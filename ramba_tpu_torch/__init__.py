"""ramba_tpu_torch — the PyTorch/CUDA port of ramba_tpu.

A NumPy drop-in whose operations are deferred into a lazy expression graph,
fused at flush time into one program per flush and run on an NVIDIA GPU.
Fused elementwise(+reduce) chains run through a hand-written CUDA C++
kernel (``ops/elemred.py``, ``csrc/elemred.cuh``); 2-D stencils run through a hand-written CUDA C++ tile
kernel (``ops/stencil_kernel.py``, ``csrc/stencil_tile.cuh``); groupby's
segment reductions run through a hand-written CUDA C++ kernel
(``ops/segred.py``, ``csrc/segred.cuh``); float cumsum/cumprod run through
a hand-written fixed-order CUDA C++ scan (``ops/scan.py``,
``csrc/scan.cuh``).  The skeletons (smap, sreduce, scumulative, spmd on
one card) call user kernels on whole tensors through the generic lowering.

``numpy.<fn>`` of port arrays runs the port's function where the port has
one (``core/interop.py``'s registry, filled below) and raises
``TypeError`` otherwise: nothing moves to the host unasked.

Arrays live on ``cuda:0``.  The CPU is used only when asked for
(``ramba_tpu_torch.common.set_device("cpu")`` or ``RAMBA_TORCH_DEVICE=cpu``).

    import ramba_tpu_torch as np
    A = np.arange(1_000_000_000) / 1000.0
    B = np.sin(A)
    C = np.cos(A)
    D = B*B + C**2
    np.sync()
"""

from __future__ import annotations

import numpy as _np

from ramba_tpu_torch import common  # noqa: F401
from ramba_tpu_torch.common import set_device  # noqa: F401
from ramba_tpu_torch.core.fuser import flush, sync, stats as fuser_stats  # noqa: F401
from ramba_tpu_torch.core.interop import implements, isscalar, result_type  # noqa: F401
from ramba_tpu_torch.core.masked import MaskedArray  # noqa: F401
from ramba_tpu_torch.core.ndarray import ndarray  # noqa: F401
from ramba_tpu_torch.ops.creation import (  # noqa: F401
    arange, array, asarray, copy, empty, empty_like, fromarray, fromfunction,
    full, full_like, init_array, linspace, ones, ones_like, zeros, zeros_like,
)
from ramba_tpu_torch.ops.elementwise import *  # noqa: F401,F403
from ramba_tpu_torch.ops.elementwise import (  # noqa: F401
    allclose, array_equal, cbrt, clip, isclose, select, where,
)
from ramba_tpu_torch.groupby import RambaGroupby  # noqa: F401
from ramba_tpu_torch.ops.linalg import (  # noqa: F401
    dot, einsum, einsum_path, inner, matmul, outer, set_matmul_precision,
    tensordot, trace, vdot,
)
from ramba_tpu_torch.ops.manipulation import (  # noqa: F401
    apply_index, argsort, array_split, atleast_1d, atleast_2d, broadcast_to,
    column_stack, concatenate, diag, dstack, expand_dims, flip, hstack,
    moveaxis, pad, ravel, repeat, reshape, reshape_copy, roll, sort, split,
    squeeze, stack, swapaxes, take, tile, transpose, tril, triu, vstack,
)
from ramba_tpu_torch.ops.reductions import (  # noqa: F401
    all, amax, amin, any, argmax, argmin, average, count_nonzero, cumprod,
    cumsum, max, mean, median, min, nanargmax, nanargmin, nanmax, nanmean,
    nanmedian, nanmin, nanprod, nanstd, nansum, nanvar, prod, ptp, std, sum,
    var,
)
from ramba_tpu_torch.skeletons import (  # noqa: F401
    KernelTraceError, LocalView, SreduceReducer, barrier, scumulative, smap,
    smap_index, spmd, sreduce, sreduce_index, sstencil, sstencil_iterate,
    stencil, worker_id,
)

newaxis = None


def shape(a):
    # metadata only: a host input is never uploaded to read it
    return a.shape if isinstance(a, ndarray) else _np.shape(a)


def ndim(a):
    return a.ndim if isinstance(a, ndarray) else _np.ndim(a)


def size(a, axis=None):
    if not isinstance(a, ndarray):
        return _np.size(a, axis)
    return a.shape[axis] if axis is not None else a.size


# The NumPy functions ``ramba_tpu`` dispatches; those the port has are
# registered, the rest raise TypeError through NumPy.
_DISPATCHED = (
    "sum", "prod", "min", "max", "amin", "amax", "mean", "var", "std",
    "any", "all", "median", "argmin", "argmax", "nansum", "nanmean",
    "nanmin", "nanmax", "nanprod", "nanvar", "nanstd", "count_nonzero",
    "cumsum", "cumprod", "average", "ptp", "nanmedian", "nanargmin",
    "nanargmax",
    "reshape", "ravel", "transpose", "moveaxis", "swapaxes",
    "expand_dims", "squeeze", "broadcast_to", "flip", "roll",
    "concatenate", "stack", "vstack", "hstack", "dstack", "column_stack",
    "split", "array_split", "pad", "tril", "triu", "diag", "repeat",
    "tile", "sort", "argsort", "take", "atleast_1d", "atleast_2d",
    "where", "clip", "select", "isclose", "allclose", "array_equal",
    "dot", "matmul", "inner", "outer", "tensordot", "einsum", "trace",
    "vdot", "einsum_path", "zeros_like", "ones_like", "empty_like",
    "full_like", "copy", "asarray", "shape", "ndim", "size",
)


def _register_numpy_dispatch():
    from ramba_tpu_torch.core.interop import HANDLED_FUNCTIONS

    mod = globals()
    for n in _DISPATCHED:
        np_fn = getattr(_np, n, None)
        ours = mod.get(n)
        if np_fn is not None and ours is not None:
            HANDLED_FUNCTIONS[np_fn] = ours


_register_numpy_dispatch()
