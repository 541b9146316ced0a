"""ramba_tpu_torch — the PyTorch/CUDA port of ramba_tpu.

A NumPy drop-in whose operations are deferred into a lazy expression graph,
fused at flush time into one program per flush and run on an NVIDIA GPU.
Fused elementwise(+reduce) chains run through a hand-written CUDA C++
kernel (``ops/elemred.py``, ``csrc/elemred.cuh``); 2-D stencils run through a hand-written CUDA C++ tile
kernel (``ops/stencil_kernel.py``, ``csrc/stencil_tile.cuh``); groupby's
segment reductions run through a hand-written CUDA C++ kernel
(``ops/segred.py``, ``csrc/segred.cuh``); float cumsum/cumprod run through
a hand-written fixed-order CUDA C++ scan (``ops/scan.py``,
``csrc/scan.cuh``).  The skeletons (smap, sreduce, scumulative, spmd) call
user kernels on whole tensors through the generic lowering.  A mesh of
shard positions in one process (``set_mesh``; ``parallel/``) splits
sstencil, spmd, scumulative and sreduce's reducers over shards: the
stencil runs the CUDA kernel on every shard's halo-extended block.  One
program started once per rank (``distributed.initialize``) runs over a
mesh whose positions are ranks, each holding its own block of every
array (``parallel/distributed.py``, ``core/rankflush.py``); every
creation op takes ``distribution=``, ``reshard`` changes a layout in
stages, and a flush over operands of different layouts aligns them.
Seeded draws (``random``), file I/O (``load``/``save`` and friends) and
atomic, digest-verified ``checkpoint``s sit on the resilience plane's
fault injection and retries (``resilience``).  A long program runs in
segments; ``RAMBA_COMPILE_CLASSES`` buckets elementwise shapes,
``RAMBA_CACHE`` keeps built kernel libraries for the next process
(``compile``), ``RAMBA_AUTOTUNE=race`` picks each program's
lowering by measurement, and the cost ledger (``observe.ledger``) files
what every program cost.  Every flush's wall is attributed to stages
along its critical path (``observe.attrib``: the fence is a CUDA event
pair), with rooflines against the card, a drift sentinel, SLOs
(``observe.slo``), a Prometheus exporter and a flight recorder
(``observe.telemetry``), ``torch.profiler`` hooks (``observe.profile``,
``profiler_trace``) and the whole ``diagnostics`` report.

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
    arange, array, asarray, asarray_chkfinite, ascontiguousarray,
    asfortranarray, c_, copy, create_array_with_divisions, empty, empty_like, eye, frombuffer, fromarray,
    fromfunction, fromiter, fromstring, full, full_like, geomspace, identity,
    indices, init_array, linspace, logspace, meshgrid, mgrid, ogrid, ones,
    ones_like, r_, rollaxis, tri, zeros, zeros_like,
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
from ramba_tpu_torch.ops.extras import (  # noqa: F401
    append, apply_along_axis, apply_over_axes, argpartition, argwhere,
    around, array_equiv, atleast_3d, bartlett, bincount, blackman, block,
    broadcast_arrays, compress, convolve, copyto, corrcoef, correlate, cov,
    cross, delete, diag_indices, diagonal, diff, digitize, divmod, dsplit,
    ediff1d, extract, fill_diagonal, fix, flatnonzero, fliplr, flipud,
    frexp, gradient, hamming, hanning, histogram, histogram2d, hsplit,
    in1d, insert, interp, intersect1d, isin, ix_, kaiser, kron, lexsort,
    modf, nan_to_num, nancumprod, nancumsum, nanpercentile, nanquantile,
    nonzero, packbits, partition, percentile, piecewise, place, poly,
    polyfit, polyval, put_along_axis, putmask, quantile, ravel_multi_index,
    real_if_close, require, resize, roots, rot90, row_stack, searchsorted,
    setdiff1d, setxor1d, sort_complex, take_along_axis, trapezoid, trapz,
    tril_indices, tril_indices_from, trim_zeros, triu_indices,
    triu_indices_from, union1d, unique, unpackbits, unravel_index, unwrap,
    vander, vsplit,
)
from ramba_tpu_torch import fft  # noqa: F401
from ramba_tpu_torch import linalg  # noqa: F401
from ramba_tpu_torch import fileio  # noqa: F401
from ramba_tpu_torch.fileio import (  # noqa: F401
    Dataset, genfromtxt, load, loadtxt, register_loader, save, savetxt,
)
from ramba_tpu_torch import checkpoint  # noqa: F401
from ramba_tpu_torch import random  # noqa: F401
from ramba_tpu_torch import resilience  # noqa: F401
from ramba_tpu_torch.skeletons import (  # noqa: F401
    KernelTraceError, LocalView, SreduceReducer, barrier, scumulative, smap,
    smap_index, spmd, sreduce, sreduce_index, sstencil, sstencil_iterate,
    stencil, worker_id,
)
from ramba_tpu_torch.parallel.mesh import (  # noqa: F401
    get_mesh, num_workers, set_mesh,
)
from ramba_tpu_torch.parallel import distributed  # noqa: F401
from ramba_tpu_torch.parallel.distributed import in_driver  # noqa: F401
from ramba_tpu_torch.parallel.reshard import reshard  # noqa: F401
from ramba_tpu_torch.parallel.constraints import (  # noqa: F401
    Constraint, add_constraint, clear_constraints, get_constraints,
)

from ramba_tpu_torch.utils.remote import get, jit, remote  # noqa: F401
from ramba_tpu_torch.utils import debug  # noqa: F401
from ramba_tpu_torch import diagnostics  # noqa: F401
from ramba_tpu_torch import observe  # noqa: F401
from ramba_tpu_torch import utils  # noqa: F401
from ramba_tpu_torch.utils import timing  # noqa: F401
from ramba_tpu_torch.utils.timing import (  # noqa: F401
    add_sub_time, add_time, annotate, get_timing, get_timing_str,
    print_comm_stats, profiler_trace, time_dict, timing_summary,
)
from ramba_tpu_torch.utils.timing import reset as reset_timing  # noqa: F401

# RAMBA_CACHE: arm the persistent kernel cache and record whether it armed
common.setup_persistent_cache()

# -- NumPy's namespace constants and dtypes --------------------------------------
newaxis = None
pi = _np.pi
e = _np.e
inf = _np.inf
nan = _np.nan
euler_gamma = _np.euler_gamma

bool_ = _np.bool_
int8 = _np.int8
int16 = _np.int16
int32 = _np.int32
int64 = _np.int64
uint8 = _np.uint8
uint16 = _np.uint16
uint32 = _np.uint32
uint64 = _np.uint64
float16 = _np.float16
float32 = _np.float32
float64 = _np.float64
complex64 = _np.complex64
complex128 = _np.complex128
dtype = _np.dtype
try:
    import ml_dtypes as _ml_dtypes

    bfloat16 = _ml_dtypes.bfloat16
except ImportError:  # pragma: no cover
    pass

float_ = _np.float64
int_ = _np.int64

byte = _np.byte
ubyte = _np.ubyte
short = _np.short
ushort = _np.ushort
intc = _np.intc
uintc = _np.uintc
uint = _np.uint
longlong = _np.longlong
ulonglong = _np.ulonglong
half = _np.half
single = _np.single
double = _np.double
longdouble = _np.longdouble
csingle = _np.csingle
cdouble = _np.cdouble
clongdouble = _np.clongdouble
iinfo = _np.iinfo
finfo = _np.finfo

# index, iteration, printing and dtype utilities over host values or
# metadata: NumPy's own are exactly right
s_ = _np.s_
index_exp = _np.index_exp
ndindex = _np.ndindex
broadcast_shapes = _np.broadcast_shapes
errstate = _np.errstate
printoptions = _np.printoptions
set_printoptions = _np.set_printoptions
get_printoptions = _np.get_printoptions
promote_types = _np.promote_types
can_cast = _np.can_cast
issubdtype = _np.issubdtype


def shape(a):
    # metadata only: a host input is never uploaded to read it
    return a.shape if isinstance(a, ndarray) else _np.shape(a)


def ndim(a):
    return a.ndim if isinstance(a, ndarray) else _np.ndim(a)


def size(a, axis=None):
    if not isinstance(a, ndarray):
        return _np.size(a, axis)
    return a.shape[axis] if axis is not None else a.size


def _host(x):
    return x.asarray() if isinstance(x, ndarray) else _np.asarray(x)


def ndenumerate(arr):
    return _np.ndenumerate(_host(arr))


def array2string(a, *args, **kwargs):
    return _np.array2string(_host(a), *args, **kwargs)


def array_repr(arr, *args, **kwargs):
    return _np.array_repr(_host(arr), *args, **kwargs)


def array_str(a, *args, **kwargs):
    return _np.array_str(_host(a), *args, **kwargs)


def init():
    """Explicit bring-up, for API parity: resolves the device and the
    default mesh now (the card, or the CPU where asked for)."""
    get_mesh()


# The NumPy functions ``ramba_tpu`` dispatches (its whole list); those the
# port has are registered, the rest raise TypeError through NumPy.
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
    "rot90", "fliplr", "flipud", "atleast_3d", "fix", "around",
    "nancumsum", "nancumprod", "quantile", "percentile", "nanquantile",
    "nanpercentile", "take_along_axis", "diagonal", "trapezoid", "vander",
    "polyval", "frexp", "broadcast_arrays", "vsplit", "hsplit", "dsplit",
    "partition", "argpartition", "setxor1d", "array_equiv", "trim_zeros",
    "resize", "poly", "polyfit", "roots", "real_if_close", "piecewise",
    "apply_along_axis", "apply_over_axes", "fill_diagonal", "putmask",
    "place", "put_along_axis", "diff", "gradient", "cross", "kron",
    "searchsorted", "interp", "unwrap", "digitize", "bincount",
    "histogram", "unique", "nonzero", "flatnonzero", "argwhere", "isin",
    "in1d", "intersect1d", "union1d", "setdiff1d", "append", "insert",
    "delete", "compress", "extract", "convolve", "correlate", "cov",
    "corrcoef", "modf", "divmod", "nan_to_num", "ediff1d", "row_stack",
    "array2string", "array_repr", "array_str", "logspace", "geomspace",
    "ascontiguousarray", "asfortranarray", "rollaxis", "histogram2d",
    "lexsort", "sort_complex", "block", "copyto", "require", "packbits",
    "unpackbits",
)


def _register_numpy_dispatch():
    import inspect

    from ramba_tpu_torch.core.interop import HANDLED_FUNCTIONS

    mod = globals()
    for n in _DISPATCHED:
        np_fn = getattr(_np, n, None)
        ours = mod.get(n)
        if np_fn is not None and ours is not None:
            HANDLED_FUNCTIONS[np_fn] = ours
    # np.linalg.<fn> and np.fft.<fn> of port arrays run the submodules'
    # functions (those each defines itself, no re-exports or classes)
    for sub, np_sub in ((linalg, _np.linalg), (fft, _np.fft)):
        for n in dir(sub):
            ours = getattr(sub, n)
            if n.startswith("_") or not inspect.isfunction(ours) or \
                    ours.__module__ != sub.__name__:
                continue
            np_fn = getattr(np_sub, n, None)
            if callable(np_fn):
                HANDLED_FUNCTIONS[np_fn] = ours


_register_numpy_dispatch()
