"""ramba_tpu_torch — the PyTorch/CUDA port of ramba_tpu.

A NumPy drop-in whose operations are deferred into a lazy expression graph,
fused at flush time into one program per flush and run on an NVIDIA GPU.
Fused elementwise(+reduce) chains run through a hand-written CUDA C++
kernel (``ops/elemred.py``, ``csrc/elemred.cuh``); 2-D stencils run through a hand-written CUDA C++ tile
kernel (``ops/stencil_kernel.py``, ``csrc/stencil_tile.cuh``); groupby's
segment reductions run through a hand-written CUDA C++ kernel
(``ops/segred.py``, ``csrc/segred.cuh``).

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

from ramba_tpu_torch import common  # noqa: F401
from ramba_tpu_torch.common import set_device  # noqa: F401
from ramba_tpu_torch.core.fuser import flush, sync, stats as fuser_stats  # noqa: F401
from ramba_tpu_torch.core.ndarray import ndarray  # noqa: F401
from ramba_tpu_torch.ops.creation import (  # noqa: F401
    arange, array, asarray, copy, empty, empty_like, fromarray, full,
    full_like, linspace, ones, ones_like, zeros, zeros_like,
)
from ramba_tpu_torch.ops.elementwise import *  # noqa: F401,F403
from ramba_tpu_torch.ops.elementwise import (  # noqa: F401
    allclose, array_equal, cbrt, clip, isclose, select, where,
)
from ramba_tpu_torch.groupby import RambaGroupby  # noqa: F401
from ramba_tpu_torch.ops.manipulation import take  # noqa: F401
from ramba_tpu_torch.ops.reductions import (  # noqa: F401
    all, amax, amin, any, max, mean, min, prod, sum,
)
from ramba_tpu_torch.skeletons import (  # noqa: F401
    KernelTraceError, sstencil, sstencil_iterate, stencil,
)
