"""Carry state from the JAX package into the port.

For this system the "parameters" are the arrays a program reads.
:func:`state_from_reference` takes host arrays gathered from ``ramba_tpu``
(its ``ndarray.asarray()``) and returns port arrays holding exactly the same
values and dtypes, so both packages run a program on identical inputs.
"""

from __future__ import annotations

import numpy as np

from ramba_tpu_torch.core.expr import Const, tensor_from_numpy, to_torch_dtype
from ramba_tpu_torch.core.ndarray import ndarray


def state_from_reference(arrays: "dict[str, np.ndarray]") -> "dict[str, ndarray]":
    """name -> port array on the process device, dtype kept exactly.

    bool, int64 and float64 stay as they are (never torch's defaults);
    bfloat16 (an ``ml_dtypes.bfloat16`` numpy array, which
    ``torch.from_numpy`` rejects) goes through its 16-bit pattern."""
    out = {}
    for name, a in arrays.items():
        a = np.asarray(a)
        t = tensor_from_numpy(a)
        if t.dtype != to_torch_dtype(a.dtype):
            raise TypeError(f"{name}: dtype {a.dtype} arrived as {t.dtype}")
        out[name] = ndarray(Const(t))
    return out
