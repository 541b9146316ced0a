"""Array creation.

Counterpart of ``ramba_tpu/ops/creation.py``.  Every creation op is a lazy
node that generates its data on the device at flush time and fuses with
its consumers; ``fromarray`` uploads a host array as a leaf.  Explicit
distributions are not ported yet: a non-``None`` ``distribution`` raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ramba_tpu_torch import common
from ramba_tpu_torch.core import expr as E
from ramba_tpu_torch.core.expr import Const, Node
from ramba_tpu_torch.core.ndarray import ndarray, as_exprable

# x64 regime: numpy's default int and float
_DEFAULT_INT = np.dtype(np.int64)
_DEFAULT_FLOAT = np.dtype(np.float64)


def _no_distribution(distribution):
    """Every creation op starts here: it refuses explicit distributions and
    resolves the device now, so a run with no card (and no request for the
    CPU) fails at the first array instead of at its first flush."""
    if distribution is not None:
        raise NotImplementedError(
            "explicit distributions are not ported to ramba_tpu_torch yet")
    common.device()


def _canon_shape(shape):
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _np_dtype(dtype):
    if dtype is float:
        return _DEFAULT_FLOAT
    if dtype is int:
        return _DEFAULT_INT
    return E.to_np_dtype(dtype)


def empty(shape, dtype=float, local_border=0, distribution=None):
    return full(shape, 0, dtype, distribution=distribution)


def zeros(shape, dtype=float, local_border=0, distribution=None):
    return full(shape, 0, dtype, distribution=distribution)


def ones(shape, dtype=float, local_border=0, distribution=None):
    return full(shape, 1, dtype, distribution=distribution)


def full(shape, fill_value, dtype=None, local_border=0, distribution=None):
    _no_distribution(distribution)
    shape = _canon_shape(shape)
    if dtype is None:
        dtype = np.result_type(fill_value)
    dtype = _np_dtype(dtype)
    return ndarray(Node("full", (shape, str(dtype), None),
                        [as_exprable(fill_value)]))


def _like_shape_dtype(a, dtype):
    if isinstance(a, ndarray):
        return a.shape, (dtype or a.dtype)
    a = np.asarray(a)
    return a.shape, (dtype or a.dtype)


def empty_like(a, dtype=None, distribution=None):
    return zeros_like(a, dtype, distribution=distribution)


def zeros_like(a, dtype=None, distribution=None):
    shape, dtype = _like_shape_dtype(a, dtype)
    return full(shape, 0, dtype, distribution=distribution)


def ones_like(a, dtype=None, distribution=None):
    shape, dtype = _like_shape_dtype(a, dtype)
    return full(shape, 1, dtype, distribution=distribution)


def full_like(a, fill_value, dtype=None, distribution=None):
    shape, dtype = _like_shape_dtype(a, dtype)
    return full(shape, fill_value, dtype, distribution=distribution)


def arange(start, stop=None, step=None, dtype=None, local_border=0,
           distribution=None):
    _no_distribution(distribution)
    if stop is None:
        start, stop = 0, start
    if step is None:
        step = 1
    n = int(max(0, -(-(stop - start) // step) if step != 0 else 0))
    if dtype is None:
        ints = all(isinstance(x, (int, np.integer)) for x in (start, stop, step))
        dtype = _DEFAULT_INT if ints else _DEFAULT_FLOAT
    dtype = _np_dtype(dtype)
    return ndarray(Node("arange", (n, str(dtype), None),
                        [E.as_expr(start), E.as_expr(step)]))


def linspace(start, stop, num=50, endpoint=True, dtype=None,
             distribution=None):
    _no_distribution(distribution)
    dtype = _DEFAULT_FLOAT if dtype is None else _np_dtype(dtype)
    return ndarray(Node("linspace", (int(num), bool(endpoint), str(dtype),
                                     None),
                        [E.as_expr(start), E.as_expr(stop)]))


def fromarray(arr, dtype=None, distribution=None):
    """Upload a host array (or adopt a tensor) as a leaf on the process
    device, dtype kept exactly."""
    _no_distribution(distribution)
    if isinstance(arr, torch.Tensor):
        t = arr if dtype is None else arr.to(E.to_torch_dtype(_np_dtype(dtype)))
        return ndarray(Const(t.to(common.device())))
    a = np.asarray(arr) if dtype is None else np.asarray(arr, dtype=dtype)
    return ndarray(Const(E.tensor_from_numpy(a)))


def asarray(a, dtype=None):
    if isinstance(a, ndarray):
        if dtype is not None and _np_dtype(dtype) != a.dtype:
            return a.astype(dtype)
        return a
    return fromarray(a, dtype=dtype)


def array(a, dtype=None, copy=True):
    if isinstance(a, ndarray):
        out = a.copy() if copy else a
        return out.astype(dtype) if dtype is not None else out
    return fromarray(a, dtype=dtype)


def copy(a):
    return a.copy() if isinstance(a, ndarray) else fromarray(np.copy(a))
