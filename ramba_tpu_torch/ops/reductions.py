"""Module-level reductions.

Counterpart of ``ramba_tpu/ops/reductions.py``.  A whole-array
sum/prod/min/max/mean at the end of an elementwise chain runs inside the
elemred kernel; every other reduction lowers through the generic path
(``expr.reduce_tensor``), with ``ramba_tpu``'s dtypes and NaN rules.
"""

from __future__ import annotations

import math

import numpy as np

from ramba_tpu_torch.core.expr import reduces_nothing
from ramba_tpu_torch.ops.creation import asarray

_NO_VALUE = getattr(np, "_NoValue", None)


def _identity_for(name, dtype):
    """The reduction identity used to mask out ``where=False`` elements
    (one ``where`` node ahead of the reduce)."""
    dt = np.dtype(dtype)
    if name in ("sum", "nansum", "any", "count_nonzero"):
        return dt.type(0) if dt.kind != "b" else False
    if name in ("prod", "nanprod", "all"):
        return dt.type(1) if dt.kind != "b" else True
    if name in ("min", "nanmin", "amin"):
        if dt.kind == "f":
            return np.inf
        if dt.kind == "c":
            return dt.type(complex(np.inf, 0))
        if dt.kind == "b":
            return True
        return np.iinfo(dt).max
    if name in ("max", "nanmax", "amax"):
        if dt.kind == "f":
            return -np.inf
        if dt.kind == "c":
            return dt.type(complex(-np.inf, 0))
        if dt.kind == "b":
            return False
        return np.iinfo(dt).min
    return None


def _apply_where(name, a, where):
    from ramba_tpu_torch.ops.elementwise import where as _where

    ident = _identity_for(name, a.dtype)
    if ident is None:
        raise TypeError(f"reduction '{name}' does not support where=")
    return _where(asarray(where), a, ident)


def _fold_initial(name, r, initial):
    """NumPy folds ``initial`` into the total exactly once."""
    from ramba_tpu_torch.ops import elementwise as ew

    if name in ("sum", "nansum"):
        return r + initial
    if name in ("prod", "nanprod"):
        return r * initial
    if name in ("min", "amin"):
        return ew.minimum(r, initial)
    if name in ("max", "amax"):
        return ew.maximum(r, initial)
    # nan variants fold NaN-ignoring: an all-NaN slice reduces to NaN and
    # numpy's nanmin(..., initial=5.0) still returns 5.0
    if name == "nanmin":
        return ew.fmin(r, initial)
    if name == "nanmax":
        return ew.fmax(r, initial)
    raise TypeError(f"reduction '{name}' does not support initial=")


_EXTREMES = frozenset({"min", "max", "amin", "amax", "nanmin", "nanmax"})


def _axis_tuple(axis, ndim) -> tuple:
    if axis is None:
        return tuple(range(ndim))
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    return tuple(int(d) % ndim for d in axes)


def _finish(r, dtype, out, asarray_form):
    """The common tail: ``dtype`` cast, deferred-(1,) form, ``out=``."""
    if dtype is not None:
        r = r.astype(dtype)
    if asarray_form:
        # `asarray=True` keeps a full reduction in deferred (1,)-array form
        r = r.reshape((1,) if r.ndim == 0 else r.shape)
    if out is not None:
        out.write_expr(r.read_expr())
        return out
    return r


def _red(name, a, axis=None, keepdims=False, dtype=None, out=None, ddof=None,
         asarray_form=False, where=None, initial=None):
    a = asarray(a)
    if where is _NO_VALUE:
        where = None
    if initial is _NO_VALUE:
        initial = None
    if where is not None:
        if (name in ("min", "max", "amin", "amax", "nanmin", "nanmax")
                and initial is None):
            # numpy: min/max have no identity, so where= requires initial=
            raise ValueError(
                f"reduction operation '{name}' does not have an identity, "
                "so to use a where mask one has to specify 'initial'")
        a = _apply_where(name, a, where)
    if initial is not None and name in _EXTREMES and a.ndim and \
            reduces_nothing(a.shape, _axis_tuple(axis, a.ndim)):
        # NumPy: ``initial`` is the answer over nothing
        from ramba_tpu_torch.ops.creation import full

        shape = tuple(1 if d in _axis_tuple(axis, a.ndim) else n
                      for d, n in enumerate(a.shape)
                      if keepdims or d not in _axis_tuple(axis, a.ndim))
        return _finish(full(shape, initial, dtype=a.dtype), dtype, out,
                       asarray_form)
    r = a._reduce(name, axis=axis, keepdims=keepdims, ddof=ddof)
    if initial is not None:
        r = _fold_initial(name, r, initial)
    return _finish(r, dtype, out, asarray_form)


# Positional parameter order follows NumPy (np.sum(a, axis, dtype, out,
# ...), np.min(a, axis, out, ...), np.var(a, axis, dtype, out, ddof, ...));
# everything past NumPy's positional tail is keyword-only.


def sum(a, axis=None, dtype=None, out=None, *, keepdims=False,  # noqa: A001
        asarray=False, where=None, initial=None):
    return _red("sum", a, axis, keepdims, dtype, out, asarray_form=asarray,
                where=where, initial=initial)


def prod(a, axis=None, dtype=None, out=None, *, keepdims=False, asarray=False,
         where=None, initial=None):
    return _red("prod", a, axis, keepdims, dtype, out, asarray_form=asarray,
                where=where, initial=initial)


def min(a, axis=None, out=None, *, keepdims=False, asarray=False,  # noqa: A001
        where=None, initial=None):
    return _red("min", a, axis, keepdims, None, out, asarray_form=asarray,
                where=where, initial=initial)


def max(a, axis=None, out=None, *, keepdims=False, asarray=False,  # noqa: A001
        where=None, initial=None):
    return _red("max", a, axis, keepdims, None, out, asarray_form=asarray,
                where=where, initial=initial)


amin = min
amax = max


def mean(a, axis=None, dtype=None, out=None, *, keepdims=False, asarray=False,
         where=None):
    if where is None or where is _NO_VALUE:
        return _red("mean", a, axis, keepdims, dtype, out, asarray_form=asarray)
    # masked mean = masked sum / included count
    from ramba_tpu_torch.ops.creation import asarray as _as

    a = _as(a)
    num = sum(a, axis=axis, keepdims=keepdims, where=where)
    cnt = sum(_as(where).astype(num.dtype).broadcast_to(a.shape),
              axis=axis, keepdims=keepdims)
    return _finish(num / cnt, dtype, out, asarray)


def var(a, axis=None, dtype=None, out=None, ddof=0, *, keepdims=False):
    return _red("var", a, axis, keepdims, dtype, out, ddof=ddof)


def std(a, axis=None, dtype=None, out=None, ddof=0, *, keepdims=False):
    return _red("std", a, axis, keepdims, dtype, out, ddof=ddof)


def any(a, axis=None, out=None, *, keepdims=False, where=None):  # noqa: A001
    return _red("any", a, axis, keepdims, None, out, where=where)


def all(a, axis=None, out=None, *, keepdims=False, where=None):  # noqa: A001
    return _red("all", a, axis, keepdims, None, out, where=where)


def median(a, axis=None, out=None, *, keepdims=False):
    return _red("median", a, axis, keepdims, None, out)


def ptp(a, axis=None, out=None, *, keepdims=False):
    return _red("ptp", a, axis, keepdims, None, out)


def argmin(a, axis=None, out=None, *, keepdims=False):
    return _red("argmin", a, axis, keepdims, None, out)


def argmax(a, axis=None, out=None, *, keepdims=False):
    return _red("argmax", a, axis, keepdims, None, out)


def _check_all_nan_slice(a, axis):
    """NumPy raises for an all-NaN slice where ``jnp.nanarg*`` would return
    -1 (which then indexes the last element).  Costs one eager scalar
    fetch, as in ``ramba_tpu``."""
    from ramba_tpu_torch.ops import elementwise as ew

    a = asarray(a)
    if a.ndim and reduces_nothing(a.shape, _axis_tuple(axis, a.ndim)):
        return  # the reduction raises NumPy's empty-sequence error
    if np.dtype(a.dtype).kind not in "fc":
        return
    allnan = _red("all", ew.isnan(a), axis)
    if bool(_red("any", allnan)):
        raise ValueError("All-NaN slice encountered")


def nanargmin(a, axis=None, out=None, *, keepdims=False):
    _check_all_nan_slice(a, axis)
    return _red("nanargmin", a, axis, keepdims, None, out)


def nanargmax(a, axis=None, out=None, *, keepdims=False):
    _check_all_nan_slice(a, axis)
    return _red("nanargmax", a, axis, keepdims, None, out)


def nansum(a, axis=None, dtype=None, out=None, *, keepdims=False,
           where=None, initial=None):
    return _red("nansum", a, axis, keepdims, dtype, out,
                where=where, initial=initial)


def nanprod(a, axis=None, dtype=None, out=None, *, keepdims=False,
            where=None, initial=None):
    return _red("nanprod", a, axis, keepdims, dtype, out,
                where=where, initial=initial)


def nanmin(a, axis=None, out=None, *, keepdims=False, where=None,
           initial=None):
    return _red("nanmin", a, axis, keepdims, None, out,
                where=where, initial=initial)


def nanmax(a, axis=None, out=None, *, keepdims=False, where=None,
           initial=None):
    return _red("nanmax", a, axis, keepdims, None, out,
                where=where, initial=initial)


def nanmean(a, axis=None, dtype=None, out=None, *, keepdims=False):
    return _red("nanmean", a, axis, keepdims, dtype, out)


def nanvar(a, axis=None, dtype=None, out=None, ddof=0, *, keepdims=False):
    return _red("nanvar", a, axis, keepdims, dtype, out, ddof=ddof)


def nanstd(a, axis=None, dtype=None, out=None, ddof=0, *, keepdims=False):
    return _red("nanstd", a, axis, keepdims, dtype, out, ddof=ddof)


def nanmedian(a, axis=None, out=None, *, keepdims=False):
    return _red("nanmedian", a, axis, keepdims, None, out)


def count_nonzero(a, axis=None, *, keepdims=False):
    return _red("count_nonzero", a, axis, keepdims)


def cumsum(a, axis=None):
    return asarray(a).cumsum(axis)


def cumprod(a, axis=None):
    return asarray(a).cumprod(axis)


def average(a, axis=None, weights=None, returned=False):
    """NumPy-compatible weighted average, including the 1-D-weights-along-
    ``axis`` broadcast rule.  ``axis`` may be an int, a tuple of ints, or
    None."""
    a = asarray(a)
    if weights is None:
        avg = a.mean(axis)
        if returned:
            if axis is None:
                n = a.size
            elif isinstance(axis, tuple):
                n = math.prod(a.shape[ax % a.ndim] for ax in axis)
            else:
                n = a.shape[axis]
            from ramba_tpu_torch.ops.creation import full

            return avg, full(avg.shape, float(n))
        return avg
    w = asarray(weights)
    if w.shape != a.shape:
        if axis is None:
            raise TypeError(
                "Axis must be specified when shapes of a and weights differ")
        if not isinstance(axis, int):
            raise TypeError(
                "Axis must be an integer when 1D weights differ from a's shape")
        if w.ndim != 1:
            raise TypeError(
                "1D weights expected when shapes of a and weights differ")
        if w.shape[0] != a.shape[axis]:
            raise ValueError(
                "Length of weights not compatible with specified axis")
        bshape = [1] * a.ndim
        bshape[axis % a.ndim] = w.shape[0]
        w = w.reshape(tuple(bshape))
    scl = sum(w, axis=axis)
    avg = sum(a * w, axis=axis) / scl
    if returned:
        if scl.shape != avg.shape:
            scl = scl.broadcast_to(avg.shape)
        return avg, scl
    return avg
