"""Module-level reductions.

Counterpart of ``ramba_tpu/ops/reductions.py`` (sum/prod/min/max/mean/
any/all).  A whole-array reduction at the end of an elementwise chain runs
inside the elemred kernel; any other lowers through the generic path.
"""

from __future__ import annotations

import numpy as np

from ramba_tpu_torch.ops.creation import asarray

_NO_VALUE = getattr(np, "_NoValue", None)


def _identity_for(name, dtype):
    """The reduction identity used to mask out ``where=False`` elements."""
    dt = np.dtype(dtype)
    if name in ("sum", "any"):
        return dt.type(0) if dt.kind != "b" else False
    if name in ("prod", "all"):
        return dt.type(1) if dt.kind != "b" else True
    if name == "min":
        if dt.kind == "f":
            return np.inf
        if dt.kind == "b":
            return True
        return np.iinfo(dt).max
    if name == "max":
        if dt.kind == "f":
            return -np.inf
        if dt.kind == "b":
            return False
        return np.iinfo(dt).min
    return None


def _fold_initial(name, r, initial):
    """NumPy folds ``initial`` into the total exactly once."""
    from ramba_tpu_torch.ops import elementwise as ew

    if name == "sum":
        return r + initial
    if name == "prod":
        return r * initial
    if name == "min":
        return ew.minimum(r, initial)
    if name == "max":
        return ew.maximum(r, initial)
    raise TypeError(f"reduction '{name}' does not support initial=")


def _red(name, a, axis=None, keepdims=False, dtype=None, out=None,
         where=None, initial=None):
    a = asarray(a)
    if where is _NO_VALUE:
        where = None
    if initial is _NO_VALUE:
        initial = None
    if where is not None:
        if name in ("min", "max") and initial is None:
            raise ValueError(
                f"reduction operation '{name}' does not have an identity, "
                "so to use a where mask one has to specify 'initial'")
        from ramba_tpu_torch.ops.elementwise import where as _where

        a = _where(asarray(where), a, _identity_for(name, a.dtype))
    r = a._reduce(name, axis=axis, keepdims=keepdims)
    if initial is not None:
        r = _fold_initial(name, r, initial)
    if dtype is not None:
        r = r.astype(dtype)
    if out is not None:
        out.write_expr(r.read_expr())
        return out
    return r


def sum(a, axis=None, dtype=None, out=None, *, keepdims=False,  # noqa: A001
        where=None, initial=None):
    return _red("sum", a, axis, keepdims, dtype, out, where, initial)


def prod(a, axis=None, dtype=None, out=None, *, keepdims=False, where=None,
         initial=None):
    return _red("prod", a, axis, keepdims, dtype, out, where, initial)


def min(a, axis=None, out=None, *, keepdims=False,  # noqa: A001
        where=None, initial=None):
    return _red("min", a, axis, keepdims, None, out, where, initial)


def max(a, axis=None, out=None, *, keepdims=False,  # noqa: A001
        where=None, initial=None):
    return _red("max", a, axis, keepdims, None, out, where, initial)


amin = min
amax = max


def mean(a, axis=None, dtype=None, out=None, *, keepdims=False):
    return _red("mean", a, axis, keepdims, dtype, out)


def any(a, axis=None, out=None, *, keepdims=False, where=None):  # noqa: A001
    return _red("any", a, axis, keepdims, None, out, where)


def all(a, axis=None, out=None, *, keepdims=False, where=None):  # noqa: A001
    return _red("all", a, axis, keepdims, None, out, where)
