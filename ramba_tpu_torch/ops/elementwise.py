"""Module-level elementwise functions (ufunc surface).

Counterpart of ``ramba_tpu/ops/elementwise.py``: each call appends ONE map
node to the lazy graph; the chain runs as one program at flush.
"""

from __future__ import annotations

import numpy as np

from ramba_tpu_torch.core import expr as E
from ramba_tpu_torch.core.expr import Node
from ramba_tpu_torch.core.ndarray import ndarray, as_exprable


def _map(fname, *operands):
    return ndarray(E.make_map(fname, [as_exprable(o) for o in operands]))


def _make_unary(fname):
    def fn(x):
        return _map(fname, x)

    fn.__name__ = fname
    return fn


def _make_binary(fname):
    def fn(a, b):
        return _map(fname, a, b)

    fn.__name__ = fname
    return fn


_g = globals()
for _name in E.UNARY:
    _g[_name] = _make_unary(_name)
for _name in E.BINARY:
    _g[_name] = _make_binary(_name)

abs = _make_unary("absolute")  # noqa: A001

__all__ = sorted(
    list(E.UNARY) + list(E.BINARY)
    + ["abs", "where", "clip", "round", "cbrt", "select", "isclose",
       "allclose", "array_equal"]
)


def where(cond, x=None, y=None):
    if x is None and y is None:
        # 1-arg where == nonzero: data-dependent shape, must materialize
        c = cond.asarray() if isinstance(cond, ndarray) else np.asarray(cond)
        return np.nonzero(c)
    return _map("where", cond, x, y)


def clip(a, a_min=None, a_max=None):
    if not isinstance(a, ndarray):
        from ramba_tpu_torch.ops.creation import asarray as _as

        a = _as(a)
    return a.clip(a_min, a_max)


def round(a, decimals=0):  # noqa: A001
    return a.round(decimals)


def cbrt(x):
    return _map("cbrt", x)


def select(condlist, choicelist, default=0):
    out = as_exprable(default)
    # last condition has lowest precedence -> build from the end
    for cond, choice in list(zip(condlist, choicelist))[::-1]:
        out = Node("map", ("where",),
                   [as_exprable(cond), as_exprable(choice), out])
    return ndarray(out)


def isclose(a, b, rtol=1e-05, atol=1e-08):
    diff = _map("absolute", _map("subtract", a, b))
    bound = _map("add", atol, _map("multiply", rtol, _map("absolute", b)))
    return _map("less_equal", diff, bound)


def allclose(a, b, rtol=1e-05, atol=1e-08):
    return bool(isclose(a, b, rtol, atol).all())


def array_equal(a, b):
    a_sh = a.shape if hasattr(a, "shape") else np.shape(a)
    b_sh = b.shape if hasattr(b, "shape") else np.shape(b)
    if tuple(a_sh) != tuple(b_sh):
        return False
    return bool(_map("equal", a, b).all())
