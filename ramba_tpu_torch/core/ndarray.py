"""The user-visible lazy array.

Counterpart of ``ramba_tpu/core/ndarray.py``: a thin handle over an
expression graph whose leaves are torch tensors.  A view holds its parent
plus a reversible view op; reads re-derive the expression from the
parent's current state and writes push an updated expression back through
the chain, which gives NumPy's view aliasing (``t = a.T; t += 1`` changes
``a``) on top of functional graph nodes.  Sharding is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ramba_tpu_torch.core import expr as E
from ramba_tpu_torch.core import fuser
from ramba_tpu_torch.core.expr import Const, Expr, Node

# ---------------------------------------------------------------------------
# View ops
# ---------------------------------------------------------------------------


class ViewOp:
    def read(self, base_expr: Expr) -> Expr:
        raise NotImplementedError

    def write(self, base_expr: Expr, value_expr: Expr) -> Expr:
        """Return a new base expression with the viewed region replaced."""
        raise NotImplementedError


class SliceView(ViewOp):
    """Basic indexing view (slices, ints, newaxis; negative steps too)."""

    def __init__(self, enc):
        self.enc = enc

    def read(self, base_expr):
        return Node("getitem", (self.enc,), [base_expr])

    def write(self, base_expr, value_expr):
        return Node("setitem", (self.enc,), [base_expr, value_expr])


class PermuteView(ViewOp):
    """Transpose-family view."""

    def __init__(self, axes):
        self.axes = tuple(axes)
        inv = [0] * len(self.axes)
        for i, a in enumerate(self.axes):
            inv[a] = i
        self.inv = tuple(inv)

    def read(self, base_expr):
        return Node("permute", (self.axes,), [base_expr])

    def write(self, base_expr, value_expr):
        return Node("permute", (self.inv,), [value_expr])


class ReshapeView(ViewOp):
    """Reshape view: writes map back through the row-major bijection."""

    def __init__(self, shape, base_shape):
        self.shape = tuple(shape)
        self.base_shape = tuple(base_shape)

    def read(self, base_expr):
        return Node("reshape", (self.shape,), [base_expr])

    def write(self, base_expr, value_expr):
        return Node("reshape", (self.base_shape,), [value_expr])


# ---------------------------------------------------------------------------
# ndarray
# ---------------------------------------------------------------------------

_BINOPS = {
    "add": "add", "sub": "subtract", "mul": "multiply",
    "truediv": "true_divide", "floordiv": "floor_divide", "mod": "mod",
    "pow": "power", "and": "bitwise_and", "or": "bitwise_or",
    "xor": "bitwise_xor", "lshift": "left_shift", "rshift": "right_shift",
}

_CMPOPS = {
    "lt": "less", "le": "less_equal", "gt": "greater", "ge": "greater_equal",
    "eq": "equal", "ne": "not_equal",
}

_UNARY_OPS = {"__neg__": "negative", "__pos__": "positive",
              "__abs__": "absolute", "__invert__": "invert"}

_UNARY_METHODS = [
    "abs", "absolute", "sqrt", "square", "exp", "log", "sin", "cos", "tan",
    "arcsin", "arccos", "arctan", "sinh", "cosh", "tanh", "arcsinh",
    "arccosh", "arctanh", "floor", "ceil", "trunc", "isnan", "isinf",
    "negative", "log2", "log10", "log1p", "expm1", "sign", "reciprocal",
]


class _AbstractLeaf(Expr):
    """Shape/dtype-only leaf used to infer view avals without touching data."""

    __slots__ = ()

    def __init__(self, aval):
        self.aval = aval


class ndarray:
    __slots__ = ("_expr", "_base", "_view", "_aval", "_seq", "__weakref__")

    # win dispatch over numpy arrays in mixed expressions
    __array_priority__ = 100.0

    def __init__(self, expr: Optional[Expr] = None, base: "ndarray" = None,
                 view: ViewOp = None):
        self._seq = fuser.next_seq()
        self._base = base
        self._view = view
        self._expr = None
        if base is not None:
            self._aval = view.read(_AbstractLeaf(base._aval)).aval
        else:
            self._set_expr(expr)
            self._aval = expr.aval

    # -- expression plumbing --------------------------------------------------

    def _set_expr(self, new: Expr):
        self._expr = new
        if isinstance(new, Const):
            fuser.unregister_pending(self)
        else:
            fuser.register_pending(self)
            fuser.note_node_created()

    def read_expr(self) -> Expr:
        if self._base is None:
            return self._expr
        return self._view.read(self._base.read_expr())

    def write_expr(self, value: Expr):
        if self._base is None:
            self._set_expr(value)
        else:
            self._base.write_expr(
                self._view.write(self._base.read_expr(), value))

    # -- basic properties -----------------------------------------------------

    @property
    def shape(self):
        return tuple(self._aval.shape)

    @property
    def dtype(self):
        return np.dtype(self._aval.dtype)

    @property
    def ndim(self):
        return len(self._aval.shape)

    @property
    def size(self):
        return int(np.prod(self._aval.shape, dtype=np.int64))

    @property
    def nbytes(self):
        return self.size * self.dtype.itemsize

    @property
    def itemsize(self):
        return self.dtype.itemsize

    @property
    def T(self):
        return self.transpose()

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    # -- materialization ------------------------------------------------------

    def _value(self) -> torch.Tensor:
        """Concrete tensor for this array (flushes lazy work)."""
        if self._base is None:
            if not isinstance(self._expr, Const):
                fuser.flush()
            return self._expr.value
        return fuser.flush(extra=[self.read_expr()])[0]

    def asarray(self) -> np.ndarray:
        """Gather to a host NumPy array."""
        v = self._value()
        if not isinstance(v, torch.Tensor):
            return np.asarray(v, dtype=self.dtype)
        return E.tensor_to_numpy(v)

    def __array__(self, dtype=None, copy=None):
        a = self.asarray()
        return a.astype(dtype) if dtype is not None else a

    def item(self):
        return self.asarray().item()

    def tolist(self):
        return self.asarray().tolist()

    def __bool__(self):
        return bool(self.asarray())

    def __int__(self):
        return int(self.asarray())

    def __float__(self):
        return float(self.asarray())

    def __index__(self):
        return int(self.asarray())

    def __complex__(self):
        return complex(self.asarray())

    def __repr__(self):
        return (f"ramba_tpu_torch.ndarray({self.asarray()!r:.200s}, "
                f"shape={self.shape})")

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __hash__(self):
        return id(self)

    # -- elementwise helpers ---------------------------------------------------

    def _map(self, fname, *others, reverse=False):
        operands = [self.read_expr()] + [as_exprable(o) for o in others]
        if reverse:
            operands = operands[::-1]
        return ndarray(E.make_map(fname, operands))

    def _inplace_map(self, fname, other):
        val = E.make_map(fname, [self.read_expr(), as_exprable(other)])
        if np.dtype(val.dtype) != self.dtype:
            val = Node("cast", (str(self.dtype),), [val])
        self.write_expr(val)
        return self

    def astype(self, dtype, copy=True):
        return ndarray(Node("cast", (str(E.to_np_dtype(dtype)),),
                            [self.read_expr()]))

    def copy(self):
        return ndarray(self.read_expr())

    def fill(self, value):
        self.write_expr(Node("full", (self.shape, str(self.dtype), None),
                             [E.as_expr(value)]))

    def round(self, decimals=0):
        return ndarray(Node("round", (decimals,), [self.read_expr()]))

    def clip(self, a_min=None, a_max=None):
        out = self
        if a_min is not None:
            out = out._map("maximum", a_min)
        if a_max is not None:
            out = out._map("minimum", a_max)
        return out

    # -- reductions ------------------------------------------------------------

    def _reduce(self, fname, axis=None, keepdims=False, ddof=None):
        axis = _norm_axis(axis, self.ndim)
        return ndarray(Node("reduce", (fname, axis, bool(keepdims), ddof),
                            [self.read_expr()]))

    def var(self, axis=None, keepdims=False, ddof=0):
        return self._reduce("var", axis, keepdims, ddof)

    def std(self, axis=None, keepdims=False, ddof=0):
        return self._reduce("std", axis, keepdims, ddof)

    def argmin(self, axis=None):
        return self._reduce("argmin", axis)

    def argmax(self, axis=None):
        return self._reduce("argmax", axis)

    def _cumulative(self, fname, axis):
        # axis=None scans the flattened array, as NumPy does
        x = self.reshape(-1) if axis is None else self
        axis = 0 if axis is None else _norm_axis(axis, x.ndim)
        return ndarray(Node("cumulative", (fname, axis), [x.read_expr()]))

    def cumsum(self, axis=None):
        return self._cumulative("cumsum", axis)

    def cumprod(self, axis=None):
        return self._cumulative("cumprod", axis)

    def broadcast_to(self, shape):
        shape = (int(shape),) if isinstance(shape, (int, np.integer)) \
            else tuple(int(s) for s in shape)
        return ndarray(Node("broadcast_to", (shape,), [self.read_expr()]))

    # -- shape manipulation (views) -------------------------------------------

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = _fix_reshape(self.size, tuple(int(s) for s in shape))
        if shape == self.shape:
            return self
        return ndarray(base=self, view=ReshapeView(shape, self.shape))

    def ravel(self):
        return self.reshape(-1)

    def flatten(self):
        return self.reshape(-1).copy()

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        if not axes:
            axes = tuple(range(self.ndim))[::-1]
        axes = tuple(int(a) % self.ndim for a in axes)
        if axes == tuple(range(self.ndim)):
            return self
        return ndarray(base=self, view=PermuteView(axes))

    def swapaxes(self, a, b):
        axes = list(range(self.ndim))
        axes[a], axes[b] = axes[b], axes[a]
        return self.transpose(axes)

    def take(self, indices, axis=None, mode="clip"):
        if mode not in ("clip", "wrap"):
            raise NotImplementedError(f"take mode {mode!r} is not ported yet")
        x = self.reshape(-1) if axis is None else self
        axis = 0 if axis is None else int(axis) % x.ndim
        return ndarray(Node("take", (axis, mode),
                            [x.read_expr(), as_exprable(indices)]))

    # -- indexing --------------------------------------------------------------

    def __getitem__(self, idx):
        return ndarray(base=self, view=SliceView(_basic_index(idx, self.shape)))

    def __setitem__(self, idx, value):
        enc = _basic_index(idx, self.shape)
        self.write_expr(Node("setitem", (enc,),
                             [self.read_expr(), as_exprable(value)]))

    # -- numpy protocol -------------------------------------------------------

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        name = {"divide": "true_divide"}.get(ufunc.__name__, ufunc.__name__)
        if method != "__call__" or kwargs or name not in E.MAPFN:
            return NotImplemented
        return ndarray(E.make_map(name, [as_exprable(x) for x in inputs]))


def as_exprable(x) -> Expr:
    """Lift operands: ndarray -> its expression; numpy array or tensor ->
    Const on the process device; python scalar -> weakly typed Scalar."""
    if isinstance(x, ndarray):
        return x.read_expr()
    if isinstance(x, (list, tuple)):
        x = np.asarray(x)
    if isinstance(x, np.ndarray) and x.ndim == 0:
        x = x[()]
    return E.as_expr(x)


def _norm_axis(axis, ndim):
    if axis is None:
        return None
    if isinstance(axis, (tuple, list)):
        return tuple(int(a) % ndim for a in axis)
    return int(axis) % ndim


def _fix_reshape(size, shape):
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1], dtype=np.int64))
        shape = tuple(size // max(known, 1) if s == -1 else s for s in shape)
    return shape


def _basic_index(idx, shape) -> tuple:
    """Encode a basic index, bounds-checking static integers (NumPy raises
    IndexError where torch would too, but only at flush time)."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    n_ellipsis = sum(1 for it in idx if it is Ellipsis)
    if n_ellipsis > 1:
        raise IndexError("an index can only have a single ellipsis ('...')")
    if n_ellipsis:
        pos = next(p for p, it in enumerate(idx) if it is Ellipsis)
        n_real = sum(1 for i in idx if i is not None and i is not Ellipsis)
        idx = idx[:pos] + (slice(None),) * (len(shape) - n_real) + idx[pos + 1:]
    dim = 0
    for it in idx:
        if it is None:
            continue
        if isinstance(it, (int, np.integer)) and not isinstance(it, bool):
            if dim >= len(shape) or not -shape[dim] <= it < shape[dim]:
                raise IndexError(
                    f"index {int(it)} is out of bounds for axis {dim}")
        elif not isinstance(it, slice):
            raise NotImplementedError(
                "advanced and boolean indexing are not ported yet")
        dim += 1
    return E.encode_index(idx)


# ---------------------------------------------------------------------------
# operator installation
# ---------------------------------------------------------------------------


def _is_operand(x):
    return isinstance(x, (ndarray, np.ndarray, torch.Tensor, bool, int, float,
                          complex, np.generic, list))


def _install_operators():
    for pyname, fname in _BINOPS.items():
        def fwd(self, other, _f=fname):
            if not _is_operand(other):
                return NotImplemented
            return self._map(_f, other)

        def rev(self, other, _f=fname):
            if not _is_operand(other):
                return NotImplemented
            return self._map(_f, other, reverse=True)

        def inp(self, other, _f=fname):
            if not _is_operand(other):
                return NotImplemented
            return self._inplace_map(_f, other)

        setattr(ndarray, f"__{pyname}__", fwd)
        setattr(ndarray, f"__r{pyname}__", rev)
        setattr(ndarray, f"__i{pyname}__", inp)

    for pyname, fname in _CMPOPS.items():
        def cmp(self, other, _f=fname):
            if not _is_operand(other):
                return NotImplemented
            return self._map(_f, other)

        setattr(ndarray, f"__{pyname}__", cmp)

    for pyop, fname in _UNARY_OPS.items():
        def un(self, _f=fname):
            return self._map(_f)

        setattr(ndarray, pyop, un)

    for name in _UNARY_METHODS:
        fname = {"abs": "absolute"}.get(name, name)

        def meth(self, _f=fname):
            return self._map(_f)

        setattr(ndarray, name, meth)

    def _finish_reduce(r, dtype, out):
        if dtype is not None:
            r = r.astype(dtype)
        if out is not None:
            out.write_expr(r.read_expr())
            return out
        return r

    for red in ("sum", "prod", "mean"):
        def rmeth(self, axis=None, dtype=None, out=None, *, keepdims=False,
                  _f=red):
            return _finish_reduce(self._reduce(_f, axis, keepdims), dtype, out)

        setattr(ndarray, red, rmeth)

    for red in ("min", "max", "any", "all"):
        def rmeth2(self, axis=None, out=None, *, keepdims=False, _f=red):
            return _finish_reduce(self._reduce(_f, axis, keepdims), None, out)

        setattr(ndarray, red, rmeth2)


_install_operators()
