"""The user-visible lazy array.

Counterpart of ``ramba_tpu/core/ndarray.py``: a thin handle over an
expression graph whose leaves are torch tensors.  A view holds its parent
plus a reversible view op; reads re-derive the expression from the
parent's current state and writes push an updated expression back through
the chain, which gives NumPy's view aliasing (``t = a.T; t += 1`` changes
``a``) on top of functional graph nodes.  Basic indexing gives such a view;
an index with an array in it gathers (``getitem_adv``) or scatters
(``setitem_adv``), and a boolean mask of the array's shape gives a
:class:`~ramba_tpu_torch.core.masked.MaskedArray`.

A realized array has a layout (``sharding``: a mesh and spec).  Its leaf
carries one where it was named (:func:`put_sharded`,
``fromarray(distribution=)``, a sharding hint); any other array has
``default_spec`` of the current mesh, as GSPMD lays out a program's
outputs.  Every position of a
mesh holds one device, so the storage is one tensor and each shard is a
view into it (``addressable_shards``): the lowering reads it whole at no
cost, and assembling it needs no copy.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ramba_tpu_torch.core import expr as E
from ramba_tpu_torch.core import fuser
from ramba_tpu_torch.core.expr import Const, Expr, Node
from ramba_tpu_torch.parallel import mesh as _mesh

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


class ndarray_flags:
    """The ``WRITEABLE`` flag, NumPy's way."""

    __slots__ = ("_arr",)

    def __init__(self, arr):
        self._arr = arr

    @property
    def writeable(self):
        return not self._arr._readonly

    @writeable.setter
    def writeable(self, value):
        arr = self._arr
        if value:
            # every ancestor must be writable: a write goes through them
            base = arr._base
            while base is not None:
                if base._readonly:
                    raise ValueError(
                        "cannot set WRITEABLE flag to True of this array")
                base = base._base
        arr._readonly = not value

    def __getitem__(self, name):
        if name in ("WRITEABLE", "writeable"):
            return self.writeable
        raise KeyError(name)

    def __setitem__(self, name, value):
        if name in ("WRITEABLE", "writeable"):
            self.writeable = value
        else:
            raise KeyError(name)


class ndarray:
    __slots__ = ("_expr", "_base", "_view", "_aval", "_seq", "_readonly",
                 "__weakref__")

    # win dispatch over numpy arrays in mixed expressions
    __array_priority__ = 100.0

    def __init__(self, expr: Optional[Expr] = None, base: "ndarray" = None,
                 view: ViewOp = None):
        self._seq = fuser.next_seq()
        self._base = base
        self._view = view
        self._expr = None
        # views of read-only arrays are read-only (numpy semantics)
        self._readonly = base._readonly if base is not None else False
        if base is not None:
            self._aval = view.read(_AbstractLeaf(base._aval)).aval
        else:
            self._set_expr(expr)
            self._aval = expr.aval

    # -- expression plumbing --------------------------------------------------

    def _set_expr(self, new: Expr):
        old = self._expr
        if isinstance(old, Const):
            fuser.owner_decref(old.value)
        self._expr = new
        if isinstance(new, Const):
            fuser.owner_incref(new)
            fuser.unregister_pending(self)
        else:
            fuser.register_pending(self)
            fuser.note_node_created()

    def __del__(self):
        # the memory governor's ledger forgets a leaf with its last owner
        try:
            if self._base is None and isinstance(self._expr, Const):
                fuser.owner_decref(self._expr.value)
        except Exception:  # interpreter shutdown: modules already gone
            pass

    def read_expr(self) -> Expr:
        if self._base is None:
            return self._expr
        return self._view.read(self._base.read_expr())

    def write_expr(self, value: Expr):
        # only the written array's own flag gates the write (a view taken
        # before its base was frozen stays writeable, as in NumPy)
        if self._readonly:
            raise ValueError("assignment destination is read-only")
        self._write_through(value)

    def _write_through(self, value: Expr):
        if self._base is None:
            self._set_expr(value)
        else:
            self._base._write_through(
                self._view.write(self._base.read_expr(), value))

    @property
    def flags(self):
        return ndarray_flags(self)

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

    @property
    def flat(self):
        return iter(self.reshape(-1).asarray())

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    # -- materialization ------------------------------------------------------

    def _const(self) -> Const:
        """The realized leaf of a base array (flushes lazy work)."""
        if not isinstance(self._expr, Const):
            fuser.flush()
        if not isinstance(self._expr, Const):
            # still lazy after a flush: a failed flush quarantined this
            # array; its graph runs again alone and raises its own error
            # if it is the broken one
            self._set_expr(fuser.realize(self._expr))
        return self._expr

    def _value(self) -> torch.Tensor:
        """Concrete tensor for this array (flushes lazy work).  On a mesh
        of ranks this is the whole array, gathered from every rank on
        every rank (counted as ``allgather``): :meth:`_block` reads the
        rank's own block without moving anything."""
        if self._base is None:
            c = self._const()
            return fuser.gather_const(c) if c.is_block else \
                fuser.leaf_value(c)
        return fuser.flush(extra=[self.read_expr()])[0]

    def _block(self) -> torch.Tensor:
        """This rank's block of the array (the whole array in one
        process), as its layout cuts it."""
        if self._base is None:
            c = self._const()
            if c.is_block:
                return fuser.leaf_value(c)
        v = self._value()
        if not isinstance(v, torch.Tensor) or v.ndim == 0:
            return v
        return v[self.sharding.local_index(self.shape)]

    @property
    def sharding(self) -> "_mesh.NamedSharding":
        """The layout of the realized array (flushes lazy work)."""
        if self._base is None and self._const().sharding is not None:
            return self._expr.sharding
        return _mesh.default_sharding(self.shape)

    @property
    def addressable_shards(self) -> list:
        """One :class:`Shard` per mesh position this process holds, in
        grid order: in one process every position, each block a view into
        the array's one tensor; on a mesh of ranks the rank's own block."""
        sh = self.sharding
        if sh.mesh.ranks is not None:
            b = self._block()
            return [Shard(pos, sh.mesh.devices[pos],
                          sh.block_index(pos, self.shape), b)
                    for pos in sh.mesh.local_positions()]
        v = self._value()
        return [Shard(pos, sh.mesh.devices[pos], idx, v[idx])
                for pos, idx in sh.shard_indices(self.shape)]

    def asarray(self) -> np.ndarray:
        """Gather to a host NumPy array (on a mesh of ranks every rank
        gathers the whole array)."""
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

    def conj(self):
        return self._map("conj")

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

    def reshape_copy(self, *shape):
        """A reshape that is a copy, not a view."""
        return self.reshape(*shape).copy()

    def squeeze(self, axis=None):
        if axis is None:
            newshape = tuple(s for s in self.shape if s != 1)
        else:
            axs = axis if isinstance(axis, tuple) else (axis,)
            axs = {int(a) % self.ndim for a in axs}
            if any(self.shape[a] != 1 for a in axs):
                raise ValueError("cannot select an axis to squeeze out which "
                                 "has size not equal to one")
            newshape = tuple(s for i, s in enumerate(self.shape)
                             if i not in axs)
        return self.reshape(newshape)

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
        """``clip`` (the default) clamps every index into range, ``wrap``
        takes it modulo the length, ``fill`` reads negative indices from the
        end and gives NaN, the signed minimum, the unsigned maximum or True
        for the rest; ``raise`` is refused, as ``jnp.take`` refuses it."""
        if mode == "raise":
            raise NotImplementedError(
                "The 'raise' mode to take is not supported: bounds are not "
                "checked on the device")
        if mode not in ("clip", "wrap", "fill"):
            raise ValueError(f"take: unknown mode {mode!r}")
        x = self.reshape(-1) if axis is None else self
        axis = 0 if axis is None else int(axis) % x.ndim
        return ndarray(Node("take", (axis, mode),
                            [x.read_expr(), as_exprable(indices)]))

    # -- indexing --------------------------------------------------------------

    def __getitem__(self, idx):
        kind, payload = _classify_index(idx, self.shape)
        if kind == "basic":
            return ndarray(base=self, view=SliceView(payload))
        if kind == "mask":
            from ramba_tpu_torch.core.masked import MaskedArray

            return MaskedArray(self, payload)
        # an index with arrays gathers: a copy, as in NumPy
        enc, arraypos, arrays = payload
        return ndarray(Node("getitem_adv", (enc, arraypos),
                            [self.read_expr()]
                            + [as_exprable(a) for a in arrays]))

    def __setitem__(self, idx, value):
        kind, payload = _classify_index(idx, self.shape)
        vexpr = as_exprable(value)
        if kind == "basic":
            self.write_expr(Node("setitem", (payload,),
                                 [self.read_expr(), vexpr]))
        elif kind == "mask":
            if np.dtype(vexpr.dtype) != self.dtype:
                vexpr = Node("cast", (str(self.dtype),), [vexpr])
            self.write_expr(Node("masked_fill", (),
                                 [self.read_expr(), payload.read_expr(),
                                  vexpr]))
        else:
            enc, arraypos, arrays = payload
            self.write_expr(Node("setitem_adv", (enc, arraypos),
                                 [self.read_expr(), vexpr]
                                 + [as_exprable(a) for a in arrays]))

    # -- linear algebra ----------------------------------------------------------

    def dot(self, other):
        from ramba_tpu_torch.ops import linalg

        return linalg.dot(self, other)

    def __matmul__(self, other):
        from ramba_tpu_torch.ops import linalg

        return linalg.matmul(self, other)

    def __rmatmul__(self, other):
        from ramba_tpu_torch.ops import linalg

        return linalg.matmul(other, self)

    # -- numpy protocol -------------------------------------------------------

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        """A NumPy ufunc of port arrays builds the port's node: a map for
        ``__call__`` (``matmul`` too, so ``np_array @ rt_array`` stays on
        the device), a reduction for ``reduce``.  ``out=`` writes a port
        array (cast to its dtype) or copies into a NumPy array with
        NumPy's ``same_kind`` rule; ``where=`` is not taken."""
        name = ufunc.__name__
        out = kwargs.pop("out", None)
        if kwargs.pop("where", True) is not True:
            return NotImplemented
        if method == "__call__":
            if kwargs:
                return NotImplemented
            if name == "divide":
                name = "true_divide"
            if name == "matmul":
                from ramba_tpu_torch.ops.linalg import matmul as _mm

                res = _mm(inputs[0], inputs[1])
            elif name not in E.MAPFN:
                return NotImplemented
            else:
                res = ndarray(E.make_map(name, [as_exprable(x)
                                                for x in inputs]))
        elif method == "reduce":
            ufunc_red = {"add": "sum", "multiply": "prod", "minimum": "min",
                         "maximum": "max", "logical_and": "all",
                         "logical_or": "any"}
            if name not in ufunc_red:
                return NotImplemented
            axis = kwargs.pop("axis", 0)
            keepdims = kwargs.pop("keepdims", False)
            dtype = kwargs.pop("dtype", None)
            if kwargs:
                return NotImplemented
            (x,) = inputs
            x = x if isinstance(x, ndarray) else ndarray(as_exprable(x))
            res = x._reduce(ufunc_red[name], axis, keepdims)
            if dtype is not None:
                res = res.astype(dtype)
        else:
            return NotImplemented
        if out is not None:
            (o,) = out if isinstance(out, tuple) else (out,)
            if isinstance(o, np.ndarray):
                np.copyto(o, res.asarray(), casting="same_kind")
                return o
            val = res.read_expr()
            if np.dtype(val.dtype) != o.dtype:
                val = Node("cast", (str(o.dtype),), [val])
            o.write_expr(val)
            return o
        return res

    def __array_function__(self, func, types, args, kwargs):
        """``numpy.<fn>`` of port arrays runs the port's function registered
        for it (``core/interop.py``); anything else gives
        ``NotImplemented``, so NumPy raises ``TypeError`` rather than
        running on the host."""
        from ramba_tpu_torch.core.interop import HANDLED_FUNCTIONS

        if func in HANDLED_FUNCTIONS:
            return HANDLED_FUNCTIONS[func](*args, **kwargs)
        return NotImplemented


class Shard(NamedTuple):
    """One shard of an array: its mesh position, device, global index and
    block (a view)."""

    position: tuple
    device: torch.device
    index: tuple
    data: torch.Tensor


def put_sharded(x, sharding) -> ndarray:
    """Upload a host array (or adopt a tensor) under ``sharding``.  The
    reference returns a ``jax.Array``; a torch tensor carries no layout, so
    the port returns the array, whose leaf carries it.  In one process the
    shards are views into one tensor on the mesh's device; on a mesh of
    ranks ``x`` is the same on every rank and each rank uploads only its
    own block (``make_array_from_callback``).  The memory governor makes
    room for the upload first (``memory.reserve_headroom``)."""
    if not isinstance(sharding, _mesh.NamedSharding):
        raise TypeError("put_sharded takes a parallel.mesh.NamedSharding, "
                        f"got {type(sharding).__name__}")
    dev = sharding.mesh.device
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    if len(sharding.spec) > x.ndim:
        raise ValueError(f"spec {sharding.spec} has more entries than the "
                         f"{x.ndim}-d array")
    from ramba_tpu_torch.resilience import memory

    if sharding.mesh.ranks is not None:
        shape = tuple(x.shape)
        block = x[sharding.local_index(shape)]
        # room for the upload: the governor spills cold leaves first
        memory.reserve_headroom(block.nbytes, site="put_sharded")
        t = block.to(dev).contiguous() if isinstance(block, torch.Tensor) \
            else E.tensor_from_numpy(block, dev)
        return ndarray(Const(t, sharding=sharding, shape=shape))
    memory.reserve_headroom(x.nbytes, site="put_sharded")
    t = x.to(dev) if isinstance(x, torch.Tensor) \
        else E.tensor_from_numpy(x, dev)
    return ndarray(Const(t, sharding=sharding))


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


def expand_ellipsis(idx: tuple, ndim: int) -> tuple:
    """Replace an Ellipsis with the full slices it stands for (identity
    checks: ``in`` would compare array items elementwise)."""
    n_ellipsis = sum(1 for it in idx if it is Ellipsis)
    if n_ellipsis > 1:
        raise IndexError("an index can only have a single ellipsis ('...')")
    if n_ellipsis:
        pos = next(p for p, it in enumerate(idx) if it is Ellipsis)
        n_real = sum(1 for i in idx if i is not None and i is not Ellipsis)
        idx = idx[:pos] + (slice(None),) * (ndim - n_real) + idx[pos + 1:]
    return idx


_INDEX_ARRAYS = (np.ndarray, list, torch.Tensor)


def _classify_index(idx, shape):
    """("basic", encoded index) | ("mask", bool ndarray) |
    ("adv", (encoded index with placeholders, array positions, arrays)).

    A boolean array of the whole index is a mask; any other array (or
    list) in the index makes it advanced.  Static integers of a basic
    index are bounds-checked here, as NumPy does; an advanced index is
    not (a gather clamps, a scatter drops)."""
    if isinstance(idx, ndarray) and idx.dtype == np.bool_:
        return "mask", idx
    if isinstance(idx, np.ndarray) and idx.dtype == np.bool_:
        return "mask", ndarray(as_exprable(idx))
    if not isinstance(idx, tuple):
        idx = (idx,)
    idx = expand_ellipsis(idx, len(shape))
    if not any(isinstance(i, (ndarray,) + _INDEX_ARRAYS) for i in idx):
        dim = 0
        for it in idx:
            if it is None:
                continue
            if isinstance(it, (int, np.integer)) and not isinstance(it, bool):
                if dim >= len(shape) or not -shape[dim] <= it < shape[dim]:
                    raise IndexError(
                        f"index {int(it)} is out of bounds for axis {dim} "
                        f"with size {shape[dim] if dim < len(shape) else 0}")
            elif not isinstance(it, slice):
                raise IndexError(
                    "only integers, slices (`:`), ellipsis (`...`), "
                    "numpy.newaxis (`None`) and integer or boolean arrays "
                    "are valid indices")
            dim += 1
        return "basic", E.encode_index(idx)
    enc, arraypos, arrays = [], [], []
    for p, it in enumerate(idx):
        if isinstance(it, (ndarray,) + _INDEX_ARRAYS):
            a = it if isinstance(it, (ndarray, torch.Tensor)) else np.asarray(it)
            kind = np.dtype(E.to_np_dtype(a.dtype)).kind
            if kind == "b":
                raise IndexError("boolean arrays inside an index tuple are "
                                 "not supported: index with one mask of the "
                                 "array's shape")
            if kind not in "iu":
                raise TypeError(f"arrays used as indices must be of integer "
                                f"type, not {a.dtype}")
            arraypos.append(p)
            arrays.append(a)
            enc.append(("i", 0))  # a placeholder, filled at evaluation
        elif it is None:
            enc.append(("n",))
        elif isinstance(it, slice):
            enc.append(("s", it.start, it.stop, it.step))
        else:
            enc.append(("i", int(it)))
    return "adv", (tuple(enc), tuple(arraypos), arrays)


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

    def _divmod(self, other):
        return self._map("floor_divide", other), self._map("mod", other)

    ndarray.__divmod__ = _divmod

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
