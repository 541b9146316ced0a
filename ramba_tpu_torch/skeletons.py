"""Algorithmic skeletons: the stencil half (``stencil``, ``sstencil``,
``sstencil_iterate``).

Counterpart of the stencil half of ``ramba_tpu/skeletons.py``.  A stencil
body is plain Python over relative-offset reads (``a[-1, 0] + a[1, 0]``):

* the offset probe runs it once over symbolic taps
  (``ops/stencil_kernel.trace``), which records the neighbourhood *and* the
  arithmetic as a tap expression; every branch path of a body that
  branches on data is visited, so the union of offsets is captured and the
  paths combine into a per-point ``where``;
* on a 2-D array whose body traced, the hand-written CUDA kernel evaluates
  it (``ops/stencil_kernel.run``); any other body runs on the shifted-slice
  path below, decided before anything launches.

The shifted-slice path evaluates the body over static slices of the whole
interior, wrapped in :class:`_KVal` so that every operation (operators and
the NumPy ufuncs a body may call) follows NumPy's dtype rules through the
port's rule table, never torch's promotion.  Border cells, whose
neighbourhood leaves the array, are zero.
"""

from __future__ import annotations

import numpy as np
import torch

from ramba_tpu_torch.core import expr as E
from ramba_tpu_torch.core.expr import Aval, Node, defop
from ramba_tpu_torch.core.ndarray import ndarray
from ramba_tpu_torch.ops.creation import asarray


class KernelTraceError(RuntimeError):
    """A stencil body did something that cannot be evaluated per point
    (a host conversion, a data-dependent loop, too many branch paths)."""


class KernelBranchError(KernelTraceError):
    """Specifically a data-dependent ``if``: the recoverable case, which the
    two-sided branch trace lowers to ``where``."""


_BRANCH_MSG = (
    "stencil body has data-dependent control flow that the two-sided branch "
    "trace cannot express (simple `if x > 0:` branches are lowered to "
    "where(); a data-dependent loop count, a float()/int() conversion "
    "feeding control flow or too many branch paths are not). Rewrite it "
    "with np.where."
)

# --- two-sided branch tracing ------------------------------------------------
# A body that branches on data is re-run once per reachable branch path with
# forced decisions; the recorded conditions then combine the per-path
# results with nested where().  Both sides of every branch are evaluated.

_MAX_BRANCH_DEPTH = 16
_MAX_BRANCH_PATHS = 64

_active_decider = None


class _Decider:
    """One body execution's branch decisions: replays ``forced`` then
    defaults to True, recording every decision and its condition."""

    __slots__ = ("forced", "decisions", "conds")

    def __init__(self, forced):
        self.forced = tuple(forced)
        self.decisions = []
        self.conds = []

    def decide(self, cond):
        i = len(self.decisions)
        if i >= _MAX_BRANCH_DEPTH:
            raise KernelTraceError(
                "stencil body exceeded the branch-enumeration depth limit "
                f"({_MAX_BRANCH_DEPTH}). " + _BRANCH_MSG)
        d = self.forced[i] if i < len(self.forced) else True
        self.decisions.append(d)
        self.conds.append(cond)
        return d


def decide(cond):
    """``bool()`` of a traced value: the active decider's choice, or
    :class:`KernelBranchError` outside a branch enumeration."""
    if _active_decider is not None:
        return _active_decider.decide(cond)
    raise KernelBranchError(_BRANCH_MSG)


def _explore_branches(run):
    """Enumerate every reachable branch path of ``run`` by re-running it
    under forced decisions.  Returns ``[(path, conds, result), ...]``."""
    global _active_decider
    leaves = []
    pending = [()]
    while pending:
        if len(leaves) >= _MAX_BRANCH_PATHS:
            raise KernelTraceError(
                f"stencil body has over {_MAX_BRANCH_PATHS} branch paths. "
                + _BRANCH_MSG)
        prefix = pending.pop()
        dec = _Decider(prefix)
        prev = _active_decider
        _active_decider = dec
        try:
            out = run()
        finally:
            _active_decider = prev
        path = tuple(dec.decisions)
        leaves.append((path, dec.conds, out))
        for d in range(len(prefix), len(path)):
            pending.append(path[:d] + (False,))
    return leaves


def _combine_branches(leaves, where):
    """Fold branch-path results into one value with nested
    ``where(cond, if_true, if_false)`` over the recorded conditions."""
    exact = {path: out for path, _c, out in leaves}
    cond_at = {}
    for path, conds, _o in leaves:
        for d in range(len(path)):
            cond_at.setdefault(path[:d], conds[d])

    def build(prefix):
        if prefix in exact:
            return exact[prefix]
        return where(cond_at[prefix], build(prefix + (True,)),
                     build(prefix + (False,)))

    return build(())


# --- values of the shifted-slice path ----------------------------------------


class _KVal:
    """A tensor inside a stencil body.  Operators and NumPy ufuncs dispatch
    through ``expr.apply_map``, so dtypes follow NumPy's rules; ``bool()``
    goes to the branch decider."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __bool__(self):
        return decide(self)

    def __float__(self):
        raise KernelTraceError(
            "stencil body converts a per-point value to a Python float. "
            + _BRANCH_MSG)

    def __int__(self):
        raise KernelTraceError(
            "stencil body converts a per-point value to a Python int. "
            + _BRANCH_MSG)

    __index__ = __int__

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        name = {"divide": "true_divide"}.get(ufunc.__name__, ufunc.__name__)
        if method != "__call__" or kwargs or name not in E.MAPFN:
            return NotImplemented
        return _kmap(name, *inputs)

    def __array_function__(self, func, types, args, kwargs):
        # non-ufunc numpy functions a body may call (np.where, np.clip,
        # np.sinc, ...) reroute to the port's op table
        if func is np.where and len(args) == 3 and not kwargs:
            return _kmap("where", *args)
        if func.__name__ in E.MAPFN and not kwargs:
            return _kmap(func.__name__, *args)
        if func is np.clip and not kwargs:
            x, lo, hi = (list(args) + [None, None])[:3]
            if lo is not None:
                x = _kmap("maximum", x, lo)
            if hi is not None:
                x = _kmap("minimum", x, hi)
            return x
        return NotImplemented

    def __getitem__(self, idx):
        return _KVal(self.v[idx])

    @property
    def shape(self):
        return tuple(self.v.shape)

    @property
    def dtype(self):
        return E.to_np_dtype(self.v.dtype)


def _unwrap(x):
    return x.v if isinstance(x, _KVal) else x


def _kmap(fname, *operands):
    return _KVal(E.apply_map(fname, [_unwrap(o) for o in operands]))


def _small_int_power(x, e):
    """``x ** e`` for a literal int 1 <= e <= 4 as a multiply chain, as
    ``expr.make_map`` builds it and ``jnp``'s integer power computes it."""
    out = x
    for _ in range(int(e) - 1):
        out = _kmap("multiply", out, x)
    return out


def _is_small_int(e):
    return (isinstance(e, (int, np.integer))
            and not isinstance(e, (bool, np.bool_)) and 1 <= int(e) <= 4)


def _install_kval_ops():
    binops = {
        "add": "add", "sub": "subtract", "mul": "multiply",
        "truediv": "true_divide", "floordiv": "floor_divide", "mod": "mod",
        "pow": "power", "and": "bitwise_and", "or": "bitwise_or",
        "xor": "bitwise_xor", "lt": "less", "le": "less_equal",
        "gt": "greater", "ge": "greater_equal", "eq": "equal",
        "ne": "not_equal",
    }
    for name, fname in binops.items():
        def fwd(self, other, _f=fname):
            if _f == "power" and _is_small_int(other) \
                    and self.v.dtype != torch.bool:
                return _small_int_power(self, other)
            return _kmap(_f, self, other)

        def rev(self, other, _f=fname):
            return _kmap(_f, other, self)

        setattr(_KVal, f"__{name}__", fwd)
        if name not in ("lt", "le", "gt", "ge", "eq", "ne"):
            setattr(_KVal, f"__r{name}__", rev)
    for name, fname in {"neg": "negative", "pos": "positive",
                        "abs": "absolute", "invert": "invert"}.items():
        def un(self, _f=fname):
            return _kmap(_f, self)

        setattr(_KVal, f"__{name}__", un)
    _KVal.__hash__ = object.__hash__


_install_kval_ops()


def _kval_where(c, t, f):
    return _kmap("where", c, t, f)


class _Lit:
    """Identity-hashed wrapper so unhashable literals (e.g. whole numpy
    arrays passed through to the body) can live in a node's static tuple."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


def _split_operands(args):
    """Partition skeleton args into element-aligned array operands and
    pass-through literals."""
    slots = []  # ("arr", operand_index) | ("lit", _Lit)
    operands = []
    for a in args:
        if isinstance(a, ndarray):
            slots.append(("arr", len(operands)))
            operands.append(a.read_expr())
        else:
            slots.append(("lit", _Lit(a)))
    return slots, operands


class _ShiftProxy:
    """Relative indexing over the interior window: ``a[di, dj]`` is the
    static slice of the whole interior shifted by (di, dj)."""

    def __init__(self, arr, lo, interior):
        self.arr = arr
        self.lo = lo
        self.interior = interior

    def __getitem__(self, off):
        if not isinstance(off, tuple):
            off = (off,)
        idx = tuple(slice(o - l, o - l + n)
                    for o, l, n in zip(off, self.lo, self.interior))
        return _KVal(self.arr[idx])


def call_stencil_body(func, call_args):
    """Evaluate a stencil body on ``call_args``; a data branch is lowered by
    the two-sided branch trace.  Returns a tensor (or a python scalar for
    a body that reads nothing)."""
    try:
        return _unwrap(func(*call_args))
    except KernelBranchError:
        pass
    leaves = _explore_branches(lambda: func(*call_args))
    return _unwrap(_combine_branches(leaves, _kval_where))


def _interior(shape, lo, hi):
    return tuple(s - (h - l) for s, l, h in zip(shape, lo, hi))


def stencil_interior(func, lo, hi, slots, arrs):
    """The body over the interior window of ``arrs`` by shifted static
    slices: the raw interior values, no border zeroing."""
    interior = _interior(arrs[0].shape, lo, hi)
    call_args = [
        _ShiftProxy(arrs[payload], lo, interior) if kind == "arr"
        else payload.v
        for kind, payload in slots
    ]
    val = call_stencil_body(func, call_args)
    if not isinstance(val, torch.Tensor):
        val = E.as_tensor(val, dev=arrs[0].device).expand(interior)
    return val


def shifted_slice_stencil(func, lo, hi, slots, arrs):
    """The whole stencil on the shifted-slice path: interior values placed
    into a zero array of the input's shape (border cells are zero)."""
    shape = tuple(arrs[0].shape)
    interior = _interior(shape, lo, hi)
    val = stencil_interior(func, lo, hi, slots, arrs)
    out = torch.zeros(shape, dtype=val.dtype, device=val.device)
    if all(n > 0 for n in interior):
        out[tuple(slice(-l, -l + n) for l, n in zip(lo, interior))] = val
    return out


# --- graph ops ---------------------------------------------------------------


def _stencil_kernel_family(arrs):
    from ramba_tpu_torch.ops import kernel_backend

    if len(arrs[0].shape) != 2:
        return None
    return kernel_backend.family("stencil")


def _eval_stencil(static, *arrs):
    func, lo, hi, slots, _taps = static
    fam = _stencil_kernel_family(arrs)
    if fam is not None and fam.available(func, lo, hi, slots, arrs):
        return fam.run(func, lo, hi, slots, arrs)
    return shifted_slice_stencil(func, lo, hi, slots, arrs)


_sweep_dtypes: dict = {}
_SWEEP_DTYPES_MAX = 256


def _sweep_dtype(func, lo, hi, slots, dtypes):
    """Result dtype of one sweep, from the body run on tiny host tensors
    (no device work; not meta tensors, whose first use imports
    ``torch._dynamo`` for seconds).  Cached for bodies without literal
    args, since every ``sstencil`` node asks."""
    key = None
    if all(kind == "arr" for kind, _ in slots):
        key = (func, tuple(lo), tuple(hi), tuple(slots),
               tuple(str(d) for d in dtypes))
        hit = _sweep_dtypes.get(key)
        if hit is not None:
            return hit
    small = tuple(h - l + 1 for l, h in zip(lo, hi))
    arrs = [torch.zeros(small, dtype=E.to_torch_dtype(d), device="cpu")
            for d in dtypes]
    dt = E.to_np_dtype(stencil_interior(func, lo, hi, slots, arrs).dtype)
    if key is not None:
        if len(_sweep_dtypes) >= _SWEEP_DTYPES_MAX:
            _sweep_dtypes.pop(next(iter(_sweep_dtypes)))
        _sweep_dtypes[key] = dt
    return dt


def _aval_stencil(static, *avals):
    func, lo, hi, slots = static[:4]
    dt = _sweep_dtype(func, lo, hi, slots, [a.dtype for a in avals])
    return Aval(tuple(avals[0].shape), dt, False)


defop("stencil", _aval_stencil)(_eval_stencil)


def _eval_stencil_iter(static, *arrs):
    """``iters`` sweeps: a loop of launches over two ping-pong buffers on
    the kernel path, a loop of shifted-slice sweeps otherwise.  The carry
    starts in the single-sweep output dtype, so the result matches
    ``iters`` chained ``sstencil`` calls."""
    func, lo, hi, slots, taps, iters = static
    one = (func, lo, hi, slots, taps)
    out_dt = E.to_torch_dtype(
        _sweep_dtype(func, lo, hi, slots, [E.to_np_dtype(a.dtype) for a in arrs]))
    a0 = arrs[0] if arrs[0].dtype == out_dt else arrs[0].to(out_dt)
    rest = list(arrs[1:])
    fam = _stencil_kernel_family(arrs)
    if fam is not None and iters > 0 and \
            fam.available(func, lo, hi, slots, [a0] + rest):
        from ramba_tpu_torch.ops import stencil_kernel

        return stencil_kernel.run_iterate(func, lo, hi, slots, a0, rest, iters)
    a = a0
    for _ in range(iters):
        a = _eval_stencil(one, a, *rest)
    return a


defop("stencil_iter", _aval_stencil)(_eval_stencil_iter)


# --- user surface ------------------------------------------------------------


class StencilKernel:
    """Result of the ``stencil`` decorator.  Callable directly on host
    arrays, or over port arrays through ``sstencil``."""

    def __init__(self, func):
        self.func = func
        self._probe_cache = None
        self._probe_key = None

    def neighborhood(self, slots):
        """``(lo, hi, taps)`` of the body, from the symbolic probe
        (``stencil_kernel.trace``), which visits every branch path so a
        branching body records the union of its offsets.  Cached when the
        body takes no literal args (their values can steer the reads)."""
        from ramba_tpu_torch.ops import stencil_kernel

        has_literals = any(kind == "lit" for kind, _ in slots)
        cache_key = None if has_literals else tuple(k for k, _ in slots)
        if (has_literals or self._probe_cache is None
                or self._probe_key != cache_key):
            try:
                tr = stencil_kernel.trace(self.func, slots)
            except Exception as e:  # the body must be offset-indexing only
                raise ValueError(
                    f"could not probe stencil kernel {self.func}: {e}") from e
            self._probe_cache = (tr.lo, tr.hi, tr.taps)
            self._probe_key = cache_key
        return self._probe_cache

    def __call__(self, *args):
        # direct call on host arrays (numpy in, numpy out)
        slots, operands = [], []
        for a in args:
            if isinstance(a, (np.ndarray, list)):
                slots.append(("arr", len(operands)))
                operands.append(E.tensor_from_numpy(np.asarray(a)))
            else:
                slots.append(("lit", _Lit(a)))
        lo, hi, taps = self.neighborhood(tuple(slots))
        out = _eval_stencil((self.func, lo, hi, tuple(slots), taps), *operands)
        return E.tensor_to_numpy(out)


def stencil(func=None, **kwargs):
    """Decorator: mark a function of relative-offset reads as a stencil."""
    if func is None:
        return lambda f: StencilKernel(f)
    return StencilKernel(func)


def _stencil_node(st, arr, args):
    if not isinstance(st, StencilKernel):
        st = StencilKernel(st)
    arr = asarray(arr)
    full_args = [arr] + [
        asarray(a) if isinstance(a, (np.ndarray, list)) else a for a in args
    ]
    slots, operands = _split_operands(tuple(full_args))
    lo, hi, taps = st.neighborhood(tuple(slots))
    if len(lo) != arr.ndim:
        raise ValueError(
            f"stencil kernel indexes {len(lo)} dims but array has {arr.ndim}")
    return st, lo, hi, slots, taps, operands


def sstencil(st, arr, *args):
    """Apply a stencil once.  Border cells of the output (no full
    neighbourhood in range) are zero.  Extra args may be arrays
    (element-aligned, relative-indexed) or literals of any type."""
    st, lo, hi, slots, taps, operands = _stencil_node(st, arr, args)
    return ndarray(
        Node("stencil", (st.func, lo, hi, tuple(slots), taps), operands))


def sstencil_iterate(st, arr, iters, *args):
    """``iters`` stencil sweeps as one graph node (extra args are
    loop-invariant); the same result as ``iters`` chained ``sstencil``
    calls, border cells re-zeroed every sweep."""
    iters = int(iters)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    st, lo, hi, slots, taps, operands = _stencil_node(st, arr, args)
    return ndarray(
        Node("stencil_iter", (st.func, lo, hi, tuple(slots), taps, iters),
             operands))
