"""Algorithmic skeletons: smap / sreduce / sstencil / scumulative / spmd.

Counterpart of ``ramba_tpu/skeletons.py``.  A user kernel is plain Python
written against NumPy.  Every skeleton calls it through one route,
:func:`call_kernel`: its array arguments arrive wrapped in :class:`_KVal`,
so each operation (operators and the NumPy ufuncs a kernel may call)
follows NumPy's dtype rules through the port's rule table, never torch's
promotion, and the same call runs on the CPU and on the card.  A kernel
that branches on data (``x if x > 0 else -x``) is lowered by the two-sided
branch trace into a per-element ``where``; a kernel that converts a value
to a Python number cannot be traced:

* ``smap``/``smap_index`` evaluate the kernel on whole tensors, one
  :class:`_EVal` per operand (a value that behaves as one element: shape
  ``()``, no indexing), with int32 index planes; an untraceable kernel
  falls back, loudly (a warning once per kernel and the
  ``skeletons.host_fallback`` counter), to per-element evaluation on the
  host;
* ``sreduce`` maps with ``smap`` and folds halves after padding to a power
  of two with the identity (``_tree_reduce``), the order ``ramba_tpu``
  uses on one device;
* ``sstencil`` probes the body over symbolic taps
  (``ops/stencil_kernel.trace``) and runs it in the hand-written CUDA
  kernel, or over shifted static slices of the interior (border cells are
  zero);
* ``scumulative`` scans with ``jax.lax.associative_scan``'s odd/even
  recursion when the kernel is associative, else one vector step per
  position along the scan axis;
* ``spmd`` runs the kernel once with the whole array as its block (one
  card: one worker).  The mesh, the ``ppermute`` halo exchange and
  ``smap(axis=)``'s co-partitioning come with multi-GPU support.
"""

from __future__ import annotations

import threading
import warnings
from typing import Callable

import numpy as np
import torch

from ramba_tpu_torch.core import expr as E
from ramba_tpu_torch.core.expr import Aval, Node, defop
from ramba_tpu_torch.core.fuser import sync
from ramba_tpu_torch.core.ndarray import ndarray
from ramba_tpu_torch.ops.creation import asarray, full, zeros


class KernelTraceError(RuntimeError):
    """A user kernel did something that cannot be evaluated per element on
    tensors (a host conversion, a data-dependent loop, too many branch
    paths).  smap/smap_index fall back to host evaluation; the other
    skeletons let it surface."""


class KernelBranchError(KernelTraceError):
    """Specifically a data-dependent ``if``: the recoverable case, which the
    two-sided branch trace lowers to ``where``."""


_BRANCH_MSG = (
    "kernel has data-dependent control flow that the two-sided branch "
    "trace cannot express (simple `if x > 0:` branches are lowered to "
    "where(); a data-dependent loop count, a float()/int() conversion "
    "feeding control flow or too many branch paths are not). Rewrite it "
    "with np.where, or accept the slow host-evaluation fallback where the "
    "skeleton provides one (smap/smap_index)."
)

# skeletons.host_fallback: smap calls that ran per element on the host;
# skeletons.branch_lowered: kernel calls the branch trace lowered to where()
counters = {"skeletons.host_fallback": 0, "skeletons.branch_lowered": 0}

# --- two-sided branch tracing ------------------------------------------------
# A body that branches on data is re-run once per reachable branch path with
# forced decisions; the recorded conditions then combine the per-path
# results with nested where().  Both sides of every branch are evaluated.

_MAX_BRANCH_DEPTH = 16
_MAX_BRANCH_PATHS = 64

_active_decider = None


class _Decider:
    """One kernel execution's branch decisions: replays ``forced`` then
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
                "kernel exceeded the branch-enumeration depth limit "
                f"({_MAX_BRANCH_DEPTH}); a data-dependent loop cannot be "
                "lowered to where(). " + _BRANCH_MSG)
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
                f"kernel has over {_MAX_BRANCH_PATHS} branch paths. "
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


# --- kernel values -----------------------------------------------------------


class _KVal:
    """A tensor inside a user kernel.  Operators and NumPy ufuncs dispatch
    through ``expr.apply_map``, so dtypes follow NumPy's rules; ``bool()``
    goes to the branch decider; ``float()``/``int()`` cannot be traced."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __bool__(self):
        return decide(self)

    def __float__(self):
        raise KernelTraceError(
            "kernel converts a traced value to a Python float. " + _BRANCH_MSG)

    def __int__(self):
        raise KernelTraceError(
            "kernel converts a traced value to a Python int. " + _BRANCH_MSG)

    __index__ = __int__

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        name = {"divide": "true_divide"}.get(ufunc.__name__, ufunc.__name__)
        if method != "__call__" or kwargs or name not in E.MAPFN:
            return NotImplemented
        return _kmap(name, *inputs)

    def __array_function__(self, func, types, args, kwargs):
        # non-ufunc numpy functions a kernel may call (np.where, np.clip,
        # np.sinc, np.round, ...) reroute to the port's op table; any other
        # (np.sum, ...) is refused, so no kernel silently reduces across
        # elements
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
        if func in (np.round, np.around) and len(args) <= 2 and \
                set(kwargs) <= {"decimals"}:
            x, decimals = args[0], (args[1:] or [kwargs.get("decimals", 0)])[0]
            return type(x)(E.round_half_even(x.v, int(decimals)))
        return NotImplemented

    def __getitem__(self, idx):
        return type(self)(self.v[idx])

    def astype(self, dtype):
        return type(self)(E.as_tensor(self.v, E.to_np_dtype(dtype)))

    @property
    def shape(self):
        return tuple(self.v.shape)

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def dtype(self):
        return E.to_np_dtype(self.v.dtype)


class _EVal(_KVal):
    """One element of an ``smap`` operand.  The kernel runs once on whole
    tensors, but as ``ramba_tpu`` runs it under ``jnp.vectorize``, it sees
    a 0-d value: shape ``()``, no indexing, no iteration."""

    __slots__ = ()

    def __getitem__(self, idx):
        if idx == () or idx is Ellipsis:
            return self
        raise IndexError("too many indices: an smap kernel sees one element "
                         "(a 0-d value) per call")

    def __iter__(self):
        raise TypeError("iteration over a 0-d value: an smap kernel sees "
                        "one element per call")

    @property
    def shape(self):
        return ()


def _unwrap(x):
    return x.v if isinstance(x, _KVal) else x


def _kmap(fname, *operands):
    cls = next((type(o) for o in operands if isinstance(o, _KVal)), _KVal)
    return cls(E.apply_map(fname, [_unwrap(o) for o in operands]))


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


def _kwrap(vals, cls):
    def wrap(v):
        if isinstance(v, tuple):  # smap_index's index tuple
            return tuple(wrap(e) for e in v)
        return cls(v) if isinstance(v, torch.Tensor) else v

    return [wrap(v) for v in vals]


def call_kernel(func, *vals, cls=_KVal, count=True):
    """Call a user kernel: its tensors wrapped in ``cls`` (every skeleton,
    the CPU and the card take this one route).  A kernel that branches on
    data is lowered by the two-sided branch trace (counted in
    ``skeletons.branch_lowered`` when ``count``); a float()/int()
    conversion, a data-dependent loop count or a path explosion raises
    :class:`KernelTraceError`.  Returns a tensor, or the kernel's own value
    where it computed none (a python or numpy scalar)."""
    try:
        return _unwrap(func(*_kwrap(vals, cls)))
    except KernelBranchError:
        pass
    wrapped = _kwrap(vals, cls)
    try:
        leaves = _explore_branches(lambda: func(*wrapped))
    except TypeError as e:
        # a forced branch path reached something untraceable that the
        # first call did not
        raise KernelTraceError(_BRANCH_MSG) from e
    if count:
        counters["skeletons.branch_lowered"] += 1
    return _unwrap(_combine_branches(leaves, _kval_where))


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


# --- host fallback -----------------------------------------------------------
# Once-per-KERNEL warning state: a module-global boolean would warn for the
# first offending kernel only, and two threads racing it could drop the
# warning entirely.
_fallback_warn_lock = threading.Lock()
_fallback_warned_kernels: set = set()


def _warn_host_fallback_once(func) -> bool:
    """True exactly once per kernel (thread-safe): the caller should warn."""
    try:
        with _fallback_warn_lock:
            if func in _fallback_warned_kernels:
                return False
            _fallback_warned_kernels.add(func)
            return True
    except TypeError:  # unhashable callable: warn every time
        return True


def fallback_warned_kernels() -> frozenset:
    """Kernels that have taken (and warned about) the host fallback."""
    with _fallback_warn_lock:
        return frozenset(_fallback_warned_kernels)


def reset_fallback_warnings() -> None:
    """Re-arm the once-per-kernel warning."""
    with _fallback_warn_lock:
        _fallback_warned_kernels.clear()


def _host_call(func, slots, with_index, ndim):
    """``call_one(*element_values)``: the kernel on one element's host
    values (index components as python ints first)."""

    def call_one(*elem_vals):
        it = iter(elem_vals)
        idx = tuple(int(next(it)) for _ in range(ndim)) if with_index else None
        call_args = [next(it) if kind == "arr" else payload.v
                     for kind, payload in slots]
        return func(idx, *call_args) if with_index else func(*call_args)

    return call_one


def _host_dtype(func, slots, with_index, ndim, dtypes) -> np.dtype:
    """The host fallback's result dtype, declared before the data exists.
    A branching kernel can return different dtypes per branch, so probe at
    mixed-sign/zero samples and promote across them; ``_host_smap`` still
    checks that the real result casts to it."""
    call_one = _host_call(func, slots, with_index, ndim)
    found = []
    for sample_val in (1, -1, 0):
        try:
            samples = [np.zeros((), np.int64)] * ndim if with_index else []
            samples += [np.dtype(dtypes[payload]).type(sample_val)
                        for kind, payload in slots if kind == "arr"]
            found.append(np.result_type(call_one(*samples)))
        except Exception:  # noqa: BLE001 - e.g. the kernel needs real data
            pass
    return np.result_type(*found) if found else np.result_type(*dtypes)


def _host_smap(func, slots, with_index, arrs):
    """Per-element host evaluation of a kernel that cannot be traced (a
    float()/int() conversion, a data-dependent loop): correct for any
    kernel, but it copies every operand to the host and back, so it warns
    once per kernel.  The result returns to the operands' device."""
    if _warn_host_fallback_once(func):
        warnings.warn(
            f"smap kernel {getattr(func, '__name__', repr(func))} cannot be "
            "traced (data-dependent control flow or a host conversion); "
            "falling back to per-element host evaluation. Rewrite the "
            "branch with np.where to run on the device.")
    dev = arrs[0].device
    ndim = arrs[0].ndim
    out_dtype = _host_dtype(func, slots, with_index, ndim,
                            [E.to_np_dtype(a.dtype) for a in arrs])
    arrays = [E.tensor_to_numpy(a) for a in arrs]
    shape = np.broadcast_shapes(*[a.shape for a in arrays])
    call_one = _host_call(func, slots, with_index, ndim)
    # index planes as the device path builds them: over the main operand's
    # shape, broadcast with the operands
    ins = ([np.broadcast_to(ix, shape) for ix in np.indices(arrays[0].shape)]
           if with_index else [])
    ins += [np.broadcast_to(a, shape) for a in arrays]
    if not shape:
        res = np.asarray(call_one(*[a[()] for a in ins]))
    else:
        # an explicit loop and one promotion over the whole list:
        # np.vectorize would lock the dtype to the first element's branch
        vals = [call_one(*xs) for xs in zip(*[a.ravel() for a in ins])]
        res = np.asarray(vals).reshape(shape)
    if res.size == 0:
        res = np.zeros(shape, out_dtype)
    if res.dtype != out_dtype and not np.can_cast(res.dtype, out_dtype,
                                                  casting="same_kind"):
        raise KernelTraceError(
            f"host-fallback kernel returned dtype {res.dtype} where the "
            f"probe inferred {out_dtype}; annotate the kernel so every "
            "branch returns one dtype")
    return E.tensor_from_numpy(res.astype(out_dtype), dev)


# --- smap --------------------------------------------------------------------


def index_planes(shape, dev):
    """int32 index planes over ``shape``, as ``ramba_tpu``'s iotas: plane
    ``d`` varies along dim ``d`` and broadcasts along the others."""
    nd = len(shape)
    return tuple(
        torch.arange(n, dtype=torch.int32, device=dev).view(
            [n if k == d else 1 for k in range(nd)])
        for d, n in enumerate(shape))


def as_result(val, shape, dev) -> torch.Tensor:
    """A kernel's value as a contiguous tensor of ``shape``."""
    if not isinstance(val, torch.Tensor):
        val = E.as_tensor(val, dev=dev)
    if tuple(val.shape) != tuple(shape):
        val = val.expand(tuple(shape))
    return val.contiguous()


def _smap_values(func, slots, with_index, arrs, count=True):
    """The kernel over whole tensors through :func:`call_kernel`, each
    operand one :class:`_EVal`."""
    dev = arrs[0].device
    shape = tuple(np.broadcast_shapes(*[tuple(a.shape) for a in arrs]))
    call_args = [arrs[payload] if kind == "arr" else payload.v
                 for kind, payload in slots]
    if with_index:
        call_args = [index_planes(tuple(arrs[0].shape), dev)] + call_args
    return as_result(call_kernel(func, *call_args, cls=_EVal, count=count),
                     shape, dev)


def _eval_smap(static, *arrs):
    func, slots, with_index = static
    arrs = [a if isinstance(a, torch.Tensor) else E.as_tensor(a) for a in arrs]
    try:
        return _smap_values(func, slots, with_index, arrs)
    except KernelTraceError:
        counters["skeletons.host_fallback"] += 1
        return _host_smap(func, slots, with_index, arrs)


def _probe_tensors(avals):
    """One-element host tensors of the operands' dtypes and ranks: what the
    aval rules run a kernel on (no device work)."""
    return [torch.ones((1,) * len(a.shape), dtype=E.to_torch_dtype(a.dtype))
            for a in avals]


def _aval_smap(static, *avals):
    func, slots, with_index = static
    shape = tuple(np.broadcast_shapes(*[a.shape for a in avals]))
    try:
        val = _smap_values(func, slots, with_index, _probe_tensors(avals),
                           count=False)
        dt = E.to_np_dtype(val.dtype)
    except KernelTraceError:
        dt = _host_dtype(func, slots, with_index, len(avals[0].shape),
                         [a.dtype for a in avals])
    return Aval(shape, np.dtype(dt), False)


defop("smap", _aval_smap)(_eval_smap)


def _check_axis(args, axis):
    """smap's ``axis=`` names the dim its operands are co-partitioned
    along.  On one card nothing is partitioned: it is validated only."""
    if axis is None:
        return
    if isinstance(axis, bool) or not isinstance(axis, (int, np.integer)):
        raise TypeError(f"axis must be an int, got {axis!r}")
    for a in args:
        if isinstance(a, ndarray) and a.ndim and \
                not -a.ndim <= int(axis) < a.ndim:
            raise ValueError(
                f"axis {axis} out of range for {a.ndim}-D operand")


def _smap_node(func, arr, args, with_index, axis):
    arr = asarray(arr)
    _check_axis((arr,) + args, axis)
    slots, operands = _split_operands((arr,) + args)
    return ndarray(Node("smap", (func, tuple(slots), with_index), operands))


def smap(func: Callable, arr, *args, axis=None):
    """Apply ``func`` element by element.  Array args (port arrays) are
    element-aligned and broadcast; every other arg passes through whole
    (docs/index.md, smap)."""
    return _smap_node(func, arr, args, False, axis)


def smap_index(func: Callable, arr, *args, axis=None):
    """``smap`` whose kernel also receives the element's global index, a
    tuple of int32 values, as its first argument."""
    return _smap_node(func, arr, args, True, axis)


# --- fromfunction ------------------------------------------------------------


def fromfunction_values(fn, shape, dtype, dev, count=True):
    """``fn`` over int32 index planes of ``shape`` (whole arrays, as in
    ``ramba_tpu``), cast to ``dtype`` when one is given."""
    val = call_kernel(fn, *index_planes(tuple(shape), dev), count=count)
    if not isinstance(val, torch.Tensor):
        val = E.as_tensor(val, dev=dev)
    if dtype is not None:
        val = E.as_tensor(val, np.dtype(dtype))
    return as_result(val, shape, dev)


# --- sreduce -----------------------------------------------------------------


class SreduceReducer:
    """Worker-local and cross-worker reducers (reference: SreduceReducer).
    On one card there is one worker: the worker reducer folds everything
    and the cross-worker reducer has one partial, so it is never called."""

    def __init__(self, worker_reducer, driver_reducer):
        self.worker_reducer = worker_reducer
        self.driver_reducer = driver_reducer


def _tree_reduce(flat, identity, comb):
    """Fold halves after padding to a power of two with ``identity``: the
    combine is an ordinary elementwise call on two halves, so any kernel
    works, branch-lowered ones included."""
    n = flat.shape[0]
    size = 1 << max(0, int(n - 1).bit_length())
    if size != n:
        flat = torch.cat([flat, identity.expand(size - n)])
    while flat.shape[0] > 1:
        half = flat.shape[0] // 2
        flat = as_result(comb(flat[:half], flat[half:]), (half,), flat.device)
    return flat[0]


def _sreduce_value(static, mapped, count=True):
    reducer, identity = static
    flat = mapped.reshape(-1)
    ident = E.as_tensor(identity, E.to_np_dtype(flat.dtype), flat.device)
    return _tree_reduce(
        flat, ident, lambda a, b: call_kernel(reducer, a, b, count=count))


def _aval_sreduce(static, mapped):
    # two elements call the reducer once (one element never calls it)
    n = 1 if int(np.prod(mapped.shape, dtype=np.int64)) == 1 else 2
    t = torch.ones(n, dtype=E.to_torch_dtype(mapped.dtype))
    return Aval((), E.to_np_dtype(_sreduce_value(static, t, False).dtype), False)


defop("sreduce", _aval_sreduce)(
    lambda static, mapped: _sreduce_value(static, mapped))


def _sreduce_impl(func, reducer, identity, arr, args, with_index):
    mapped = _smap_node(func, arr, args, with_index, None)
    if isinstance(reducer, SreduceReducer):
        reducer = reducer.worker_reducer  # one worker: its tree is the total
    return ndarray(Node("sreduce", (reducer, identity), [mapped.read_expr()]))


def sreduce(func, reducer, identity, arr, *args):
    """Map ``func`` over the elements, then reduce with ``reducer`` (a
    two-argument kernel, or a :class:`SreduceReducer`) from ``identity``
    (docs/index.md, sreduce)."""
    return _sreduce_impl(func, reducer, identity, arr, args, False)


def sreduce_index(func, reducer, identity, arr, *args):
    return _sreduce_impl(func, reducer, identity, arr, args, True)


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
    val = call_kernel(func, *call_args)
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


# --- scumulative -------------------------------------------------------------


def _probe_associative(local_func, final_func) -> bool:
    """Whether the scan may take the associative (odd/even) order: a
    host-side probe with concrete floats.  ``combine(a, b) :=
    local_func(b, a)`` must be associative on mixed signs, zeros, integers
    and large/small magnitudes, and ``final_func(c, t)`` must equal
    ``combine(c, t)``.  Probing can never be a proof: pass
    ``associative=False`` to force the sequential scan, or ``True`` to skip
    the probe.  Any exception or mismatch means sequential."""
    try:
        rng = np.random.RandomState(7)
        trips = [
            (5.0, -7.0, 3.0),            # mixed sign (catches clamps)
            (-1.0, 2.0, -3.0),
            (0.0, 1.0, -1.0),            # zeros
            (0.0, 0.0, 0.0),
            (1e8, -3.7, 1e-4),           # large/small magnitude
            (-1e8, 1e8, 1.0),
            (7.0, -3.0, 2.0),            # integer-valued
            (2.0, 2.0, 2.0),
        ] + [tuple(t) for t in rng.uniform(-4.0, 4.0, size=(8, 3))]

        def comb(a, b):
            return float(local_func(np.float64(b), np.float64(a)))

        for a, b, c in trips:
            if not np.isclose(comb(comb(a, b), c), comb(a, comb(b, c)),
                              rtol=1e-9, atol=1e-12):
                return False
            if not np.isclose(float(final_func(np.float64(a), np.float64(b))),
                              comb(a, b), rtol=1e-9, atol=1e-12):
                return False
        return True
    except Exception:
        return False


def _same_dtype(y, want, what):
    if y.dtype != want:
        raise TypeError(
            f"scumulative: the kernel returned {E.to_np_dtype(y.dtype)} for "
            f"{E.to_np_dtype(want)} operands ({what}); the scan's carry "
            "keeps one dtype")


def associative_scan(comb, x):
    """Inclusive scan along dim 0 in ``jax.lax.associative_scan``'s order:
    combine adjacent pairs, scan those recursively, combine the scanned
    odds with the even elements, interleave.  ``comb(earlier, later)``."""
    n = x.shape[0]
    if n < 2:
        return x
    reduced = comb(x[0:-1:2], x[1::2])
    _same_dtype(reduced, x.dtype, "pairs")
    odd = associative_scan(comb, reduced)
    even = comb(odd[:-1] if n % 2 == 0 else odd, x[2::2])
    _same_dtype(even, x.dtype, "evens")
    out = torch.empty_like(x)
    out[0] = x[0]
    out[2::2] = even
    out[1::2] = odd
    return out


def sequential_scan(step, x):
    """``y[0] = x[0]``, ``y[i] = step(x[i], y[i-1])``: one vector step per
    position along dim 0 (``ramba_tpu``'s ``lax.scan`` whose first element
    passes unchanged).  Host-bound: a few launches per position."""
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    out[0] = x[0]
    for i in range(1, x.shape[0]):
        y = step(x[i], out[i - 1])
        _same_dtype(y, x.dtype, f"position {i}")
        out[i] = y
    return out


def _eval_scumulative(static, x):
    local_func, associative, axis = static
    x = x.movedim(axis, 0)  # scan along the leading axis

    def kernel(xi, carry):
        shape = np.broadcast_shapes(tuple(xi.shape), tuple(carry.shape))
        return as_result(call_kernel(local_func, xi, carry), shape, x.device)

    if associative:
        ys = associative_scan(lambda a, c: kernel(c, a), x)
    else:
        ys = sequential_scan(kernel, x)
    return ys.movedim(0, axis).contiguous()


defop("scumulative", lambda static, x: Aval(x.shape, x.dtype, False))(
    _eval_scumulative)


def scumulative(local_func, final_func, arr, axis=0, dtype=None, out=None,
                *, associative=None):
    """Inclusive scan of ``local_func(x_i, previous)`` along ``axis``
    (docs/index.md, scumulative); ``final_func(boundary, block)`` rebases a
    block on the previous block's last value, which only a scan split over
    devices needs.  ``dtype`` casts first; ``out=`` receives the result.
    ``associative=None`` probes the kernel (``_probe_associative``):
    associative kernels scan in the odd/even order, others one position
    at a time."""
    arr = asarray(arr)
    axis = int(axis)
    if not -arr.ndim <= axis < arr.ndim:
        raise ValueError(f"axis {axis} out of range for {arr.ndim}-D array")
    axis %= arr.ndim
    if dtype is not None and np.dtype(dtype) != arr.dtype:
        arr = arr.astype(dtype)
    if associative is None:
        associative = _probe_associative(local_func, final_func)
    # one card: the scan axis is never split, so final_func is not needed
    res = ndarray(Node("scumulative", (local_func, bool(associative), axis),
                       [arr.read_expr()]))
    if out is not None:
        if tuple(out.shape) != tuple(arr.shape):
            raise ValueError(
                f"out shape {out.shape} != array shape {arr.shape}")
        res = res if out.dtype == res.dtype else res.astype(out.dtype)
        out.write_expr(res.read_expr())
        return out
    return res


# --- spmd --------------------------------------------------------------------


def _int32(v):
    return full((), int(v), np.int32)


class LocalView:
    """One worker's view of an array inside ``spmd`` (reference:
    LocalNdarray, docs/index.md).  On one card the block is the whole
    array: ``global_start`` is zeros, ``local_valid`` the shape,
    ``valid_mask`` all True, and ``halo`` pads zeros beyond the global
    domain.  ``set_local`` is the functional write-back: the updated block
    replaces the source array after the call."""

    def __init__(self, block, global_start=None, global_shape=None):
        self._block = asarray(block)
        self._updated = None
        self._global_start = global_start
        self._global_shape = global_shape

    def get_local(self):
        return self._block if self._updated is None else self._updated

    def set_local(self, value):
        value = asarray(value)
        self._updated = value if value.dtype == self._block.dtype \
            else value.astype(self._block.dtype)

    @property
    def global_start(self):
        """Per-dim global index of this block's first element (int32)."""
        if self._global_start is None:
            raise ValueError("global_start is only available inside spmd")
        return self._global_start

    @property
    def global_shape(self):
        """Global shape of the array (ints)."""
        if self._global_shape is None:
            raise ValueError("global_shape is only available inside spmd")
        return self._global_shape

    @property
    def local_valid(self):
        """Per-dim count of valid rows in this block (int32): the block's
        shape, since one card never pads."""
        if self._global_start is None or self._global_shape is None:
            raise ValueError("local_valid is only available inside spmd")
        return tuple(_int32(max(0, min(g, b)))
                     for g, b in zip(self._global_shape, self._block.shape))

    def halo(self, depth):
        """The current block extended by ``depth`` cells per dim (an int or
        one per dim).  Every dim is whole on one card, so the cells beyond
        it lie beyond the global domain: zeros, at any depth."""
        if self._global_start is None:
            raise ValueError("halo() is only available inside spmd")
        x = self.get_local()
        nd = x.ndim
        if isinstance(depth, (int, np.integer)):
            depth = (int(depth),) * nd
        depth = tuple(depth)
        if len(depth) != nd or any(d < 0 for d in depth):
            raise ValueError(
                f"halo depth {depth!r} must be {nd} non-negative ints")
        if not any(depth):
            return x
        out = zeros(tuple(s + 2 * d for s, d in zip(x.shape, depth)), x.dtype)
        out[tuple(slice(d, d + s) for s, d in zip(x.shape, depth))] = x
        return out

    @property
    def valid_mask(self):
        """Bool mask over the block, True where the element is real data:
        everywhere on one card."""
        cur = self.get_local().shape
        if cur != self._block.shape:
            raise ValueError(
                f"valid_mask refers to the original {self._block.shape} "
                f"block but the local slab is now {cur}; read valid_mask "
                "before a shape-changing set_local(), or mask manually "
                "with local_valid")
        return full(cur, True, bool)

    @property
    def shape(self):
        return self.get_local().shape

    @property
    def dtype(self):
        return self.get_local().dtype


def worker_id():
    """Inside ``spmd``: this worker's linear index, int32 (one card: 0)."""
    return _int32(0)


def spmd(func, *args):
    """Run ``func`` once per worker with each port array argument as a
    :class:`LocalView` (docs/index.md, spmd).  One card is one worker: the
    block is the whole array, and each ``set_local`` replaces its array
    when ``func`` returns.  Other args pass through."""
    positions = [i for i, a in enumerate(args) if isinstance(a, ndarray)]
    arrays = [args[i] for i in positions]
    views = [LocalView(ndarray(a.read_expr()),
                       tuple(_int32(0) for _ in a.shape), a.shape)
             for a in arrays]
    call_args = list(args)
    for p, v in zip(positions, views):
        call_args[p] = v
    func(*call_args)
    for a, v in zip(arrays, views):
        if v._updated is None:
            continue
        new = v._updated
        if new.shape != a.shape:
            if new.ndim == a.ndim and all(n >= s for n, s in
                                          zip(new.shape, a.shape)):
                new = new[tuple(slice(0, s) for s in a.shape)]
            else:
                raise ValueError(
                    f"set_local gave a {new.shape} block for a {a.shape} "
                    "array")
        a.write_expr(new.read_expr())


def barrier():
    """Wait for every worker (reference: ramba.barrier): a device sync."""
    sync()
