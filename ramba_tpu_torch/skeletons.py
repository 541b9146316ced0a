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

import itertools
import math
import threading
import warnings
from typing import Callable

import numpy as np
import torch

from ramba_tpu_torch import common
from ramba_tpu_torch.core import expr as E
from ramba_tpu_torch.core.expr import Aval, Node, defop
from ramba_tpu_torch.core.fuser import sync
from ramba_tpu_torch.core.ndarray import ndarray
from ramba_tpu_torch.observe import registry as _registry
from ramba_tpu_torch.ops.creation import asarray, full, zeros
from ramba_tpu_torch.parallel import mesh as _mesh


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


def _host_smap(func, slots, with_index, arrs, starts=None):
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
    ins = ([np.broadcast_to(ix + st, shape) for ix, st in zip(
        np.indices(arrays[0].shape), starts or (0,) * ndim)]
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


def index_planes(shape, dev, starts=None):
    """int32 index planes over ``shape``, as ``ramba_tpu``'s iotas: plane
    ``d`` varies along dim ``d`` and broadcasts along the others; a block
    at ``starts`` gets its global indices."""
    nd = len(shape)
    starts = starts or (0,) * nd
    return tuple(
        torch.arange(s, s + n, dtype=torch.int32, device=dev).view(
            [n if k == d else 1 for k in range(nd)])
        for d, (n, s) in enumerate(zip(shape, starts)))


def as_result(val, shape, dev) -> torch.Tensor:
    """A kernel's value as a contiguous tensor of ``shape``."""
    if not isinstance(val, torch.Tensor):
        val = E.as_tensor(val, dev=dev)
    if tuple(val.shape) != tuple(shape):
        val = val.expand(tuple(shape))
    return val.contiguous()


def _smap_values(func, slots, with_index, arrs, count=True, starts=None):
    """The kernel over whole tensors through :func:`call_kernel`, each
    operand one :class:`_EVal` (a rank's block at ``starts`` sees its
    global indices)."""
    dev = arrs[0].device
    shape = tuple(np.broadcast_shapes(*[tuple(a.shape) for a in arrs]))
    call_args = [arrs[payload] if kind == "arr" else payload.v
                 for kind, payload in slots]
    if with_index:
        call_args = [index_planes(tuple(arrs[0].shape), dev, starts)] + \
            call_args
    return as_result(call_kernel(func, *call_args, cls=_EVal, count=count),
                     shape, dev)


def _eval_smap(static, *arrs):
    func, slots, with_index = static[:3]
    starts = static[3] if len(static) > 3 else None
    arrs = [a if isinstance(a, torch.Tensor) else E.as_tensor(a) for a in arrs]
    try:
        return _smap_values(func, slots, with_index, arrs, starts=starts)
    except KernelTraceError:
        counters["skeletons.host_fallback"] += 1
        return _host_smap(func, slots, with_index, arrs, starts)


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
# one rank's block of an smap_index: ``static`` + the block's global start
# (``core/rankflush.py``)
defop("smap_block")(_eval_smap)


def _constrain(args, axis):
    """smap's ``axis=`` co-partitions its array operands along that dim
    (``parallel.constraints.add_constraint``)."""
    if axis is None:
        return
    if isinstance(axis, bool) or not isinstance(axis, (int, np.integer)):
        raise TypeError(f"axis must be an int, got {axis!r}")
    for a in args:
        if isinstance(a, ndarray) and a.ndim and \
                not -a.ndim <= int(axis) < a.ndim:
            raise ValueError(
                f"axis {axis} out of range for {a.ndim}-D operand")
    from ramba_tpu_torch.parallel.constraints import add_constraint

    add_constraint([a for a in args if isinstance(a, ndarray)], int(axis))


def _smap_node(func, arr, args, with_index, axis):
    arr = asarray(arr)
    _constrain((arr,) + args, axis)
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


def fromfunction_values(fn, shape, dtype, dev, count=True, starts=None):
    """``fn`` over int32 index planes of ``shape`` (whole arrays, as in
    ``ramba_tpu``; a block at ``starts``), cast to ``dtype`` when one is
    given."""
    val = call_kernel(fn, *index_planes(tuple(shape), dev, starts),
                      count=count)
    if not isinstance(val, torch.Tensor):
        val = E.as_tensor(val, dev=dev)
    if dtype is not None:
        val = E.as_tensor(val, np.dtype(dtype))
    return as_result(val, shape, dev)


# --- sreduce -----------------------------------------------------------------


class SreduceReducer:
    """Worker-local and cross-worker reducers (reference: SreduceReducer):
    each shard folds its block with ``worker_reducer``, then
    ``driver_reducer`` folds the shards' partials.  On a one-shard mesh
    there is one partial, so the driver reducer is never called."""

    def __init__(self, worker_reducer, driver_reducer):
        self.worker_reducer = worker_reducer
        self.driver_reducer = driver_reducer


def _tree_reduce(x, identity, comb):
    """Fold halves of the last dim after padding it to a power of two with
    ``identity``: the combine is an ordinary elementwise call on two
    halves, so any kernel works, branch-lowered ones included.  Each row of
    a 2-D ``x`` folds alone, in the order a 1-D fold of it takes."""
    n = x.shape[-1]
    size = 1 << max(0, int(n - 1).bit_length())
    if size != n:
        x = torch.cat([x, identity.expand(*x.shape[:-1], size - n)], dim=-1)
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = as_result(comb(x[..., :half], x[..., half:]),
                      x.shape[:-1] + (half,), x.device)
    return x[..., 0]


def _sreduce_value(static, mapped, count=True):
    worker, across, identity, split = static
    flat = mapped.reshape(-1)
    ident = E.as_tensor(identity, E.to_np_dtype(flat.dtype), flat.device)

    def fold(fn):
        return lambda a, b: call_kernel(fn, a, b, count=count)

    n = _mesh.num_workers()
    if not split or n == 1:
        return _tree_reduce(flat, ident, fold(worker))
    # a SreduceReducer: the flat data, padded with the identity to a
    # multiple of the shard count, split evenly (row k is shard k's block,
    # as ramba_tpu's shard_map splits it); every block folds with the
    # worker reducer (all rows at once, each in its own order), then the
    # partials fold with the cross-shard one
    pad = (-flat.shape[0]) % n
    if pad:
        flat = torch.cat([flat, ident.expand(pad)])
    partials = _tree_reduce(flat.reshape(n, -1), ident, fold(worker))
    return _tree_reduce(partials, ident, fold(across))


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
        static = (reducer.worker_reducer, reducer.driver_reducer, identity,
                  True)
    else:
        static = (reducer, reducer, identity, False)
    return ndarray(Node("sreduce", static, [mapped.read_expr()]))


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
    from ramba_tpu_torch.ops import stencil_sharded

    if stencil_sharded.eligible(lo, hi, arrs):
        return stencil_sharded.run(func, lo, hi, slots, arrs)
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
    from ramba_tpu_torch.ops import stencil_sharded

    if stencil_sharded.eligible(lo, hi, arrs):
        return stencil_sharded.run(func, lo, hi, slots, [a0] + rest, iters)
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


@defop("stencil_block")
def _eval_stencil_block(static, *blocks):
    """One rank's block of a stencil (``sstencil``) or of ``iters`` sweeps
    (``sstencil_iterate``) over a mesh of ranks (``core/rankflush.py``):
    halos over send/recv, the kernel on the extended block."""
    from ramba_tpu_torch.ops import stencil_sharded

    (func, lo, hi, slots, _taps), iters, shape, sharding = static
    if iters is None:
        return stencil_sharded.run_block(func, lo, hi, slots, blocks, shape,
                                         sharding)
    out_dt = E.to_torch_dtype(_sweep_dtype(
        func, lo, hi, slots, [E.to_np_dtype(b.dtype) for b in blocks]))
    a0 = blocks[0] if blocks[0].dtype == out_dt else blocks[0].to(out_dt)
    return stencil_sharded.run_block(func, lo, hi, slots,
                                     [a0] + list(blocks[1:]), shape,
                                     sharding, iters)


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


class _OpRec:
    """Stands in for a kernel argument to see whether the kernel is one
    ``+`` or one ``*`` of its two arguments (:func:`_scan_kind`)."""

    def __init__(self, name):
        self.name = name

    def _op(self, op, other, right=False):
        o = getattr(other, "name", other)
        return (op, o, self.name) if right else (op, self.name, o)

    def __add__(self, o):
        return self._op("add", o)

    def __radd__(self, o):
        return self._op("add", o, True)

    def __mul__(self, o):
        return self._op("mul", o)

    def __rmul__(self, o):
        return self._op("mul", o, True)


def _scan_kind(local_func, final_func):
    """"cumsum"/"cumprod" when ``local_func(x, carry)`` is ``x + carry``
    (``x * carry``) and ``final_func(carry, block)`` the same operation:
    a scan the scan kernel computes.  None otherwise."""
    try:
        loc = local_func(_OpRec("v"), _OpRec("c"))
        fin = final_func(_OpRec("c"), _OpRec("b"))
    except Exception:  # the kernel does more than one + or *
        return None
    for op, kind in (("add", "cumsum"), ("mul", "cumprod")):
        if loc in ((op, "v", "c"), (op, "c", "v")) and \
                fin in ((op, "b", "c"), (op, "c", "b")):
            return kind
    return None


def _block_scans(blocks, local_func, final_func, local_scan):
    """Each rank's block scanned along dim 0: on the scan kernel
    (``ops/scan.py``: its plain version on CPU tensors) when the kernel is
    a sum or product of floats, else by ``local_scan``."""
    from ramba_tpu_torch.ops import scan

    kind = _scan_kind(local_func, final_func)
    if kind is not None and blocks and blocks[0].dtype in scan.DTYPES:
        return [scan.run(b.contiguous(), kind, 0) if b.shape[0] else b
                for b in blocks]
    return [local_scan(b) if b.shape[0] else b for b in blocks]


def _eval_scumulative(static, x):
    local_func, final_func, associative, axis, distribute = static
    x = x.movedim(axis, 0)  # scan along the leading axis
    n, rest = x.shape[0], tuple(x.shape[1:])

    def call(fn, a, b):
        shape = np.broadcast_shapes(tuple(a.shape), tuple(b.shape))
        return as_result(call_kernel(fn, a, b), shape, x.device)

    def kernel(xi, carry):
        return call(local_func, xi, carry)

    def local_scan(b):
        if associative:
            return associative_scan(lambda a, c: kernel(c, a), b)
        return sequential_scan(kernel, b)

    nsh = _mesh.num_workers()
    if not distribute or nsh == 1 or n < nsh * 2:
        return local_scan(x).movedim(0, axis).contiguous()
    # Per-shard scans, then the carry fix-up: x padded to a multiple of
    # the shard count and split evenly along the scan axis; every shard's
    # block scans at once (dim 1 holds the shards, each in its own order),
    # the shard totals fold in shard order with final_func into exclusive
    # carries, and every shard but the first rebases its block on its
    # carry.  ramba_tpu all-gathers the totals: counted as it counts them.
    pad = (-n) % nsh
    if pad:
        x = torch.cat([x, torch.zeros((pad,) + rest, dtype=x.dtype,
                                      device=x.device)])
    _registry.inc("skeletons.scan_allgather_bytes_est",
                  nsh * nsh * int(np.prod(rest, dtype=np.int64))
                  * x.element_size())
    ys = local_scan(x.reshape((nsh, -1) + rest).movedim(0, 1))
    ts = ys[-1]
    carries = [ts[0]]
    for j in range(1, nsh - 1):
        carries.append(call(final_func, carries[-1], ts[j]))
    ys[:, 1:] = call(final_func, torch.stack(carries), ys[:, 1:])
    out = ys.movedim(1, 0).reshape((n + pad,) + rest)[:n]
    return out.movedim(0, axis).contiguous()


defop("scumulative", lambda static, x: Aval(x.shape, x.dtype, False))(
    _eval_scumulative)


@defop("scumulative_block")
def _eval_scumulative_block(static, x):
    """One rank's block of an ``scumulative`` over a mesh of ranks
    (``core/rankflush.py``): where the scan axis is split, the block scans
    along it (on the scan kernel when the kernel is a float sum or
    product: one launch per rank; in one process the shards scan in
    ``jax.lax.associative_scan``'s order, as ramba_tpu's do), the blocks'
    totals are all-gathered, and each block rebases on the fold of the
    totals of the blocks before it along the axis, in order."""
    from ramba_tpu_torch.parallel import distributed

    (local_func, final_func, associative, axis, _d), shape, sharding = static
    dev = x.device
    xm = x.movedim(axis, 0)
    rest = tuple(xm.shape[1:])

    def call(fn, a, b):
        out = np.broadcast_shapes(tuple(a.shape), tuple(b.shape))
        return as_result(call_kernel(fn, a, b), out, dev)

    def local_scan(b):
        kernel = lambda xi, carry: call(local_func, xi, carry)  # noqa: E731
        if associative:
            return associative_scan(lambda a, c: kernel(c, a), b)
        return sequential_scan(kernel, b)

    counts = sharding.split_counts(len(shape))
    if counts[axis] == 1:
        return local_scan(xm).movedim(0, axis).contiguous() \
            if xm.shape[0] else x
    (ys,) = _block_scans([xm], local_func, final_func, local_scan)
    tot = ys[-1] if xm.shape[0] else torch.zeros(rest, dtype=x.dtype,
                                                 device=dev)
    shapes = [tuple(t[:axis] + t[axis + 1:])
              for t in sharding.rank_shapes(shape)]
    totals = distributed.all_gather(tot.contiguous(), shapes)
    mesh = sharding.mesh
    me = mesh.position_of(distributed.process_index())
    if me is None:  # outside the mesh: an empty block
        return x
    mine = sharding.block_coords(me, len(shape))
    carry = None
    for k in range(mine[axis]):
        want = mine[:axis] + (k,) + mine[axis + 1:]
        for pos in np.ndindex(mesh.devices.shape):
            if sharding.block_coords(pos, len(shape)) == want:
                t = totals[mesh.rank_at(pos)]
                if t.numel() or not rest:
                    carry = t if carry is None else call(final_func,
                                                         carry, t)
                break
    if carry is not None and xm.shape[0]:
        ys = call(final_func, carry, ys)
    return ys.movedim(0, axis).contiguous()


def _scan_axis_shards(arr, axis, mesh) -> int:
    """How many shards split ``axis`` of ``arr`` (its layout on ``mesh``)."""
    spec = tuple(_mesh.layout_of(arr, mesh))
    entry = spec[axis] if axis < len(spec) else None
    k = 1
    for nm in _mesh.entry_names(entry):
        k *= int(mesh.shape.get(nm, 1))
    return k


_warned_nonassoc = False


def _warn_nonassoc_sharded(k, nsh) -> None:
    """A kernel that failed the associativity probe on a split scan axis is
    exact only per block: say so, once."""
    global _warned_nonassoc
    if _warned_nonassoc:
        return
    _warned_nonassoc = True
    warnings.warn(
        "scumulative: the kernel failed the associativity probe and the "
        f"scan axis is sharded over {k} of the mesh's {nsh} devices.  "
        "Each shard scans its own "
        "block and the cross-shard carry is applied via final_func(boundary, "
        "block) — per-block carry semantics, identical to the reference's "
        "scumulative_final, which can differ from an exact sequential scan "
        "for non-rebasable kernels (e.g. clamped accumulators).  Pass "
        "associative=True if the kernel is in fact associative, or keep the "
        "scan axis unsharded for exact semantics.",
        RuntimeWarning,
        stacklevel=3,
    )


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
    mesh = _mesh.get_mesh()
    nsh = mesh.size
    n = arr.shape[axis] if arr.ndim else 0
    k = _scan_axis_shards(arr, axis, mesh) if nsh > 1 else 1
    # distribute only when the scan axis is split: an operand kept whole
    # (or split on other axes) scans each block whole, exactly
    distribute = nsh > 1 and k > 1 and \
        n >= max(nsh * 2, common.dist_threshold)
    if not associative and distribute:
        _warn_nonassoc_sharded(k, nsh)
    res = ndarray(Node("scumulative", (local_func, final_func,
                                       bool(associative), axis, distribute),
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


class _ShardAborted(RuntimeError):
    """Raised in an spmd shard whose rendezvous another shard broke."""


class _Rendezvous:
    """Where the shards of one ``spmd`` run meet: each shard runs the
    kernel in a thread of its own, and a collective (``halo``'s exchange,
    the end of the kernel) waits until every shard has posted its value for
    that round, as ``shard_map``'s collectives do.  Shards that reach
    different collectives, or a shard that raised, end the run."""

    def __init__(self, n):
        self.n = n
        self.cv = threading.Condition()
        self.rounds: dict = {}
        self.error = None

    def exchange(self, rank, rnd, tag, value) -> dict:
        with self.cv:
            posts = self.rounds.setdefault(rnd, {})
            posts[rank] = (tag, value)
            self.cv.notify_all()
            while len(posts) < self.n and self.error is None:
                self.cv.wait()
            if self.error is not None:
                raise _ShardAborted("spmd: another shard failed")
            if len({t for t, _ in posts.values()}) != 1:
                raise RuntimeError(
                    "spmd: the shards reached different collectives (a "
                    "kernel must call halo() the same way on every shard)")
            return {r: v for r, (_t, v) in posts.items()}

    def fail(self, exc) -> None:
        with self.cv:
            if self.error is None:
                self.error = exc
            self.cv.notify_all()


class _Shard(threading.local):
    """The calling thread's shard inside ``spmd``: its linear rank, mesh
    position, rendezvous and next round (rank None outside spmd)."""

    rank = None
    position = None
    rendezvous = None
    round = 0

    def collective(self, tag, value) -> dict:
        self.round += 1
        return self.rendezvous.exchange(self.rank, self.round, tag, value)


_shard = _Shard()


class LocalView:
    """One shard's view of an array inside ``spmd`` (reference:
    LocalNdarray, docs/index.md).  ``set_local`` is the functional
    write-back: the updated blocks replace the source array after the
    call.  ``global_start`` is the block's offset in global index space,
    ``local_valid`` the count of real (not padding) rows per dim,
    ``valid_mask`` the same as a mask, and ``halo(depth)`` the block
    extended by its neighbours' edge cells (zeros beyond the global
    domain)."""

    def __init__(self, block, global_start=None, global_shape=None,
                 spec=None, mesh=None, valid=None):
        self._block = asarray(block)
        self._updated = None
        self._global_start = global_start
        self._global_shape = global_shape
        self._spec = spec
        self._mesh = mesh
        self._valid = valid if valid is not None else (
            None if global_shape is None else tuple(
                max(0, min(g, b))
                for g, b in zip(global_shape, self._block.shape)))

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
        """Per-dim count of valid rows in this block (int32).  On uneven
        shards the trailing block is zero-padded to the uniform block size;
        rows at index >= local_valid[d] are padding and their writes are
        discarded."""
        if self._global_start is None or self._global_shape is None:
            raise ValueError("local_valid is only available inside spmd")
        return tuple(_int32(v) for v in self._valid)

    def halo(self, depth):
        """The current block (``get_local()``, so earlier ``set_local``
        updates show) extended by ``depth`` cells per dim (an int or one
        per dim): along a split dim, the neighbouring shards' edge cells,
        exchanged dim by dim so corners arrive too (zeros at the ends of
        the mesh); along a whole dim, zeros at any depth.  The padding of
        an uneven trailing block travels as data: mask with
        ``local_valid``."""
        if self._global_start is None:
            raise ValueError("halo() is only available inside spmd")
        from ramba_tpu_torch.ops.manipulation import concatenate, pad

        x = self.get_local()
        nd = x.ndim
        if isinstance(depth, (int, np.integer)):
            depth = (int(depth),) * nd
        depth = tuple(depth)
        if len(depth) != nd or any(d < 0 for d in depth):
            raise ValueError(
                f"halo depth {depth!r} must be {nd} non-negative ints")
        spec = tuple(self._spec or ()) + (None,) * nd
        for d in range(nd):
            if not depth[d]:
                continue
            names = _mesh.entry_names(spec[d])
            if _shard.rank is None or math.prod(
                    self._mesh.shape[nm] for nm in names) == 1:
                # the whole dim is local: beyond it lies the global
                # boundary, zeros at any depth
                pads = [(0, 0)] * nd
                pads[d] = (depth[d], depth[d])
                x = pad(x, pads)
                continue
            if depth[d] > x.shape[d]:
                raise ValueError(
                    f"halo depth {depth[d]} exceeds the local block extent "
                    f"{x.shape[d]} along dim {d}")
            if _shard.rendezvous is None:  # a mesh of ranks
                parts = self._rank_halo(x, d, depth[d])
            else:
                posts = _shard.collective(("halo", d), x)
                parts = [self._neighbour(posts, names, -1, x, d, depth[d]),
                         x,
                         self._neighbour(posts, names, 1, x, d, depth[d])]
            x = concatenate(parts, axis=d)
        return x

    def _rank_halo(self, x, d, amt):
        """``[lower slab, x, upper slab]`` along dim ``d`` from the
        neighbouring ranks over send/recv: the lower one's last ``amt``
        cells, the upper one's first (zeros past the end of the mesh)."""
        from ramba_tpu_torch.parallel import distributed

        sh = _mesh.NamedSharding(self._mesh, self._spec)
        down = sh.neighbour_rank(_shard.position, x.ndim, d, -1)
        up = sh.neighbour_rank(_shard.position, x.ndim, d, 1)
        t = x._value()
        n = t.shape[d]
        first = t.narrow(d, 0, amt)
        last = t.narrow(d, n - amt, amt)
        sends = [(first, down)] if down is not None else []
        if up is not None:
            sends.append((last, up))
        slab = tuple(first.shape)
        recvs = [(slab, t.dtype, r) for r in (down, up) if r is not None]
        got = iter(distributed.exchange(sends, recvs))
        parts = []
        for r in (down, up):
            v = next(got) if r is not None else torch.zeros(
                slab, dtype=t.dtype, device=t.device)
            parts.append(ndarray(E.Const(v)))
        return [parts[0], x, parts[1]]

    def _neighbour(self, posts, names, step, x, d, amt):
        """The slab the neighbour ``step`` blocks away along ``names``
        sends (its last ``amt`` cells for the lower neighbour, first for
        the upper), or zeros past the end of the mesh."""
        from ramba_tpu_torch import parallel

        pos = dict(zip(self._mesh.axis_names, _shard.position))
        k = 0
        for nm in names:
            k = k * self._mesh.shape[nm] + pos[nm]
        k += step
        total = math.prod(self._mesh.shape[nm] for nm in names)
        shape = list(x.shape)
        shape[d] = amt
        if not 0 <= k < total:
            return zeros(tuple(shape), x.dtype)
        for nm in reversed(names):
            k, pos[nm] = divmod(k, self._mesh.shape[nm])
        src = int(np.ravel_multi_index(
            tuple(pos[nm] for nm in self._mesh.axis_names),
            self._mesh.devices.shape))
        y = posts[src]
        idx = [slice(None)] * x.ndim
        idx[d] = slice(y.shape[d] - amt, None) if step < 0 else slice(0, amt)
        return parallel.transport(y[tuple(idx)], src, _shard.rank)

    @property
    def valid_mask(self):
        """Bool mask over the block, True where the element is real data and
        False in the zero padding of an uneven trailing block."""
        cur = self.get_local().shape
        if cur != self._block.shape:
            raise ValueError(
                f"valid_mask refers to the original {self._block.shape} "
                f"block but the local slab is now {cur}; read valid_mask "
                "before a shape-changing set_local(), or mask manually "
                "with local_valid")
        mask = full(cur, True, bool)
        for d, nv in enumerate(self._valid or cur):
            if nv < cur[d]:
                shape = [1] * len(cur)
                shape[d] = cur[d]
                from ramba_tpu_torch.ops.creation import arange

                mask = mask & (arange(cur[d], dtype=np.int32)
                               .reshape(tuple(shape)) < nv)
        return mask

    @property
    def shape(self):
        return self.get_local().shape

    @property
    def dtype(self):
        return self.get_local().dtype


def worker_id():
    """Inside ``spmd``: this shard's linear index in the mesh grid, int32
    (0 outside spmd and on a one-shard mesh)."""
    return _int32(_shard.rank or 0)


_uneven_pad_warned = False
_replicated_write_warned = False


def _assemble_aval(static, *blocks):
    _counts, _local, shape = static
    return Aval(tuple(shape), blocks[0].dtype, False)


def _assemble(static, *blocks):
    """One tensor from per-shard blocks (``counts`` of them per dim, each
    of shape ``local``, in grid order), cut to ``shape``: a counted copy."""
    from ramba_tpu_torch import parallel

    counts, local, shape = static
    out = torch.empty(tuple(c * l for c, l in zip(counts, local)),
                      dtype=blocks[0].dtype, device=blocks[0].device)
    for c, b in zip(itertools.product(*[range(n) for n in counts]), blocks):
        out[tuple(slice(k * l, (k + 1) * l) for k, l in zip(c, local))] = b
        parallel.note_transfer("shard_assemble",
                               b.numel() * b.element_size())
    return out[tuple(slice(0, s) for s in shape)]


defop("shard_assemble", _assemble_aval)(_assemble)


def _spmd_one(func, args, positions, arrays):
    """One shard: the kernel runs once with the whole array as its block,
    in the calling thread."""
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
        a.write_expr(_fit(v._updated, a.shape).read_expr())


def _fit(new, shape):
    """A ``set_local`` value cut to its block's ``shape``."""
    if new.shape == tuple(shape):
        return new
    if new.ndim == len(shape) and all(n >= s for n, s in
                                      zip(new.shape, shape)):
        return new[tuple(slice(0, s) for s in shape)]
    raise ValueError(f"set_local gave a {new.shape} block for a "
                     f"{tuple(shape)} block")


def _spmd_layout(a, mesh):
    """Spec of an spmd operand: its layout on this mesh, unless that keeps
    it whole, which ``default_spec`` splits (as the reference does)."""
    spec = _mesh.layout_of(a, mesh)
    return spec if tuple(spec) != () else _mesh.default_spec(a.shape, mesh)


def spmd(func, *args):
    """Run ``func`` once per shard of the mesh with each port array
    argument as that shard's :class:`LocalView` (docs/index.md, spmd);
    other args pass through.  Each shard runs in a thread of its own and
    meets the others at ``halo`` exchanges.  Uneven dims are zero-padded to
    the uniform block (a warning, once); arrays kept whole (small ones)
    arrive whole on every shard; after the call the ``set_local`` blocks
    are assembled into their arrays, and where an array is whole along
    some mesh axes the copy at coordinate 0 of those axes wins (a warning,
    once)."""
    global _uneven_pad_warned, _replicated_write_warned
    from ramba_tpu_torch.ops.manipulation import pad

    positions = [i for i, a in enumerate(args) if isinstance(a, ndarray)]
    arrays = [args[i] for i in positions]
    mesh = _mesh.get_mesh()
    if _mesh.is_rank_mesh(mesh):
        return _spmd_ranks(func, args, positions, arrays, mesh)
    if mesh.size == 1:
        return _spmd_one(func, args, positions, arrays)
    grid = list(np.ndindex(mesh.devices.shape))
    layouts = []
    for a in arrays:
        sh = _mesh.NamedSharding(mesh, _spmd_layout(a, mesh))
        counts = sh.split_counts(a.ndim)
        padded = tuple(-(-s // c) * c for s, c in zip(a.shape, counts))
        src = a
        if padded != a.shape:
            if not _uneven_pad_warned:
                _uneven_pad_warned = True
                warnings.warn(
                    f"spmd: array of shape {tuple(a.shape)} does not divide "
                    f"evenly over the mesh; trailing blocks are zero-padded "
                    f"to the uniform SPMD block. Block-coupled computations "
                    f"(min/mean/matmul over the block) must mask the padding "
                    f"via LocalView.local_valid or LocalView.valid_mask.")
            src = pad(a, [(0, p - s) for s, p in zip(a.shape, padded)])
        local = tuple(p // c for p, c in zip(padded, counts))
        layouts.append((sh, counts, local, src))
    views = {}
    for rank, pos in enumerate(grid):
        for j, (a, (sh, counts, local, src)) in enumerate(zip(arrays,
                                                             layouts)):
            coords = sh.block_coords(pos, a.ndim)
            start = tuple(k * l for k, l in zip(coords, local))
            block = src[tuple(slice(s, s + l)
                              for s, l in zip(start, local))].copy()
            views[rank, j] = LocalView(
                block, tuple(_int32(s) for s in start), a.shape,
                sh.spec, mesh,
                tuple(max(0, min(g - s, l))
                      for g, s, l in zip(a.shape, start, local)))
    rv = _Rendezvous(len(grid))
    errors: dict = {}

    def shard(rank, pos):
        _shard.rank, _shard.position = rank, pos
        _shard.rendezvous, _shard.round = rv, 0
        call_args = list(args)
        for j, p in enumerate(positions):
            call_args[p] = views[rank, j]
        try:
            func(*call_args)
            _shard.collective("end", None)
        except BaseException as e:  # handed to the caller below
            errors[rank] = e
            rv.fail(e)
        finally:
            _shard.rank = _shard.rendezvous = None

    threads = [threading.Thread(target=shard, args=(rank, pos),
                                name=f"spmd-shard-{rank}")
               for rank, pos in enumerate(grid)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        first = [e for _r, e in sorted(errors.items())
                 if not isinstance(e, _ShardAborted)]
        raise (first or list(errors.values()))[0]
    for j, (a, (sh, counts, local, _src)) in enumerate(zip(arrays, layouts)):
        if all(views[r, j]._updated is None for r in range(len(grid))):
            continue
        used = {nm for e in sh.spec for nm in _mesh.entry_names(e)}
        unused = tuple(nm for nm in mesh.axis_names if nm not in used)
        if unused and not _replicated_write_warned:
            _replicated_write_warned = True
            warnings.warn(
                f"spmd kernel wrote to an array replicated along mesh "
                f"ax{'is' if len(unused) == 1 else 'es'} {unused}; the "
                f"coordinate-0 copy wins (reference semantics) — "
                f"device-divergent writes to replicated copies are not "
                f"merged")
        blocks = {}
        for rank, pos in enumerate(grid):  # grid order: coordinate 0 first
            coords = sh.block_coords(pos, a.ndim)
            if coords not in blocks:
                blocks[coords] = _fit(views[rank, j].get_local(), local)
        exprs = [blocks[c].read_expr()
                 for c in itertools.product(*[range(n) for n in counts])]
        a.write_expr(Node("shard_assemble", (tuple(counts), local, a.shape),
                          exprs))


def _spmd_ranks(func, args, positions, arrays, mesh):
    """``spmd`` over a mesh of ranks: this rank runs the kernel once, on
    its own position, in the calling thread and inside
    ``mesh.local_scope`` (what the kernel computes is rank-local);
    ``halo`` exchanges slabs with the neighbouring ranks over send/recv.
    The ranks agree on the outcome (a kernel that raised anywhere raises
    everywhere), then each rank's ``set_local`` block becomes its block of
    the array.  A rank outside the mesh runs no kernel but takes part in
    the agreement and the write-back."""
    from ramba_tpu_torch.core import fuser
    from ramba_tpu_torch.core.rankflush import gather_const
    from ramba_tpu_torch.parallel import distributed

    fuser.flush()
    me = mesh.position_of(distributed.process_index())
    layouts = []
    for a in arrays:
        sh = _mesh.NamedSharding(mesh, _spmd_layout(a, mesh))
        counts = sh.split_counts(a.ndim)
        local = tuple(-(-n // c) for n, c in zip(a.shape, counts))
        c = a._expr if a._base is None else None
        if isinstance(c, E.Const) and c.is_block and c.sharding == sh:
            block = fuser.leaf_value(c)
        else:  # another layout: every rank cuts its block from the whole
            block = a._value()[sh.local_index(a.shape)]
        layouts.append((sh, counts, local, block))
    err = None
    updates = [None] * len(arrays)
    if me is not None:
        try:
            with _mesh.local_scope():
                views = []
                for a, (sh, counts, local, block) in zip(arrays, layouts):
                    start = tuple(k * l for k, l in
                                  zip(sh.block_coords(me, a.ndim), local))
                    padded = block if tuple(block.shape) == local else \
                        _pad_to(block, local)
                    views.append(LocalView(
                        ndarray(E.Const(padded)),
                        tuple(_int32(v) for v in start), a.shape, sh.spec,
                        mesh, tuple(max(0, min(g - v, l)) for g, v, l in
                                    zip(a.shape, start, local))))
                call_args = list(args)
                for p, v in zip(positions, views):
                    call_args[p] = v
                _shard.rank = int(np.ravel_multi_index(
                    me, mesh.devices.shape))
                _shard.position, _shard.rendezvous = me, None
                try:
                    func(*call_args)
                finally:
                    _shard.rank = _shard.position = None
                for j, v in enumerate(views):
                    if v._updated is not None:
                        updates[j] = _fit(v._updated,
                                          layouts[j][2])._value()
        except Exception as e:  # every rank must learn of it
            err = e
    failed = distributed.all_reduce_int(0 if err is None else 1, "max")
    if err is not None:
        raise err
    if failed:
        raise RuntimeError("spmd: the kernel raised on another rank")
    written = distributed.all_reduce_int(
        sum(1 << j for j, u in enumerate(updates) if u is not None), "max")
    for j, (a, (sh, counts, local, block)) in enumerate(zip(arrays,
                                                            layouts)):
        if not written >> j & 1:
            continue
        real = _mesh.index_shape(sh.local_index(a.shape), a.shape)
        new = block if updates[j] is None else updates[j]
        new = new[tuple(slice(0, r) for r in real)].contiguous()
        leaf = E.Const(new, sharding=sh, shape=tuple(a.shape))
        used = {nm for e in sh.spec for nm in _mesh.entry_names(e)}
        if any(nm not in used for nm in mesh.axis_names):
            # whole along some mesh axes: the coordinate-0 copy wins
            whole = gather_const(leaf)
            leaf = E.Const(whole[sh.local_index(a.shape)].clone(),
                           sharding=sh, shape=tuple(a.shape))
        a.write_expr(leaf)


def _pad_to(t, shape):
    out = torch.zeros(shape, dtype=t.dtype, device=t.device)
    out[tuple(slice(0, s) for s in t.shape)] = t
    return out


def barrier():
    """Wait for every worker (reference: ramba.barrier): a device sync,
    and on a group of several processes a barrier across the ranks."""
    from ramba_tpu_torch.parallel import distributed

    sync()
    distributed.barrier("spmd")
