"""Flush machinery: lazy expression graphs -> one program per flush.

Counterpart of ``ramba_tpu/core/fuser.py`` without its resilience, memo,
plan-cache, attribution, serving and integrity planes.  A flush collects
every pending array, applies the graph rewrites (``core/rewrite.py``,
unless ``RAMBA_TPU_REWRITE=0``), linearizes the graph into a buffer-free
instruction program, picks a lowering for it and runs it once:

* ``"kernel"`` — the hand-written kernels (``ops/kernel_backend.py``), for
  every program the classifier accepts;
* ``"torch"`` — the generic lowering: the instructions run one by one
  through the ``OPS`` table.  It plays the part ``jax.jit``/XLA plays in
  the JAX package, and frees every intermediate after its last use so a
  long chain holds only the values still needed.

There is no fallback between the two: the choice is made before anything
runs, and a kernel that fails to build or launch raises.  On a mesh of
ranks (several processes) a flush runs through ``core/rankflush.py``:
on each rank's blocks, or on gathered operands, decided before it runs.
"""

from __future__ import annotations

import itertools
import threading
import weakref
from typing import Optional, Sequence

import torch

from ramba_tpu_torch import common
from ramba_tpu_torch.core.expr import OPS, Const, Expr, Node, Scalar
from ramba_tpu_torch.observe import registry as _registry
from ramba_tpu_torch.parallel import mesh as _mesh

# Monotone counters (observability; same keys as the JAX package's).
# ``quarantined``: roots of failed flushes taken out of the pending registry.
# ``gathered``: flushes on a mesh of ranks that all-gathered their block
# leaves to run whole (``core/rankflush.py``).
stats = {"flushes": 0, "compiles": 0, "nodes_flushed": 0, "quarantined": 0,
         "gathered": 0}

# Called with no arguments after every flush (results shared between the
# nodes of one flush are dropped there).
after_flush: list = []
_stats_lock = threading.Lock()

_seq = itertools.count()


# ---------------------------------------------------------------------------
# pending registry
# ---------------------------------------------------------------------------


class FlushStream:
    """Pending registry + flush scope.  The port has one, the process-wide
    default stream; serving sessions with streams of their own come later."""

    def __init__(self, name: str = "default"):
        self.name = name
        self.nodes_since_flush = 0
        self._pending: dict[int, "weakref.ref"] = {}
        self._lock = threading.RLock()
        self._flush_lock = threading.RLock()

    def register(self, arr) -> None:
        k = id(arr)

        def _cleanup(ref, _k=k, _s=self):
            with _s._lock:
                if _s._pending.get(_k) is ref:
                    del _s._pending[_k]

        with self._lock:
            self._pending[k] = weakref.ref(arr, _cleanup)

    def unregister(self, arr) -> None:
        with self._lock:
            self._pending.pop(id(arr), None)

    def pending_roots(self) -> list:
        """Pending arrays in creation order: the roots of the next flush."""
        with self._lock:
            self.nodes_since_flush = 0
            roots = []
            for r in list(self._pending.values()):
                a = r()
                if a is not None and not isinstance(a._expr, Const):
                    roots.append(a)
        roots.sort(key=lambda a: a._seq)
        return roots

    def note_node_created(self) -> None:
        """Forced-flush safety valve for unbounded build loops."""
        with self._lock:
            self.nodes_since_flush += 1
            fire = (common.max_pending_ops
                    and self.nodes_since_flush >= common.max_pending_ops)
        if fire:
            self.flush()

    def flush(self, extra: Sequence[Expr] = ()) -> list:
        """Materialize every pending array (and ``extra`` expressions) in
        one program run.  Returns the values of ``extra`` in order."""
        with self._flush_lock:
            return _flush_roots(self, self.pending_roots(), extra)


_default_stream = FlushStream()


def register_pending(arr) -> None:
    _default_stream.register(arr)


def unregister_pending(arr) -> None:
    _default_stream.unregister(arr)


def note_node_created() -> None:
    _default_stream.note_node_created()


def next_seq() -> int:
    return next(_seq)


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------


class _Program:
    """Buffer-free linearization of an expression DAG.

    ``instrs[i] = (op, static, arg_slots)`` where slots < n_leaves index the
    leaf arguments and later slots index prior instruction results.
    """

    __slots__ = ("instrs", "n_leaves", "leaf_kinds", "out_slots", "key")

    def __init__(self, instrs, n_leaves, leaf_kinds, out_slots):
        self.instrs = instrs
        self.n_leaves = n_leaves
        self.leaf_kinds = leaf_kinds
        self.out_slots = tuple(out_slots)
        self.key = (tuple(instrs), n_leaves, leaf_kinds, self.out_slots)


def _linearize(roots: Sequence[Expr]):
    """Iterative postorder DFS over the DAG with node dedup (shared
    subexpressions evaluate once); leaves holding the same tensor share a
    slot."""
    slot: dict[int, int] = {}
    leaves: list = []
    instrs: list = []
    const_slot: dict[int, int] = {}
    order: list[Expr] = []
    seen: set[int] = set()
    stack = [(r, False) for r in reversed(roots)]
    while stack:
        node, done = stack.pop()
        nid = id(node)
        if done:
            order.append(node)
            continue
        if nid in seen:
            continue
        seen.add(nid)
        if isinstance(node, Node):
            stack.append((node, True))
            for a in reversed(node.args):
                stack.append((a, False))
        else:
            order.append(node)
    for node in order:
        nid = id(node)
        if nid in slot:
            continue
        if isinstance(node, Const):
            bid = id(node.value)
            if bid in const_slot:
                slot[nid] = const_slot[bid]
                continue
            const_slot[bid] = len(leaves)
            slot[nid] = len(leaves)
            leaves.append(node)
        elif isinstance(node, Scalar):
            slot[nid] = len(leaves)
            leaves.append(node)
    n_leaves = len(leaves)
    for node in order:
        nid = id(node)
        if nid in slot or not isinstance(node, Node):
            continue
        args = tuple(slot[id(a)] for a in node.args)
        slot[nid] = n_leaves + len(instrs)
        instrs.append((node.op, node.static, args))
    leaf_kinds = tuple("C" if isinstance(l, Const) else "S" for l in leaves)
    out_slots = [slot[id(r)] for r in roots]
    return _Program(tuple(instrs), n_leaves, leaf_kinds, out_slots), leaves


def prepare_program(exprs: Sequence[Expr]):
    """Linearize ``exprs`` without running them: ``(program, leaf_vals)``."""
    program, leaves = _linearize(list(exprs))
    return program, [leaf.value for leaf in leaves]


def _last_use_map(program: _Program) -> dict:
    """slot -> index of the last instruction that reads it; program outputs
    are pinned past the end so they are never freed."""
    last_use: dict[int, int] = {}
    for i, (_op, _st, args) in enumerate(program.instrs):
        for s in args:
            last_use[s] = i
    for s in program.out_slots:
        last_use[s] = len(program.instrs)
    return last_use


def run_instructions(program: _Program, leaf_vals) -> tuple:
    """Evaluate ``program`` through the ``OPS`` table, dropping each value
    after its last use (the headline chain at n=1e9 in float64 would
    otherwise hold every 8 GB temporary until the end)."""
    last_use = _last_use_map(program)
    dying: dict[int, list] = {}
    for s, i in last_use.items():
        if s >= program.n_leaves:
            dying.setdefault(i, []).append(s)
    vals = list(leaf_vals)
    for i, (op, static, argslots) in enumerate(program.instrs):
        vals.append(OPS[op](static, *(vals[s] for s in argslots)))
        for s in dying.get(i, ()):
            vals[s] = None
    return tuple(vals[s] for s in program.out_slots)


def _build_callable(program: _Program):
    """The generic torch lowering."""

    def run(*leaf_vals):
        return run_instructions(program, leaf_vals)

    return run


# ---------------------------------------------------------------------------
# compile cache + backend seam
# ---------------------------------------------------------------------------

_compile_cache: dict = {}
_COMPILE_CACHE_MAX = 512
_cache_lock = threading.RLock()


def _leaf_signature(leaf_vals) -> tuple:
    out = []
    for v in leaf_vals:
        if isinstance(v, torch.Tensor):
            out.append((tuple(v.shape), v.dtype, v.device.type))
        else:
            out.append(type(v))
    return tuple(out)


def _cache_key(program: _Program, leaf_vals) -> tuple:
    """Structure + leaf shapes/dtypes: the classifier reads both, so a
    lowering chosen for one signature is never reused for another."""
    return (program.key, _leaf_signature(leaf_vals))


def _get_compiled(program: _Program, leaf_vals,
                  force_backend: Optional[str] = None):
    """Compile-cache lookup (true LRU); returns the program's callable.
    The backend seam: ``core/autotune.py`` picks the lowering per program
    unless ``force_backend`` pins it."""
    from ramba_tpu_torch.core import autotune as _autotune

    backend = force_backend or _autotune.select(program, leaf_vals)
    try:
        key = _cache_key(program, leaf_vals) + (backend,)
        hash(key)
    except TypeError:
        key = None  # a static that hashes by identity only: no caching
    with _cache_lock:
        if key is not None:
            fn = _compile_cache.pop(key, None)
            if fn is not None:
                _compile_cache[key] = fn  # re-insert: most recently used
                return fn
        if backend == "kernel":
            from ramba_tpu_torch.ops import kernel_backend

            fn = kernel_backend.lower_program(program, leaf_vals)
            if fn is None:
                raise RuntimeError(
                    "kernel backend selected for a program its classifier "
                    "does not accept")
        else:
            fn = _build_callable(program)
        if key is not None:
            if len(_compile_cache) >= _COMPILE_CACHE_MAX:
                _compile_cache.pop(next(iter(_compile_cache)))
            _compile_cache[key] = fn
        with _stats_lock:
            stats["compiles"] += 1
        return fn


def _quarantine(stream: FlushStream, roots: list) -> None:
    """The roots of a program that raised leave the pending registry, or
    the one broken graph would re-enter, and re-fail, every later flush.
    They keep their lazy graphs: a later read re-runs each one alone
    (``ndarray._value``), so an array that did not cause the error still
    gets its value and a broken one raises its own error again."""
    for arr in roots:
        stream.unregister(arr)
    with _stats_lock:
        stats["quarantined"] += len(roots)
    _registry.inc("resilience.flush_quarantined", len(roots))


def _flush_roots(stream: FlushStream, roots: list,
                 extra: Sequence[Expr]) -> list:
    mesh = _mesh.get_mesh()
    if _mesh.is_rank_mesh(mesh):
        from ramba_tpu_torch.core import rankflush

        return rankflush.flush_roots(stream, roots, extra, mesh)
    root_exprs = [a._expr for a in roots]
    exprs = root_exprs + list(extra)
    if not exprs:
        return []
    try:
        if common.rewrite_enabled:
            from ramba_tpu_torch.core.rewrite import rewrite_roots

            exprs = rewrite_roots(exprs)
        program, leaf_vals = prepare_program(exprs)
        try:
            outs = _get_compiled(program, leaf_vals)(*leaf_vals)
        finally:
            for hook in after_flush:
                hook()
    except Exception:
        _quarantine(stream, roots)
        raise
    for arr, expr, val in zip(roots, root_exprs, outs):
        # a sharding hint's root keeps the layout it names; other results
        # take the default layout of the mesh they are read on
        hint = expr.static[0] if isinstance(expr, Node) \
            and expr.op == "shard_hint" else None
        arr._set_expr(Const(val, sharding=hint))
    with _stats_lock:
        stats["flushes"] += 1
        stats["nodes_flushed"] += len(program.instrs)
    return list(outs[len(roots):])


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def flush(extra: Sequence[Expr] = ()) -> list:
    """Materialize every pending array (and ``extra`` expressions) in one
    program run.  Returns the values of ``extra`` in order."""
    return _default_stream.flush(extra)


def sync() -> None:
    """Flush pending work and wait for the device to finish it."""
    _default_stream.flush()
    dev = common.device()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def realize(expr: Expr) -> Const:
    """One expression run alone into a leaf (on a mesh of ranks, this
    rank's block of it)."""
    mesh = _mesh.get_mesh()
    if _mesh.is_rank_mesh(mesh):
        from ramba_tpu_torch.core import rankflush

        holder = _Holder(expr)
        with _default_stream._flush_lock:
            rankflush.flush_roots(_default_stream, [holder], (), mesh)
        return holder._expr
    return Const(flush(extra=[expr])[0])


class _Holder:
    """A stand-in root for :func:`realize`: takes the leaf it is given."""

    def __init__(self, expr):
        self._expr = expr

    def _set_expr(self, c):
        self._expr = c


def gather_const(c: Const):
    """The whole array of a leaf (a block leaf gathered from every
    rank)."""
    if not c.is_block:
        return c.value
    from ramba_tpu_torch.core import rankflush

    return rankflush.gather_const(c)


def evaluate(expr: Expr):
    """Evaluate one expression (flushing pending work alongside it)."""
    if isinstance(expr, Const):
        return expr.value
    return flush(extra=[expr])[0]
