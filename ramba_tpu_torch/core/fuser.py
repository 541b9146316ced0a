"""Flush machinery: lazy expression graphs -> one program per flush.

Counterpart of ``ramba_tpu/core/fuser.py`` without its serving plane.
A flush
collects every pending array, applies the graph rewrites
(``core/rewrite.py``, unless ``RAMBA_TPU_REWRITE=0``), linearizes the graph
into a buffer-free instruction program, picks a lowering for it and runs it
once:

* ``"kernel"`` — the hand-written kernels (``ops/kernel_backend.py``);
* ``"torch"`` — the generic lowering: the instructions run one by one
  through the ``OPS`` table.  It plays the part ``jax.jit``/XLA plays in
  the JAX package, and frees every intermediate after its last use so a
  long chain holds only the values still needed.

``core/autotune.py`` picks the lowering per program fingerprint (by
default the kernels take every program the classifier accepts; under
``RAMBA_AUTOTUNE=race`` a measured race decides).  There is no fallback
between the two: the choice is made before anything runs, and a kernel
that fails to build or launch raises.

The compile pipeline around a program (ROADMAP A.7):

* a program longer than ``common.max_program_instrs`` runs segment by
  segment inside the flush (:func:`_run_segmented`), each segment through
  the compile cache with its own leaf values, so a segment the classifier
  accepts runs on elemred (ramba_tpu's segments always take XLA);
* ``RAMBA_COMPILE_CLASSES`` buckets the leading dim of an elementwise
  program the kernels do not take (``compile/classes.py``): leaves
  zero-padded, outputs sliced;
* the compile cache is a true LRU of ``_COMPILE_CACHE_MAX`` entries;
  kernel libraries a miss loads may come from the persistent cache
  (``compile/persist.py``), which saves their builds, not the compile;
* every cache interaction and every execution lands in the cost ledger
  (``observe/ledger.py``) under the fingerprint of :func:`_cache_key`,
  and every flush builds a span (emitted as a ``flush`` event) that the
  slow-flush sentinel reads.

Between linearization and the run, :func:`_prepare` follows the
reference's ``_flush_prepare`` (ROADMAP A.7 part two), each step behind
a switch that is off by default and costs one environment read when
unset:

* ``RAMBA_PLANCERT`` — a repeat flush whose plan certificate still
  validates (``core/plancache.py``) skips the class proof, the
  fingerprint derivation, the memo certification and the verifier;
* ``RAMBA_MEMO`` — an effect-certified program over the same input
  versions is served from the result cache (``core/memo.py``): no
  lowering, no launch;
* ``RAMBA_VERIFY`` — the static verifier (``analyze/``) checks the
  program before it is lowered: strict mode raises
  ``ProgramVerificationError`` (the roots are quarantined), warn mode
  starts a program with error findings at the split rung
  (:func:`_run_segmented` at half the cap).

Then :func:`_dispatch` admits the flush (``memory.admit``: one that does
not fit starts at the chunked rung) and runs it down the degradation
ladder (``resilience/degrade.py``): fused → split → chunked
(:func:`_run_chunked`) → eager (:func:`_run_eager`) → host
(:func:`_run_host`), every rung under the retry engine, a drop counted,
evented and stamped on the span (``degraded``).  The healthy flush stays
on the fused rung; a fatal error (a CUDA error, a failed kernel build, a
programming error) raises from the rung that hit it.  Under
``RAMBA_AUDIT`` a certified flush of the fused rung is re-run on the
eager rung and compared (``resilience/integrity.shadow_audit``).

Every flush span carries the attribution plane's stage waterfall
(``observe/attrib.py``): ``trace`` and ``prepare`` (and ``verify``) in
:func:`_prepare`, ``compile``/``dispatch``/``device_execute`` per call in
:func:`_execute_compiled` and per rung in :func:`_record_rung`,
``admit`` and the ladder's host residual in :func:`_dispatch`,
``write_back`` in :func:`_finish_span`, which finalizes the span (stages
plus ``unattributed_s`` equal ``wall_s``) and feeds the SLO histograms
(``observe/slo.py``).  The fence is the CUDA event pair around a call,
one pair per call (``RAMBA_ATTRIB``: on, ``off``, ``sample:<N>``).

On a mesh of ranks (several processes) a flush runs through
``core/rankflush.py``: on each rank's blocks, or on gathered operands,
decided before it runs; its programs run through :func:`run_program`.
"""

from __future__ import annotations

import contextvars
import hashlib
import itertools
import os
import threading
import time
import weakref
from typing import Optional, Sequence

import torch

from ramba_tpu_torch import _build, common
from ramba_tpu_torch.compile import classes as _classes
from ramba_tpu_torch.core import memo as _memo
from ramba_tpu_torch.core import plancache as _plancache
from ramba_tpu_torch.core.expr import OPS, Const, Expr, Node, Scalar
from ramba_tpu_torch.observe import attrib as _attrib
from ramba_tpu_torch.observe import events as _events
from ramba_tpu_torch.observe import ledger as _ledger
from ramba_tpu_torch.observe import observer as _observer
from ramba_tpu_torch.observe import profile as _profile
from ramba_tpu_torch.observe import registry as _registry
from ramba_tpu_torch.observe import slo as _slo
from ramba_tpu_torch.observe import telemetry as _telemetry
from ramba_tpu_torch.parallel import distributed as _distributed
from ramba_tpu_torch.parallel import mesh as _mesh
from ramba_tpu_torch.resilience import coherence as _coherence
from ramba_tpu_torch.resilience import degrade as _degrade
from ramba_tpu_torch.resilience import elastic as _elastic
from ramba_tpu_torch.resilience import faults as _faults
from ramba_tpu_torch.resilience import memory as _memory
from ramba_tpu_torch.resilience.spill import SpilledArray
from ramba_tpu_torch.utils import timing as _timing

# Monotone counters (observability; same keys as the JAX package's).
# ``segments``: segment runs of programs longer than max_program_instrs.
# ``quarantined``: roots of failed flushes taken out of the pending registry.
# ``gathered``: flushes on a mesh of ranks that all-gathered their block
# leaves to run whole (``core/rankflush.py``).  ``verify_routed``: flushes
# RAMBA_VERIFY=warn started at the split rung.
stats = {"flushes": 0, "compiles": 0, "nodes_flushed": 0, "segments": 0,
         "quarantined": 0, "gathered": 0, "verify_routed": 0}

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
# ownership of realized leaves (the memory governor's ledger)
# ---------------------------------------------------------------------------


def owner_incref(const: Const) -> None:
    """One more array owns ``const`` (``ndarray._set_expr``): its bytes
    enter the memory governor's ledger."""
    _memory.on_incref(const)


def owner_decref(value) -> None:
    """An array let go of a leaf holding ``value``; the last owner takes
    its bytes out of the ledger."""
    _memory.on_decref(value)


def leaf_value(leaf):
    """The value of a leaf, put back on its device first when the memory
    governor spilled it to the host."""
    v = leaf.value
    if isinstance(v, SpilledArray):
        return _memory.restore(leaf)
    return v


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------


class _Program:
    """Buffer-free linearization of an expression DAG.

    ``instrs[i] = (op, static, arg_slots)`` where slots < n_leaves index the
    leaf arguments and later slots index prior instruction results.
    """

    __slots__ = ("instrs", "n_leaves", "leaf_kinds", "out_slots", "key",
                 "_kh")

    def __init__(self, instrs, n_leaves, leaf_kinds, out_slots):
        self.instrs = instrs
        self.n_leaves = n_leaves
        self.leaf_kinds = leaf_kinds
        self.out_slots = tuple(out_slots)
        self.key = (tuple(instrs), n_leaves, leaf_kinds, self.out_slots)
        self._kh = None

    @property
    def key_hash(self) -> int:
        """``hash(key)``, computed once (-1: the key is unhashable); the
        plan cache keys on it."""
        if self._kh is None:
            try:
                self._kh = hash(self.key)
            except TypeError:
                self._kh = -1
        return self._kh


def _linearize(roots: Sequence[Expr]):
    """Iterative postorder DFS over the DAG with node dedup (shared
    subexpressions evaluate once); leaves holding the same tensor share a
    slot, and a ``shard_hint`` shares its operand's (a layout a flush
    stamps on its root, or across ranks a reshard before the program,
    ``core/rankflush.py``)."""
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
        if node.op == "shard_hint":
            # a layout, not a computation: the value is its operand's
            slot[nid] = slot[id(node.args[0])]
            continue
        args = tuple(slot[id(a)] for a in node.args)
        slot[nid] = n_leaves + len(instrs)
        instrs.append((node.op, node.static, args))
    leaf_kinds = tuple("C" if isinstance(l, Const) else "S" for l in leaves)
    out_slots = [slot[id(r)] for r in roots]
    return _Program(tuple(instrs), n_leaves, leaf_kinds, out_slots), leaves


def prepare_program(exprs: Sequence[Expr]):
    """Linearize ``exprs`` without running them: ``(program, leaf_vals)``
    (a spilled leaf is put back on its device first)."""
    program, leaves = _linearize(list(exprs))
    return program, [leaf_value(leaf) for leaf in leaves]


def _prepare_program(exprs: Sequence[Expr]):
    """Rewrite + linearize, as a flush does: ``(program, leaves,
    exprs)``, where ``exprs`` are the rewritten roots, so the verifier
    re-checks the very graph that was linearized."""
    exprs = list(exprs)
    if common.rewrite_enabled:
        from ramba_tpu_torch.core.rewrite import rewrite_roots

        exprs = rewrite_roots(exprs)
    program, leaves = _linearize(exprs)
    return program, leaves, exprs


def _last_use_map(program: _Program) -> dict:
    """slot -> the highest slot that reads it (an instruction's result
    takes slot ``n_leaves + its index``, so this is the slot of the last
    instruction consuming it); program outputs are pinned past the end,
    at ``n_leaves + len(instrs) + 1``, so they are never dropped.  One
    convention for :func:`run_instructions` and the segment iterator, as
    ramba_tpu's (``tests/test_torch_segments.py`` pins it)."""
    instrs, n_leaves = program.instrs, program.n_leaves
    last_use: dict[int, int] = {}
    for i, (_op, _st, args) in enumerate(instrs):
        for s in args:
            last_use[s] = n_leaves + i
    inf = n_leaves + len(instrs) + 1
    for s in program.out_slots:
        last_use[s] = inf
    return last_use


def run_instructions(program: _Program, leaf_vals) -> tuple:
    """Evaluate ``program`` through the ``OPS`` table, dropping each value
    after its last use (the headline chain at n=1e9 in float64 would
    otherwise hold every 8 GB temporary until the end)."""
    n_leaves = program.n_leaves
    dying: dict[int, list] = {}
    for s, u in _last_use_map(program).items():
        if s >= n_leaves:
            dying.setdefault(u, []).append(s)
    vals = list(leaf_vals)
    for i, (op, static, argslots) in enumerate(program.instrs):
        vals.append(OPS[op](static, *(vals[s] for s in argslots)))
        for s in dying.get(n_leaves + i, ()):
            vals[s] = None
    return tuple(vals[s] for s in program.out_slots)


def _build_callable(program: _Program):
    """The generic torch lowering."""

    def run(*leaf_vals):
        return run_instructions(program, leaf_vals)

    return run


def _semantic_fingerprint() -> tuple:
    """Trace-time configuration the ops read beyond the program and its
    leaves: the reference's x64 regime, which the port fixes (its eval
    rules always run the x64 promotions).  It keys the result memo and
    the cache-key collision check, as in the reference."""
    return (True,)


def _program_label(program: _Program) -> str:
    """Stable per-structure label (the op sequence only: statics can hold
    closures whose repr embeds addresses)."""
    text = " ".join(op for op, _, _ in program.instrs) + f"|{program.n_leaves}"
    return "prog_" + hashlib.sha256(text.encode()).hexdigest()[:12]


def _nbytes(v) -> int:
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    return int(getattr(v, "nbytes", 0) or 0)


# ---------------------------------------------------------------------------
# segmentation
# ---------------------------------------------------------------------------


def _byte_segment_end(instrs, n_leaves, start: int, slot_bytes: dict,
                      max_seg_bytes: int, seg_cap: int) -> int:
    """First instruction index past a byte-bounded segment starting at
    ``start``: add up the bytes each instruction brings into the
    segment's live set (its output slot plus any outside input it pulls
    in) and stop before the total crosses ``max_seg_bytes``.  Always
    admits at least one instruction.  The ``chunked`` rung
    (:func:`_run_chunked`) cuts its segments here."""
    base = n_leaves + start
    ninstr = len(instrs)
    seen_in: set = set()
    seg_bytes = 0
    end = start
    while end < ninstr:
        if seg_cap and end - start >= seg_cap:
            break
        _op, _st, args = instrs[end]
        cost = slot_bytes.get(n_leaves + end, 0)
        for s in args:
            if s < base and s not in seen_in:
                cost += slot_bytes.get(s, 0)
        if end > start and seg_bytes + cost > max_seg_bytes:
            break
        for s in args:
            if s < base:
                seen_in.add(s)
        seg_bytes += cost
        end += 1
    return end


def _iter_segments(program: _Program, last_use: dict,
                   seg_size: Optional[int] = None, *,
                   slot_bytes: Optional[dict] = None,
                   max_seg_bytes: Optional[int] = None):
    """Split ``program`` into sub-programs of at most ``seg_size`` (default
    ``common.max_program_instrs``) instructions, or of bounded live bytes
    when ``slot_bytes``/``max_seg_bytes`` are given.  Yields ``(seg_prog,
    in_slots, out_here, top)``: the parent slots the segment reads, the
    parent slots it must emit (read later, or program outputs) and the
    first parent slot past it."""
    instrs, n_leaves = program.instrs, program.n_leaves
    if seg_size is None:
        seg_size = common.max_program_instrs
    ninstr = len(instrs)
    start = 0
    while start < ninstr:
        if max_seg_bytes and slot_bytes is not None:
            end = _byte_segment_end(instrs, n_leaves, start, slot_bytes,
                                    max_seg_bytes, seg_size)
        else:
            end = min(start + seg_size, ninstr)
        base, top = n_leaves + start, n_leaves + end
        seg = instrs[start:end]
        in_slots = sorted(
            {s for _o, _s, args in seg for s in args if s < base}
        )
        remap = {s: j for j, s in enumerate(in_slots)}
        nin = len(in_slots)
        seg_instrs = tuple(
            (op, st, tuple(remap[s] if s < base else nin + (s - base)
                           for s in args))
            for op, st, args in seg
        )
        out_here = [s for s in range(base, top) if last_use.get(s, 0) >= top]
        seg_prog = _Program(
            seg_instrs,
            nin,
            tuple(program.leaf_kinds[s] if s < n_leaves else "C"
                  for s in in_slots),
            tuple(nin + (s - base) for s in out_here),
        )
        yield seg_prog, in_slots, out_here, top
        start = end


def _run_segmented(program: _Program, leaf_vals, span: Optional[dict] = None,
                   seg_size: Optional[int] = None,
                   rung: str = "fused", *,
                   slot_bytes: Optional[dict] = None,
                   max_seg_bytes: Optional[int] = None) -> tuple:
    """Run a program longer than ``common.max_program_instrs`` as a chain
    of segments inside one flush (or, as the split rung, any program at
    ``seg_size``; as the chunked rung, at ``max_seg_bytes`` of estimated
    live bytes a segment).  Each segment goes through the compile cache
    with its own leaf values (a chain of one repeated structure compiles
    one segment), so a segment the classifier accepts launches elemred; a
    value crossing a boundary is a segment output carried to the next,
    and every value is dropped after its last use."""
    last_use = _last_use_map(program)
    vals: dict[int, object] = dict(enumerate(leaf_vals))
    for seg_prog, in_slots, out_here, top in _iter_segments(
            program, last_use, seg_size, slot_bytes=slot_bytes,
            max_seg_bytes=max_seg_bytes):
        seg_vals = [vals[s] for s in in_slots]
        outs = _execute(seg_prog, seg_vals, span, rung=rung)
        del seg_vals
        for s in in_slots:
            if last_use.get(s, 0) < top:
                del vals[s]
        for s, v in zip(out_here, outs):
            vals[s] = v
        with _stats_lock:
            stats["segments"] += 1
        _registry.inc("fuser.segments")
    return tuple(vals[s] for s in program.out_slots)


# ---------------------------------------------------------------------------
# compile cache + backend seam
# ---------------------------------------------------------------------------

_compile_cache: dict = {}
_COMPILE_CACHE_MAX = 512
_cache_epoch = 0  # the mesh epoch the cached programs were made under

# Called (when set) just before a program is launched, after its fault
# sites: ``core/rankflush.py`` sets it while a rung runs a program that
# exchanges with other ranks inside it (a stencil's halos), so no rank
# enters the exchange while a peer has already failed.  A context
# variable: an attempt the watchdog runs on a helper thread carries its
# own gate, and a zombie attempt never opens the next attempt's.
launch_gate: contextvars.ContextVar = contextvars.ContextVar(
    "ramba_launch_gate", default=None)
_cache_lock = threading.RLock()


def _leaf_signature(leaf_vals) -> tuple:
    out = []
    for v in leaf_vals:
        if isinstance(v, torch.Tensor):
            # the dtype by name: the fingerprint serializes names, and a
            # torch.dtype object would serialize as its type alone
            out.append((tuple(v.shape), str(v.dtype), v.device.type))
        else:
            out.append(type(v))
    return tuple(out)


def _cache_key(program: _Program, leaf_vals, compile_class=None) -> tuple:
    """Structure + leaf shapes/dtypes (the classifier reads both, so a
    lowering chosen for one signature is never reused for another), plus
    the compile class of a bucketed flush: bucketed and exact-shape
    programs never share an entry or a ledger row."""
    key = (program.key, _leaf_signature(leaf_vals))
    if compile_class is None:
        return key
    return key + (("class",) + tuple(compile_class),)


def _lower(program: _Program, leaf_vals, backend: str):
    if backend == "kernel":
        from ramba_tpu_torch.ops import kernel_backend

        fn = kernel_backend.lower_program(program, leaf_vals)
        if fn is None:
            raise RuntimeError(
                "kernel backend selected for a program its classifier "
                "does not accept")
        return fn
    return _build_callable(program)


def _get_compiled(program: _Program, leaf_vals, compile_class=None,
                  key: Optional[tuple] = None, fp: Optional[str] = None):
    """Compile-cache lookup (true LRU).  Returns ``(fn, is_new, fp,
    backend, via)``: ``fp`` is the fingerprint the ledger files the
    program under, ``backend`` the lowering ``core/autotune.py`` picks
    and ``via`` why.  A caller that already holds the program's
    :func:`_cache_key` and fingerprint passes them in.  A new mesh epoch
    (``set_mesh``, ``elastic.live_reshape``) empties the cache, as in
    the reference."""
    global _cache_epoch
    from ramba_tpu_torch.core import autotune as _autotune

    if key is None:
        key = _cache_key(program, leaf_vals, compile_class)
    if fp is None:
        fp = _ledger.fingerprint(key)
    try:
        hash(key)
        cacheable = True
    except TypeError:
        cacheable = False  # a static that hashes by identity only
    backend, via = _autotune.select(fp, program, leaf_vals)
    cache_key = key + (backend,)
    with _cache_lock:
        if _cache_epoch != _mesh.mesh_epoch:
            _compile_cache.clear()
            _cache_epoch = _mesh.mesh_epoch
        if cacheable:
            fn = _compile_cache.pop(cache_key, None)
            if fn is not None:
                _compile_cache[cache_key] = fn  # re-insert: most recent
                _registry.inc("fuser.cache_hit")
                _ledger.record_cache(fp, "hit")
                return fn, False, fp, backend, via
            if len(_compile_cache) >= _COMPILE_CACHE_MAX:
                old_key = next(iter(_compile_cache))  # least recently used
                _compile_cache.pop(old_key)
                old_fp = _ledger.fingerprint(old_key[:-1])
                _registry.inc("fuser.cache_evict")
                _ledger.record_cache(old_fp, "evict")
                _events.emit({"type": "cache_evict", "key": old_fp,
                              "capacity": _COMPILE_CACHE_MAX})
        _faults.check("compile", instrs=len(program.instrs))
        fn = _lower(program, leaf_vals, backend)
        _elastic.abandon_if_cancelled("the compile cache")
        if cacheable:
            _compile_cache[cache_key] = fn
        with _stats_lock:
            stats["compiles"] += 1
        _registry.inc("fuser.cache_miss")
        _ledger.record_cache(fp, "miss")
        return fn, True, fp, backend, via


def _device_of(leaf_vals):
    for v in leaf_vals:
        if isinstance(v, torch.Tensor):
            return v.device
    return None


def _origin(before: tuple) -> str:
    """Where a first call's seconds went, from ``_build``'s counts taken
    before it: a build, a library loaded from disk, or neither."""
    builds, loads = _build.counts()
    if builds > before[0]:
        return "nvcc"
    if loads > before[1]:
        return "persist"
    return "memory"


_fence_tls = threading.local()


def _fence_events(dev) -> tuple:
    """A pair of timing events on ``dev`` for one fenced call, taken from
    this thread's spare pair (the call puts it back once both have
    completed): making and destroying two CUDA events a call costs host
    time.  A call nested in another takes a pair of its own."""
    pairs = getattr(_fence_tls, "pairs", None)
    if pairs is None:
        pairs = _fence_tls.pairs = {}
    return pairs.pop(dev, None) or (torch.cuda.Event(enable_timing=True),
                                    torch.cuda.Event(enable_timing=True))


def _execute_compiled(fn, program: _Program, leaf_vals, is_new: bool,
                      span: Optional[dict], fp: str, backend: str, via: str,
                      rung: str = "fused", label: Optional[str] = None,
                      bytes_in: Optional[int] = None) -> tuple:
    """Run one compiled program with the ledger's and the attribution
    plane's bookkeeping.  A first call counts as a compile by origin,
    never as a sample.  A fenced call (``attrib.fence_decision``), a
    racing call and every call under ``RAMBA_PERF=sync`` is bracketed by
    one pair of CUDA events on the card: the host's wait in
    ``end.synchronize()`` is the span's ``device_execute`` stage and
    ``start.elapsed_time(end)`` the device window (on the CPU: the host
    wall from call entry through the call).  A CUDA error at the fence
    raises.  ``label`` and ``bytes_in`` are the flush's when the caller
    has them."""
    t_call = time.perf_counter()  # before the fault sites, as the reference
    _faults.check("execute", instrs=len(program.instrs))
    _faults.check("oom", instrs=len(program.instrs))
    gate = launch_gate.get()
    if gate is not None:
        gate()
    _elastic.abandon_if_cancelled("a launch")
    if label is None:
        label = _program_label(program)
    before = _build.counts() if is_new else None
    racing = via == "racing"
    fenced = _attrib.fence_decision(fp, span)
    timed = fenced or racing or _ledger.sync_timing()
    device_s = fence_dt = None
    dev = (_device_of(leaf_vals) or common.device()) if timed else None
    t0 = time.perf_counter()
    with _profile.annotation(label):
        if dev is not None and dev.type == "cuda":
            with torch.cuda.device(dev):
                e0, e1 = _fence_events(dev)
                e0.record()
                outs = fn(*leaf_vals)
                e1.record()
                dt = time.perf_counter() - t0
                e1.synchronize()
            fence_dt = time.perf_counter() - t0 - dt
            device_s = e0.elapsed_time(e1) / 1e3
            _fence_tls.pairs[dev] = (e0, e1)
        else:
            outs = fn(*leaf_vals)
            dt = time.perf_counter() - t0
            if timed:
                fence_dt = 0.0  # a CPU call returns with its work done
                device_s = time.perf_counter() - t_call
    if bytes_in is None:
        bytes_in = sum(_nbytes(v) for v in leaf_vals)
    bytes_out = sum(_nbytes(o) for o in outs)
    _elastic.abandon_if_cancelled("the ledger's execute record")
    if is_new:
        _timing.add_time("trace_compile_first_call", dt)
    else:
        _timing.add_time("flush_execute", dt)
        if common.timing_level > 0:
            _timing.add_func_time(label, dt)
    # a backend's slice takes compiles and racing samples only: the race's
    # evidence is device times, never a dispatch wall
    _ledger.record_execute(
        fp, label, len(program.instrs), rung, dt, is_new,
        bytes_in=bytes_in, bytes_out=bytes_out,
        sync_seconds=device_s if _ledger.sync_timing() else None,
        backend=backend if racing or is_new else None,
        backend_seconds=device_s if racing else None,
        origin=_origin(before) if is_new else None)
    if is_new:
        from ramba_tpu_torch.ops import kernel_backend

        cost = kernel_backend.program_cost(program, leaf_vals)
        if cost is None:  # the generic lowering: bytes only
            _ledger.capture_cost(fp, bytes_in + bytes_out, backend=backend)
        else:
            _ledger.capture_cost(fp, cost[1], backend=backend,
                                 flops=cost[0])
    if fenced:
        _observer.add("fence", fence_dt)
        if not is_new:
            _attrib.record_device(fp, label, device_s, backend=backend)
    elif not is_new and _attrib.sampling() and span is not None:
        # an unfenced sampled call carries the fenced p50 as an estimate
        # (never a stage: the card's tail overlaps the host here)
        est = _attrib.estimated_device_s(fp)
        if est is not None:
            span["device_est_s"] = round(span.get("device_est_s", 0.0) + est,
                                         6)
    if span is not None:
        _attrib.add_stage(span, "compile" if is_new else "dispatch",
                          (t0 - t_call) + dt)
        if fenced:
            _attrib.add_stage(span, "device_execute", fence_dt)
        span["calls"].append({"label": label,
                              "cache": "miss" if is_new else "hit",
                              "seconds": round(dt, 6), "backend": backend})
    return outs


def _execute(program: _Program, leaf_vals, span: Optional[dict] = None,
             compile_class=None, key: Optional[tuple] = None,
             fp: Optional[str] = None, label: Optional[str] = None,
             bytes_in: Optional[int] = None, rung: str = "fused") -> tuple:
    fn, is_new, fp, backend, via = _get_compiled(
        program, leaf_vals, compile_class=compile_class, key=key, fp=fp)
    return _execute_compiled(fn, program, leaf_vals, is_new, span, fp,
                             backend, via, rung=rung, label=label,
                             bytes_in=bytes_in)


def _kernel_takes(program: _Program, leaf_vals) -> bool:
    """True when the kernels take this program.  Such a program is never
    bucketed: a new extent costs the kernel a plan over a library already
    loaded (its source does not depend on the extent), less than the pad
    copy a bucket adds to every flush (``chip_smoke.py``'s shape soak on
    the card)."""
    from ramba_tpu_torch.ops import kernel_backend

    return kernel_backend.supports(program, leaf_vals)


# ---------------------------------------------------------------------------
# the prepare stage: certificates, compile classes, memo, the verifier
# ---------------------------------------------------------------------------

def _leaf_owner_counts(leaves) -> list:
    """Live-alias census per leaf slot: how many realized arrays own each
    leaf's storage, from the memory governor's ledger (``leaves``: the
    flush's Const/Scalar leaves or their values; a scalar owns
    nothing)."""
    return [_memory.ledger.owner_count(
        leaf.value if isinstance(leaf, Expr) else leaf) for leaf in leaves]


def _program_event(program: _Program, leaf_vals, donate_key: tuple,
                   label: str, fingerprint: Optional[str] = None,
                   compile_class=None) -> dict:
    """Offline-lintable record of the program a flush is about to run,
    in the reference's schema: ``python -m ramba_tpu_torch.analyze`` (or
    the reference's linter) re-checks graph hygiene and donation hazards
    from these events without the live process.  Statics are
    repr-truncated: the offline rules need structure (op names, slot
    refs, donate mask, owner counts), not closure identities.  ``x64``
    is always true: the port's regime is fixed."""
    ev = {
        "type": "program", "label": label,
        "instrs": [[op, repr(st)[:160], list(args)]
                   for op, st, args in program.instrs],
        "n_leaves": program.n_leaves,
        "leaf_kinds": "".join(program.leaf_kinds),
        "out_slots": list(program.out_slots),
        "donate": list(donate_key),
        "owners": _leaf_owner_counts(leaf_vals),
        "x64": True,
    }
    if fingerprint is not None:
        ev["fingerprint"] = fingerprint
    if compile_class is not None:
        ev["compile_class"] = list(compile_class)
    return ev


def _verify_if_enabled(program: _Program, leaves, exprs, donate_key: tuple,
                       span: dict, label: str, memo_plan=None,
                       class_plan=None, cache_key=None) -> bool:
    """RAMBA_VERIFY hook: statically verify the program about to run
    (``ramba_tpu_torch.analyze``).  Strict mode raises
    ProgramVerificationError on error findings — before anything is
    lowered, built or launched.  Warn mode returns True instead: the
    flush goes to the split rung.  One environment read when
    RAMBA_VERIFY is unset."""
    if not os.environ.get("RAMBA_VERIFY"):
        return False
    from ramba_tpu_torch.analyze import verifier as _verifier

    vmode = _verifier.mode()
    if vmode == "off":
        return False
    findings = _verifier.verify_flush(program, leaves, exprs, donate_key,
                                      label=label, memo_plan=memo_plan,
                                      class_plan=class_plan,
                                      cache_key=cache_key)
    if findings:
        counts: dict = {}
        for f in findings:
            counts[f.severity] = counts.get(f.severity, 0) + 1
        span["findings"] = counts
    errors = [f for f in findings if f.severity == "error"]
    if not errors:
        return False
    if vmode == "strict":
        from ramba_tpu_torch.analyze.findings import ProgramVerificationError

        raise ProgramVerificationError(errors)
    span["verify_routed"] = True
    with _stats_lock:
        stats["verify_routed"] += 1
    _registry.inc("analyze.verify_routed")
    return True


class _FlushWork:
    """What one flush carries from :func:`_prepare` to :func:`_dispatch`
    (the reference's ``_FlushWork``, without its async pipeline)."""

    __slots__ = ("program", "leaves", "exprs", "leaf_vals", "donate_key",
                 "span", "label", "segmented", "class_plan", "key",
                 "fingerprint", "memo_plan", "memo_hit", "plan_cert",
                 "plan_cache", "routed")

    def __init__(self, program, leaves, exprs, leaf_vals, span):
        self.program = program
        self.leaves = leaves
        self.exprs = exprs
        self.leaf_vals = leaf_vals
        self.donate_key = ()  # torch has no buffer donation
        self.span = span
        self.label = span["label"]
        cap = common.max_program_instrs
        self.segmented = bool(cap and len(program.instrs) > cap)
        self.class_plan = None
        self.key = None
        self.fingerprint = None
        self.memo_plan = None
        self.memo_hit = None
        self.plan_cert = None
        self.plan_cache = None
        self.routed = False


def _run_signature_key(program: _Program, leaf_vals, plan) -> tuple:
    """:func:`_cache_key` of the values the program runs on: the padded
    leaves' shapes under a bucket plan, without padding anything."""
    if plan is None:
        return _cache_key(program, leaf_vals)
    if plan.bucket <= plan.n:
        return _cache_key(program, leaf_vals, plan.token)
    sig = list(_leaf_signature(leaf_vals))
    for s in plan.pad_slots:
        shape, dt, dev = sig[s]
        sig[s] = ((plan.bucket,) + tuple(shape[1:]), dt, dev)
    return (program.key, tuple(sig), ("class",) + tuple(plan.token))


def _note_class(work: _FlushWork) -> None:
    plan = work.class_plan
    if _classes.enabled():
        _classes.note_decision(work.fingerprint, plan)
    if plan is not None:
        work.span["compile_class"] = list(plan.token)
        work.span["pad_waste_bytes"] = plan.pad_waste_bytes
        _ledger.record_class(work.fingerprint, plan.token,
                             plan.pad_waste_bytes, label=work.label)


def _redeem(program: _Program, leaf_vals, label: str, leaves):
    """The plan cache's lookup for one flush: the hit to redeem, or None
    (no certificate, a stale one, or a lookup that failed: the flush is
    analyzed afresh).  A certificate forged stale (``plan:stale``) is
    rejected under strict mode like a verifier error, before anything
    runs; warn mode re-analyzes."""
    try:
        hit = _plancache.lookup(program, leaf_vals, (), label, leaves)
    except NotImplementedError:
        raise
    except Exception:
        return None
    if hit is None or not hit.forged:
        return hit
    if _plancache.strict():
        from ramba_tpu_torch.analyze.findings import ProgramVerificationError

        raise ProgramVerificationError(_plancache.stale_findings(hit, label))
    return None


def _prepare(program: _Program, leaves, exprs, leaf_vals, span: dict,
             whole: bool = True) -> _FlushWork:
    """Everything between leaf gathering and the run, in the reference's
    ``_flush_prepare`` order: plan-certificate redemption, else the class
    plan (with its ``compile:bucket`` forge), the cache key and
    fingerprint, the ``program`` event, the memo plan, the verifier and
    certification; then the memo lookup.  ``whole`` is False for a rank's
    local program (``core/rankflush.py`` verified and certified the
    whole program before planning it): the memo alone runs there.  A
    segmented program runs its segments under their own keys, so its
    whole key and fingerprint are derived only for a switch or a trace
    that reads them."""
    work = _FlushWork(program, leaves, exprs, leaf_vals, span)
    label = work.label
    t0 = time.perf_counter()
    # everything before this point (rewrites, linearize, leaf gather) is
    # graph capture; everything after it the analysis pipeline, which a
    # plan certificate skips
    _attrib.add_stage(span, "trace", t0 - span["t0"])
    certs = whole and _plancache.enabled()
    memo_on = _memo.enabled()
    verify = whole and bool(os.environ.get("RAMBA_VERIFY"))
    plan_hit = _redeem(program, leaf_vals, label, leaves) if certs else None
    if plan_hit is not None:
        # redeem: every verdict below is adopted from the certificate
        cert = plan_hit.cert
        work.class_plan = None if work.segmented else \
            _plancache.class_plan_from(cert)
        work.key = _run_signature_key(program, leaf_vals, work.class_plan)
        work.fingerprint = cert.fingerprint or _ledger.fingerprint(work.key)
        if not work.segmented:
            _note_class(work)
        if _events.trace_enabled():
            pev = _program_event(
                program, leaf_vals, (), label, fingerprint=work.fingerprint,
                compile_class=(work.class_plan.token
                               if work.class_plan is not None else None))
            pev["plan_cache"] = plan_hit.tier
            if cert.chash is not None:
                pev["chash"] = cert.chash
            _events.emit(pev)
        if cert.memo_ok and memo_on:
            work.memo_plan = _memo.plan_from_cert(
                cert.chash, cert.canon_form, cert.leaf_order, cert.effects,
                leaves, leaf_vals)
        work.plan_cert = cert
        work.plan_cache = plan_hit.tier
        span["plan_cache"] = plan_hit.tier
        if cert.chash is not None:
            span["chash"] = cert.chash
        if cert.finding_counts:
            # the certified verdict's findings, re-stamped so the span
            # reads as a fresh analysis would
            span["findings"] = dict(cert.finding_counts)
    elif not work.segmented:
        plan = None
        if _classes.enabled() and not _kernel_takes(program, leaf_vals):
            try:
                plan = _classes.plan_for(program, leaf_vals)
            except Exception:
                plan = None
        # the compile:bucket fault site forges a plan that skips the
        # op-safety proof: the violation the compile-class rule exists to
        # catch
        try:
            _faults.check("compile:bucket", label=label)
        except _faults.InjectedFault:
            forged = _classes.forced_plan(program, leaf_vals)
            if forged is not None:
                plan = forged
        work.class_plan = plan
        work.key = _run_signature_key(program, leaf_vals, plan)
        work.fingerprint = _ledger.fingerprint(work.key)
        _note_class(work)
    elif certs or memo_on or verify or _events.trace_enabled():
        work.key = _cache_key(program, leaf_vals)
        work.fingerprint = _ledger.fingerprint(work.key)
    if plan_hit is None:
        if _events.trace_enabled():
            plan = work.class_plan
            _events.emit(_program_event(
                program, leaf_vals, (), label, fingerprint=work.fingerprint,
                compile_class=plan.token if plan is not None else None))
        if memo_on:
            try:
                work.memo_plan = _memo.plan_for(program, (), leaves,
                                                leaf_vals)
            except NotImplementedError:
                raise
            except Exception:
                work.memo_plan = None
        if verify:
            t_verify = time.perf_counter()
            work.routed = _verify_if_enabled(
                program, leaves, exprs, (), span, label,
                memo_plan=work.memo_plan, class_plan=work.class_plan,
                cache_key=work.key)
            _attrib.add_stage(span, "verify", time.perf_counter() - t_verify)
        if work.routed:
            # a distrusted flush neither consults nor fills the result
            # cache, runs exact shapes and certifies nothing
            work.memo_plan = None
            work.class_plan = None
            span.pop("compile_class", None)
            span.pop("pad_waste_bytes", None)
        elif certs:
            _elastic.abandon_if_cancelled("a plan certificate")
            try:
                work.plan_cert = _plancache.certify(work)
            except NotImplementedError:
                raise
            except Exception:
                work.plan_cert = None
    if work.memo_plan is not None:
        work.memo_hit = _memo.lookup(work.memo_plan)
    if work.fingerprint is not None:
        span["fingerprint"] = work.fingerprint
    _attrib.add_stage(span, "prepare", (time.perf_counter() - t0)
                      - span["stages"].get("verify", 0.0))
    return work


# ---------------------------------------------------------------------------
# the degradation ladder's rungs (resilience/degrade.py)
# ---------------------------------------------------------------------------


def _attempt_fused(work: _FlushWork) -> tuple:
    """The fused rung: the program through the compile cache (by
    segments when it is longer than ``common.max_program_instrs``),
    bucketed when it has a class plan: leaves padded to the bucket,
    outputs sliced back.  Only this rung buckets; the lower rungs run
    exact shapes."""
    program, span, leaf_vals = work.program, work.span, work.leaf_vals
    if work.segmented:
        return _run_segmented(program, leaf_vals, span)
    plan = work.class_plan
    if plan is None:
        return _execute(program, leaf_vals, span, key=work.key,
                        fp=work.fingerprint, label=work.label,
                        bytes_in=span["leaf_bytes"])
    run_vals = _classes.apply(plan, leaf_vals)
    outs = _execute(program, run_vals, span, compile_class=plan.token,
                    key=work.key, fp=work.fingerprint, label=work.label)
    del run_vals
    return _classes.strip(plan, outs)


def _run_chunked(program: _Program, leaf_vals,
                 span: Optional[dict] = None) -> tuple:
    """The chunked rung: the segmented executor bounded by the estimated
    live bytes of each segment (``memory.chunk_target_bytes()``, this
    rank's own in a rank-local program) instead of an instruction count;
    every value still dies after its last use, which is what bounds the
    peak."""
    from ramba_tpu_torch.analyze import rules as _rules
    from ramba_tpu_torch.core.expr import aval_of

    slot_bytes = _rules.slot_nbytes(program, [aval_of(v) for v in leaf_vals])
    cap = _memory.chunk_target_bytes(_whole_job())
    if span is not None:
        span["chunk_bytes"] = cap
    _registry.inc("fuser.chunked_runs")
    return _run_segmented(program, leaf_vals, span, rung="chunked",
                          slot_bytes=slot_bytes, max_seg_bytes=cap)


def _sync_device() -> None:
    """Wait for the card, so an asynchronous CUDA failure of what was
    just launched lands here."""
    dev = common.device()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _record_rung(program: _Program, leaf_vals, outs, rung: str, dt: float,
                 span: Optional[dict], wait: float = 0.0) -> None:
    """A lower rung's run in the ledger and on the span: ``dt`` seconds,
    of them ``wait`` the host's wait on the card (the span's
    ``device_execute``; the rest its ``dispatch``)."""
    _elastic.abandon_if_cancelled("the ledger's execute record")
    _attrib.add_stage(span, "dispatch", dt - wait)
    _attrib.add_stage(span, "device_execute", wait)
    label = _program_label(program)
    _ledger.record_execute(
        _ledger.fingerprint(_cache_key(program, leaf_vals)), label,
        len(program.instrs), rung, dt, False,
        bytes_in=sum(_nbytes(v) for v in leaf_vals),
        bytes_out=sum(_nbytes(o) for o in outs))
    if span is not None:
        span["calls"].append({"label": label, "cache": rung,
                              "seconds": round(dt, 6)})


def _run_eager(program: _Program, leaf_vals, span: Optional[dict]) -> tuple:
    """The eager rung: one torch op per instruction
    (:func:`run_instructions`), no compile cache and no kernel family,
    then a wait for the card, so an asynchronous CUDA failure lands
    inside this rung."""
    _faults.check("eager")
    gate = launch_gate.get()
    if gate is not None:
        gate()
    _elastic.abandon_if_cancelled("a launch")
    t0 = time.perf_counter()
    outs = run_instructions(program, leaf_vals)
    t1 = time.perf_counter()
    _sync_device()
    t2 = time.perf_counter()
    _record_rung(program, leaf_vals, outs, "eager", t2 - t0, span,
                 wait=t2 - t1)
    return outs


def _whole_job() -> bool:
    """True when this flush is the job's, so its recovery rounds may run:
    one process (the coherence layer engages there only in its loopback
    ``force`` mode).  In a job of several processes a flush outside
    ``core/rankflush.py`` is one rank's own (a spmd kernel's, a program
    under ``mesh.local_scope``): its ladder, admission and evictions run
    no round the other ranks would have to join."""
    return _distributed.process_count() == 1


def _run_host(program: _Program, leaf_vals, span: Optional[dict]) -> tuple:
    """The host rung (last): the whole program on CPU tensors, where
    every kernel wrapper takes its plain version, on a one-shard mesh (a
    mesh of shards on one card holds views of one tensor, so one shard
    gives the same values), then every output placed back on the process
    device through the governor (``memory.governed_device_put``).  A
    placement that still fails raises: a CPU tensor would break the next
    program on the card (the reference keeps a host-committed array)."""
    _faults.check("host")
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    dev = common.device()
    host_vals = [v.to(cpu) if isinstance(v, torch.Tensor) else v
                 for v in leaf_vals]
    with common.device_scope(cpu), _mesh.local_scope():
        outs = run_instructions(program, host_vals)
    del host_vals
    _elastic.abandon_if_cancelled("placing the host rung's outputs")
    if dev.type != "cpu":
        outs = tuple(_memory.governed_device_put(o, dev, site="host_rung")
                     if isinstance(o, torch.Tensor) else o for o in outs)
    _record_rung(program, leaf_vals, outs, "host", time.perf_counter() - t0,
                 span)
    return outs


def _rung(work: _FlushWork, name: str):
    """The thunk that runs ``work``'s program on rung ``name``."""
    program, leaf_vals, span = work.program, work.leaf_vals, work.span
    if name == "fused":
        fn = lambda: _attempt_fused(work)  # noqa: E731
    elif name == "split":
        cap = common.max_program_instrs or len(program.instrs)
        half = max(1, min(len(program.instrs), cap) // 2)
        fn = lambda: _run_segmented(  # noqa: E731
            program, leaf_vals, span, seg_size=half, rung="split")
    elif name == "chunked":
        fn = lambda: _run_chunked(program, leaf_vals, span)  # noqa: E731
    elif name == "eager":
        fn = lambda: _run_eager(program, leaf_vals, span)  # noqa: E731
    else:
        fn = lambda: _run_host(program, leaf_vals, span)  # noqa: E731
    return fn


def _checked(name: str, fn, wd: Optional[float] = None):
    """``fn`` behind the ``dispatch`` fault site: one check a rung
    attempt of a flush (``core/rankflush.py`` checks once a rung attempt
    of all of a rank's programs).  With the watchdog armed (``wd``
    seconds) the attempt runs under ``elastic.with_deadline``: a hang
    becomes a degrade-class ``RankStallError`` and the ladder moves on;
    an attempt that wakes after its deadline stops before the rung
    body (and before every launch and commit inside it)."""
    def attempt():
        _faults.check("dispatch", rung=name)
        _elastic.abandon_if_cancelled(f"the {name} rung")
        return fn()

    if wd is None:
        return attempt
    return lambda: _elastic.with_deadline("dispatch", attempt, timeout_s=wd)


def rungs_for(n_instrs: Optional[int], skip_fused: bool = False,
              route_chunked: bool = False, host: bool = False) -> list:
    """The rung names of a flush's ladder, as the reference builds it:
    ``skip_fused`` (the verifier's warn verdict) starts at split,
    ``route_chunked`` (admission) at chunked; split and chunked need
    more than one instruction (``n_instrs=None``: offer them, the
    rank flush's fixed list); host only where asked (one process)."""
    many = n_instrs is None or n_instrs > 1
    names = []
    if not skip_fused and not route_chunked:
        names.append("fused")
    if (many or skip_fused) and not route_chunked:
        names.append("split")
    if many or route_chunked:
        names.append("chunked")
    names.append("eager")
    if host:
        names.append("host")
    return names


def _execute_resilient(work: _FlushWork, route_chunked: bool = False,
                       whole: bool = True, wd: Optional[float] = None):
    """Run the flush down the degradation ladder
    (``resilience/degrade.py``): fused → split → chunked → eager → host
    (``whole``: :func:`_whole_job`; else no host rung and no round).
    Returns ``(outs, rung)``.  Each rung attempt runs under the elastic
    watchdog when ``wd`` (``RAMBA_WATCHDOG_S``, which :func:`_dispatch`
    reads once a flush) is set.  The reference's deadline pruning and
    hedging, and its clamp of the watchdog to a request's deadline, come
    with serving (ROADMAP A.10)."""
    names = rungs_for(len(work.program.instrs), work.routed, route_chunked,
                      whole)
    return _degrade.run_ladder(
        "flush", [(n, _checked(n, _rung(work, n), wd)) for n in names],
        coherent=whole and _coherence.engaged())


def _with_magnitudes(program: _Program, leaf_vals):
    """``program`` with one more output for each float ``sum``/``mean``
    output (a reduction or a groupby): the same reduction of ``|x|``.
    Returns ``(program, extra)``, ``extra`` a list of (output index,
    terms a result sums, kind) in the order of the added outputs."""
    from ramba_tpu_torch.compile.classes import slot_avals
    from ramba_tpu_torch.core.expr import aval_of

    n0 = program.n_leaves
    try:
        avals = slot_avals(program, [aval_of(v) for v in leaf_vals])
    except Exception:
        avals = None
    if avals is None:
        return program, []
    instrs, outs, extra = list(program.instrs), [], []
    for k, s in enumerate(program.out_slots):
        if s < n0:
            continue
        op, st, args = program.instrs[s - n0]
        if op not in ("reduce", "segment_reduce") or st[0] not in (
                "sum", "mean", "prod"):
            continue
        src, out = avals[args[0]], avals[s]
        if src is None or out is None or src.dtype.kind not in "fc":
            continue
        size = 1
        for d in src.shape:
            size *= int(d)
        osize = 1
        for d in out.shape:
            osize *= int(d)
        terms = size if op == "segment_reduce" else size // max(1, osize)
        extra.append((k, terms, st[0]))
        if st[0] == "prod":
            continue  # its bound reads the shadow value itself
        instrs.append(("map", ("absolute",), (args[0],)))
        instrs.append((op, st, (n0 + len(instrs) - 1,) + tuple(args[1:])))
        outs.append(n0 + len(instrs) - 1)
    if not extra:
        return program, []
    aug = _Program(tuple(instrs), n0, program.leaf_kinds,
                   tuple(program.out_slots) + tuple(outs))
    return aug, extra


def _audit_rerun(program: _Program, leaf_vals):
    """The shadow run of an audit: the eager rung, and the slack of each
    float reduction output from the kernels' rounding depth (the deeper
    of elemred's and segred's for its number of terms): 2 * depth * eps *
    (the reduction of |x|) for a sum or mean, as ``chip_smoke.py``'s
    ``sum_bound``; 10 * sqrt(n) * eps * |value| for a product (its
    ``prod_bound``).  Returns ``(outputs, slack)``."""
    from ramba_tpu_torch.ops import elemred, segred

    aug, extra = _with_magnitudes(program, leaf_vals)
    outs = _run_eager(aug, leaf_vals, None)
    n_out = len(program.out_slots)
    shadow, mags = outs[:n_out], list(outs[n_out:])
    slack = [None] * n_out
    for k, terms, kind in extra:
        o = shadow[k]
        eps = float(torch.finfo(o.real.dtype if o.is_complex()
                                else o.dtype).eps)
        if kind == "prod":
            slack[k] = 10 * terms ** 0.5 * eps * o.abs().double()
            continue
        depth = max(elemred.depth(terms), segred.depth(terms))
        slack[k] = 2 * depth * eps * mags.pop(0).double()
    return shadow, slack


def _dispatch(work: _FlushWork, rung: Optional[str] = None) -> tuple:
    """Run a prepared flush: a memo hit is served as it is (no lowering,
    no launch); anything else passes admission (``memory.admit``: a
    flush that does not fit starts at the chunked rung) and runs down
    the degradation ladder, from the split rung when the verifier routed
    it.  A rank's local program (``rung`` given) runs on that rung alone:
    ``core/rankflush.py`` runs the ladder and admission around all of a
    rank's programs.  A certified result of the fused rung is
    shadow-audited under ``RAMBA_AUDIT``, and enters the result cache
    unless the audit disagreed."""
    span = work.span
    # an incident of this flush is dumped after its span is final
    with _telemetry.deferred_flight():
        if work.memo_hit is not None:
            outs = tuple(work.memo_hit)
            work.memo_hit = None
            _finish_memo_span(work, outs)
            return outs
        with _telemetry.span_scope(span.get("trace_id"), span.get("span_id")):
            return _dispatch_traced(work, rung)


_CALL_STAGES = ("compile", "dispatch", "device_execute")


def _dispatch_traced(work: _FlushWork, rung: Optional[str]) -> tuple:
    program, span, leaf_vals = work.program, work.span, work.leaf_vals
    stages = span["stages"]
    with _profile.flush_annotation("ramba_flush:" + work.label,
                                   trace_id=span.get("trace_id")):
        if rung is None:
            whole = _whole_job()
            wd = _elastic.watchdog_seconds()  # the flush's one read
            with _coherence.flush_scope(wd):
                t_admit = time.perf_counter()
                route = _memory.admit(program, leaf_vals, (), span,
                                      coherent=whole,
                                      fingerprint=work.fingerprint)
                _attrib.add_stage(span, "admit",
                                  time.perf_counter() - t_admit)
                pre = sum(stages.get(k, 0.0) for k in _CALL_STAGES)
                t_ladder = time.perf_counter()
                outs, rung = _execute_resilient(work, route, whole, wd)
            audit = rung == "fused"
        else:
            pre = sum(stages.get(k, 0.0) for k in _CALL_STAGES)
            t_ladder = time.perf_counter()
            outs = _rung(work, rung)()
            audit = whole = False
    t_writeback = time.perf_counter()
    # the ladder's host residual (cache lookups, retries, the attempt's
    # thread under the watchdog) is dispatch overhead: the slice of the
    # ladder's window the per-call stamps did not cover
    _attrib.add_stage(span, "dispatch", (t_writeback - t_ladder) - (
        sum(stages.get(k, 0.0) for k in _CALL_STAGES) - pre))
    if rung != "fused":
        span["degraded"] = rung
    mismatch = False
    if audit and work.memo_plan is not None and work.memo_plan.certified \
            and os.environ.get("RAMBA_AUDIT"):
        from ramba_tpu_torch.resilience import integrity as _integrity

        mismatch = _integrity.shadow_audit(
            work.label, outs, lambda: _audit_rerun(program, leaf_vals),
            plan=work.memo_plan, span=span, coherent=whole)
    _elastic.abandon_if_cancelled("the result memo")
    if work.memo_plan is not None and not mismatch:
        try:
            _memo.insert(work.memo_plan, list(outs))
        except Exception:
            _registry.inc("memo.insert_failed")
    _finish_span(span, outs, t_writeback, work.fingerprint)
    return outs


def _finish_memo_span(work: _FlushWork, outs) -> None:
    """The span of a flush the result cache served: ``cache: "memo"``,
    no compile or execute seconds; the ledger counts a memo hit, and the
    slow-flush sentinel is not fed (a near-zero wall would poison the
    program's latency history)."""
    span = work.span
    span["segments"] = 0
    span["compile_s"] = 0.0
    span["execute_s"] = 0.0
    span["cache"] = "memo"
    span["memo_hit"] = True
    span["out_bytes"] = sum(_nbytes(v) for v in outs)
    span["wall_s"] = round(time.perf_counter() - span.pop("t0"), 6)
    _elastic.abandon_if_cancelled("the flush span")
    _attrib.finalize_span(span, fp=work.fingerprint)
    _ledger.record_memo_hit(work.fingerprint, work.label)
    _events.emit(span)
    _slo.observe_span(span)
    _slo.observe_e2e(span["wall_s"], span=span)
    _elastic.note_progress("flush")


def _new_span(program: _Program, leaf_vals,
              t0: Optional[float] = None) -> dict:
    """A flush's span; ``t0`` is when the flush began (before its
    rewrites and linearization), else now.  Starts the profiler and the
    telemetry exporter where the environment asks for them."""
    _profile.ensure_started()
    _telemetry.ensure_started()
    return {"type": "flush", "label": _program_label(program),
            "instrs": len(program.instrs),
            "leaf_bytes": sum(_nbytes(v) for v in leaf_vals),
            "t0": time.perf_counter() if t0 is None else t0, "calls": [],
            "stages": {}}


def _finish_span(span: dict, outs, t_writeback: float,
                 fp: Optional[str]) -> None:
    """The span's totals from its calls; its ``write_back`` stage (from
    ``t_writeback``, the ladder's return), its finalized waterfall; then
    the ``flush`` event, the slow-flush sentinel and the SLO
    histograms."""
    calls = span["calls"]
    span["segments"] = len(calls) - 1 if len(calls) > 1 else 0
    span["compile_s"] = round(
        sum(c["seconds"] for c in calls if c["cache"] == "miss"), 6)
    span["execute_s"] = round(
        sum(c["seconds"] for c in calls if c["cache"] == "hit"), 6)
    span["cache"] = "miss" if any(c["cache"] == "miss" for c in calls) \
        else "hit"
    span["out_bytes"] = sum(_nbytes(v) for v in outs)
    t_end = time.perf_counter()
    span["wall_s"] = round(t_end - span.pop("t0"), 6)
    _attrib.add_stage(span, "write_back", t_end - t_writeback)
    _attrib.finalize_span(span, fp=fp)
    _events.emit(span)
    _ledger.observe_flush(span)
    _slo.observe_span(span)
    _slo.observe_e2e(span["wall_s"], span=span)
    _elastic.note_progress("flush")


def run_program(program: _Program, leaf_vals, split: bool = False,
                rung: Optional[str] = None) -> tuple:
    """Run one linearized program as a flush runs it (segments, compile
    classes, the result memo, the ledger, a span);
    ``core/rankflush.py`` runs every rank's programs through here, having
    verified the whole program first (``split``: its verdict routed the
    flush to the split rung), on the ``rung`` its ladder is on."""
    span = _new_span(program, leaf_vals)
    work = _prepare(program, None, None, leaf_vals, span, whole=False)
    if split:
        work.routed = True
        work.memo_plan = work.memo_hit = work.class_plan = None
    return _dispatch(work, rung)


def verify_whole(exprs) -> bool:
    """The verifier and the plan cache across ranks
    (``core/rankflush.py``): the whole program, before it is planned
    into rank-local programs, is verified on every rank — the rules read
    the graph and the leaves' global avals and layouts, so every rank
    reaches the same verdict.  A strict error (or a forged stale
    certificate) raises here, and the flush's one outcome agreement
    carries it to every rank.  Returns True when warn mode routes the
    flush to the split rung.  A redeemed certificate (keyed on global
    shapes, the same on every rank) skips the verifier; hits agree in
    batches over coherence.  One environment read each when the switches
    are unset."""
    verify = bool(os.environ.get("RAMBA_VERIFY"))
    certs = _plancache.enabled()
    if not (verify or certs):
        return False
    program, leaves = _linearize(list(exprs))
    span = {"label": _program_label(program)}
    work = _FlushWork(program, leaves, exprs, leaves, span)
    work.segmented = False
    if certs and _redeem(program, leaves, work.label, leaves) is not None:
        return False
    routed = _verify_if_enabled(program, leaves, exprs, (), span,
                                work.label)
    if certs and not routed:
        _plancache.certify(work)
    return routed


def _quarantine(stream: FlushStream, roots: list,
                error: Optional[BaseException] = None,
                label: Optional[str] = None) -> None:
    """The roots of a program that raised leave the pending registry, or
    the one broken graph would re-enter, and re-fail, every later flush.
    They keep their lazy graphs: a later read re-runs each one alone
    (``ndarray._value``), so an array that did not cause the error still
    gets its value and a broken one raises its own error again.  Emits
    the reference's ``flush_error`` event (an incident: the trace's tail
    latch and the flight recorder key on it), with the agreed epoch of
    the ladder's last round where there was one."""
    for arr in roots:
        stream.unregister(arr)
    n = len(roots)
    with _stats_lock:
        stats["quarantined"] += n
    _registry.inc("resilience.flush_quarantined", n)
    ev = {"type": "flush_error", "label": label, "quarantined": n,
          "error": f"{type(error).__name__}: {error}"[:300]}
    epoch = _coherence.last_epoch("flush:rung")
    if epoch:
        ev["coherence_epoch"] = epoch
    _events.emit(ev)


_KEEPS_LAYOUT = frozenset({"map", "cast", "round"})


def _result_layout(expr, mesh):
    """The layout a flush gives a root (None: the default layout of the
    mesh it is read on): a sharding hint's, else the one layout other
    than the default that every full-shape leaf under an elementwise root
    has, as GSPMD carries an operand's layout to an elementwise result."""
    if isinstance(expr, Node) and expr.op == "shard_hint":
        return expr.static[0]
    if mesh.size <= 1 or not isinstance(expr, Node) \
            or expr.op not in _KEEPS_LAYOUT:
        return None
    shape = expr.shape
    found = set()
    stack, seen = [expr], set()
    while stack:
        e = stack.pop()
        if id(e) in seen or e.shape != shape:
            continue
        seen.add(id(e))
        if isinstance(e, Const):
            sh = e.sharding
            found.add(sh if sh is not None and sh.mesh == mesh else None)
        elif isinstance(e, Node) and e.op == "shard_hint":
            found.add(e.static[0])
        elif isinstance(e, Node) and e.op in _KEEPS_LAYOUT:
            stack.extend(e.args)
    sh = found.pop() if len(found) == 1 else None
    if sh is None or _mesh.canonical(sh.spec) == _mesh.canonical(
            _mesh.default_spec(shape, mesh)):
        return None  # the default layout: carried by no leaf
    return sh


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
    t_flush = time.perf_counter()
    program = None
    try:
        program, leaves, exprs = _prepare_program(exprs)
        leaf_vals = [leaf_value(leaf) for leaf in leaves]
        # a flush's leaves are never spill candidates while it runs
        pins = _memory.ledger.pin_values(leaf_vals)
        try:
            span = _new_span(program, leaf_vals, t_flush)
            work = _prepare(program, leaves, exprs, leaf_vals, span)
            outs = _dispatch(work)
            del work
        finally:
            _memory.ledger.unpin(pins)
            for hook in after_flush:
                hook()
    except Exception as e:
        _quarantine(stream, roots, e, _program_label(program)
                    if program is not None else None)
        raise
    for arr, expr, val in zip(roots, root_exprs, outs):
        arr._set_expr(Const(val, sharding=_result_layout(expr, mesh)))
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
        return leaf_value(c)
    from ramba_tpu_torch.core import rankflush

    return rankflush.gather_const(c)


def analyze_pending() -> Optional[dict]:
    """What the next flush would run, without running it: instruction
    and leaf counts, the bytes of its arguments and outputs, and for a
    program longer than ``common.max_program_instrs`` the number of
    segments it runs as with the peak argument and output bytes of one
    segment (ramba_tpu reports XLA's memory analysis here; the port has
    no compiler to ask, so temporaries are not counted).  The pending
    graph stays pending; None when nothing is pending."""
    from ramba_tpu_torch.compile.classes import _itemsize, slot_avals
    from ramba_tpu_torch.core.expr import aval_of

    exprs = [a._expr for a in _default_stream.pending_roots()]
    if not exprs:
        return None
    if common.rewrite_enabled:
        from ramba_tpu_torch.core.rewrite import rewrite_roots

        exprs = rewrite_roots(exprs)
    program, leaves = _linearize(exprs)
    avals = slot_avals(program, [aval_of(leaf.value) for leaf in leaves])

    def nbytes(slots):
        if avals is None:
            return None
        total = 0
        for s in slots:
            a = avals[s]
            n = 1
            for d in a.shape:
                n *= int(d)
            total += n * _itemsize(a.dtype)
        return total

    out = {"instructions": len(program.instrs),
           "n_leaves": program.n_leaves,
           "argument_size_in_bytes": nbytes(range(program.n_leaves)),
           "output_size_in_bytes": nbytes(program.out_slots)}
    if (common.max_program_instrs
            and len(program.instrs) > common.max_program_instrs):
        out["segments"] = 0
        peak_in = peak_out = 0
        for _seg, in_slots, out_here, _top in _iter_segments(
                program, _last_use_map(program)):
            out["segments"] += 1
            if avals is not None:
                peak_in = max(peak_in, nbytes(in_slots))
                peak_out = max(peak_out, nbytes(out_here))
        if avals is not None:
            out["argument_size_in_bytes"] = peak_in
            out["output_size_in_bytes"] = peak_out
    return out


def evaluate(expr: Expr):
    """Evaluate one expression (flushing pending work alongside it)."""
    if isinstance(expr, Const):
        return leaf_value(expr)
    return flush(extra=[expr])[0]
