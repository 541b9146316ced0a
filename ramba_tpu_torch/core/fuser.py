"""Flush machinery: lazy expression graphs -> one program per flush.

Counterpart of ``ramba_tpu/core/fuser.py``.  A flush collects the
pending arrays of one flush stream (the process's default stream, or a
serving session's: :class:`FlushStream`), applies the graph rewrites
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
that fails to build or launch raises.  The one route off a kernel is the
race's pre-warm (``autotune.maybe_prewarm``): under ``race`` with a live
serve pipeline, a racing flush whose kernel libraries are still building
on the pipeline runs the generic lowering, with ``prewarm`` in its span.

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
  (``compile/persist.py``), which saves their builds and each new
  program's skeleton (a miss looks its entry up first, a fresh compile
  registers it), so a warm pool in another process can rebuild and
  launch the program before traffic arrives;
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

A stream's flush is two stages, :func:`_flush_prepare` and
:func:`_flush_dispatch`: the serve pipeline (``serve/pipeline.py``) runs
the first on the submitting thread and the second on its dispatch
worker, with the overload plane's verdict, a memo re-lookup (batch CSE)
and an abandoned ticket's dropped write-back between them.  Under a
request deadline (``serve/overload.py``) the ladder drops the rungs whose
rolling p50 cannot fit the budget, checks expiry before every attempt
and clamps the watchdog to the remaining budget; under
``RAMBA_HEDGE_FACTOR`` a certified-pure, reproducible dispatch past its
threshold races a second attempt.

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
from ramba_tpu_torch.compile import persist as _persist
from ramba_tpu_torch.core import memo as _memo
from ramba_tpu_torch.core import plancache as _plancache
from ramba_tpu_torch.core.expr import OPS, Const, Expr, Node, Scalar
from ramba_tpu_torch.observe import attrib as _attrib
from ramba_tpu_torch.observe import events as _events
from ramba_tpu_torch.observe import fleet as _fleet
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
# flush streams
# ---------------------------------------------------------------------------

_stream_ids = itertools.count(1)

# id(arr) -> the session stream that owns its pending work.  Arrays of the
# default stream are not entered: with no session open, registering costs
# the default stream what it did before streams existed.
_arr_streams: dict = {}
_reg_lock = threading.RLock()


class FlushStream:
    """Pending registry + flush scope: the process-wide default stream,
    plus one per serving session (``serve.Session``), as in the
    reference.  Each stream owns its pending registry, its
    ``nodes_since_flush`` counter and ``max_pending_ops`` threshold (one
    tenant's build burst never flushes another tenant's half-built
    program), its quarantine scope (a failed flush takes only this
    stream's roots out), and its flush order: ``_flush_lock`` serializes
    flushes of one stream while different streams flush concurrently.
    The serving fields (tenant, quota, trace ids, deadline, priority,
    in-flight tickets) are read only for a session's stream."""

    __slots__ = ("stream_id", "name", "tenant", "max_pending_ops",
                 "quota_bytes", "on_threshold", "inflight", "stats",
                 "nodes_since_flush", "trace_id", "root_span",
                 "deadline_ms", "priority",
                 "_pending", "_lock", "_flush_lock", "__weakref__")

    def __init__(self, name: Optional[str] = None,
                 tenant: Optional[str] = None,
                 max_pending_ops: Optional[int] = None,
                 quota_bytes: Optional[int] = None):
        self.stream_id = next(_stream_ids)
        self.name = name or f"stream{self.stream_id}"
        self.tenant = tenant
        # None: the process-wide common.max_pending_ops
        self.max_pending_ops = max_pending_ops
        # the tenant's device-byte quota, held by memory.admit
        self.quota_bytes = quota_bytes
        # set by a serving session: a threshold flush goes through the
        # async pipeline instead of blocking the building thread
        self.on_threshold = None
        # the causal trace a serving session mints
        self.trace_id: Optional[str] = None
        self.root_span: Optional[str] = None
        # the overload plane's per-flush budget and brownout exemption
        self.deadline_ms: Optional[float] = None
        self.priority = False
        # queued tickets (serve/pipeline.py), so drain() and a read can
        # wait for them
        self.inflight: list = []
        self.stats = {"flushes": 0, "nodes_flushed": 0, "quarantined": 0,
                      "enqueued": 0}
        self.nodes_since_flush = 0
        self._pending: dict[int, "weakref.ref"] = {}
        self._lock = threading.RLock()
        self._flush_lock = threading.RLock()
        _streams.add(self)

    def __repr__(self):
        return (f"<FlushStream {self.name!r} tenant={self.tenant!r} "
                f"pending={len(self._pending)}>")

    def register(self, arr) -> None:
        k = id(arr)

        # the owner map and its lock are bound here: at interpreter exit
        # this module's globals may be gone before the last callback
        def _cleanup(ref, _k=k, _s=self, _owners=_arr_streams,
                     _olock=_reg_lock):
            with _s._lock:
                if _s._pending.get(_k) is ref:
                    del _s._pending[_k]
                else:
                    return
            if _owners.get(_k) is _s:
                with _olock:
                    if _owners.get(_k) is _s:
                        del _owners[_k]

        with self._lock:
            self._pending[k] = weakref.ref(arr, _cleanup)

    def unregister(self, arr) -> None:
        with self._lock:
            self._pending.pop(id(arr), None)

    def pending_arrays(self) -> list:
        with self._lock:
            refs = list(self._pending.values())
        return [a for a in (r() for r in refs) if a is not None]

    def pending_roots(self) -> list:
        """Pending arrays in creation order: the roots of the next flush
        (the registry and the node counter are left as they are)."""
        roots = [a for a in self.pending_arrays()
                 if not isinstance(a._expr, Const)]
        roots.sort(key=lambda a: a._seq)
        return roots

    def _collect(self, *, detach: bool = False) -> list:
        """The roots of the next flush, with the node counter reset.
        ``detach`` (the pipeline's enqueue) also takes them out of the
        registry, so a later flush cannot collect, and run again, the same
        work; the returned references keep them alive until write-back."""
        with self._lock:
            self.nodes_since_flush = 0
            roots = []
            for r in list(self._pending.values()):
                a = r()
                if a is not None and not isinstance(a._expr, Const):
                    roots.append(a)
            roots.sort(key=lambda a: a._seq)
            if detach:
                for a in roots:
                    self._pending.pop(id(a), None)
        if detach and roots and _arr_streams:
            with _reg_lock:
                for a in roots:
                    if _arr_streams.get(id(a)) is self:
                        del _arr_streams[id(a)]
        return roots

    def note_node_created(self) -> None:
        """Forced-flush safety valve for unbounded build loops, per
        stream."""
        with self._lock:
            self.nodes_since_flush += 1
            cap = self.max_pending_ops
            if cap is None:
                cap = common.max_pending_ops
            fire = cap and self.nodes_since_flush >= cap
        if fire:
            hook = self.on_threshold
            if hook is not None:
                hook(self)
            else:
                self.flush()

    def flush(self, extra: Sequence[Expr] = ()) -> list:
        """Materialize this stream's pending arrays (and ``extra``
        expressions) in one program run.  Returns the values of ``extra``
        in order."""
        with self._flush_lock:
            if self is _default_stream and _current_stream.get() is None:
                # the default stream is the current one already
                return _flush_roots(self, self._collect(), extra)
            with stream_scope(self):
                return _flush_roots(self, self._collect(), extra)

    def drain(self) -> None:
        """Wait for every queued flush of this stream (serve/pipeline.py)
        to finish; their failures surface through the tickets and later
        reads, not here."""
        if not self.inflight:
            return
        for t in list(self.inflight):
            try:
                t.wait()
            except Exception:
                pass


# every live stream, weakly: a dropped session's stream is collectable
_streams: "weakref.WeakSet[FlushStream]" = weakref.WeakSet()
_default_stream = FlushStream(name="default")

_current_stream: "contextvars.ContextVar[Optional[FlushStream]]" = \
    contextvars.ContextVar("ramba_flush_stream", default=None)


def current_stream() -> FlushStream:
    s = _current_stream.get()
    return s if s is not None else _default_stream


def default_stream() -> FlushStream:
    return _default_stream


def current_tenant() -> Optional[str]:
    s = _current_stream.get()
    return s.tenant if s is not None else None


# the memory governor files each realized leaf under this tenant
_memory.tenant_of = current_tenant


class stream_scope:
    """Make ``stream`` the current stream of the calling context: new lazy
    arrays register on it, and attribution follows it."""

    __slots__ = ("stream", "_token")

    def __init__(self, stream: FlushStream):
        self.stream = stream

    def __enter__(self):
        self._token = _current_stream.set(self.stream)
        return self.stream

    def __exit__(self, *exc):
        _current_stream.reset(self._token)


def activate_stream(stream: FlushStream):
    """Activation without a ``with`` (``serve.Session.__enter__``); returns
    the token :func:`deactivate_stream` takes."""
    return _current_stream.set(stream)


def deactivate_stream(token) -> None:
    _current_stream.reset(token)


def all_streams() -> list:
    """Live streams: the default first, then by creation order."""
    out = [s for s in list(_streams) if s is not _default_stream]
    out.sort(key=lambda s: s.stream_id)
    return [_default_stream] + out


def stream_of(arr) -> FlushStream:
    """The stream that owns ``arr``'s pending work (the current stream
    when it is pending nowhere: realized or quarantined)."""
    k = id(arr)
    s = _arr_streams.get(k) if _arr_streams else None
    if s is not None:
        return s
    if k in _default_stream._pending:
        return _default_stream
    return current_stream()


def register_pending(arr) -> FlushStream:
    """Enter ``arr`` in the pending registry of the stream that owns it
    (the current stream, unless it is pending on another already);
    returns that stream, whose threshold the caller advances
    (``note_node_created``)."""
    k = id(arr)
    s = _arr_streams.get(k) if _arr_streams else None
    if s is None:
        cur = _current_stream.get()
        if cur is None or cur is _default_stream \
                or k in _default_stream._pending:
            _default_stream.register(arr)
            return _default_stream
        with _reg_lock:
            s = _arr_streams.setdefault(k, cur)
    s.register(arr)
    return s


def unregister_pending(arr) -> None:
    s = None
    if _arr_streams:
        with _reg_lock:
            s = _arr_streams.pop(id(arr), None)
    (s if s is not None else _default_stream).unregister(arr)


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
                  key: Optional[tuple] = None, fp: Optional[str] = None,
                  backend: Optional[str] = None):
    """Compile-cache lookup (true LRU).  Returns ``(fn, is_new, fp,
    backend, via)``: ``fp`` is the fingerprint the ledger files the
    program under, ``backend`` the lowering ``core/autotune.py`` picks
    (or the caller's ``backend``, ``via`` ``"prewarm"``: autotune's race
    pre-warm) and ``via`` why.  A caller that already holds the
    program's :func:`_cache_key` and fingerprint passes them in.  A new
    mesh epoch (``set_mesh``, ``elastic.live_reshape``) empties the
    cache, as in the reference."""
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
    if backend is None:
        backend, via = _autotune.select(fp, program, leaf_vals)
    else:
        via = "prewarm"
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
        # the persistent cache's entry for this program loads its kernel
        # libraries (no nvcc) before the first launch would build them
        if _persist.aot_armed():
            _persist.lookup(fp, leaf_vals)
        _faults.check("compile", instrs=len(program.instrs))
        fn = _lower(program, leaf_vals, backend)
        _elastic.abandon_if_cancelled("the compile cache")
        if cacheable:
            _compile_cache[cache_key] = fn
        with _stats_lock:
            stats["compiles"] += 1
        _registry.inc("fuser.cache_miss")
        _ledger.record_cache(fp, "miss")
        if _persist.aot_armed():
            # a candidate for save_topk, and its skeleton saved for the
            # warm pool of another process
            _persist.note_compiled(fp, program, leaf_vals,
                                   compile_class=compile_class)
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
        origin=_origin(before) if is_new else None,
        tenant=current_tenant())
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
    if via == "racing" and backend == "kernel" and span is not None:
        from ramba_tpu_torch.core import autotune as _autotune

        if _autotune.maybe_prewarm(fp, program, leaf_vals):
            # the race pre-warm: the kernel's libraries are building on
            # the serve pipeline; this flush runs the generic lowering,
            # named in its span and counted
            fn, is_new, fp, backend, via = _get_compiled(
                program, leaf_vals, compile_class=compile_class, key=key,
                fp=fp, backend="torch")
            span["prewarm"] = fp
            _registry.inc("autotune.prewarm_served")
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
    (the reference's ``_FlushWork``).  A stream's flush adds its roots,
    their pins and, when the serve pipeline queued it, when it was
    enqueued, its deadline and its abandonment probe."""

    __slots__ = ("program", "leaves", "exprs", "leaf_vals", "donate_key",
                 "span", "label", "segmented", "class_plan", "key",
                 "fingerprint", "memo_plan", "memo_hit", "plan_cert",
                 "plan_cache", "routed", "stream", "roots", "root_exprs",
                 "pins", "detached", "enqueued_at", "deadline",
                 "is_abandoned", "mesh")

    def __init__(self, program, leaves, exprs, leaf_vals, span):
        self.program = program
        self.leaves = leaves
        self.exprs = exprs
        self.leaf_vals = leaf_vals
        self.donate_key = ()  # torch has no buffer donation
        self.span = span
        self.label = span["label"]
        cap = common.max_program_instrs
        self.segmented = bool(cap and program is not None
                              and len(program.instrs) > cap)
        self.class_plan = None
        self.key = None
        self.fingerprint = None
        self.memo_plan = None
        self.memo_hit = None
        self.plan_cert = None
        self.plan_cache = None
        self.routed = False
        self.stream = None
        self.roots = ()
        self.root_exprs = ()
        self.pins = ()
        self.detached = False
        self.enqueued_at = None
        self.deadline = None
        self.is_abandoned = None
        self.mesh = None


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


def _attempt_fused(work: _FlushWork, span: Optional[dict]) -> tuple:
    """The fused rung: the program through the compile cache (by
    segments when it is longer than ``common.max_program_instrs``),
    bucketed when it has a class plan: leaves padded to the bucket,
    outputs sliced back.  Only this rung buckets; the lower rungs run
    exact shapes."""
    program, leaf_vals = work.program, work.leaf_vals
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
        bytes_out=sum(_nbytes(o) for o in outs), tenant=current_tenant())
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


def _rung(work: _FlushWork, name: str, span: Optional[dict] = None):
    """The thunk that runs ``work``'s program on rung ``name``, stamping
    ``span`` (default: the flush's; a hedged attempt's private copy)."""
    program, leaf_vals = work.program, work.leaf_vals
    if span is None:
        span = work.span
    if name == "fused":
        fn = lambda: _attempt_fused(work, span)  # noqa: E731
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


def _deadline_checked(name: str, fn, wd: Optional[float], deadline,
                      label: str, tenant: Optional[str]):
    """:func:`_checked` under a request deadline: expiry is checked at the
    top of the attempt, and the watchdog is clamped to ``min(wd,
    remaining)`` when the attempt starts (the earlier rungs have spent
    part of the budget)."""
    from ramba_tpu_torch.serve import overload as _overload

    def guarded():
        _overload.check_expired(deadline, label, tenant=tenant)
        return _checked(name, fn, _overload.clamp_watchdog(wd, deadline))()

    return guarded


def _execute_resilient(work: _FlushWork, route_chunked: bool = False,
                       whole: bool = True, wd: Optional[float] = None,
                       span: Optional[dict] = None):
    """Run the flush down the degradation ladder
    (``resilience/degrade.py``): fused → split → chunked → eager → host
    (``whole``: :func:`_whole_job`; else no host rung and no round).
    Returns ``(outs, rung)``.  Each rung attempt runs under the elastic
    watchdog when ``wd`` (``RAMBA_WATCHDOG_S``, which :func:`_dispatch`
    reads once a flush) is set.  Under a request deadline
    (``serve/overload.py``) the rungs whose rolling p50 cannot fit the
    remaining budget are dropped, every attempt checks expiry first, and
    the watchdog is clamped to the remaining budget.  ``span``: the one
    the rungs stamp (a hedged attempt's private copy)."""
    names = rungs_for(len(work.program.instrs), work.routed, route_chunked,
                      whole)
    tenant = work.stream.tenant if work.stream is not None else None
    tags = {"tenant": tenant} if tenant is not None else None
    deadline = work.deadline
    if deadline is None:
        rungs = [(n, _checked(n, _rung(work, n, span), wd)) for n in names]
    else:
        from ramba_tpu_torch.serve import overload as _overload

        rungs = _overload.prune_rungs([(n, _rung(work, n, span))
                                       for n in names], deadline,
                                      work.label, tenant=tenant)
        rungs = [(n, _deadline_checked(n, fn, wd, deadline, work.label,
                                       tenant)) for n, fn in rungs]
    return _degrade.run_ladder("flush", rungs, tags=tags,
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
            stream = work.stream
            tenant = quota = None
            if stream is not None and stream is not _default_stream:
                tenant, quota = stream.tenant, stream.quota_bytes
            with _coherence.flush_scope(wd):
                t_admit = time.perf_counter()
                route = _memory.admit(program, leaf_vals, (), span,
                                      tenant=tenant, quota=quota,
                                      coherent=whole,
                                      fingerprint=work.fingerprint)
                _attrib.add_stage(span, "admit",
                                  time.perf_counter() - t_admit)
                hedge_s = None
                if os.environ.get("RAMBA_HEDGE_FACTOR") and not work.routed:
                    from ramba_tpu_torch.serve import overload as _overload

                    hedge_s = _overload.hedge_threshold(
                        work.label, program, (), leaf_vals)
                pre = sum(stages.get(k, 0.0) for k in _CALL_STAGES)
                t_ladder = time.perf_counter()
                if hedge_s is None:
                    outs, rung = _execute_resilient(work, route, whole, wd)
                else:
                    outs, rung = _overload.run_hedged(
                        lambda hspan: _execute_resilient(
                            work, route, whole, wd, span=hspan),
                        hedge_s, span=span, label=work.label,
                        tenant=tenant, leaf_vals=leaf_vals)
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
    _finish_span(span, outs, t_writeback, work.fingerprint,
                 e2e=work.enqueued_at is None)
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
    if work.enqueued_at is None:  # a queued ticket's e2e is the pipeline's
        _slo.observe_e2e(span["wall_s"], tenant=span.get("tenant"),
                         span=span)
    _elastic.note_progress("flush")


def _new_span(program: _Program, leaf_vals,
              t0: Optional[float] = None) -> dict:
    """A flush's span; ``t0`` is when the flush began (before its
    rewrites and linearization), else now.  Starts the profiler, the
    telemetry exporter and the fleet's snapshot spool where the
    environment asks for them."""
    _profile.ensure_started()
    _telemetry.ensure_started()
    _fleet.ensure_started()
    return {"type": "flush", "label": _program_label(program),
            "instrs": len(program.instrs),
            "leaf_bytes": sum(_nbytes(v) for v in leaf_vals),
            "t0": time.perf_counter() if t0 is None else t0, "calls": [],
            "stages": {}}


def _finish_span(span: dict, outs, t_writeback: float,
                 fp: Optional[str], e2e: bool = True) -> None:
    """The span's totals from its calls; its ``write_back`` stage (from
    ``t_writeback``, the ladder's return), its finalized waterfall; then
    the ``flush`` event, the slow-flush sentinel and the SLO histograms
    (the end-to-end one unless the serve pipeline observes it: ``e2e``
    False for a queued ticket)."""
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
    if e2e:
        _slo.observe_e2e(span["wall_s"], tenant=span.get("tenant"),
                         span=span)
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


def _quarantine(stream: Optional[FlushStream], roots,
                error: Optional[BaseException] = None,
                label: Optional[str] = None) -> None:
    """The roots of a program that raised leave the pending registry, or
    the one broken graph would re-enter, and re-fail, every later flush
    of their stream.  They keep their lazy graphs: a later read re-runs
    each one alone (``ndarray._value``), so an array that did not cause
    the error still gets its value and a broken one raises its own error
    again.  Per stream: another stream's pending work is untouched.
    Emits the reference's ``flush_error`` event (an incident: the trace's
    tail latch and the flight recorder key on it), with the tenant and
    the agreed epoch of the ladder's last round where there are any."""
    for arr in roots:
        unregister_pending(arr)
    n = len(roots)
    with _stats_lock:
        stats["quarantined"] += n
    if stream is not None:
        stream.stats["quarantined"] += n
    _registry.inc("resilience.flush_quarantined", n)
    ev = {"type": "flush_error", "label": label, "quarantined": n,
          "error": f"{type(error).__name__}: {error}"[:300]}
    if stream is not None and stream.tenant is not None:
        ev["tenant"] = stream.tenant
    epoch = _coherence.last_epoch("flush:rung")
    if epoch:
        ev["coherence_epoch"] = epoch
    _events.emit(ev)


def _release(work: _FlushWork) -> None:
    """Unpin the flush's leaves and run the end-of-flush hooks."""
    if work.pins:
        _memory.ledger.unpin(work.pins)
    work.pins = ()
    for hook in after_flush:
        hook()


def _flush_discard(work: _FlushWork) -> None:
    """Let go of prepared work that is not run (the overload plane shed
    it, a full queue refused it, its ticket was abandoned): no failure,
    so no quarantine and no ``flush_error``; the roots leave the pending
    set with their lazy graphs, and each array heals on its next read."""
    for arr in work.roots:
        unregister_pending(arr)  # nothing to do for detached work
    _release(work)
    work.leaf_vals = None


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


def _serving_fields(stream: FlushStream, span: dict) -> None:
    """A session stream's span: its stream, tenant and trace (the flush
    gets a span id of its own, chained to the session's root)."""
    span["stream"] = stream.name
    if stream.tenant is not None:
        span["tenant"] = stream.tenant
    if stream.trace_id is not None:
        span["trace_id"] = stream.trace_id
        span["span_id"] = _telemetry.mint_id()
        span["parent_span"] = stream.root_span


def _flush_prepare(stream: FlushStream, roots: list,
                   extra: Sequence[Expr] = (), *,
                   detached: bool = False) -> Optional[_FlushWork]:
    """Stage 1 of a stream's flush: rewrite + linearize, the leaves
    gathered and pinned, the span opened, :func:`_prepare`, the request
    deadline minted.  The serve pipeline runs this on the submitting
    thread.  None when there is nothing to run.  A failure here
    quarantines the roots and raises."""
    root_exprs = [a._expr for a in roots]
    exprs = root_exprs + list(extra)
    if not exprs:
        return None
    mesh = _mesh.get_mesh()
    if _mesh.is_rank_mesh(mesh):
        # on a mesh of ranks the whole flush runs in core/rankflush.py at
        # dispatch: the work carries its roots and its extra expressions
        # (``exprs``)
        span = {"type": "flush", "label": "rank_flush", "calls": [],
                "stages": {}}
        if stream is not _default_stream:
            _serving_fields(stream, span)
        work = _FlushWork(None, None, list(extra), None, span)
    else:
        work = _prepare_local(stream, roots, exprs)
    work.stream, work.roots, work.root_exprs = stream, roots, root_exprs
    work.mesh = mesh
    work.detached = detached
    if stream.deadline_ms is not None or os.environ.get("RAMBA_DEADLINE_MS"):
        from ramba_tpu_torch.serve import overload as _overload

        work.deadline = _overload.mint_deadline(stream.deadline_ms)
        if work.deadline is not None:
            work.span["deadline_ms"] = work.deadline.budget_ms
    return work


def _prepare_local(stream: FlushStream, roots: list, exprs: list):
    """:func:`_flush_prepare` in one process: the program, its pinned
    leaves, its span and :func:`_prepare`."""
    t_flush = time.perf_counter()
    program = None
    pins = ()
    try:
        program, leaves, exprs = _prepare_program(exprs)
        leaf_vals = [leaf_value(leaf) for leaf in leaves]
        # a flush's leaves are never spill candidates while it runs
        pins = _memory.ledger.pin_values(leaf_vals)
        span = _new_span(program, leaf_vals, t_flush)
        if stream is not _default_stream:
            _serving_fields(stream, span)
        work = _prepare(program, leaves, exprs, leaf_vals, span)
    except Exception as e:
        if pins:
            _memory.ledger.unpin(pins)
        for hook in after_flush:
            hook()
        _quarantine(stream, roots, e, _program_label(program)
                    if program is not None else None)
        raise
    work.pins = pins
    return work


def _flush_dispatch(work: _FlushWork, *, coalesced: int = 0) -> list:
    """Stage 2 of a stream's flush: the overload plane's verdict (queued
    or deadlined work), the memo looked up again for queued work (an
    earlier ticket of the same key may have filled it: batch CSE), the
    run (:func:`_dispatch`), then write-back into the roots (not when
    the ticket was abandoned meanwhile, nor into a root whose expression
    changed).  Returns the values of the extra expressions.  Runs on the
    calling thread or on the serve pipeline's worker."""
    span, stream = work.span, work.stream
    try:
        if work.enqueued_at is not None:
            queue_s = time.perf_counter() - work.enqueued_at
            span["queue_s"] = round(queue_s, 6)
            # the pipeline billed group pop -> this ticket as coalesce
            _attrib.add_stage(span, "queue_wait", queue_s - span[
                "stages"].get("coalesce", 0.0))
        if coalesced > 1:
            span["coalesced"] = coalesced
        if work.deadline is not None or work.enqueued_at is not None:
            from ramba_tpu_torch.serve import overload as _overload

            try:
                _overload.dispatch_verdict(
                    deadline=work.deadline, enqueued_at=work.enqueued_at,
                    tenant=stream.tenant, priority=stream.priority,
                    label=work.label)
            except _overload.OverloadError:
                _flush_discard(work)
                raise
            if work.memo_hit is None and work.memo_plan is not None \
                    and work.enqueued_at is not None:
                try:
                    work.memo_hit = _memo.lookup(work.memo_plan)
                except Exception:
                    work.memo_hit = None
        if work.program is None:  # a mesh of ranks: rankflush writes back
            from ramba_tpu_torch.core import rankflush

            n0 = stats["nodes_flushed"]
            got = rankflush.flush_roots(stream, work.roots, work.exprs,
                                        work.mesh)
            if stream is not _default_stream:
                stream.stats["flushes"] += 1
                stream.stats["nodes_flushed"] += stats["nodes_flushed"] - n0
            return got
        try:
            outs = _dispatch(work)
        except Exception as e:
            _quarantine(stream, work.roots, e, work.label)
            raise
    finally:
        if work.pins or work.leaf_vals is not None:
            _release(work)
        work.leaf_vals = None
    n = len(work.program.instrs)
    with _stats_lock:
        stats["flushes"] += 1
        stats["nodes_flushed"] += n
    _registry.inc("fuser.flushes")
    _registry.inc("fuser.nodes_flushed", n)
    if stream is not _default_stream:  # a session's bookkeeping only
        stream.stats["flushes"] += 1
        stream.stats["nodes_flushed"] += n
        if stream.tenant is not None:
            _registry.inc(f"serve.tenant.{stream.tenant}.flushes")
            _registry.inc(f"serve.tenant.{stream.tenant}.nodes", n)
    roots = work.roots
    if work.is_abandoned is not None and work.is_abandoned() \
            and not _coherence.engaged():
        # no one reads this ticket: its arrays keep their graphs and
        # heal on their next read
        _registry.inc("serve.abandoned_late")
    else:
        mesh = work.mesh
        for arr, expr, val in zip(roots, work.root_exprs, outs):
            if arr._expr is expr:  # a newer graph written meanwhile wins
                arr._set_expr(Const(val, sharding=_result_layout(expr,
                                                                 mesh)))
    return list(outs[len(roots):])


def _flush_roots(stream: FlushStream, roots: list,
                 extra: Sequence[Expr]) -> list:
    work = _flush_prepare(stream, roots, extra)
    if work is None:
        return []
    return _flush_dispatch(work)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def flush(extra: Sequence[Expr] = ()) -> list:
    """Materialize every pending array of the current stream (and
    ``extra`` expressions) in one program run.  Returns the values of
    ``extra`` in order."""
    return current_stream().flush(extra)


def flush_for(arr, extra: Sequence[Expr] = ()) -> list:
    """Flush the stream that owns ``arr``'s pending work, whichever stream
    is current and from any thread, after its queued tickets have run: a
    read chases the work to where it was built."""
    s = stream_of(arr)
    s.drain()
    return s.flush(extra)


def sync() -> None:
    """Flush every stream, wait for their queued tickets, and wait for
    the device to finish."""
    streams = all_streams()
    for s in streams:
        s.flush()
    for s in streams:
        s.drain()
    dev = common.device()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def realize(expr: Expr, stream: Optional[FlushStream] = None) -> Const:
    """One expression run alone into a leaf (on a mesh of ranks, this
    rank's block of it), flushed with ``stream``'s pending work (default:
    the current stream's)."""
    stream = stream if stream is not None else current_stream()
    mesh = _mesh.get_mesh()
    if _mesh.is_rank_mesh(mesh):
        from ramba_tpu_torch.core import rankflush

        holder = _Holder(expr)
        with stream._flush_lock:
            rankflush.flush_roots(stream, [holder], (), mesh)
        return holder._expr
    return Const(stream.flush(extra=[expr])[0])


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

    exprs = [a._expr for a in current_stream().pending_roots()]
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
