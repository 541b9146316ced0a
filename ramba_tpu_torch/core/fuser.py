"""Flush machinery: lazy expression graphs -> one program per flush.

Counterpart of ``ramba_tpu/core/fuser.py`` without its resilience ladder,
memo, plan-cache, attribution, serving and integrity planes.  A flush
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

On a mesh of ranks (several processes) a flush runs through
``core/rankflush.py``: on each rank's blocks, or on gathered operands,
decided before it runs; its programs run through :func:`run_program`.
"""

from __future__ import annotations

import hashlib
import itertools
import threading
import time
import weakref
from typing import Optional, Sequence

import torch

from ramba_tpu_torch import _build, common
from ramba_tpu_torch.compile import classes as _classes
from ramba_tpu_torch.core.expr import OPS, Const, Expr, Node, Scalar
from ramba_tpu_torch.observe import events as _events
from ramba_tpu_torch.observe import ledger as _ledger
from ramba_tpu_torch.observe import registry as _registry
from ramba_tpu_torch.parallel import mesh as _mesh
from ramba_tpu_torch.resilience import faults as _faults
from ramba_tpu_torch.resilience import memory as _memory
from ramba_tpu_torch.resilience.spill import SpilledArray

# Monotone counters (observability; same keys as the JAX package's).
# ``segments``: segment runs of programs longer than max_program_instrs.
# ``quarantined``: roots of failed flushes taken out of the pending registry.
# ``gathered``: flushes on a mesh of ranks that all-gathered their block
# leaves to run whole (``core/rankflush.py``).
stats = {"flushes": 0, "compiles": 0, "nodes_flushed": 0, "segments": 0,
         "quarantined": 0, "gathered": 0}

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
    admits at least one instruction.  (ROADMAP A.8's ``chunked`` rung
    reads it; nothing in this port calls it yet.)"""
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
                   seg_size: Optional[int] = None) -> tuple:
    """Run a program longer than ``common.max_program_instrs`` as a chain
    of segments inside one flush.  Each segment goes through the compile
    cache with its own leaf values (a chain of one repeated structure
    compiles one segment), so a segment the classifier accepts launches
    elemred; a value crossing a boundary is a segment output carried to
    the next, and every value is dropped after its last use."""
    last_use = _last_use_map(program)
    vals: dict[int, object] = dict(enumerate(leaf_vals))
    for seg_prog, in_slots, out_here, top in _iter_segments(
            program, last_use, seg_size):
        seg_vals = [vals[s] for s in in_slots]
        outs = _execute(seg_prog, seg_vals, span)
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
    :func:`_cache_key` and fingerprint passes them in."""
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


def _execute_compiled(fn, program: _Program, leaf_vals, is_new: bool,
                      span: Optional[dict], fp: str, backend: str, via: str,
                      rung: str = "fused", label: Optional[str] = None,
                      bytes_in: Optional[int] = None) -> tuple:
    """Run one compiled program with the ledger's bookkeeping.  A first
    call counts as a compile by origin, never as a sample.  A racing
    call, and every call under ``RAMBA_PERF=sync``, is also timed on the
    device: CUDA events around the call on the card, the wall on the
    CPU.  ``label`` and ``bytes_in`` are the flush's when the caller has
    them."""
    _faults.check("execute", instrs=len(program.instrs))
    before = _build.counts() if is_new else None
    racing = via == "racing"
    timed = racing or _ledger.sync_timing()
    device_s = None
    t0 = time.perf_counter()
    dev = _device_of(leaf_vals) if timed else None
    if dev is not None and dev.type == "cuda":
        with torch.cuda.device(dev):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            outs = fn(*leaf_vals)
            e1.record()
            e1.synchronize()
        dt = time.perf_counter() - t0
        device_s = e0.elapsed_time(e1) / 1e3
    else:
        outs = fn(*leaf_vals)
        dt = time.perf_counter() - t0
        if timed:
            device_s = dt
    if label is None:
        label = _program_label(program)
    if bytes_in is None:
        bytes_in = sum(_nbytes(v) for v in leaf_vals)
    bytes_out = sum(_nbytes(o) for o in outs)
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
        _ledger.capture_cost(fp, bytes_in + bytes_out, backend=backend)
    if span is not None:
        span["calls"].append({"label": label,
                              "cache": "miss" if is_new else "hit",
                              "seconds": round(dt, 6), "backend": backend})
    return outs


def _execute(program: _Program, leaf_vals, span: Optional[dict] = None,
             compile_class=None, key: Optional[tuple] = None,
             fp: Optional[str] = None, label: Optional[str] = None,
             bytes_in: Optional[int] = None) -> tuple:
    fn, is_new, fp, backend, via = _get_compiled(
        program, leaf_vals, compile_class=compile_class, key=key, fp=fp)
    return _execute_compiled(fn, program, leaf_vals, is_new, span, fp,
                             backend, via, label=label, bytes_in=bytes_in)


def _program_event(program: _Program, label: str, fp: str,
                   compile_class) -> None:
    _events.emit({"type": "program", "label": label, "fingerprint": fp,
                  "instrs": len(program.instrs),
                  "n_leaves": program.n_leaves,
                  "compile_class": (list(compile_class)
                                    if compile_class is not None else None)})


def _kernel_takes(program: _Program, leaf_vals) -> bool:
    """True when the kernels take this program.  Such a program is never
    bucketed: a new extent costs the kernel a plan over a library already
    loaded (its source does not depend on the extent), less than the pad
    copy a bucket adds to every flush (``chip_smoke.py``'s shape soak on
    the card)."""
    from ramba_tpu_torch.ops import kernel_backend

    return kernel_backend.supports(program, leaf_vals)


def _run_program(program: _Program, leaf_vals, span: dict) -> tuple:
    """One fused program: segmented when it is too long, else bucketed
    when ``RAMBA_COMPILE_CLASSES`` plans a class for it and the kernels do
    not take it, and run."""
    if (common.max_program_instrs
            and len(program.instrs) > common.max_program_instrs):
        if _events.trace_enabled():
            _program_event(program, span["label"], _ledger.fingerprint(
                _cache_key(program, leaf_vals)), None)
        return _run_segmented(program, leaf_vals, span)
    plan = None
    if _classes.enabled() and not _kernel_takes(program, leaf_vals):
        try:
            plan = _classes.plan_for(program, leaf_vals)
        except Exception:
            plan = None
    try:
        _faults.check("compile:bucket", label=span["label"])
    except _faults.InjectedFault:
        forged = _classes.forced_plan(program, leaf_vals)
        if forged is not None:
            plan = forged
    token = plan.token if plan is not None else None
    run_vals = _classes.apply(plan, leaf_vals) if plan is not None \
        else leaf_vals
    key = _cache_key(program, run_vals, token)
    fp = _ledger.fingerprint(key)
    if _classes.enabled():
        _classes.note_decision(fp, plan)
    if plan is not None:
        span["compile_class"] = list(token)
        span["pad_waste_bytes"] = plan.pad_waste_bytes
        _ledger.record_class(fp, token, plan.pad_waste_bytes,
                             label=span["label"])
    span["fingerprint"] = fp
    if _events.trace_enabled():
        _program_event(program, span["label"], fp, token)
    outs = _execute(program, run_vals, span, compile_class=token, key=key,
                    fp=fp, label=span["label"],
                    bytes_in=span["leaf_bytes"] if plan is None else None)
    del run_vals
    return _classes.strip(plan, outs) if plan is not None else outs


def _new_span(program: _Program, leaf_vals) -> dict:
    return {"type": "flush", "label": _program_label(program),
            "instrs": len(program.instrs),
            "leaf_bytes": sum(_nbytes(v) for v in leaf_vals),
            "t0": time.perf_counter(), "calls": []}


def _finish_span(span: dict, outs) -> None:
    """The span's totals from its calls, emitted as a ``flush`` event and
    fed to the slow-flush sentinel."""
    calls = span["calls"]
    span["segments"] = len(calls) - 1 if len(calls) > 1 else 0
    span["compile_s"] = round(
        sum(c["seconds"] for c in calls if c["cache"] == "miss"), 6)
    span["execute_s"] = round(
        sum(c["seconds"] for c in calls if c["cache"] == "hit"), 6)
    span["cache"] = "miss" if any(c["cache"] == "miss" for c in calls) \
        else "hit"
    span["out_bytes"] = sum(_nbytes(v) for v in outs)
    span["wall_s"] = round(time.perf_counter() - span.pop("t0"), 6)
    _events.emit(span)
    _ledger.observe_flush(span)


def run_program(program: _Program, leaf_vals) -> tuple:
    """Run one linearized program as a flush runs it (segments, compile
    classes, the ledger, a span); ``core/rankflush.py`` runs every rank's
    programs through here."""
    span = _new_span(program, leaf_vals)
    outs = _run_program(program, leaf_vals, span)
    _finish_span(span, outs)
    return outs


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
    try:
        if common.rewrite_enabled:
            from ramba_tpu_torch.core.rewrite import rewrite_roots

            exprs = rewrite_roots(exprs)
        program, leaf_vals = prepare_program(exprs)
        # a flush's leaves are never spill candidates while it runs
        pins = _memory.ledger.pin_values(leaf_vals)
        try:
            span = _new_span(program, leaf_vals)
            outs = _run_program(program, leaf_vals, span)
            _finish_span(span, outs)
        finally:
            _memory.ledger.unpin(pins)
            for hook in after_flush:
                hook()
    except Exception:
        _quarantine(stream, roots)
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
