"""Structured event/span stream: in-memory ring, optional JSONL file.

Counterpart of ``ramba_tpu/observe/events.py``.  The fault harness, the
retry engine, the integrity plane and health records emit one event dict
here.  The ring buffer is ALWAYS on — a bounded deque append, cheap enough
for the hot path — while file output engages only when
``RAMBA_TRACE=<path>`` is set.  Under several processes each one writes
its own ``<path>.rank<i>`` file.

The file is line-buffered JSON-lines: one object per line, so a crashed run
still yields a parseable prefix.  Events carry ``ts`` (unix seconds),
``mono`` (monotonic seconds), ``seq`` (per-process monotone), and ``rank``
(with more than one process).

The file write happens OUTSIDE ``_emit_lock``: emit serializes the line
under the lock (seq order == file order) but only appends it to a bounded
pending buffer; a separate writer lock drains the buffer with a
non-blocking combining pattern, so a slow disk stalls at most the one
emitter that happens to be draining — never every emitter.  Overflow and
write failures are counted (``events.write_dropped`` /
``events.write_errors``), never raised.  ``sync()`` and ``close()`` drain
blocking; incident events drain blocking too.

**Tail-based retention** (``RAMBA_TRACE_SAMPLE=<N>``): the ring stays
full-fidelity, but the file lane head-samples 1-in-N *traces* — the
verdict is a deterministic hash of the ``trace_id`` (identical on every
rank).  Sampled-out events park in a bounded per-trace buffer; if the
chain later hits an incident (``TAIL_TRIGGERS``) the buffer is
retroactively flushed and the trace latched in.  A rotated buffer leaves a
``trace_gap`` marker.

Two injection points keep this module import-light: a **context
provider** (called under the emit lock, returns fields to setdefault onto
the event) and **taps** (callbacks invoked after the lock is released).

The process identity comes from ``torch.distributed``: its rank and world
size once a process group is initialised, else rank 0 of 1.
"""

from __future__ import annotations

import atexit
import collections
import hashlib
import json
import os
import threading
import time
from typing import Optional

from ramba_tpu_torch.observe import observer as _observer
from ramba_tpu_torch.observe import registry as _registry

# Serializes seq assignment, the ring append, and the pending-buffer
# append so events from concurrent serving streams land as whole lines
# with strictly increasing seq (deque.append alone is atomic, but seq
# would race and the JSONL file would tear).
_emit_lock = threading.Lock()

_RING_MAX = max(1, int(os.environ.get("RAMBA_TRACE_RING", "256") or 256))

# newest-last bounded history
ring: "collections.deque" = collections.deque(maxlen=_RING_MAX)

_trace_path: Optional[str] = os.environ.get("RAMBA_TRACE") or None
_trace_file = None
_seq = 0
_rank: Optional[tuple] = None

# injection points (see module docstring)
_context_provider = None
_taps: list = []


def _env_int(name: str, default: int, floor: int = 1) -> int:
    try:
        return max(floor, int(os.environ.get(name, str(default)) or default))
    except ValueError:
        return default


# -- buffered file writer (drained outside _emit_lock) ----------------------
_write_lock = threading.Lock()
_pending: list = []  # serialized lines awaiting the writer, emit-lock guarded
_PENDING_MAX = _env_int("RAMBA_TRACE_BUFFER", 2048)

# -- tail-based retention ----------------------------------------------------
# Incident types that latch a sampled-out trace into the file lane.
TAIL_TRIGGERS = ("slow_flush", "flush_error", "shed", "degrade", "stall",
                 "integrity", "slo_breach", "perf_regression")
_trace_sample = _env_int("RAMBA_TRACE_SAMPLE", 1)
_TAIL_SPANS = 64        # buffered events per sampled-out trace
_TAIL_TRACES_MAX = 256  # distinct sampled-out traces buffered at once
# trace_id -> [deque(lines, maxlen=_TAIL_SPANS), rotated_count]; LRU by
# insertion so a trace flood evicts the oldest chain wholesale
_tail_buffers: "collections.OrderedDict" = collections.OrderedDict()
_tail_latched: set = set()
_sample_memo: dict = {}  # trace_id -> head-sampling verdict (bounded)


def set_context_provider(fn) -> None:
    """Install the trace-context provider: ``fn() -> Optional[dict]`` of
    fields to setdefault onto every event.  One provider (last wins)."""
    global _context_provider
    _context_provider = fn


def add_tap(fn) -> None:
    """Register ``fn(event)`` to run after every emit, outside the emit
    lock.  Tap exceptions are swallowed — observers must never take the
    computation down."""
    if fn not in _taps:
        _taps.append(fn)


def remove_tap(fn) -> None:
    try:
        _taps.remove(fn)
    except ValueError:
        pass


def trace_enabled() -> bool:
    return _trace_path is not None


def configure(path: Optional[str], *,
              sample: Optional[int] = None,
              buffer_max: Optional[int] = None) -> None:
    """(Re)point the JSONL sink — primarily for tests; production use is
    the RAMBA_TRACE environment variable read at import.  Rereads
    ``RAMBA_TRACE_SAMPLE`` / ``RAMBA_TRACE_BUFFER`` (kwargs override)
    and resets the tail-retention state: a new sink starts with no
    latched traces and an empty per-trace buffer."""
    global _trace_path, _trace_sample, _PENDING_MAX
    close()  # drains pending lines to the OLD sink first
    _trace_path = path or None
    _trace_sample = (max(1, int(sample)) if sample is not None
                     else _env_int("RAMBA_TRACE_SAMPLE", 1))
    if buffer_max is not None:
        _PENDING_MAX = max(1, int(buffer_max))
    else:
        _PENDING_MAX = _env_int("RAMBA_TRACE_BUFFER", 2048)
    with _emit_lock:
        _tail_buffers.clear()
        _tail_latched.clear()
        _sample_memo.clear()


def trace_sample_every() -> int:
    """The configured 1-in-N head-sampling period for the file lane."""
    return _trace_sample


def trace_sampled_in(trace_id) -> bool:
    """Deterministic head-sampling verdict for one trace id: a hash of
    the id modulo N — identical on every rank, so a trace is sampled in
    (or out) fleet-wide.  Events without a trace id are always in."""
    if _trace_sample <= 1 or trace_id is None:
        return True
    v = _sample_memo.get(trace_id)
    if v is None:
        h = int.from_bytes(
            hashlib.sha256(str(trace_id).encode()).digest()[:4], "big")
        v = (h % _trace_sample == 0)
        if len(_sample_memo) >= 4096:
            _sample_memo.clear()
        _sample_memo[trace_id] = v
    return v


def _probe_rank():
    """``(rank, nprocs, authoritative)`` from ``torch.distributed``.
    Authoritative only once a process group is initialised (the topology
    can no longer change); before that, single-process semantics without
    caching, so an emit before ``init_process_group`` cannot freeze the
    wrong identity onto later events."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank(), dist.get_world_size(), True
    except Exception:
        pass
    return 0, 1, False


def _rank_info():
    """(rank, nprocs) — cached only once authoritative (see _probe_rank),
    so an emit that happens BEFORE distributed bring-up cannot freeze the
    wrong identity onto every later event of a multi-controller run."""
    global _rank
    if _rank is None:
        r, n, authoritative = _probe_rank()
        if not authoritative:
            return (r, n)
        _rank = (r, n)
    return _rank


def rank_info() -> tuple:
    """Public ``(rank, nprocs)``, with the emit path's caching discipline
    (see :func:`_rank_info`)."""
    return _rank_info()


def invalidate_rank() -> None:
    """Drop the cached (rank, nprocs) AND any trace sink opened under the
    stale identity, so the next emit re-probes and reopens the JSONL file
    under the correct ``.rank<i>`` name (call it when a process group
    forms)."""
    global _rank
    _rank = None
    close()


def _file():
    global _trace_file
    if _trace_file is None and _trace_path is not None:
        rank, nprocs = _rank_info()
        path = _trace_path if nprocs <= 1 else f"{_trace_path}.rank{rank}"
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        _trace_file = open(path, "a", buffering=1)  # line-buffered
    return _trace_file


def _append_pending_locked(line: str) -> None:
    """Queue one serialized line for the writer (emit lock held).  A
    full buffer drops the line and counts it — never blocks, never
    raises (the writer being slow must not become backpressure on the
    computation)."""
    if len(_pending) >= _PENDING_MAX:
        _registry.inc("events.write_dropped")
        return
    _pending.append(line)


def _enqueue_locked(event: dict, line: str) -> bool:
    """Route one serialized event into the file lane (emit lock held):
    straight to the pending buffer, or into the trace's tail buffer
    when its trace is head-sampled out.  Returns True when the event is
    an incident (the caller drains blocking so the latched chain — and
    the incident itself — are on disk before taps run)."""
    incident = event.get("type") in TAIL_TRIGGERS
    tid = event.get("trace_id")
    if _trace_sample > 1 and tid is not None and tid not in _tail_latched:
        if incident:
            # tail latch: this boring trace just became evidence —
            # replay its buffered chain ahead of the incident line and
            # keep every later event of the trace
            _tail_latched.add(tid)
            if len(_tail_latched) > 8192:  # leak bound; re-latch on demand
                _tail_latched.clear()
                _tail_latched.add(tid)
            ent = _tail_buffers.pop(tid, None)
            if ent is not None:
                buf, rotated = ent
                if rotated:
                    gap = {"type": "trace_gap", "trace_id": tid,
                           "dropped": rotated,
                           "reason": "tail_buffer_rotation"}
                    _append_pending_locked(
                        json.dumps(gap, default=str) + "\n")
                for buffered in buf:
                    _append_pending_locked(buffered)
            _registry.inc("events.tail_latched")
        elif not trace_sampled_in(tid):
            ent = _tail_buffers.get(tid)
            if ent is None:
                if len(_tail_buffers) >= _TAIL_TRACES_MAX:
                    _tail_buffers.popitem(last=False)
                ent = _tail_buffers[tid] = [
                    collections.deque(maxlen=_TAIL_SPANS), 0]
            buf = ent[0]
            if len(buf) == buf.maxlen:
                ent[1] += 1
            buf.append(line)
            _registry.inc("events.tail_buffered")
            return incident
    _append_pending_locked(line)
    return incident


def emit(event: dict) -> dict:
    """Stamp and record one event.  Mutates ``event`` in place (adds
    ts/seq/rank) and returns it.  Never raises out of the sink: a full
    disk must not take the computation down with it."""
    global _seq
    t_obs = time.perf_counter()
    incident = False
    with _emit_lock:
        _seq += 1
        event.setdefault("ts", round(time.time(), 6))
        event.setdefault("mono", round(time.monotonic(), 6))
        if _context_provider is not None:
            try:
                fields = _context_provider()
            except Exception:
                fields = None
            if fields:
                for k, v in fields.items():
                    event.setdefault(k, v)
        event["seq"] = _seq
        rank, nprocs = _rank_info() if _trace_path is not None else (None, 1)
        if nprocs > 1:
            event["rank"] = rank
        if len(ring) == ring.maxlen:
            _registry.inc("events.ring_dropped")
        ring.append(event)
        if _trace_path is not None:
            try:
                incident = _enqueue_locked(
                    event, json.dumps(event, default=str) + "\n")
            except Exception:
                _registry.inc("events.write_errors")
    if _trace_path is not None:
        _drain(block=incident)
    _observer.add("events", time.perf_counter() - t_obs)
    for fn in list(_taps):
        try:
            fn(event)
        except Exception:
            pass
    return event


def _drain(block: bool = False) -> None:
    """Write pending lines to the sink.  Non-blocking by default — if
    another emitter holds the writer lock our lines ride its drain loop
    (combining), so a slow disk stalls one thread, not all of them.
    Failures are counted, never raised."""
    if not _pending:
        return
    if not _write_lock.acquire(blocking=block):
        return
    try:
        while True:
            with _emit_lock:
                if not _pending:
                    break
                batch = _pending[:]
                del _pending[:]
            try:
                f = _file()
            except OSError:
                f = None
            if f is None:
                _registry.inc("events.write_dropped", len(batch))
                continue
            try:
                f.write("".join(batch))
            except (OSError, ValueError):
                _registry.inc("events.write_errors")
    finally:
        _write_lock.release()


def sync() -> None:
    """Block until every pending line is on disk."""
    _drain(block=True)


def snapshot_ring() -> list:
    """One consistent copy of the ring, taken under the emit lock so a
    reader never interleaves with a concurrent append."""
    with _emit_lock:
        return list(ring)


def last(n: int = 10, type=None) -> list:
    """Newest-last slice of the ring, optionally filtered by event type
    (a single type string or a tuple/list of them)."""
    evs = list(ring)
    if type is not None:
        types = (type,) if isinstance(type, str) else tuple(type)
        evs = [e for e in evs if e.get("type") in types]
    return evs[-n:] if n else evs


def close() -> None:
    global _trace_file
    try:
        _drain(block=True)  # pending lines belong to the sink being closed
    except Exception:
        pass
    with _write_lock:
        if _trace_file is not None:
            try:
                _trace_file.close()
            except OSError:
                pass
            _trace_file = None


atexit.register(close)
