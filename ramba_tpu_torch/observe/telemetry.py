"""Live telemetry plane: trace context, metrics exporter, flight recorder.

Counterpart of ``ramba_tpu/observe/telemetry.py``.  Three layers, each
cheap when off:

**Causal trace context.**  :func:`span_scope` installs a
``(trace_id, span_id)`` pair in a contextvar; while a scope is active,
every event emitted on that thread (or on a helper thread that copied the
context, as ``resilience/elastic.py``'s watchdog does) is stamped with
``trace_id``/``parent_span`` by the provider this module installs in
``observe/events.py``.  The fuser re-scopes each flush dispatch to the
flush's own span id, so rungs, stalls and admissions chain back to it.
Ids are minted by :func:`mint_id`; serve sessions, which mint them per
request in the reference, come with ROADMAP A.10.

**Metrics exporter.**  :func:`render` serializes the counter registry,
the kernel cost ledger, the memory governor, the SLO histograms
(``observe/slo.py``), autotune, the compile pipeline, the attribution
plane (stage seconds, rooflines, regressions), the observer tax and the
elastic plane's liveness into Prometheus text format, every sample
labelled with ``rank``.  The serve series of the reference (tenants'
sessions, overload) come with serving (ROADMAP A.10).
``RAMBA_METRICS_PORT`` starts an HTTP listener on a daemon thread
(``/metrics``, and ``/healthz`` with :func:`health`'s JSON; port ``0``
binds an ephemeral port, see :func:`port`; ``RAMBA_METRICS_HOST`` the
address, default every interface), ``RAMBA_METRICS_FILE`` rewrites a
text file atomically (tmp + ``os.replace``) every
``RAMBA_METRICS_INTERVAL_S`` seconds (default 5).  Both can run at once.

**Incident flight recorder.**  With ``RAMBA_FLIGHT_DIR`` set, a tap on
the event stream dumps, once per incident event (after the flush it was
emitted in, :func:`deferred_flight`) (``slow_flush``,
``perf_regression``, ``slo_breach``, ``flush_error``, ``stall``,
``integrity``, and an out-of-memory eviction), the event ring plus
``diagnostics.snapshot()`` to one JSON file named by the event's
``seq``.  ``RAMBA_FLIGHT_MAX`` (default 50) caps this process's files on
disk (oldest evicted first).
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
import time
import uuid
from typing import Optional

from ramba_tpu_torch.observe import events as _events
from ramba_tpu_torch.observe import ledger as _ledger
from ramba_tpu_torch.observe import observer as _observer
from ramba_tpu_torch.observe import registry as _registry
from ramba_tpu_torch.observe import slo as _slo

# ---------------------------------------------------------------------------
# causal trace context
# ---------------------------------------------------------------------------

# (trace_id, span_id) of the innermost active scope; None outside any
# scope.  contextvars propagate into elastic.with_deadline's helper
# thread (it copies the context); the fuser opens a span_scope around each
# dispatch.
_trace_ctx: "contextvars.ContextVar[Optional[tuple]]" = contextvars.ContextVar(
    "ramba_trace_ctx", default=None)


def mint_id() -> str:
    """A fresh 16-hex-char id (trace or span).  Random, not sequential:
    ids must not collide across ranks or sessions."""
    return uuid.uuid4().hex[:16]


@contextlib.contextmanager
def span_scope(trace_id: Optional[str], span_id: Optional[str]):
    """Make (trace_id, span_id) the ambient trace context for the
    duration.  No-op scope when trace_id is None, so call sites don't
    need their own 'is tracing on' branch."""
    if trace_id is None:
        yield
        return
    token = _trace_ctx.set((trace_id, span_id))
    try:
        yield
    finally:
        _trace_ctx.reset(token)


def current_context() -> Optional[tuple]:
    """(trace_id, span_id) of the innermost scope, or None."""
    return _trace_ctx.get()


def _context_fields() -> Optional[dict]:
    """The provider observe/events.py calls on every emit: fields to
    setdefault onto the event.  The active span becomes the event's
    *parent* — the event is a child observation of that span."""
    ctx = _trace_ctx.get()
    if ctx is None:
        return None
    return {"trace_id": ctx[0], "parent_span": ctx[1]}


_events.set_context_provider(_context_fields)

# ---------------------------------------------------------------------------
# incident flight recorder
# ---------------------------------------------------------------------------

#: Event types that constitute an incident (each occurrence = one dump);
#: an oom-class eviction (``memory`` / ``oom_evict``) is one too.
FLIGHT_TRIGGERS = ("slow_flush", "stall", "slo_breach", "flush_error",
                   "perf_regression", "integrity")

_flight_lock = threading.Lock()
_flight_dumps = 0
_flight_tls = threading.local()  # reentrancy guard (dump may emit)


def _flight_dir() -> Optional[str]:
    return os.environ.get("RAMBA_FLIGHT_DIR") or None


def _flight_max() -> int:
    try:
        return max(1, int(os.environ.get("RAMBA_FLIGHT_MAX", "50") or 50))
    except ValueError:
        return 50


def is_incident(event: dict) -> bool:
    t = event.get("type")
    if t in FLIGHT_TRIGGERS:
        return True
    return t == "memory" and event.get("action") == "oom_evict"


# incidents waiting for the end of the flush they were emitted in (see
# deferred_flight); a contextvar, so a watchdog's helper thread that
# copied the flush's context queues into the same list
_deferred: "contextvars.ContextVar[Optional[list]]" = contextvars.ContextVar(
    "ramba_flight_deferred", default=None)


@contextlib.contextmanager
def deferred_flight():
    """Incidents emitted inside the block are dumped when it ends, not
    where they fire.  The fuser runs each flush's dispatch inside one, so
    a dump (the ring and a diagnostics snapshot) never
    lands in the wall of the flush that raised it, where the slow-flush
    sentinel would read it as an incident of its own.  The reference
    dumps in place.  Nested blocks share the outermost one's queue."""
    if _deferred.get() is not None:
        yield
        return
    queue: list = []
    token = _deferred.set(queue)
    try:
        yield
    finally:
        _deferred.reset(token)
        for event in queue:
            _flight_tap(event)


def _flight_tap(event: dict) -> None:
    """events.py tap (called outside the emit lock).  One dump per
    triggering event; never raises into the emitter."""
    if _flight_dir() is None or not is_incident(event):
        return
    queue = _deferred.get()
    if queue is not None:
        queue.append(event)
        return
    if getattr(_flight_tls, "busy", False):
        return  # an event emitted while dumping is part of THIS incident
    _flight_tls.busy = True
    try:
        dump_flight(event)
    except Exception:
        pass  # the recorder must never take the computation down
    finally:
        _flight_tls.busy = False


def _own_flight_dumps(directory: str) -> list:
    """THIS process's dump files in ``directory``, oldest first (names
    sort in incident-seq order).  Multi-rank processes write ``.rank<i>``
    suffixed names, so each rank GCs only its own files — a fleet of
    replicas pointed at per-replica flight dirs (the recommended layout)
    or SPMD ranks sharing one dir never evict each other's incidents."""
    import glob as _glob

    rank, nprocs = _events._rank_info()
    if nprocs > 1:
        pattern = os.path.join(directory, f"flight_*.rank{rank}.json")
        return sorted(_glob.glob(pattern))
    return sorted(p for p in _glob.glob(
        os.path.join(directory, "flight_*.json")) if ".rank" not in p)


def _gc_flight(directory: str) -> None:
    """Oldest-first disk retention: keep at most ``RAMBA_FLIGHT_MAX``
    of this process's dumps.  A long fleet soak keeps dumping fresh
    incidents forever; the cap bounds DISK, not incident count."""
    keep = _flight_max()
    own = _own_flight_dumps(directory)
    for path in own[:max(0, len(own) - keep)]:
        try:
            os.remove(path)
            _registry.inc("telemetry.flight_gc")
        except OSError:
            pass  # concurrent GC / manual cleanup


def dump_flight(incident: dict, directory: Optional[str] = None) -> Optional[str]:
    """Write one flight record (incident + identity + ring + diagnostics
    snapshot), evict this process's oldest dumps past ``RAMBA_FLIGHT_MAX``,
    and return the new path (None when disabled)."""
    d = directory or _flight_dir()
    if d is None:
        return None
    global _flight_dumps
    t_obs = time.perf_counter()
    with _flight_lock:
        _flight_dumps += 1
        n = _flight_dumps
    from ramba_tpu_torch import diagnostics as _diagnostics

    rank, nprocs = _events._rank_info()
    seq = incident.get("seq", 0)
    name = f"flight_{seq:06d}_{incident.get('type', 'event')}"
    if nprocs > 1:
        name += f".rank{rank}"
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, name + ".json")
    record = {
        "incident": incident,
        "dump_n": n,
        "rank": rank,
        "identity": _diagnostics.identity(),
        "events": _events.snapshot_ring(),
        "diagnostics": _diagnostics.snapshot(),
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(record, f, default=str)
    os.replace(tmp, path)  # readers never see a torn dump
    _registry.inc("telemetry.flight_dumps")
    with _flight_lock:
        _gc_flight(d)
    _observer.add("flight", time.perf_counter() - t_obs)
    return path


_events.add_tap(_flight_tap)


def flight_reset() -> None:
    """Re-arm the dump budget (tests)."""
    global _flight_dumps
    with _flight_lock:
        _flight_dumps = 0

# ---------------------------------------------------------------------------
# Prometheus text rendering
# ---------------------------------------------------------------------------


def _sanitize(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    s = "".join(out)
    if s and s[0].isdigit():
        s = "_" + s
    return s


def _fmt(v) -> str:
    if v is None:
        return "0"
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _esc(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class _Family:
    """One metric family: TYPE line + samples, rendered together so the
    exposition groups series the way Prometheus parsers require."""

    __slots__ = ("name", "typ", "samples")

    def __init__(self, name: str, typ: str):
        self.name = name
        self.typ = typ
        self.samples = []  # (suffix, label dict, value)

    def add(self, labels: dict, value, suffix: str = "") -> None:
        self.samples.append((suffix, labels, value))


class _Families:
    def __init__(self, base_labels: dict):
        self.base = base_labels
        self._fams: "dict[str, _Family]" = {}

    def fam(self, name: str, typ: str) -> _Family:
        f = self._fams.get(name)
        if f is None:
            f = self._fams[name] = _Family(name, typ)
        return f

    def add(self, name: str, typ: str, value, labels: Optional[dict] = None,
            suffix: str = "") -> None:
        self.fam(name, typ).add(labels or {}, value, suffix)

    def render(self) -> str:
        lines = []
        for name in sorted(self._fams):
            f = self._fams[name]
            lines.append(f"# TYPE {f.name} {f.typ}")
            for suffix, labels, value in f.samples:
                lab = dict(self.base)
                lab.update(labels)
                body = ",".join(f'{k}="{_esc(v)}"'
                                for k, v in sorted(lab.items()))
                labels_part = f"{{{body}}}" if body else ""
                lines.append(f"{f.name}{suffix}{labels_part} {_fmt(value)}")
        return "\n".join(lines) + "\n"


def _counter_series(fams: _Families, snap: dict, gauge_names) -> None:
    for name, val in snap.get("counters", {}).items():
        tenant = None
        metric_name = name
        parts = name.split(".")
        # serve.tenant.<t>.<metric...> -> tenant label, shared family
        if len(parts) >= 4 and parts[0] == "serve" and parts[1] == "tenant":
            tenant = parts[2]
            metric_name = "serve.tenant." + ".".join(parts[3:])
        typ = "gauge" if name in gauge_names else "counter"
        fam = "ramba_" + _sanitize(metric_name)
        if typ == "counter" and not fam.endswith("_total"):
            fam += "_total"
        labels = {"tenant": tenant} if tenant is not None else {}
        fams.add(fam, typ, val, labels)
    for name, (total_s, count) in snap.get("timers", {}).items():
        base = "ramba_timer_" + _sanitize(name)
        fams.add(base + "_seconds_total", "counter", total_s)
        fams.add(base + "_count", "counter", count)


def _ledger_series(fams: _Families) -> None:
    snap = _ledger.snapshot()
    fams.add("ramba_slow_flushes_total", "counter", snap.get("slow_flushes", 0))
    for fp, e in snap.get("kernels", {}).items():
        lab = {"fingerprint": fp, "label": e.get("label", "?")}
        ex = e.get("exec", {})
        fams.add("ramba_kernel_exec_total", "counter", ex.get("count", 0), lab)
        fams.add("ramba_kernel_exec_seconds_total", "counter",
                 ex.get("total_s", 0) or 0, lab)
        fams.add("ramba_kernel_compile_seconds_total", "counter",
                 e.get("compile_s", 0), lab)
        cache = e.get("cache", {})
        fams.add("ramba_kernel_cache_hits_total", "counter",
                 cache.get("hits", 0), lab)
        fams.add("ramba_kernel_cache_misses_total", "counter",
                 cache.get("misses", 0), lab)
        for backend, b in e.get("backends", {}).items():
            blab = {**lab, "backend": backend}
            bex = b.get("exec", {})
            fams.add("ramba_kernel_backend_exec_total", "counter",
                     bex.get("count", 0), blab)
            fams.add("ramba_kernel_backend_exec_seconds_total", "counter",
                     bex.get("total_s", 0) or 0, blab)
            p50 = bex.get("p50_s")
            if p50 is not None:
                fams.add("ramba_kernel_backend_exec_p50_seconds", "gauge",
                         p50, blab)
            fams.add("ramba_kernel_backend_compile_seconds_total", "counter",
                     b.get("compile_s", 0), blab)
            fams.add("ramba_kernel_backend_fallbacks_total", "counter",
                     b.get("fallbacks", 0), blab)


def _memory_series(fams: _Families) -> None:
    from ramba_tpu_torch.resilience import memory as _memory

    snap = _memory.ledger.snapshot(top=0)
    for key, fam in (("live_bytes", "ramba_memory_live_bytes"),
                     ("spilled_bytes", "ramba_memory_spilled_bytes"),
                     ("pinned_bytes", "ramba_memory_pinned_bytes"),
                     ("peak_live_bytes", "ramba_memory_peak_live_bytes"),
                     ("budget_bytes", "ramba_memory_budget_bytes")):
        v = snap.get(key)
        if v is not None:
            fams.add(fam, "gauge", v)
    fams.add("ramba_memory_evictions_total", "counter",
             snap.get("evictions", 0))
    fams.add("ramba_memory_restores_total", "counter",
             snap.get("restores", 0))
    for t, b in snap.get("tenant_live_bytes", {}).items():
        fams.add("ramba_memory_tenant_live_bytes", "gauge", b, {"tenant": t})


def _slo_series(fams: _Families) -> None:
    snap = _slo.snapshot()
    for metric, per_tenant in snap.get("histograms", {}).items():
        fam = f"ramba_flush_{_sanitize(metric)}_seconds"
        f = fams.fam(fam, "histogram")
        for tenant, summ in per_tenant.items():
            lab = {"tenant": tenant}
            for ub, cum in summ.get("buckets", []):
                f.add({**lab, "le": _fmt(ub)}, cum, "_bucket")
            f.add({**lab, "le": "+Inf"}, summ.get("count", 0), "_bucket")
            f.add(lab, summ.get("sum_s", 0.0), "_sum")
            f.add(lab, summ.get("count", 0), "_count")
    obj = snap.get("objective_p95_ms")
    if obj is not None:
        fams.add("ramba_slo_objective_p95_ms", "gauge", obj)
    for t in snap.get("breached", []):
        fams.add("ramba_slo_breached", "gauge", 1, {"tenant": t})


def _autotune_series(fams: _Families) -> None:
    from ramba_tpu_torch.core import autotune as _autotune

    rep = _autotune.report()
    if rep.get("mode") == "off" and not rep.get("decisions"):
        return  # feature unused: keep the exposition quiet
    fams.add("ramba_autotune_decisions", "gauge",
             len(rep.get("decisions", {})))
    fams.add("ramba_autotune_races_latched_total", "counter",
             rep.get("races_latched", 0))
    fams.add("ramba_autotune_race_overhead_seconds_total", "counter",
             rep.get("race_overhead_s", 0.0))
    per_backend: dict = {}
    for d in rep.get("decisions", {}).values():
        per_backend[d.get("backend")] = per_backend.get(d.get("backend"), 0) + 1
    for backend, n in sorted(per_backend.items()):
        fams.add("ramba_autotune_backend_decisions", "gauge", n,
                 {"backend": backend})


def _compile_series(fams: _Families) -> None:
    from ramba_tpu_torch.compile import classes as _classes
    from ramba_tpu_torch.compile import persist as _persist

    csnap = _classes.snapshot()
    psnap = _persist.snapshot()
    # jit-cache hit rate is meaningful with or without compile classes —
    # exported ahead of the quiet-when-unused cut below
    hits = _registry.get("fuser.cache_hit")
    misses = _registry.get("fuser.cache_miss")
    if hits + misses:
        fams.add("ramba_compile_hit_rate", "gauge",
                 round(hits / (hits + misses), 4))
    if (csnap.get("mode") == "off" and not csnap.get("planned")
            and not csnap.get("bailouts") and not psnap.get("armed")
            and not psnap.get("hits") and not psnap.get("misses")):
        return  # feature unused: keep the exposition quiet
    fams.add("ramba_compile_call_fallbacks_total", "counter",
             psnap.get("call_fallbacks", 0))
    fams.add("ramba_compile_bucket_pad_waste_bytes", "gauge",
             csnap.get("pad_bytes", 0))
    fams.add("ramba_compile_class_planned_total", "counter",
             csnap.get("planned", 0))
    fams.add("ramba_compile_class_padded_total", "counter",
             csnap.get("padded", 0))
    fams.add("ramba_compile_bucket_bailout_total", "counter",
             csnap.get("bailouts", 0))
    fams.add("ramba_compile_class_pad_bytes_total", "counter",
             csnap.get("pad_bytes", 0))
    fams.add("ramba_compile_class_pad_waste_frac", "gauge",
             csnap.get("pad_waste_frac", 0.0))
    fams.add("ramba_compile_persist_armed", "gauge",
             1 if psnap.get("armed") else 0)
    fams.add("ramba_compile_persist_hits_total", "counter",
             psnap.get("hits", 0))
    fams.add("ramba_compile_persist_misses_total", "counter",
             psnap.get("misses", 0))
    fams.add("ramba_compile_persist_corrupt_total", "counter",
             psnap.get("corrupt", 0))
    fams.add("ramba_compile_persist_stores_total", "counter",
             psnap.get("stores", 0))
    fams.add("ramba_compile_persist_bytes_read_total", "counter",
             psnap.get("bytes_read", 0))
    fams.add("ramba_compile_persist_bytes_written_total", "counter",
             psnap.get("bytes_written", 0))


def _attrib_series(fams: _Families) -> None:
    from ramba_tpu_torch.observe import attrib as _attrib

    rep = _attrib.attribution_report()
    if not rep:
        return  # no flush attributed yet: keep the exposition quiet
    fams.add("ramba_flushes_attributed_total", "counter",
             rep.get("flushes", 0))
    for stage, s in rep.get("stage_seconds", {}).items():
        fams.add("ramba_stage_seconds_total", "counter", s,
                 {"stage": stage})
    fams.add("ramba_stage_unattributed_seconds_total", "counter",
             rep.get("unattributed_s", 0.0))
    sentinel = rep.get("sentinel", {})
    fams.add("ramba_perf_regressions_total", "counter",
             sentinel.get("regressions", 0))
    fams.add("ramba_perf_baselines", "gauge", sentinel.get("baselines", 0))
    for fp, row in sorted(rep.get("rooflines", {}).items()):
        labels = {"fingerprint": fp, "label": row.get("label", "?"),
                  "bound": row.get("bound", "?")}
        fams.add("ramba_roofline_frac_of_peak", "gauge",
                 row.get("frac_of_peak", 0.0), labels)
        fams.add("ramba_roofline_achieved_gb_per_s", "gauge",
                 row.get("achieved_gb_per_s", 0.0), labels)
        fams.add("ramba_roofline_achieved_tflops", "gauge",
                 row.get("achieved_tflops", 0.0), labels)


def _observer_series(fams: _Families) -> None:
    """The observability plane's own bill (observe/observer.py): wall
    seconds per component plus the tax as a fraction of attributed
    flush wall — the number perf_diff gates below 2%."""
    snap = _observer.snapshot()
    comps = snap.get("components") or {}
    if not comps:
        return  # plane has not billed anything yet: stay quiet
    for name, ent in sorted(comps.items()):
        fams.add("ramba_observer_seconds_total", "counter",
                 ent.get("seconds", 0.0), {"component": name})
    frac = snap.get("tax_frac")
    if frac is not None:
        fams.add("ramba_observer_tax_frac", "gauge", frac)


def _elastic_series(fams: _Families) -> None:
    from ramba_tpu_torch.resilience import elastic as _elastic

    rep = _elastic.report()
    fams.add("ramba_heartbeats_total", "counter", rep.get("heartbeats", 0))
    fams.add("ramba_heartbeat_running", "gauge",
             1 if rep.get("heartbeat_running") else 0)
    age = rep.get("last_beat_age_s")
    if age is not None:
        fams.add("ramba_heartbeat_age_seconds", "gauge", age)
    prog = rep.get("last_progress_age_s")
    if prog is not None:
        fams.add("ramba_progress_age_seconds", "gauge", prog)
    fams.add("ramba_stalls_total", "counter", rep.get("stalls", 0))


def _process_info_series(fams: _Families) -> None:
    """``ramba_process_info`` — the identity series federated scrapes
    join/dedup replicas on: constant value 1, all information in the
    labels (the node-exporter ``*_info`` convention).  ``start_time``
    distinguishes incarnations of a recycled pid."""
    from ramba_tpu_torch import diagnostics as _diagnostics

    ident = _diagnostics.identity()
    fams.add("ramba_process_info", "gauge", 1, {
        "pid": ident["pid"],
        "host": ident["host"],
        "device_kind": ident["device_kind"] or "",
        "start_time": ident["start_time_wall"],
        "schema_version": ident["schema_version"],
    })


def render() -> str:
    """The full Prometheus exposition.  Each source is snapshotted under
    its own lock (internally consistent per subsystem); a scrape is one
    moment per subsystem, not one global stop-the-world."""
    t_obs = time.perf_counter()
    try:
        rank, _nprocs = _events._rank_info()
        fams = _Families({"rank": rank})
        try:
            _process_info_series(fams)
        except Exception:
            pass  # identity must never break a scrape
        snap = _registry.snapshot()
        _counter_series(fams, snap, _registry.gauge_names())
        _ledger_series(fams)
        try:
            _memory_series(fams)
        except Exception:
            pass  # governor not imported/available: skip its families
        _slo_series(fams)
        try:
            _autotune_series(fams)
        except Exception:
            pass  # autotuner not imported/available: skip its families
        try:
            _compile_series(fams)
        except Exception:
            pass  # compile classes / persist cache unused: skip
        try:
            _attrib_series(fams)
        except Exception:
            pass  # attribution plane unused: skip
        try:
            _observer_series(fams)
        except Exception:
            pass  # observer ledger empty: skip
        try:
            _elastic_series(fams)
        except Exception:
            pass
        fams.add("ramba_scrape_timestamp_seconds", "gauge",
                 round(time.time(), 3))
        return fams.render()
    finally:
        _observer.add("telemetry", time.perf_counter() - t_obs)


def textfile_path(path: str) -> str:
    """The actual path one process rewrites: ``<path>.rank<i>`` under
    multi-controller SPMD (same suffixing as events.py's trace JSONL).
    Two ranks handed the same ``RAMBA_TELEMETRY``/``RAMBA_METRICS_FILE``
    path would otherwise take turns clobbering each other's atomic
    rewrites — each scrape would see whichever rank replaced last."""
    rank, nprocs = _events._rank_info()
    return path if nprocs <= 1 else f"{path}.rank{rank}"


def write_textfile(path: str) -> None:
    """One atomic textfile rewrite (tmp + replace): a scraper reading the
    file never sees a partial exposition.  Multi-rank processes write
    per-rank siblings (see :func:`textfile_path`)."""
    path = textfile_path(path)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(render())
    os.replace(tmp, path)

# ---------------------------------------------------------------------------
# exporter threads
# ---------------------------------------------------------------------------


class _Exporter:
    """Background serving of :func:`render`: an HTTP /metrics listener
    and/or a periodic textfile writer, both daemon threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self._server = None
        self._http_thread = None
        self._file_thread = None
        self._file_stop = threading.Event()
        self._port = None

    # -- http ---------------------------------------------------------------

    def start_http(self, port: int) -> Optional[int]:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                path = self.path.split("?")[0]
                if path not in ("/metrics", "/", "/healthz"):
                    self.send_error(404)
                    return
                try:
                    if path == "/healthz":
                        body = json.dumps(health()).encode()
                        ctype = "application/json"
                    else:
                        body = render().encode()
                        ctype = "text/plain; version=0.0.4"
                except Exception as e:
                    self.send_error(500, str(e)[:100])
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # scrapes must not spam stderr
                pass

        with self._lock:
            if self._server is not None:
                return self._port
            try:
                srv = ThreadingHTTPServer((_bind_host(), int(port)), Handler)
            except OSError as e:
                from ramba_tpu_torch.observe import health as _health

                _health.record(outcome="error", error=e,
                               source="metrics_exporter", port=port)
                return None
            srv.daemon_threads = True
            self._server = srv
            self._port = srv.server_address[1]
            t = threading.Thread(target=srv.serve_forever,
                                 name="ramba-metrics-http", daemon=True)
            t.start()
            self._http_thread = t
            _registry.gauge("telemetry.metrics_port", self._port)
            return self._port

    def port(self) -> Optional[int]:
        """Bound HTTP port (resolves port-0 ephemeral binds for tests and
        the SPMD suite)."""
        return self._port

    # -- textfile -----------------------------------------------------------

    def start_textfile(self, path: str, interval_s: float) -> None:
        with self._lock:
            if self._file_thread is not None:
                return
            self._file_stop.clear()

            def run():
                while True:
                    try:
                        write_textfile(path)
                    except Exception:
                        pass
                    if self._file_stop.wait(interval_s):
                        return

            t = threading.Thread(target=run, name="ramba-metrics-file",
                                 daemon=True)
            t.start()
            self._file_thread = t

    # -- lifecycle ----------------------------------------------------------

    def started(self) -> bool:
        return self._server is not None or self._file_thread is not None

    def stop(self) -> None:
        with self._lock:
            srv, self._server, self._port = self._server, None, None
            ft, self._file_thread = self._file_thread, None
        if srv is not None:
            try:
                srv.shutdown()
                srv.server_close()
            except Exception:
                pass
        if ft is not None:
            self._file_stop.set()
            ft.join(timeout=2)


_exporter = _Exporter()
_env_checked = False


def _bind_host() -> str:
    """The exporter's bind address: ``RAMBA_METRICS_HOST``, else every
    interface (as the reference)."""
    return os.environ.get("RAMBA_METRICS_HOST", "")


def health() -> dict:
    """The exporter's ``/healthz`` document: the process identity, the
    heartbeat's and the last flush's ages, stalls, slow flushes, perf
    regressions and breached tenants; ``ok`` is false while a tenant is
    breached or the group is broken."""
    from ramba_tpu_torch import diagnostics as _diagnostics
    from ramba_tpu_torch.parallel import distributed as _distributed
    from ramba_tpu_torch.resilience import elastic as _elastic

    ident = _diagnostics.identity()
    el = _elastic.report()
    breached = _slo.breached_tenants()
    broken = _distributed.broken()
    return {
        "ok": not breached and not broken,
        "rank": ident["rank"], "pid": ident["pid"],
        "device_kind": ident["device_kind"],
        "heartbeat_age_s": el.get("last_beat_age_s"),
        "progress_age_s": el.get("last_progress_age_s"),
        "stalls": el.get("stalls", 0),
        "slow_flushes": _ledger.snapshot().get("slow_flushes", 0),
        "perf_regressions": _registry.get("attrib.perf_regression"),
        "slo_breached": breached,
        "group_broken": bool(broken),
    }


def start(port: Optional[int] = None, path: Optional[str] = None,
          interval_s: Optional[float] = None) -> Optional[int]:
    """Explicitly start the exporter (tests / embedding code).  Returns
    the bound HTTP port when an HTTP listener was requested."""
    bound = None
    if port is not None:
        bound = _exporter.start_http(port)
    if path is not None:
        iv = interval_s
        if iv is None:
            try:
                iv = float(os.environ.get("RAMBA_METRICS_INTERVAL_S", "5") or 5)
            except ValueError:
                iv = 5.0
        _exporter.start_textfile(path, max(0.05, iv))
    return bound


def ensure_started() -> None:
    """Env-driven idempotent start; the fuser calls this once per flush
    next to the profiler's ensure_started.  After the first look at the
    environment it is a single boolean check."""
    global _env_checked
    if _env_checked or _exporter.started():
        return
    _env_checked = True
    port_raw = os.environ.get("RAMBA_METRICS_PORT")
    file_raw = os.environ.get("RAMBA_METRICS_FILE") or None
    port = None
    if port_raw not in (None, ""):
        try:
            port = int(port_raw)
        except ValueError:
            port = None
    if port is not None or file_raw is not None:
        start(port=port, path=file_raw)


def started() -> bool:
    return _exporter.started()


def port() -> Optional[int]:
    return _exporter.port()


def stop() -> None:
    global _env_checked
    _exporter.stop()
    _env_checked = False


def reset() -> None:
    """Tests: stop threads, re-arm flight budget and env check."""
    stop()
    flight_reset()
