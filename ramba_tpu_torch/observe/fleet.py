"""Fleet observability federation: snapshot spool, collector, health model.

Counterpart of ``ramba_tpu/observe/fleet.py``.  Every observability
surface below this module is process-local: the counters registry, the
kernel and roofline ledger, the SLO histograms, the overload plane, the
heartbeat.  A serving fleet of N replicas is N silos until something
federates them.  This module does, in three pieces:

**Snapshot spool (publisher side).**  When ``RAMBA_FLEET_DIR`` is set,
:func:`ensure_started` (called by the fuser once per flush, beside the
telemetry exporter's hook) starts a daemon thread that publishes the whole
``diagnostics.snapshot()``, wrapped in a versioned spool document with the
process-identity block, the publish interval and a publish sequence
number, to ``RAMBA_FLEET_DIR/<host>-<pid>-<rank>.json`` every
``RAMBA_FLEET_INTERVAL_S`` seconds (default 5).  Writes are atomic (tmp +
``os.replace``), so a collector never reads a torn document from a live
publisher; a torn file on disk means a dead writer, and the collector
classifies it instead of crashing.  The publisher reads host state only:
the snapshot copies each section under its own lock and never waits for
the card, launches nothing and stamps no flush span, so the flush path
pays the one boolean check in :func:`ensure_started`.

**Collector (reader side).**  :func:`health` reads every spool file in a
fleet directory and classifies each replica:

========== ==========================================================
state      meaning
========== ==========================================================
healthy    fresh snapshot, brownout green, no open breakers, no
           latched SLO breach
degraded   fresh snapshot but the replica says it is in trouble:
           brownout yellow/red, an open circuit breaker, a latched SLO
           breach, an integrity suspect or a silent heartbeat
stale      snapshot age past ``RAMBA_FLEET_STALE_X`` x interval
           (default 1.5), or the document was torn/unparseable or
           carries another schema_version
dead       snapshot age past ``RAMBA_FLEET_DEAD_X`` x interval
           (default 2.0): a router must stop sending it traffic
========== ==========================================================

The health dict is the router's input (``fleet/router.py``):
``{"replicas": {id: {state, reason, age_s, identity, signals}},
"counts": {...}, "fleet_state": worst}``.  :func:`rollup` aggregates the
same spool into fleet-level numbers: per-tenant SLO summaries merged by
histogram addition (``slo.merge_summaries``), fleet goodput, the
replicas' compile-cache, memo and persist hit rates side by side, and the
fleet's worst kernels by fraction of peak.

**Prometheus federation.**  :func:`render` emits the rollup in text
exposition format with a ``replica`` label on every per-replica series,
and :func:`write_textfile` writes it atomically.
``scripts/fleet_collector_torch.py`` wraps all of this in a CLI.

The reader side touches no device: it parses JSON from disk, so the
collector runs on any host that sees the spool directory.  Traces of
several replicas stitch by their shared ``trace_id`` with
``scripts/trace_report.py <dir> --trace <id>`` over the replicas'
``RAMBA_TRACE`` files (stdlib only; the event schema is the reference's).
"""

from __future__ import annotations

import glob
import json
import os
import socket
import threading
import time
from typing import Optional

from ramba_tpu_torch.observe import observer as _observer
from ramba_tpu_torch.observe import registry as _registry
from ramba_tpu_torch.observe import slo as _slo

#: Replica health states (see the module-docstring table).
HEALTHY, DEGRADED, STALE, DEAD = "healthy", "degraded", "stale", "dead"

#: Worst-first severity order for the fleet_state rollup.
_SEVERITY = (DEAD, STALE, DEGRADED, HEALTHY)

DEFAULT_INTERVAL_S = 5.0
DEFAULT_STALE_X = 1.5
DEFAULT_DEAD_X = 2.0


def _env_float(name: str, default: float) -> float:
    try:
        v = float(os.environ.get(name, "") or default)
        return v if v > 0 else default
    except ValueError:
        return default


def fleet_dir() -> Optional[str]:
    return os.environ.get("RAMBA_FLEET_DIR") or None


def publish_interval_s() -> float:
    return _env_float("RAMBA_FLEET_INTERVAL_S", DEFAULT_INTERVAL_S)


def stale_factor() -> float:
    return _env_float("RAMBA_FLEET_STALE_X", DEFAULT_STALE_X)


def dead_factor() -> float:
    return _env_float("RAMBA_FLEET_DEAD_X", DEFAULT_DEAD_X)


# ---------------------------------------------------------------------------
# publisher: the snapshot spool
# ---------------------------------------------------------------------------

_pub_lock = threading.Lock()
_pub_seq = 0


def replica_id(identity: Optional[dict] = None) -> str:
    """``<host>-<pid>-<rank>`` — the spool filename stem and the
    ``replica`` label value.  Derived from the identity block so the
    collector can re-derive it from the document alone."""
    if identity is None:
        from ramba_tpu_torch import diagnostics as _diagnostics

        identity = _diagnostics.identity()
    return (f"{identity.get('host', socket.gethostname())}"
            f"-{identity.get('pid', os.getpid())}"
            f"-{identity.get('rank', 0)}")


def publish(directory: Optional[str] = None) -> Optional[str]:
    """Write one atomic spool document; returns its path (None when no
    fleet directory is configured).  Safe to call from any thread; the
    document is internally consistent because ``diagnostics.snapshot()``
    copies each section under its own lock."""
    d = directory or fleet_dir()
    if d is None:
        return None
    from ramba_tpu_torch import diagnostics as _diagnostics

    global _pub_seq
    t0 = time.perf_counter()
    snap = _diagnostics.snapshot()
    ident = snap["identity"]
    with _pub_lock:
        _pub_seq += 1
        seq = _pub_seq
    doc = {
        "schema_version": _diagnostics.SCHEMA_VERSION,
        "identity": ident,
        "replica": replica_id(ident),
        "interval_s": publish_interval_s(),
        "published_at": round(time.time(), 6),
        "published_mono": round(time.monotonic(), 6),
        "publish_seq": seq,
        # the compact always-present signals the health model reads —
        # duplicated out of the snapshot's quiet-when-idle sections so a
        # green replica is POSITIVELY green, not ambiguously silent
        "signals": _signals(),
        "diagnostics": snap,
    }
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, doc["replica"] + ".json")
    # seq in the tmp name: concurrent publishes from the same process
    # (background publisher thread + a direct publish() call) must not
    # share a staging file, or one thread's os.replace steals the other's
    tmp = f"{path}.{os.getpid()}.{seq}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, default=str)
    os.replace(tmp, path)  # collectors never see a torn live document
    publish_ms = round((time.perf_counter() - t0) * 1e3, 3)
    _registry.inc("fleet.publishes")
    _registry.gauge("fleet.last_publish_ms", publish_ms)
    _observer.add("fleet", time.perf_counter() - t0)
    return path


def _signals() -> dict:
    """The health-relevant slice published alongside the full snapshot:
    brownout level, open breakers, latched SLO breaches, heartbeat age.
    Every key is always present (a router must read green as green)."""
    out = {"brownout": "green", "open_breakers": [], "breaker_trips": 0,
           "shed_total": 0, "slo_breached": [], "heartbeat_running": False,
           "heartbeat_age_s": None, "heartbeat_interval_s": None,
           # serving endpoint (host:port) when this process is a fleet
           # replica server — how the router joins a spool snapshot to
           # the connection it routes to (fleet/replica.py exports it)
           "endpoint": os.environ.get("RAMBA_FLEET_ENDPOINT") or None,
           # silent-corruption defense (resilience/integrity.py): digest
           # or audit failures in the rolling window; past the threshold
           # the replica is a corruption suspect -> routed around
           "integrity_suspect": False, "integrity_failures": 0}
    try:
        from ramba_tpu_torch.serve import overload as _overload

        out.update(_overload.health_signals())
    except Exception:
        pass
    try:
        out["slo_breached"] = _slo.breached_tenants()
    except Exception:
        pass
    try:
        from ramba_tpu_torch.resilience import integrity as _integrity

        out["integrity_failures"] = _integrity.failure_count()
        out["integrity_suspect"] = _integrity.suspect()
    except Exception:
        pass
    try:
        from ramba_tpu_torch.resilience import elastic as _elastic

        rep = _elastic.report()
        out["heartbeat_running"] = rep.get("heartbeat_running", False)
        out["heartbeat_age_s"] = rep.get("last_beat_age_s")
        out["heartbeat_interval_s"] = rep.get("heartbeat_interval_s")
    except Exception:
        pass
    return out


class _Spool:
    """Daemon publisher thread (same lifecycle shape as the telemetry
    exporter's textfile thread)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._thread = None
        self._stop = threading.Event()

    def start(self, directory: str, interval_s: float) -> None:
        with self._lock:
            if self._thread is not None:
                return
            self._stop.clear()

            def run():
                while True:
                    try:
                        publish(directory)
                    except Exception:
                        pass  # the spool must never take the job down
                    if self._stop.wait(interval_s):
                        return

            t = threading.Thread(target=run, name="ramba-fleet-spool",
                                 daemon=True)
            t.start()
            self._thread = t

    def started(self) -> bool:
        return self._thread is not None

    def stop(self) -> None:
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:
            self._stop.set()
            t.join(timeout=2)


_spool = _Spool()
_env_checked = False


def start(directory: Optional[str] = None,
          interval_s: Optional[float] = None) -> None:
    """Explicitly start the spool publisher (tests / embedding code)."""
    d = directory or fleet_dir()
    if d is None:
        return
    iv = interval_s if interval_s is not None else publish_interval_s()
    _spool.start(d, max(0.05, iv))


def ensure_started() -> None:
    """Env-driven idempotent start; after the first environment look it
    is a single boolean check on the flush path."""
    global _env_checked
    if _env_checked or _spool.started():
        return
    _env_checked = True
    if fleet_dir() is not None:
        start()


def started() -> bool:
    return _spool.started()


def stop() -> None:
    global _env_checked
    _spool.stop()
    _env_checked = False


def reset() -> None:
    """Tests: stop the publisher thread and re-arm the env check."""
    stop()


# ---------------------------------------------------------------------------
# collector: load + classify
# ---------------------------------------------------------------------------


def load_spool(directory: str) -> list:
    """Read every spool document under ``directory``.  Returns one entry
    per file: ``{"path", "replica", "doc"|None, "error"|None}``.  A
    torn/truncated/unreadable file yields ``doc=None`` with the error —
    NEVER an exception; classifying garbage is the collector's job."""
    entries = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        entry = {"path": path,
                 "replica": os.path.splitext(os.path.basename(path))[0],
                 "doc": None, "error": None}
        try:
            with open(path) as f:
                doc = json.load(f)
            if not isinstance(doc, dict):
                raise ValueError("spool document is not a JSON object")
            entry["doc"] = doc
            rep = doc.get("replica")
            if isinstance(rep, str) and rep:
                entry["replica"] = rep
        except (OSError, ValueError) as e:
            entry["error"] = f"{type(e).__name__}: {e}"
        entries.append(entry)
    return entries


def classify(entry: dict, now: Optional[float] = None) -> tuple:
    """``(state, reason)`` for one spool entry (see module table).
    ``now`` is unix seconds (tests inject it to step time)."""
    from ramba_tpu_torch import diagnostics as _diagnostics

    doc = entry.get("doc")
    if doc is None:
        return STALE, entry.get("error") or "unreadable"
    sv = doc.get("schema_version")
    if sv != _diagnostics.SCHEMA_VERSION:
        return (STALE, f"schema_version {sv!r} != "
                       f"{_diagnostics.SCHEMA_VERSION} (snapshot skipped)")
    interval = doc.get("interval_s")
    if not isinstance(interval, (int, float)) or interval <= 0:
        interval = DEFAULT_INTERVAL_S
    published = doc.get("published_at")
    if not isinstance(published, (int, float)):
        return STALE, "no published_at stamp"
    age = (now if now is not None else time.time()) - published
    if age > dead_factor() * interval:
        return DEAD, (f"snapshot age {age:.1f}s > "
                      f"{dead_factor():g}x interval ({interval:g}s)")
    if age > stale_factor() * interval:
        return STALE, (f"snapshot age {age:.1f}s > "
                       f"{stale_factor():g}x interval ({interval:g}s)")
    sig = doc.get("signals") or {}
    brown = sig.get("brownout", "green")
    if brown not in ("green", None):
        return DEGRADED, f"brownout {brown}"
    open_b = sig.get("open_breakers") or []
    if open_b:
        return DEGRADED, f"open breakers: {','.join(map(str, open_b))}"
    breached = sig.get("slo_breached") or []
    if breached:
        return DEGRADED, ("latched SLO breach: "
                          + ",".join(t or "(default)" for t in breached))
    if sig.get("integrity_suspect"):
        return DEGRADED, (f"integrity suspect: "
                          f"{sig.get('integrity_failures', 0)} digest/audit "
                          f"failure(s) in window")
    hb_iv = sig.get("heartbeat_interval_s")
    hb_age = sig.get("heartbeat_age_s")
    if (sig.get("heartbeat_running") and isinstance(hb_iv, (int, float))
            and isinstance(hb_age, (int, float)) and hb_age > 2.0 * hb_iv):
        return DEGRADED, (f"heartbeat silent {hb_age:.1f}s "
                          f"(> 2x {hb_iv:g}s beacon)")
    return HEALTHY, "fresh snapshot, green signals"


def _ingest(d: Optional[str], entries: list,
            now: Optional[float] = None) -> tuple:
    """One classify pass over loaded spool entries → ``(health,
    fresh_docs)``.  The single place health semantics live: both the
    collector and the router (``fleet.poll``) build on this, so they
    cannot drift on what healthy/degraded/stale/dead mean."""
    replicas: dict = {}
    counts = {s: 0 for s in _SEVERITY}
    fresh: dict = {}
    for entry in entries:
        state, reason = classify(entry, now=now)
        counts[state] += 1
        doc = entry.get("doc") or {}
        published = doc.get("published_at")
        age = None
        if isinstance(published, (int, float)):
            age = round((now if now is not None else time.time())
                        - published, 3)
        replicas[entry["replica"]] = {
            "state": state,
            "reason": reason,
            "age_s": age,
            "interval_s": doc.get("interval_s"),
            "publish_seq": doc.get("publish_seq"),
            "identity": doc.get("identity"),
            "signals": doc.get("signals"),
        }
        # aggregatable docs: stale/dead numbers would double-count a
        # replica against its own successor or drag in a corpse
        if state in (HEALTHY, DEGRADED):
            fresh[entry["replica"]] = entry["doc"]
    fleet_state = next((s for s in _SEVERITY if counts[s]), HEALTHY)
    return ({"dir": d, "replicas": replicas, "counts": counts,
             "fleet_state": fleet_state}, fresh)


def _load_entries(d: Optional[str]) -> list:
    return load_spool(d) if d is not None and os.path.isdir(d) else []


def health(directory: Optional[str] = None,
           now: Optional[float] = None) -> dict:
    """The router-facing fleet health verdict (see module docstring)."""
    d = directory or fleet_dir()
    return _ingest(d, _load_entries(d), now=now)[0]


def poll(directory: Optional[str] = None,
         now: Optional[float] = None) -> dict:
    """One spool read → ``{"dir", "health", "rollup"}``.  The shared
    load/classify/aggregate path: ``fleet_collector.py --watch`` renders
    from it each tick and the router's health feed consumes it, so the
    two cannot disagree about a replica's state — and the spool files
    are read exactly once per tick instead of once per question."""
    d = directory or fleet_dir()
    h, fresh = _ingest(d, _load_entries(d), now=now)
    return {"dir": d, "health": h, "rollup": _rollup_of(d, fresh)}


# ---------------------------------------------------------------------------
# collector: fleet rollups
# ---------------------------------------------------------------------------


def rollup(directory: Optional[str] = None,
           now: Optional[float] = None) -> dict:
    """Fleet-level aggregation over the fresh spool documents:

    * ``slo``: per-tenant e2e/dispatch/prepare summaries merged across
      replicas by histogram-bucket addition (exact, no resampling),
    * ``goodput``: summed flush/node/shed counters + per-replica rows
      (the per-replica rows always re-add to the fleet row — that is the
      reconciliation invariant the fleet suite leg asserts),
    * ``caches``: per-replica memo / compile-cache / persist-cache hit
      rates side by side — one replica compiling what the others serve
      from cache is the federated-warm-start smell,
    * ``rooflines``: the fleet's worst kernels by fraction-of-peak with
      the replica that reported them.
    """
    d = directory or fleet_dir()
    _h, docs = _ingest(d, _load_entries(d), now=now)
    return _rollup_of(d, docs)


def _rollup_of(d: Optional[str], docs: dict) -> dict:
    """The aggregation body of :func:`rollup`, over already-loaded
    fresh documents (shared with :func:`poll`)."""
    # -- per-tenant SLO merge ------------------------------------------------
    per_metric: dict = {}  # metric -> tenant -> [summary, ...]
    for doc in docs.values():
        hists = (doc.get("diagnostics", {}).get("slo", {})
                 .get("histograms", {}))
        for metric, per_tenant in hists.items():
            if not isinstance(per_tenant, dict):
                continue
            bucket = per_metric.setdefault(metric, {})
            for tenant, summary in per_tenant.items():
                bucket.setdefault(tenant, []).append(summary)
    slo_merged = {
        metric: {tenant: _slo.merge_summaries(parts)
                 for tenant, parts in tenants.items()}
        for metric, tenants in per_metric.items()
    }

    # -- goodput -------------------------------------------------------------
    per_replica = {}
    totals = {"flushes": 0, "nodes_flushed": 0, "serve_flushes": 0,
              "shed_total": 0, "slo_breaches": 0}
    for rep, doc in docs.items():
        counters = doc.get("diagnostics", {}).get("counters", {}) or {}
        row = {
            "flushes": int(counters.get("fuser.flushes", 0)),
            "nodes_flushed": int(counters.get("fuser.nodes_flushed", 0)),
            "serve_flushes": int(counters.get("serve.flushes", 0)),
            "shed_total": int(counters.get("serve.shed", 0)),
            "slo_breaches": int(counters.get("serve.slo_breach", 0)),
            "uptime_s": None,
        }
        ident = doc.get("identity") or {}
        start = ident.get("start_time_wall")
        published = doc.get("published_at")
        if isinstance(start, (int, float)) \
                and isinstance(published, (int, float)):
            row["uptime_s"] = round(published - start, 3)
        per_replica[rep] = row
        for k in totals:
            totals[k] += row[k]
    goodput = dict(totals)
    goodput["replicas"] = per_replica

    # -- cache / memo / AOT comparison --------------------------------------
    caches = {}
    for rep, doc in docs.items():
        diag = doc.get("diagnostics", {})
        counters = diag.get("counters", {}) or {}
        hits = int(counters.get("fuser.cache_hit", 0))
        misses = int(counters.get("fuser.cache_miss", 0))
        row = {
            "jit_hit_rate": (round(hits / (hits + misses), 4)
                             if hits + misses else None),
            "memo_hit_rate": None, "aot_hits": 0, "aot_misses": 0,
        }
        memo = diag.get("memo") or {}
        if memo.get("hits") or memo.get("misses"):
            row["memo_hit_rate"] = memo.get("hit_rate")
        persist = (diag.get("perf", {}).get("compile", {})
                   .get("persist", {}) or {})
        row["aot_hits"] = int(persist.get("hits", 0))
        row["aot_misses"] = int(persist.get("misses", 0))
        caches[rep] = row

    # -- worst rooflines -----------------------------------------------------
    worst = []
    for rep, doc in docs.items():
        roofs = (doc.get("diagnostics", {}).get("perf", {})
                 .get("attribution", {}).get("rooflines", {}) or {})
        for fp, row in roofs.items():
            frac = row.get("frac_of_peak")
            if isinstance(frac, (int, float)):
                worst.append({
                    "replica": rep, "fingerprint": fp,
                    "label": row.get("label", "?"),
                    "bound": row.get("bound", "?"),
                    "frac_of_peak": frac,
                })
    worst.sort(key=lambda r: r["frac_of_peak"])

    return {"dir": d, "replicas": sorted(docs),
            "slo": slo_merged, "goodput": goodput,
            "caches": caches, "rooflines": worst[:16]}


# ---------------------------------------------------------------------------
# Prometheus federation
# ---------------------------------------------------------------------------


def render(directory: Optional[str] = None,
           now: Optional[float] = None) -> str:
    """Fleet-level text exposition: one scrape covering every replica,
    with ``replica`` labels on per-replica series and the merged
    per-tenant e2e histograms at fleet scope."""
    from ramba_tpu_torch.observe.telemetry import _Families, _fmt

    fams = _Families({})
    polled = poll(directory, now=now)
    h, roll = polled["health"], polled["rollup"]
    for state in _SEVERITY:
        fams.add("ramba_fleet_replicas", "gauge", h["counts"][state],
                 {"state": state})
    for rep, row in sorted(h["replicas"].items()):
        lab = {"replica": rep}
        fams.add("ramba_fleet_replica_state", "gauge", 1,
                 {**lab, "state": row["state"]})
        if row["age_s"] is not None:
            fams.add("ramba_fleet_replica_age_seconds", "gauge",
                     row["age_s"], lab)
        ident = row.get("identity") or {}
        if ident:
            fams.add("ramba_process_info", "gauge", 1, {
                **lab,
                "pid": ident.get("pid", ""),
                "rank": ident.get("rank", ""),
                "host": ident.get("host", ""),
                "device_kind": ident.get("device_kind") or "",
                "start_time": ident.get("start_time_wall", ""),
                "schema_version": ident.get("schema_version", ""),
            })
    for rep, row in sorted(roll["goodput"]["replicas"].items()):
        lab = {"replica": rep}
        fams.add("ramba_fleet_flushes_total", "counter",
                 row["flushes"], lab)
        fams.add("ramba_fleet_shed_total", "counter",
                 row["shed_total"], lab)
    fams.add("ramba_fleet_goodput_flushes_total", "counter",
             roll["goodput"]["flushes"])
    for tenant, summ in sorted((roll["slo"].get("e2e") or {}).items()):
        f = fams.fam("ramba_fleet_e2e_seconds", "histogram")
        lab = {"tenant": tenant}
        for ub, cum in summ.get("buckets", []):
            f.add({**lab, "le": _fmt(ub)}, cum, "_bucket")
        f.add({**lab, "le": "+Inf"}, summ.get("count", 0), "_bucket")
        f.add(lab, summ.get("sum_s", 0.0), "_sum")
        f.add(lab, summ.get("count", 0), "_count")
    fams.add("ramba_fleet_scrape_timestamp_seconds", "gauge",
             round(time.time(), 3))
    return fams.render()


def write_textfile(path: str, directory: Optional[str] = None) -> None:
    """Atomic fleet exposition rewrite (tmp + replace)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(render(directory))
    os.replace(tmp, path)
