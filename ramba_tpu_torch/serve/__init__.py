"""Multi-tenant serving facade over the per-stream fuser.

Counterpart of ``ramba_tpu/serve/__init__.py``.  The fleet above it
(replicas, the router, the shared artifact tier) is ``ramba_tpu_torch.fleet``,
and the warm pool ``ramba_tpu_torch.compile.warmpool``.

The fuser gives every serving session its own :class:`~ramba_tpu_torch.core.
fuser.FlushStream` — pending registry, auto-flush threshold, quarantine
scope.  This package puts the production front-end on top:

* :class:`~ramba_tpu_torch.serve.session.Session` — the user-facing handle.  A
  context manager that routes every lazy array built inside it onto the
  session's stream, carries a tenant identity for attribution, an
  optional per-tenant device-memory byte quota (enforced by the memory governor's
  admission control), and flushes through the async pipeline.
* :class:`~ramba_tpu_torch.serve.pipeline.CompilePipeline` — ONE background
  compile/dispatch worker for the process.  A session flush becomes
  enqueue (trace + verify + fingerprint, cheap, caller thread) +
  dispatch (execution, worker thread); back-to-back flushes whose
  program fingerprints match are coalesced into one compile-cache-warm
  batch.
* :class:`~ramba_tpu_torch.serve.fairness.RoundRobin` — the pipeline's queue:
  strict round-robin between tenants with queued work, FIFO within a
  tenant, so one tenant's burst cannot starve the others.

Environment:

* ``RAMBA_SERVE_MAX_PENDING`` — default per-session auto-flush
  threshold (falls back to ``RAMBA_TPU_MAX_PENDING``).
* ``RAMBA_SERVE_QUOTA`` — default per-tenant device-memory quota
  (``common.parse_bytes`` grammar, e.g. ``512m``; unset = no quota).
* ``RAMBA_SERVE_COALESCE`` — max flushes coalesced into one dispatch
  batch (default 8; ``1`` disables coalescing).
* Overload plane (:mod:`ramba_tpu_torch.serve.overload`):
  ``RAMBA_DEADLINE_MS`` (default request deadline),
  ``RAMBA_SERVE_QUEUE_DEPTH`` (per-tenant queue cap, default 4096),
  ``RAMBA_SERVE_SOJOURN_MS`` (CoDel sojourn target, 0 = off),
  ``RAMBA_HEDGE_FACTOR`` (hedged dispatch, 0 = off),
  ``RAMBA_BREAKER_THRESHOLD`` / ``RAMBA_BREAKER_WINDOW_S`` /
  ``RAMBA_BREAKER_COOLDOWN_S`` (per-tenant circuit breakers).

Everything a session does lands on the existing observability surface
with a ``tenant`` tag: flush spans and degrade/flush_error/slow_flush
events, ``serve.tenant.<t>.*`` counters, per-tenant execution counts in
the kernel cost ledger, and per-tenant resident bytes in the memory
snapshot — ``diagnostics.report()`` renders the rollup.
"""

from __future__ import annotations

from ramba_tpu_torch.serve import overload
from ramba_tpu_torch.serve.fairness import RoundRobin
from ramba_tpu_torch.serve.overload import (CircuitOpenError,
                                      DeadlineExceededError, OverloadError,
                                      QueueFullError, ShedError,
                                      TicketAbandoned, brownout_state)
from ramba_tpu_torch.serve.pipeline import (CompilePipeline, FlushTicket,
                                      current_pipeline, get_pipeline,
                                      shutdown)
from ramba_tpu_torch.serve.session import Session

__all__ = [
    "Session", "CompilePipeline", "FlushTicket", "RoundRobin",
    "current_pipeline", "get_pipeline", "shutdown", "quiesce",
    "tenant_report", "overload", "OverloadError", "DeadlineExceededError",
    "QueueFullError", "ShedError", "CircuitOpenError", "TicketAbandoned",
    "brownout_state", "overload_report",
]


def quiesce() -> int:
    """Flush + drain every session's stream and the async pipeline's
    queue — the serve-facing name for ``resilience.elastic.quiesce``,
    which drain-to-checkpoint runs before saving."""
    from ramba_tpu_torch.resilience import elastic as _elastic

    return _elastic.quiesce()


def overload_report() -> dict:
    """Brownout/breaker/shed/hedge rollup — the data behind the
    overload section of ``diagnostics.report()``."""
    return overload.report()


def tenant_report() -> dict:
    """Per-tenant rollup across counters, kernel ledger, memory ledger,
    and the SLO histograms (e2e p50/p95/p99 latency) — the data behind
    the serving section of ``diagnostics.report()``."""
    from ramba_tpu_torch.observe import ledger as _ledger
    from ramba_tpu_torch.observe import registry as _registry
    from ramba_tpu_torch.observe import slo as _slo
    from ramba_tpu_torch.resilience import memory as _memory

    tenants: dict = {}

    def _t(name: str) -> dict:
        return tenants.setdefault(name, {
            "flushes": 0, "nodes": 0, "quota_rejects": 0,
            "executes": 0, "live_bytes": 0,
        })

    for key, v in _registry.prefixed("serve.tenant.").items():
        parts = key.split(".")
        if len(parts) < 4:
            continue
        tenant, metric = ".".join(parts[2:-1]), parts[-1]
        if metric in ("flushes", "nodes", "quota_rejects", "slo_breach"):
            _t(tenant)[metric] = v
    for entry in _ledger.snapshot()["kernels"].values():
        for tenant, n in entry.get("tenants", {}).items():
            _t(tenant)["executes"] += n
    for tenant, b in _memory.ledger.tenant_snapshot().items():
        _t(tenant)["live_bytes"] = b
    for tenant in list(tenants):
        tenants[tenant].update(_slo.tenant_latency(tenant))
    return tenants
