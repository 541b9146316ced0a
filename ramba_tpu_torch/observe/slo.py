"""Per-tenant SLO tracking: fixed-bucket latency histograms + breach events.

Counterpart of ``ramba_tpu/observe/slo.py``.  The kernel cost ledger
answers "what does this *program* cost"; this module answers "what does
this *tenant* experience".  Three latency distributions per tenant, each
a fixed-bucket histogram (Prometheus-compatible cumulative buckets, so
``observe/telemetry.py`` exposes them verbatim and they merge across
ranks by addition):

* ``prepare``  — the caller-thread stages of a flush (trace + prepare +
  verify),
* ``dispatch`` — the flush's wall (``wall_s``),
* ``e2e``      — end-to-end latency, the one the objective is judged
  against.  Until serve sessions are ported (ROADMAP A.10) the fuser
  feeds every flush's wall here, and every span is the default
  tenant's.

Quantiles are estimated from the cumulative counts with linear
interpolation inside the landing bucket (error bounded by the bucket
width).

**SLO breach events.**  With ``RAMBA_SLO_P95_MS`` set, every ``e2e``
observation re-evaluates the tenant's p95; once at least
``RAMBA_SLO_MIN_SAMPLES`` (default 20) samples exist and the p95 exceeds
the objective, ONE ``slo_breach`` event is emitted and the tenant is
latched breached until the p95 recovers below 80 % of the objective.
The event carries ``why``: ``attrib.explain``'s verdict on the flush
that tipped the p95, else (no stage diverges from its baseline) the
stage that takes the largest share of that flush's wall.  Breach events
are a flight-recorder trigger (``observe/telemetry.py``).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional, Tuple

from ramba_tpu_torch.observe import events as _events
from ramba_tpu_torch.observe import registry as _registry

# Upper bounds in seconds, strictly increasing; +Inf is implicit as the
# final bucket.  Spans 1 ms .. 10 s: below 1 ms is dispatch-floor noise,
# above 10 s is a stall and the watchdog's problem, not a histogram's.
BUCKETS_S: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

#: Latency distributions tracked per tenant.
METRICS = ("prepare", "dispatch", "e2e")

_lock = threading.Lock()


class Histogram:
    """One fixed-bucket latency histogram (cumulative on read, per-bucket
    on write).  Not thread-safe on its own — the module lock guards every
    mutation."""

    __slots__ = ("counts", "sum", "count")

    def __init__(self):
        self.counts = [0] * (len(BUCKETS_S) + 1)  # last slot = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, seconds: float) -> None:
        i = len(BUCKETS_S)
        for j, ub in enumerate(BUCKETS_S):
            if seconds <= ub:
                i = j
                break
        self.counts[i] += 1
        self.sum += seconds
        self.count += 1

    def cumulative(self) -> list:
        """``[(upper_bound_s, cumulative_count), ..., (inf, total)]`` —
        the Prometheus ``le`` series."""
        out, acc = [], 0
        for ub, c in zip(BUCKETS_S, self.counts):
            acc += c
            out.append((ub, acc))
        out.append((float("inf"), acc + self.counts[-1]))
        return out

    def quantile(self, q: float) -> Optional[float]:
        """Estimated quantile (seconds): linear interpolation inside the
        landing bucket; None when empty.  Observations beyond the last
        finite bucket report that bucket's bound (the estimate saturates
        rather than inventing a tail shape)."""
        if self.count == 0:
            return None
        target = q * self.count
        acc = 0
        lower = 0.0
        for ub, c in zip(BUCKETS_S, self.counts):
            if acc + c >= target and c > 0:
                frac = (target - acc) / c
                return lower + frac * (ub - lower)
            acc += c
            lower = ub
        return BUCKETS_S[-1]

    def summary(self) -> dict:
        out = {"count": self.count, "sum_s": round(self.sum, 6),
               "buckets": [[ub, n] for ub, n in self.cumulative()[:-1]]}
        for name, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
            v = self.quantile(q)
            out[f"{name}_ms"] = round(v * 1e3, 3) if v is not None else None
        return out


# (metric, tenant-or-None) -> Histogram
_hists: Dict[tuple, Histogram] = {}

# tenants currently latched breached (see module docstring)
_breached: set = set()

_objective_ms: Optional[float] = None
_min_samples = 20


def reconfigure(*, objective_ms: Optional[float] = None,
                min_samples: Optional[int] = None) -> None:
    """Reload the SLO objective from the environment, with explicit
    keyword overrides (tests).  Clears the breach latches."""
    global _objective_ms, _min_samples
    if objective_ms is not None:
        _objective_ms = float(objective_ms) if objective_ms > 0 else None
    else:
        raw = os.environ.get("RAMBA_SLO_P95_MS")
        try:
            _objective_ms = float(raw) if raw else None
        except ValueError:
            _objective_ms = None
        if _objective_ms is not None and _objective_ms <= 0:
            _objective_ms = None
    if min_samples is not None:
        _min_samples = max(1, int(min_samples))
    else:
        try:
            _min_samples = max(1, int(
                os.environ.get("RAMBA_SLO_MIN_SAMPLES", "20") or 20))
        except ValueError:
            _min_samples = 20
    with _lock:
        _breached.clear()


def objective_ms() -> Optional[float]:
    return _objective_ms


def _hist(metric: str, tenant: Optional[str]) -> Histogram:
    key = (metric, tenant)
    h = _hists.get(key)
    if h is None:
        h = _hists[key] = Histogram()
    return h


def observe(metric: str, seconds: float,
            tenant: Optional[str] = None) -> None:
    """Record one latency sample (hot path: one lock, one list index)."""
    with _lock:
        _hist(metric, tenant).observe(seconds)


def observe_span(span: dict) -> None:
    """Feed one finished flush span: its caller-thread stages (``trace``
    + ``prepare`` + ``verify``; the reference reads ``linearize_s``) →
    prepare, ``wall_s`` → dispatch, attributed to the span's tenant."""
    tenant = span.get("tenant")
    with _lock:
        st = span.get("stages") or {}
        if st:
            _hist("prepare", tenant).observe(float(
                st.get("trace", 0.0) + st.get("prepare", 0.0)
                + st.get("verify", 0.0)))
        wall = span.get("wall_s")
        if wall is not None:
            _hist("dispatch", tenant).observe(float(wall))


def observe_e2e(seconds: float, tenant: Optional[str] = None,
                trace_id: Optional[str] = None,
                span: Optional[dict] = None) -> Optional[dict]:
    """Record one end-to-end ticket latency and evaluate the SLO.
    Returns the ``slo_breach`` event if this observation crossed the
    objective (None otherwise).  ``span`` (the flush that tipped the
    p95) lets the incident explainer stamp a ``why`` verdict naming the
    dominant divergent stage."""
    fire = None
    with _lock:
        h = _hist("e2e", tenant)
        h.observe(seconds)
        if _objective_ms is not None and h.count >= _min_samples:
            p95 = h.quantile(0.95)
            p95_ms = p95 * 1e3 if p95 is not None else None
            key = tenant or ""
            if p95_ms is not None and p95_ms > _objective_ms:
                if key not in _breached:
                    _breached.add(key)
                    fire = (p95_ms, h.count)
            elif key in _breached and p95_ms is not None \
                    and p95_ms <= 0.8 * _objective_ms:
                _breached.discard(key)  # episode over: re-arm the latch
    if fire is None:
        return None
    p95_ms, samples = fire
    _registry.inc("serve.slo_breach")
    if tenant is not None:
        _registry.inc(f"serve.tenant.{tenant}.slo_breach")
    ev = {
        "type": "slo_breach",
        "metric": "e2e_p95",
        "p95_ms": round(p95_ms, 3),
        "objective_ms": _objective_ms,
        "samples": samples,
    }
    if tenant is not None:
        ev["tenant"] = tenant
    if trace_id is not None:
        ev["trace_id"] = trace_id
    if span is not None:
        # incident explainer: why was the flush that tipped the p95
        # slow?  Lazy import — observe modules must stay a DAG.
        from ramba_tpu_torch.observe import attrib as _attrib

        why = _attrib.explain(span) or _steady(span)
        if why is not None:
            ev["why"] = why["text"]
            ev["why_stage"] = why["stage"]
            ev["why_verdict"] = why["verdict"]
    return _events.emit(ev)


def _steady(span: dict) -> Optional[dict]:
    """The verdict of a breach no stage explains (nothing diverges from
    its baseline: the program is over its objective in its steady
    state): the stage that takes the largest share of the span's wall.
    The reference stamps no ``why`` there."""
    st = dict(span.get("stages") or {})
    un = span.get("unattributed_s")
    if isinstance(un, (int, float)) and un > 0:
        st["unattributed"] = float(un)
    wall = float(span.get("wall_s") or 0.0)
    if not st or wall <= 0:
        return None
    stage = max(st, key=lambda k: st[k])
    return {"stage": stage, "verdict": "steady state over objective",
            "text": f"{stage} {st[stage] / wall:.0%} of wall -> steady "
                    "state over objective"}


def tenant_latency(tenant: Optional[str]) -> dict:
    """p50/p95/p99 (ms) + sample count of the tenant's e2e distribution —
    the percentile block ``serve.tenant_report()`` merges in.  Empty dict
    when the tenant has no samples."""
    with _lock:
        h = _hists.get(("e2e", tenant))
        if h is None or h.count == 0:
            return {}
        out = {"e2e_samples": h.count}
        for name, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
            v = h.quantile(q)
            out[f"e2e_{name}_ms"] = (round(v * 1e3, 3)
                                     if v is not None else None)
        return out


def merge_summaries(summaries: list) -> dict:
    """Merge N :meth:`Histogram.summary` dicts (e.g. one per fleet
    replica) into one summary with re-derived p50/p95/p99.

    This is why the histograms are fixed-bucket: merging is cumulative-
    count addition per ``le`` bound, exact — no resampling, no quantile
    sketch error beyond the single-histogram bucket-width bound.  The
    fleet collector (observe/fleet.py) calls this on per-replica snapshot
    JSON, so it must tolerate summaries whose bucket lists came from a
    different process (lists from JSON, tuples from live snapshots)."""
    h = Histogram()
    for s in summaries:
        if not s:
            continue
        buckets = s.get("buckets") or []
        prev = 0
        for i, pair in enumerate(buckets):
            try:
                ub, cum = float(pair[0]), int(pair[1])
            except (TypeError, ValueError, IndexError):
                continue
            # cumulative -> per-bucket; align by position when the bound
            # matches the canonical table, else drop into the landing slot
            n = cum - prev
            prev = cum
            if n <= 0:
                continue
            slot = len(BUCKETS_S)
            for j, b in enumerate(BUCKETS_S):
                if ub <= b:
                    slot = j
                    break
            h.counts[slot] += n
        total = int(s.get("count") or 0)
        h.counts[-1] += max(0, total - prev)  # +Inf tail beyond last bound
        h.count += total
        h.sum += float(s.get("sum_s") or 0.0)
    return h.summary()


def breached_tenants() -> list:
    with _lock:
        return sorted(_breached)


def snapshot() -> dict:
    """JSON-serializable dump of every histogram (one consistent copy
    under the lock), keyed ``metric -> tenant -> summary``.  The tenant
    key for un-tenanted (default-stream) samples is ``""``."""
    with _lock:
        out: dict = {m: {} for m in METRICS}
        for (metric, tenant), h in _hists.items():
            out.setdefault(metric, {})[tenant or ""] = h.summary()
        return {
            "objective_p95_ms": _objective_ms,
            "min_samples": _min_samples,
            "breached": sorted(_breached),
            "histograms": out,
        }


def reset() -> None:
    with _lock:
        _hists.clear()
        _breached.clear()


reconfigure()
