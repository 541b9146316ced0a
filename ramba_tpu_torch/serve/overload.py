"""Overload control plane for the serving stack: deadlines, shedding,
circuit breakers, hedging.

Counterpart of ``ramba_tpu/serve/overload.py``; what differs is the
hedge on one card (see :func:`run_hedged`) and the determinism gate of
:func:`hedge_threshold`.

Every layer below the serving plane degrades gracefully — retry/ladder,
memory governor, watchdog, rank coherence — but a front door that admits
everything converts overload into collapse: queues grow without bound,
every request times out, and goodput goes to zero exactly when demand
peaks.  This module is the piece that decides *what not to run*:

* **Deadline propagation** — :class:`Deadline` is minted at flush
  prepare from ``serve.Session(deadline_ms=)`` (or ``RAMBA_DEADLINE_MS``)
  and rides the ``_FlushWork``/``FlushTicket``.  Work whose budget is
  already spent is shed *before* admission/compile/dispatch with a
  classified :class:`DeadlineExceededError`; inside the degradation
  ladder, rungs whose rolling p50 (kernel cost ledger) cannot fit the
  remaining budget are skipped, and the elastic watchdog deadline is
  clamped to ``min(watchdog, remaining)``.
* **Admission control + load shedding** — the fairness queue is bounded
  per tenant (``RAMBA_SERVE_QUEUE_DEPTH`` → :class:`QueueFullError` at
  submit), queue sojourn time is controlled CoDel-style
  (``RAMBA_SERVE_SOJOURN_MS``: drop-from-front once sojourn stays above
  target for a full interval), and a green/yellow/red brownout state
  machine fed by queue depth, memory-governor headroom, and the SLO
  breach latch disables speculative work (yellow) and sheds
  non-priority tenants (red).
* **Coherent shedding** — across ranks a locally-decided shed desyncs
  the collective schedule (one rank skips a program its peers
  dispatch).  Every dispatch-time shed decision therefore runs
  through a ``coherence.agree("serve:shed", code)`` round (severity
  max): all ranks shed the identical request set on the same epoch, or
  none do.  The round only runs when overload control is *active*
  (a deadline present, sojourn control armed, or a ``serve:admit``
  fault configured — all rank-identical predicates), so ordinary
  flushes pay nothing.  The round is the port's coherence round
  (``resilience/coherence.py``).
* **Per-tenant circuit breakers** — closed → open on repeated flush
  errors inside a rolling window; open breakers fail submissions fast
  (O(ms), before any prepare work) with :class:`CircuitOpenError`;
  after a cooldown the breaker goes half-open and admits exactly one
  probe flush, whose outcome closes or re-opens it.
* **Hedged dispatch** — when a dispatch exceeds ``RAMBA_HEDGE_FACTOR``
  × its program's rolling p95 (the slow-flush sentinel's window), a
  second attempt races the first — but only for programs the effect
  certifier (``analyze/effects.py``) proves pure and donation-free, so
  the loser can be abandoned without a donation hazard.  The loser is
  cancelled via the elastic cancel-flag; the first result resolves the
  ticket.  One process only: a hedge's extra execution would desync the
  collectives of ranks.

Fault sites: ``serve:admit`` (checked in every dispatch verdict; an
injected fault becomes a shed *proposal*, so rank-skewed specs like
``serve:admit:3:rank=1`` drive the coherent-shedding chaos leg) and
``serve:hedge`` (checked by the primary attempt of a hedged dispatch;
``serve:hedge:delay:ms=200`` seeds a deterministic hedge race).

Observability: ``serve.shed.*`` / ``serve.breaker.*`` / ``serve.hedge.*``
counters, ``shed`` / ``breaker`` / ``hedge`` / ``brownout`` events,
brownout and
breaker gauges on the Prometheus exporter, and a flight-recorder
incident per breaker trip.
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
from typing import Callable, Optional

from ramba_tpu_torch.observe import events as _events
from ramba_tpu_torch.observe import ledger as _ledger
from ramba_tpu_torch.observe import registry as _registry
from ramba_tpu_torch.observe import slo as _slo
from ramba_tpu_torch.resilience import coherence as _coherence
from ramba_tpu_torch.resilience import faults as _faults


# ---------------------------------------------------------------------------
# classified errors
# ---------------------------------------------------------------------------


class OverloadError(RuntimeError):
    """Base class for deliberate drops by the overload plane.

    ``shed_classification`` is the duck-typed routing attribute
    ``retry.classify`` keys on (like ``stall_classification`` /
    ``coherent_classification``): shed work must never be retried or
    degraded — re-attempting a shed defeats the shed."""

    shed_classification = "shed"

    def __init__(self, msg: str, *, tenant: Optional[str] = None):
        super().__init__(msg)
        self.tenant = tenant


class DeadlineExceededError(OverloadError):
    """The request's deadline budget was spent before (or during)
    execution; the work was shed, not failed."""

    shed_classification = "deadline"

    def __init__(self, msg: str, *, tenant: Optional[str] = None,
                 budget_ms: Optional[float] = None,
                 elapsed_ms: Optional[float] = None,
                 stage: str = "dispatch"):
        super().__init__(msg, tenant=tenant)
        self.budget_ms = budget_ms
        self.elapsed_ms = elapsed_ms
        self.stage = stage


class QueueFullError(OverloadError):
    """The tenant's fairness-queue depth cap rejected a submit."""

    shed_classification = "queue_full"

    def __init__(self, tenant: str, depth: int, cap: int):
        super().__init__(
            f"serve queue full for tenant {tenant!r}: depth {depth} >= "
            f"cap {cap} (RAMBA_SERVE_QUEUE_DEPTH)", tenant=tenant)
        self.depth = depth
        self.cap = cap


class ShedError(OverloadError):
    """Admission-control shed (CoDel sojourn, brownout, injected
    ``serve:admit`` fault).  ``reason`` names which."""

    def __init__(self, reason: str, *, tenant: Optional[str] = None,
                 epoch: Optional[int] = None):
        super().__init__(f"request shed by overload control ({reason})",
                         tenant=tenant)
        self.reason = reason
        self.epoch = epoch


class CircuitOpenError(OverloadError):
    """The tenant's circuit breaker is open: fail fast, no prepare, no
    queueing, no dispatch."""

    shed_classification = "breaker"

    def __init__(self, tenant: str, state: str,
                 retry_after_s: Optional[float] = None):
        msg = f"circuit breaker {state} for tenant {tenant!r}"
        if retry_after_s is not None:
            msg += f" (retry after {retry_after_s:.3f}s)"
        super().__init__(msg, tenant=tenant)
        self.state = state
        self.retry_after_s = retry_after_s


class TicketAbandoned(TimeoutError):
    """``FlushTicket.wait(timeout)`` expired: the caller gave up on this
    ticket.  The ticket is marked abandoned so a late completion
    discards instead of writing results back into a stream nobody is
    reading (the zombie-rung pattern applied to tickets).

    Subclasses TimeoutError for caller compatibility, but carries
    ``shed_classification`` so the retry classifier never treats an
    abandonment as retryable."""

    shed_classification = "abandoned"


# ---------------------------------------------------------------------------
# env knobs (read per call so tests can monkeypatch)
# ---------------------------------------------------------------------------


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def default_deadline_ms() -> Optional[float]:
    """Process-wide default request deadline (``RAMBA_DEADLINE_MS``);
    None when unset — deadlines are strictly opt-in."""
    raw = os.environ.get("RAMBA_DEADLINE_MS")
    if not raw:
        return None
    try:
        v = float(raw)
    except ValueError:
        return None
    return v if v > 0 else None


def queue_depth_cap() -> int:
    """Per-tenant fairness-queue depth cap (``RAMBA_SERVE_QUEUE_DEPTH``,
    default 4096; 0 disables).  Deliberately generous by default — the
    cap exists to bound pathological backlogs, not to tune throughput."""
    return max(0, _env_int("RAMBA_SERVE_QUEUE_DEPTH", 4096))


def sojourn_target_ms() -> float:
    """CoDel target sojourn time (``RAMBA_SERVE_SOJOURN_MS``; 0 = off)."""
    return max(0.0, _env_float("RAMBA_SERVE_SOJOURN_MS", 0.0))


def sojourn_interval_ms() -> float:
    """CoDel interval (``RAMBA_SERVE_SOJOURN_INTERVAL_MS``, default 4x
    the target): sojourn must stay above target this long before the
    first drop."""
    t = sojourn_target_ms()
    return max(0.0, _env_float("RAMBA_SERVE_SOJOURN_INTERVAL_MS", 4.0 * t))


def hedge_factor() -> float:
    """Hedged-dispatch trigger factor (``RAMBA_HEDGE_FACTOR``; 0 = off):
    a dispatch exceeding factor x rolling-p95 launches a hedge."""
    return max(0.0, _env_float("RAMBA_HEDGE_FACTOR", 0.0))


def breaker_threshold() -> int:
    return max(1, _env_int("RAMBA_BREAKER_THRESHOLD", 5))


def breaker_window_s() -> float:
    return max(0.001, _env_float("RAMBA_BREAKER_WINDOW_S", 30.0))


def breaker_cooldown_s() -> float:
    return max(0.001, _env_float("RAMBA_BREAKER_COOLDOWN_S", 5.0))


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------


class Deadline:
    """A request's time budget, minted at flush prepare.  Monotonic:
    wall-clock steps cannot expire (or resurrect) a request."""

    __slots__ = ("budget_ms", "born", "expires")

    def __init__(self, budget_ms: float, *, now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        self.budget_ms = float(budget_ms)
        self.born = now
        self.expires = now + self.budget_ms / 1000.0

    def remaining_s(self) -> float:
        return self.expires - time.monotonic()

    def elapsed_ms(self) -> float:
        return (time.monotonic() - self.born) * 1000.0

    def expired(self) -> bool:
        return time.monotonic() >= self.expires

    def __repr__(self):
        return (f"<Deadline budget={self.budget_ms:.0f}ms "
                f"remaining={self.remaining_s() * 1000.0:.0f}ms>")


def mint_deadline(deadline_ms: Optional[float]) -> Optional["Deadline"]:
    """Deadline for one flush: the explicit per-session budget, else the
    ``RAMBA_DEADLINE_MS`` default, else None (no deadline)."""
    ms = deadline_ms if deadline_ms is not None else default_deadline_ms()
    if ms is None or ms <= 0:
        return None
    return Deadline(ms)


def clamp_watchdog(watchdog_s: Optional[float],
                   deadline: Optional["Deadline"]) -> Optional[float]:
    """Effective per-attempt watchdog: ``min(watchdog, remaining)``.
    With a deadline but no watchdog, the remaining budget IS the
    deadline; floored at 1ms so an already-expired budget still raises
    through the watchdog path instead of passing 0 (= unarmed)."""
    if deadline is None:
        return watchdog_s
    rem = max(0.001, deadline.remaining_s())
    return rem if watchdog_s is None else min(watchdog_s, rem)


# ---------------------------------------------------------------------------
# CoDel-style sojourn control
# ---------------------------------------------------------------------------


class _CoDel:
    """Sojourn-time controller per tenant, CoDel-style: transient queue
    spikes pass untouched; a queue whose head sojourn stays above target
    for a full interval is in standing-queue territory and drops from
    the front until sojourn recovers."""

    __slots__ = ("first_above", "drops")

    def __init__(self):
        self.first_above: Optional[float] = None
        self.drops = 0

    def should_drop(self, sojourn_s: float, *, target_s: float,
                    interval_s: float,
                    now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        if sojourn_s < target_s:
            self.first_above = None
            return False
        if self.first_above is None:
            self.first_above = now + interval_s
            return False
        if now >= self.first_above:
            self.drops += 1
            return True
        return False


_codel_lock = threading.Lock()
_codels: dict = {}


def _codel_for(tenant: Optional[str]) -> _CoDel:
    key = tenant or "_anon"
    with _codel_lock:
        c = _codels.get(key)
        if c is None:
            c = _codels[key] = _CoDel()
        return c


# ---------------------------------------------------------------------------
# brownout state machine
# ---------------------------------------------------------------------------

GREEN, YELLOW, RED = "green", "yellow", "red"
_BROWNOUT_LEVEL = {GREEN: 0, YELLOW: 1, RED: 2}


class _Brownout:
    """green/yellow/red pressure ladder.  Yellow disables speculative
    work (autotune warm-ups); red additionally sheds non-priority
    tenants at admission.  Fed by three signals: fairness-queue depth
    vs its cap, memory-governor live bytes vs the eviction watermark,
    and the SLO breach latch."""

    __slots__ = ("state", "since", "transitions", "lock", "signals")

    def __init__(self):
        self.state = GREEN
        self.since = time.monotonic()
        self.transitions: dict = {}
        self.lock = threading.Lock()
        self.signals: dict = {}

    def update(self, *, queue_ratio: float, memory_frac: float,
               breached: bool) -> str:
        score = 0
        if queue_ratio >= 0.95:
            score += 2
        elif queue_ratio >= 0.5:
            score += 1
        if memory_frac >= 0.98:
            score += 2
        elif memory_frac >= 0.85:
            score += 1
        if breached:
            score += 1
        target = RED if score >= 2 else (YELLOW if score == 1 else GREEN)
        with self.lock:
            self.signals = {
                "queue_ratio": round(queue_ratio, 3),
                "memory_frac": round(memory_frac, 3),
                "slo_breached": breached,
            }
            if target == self.state:
                return target
            prev, self.state = self.state, target
            self.since = time.monotonic()
            key = f"{prev}->{target}"
            self.transitions[key] = self.transitions.get(key, 0) + 1
        _registry.inc(f"serve.brownout.{target}")
        _registry.gauge("serve.brownout_level", _BROWNOUT_LEVEL[target])
        _events.emit({"type": "brownout", "from": prev, "to": target,
                      **self.signals})
        return target


_brownout = _Brownout()


def brownout_state() -> str:
    return _brownout.state


def refresh_brownout(queue_depth: Optional[int] = None) -> str:
    """Recompute the brownout state from live signals (called on each
    submit).  ``queue_depth`` is the submitting tenant's own backlog
    (``serve/pipeline.py``)."""
    cap = queue_depth_cap()
    qr = (queue_depth / cap) if (queue_depth is not None and cap > 0) else 0.0
    mf = 0.0
    try:
        from ramba_tpu_torch.resilience import memory as _memory

        wm = _memory.watermark_bytes()
        if wm:
            mf = _memory.ledger.live_bytes / wm
    except Exception:
        pass
    breached = bool(_slo.breached_tenants())
    return _brownout.update(queue_ratio=qr, memory_frac=mf,
                            breached=breached)


def allow_speculative() -> bool:
    """False under yellow/red brownout: autotune races and warm-up work
    are the first load to shed."""
    return _brownout.state == GREEN


# ---------------------------------------------------------------------------
# per-tenant circuit breakers
# ---------------------------------------------------------------------------

CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
_BREAKER_LEVEL = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    """closed → open → half-open → closed, keyed on recent flush-error
    rate.  Open fails submissions fast; half-open admits exactly one
    probe flush whose outcome decides."""

    __slots__ = ("tenant", "state", "failures", "opened_at",
                 "probe_inflight", "trips", "lock")

    def __init__(self, tenant: str):
        self.tenant = tenant
        self.state = CLOSED
        self.failures: list = []  # monotonic timestamps inside the window
        self.opened_at: Optional[float] = None
        self.probe_inflight = False
        self.trips = 0
        self.lock = threading.Lock()

    def _transition(self, to: str, *, failures: int) -> None:
        prev, self.state = self.state, to
        _registry.inc(f"serve.breaker.{to}")
        _registry.gauge(f"serve.breaker_level.{self.tenant}",
                        _BREAKER_LEVEL[to])
        _events.emit({"type": "breaker", "tenant": self.tenant,
                      "action": to, "from": prev, "to": to,
                      "failures": failures})

    def admit(self, *, now: Optional[float] = None) -> None:
        """Raise :class:`CircuitOpenError` unless this submit may
        proceed.  O(ms): one lock, no prepare work behind it."""
        now = time.monotonic() if now is None else now
        with self.lock:
            if self.state == CLOSED:
                return
            if self.state == OPEN:
                cool = breaker_cooldown_s()
                if self.opened_at is not None and \
                        now - self.opened_at >= cool:
                    self._transition(HALF_OPEN, failures=len(self.failures))
                    self.probe_inflight = True
                    return  # this submit is the probe
                retry_after = None if self.opened_at is None else \
                    max(0.0, cool - (now - self.opened_at))
                _registry.inc("serve.breaker.fast_fail")
                raise CircuitOpenError(self.tenant, OPEN,
                                       retry_after_s=retry_after)
            # half-open: exactly one probe at a time
            if self.probe_inflight:
                _registry.inc("serve.breaker.fast_fail")
                raise CircuitOpenError(self.tenant, HALF_OPEN)
            self.probe_inflight = True

    def record(self, ok: bool, *, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self.lock:
            window = breaker_window_s()
            self.failures = [t for t in self.failures if now - t <= window]
            if ok:
                if self.state == HALF_OPEN:
                    self.probe_inflight = False
                    self.failures = []
                    self._transition(CLOSED, failures=0)
                return
            self.failures.append(now)
            if self.state == HALF_OPEN:
                # the probe failed: straight back to open
                self.probe_inflight = False
                self.opened_at = now
                self.trips += 1
                self._transition(OPEN, failures=len(self.failures))
                return
            if self.state == CLOSED and \
                    len(self.failures) >= breaker_threshold():
                self.opened_at = now
                self.trips += 1
                self._transition(OPEN, failures=len(self.failures))

    def snapshot(self) -> dict:
        with self.lock:
            return {"state": self.state, "trips": self.trips,
                    "recent_failures": len(self.failures)}


_breaker_lock = threading.Lock()
_breakers: dict = {}


def breaker_for(tenant: Optional[str]) -> CircuitBreaker:
    key = tenant or "_anon"
    with _breaker_lock:
        b = _breakers.get(key)
        if b is None:
            b = _breakers[key] = CircuitBreaker(key)
        return b


def record_outcome(tenant: Optional[str], ok: bool) -> None:
    """Feed one finished flush into the tenant's breaker.  Overload
    sheds must NOT be recorded as failures (a shed storm tripping
    breakers would be a positive feedback loop); the pipeline filters
    them before calling this."""
    breaker_for(tenant).record(ok)


# ---------------------------------------------------------------------------
# submit-side admission
# ---------------------------------------------------------------------------


def _shed_event(reason: str, stage: str, *, tenant: Optional[str],
                label: Optional[str] = None,
                epoch: Optional[int] = None, **extra) -> None:
    _registry.inc("serve.shed")
    _registry.inc(f"serve.shed.{reason}")
    if tenant is not None:
        _registry.inc(f"serve.tenant.{tenant}.shed")
    ev = {"type": "shed", "reason": reason, "stage": stage, **extra}
    if tenant is not None:
        ev["tenant"] = tenant
    if label is not None:
        ev["label"] = label
    if epoch is not None:
        ev["epoch"] = epoch
    _events.emit(ev)


def admit_submit(*, tenant: Optional[str], priority: bool = False,
                 queue_depth: Optional[int] = None) -> None:
    """Caller-thread admission gate, run BEFORE any prepare work so
    rejections cost O(ms): breaker fail-fast, then brownout-red
    shedding of non-priority tenants."""
    breaker_for(tenant).admit()
    state = refresh_brownout(queue_depth)
    if state == RED and not priority:
        _shed_event("brownout", "submit", tenant=tenant)
        raise ShedError("brownout", tenant=tenant)


# ---------------------------------------------------------------------------
# dispatch-side (coherent) shed verdict
# ---------------------------------------------------------------------------

#: agreement codes for the ``serve:shed`` site (severity max; any shed
#: proposal beats ADMIT fleet-wide)
ADMIT = 0
SHED_DEADLINE = 1
SHED_SOJOURN = 2
SHED_BROWNOUT = 3
SHED_FAULT = 4

_SHED_REASON = {SHED_DEADLINE: "deadline", SHED_SOJOURN: "sojourn",
                SHED_BROWNOUT: "brownout", SHED_FAULT: "fault"}


def _active(deadline: Optional["Deadline"]) -> bool:
    """Whether the dispatch verdict has anything to decide.  Must be
    rank-identical across ranks (it gates the agreement round): deadline
    presence, the sojourn env knob, and the *configured* fault plan all
    are — a ``rank=`` payload skews who proposes, never who votes."""
    return (deadline is not None or sojourn_target_ms() > 0
            or _faults.configured("serve:admit"))


def dispatch_verdict(*, deadline: Optional["Deadline"],
                     enqueued_at: Optional[float],
                     tenant: Optional[str], priority: bool,
                     label: str) -> None:
    """Shed-or-admit decision at the top of flush dispatch, before
    admission control and compile.  Raises a classified error on shed.

    Local proposal: injected ``serve:admit`` fault > brownout(red) >
    queue sojourn (CoDel) > expired deadline > admit.  Under engaged
    coherence the proposal runs through a ``serve:shed`` agreement
    round (severity max), so all ranks shed the identical request set
    on the same epoch, as every other recovery decision across ranks."""
    engaged = _coherence.engaged()
    if not _active(deadline):
        # nothing fleet-decidable; still honor a local red brownout
        # (single-controller only: a local signal must not desync ranks)
        if not engaged and _brownout.state == RED and not priority:
            _shed_event("brownout", "dispatch", tenant=tenant, label=label)
            raise ShedError("brownout", tenant=tenant)
        return
    code = ADMIT
    try:
        _faults.check("serve:admit", tenant=tenant or "")
    except _faults.InjectedFault:
        code = SHED_FAULT
    if code == ADMIT and deadline is not None and deadline.expired():
        code = SHED_DEADLINE
    target = sojourn_target_ms()
    if code == ADMIT and target > 0 and enqueued_at is not None:
        sojourn = time.perf_counter() - enqueued_at
        if _codel_for(tenant).should_drop(
                sojourn, target_s=target / 1000.0,
                interval_s=sojourn_interval_ms() / 1000.0):
            code = SHED_SOJOURN
    if code == ADMIT and _brownout.state == RED and not priority:
        code = SHED_BROWNOUT
    epoch = None
    decision = code
    if engaged:
        decision = _coherence.agree("serve:shed", code, reduce="max")
        epoch = _coherence.last_epoch("serve:shed")
    if decision == ADMIT:
        return
    reason = _SHED_REASON.get(decision, "shed")
    _shed_event(reason, "dispatch", tenant=tenant, label=label, epoch=epoch)
    if decision == SHED_DEADLINE:
        raise DeadlineExceededError(
            f"deadline exceeded before dispatch of {label!r}"
            + (f" (budget {deadline.budget_ms:.0f}ms)" if deadline else ""),
            tenant=tenant,
            budget_ms=deadline.budget_ms if deadline else None,
            elapsed_ms=deadline.elapsed_ms() if deadline else None,
            stage="dispatch")
    raise ShedError(reason, tenant=tenant, epoch=epoch)


# ---------------------------------------------------------------------------
# deadline-aware ladder support
# ---------------------------------------------------------------------------


def prune_rungs(rungs: list, deadline: Optional["Deadline"],
                label: str, *, tenant: Optional[str] = None) -> list:
    """Drop ladder rungs whose rolling p50 (per label+rung flush-wall
    window in the kernel cost ledger) cannot fit the remaining budget.
    Returns the surviving ``(name, thunk)`` list; raises a classified
    :class:`DeadlineExceededError` when nothing fits.

    Disabled under engaged coherence: rolling windows are rank-local,
    and a rank-skewed rung list is exactly the divergence the coherent
    ladder exists to prevent (the in-attempt deadline check still runs
    and aborts coherently)."""
    if deadline is None or _coherence.engaged():
        return rungs
    remaining = deadline.remaining_s()
    kept = []
    for name, thunk in rungs:
        p50 = _ledger.rung_quantile(label, name, 0.50)
        if p50 is not None and p50 > remaining:
            _registry.inc("serve.deadline_rung_skips")
            _events.emit({"type": "degrade", "site": "flush",
                          "action": "skip", "rung": name,
                          "reason": "deadline", "p50_s": round(p50, 6),
                          "remaining_s": round(remaining, 6),
                          **({"tenant": tenant} if tenant else {})})
            continue
        kept.append((name, thunk))
    if kept:
        return kept
    _shed_event("deadline", "ladder", tenant=tenant, label=label)
    raise DeadlineExceededError(
        f"no ladder rung of {label!r} fits the remaining "
        f"{remaining * 1000.0:.1f}ms budget",
        tenant=tenant, budget_ms=deadline.budget_ms,
        elapsed_ms=deadline.elapsed_ms(), stage="ladder")


def check_expired(deadline: Optional["Deadline"], label: str, *,
                  tenant: Optional[str] = None,
                  stage: str = "ladder") -> None:
    """In-attempt deadline check (run at the top of every rung attempt).
    Classified fatal, so the ladder surfaces it immediately — and under
    engaged coherence the fatal class rides the normal ``flush:rung``
    agreement, aborting every rank identically."""
    if deadline is None or not deadline.expired():
        return
    _shed_event("deadline", stage, tenant=tenant, label=label)
    raise DeadlineExceededError(
        f"deadline exceeded during {stage} of {label!r}",
        tenant=tenant, budget_ms=deadline.budget_ms,
        elapsed_ms=deadline.elapsed_ms(), stage=stage)


# ---------------------------------------------------------------------------
# hedged dispatch
# ---------------------------------------------------------------------------


#: Ops whose generic lowering may not give the same bytes twice on the
#: card: the segment reduction (scatters with atomics), a scatter whose
#: duplicate indices have no fixed winner, the extras' library calls,
#: and cuBLAS products (whose algorithm may differ on another stream).
#: A program holding one is never hedged unless the hand kernels take it.
NONDETERMINISTIC_OPS = frozenset({
    "segment_reduce", "setitem_adv", "call", "matmul", "dot", "tensordot",
    "einsum",
})


def deterministic(program, leaf_vals=None) -> bool:
    """Whether two runs of ``program`` give the same bytes: the hand
    kernels (``ops/kernel_backend``) fold in a fixed order, and the
    generic lowering does too unless an op of
    :data:`NONDETERMINISTIC_OPS` uses atomics."""
    if not any(op in NONDETERMINISTIC_OPS for op, _st, _a in program.instrs):
        return True
    if leaf_vals is None:
        return False
    try:
        from ramba_tpu_torch.ops import kernel_backend

        return bool(kernel_backend.supports(program, leaf_vals))
    except Exception:
        return False


def hedge_threshold(label: str, program, donate_key,
                    leaf_vals=None) -> Optional[float]:
    """Seconds after which a dispatch of this program should hedge, or
    None when hedging must not apply: factor off, ranks engaged (a
    second execution desyncs collectives), donation present (the hedge
    would read buffers the primary consumes), not effect-certified
    pure, a lowering that is not bitwise-reproducible
    (:func:`deterministic`), or no rolling-p95 history yet."""
    factor = hedge_factor()
    if factor <= 0 or _coherence.engaged() or donate_key:
        return None
    try:
        from ramba_tpu_torch.analyze import effects as _effects

        rep = _effects.classify_program(program, tuple(donate_key))
    except Exception:
        return None
    if rep.program_class != "pure" or rep.alias_outs \
            or not deterministic(program, leaf_vals):
        _registry.inc("serve.hedge.ineligible")
        return None
    p95 = _ledger.flush_quantile(label, 0.95)
    if p95 is None or p95 <= 0:
        return None
    return factor * p95


def _on_card(leaf_vals):
    """The CUDA device of the first card tensor among ``leaf_vals``."""
    import torch

    for v in leaf_vals or ():
        if isinstance(v, torch.Tensor) and v.device.type == "cuda":
            return v.device
    return None


def run_hedged(execute: Callable[[dict], tuple], threshold_s: float, *,
               span: dict, label: str, tenant: Optional[str] = None,
               leaf_vals=None):
    """Race a primary and (past ``threshold_s``) a hedge attempt of one
    effect-certified-pure dispatch.  ``execute(private_span)`` runs the
    full resilient execution and returns ``(outs, rung)``; each attempt
    gets a private span copy (merged back from the winner) so a
    still-running loser cannot race span finalization.  The first
    attempt to finish wins — byte-identical either way, that is what
    the purity certificate and :func:`deterministic` are for — and the
    loser's elastic cancel-flag is set so its remaining rung attempts
    refuse to run.

    On the card each attempt launches on a ``torch.cuda.Stream`` of its
    own (on the caller's stream a hedge would only queue behind the
    primary), carrying the caller's device and mesh scopes.  The leaves
    are marked in use on both attempt streams (``record_stream``), the
    winner's outputs are joined to the caller's stream by an event wait
    and marked in use there, so the caching allocator reuses nothing
    early.  A loser's launched kernels cannot be stopped: they run to
    their end, their outputs are dropped, and the cancel flag stops the
    loser's later rung attempts.

    The primary checks the ``serve:hedge`` fault site, so
    ``RAMBA_FAULTS='serve:hedge:delay:ms=200'`` seeds a deterministic
    hedge race without perturbing results."""
    import torch

    from ramba_tpu_torch import common as _common
    from ramba_tpu_torch.parallel import mesh as _mesh
    from ramba_tpu_torch.resilience import elastic as _elastic

    cond = threading.Condition()
    results: list = []  # (who, (outs, rung) | None, exc | None, span, event)
    dev = _on_card(leaf_vals)
    caller_dev, caller_mesh, _stream = _elastic._thread_state()
    caller_stream = torch.cuda.current_stream(dev) if dev is not None \
        else None

    def _spawn(who: str):
        private = dict(span)
        private["calls"] = []
        private["stages"] = dict(span.get("stages") or {})
        cancel = threading.Event()
        ctx = contextvars.copy_context()
        side = None
        if dev is not None:
            side = torch.cuda.Stream(dev)
            side.wait_stream(caller_stream)  # the leaves are written
            for v in leaf_vals:
                if isinstance(v, torch.Tensor) and v.device == dev:
                    v.record_stream(side)

        def run():
            _common._scope.device = caller_dev
            _mesh._scope.mesh = caller_mesh
            try:
                def inner():
                    _elastic._cancel_var.set(cancel)
                    if who == "primary":
                        _faults.check("serve:hedge", label=label)
                    if side is None:
                        return execute(private), None
                    with torch.cuda.stream(side):
                        out = execute(private)
                        done = torch.cuda.Event()
                        done.record(side)
                    return out, done

                out, done = ctx.run(inner)
                with cond:
                    results.append((who, out, None, private, done))
                    cond.notify_all()
            except BaseException as e:  # noqa: BLE001 — re-raised by winner
                with cond:
                    results.append((who, None, e, private, None))
                    cond.notify_all()

        th = threading.Thread(target=run, name=f"ramba-hedge-{who}",
                              daemon=True)
        th.start()
        return cancel

    t0 = time.perf_counter()
    cancels = {"primary": _spawn("primary")}
    with cond:
        cond.wait_for(lambda: results, timeout=threshold_s)
        fired = not results
    if fired:
        waited_ms = (time.perf_counter() - t0) * 1000.0
        _registry.inc("serve.hedge.fired")
        ev = {"type": "hedge", "action": "fired", "label": label,
              "threshold_ms": round(threshold_s * 1000.0, 3),
              "waited_ms": round(waited_ms, 3)}
        if tenant is not None:
            ev["tenant"] = tenant
        _events.emit(ev)
        cancels["hedge"] = _spawn("hedge")
    with cond:
        if not cond.wait_for(lambda: results, timeout=600.0):
            raise RuntimeError(f"hedged dispatch of {label!r} produced no "
                               "result within 600s")
        who, out, exc, private, done = results[0]
    # cancel the loser: its in-flight kernel finishes but any further
    # rung attempt sees the flag and refuses (the zombie-rung pattern)
    for name, cancel in cancels.items():
        if name != who:
            cancel.set()
    if done is not None:
        caller_stream.wait_event(done)
        for o in out[0]:
            if isinstance(o, torch.Tensor) and o.device == dev:
                o.record_stream(caller_stream)
    if fired:
        _registry.inc(f"serve.hedge.won_{who}")
        ev = {"type": "hedge", "action": "resolved", "label": label,
              "winner": who,
              "wall_ms": round((time.perf_counter() - t0) * 1000.0, 3)}
        if tenant is not None:
            ev["tenant"] = tenant
        _events.emit(ev)
    span.update(private)
    if exc is not None:
        raise exc
    return out


# ---------------------------------------------------------------------------
# reporting / reset
# ---------------------------------------------------------------------------


def health_signals() -> dict:
    """Compact liveness-relevant slice of the overload plane — what the
    fleet's snapshot spool publishes every interval and its collector's
    replica health model classifies on (``observe/fleet.py``).  Deliberately
    tiny and always present (unlike the quiet-when-idle ``overload``
    section of ``diagnostics.snapshot()``): a router polling fleet
    health must see ``brownout == "green"`` as a positive signal, not
    infer it from an absent key."""
    with _brownout.lock:
        state = _brownout.state
    with _breaker_lock:
        snaps = {t: b.snapshot() for t, b in _breakers.items()}
    return {
        "brownout": state,
        "open_breakers": sorted(t for t, s in snaps.items()
                                if s["state"] == "open"),
        "breaker_trips": sum(s["trips"] for s in snaps.values()),
        "shed_total": _registry.get("serve.shed"),
    }


def admission_verdict(tenant: Optional[str] = None) -> dict:
    """Would a submit for ``tenant`` be admitted right now?  The
    fleet's replica server (``fleet/replica.py``) answers router pings
    with this so the router can redirect *before* sending work, not just
    after a refusal.  Read-only: unlike :func:`admit_submit` it never
    transitions a breaker to half-open or burns its probe slot —
    routing probes must not perturb the admission state they observe."""
    with _brownout.lock:
        brown = _brownout.state
    with _breaker_lock:
        snaps = {t: b.snapshot() for t, b in _breakers.items()}
    reasons = []
    if brown == RED:
        reasons.append("brownout_red")
    breaker = None
    if tenant is not None:
        snap = snaps.get(tenant)
        breaker = snap["state"] if snap else CLOSED
        if breaker == OPEN:
            reasons.append("breaker_open")
    open_breakers = sorted(t for t, s in snaps.items()
                           if s["state"] == OPEN)
    return {
        "accepting": not reasons,
        "reasons": reasons,
        "brownout": brown,
        "breaker": breaker,
        "open_breakers": open_breakers,
    }


def report() -> dict:
    """Machine-readable overload rollup for diagnostics: brownout state
    + transitions, per-tenant breaker states, shed/hedge counters."""
    with _brownout.lock:
        brown = {
            "state": _brownout.state,
            "since_s": round(time.monotonic() - _brownout.since, 3),
            "transitions": dict(_brownout.transitions),
            "signals": dict(_brownout.signals),
        }
    with _breaker_lock:
        breakers = {t: b.snapshot() for t, b in _breakers.items()}
    shed = {k[len("serve.shed."):]: v
            for k, v in _registry.prefixed("serve.shed.").items()}
    hedge = {k[len("serve.hedge."):]: v
             for k, v in _registry.prefixed("serve.hedge.").items()}
    with _codel_lock:
        codel_drops = sum(c.drops for c in _codels.values())
    return {
        "brownout": brown,
        "breakers": breakers,
        "shed_total": _registry.get("serve.shed"),
        "shed": shed,
        "codel_drops": codel_drops,
        "hedge": hedge,
        "deadline_rung_skips": _registry.get("serve.deadline_rung_skips"),
        "queue_depth_cap": queue_depth_cap(),
        "sojourn_target_ms": sojourn_target_ms(),
        "hedge_factor": hedge_factor(),
    }


def reset() -> None:
    """Forget all breaker/brownout/CoDel state (tests)."""
    global _brownout
    with _breaker_lock:
        _breakers.clear()
    with _codel_lock:
        _codels.clear()
    _brownout = _Brownout()
