"""Tenant router: spread sessions across replicas, redirect, hedge, heal.

Counterpart of ``ramba_tpu/fleet/router.py``, the fleet's front door.  N
replica processes (``fleet/replica.py``) serve tenant sessions; the
router decides which replica serves whom from three inputs:

* **The snapshot spool as the health feed.**  ``observe.fleet.poll()``,
  the collector's load-and-classify pass, gives each replica's
  healthy/degraded/stale/dead verdict and signals; the
  ``signals.endpoint`` key joins a spool document to the connection it
  describes.  The router has no health semantics of its own.
* **Fleet-level circuit breakers.**  One ``overload.CircuitBreaker`` per
  replica, fed by transport failures only.  A refusal (a replica's own
  breaker, brownout or queue saying no) never feeds it: the refusal is
  the replica's overload plane working.
* **Tenant affinity by rendezvous hash.**  ``hash(tenant, endpoint)``
  ranks every replica for a tenant; a session lands on the best-ranked
  healthy one, and when a replica dies only its tenants move.

Failure handling mirrors ``retry.classify``'s ``redirect`` rung
(retryable elsewhere):

1. **Refusal** (a ``{"refused": ...}`` reply): :class:`ReplicaRefusal`,
   classified ``redirect``; the session heals onto the next healthy
   replica and the step is re-sent.  The tenant never sees it.
2. **Unavailability** (connect/send/recv/timeout failure): the same
   redirect, and the fleet breaker records the failure, so a dying
   replica is excluded after a few strikes.
3. **Heal by replay.**  Sessions are deterministic step logs; healing
   onto a survivor replays the log there, with the same bytes (the
   workloads are deterministic; the shared artifact tier makes the replay
   warm).

**Replica-level hedging** (``RAMBA_ROUTER_HEDGE=1``): the router keeps a
standby replica per session.  Mutating steps mirror to it after the
primary acks; a step that is pure (``replica.workload_pure``) and
reproducible (``replica.workload_reproducible``: the port's rule of
kernel-level hedging, ``overload.deterministic``) races primary against
standby once the primary exceeds ``RAMBA_ROUTER_HEDGE_FACTOR`` x its
rolling p95.  The first reply wins, with the same bytes either way.  The
standby doubles as failover: a SIGKILLed primary heals by promotion
instead of replay.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from collections import deque
from multiprocessing.connection import Client
from typing import Dict, List, Optional

from ramba_tpu_torch.fleet import migrate as _migrate
from ramba_tpu_torch.fleet import replica as _replica_mod
from ramba_tpu_torch.observe import events as _events
from ramba_tpu_torch.observe import fleet as _fleet
from ramba_tpu_torch.observe import registry as _registry
from ramba_tpu_torch.observe import telemetry as _telemetry
from ramba_tpu_torch.serve import overload as _overload


class FleetError(RuntimeError):
    """Base class for router-level failures."""


class ReplicaRefusal(FleetError):
    """A replica's overload plane said no (breaker / brownout / queue /
    injected fault).  ``redirect_classification`` routes this to
    ``retry.classify`` → ``"redirect"``: retryable elsewhere."""

    redirect_classification = "refusal"

    def __init__(self, endpoint: str, refusal: dict):
        super().__init__(
            f"replica {endpoint} refused: {refusal.get('error')} "
            f"({refusal.get('classification')}) — {refusal.get('message')}")
        self.endpoint = endpoint
        self.refusal = refusal


class ReplicaUnavailable(FleetError):
    """Transport-level failure (connect/send/recv/timeout): the replica
    is unreachable or dead.  Also a redirect — but THIS failure feeds
    the fleet breaker."""

    redirect_classification = "unavailable"

    def __init__(self, endpoint: str, cause: str):
        super().__init__(f"replica {endpoint} unavailable: {cause}")
        self.endpoint = endpoint
        self.cause = cause


class NoHealthyReplica(FleetError):
    """The redirect chain exhausted every candidate.  Terminal — there
    is no ``redirect_classification``; nowhere is left to redirect to."""


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def router_timeout_s() -> float:
    return max(0.1, _env_float("RAMBA_ROUTER_TIMEOUT_S", 30.0))


def hedge_enabled() -> bool:
    raw = (os.environ.get("RAMBA_ROUTER_HEDGE") or "").strip().lower()
    return raw not in ("", "0", "off", "false", "no")


def hedge_factor() -> float:
    return max(0.0, _env_float("RAMBA_ROUTER_HEDGE_FACTOR", 3.0))


def max_redirects() -> int:
    try:
        return max(1, int(os.environ.get("RAMBA_ROUTER_MAX_REDIRECTS",
                                         "") or 4))
    except ValueError:
        return 4


class _Replica:
    """Router-side view of one replica: its connection, its fleet-level
    breaker, and the last health verdict the spool gave it."""

    def __init__(self, endpoint: str):
        self.endpoint = endpoint
        self.replica_id: Optional[str] = None
        self.state = _fleet.HEALTHY  # bootstrap optimism until the spool says otherwise
        self.reason = "explicit endpoint (no spool snapshot yet)"
        self.signals: dict = {}
        self.conn = None
        self.lock = threading.RLock()
        self.breaker = _overload.CircuitBreaker(f"replica:{endpoint}")

    def close(self) -> None:
        with self.lock:
            if self.conn is not None:
                try:
                    self.conn.close()
                except OSError:
                    pass
                self.conn = None

class Router:
    """The fleet front door.  Thread-compatible: a lock guards the
    replica and session tables; per-replica connections serialize on
    their own locks."""

    def __init__(self, fleet_dir: Optional[str] = None,
                 endpoints: Optional[List[str]] = None):
        self.fleet_dir = fleet_dir or _fleet.fleet_dir()
        self._replicas: Dict[str, _Replica] = {}
        self._sessions: Dict[str, dict] = {}
        self._lock = threading.RLock()
        self._last_poll = 0.0
        self._latency: Dict[str, deque] = {}  # workload -> recent seconds
        for ep in endpoints or []:
            self._replicas[ep] = _Replica(ep)
        self.refresh(force=True)

    # -- health feed -------------------------------------------------------

    def refresh(self, force: bool = False) -> None:
        """Fold the latest ``fleet.poll()`` verdicts into the replica
        table (rate-limited to one spool read per second unless
        forced).  Replicas are discovered by the ``signals.endpoint``
        key their spool snapshots carry."""
        now = time.monotonic()
        with self._lock:
            if not force and now - self._last_poll < 1.0:
                return
            self._last_poll = now
        if self.fleet_dir is None:
            return
        polled = _fleet.poll(self.fleet_dir)
        with self._lock:
            for rid, row in polled["health"]["replicas"].items():
                sig = row.get("signals") or {}
                ep = sig.get("endpoint")
                if not ep:
                    continue
                rep = self._replicas.get(ep)
                if rep is None:
                    rep = self._replicas[ep] = _Replica(ep)
                rep.replica_id = rid
                rep.state = row["state"]
                rep.reason = row["reason"]
                rep.signals = sig

    # -- placement ---------------------------------------------------------

    @staticmethod
    def _affinity(tenant: Optional[str], endpoint: str) -> int:
        h = hashlib.sha256(f"{tenant or ''}|{endpoint}".encode())
        return int.from_bytes(h.digest()[:8], "big")

    def candidates(self, tenant: Optional[str],
                   exclude: Optional[set] = None) -> List[_Replica]:
        """Rendezvous-ranked serviceable replicas for one tenant:
        healthy first, then degraded (a degraded replica still serves —
        its own overload plane will refuse if it must), never
        stale/dead, never excluded, never breaker-open (unless the
        breaker admits a half-open probe, decided at call time)."""
        self.refresh()
        exclude = exclude or set()
        with self._lock:
            reps = [r for r in self._replicas.values()
                    if r.endpoint not in exclude
                    and r.state in (_fleet.HEALTHY, _fleet.DEGRADED)]
        reps.sort(key=lambda r: (r.state != _fleet.HEALTHY,
                                 -self._affinity(tenant, r.endpoint)))
        return reps

    # -- events / metrics --------------------------------------------------

    def _emit_redirect(self, *, sid: str, tenant: Optional[str],
                       trace_id: Optional[str], src: Optional[str],
                       dst: Optional[str], reason: str,
                       classification: str) -> None:
        _registry.inc("router.redirects")
        _registry.inc(f"router.redirect.{classification}")
        _events.emit({"type": "redirect", "sid": sid, "tenant": tenant,
                      "trace_id": trace_id, "from": src, "to": dst,
                      "reason": reason, "classification": classification})

    # -- transport ---------------------------------------------------------

    def _call(self, rep: _Replica, msg: dict,
              timeout_s: Optional[float] = None) -> dict:
        """Request/reply with fleet-breaker accounting: transport
        failures feed the breaker and raise :class:`ReplicaUnavailable`;
        refusal replies raise :class:`ReplicaRefusal` WITHOUT feeding it
        (sheds never feed back)."""
        timeout_s = timeout_s if timeout_s is not None else router_timeout_s()
        try:
            with rep.lock:
                if rep.conn is None:
                    rep.conn = Client(
                        _replica_mod.parse_endpoint(rep.endpoint),
                        authkey=_replica_mod.authkey())
                rep.conn.send(msg)
                if not rep.conn.poll(timeout_s):
                    raise TimeoutError(f"no reply within {timeout_s:g}s")
                reply = rep.conn.recv()
        except Exception as e:  # noqa: BLE001 — all transport shapes
            rep.close()
            rep.breaker.record(False)
            raise ReplicaUnavailable(rep.endpoint,
                                     f"{type(e).__name__}: {e}") from e
        if isinstance(reply, dict) and reply.get("refused"):
            raise ReplicaRefusal(rep.endpoint, reply["refused"])
        if isinstance(reply, dict) and reply.get("error"):
            err = reply["error"]
            rep.breaker.record(True)  # the replica is alive and talking
            raise FleetError(f"replica {rep.endpoint} error: "
                             f"{err.get('type')}: {err.get('message')}")
        rep.breaker.record(True)
        return reply

    # -- sessions ----------------------------------------------------------

    def open_session(self, tenant: Optional[str] = None,
                     sid: Optional[str] = None,
                     trace_id: Optional[str] = None) -> str:
        """Place a new tenant session on the best-ranked serviceable
        replica (with a standby when hedging is armed)."""
        sid = sid or _telemetry.mint_id()
        entry = {"sid": sid, "tenant": tenant, "trace_id": trace_id,
                 "endpoint": None, "standby": None, "log": [], "seq": 0}
        last: Optional[BaseException] = None
        for rep in self.candidates(tenant):
            try:
                rep.breaker.admit()
            except _overload.CircuitOpenError:
                continue
            try:
                reply = self._call(rep, {"op": "open", "sid": sid,
                                         "tenant": tenant,
                                         "trace_id": trace_id})
            except (ReplicaRefusal, ReplicaUnavailable) as e:
                last = e
                continue
            entry["endpoint"] = rep.endpoint
            entry["trace_id"] = reply.get("trace_id") or trace_id
            break
        if entry["endpoint"] is None:
            raise NoHealthyReplica(
                f"no replica could open a session for tenant {tenant!r}"
                + (f" (last: {last})" if last else ""))
        with self._lock:
            self._sessions[sid] = entry
        _registry.inc("router.sessions_opened")
        if hedge_enabled():
            self._ensure_standby(entry)
        return sid

    def _ensure_standby(self, entry: dict) -> None:
        """Open (and catch up) a standby session on the next-ranked
        replica.  Best-effort: no standby is a degraded mode, not an
        error."""
        primary = entry["endpoint"]
        for rep in self.candidates(entry["tenant"], exclude={primary}):
            try:
                rep.breaker.admit()
                self._call(rep, {"op": "open", "sid": entry["sid"],
                                 "tenant": entry["tenant"],
                                 "trace_id": entry["trace_id"]})
                for workload, params in entry["log"]:
                    self._call(rep, {"op": "step", "sid": entry["sid"],
                                     "workload": workload,
                                     "params": params})
                entry["standby"] = rep.endpoint
                _registry.inc("router.standbys_opened")
                return
            except (FleetError, _overload.CircuitOpenError):
                continue
        entry["standby"] = None

    def _session(self, sid: str) -> dict:
        with self._lock:
            entry = self._sessions.get(sid)
        if entry is None:
            raise KeyError(f"unknown session {sid!r}")
        return entry

    def _replica(self, endpoint: str) -> _Replica:
        with self._lock:
            rep = self._replicas.get(endpoint)
            if rep is None:
                rep = self._replicas[endpoint] = _Replica(endpoint)
            return rep

    # -- heal --------------------------------------------------------------

    def _heal(self, entry: dict, exclude: set, reason: str) -> _Replica:
        """Move a session to a survivor: promote the standby when one
        exists (already caught up — instant), else replay the
        deterministic step log on the best candidate.  Raises
        :class:`NoHealthyReplica` when the chain is exhausted."""
        t0 = time.perf_counter()
        src = entry["endpoint"]
        # standby promotion: the hedge pair doubles as a hot spare
        standby = entry.get("standby")
        if standby and standby not in exclude:
            rep = self._replica(standby)
            entry["endpoint"], entry["standby"] = standby, None
            _registry.inc("router.heals")
            _registry.inc("router.heal.promoted")
            _events.emit({"type": "heal", "sid": entry["sid"],
                          "tenant": entry["tenant"],
                          "trace_id": entry["trace_id"],
                          "from": src, "to": standby, "how": "promote",
                          "reason": reason, "steps_replayed": 0,
                          "wall_ms": round(
                              (time.perf_counter() - t0) * 1e3, 2)})
            if hedge_enabled():
                self._ensure_standby(entry)
            return rep
        last: Optional[BaseException] = None
        for rep in self.candidates(entry["tenant"], exclude=exclude):
            try:
                rep.breaker.admit()
            except _overload.CircuitOpenError:
                continue
            try:
                self._call(rep, {"op": "open", "sid": entry["sid"],
                                 "tenant": entry["tenant"],
                                 "trace_id": entry["trace_id"]})
                for workload, params in entry["log"]:
                    self._call(rep, {"op": "step", "sid": entry["sid"],
                                     "workload": workload,
                                     "params": params})
            except (ReplicaRefusal, ReplicaUnavailable) as e:
                last = e
                exclude = exclude | {rep.endpoint}
                continue
            entry["endpoint"] = rep.endpoint
            if entry.get("standby") == rep.endpoint:
                entry["standby"] = None
            _registry.inc("router.heals")
            _registry.inc("router.heal.replayed")
            _events.emit({"type": "heal", "sid": entry["sid"],
                          "tenant": entry["tenant"],
                          "trace_id": entry["trace_id"],
                          "from": src, "to": rep.endpoint, "how": "replay",
                          "reason": reason,
                          "steps_replayed": len(entry["log"]),
                          "wall_ms": round(
                              (time.perf_counter() - t0) * 1e3, 2)})
            if hedge_enabled():
                self._ensure_standby(entry)
            return rep
        raise NoHealthyReplica(
            f"session {entry['sid']!r} cannot heal: no serviceable "
            f"replica left" + (f" (last: {last})" if last else ""))

    # -- steps -------------------------------------------------------------

    def step(self, sid: str, workload: str, params: Optional[dict] = None,
             priority: bool = False) -> dict:
        """Run one deterministic workload step on the session's replica,
        redirecting on refusal/unavailability and hedging pure steps.
        Returns the replica's reply (``result``, ``seq``, ``replica``,
        ``trace_id``)."""
        entry = self._session(sid)
        params = dict(params or {})
        exclude: set = set()
        last: Optional[BaseException] = None
        for _ in range(max_redirects() + 1):
            endpoint = entry["endpoint"]
            if endpoint is None or endpoint in exclude:
                rep = self._heal(entry, exclude, reason=(
                    "unplaced" if endpoint is None else
                    getattr(last, "redirect_classification", "redirect")))
            else:
                rep = self._replica(endpoint)
            msg = {"op": "step", "sid": sid, "workload": workload,
                   "params": params, "priority": priority}
            try:
                rep.breaker.admit()
                t0 = time.perf_counter()
                reply = self._dispatch_step(rep, entry, msg)
                self._note_latency(workload, time.perf_counter() - t0)
            except (ReplicaRefusal, ReplicaUnavailable,
                    _overload.CircuitOpenError) as e:
                from ramba_tpu_torch.resilience import retry as _retry

                last = e
                exclude.add(rep.endpoint)
                cls = (_retry.classify(e)
                       if not isinstance(e, _overload.CircuitOpenError)
                       else "redirect")
                self._emit_redirect(
                    sid=sid, tenant=entry["tenant"],
                    trace_id=entry["trace_id"], src=rep.endpoint, dst=None,
                    reason=getattr(e, "redirect_classification",
                                   "fleet_breaker"),
                    classification=cls)
                continue
            entry["log"].append((workload, params))
            entry["seq"] = reply.get("seq", entry["seq"] + 1)
            _registry.inc("router.steps")
            self._mirror_to_standby(entry, workload, params)
            return reply
        raise NoHealthyReplica(
            f"step {workload!r} of session {sid!r} exhausted the redirect "
            f"chain ({sorted(exclude)})" + (f"; last: {last}" if last else ""))

    def _dispatch_step(self, rep: _Replica, entry: dict,
                       msg: dict) -> dict:
        """Primary dispatch, racing a standby hedge for pure workloads
        once the primary exceeds hedge_factor × rolling p95."""
        threshold_s = self._hedge_threshold(entry, msg["workload"])
        if threshold_s is None:
            return self._call(rep, msg)
        standby = self._replica(entry["standby"])
        result: list = []
        cond = threading.Condition()

        def attempt(target: _Replica, who: str):
            try:
                out = self._call(target, msg)
                with cond:
                    result.append((who, out, None))
                    cond.notify_all()
            except BaseException as e:  # noqa: BLE001 — loser may fail
                with cond:
                    result.append((who, None, e))
                    cond.notify_all()

        threading.Thread(target=attempt, args=(rep, "primary"),
                         name="ramba-router-primary", daemon=True).start()
        with cond:
            cond.wait_for(lambda: result, timeout=threshold_s)
            fired = not result
        if fired:
            _registry.inc("router.hedges_fired")
            _events.emit({"type": "hedge", "action": "fired",
                          "level": "replica", "label": msg["workload"],
                          "sid": entry["sid"], "tenant": entry["tenant"],
                          "threshold_ms": round(threshold_s * 1e3, 3)})
            threading.Thread(target=attempt, args=(standby, "hedge"),
                             name="ramba-router-hedge", daemon=True).start()
        deadline = time.monotonic() + router_timeout_s()
        with cond:
            while True:
                done = {who for who, _o, _e in result}
                expected = {"primary", "hedge"} if fired else {"primary"}
                wins = [(who, out) for who, out, exc in result
                        if exc is None]
                if wins:
                    who, out = wins[0]
                    break
                if done >= expected:
                    # every attempt failed: surface the primary's error
                    for w, _out, exc in result:
                        if w == "primary":
                            raise exc
                    raise result[0][2]
                if not cond.wait(timeout=max(0.0,
                                             deadline - time.monotonic())):
                    raise ReplicaUnavailable(
                        rep.endpoint, "hedged dispatch timed out")
        if fired:
            _registry.inc(f"router.hedge_won_{who}")
            _events.emit({"type": "hedge", "action": "resolved",
                          "level": "replica", "label": msg["workload"],
                          "sid": entry["sid"], "winner": who})
        return out

    def _hedge_threshold(self, entry: dict,
                         workload: str) -> Optional[float]:
        if not hedge_enabled() or not entry.get("standby"):
            return None
        if not (_replica_mod.workload_pure(workload)
                and _replica_mod.workload_reproducible(workload)):
            return None
        factor = hedge_factor()
        if factor <= 0:
            return None
        with self._lock:
            samples = sorted(self._latency.get(workload, ()))
        if len(samples) < 5:
            return None
        p95 = samples[min(len(samples) - 1, int(0.95 * len(samples)))]
        return max(1e-4, factor * p95)

    def _note_latency(self, workload: str, seconds: float) -> None:
        with self._lock:
            dq = self._latency.setdefault(workload, deque(maxlen=64))
            dq.append(seconds)

    def _mirror_to_standby(self, entry: dict, workload: str,
                           params: dict) -> None:
        """Keep the hot spare caught up: mutating steps re-run on the
        standby after the primary acks (pure steps change nothing, so
        mirroring them would only burn standby cycles).  A failed
        mirror drops the standby; the next step re-establishes one."""
        standby = entry.get("standby")
        if not standby or _replica_mod.workload_pure(workload):
            return
        try:
            self._call(self._replica(standby),
                       {"op": "step", "sid": entry["sid"],
                        "workload": workload, "params": params})
        except FleetError:
            entry["standby"] = None
            _registry.inc("router.standbys_dropped")

    # -- migration / rebalance --------------------------------------------

    def migrate_session(self, sid: str, target_endpoint: str) -> dict:
        """Graceful handoff: drain + checkpoint on the current replica
        (``fleet/migrate.py``), adopt on the target, then discard the
        handoff.  Zero recompute — the arrays move, not the history."""
        entry = self._session(sid)
        src = self._replica(entry["endpoint"])
        dst = self._replica(target_endpoint)
        t0 = time.perf_counter()
        self._call(src, {"op": "drain", "sid": sid})
        try:
            reply = self._call(dst, {"op": "adopt", "sid": sid})
        except FleetError:
            # adoption failed: the handoff stays on disk for a retry
            entry["endpoint"] = None
            raise
        entry["endpoint"] = target_endpoint
        if entry.get("standby") == target_endpoint:
            entry["standby"] = None
        _migrate.discard(sid)
        _registry.inc("router.migrations")
        _events.emit({"type": "migrate", "action": "routed", "sid": sid,
                      "tenant": entry["tenant"],
                      "trace_id": entry["trace_id"],
                      "from": src.endpoint, "to": target_endpoint,
                      "wall_ms": round((time.perf_counter() - t0) * 1e3, 2)})
        return reply

    def rebalance(self) -> List[dict]:
        """Move every session off degraded replicas onto healthy ones
        (the router-driven use of session migration).  Returns one
        record per attempted move."""
        self.refresh(force=True)
        moves = []
        with self._lock:
            sessions = list(self._sessions.values())
            states = {ep: r.state for ep, r in self._replicas.items()}
        for entry in sessions:
            ep = entry["endpoint"]
            if ep is None or states.get(ep) != _fleet.DEGRADED:
                continue
            for rep in self.candidates(entry["tenant"], exclude={ep}):
                if rep.state != _fleet.HEALTHY:
                    continue
                rec = {"sid": entry["sid"], "from": ep,
                       "to": rep.endpoint, "ok": False}
                try:
                    self.migrate_session(entry["sid"], rep.endpoint)
                    rec["ok"] = True
                except FleetError as e:
                    rec["error"] = str(e)
                moves.append(rec)
                break
        return moves

    # -- teardown / introspection ------------------------------------------

    def close_session(self, sid: str) -> None:
        with self._lock:
            entry = self._sessions.pop(sid, None)
        if entry is None:
            return
        for ep in filter(None, (entry["endpoint"], entry.get("standby"))):
            try:
                self._call(self._replica(ep), {"op": "close", "sid": sid})
            except FleetError:
                pass

    def call_replica(self, endpoint: str, op: str, **fields) -> dict:
        """Request/reply one out-of-band op (``stats``,
        ``save_artifacts``, ...) on a specific replica.  Used by the
        suite leg and bench to read per-replica cache counters through
        the same breaker-accounted transport as session traffic."""
        return self._call(self._replica(endpoint), {"op": op, **fields})

    def shutdown_fleet(self) -> None:
        """Best-effort shutdown op to every known replica (tests/CLI)."""
        with self._lock:
            reps = list(self._replicas.values())
        for rep in reps:
            try:
                self._call(rep, {"op": "shutdown"}, timeout_s=2.0)
            except FleetError:
                pass
            rep.close()

    def stats(self) -> dict:
        with self._lock:
            reps = {ep: {"state": r.state, "reason": r.reason,
                         "breaker": r.breaker.snapshot()}
                    for ep, r in self._replicas.items()}
            sessions = {sid: {"tenant": e["tenant"],
                              "endpoint": e["endpoint"],
                              "standby": e.get("standby"),
                              "steps": len(e["log"])}
                        for sid, e in self._sessions.items()}
        return {
            "replicas": reps,
            "sessions": sessions,
            "steps": _registry.get("router.steps"),
            "redirects": _registry.get("router.redirects"),
            "heals": _registry.get("router.heals"),
            "migrations": _registry.get("router.migrations"),
            "hedges_fired": _registry.get("router.hedges_fired"),
        }

    def metrics_text(self) -> str:
        """Router-scope Prometheus exposition (the fleet-serving
        counterpart of ``observe.fleet.render``)."""
        from ramba_tpu_torch.observe.telemetry import _Families

        fams = _Families({})
        with self._lock:
            reps = list(self._replicas.items())
            n_sessions = len(self._sessions)
        for ep, rep in reps:
            lab = {"endpoint": ep}
            fams.add("ramba_router_replica_state", "gauge", 1,
                     {**lab, "state": rep.state})
            snap = rep.breaker.snapshot()
            fams.add("ramba_router_breaker_trips_total", "counter",
                     snap["trips"], lab)
        fams.add("ramba_router_sessions", "gauge", n_sessions)
        for name, metric in (("router.steps", "ramba_router_steps_total"),
                             ("router.redirects",
                              "ramba_router_redirects_total"),
                             ("router.heals", "ramba_router_heals_total"),
                             ("router.migrations",
                              "ramba_router_migrations_total"),
                             ("router.hedges_fired",
                              "ramba_router_hedges_total")):
            fams.add(metric, "counter", _registry.get(name))
        return fams.render()
