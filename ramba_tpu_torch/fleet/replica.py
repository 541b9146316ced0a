"""Replica server: one ramba_tpu_torch process serving tenant sessions.

Counterpart of ``ramba_tpu/fleet/replica.py``: the serving plane's unit
of capacity.  A replica wraps the single-process stack (``serve.Session``
streams, the overload plane, the memo and the persistent kernel cache,
the fleet's snapshot spool) behind a length-prefixed authenticated
transport (``multiprocessing.connection``, stdlib).  The router
(``fleet/router.py``) talks to N of these.

* **Refusals are replies, not errors.**  When the overload plane refuses
  a step (open breaker, red brownout, queue cap, the ``fleet:admit``
  fault site), the replica answers ``{"refused": ...}`` with the shed
  classification.  The router turns that into a redirect
  (``retry.classify`` -> ``"redirect"``).  Transport failures are how a
  dead replica looks; the router's fleet-level breaker feeds on those
  only.
* **Deterministic workloads.**  Steps are named workloads from a small
  registry, never pickled closures: the transport stays safe, and every
  session is a deterministic step log the router can replay on a
  survivor with the same bytes.  Only JSON-able results cross the
  transport, never a tensor.
* **Long-lived sessions** use ``Session.acquire()``/``release()``.
* **Identity in every reply**, so stitched traces show which process
  served which step.  The ``stats`` reply carries the replica's launch
  count of each kernel family, its builds and its cache counters.

Environment: ``RAMBA_FLEET_AUTHKEY`` (transport secret, default
``ramba-fleet``: set it in production); the server exports
``RAMBA_FLEET_ENDPOINT`` so the spool's ``signals`` tell the router where
it listens.
"""

from __future__ import annotations

import hashlib
import os
import threading
from multiprocessing.connection import Client, Listener
from typing import Any, Dict, Optional, Tuple

from ramba_tpu_torch.observe import events as _events
from ramba_tpu_torch.observe import registry as _registry
from ramba_tpu_torch.observe import telemetry as _telemetry
from ramba_tpu_torch.resilience import faults as _faults


def authkey() -> bytes:
    return (os.environ.get("RAMBA_FLEET_AUTHKEY") or "ramba-fleet").encode()


def parse_endpoint(endpoint: str) -> Tuple[str, int]:
    host, _, port = endpoint.rpartition(":")
    return host or "127.0.0.1", int(port)


# ---------------------------------------------------------------------------
# deterministic workload registry
# ---------------------------------------------------------------------------
#
# name -> (fn(state, params) -> json-able result, mutates).  Pure
# (mutates=False) and reproducible workloads are the ones the router may
# hedge onto a second replica: the replica-level form of the purity and
# reproducibility gates on kernel-level hedging (serve/overload.py).


def _w_init(state: Dict[str, Any], params: dict):
    import ramba_tpu_torch as rt

    name = params.get("name", "x")
    shape = tuple(params.get("shape", (256,)))
    fill = float(params.get("fill", 1.0))
    state[name] = rt.full(shape, fill, dtype=params.get("dtype", "float32"))
    return {"name": name, "shape": list(shape)}


def _w_affine(state: Dict[str, Any], params: dict):
    name = params.get("name", "x")
    x = state[name]
    # the port donates no buffer, so the previous array is simply
    # dropped (the reference keeps it alive in "_keep" to block donation)
    state[name] = x * float(params.get("a", 1.0)) + float(params.get("b", 0.0))
    return {"name": name}


def _w_sum(state: Dict[str, Any], params: dict):
    import ramba_tpu_torch as rt

    return float(rt.sum(state[params.get("name", "x")]).asarray())


def _w_digest(state: Dict[str, Any], params: dict):
    import numpy as np

    h = hashlib.sha256()
    for name in sorted(state):
        if name.startswith("_"):
            continue
        a = np.require(state[name].asarray(), requirements="C")
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        # the buffer itself: hashlib reads it without a copy and lets
        # the spool's publisher thread run meanwhile
        h.update(memoryview(a).cast("B"))
    return h.hexdigest()


WORKLOADS = {
    "init": (_w_init, True),
    "affine": (_w_affine, True),
    "sum": (_w_sum, False),
    "digest": (_w_digest, False),
}

#: the instructions each workload's flushes run (``digest`` runs none on
#: the device: it reads the state back)
WORKLOAD_OPS = {
    "init": ("full",),
    "affine": ("map",),
    "sum": ("reduce",),
    "digest": (),
}


def workload_pure(name: str) -> bool:
    """Hedge/replay-safe without state effects?  Router-side gate for
    replica-level hedging."""
    entry = WORKLOADS.get(name)
    return entry is not None and not entry[1]


def workload_reproducible(name: str) -> bool:
    """Whether two runs of the workload give the same bytes: the port's
    rule of kernel-level hedging (``overload.deterministic``: no
    instruction whose generic lowering uses atomics).  The router hedges
    a step only when it is pure and reproducible."""
    from ramba_tpu_torch.serve import overload as _overload

    ops = WORKLOAD_OPS.get(name)
    return ops is not None and not any(
        op in _overload.NONDETERMINISTIC_OPS for op in ops)


def kernel_launches() -> dict:
    """This process's launch count of each hand-written kernel family."""
    from ramba_tpu_torch.ops import elemred, scan, segred, stencil_kernel

    return {"elemred": elemred.launches, "stencil": stencil_kernel.launches,
            "segred": segred.launches, "scan": scan.launches}


def _ledger_kernels() -> list:
    """Fingerprints of the programs this process's ledger has seen."""
    from ramba_tpu_torch.observe import ledger as _ledger

    return list(_ledger.snapshot().get("kernels", {}))


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------


class ReplicaSession:
    """One tenant session resident on this replica: the serve.Session
    (its flush stream + trace root), the named-array state the
    deterministic workloads act on, and the step sequence number that
    orders the router's replayable step log."""

    def __init__(self, sid: str, tenant: Optional[str],
                 trace_id: Optional[str] = None, seq: int = 0):
        from ramba_tpu_torch import serve as _serve

        self.sid = sid
        self.tenant = tenant
        self.session = _serve.Session(tenant=tenant, trace_id=trace_id,
                                      name=f"fleet:{sid}")
        self.state: Dict[str, Any] = {}
        self.seq = seq
        self.lock = threading.Lock()

    def run(self, workload: str, params: dict):
        fn, _mutates = WORKLOADS[workload]
        with self.lock:
            self.session.acquire()
            try:
                result = fn(self.state, params)
                # sync after every step: results land before the reply,
                # so an acked step is a durable step for replay purposes
                self.session.sync()
            finally:
                self.session.release()
            self.seq += 1
            return result, self.seq


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


class ReplicaServer:
    """Accept loop + per-connection dispatch threads.  One instance per
    process; ``serve_forever`` blocks until a ``shutdown`` op (or
    :meth:`stop`)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        from ramba_tpu_torch.fleet import artifacts as _artifacts
        from ramba_tpu_torch.observe import fleet as _fleet

        self._listener = Listener((host, port), authkey=authkey())
        lhost, lport = self._listener.address
        self.endpoint = f"{lhost}:{lport}"
        # export the endpoint BEFORE the first spool publish so the
        # router can join this replica's health snapshot to a connection
        os.environ["RAMBA_FLEET_ENDPOINT"] = self.endpoint
        self.replica = _fleet.replica_id()
        self._sessions: Dict[str, ReplicaSession] = {}
        self._conns: list = []  # accepted connections, closed on stop
        self._lock = threading.Lock()
        self._stop = threading.Event()
        _artifacts.configure()
        _fleet.start()
        _fleet.publish()  # visible to the router immediately, not in 5s
        _registry.gauge("fleet.replica_serving", 1)
        _events.emit({"type": "replica", "action": "serving",
                      "endpoint": self.endpoint, "replica": self.replica})

    # -- lifecycle ---------------------------------------------------------

    def stop(self) -> None:
        self._stop.set()
        # a blocked accept() does not reliably wake when the listening
        # socket is closed from another thread; poke it with a
        # throwaway authenticated connection first so serve_forever
        # re-checks the stop flag and returns
        try:
            Client(parse_endpoint(self.endpoint),
                   authkey=authkey()).close()
        except (OSError, EOFError, ValueError):
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        # established connections have handler threads blocked in recv();
        # closing the Connection from here makes that recv raise so the
        # thread exits instead of serving one more request after stop
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass

    def serve_forever(self) -> None:
        while not self._stop.is_set():
            try:
                conn = self._listener.accept()
            except (OSError, EOFError):
                if self._stop.is_set():
                    return
                continue
            with self._lock:
                self._conns.append(conn)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name="ramba-fleet-conn", daemon=True)
            t.start()

    def _serve_conn(self, conn) -> None:
        try:
            while not self._stop.is_set():
                try:
                    msg = conn.recv()
                except (EOFError, OSError, TypeError):
                    # TypeError: stop() closed this Connection under us
                    # and the stdlib recv read from a None handle
                    return
                try:
                    reply = self._dispatch(msg)
                except Exception as e:  # noqa: BLE001 — reply, don't die
                    reply = {"error": {"type": type(e).__name__,
                                       "message": str(e)},
                             "replica": self.replica}
                try:
                    conn.send(reply)
                except (OSError, ValueError, BrokenPipeError):
                    return
                if isinstance(msg, dict) and msg.get("op") == "shutdown":
                    self.stop()
                    return
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)

    # -- session table -----------------------------------------------------

    def _session(self, sid: str) -> ReplicaSession:
        with self._lock:
            sess = self._sessions.get(sid)
        if sess is None:
            raise KeyError(f"no open session {sid!r} on replica "
                           f"{self.replica}")
        return sess

    # -- dispatch ----------------------------------------------------------

    def _dispatch(self, msg: dict) -> dict:
        op = msg.get("op")
        handler = getattr(self, f"_op_{op}", None)
        if handler is None:
            return {"error": {"type": "UnknownOp", "message": repr(op)},
                    "replica": self.replica}
        return handler(msg)

    def _op_ping(self, msg: dict) -> dict:
        from ramba_tpu_torch.serve import overload as _overload

        return {"ok": True, "replica": self.replica,
                "endpoint": self.endpoint, "pid": os.getpid(),
                "sessions": len(self._sessions),
                "verdict": _overload.admission_verdict(msg.get("tenant"))}

    def _op_open(self, msg: dict) -> dict:
        sid = msg.get("sid") or _telemetry.mint_id()
        sess = ReplicaSession(sid, msg.get("tenant"), msg.get("trace_id"))
        with self._lock:
            self._sessions[sid] = sess
        _registry.inc("fleet.replica_opens")
        return {"ok": True, "sid": sid, "replica": self.replica,
                "trace_id": sess.session.trace_id}

    def _op_step(self, msg: dict) -> dict:
        from ramba_tpu_torch.serve import overload as _overload

        sess = self._session(msg["sid"])
        workload = msg.get("workload")
        if workload not in WORKLOADS:
            return {"error": {"type": "UnknownWorkload",
                              "message": repr(workload)},
                    "replica": self.replica}
        tenant = sess.tenant
        # admission: the same front door in-process flushes face, plus
        # the fleet:admit injection site the suite leg drives.  A
        # refusal is a REPLY — the router redirects, the tenant never
        # sees it.
        try:
            _faults.check("fleet:admit", tenant=tenant or "")
            _overload.admit_submit(tenant=tenant,
                                   priority=bool(msg.get("priority")))
        except _overload.OverloadError as e:
            _registry.inc("fleet.replica_refusals")
            return {"refused": {
                "error": type(e).__name__,
                "classification": getattr(e, "shed_classification", "shed"),
                "message": str(e)}, "replica": self.replica}
        except _faults.InjectedFault as e:
            _registry.inc("fleet.replica_refusals")
            return {"refused": {
                "error": type(e).__name__, "classification": "fault",
                "message": str(e)}, "replica": self.replica}
        try:
            result, seq = sess.run(workload, msg.get("params") or {})
        except Exception as e:  # noqa: BLE001 — reply + feed the breaker
            _overload.record_outcome(tenant, False)
            _registry.inc("fleet.replica_step_errors")
            return {"error": {"type": type(e).__name__, "message": str(e)},
                    "replica": self.replica}
        _overload.record_outcome(tenant, True)
        _registry.inc("fleet.replica_steps")
        return {"ok": True, "result": result, "seq": seq,
                "replica": self.replica,
                "trace_id": sess.session.trace_id}

    def _op_stats(self, msg: dict) -> dict:
        from ramba_tpu_torch import _build
        from ramba_tpu_torch.compile import persist as _persist
        from ramba_tpu_torch.core import fuser as _fuser
        from ramba_tpu_torch.core import memo as _memo
        from ramba_tpu_torch.fleet import artifacts as _artifacts

        return {"ok": True, "replica": self.replica,
                "persist": _persist.snapshot(),
                "memo": _memo.cache.snapshot(),
                "artifacts": _artifacts.snapshot(),
                "launches": kernel_launches(),
                "nvcc_builds": _build.nvcc_builds,
                "disk_loads": _build.disk_loads,
                "fingerprints": sorted(
                    _ledger_kernels()),
                "counters": {
                    "memo.shared_hit": _registry.get("memo.shared_hit"),
                    "compile.persist_cross_hit":
                        _registry.get("compile.persist_cross_hit"),
                    # programs this process lowered (a library loaded
                    # from the cache is a compile without an nvcc build)
                    "fuser.compiles": _fuser.stats["compiles"],
                    "fleet.replica_steps":
                        _registry.get("fleet.replica_steps"),
                    "fleet.replica_refusals":
                        _registry.get("fleet.replica_refusals"),
                    "memo.hit": _registry.get("memo.hit"),
                    "memo.insert": _registry.get("memo.insert"),
                }}

    def _op_save_artifacts(self, msg: dict) -> dict:
        from ramba_tpu_torch.compile import persist as _persist

        return {"ok": True, "replica": self.replica,
                "saved": _persist.save_topk(int(msg.get("k", 8)))}

    def _op_drain(self, msg: dict) -> dict:
        from ramba_tpu_torch.fleet import migrate as _migrate

        sid = msg["sid"]
        sess = self._session(sid)
        with sess.lock:
            meta = sess.session.handoff()  # drains: every flush lands
            meta["seq"] = sess.seq
            path = _migrate.export_session(sid, meta, sess.state)
            with self._lock:
                self._sessions.pop(sid, None)
        return {"ok": True, "sid": sid, "replica": self.replica,
                "checkpoint": path, "seq": meta["seq"]}

    def _op_adopt(self, msg: dict) -> dict:
        from ramba_tpu_torch.fleet import migrate as _migrate

        sid = msg["sid"]
        manifest, state = _migrate.adopt_session(sid)
        sess = ReplicaSession(sid, manifest.get("tenant"),
                              manifest.get("trace_id"),
                              seq=int(manifest.get("seq", 0)))
        sess.state = state
        with self._lock:
            self._sessions[sid] = sess
        _registry.inc("fleet.replica_adopts")
        return {"ok": True, "sid": sid, "replica": self.replica,
                "seq": sess.seq, "names": manifest["names"],
                "payload_bytes": manifest.get("payload_bytes")}

    def _op_close(self, msg: dict) -> dict:
        with self._lock:
            sess = self._sessions.pop(msg["sid"], None)
        if sess is not None:
            sess.session.close()
        return {"ok": True, "replica": self.replica}

    def _op_shutdown(self, msg: dict) -> dict:
        return {"ok": True, "replica": self.replica}
