"""serve.Session — the per-request/per-tenant handle over a FlushStream.

Counterpart of ``ramba_tpu/serve/session.py``.

Usage::

    with serve.Session(tenant="acme", quota="512m") as s:
        a = rt.ones((4096, 4096)) * 3.0     # registers on s's stream
        t = s.flush()                        # async: enqueue + ticket
        ...build more...
        print(a.asarray())                   # rendezvous: drains s's stream

A session is a context manager; inside the ``with`` block every lazy
array created on the calling thread registers on the session's own
:class:`~ramba_tpu_torch.core.fuser.FlushStream` (a contextvar, so concurrent
sessions on different threads — or interleaved async tasks — never see
each other's pending work).  Materializing an array from any thread
flushes the stream that owns it, so handing a session's result to
another component just works.

Per-session knobs:

* ``tenant`` — attribution identity: spans, degrade/slow-flush events,
  ``serve.tenant.<t>.*`` counters, kernel-ledger execution counts, and
  memory-ledger resident bytes all carry it.  Two sessions may share a
  tenant (one user, many requests); quota is then enforced jointly.
* ``quota`` — per-tenant device-memory byte cap (int or ``parse_bytes`` string;
  default ``RAMBA_SERVE_QUOTA``).  Enforced by memory-governor
  admission: an over-quota flush first evicts the tenant's own cold
  arrays, then routes to the byte-bounded ``chunked`` rung.  Never
  touches other tenants' memory.
* ``max_pending`` — auto-flush threshold for THIS stream (default
  ``RAMBA_SERVE_MAX_PENDING``, else the global
  ``RAMBA_TPU_MAX_PENDING``).  Threshold flushes go through the async
  pipeline, so a long build loop streams work to the device instead of
  stalling on a synchronous flush.
* ``deadline_ms`` — per-flush time budget (default
  ``RAMBA_DEADLINE_MS``, unset = none).  Minted into a
  :class:`~ramba_tpu_torch.serve.overload.Deadline` at flush prepare and
  carried on the ticket/span; expired work is shed before dispatch
  with a classified ``DeadlineExceededError``, the degradation ladder
  skips rungs whose rolling p50 cannot fit the remaining budget, and
  the elastic watchdog clamps to ``min(watchdog, remaining)``.
* ``priority`` — exempts this session's flushes from brownout
  shedding (``serve/overload.py``): under red brownout only priority
  tenants are admitted.  Not a scheduling priority — fairness
  rotation is unchanged.
"""

from __future__ import annotations

import os
from typing import Optional

from ramba_tpu_torch import common as _common
from ramba_tpu_torch.core import fuser as _fuser
from ramba_tpu_torch.observe import events as _events
from ramba_tpu_torch.observe import telemetry as _telemetry
from ramba_tpu_torch.serve import pipeline as _pipeline


def _env_max_pending() -> Optional[int]:
    raw = os.environ.get("RAMBA_SERVE_MAX_PENDING")
    if raw:
        try:
            return max(1, int(raw))
        except ValueError:
            pass
    return None


def _env_quota() -> Optional[int]:
    raw = os.environ.get("RAMBA_SERVE_QUOTA")
    if raw:
        try:
            return max(1, _common.parse_bytes(raw))
        except ValueError:
            pass
    return None


def _parse_quota(quota) -> Optional[int]:
    if quota is None:
        return _env_quota()
    if isinstance(quota, str):
        return max(1, _common.parse_bytes(quota))
    return max(1, int(quota))


class Session:
    """One serving session: a scoped flush stream + the async pipeline.

    Reentrant-safe as a context manager on one thread; a Session object
    must not be entered on two threads at once (each thread should open
    its own — Sessions are cheap)."""

    def __init__(self, tenant: Optional[str] = None,
                 name: Optional[str] = None,
                 max_pending: Optional[int] = None,
                 quota=None,
                 pipeline: Optional["_pipeline.CompilePipeline"] = None,
                 trace_id: Optional[str] = None,
                 deadline_ms: Optional[float] = None,
                 priority: bool = False):
        self.tenant = tenant
        self.pipeline = pipeline or _pipeline.get_pipeline()
        # causal trace root: every flush span of this session chains back
        # here.  Caller-supplied trace_id joins an existing distributed
        # trace (ranks that serve one request pass one shared id);
        # default is a fresh id per session.
        self.trace_id = trace_id or _telemetry.mint_id()
        self.root_span = _telemetry.mint_id()
        self.stream = _fuser.FlushStream(
            name=name or (f"session:{tenant}" if tenant else None),
            tenant=tenant,
            max_pending_ops=(max_pending if max_pending is not None
                             else _env_max_pending()),
            quota_bytes=_parse_quota(quota),
        )
        self.stream.trace_id = self.trace_id
        self.stream.root_span = self.root_span
        self.stream.deadline_ms = deadline_ms
        self.stream.priority = bool(priority)
        # threshold auto-flushes stream through the pipeline instead of
        # blocking the build thread on a synchronous flush
        self.stream.on_threshold = self.pipeline.submit
        self._tokens: list = []
        self.closed = False
        ev = {"type": "serve_session", "trace_id": self.trace_id,
              "span_id": self.root_span, "stream": self.stream.name}
        if tenant is not None:
            ev["tenant"] = tenant
        _events.emit(ev)

    # -- context management ------------------------------------------------

    def __enter__(self) -> "Session":
        if self.closed:
            raise RuntimeError("session is closed")
        self._tokens.append(_fuser.activate_stream(self.stream))
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._tokens:
            _fuser.deactivate_stream(self._tokens.pop())
        if not self._tokens:
            self.close(drain=exc_type is None)

    # -- non-scoped activation (replica servers) ---------------------------

    def acquire(self) -> "Session":
        """Activate this session's stream on the calling thread WITHOUT
        closing on deactivation — the long-lived form of ``__enter__``
        for servers that resume one session across many requests
        (the fleet's replica servers).  Pair every acquire with a
        :meth:`release`; the session stays open until :meth:`close` or
        :meth:`handoff`."""
        if self.closed:
            raise RuntimeError("session is closed")
        self._tokens.append(_fuser.activate_stream(self.stream))
        return self

    def release(self) -> None:
        """Deactivate the stream on the calling thread (undo one
        :meth:`acquire`) without closing the session."""
        if self._tokens:
            _fuser.deactivate_stream(self._tokens.pop())

    # -- flushing ----------------------------------------------------------

    def flush(self, wait: bool = False) -> "_pipeline.FlushTicket":
        """Enqueue an async flush of everything pending on this session.
        Returns the ticket; ``wait=True`` blocks until dispatch finishes
        (re-raising its error, exactly like a synchronous flush)."""
        ticket = self.pipeline.submit(self.stream)
        if wait:
            ticket.wait()
        return ticket

    def sync(self) -> None:
        """Barrier: every flush of this session (queued or in flight) is
        dispatched and anything still pending is flushed."""
        self.stream.drain()
        self.stream.flush()

    def close(self, drain: bool = True) -> None:
        """Finish the session.  ``drain`` (default) runs a final sync so
        nothing pending is silently dropped; pass False to abandon
        un-materialized work (its arrays self-heal on next touch via the
        per-array re-flush path)."""
        if self.closed:
            return
        self.closed = True
        if drain:
            try:
                self.sync()
            finally:
                self.stream.on_threshold = None
        else:
            self.stream.drain()
            self.stream.on_threshold = None

    def handoff(self) -> dict:
        """Drain and close this session for migration to another
        process (the fleet's migration, ``fleet/migrate.py``, adopts
        it there): a final :meth:`sync` lands every
        pending flush so the arrays the caller is about to checkpoint
        are complete, then the session closes.  Returns the identity
        meta the migration manifest records (tenant, trace root) so the
        adopting replica's new session can chain the same distributed
        trace."""
        meta = {"tenant": self.tenant, "trace_id": self.trace_id,
                "root_span": self.root_span, "stream": self.stream.name}
        self.close(drain=True)
        ev = {"type": "migrate", "action": "handoff",
              "trace_id": self.trace_id, "stream": self.stream.name}
        if self.tenant is not None:
            ev["tenant"] = self.tenant
        _events.emit(ev)
        return meta

    # -- introspection -----------------------------------------------------

    @property
    def stats(self) -> dict:
        return dict(self.stream.stats)

    def __repr__(self):
        return (f"<serve.Session tenant={self.tenant!r} "
                f"stream={self.stream.name!r} closed={self.closed}>")
