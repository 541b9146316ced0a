"""Async compile/dispatch pipeline: enqueue on the caller, execute on a
background worker.

Counterpart of ``ramba_tpu/serve/pipeline.py``.  A synchronous flush pays
trace + verify + admission + compile + execute on the calling thread.
The pipeline splits it along the fuser's own staging seam
(``fuser._flush_prepare`` / ``fuser._flush_dispatch``):

* **enqueue** (caller thread, cheap): atomically detach the stream's
  pending roots, rewrite + linearize, RAMBA_VERIFY, fingerprint, the
  memo plan.  Returns a :class:`FlushTicket` immediately — the build
  thread goes back to building.
* **dispatch** (worker thread): admission control, the degradation
  ladder, Const write-back.  Every per-program guarantee — retry
  budgets, ladder rungs, quarantine, memory admission — runs exactly as in
  a synchronous flush because it IS the same code.

ONE worker serves the whole process.  Dispatches funnel into one card
anyway (kernel launches hold the GIL; the card serializes execution),
so extra workers would only add lock contention — while a single worker
gives back-to-back dispatch of coalesced same-fingerprint batches: one
compile, N cache-warm executions.

The worker runs each ticket with the submitting thread's per-thread
state (``elastic._thread_state``: ``common.device_scope``'s device,
``mesh.local_scope``'s mesh and torch's current CUDA stream), so every
kernel launcher reads the submitter's stream as its
``torch.cuda.current_stream``.  After write-back the worker records a
CUDA event on that stream; a :meth:`FlushTicket.wait` on a thread whose
current stream is another makes that stream wait on the event and marks
the results in use there (``record_stream``), so the caching allocator
cannot reuse their memory early.  A build or launch error on the worker
(``_build.KernelBuildError``, a CUDA error) reaches the ticket as the
error it is: the ladder treats it as fatal, so it never becomes a lower
rung or a shed.

Coalescing: consecutive queued flushes whose program fingerprints match
(identical structure + donation mask + semantic regime) are popped as
one batch (``RAMBA_SERVE_COALESCE``, default 8, head-only so per-tenant
FIFO survives) and dispatched back-to-back; each span records
``coalesced: N`` and a ``serve_coalesce`` event summarizes the batch.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from ramba_tpu_torch import common as _common
from ramba_tpu_torch.core import fuser as _fuser
from ramba_tpu_torch.observe import attrib as _attrib
from ramba_tpu_torch.observe import events as _events
from ramba_tpu_torch.observe import ledger as _ledger
from ramba_tpu_torch.observe import registry as _registry
from ramba_tpu_torch.observe import slo as _slo
from ramba_tpu_torch.parallel import mesh as _mesh
from ramba_tpu_torch.resilience import coherence as _coherence
from ramba_tpu_torch.resilience import elastic as _elastic
from ramba_tpu_torch.serve import overload as _overload
from ramba_tpu_torch.serve.fairness import RoundRobin


def _coalesce_max() -> int:
    try:
        return max(1, int(os.environ.get("RAMBA_SERVE_COALESCE", "8") or 8))
    except ValueError:
        return 8


class FlushTicket:
    """Handle to one enqueued flush.  ``wait()`` blocks until dispatch
    finishes and returns the flush result (the values of ``extra``
    expressions, usually ``[]``), re-raising the dispatch error if the
    flush failed — the same exception a synchronous ``flush()`` would
    have raised, just later."""

    __slots__ = ("stream", "work", "result", "exception", "coalesced",
                 "trace_id", "deadline", "abandoned", "_done", "state",
                 "event")

    def __init__(self, stream, work=None):
        self.stream = stream
        self.work = work
        self.result: Optional[list] = None
        self.exception: Optional[BaseException] = None
        self.coalesced = 1
        # the causal trace this flush belongs to (from the prepared span)
        self.trace_id: Optional[str] = (
            work.span.get("trace_id") if work is not None else None)
        self.deadline = getattr(work, "deadline", None)
        self.abandoned = False
        self._done = threading.Event()
        # the submitter's (device, mesh, CUDA stream); the CUDA event the
        # worker records after write-back
        self.state = None
        self.event = None
        if work is None:  # nothing was pending: born finished
            self.result = []
            self._done.set()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def _resolve(self, result) -> None:
        self.result = result
        self._done.set()

    def _fail(self, exc: BaseException) -> None:
        self.exception = exc
        self._done.set()

    def abandon(self) -> None:
        """Give up on this ticket: a late completion discards its results
        instead of writing them back into a stream nobody is reading
        (the zombie-rung cancel pattern applied to tickets).  The
        underlying arrays stay quarantine-free and self-heal on next
        touch via the per-array re-flush path."""
        self.abandoned = True

    def wait(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            # the caller is walking away — mark the ticket so the
            # dispatch worker discards instead of writing back
            self.abandon()
            _registry.inc("serve.abandoned")
            raise _overload.TicketAbandoned(
                f"flush ticket not done after {timeout}s; ticket abandoned")
        if self.exception is not None:
            raise self.exception
        self._join_stream()
        return self.result

    def _join_stream(self) -> None:
        """Order the caller's CUDA stream after the worker's write-back
        when the two differ."""
        ev = self.event
        if ev is None:
            return
        import torch

        launch = self.state[2]
        cur = torch.cuda.current_stream(launch.device)
        if cur == launch:
            return
        cur.wait_event(ev)
        for arr in (self.work.roots if self.work is not None else ()):
            v = getattr(arr._expr, "value", None)
            if isinstance(v, torch.Tensor) and v.device == launch.device:
                v.record_stream(cur)


class _WarmWork:
    """Minimal work stub for warm tasks: no program, no fingerprint (a
    None fingerprint also tells the fairness queue not to coalesce past
    it), no SLO clock."""

    __slots__ = ("fingerprint", "enqueued_at", "span")

    def __init__(self):
        self.fingerprint = None
        self.enqueued_at = None
        self.span: dict = {}


class _WarmStream:
    """Stream stub so ``_finish`` bookkeeping works on warm tickets."""

    __slots__ = ("inflight", "tenant", "name")

    def __init__(self, label: str):
        self.inflight: list = []
        self.tenant = "_autotune"
        self.name = label


class WarmTicket(FlushTicket):
    """A background thunk riding the dispatch queue — used by the backend
    autotuner to pay challenger (kernel) builds off the serving hot
    path.  Fairness still applies: warm tasks queue under their own
    tenant, so they take round-robin turns instead of starving real
    flushes."""

    __slots__ = ("thunk", "label")

    def __init__(self, thunk, label: str):
        super().__init__(_WarmStream(label), _WarmWork())
        self.thunk = thunk
        self.label = label


class CompilePipeline:
    """The background dispatch worker + its fairness queue."""

    def __init__(self, coalesce: Optional[int] = None):
        self.coalesce = coalesce if coalesce is not None else _coalesce_max()
        self.queue = RoundRobin()
        self._worker: Optional[threading.Thread] = None
        self._start_lock = threading.Lock()
        self._stopping = False
        self.dispatched = 0
        self.batches = 0

    # -- lifecycle ---------------------------------------------------------

    def _ensure_worker(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            return
        with self._start_lock:
            if self._worker is not None and self._worker.is_alive():
                return
            self._stopping = False
            self._worker = threading.Thread(
                target=self._run, name="ramba-serve-dispatch", daemon=True
            )
            self._worker.start()

    def quiesce(self, timeout: Optional[float] = None) -> bool:
        """Wait until the fairness queue is empty (drain-to-checkpoint's
        first step).  Popped-but-unfinished work is covered by the stream
        drains that follow (``fuser.sync`` waits out every inflight
        ticket); this only has to outlast the queue backlog.  Returns
        False on timeout instead of raising — the caller's drain
        deadline decides what a stuck queue means."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while len(self.queue) > 0:
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.005)
        return True

    def stop(self) -> None:
        """Drain nothing, stop the worker (tests / interpreter shutdown).
        Queued tickets are failed so no waiter hangs."""
        self._stopping = True
        self.queue.close()
        w = self._worker
        if w is not None and w.is_alive():
            w.join(timeout=5)
        self._worker = None
        # fail anything still queued
        while True:
            group = self.queue.pop_group(1, timeout=0)
            if not group:
                break
            for t in group:
                self._finish(t, error=RuntimeError("pipeline stopped"))

    # -- enqueue -----------------------------------------------------------

    def submit(self, stream, extra=()) -> FlushTicket:
        """Enqueue one flush of ``stream``: detach its pending roots and
        run the prepare stage on THIS thread, then queue the prepared
        work for the dispatch worker.  Returns immediately with a
        ticket.  Prepare errors behave like a synchronous flush's: they
        raise here (after quarantining the detached roots).

        Overload admission runs FIRST — breaker fail-fast and
        brownout-red shedding cost O(ms) because no prepare work has
        happened yet; a rejected submit leaves the stream's pending
        graph intact (nothing was detached), so the caller can retry
        after backoff or materialize synchronously.  The brownout's
        queue signal is the submitting tenant's own backlog: one
        tenant's backlog never sheds another tenant."""
        tenant = stream.tenant or stream.name
        _overload.admit_submit(
            tenant=stream.tenant,
            priority=getattr(stream, "priority", False),
            queue_depth=self.queue.depth(tenant) if tenant else None)
        with stream._flush_lock, _fuser.stream_scope(stream):
            roots = stream._collect(detach=True)
            work = _fuser._flush_prepare(stream, roots, list(extra),
                                         detached=True)
        if work is None:
            return FlushTicket(stream)
        if work.plan_cert is not None and work.plan_cache is None:
            # a freshly certified plan (miss path) is fleet property:
            # publish it to the shared artifact tier by chash so one
            # replica's analysis warms its peers (core/plancache.py
            # returns False while the tier is off)
            from ramba_tpu_torch.core import plancache as _plancache

            _plancache.publish(work.plan_cert)
        work.enqueued_at = time.perf_counter()
        ticket = FlushTicket(stream, work)
        ticket.state = _elastic._thread_state()
        # late-completion probe: dispatch checks this before write-back
        work.is_abandoned = (lambda t=ticket: t.abandoned)
        stream.inflight.append(ticket)
        stream.stats["enqueued"] += 1
        _registry.inc("serve.enqueued")
        try:
            self.queue.push(tenant, ticket)
        except _overload.QueueFullError:
            # unwind: the prepared work holds pins/flight refs and its
            # roots are registered as pending — release both so the
            # arrays self-heal on next touch instead of leaking
            stream.inflight.remove(ticket)
            stream.stats["enqueued"] -= 1
            _fuser._flush_discard(work)
            raise
        self._ensure_worker()
        return ticket

    def submit_warm(self, thunk, label: str = "warm") -> WarmTicket:
        """Enqueue a background thunk (e.g. an autotune challenger
        compile) on the dispatch worker.  The thunk runs under the
        ``_autotune`` tenant — round-robin fairness keeps it from
        starving real flushes — and never coalesces (its fingerprint is
        None).  Errors are captured on the ticket, not raised: a failed
        warm-up must not take down the worker.

        Under yellow/red brownout speculative work is the first load to
        shed: the thunk is dropped (never run) and an already-resolved
        ticket returned — autotune treats an unrun warm-up exactly like
        a lost race."""
        ticket = WarmTicket(thunk, label)
        if not _overload.allow_speculative():
            _registry.inc("serve.warm_shed")
            ticket._resolve([])
            return ticket
        _registry.inc("serve.warm_enqueued")
        self.queue.push(ticket.stream.tenant, ticket)
        self._ensure_worker()
        return ticket

    # -- dispatch ----------------------------------------------------------

    def _finish(self, ticket: FlushTicket, result=None, error=None) -> None:
        try:
            ticket.stream.inflight.remove(ticket)
        except ValueError:
            pass
        # End-to-end ticket latency (enqueue -> resolve/fail, queue time
        # included) is what a serving caller experiences — the SLO metric.
        # Failures count too: a timed-out request that errored still
        # missed its objective.
        work = ticket.work
        if work is not None and work.enqueued_at is not None:
            # the span rides along so an slo_breach can carry the
            # explainer's "why" verdict for the flush that tipped it
            _slo.observe_e2e(time.perf_counter() - work.enqueued_at,
                             tenant=ticket.stream.tenant,
                             trace_id=ticket.trace_id,
                             span=work.span or None)
        # Feed the tenant's circuit breaker — but never count overload
        # sheds as failures (a shed storm tripping breakers would be a
        # positive feedback loop), warm thunks (no tenant traffic), or
        # the shutdown path's synthetic errors.
        if not isinstance(ticket, WarmTicket) and not self._stopping:
            if error is None:
                _overload.record_outcome(ticket.stream.tenant, True)
            elif getattr(error, "shed_classification", None) is None:
                _overload.record_outcome(ticket.stream.tenant, False)
        if error is not None:
            ticket._fail(error)
        else:
            ticket._resolve(result)

    def _dispatch_group(self, group: list) -> None:
        t_group = time.perf_counter()
        n = len(group)
        if n > 1:
            self.batches += 1
            _registry.inc("serve.coalesced", n)
            ev = {
                "type": "serve_coalesce",
                "fingerprint": group[0].work.fingerprint,
                "n": n,
                "tenants": sorted({t.stream.tenant or t.stream.name
                                   for t in group}),
            }
            # every trace that rode this batch — a coalesced dispatch is
            # one causal join point shared by N requests
            trace_ids = sorted({t.trace_id for t in group
                                if t.trace_id is not None})
            if trace_ids:
                ev["trace_ids"] = trace_ids
            _events.emit(ev)
        # Batch-level CSE bookkeeping: tickets whose certified memo keys
        # repeat within this dispatch run should share one execution —
        # the leader executes + inserts, the followers' dispatch-time
        # re-lookup hits (span cache == "memo").  A duplicate that still
        # re-executed (memo full / racing eviction) is a dup exec — the
        # serving-waste signal.
        seen_keys: set = set()
        for ticket in group:
            if isinstance(ticket, WarmTicket):
                # Warm tasks carry a bare thunk, not prepared flush work.
                # The compile_source scope tags every compile the thunk
                # triggers as "warm" in the ledger — the warm-vs-demand
                # split diagnostics and trace_report surface.
                try:
                    with _ledger.compile_source("warm"):
                        ticket.thunk()
                except BaseException as e:  # noqa: BLE001 — captured, not fatal
                    _registry.inc("serve.warm_failed")
                    self._finish(ticket, error=e)
                else:
                    self._finish(ticket, result=[])
                continue
            ticket.coalesced = n
            work = ticket.work
            # Abandoned tickets (wait() timed out) are dropped before
            # dispatch: discard the prepared work so the arrays
            # self-heal instead of executing a flush nobody will read.
            # One process only — across ranks an abandonment is
            # rank-local state, and skipping the dispatch on one rank
            # would desync the collective schedule.
            if ticket.abandoned and not _coherence.engaged():
                _fuser._flush_discard(work)
                _registry.inc("serve.abandoned_drop")
                tenant = ticket.stream.tenant
                ev = {"type": "shed", "reason": "abandoned",
                      "stage": "dispatch", "label": work.label}
                if tenant is not None:
                    ev["tenant"] = tenant
                _events.emit(ev)
                self._finish(ticket, error=_overload.TicketAbandoned(
                    "ticket abandoned by caller before dispatch"))
                continue
            work.span["async"] = True
            if n > 1:
                # time this ticket spent behind its batch peers (group
                # pop -> its own dispatch); queue_wait is stamped net of
                # this slice at dispatch
                _attrib.add_stage(work.span, "coalesce",
                                  time.perf_counter() - t_group)
            plan = work.memo_plan
            key = (plan.key if plan is not None and plan.memoizable
                   and plan.key is not None else None)
            is_dup = key is not None and key in seen_keys
            if key is not None:
                seen_keys.add(key)
            try:
                result = self._run_ticket(ticket, n)
            except BaseException as e:  # ladder exhausted / fatal
                self._finish(ticket, error=e)
                continue
            if is_dup:
                tenant = ticket.stream.tenant
                if work.span.get("cache") == "memo":
                    _registry.inc("serve.cse_merged")
                    if tenant is not None:
                        _registry.inc(f"serve.tenant.{tenant}.cse_merged")
                    ev = {"type": "cse_merge", "chash": plan.chash}
                    if tenant is not None:
                        ev["tenant"] = tenant
                    _events.emit(ev)
                else:
                    _registry.inc("serve.dup_execs")
            self.dispatched += 1
            self._finish(ticket, result=result)

    @staticmethod
    def _run_ticket(ticket: FlushTicket, n: int):
        """One ticket's dispatch on this thread, under its stream's scope
        and its submitter's device, mesh and CUDA stream; on the card a
        CUDA event recorded after write-back goes on the ticket."""
        work = ticket.work
        dev, msh, cstream = ticket.state or (None, None, None)
        prev = (getattr(_common._scope, "device", None),
                getattr(_mesh._scope, "mesh", None))
        _common._scope.device, _mesh._scope.mesh = dev, msh
        try:
            with _fuser.stream_scope(work.stream):
                if cstream is None:
                    return _fuser._flush_dispatch(work, coalesced=n)
                import torch

                with torch.cuda.stream(cstream):
                    result = _fuser._flush_dispatch(work, coalesced=n)
                    ev = torch.cuda.Event()
                    ev.record(cstream)
                ticket.event = ev
                return result
        finally:
            _common._scope.device, _mesh._scope.mesh = prev

    def _run(self) -> None:
        while not self._stopping:
            group = self.queue.pop_group(
                self.coalesce,
                fingerprint_of=lambda t: t.work.fingerprint,
                timeout=0.5,
            )
            if not group:
                continue
            self._dispatch_group(group)


_pipeline: Optional[CompilePipeline] = None
_pipeline_lock = threading.Lock()


def get_pipeline() -> CompilePipeline:
    """Process-wide pipeline singleton (all sessions share one worker —
    see the module docstring for why one is the right number)."""
    global _pipeline
    with _pipeline_lock:
        if _pipeline is None:
            _pipeline = CompilePipeline()
        return _pipeline


def current_pipeline() -> Optional[CompilePipeline]:
    """The live pipeline if one exists — unlike :func:`get_pipeline`,
    never creates one (elastic drain must not spin up a worker just to
    quiesce it)."""
    return _pipeline


def shutdown() -> None:
    """Stop the shared pipeline (tests).  Overload-plane state
    (breakers, brownout, CoDel clocks) is per-pipeline — it resets with
    the pipeline so one test's tripped breaker cannot shed the next
    test's traffic."""
    global _pipeline
    with _pipeline_lock:
        p, _pipeline = _pipeline, None
    if p is not None:
        p.stop()
    _overload.reset()
