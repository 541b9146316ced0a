"""Rank-coherent recovery: the consensus control plane for resilience.

Counterpart of ``ramba_tpu/resilience/coherence.py``.  Every rank of a
multi-process program must take the same recovery path, or their
collective schedules part ways.  One primitive, epoch-numbered per
decision site::

    decision = coherence.agree(site, local_proposal)

``agree`` runs a tiny cross-rank round and returns the same decision on
every rank; each site carries a monotonically increasing **epoch**, so the
rounds pair up by construction.  Reductions: ``max`` (default, "worst
proposal wins": ``P_OK < P_RETRY < P_DROP < P_OOM < P_FATAL``), ``min``
("tightest budget wins") and ``bcast`` (rank 0 decides).  The
propose/decide split (:func:`propose`, :func:`decide`) parks a rank-local
signal that the next round folds in.

In one process the layer is the reference's single-process behaviour:
with ``RAMBA_COHERENCE`` ``on`` (default) nothing is engaged and every
call returns the local proposal untouched; ``force`` engages the
bookkeeping (epochs, events, counters) with a loopback transport.
Across processes a round is one all-reduce over
``parallel/distributed.py``.

Each round runs under a deadline (``elastic.with_deadline("coherence",
...)``): ``RAMBA_COHERENCE_TIMEOUT_S``, else the elastic watchdog's
``RAMBA_WATCHDOG_S``, else none.  A round that expires or whose
transport fails falls back to the local proposal (its event says
``outcome="local"``, counted ``coherence.round_failures``), as in the
reference; the port then marks the group broken
(``distributed.mark_broken``), so every later collective raises at once
instead of pairing with the collective the failed round left running
(a kept divergence).  A round on a group already broken raises.  Give
the coherence deadline more room than the watchdog's: a rank that
stalls one watchdog deadline in its attempt then still reaches the
round its peers wait in.

Configuration (read per call): ``RAMBA_COHERENCE`` ``on`` (default) |
``off`` | ``force``; ``RAMBA_COHERENCE_TIMEOUT_S`` (inside a flush, read
once for all its rounds: :func:`flush_scope`).
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
from typing import Dict, Optional

from ramba_tpu_torch.observe import events as _events
from ramba_tpu_torch.observe import registry as _registry

# Recovery-outcome codes, ordered by severity so a ``max`` round is
# "worst proposal wins".  These are the ladder/retry vocabulary; byte
# budgets and backend ids ride the same transport as plain ints.
P_OK = 0      # local attempt succeeded
P_RETRY = 1   # transient failure: re-attempt in place
P_DROP = 2    # degrade-class failure: move down one ladder rung
P_OOM = 3     # device memory exhaustion: evict, then drop a rung
P_FATAL = 4   # programming error / no way forward: abort everywhere

_DECISION_CLASS = {P_RETRY: "retryable", P_DROP: "degrade",
                   P_OOM: "oom", P_FATAL: "fatal"}
_DECISION_NAME = {P_OK: "ok", P_RETRY: "retry", P_DROP: "drop",
                  P_OOM: "oom", P_FATAL: "fatal"}

_CLASS_CODE = {"retryable": P_RETRY, "degrade": P_DROP, "oom": P_OOM,
               "fatal": P_FATAL}


class CoherentAbort(RuntimeError):
    """A peer rank's failure became this rank's failure: the agreement
    round decided a severity the local attempt did not observe, and the
    only coherent reaction is to fail the same way everywhere.

    ``coherent_classification`` routes the error through
    ``retry.classify`` (duck-typed there, like the watchdog's
    ``stall_classification``), so a CoherentAbort degrades/aborts the
    local ladder exactly as the remote original did on its rank."""

    def __init__(self, site: str, decision: int, cause: Optional[str] = None):
        self.site = site
        self.decision = int(decision)
        self.epoch = last_epoch(site)
        self.coherent_classification = _DECISION_CLASS.get(
            int(decision), "fatal")
        msg = (f"coherent abort at site {site!r} epoch {self.epoch}: "
               f"agreed decision "
               f"{_DECISION_NAME.get(int(decision), decision)!r} "
               f"(a peer rank's recovery outcome, consumed here so every "
               f"rank fails identically)")
        if cause:
            msg += f"; local context: {cause}"
        super().__init__(msg)


def classification_code(cls: str) -> int:
    """Map a retry/stall classification string to its proposal code."""
    return _CLASS_CODE.get(cls, P_FATAL)


def decision_class(decision: int) -> str:
    """Map an agreed decision code back to a retry classification."""
    return _DECISION_CLASS.get(int(decision), "fatal")


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------

# One lock serializes whole rounds within the process: epoch allocation
# and the collective itself.  Cross-rank round order must match anyway
# (the same SPMD assumption the device collectives already make); the
# lock keeps a second thread from splicing a round into the middle of
# another's collective.
_round_lock = threading.RLock()
_epochs: Dict[str, int] = {}
_pending: Dict[str, int] = {}
_overhead_s = 0.0

_nprocs_cache: Optional[int] = None


def invalidate() -> None:
    """Drop the cached process count (the process group just formed or a
    test rewired the environment)."""
    global _nprocs_cache
    with _round_lock:
        _nprocs_cache = None


def reset() -> None:
    """Drop epochs, pending proposals, and caches (tests)."""
    global _overhead_s, _nprocs_cache
    with _round_lock:
        _epochs.clear()
        _pending.clear()
        _overhead_s = 0.0
        _nprocs_cache = None


def mode() -> str:
    raw = (os.environ.get("RAMBA_COHERENCE") or "on").strip().lower()
    if raw in ("off", "0", "false", "no"):
        return "off"
    if raw == "force":
        return "force"
    return "on"


def _process_count() -> int:
    global _nprocs_cache
    n = _nprocs_cache
    if n is not None:
        return n
    _rank, n = _events.rank_info()
    with _round_lock:
        _nprocs_cache = n
    return n


def engaged() -> bool:
    """True when agreement rounds actually run: coherence is on and the
    job is multi-controller (or the loopback ``force`` mode is set)."""
    m = mode()
    if m == "off":
        return False
    if m == "force":
        return True
    return _process_count() > 1


_READ = object()  # the watchdog's deadline not read yet


def _timeout_s(watchdog=_READ) -> float:
    """A round's deadline in seconds, 0 for none:
    ``RAMBA_COHERENCE_TIMEOUT_S``, else the watchdog's (``watchdog``,
    when the caller read it already)."""
    raw = os.environ.get("RAMBA_COHERENCE_TIMEOUT_S")
    if raw:
        try:
            t = float(raw)
            if t > 0:
                return t
        except ValueError:
            pass
    if watchdog is _READ:
        from ramba_tpu_torch.resilience import elastic as _elastic

        watchdog = _elastic.watchdog_seconds()
    return watchdog or 0.0


# The rounds of one flush share one reading of the switches: the
# watchdog's deadline the flush read, and the round deadline resolved
# from it at the flush's first round (a list, so the helper threads the
# flush's attempts run on fill the same one).
_flush_deadline: contextvars.ContextVar = contextvars.ContextVar(
    "ramba_coherence_flush_deadline", default=None)


@contextlib.contextmanager
def flush_scope(watchdog_s: Optional[float]):
    """The extent of a flush that read the watchdog's deadline
    (``watchdog_s``) once: its rounds read the environment at most once
    more, for ``RAMBA_COHERENCE_TIMEOUT_S``, and only when one runs."""
    token = _flush_deadline.set([watchdog_s, None])
    try:
        yield
    finally:
        _flush_deadline.reset(token)


def _round_deadline() -> float:
    held = _flush_deadline.get()
    if held is None:
        return _timeout_s()
    if held[1] is None:
        held[1] = _timeout_s(held[0])
    return held[1]


def last_epoch(site: str) -> int:
    """The epoch of the most recent round at ``site`` (0 = never)."""
    with _round_lock:
        return _epochs.get(site, 0)


def epochs() -> Dict[str, int]:
    with _round_lock:
        return dict(_epochs)


# ---------------------------------------------------------------------------
# the round
# ---------------------------------------------------------------------------


def _transport(value: int, reduce: str) -> "tuple[int, int]":
    """One round: ``(decision, nbytes)``.  Loopback (``force`` mode, or
    no process group formed) reduces over the local proposal alone;
    across processes the proposal is all-reduced (max or min; ``bcast``:
    rank 0's value) over ``parallel.distributed``, under the round's
    deadline (:func:`agree`)."""
    from ramba_tpu_torch.parallel import distributed

    n = distributed.process_count()
    if n <= 1:
        return int(value), 4  # loopback: own proposal wins (one int32)
    if reduce == "bcast":
        mine = int(value) if distributed.in_driver() else 0
        # rank 0's value: the others contribute nothing to a sum
        return distributed.all_reduce_int(mine, "sum"), 8 * n
    return distributed.all_reduce_int(int(value), reduce), 8 * n


def agree(site: str, proposal: int, *, reduce: str = "max") -> int:
    """Run one agreement round at ``site`` and return the agreed
    decision.  Not engaged (coherence off, or one process in ``on``
    mode): returns ``proposal`` untouched — no epoch, no event, no
    traffic.

    Engaged: allocates the site's next epoch, runs the round under the
    coherence deadline, accounts its bytes
    (``distributed.coherence_bytes``) and emits a ``coherence`` event
    with site/epoch/proposal/decision.  A round that times out or whose
    transport fails returns the local proposal (``outcome="local"``) and
    breaks the group; a round on a broken group raises."""
    if reduce not in ("max", "min", "bcast"):
        raise ValueError(f"bad coherence reduce {reduce!r}")
    proposal = int(proposal)
    if not engaged():
        return proposal
    global _overhead_s
    from ramba_tpu_torch.parallel import distributed as _distributed
    from ramba_tpu_torch.resilience import elastic as _elastic

    with _round_lock:
        ep = _epochs.get(site, 0) + 1
        _epochs[site] = ep
        t0 = time.perf_counter()
        outcome = "agreed"
        try:
            decision, nbytes = _elastic.with_deadline(
                "coherence", lambda: _transport(proposal, reduce),
                timeout_s=_round_deadline())
        except (_elastic.GroupBrokenError, _elastic.AbandonedAttempt):
            raise
        except Exception as e:
            # the peer never joined the round (a dead rank, a wedged
            # transport): the local proposal, and the group is refused
            # from here on
            decision, nbytes = proposal, 0
            outcome = "local"
            err = f"{type(e).__name__}: {e}"[:200]
            _registry.inc("coherence.round_failures")
            _events.emit({"type": "coherence", "site": site, "epoch": ep,
                          "proposal": proposal, "decision": decision,
                          "reduce": reduce, "outcome": outcome,
                          "error": err})
            if _distributed.process_count() > 1:
                _distributed.mark_broken(f"coherence round {site!r} epoch "
                                         f"{ep} failed: {err}")
        dt = time.perf_counter() - t0
        _overhead_s += dt
    _registry.inc("coherence.rounds")
    _registry.inc(f"coherence.rounds.{site.split(':', 1)[0]}")
    if outcome == "agreed":
        _registry.inc("distributed.coherence_count")
        _registry.inc("distributed.coherence_bytes", int(nbytes))
        if decision != proposal:
            _registry.inc("coherence.overrides")
        _events.emit({"type": "coherence", "site": site, "epoch": ep,
                      "proposal": proposal, "decision": decision,
                      "reduce": reduce, "ms": round(dt * 1e3, 3)})
    return decision


def propose(site: str, code: int) -> None:
    """Park a rank-local proposal for ``site`` without communicating;
    the next :func:`decide` round at the site folds it in (severity-max).
    No-op when not engaged."""
    if not engaged():
        return
    with _round_lock:
        _pending[site] = max(_pending.get(site, 0), int(code))
        _registry.inc("coherence.proposals")


def decide(site: str, local: int, *, reduce: str = "max") -> int:
    """An agreement round that first merges any pending :func:`propose`
    signal for ``site`` into the local value (severity-max), then runs
    :func:`agree`.  The mid-ladder decision point."""
    if not engaged():
        return int(local)
    with _round_lock:
        pend = _pending.pop(site, None)
    if pend is not None:
        local = max(int(local), int(pend))
    return agree(site, local, reduce=reduce)


def report() -> dict:
    """Diagnostics section: mode, engagement, per-site epochs, pending
    proposals, and cumulative round overhead."""
    with _round_lock:
        return {
            "mode": mode(),
            "engaged": engaged(),
            "epochs": dict(_epochs),
            "pending": dict(_pending),
            "overhead_s": round(_overhead_s, 6),
        }
