"""Retry policy engine: backoff + jitter, per-site budgets, classification.

Counterpart of ``ramba_tpu/resilience/retry.py``.  Every wrapped call site
(the port's ``fileio`` reads and writes, checkpoint I/O, every rung of a
flush's degradation ladder) funnels through
:func:`call`, which:

1. classifies each failure as ``retryable`` / ``degrade`` / ``oom`` /
   ``fatal`` (:func:`classify`) — programming errors propagate unchanged;
2. sleeps exponential backoff with *deterministic* jitter (a hash of
   seed × site × attempt, not wall-clock randomness) so ranks back off
   identically and reruns reproduce;
3. gives up after the per-site attempt budget with
   :class:`RetryBudgetExhausted`, chaining the last real error
   (``__cause__``) so nothing is swallowed.

Budgets and timing come from the environment, read per call (cheap, and
monkeypatch-friendly):

* ``RAMBA_RETRY_ATTEMPTS``        total attempts per site (default 3)
* ``RAMBA_RETRY_<SITE>_ATTEMPTS`` per-site override (site uppercased,
  non-alphanumerics → ``_``; e.g. ``RAMBA_RETRY_CHECKPOINT_IO_ATTEMPTS``)
* ``RAMBA_RETRY_BASE_S``          first backoff delay (default 0.05)
* ``RAMBA_RETRY_MAX_S``           delay ceiling (default 2.0)
* ``RAMBA_RETRY_JITTER``          fractional jitter, 0..1 (default 0.5)

torch's errors, beside the reference's rules (:func:`classify`):

* ``torch.cuda.OutOfMemoryError`` (the caching allocator could not get
  device memory) → ``oom``: retrying the identical allocation in place
  would fail again.
* a CUDA error (``torch.AcceleratorError``, or a ``RuntimeError`` whose
  message carries ``CUDA error``: a failed or faulting kernel launch,
  an illegal address, a device-side assert) → ``fatal``: such an error
  poisons the CUDA context, so no later attempt in this process can
  succeed.  This rule comes before the message markers, so a launch
  failure whose text happens to say ``UNAVAILABLE`` is not retried.
* a failed kernel build (``_build.KernelBuildError``) → ``fatal``: the
  same source fails the same way, and the degradation ladder must not
  hide it behind a lower rung.
"""

from __future__ import annotations

import os
import random
import time
from typing import Callable, Optional

import torch

from ramba_tpu_torch import _build
from ramba_tpu_torch.observe import events as _events
from ramba_tpu_torch.observe import health as _health
from ramba_tpu_torch.observe import registry as _registry
from ramba_tpu_torch.resilience import coherence as _coherence
from ramba_tpu_torch.resilience import faults as _faults


class RetryBudgetExhausted(RuntimeError):
    """All attempts at a site failed; ``__cause__`` holds the last error."""


# Matched case-sensitively: status codes come through uppercase,
# and matching lowercase English ("unavailable", "aborted") would
# misclassify ordinary error prose — e.g. skeletons' "host fallback is
# unavailable under multi-controller execution" must stay fatal.
_RETRYABLE_MARKERS = (
    "DEADLINE_EXCEEDED", "UNAVAILABLE", "ABORTED", "CANCELLED", "INTERNAL: ",
    "Connection refused", "Connection reset", "Broken pipe",
    "Socket closed", "connection attempt timed out",
)
_OOM_MARKERS = (
    "RESOURCE_EXHAUSTED", "out of memory", "Out of memory", "OutOfMemory",
    "Resource exhausted",
)
# I/O errors where a retry cannot possibly change the outcome.
_FATAL_OS_ERRORS = (
    FileNotFoundError, IsADirectoryError, NotADirectoryError,
    PermissionError, FileExistsError,
)


def _is_cuda_error(exc: BaseException) -> bool:
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    return isinstance(exc, RuntimeError) and "CUDA error" in str(exc)


def classify(exc: BaseException) -> str:
    """Sort an exception into ``"retryable"`` (back off and re-attempt in
    place), ``"degrade"`` (re-attempting identically is pointless),
    ``"oom"`` (device memory exhaustion, real or injected),
    ``"redirect"`` (retryable *elsewhere*, not here: a replica refused
    or died), or ``"fatal"`` (propagate unchanged).  The duck-typed
    attributes below are the reference's; the port's errors that carry
    them come with the queues that raise them."""
    if isinstance(exc, RetryBudgetExhausted):
        return "degrade"
    # Fleet-level refusals carry their routing duck-typed: the work is
    # valid but THIS replica cannot serve it.  Checked before the shed
    # branch: redirect must win.
    if getattr(exc, "redirect_classification", None) is not None:
        return "redirect"
    # Coherent aborts (coherence.CoherentAbort) carry the fleet-agreed
    # class: a peer's failure consumed here must route exactly as the
    # original did on its rank.
    agreed = getattr(exc, "coherent_classification", None)
    if agreed in ("retryable", "degrade", "oom", "fatal"):
        return agreed
    # Watchdog stalls carry their routing with them (duck-typed).
    stall = getattr(exc, "stall_classification", None)
    if stall in ("retryable", "degrade", "fatal"):
        return stall
    # Overload sheds are deliberate drops: retrying or degrading a shed
    # defeats the shed.  Checked before the TimeoutError → retryable
    # branch below.
    if getattr(exc, "shed_classification", None) is not None:
        return "fatal"
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return "oom"
    if _is_cuda_error(exc) or isinstance(exc, _build.KernelBuildError):
        return "fatal"
    if isinstance(exc, _faults.InjectedResourceExhausted):
        return "oom"
    if isinstance(exc, _faults.InjectedFault):
        return "retryable" if exc.retryable else "fatal"
    if isinstance(exc, _FATAL_OS_ERRORS):
        return "fatal"
    if isinstance(exc, (OSError, TimeoutError, ConnectionError)):
        return "retryable"
    msg = str(exc)
    for marker in _OOM_MARKERS:
        if marker in msg:
            return "oom"
    for marker in _RETRYABLE_MARKERS:
        if marker in msg:
            return "retryable"
    return "fatal"


def is_retryable(exc: BaseException) -> bool:
    return classify(exc) == "retryable"


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


def _site_env(site: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in site.upper())


class RetryPolicy:
    __slots__ = ("attempts", "base_s", "max_s", "jitter", "seed")

    def __init__(self, attempts: int = 3, base_s: float = 0.05,
                 max_s: float = 2.0, jitter: float = 0.5, seed: int = 0):
        self.attempts = max(1, int(attempts))
        self.base_s = max(0.0, float(base_s))
        self.max_s = max(0.0, float(max_s))
        self.jitter = min(1.0, max(0.0, float(jitter)))
        self.seed = int(seed)

    def delay(self, site: str, attempt: int) -> float:
        """Backoff before re-attempt number ``attempt`` (1-based): capped
        exponential, jittered by a deterministic ±jitter/2 fraction."""
        base = min(self.max_s, self.base_s * (2.0 ** (attempt - 1)))
        if base <= 0.0:
            return 0.0
        if self.jitter <= 0.0:
            return base
        rng = random.Random(f"{self.seed}:{site}:{attempt}")
        frac = 1.0 + self.jitter * (rng.random() - 0.5)
        return base * frac


def policy_for(site: str) -> RetryPolicy:
    attempts = _env_int(f"RAMBA_RETRY_{_site_env(site)}_ATTEMPTS",
                        _env_int("RAMBA_RETRY_ATTEMPTS", 3))
    return RetryPolicy(
        attempts=attempts,
        base_s=_env_float("RAMBA_RETRY_BASE_S", 0.05),
        max_s=_env_float("RAMBA_RETRY_MAX_S", 2.0),
        jitter=_env_float("RAMBA_RETRY_JITTER", 0.5),
        seed=_env_int("RAMBA_FAULTS_SEED", 0),
    )


def _errstr(exc: BaseException) -> str:
    return f"{type(exc).__name__}: {exc}"[:300]


def call(site: str, fn: Callable, *, on_retry: Optional[Callable] = None,
         policy: Optional[RetryPolicy] = None, coherent: bool = False):
    """Run ``fn()`` under the site's retry policy.

    Retryable failures back off and re-attempt (running ``on_retry``
    between attempts, e.g. to tear down a half-formed client); anything
    else propagates unchanged.  When the budget runs out the last error
    is chained under :class:`RetryBudgetExhausted`.  A recovery after
    ≥1 retry is recorded in the health stream.

    ``coherent=True`` runs every attempt outcome through a cross-rank
    agreement round when the coherence layer is engaged: attempt counts
    advance in lockstep, a retry anywhere is a retry everywhere, and the
    terminal classification is agreed.  With one process (or coherence
    off) the flag is inert.
    """
    if coherent and _coherence.engaged():
        return _call_coherent(site, fn, on_retry=on_retry, policy=policy)
    pol = policy  # read from the environment at the first failure only
    attempt = 0
    while True:
        attempt += 1
        try:
            out = fn()
        except Exception as e:
            if classify(e) != "retryable":
                raise
            if pol is None:
                pol = policy_for(site)
            if attempt >= pol.attempts:
                _registry.inc("resilience.retry_exhausted")
                _registry.inc(f"resilience.retry_exhausted.{site}")
                _events.emit({"type": "degrade", "site": site,
                              "action": "exhausted", "attempts": attempt,
                              "error": _errstr(e)})
                raise RetryBudgetExhausted(
                    f"{site}: {attempt} attempt(s) failed; retry budget "
                    f"exhausted (last: {_errstr(e)})"
                ) from e
            delay = pol.delay(site, attempt)
            _registry.inc("resilience.retries")
            _registry.inc(f"resilience.retries.{site}")
            _events.emit({"type": "degrade", "site": site, "action": "retry",
                          "attempt": attempt, "delay_s": round(delay, 4),
                          "error": _errstr(e)})
            if on_retry is not None:
                try:
                    on_retry()
                except Exception:
                    pass
            if delay > 0:
                time.sleep(delay)
            continue
        if attempt > 1:
            _health.record_recovery(site, attempt - 1)
        return out


def _call_coherent(site: str, fn: Callable, *,
                   on_retry: Optional[Callable] = None,
                   policy: Optional[RetryPolicy] = None):
    """The coherent variant of :func:`call`: one agreement round per
    attempt at ``retry:<site>``, severity-max.  Every rank participates
    in every round — a rank whose attempt succeeded keeps its result and
    proposes ``P_OK``, but still consumes the round, so a peer's failure
    pulls the whole fleet through the same retry/degrade/abort sequence
    (same attempt numbers, same backoff sleeps, same terminal class)."""
    pol = policy or policy_for(site)
    rsite = f"retry:{site}"
    attempt = 0
    done = False
    out = None
    err: Optional[Exception] = None
    while True:
        attempt += 1
        if not done:
            err = None
            try:
                out = fn()
                done = True
            except Exception as e:
                err = e
        if err is None:
            my = _coherence.P_OK
        else:
            cls = classify(err)
            if cls == "retryable":
                my = _coherence.P_RETRY if attempt < pol.attempts \
                    else _coherence.P_DROP
            else:
                my = _coherence.classification_code(cls)
        d = _coherence.decide(rsite, my)
        if d == _coherence.P_OK:
            if attempt > 1:
                _health.record_recovery(site, attempt - 1)
            return out
        if d == _coherence.P_RETRY:
            delay = pol.delay(site, attempt)
            _registry.inc("resilience.retries")
            _registry.inc(f"resilience.retries.{site}")
            _events.emit({"type": "degrade", "site": site, "action": "retry",
                          "attempt": attempt, "delay_s": round(delay, 4),
                          "error": _errstr(err) if err is not None else None})
            if err is not None and on_retry is not None:
                try:
                    on_retry()
                except Exception:
                    pass
            if delay > 0:
                # every rank sleeps the (deterministic) backoff, failed or
                # not, so the fleet re-enters the next round together
                time.sleep(delay)
            continue
        # Terminal: every rank raises the agreed class together.
        if my == _coherence.P_DROP and err is not None \
                and classify(err) == "retryable":
            # this rank's own budget ran out — surface it the historical
            # way, chained under RetryBudgetExhausted (classified degrade)
            _registry.inc("resilience.retry_exhausted")
            _registry.inc(f"resilience.retry_exhausted.{site}")
            _events.emit({"type": "degrade", "site": site,
                          "action": "exhausted", "attempts": attempt,
                          "error": _errstr(err)})
            raise RetryBudgetExhausted(
                f"{site}: {attempt} attempt(s) failed; retry budget "
                f"exhausted (last: {_errstr(err)})"
            ) from err
        if err is not None and classify(err) == _coherence.decision_class(d):
            raise err  # the local failure IS the agreed failure
        raise _coherence.CoherentAbort(
            rsite, d, cause=_errstr(err) if err is not None else None)
