"""Graceful-degradation ladder for a flush's program.

Counterpart of ``ramba_tpu/resilience/degrade.py``.  When the fused
program keeps failing — a retry budget exhausted, or a device
out-of-memory error where re-running the identical program is pointless
— the flush walks down a ladder of rungs that each need less of the
card, instead of failing the program:

    fused  →  split  →  chunked  →  eager  →  host

* **fused**: the normal path — one program through the compile cache
  (the kernels or the generic lowering; a long program by segments).
* **split**: the same program through the segmented executor at half
  the segment size (``fuser._run_segmented``).
* **chunked**: the segmented executor bounded by estimated live *bytes*
  per segment (``fuser._run_chunked``, ``memory.chunk_target_bytes``).
  Admission (``memory.admit``) can start the ladder here, before
  anything has failed.
* **eager**: one torch op per instruction (``fuser.run_instructions``),
  no compile cache and no kernel family, synchronized on the card so an
  asynchronous CUDA failure lands inside the rung.
* **host**: the whole program on CPU tensors, its outputs placed back on
  the card (one process only).

An ``oom``-class failure (``torch.cuda.OutOfMemoryError`` or an injected
one) gets one recovery step before the ladder moves: the memory governor
spills cold arrays (``memory.evict_for_oom``), so the next rung starts
with more free memory.  Every rung runs under the retry engine, so a
transient failure is retried in place before the ladder moves at all.

The ladder never hides an error the retry engine calls ``fatal`` (a
programming error, a failed kernel build, a CUDA error): it raises from
the rung that hit it.  Every rung below the first is counted
(``resilience.degrade_steps``, ``resilience.degrade.<rung>``,
``resilience.degrade_recovered``) and emitted as a ``degrade`` event.
"""

from __future__ import annotations

import traceback
from typing import Callable, List, Optional, Tuple

from ramba_tpu_torch.observe import events as _events
from ramba_tpu_torch.observe import registry as _registry
from ramba_tpu_torch.resilience import coherence as _coherence
from ramba_tpu_torch.resilience import retry as _retry

#: Canonical rung order for the flush ladder.
LADDER = ("fused", "split", "chunked", "eager", "host")


def _drop_frames(err: Optional[BaseException]) -> None:
    """Clear the frames of a failed rung's traceback (and of the errors
    it chains): a held exception would otherwise keep every tensor of
    the failed attempt alive while the next rung runs."""
    seen = set()
    while err is not None and id(err) not in seen:
        seen.add(id(err))
        if err.__traceback__ is not None:
            traceback.clear_frames(err.__traceback__)
        err = err.__cause__ or err.__context__


def run_ladder(site: str, rungs: List[Tuple[str, Callable]], *,
               leaf_check: Optional[Callable[[], bool]] = None,
               tags: Optional[dict] = None,
               coherent: Optional[bool] = None):
    """Try ``rungs`` (ordered ``(name, thunk)`` pairs) until one succeeds.

    Each rung runs under ``retry.call(site, thunk)``.  Returns
    ``(result, rung_name)``.  Moves down a rung only for degrade-class
    and oom-class failures; fatal errors raise from the rung that hit
    them.  ``leaf_check`` (if given) must return True for the ladder to
    continue; torch has no buffer donation, so the fuser passes none,
    and the hook stays for callers whose inputs a failed attempt can
    consume.  ``tags`` ride on every degrade event.

    Across ranks with the coherence layer engaged, every rung outcome
    runs through a ``flush:rung`` agreement round (severity-max: the
    worst outcome of any rank wins): a rank whose attempt succeeded
    still drops with the others when a peer failed, and a fatal outcome
    anywhere aborts everywhere with the same class.  In one process the
    round is not run.  ``coherent=False`` keeps the ladder this rank's
    own (a rank-local flush inside a job of several processes); None
    follows ``coherence.engaged()``.
    """
    coh = _coherence.engaged() if coherent is None else coherent
    rsite = f"{site}:rung"
    n = len(rungs)
    last: Optional[Exception] = None
    prev_name: Optional[str] = None
    i = 0
    while i < n:
        name, thunk = rungs[i]
        if i > 0:
            _registry.inc("resilience.degrade_steps")
            _registry.inc(f"resilience.degrade.{name}")
            _events.emit({"type": "degrade", "site": site, "action": "rung",
                          "from": prev_name, "to": name,
                          "error": _retry._errstr(last) if last else None,
                          **(tags or {})})
        out = None
        err: Optional[Exception] = None
        my = _coherence.P_OK
        if coh and i > 0 and leaf_check is not None and not leaf_check():
            # this rank's inputs are gone, but the ranks agreed to drop
            # (a peer failed): propose a coherent abort
            err = last if last is not None else RuntimeError(
                f"{site}: inputs consumed before rung {name!r}")
            my = _coherence.P_FATAL
        else:
            try:
                out = _retry.call(site, thunk, coherent=coh)
            except Exception as e:
                err = e
                cls = _retry.classify(e)
                if cls == "fatal":
                    if not coh:
                        raise
                    my = _coherence.P_FATAL
                elif leaf_check is not None and not leaf_check():
                    if not coh:
                        raise
                    my = _coherence.P_FATAL
                else:
                    my = _coherence.P_OOM if cls == "oom" \
                        else _coherence.P_DROP
        decision = _coherence.decide(rsite, my) if coh else my
        if decision == _coherence.P_OK:
            if i > 0:
                _registry.inc("resilience.degrade_recovered")
                _events.emit({"type": "degrade", "site": site,
                              "action": "recovered", "rung": name,
                              **(tags or {})})
            return out, name
        if decision >= _coherence.P_FATAL or i + 1 >= n:
            # the raised class matches the agreed decision on every rank
            if err is not None and (not coh or _retry.classify(err) ==
                                    _coherence.decision_class(decision)):
                raise err
            raise _coherence.CoherentAbort(
                rsite, decision,
                cause=_retry._errstr(err) if err is not None else None)
        # nothing of the failed attempt may outlive it: its frames hold
        # every intermediate tensor it made
        _drop_frames(err)
        del out
        if decision == _coherence.P_OOM:
            # free device memory before the next rung runs (every rank,
            # across ranks: evict_for_oom agrees on the need)
            try:
                from ramba_tpu_torch.resilience import memory as _memory

                _memory.evict_for_oom(
                    err if err is not None
                    else _coherence.CoherentAbort(rsite, decision),
                    coherent=coh)
            except Exception:
                pass
        last = err if err is not None \
            else _coherence.CoherentAbort(rsite, decision)
        err = None
        prev_name = name
        i += 1
    raise last if last is not None else RuntimeError(
        f"{site}: empty ladder")
