"""Effect-certified cross-flush result memoization (``RAMBA_MEMO``).

Counterpart of ``ramba_tpu/core/memo.py``.  The compile cache
(``fuser._compile_cache``) makes the *second* flush of a program
structure cheap; this cache makes it free — when, and only when, the
static certifier proves that is sound:

* the program's effect class is pure or RNG-keyed and it neither
  donates nor alias-escapes an input
  (:func:`ramba_tpu_torch.analyze.effects.classify_program`);
* its statics fold to value tokens, so it has a canonical semantic
  fingerprint (:func:`ramba_tpu_torch.analyze.canon.canonicalize`);
* every input binds to a *version token*: python scalars by value,
  tensors by identity-under-weakref AND their in-place version counter.
  Where the reference may take buffer identity for version identity
  (jax arrays are immutable), a torch tensor is mutable and ``fromarray``
  adopts a caller's tensor without a copy: ``t.add_(1)``, or a write
  through any view of ``t`` (views share their base's counter), bumps
  ``t._version`` and so changes the token.  The weakref death hook still
  retires a token before ``id()`` reuse can forge it, and a leaf the
  memory governor spilled comes back as a new tensor with a new token (a
  sound miss, as in the reference).

The memo key is ``(canonical hash, input tokens in canonical leaf
order, semantic fingerprint)`` — stable across leaf orderings, unlike
``program.key``.

Cached results are ``Const``-wrapped and registered with the memory
governor's ledger (``fuser.owner_incref``): the ledger accounts their
bytes, may spill them to the host, and a hit restores them.  A cached
tensor's own version is recorded too: a hit whose tensor was written in
place since is dropped and counted a miss (``stale_outputs``).  The
cache's own budget (``RAMBA_MEMO_BUDGET``, default 256m) bounds the
*logical* bytes it retains, LRU-evicted on insert; a result larger than
the whole budget is not retained at all (``oversize``; the reference
keeps it as the one entry).

Verification: the ``memo-safety`` rule (``analyze/rules.py``) audits
every flush-time plan; under ``RAMBA_VERIFY=strict`` an uncertified
plan aborts the flush before execution, and :func:`insert` additionally
refuses uncertified inserts even when rule filtering skipped the rule.
The ``memo:insert`` / ``memo:hit`` fault sites corrupt the certifier
into approving an impure program — the seeded violation the rule exists
to catch.

Batch CSE lives in the serve pipeline (``serve/pipeline.py``): a queued
flush looks the memo up again at dispatch, so tickets of one batch with
the same key share one execution.

The shared (fleet artifact) lane, as in the reference: with
``RAMBA_ARTIFACTS`` set (``fleet/artifacts.py``; ``RAMBA_MEMO_SHARED=0``
turns the lane off) and one process in the job, a certified plan also
carries a content-addressed key (``MemoPlan.shared_key``: the canonical
hash, each input's dtype, shape and bytes, the semantic fingerprint).  A
local miss probes the lane; a hit is uploaded to the process device and
promoted into the local cache (``memo.shared_hit``), and every certified
insert publishes its outputs there.  Inputs and outputs past the lane's
byte cap (``RAMBA_MEMO_SHARED_MAX``, 8m) are skipped before any copy off
the card.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import threading
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ramba_tpu_torch import common as _common
from ramba_tpu_torch.analyze import canon as _canon
from ramba_tpu_torch.analyze import effects as _effects
from ramba_tpu_torch.observe import events as _events
from ramba_tpu_torch.observe import registry as _registry
from ramba_tpu_torch.resilience import faults as _faults
from ramba_tpu_torch.resilience import memory as _memory
from ramba_tpu_torch.resilience.spill import SpilledArray as _SpilledArray

_OFF = ("", "0", "off", "false", "no")

def enabled() -> bool:
    """Result memoization armed?  Off by default — ``RAMBA_MEMO=1``."""
    return (os.environ.get("RAMBA_MEMO") or "").strip().lower() not in _OFF


def budget_bytes() -> int:
    """Logical-byte budget for retained results (``RAMBA_MEMO_BUDGET``,
    ``common.parse_bytes`` grammar, default 256m; ``0`` = unbounded)."""
    raw = os.environ.get("RAMBA_MEMO_BUDGET")
    if raw:
        try:
            return max(0, _common.parse_bytes(raw))
        except ValueError:
            pass
    return 256 << 20


def _nbytes(v: Any) -> int:
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    try:
        return int(v.nbytes)
    except Exception:
        return 0


@dataclasses.dataclass(frozen=True)
class MemoPlan:
    """One flush's memoization verdict, attached to ``_FlushWork`` and
    audited by the ``memo-safety`` verifier rule.

    ``memoizable`` is the operative decision (a fault site may force it
    True); ``certified`` is the certifier's genuine verdict — the two
    differ exactly when ``memo:insert``/``memo:hit`` injection seeded an
    impure program into the cache path.
    """

    memoizable: bool
    certified: bool
    reason: str
    chash: Optional[str]
    form: Optional[str]
    leaf_order: Tuple[int, ...]
    key: Optional[Tuple[Any, ...]]
    effects: Optional[_effects.EffectReport]
    #: content-addressed key for the fleet's shared memo lane; None when
    #: the lane is off, the job has several processes, or the inputs
    #: exceed the lane's byte cap
    shared_key: Optional[str] = None


# ---------------------------------------------------------------------------
# input version tokens
# ---------------------------------------------------------------------------

# id(value) -> (token, weakref).  The weakref death callback retires the
# token, so a recycled id() can never alias a dead buffer's version.
_tokens: Dict[int, Tuple[Any, Any]] = {}
_token_lock = threading.Lock()
_token_clock = itertools.count(1)


def _retire_token(key: int, ref: Any) -> None:
    with _token_lock:
        cur = _tokens.get(key)
        if cur is not None and cur[1] is ref:
            del _tokens[key]


def _version(v: Any) -> Optional[int]:
    """The in-place version counter of a tensor (shared with its views);
    None for a tensor that keeps none (an inference tensor)."""
    try:
        return int(v._version)
    except (AttributeError, RuntimeError):
        return None


def value_token(v: Any) -> Optional[Tuple[Any, ...]]:
    """Version token for one buffer input: its identity (a clock value
    bound under a weakref) and, for a tensor, its version counter (a
    one-element host tensor by its value instead).  None
    when the value cannot be tracked (not weak-referenceable, or a tensor
    without a version counter) — the program is then unmemoizable."""
    if isinstance(v, torch.Tensor):
        if v.numel() == 1 and v.device.type == "cpu":
            # one host value (a random draw's key): by value, so the same
            # seeded draw hits and a new seed misses; reading it moves
            # nothing off a card
            return ("val", str(v.dtype), tuple(v.shape), repr(v.item()))
        ver = _version(v)
        if ver is None:
            return None
    else:
        ver = 0
    k = id(v)
    with _token_lock:
        cur = _tokens.get(k)
        if cur is not None and cur[1]() is v:
            return cur[0] + (ver,)
        try:
            ref = weakref.ref(v, lambda r, _k=k: _retire_token(_k, r))
        except TypeError:
            return None
        token = ("buf", next(_token_clock))
        _tokens[k] = (token, ref)
        return token + (ver,)


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------


class _Entry:
    __slots__ = ("key", "consts", "nbytes", "hits", "seen")

    def __init__(self, key: Tuple[Any, ...], consts: List[Any],
                 nbytes: int) -> None:
        self.key = key
        self.consts = consts
        self.nbytes = nbytes
        self.hits = 0
        # (tensor, version) of each output as last served: a tensor
        # written in place since makes the entry stale
        self.seen = [(c.value, _version(c.value)) for c in consts]

    def stale(self) -> bool:
        for c, (t, ver) in zip(self.consts, self.seen):
            if c.value is t and isinstance(t, torch.Tensor) \
                    and _version(t) != ver:
                return True
        return False


class ResultCache:
    """Canonical-key LRU over Const-wrapped flush results.  dict
    preserves insertion order and hits re-insert, so iteration order is
    recency order and eviction pops the LRU — the compile cache's own
    discipline."""

    def __init__(self) -> None:
        self._entries: Dict[Tuple[Any, ...], _Entry] = {}
        self._lock = threading.Lock()
        self.total_bytes = 0
        self.reset_counters()

    def reset_counters(self) -> None:
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.evictions = 0
        self.insert_rejects = 0
        self.oversize = 0
        self.stale_outputs = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def lookup(self, key: Tuple[Any, ...]) -> Optional[List[Any]]:
        with self._lock:
            e = self._entries.pop(key, None)
            if e is None:
                self.misses += 1
                return None
            if e.stale():
                # a cached tensor was written in place: never serve it
                self.total_bytes -= e.nbytes
                self.evictions += 1
                self.stale_outputs += 1
                self.misses += 1
                stale = e
            else:
                stale = None
                self._entries[key] = e  # re-insert: MRU position
                e.hits += 1
                self.hits += 1
                consts = list(e.consts)
        if stale is not None:
            _release_entry(stale)
            _registry.inc("memo.stale_outputs")
            return None
        vals: List[Any] = []
        for c in consts:
            v = c.value
            if isinstance(v, _SpilledArray):
                v = _memory.restore(c)
            else:
                _memory.ledger.touch(v)
            vals.append(v)
        e.seen = [(v, _version(v)) for v in vals]
        return vals

    def insert(self, key: Tuple[Any, ...], outs: List[Any]) -> bool:
        from ramba_tpu_torch.core import fuser as _fuser
        from ramba_tpu_torch.core.expr import Const

        nbytes = sum(_nbytes(v) for v in outs)
        limit = budget_bytes()
        if limit and nbytes > limit:
            # larger than the whole budget: retaining it would evict
            # everything else and still break the bound
            with self._lock:
                self.oversize += 1
            _registry.inc("memo.oversize")
            return False
        consts = []
        for v in outs:
            c = Const(v)
            # ledger registration: the governor accounts (and may spill)
            # the buffer
            _fuser.owner_incref(c)
            consts.append(c)
        evicted: List[_Entry] = []
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                evicted.append(old)
                self.total_bytes -= old.nbytes
            self._entries[key] = _Entry(key, consts, nbytes)
            self.total_bytes += nbytes
            self.inserts += 1
            if limit:
                while self.total_bytes > limit and len(self._entries) > 1:
                    lru_key = next(iter(self._entries))
                    if lru_key == key:
                        break
                    lru = self._entries.pop(lru_key)
                    self.total_bytes -= lru.nbytes
                    self.evictions += 1
                    evicted.append(lru)
        for e in evicted:
            _release_entry(e)
        if evicted:
            _registry.inc("memo.evictions", len(evicted))
        return True

    def clear(self) -> None:
        with self._lock:
            dead = list(self._entries.values())
            self._entries.clear()
            self.total_bytes = 0
        for e in dead:
            _release_entry(e)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            looks = self.hits + self.misses
            return {
                "enabled": enabled(),
                "entries": len(self._entries),
                "bytes": self.total_bytes,
                "budget_bytes": budget_bytes(),
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": round(self.hits / looks, 4) if looks else 0.0,
                "inserts": self.inserts,
                "evictions": self.evictions,
                "insert_rejects": self.insert_rejects,
                "oversize": self.oversize,
                "stale_outputs": self.stale_outputs,
            }


def _release_entry(e: _Entry) -> None:
    from ramba_tpu_torch.core import fuser as _fuser

    for c in e.consts:
        _fuser.owner_decref(c.value)
    e.consts = []


#: Process-wide result cache.
cache = ResultCache()


def _shared_tier():
    """``fleet.artifacts`` when the cross-process shared memo lane is
    armed for this process, else None.  One environment read when the
    tier is off; one process only (under several ranks a rank served
    from the lane while its peers execute would leave the collective
    schedule)."""
    if not os.environ.get("RAMBA_ARTIFACTS"):
        return None
    if _events.rank_info()[1] != 1:
        return None
    try:
        from ramba_tpu_torch.fleet import artifacts as _artifacts
    except Exception:  # noqa: BLE001 — the tier must never break memo
        return None
    if not _artifacts.memo_shared_enabled():
        return None
    return _artifacts


def _shared_key(chash: str, leaf_order, leaf_vals: List[Any],
                tokens: Tuple[Any, ...], fingerprint) -> Optional[str]:
    """The lane's content key: tensors by their bytes, scalar leaves by
    their value tokens, in canonical leaf order."""
    tier = _shared_tier()
    if tier is None:
        return None
    parts = [tok if isinstance(tok, tuple) and tok and tok[0] == "s"
             else leaf_vals[slot] for slot, tok in zip(leaf_order, tokens)]
    return tier.content_key(chash, parts, fingerprint)


def evict(plan: Optional["MemoPlan"]) -> bool:
    """Drop one plan's cached entry (and its ledger refs).  The integrity
    plane calls this when a shadow audit disagreed with the primary
    result (``integrity.evict_plan_blobs``)."""
    if plan is None or plan.key is None:
        return False
    with cache._lock:
        e = cache._entries.pop(plan.key, None)
        if e is None:
            return False
        cache.total_bytes -= e.nbytes
        cache.evictions += 1
    _release_entry(e)
    _registry.inc("memo.evictions")
    return True


def reset() -> None:
    """Drop every cached result and its ledger refs, and zero the
    counters (tests)."""
    cache.clear()
    cache.reset_counters()
    with _token_lock:
        _tokens.clear()


# ---------------------------------------------------------------------------
# the flush-path API (fuser._flush_prepare / _flush_dispatch)
# ---------------------------------------------------------------------------


def _bind(leaf_order, leaf_vals: List[Any]) -> Optional[Tuple[Any, ...]]:
    """Version tokens of the inputs in canonical leaf order: a tensor by
    :func:`value_token`, a scalar leaf by its value's repr (the
    reference keys a scalar by value, where ``0.0 == -0.0``); None when
    one cannot be tracked."""
    tokens: List[Any] = []
    for slot in leaf_order:
        if slot >= len(leaf_vals):
            return None
        v = leaf_vals[slot]
        if isinstance(v, torch.Tensor):
            tok = value_token(v)
            if tok is None:
                return None
        elif isinstance(v, (bool, int, float, complex, np.generic)):
            # by repr: 0.0 == -0.0 (and hashes alike), but x * -0.0 is
            # not x * 0.0
            tok = ("s", type(v).__name__, repr(v))
        else:
            return None
        tokens.append(tok)
    return tuple(tokens)


def plan_for(program: Any, donate_key: Tuple[int, ...], leaves: List[Any],
             leaf_vals: List[Any]) -> Optional[MemoPlan]:
    """Certify one prepared flush.  Returns None when memoization is
    disarmed or the program is provably unmemoizable; otherwise a plan
    whose ``key`` binds the canonical hash to the current input
    versions (``leaves`` may be None: the values decide).  The
    ``memo:insert`` / ``memo:hit`` fault sites corrupt
    the certification (memoizable forced True) so the ``memo-safety``
    rule has a real violation to catch."""
    if not enabled():
        return None
    rep = _effects.classify_program(program, tuple(donate_key))
    memoizable = rep.memoizable
    for site in ("memo:insert", "memo:hit"):
        try:
            _faults.check(site)
        except _faults.InjectedFault:
            # certifier corruption: admit this program regardless of its
            # effect class — the seeded violation RAMBA_VERIFY's
            # memo-safety rule exists to catch.  Only reachable under
            # explicit fault injection.
            memoizable = True
    if not memoizable:
        _registry.inc("memo.uncacheable")
        return None
    form = _canon.try_canonicalize(program)
    if form is None:
        _registry.inc("memo.not_canonical")
        return None
    tokens = _bind(form.leaf_order, leaf_vals)
    if tokens is None:
        return None
    from ramba_tpu_torch.core import fuser as _fuser

    fingerprint = _fuser._semantic_fingerprint()
    shared_key = None
    if rep.memoizable:
        shared_key = _shared_key(form.chash, form.leaf_order, leaf_vals,
                                 tokens, fingerprint)
    return MemoPlan(
        memoizable=True,
        certified=rep.memoizable,
        reason=rep.reason,
        chash=form.chash,
        form=form.form,
        leaf_order=form.leaf_order,
        key=(form.chash, tokens, fingerprint),
        effects=rep,
        shared_key=shared_key,
    )


def plan_from_cert(chash: Optional[str], form: Optional[str],
                   leaf_order: Tuple[int, ...],
                   effects: Optional[_effects.EffectReport],
                   leaves: List[Any],
                   leaf_vals: List[Any]) -> Optional[MemoPlan]:
    """Rebuild a certified :class:`MemoPlan` from a plan certificate
    (``analyze/plancert.py``) without re-running effect classification
    or canonicalization — the certificate already vouches for both, and
    its invalidation signature proves the verdicts still hold.  Only the
    live state binds per flush: the per-input version tokens and the
    shared lane's content key.  Returns
    None when memoization is disarmed, the certificate carried no
    canonical hash, or an input cannot be version-tracked (same
    bail-outs as :func:`plan_for`)."""
    if not enabled() or chash is None:
        return None
    tokens = _bind(leaf_order, leaf_vals)
    if tokens is None:
        return None
    from ramba_tpu_torch.core import fuser as _fuser

    fingerprint = _fuser._semantic_fingerprint()
    return MemoPlan(
        memoizable=True,
        certified=True,
        reason="",
        chash=chash,
        form=form,
        leaf_order=tuple(leaf_order),
        key=(chash, tokens, fingerprint),
        effects=effects,
        shared_key=_shared_key(chash, leaf_order, leaf_vals, tokens,
                               fingerprint),
    )


def lookup(plan: Optional[MemoPlan]) -> Optional[List[Any]]:
    """Consult the result cache for a certified plan.  A hit returns the
    cached output values (restored from host spill when needed)."""
    if plan is None or not plan.memoizable or plan.key is None:
        return None
    vals = cache.lookup(plan.key)
    if vals is None:
        vals = _shared_lookup(plan)
        if vals is None:
            _registry.inc("memo.miss")
        return vals
    _registry.inc("memo.hit")
    _events.emit({
        "type": "memo_hit", "chash": plan.chash, "n_outs": len(vals),
    })
    return vals


def _shared_lookup(plan: MemoPlan) -> Optional[List[Any]]:
    """Probe the fleet's shared memo lane on a local miss.  A hit is
    uploaded to the process device and promoted into the local cache, so
    the next lookup never touches disk."""
    if plan.shared_key is None:
        return None
    tier = _shared_tier()
    if tier is None:
        return None
    arrays = tier.memo_load(plan.shared_key)
    if arrays is None:
        return None
    dev = _common.device()
    vals: List[Any] = [torch.from_numpy(np.require(a, requirements="C"))
                       .to(dev) for a in arrays]
    cache.insert(plan.key, vals)
    _registry.inc("memo.hit")
    _registry.inc("memo.shared_hit")
    _events.emit({
        "type": "memo_hit", "chash": plan.chash, "n_outs": len(vals),
        "tier": "shared",
    })
    return vals


def insert(plan: Optional[MemoPlan], outs: List[Any]) -> bool:
    """Insert one flush's outputs under the plan's key.  Strict-mode
    RAMBA_VERIFY refuses any insert the certifier did not approve —
    the backstop behind the memo-safety rule, effective even when rule
    filtering (RAMBA_VERIFY_RULES/_SKIP) bypassed the rule itself."""
    if plan is None or not plan.memoizable or plan.key is None:
        return False
    if not plan.certified:
        from ramba_tpu_torch.analyze import verifier as _verifier

        if _verifier.mode() == "strict":
            cache.insert_rejects += 1
            _registry.inc("memo.insert_rejected")
            _events.emit({
                "type": "memo_insert_rejected", "chash": plan.chash,
                "reason": plan.reason,
            })
            return False
    retained = cache.insert(plan.key, list(outs))
    if retained:
        _registry.inc("memo.insert")
    if plan.shared_key is not None and plan.certified:
        tier = _shared_tier()
        if tier is not None:
            # best-effort fleet publish: one replica's result becomes
            # every replica's shared-lane hit
            tier.memo_store(plan.shared_key, outs)
    return retained
