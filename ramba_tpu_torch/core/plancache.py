"""The verified prepare-side plan cache (``RAMBA_PLANCERT=1``).

Counterpart of ``ramba_tpu/core/plancache.py``.  ``analyze/plancert.py``
defines what a proof-carrying plan certificate *is*; this module is the
flush-path machinery that stores and redeems them.  A repeat flush whose
certificate validates skips the entire prepare-side analysis pipeline —
RAMBA_VERIFY rules, effect classification, canonical hashing,
compile-class proof, fingerprint derivation — behind one version-vector
comparison.

Design points:

* **Keyed per flush, signed per epoch.**  The cache key carries the
  per-flush inputs (program structure, leaf shape/dtype/device
  signature, donation mask); the certificate's invalidation signature
  carries the ambient ones (mesh epoch, x64, rule set, leaf layouts,
  budget band, autotune generation, class policy).  A hit re-captures
  only the signature.

* **Fault-forging flushes never certify.**  The donate-census /
  compile-bucket / memo-certifier fault sites deliberately corrupt the
  analyses a certificate snapshots; while any of them is armed the
  cache stands down entirely (lookups and stores), so a forged verdict
  can neither enter nor serve.  ``faults.configured`` is rank-identical,
  so ranks stand down in lockstep.

* **``plan:stale``** is this module's own fault site: it forges a
  stale-signature verdict onto an otherwise valid hit so strict mode's
  rejection path (raise) and warn mode's silent re-analysis are testable
  end-to-end.

* **Batched coherence.**  Ranks agree on hit counts via one
  ``coherence.agree()`` round per ``RAMBA_PLANCERT_AGREE`` hits (default
  16), not per flush; a divergent round clears the local cache so ranks
  re-converge through fresh analysis.  Across ranks only the whole
  program's verdict is certified (``core/rankflush.py``): its key reads
  global shapes, the same on every rank, so every rank hits together.

* **Shared tier.**  With ``RAMBA_ARTIFACTS`` set (``fleet/artifacts.py``)
  and one process in the job, the serve pipeline publishes every freshly
  certified plan by its canonical hash (:func:`publish`), and a local
  miss adopts a peer's certificate whose per-flush inputs match
  (``Hit.tier == "shared"``, ``plancache.shared_hit``);
  ``RAMBA_PLANCERT_SHARED=0`` keeps the tier off for certificates.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ramba_tpu_torch.analyze import plancert as _plancert
from ramba_tpu_torch.analyze.findings import Finding
from ramba_tpu_torch.core.memo import _OFF
from ramba_tpu_torch.observe import events as _events
from ramba_tpu_torch.observe import registry as _registry
from ramba_tpu_torch.resilience import coherence as _coherence
from ramba_tpu_torch.resilience import faults as _faults
from ramba_tpu_torch.resilience import integrity as _integrity

#: Fault sites that deliberately corrupt an analysis the certificate
#: snapshots — the cache stands down while any is armed.
_FORGE_SITES = ("donate_census", "compile:bucket", "memo:insert",
                "memo:hit")

#: Sentinel: the certificate's signature carries no ``shardings`` field
#: (the sharding-legality rule was disabled), so hits skip the digest.
_NO_SHARDING = object()


class _Entry:
    """One stored certificate plus its redemption fast path: the ambient
    probe captured when the certificate last validated and the expected
    shardings digest.  A lookup whose live probe equals ``probe`` and
    whose leaf shardings digest equals ``sharding`` is valid without
    re-building the signature vector (every non-shardings field is a
    pure function of the probe); any mismatch falls back to the full
    capture-and-compare, which self-heals ``probe`` on success (e.g. an
    env var rewritten to an equivalent spelling, or an adopted
    certificate whose home process had different ambient raw values)."""

    __slots__ = ("cert", "probe", "sharding", "sharding_objs", "hit")

    def __init__(self, cert: _plancert.PlanCertificate,
                 probe: Optional[Tuple[Any, ...]],
                 sharding_objs: Optional[Tuple[Any, ...]] = None):
        self.cert = cert
        self.probe = probe
        self.sharding = dict(cert.signature).get("shardings", _NO_SHARDING)
        # the live sharding objects the digest last validated against:
        # an equal tuple (identity fast path for the common repeat) is
        # proof the digest would match without rehashing
        self.sharding_objs = sharding_objs
        self.hit: Optional["Hit"] = None    # built on first redemption


def _sharding_objs(leaf_vals: Sequence[Any],
                   leaf_order: Sequence[int]) -> Optional[Tuple[Any, ...]]:
    """The live per-leaf sharding objects in canonical order (None on
    any indexing surprise); the port passes the leaves (``Const.sharding``).
    Compared by ``==`` against the tuple cached at the last digest
    validation — ``NamedSharding`` defines structural equality, and
    CPython's identity shortcut makes the steady-state compare a few
    pointer tests."""
    try:
        if leaf_order:
            return tuple(getattr(leaf_vals[s], "sharding", None)
                         for s in leaf_order)
        return tuple(getattr(v, "sharding", None) for v in leaf_vals)
    except (IndexError, TypeError):
        return None


_lock = threading.Lock()
_store: "OrderedDict[Tuple[Any, ...], _Entry]" = OrderedDict()
_stats: Dict[str, int] = {}
_stale_causes: Dict[str, int] = {}
_pending_hits = 0


def enabled() -> bool:
    """Plan-certificate cache armed?  Off by default — ``RAMBA_PLANCERT=1``."""
    return (os.environ.get("RAMBA_PLANCERT") or "").strip().lower() \
        not in _OFF


def strict() -> bool:
    """Does the current RAMBA_VERIFY mode reject (rather than re-analyze)
    a stale certificate?"""
    if not os.environ.get("RAMBA_VERIFY"):
        return False
    from ramba_tpu_torch.analyze import verifier as _verifier

    return _verifier.mode() == "strict"


def _max_entries() -> int:
    try:
        return max(1, int(os.environ.get("RAMBA_PLANCERT_MAX", "512")
                          or 512))
    except ValueError:
        return 512


def _agree_batch() -> int:
    try:
        return max(1, int(os.environ.get("RAMBA_PLANCERT_AGREE", "16")
                          or 16))
    except ValueError:
        return 16


def _bump(name: str, n: int = 1) -> None:
    _stats[name] = _stats.get(name, 0) + n


def _forgery_armed() -> bool:
    if not _faults.enabled():
        return False
    return any(_faults.configured(s) for s in _FORGE_SITES)


@dataclasses.dataclass(frozen=True)
class Hit:
    """One redeemed certificate.  ``tier`` is ``"hit"`` (the local store)
    or ``"shared"`` (adopted from the fleet artifact tier).  ``forged``
    marks a ``plan:stale`` fault-forged staleness verdict — the fuser
    rejects it under strict and silently re-analyzes under warn."""

    cert: _plancert.PlanCertificate
    tier: str
    forged: bool
    causes: Tuple[str, ...]


class _HashedKey:
    """Program-key wrapper carrying the hash computed once per program
    (``_Program.key_hash``): the instrs tuple is the large part of
    the cache key, and re-walking it for every dict operation would put
    an O(program) hash back on the redemption path the certificate just
    cleared."""

    __slots__ = ("key", "h")

    def __init__(self, key: Any, h: int):
        self.key = key
        self.h = h

    def __hash__(self) -> int:
        return self.h

    def __eq__(self, other: Any) -> bool:
        return self.key == getattr(other, "key", None)


def _key(program: Any, leaf_vals: Sequence[Any],
         donate_key: Tuple[int, ...]) -> Optional[Tuple[Any, ...]]:
    """Cache key: per-flush inputs only (ambient state lives in the
    certificate's signature).  None when the program has no key or the
    key is unhashable (``key_hash == -1`` — CPython ``hash()`` never
    returns -1) — such programs simply never certify."""
    try:
        kh = getattr(program, "key_hash", None)
        if kh is None:
            kh = hash(program.key)
        elif kh == -1:
            return None
        return (_HashedKey(program.key, kh),
                _plancert.aval_signature(leaf_vals), tuple(donate_key))
    except (AttributeError, TypeError):
        return None


def lookup(program: Any, leaf_vals: Sequence[Any],
           donate_key: Tuple[int, ...], label: str,
           leaves: Optional[Sequence[Any]] = None) -> Optional[Hit]:
    """Redeem a certificate for a prepared flush.  Returns None on miss
    or genuine staleness (both fall through to full analysis); a
    :class:`Hit` otherwise.  A genuine signature mismatch evicts, counts
    its causes, and emits a ``plan_stale`` trace event.  ``leaves`` are
    the flush's leaves, whose layouts the ``shardings`` field reads
    (default: ``leaf_vals``)."""
    if not enabled() or _forgery_armed():
        return None
    if leaves is None:
        leaves = leaf_vals
    key = _key(program, leaf_vals, donate_key)
    if key is None:
        return None
    tier = "hit"
    try:
        with _lock:
            _bump("lookups")
            entry = _store.get(key)
            if entry is not None:
                _store.move_to_end(key)
    except TypeError:       # unhashable program key — never certifiable
        return None
    if entry is None:
        entry = _adopt_shared(program, leaf_vals, donate_key, key)
        tier = "shared"
    if entry is None:
        with _lock:
            _bump("misses")
        _registry.inc("plancache.miss")
        return None
    cert = entry.cert
    # plan:stale — forge a stale-signature verdict onto a valid hit so
    # the strict rejection path is exercisable end-to-end.
    try:
        _faults.check("plan:stale", label=label)
    except _faults.InjectedFault:
        causes = cert.sig_fields or ("ruleset",)
        with _lock:
            _bump("forged_stale")
        _registry.inc("plancache.forged_stale")
        _emit_stale(label, cert, causes, forged=True)
        return Hit(cert=cert, tier=tier, forged=True, causes=causes)
    # Fast path: live ambient probe equals the probe this entry last
    # validated under, and the leaf shardings still match — every other
    # signature field is a pure function of the probe, so the
    # certificate is valid without rebuilding the vector.  Shardings
    # validate by object equality against the tuple the digest last
    # vouched for; only a changed tuple pays the rehash.
    valid = False
    probe = _plancert._ambient_probe()
    if probe is not None and probe == entry.probe:
        if entry.sharding is _NO_SHARDING:
            valid = True
        else:
            objs = _sharding_objs(leaves, cert.leaf_order)
            if objs is not None and objs == entry.sharding_objs:
                valid = True
            elif _plancert.sharding_digest(leaves, cert.leaf_order) \
                    == entry.sharding:
                valid = True
                entry.sharding_objs = objs
    if valid:
        causes: Tuple[str, ...] = ()
    else:
        fresh = _plancert.capture_signature(cert.sig_fields, leaves,
                                            cert.leaf_order)
        if fresh == cert.signature:
            causes = ()
            # self-heal the fast path
            entry.probe = probe
            entry.sharding_objs = _sharding_objs(leaves, cert.leaf_order)
        else:
            causes = _plancert.stale_fields(cert.signature, fresh) \
                or ("ruleset",)
    if causes:
        with _lock:
            _store.pop(key, None)
            _bump("stale")
            _bump("misses")
            for c in causes:
                _stale_causes[c] = _stale_causes.get(c, 0) + 1
        _registry.inc("plancache.stale")
        _emit_stale(label, cert, causes, forged=False)
        return None
    with _lock:
        _bump("hits" if tier == "hit" else "shared_hits")
    _registry.inc("plancache.hit" if tier == "hit"
                  else "plancache.shared_hit")
    _note_hit()
    hit = entry.hit
    if hit is None or hit.tier != tier:
        hit = Hit(cert=cert, tier=tier, forged=False, causes=())
        entry.hit = hit
    return hit


def _emit_stale(label: str, cert: _plancert.PlanCertificate,
                causes: Sequence[str], forged: bool) -> None:
    ev: Dict[str, Any] = {
        "type": "plan_stale", "label": label, "causes": list(causes),
        "forged": bool(forged),
    }
    if cert.chash is not None:
        ev["chash"] = cert.chash
    _events.emit(ev)


def stale_findings(hit: Hit, label: str) -> List[Finding]:
    """The error findings a strict-mode flush raises for a certificate
    whose signature no longer validates."""
    return [Finding(
        rule="plan-stale",
        severity="error",
        node="program",
        message=(
            f"plan certificate for {label!r} failed signature validation "
            f"(stale fields: {', '.join(hit.causes) or '?'}); strict mode "
            "rejects rather than trusting a stale verdict"
        ),
    )]


# ---------------------------------------------------------------------------
# certification (the miss path)
# ---------------------------------------------------------------------------


def certify(work: Any) -> Optional[_plancert.PlanCertificate]:
    """Snapshot a fully-analyzed, verifier-clean flush as a certificate
    and store it.  Called by ``fuser._prepare`` after the verifier ran
    on the miss path; returns None (and stores nothing) when the flush
    is ineligible — error findings, forging faults armed, or an
    unkeyable program.  ``work`` carries the flush's ``program``,
    ``leaves``, ``leaf_vals``, ``donate_key``, ``span``, ``label``,
    ``fingerprint``, ``memo_plan`` and ``class_plan``."""
    if not enabled() or _forgery_armed():
        return None
    program = work.program
    leaf_vals = work.leaf_vals
    leaves = work.leaves
    donate_key = tuple(work.donate_key)
    key = _key(program, leaf_vals, donate_key)
    if key is None:
        return None
    span = work.span or {}
    counts: Dict[str, int] = dict(span.get("findings") or {})
    if counts.get("error"):
        return None
    from ramba_tpu_torch.analyze import verifier as _verifier

    if os.environ.get("RAMBA_VERIFY"):
        vmode = _verifier.mode()
        rule_names: List[str] = (
            _verifier.enabled_rules() if vmode != "off" else [])
    else:
        vmode, rule_names = "off", []

    mp = work.memo_plan
    effects_rep: Any = None
    if mp is not None:
        chash: Optional[str] = mp.chash
        form: Optional[str] = mp.form
        leaf_order: Tuple[int, ...] = tuple(mp.leaf_order)
        effects_rep = mp.effects
        memo_ok = bool(mp.certified)
    else:
        chash, form, leaf_order, memo_ok = None, None, (), False
    if effects_rep is None:
        from ramba_tpu_torch.analyze import effects as _effects

        try:
            effects_rep = _effects.classify_program(program, donate_key)
        except Exception:  # noqa: BLE001 — no report, no certificate
            return None
    if chash is None:
        from ramba_tpu_torch.analyze import canon as _canon

        try:
            cf = _canon.try_canonicalize(program)
        except Exception:  # noqa: BLE001
            cf = None
        if cf is not None:
            chash, form, leaf_order = cf.chash, cf.form, tuple(cf.leaf_order)

    cp = work.class_plan
    class_data: Optional[Tuple[Any, ...]] = None
    class_proof = ""
    if cp is not None:
        from ramba_tpu_torch.compile import classes as _classes

        class_data = (tuple(cp.token), int(cp.n), int(cp.bucket),
                      tuple(cp.pad_slots), int(cp.pad_waste_bytes))
        class_proof = hashlib.sha256(
            repr((class_data, _classes.mode())).encode()).hexdigest()[:16]

    admit_est = 0
    try:
        from ramba_tpu_torch.resilience import memory as _memory

        admit_est = int(_memory.estimate_program_bytes(
            program, leaf_vals, donate_key))
    except Exception:  # noqa: BLE001 — estimate is advisory
        admit_est = 0

    at_backend: Optional[str] = None
    at_via: Optional[str] = None
    try:
        from ramba_tpu_torch.core import autotune as _autotune

        d = _autotune.decision(work.fingerprint) \
            if work.fingerprint else None
        if d is not None:
            at_backend, at_via = d.get("backend"), d.get("via")
    except Exception:  # noqa: BLE001
        pass

    sig_fields = _plancert.signature_fields_for(rule_names)
    signature = _plancert.capture_signature(
        sig_fields, leaves, leaf_order, mode=vmode,
        rule_names=rule_names)
    ruleset_digest = dict(signature).get("ruleset", "")
    finding_counts = tuple(sorted(counts.items()))
    cert = _plancert.PlanCertificate(
        label=work.label,
        fingerprint=work.fingerprint,
        chash=chash,
        canon_form=form,
        leaf_order=leaf_order,
        aval_sig=key[1],
        donate_key=donate_key,
        finding_counts=finding_counts,
        findings_digest=_plancert.findings_digest(
            finding_counts, str(ruleset_digest)),
        effect_memoizable=bool(effects_rep.memoizable),
        effect_reason=str(effects_rep.reason),
        effect_class=str(effects_rep.program_class),
        effects=effects_rep,
        memo_ok=memo_ok,
        class_data=class_data,
        class_proof=class_proof,
        admit_est_bytes=admit_est,
        autotune_backend=at_backend,
        autotune_via=at_via,
        versions=_plancert.component_versions(),
        ruleset=tuple(rule_names),
        sig_fields=sig_fields,
        signature=signature,
    )
    try:
        with _lock:
            _store[key] = _Entry(
                cert, _plancert._ambient_probe(),
                _sharding_objs(leaves, cert.leaf_order))
            _store.move_to_end(key)
            cap = _max_entries()
            while len(_store) > cap:
                _store.popitem(last=False)
                _bump("evictions")
            _bump("stores")
    except TypeError:       # unhashable program key — never certifiable
        return None
    _registry.inc("plancache.store")
    if _events.trace_enabled():
        ev = _plancert.to_payload(cert)
        ev["type"] = "plan_cert"
        _events.emit(ev)
    return cert


def class_plan_from(cert: _plancert.PlanCertificate) -> Optional[Any]:
    """Rebuild the compile-class plan a certificate vouches for.  The
    stored proof bound (token, policy) at certification; the
    ``class_policy`` signature field already proved the policy unchanged,
    so the plan is reconstructible without re-running the op-safety
    walk."""
    if cert.class_data is None:
        return None
    from ramba_tpu_torch.compile import classes as _classes

    token, n, bucket, pad_slots, pad_waste = cert.class_data
    try:
        return _classes.ClassPlan(tuple(token), int(n), int(bucket),
                                  tuple(pad_slots), int(pad_waste))
    except Exception:  # noqa: BLE001 — fall back to fresh planning
        return None


# ---------------------------------------------------------------------------
# shared artifact tier (fleet/artifacts.py)
# ---------------------------------------------------------------------------


def _shared_tier() -> Optional[Any]:
    """``fleet.artifacts`` when the cross-process certificate lane is
    armed for this process, else None (one environment read when the
    tier is off).  One process only, as the shared memo lane: a
    half-warmed artifact directory must not split the ranks' hit and
    miss decisions."""
    if not os.environ.get("RAMBA_ARTIFACTS"):
        return None
    if (os.environ.get("RAMBA_PLANCERT_SHARED") or "1").strip().lower() \
            in _OFF:
        return None
    if _events.rank_info()[1] != 1:
        return None
    try:
        from ramba_tpu_torch.fleet import artifacts as _artifacts
    except Exception:  # noqa: BLE001 — the tier must never break flushes
        return None
    if not _artifacts.armed():
        return None
    return _artifacts


#: integrity-envelope schema tag for shared certificate blobs
CERT_SCHEMA = "plancert.json"


def _cert_path(tier: Any, chash: str) -> str:
    return os.path.join(tier.artifacts_dir(), "plancert", f"{chash}.json")


def publish(cert: Optional[_plancert.PlanCertificate]) -> bool:
    """Write a certificate to the shared artifact tier (keyed by chash)
    so peer replicas can adopt it.  The serve pipeline calls this for
    every freshly certified plan; best-effort, never raises, False while
    the tier is off."""
    if getattr(cert, "chash", None) is None or not enabled():
        return False
    tier = _shared_tier()
    if tier is None:
        return False
    try:
        data = json.dumps(_plancert.to_payload(cert),
                          sort_keys=True).encode()
    except (TypeError, ValueError):
        return False
    if not tier.store_blob(_cert_path(tier, cert.chash),
                           _integrity.wrap(data, CERT_SCHEMA)):
        return False
    with _lock:
        _bump("publishes")
    _registry.inc("plancache.publish")
    return True


def _adopt_shared(program: Any, leaf_vals: Sequence[Any],
                  donate_key: Tuple[int, ...],
                  key: Tuple[Any, ...]) -> Optional["_Entry"]:
    """On a local miss, probe the shared tier by chash and adopt a peer's
    certificate when its per-flush inputs match these exactly.  Pays one
    canonicalization and installs the adopted certificate locally, so
    repeats are plain hits.  A corrupt blob is evicted, never raised."""
    tier = _shared_tier()
    if tier is None:
        return None
    from ramba_tpu_torch.analyze import canon as _canon

    try:
        cf = _canon.try_canonicalize(program)
    except Exception:  # noqa: BLE001
        return None
    if cf is None:
        return None
    raw = tier.load_blob(_cert_path(tier, cf.chash))
    if raw is None:
        return None
    try:
        payload = _integrity.unwrap(raw, CERT_SCHEMA, site="plancert:blob")
    except _integrity.IntegrityError:
        tier.evict(_cert_path(tier, cf.chash))
        return None
    try:
        obj = json.loads(payload.decode())
    except (ValueError, UnicodeDecodeError) as e:
        _integrity.failure("plancert:blob", "deserialize",
                           detail=repr(e)[:200], chash=cf.chash)
        tier.evict(_cert_path(tier, cf.chash))
        return None
    cert = _plancert.from_payload(obj)
    if cert is None:
        tier.evict(_cert_path(tier, cf.chash))
        return None
    # per-flush inputs must match exactly; ambient state is checked by
    # the caller's signature comparison like any local hit
    if cert.aval_sig != key[1] or cert.donate_key != tuple(donate_key):
        return None
    if cert.versions != _plancert.component_versions():
        return None
    # probe None: the home process's ambient raw values are unknown, so
    # the first redemption validates through the full signature compare
    entry = _Entry(cert, None)
    try:
        with _lock:
            _store[key] = entry
            _store.move_to_end(key)
            cap = _max_entries()
            while len(_store) > cap:
                _store.popitem(last=False)
            _bump("adopted")
    except TypeError:       # unhashable program key — never certifiable
        return None
    _registry.inc("plancache.adopted")
    return entry


# ---------------------------------------------------------------------------
# batched coherence (ROADMAP 2b, hits only)
# ---------------------------------------------------------------------------


def _note_hit() -> None:
    """Per-hit bookkeeping for the epoch-batched coherence round: the
    agree() exchange is deferred until RAMBA_PLANCERT_AGREE hits have
    accumulated, so multi-controller ranks pay the collective once per
    batch instead of once per flush."""
    global _pending_hits
    if not _coherence.engaged():
        return
    with _lock:
        _pending_hits += 1
        due = _pending_hits >= _agree_batch()
    if due:
        flush_agree()


def flush_agree() -> None:
    """Run the deferred hit-count agreement round now (batch boundary,
    tests, or drain).  Ranks propose their batch hit count; a rank
    seeing a smaller agreed count than its own has hits its peers did
    not — it clears its local certificates and re-converges through
    fresh analysis."""
    global _pending_hits
    with _lock:
        n = _pending_hits
        _pending_hits = 0
    if n <= 0 or not _coherence.engaged():
        return
    agreed = _coherence.agree("plan:hits", n, reduce="min")
    with _lock:
        _bump("agree_rounds")
    if agreed < n:
        with _lock:
            _store.clear()
            _bump("divergences")
        _registry.inc("plancache.divergence")
        _events.emit({
            "type": "plan_divergence", "proposed": int(n),
            "agreed": int(agreed),
        })


# ---------------------------------------------------------------------------
# introspection
# ---------------------------------------------------------------------------


def snapshot() -> Dict[str, Any]:
    """Point-in-time view for diagnostics/bench: counters, stale causes,
    and the derived hit rate (hits + shared hits over lookups)."""
    with _lock:
        s = dict(_stats)
        causes = dict(_stale_causes)
        size = len(_store)
        pending = _pending_hits
    lookups = s.get("lookups", 0)
    hits = s.get("hits", 0) + s.get("shared_hits", 0)
    return {
        "enabled": enabled(),
        "entries": size,
        "pending_agree_hits": pending,
        "hit_rate": (hits / lookups) if lookups else 0.0,
        "stale_causes": causes,
        **s,
    }


def reset() -> None:
    """Drop every certificate and counter (tests)."""
    global _pending_hits
    with _lock:
        _store.clear()
        _stats.clear()
        _stale_causes.clear()
        _pending_hits = 0
