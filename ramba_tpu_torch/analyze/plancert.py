"""Proof-carrying plan certificates: the prepare-side verdict, snapshotted.

Counterpart of ``ramba_tpu/analyze/plancert.py``.  Every flush pays the
same host-side analysis pipeline — RAMBA_VERIFY rules, effect
classification, canonical hashing, compile-class proof, admission
estimate, autotune lookup — even for a program the process has analyzed
a million times.  Re-running a *static* analysis on an unchanged input
is pure waste — *if* you can prove the input really is unchanged.

This module supplies that proof:

* :class:`PlanCertificate` — a frozen snapshot of the full prepare-side
  verdict (verified-findings digest, effect certificate, canonical form
  + chash, compile-class token and its safety proof, admission byte
  estimate, autotune backend decision), each component stamped with the
  analysis version it was derived under (:func:`component_versions`).

* a **validity analysis** — :data:`RULE_SIGNATURE_DEPS` /
  :data:`COMPONENT_SIGNATURE_DEPS` statically map every verifier rule
  and analysis component to the ambient inputs it reads (mesh epoch,
  the x64 regime, the RAMBA_VERIFY rule set, the layouts of the
  canonical leaves, the memory governor's budget band, the autotune
  table generation, the compile-class policy).  The union over the
  rules/components that actually ran (:func:`signature_fields_for`) IS
  the certificate's invalidation signature: capture it at certification
  (:func:`capture_signature`), re-capture at lookup, and a hit is valid
  iff the two version vectors are equal — one tuple comparison on the
  hot path.  Everything *per-flush* (program structure, leaf avals,
  donation mask) lives in the cache key instead, so the signature only
  has to cover ambient state.

Where the port differs: its regime is fixed at x64 (the ``x64`` field is
always True, so it never invalidates), and a layout lives on the leaf
(``Const.sharding``), not on the tensor, so the ``shardings`` field
digests the leaves the flush gathered (a ``Const`` with no sharding is
the default layout of the mesh, which ``mesh_epoch`` covers).

The cache itself lives in ``core/plancache.py``; this module is the
analysis layer (pure functions, no flush-path state) so ``ramba-lint
--plan-audit`` can replay certificates offline without importing the
fuser.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

#: Version of the certificate schema + validity analysis itself.  Bump on
#: any change to the signature derivation: stamped into every
#: certificate's version vector, so stale schemas can never validate.
ANALYSIS_VERSION = 1

#: Ambient inputs a rule reads beyond the per-flush (program, avals,
#: donate) triple that already lives in the cache key.  This is the
#: static dependence analysis behind the invalidation signature: a rule
#: absent from this table is assumed pure in the key — adding a rule
#: with ambient reads MUST add its fields here (the plan-audit lane
#: cross-checks stored certificates against re-derived proofs, so a
#: missed dependence surfaces as a proof that no longer re-derives).
RULE_SIGNATURE_DEPS: Dict[str, Tuple[str, ...]] = {
    # donation legality is a pure function of donate mask + owner census,
    # both folded into the cache key
    "donation-hazard": (),
    # dtype promotion keys off the x64 regime (fixed in the port)
    "shape-dtype": ("x64",),
    # sharding legality reads the live mesh and each leaf's placement
    "sharding-legality": ("mesh_epoch", "shardings"),
    # the cache-key collision check folds the semantic fingerprint
    "graph-hygiene": ("x64",),
    # memo keys bind the semantic fingerprint; arming RAMBA_MEMO changes
    # whether a plan exists at all
    "memo-safety": ("x64", "memo"),
    # the bucket decision is pure in (program, shapes, policy) — only the
    # policy is ambient
    "compile-class": ("class_policy",),
}

#: Same analysis for the non-rule components of the prepare verdict.
COMPONENT_SIGNATURE_DEPS: Dict[str, Tuple[str, ...]] = {
    "effects": (),                       # pure in (program, donate)
    "canon": (),                         # pure in program structure
    "classes": ("class_policy",),
    "admission": ("budget_band",),
    "autotune": ("autotune_gen",),
    "memo": ("memo", "x64"),
    # a result stamps the mesh's layout; a new epoch invalidates the
    # fingerprint's meaning even when no rule reads the mesh
    "fingerprint": ("mesh_epoch", "x64"),
}

#: Every signature field the analysis can emit, in canonical order.
SIGNATURE_FIELDS: Tuple[str, ...] = (
    "ruleset", "mesh_epoch", "x64", "shardings", "budget_band",
    "autotune_gen", "class_policy", "memo",
)


# Hot-path memos: a lookup re-captures the signature on every flush, so
# the pure pieces (analysis versions are fixed for a process lifetime,
# ruleset digests are pure in (mode, rules), sharding reprs are pure in
# the sharding object) are computed once.  reset_caches() exists for
# tests that monkeypatch ANALYSIS_VERSION.
_versions_memo: Optional[Tuple[Tuple[str, int], ...]] = None
_ruleset_memo: Dict[Tuple[str, Tuple[str, ...]], str] = {}
_sharding_memo: Dict[Any, bytes] = {}
_signature_memo: Dict[Tuple[Any, ...], Tuple[Tuple[str, Any], ...]] = {}
_probe_mods: Optional[Tuple[Any, ...]] = None

#: Raw environment variables that, together with the cheap live probes
#: in :func:`_ambient_probe`, jointly determine every non-leaf signature
#: field.  Keep in sync with the ``_capture_field`` implementations —
#: a field reading a NEW ambient source must add its raw inputs here or
#: the memoized capture will serve stale values.
_AMBIENT_ENV = ("RAMBA_VERIFY", "RAMBA_VERIFY_RULES", "RAMBA_VERIFY_SKIP",
                "RAMBA_HBM_BUDGET", "RAMBA_HBM_WATERMARK", "RAMBA_MEMO")

# os.environ's backing dict skips the MutableMapping machinery for the
# six reads per flush, but its keys are platform-encoded (bytes on
# posix) — probe keys must go through the same encodekey, and probe
# values only need equality semantics so raw bytes are fine.
try:
    _ENV_DATA: Any = os.environ._data  # type: ignore[attr-defined]
    _ENV_KEYS: Tuple[Any, ...] = tuple(
        os.environ.encodekey(k)  # type: ignore[attr-defined]
        for k in _AMBIENT_ENV)
    _ENV_DATA.get  # the probe relies on dict.get semantics
except Exception:  # noqa: BLE001 — non-CPython or exotic os.environ
    _ENV_DATA, _ENV_KEYS = os.environ, _AMBIENT_ENV


def reset_caches() -> None:
    """Drop the pure-function memos (test hook)."""
    global _versions_memo
    _versions_memo = None
    _ruleset_memo.clear()
    _sharding_memo.clear()
    _signature_memo.clear()


def _ambient_probe() -> Optional[Tuple[Any, ...]]:
    """Cheap raw reads (env strings, epoch counters, the class policy,
    the governor's probed device budget) that jointly determine every
    non-``shardings`` signature field.  The
    probe keys :data:`_signature_memo` so the hot-path capture is a few
    attribute reads instead of re-parsing env vars and re-hashing the
    rule set each flush.  None means a probe source is unavailable —
    callers fall back to the unmemoized capture."""
    global _probe_mods
    if _probe_mods is None:
        try:
            from ramba_tpu_torch.compile import classes as _classes
            from ramba_tpu_torch.core import autotune as _autotune
            from ramba_tpu_torch.parallel import mesh as _mesh
            from ramba_tpu_torch.resilience import memory as _memory
            _probe_mods = (_mesh, _autotune, _classes, _memory)
        except Exception:  # noqa: BLE001 — partial import environments
            return None
    _mesh, _autotune, _classes, _memory = _probe_mods
    try:
        return (
            tuple(_ENV_DATA.get(k) for k in _ENV_KEYS),
            int(_mesh.mesh_epoch),
            int(_autotune.generation()),
            tuple(_classes.mode()),
            # the governor's probed device budgets: a new probe (reset,
            # first use on a card) changes the probe and forces one fresh
            # capture
            tuple(_memory._probe.values()),
        )
    except Exception:  # noqa: BLE001 — never let the probe break a flush
        return None


def component_versions() -> Tuple[Tuple[str, int], ...]:
    """(component, analysis-version) stamp for every analysis a
    certificate snapshots.  Modules may export ``ANALYSIS_VERSION``;
    absent means version 1.  Any bump invalidates via the ruleset
    signature field (the versions are folded into its digest)."""
    global _versions_memo
    if _versions_memo is not None:
        return _versions_memo
    from ramba_tpu_torch.analyze import canon as _canon
    from ramba_tpu_torch.analyze import effects as _effects
    from ramba_tpu_torch.analyze import rules as _rules
    from ramba_tpu_torch.compile import classes as _classes

    mods = (("plancert", globals()),
            ("rules", vars(_rules)),
            ("effects", vars(_effects)),
            ("canon", vars(_canon)),
            ("classes", vars(_classes)))
    _versions_memo = tuple((name, int(ns.get("ANALYSIS_VERSION", 1)))
                           for name, ns in mods)
    return _versions_memo


def signature_fields_for(rule_names: Sequence[str]) -> Tuple[str, ...]:
    """Statically derive the invalidation-signature fields for a flush
    verified under ``rule_names``: the union of every named rule's
    ambient reads plus every component's (all components always run on
    the miss path — effects/canon/classes/admission/autotune are
    snapshotted whether or not a rule audits them), ordered canonically.
    ``ruleset`` is always present: changing the rule selection (or any
    analysis version) must invalidate regardless of what else matched."""
    want = {"ruleset"}
    for name in rule_names:
        want.update(RULE_SIGNATURE_DEPS.get(name, ()))
    for deps in COMPONENT_SIGNATURE_DEPS.values():
        want.update(deps)
    return tuple(f for f in SIGNATURE_FIELDS if f in want)


def ruleset_token(mode: str, rule_names: Sequence[str]) -> str:
    """Digest of (verifier mode, enabled rules, analysis versions) — the
    ``ruleset`` signature field.  A certificate derived under one rule
    set can never validate under another."""
    key = (mode, tuple(rule_names))
    tok = _ruleset_memo.get(key)
    if tok is None:
        h = hashlib.sha256()
        h.update(repr((key[0], key[1], component_versions())).encode())
        tok = h.hexdigest()[:16]
        if len(_ruleset_memo) < 64:
            _ruleset_memo[key] = tok
    return tok


def sharding_digest(leaf_vals: Sequence[Any],
                    leaf_order: Sequence[int]) -> str:
    """Digest of the live shardings of the canonical leaves (program
    order when the program had no canonical form).  The port passes the
    leaves themselves (``Const.sharding``); ``str(sharding)`` of a
    ``NamedSharding`` is stable within a mesh epoch, and a leaf with no
    sharding contributes its type name."""
    parts: List[bytes] = []
    order = leaf_order if leaf_order else range(len(leaf_vals))
    for slot in order:
        try:
            v = leaf_vals[slot]
        except (IndexError, TypeError):
            parts.append(b"?")
            continue
        sh = getattr(v, "sharding", None)
        if sh is None:
            parts.append(type(v).__name__.encode())
            continue
        try:
            enc = _sharding_memo.get(sh)
        except TypeError:       # unhashable sharding type
            enc = None
        if enc is None:
            try:
                enc = str(sh).encode()
            except Exception:  # noqa: BLE001 — exotic sharding repr
                enc = type(sh).__name__.encode()
            try:
                if len(_sharding_memo) < 256:
                    _sharding_memo[sh] = enc
            except TypeError:
                pass
        parts.append(enc)
    return hashlib.sha256(b";".join(parts)).hexdigest()[:16]


def capture_signature(
    fields: Sequence[str],
    leaf_vals: Sequence[Any],
    leaf_order: Sequence[int],
    mode: Optional[str] = None,
    rule_names: Optional[Sequence[str]] = None,
) -> Tuple[Tuple[str, Any], ...]:
    """Capture the current value of every named signature field — the
    version vector.  Called once at certification and once per lookup;
    a hit is valid iff the two captures compare equal.

    The lookup-path capture (no mode/rule overrides) is memoized on the
    :func:`_ambient_probe`: every non-``shardings`` field is a pure
    function of the probe, so an unchanged probe replays the previous
    capture and only the leaf-dependent shardings digest is recomputed."""
    flds = tuple(fields)
    if mode is None and rule_names is None:
        probe = _ambient_probe()
        if probe is not None:
            memo_key = (flds, probe)
            base = _signature_memo.get(memo_key)
            if base is None:
                base = tuple(
                    (f, _capture_field(f, (), (), None, None))
                    for f in flds if f != "shardings")
                if len(_signature_memo) >= 32:
                    _signature_memo.clear()
                _signature_memo[memo_key] = base
            if "shardings" not in flds:
                return base
            sh = sharding_digest(leaf_vals, leaf_order)
            it = iter(base)
            return tuple(
                (f, sh) if f == "shardings" else next(it) for f in flds)
    out: List[Tuple[str, Any]] = []
    for f in flds:
        out.append((f, _capture_field(f, leaf_vals, leaf_order,
                                      mode, rule_names)))
    return tuple(out)


def _capture_field(
    field: str,
    leaf_vals: Sequence[Any],
    leaf_order: Sequence[int],
    mode: Optional[str],
    rule_names: Optional[Sequence[str]],
) -> Any:
    if field == "ruleset":
        from ramba_tpu_torch.analyze import verifier as _verifier

        m = _verifier.mode() if mode is None else mode
        names = (_verifier.enabled_rules() if rule_names is None
                 else list(rule_names))
        if m == "off":
            names = []
        return ruleset_token(m, names)
    if field == "mesh_epoch":
        from ramba_tpu_torch.parallel import mesh as _mesh

        return int(_mesh.mesh_epoch)
    if field == "x64":
        return True  # the port's regime is fixed
    if field == "shardings":
        return sharding_digest(leaf_vals, leaf_order)
    if field == "budget_band":
        from ramba_tpu_torch.resilience import memory as _memory

        budget = _memory.budget_bytes()
        if budget is None:
            return (-1, -1)
        return (int(budget), int(_memory.watermark_bytes(budget) or budget))
    if field == "autotune_gen":
        from ramba_tpu_torch.core import autotune as _autotune

        return int(_autotune.generation())
    if field == "class_policy":
        from ramba_tpu_torch.compile import classes as _classes

        return ":".join(str(p) for p in _classes.mode())
    if field == "memo":
        from ramba_tpu_torch.core import memo as _memo

        return bool(_memo.enabled())
    return None


def stale_fields(
    stored: Sequence[Tuple[str, Any]],
    fresh: Sequence[Tuple[str, Any]],
) -> Tuple[str, ...]:
    """The signature fields whose stored and fresh values diverge —
    the stale *causes* the plan-cache counters and ``--plan-audit``
    attribute misses to.  Empty iff the certificate is valid."""
    fresh_map = dict(fresh)
    out: List[str] = []
    for name, val in stored:
        if name not in fresh_map:
            out.append(name)
        elif fresh_map[name] != val:
            out.append(name)
    for name, _val in fresh:
        if name not in dict(stored) and name not in out:
            out.append(name)
    return tuple(out)


def findings_digest(
    counts: Sequence[Tuple[str, int]],
    ruleset: str,
) -> str:
    """Digest of the verified findings a certificate vouches for (by
    severity counts — error-bearing flushes are never certified, so the
    counts fully determine the replayable verdict) bound to the rule
    set that produced them."""
    h = hashlib.sha256()
    h.update(repr((tuple(sorted(counts)), ruleset)).encode())
    return h.hexdigest()[:16]


def aval_signature(leaf_vals: Sequence[Any]) -> Tuple[Any, ...]:
    """Per-leaf (shape, dtype, device) signature — the part of the cache
    key that distinguishes same-structure programs over different
    operand shapes (the device too: the kernels take only card
    tensors).  Scalar leaves contribute their Python type only: scalar
    *values* are runtime operands and affect no prepare-side analysis."""
    out: List[Any] = []
    for v in leaf_vals:
        shape = getattr(v, "shape", None)
        dtype = getattr(v, "dtype", None)
        if shape is None or dtype is None:
            out.append(("s", type(v).__name__))
        else:
            dev = getattr(v, "device", None)
            out.append(("a", tuple(int(d) for d in shape), str(dtype),
                        None if dev is None else str(dev)))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class PlanCertificate:
    """One program's full prepare-side verdict plus the proof of when it
    stops being true.  Immutable: a hit adopts fields, never mutates
    them.  ``effects`` holds the live :class:`~ramba_tpu_torch.analyze.effects.
    EffectReport` for in-process certificates and None for certificates
    adopted from the shared artifact tier (the memo plan rebuilt from a
    portable certificate carries no per-instr effect detail — only the
    certified verdict, which is what the insert backstop checks)."""

    label: str
    fingerprint: Optional[str]
    chash: Optional[str]
    canon_form: Optional[str]
    leaf_order: Tuple[int, ...]
    aval_sig: Tuple[Any, ...]
    donate_key: Tuple[int, ...]
    # verified-findings digest + per-severity counts (re-stamped on hits)
    finding_counts: Tuple[Tuple[str, int], ...]
    findings_digest: str
    # effect certificate
    effect_memoizable: bool
    effect_reason: str
    effect_class: str
    effects: Any
    # result-memo verdict (True iff a certified MemoPlan existed)
    memo_ok: bool
    # compile-class bucket + proof
    class_data: Optional[Tuple[Any, ...]]
    class_proof: str
    # admission byte estimate (analytic peak-live simulation)
    admit_est_bytes: int
    # autotune decision at certification time (informational; the
    # autotune_gen signature field invalidates when the table moves)
    autotune_backend: Optional[str]
    autotune_via: Optional[str]
    # provenance: per-component analysis versions + the rule set
    versions: Tuple[Tuple[str, int], ...]
    ruleset: Tuple[str, ...]
    # the invalidation signature (the validity proof)
    sig_fields: Tuple[str, ...]
    signature: Tuple[Tuple[str, Any], ...]


def to_payload(cert: PlanCertificate) -> Dict[str, Any]:
    """Portable (JSON-safe) form for the shared artifact tier and the
    trace's ``plan_cert`` events.  Drops the live EffectReport — a
    certificate crossing a process boundary carries verdicts, not
    objects."""
    return {
        "v": ANALYSIS_VERSION,
        "label": cert.label,
        "fingerprint": cert.fingerprint,
        "chash": cert.chash,
        "canon_form": cert.canon_form,
        "leaf_order": list(cert.leaf_order),
        "aval_sig": [list(a) if isinstance(a, tuple) else a
                     for a in cert.aval_sig],
        "donate": list(cert.donate_key),
        "finding_counts": [list(c) for c in cert.finding_counts],
        "findings_digest": cert.findings_digest,
        "effect": [cert.effect_memoizable, cert.effect_reason,
                   cert.effect_class],
        "memo_ok": cert.memo_ok,
        "class_data": (list(cert.class_data)
                       if cert.class_data is not None else None),
        "class_proof": cert.class_proof,
        "admit_est_bytes": cert.admit_est_bytes,
        "autotune": [cert.autotune_backend, cert.autotune_via],
        "versions": [list(v) for v in cert.versions],
        "ruleset": list(cert.ruleset),
        "sig_fields": list(cert.sig_fields),
        "signature": [[f, _freeze(v)] for f, v in cert.signature],
    }


def _freeze(v: Any) -> Any:
    if isinstance(v, tuple):
        return list(v)
    return v


def _thaw(v: Any) -> Any:
    if isinstance(v, list):
        return tuple(_thaw(x) for x in v)
    return v


def from_payload(obj: Dict[str, Any]) -> Optional[PlanCertificate]:
    """Reconstruct a portable certificate; None on schema mismatch or a
    malformed blob (a shared cache must only make things faster)."""
    try:
        if int(obj.get("v", -1)) != ANALYSIS_VERSION:
            return None
        effect = obj["effect"]
        aval_sig = tuple(_thaw(a) for a in obj["aval_sig"])
        class_data = obj.get("class_data")
        return PlanCertificate(
            label=str(obj["label"]),
            fingerprint=obj.get("fingerprint"),
            chash=obj.get("chash"),
            canon_form=obj.get("canon_form"),
            leaf_order=tuple(int(i) for i in obj["leaf_order"]),
            aval_sig=aval_sig,
            donate_key=tuple(int(i) for i in obj["donate"]),
            finding_counts=tuple((str(s), int(n))
                                 for s, n in obj["finding_counts"]),
            findings_digest=str(obj["findings_digest"]),
            effect_memoizable=bool(effect[0]),
            effect_reason=str(effect[1]),
            effect_class=str(effect[2]),
            effects=None,
            memo_ok=bool(obj["memo_ok"]),
            class_data=(tuple(_thaw(c) for c in class_data)
                        if class_data is not None else None),
            class_proof=str(obj["class_proof"]),
            admit_est_bytes=int(obj["admit_est_bytes"]),
            autotune_backend=obj["autotune"][0],
            autotune_via=obj["autotune"][1],
            versions=tuple((str(n), int(v)) for n, v in obj["versions"]),
            ruleset=tuple(str(r) for r in obj["ruleset"]),
            sig_fields=tuple(str(f) for f in obj["sig_fields"]),
            signature=tuple((str(f), _thaw(v))
                            for f, v in obj["signature"]),
        )
    except (KeyError, IndexError, TypeError, ValueError):
        return None


def rederive_check(
    cert: PlanCertificate,
    program: Any,
    donate: Iterable[int] = (),
) -> List[str]:
    """Audit-lane proof re-derivation: re-run the analyses a certificate
    snapshots and report every stored field the fresh derivation
    contradicts.  Empty list means the proof still re-derives.  Three
    legs, all replayable offline:

    * effect classification re-run against the (recorded) program vs the
      stored effect certificate;
    * the stored canonical form re-hashed vs the stored chash (a
      corrupted or hand-edited certificate fails here — recorded
      ``program`` events repr-truncate statics, so the *live* chash is
      deliberately NOT recomputed from them);
    * the findings digest re-derived from the stored counts + ruleset.

    Used by ``ramba-lint --plan-audit`` — a non-empty result means a
    stale analysis version or a corrupted certificate."""
    from ramba_tpu_torch.analyze import effects as _effects

    bad: List[str] = []
    try:
        rep = _effects.classify_program(program, tuple(donate))
    except Exception as e:  # noqa: BLE001 — unreadable program
        bad.append(f"effects-unreplayable:{type(e).__name__}")
    else:
        if bool(rep.memoizable) != cert.effect_memoizable:
            bad.append("effect_memoizable")
        if str(rep.program_class) != cert.effect_class:
            bad.append("effect_class")
    if cert.canon_form is not None and cert.chash is not None:
        rehash = hashlib.sha256(
            cert.canon_form.encode()).hexdigest()[:16]
        if rehash != cert.chash:
            bad.append("chash")
    ruleset_val = dict(cert.signature).get("ruleset", "")
    if findings_digest(cert.finding_counts, str(ruleset_val)) \
            != cert.findings_digest:
        bad.append("findings_digest")
    return bad
