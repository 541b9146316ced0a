"""``ramba-lint``: offline static analysis over RAMBA_TRACE JSONL captures.

Counterpart of ``ramba_tpu/analyze/lint.py`` over the same event schema:
either package lints a trace the other recorded, with the same findings.

Usage::

    python -m ramba_tpu_torch.analyze /tmp/trace.jsonl [more.jsonl ...]
    python -m ramba_tpu_torch.analyze --json --strict trace.jsonl
    python -m ramba_tpu_torch.analyze --memo-audit trace.jsonl
    python -m ramba_tpu_torch.analyze --plan-audit trace.jsonl

Consumes the trace a run wrote under ``RAMBA_TRACE=<path>`` (per-rank
``.rank*`` siblings are auto-discovered).  Two sources of diagnostics:

1. ``finding`` events the flush-time verifier already emitted (any
   ``RAMBA_VERIFY`` mode) — summarized per rule and severity.
2. ``program`` events every traced flush records — re-checked offline with
   the rules that need only program structure (``graph-hygiene`` and
   ``donation-hazard``, including the cross-regime cache-key collision
   check: the same structural program captured under both x64 regimes in
   one trace is flagged when keyed without the semantic fingerprint).

Exit status: 0 on success, 1 under ``--strict`` when any error-severity
finding exists, 2 when no trace file was found.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, TextIO, Tuple

from ramba_tpu_torch.analyze.findings import Finding

#: Rules that can run from a recorded program event alone.
OFFLINE_RULES: Tuple[str, ...] = ("donation-hazard", "graph-hygiene")


class _RecordedProgram:
    """Duck-typed stand-in for ``fuser._Program`` built from a ``program``
    trace event — exactly the fields the offline-capable rules touch."""

    __slots__ = ("instrs", "n_leaves", "leaf_kinds", "out_slots", "key")

    def __init__(self, ev: Dict[str, Any]):
        self.instrs = tuple(
            (op, static, tuple(args)) for op, static, args in ev["instrs"]
        )
        self.n_leaves = int(ev["n_leaves"])
        self.leaf_kinds = tuple(ev.get("leaf_kinds", ""))
        self.out_slots = tuple(ev.get("out_slots", ()))
        self.key = (self.instrs, self.n_leaves, self.leaf_kinds,
                    self.out_slots)


def discover(path: str) -> List[str]:
    """The file itself, or its ``.rank*`` siblings (multi-controller)."""
    files = []
    if os.path.exists(path):
        files.append(path)
    files += sorted(glob.glob(glob.escape(path) + ".rank*"))
    return files


def load_events(path: str) -> List[Dict[str, Any]]:
    events: List[Dict[str, Any]] = []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError as e:
                print(f"{path}:{ln}: unparseable line ({e})",
                      file=sys.stderr)
    return events


def lint_events(
    events: Sequence[Dict[str, Any]],
) -> List[Tuple[str, Finding]]:
    """Re-run the offline-capable rules over every recorded program.
    Returns ``(program label, finding)`` pairs."""
    from ramba_tpu_torch.analyze import verifier as _verifier

    # Structure-only keying plus the *recorded* regime as the fingerprint:
    # flags traces (from code predating the fingerprinted cache key) where
    # one structural key served two numeric regimes.
    key_registry: Dict[Any, Any] = {}
    out: List[Tuple[str, Finding]] = []
    for ev in events:
        if ev.get("type") != "program":
            continue
        label = str(ev.get("label", "?"))
        try:
            prog = _RecordedProgram(ev)
        except Exception as e:
            out.append((label, Finding(
                "graph-hygiene", "warning", "program",
                f"unreadable program event: {type(e).__name__}: {e}",
            )))
            continue
        view = _verifier.ProgramView(
            program=prog,
            donate=tuple(ev.get("donate", ())),
            owners=tuple(ev.get("owners", ())),
            seg_size=0,  # segment replay needs live fuser sizing; skip
            key_fn=lambda p, d: (p.key, d),
            fingerprint=("x64", bool(ev.get("x64", False))),
            key_registry=key_registry,
        )
        for f in _verifier.verify_program(view, OFFLINE_RULES):
            out.append((label, f))
    return out


def render(
    path: str,
    events: Sequence[Dict[str, Any]],
    file: Optional[TextIO] = None,
) -> List[Tuple[str, Finding]]:
    """Print the lint report for one trace; returns the offline findings."""
    out = file or sys.stdout
    programs = [e for e in events if e.get("type") == "program"]
    flushes = [e for e in events if e.get("type") == "flush"]
    recorded = [e for e in events if e.get("type") == "finding"]
    print(f"== ramba-lint {path} ==", file=out)
    print(
        f"events: {len(events)}  flushes: {len(flushes)}  "
        f"programs recorded: {len(programs)}  "
        f"flush-time findings: {len(recorded)}",
        file=out,
    )

    if recorded:
        per = Counter(
            (e.get("rule", "?"), e.get("severity", "?")) for e in recorded
        )
        print("flush-time findings by rule:", file=out)
        for (rl, sev), n in sorted(per.items()):
            print(f"  {rl:<20s} {sev:<8s} x{n}", file=out)

    offline = lint_events(events)
    if programs and not offline:
        print(
            f"offline re-check: {len(programs)} program(s) clean "
            f"({', '.join(OFFLINE_RULES)})",
            file=out,
        )
    for label, f in offline:
        print(
            f"  {f.severity.upper():<7s} [{f.rule}] {label} {f.node}: "
            f"{f.message}",
            file=out,
        )
    if not programs and not recorded:
        print(
            "no program/finding events in this trace — capture with "
            "RAMBA_TRACE=<path> (and optionally RAMBA_VERIFY=1)",
            file=out,
        )
    return offline


def memo_audit(
    events: Sequence[Dict[str, Any]],
    file: Optional[TextIO] = None,
    top: int = 10,
) -> Dict[str, Any]:
    """Replay a trace's ``program`` events through the effect certifier
    and canonical hasher, and report the recurring canonical subgraphs a
    result cache (``RAMBA_MEMO``) would have deduplicated, beside the
    hits the live cache recorded (``memo_hit`` events).  The
    would-be hit rate assumes stable inputs (every repeat of a
    memoizable canonical form after the first is a hit) — an upper
    bound that sizes ``RAMBA_MEMO_BUDGET``, not a promise."""
    from ramba_tpu_torch.analyze import canon as _canon
    from ramba_tpu_torch.analyze import effects as _effects

    out = file or sys.stdout
    # mean out_bytes per label, from the flush spans, to size the budget
    label_bytes: Dict[str, List[int]] = {}
    for ev in events:
        if ev.get("type") == "flush" and "out_bytes" in ev:
            label_bytes.setdefault(str(ev.get("label", "?")), []).append(
                int(ev["out_bytes"]))

    groups: Dict[str, Dict[str, Any]] = {}
    total = unreadable = 0
    for ev in events:
        if ev.get("type") != "program":
            continue
        total += 1
        label = str(ev.get("label", "?"))
        try:
            prog = _RecordedProgram(ev)
            form = _canon.try_canonicalize(prog)
            rep = _effects.classify_program(
                prog, tuple(ev.get("donate", ())))
        except Exception:
            unreadable += 1
            continue
        chash = form.chash if form is not None else f"<uncanonical:{label}>"
        g = groups.setdefault(chash, {
            "chash": chash, "count": 0, "labels": Counter(),
            "memoizable": form is not None and rep.memoizable,
            "reason": rep.reason,
        })
        g["count"] += 1
        g["labels"][label] += 1
        if not (form is not None and rep.memoizable):
            g["memoizable"] = False
            g["reason"] = rep.reason if rep.reason != "ok" else "uncanonical"

    # the port's memo emits one ``memo_hit`` event a hit: the live count
    live_hits = sum(1 for ev in events if ev.get("type") == "memo_hit")
    would_hits = resident_bytes = 0
    for g in groups.values():
        sizes = [b for lbl, n in g["labels"].items()
                 for b in label_bytes.get(lbl, [])]
        g["mean_out_bytes"] = int(sum(sizes) / len(sizes)) if sizes else 0
        if g["memoizable"]:
            would_hits += g["count"] - 1
            resident_bytes += g["mean_out_bytes"]
    rate = would_hits / total if total else 0.0

    print("== memo audit ==", file=out)
    print(
        f"programs: {total}  canonical groups: {len(groups)}  "
        f"live hits: {live_hits}  "
        f"would-be hits: {would_hits}  would-be hit rate: {rate:.1%}"
        + (f"  unreadable: {unreadable}" if unreadable else ""),
        file=out,
    )
    ranked = sorted(groups.values(), key=lambda g: -g["count"])[:top]
    for g in ranked:
        label, _n = g["labels"].most_common(1)[0]
        verdict = ("memoizable" if g["memoizable"]
                   else f"uncacheable ({g['reason']})")
        print(
            f"  {g['chash']:<18s} x{g['count']:<5d} {verdict:<28s} "
            f"~{g['mean_out_bytes']}B/result  e.g. {label}",
            file=out,
        )
    if resident_bytes:
        print(
            f"budget guidance: one resident result per memoizable group "
            f"needs ~{resident_bytes} bytes — set RAMBA_MEMO_BUDGET at or "
            f"above this (default 256m) to avoid thrash",
            file=out,
        )
    elif total and not would_hits:
        print("no recurring memoizable subgraphs — RAMBA_MEMO would not "
              "help this workload", file=out)
    return {
        "programs": total,
        "groups": len(groups),
        "live_hits": live_hits,
        "would_hits": would_hits,
        "would_hit_rate": round(rate, 4),
        "resident_bytes": resident_bytes,
        "top": [{k: (dict(v) if isinstance(v, Counter) else v)
                 for k, v in g.items()} for g in ranked],
    }


def plan_audit(
    events: Sequence[Dict[str, Any]],
    file: Optional[TextIO] = None,
    top: int = 10,
) -> Dict[str, Any]:
    """Replay a trace's ``program`` events against its recorded plan
    certificates (``plan_cert`` events, ``analyze/plancert.py``):

    * the **would-be hit rate** a plan cache (``RAMBA_PLANCERT``) gets
      on this workload — every repeat of a certified canonical form
      after its certification is a would-be hit;
    * the **stale-signature causes** observed at runtime (``plan_stale``
      events), the reason repeats re-analyzed instead of hitting;
    * certificates whose **stored proof no longer re-derives** — the
      effect class or canonical hash recomputed offline contradicts the
      stored verdict, meaning a stale analysis version or a corrupted
      certificate (these would invalidate via the ruleset field live,
      but the audit names them explicitly)."""
    from ramba_tpu_torch.analyze import canon as _canon
    from ramba_tpu_torch.analyze import plancert as _plancert

    out = file or sys.stdout
    certs: Dict[str, Any] = {}
    for ev in events:
        if ev.get("type") != "plan_cert":
            continue
        cert = _plancert.from_payload(ev)
        if cert is not None and cert.chash is not None:
            certs.setdefault(cert.chash, cert)

    total = unreadable = covered = would_hits = live_hits = 0
    # each certificate's own certification flush is its first
    # occurrence: every covered repeat after it is a would-be hit
    seen: Counter = Counter({ch: 1 for ch in certs})
    rederive_failed: Dict[str, List[str]] = {}
    for ev in events:
        if ev.get("type") != "program":
            continue
        total += 1
        if ev.get("plan_cache"):
            live_hits += 1
        try:
            prog = _RecordedProgram(ev)
            form = _canon.try_canonicalize(prog)
        except Exception:
            unreadable += 1
            continue
        # hits record their chash; miss events fall back to the offline
        # recomputation (faithful when statics survive repr-truncation)
        chash = ev.get("chash") or (form.chash if form is not None
                                    else None)
        if chash is None or chash not in certs:
            continue
        covered += 1
        if seen[chash]:
            would_hits += 1
        seen[chash] += 1
        if chash not in rederive_failed:
            bad = _plancert.rederive_check(
                certs[chash], prog, tuple(ev.get("donate", ())))
            rederive_failed[chash] = bad

    stale_causes: Counter = Counter()
    stale_events = forged = 0
    for ev in events:
        if ev.get("type") != "plan_stale":
            continue
        stale_events += 1
        if ev.get("forged"):
            forged += 1
        for c in ev.get("causes", ()):
            stale_causes[str(c)] += 1

    broken = {ch: bad for ch, bad in rederive_failed.items() if bad}
    rate = would_hits / total if total else 0.0

    print("== plan audit ==", file=out)
    print(
        f"programs: {total}  certificates: {len(certs)}  "
        f"covered: {covered}  live hits: {live_hits}  "
        f"would-be hits: {would_hits}  would-be hit rate: {rate:.1%}"
        + (f"  unreadable: {unreadable}" if unreadable else ""),
        file=out,
    )
    if stale_events:
        causes = ", ".join(f"{c} x{n}"
                           for c, n in stale_causes.most_common())
        print(
            f"stale signatures: {stale_events} "
            f"(forged by plan:stale: {forged})  causes: {causes or '-'}",
            file=out,
        )
    for ch, cert in sorted(certs.items(),
                           key=lambda kv: -seen[kv[0]])[:top]:
        bad = broken.get(ch)
        verdict = (f"PROOF BROKEN ({', '.join(bad)})" if bad
                   else "proof re-derives")
        print(
            f"  {ch:<18s} x{seen[ch]:<5d} {verdict:<34s} "
            f"sig: {','.join(cert.sig_fields)}  e.g. {cert.label}",
            file=out,
        )
    if not certs:
        print(
            "no plan_cert events in this trace — capture with "
            "RAMBA_PLANCERT=1 RAMBA_TRACE=<path>",
            file=out,
        )
    return {
        "programs": total,
        "certificates": len(certs),
        "covered": covered,
        "live_hits": live_hits,
        "would_hits": would_hits,
        "would_hit_rate": round(rate, 4),
        "stale_events": stale_events,
        "forged_stale": forged,
        "stale_causes": dict(stale_causes),
        "proof_broken": {ch: list(bad) for ch, bad in broken.items()},
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="ramba-lint",
        description="Offline static analysis over RAMBA_TRACE JSONL "
                    "captures.",
    )
    ap.add_argument("paths", nargs="+",
                    help="trace file(s); .rank* siblings auto-discovered")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as JSON lines instead of text")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 if any error-severity finding exists")
    ap.add_argument("--memo-audit", action="store_true",
                    help="report recurring canonical subgraphs and the "
                         "would-be RAMBA_MEMO hit rate")
    ap.add_argument("--plan-audit", action="store_true",
                    help="replay program events against recorded plan "
                         "certificates: would-be RAMBA_PLANCERT hit "
                         "rate, stale-signature causes, proofs that no "
                         "longer re-derive")
    args = ap.parse_args(argv)

    files: List[str] = []
    for p in args.paths:
        found = discover(p)
        if not found:
            print(f"{p}: no trace file found", file=sys.stderr)
            return 2
        files += [f for f in found if f not in files]

    any_error = False
    for path in files:
        events = load_events(path)
        if args.memo_audit:
            if args.json:
                audit = memo_audit(events, file=open(os.devnull, "w"))
                print(json.dumps({"trace": path, **audit}))
            else:
                print(f"== ramba-lint {path} ==")
                memo_audit(events)
            continue
        if args.plan_audit:
            if args.json:
                audit = plan_audit(events, file=open(os.devnull, "w"))
                print(json.dumps({"trace": path, **audit}))
            else:
                print(f"== ramba-lint {path} ==")
                plan_audit(events)
            continue
        if args.json:
            offline = lint_events(events)
            for label, f in offline:
                print(json.dumps({"trace": path, "label": label,
                                  **f.as_event()}))
        else:
            offline = render(path, events)
        recorded_errs = any(
            e.get("type") == "finding" and e.get("severity") == "error"
            for e in events
        )
        offline_errs = any(f.severity == "error" for _lbl, f in offline)
        any_error = any_error or recorded_errs or offline_errs
    return 1 if (args.strict and any_error) else 0
