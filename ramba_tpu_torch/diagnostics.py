"""Public observability surface: one import to see the whole system.

    import ramba_tpu_torch as rt
    rt.diagnostics.report()            # human-readable summary
    rt.diagnostics.counters()          # {"fuser.cache_miss": 3, ...}
    rt.diagnostics.last_flushes(5)     # newest-last flush spans
    rt.diagnostics.dump("state.json")  # machine-readable snapshot

Counterpart of ``ramba_tpu/diagnostics.py``: the counter registry, the
timers and the event ring (flush spans, health records) in one place,
with the memory governor, the cost ledger with its attribution section
(stage waterfalls, rooflines, the drift sentinel), the SLO histograms,
the elastic plane, the result memo, the plan cache, the integrity plane
and the observer tax.  ``serving_report`` and ``overload_report`` come
with serve sessions (ROADMAP A.10): they raise, and :func:`snapshot` and
:func:`report` leave their sections out.  ``python -m
ramba_tpu_torch.diagnostics [--json] [-o PATH]`` dumps the snapshot.
"""

from __future__ import annotations

import json
import os
import socket
import sys
from typing import Optional

from ramba_tpu_torch.observe import events as _events, registry as _registry

#: Version of the :func:`snapshot` JSON contract.  Bump on any change
#: that breaks a consumer of the dump (key renamed/removed, semantics
#: changed) — additive keys do NOT bump it.  The fleet collector
#: (observe/fleet.py) refuses to aggregate snapshots whose major version
#: differs from its own, so a mixed-version fleet degrades to "replica
#: skipped, reason=schema" instead of silently mis-merging counters.
SCHEMA_VERSION = 1


def identity() -> dict:
    """The process-identity block: who produced this snapshot.

    ``(host, pid, rank)`` names the replica; ``start_time_wall`` (plus
    its monotonic twin) distinguishes incarnations of a recycled pid;
    ``schema_version`` versions the contract the rest of the snapshot
    follows.  Stamped onto every snapshot, flight-recorder dump, and
    fleet spool file so federated tooling can join/dedup replicas."""
    try:
        from ramba_tpu_torch.observe import attrib as _attrib

        kind = _attrib.device_kind()
    except Exception:
        kind = None
    rank, nprocs = _events.rank_info()
    return {
        "schema_version": SCHEMA_VERSION,
        "host": socket.gethostname(),
        "pid": os.getpid(),
        "rank": rank,
        "nprocs": nprocs,
        "device_kind": kind,
        "start_time_wall": _registry.START_WALL,
        "start_time_mono": _registry.START_MONO,
    }


def counters() -> dict:
    """Copy of every named counter (see observe/registry.py for the
    naming convention)."""
    return dict(_registry.counters)


def last_flushes(n: int = 10) -> list:
    """The newest ``n`` flush spans from the in-memory ring (newest last).
    Each span carries label, instr count, cache hit/miss, compile vs
    execute seconds, byte totals, and per-compiled-call children."""
    return _events.last(n, type="flush")


def health_events(n: int = 10) -> list:
    return _events.last(n, type="health")


def resilience_events(n: int = 20) -> list:
    """Newest-last fault/degradation events — the same degradation
    timeline ``RAMBA_TRACE`` records (fault injections, per-site retries,
    ladder rung transitions, recoveries)."""
    return _events.last(n, type=("fault", "degrade"))


def memory_report(top: int = 5) -> dict:
    """Ledger snapshot from the memory governor: budget/watermark, live /
    spilled / pinned bytes, peak live bytes, eviction and restore counts,
    and the top-``top`` resident arrays by size — "what is eating my
    card memory" without reading trace JSONL.  All byte fields are 0/None on a
    budgetless backend until arrays materialize."""
    from ramba_tpu_torch.resilience import memory as _memory

    return _memory.ledger.snapshot(top=top)


def perf_report() -> dict:
    """Kernel cost ledger snapshot (see observe/ledger.py): one entry per
    compiled kernel — compile wall time, rolling execution stats
    (count/total/min/max/p50/p95), bytes in/out, cache hit/miss/evict,
    per-degradation-rung execution counts, the cost record (bytes, and
    flops where a kernel family counts them) — plus per-program flush wall-time
    windows and the slow-flush sentinel tally.  This is the capture
    format ``scripts/perf_diff.py`` compares.  When the backend
    autotuner is active (or has latched decisions), an ``autotune``
    section reports its mode, decision table, and race overhead.  When
    compile classes or the persistent AOT cache are in play, a
    ``compile`` section carries their counters plus the warm-vs-demand
    compile split (what the warm pool pre-paid vs. what requests
    paid)."""
    from ramba_tpu_torch.observe import ledger as _ledger

    snap = _ledger.snapshot()
    try:
        from ramba_tpu_torch.core import autotune as _autotune

        rep = _autotune.report()
        if rep.get("mode") != "off" or rep.get("decisions"):
            snap["autotune"] = rep
    except Exception:
        pass
    try:
        snap.update(_compile_section(snap))
    except Exception:
        pass
    try:
        from ramba_tpu_torch.observe import attrib as _attrib

        arep = _attrib.attribution_report()
        if arep:
            snap["attribution"] = arep
    except Exception:
        pass
    return snap


def _compile_section(perf_snap: dict) -> dict:
    """The ``compile`` section of :func:`perf_report`: compile-class and
    persist-cache snapshots plus the warm-vs-demand compile split summed
    over the kernel ledger.  Empty when the whole subsystem is idle so
    historical captures keep their shape."""
    from ramba_tpu_torch.compile import classes as _classes
    from ramba_tpu_torch.compile import persist as _persist

    csnap = _classes.snapshot()
    psnap = _persist.snapshot()
    total_c, total_s, warm_c, warm_s = 0, 0.0, 0, 0.0
    for k in perf_snap.get("kernels", {}).values():
        total_c += k.get("compiles", 0)
        total_s += k.get("compile_s", 0.0)
        warm_c += k.get("warm_compiles", 0)
        warm_s += k.get("warm_compile_s", 0.0)
    active = (csnap.get("mode") != "off" or csnap.get("planned")
              or csnap.get("bailouts") or psnap.get("armed")
              or psnap.get("hits") or psnap.get("misses") or warm_c)
    if not active:
        return {}
    return {"compile": {
        "classes": csnap,
        "persist": psnap,
        "compiles": {
            "total": total_c,
            "total_s": round(total_s, 6),
            "warm": warm_c,
            "warm_s": round(warm_s, 6),
            "demand": total_c - warm_c,
            "demand_s": round(total_s - warm_s, 6),
        },
    }}


SERVING = "serve sessions and their overload control: ROADMAP A.10"


def serving_report() -> dict:
    """Per-tenant serving rollup: comes with serve sessions (ROADMAP
    A.10)."""
    raise NotImplementedError(SERVING)


def overload_report() -> dict:
    """Overload-control rollup: comes with serve sessions (ROADMAP
    A.10)."""
    raise NotImplementedError(SERVING)


def elastic_report() -> dict:
    """Job-lifecycle rollup (resilience.elastic): watchdog arming,
    heartbeat liveness, stall / checkpoint / drain / resume counts."""
    from ramba_tpu_torch.resilience import elastic as _elastic

    return _elastic.report()


def lifecycle_events(n: int = 20) -> list:
    """Newest-last elastic lifecycle timeline — heartbeats excluded
    (they are volume); stalls, drains, checkpoints, resumes included."""
    return _events.last(n, type=("stall", "lifecycle"))


def slo_report() -> dict:
    """Per-tenant latency histogram snapshot + breach state (observe/slo):
    prepare/dispatch/e2e distributions with p50/p95/p99."""
    from ramba_tpu_torch.observe import slo as _slo

    return _slo.snapshot()


def memo_report() -> dict:
    """Result-memoization cache snapshot (core/memo.py): entry count,
    retained bytes vs RAMBA_MEMO_BUDGET, hit/miss/insert/eviction
    counters and the strict-mode insert rejections."""
    from ramba_tpu_torch.core import memo as _memo

    return _memo.cache.snapshot()


def plancache_report() -> dict:
    """Plan-certificate cache snapshot (core/plancache.py): certified
    entries, hit/miss/stale/forged counters, per-field stale causes and
    the derived fast-path hit rate."""
    from ramba_tpu_torch.core import plancache as _plancache

    return _plancache.snapshot()


def integrity_report() -> dict:
    """Data-integrity plane snapshot (resilience/integrity.py): digests
    stamped/verified, classified failures, shadow-audit verdicts and the
    rolling suspect-window state."""
    from ramba_tpu_torch.resilience import integrity as _integrity

    return _integrity.snapshot()


def observer_report() -> dict:
    """Observer-tax ledger snapshot (observe/observer.py): wall seconds
    the observability plane billed itself, per component, plus the tax
    as a fraction of attributed flush wall."""
    from ramba_tpu_torch.observe import observer as _observer

    return _observer.snapshot()


def snapshot() -> dict:
    """Everything, JSON-serializable: registry stores + the event ring.

    Each section is copied whole under its own lock, and ``captured_at``
    (+ its monotonic twin) stamps the capture once so exporter scrapes
    and flight-recorder dumps are attributable to one moment instead of
    one ambiguous interval."""
    import time as _time

    snap = _registry.snapshot()
    snap["schema_version"] = SCHEMA_VERSION
    snap["identity"] = identity()
    snap["captured_at"] = round(_time.time(), 6)
    snap["captured_mono"] = round(_time.monotonic(), 6)
    snap["events"] = _events.snapshot_ring()
    snap["memory"] = memory_report()
    snap["perf"] = perf_report()
    slo = slo_report()
    if any(slo.get("histograms", {}).values()):
        snap["slo"] = slo
    snap["elastic"] = elastic_report()
    memo = memo_report()
    if memo["enabled"] or memo["inserts"] or memo["hits"]:
        snap["memo"] = memo
    plan = plancache_report()
    if plan["enabled"] or plan.get("lookups") or plan.get("stores"):
        snap["plancache"] = plan
    integ = integrity_report()
    if integ["stamped"] or integ["failures"] or integ["audits"]:
        snap["integrity"] = integ
    obs = observer_report()
    if obs.get("components"):
        snap["observer"] = obs
    return snap


def report(file=None) -> None:
    """Human-readable one-shot summary to ``file`` (default stderr)."""
    from ramba_tpu_torch.utils import timing as _timing

    file = file or sys.stderr
    print("=== ramba_tpu_torch diagnostics ===", file=file)
    cs = counters()
    if cs:
        print("-- counters --", file=file)
        for k in sorted(cs):
            print(f"  {k:<40s} {cs[k]:>14,d}", file=file)
    hs = health_events()
    if hs:
        print("-- health --", file=file)
        for ev in hs:
            bits = [f"{k}={ev[k]}" for k in
                    ("platform", "device_count", "outcome", "init_seconds",
                     "selected_via", "error") if k in ev]
            print("  " + " ".join(bits), file=file)
    rs = resilience_events()
    if rs:
        print(f"-- resilience timeline (last {len(rs)}) --", file=file)
        for ev in rs:
            bits = [f"{k}={ev[k]}" for k in
                    ("site", "action", "attempt", "from", "to", "rung",
                     "mode", "error") if ev.get(k) is not None]
            print(f"  {ev.get('type', '?'):<8s}" + " ".join(bits), file=file)
    mem = memory_report()
    if mem["arrays"] or mem["evictions"] or mem["spilled_bytes"]:
        print("-- memory --", file=file)
        print(
            f"  live={mem['live_bytes']:,d}B"
            f" spilled={mem['spilled_bytes']:,d}B"
            f" pinned={mem['pinned_bytes']:,d}B"
            f" peak={mem['peak_live_bytes']:,d}B"
            f" evictions={mem['evictions']} restores={mem['restores']}"
            f" arrays={mem['arrays']}",
            file=file,
        )
        for row in mem["top"]:
            state = "spilled" if row["spilled"] else (
                "pinned" if row["pinned"] else "resident")
            print(
                f"    {row['nbytes']:>12,d}B {str(tuple(row['shape'])):<16s}"
                f" {row['dtype']:<10s} {state}",
                file=file,
            )
    perf = perf_report()
    if perf["kernels"]:
        rows = sorted(
            perf["kernels"].items(),
            key=lambda kv: kv[1]["exec"]["total_s"] + kv[1]["compile_s"],
            reverse=True,
        )[:8]
        print(f"-- kernels (top {len(rows)} of {len(perf['kernels'])}"
              f" by wall time, mode={perf['mode']}) --", file=file)
        for fp, k in rows:
            ex = k["exec"]
            rungs = ",".join(f"{r}:{n}" for r, n in sorted(k["rungs"].items()))
            line = (
                f"  {fp} {k['label']:<18s} x{ex['count']:<5d}"
                f" p50={ex['p50_s'] or 0:.4f}s p95={ex['p95_s'] or 0:.4f}s"
                f" compile={k['compile_s']:.4f}s"
                f" hit/miss/evict={k['cache']['hits']}/{k['cache']['misses']}"
                f"/{k['cache']['evicts']}"
            )
            if rungs:
                line += f" rungs={rungs}"
            if k.get("flops") is not None:
                line += f" flops={k['flops']:.3g}"
            print(line, file=file)
        if perf["slow_flushes"]:
            print(f"  slow flushes: {perf['slow_flushes']}", file=file)
    comp = perf.get("compile")
    if comp:
        print("-- compile --", file=file)
        c, p, t = comp["classes"], comp["persist"], comp["compiles"]
        print(
            f"  classes mode={c['mode']} planned={c['planned']}"
            f" padded={c['padded']} bailouts={c['bailouts']}"
            f" pad_waste={c['pad_waste_frac']:.1%}",
            file=file,
        )
        print(
            f"  persist armed={'yes' if p['armed'] else 'no'}"
            f" hits={p['hits']} corrupt={p['corrupt']} dir={p['dir']}",
            file=file,
        )
        print(
            f"  compiles total={t['total']} ({t['total_s']:.4f}s)"
            f" warm={t['warm']} ({t['warm_s']:.4f}s)"
            f" demand={t['demand']} ({t['demand_s']:.4f}s)",
            file=file,
        )
    attr = perf.get("attribution")
    if attr:
        print("-- attribution --", file=file)
        stages = " ".join(f"{k}={v:.4f}s"
                          for k, v in attr["stage_seconds"].items())
        print(f"  flushes={attr['flushes']} {stages}"
              f" unattributed={attr['unattributed_s']:.4f}s"
              f" ({attr['unattributed_frac']:.1%})", file=file)
        print(f"  device_kind={attr['device_kind'] or '?'}"
              f" peaks={attr['peaks']['peak_gbps']:g}GB/s"
              f"/{attr['peaks']['peak_tflops']:g}TFLOPs"
              f" ({attr['peaks']['source']})", file=file)
        roofs = sorted(attr["rooflines"].items(),
                       key=lambda kv: kv[1]["frac_of_peak"], reverse=True)[:8]
        for fp, r in roofs:
            print(f"  {fp} {r['label']:<18s} {r['bound']:<9s}"
                  f" peak={r['frac_of_peak']:.2%}"
                  f" bw={r['achieved_gb_per_s']:g}GB/s"
                  f" fl={r['achieved_tflops']:g}TFLOPs"
                  f" dev_p50={r['device_p50_s']:.6f}s"
                  f" ({r['device_time_source']})", file=file)
        sen = attr["sentinel"]
        if sen["regressions"] or sen["baselines"]:
            print(f"  sentinel baselines={sen['baselines']}"
                  f" regressions={sen['regressions']}"
                  f" factor={sen['drift_factor']:g}", file=file)
        samp = attr.get("sampling")
        if samp:
            fenced = sum(len(d.get("fenced_seqs", []))
                         for d in samp.get("fingerprints", {}).values())
            calls = sum(d.get("calls", 0)
                        for d in samp.get("fingerprints", {}).values())
            print(f"  sampling 1-in-{samp['sample_every']}"
                  f" fenced={fenced}/{calls} calls", file=file)
    obs = observer_report()
    if obs.get("components"):
        print("-- observer tax --", file=file)
        comps = " ".join(f"{k}={v['seconds']:.4f}s"
                         for k, v in obs["components"].items())
        frac = obs.get("tax_frac")
        frac_s = f" tax_frac={frac:.2%}" if frac is not None else ""
        print(f"  total={obs['total_s']:.4f}s{frac_s} {comps}", file=file)
    # incident explainer verdicts from the recent-event ring: the "why"
    # an operator should read before opening the flight record by hand
    whys = [e for e in _events.snapshot_ring() if e.get("why")]
    if whys:
        print("-- incident explainer --", file=file)
        for e in whys[-8:]:
            label = e.get("label") or e.get("tenant") or ""
            print(f"  {e.get('type', '?'):<16s} {label:<18s}"
                  f" {e['why']}", file=file)
    memo = memo_report()
    if memo["enabled"] or memo["inserts"] or memo["hits"]:
        print("-- result memo --", file=file)
        print(
            f"  entries={memo['entries']} bytes={memo['bytes']:,d}B"
            f" budget={memo['budget_bytes']:,d}B"
            f" hits={memo['hits']} misses={memo['misses']}"
            f" hit_rate={memo['hit_rate']:.1%}"
            f" inserts={memo['inserts']} evictions={memo['evictions']}"
            f" rejects={memo['insert_rejects']}",
            file=file,
        )
    plan = plancache_report()
    if plan["enabled"] or plan.get("lookups") or plan.get("stores"):
        print("-- plan cache --", file=file)
        print(
            f"  entries={plan['entries']}"
            f" hits={plan.get('hits', 0)}"
            f"+{plan.get('shared_hits', 0)}shared"
            f" misses={plan.get('misses', 0)}"
            f" hit_rate={plan['hit_rate']:.1%}"
            f" stores={plan.get('stores', 0)}"
            f" stale={plan.get('stale', 0)}"
            f" forged={plan.get('forged_stale', 0)}"
            f" adopted={plan.get('adopted', 0)}"
            f" published={plan.get('publishes', 0)}",
            file=file,
        )
        if plan["stale_causes"]:
            causes = " ".join(f"{c}={n}" for c, n in
                              sorted(plan["stale_causes"].items()))
            print(f"  stale causes: {causes}", file=file)
    el = elastic_report()
    lc = lifecycle_events()
    if (el["heartbeat_running"] or el["stalls"] or el["checkpoints"]
            or el["resumes"] or el["drains"] or lc):
        print("-- elastic lifecycle --", file=file)
        print(
            f"  watchdog_s={el['watchdog_s']}"
            f" heartbeat={'on' if el['heartbeat_running'] else 'off'}"
            f" beats={el['heartbeats']}"
            f" stalls={el['stalls']} drains={el['drains']}"
            f" checkpoints={el['checkpoints']} resumes={el['resumes']}",
            file=file,
        )
        for ev in lc:
            bits = [f"{k}={ev[k]}" for k in
                    ("site", "phase", "step", "waited_s", "classification",
                     "age_s", "freed_bytes", "wall_s")
                    if ev.get(k) is not None]
            print(f"  {ev.get('type', '?'):<10s}" + " ".join(bits), file=file)
    fl = last_flushes()
    if fl:
        print(f"-- last {len(fl)} flush span(s) --", file=file)
        for ev in fl:
            print(
                f"  {ev.get('label', '?'):<18s} instrs={ev.get('instrs', 0):<5d}"
                f" cache={ev.get('cache', '?'):<4s}"
                f" wall={ev.get('wall_s', 0.0):.4f}s"
                f" compile={ev.get('compile_s', 0.0):.4f}s"
                f" execute={ev.get('execute_s', 0.0):.4f}s",
                file=file,
            )
    _timing.timing_summary(file=file)
    _timing.print_comm_stats(file=file)


def dump(path: str) -> str:
    """Write ``snapshot()`` as JSON to ``path``; returns the path."""
    with open(path, "w") as f:
        json.dump(snapshot(), f, default=str)
    return path


def reset() -> None:
    """Clear counters, timers, the event ring, the kernel cost ledger,
    and the SLO histograms (tests/benchmarks)."""
    from ramba_tpu_torch.observe import ledger as _ledger
    from ramba_tpu_torch.observe import slo as _slo

    _registry.reset()
    _events.ring.clear()
    _ledger.reset()
    _slo.reset()


def main(argv=None) -> int:
    """``python -m ramba_tpu_torch.diagnostics`` — the machine-readable dump
    entrypoint.  ``--json`` writes one :func:`snapshot` object (the
    versioned contract external tooling and the fleet collector consume)
    to stdout or ``-o <path>``; without it, the human summary of
    :func:`report` goes to stdout."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m ramba_tpu_torch.diagnostics",
        description="Dump the process diagnostics snapshot "
                    f"(schema_version {SCHEMA_VERSION}).")
    ap.add_argument("--json", action="store_true",
                    help="emit the snapshot as one JSON object")
    ap.add_argument("-o", "--output", default=None, metavar="PATH",
                    help="write the JSON snapshot to PATH (implies --json)")
    args = ap.parse_args(argv)
    if args.output:
        dump(args.output)
        print(args.output)
    elif args.json:
        json.dump(snapshot(), sys.stdout, default=str)
        sys.stdout.write("\n")
    else:
        report(file=sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
