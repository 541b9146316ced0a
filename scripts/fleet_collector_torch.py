#!/usr/bin/env python
"""Fleet collector CLI: read a RAMBA_FLEET_DIR snapshot spool and report.

Each ramba_tpu_torch process with ``RAMBA_FLEET_DIR`` set publishes an
atomic versioned snapshot of its diagnostics every
``RAMBA_FLEET_INTERVAL_S`` seconds (ramba_tpu_torch/observe/fleet.py).
This CLI is the reader side: run it anywhere the spool directory is
visible (a shared mount, an rsync target, the host itself); it touches no
device.

Usage:
    python scripts/fleet_collector_torch.py /srv/ramba-fleet
    python scripts/fleet_collector_torch.py /srv/ramba-fleet --json
    python scripts/fleet_collector_torch.py /srv/ramba-fleet --prom -
    python scripts/fleet_collector_torch.py /srv/ramba-fleet \
        --prom /var/lib/node_exporter/ramba_fleet.prom --watch 10

One-shot by default: prints the replica health table (state, reason,
snapshot age, publish seq) and the fleet rollup (merged per-tenant SLO
percentiles, goodput totals with per-replica rows, cache hit-rate
comparison, worst rooflines).  ``--json`` emits the same as one JSON
object.  ``--prom PATH`` writes the fleet Prometheus textfile atomically
(``-`` prints the exposition to stdout).  ``--watch N`` repeats every N
seconds until interrupted — the poor operator's dashboard.

Exit status encodes the fleet verdict for scripting: 0 all-healthy,
1 degraded, 2 stale, 3 dead replicas present, 4 empty/missing spool.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ramba_tpu_torch.observe import fleet  # noqa: E402

_EXIT = {fleet.HEALTHY: 0, fleet.DEGRADED: 1, fleet.STALE: 2, fleet.DEAD: 3}


def _pct(v):
    return "-" if v is None else f"{v:.1f}ms"


def print_report(directory: str, file=None, polled=None) -> int:
    file = file or sys.stdout
    # one spool read per tick: health and rollup come from the same
    # fleet.poll() pass the router consumes, so the two cannot drift
    polled = polled or fleet.poll(directory)
    h = polled["health"]
    print(f"== fleet {directory} ({len(h['replicas'])} replica(s), "
          f"fleet_state={h['fleet_state']}) ==", file=file)
    if not h["replicas"]:
        print("no spool documents found", file=file)
        return 4
    print(f"  {'replica':<32s} {'state':<9s} {'age':>8s} {'seq':>6s}  reason",
          file=file)
    order = {s: i for i, s in enumerate(fleet._SEVERITY)}
    for rep, row in sorted(h["replicas"].items(),
                           key=lambda kv: (order[kv[1]["state"]], kv[0])):
        age = "-" if row["age_s"] is None else f"{row['age_s']:.1f}s"
        seq = "-" if row["publish_seq"] is None else str(row["publish_seq"])
        print(f"  {rep:<32s} {row['state']:<9s} {age:>8s} {seq:>6s}  "
              f"{row['reason']}", file=file)

    roll = polled["rollup"]
    gp = roll["goodput"]
    print(f"goodput (over {len(roll['replicas'])} fresh replica(s)): "
          f"flushes={gp['flushes']} nodes={gp['nodes_flushed']} "
          f"serve={gp['serve_flushes']} shed={gp['shed_total']} "
          f"slo_breaches={gp['slo_breaches']}", file=file)
    for rep, row in sorted(gp["replicas"].items()):
        up = "-" if row["uptime_s"] is None else f"{row['uptime_s']:.0f}s"
        print(f"  {rep:<32s} flushes={row['flushes']:<8d} "
              f"shed={row['shed_total']:<6d} uptime={up}", file=file)
    for metric, tenants in sorted(roll["slo"].items()):
        for tenant, summ in sorted(tenants.items()):
            print(f"slo {metric} tenant={tenant or '(default)'}: "
                  f"n={summ.get('count', 0)} "
                  f"p50={_pct(summ.get('p50_ms'))} "
                  f"p95={_pct(summ.get('p95_ms'))} "
                  f"p99={_pct(summ.get('p99_ms'))}", file=file)
    if roll["caches"]:
        print("caches (compile / memo / persist):", file=file)
        for rep, row in sorted(roll["caches"].items()):
            jit = ("-" if row["jit_hit_rate"] is None
                   else f"{row['jit_hit_rate']:.0%}")
            memo = ("-" if row["memo_hit_rate"] is None
                    else f"{row['memo_hit_rate']:.0%}")
            print(f"  {rep:<32s} jit={jit:<5s} memo={memo:<5s} "
                  f"aot={row['aot_hits']}/{row['aot_hits'] + row['aot_misses']}",
                  file=file)
    for r in roll["rooflines"][:8]:
        print(f"roofline {r['label']:<18s} {r['bound']}-bound "
              f"{r['frac_of_peak']:.1%} of peak  "
              f"replica={r['replica']}", file=file)
    return _EXIT[h["fleet_state"]]


def run_once(args) -> int:
    polled = fleet.poll(args.fleet_dir)
    if args.json:
        out = {"health": polled["health"], "rollup": polled["rollup"]}
        json.dump(out, sys.stdout, indent=2, default=str)
        print()
        rc = (_EXIT[out["health"]["fleet_state"]]
              if out["health"]["replicas"] else 4)
    elif args.prom and not args.prom_also_report:
        rc = _EXIT[polled["health"]["fleet_state"]]
    else:
        rc = print_report(args.fleet_dir, polled=polled)
    if args.prom == "-":
        sys.stdout.write(fleet.render(args.fleet_dir))
    elif args.prom:
        fleet.write_textfile(args.prom, args.fleet_dir)
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Collect and report a ramba_tpu_torch fleet snapshot "
                    "spool."
    )
    ap.add_argument("fleet_dir", help="spool directory (RAMBA_FLEET_DIR)")
    ap.add_argument("--json", action="store_true",
                    help="emit health + rollup as one JSON object")
    ap.add_argument("--prom", metavar="PATH", default=None,
                    help="write the fleet Prometheus textfile atomically"
                         " ('-' prints the exposition to stdout)")
    ap.add_argument("--prom-also-report", action="store_true",
                    help="with --prom PATH, also print the human report")
    ap.add_argument("--watch", type=float, metavar="N", default=None,
                    help="repeat every N seconds until interrupted")
    args = ap.parse_args(argv)

    if args.watch:
        rc = 0
        try:
            while True:
                rc = run_once(args)
                time.sleep(max(0.1, args.watch))
        except KeyboardInterrupt:
            return rc
    return run_once(args)


if __name__ == "__main__":
    sys.exit(main())
