#!/bin/sh
# Host-time A/B of two checkouts on one card: chip_smoke.py's mesh_path and
# layout_path (star2 ms per sweep) run in the order A, B, B, A, so a drift
# of the host during the call falls on both.  Each run's whole log goes to
# <out dir>/<n>-<path>.log; the per-sweep lines are printed.
#
#   sh scripts/host_ab.sh <checkout A> <checkout B> <out dir>
set -u
A=$1
B=$2
OUT=$3
mkdir -p "$OUT"
OUT=$(cd "$OUT" && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
n=0
for d in "$A" "$B" "$B" "$A"; do
  n=$((n + 1))
  for p in mesh layout; do
    (cd "$d" && python3 chip_smoke.py --$p) > "$OUT/$n-$p.log" 2>&1
    echo "run $n: $d --$p exit $?"
    grep -E "ms/sweep" "$OUT/$n-$p.log"
  done
done
