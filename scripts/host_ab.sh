#!/bin/sh
# Host-time A/B of two checkouts on one card: chip_smoke.py's paths run in
# the order A, B, B, A, so a drift of the host during the call falls on
# both.  Each run's whole log goes to <out dir>/<n>-<path>.log; the
# per-sweep lines, the per-path walls and the run's total are printed.
#
#   sh scripts/host_ab.sh <checkout A> <checkout B> <out dir> [path ...]
#
# path: a flag of chip_smoke.py without its dashes (default: mesh layout),
# or "all" for the whole run, which starts from an empty kernel build
# directory as a fresh checkout does.
set -u
A=$1
B=$2
OUT=$3
shift 3
PATHS=${*:-mesh layout}
mkdir -p "$OUT"
OUT=$(cd "$OUT" && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
n=0
for d in "$A" "$B" "$B" "$A"; do
  n=$((n + 1))
  for p in $PATHS; do
    if [ "$p" = all ]; then
      rm -rf "$d/ramba_tpu_torch/_build"
      flag=
    else
      flag=--$p
    fi
    (cd "$d" && python3 chip_smoke.py $flag) > "$OUT/$n-$p.log" 2>&1
    echo "run $n: $d ${flag:-whole run} exit $?"
    grep -E "ms/sweep|walls by path|^total" "$OUT/$n-$p.log"
  done
done
