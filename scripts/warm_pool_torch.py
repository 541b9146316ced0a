#!/usr/bin/env python
"""Replay a RAMBA_TRACE capture's hottest programs through the compile
pipeline of ramba_tpu_torch before opening to traffic: the CLI of
``ramba_tpu_torch.compile.warmpool``.

    # yesterday's shift recorded a trace; warm tomorrow's process:
    RAMBA_CACHE=/var/cache/ramba python scripts/warm_pool_torch.py \
        --trace /var/log/ramba/trace.jsonl --top-k 8

The trace's ``program`` events (each with its fingerprint and compile
class) are ranked by arrival count, re-weighted by the live ledger,
resolved against the persistent cache's program skeletons, and each
submitted through ``CompilePipeline.submit_warm``: the program is rebuilt
and launched once on zero-filled examples on the card, so its kernel
library is loaded and its plan made.  Warm work takes round-robin turns
with live traffic and is the first load shed under brownout
(``serve.warm_shed``).  Exit status is 0 even when warm-ups fail: a
failed warm-up is a lost opportunity, not an error.  In a real server,
call ``warmpool.warm`` in the serving process itself: the libraries and
plans a warm-up makes live in the process that made them.
"""

import argparse
import json
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", required=True,
                    help="RAMBA_TRACE JSONL capture to rank programs from")
    ap.add_argument("--top-k", type=int, default=8,
                    help="warm at most this many (fingerprint, class) "
                         "pairs (default 8)")
    ap.add_argument("--budget-s", type=float, default=None,
                    help="stop submitting after this many seconds")
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="per-ticket wait timeout in seconds")
    ap.add_argument("--json", action="store_true",
                    help="print the report as one JSON line")
    args = ap.parse_args(argv)

    from ramba_tpu_torch.compile import persist as _persist
    from ramba_tpu_torch.compile import warmpool as _warmpool

    _persist.reconfigure()
    if not _persist.aot_armed():
        print("warm_pool: persist cache not armed (set RAMBA_CACHE, "
              "RAMBA_AOT not 0); nothing to replay", file=sys.stderr)
        return 1

    report = _warmpool.warm(args.trace, top_k=args.top_k,
                            budget_s=args.budget_s, timeout=args.timeout)
    from ramba_tpu_torch import serve

    serve.shutdown()
    if args.json:
        print(json.dumps(report))
    else:
        print("warm_pool: "
              f"considered={report['considered']} "
              f"submitted={report['submitted']} warmed={report['warmed']} "
              f"failed={report['failed']} shed={report['shed']} "
              f"unresolved={report['unresolved']} "
              f"seconds={report['seconds']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
