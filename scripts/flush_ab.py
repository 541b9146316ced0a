#!/usr/bin/env python3
"""Host time of one flush, nothing forced, in two checkouts on one card.

    python3 scripts/flush_ab.py <checkout A> <checkout B> [flushes]

Each checkout runs in its own process, in the order A, B, B, A (a drift
of the host during the call falls on both), importing its own
``ramba_tpu_torch``.  Each process times ``flushes`` (default 300) flushes
of three small programs after 30 warm ones, each flush ending in a wait
for the card: an elementwise program over 2^20 float32 (elemred), its
sum read back as a float (elemred), and one star2 ``sstencil`` sweep
over 1024^2 float32 (the stencil kernel).  At these sizes the card works
a few microseconds a flush, so the wall is the host's: graph building,
the flush's prepare and dispatch, admission, the ladder and the launch.
Prints the card, then each run's p50 and p95 in microseconds a flush,
then the p50s side by side.  ``python3 scripts/flush_ab.py --profile
[flushes]`` runs the elementwise program of this checkout under cProfile
instead.
"""

import json
import os
import subprocess
import sys
import time


def star2_body(a):
    return (0.25 * (a[0, 1] + a[0, -1] + a[1, 0] + a[-1, 0])
            + 0.125 * (a[0, 2] + a[0, -2] + a[2, 0] + a[-2, 0]))


def child(flushes: int) -> dict:
    import numpy as np
    import torch

    import ramba_tpu_torch as rt

    rt.set_device("cuda:0")
    x = rt.fromarray(np.random.RandomState(0).rand(1 << 20)
                     .astype(np.float32))
    g = rt.fromarray(np.random.RandomState(1).rand(1024, 1024)
                     .astype(np.float32))
    st = rt.stencil(star2_body)
    progs = {"elementwise_2^20": lambda: (x * 2.0 + 1.0)._value(),
             "sum_2^20": lambda: float(rt.sum(x * 2.0 + 1.0)),
             "star2_1024^2": lambda: rt.sstencil(st, g)._value()}
    out = {}
    for name, fn in progs.items():
        for _ in range(30):
            fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(flushes):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        walls.sort()
        out[name] = {"p50_us": walls[len(walls) // 2] * 1e6,
                     "p95_us": walls[int(len(walls) * 0.95)] * 1e6}
    return out


def profile(flushes: int) -> None:
    """The elementwise program's flushes under cProfile: the functions
    that take the most host time a flush, cumulative and own."""
    import cProfile
    import pstats

    import numpy as np
    import torch

    import ramba_tpu_torch as rt

    rt.set_device("cuda:0")
    x = rt.fromarray(np.random.RandomState(0).rand(1 << 20)
                     .astype(np.float32))
    for _ in range(30):
        (x * 2.0 + 1.0)._value()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(flushes):
        (x * 2.0 + 1.0)._value()
        torch.cuda.synchronize()
    prof.disable()
    for key in ("cumulative", "tottime"):
        pstats.Stats(prof, stream=sys.stdout).sort_stats(key).print_stats(30)


def main(argv) -> int:
    if argv and argv[0] == "--child":
        print(json.dumps(child(int(argv[1]))))
        return 0
    if argv and argv[0] == "--profile":  # python3 flush_ab.py --profile [N]
        profile(int(argv[1]) if len(argv) > 1 else 300)
        return 0
    a, b = argv[0], argv[1]
    flushes = argv[2] if len(argv) > 2 else "300"
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    runs = []
    for n, d in enumerate((a, b, b, a), 1):
        env = dict(os.environ, PYTHONPATH=os.path.abspath(d))
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", flushes],
            cwd=d, env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            print(f"run {n} ({d}) failed:\n{proc.stderr[-3000:]}")
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(res)
        print(f"run {n}: {d} " + ", ".join(
            f"{k} p50 {v['p50_us']:.1f} p95 {v['p95_us']:.1f} us"
            for k, v in res.items()), flush=True)
    for k in runs[0]:
        print(f"{k}: p50 us a flush A/B/B/A " + " ".join(
            f"{r[k]['p50_us']:.1f}" for r in runs))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
