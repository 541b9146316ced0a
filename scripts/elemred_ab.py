#!/usr/bin/env python3
"""Time one checkout's elemred kernel on the main path's programs, on one
NVIDIA GPU, to compare two versions of the kernel in one call.

    python3 scripts/elemred_ab.py PATH [PATH ...]

For each checkout ``PATH`` in turn (give the two versions alternating, for
example ``old new new old``), in a fresh process each, it imports that
checkout's ``ramba_tpu_torch``, builds the sin/cos chain over a
materialised base (n = 1e9 float64, the program the main path's
``mat_chain`` launches) and axpy + sum (n = 2^28 float64, inputs made on
the card), launches each once through the checkout's ``elemred.launch``,
and times 20 launches with CUDA events, three times; it prints the median
and the spread of the three beside the byte bounds and the card's name and
power limit.  Imports nothing of JAX.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)


def measure(tree: str) -> None:
    import torch

    sys.path.insert(0, os.path.abspath(tree))
    import ramba_tpu_torch as rt
    from ramba_tpu_torch.core import fuser
    from ramba_tpu_torch.ops import elemred as er

    rt.set_device("cuda:0")

    def program(roots):
        exprs = [a._expr for a in roots]
        del roots
        return fuser.prepare_program(exprs)

    def time3(p, lv):
        er.launch(p, lv)
        torch.cuda.synchronize()
        out = []
        for _ in range(3):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(20):
                er.launch(p, lv)
            e1.record()
            e1.synchronize()
            out.append(e0.elapsed_time(e1) / 20)
        return out

    n, m = 10 ** 9, 1 << 28
    base = rt.arange(n) / 1000.0
    rt.sync()
    B, C = rt.sin(base), rt.cos(base)
    D = B * B + C * C
    chain = time3(*program([D, rt.sum(D)]))
    del B, C, D, base
    torch.cuda.empty_cache()
    x = rt.sin(rt.arange(m) * 1e-3)
    y = rt.cos(rt.arange(m) * 1e-3)
    rt.sync()
    z = 2.5 * x + y
    axpy = time3(*program([z, rt.sum(z)]))
    for what, ms, nbytes in (("sin/cos chain n=1e9 f64", chain, 16 * n),
                             ("axpy+sum n=2^28 f64", axpy, 24 * m)):
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        med = statistics.median(ms)
        print(f"  {tree}: elemred {what}: median {med:.4f} ms of "
              f"{', '.join(f'{t:.4f}' for t in ms)} ({bound / med:.1%} of the "
              f"{bound:.4f} ms byte bound)", flush=True)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available() or not argv:
        print("usage: elemred_ab.py PATH [PATH ...] (on a CUDA card)",
              file=sys.stderr)
        return 2
    if argv[0] == "--one":
        measure(argv[1])
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(f"elemred A/B on {torch.cuda.get_device_name(0)} ({card})", flush=True)
    rc = 0
    for tree in argv:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", tree]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
