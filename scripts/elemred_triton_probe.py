#!/usr/bin/env python3
"""Read what held back the Triton elemred kernel of an older checkout.

    python3 scripts/elemred_triton_probe.py PATH

``PATH`` is a checkout of commit 688282d (the last tree whose elemred was
a generated Triton kernel), for example unpacked with
``git archive 688282d | tar -x -C _chipcheck/parent``.  On one NVIDIA GPU
it builds that tree's elemred kernel for the main path's program (the
sin/cos chain over a materialised base, n = 1e9 float64) and for the
program that spells each transcendental twice, and prints for each:

* Triton's ``n_regs``, ``n_spills`` and shared memory, and the CTAs one SM
  holds at once by the CUDA occupancy rules (65,536 registers allocated
  per warp in units of 256, at most 64 warps, 32 CTAs and 228 KB of
  shared memory per SM, 1 KB of it reserved per CTA);
* its SASS (``cuobjdump -sass`` of the cubin Triton built): CALL, LDL and
  STL counts, and FP64-pipe and all instructions per element outside the
  trig slow-path subroutine;
* ``torch.profiler``'s device time of ``elemred_kernel`` and of the
  combine kernel, and the program's time by CUDA events;

beside the card's name and power limit.  This script exists to record
the starting point of the CUDA C++ kernel that replaced it; the port no
longer uses Triton.  Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import os
import re
import shutil
import subprocess
import sys

FP64_PIPE = {"DADD", "DMUL", "DFMA", "DSETP", "DMNMX", "DSET"}


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def compiled(er, program, leaf_vals):
    fn = er._module(er.plan_for(program, leaf_vals)).elemred_kernel
    kernels = []
    for v in getattr(fn, "device_caches", {}).values():
        kernels += list((v[0] if isinstance(v, tuple) else v).values())
    for v in getattr(fn, "cache", {}).values():
        kernels += list(v.values())
    if len(kernels) != 1:
        raise SystemExit(f"expected one compiled kernel, found {len(kernels)}")
    return kernels[0]


def sass_counts(kernel, path, per_thread):
    import triton

    tools = [shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump",
             os.path.join(os.path.dirname(triton.__file__),
                          "backends/nvidia/bin/cuobjdump")]
    tool = next(t for t in tools if t and os.path.exists(t))
    with open(path, "wb") as f:
        f.write(kernel.asm["cubin"])
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    inline, sub = collections.Counter(), collections.Counter()
    target = None
    for line in sass.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)(.*)", line)
        if not m:
            continue
        addr, op = int(m.group(1), 16), m.group(2)
        if op.startswith("CALL") and target is None:
            target = int(m.group(3).split()[0].rstrip(";"), 16)
        (sub if target is not None and addr >= target else inline)[op] += 1

    def fp64(c):
        return sum(k for op, k in c.items()
                   if op.split(".")[0] in FP64_PIPE
                   or (op.split(".")[0] in ("F2F", "F2I", "I2F", "FRND")
                       and "F64" in op))

    allc = inline + sub

    def count(prefix):
        return sum(k for op, k in allc.items() if op.split(".")[0] == prefix)

    return {"fp64_per_elem": fp64(inline) / per_thread,
            "all_per_elem": sum(inline.values()) / per_thread,
            "calls": sum(k for op, k in inline.items() if op.startswith("CALL")),
            "ldl": count("LDL"), "stl": count("STL"),
            "slow_path_all": sum(sub.values())}


def ctas_per_sm(n_regs, shared, warps):
    per_warp = -(-n_regs * 32 // 256) * 256
    by_regs = (65536 // per_warp) // warps if per_warp else 64
    by_smem = 233472 // (shared + 1024)
    return min(by_regs, 64 // warps, 32, by_smem)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available() or len(argv) != 1:
        print("usage: elemred_triton_probe.py PATH (on a CUDA card)",
              file=sys.stderr)
        return 2
    tree = os.path.abspath(argv[0])
    sys.path.insert(0, tree)
    import ramba_tpu_torch as rt
    from ramba_tpu_torch.core import fuser
    from ramba_tpu_torch.ops import elemred as er

    rt.set_device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    n = 10 ** 9
    base = rt.arange(n) / 1000.0
    rt.sync()

    def program(twice):
        if twice:
            D = rt.sin(base) * rt.sin(base) + rt.cos(base) * rt.cos(base)
        else:
            B, C = rt.sin(base), rt.cos(base)
            D = B * B + C * C
        roots = [D, rt.sum(D)]
        exprs = [a._expr for a in roots]
        del roots
        return fuser.prepare_program(exprs)

    per_thread = er.BLOCK // (32 * er.NUM_WARPS)
    for label, twice in (("main path's program, 2 transcendentals", False),
                         ("each transcendental spelled twice, 4", True)):
        p, lv = program(twice)
        er.launch(p, lv)
        torch.cuda.synchronize()
        k = compiled(er, p, lv)
        shared = int(getattr(k.metadata, "shared", 0) or 0)
        occ = ctas_per_sm(k.n_regs, shared, er.NUM_WARPS)
        s = sass_counts(k, os.path.join(tree, f"probe_{int(twice)}.cubin"),
                        per_thread)
        ms = cuda_ms(lambda: er.launch(p, lv), 5)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                er.launch(p, lv)
            torch.cuda.synchronize()
        dev = {}
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", None)
            if t is None:
                t = getattr(e, "cuda_time_total", 0)
            if t and ("elemred" in e.key or "combine" in e.key):
                dev[e.key] = t / 1e3 / 3  # ms per launch
        print(f"elemred Triton, {label}, n=1e9 f64: n_regs {k.n_regs}, "
              f"n_spills {k.n_spills}, shared {shared} B, {occ} CTAs/SM of "
              f"{er.NUM_WARPS} warps (occupancy rules); SASS: {s['calls']} "
              f"CALL, {s['ldl']} LDL, {s['stl']} STL, "
              f"{s['fp64_per_elem']:.2f} FP64-pipe and {s['all_per_elem']:.2f} "
              f"instructions per element ({per_thread} per thread), slow path "
              f"{s['slow_path_all']} instructions; kernel {ms:.4f} ms (CUDA "
              f"events); profiler ms per launch {dev} [{card}]", flush=True)
        del p, lv
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
