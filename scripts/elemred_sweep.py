#!/usr/bin/env python3
"""Time the port's elemred kernel under other configurations, on one
NVIDIA GPU.

    python3 scripts/elemred_sweep.py

For each program below (the main path's sin/cos chain at n = 1e9 in
float64 and in float32, the float32 chain again below |x| = 1e4, axpy + sum
at n = 2^28 in float64), it builds the
kernel once per (elements per thread, ring stages, CTAs per SM the launch
bounds ask for, sin and cos fused into one sincos or not) in its list,
plus the configuration ``ops/elemred.py`` picks, all sources at once; then
it launches each on aligned leaves, the bulk path (and the default also on
a copy one element into its buffer, the plain-load path), holds its vector output byte for byte against the default's (a
variant whose sincos setting differs from the default's is only
reported), and times it with CUDA events beside the byte
bound, its registers, local memory and CTAs per SM, and the card's name and
power limit.  Exits non-zero without a card or when a variant disagrees.
Imports nothing of JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)

# (elements per thread, stages, CTAs per SM the launch bounds ask for,
# sincos)
TRIG_F64 = [(8, 4, 2, False), (4, 4, 2, True), (4, 4, 3, True),
            (4, 3, 4, True), (8, 2, 2, True), (8, 3, 2, True), (8, 4, 1, True),
            (8, 3, 3, True), (16, 2, 2, True), (16, 3, 1, True),
            (4, 4, 3, False), (16, 2, 2, False)]
TRIG_F32 = [(8, 4, 2, False), (4, 4, 2, True), (16, 4, 2, True),
            (8, 4, 3, True), (8, 4, 4, True)]
AXPY_F64 = [(4, 4, 2, True), (8, 2, 2, True), (8, 4, 1, True),
            (16, 2, 2, True)]


def cuda_ms(fn, reps=5):
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("elemred_sweep: no CUDA device", file=sys.stderr)
        return 2
    import ramba_tpu_torch as rt
    from chip_smoke import axpy_program, elemred_resources, trig_program
    from ramba_tpu_torch import _build
    from ramba_tpu_torch.ops import elemred as er

    rt.set_device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    n, m = 10 ** 9, 1 << 28

    def rows():
        base = rt.arange(n) / 1000.0
        rt.sync()  # materialised: the program's one vector leaf
        yield ("sin/cos chain n=1e9 float64", *trig_program(rt, base), 16 * n,
               TRIG_F64)
        del base
        b32 = rt.fromarray(torch.arange(n, device="cuda", dtype=torch.float32)
                           / 1000.0)
        yield ("sin/cos chain n=1e9 float32", *trig_program(rt, b32), 8 * n,
               TRIG_F32)
        # the same below |x| = 1e4: sinf and cosf never take their slow path
        # (Payne-Hanek, from |x| = 105615), which the chain above takes for
        # nine elements in ten
        b32 = rt.fromarray(torch.arange(n, device="cuda", dtype=torch.float32)
                           / 1e5)
        yield ("sin/cos chain n=1e9 float32, |x| < 1e4",
               *trig_program(rt, b32), 8 * n, [])
        del b32
        x = rt.sin(rt.arange(m) * 1e-3)
        y = rt.cos(rt.arange(m) * 1e-3)
        rt.sync()
        yield ("axpy+sum n=2^28 float64", *axpy_program(rt, x, y), 24 * m,
               AXPY_F64)

    configs = {}
    # build every variant of every program first, all at once (the plans
    # only need the leaves' dtypes: made on tiny leaves of the same kinds)
    small = rt.fromarray(torch.rand(64, device="cuda", dtype=torch.float64))
    small32 = rt.fromarray(torch.rand(64, device="cuda", dtype=torch.float32))
    for what, (p, lv), variants in (
            ("sin/cos chain n=1e9 float64", trig_program(rt, small), TRIG_F64),
            ("sin/cos chain n=1e9 float32", trig_program(rt, small32), TRIG_F32),
            ("sin/cos chain n=1e9 float32, |x| < 1e4", trig_program(rt, small32),
             []),
            ("axpy+sum n=2^28 float64", axpy_program(rt, small, small), AXPY_F64)):
        cfgs = [er.CONFIG] + [er.CONFIG._replace(ept=e, stages=s, min_ctas=c,
                                                 sincos=f)
                              for e, s, c, f in variants]
        configs[what] = cfgs
        _build.build_many(sorted({(pl.name, pl.source) for pl in
                                  (er.plan_for(p, lv, c) for c in cfgs)}))
    del small, small32
    print(f"elemred sweep on {torch.cuda.get_device_name(0)} ({card})", flush=True)
    ok = True
    for what, p, lv, nbytes, _variants in rows():
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        ref = None
        cases = [(c, "bulk") for c in configs[what]] + [(er.CONFIG, "plain")]
        for k, (cfg, path) in enumerate(cases):
            plan = er.plan_for(p, lv, cfg)
            if path == "plain":
                # a view one element in: the same values, plain loads
                shifted = []
                for v in lv:
                    if isinstance(v, torch.Tensor) and v.ndim == 1:
                        buf = torch.empty(v.numel() + 1, dtype=v.dtype,
                                          device=v.device)
                        buf[1:] = v
                        v = buf[1:]
                    shifted.append(v)
                run_lv = shifted
            else:
                run_lv = lv
            if er.geometry(p, run_lv, cfg)[0] != path:
                raise RuntimeError(f"{what}: expected the {path} path")
            got = er.launch(p, run_lv, cfg)[0]
            torch.cuda.synchronize()
            if ref is None:
                ref = got
            same = torch.equal(got.view(torch.uint8), ref.view(torch.uint8))
            ok &= same or cfg.sincos != er.CONFIG.sincos
            del got
            ms = cuda_ms(lambda: er.launch(p, run_lv, cfg))
            occ = er.ctas_per_sm(plan, path, run_lv[plan.vec_leaves[0]].device)
            res = elemred_resources(er, plan)
            label = "default" if k == 0 else ("default, plain loads"
                                              if path == "plain" else "variant")
            print(f"  {what} ({path}) {label} sincos={cfg.sincos} ept={plan.ept} "
                  f"stages={plan.config.stages} min_ctas={plan.config.min_ctas} "
                  f"smem={plan.smem} regs={res['registers']} "
                  f"local={res['local']} CTAs/SM={occ}: {ms:.4f} ms "
                  f"({bound / ms:.1%} of the {bound:.4f} ms byte bound), "
                  f"byte-equal {same} [{card}]", flush=True)
            del run_lv
        del ref, p, lv
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
