#!/usr/bin/env python3
"""Time the port's stencil kernel under other tilings, on one NVIDIA GPU.

    python3 scripts/stencil_sweep.py

For each body and shape below (star2 at 8192^2 in float32 and bfloat16 and
at 4099x4133 in float32, the jacobi sweep at 4096^2 in float64 with two
slots), it builds the kernel once per (strip width TW, row block BH, ring
stages, CTAs per SM) in its list, plus the geometry
``ops/stencil_kernel.geometry`` picks, all sources at once; then it holds
each against the plain version (byte for byte) and times it with CUDA
events, beside the byte bound and the card's name and power limit.  The
4099x4133 shape takes the cp.async path, the others the TMA path.  Exits
non-zero without a card or when a variant disagrees.  Imports nothing of
JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)

# (TW, BH, stages, CTAs per SM the launch bounds ask for)
STAR2_F32 = [(32, 64, 4, 2), (64, 32, 4, 2), (128, 16, 4, 2), (128, 32, 2, 2),
             (128, 32, 3, 2), (128, 64, 2, 1), (128, 64, 3, 2)]
STAR2_BF16 = [(64, 32, 4, 2), (128, 32, 3, 2)]
SWEEP_F64 = [(64, 32, 3, 2), (128, 8, 3, 2), (128, 16, 2, 2), (128, 32, 2, 1)]
ODD_F32 = [(64, 32, 4, 2), (128, 16, 4, 2), (128, 64, 3, 2)]


def star2(a):
    return (0.25 * (a[0, 1] + a[0, -1] + a[1, 0] + a[-1, 0])
            + 0.125 * (a[0, 2] + a[0, -2] + a[2, 0] + a[-2, 0]))


def cuda_ms(fn, reps=20):
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
        print("stencil_sweep: no CUDA device", file=sys.stderr)
        return 2
    import ramba_tpu_torch as rt
    from ramba_tpu_torch import _build
    from ramba_tpu_torch.models import jacobi
    from ramba_tpu_torch.ops import stencil_kernel as sk

    rt.set_device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    g = torch.Generator(device="cuda")
    g.manual_seed(0)

    def rand(*shape, dtype=torch.float32):
        return torch.rand(shape, generator=g, device="cuda", dtype=dtype)

    x = rand(8192, 8192)
    sweep = jacobi._kernels()["sweep"].func
    rows = [("star2 8192x8192 float32", star2, [x], "tma", STAR2_F32),
            ("star2 8192x8192 bfloat16", star2, [x.to(torch.bfloat16)], "tma",
             STAR2_BF16),
            ("jacobi sweep 4096x4096 float64, 2 slots", sweep,
             [rand(4096, 4096, dtype=torch.float64),
              rand(4096, 4096, dtype=torch.float64)], "tma", SWEEP_F64),
            ("star2 4099x4133 float32", star2, [rand(4099, 4133)], "cpasync",
             ODD_F32)]
    default_geometry = sk.geometry
    cases = []
    for what, body, arrs, want_path, variants in rows:
        slots = tuple(("arr", k) for k in range(len(arrs)))
        tr = sk.trace(body, slots)
        for v in [None] + variants:
            sk.geometry = default_geometry if v is None else (
                lambda *a, v=v: sk.ring(*a, *v))
            sk._spec_cache.clear()
            spec = sk.spec_for(tr.expr, tr.lo, tr.hi, len(arrs), arrs[0].dtype)
            cases.append((what, body, slots, tr, arrs, want_path, v, spec))
    sk.geometry = default_geometry
    sk._spec_cache.clear()
    _build.build_many(sorted({(c[7].name, c[7].source) for c in cases}))
    print(f"stencil sweep on {torch.cuda.get_device_name(0)} ({card})", flush=True)
    ok = True
    wants = {}
    for what, body, slots, tr, arrs, want_path, v, spec in cases:
        if what not in wants:
            wants[what] = sk.stencil_reference(body, tr.lo, tr.hi, slots, arrs)
        out = torch.empty_like(arrs[0])
        real_spec = sk._spec
        sk._spec = lambda *a, s=spec: s
        try:
            before = sk.launches_tma
            sk.launch(body, tr.lo, tr.hi, slots, arrs, out)
            path = "tma" if sk.launches_tma > before else "cpasync"
            ms = cuda_ms(lambda: sk.launch(body, tr.lo, tr.hi, slots, arrs, out))
            occ = sk.ctas_per_sm(body, tr.lo, tr.hi, slots, arrs, path)
        finally:
            sk._spec = real_spec
        torch.cuda.synchronize()
        same = torch.equal(out.view(torch.uint8), wants[what].view(torch.uint8))
        ok &= same and path == want_path
        geo = spec.geometry
        H, W = arrs[0].shape
        bound = (len(arrs) + 1) * H * W * arrs[0].element_size() / HBM_BYTES_PER_S * 1e3
        label = "default" if v is None else "variant"
        print(f"  {what} ({path}) {label} TW={geo.tw} BH={geo.bh} "
              f"stages={geo.stages} min_ctas={geo.min_ctas} "
              f"smem={geo.smem} CTAs/SM={occ}: {ms:.4f} ms "
              f"({bound / ms:.1%} of the {bound:.4f} ms byte bound), "
              f"byte-equal {same} [{card}]", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
