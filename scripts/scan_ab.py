#!/usr/bin/env python3
"""Time the scan kernel's ``scan_tiles`` as it is (each thread keeps its
running fold in registers) against a variant that recomputes the fold
from shared memory (fewer registers), on one NVIDIA GPU, in one call.

    python3 scripts/scan_ab.py

Both are built from this checkout's ``csrc/scan.cuh`` (the variant by
rewriting its ``scan_tiles`` fold in a temporary copy) with the entry
points of ``ops/scan.py``; the two compute the same operations in the same
order, so their bytes are compared for equality.  Each is timed with CUDA
events in turns (kept, variant, variant, kept) on cumsum of 2^28 float64
and of 16384 rows of 16384 float32, and the registers ``ptxas`` reports
for ``scan_tiles`` are printed beside the card's name and power limit.
Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

KEPT = """    A loc[ITEMS];
    loc[0] = tile[slot(tid * ITEMS)];
#pragma unroll
    for (int k = 1; k < ITEMS; ++k)
      loc[k] = Op::comb(loc[k - 1], tile[slot(tid * ITEMS + k)]);
    kogge_stone<A, Op>(sh, loc[ITEMS - 1]);
    const A e = tid > 0 ? sh[tid - 1] : Op::template ident<A>();
    const A cj = j > 0 ? carry[g] : Op::template ident<A>();
    // each thread rewrites only the slots of its own chunk
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const A w = tid > 0 ? Op::comb(e, loc[k]) : loc[k];
      tile[slot(tid * ITEMS + k)] = j > 0 ? Op::comb(cj, w) : w;
    }
"""
RECOMPUTED = """    A s = tile[slot(tid * ITEMS)];
#pragma unroll
    for (int k = 1; k < ITEMS; ++k) s = Op::comb(s, tile[slot(tid * ITEMS + k)]);
    kogge_stone<A, Op>(sh, s);
    const A e = tid > 0 ? sh[tid - 1] : Op::template ident<A>();
    const A cj = j > 0 ? carry[g] : Op::template ident<A>();
    A run = tile[slot(tid * ITEMS)];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if (k > 0) run = Op::comb(run, tile[slot(tid * ITEMS + k)]);
      const A w = tid > 0 ? Op::comb(e, run) : run;
      tile[slot(tid * ITEMS + k)] = j > 0 ? Op::comb(cj, w) : w;
    }
"""


def build(tmp: str, tag: str, header: str):
    """Build the scan source against ``header``; returns the library and
    the registers of every kernel as ptxas reports them."""
    from ramba_tpu_torch import _build
    from ramba_tpu_torch.ops import scan

    d = os.path.join(tmp, tag)
    os.makedirs(d)
    with open(os.path.join(d, "scan.cuh"), "w") as f:
        f.write(header)
    cu = os.path.join(d, "scan.cu")
    with open(cu, "w") as f:
        f.write(scan.SOURCE)
    so = os.path.join(d, "scan.so")
    r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                        "-I", d, "-o", so, cu], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for {tag}:\n{r.stderr[-3000:]}")
    regs = sorted({int(line.split("Used ")[1].split()[0])
                   for line in r.stderr.splitlines() if "registers" in line})
    return ctypes.CDLL(so), regs


def main() -> int:
    import torch

    from ramba_tpu_torch.ops import scan

    if not torch.cuda.is_available():
        print("scan_ab: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    with open(os.path.join(REPO, "ramba_tpu_torch", "csrc", "scan.cuh")) as f:
        header = f.read()
    if KEPT not in header:
        raise RuntimeError("scan.cuh's scan_tiles fold changed: update KEPT")
    tmp = tempfile.mkdtemp()
    try:
        libs = {}
        for tag, text in (("kept", header),
                          ("recomputed", header.replace(KEPT, RECOMPUTED))):
            libs[tag], regs = build(tmp, tag, text)
            print(f"{tag}: registers per thread of the scan kernels {regs}",
                  flush=True)

        def run(tag, x):
            fn = getattr(libs[tag], scan.entry_name(x.dtype, "cumsum"))
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + \
                [ctypes.c_int, ctypes.c_void_p]
            R, n = x.shape
            out = torch.empty_like(x)
            tot = torch.empty(R * scan.tiles(n), dtype=x.dtype, device=x.device)
            carry = torch.empty_like(tot)
            rc = fn(x.data_ptr(), out.data_ptr(), tot.data_ptr(),
                    carry.data_ptr(), R, n, scan.grid(x.device),
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{tag}: CUDA error {rc}")
            return out

        def ms(f, reps=10):
            f()
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(reps):
                f()
            e1.record()
            e1.synchronize()
            return e0.elapsed_time(e1) / reps

        g = torch.Generator(device="cuda")
        g.manual_seed(3)
        for what, shape, dt in (("2^28 float64", (1, 1 << 28), torch.float64),
                                ("16384 rows of 16384 float32", (16384, 16384),
                                 torch.float32)):
            x = torch.randn(*shape, generator=g, device="cuda", dtype=dt)
            same = torch.equal(run("kept", x).view(torch.uint8),
                               run("recomputed", x).view(torch.uint8))
            t = {"kept": [], "recomputed": []}
            for tag in ("kept", "recomputed", "recomputed", "kept"):
                t[tag].append(ms(lambda: run(tag, x)))
            print(f"scan cumsum {what}: kept (fold in registers) "
                  f"{t['kept'][0]:.4f} / {t['kept'][1]:.4f} ms, recomputed "
                  f"{t['recomputed'][0]:.4f} / {t['recomputed'][1]:.4f} ms, "
                  f"bytes equal {same} [{card}]", flush=True)
            del x
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
