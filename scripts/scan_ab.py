#!/usr/bin/env python3
"""Time the one-pass scan kernel on one NVIDIA GPU, in one call: bare and
through ``rt.cumsum`` against ``torch.cumsum``, in turns; the checkpoint
chain's hop; and copies of the kernel built with other constants.

    python3 scripts/scan_ab.py             # the hop (K=1) and MIN_CTAS=2
    python3 scripts/scan_ab.py --ctas-per-sm 4,6 \\
        --variants "K=1;K=64;K=256;MIN_CTAS=3"

Shapes: cumsum of 2^28 float64 (one row of 65536 tiles) and of 16384 rows
of 16384 float32.  Each time is the mean of 10 launches after a warm-up,
with CUDA events for the kernel and ``torch.cumsum`` and the host clock
around a synchronised ``rt.cumsum`` (its wall), taken in turns (kernel,
rt.cumsum, torch.cumsum, torch.cumsum, rt.cumsum, kernel).  The kept
kernel is also timed on other grids (``--ctas-per-sm``), bytes compared.

A variant is a copy of ``csrc/scan.cuh`` whose ``constexpr int NAME = v;``
lines are rewritten (``K``, ``MIN_CTAS``...), timed in turns
with the kept kernel (variant, kept, variant) and held byte for byte
against the plain version with the variant's K (``ops/scan.py`` reads
``K`` at call time; no other constant changes the order).  With K = 1
every tile is a checkpoint and a row is one chain of tiles_per_row hops:
its time over the hops is the time of one hop (an L2 round trip, a
combine and a publish), an upper bound since the data's own time is
inside it.  ``ptxas``' registers and spills of every copy and the card's
name and power limit are printed beside the times.  Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def parse_variants(text: str) -> list[dict]:
    """``"K=1;K=64,MIN_CTAS=3"`` -> [{"K": 1}, {"K": 64, "MIN_CTAS": 3}]."""
    out = []
    for part in filter(None, (p.strip() for p in text.split(";"))):
        out.append({k.strip(): int(v) for k, v in
                    (kv.split("=") for kv in part.split(","))})
    return out


def label(consts: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in consts.items()) or "kept"


def build(tmp: str, consts: dict):
    """The scan source against a copy of ``scan.cuh`` with ``consts``
    rewritten; returns (library, ptxas' lines of registers and spills)."""
    from ramba_tpu_torch import _build
    from ramba_tpu_torch.ops import scan

    with open(os.path.join(_build.CSRC_DIR, "scan.cuh")) as f:
        header = f.read()
    for name, v in consts.items():
        pat = re.compile(rf"constexpr int {name} = \d+;")
        if not pat.search(header):
            raise RuntimeError(f"scan.cuh has no 'constexpr int {name} = ...;'")
        header = pat.sub(f"constexpr int {name} = {v};", header)
    d = os.path.join(tmp, label(consts).replace(",", "_").replace("=", ""))
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
        raise RuntimeError(f"nvcc failed for {label(consts)}:\n"
                           f"{r.stderr[-3000:]}")
    usage = sorted({line.split("ptxas info    : ")[-1].strip()
                    for line in r.stderr.splitlines()
                    if "registers" in line or "spill" in line})
    return ctypes.CDLL(so), usage


def main(argv) -> int:
    import torch

    import ramba_tpu_torch as rt
    from ramba_tpu_torch.ops import scan

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="K=1;MIN_CTAS=2",
                    help="copies to build: ';' between copies, ',' between "
                         "NAME=value assignments")
    ap.add_argument("--ctas-per-sm", default="6",
                    help="grids (CTAs per SM) to time the kept kernel on")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("scan_ab: no CUDA device", file=sys.stderr)
        return 2
    rt.set_device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    variants = [{}] + parse_variants(args.variants)
    per_sm = [int(v) for v in args.ctas_per_sm.split(",") if v]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tmp = tempfile.mkdtemp()
    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(variants)) as pool:
            built = list(pool.map(lambda c: build(tmp, c), variants))
        print(f"built {len(variants)} copies in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for consts, (_lib, usage) in zip(variants, built):
            print(f"  {label(consts)}: {usage}", flush=True)

        def run_copy(lib, x):
            fn = getattr(lib, scan.entry_name(x.dtype, "cumsum"))
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + \
                [ctypes.c_int, ctypes.c_void_p]
            R, n = x.shape
            out = torch.empty_like(x)
            num = R * scan.tiles(n)
            val = torch.empty(num, dtype=x.dtype, device=x.device)
            status = torch.empty(scan.status_bytes(num), dtype=torch.uint8,
                                 device=x.device)
            rc = fn(x.data_ptr(), out.data_ptr(), val.data_ptr(),
                    status.data_ptr(), R, n, scan.grid(x.device),
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"CUDA error {rc}")
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

        def wall_ms(f, reps=10):
            f()
            torch.cuda.synchronize()
            walls = []
            for _ in range(reps):
                t = time.perf_counter()
                f()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t)
            return 1e3 * sum(walls) / reps

        def kept():
            return scan.launch(x, "cumsum", 1)

        wrong = []
        g = torch.Generator(device="cuda")
        g.manual_seed(3)
        for what, shape, dt in (("2^28 float64", (1, 1 << 28), torch.float64),
                                ("16384 rows of 16384 float32", (16384, 16384),
                                 torch.float32)):
            x = torch.randn(*shape, generator=g, device="cuda", dtype=dt)
            xa = rt.fromarray(x)
            bound = 1e3 * 2 * x.numel() * x.element_size() / 3.35e12
            t = {"kernel": [], "rt.cumsum": [], "torch.cumsum": []}
            calls = {"kernel": kept,
                     "rt.cumsum": lambda: rt.cumsum(xa, 1)._value(),
                     "torch.cumsum": lambda: torch.cumsum(x, 1)}
            for name in ("kernel", "rt.cumsum", "torch.cumsum", "torch.cumsum",
                         "rt.cumsum", "kernel"):
                timer = wall_ms if name == "rt.cumsum" else ms
                t[name].append(timer(calls[name]))
            print(f"cumsum {what}: kernel {t['kernel'][0]:.4f} / "
                  f"{t['kernel'][1]:.4f} ms, rt.cumsum wall "
                  f"{t['rt.cumsum'][0]:.4f} / {t['rt.cumsum'][1]:.4f} ms, "
                  f"torch.cumsum {t['torch.cumsum'][0]:.4f} / "
                  f"{t['torch.cumsum'][1]:.4f} ms, byte bound {bound:.4f} ms "
                  f"[{card}]", flush=True)
            ref = kept()
            for c in per_sm:
                same = torch.equal(scan.launch(x, "cumsum", 1, sms * c)
                                   .view(torch.uint8), ref.view(torch.uint8))
                print(f"  kept on {c} CTAs per SM ({sms * c}): "
                      f"{ms(lambda: scan.launch(x, 'cumsum', 1, sms * c)):.4f}"
                      f" ms, bytes equal to the default grid's {same} [{card}]",
                      flush=True)
            del ref
            for consts, (lib, _usage) in zip(variants[1:], built[1:]):
                k = consts.get("K", scan.K)
                got = run_copy(lib, x)
                kept_k, scan.K = scan.K, k
                try:
                    same = torch.equal(got.view(torch.uint8),
                                       scan.scan_reference(x, "cumsum", 1)
                                       .view(torch.uint8))
                finally:
                    scan.K = kept_k
                del got
                reps = 3 if k == 1 else 10
                tv = [ms(lambda: run_copy(lib, x), reps)]
                tkept = ms(kept)
                tv.append(ms(lambda: run_copy(lib, x), reps))
                hops = -(-scan.tiles(x.shape[1]) // k)
                hop = (f", {1e6 * min(tv) / hops:.1f} ns per hop over {hops} "
                       f"hops a row" if k == 1 else "")
                print(f"  {label(consts)}: {tv[0]:.4f} / {tv[1]:.4f} ms "
                      f"(kept {tkept:.4f} ms between){hop}, bytes equal to the "
                      f"plain version with K={k} {same} [{card}]", flush=True)
                if not same:
                    wrong.append(f"{label(consts)} on {what}")
            del x, xa
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if wrong:
        print(f"scan_ab: not the plain version's bytes: {wrong}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
