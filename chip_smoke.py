#!/usr/bin/env python3
"""Smoke run of ramba_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py            # the whole run (6-7 min on one H100)
    python3 chip_smoke.py --quick    # phases 1-2 only: build and check kernels
    python3 chip_smoke.py --mesh     # phase 1 and the mesh path only
    python3 chip_smoke.py --dist     # phase 1 and the path across processes
    python3 chip_smoke.py --layout   # phase 1 and layouts across processes
    python3 chip_smoke.py --compile  # phase 1 and the compile pipeline
    python3 chip_smoke.py --analyze  # phase 1 and the analyzer, memo, certs
    python3 chip_smoke.py --ladder   # phase 1 and the degradation ladder
    python3 chip_smoke.py --elastic  # phase 1 and the elastic plane
                                     # (--parts stall,inflight: some parts)
    python3 chip_smoke.py --observe  # phase 1 and the observability plane

Phases, each reported on its own line:

1. device and build: the card's name and power limit, then every CUDA
   kernel of the main path built from this checkout's sources at once;
2. each kernel held against its plain PyTorch version on the card, at the
   main path's shapes, with the tolerance stated beside every check, and
   timed beside its bound and (where one PyTorch call computes the same
   function) that call.  Every stencil check names the load path it took
   (TMA, cp.async, plain loads; each is taken at least once) and whether
   its bytes equal the plain version's; the stencil kernel is timed at
   every shape the main path launches it at, with its host time per
   launch.  Every elemred check runs twice (reruns byte-equal) and names
   its load path (bulk copies, plain loads; each is taken); its sincos is
   held byte for byte against separate sin and cos; it is timed on the
   main path's program, on axpy + sum and on the chain in float32, with
   its registers, spills, CTAs per SM, host time per launch, and a bound
   that counts the FP64-pipe instructions per element in its SASS at the
   SM clock read under load.
   This phase also holds the repairs: integer ``// 0`` on the elemred and
   stencil kernels against the rule itself, a uint32 chain against NumPy,
   Python ints outside int32 wrapping through elemred and comparing
   exactly, integer ``reciprocal`` of 0 giving the dtype's maximum,
   the bf16 stencil kernel exactly against its plain version, saturating
   float-to-int casts and ``sign(-0.0)`` through elemred and the generic
   lowering, ``spacing`` on the generic lowering against its plain
   version; and the one-pass fixed-order scan (cumsum/cumprod of floats)
   against its plain version (same order: the same bytes) and within its
   rounding-depth bound of the float64 scan, launched on one CTA, on a
   small odd grid and twice on the default grid (all byte-equal), on 2^28
   float64 and float32, along both axes of 16384^2 float32 and on two rows
   that cross checkpoints, timed beside ``torch.cumsum``;
3. the main path through ``import ramba_tpu_torch as rt``: the headline
   chain at n = 1e9, the sin/cos chain over a materialised base at n = 1e9,
   axpy + sum, the PRK star stencil (30 chained ``sstencil`` calls and 100
   ``sstencil_iterate`` sweeps at 8192^2), ``jacobi2d`` at 4096^2, and
   groupby over an hourly sensor series (n = 2^28 float64, 24 hour-of-day
   groups: sum, min, max, count on the segred kernel, then mean and the
   anomaly ``g - g.mean()`` on the generic lowering) and over n = 2^28
   float32 category codes (64 groups: sum, max); then the skeleton layer
   (``skeletons_path``): smap over n = 2^28 float64 (the docs' f1 form, a
   branching kernel, an np.sin kernel), smap_index over a 16384^2 float32
   grid, a synced smap result summed (one elemred launch), sreduce (the
   docs' example, an np.maximum reducer, a SreduceReducer), scumulative
   (the odd/even cumsum over 2^28 float64 and int64, a sequential EMA
   down a (4096, 65536) float32 array), spmd (a halo(1) 5-point update of
   an 8192^2 float32 array) and var, std, argmax, nanargmin, median and
   cumsum over 2^28 float64, each timed cold and warm and held against
   plain torch, with ``skeletons.host_fallback`` at 0 after every call
   and one 1024-element float() kernel showing the warning and the
   counter; then indexing and the NumPy protocol (``indexing_path``):
   masked writes on 2^28 float64, a gather of 2^26 indices (out of range
   and negative ones among them) and a scatter of 2^26 unique indices,
   ``X[rows, 1:9]`` on 16384^2 float32, NumPy's concatenate, stack, where
   and transpose giving port arrays on the card, sort/argsort of 2^28
   float64 with NaNs and signed zeros, matmul 8192^2 float32 (TF32 off)
   and 4096^2 float64 against float64 products, an int64 matmul at 2048^2
   and cumsum of 2^28 float64 on the scan kernel, its wall split into
   host time, launch and card time, cold and warm; then the rest of the
   NumPy surface (``breadth_path``): complex128 imag, angle, sign, var,
   less, max and sort on 2^26 values (against plain torch and NumPy on a
   2^20 sample), nancumsum/nancumprod of 2^28 float64 on the scan kernel
   (the plain version's bytes), diff, nan_to_num, fix, around, trapezoid,
   searchsorted/digitize, isin, interp, convolve (TF32 off, against a
   float64 run), quantiles, a weighted bincount run twice byte-equal,
   ``unique`` (a host boundary) and cov; fft/ifft, rfft/irfft round
   trips, fft2 of 16384^2 and fftshift; solve, inv, det, slogdet and
   cholesky at 8192^2 float64, qr, svd, eigh, pinv and matrix_rank at
   4096^2 by their residuals, norm, eig and lstsq (host); eye, mgrid,
   meshgrid, logspace and geomspace; the rewrites (the hourly series'
   stack of group sums and maxima on segred, the anomaly idiom against
   the un-rewritten program, ``rewrite.stats["errors"] == 0``); and the
   models (``integrate_pi(1e9)`` in one flush, k-means on 2^24 x 32
   points against its plain run); then ``rt.random``, file I/O and
   checkpoints (``io_path``): random, normal, randint and exponential of
   2^28 and permutation(2^26) from a seed, each checked (moments within
   6 standard errors, supports) and timed, reseeded byte-equal, one
   draw's program rerun byte-equal, ten seeds adding no compile;
   Monte-Carlo pi from two 2^28 float64 draws, its hits counted on elemred
   and equal to the plain count; 2 GiB saved to .npy and .rtd and loaded
   back byte-equal within the chunk bound, ``fileio:once`` retried; an
   8192^2 float32 grid from ``rt.random`` through .npy, 100 star2 sweeps
   on the TMA path, a checkpoint, a restore and 100 more sweeps byte-equal
   to 200 straight, ``checkpoint_io:once`` retried and a
   ``checkpoint:leaf`` flip refused; then the mesh of shards
   (``mesh_path``): a 2x2 mesh whose positions all hold cuda:0, star2
   through ``sstencil`` (30 chained) and ``sstencil_iterate`` (100) at
   8192^2 float32 (TMA path) and 10 + 20 sweeps at 4099x4133 (uneven
   shards, cp.async path), the kernel launched once per shard per sweep
   and the result byte-equal to the one-shard kernel's; spmd with
   ``halo(2)`` (star2 by hand, masked with ``valid_mask``) equal to
   sstencil's interior; sreduce with a SreduceReducer over 2^28 float64
   and scumulative's cumsum over 2^26 float64 on 4 shards, each within
   its bound of the one-shard answer and rerun byte-equal; then the main
   path across processes (``dist_path``, alone with ``--dist``): four
   processes of this script (``--rank``) on cuda:0, the default 2x2 mesh
   of ranks over gloo through pinned host memory (NCCL refuses two ranks
   on one card), running star2 at 8192^2 (TMA) and 4099x4133 (cp.async),
   the sin/cos chain at 1e9 f64 and axpy + sum with their cross-rank
   sums, spmd ``halo(1)``/``halo(2)``, scumulative on the scan kernel, a
   SreduceReducer, 2 GiB ``.rtd``/``.npy`` files and a checkpointed
   solve, every result held byte-equal to the one-process result (block
   digests; the sums within 2 n eps sum, the same on every rank and
   rerun) with every rank's launches counted and no gathered program;
   then one rank over NCCL, and four ranks one per card over NCCL where
   the machine has four cards; then layouts chosen and changed across
   ranks (``layout_path``, alone with ``--layout``): four ranks on cuda:0
   run star2 at 8192^2 on arrays made by ``fromfunction(...,
   distribution=(4, 1))`` and ``(1, 4)`` and by
   ``create_array_with_divisions`` (2x2 ranges), reshard the 8192^2 grid
   rows -> columns -> 2x2 -> rows in one stage and in 16 MiB stages (each
   round trip byte-identical, peak transient bytes within dst + slab),
   sum ``2.5 * x + y`` over 16384^2 float64 with x row-split and y
   column-split (one aligning reshard, elemred on every rank), groupby
   sum/min/max/count/mean/var of the hourly series (2^28 float64, G=24;
   segred once a rank for each of sum/min/max/count, twice for mean,
   three times for var) and sum(axis=0)/sum(axis=1) of 8192^2 float64,
   with no gathered program, every block byte-equal to the one-process
   result (the sums within stated bounds); then, in this process, a
   budget that holds one 2 GiB float64 array and not two: placing the
   second spills the first to pinned host memory, reading it restores it
   byte-equal, ``memory.*`` counters before and after; then compile and
   caching (``compile_path``, alone with ``--compile``): two processes of
   this script (``--compile-child cold|warm``) on one fresh
   ``RAMBA_CACHE`` under ``RAMBA_COMPILE_CLASSES=pow2`` run the sin/cos
   chain over a materialised 2^28 float64 base (elemred), the hourly
   groupby sum (segred) and ``x * 2 + 1`` over 3e7 float32 (elemred at
   its own length: the kernels' programs are not bucketed): the warm one
   builds nothing, loads at least 3 libraries from the cache (persist
   hits) and gives the cold one's bytes; the shape soaks (ramba_tpu's 32
   row counts in 1..300 x 256 float32 on the generic lowering, then 32
   lengths in 2^20..2^26 float32 on elemred; the same 240 flushes each
   with classes off and under pow2 in turns, each from fresh plans, on
   elemred with its programs made to bucket and then as the port runs
   them, exact; every result byte-equal to the exact shape's; hit rate,
   pad waste, p50 and p95, launches, plans); a chain of 1000 instructions over 2^27 float64 at segment
   sizes 0, 384 and 64 (0, 3 and 16 segments, one elemred launch a
   segment at 64, the same bytes at all three); and the backend race
   (``RAMBA_AUTOTUNE=race``, K=3) on the sin/cos chain and axpy + sum at
   2^28 float64 and the hourly groupby sum, every sample held against
   the plain version, both p50s (CUDA events) and the latched winner,
   then a third process (``--compile-child race2``) on the written table
   that races nothing and launches the latched backends; then the static
   analyzer, the result memo and plan certificates (``analyze_path``,
   alone with ``--analyze``): the main path's elemred, stencil (both load
   paths, and on the 2x2 mesh of shards) and segred programs under
   ``RAMBA_VERIFY=strict`` byte-equal to verify unset with the same
   launches, ``RAMBA_MEMO=1`` (9 hits and 1 launch over the same buffers,
   misses over fresh ones, after in-place writes and for a new seed, a
   2 GiB result not retained, a spilled entry restored), 100 repeat
   flushes under verify off, strict and strict with ``RAMBA_PLANCERT=1``
   (99 certificate hits, prepare-plus-verify host time per flush), the
   offline linter over the path's trace, and the forged faults
   (``compile:bucket``, ``memo:insert``, ``plan:stale``); then the
   degradation ladder (``ladder_path``, alone with ``--ladder``): (a) the
   sin/cos chain over a 2^28 float64 base, axpy + sum 2^28, star2 at
   8192^2 and 4099x4133 (10 chained and 20 iterated sweeps), the hourly
   groupby sum, ``rt.cumsum`` 2^28 and the 1e9 headline chain, each on
   the fused rung with no degrade step; (b) every rung the ladder offers
   each of them forced through ``RAMBA_FAULTS`` (the host rung at 2^24 and
   2048^2) and held against the fused result, byte-equal or within its
   stated bound, each rung's wall beside the fused one; (c) the headline
   chain under a ``RAMBA_HBM_BUDGET`` below its estimated peak: kept on
   the fused rung where one result is larger than the chunked rung's
   bytes a segment, admitted to the chunked rung where it is not, and
   admission's own host time over healthy flushes; (d) a real out-of-memory error on a card filled
   with governed arrays, evicted and recovered with no buffer of the
   failed attempt left; (e) a transient fault retried in place, an
   injected fatal fault and a forged kernel build error raising with no
   degrade step; (f) the shadow audit (``RAMBA_MEMO=1 RAMBA_AUDIT=1``) of
   the elemred and segred programs, ``ok`` or ``numeric``, and a flipped
   shadow a mismatch that evicts; (g) four ranks on cuda:0 dropping
   together on one rank's fault and aborting together on a fatal one;
   then the elastic plane (``elastic_path``, alone with ``--elastic``):
   (a) the main path's programs with ``RAMBA_WATCHDOG_S`` armed and
   nothing seeded, on fused with the bytes and launches of unarmed, and
   the host microseconds of a flush armed against unarmed; (b) a seeded
   ``dispatch`` hang giving a degrade-class stall within two deadlines,
   the split rung's bytes, and a zombie that launches and commits
   nothing; (c) an attempt abandoned while it waits on a busy card
   (``RAMBA_PERF=sync``), the card's allocation unchanged after; (d) the
   heartbeat during 100 star2 sweeps and a seeded miss; (e) the
   ``CheckpointManager`` solver (8192^2, saves every 25, keep 2) and a
   child killed after step 50 resumed by a fresh process to the same
   bytes; (f) a checkpoint of the 8192^2 grid and a 2^28 float64 series
   resumed 4 -> 2 ranks -> this process (under a budget that spills) ->
   4 ranks, byte-equal; (g) ``live_reshape`` between meshes of shards
   (2x2 -> 4x1 -> one shard), of ranks ((2, 2) -> (4, 1)), and its
   checkpoint fallback; (h) rank 3 of 4 wedged and crashed at a
   checkpoint's barrier: a fatal stall on the others within two
   deadlines, the broken group refusing the next collective at once;
   then the observability plane (``observe_path``, alone with
   ``--observe``): (a) the main path's programs at full width (the sin/cos
   chain over a 1e9 f64 base, axpy + sum 2^28, star2 8192^2 chained 30
   and iterated 100, 4099x4133 iterated 100, the hourly groupby sum,
   cumsum 2^28) with attribution on: every span's stages plus its residual equal
   its wall, the median residual at most 5 %, each kernel fingerprint's
   fenced device p50 within 10 % of the same compiled call under this
   script's own CUDA events, its roofline ``bandwidth`` with a fraction
   of peak within 10 % of bound / p50, the bytes of ``RAMBA_ATTRIB=off``;
   (b) the fence's cost (unset, off, sample:16; ms a sweep, host us a
   flush, the same bytes, sample:16's fenced sequences); (c) the drift
   sentinel across two child processes (``--observe-child``) on an edited
   baseline; (d) one ``slo_breach`` with ``why``; (e) the Prometheus
   exporter scraped on 127.0.0.1, the atomic text file, the flight
   recorder's dumps; (f) ``RAMBA_PROFILE_DIR`` with ``deep``: a CUDA
   kernel event for every launch inside its ``ramba_flush`` range; (g)
   ``diagnostics.report()``, ``identity()``, ``dump()``, the timing
   names, ``jit``, ``remote``, ``get``; (h) four ranks under sample:4
   with the same stage signatures and fence logs, blocks byte-equal to
   one process.
   Every kernel's launch count is set to 0 just before each path and
   read just after; a path that does not launch its kernel fails the
   run;
4. a ``kernels`` JSON line, the card's name and power limit, and the last
   line ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when no CUDA device is present or when
any check fails.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

T_START = time.perf_counter()  # a compile child's first result counts from here

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# peak non-tensor-core rates on the H100 SXM (NVIDIA data sheet)
PEAK_OPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 67e12}
# the matmul paths' peaks (the same data sheet): float32 with TF32 off runs
# on the CUDA cores, float64 on the FP64 tensor cores
PEAK_MATMUL = {"float32": 67e12, "float64": 67e12}
EPS = {"float32": 2.0 ** -23, "float64": 2.0 ** -52}
# io_path's sizes: the draws, the Monte-Carlo points and the I/O array;
# the permutation; the solver's grid edge
IO_N = 1 << 28
IO_PERM_N = 1 << 26
IO_GRID = 8192


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


class Fail(RuntimeError):
    pass


def cuda_ms(fn, reps: int) -> float:
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


def max_abs(a, b) -> float:
    import torch

    if a.dtype == torch.bool:
        return float((a != b).sum().item())
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    return float((a.double() - b.double()).abs().max().item()) if a.numel() else 0.0


def check_close(what, got, want, rtol, reason, atol=0.0):
    """|got - want| <= atol + rtol * |want| everywhere; dtypes equal."""
    import torch

    if got.dtype != want.dtype or tuple(got.shape) != tuple(want.shape):
        raise Fail(f"{what}: {got.dtype}{tuple(got.shape)} vs "
                   f"{want.dtype}{tuple(want.shape)}")
    err = max_abs(got, want)
    if got.dtype == torch.bool or not got.is_floating_point():
        ok = torch.equal(got, want)
        log(f"  {what}: max_abs_err={err} (exact: {reason}) "
            f"{'ok' if ok else 'MISS'}")
    else:
        g, w = got.double(), want.double()
        excess = ((g - w).abs() - (atol + rtol * w.abs())).max().item()
        ok = bool(excess <= 0) and bool(torch.isfinite(g).all())
        log(f"  {what}: max_abs_err={err:.3e} (rtol={rtol}, atol={atol:.3e}: "
            f"{reason}) {'ok' if ok else 'MISS'}")
    if not ok:
        raise Fail(f"{what} disagrees with its plain version")
    return err


def check_exact(what, got, want, reason):
    """Equal values (NaN where NaN) and dtypes."""
    import torch

    if got.dtype != want.dtype or tuple(got.shape) != tuple(want.shape):
        raise Fail(f"{what}: {got.dtype}{tuple(got.shape)} vs "
                   f"{want.dtype}{tuple(want.shape)}")
    same = got == want
    if got.is_floating_point():
        same |= torch.isnan(got) & torch.isnan(want)
    ok = bool(same.all())
    err = max_abs(torch.nan_to_num(got), torch.nan_to_num(want))
    log(f"  {what}: max_abs_err={err} (exact: {reason}) {'ok' if ok else 'MISS'}")
    if not ok:
        raise Fail(f"{what} disagrees")
    return err


def bytes_equal(a, b) -> bool:
    """The same bytes, shape and dtype."""
    import torch

    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8),
                            b.reshape(-1).view(torch.uint8)))


def same_bits_but_nan(a, b) -> bool:
    """NaN in the same places and the same bits (sign bits included)
    everywhere else: inf - inf gives the card's NaN pattern on the card and
    the CPU's on the CPU."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    nan = torch.isnan(a)
    ibits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a.view(ibits)[~nan], b.view(ibits)[~nan]))


def stencil_paths(sk) -> dict:
    return {"tma": sk.launches_tma, "cpasync": sk.launches_cpasync,
            "ldst": sk.launches_ldst}


def path_taken(sk, before) -> str:
    """The one load path whose count moved since ``before``."""
    moved = [p for p, n in stencil_paths(sk).items() if n != before[p]]
    if len(moved) != 1:
        raise Fail(f"stencil path counters moved for {moved}, expected one")
    return moved[0]


def sm_clock_mhz(fn) -> tuple:
    """(current, max) SM clock in MHz, read by nvidia-smi while ``fn``'s
    launches (queued without a synchronise) keep the card busy."""
    import torch

    torch.cuda.synchronize()
    fn()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    torch.cuda.synchronize()
    cur, mx = out.stdout.strip().splitlines()[0].split(",")
    return float(cur), float(mx)


FP64_PIPE = {"DADD", "DMUL", "DFMA", "DSETP", "DMNMX", "DSET"}


def cuobjdump() -> str:
    import os
    import shutil

    for tool in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if tool and os.path.exists(tool):
            return tool
    raise Fail("cuobjdump not found")


def _kernel_section(text, path_code):
    """The lines of the elemred kernel of load path ``path_code`` (its
    template argument: 0 bulk, 1 plain) in ``cuobjdump`` output."""
    lines, keep = [], False
    for line in text.splitlines():
        if line.strip().startswith("Function"):
            name = line.split("Function", 1)[1]
            keep = "elemred_kernel" in name and f"Li{path_code}E" in name
            continue
        if keep:
            lines.append(line)
    if not lines:
        raise Fail("elemred kernel not found in the library")
    return lines


def elemred_resources(er, plan) -> dict:
    """Registers, stack and local memory per thread of the plan's bulk
    kernel (``cuobjdump -res-usage`` of the library nvcc built)."""
    import re

    from ramba_tpu_torch import _build

    out = subprocess.run([cuobjdump(), "-res-usage",
                          _build.build_so(plan.name, plan.source)],
                         capture_output=True, text=True, check=True).stdout
    sec = " ".join(_kernel_section(out, 0)[:3])
    got = {k: int(v) for k, v in re.findall(r"(REG|STACK|LOCAL):(\d+)", sec)}
    return {"registers": got.get("REG"), "stack": got.get("STACK"),
            "local": got.get("LOCAL")}


def elemred_sass(er, plan) -> dict:
    """FP64-pipe and all instructions per element of the plan's bulk kernel,
    counted in its SASS (``cuobjdump -sass`` of the library nvcc built):
    the tile loop (from the target of the kernel's outermost backward
    branch to that branch) over the elements a thread computes per tile,
    the whole kernel over the same, and the CALL, LDL and STL counts.  The
    trig functions' slow path (Payne-Hanek, taken for |x| >= 2^31) is a
    subroutine the loop CALLs, counted apart: this run's |x| <= 1e6 never
    takes it."""
    import collections
    import re

    from ramba_tpu_torch import _build

    sass = subprocess.run([cuobjdump(), "-sass",
                           _build.build_so(plan.name, plan.source)],
                          capture_output=True, text=True, check=True).stdout
    ins = []
    for line in _kernel_section(sass, 0):
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)(.*)", line)
        if m:
            ins.append((int(m.group(1), 16), m.group(2), m.group(3)))

    def target(rest):
        m = re.search(r"0x([0-9a-f]+)", rest)
        return int(m.group(1), 16) if m else None

    calls = [target(r) for _a, op, r in ins if op.startswith("CALL")]
    sub = min((c for c in calls if c is not None), default=None)
    main = [i for i in ins if sub is None or i[0] < sub]
    back = [(a - target(r), target(r), a) for a, op, r in main
            if op.startswith("BRA") and target(r) is not None and target(r) < a]
    if not back:
        raise Fail("elemred: no tile loop found in the SASS")
    _span, lo, hi = max(back)
    loop = collections.Counter(op for a, op, _r in main if lo <= a <= hi)
    whole = collections.Counter(op for _a, op, _r in main)
    subc = collections.Counter(op for a, op, _r in ins if sub is not None and a >= sub)

    def fp64(c):
        return sum(k for op, k in c.items()
                   if op.split(".")[0] in FP64_PIPE
                   or (op.split(".")[0] in ("F2F", "F2I", "I2F", "FRND")
                       and "F64" in op))

    def count(c, prefix):
        return sum(k for op, k in c.items() if op.split(".")[0] == prefix)

    ept = plan.ept
    return {"fp64_per_elem": fp64(loop) / ept,
            "all_per_elem": sum(loop.values()) / ept,
            "kernel_fp64_per_elem": fp64(whole) / ept,
            "kernel_all_per_elem": sum(whole.values()) / ept,
            "slow_path_fp64": fp64(subc), "slow_path_all": sum(subc.values()),
            "calls": count(whole, "CALL"), "ldl": count(whole + subc, "LDL"),
            "stl": count(whole + subc, "STL"), "per_thread": ept}


def sum_bound(depth, dtype_name, sum_abs):
    """What a float reduction may differ from its plain version by.  An
    order whose longest chain of roundings is ``depth`` errs by at most
    depth * eps/2 * sum|x| (first order); ``2 * depth * eps * sum|x|``
    covers the kernel's order (the depth its module states) and a plain
    order up to three times as deep.  ``sum_abs`` is sum|x| of each
    output (|value| for a product)."""
    return 2 * depth * EPS[dtype_name] * sum_abs


def prod_bound(n_g, dtype_name, prod_abs):
    """What a float product of n_g factors may differ from its plain
    version by.  Every one of its roundings scales the whole product, in
    any order, so the worst case grows as n_g * eps/2; with rounding
    errors independent and of mean zero, each order stays within
    10 * sqrt(n_g) * eps/2 relative but with probability below 1e-21
    (Higham and Mary, SIAM J. Sci. Comput. 41(5), 2019, Thm. 2.4, at
    lambda = 10).  Twice that covers both orders."""
    return 10 * n_g ** 0.5 * EPS[dtype_name] * prod_abs


def check_sums(what, got, want, bound, reason):
    """Float reductions: |got - want| <= bound elementwise (a tensor, or
    one number for all), dtypes equal."""
    import torch

    err = (got.double() - want.double()).abs()
    bound = torch.as_tensor(bound, dtype=torch.float64, device=err.device)
    ok = bool((err <= bound).all()) and got.dtype == want.dtype
    ratio = torch.where(bound > 0, err / bound, err).max().item()
    log(f"  {what}: max_abs_err={err.max().item():.3e}, largest err/bound "
        f"{ratio:.4f} ({reason}) {'ok' if ok else 'MISS'}")
    if not ok:
        raise Fail(f"{what} disagrees with its plain version")
    return err.max().item()


def _op_nodes(expr):
    """The operation nodes of a tap expression, each once."""
    stack, seen = [expr], set()
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        if node.kind == "op":
            yield node
        stack.extend(node.args)


# ---------------------------------------------------------------------------


def star2_body(a):
    return (
        0.25 * (a[0, 1] + a[0, -1] + a[1, 0] + a[-1, 0])
        + 0.125 * (a[0, 2] + a[0, -2] + a[2, 0] + a[-2, 0])
    )


def div0_body(a):
    """Integer floor division with zero divisors inside a float64 body."""
    num = (a[0, 1] > 0.5) * 1 - (a[0, 1] < -0.5) * 1  # -1, 0 or 1
    den = (a[0, -1] > 0) * 2  # 0 or 2
    return num // den + 0.0 * a[0, 0]


SEG_KINDS = ("sum", "prod", "min", "max", "count")
SEG_DTYPES = ("float32", "float64", "int32", "int64")


# (kind, data dtype) cases phase 2 also runs with int64 labels
SEG_LABELS64 = (("sum", "float64"), ("min", "float32"), ("count", "int64"))


def segred_specs(sg, gb):
    """The segred sources phase 2 and the main path launch."""
    cases = [(k, d, "int32") for k in SEG_KINDS for d in SEG_DTYPES]
    cases += [(k, d, "int64") for k, d in SEG_LABELS64]
    return sorted({sg.spec_for(k, lab if k == "count" else d,
                               gb.segment_dtype(k, d), lab)
                   for k, d, lab in cases})


def segred_program(rt, x, labels, G, kind):
    """(program, leaves) of one segment reduction over ``x`` (a port
    array) with ``labels`` (a host array of their own dtype)."""
    from ramba_tpu_torch.core.expr import Node
    from ramba_tpu_torch.core.ndarray import ndarray

    lab = rt.fromarray(labels)
    return _program(lambda: [ndarray(Node("segment_reduce", (kind, G, 0),
                                          [x.read_expr(), lab.read_expr()]))])


def segred_checks(rt, sg, torch, np):
    """Every kind x dtype x G in {1, 24, 64} at a ragged n, labels -1 and G
    among them, NaNs for min/max; each kernel result held against the plain
    version and rerun for byte equality."""
    n = (1 << 22) + 37
    rs = np.random.RandomState(5)
    worst = 0.0
    for dt in SEG_DTYPES:
        for G in (1, 24, 64):
            labels = rs.randint(-1, G + 1, n).astype(np.int32)
            lab_t = torch.from_numpy(labels).cuda()
            for kind in SEG_KINDS:
                if dt.startswith("float"):
                    v = rs.uniform(0.5, 1.5, n)
                    if kind == "prod":  # log|prod_g| ~ N(0, 3): finite, and
                        # one CTA's factors move it by ~9 %
                        v = np.exp(rs.uniform(-1, 1, n) * 3 * np.sqrt(3 * (G + 2) / n))
                    if kind in ("min", "max"):
                        v[rs.randint(0, n, 3)] = np.nan
                else:
                    v = rs.randint(-1000, 1000, n)
                x = rt.fromarray(v.astype(dt))
                cases = [(labels, "int32")]
                if (kind, dt) in SEG_LABELS64:
                    cases.append((labels.astype(np.int64), "int64"))
                for lab, lname in cases:
                    p, lv = segred_program(rt, x, lab, G, kind)
                    got = sg.launch(p, lv)[0]
                    again = sg.launch(p, lv)[0]
                    want = sg.segred_reference(p, lv)[0]
                    torch.cuda.synchronize()
                    what = f"segred {kind} {dt} G={G} labels {lname} n={n}"
                    if not torch.equal(got.view(torch.uint8), again.view(torch.uint8)):
                        raise Fail(f"{what}: rerun not byte-equal")
                    if got.is_floating_point() and kind in ("sum", "prod"):
                        if kind == "sum":
                            xt = x._value().double().abs()
                            scale = torch.stack([xt[lab_t == g].sum()
                                                 for g in range(G)])
                            reason = "2*depth*eps*sum|x_g|, another order"
                            bound = sum_bound(sg.depth(n), dt, scale)
                        else:
                            n_g = torch.stack([(lab_t == g).sum()
                                               for g in range(G)]).double()
                            bound = prod_bound(n_g, dt, want.double().abs())
                            reason = "10*sqrt(n_g)*eps*|prod_g|, another order"
                        worst = max(worst, check_sums(what, got, want, bound, reason))
                    else:
                        worst = max(worst, check_exact(
                            what, got, want, "integers, min/max (NaN wins), count"))
                del x
    log("  segred reruns byte-equal: True (every case above launched twice)")
    return worst


def repair_checks(rt, er, sk, torch, np):
    """Integer // 0 on the elemred and stencil kernels against the rule
    itself (-1 for 0 // 0, -2 for x // 0 otherwise), a uint32 chain against
    NumPy's uint32 arithmetic."""
    n = (1 << 20) + 3
    rs = np.random.RandomState(9)
    for dt in ("int32", "int64"):
        a_np = rs.randint(-5, 6, n).astype(dt)
        b_np = (rs.randint(0, 4, n) * rs.choice([-1, 1], n)).astype(dt)
        a, b = rt.fromarray(a_np), rt.fromarray(b_np)
        p, lv = _program(lambda: [a // b, a % b])
        q, r = er.launch(p, lv)
        torch.cuda.synchronize()
        with np.errstate(all="ignore"):
            want_q = np.where(b_np == 0, np.where(a_np == 0, -1, -2),
                              a_np // np.where(b_np == 0, 1, b_np)).astype(dt)
            want_r = np.where(b_np == 0, 0, a_np % np.where(b_np == 0, 1, b_np))
        check_exact(f"elemred {dt} a // b, {int((b_np == 0).sum())} zero divisors",
                    q.cpu(), torch.from_numpy(want_q), "the x // 0 rule")
        check_exact(f"elemred {dt} a % b", r.cpu(),
                    torch.from_numpy(want_r.astype(dt)), "x % 0 is 0")
    slots = (("arr", 0),)
    tr = sk.trace(div0_body, slots)
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    xs = torch.randn(1031, 517, generator=g, device="cuda", dtype=torch.float64)
    if not sk.available(div0_body, tr.lo, tr.hi, slots, [xs]):
        raise Fail("the stencil kernel does not take div0_body")
    got = sk.launch(div0_body, tr.lo, tr.hi, slots, [xs], torch.empty_like(xs))
    plain = sk.stencil_reference(div0_body, tr.lo, tr.hi, slots, [xs])
    num = (xs[:, 2:] > 0.5).long() - (xs[:, 2:] < -0.5).long()
    den = (xs[:, :-2] > 0).long() * 2
    q = torch.where(den == 0, torch.where(num == 0, -1, -2),
                    torch.div(num, torch.where(den == 0, 1, den),
                              rounding_mode="floor"))
    want = torch.zeros_like(xs)
    want[:, 1:-1] = q.double()
    check_exact("stencil int64 floor_divide by 0 in a f64 body (kernel)", got, want,
                "the x // 0 rule")
    check_exact("stencil int64 floor_divide by 0 in a f64 body (plain)", plain,
                want, "the x // 0 rule")
    # unsigned: the generic lowering through its int64 carrier, on the card
    u_np = rs.randint(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    u = rt.fromarray(u_np)
    w = ((u * 2654435761 + 12345) >> 7) // (u % 1000 + 1) - (u >> 20)
    s, mx = rt.sum(w), rt.max(w)
    with np.errstate(all="ignore"):
        w_np = ((u_np * np.uint32(2654435761) + np.uint32(12345)) >> np.uint32(7)) \
            // (u_np % np.uint32(1000) + np.uint32(1)) - (u_np >> np.uint32(20))
    got_w = w.asarray()
    ok = (got_w.dtype == np.uint32 and np.array_equal(got_w, w_np)
          and np.asarray(s).dtype == np.uint64 and int(s) == int(w_np.sum())
          and int(mx) == int(w_np.max()))
    log(f"  uint32 chain n={n} (mul, add, >>, //, %, -, sum -> uint64, max) "
        f"against numpy: exact {'ok' if ok else 'MISS'}")
    if not ok:
        raise Fail("uint32 chain disagrees with numpy")
    int_scalar_checks(rt, er, torch, np)
    cast_sign_checks(rt, er, torch)


def int_scalar_programs(rt, x):
    """(name, expression) of the elemred programs with out-of-range ints."""
    return [("x + 2**40", lambda: x + 2 ** 40),
            ("x * (2**33 + 3)", lambda: x * (2 ** 33 + 3)),
            ("maximum(x, 2**32 + 5)", lambda: rt.maximum(x, 2 ** 32 + 5))]


def int_scalar_checks(rt, er, torch, np):
    """A Python int outside an integer array's dtype: arithmetic wraps
    modulo the dtype through the elemred kernel (its C casts) as on the
    generic lowering; a comparison with it is exact (one constant); integer
    reciprocal of 0 is the dtype's maximum on the generic lowering."""
    n = (1 << 20) + 3
    x_np = (np.arange(n) % 201 - 100).astype(np.int32)
    x = rt.fromarray(x_np)
    wants = (x_np, x_np * 3, np.maximum(x_np, 5))
    for (what, make), want in zip(int_scalar_programs(rt, x), wants):
        p, lv = _program(lambda: [make()])
        (got,) = er.launch(p, lv)
        check_exact(f"elemred int32 {what}", got.cpu(),
                    torch.from_numpy(want.astype(np.int32)),
                    "the int wraps modulo 2**32")
    check_exact("int32 x < 2**40 (one constant)",
                torch.from_numpy((x < 2 ** 40).asarray()),
                torch.ones(n, dtype=torch.bool), "NumPy compares exactly")
    for dt, top in (("int8", 127), ("int32", 2 ** 31 - 1), ("uint8", 255),
                    ("int64", 2 ** 63 - 1)):
        v = np.array([0, 1, 2, 0, 3], dt)
        got = rt.reciprocal(rt.fromarray(v)).asarray()
        check_exact(f"reciprocal {dt} of 0 on the generic lowering",
                    torch.from_numpy(got),
                    torch.from_numpy(np.array([top, 1, 0, top, 0], dt)),
                    "1 // 0 is the dtype's maximum")


# float -> int casts saturate (NaN to 0, out of range to the limits) and
# sign keeps a zero's sign, as in ramba_tpu
CAST_VALUES = [128.5, -129.5, float("nan"), float("inf"), float("-inf"), 1e30,
               -1e30, 2.0 ** 63, -2.0 ** 63, 2.0 ** 31, -2.0 ** 31 - 1.5, 1.7,
               -1.7, -0.5, 0.0, 3e9, -3e9]
SIGN_VALUES = [-0.0, 0.0, -2.5, 3.0, float("nan"), float("-inf")]


def cast_sign_programs(rt, x):
    """The elemred programs of the cast and sign repairs over ``x``."""
    return [lambda: [x.astype("int32")], lambda: [x.astype("int64")],
            lambda: [rt.sign(x)]]


def cast_sign_checks(rt, er, torch):
    """The saturating casts and sign(-0.0) on the card: through elemred
    (its emitted casts test the range before casting, as a C cast of an
    out-of-range float is undefined) and through the generic lowering
    (``expr.convert``), both against the rule on the CPU."""
    from ramba_tpu_torch.core import expr as E

    for tdt in (torch.float64, torch.float32):
        vals = torch.tensor(CAST_VALUES, dtype=torch.float64).to(tdt)
        xc = vals.repeat(1 << 16).cuda()
        x = rt.fromarray(xc)
        progs = cast_sign_programs(rt, x)
        for f, dst in zip(progs[:2], (torch.int32, torch.int64)):
            p, lv = _program(f)
            if er.kb.classify(p, lv) != "elemred":
                raise Fail("elemred does not take a float -> int cast")
            (got,) = er.launch(p, lv)
            want = E.convert(xc.cpu(), dst)
            check_exact(f"elemred cast {tdt} -> {dst} (NaN, inf, out of range)",
                        got.cpu(), want, "saturating, as ramba_tpu")
        for dst in (torch.int8, torch.uint8, torch.int16, torch.int32,
                    torch.int64, torch.uint64):
            check_exact(f"generic lowering cast {tdt} -> {dst}",
                        E.convert(xc, dst).cpu(), E.convert(xc.cpu(), dst),
                        "saturating, as ramba_tpu")
        sv = torch.tensor(SIGN_VALUES, dtype=torch.float64).to(tdt)
        sc_ = sv.repeat(1 << 16).cuda()
        p, lv = _program(lambda: [rt.sign(rt.fromarray(sc_))])
        (got,) = er.launch(p, lv)
        (plain,) = er.elemred_reference(p, lv)
        torch.cuda.synchronize()
        zero = sc_ == 0
        ok = (bytes_equal(got, plain) and torch.equal(
            torch.signbit(got[zero]), torch.signbit(sc_[zero])))
        log(f"  elemred sign {tdt} of -0.0/0.0/NaN/-inf: byte-equal to the "
            f"plain version, zeros keep their sign {'ok' if ok else 'MISS'}")
        if not ok:
            raise Fail("sign(-0.0) on the card")
    spacing_checks(rt, er, torch)


SPACING_VALUES = [0.0, -0.0, 1.0, -1.0, 1e-40, -1e-40, 6e-8, -6e-8, 3.0e38,
                  65504.0, 1e300, float("inf"), float("-inf"), float("nan"),
                  2.5, -7.25]


def spacing_checks(rt, er, torch):
    """``spacing`` on the card: the elemred classifier turns it away (no
    C++ for nextafter in the emitter), so it runs on the generic lowering;
    its bytes there equal the plain version's on the CPU for float16, 32
    and 64, ramba_tpu's rule (-0.0 gives the negative smallest subnormal,
    NaN and inf give NaN)."""
    from ramba_tpu_torch.core import expr as E

    for tdt in (torch.float16, torch.float32, torch.float64):
        vals = torch.tensor(SPACING_VALUES, dtype=torch.float64).to(tdt)
        xc = vals.repeat(1 << 16).cuda()
        p, lv = _program(lambda: [rt.spacing(rt.fromarray(xc))])
        if er.kb.classify(p, lv) is not None:
            raise Fail("a kernel took spacing: this check expects the "
                       "generic lowering")
        got = rt.spacing(rt.fromarray(xc))._value().cpu()
        want = E.UNARY["spacing"](xc.cpu())
        ok = same_bits_but_nan(got, want)
        log(f"  spacing {tdt} (generic lowering on the card) of "
            f"+-0/subnormal/inf/NaN/1e300: NaN where the plain version on "
            f"the CPU has NaN, its bits elsewhere (a NaN's payload is the "
            f"hardware's) {'ok' if ok else 'MISS'}")
        if not ok:
            raise Fail(f"spacing {tdt} on the card")


def phase_build(rt, er, sk, sg, gb, jacobi, sc):
    """Build every CUDA kernel of the run at once: the stencil bodies, the
    segred instantiations, every elemred program phases 2 and 3 launch
    (one library per program; the source does not depend on n) and the
    scan (one library, eight entry points)."""
    import numpy as np
    from ramba_tpu_torch import _build
    from ramba_tpu_torch.core.expr import BF16

    K = jacobi._kernels()
    bodies = [(star2_body, 1, np.float32), (star2_body, 1, BF16),
              (K["sweep"].func, 2, np.float64), (K["lap"].func, 1, np.float64),
              (div0_body, 1, np.float64)]
    specs = []
    for func, n_slots, dt in bodies:
        tr = sk.trace(func, tuple(("arr", k) for k in range(n_slots)))
        spec = sk.spec_for(tr.expr, tr.lo, tr.hi, n_slots, dt)
        if spec is None:
            raise Fail(f"stencil kernel does not take {func.__name__} in {dt}")
        specs.append(spec)
    seg = segred_specs(sg, gb)
    plans = {p.name: p for p in elemred_plans(rt, er, np)}
    t0 = time.perf_counter()
    _build.build_many([(s.name, s.source) for s in specs + seg]
                      + [(p.name, p.source) for p in plans.values()]
                      + [(sc.NAME, sc.SOURCE)])
    log(f"phase 1: built {len(specs)} CUDA stencil, {len(seg)} CUDA segred, "
        f"{len(plans)} CUDA elemred kernels and the CUDA scan in "
        f"{time.perf_counter() - t0:.2f} s (nvcc, sm_90a, one process per "
        f"source, in parallel)")


def trig_program(rt, base, twice=False):
    """The main path's chain over a materialised ``base`` (B = sin(base),
    C = cos(base), D = B*B + C*C, sum(D)), or with each transcendental
    spelled twice (four per element)."""
    def build():
        if twice:
            D = rt.sin(base) * rt.sin(base) + rt.cos(base) * rt.cos(base)
        else:
            B, C = rt.sin(base), rt.cos(base)
            D = B * B + C * C
        return [D, rt.sum(D)]
    return _program(build)


def sincos_program(rt, x):
    """sin(x), cos(x) and sin^2 + cos^2 as outputs."""
    return _program(lambda: (lambda B, C: [B, C, B * B + C * C])(
        rt.sin(x), rt.cos(x)))


def axpy_program(rt, x, y):
    return _program(lambda: (lambda z: [z, rt.sum(z)])(2.5 * x + y))


def float_checks(rt, x, y):
    """(name, expressions) of the elemred checks over float leaves."""
    return [
        ("sin/cos+sum", lambda: (lambda D: [D, rt.sum(D)])(
            rt.sin(x) * rt.sin(x) + rt.cos(x) * rt.cos(x))),
        ("axpy+sum", lambda: (lambda z: [z, rt.sum(z)])(2.5 * x + y)),
        ("mean/min/max", lambda: (lambda v: [rt.mean(v), rt.min(v), rt.max(v)])(
            x * 3.0 - y)),
        ("sqrt/divide/floor_divide/mod", lambda: [
            rt.sqrt(x) / (y - 0.5), (x * 7.0) // y, (x * 7.0) % (y - 0.5)]),
    ]


def int_checks(rt, a, b):
    """(name, expressions) of the elemred checks over integer leaves."""
    return [("floor_divide/mod+sum", lambda: (lambda c: [c, rt.sum(c)])(
        (a // b) + (a % b) * 3)),
        ("a // b, a % b", lambda: [a // b, a % b])]


def elemred_plans(rt, er, np):
    """The plan of every elemred program the run launches, on tiny leaves
    of the same dtypes (a plan's source does not depend on n)."""
    rs = np.random.RandomState(0)
    plans = []
    for dt in ("float32", "float64"):
        x = rt.fromarray(rs.rand(64).astype(dt))
        y = rt.fromarray(rs.rand(64).astype(dt))
        for _name, f in float_checks(rt, x, y):
            plans.append(er.plan_for(*_program(f)))
        for p, lv in (trig_program(rt, x), trig_program(rt, x, True),
                      sincos_program(rt, x)):
            plans.append(er.plan_for(p, lv))
            plans.append(er.plan_for(p, lv, er.CONFIG._replace(sincos=False)))
        if dt == "float64":  # the skeletons phase sums a synced smap result
            plans.append(er.plan_for(*_program(lambda: [rt.sum(x)])))
        for f in cast_sign_programs(rt, x):
            plans.append(er.plan_for(*_program(f)))
        if dt == "float64":  # the indexing phase's np.where
            plans.append(er.plan_for(*_program(
                lambda: [np.where(x > 0, x, y)])))
        if dt == "float64":  # io_path's Monte-Carlo estimate
            plans.append(er.plan_for(*_program(
                lambda: [mc_hits(rt, x, y)])))
        if dt == "float64":  # breadth_path's fix and around
            plans.append(er.plan_for(*_program(lambda: [rt.fix(x)])))
            plans.append(er.plan_for(*_program(lambda: [rt.around(x, 2)])))
        if dt == "float64":  # layout_path: the two-layout sum, a var's
            # sum of squares
            plans.append(er.plan_for(*_program(
                lambda: [rt.sum(2.5 * x + y)])))
            plans.append(er.plan_for(*_program(lambda: [x * x])))
        if dt == "float32":  # compile_path: the bucketed program and soak
            plans.append(er.plan_for(*_program(lambda: [x * 2.0 + 1.0])))
        if dt == "float64":  # compile_path: the chain's segments at 64
            plans += segment_plans(er, x)
    for dt in ("int32", "int64"):
        a = rt.fromarray(rs.randint(-5, 6, 64).astype(dt))
        b = rt.fromarray(rs.randint(1, 6, 64).astype(dt))
        for _name, f in int_checks(rt, a, b):
            plans.append(er.plan_for(*_program(f)))
        if dt == "int32":  # the repair checks' out-of-range Python ints
            for _name, f in int_scalar_programs(rt, a):
                plans.append(er.plan_for(*_program(lambda: [f()])))
        if dt == "int64":  # bincount's min and max of its labels
            plans.append(er.plan_for(*_program(lambda: [a.min()])))
            plans.append(er.plan_for(*_program(lambda: [a.max()])))
    return plans


def mc_hits(rt, x, y):
    """The Monte-Carlo estimate's count of draws inside the quarter circle:
    an int64 sum of a bool compare (exact in any order; ``mean`` of a bool
    is float32 by jnp's rule, so the estimate divides on the host)."""
    return rt.sum(x * x + y * y <= 1.0)


def _program(exprs_of):
    """(program, leaf values) of the expressions ``exprs_of()`` builds; the
    arrays it made are dropped, so nothing stays pending."""
    from ramba_tpu_torch.core import fuser

    arrays = exprs_of()
    exprs = [a._expr for a in arrays]
    del arrays
    return fuser.prepare_program(exprs)


def elemred_paths(er) -> dict:
    return {"bulk": er.launches_bulk, "plain": er.launches_plain}


def elemred_checks(rt, er, torch, np):
    """The test programs at n = 2**24 + 37 (a ragged tail), each launched
    twice (the reruns must be byte-equal) on aligned leaves (the bulk
    path) and the float ones again on ``x[1:]`` views (plain loads); then
    sincos against separate sin and cos, byte for byte."""
    n = (1 << 24) + 37
    rs = np.random.RandomState(0)
    worst = 0.0
    used = {"bulk": 0, "plain": 0}

    def compare(name, program, lv, dt, sum_abs=()):
        """Vector outputs elementwise; reductions: exact for integers and
        min/max, within :func:`sum_bound` of elemred's depth on this
        launch's grid (``sum_abs`` in output order; a mean's is sum|x| /
        n) for float sums and means."""
        nonlocal worst
        path, grid, ept = er.geometry(program, lv)
        before = elemred_paths(er)
        got = er.launch(program, lv)
        again = er.launch(program, lv)
        moved = {k: v - before[k] for k, v in elemred_paths(er).items()}
        if moved != {path: 2, **{k: 0 for k in used if k != path}}:
            raise Fail(f"{name}: path counters moved by {moved}, expected {path}")
        used[path] += 2
        want = er.elemred_reference(program, lv)
        torch.cuda.synchronize()
        if not all(bytes_equal(a, b) for a, b in zip(got, again)):
            raise Fail(f"{name}: rerun not byte-equal")
        bounds = iter(sum_abs)
        name = f"{name} ({path}, grid {grid})"
        for k, (g, w) in enumerate(zip(got, want)):
            if g.ndim == 1 and not g.is_floating_point():
                worst = max(worst, check_close(f"{name} out{k}", g, w, 0,
                                               "integers"))
            elif g.ndim == 1:
                rtol = 1e-6 if dt == "float32" else 1e-12
                worst = max(worst, check_close(
                    f"{name} out{k}", g, w, rtol,
                    f"{dt} elementwise; CUDA's and torch's math differ by ulps",
                    atol=rtol))
            else:
                b = next(bounds)
                if b is None:
                    check_close(f"{name} red{k}", g, w, 0,
                                "integer sum, or min/max: order-independent")
                else:
                    check_sums(f"{name} red{k}", g, w,
                               sum_bound(er.depth(n, grid, ept) + 1, dt, float(b)),
                               "2*depth*eps*sum|x|, another order")
        return got

    for dt in ("float32", "float64"):
        tdt = getattr(torch, dt)
        xt = torch.from_numpy(rs.rand(n + 1).astype(dt)).cuda()
        yt = torch.from_numpy(rs.rand(n + 1).astype(dt)).cuda()
        xs, ys = xt[:n].double().abs().sum(), yt[:n].double().abs().sum()
        sums = {"sin/cos+sum": [2.0 * n], "axpy+sum": [2.5 * xs + ys],
                "mean/min/max": [(3.0 * xs + ys) / n, None, None],
                "sqrt/divide/floor_divide/mod": []}
        for view in (False, True):
            x = rt.fromarray(xt[1:] if view else xt[:n].clone())
            y = rt.fromarray(yt[1:] if view else yt[:n].clone())
            if view:  # the view's sums differ from the aligned copy's
                xv, yv = xt[1:].double().abs().sum(), yt[1:].double().abs().sum()
                sums["axpy+sum"] = [2.5 * xv + yv]
                sums["mean/min/max"] = [(3.0 * xv + yv) / n, None, None]
            for name, f in float_checks(rt, x, y):
                p, lv = _program(f)
                compare(f"elemred {name} {dt}{' x[1:]' if view else ''}", p, lv,
                        dt, sums[name])
            del x, y
        # sin and cos themselves (sin^2 + cos^2 hides a wrong input), as
        # one sincos and as separate calls, over |x| < 1e4 plus signed
        # zeros, infinities, NaN and |x| >= 2^31 (the slow path): each
        # against the plain version, and the two byte for byte
        special = torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                                float("nan"), 2.0 ** 31, -3 * 2.0 ** 31, 1e30,
                                -1e30, 12345678.9, 1e6, -1e6], dtype=tdt,
                               device="cuda")
        xs = (xt[:n] - 0.5) * 2e4
        xs[:special.numel()] = special
        x = rt.fromarray(xs)
        p, lv = sincos_program(rt, x)
        fused = er.launch(p, lv)
        apart = er.launch(p, lv, er.CONFIG._replace(sincos=False))
        want = er.elemred_reference(p, lv)
        torch.cuda.synchronize()
        rtol = 1e-6 if dt == "float32" else 1e-12
        for k, what in enumerate(("sin", "cos")):
            for got, how in ((fused, "one sincos"), (apart, "separate calls")):
                fin = torch.isfinite(want[k])
                worst = max(worst, check_close(
                    f"elemred {what} |x| < 1e4 {dt} ({how})", got[k][fin],
                    want[k][fin], rtol, f"{dt} elementwise", atol=rtol))
        same = all(bytes_equal(a, b) for a, b in zip(fused, apart))
        log(f"  elemred sincos vs separate sin and cos, {dt}, n={n}, |x| < 1e4 "
            f"with +-0, +-inf, NaN, |x| >= 2^31: byte-equal {same}")
        if not same:
            raise Fail("sincos differs from separate sin and cos")
        del xt, yt, xs, x, fused, apart, want
    a = rt.fromarray((rs.randint(-1000, 1000, n)).astype(np.int32))
    # divisors of both signs, and some zeros: integer x // 0 and x % 0 are 0
    b = rt.fromarray((rs.randint(0, 50, n) * rs.choice([-1, 1], n)).astype(np.int32))
    name, f = int_checks(rt, a, b)[0]
    p, lv = _program(f)
    compare(f"elemred int32 {name}", p, lv, "int32", [None])
    log(f"  elemred launches by load path in these checks: {used}; reruns "
        "byte-equal (every program above launched twice)")
    if not all(used.values()):
        raise Fail("an elemred load path went unexercised")
    return worst


def hourly_series(torch, np, n, seed=0):
    """An hourly sensor series: n float64 readings made on the card from a
    seed (a daily cycle plus noise) and their int32 hour-of-day labels."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    t = torch.arange(n, device="cuda", dtype=torch.float64)
    x = 20.0 + 5.0 * torch.sin(t * (2 * np.pi / 24)) \
        + torch.randn(n, generator=g, device="cuda", dtype=torch.float64)
    del t
    # hour of day 0..23 repeating, int32 (tiled: no int64 pass over n)
    return x, np.tile(np.arange(24, dtype=np.int32), -(-n // 24))[:n]


def category_series(torch, np, n, G, seed=1):
    """n float32 values with seeded random category codes in [0, G)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    x = torch.rand(n, generator=g, device="cuda", dtype=torch.float32)
    codes = torch.randint(0, G, (n,), generator=g, device="cuda",
                          dtype=torch.int32)
    return x, codes.cpu().numpy()


_LIB_REDUCE = {"sum": "sum", "prod": "prod", "min": "amin", "max": "amax"}


def time_segred(sg, torch, g, kind, what, card):
    """``getattr(g, kind)()`` of a groupby ``g`` as one segred program on
    the card: its kernel result held against the plain version, then
    kernel, plain and library times (CUDA events) beside the byte bound.
    Returns the row's numbers and the kernel's result."""
    G = g.num_groups
    p, lv = _program(lambda: [getattr(g, kind)()])
    got = sg.launch(p, lv)[0]
    want = sg.segred_reference(p, lv)[0]
    torch.cuda.synchronize()
    dname = str(lv[0].dtype).split(".")[1]
    if got.is_floating_point() and kind == "sum":
        data, lab = lv[0].double().abs(), lv[1]
        sum_abs = torch.stack([data[lab == k].sum() for k in range(G)])
        del data
        err = check_sums(f"{what} kernel vs plain", got, want,
                         sum_bound(sg.depth(lab.numel()), dname, sum_abs),
                         "2*depth*eps*sum|x_g|, another order")
    else:
        err = check_exact(f"{what} kernel vs plain", got, want,
                          "min/max/count: order-independent")
    ms = cuda_ms(lambda: sg.launch(p, lv), 10)
    plain_ms = cuda_ms(lambda: sg.segred_reference(p, lv), 3)
    lab_t = lv[1]
    idx = lab_t.long()  # scatter_reduce_ and bincount index in int64
    if kind == "count":
        lib = lambda: torch.bincount(idx, minlength=G)  # noqa: E731
        lib_name = "bincount"
    else:
        src = lv[0]
        lib = lambda: torch.zeros(  # noqa: E731
            G, dtype=src.dtype, device="cuda").scatter_reduce_(
                0, idx, src, _LIB_REDUCE[kind], include_self=False)
        lib_name = f"scatter_reduce_({_LIB_REDUCE[kind]})"
    lib_ms = cuda_ms(lib, 10)
    n = lab_t.numel()
    nbytes = n * lab_t.element_size() + G * got.element_size()
    if kind != "count":
        nbytes += n * lv[0].element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = n / PEAK_OPS.get(dname, PEAK_OPS["float32"])
    bound_ms = 1e3 * max(t_bytes, t_ops)
    note = "; a float sum by atomics, not deterministic" \
        if kind == "sum" and got.is_floating_point() else ""
    log(f"  {what}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, {lib_name} "
        f"{lib_ms:.4f} ms (index widened to int64 beforehand{note}), bound "
        f"{bound_ms:.4f} ms ({nbytes / 1e9:.3f} GB at 3.35 TB/s) [{card}]")
    del p, lv, idx
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms}, got


def scan_checks(sc, torch, card):
    """The fixed-order scan against its plain version (the same tiles in
    the same order: the same bytes), within the rounding-depth bound
    2 * depth * eps * cumsum|x| of the float64 scan, launched on one CTA,
    on a small odd grid and twice on the default grid (all byte-equal: the
    bytes do not depend on the grid), at 2^28 float64 and float32, along
    both axes of 16384^2 float32 and on two rows that cross checkpoints;
    float16, bfloat16 and the products on a ragged (3, 2 * TILE + 37).
    Then the kernel timed beside its plain version, torch.cumsum and its
    byte bound."""
    g = torch.Generator(device="cuda")
    g.manual_seed(21)
    worst = 0.0
    grids = (1, 7, None, None)  # one CTA, a small odd grid, the default twice

    def case(what, x, name, axis):
        nonlocal worst
        before = sc.launches
        outs = [sc.launch(x, name, axis, ctas) for ctas in grids]
        want = sc.scan_reference(x, name, axis)
        torch.cuda.synchronize()
        if sc.launches != before + len(grids):
            raise Fail(f"{what}: scan launches not counted")
        got = outs[-1]
        if not all(bytes_equal(got, o) for o in outs[:-1]):
            raise Fail(f"{what}: grids 1, 7 and {sc.grid(x.device)} or two "
                       f"launches differ in their bytes")
        same = bytes_equal(got, want)
        dname = str(x.dtype).split(".")[1]
        if name == "cumsum" and dname in EPS:
            bound = sum_bound(sc.depth(x.shape[axis]), dname,
                              torch.cumsum(x.double().abs(), axis))
            worst = max(worst, check_sums(
                f"{what} vs the float64 scan", got.double(),
                torch.cumsum(x.double(), axis), bound,
                "2*depth*eps*cumsum|x|"))
        log(f"  {what}: byte-equal to its plain version {same}; grids 1, 7 "
            f"and {sc.grid(x.device)} and a second launch byte-equal True "
            f"[{card}]")
        if not same:
            raise Fail(f"{what}: the kernel's order is not the plain version's")
        del outs, got, want

    n = 1 << 28
    x64 = torch.randn(n, generator=g, device="cuda", dtype=torch.float64)
    case("scan cumsum 1-D n=2^28 float64", x64, "cumsum", 0)
    x32 = torch.randn(n, generator=g, device="cuda", dtype=torch.float32)
    case("scan cumsum 1-D n=2^28 float32", x32, "cumsum", 0)
    del x32
    X = torch.randn(16384, 16384, generator=g, device="cuda",
                    dtype=torch.float32)
    for axis in (0, 1):
        case(f"scan cumsum 16384^2 float32 axis {axis}", X, "cumsum", axis)
    del X
    for dt in (torch.float32, torch.float64):
        s = torch.randn(2, (2 * sc.K + 3) * sc.TILE + 11, generator=g,
                        device="cuda", dtype=dt)
        case(f"scan cumsum (2, (2K+3)*TILE+11) {dt} axis 1 (checkpoints "
             f"crossed)", s, "cumsum", 1)
    for dt in (torch.float16, torch.bfloat16, torch.float32, torch.float64):
        s = 1 + 0.01 * torch.randn(3, 2 * sc.TILE + 37, generator=g,
                                   device="cuda", dtype=torch.float64)
        s = s.to(dt)
        for name in ("cumsum", "cumprod"):
            for axis in (0, 1):
                case(f"scan {name} (3, 2*TILE+37) {dt} axis {axis}", s, name,
                     axis)
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: sc.launch(x64, "cumsum", 0), 10)
    plain_ms = cuda_ms(lambda: sc.scan_reference(x64, "cumsum", 0), 2)
    lib_ms = cuda_ms(lambda: torch.cumsum(x64, 0), 10)
    bound_ms = 1e3 * 2 * n * 8 / HBM_BYTES_PER_S
    moved = 2 * n * 8 + sc.tiles(n) * 8 + sc.status_bytes(sc.tiles(n))
    log(f"  scan cumsum n=2^28 float64: kernel {ms:.4f} ms ({bound_ms / ms:.1%} "
        f"of its bound), plain {plain_ms:.4f} ms, torch.cumsum {lib_ms:.4f} ms "
        f"(not reproducible), bound {bound_ms:.4f} ms ({2 * n * 8 / 1e9:.3f} GB "
        f"at 3.35 TB/s), {moved / 1e9:.6f} GB moved by its one pass (the "
        f"data read once, the result written once, a value and a flag per "
        f"tile), K={sc.K} [{card}]")
    del x64
    torch.cuda.empty_cache()
    return {"name": "scan", "route": "cuda",
            "source": "ramba_tpu_torch/csrc/scan.cuh",
            "replaces": "none: a port-only repair kernel (ramba_tpu's cumsum "
                        "is XLA's deterministic scan, ramba_tpu/core/expr.py:357"
                        ", no pallas_call)",
            "launches": 0, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": lib_ms, "shape": "cumsum n=2^28 float64",
            "moved_bytes": moved}


def phase_kernels(rt, er, sk, sg, jacobi, torch, np, card, sc):
    """Each kernel against its plain version on the card; timings."""
    log("phase 2: kernels against their plain versions")
    elemred_small_err = elemred_checks(rt, er, torch, np)
    segred_small_err = segred_checks(rt, sg, torch, np)
    repair_checks(rt, er, sk, torch, np)

    slots1 = (("arr", 0),)
    slots2 = (("arr", 0), ("arr", 1))
    g = torch.Generator(device="cuda")
    g.manual_seed(1)

    def rand(*shape, dtype=torch.float32):
        return torch.rand(shape, generator=g, device="cuda", dtype=dtype)

    def stencil_case(name, func, slots, arrs, rtol, reason, atol=0.0):
        """The kernel against its plain version within the tolerance; then
        whether its bytes equal the plain version's (printed)."""
        l, h = sk.trace(func, slots)[:2]
        if not sk.available(func, l, h, slots, arrs):
            raise Fail(f"{name}: the stencil kernel does not take it")
        before = stencil_paths(sk)
        got = sk.launch(func, l, h, slots, arrs, torch.empty_like(arrs[0]))
        path = path_taken(sk, before)
        want = sk.stencil_reference(func, l, h, slots, arrs)
        torch.cuda.synchronize()
        err = check_close(f"{name} ({path})", got, want, rtol, reason, atol)
        log(f"  {name} ({path}): byte-equal to the plain version: "
            f"{bytes_equal(got, want)}")
        return err

    f32 = "float32 per-op IEEE in both, same order"
    f64 = "float64 per-op IEEE in both"
    bf16 = "bf16: both round every op to bf16"
    paths0 = stencil_paths(sk)
    x8 = rand(8192, 8192)
    st_err = stencil_case("stencil star2 8192^2 f32", star2_body, slots1, [x8],
                          1e-6, f32)
    x30 = rand(30000, 30000)
    stencil_case("stencil star2 30000^2 f32", star2_body, slots1, [x30], 1e-6, f32)
    del x30
    torch.cuda.empty_cache()
    xo = rand(4099, 4133)
    stencil_case("stencil star2 4099x4133 f32", star2_body, slots1, [xo], 1e-6, f32)
    flat = rand(4096 * 4096 + 1)
    stencil_case("stencil star2 4096^2 f32 view at a 4-byte offset", star2_body,
                 slots1, [flat[1:].view(4096, 4096)], 1e-6, f32)
    del flat
    stencil_case("stencil star2 4099x4133 bf16", star2_body, slots1,
                 [xo.to(torch.bfloat16)], 0.0, bf16)
    K = jacobi._kernels()
    u = rand(4096, 4096, dtype=torch.float64)
    f = rand(4096, 4096, dtype=torch.float64)
    stencil_case("stencil jacobi sweep 4096^2 f64 (2 slots)", K["sweep"].func,
                 slots2, [u, f], 1e-12, f64)
    stencil_case("stencil jacobi lap 4096^2 f64", K["lap"].func, slots1, [u],
                 1e-12, f64)
    xb = x8.to(torch.bfloat16)
    stencil_case("stencil star2 8192^2 bf16", star2_body, slots1, [xb], 0.0, bf16)
    used = {p: n - paths0[p] for p, n in stencil_paths(sk).items()}
    log(f"  stencil launches by load path in these checks: {used}")
    if not all(used.values()):
        raise Fail("a stencil load path went unexercised")

    # -- timings: every shape the main path launches the kernel at, the
    # bf16 check's shape and the odd shape (_run_padded's on the TPU) -----
    def conv_weights(dtype, taps):
        w = torch.zeros(1, 1, 5, 5, dtype=dtype, device="cuda")
        for (di, dj), c in taps.items():
            w[0, 0, 2 + di, 2 + dj] = c
        return w

    star2_w = {(0, 1): .25, (0, -1): .25, (1, 0): .25, (-1, 0): .25,
               (0, 2): .125, (0, -2): .125, (2, 0): .125, (-2, 0): .125}
    lap_w = {(-1, 0): 1.0, (1, 0): 1.0, (0, -1): 1.0, (0, 1): 1.0, (0, 0): -4.0}

    def conv(x, taps):
        w = conv_weights(x.dtype, taps)
        x4 = x.view(1, 1, *x.shape)
        return lambda: torch.nn.functional.conv2d(x4, w)

    def time_stencil(what, func, slots, arrs, lib=None, lib_note=""):
        tr = sk.trace(func, slots)
        out = torch.empty_like(arrs[0])
        before = stencil_paths(sk)
        sk.launch(func, tr.lo, tr.hi, slots, arrs, out)
        path = path_taken(sk, before)
        ms = cuda_ms(lambda: sk.launch(func, tr.lo, tr.hi, slots, arrs, out), 20)
        plain_ms = cuda_ms(
            lambda: sk.stencil_reference(func, tr.lo, tr.hi, slots, arrs), 3)
        lib_ms = None
        if lib is not None:
            prev = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False  # full float32, like the kernel
            try:
                lib_ms = cuda_ms(lib, 20)
            finally:
                torch.backends.cudnn.allow_tf32 = prev
        # the host's share: 100 launches enqueued without a synchronise
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            sk.launch(func, tr.lo, tr.hi, slots, arrs, out)
        host_ms = (time.perf_counter() - t0) * 1e3 / 100
        torch.cuda.synchronize()
        H, W = arrs[0].shape
        nbytes = (len(arrs) + 1) * H * W * arrs[0].element_size()
        n_ops = sum(1 for _ in _op_nodes(tr.expr))
        inner = (H - (tr.hi[0] - tr.lo[0])) * (W - (tr.hi[1] - tr.lo[1]))
        dname = str(arrs[0].dtype).split(".")[1]
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = n_ops * max(inner, 0) / PEAK_OPS[dname]
        bound_ms = 1e3 * max(t_bytes, t_ops)
        occ = sk.ctas_per_sm(func, tr.lo, tr.hi, slots, arrs, path)
        lib_txt = f"{lib_note} {lib_ms:.4f} ms" if lib_ms is not None else \
            "no single library call"
        log(f"  stencil {what}: {path} path, {occ} CTAs/SM, kernel {ms:.4f} ms "
            f"({bound_ms / ms:.1%} of its bound), plain {plain_ms:.4f} ms, "
            f"{lib_txt}, bound {bound_ms:.4f} ms ({nbytes / 1e9:.3f} GB at "
            f"3.35 TB/s), host {host_ms:.4f} ms per launch enqueued [{card}]")
        return {"shape": what, "path": path, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": lib_ms, "host_ms": host_ms}

    conv_f32 = "conv2d (TF32 off)"
    times = [
        time_stencil("star2 8192x8192 float32", star2_body, slots1, [x8],
                     conv(x8, star2_w), conv_f32),
        time_stencil("jacobi sweep 4096x4096 float64, 2 slots", K["sweep"].func,
                     slots2, [u, f]),
        time_stencil("jacobi lap 4096x4096 float64", K["lap"].func, slots1, [u],
                     conv(u, lap_w), "conv2d"),
        time_stencil("star2 8192x8192 bfloat16", star2_body, slots1, [xb],
                     conv(xb, star2_w), "conv2d (bf16 in, float accumulation)"),
        time_stencil("star2 4099x4133 float32", star2_body, slots1, [xo],
                     conv(xo, star2_w), conv_f32),
    ]
    del x8, xb, xo, u, f
    torch.cuda.empty_cache()
    t = times[0]
    stencil_row = {
        "name": "stencil", "route": "cuda",
        "source": "ramba_tpu_torch/csrc/stencil_tile.cuh",
        "replaces": "ramba_tpu/ops/stencil_pallas.py:261",
        "also_replaces": "ramba_tpu/ops/stencil_pallas.py:370",
        "launches": 0, "max_abs_err": st_err,
        **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "path", "shape")},
        "shapes": times[1:],
    }

    elemred_row = time_elemred(rt, er, torch, np, card)
    elemred_row["max_abs_err"] = max(elemred_row["max_abs_err"], elemred_small_err)

    x, hour = hourly_series(torch, np, 1 << 28)
    t, _got = time_segred(sg, torch, rt.fromarray(x).groupby(0, hour, 24), "sum",
                          "segred hourly sum n=2^28 f64 G=24", card)
    del x, _got
    torch.cuda.empty_cache()
    segred_row = {
        "name": "segred", "route": "cuda",
        "source": "ramba_tpu_torch/csrc/segred.cuh",
        "replaces": "ramba_tpu/ops/pallas_backend.py:532",
        "launches": 0, **t,
        "max_abs_err": max(t["max_abs_err"], segred_small_err),
        "shape": "hourly sum n=2^28 float64, 24 groups, int32 labels",
    }
    scan_row = scan_checks(sc, torch, card)
    return elemred_row, stencil_row, segred_row, scan_row


def time_elemred_case(er, torch, what, p, lv, nbytes, card):
    """One elemred program on the card: the kernel against the plain version
    (elementwise and its sum, within the depth bound of this launch's
    grid), then kernel and plain times (CUDA events) beside the byte
    bound.  Returns the row's numbers."""
    n = er.kb.vector_length(lv)
    plan = er.plan_for(p, lv)
    dname = str(lv[plan.vec_leaves[0]].dtype).split(".")[1]
    path, grid, ept = er.geometry(p, lv)
    got = er.launch(p, lv)
    want = er.elemred_reference(p, lv)
    torch.cuda.synchronize()
    rtol = 1e-12 if dname == "float64" else 1e-6
    err = check_close(f"{what} (D)", got[0], want[0], rtol,
                      f"{dname} elementwise", atol=rtol)
    check_sums(f"{what} (sum)", got[1], want[1],
               sum_bound(er.depth(n, grid, ept), dname,
                         float(got[0].abs().sum(dtype=torch.float64))),
               "2*depth*eps*sum|x|, another order")
    del want
    again = er.launch(p, lv)
    torch.cuda.synchronize()
    if not all(bytes_equal(a, b) for a, b in zip(got, again)):
        raise Fail(f"{what}: rerun not byte-equal")
    del got, again
    ms = cuda_ms(lambda: er.launch(p, lv), 5)
    plain_ms = cuda_ms(lambda: er.elemred_reference(p, lv), 2)
    bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    log(f"  {what}: {path} path, grid {grid}, kernel {ms:.4f} ms "
        f"({bound_ms / ms:.1%} of its bound), plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({nbytes / 1e9:.3f} GB at 3.35 TB/s), rerun "
        f"byte-equal [{card}]")
    return {"shape": what, "path": path, "grid": grid, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None}


def time_elemred(rt, er, torch, np, card):
    """elemred on the program the main path launches (mat_chain: B =
    sin(base), C = cos(base), D = B*B + C*C, sum(D) at n = 1e9 float64),
    with its SASS counts, registers, occupancy and host time per launch;
    the program that spells each transcendental twice; axpy + sum at
    n = 2^28 float64; the chain at n = 1e9 float32."""
    n = 10 ** 9
    base = rt.arange(n) / 1000.0
    rt.sync()  # a materialised base: the program's one vector leaf
    p, lv = trig_program(rt, base)
    p4, lv4 = trig_program(rt, base, True)
    del base
    n_trig = sum(1 for op, st, _a in p.instrs
                 if op == "map" and st[0] in ("sin", "cos"))
    if n_trig != 2:
        raise Fail(f"the main path's chain has {n_trig} transcendentals, expected 2")
    plan, plan4 = er.plan_for(p, lv), er.plan_for(p4, lv4)
    row = time_elemred_case(er, torch, "elemred sin/cos chain n=1e9 f64", p, lv,
                            2 * n * 8, card)
    sass, sass4 = elemred_sass(er, plan), elemred_sass(er, plan4)
    res = elemred_resources(er, plan)
    occ = er.ctas_per_sm(plan, row["path"], lv[0].device)

    def busy():  # about 0.1 s of launches; each result is dropped at once
        for _ in range(20):
            er.launch(p, lv)

    clk, clk_max = sm_clock_mhz(busy)
    fp64_rate = 132 * 64 * clk * 1e6  # FP64-pipe instructions per second
    t_bytes = 2 * n * 8 / HBM_BYTES_PER_S
    t_ops = n * sass["fp64_per_elem"] / fp64_rate
    t_issue = n * sass["all_per_elem"] / (132 * 4 * 32 * clk * 1e6)
    row.update(bound_ms=1e3 * max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    ms4 = cuda_ms(lambda: er.launch(p4, lv4), 5)
    del p4, lv4
    # the host's share: 100 launches at n = 2^16 enqueued without a synchronise
    small = rt.arange(1 << 16) / 1000.0
    rt.sync()
    ps, lvs = trig_program(rt, small)
    er.launch(ps, lvs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        er.launch(ps, lvs)
    host_ms = (time.perf_counter() - t0) * 1e3 / 100
    torch.cuda.synchronize()
    log(f"  elemred main path's program: {res['registers']} registers, stack "
        f"{res['stack']} B, local {res['local']} B per thread, {sass['ldl']} LDL "
        f"and {sass['stl']} STL (spills), {occ} CTAs/SM on the {row['path']} "
        f"path ({er.NT} threads, {plan.ept} elements per thread per tile, "
        f"{plan.config.stages} stages, {plan.smem} B of shared memory)")
    log(f"  elemred SASS: {sass['fp64_per_elem']:.2f} FP64-pipe and "
        f"{sass['all_per_elem']:.2f} instructions per element in the tile loop "
        f"({sass['kernel_fp64_per_elem']:.2f} and {sass['kernel_all_per_elem']:.2f} "
        f"over the whole kernel), {sass['calls']} CALLs to the trig slow path "
        f"(|x| >= 2^31, not taken here; {sass['slow_path_all']} instructions, "
        f"{sass['slow_path_fp64']} FP64); SM clock {clk:.0f} MHz under load "
        f"(max {clk_max:.0f})")
    log(f"  elemred sin/cos chain n=1e9 f64, 2 transcendentals: kernel "
        f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}; bytes {1e3 * t_bytes:.4f} "
        f"ms, FP64 pipe {1e3 * t_ops:.4f} ms at 132 SMs x 64 x {clk:.0f} MHz, "
        f"all-instruction issue {1e3 * t_issue:.4f} ms at 4 warps x 32 lanes per "
        f"SM per clock), {row['bound_ms'] / row['ms']:.1%} of the bound; host "
        f"{host_ms:.4f} ms per launch enqueued [{card}]")
    merged = (sass4["all_per_elem"] == sass["all_per_elem"]
              and sass4["fp64_per_elem"] == sass["fp64_per_elem"])
    log(f"  elemred sin/cos chain n=1e9 f64, each transcendental spelled twice "
        f"(4 per element; not the main path's program): kernel {ms4:.4f} ms, "
        f"{sass4['fp64_per_elem']:.2f} FP64-pipe and {sass4['all_per_elem']:.2f} "
        f"instructions per element: "
        + ("the same as the main path's program: the compiler merged the "
           "repeated calls" if merged else "more than the main path's program: "
           "the repeated calls are computed") + f" [{card}]")
    torch.cuda.empty_cache()

    m = 1 << 28
    x = rt.sin(rt.arange(m) * 1e-3)
    y = rt.cos(rt.arange(m) * 1e-3)
    rt.sync()
    pa, lva = axpy_program(rt, x, y)
    del x, y
    axpy = time_elemred_case(er, torch, "elemred axpy+sum n=2^28 f64", pa, lva,
                             3 * m * 8, card)
    del pa, lva
    torch.cuda.empty_cache()
    b32 = rt.fromarray(torch.arange(n, device="cuda", dtype=torch.float32) / 1000.0)
    pf, lvf = trig_program(rt, b32)
    del b32
    f32 = time_elemred_case(er, torch, "elemred sin/cos chain n=1e9 f32", pf, lvf,
                            2 * n * 4, card)
    del pf, lvf
    torch.cuda.empty_cache()
    return {"name": "elemred", "route": "cuda",
            "source": "ramba_tpu_torch/csrc/elemred.cuh",
            "replaces": "ramba_tpu/ops/pallas_backend.py:447",
            "launches": 0, **row,
            "shape": "sin/cos chain + sum, n=1e9 float64, 2 transcendentals (mat_chain)",
            "fp64_per_elem": sass["fp64_per_elem"],
            "all_per_elem": sass["all_per_elem"], "sm_clock_mhz": clk,
            "registers": res["registers"], "local_bytes": res["local"],
            "spill_ldl_stl": sass["ldl"] + sass["stl"], "ctas_per_sm": occ,
            "host_ms": host_ms, "four_transcendentals_ms": ms4,
            "shapes": [axpy, f32]}


def launch_window(er, sk, sg, sc, totals, card):
    """``window(name, fn, need)``: every kernel's launch count set to 0
    just before ``fn`` runs and read just after, added to ``totals``; a
    kernel named in ``need`` that was not launched (``need[k]`` times, or
    at least once for None) fails the run."""

    def window(name, fn, need):
        er.launches = er.launches_bulk = er.launches_plain = 0
        sk.launches = sk.launches_tma = sk.launches_cpasync = 0
        sk.launches_ldst = 0
        sg.launches = 0
        sc.launches = 0
        res = fn()
        got = {"elemred": er.launches, "stencil": sk.launches,
               "segred": sg.launches, "scan": sc.launches}
        if sk.launches:
            log(f"  {name}: stencil launches by load path {stencil_paths(sk)}")
        if er.launches:
            log(f"  {name}: elemred launches by load path {elemred_paths(er)}")
        for k in totals:
            totals[k] += got[k]
        for k, want in need.items():
            ok = got[k] == want if isinstance(want, int) else got[k] > 0
            if not ok:
                raise Fail(f"{name}: {k} launches {got[k]}, expected "
                           f"{'> 0' if want is None else want}")
        log(f"  {name}: launches {got} [{card}]")
        return res

    return window


def phase_main_path(rt, er, sk, sg, jacobi, torch, np, card, sc):
    """The main path through the user API, launch counts around each."""
    log("phase 3: main path through `import ramba_tpu_torch as rt`")
    t_main = time.perf_counter()
    totals = {"elemred": 0, "stencil": 0, "segred": 0, "scan": 0}
    window = launch_window(er, sk, sg, sc, totals, card)

    # headline chain (bench.py's _bench_chain)
    n = 10 ** 9

    def chain():
        t0 = time.perf_counter()
        A = rt.arange(n) / 1000.0
        B = rt.sin(A)
        C = rt.cos(A)
        D = B * B + C ** 2
        del A, B, C
        s = rt.sum(D)
        f0 = rt.fuser_stats["flushes"]
        sv = float(s)
        wall = time.perf_counter() - t0
        if rt.fuser_stats["flushes"] - f0 != 1:
            raise Fail("headline chain did not run as exactly one flush")
        slack = n * EPS["float64"] * n
        if not abs(sv - n) <= slack or D.dtype != np.float64:
            raise Fail(f"headline chain checksum {sv!r} (want {n} within {slack})")
        del D
        return wall, sv

    cold, _ = window("headline chain n=1e9 (cold)", chain, {})
    wall, sv = min(window("headline chain n=1e9", chain, {}) for _ in range(2))
    log(f"  headline chain n=1e9 f64: cold {cold:.4f} s, best {wall:.4f} s, "
        f"checksum {sv!r}, one flush [{card}]")

    base = rt.arange(n) / 1000.0
    rt.sync()

    def mat_chain():
        t0 = time.perf_counter()
        B = rt.sin(base)
        C = rt.cos(base)
        D = B * B + C * C
        del B, C
        sv = float(rt.sum(D))
        wall = time.perf_counter() - t0
        if not abs(sv - n) <= n * EPS["float64"] * n:
            raise Fail(f"materialised chain checksum {sv!r}")
        return wall

    walls = [window("sin/cos chain over base n=1e9", mat_chain, {"elemred": 1})
             for _ in range(3)]
    w = min(walls[1:])
    log(f"  sin/cos chain over base n=1e9 f64: {w:.4f} s, "
        f"{2 * n * 8 / w / 1e9:.1f} GB/s (read base + write D) [{card}]")
    del base
    torch.cuda.empty_cache()

    m = 1 << 28
    x = rt.sin(rt.arange(m) * 1e-3)
    y = rt.cos(rt.arange(m) * 1e-3)
    rt.sync()
    xt, yt = x._value(), y._value()

    def axpy():
        t0 = time.perf_counter()
        z = 2.5 * x + y
        sv = float(rt.sum(z))
        wall = time.perf_counter() - t0
        ref = float((2.5 * xt + yt).sum())
        if not abs(sv - ref) <= m * EPS["float64"] * float((2.5 * xt + yt).abs().sum()):
            raise Fail(f"axpy sum {sv!r} vs {ref!r}")
        return wall

    walls = [window("axpy + sum n=2^28", axpy, {"elemred": 1}) for _ in range(3)]
    w = min(walls[1:])
    log(f"  axpy + sum n=2^28 f64: {w:.4f} s, {3 * m * 8 / w / 1e9:.1f} GB/s "
        f"(read x, y; write z) [{card}]")
    del x, y, xt, yt

    star2 = rt.stencil(star2_body)
    sn = 8192
    xs = rt.fromarray(np.random.RandomState(0).rand(sn, sn).astype(np.float32))
    rt.sync()

    def stencils():
        # graph building counts: it is host time every sweep pays
        t0 = time.perf_counter()
        y = xs
        for _ in range(30):
            y = rt.sstencil(star2, y)
        s_chain = float(rt.sum(y))
        t_chain = (time.perf_counter() - t0) / 30
        t0 = time.perf_counter()
        s_iter = float(rt.sum(rt.sstencil_iterate(star2, xs, 100)))
        t_iter = (time.perf_counter() - t0) / 100
        return y._value(), s_chain, t_chain, s_iter, t_iter

    y30, s_chain, t_chain, s_iter, t_iter = window(
        "star2 30 sstencil + 100 sstencil_iterate at 8192^2", stencils,
        {"stencil": 130})
    # the same 30 sweeps through the plain version
    ref = xs._value()
    lo, hi, _t = star2.neighborhood((("arr", 0),))
    for _ in range(30):
        ref = sk.stencil_reference(star2_body, lo, hi, (("arr", 0),), [ref])
    check_close("star2 30 chained sweeps vs 30 plain sweeps", y30, ref, 1e-6,
                "float32 per-op IEEE in both, same order")
    del ref, y30
    mf = lambda t: 13 * (sn - 4) * (sn - 4) / t / 1e6  # noqa: E731  PRK convention
    log(f"  star2 8192^2 f32: chained {mf(t_chain):.0f} MFlops/s "
        f"({t_chain * 1e3:.4f} ms/sweep), iterate {mf(t_iter):.0f} MFlops/s "
        f"({t_iter * 1e3:.4f} ms/sweep), sums {s_chain!r} {s_iter!r} [{card}]")
    del xs

    fj = np.random.RandomState(2).rand(4096, 4096)  # f64, as zeros() is
    fd = rt.fromarray(fj)  # uploaded before the timer: the sweeps are timed
    rt.sync()

    def jac():
        r0 = jacobi.residual(rt.zeros(fj.shape), fd)
        t0 = time.perf_counter()
        u = jacobi.jacobi2d(fd, 100)
        rt.sync()
        wall = time.perf_counter() - t0
        r = jacobi.residual(u, fd)
        if not (np.isfinite(r) and r < r0):
            raise Fail(f"jacobi residual {r!r} did not fall below {r0!r}")
        return wall, r0, r

    # 100 sweeps + one lap in each residual
    wall, r0, r = window("jacobi2d 4096^2 x 100", jac, {"stencil": 102})
    log(f"  jacobi2d 4096^2 f64 x100: {wall:.4f} s ({wall * 10:.4f} ms/sweep, "
        f"f already on the card), residual {r0!r} -> {r!r} [{card}]")
    del fd
    torch.cuda.empty_cache()
    walls = {"main": time.perf_counter() - t_main}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        walls[name] = time.perf_counter() - t0
        return out

    timed("groupby_path", groupby_path, rt, sg, torch, np, card, window)
    timed("skeletons_path", skeletons_path, rt, er, torch, np, card, window)
    timed("indexing_path", indexing_path, rt, sc, torch, np, card, window)
    timed("breadth_path", breadth_path, rt, er, sg, sc, torch, np, card,
          window)
    timed("io_path", io_path, rt, sk, torch, np, card, window)
    sharded = timed("mesh_path", mesh_path, rt, sk, sc, torch, np, card,
                    window)
    log("  dist_path: the main path across processes")
    dist = timed("dist_path", dist_path, rt, er, sk, sc, torch, np, card,
                 totals)
    log("  layout_path: layouts chosen and changed across ranks")
    dist["layout"] = timed("layout_path", layout_path, rt, torch, np, card,
                           totals)
    log("  compile_path: segments, compile classes, the kernel cache and the "
        "backend race")
    e0, g0 = totals["elemred"], totals["segred"]
    timed("compile_path", compile_path, rt, er, sg, torch, np, card, window,
          totals)
    if totals["elemred"] == e0 or totals["segred"] == g0:
        raise Fail("compile_path launched no elemred or no segred")
    log("  analyze_path: the verifier, the result memo and plan certificates")
    before = dict(totals)
    timed("analyze_path", analyze_path, rt, er, sk, sg, sc, torch, np, card,
          window)
    for k in ("elemred", "stencil", "segred"):
        if totals[k] == before[k]:
            raise Fail(f"analyze_path launched no {k}")
    log("  ladder_path: the degradation ladder, admission, retries and the "
        "shadow audit")
    before = dict(totals)
    timed("ladder_path", ladder_path, rt, er, sk, sg, sc, torch, np, card,
          window, totals,
          dist.get("ms_per_sweep_slowest_rank", {}).get("star2_even"))
    for k in totals:
        if totals[k] == before[k]:
            raise Fail(f"ladder_path launched no {k}")
    log("  elastic_path: the watchdog, the heartbeat, the checkpoint "
        "manager, resume into other worlds and live reshape")
    before = dict(totals)
    timed("elastic_path", elastic_path, rt, er, sk, sg, sc, torch, np, card,
          window, totals)
    for k in totals:
        if totals[k] == before[k]:
            raise Fail(f"elastic_path launched no {k}")
    log("  observe_path: attribution with CUDA-event fences, rooflines, the "
        "drift sentinel, SLOs, telemetry, the profiler and diagnostics")
    before = dict(totals)
    timed("observe_path", observe_path, rt, er, sk, sg, sc, torch, np, card,
          window, totals)
    for k in totals:
        if totals[k] == before[k]:
            raise Fail(f"observe_path launched no {k}")
    log(f"  phase 3 walls by path (s): {json.dumps(walls)} [{card}]")
    return totals, sharded, dist


def io_path(rt, sk, torch, np, card, window):
    """Seeded draws, a Monte-Carlo estimate on elemred, file I/O and a
    checkpointed stencil solver at full size: ``rt.random``,
    ``rt.save``/``rt.load`` and ``checkpoint`` with the resilience plane
    under them.  Files live in a temporary directory removed at the end,
    each big one deleted after its check."""
    import shutil
    import tempfile

    from ramba_tpu_torch.resilience import faults

    log("io_path: seeded draws, Monte-Carlo pi, file I/O, a checkpointed "
        "star2 solver")
    root = tempfile.mkdtemp(prefix="ramba_io_")
    try:
        io_draws(rt, torch, card, window)
        io_monte_carlo(rt, torch, card, window)
        io_files(rt, torch, card, window, root)
        io_solver(rt, sk, torch, np, card, window, root)
    finally:
        faults.configure(None)
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()


def _synced(make):
    """(tensor of ``make()``, host seconds until the card finished it)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v = make()._value()
    torch.cuda.synchronize()
    return v, time.perf_counter() - t0


def _moments_ok(what, v, mean, var, mu4):
    """The sample mean and variance of ``v`` within 6 standard errors of
    the distribution's (``mu4``: its fourth central moment)."""
    n = v.numel()
    d = v.double()
    m = d.mean().item()
    s2 = ((d - m) ** 2).mean().item()
    del d
    se_m, se_v = (var / n) ** 0.5, ((mu4 - var * var) / n) ** 0.5
    ok = abs(m - mean) <= 6 * se_m and abs(s2 - var) <= 6 * se_v
    log(f"  {what}: mean {m!r} (want {mean!r} within 6 SE = {6 * se_m:.3e}), "
        f"variance {s2!r} (want {var!r} within 6 SE = {6 * se_v:.3e}) "
        f"{'ok' if ok else 'MISS'}")
    if not ok:
        raise Fail(f"{what}: moments off")


def io_draws(rt, torch, card, window):
    """random, normal, randint and exponential of 2^28 (float64 where
    float) and permutation(2^26), checked and timed; a reseed reproduces
    every draw byte for byte; re-running one draw's program gives the same
    bytes; ten seeds of one shape add no compile."""
    from ramba_tpu_torch.core import fuser

    n, k = IO_N, 1000
    draws = [
        ("random", lambda: rt.random.random(n), (0.5, 1 / 12, 1 / 80)),
        ("normal", lambda: rt.random.normal(size=n), (0.0, 1.0, 3.0)),
        (f"randint(0, {k})", lambda: rt.random.randint(0, k, size=n),
         ((k - 1) / 2, (k * k - 1) / 12, (k * k - 1) * (3 * k * k - 7) / 240)),
        ("exponential", lambda: rt.random.exponential(size=n),
         (1.0, 1.0, 9.0)),
        ("permutation(2^26)", lambda: rt.random.permutation(IO_PERM_N), None),
    ]

    def run():
        rt.random.seed(1234)
        first = []
        for name, make, mom in draws:
            v, wall = _synced(make)
            first.append((v, wall))
            if mom is not None:
                _moments_ok(f"{name} n=2^28 {v.dtype}", v, *mom)
            else:
                ok = v.dtype == torch.int64 and torch.equal(
                    torch.sort(v).values,
                    torch.arange(v.numel(), device=v.device))
                log(f"  {name}: int64, sorted it is arange(2^26) "
                    f"{'ok' if ok else 'MISS'}")
                if not ok:
                    raise Fail("permutation is not a permutation")
        lo, hi = int(first[2][0].min()), int(first[2][0].max())
        if (lo, hi) != (0, k - 1):
            raise Fail(f"randint(0, {k}) support [{lo}, {hi}]")
        log(f"  randint(0, {k}) support [{lo}, {hi}] ok")
        rt.random.seed(1234)
        for (name, make, _m), (v0, cold) in zip(draws, first):
            v, wall = _synced(make)
            same = bytes_equal(v, v0)
            log(f"  {name}: reseeded draw byte-equal {'ok' if same else 'MISS'};"
                f" {wall * 1e3:.4f} ms ({v.numel() * v.element_size() / wall / 1e9:.1f}"
                f" GB/s written; first draw {cold * 1e3:.4f} ms) [{card}]")
            if not same:
                raise Fail(f"{name}: a reseed did not reproduce the draw")
        del first, v, v0
        x = rt.random.normal(size=n)
        expr = x.read_expr()
        v1 = fuser.evaluate(expr)
        v2 = fuser.evaluate(expr)
        same = bytes_equal(v1, v2)
        log(f"  normal n=2^28: its program run twice gives the same bytes "
            f"{'ok' if same else 'MISS'}")
        if not same:
            raise Fail("a draw's program gave other bytes on a rerun")
        del x, expr, v1, v2
        c0 = rt.fuser_stats["compiles"]
        for s in range(10):
            rt.random.seed(100 + s)
            rt.random.random(n)._value()
        added = rt.fuser_stats["compiles"] - c0
        log(f"  ten seeds of random(2^28): {added} compiles added "
            f"{'ok' if added == 0 else 'MISS'}")
        if added:
            raise Fail("a new seed compiled a new program")
        torch.cuda.empty_cache()

    window("io_path draws", run, {})


def io_monte_carlo(rt, torch, card, window):
    """pi from 2^28 seeded points: hits counted on elemred (an int64 sum of
    a bool compare), equal to the plain count on the same draws, within 6
    sigma of pi."""
    import math

    n = IO_N
    rt.random.seed(2718)
    x, y = rt.random.random(n), rt.random.random(n)
    rt.sync()
    xt, yt = x._value(), y._value()

    def estimate():
        t0 = time.perf_counter()
        hits = int(mc_hits(rt, x, y))
        return hits, time.perf_counter() - t0

    window("Monte-Carlo pi n=2^28 (cold)", estimate, {"elemred": 1})
    hits, wall = window("Monte-Carlo pi n=2^28", estimate, {"elemred": 1})
    plain = int(((xt * xt + yt * yt) <= 1.0).sum())
    est = 4.0 * hits / n
    p = math.pi / 4
    six_sigma = 6 * 4 * math.sqrt(p * (1 - p) / n)
    ok = hits == plain and abs(est - math.pi) <= six_sigma
    log(f"  Monte-Carlo pi n=2^28 f64: {est!r}, |pi - est| = "
        f"{abs(est - math.pi):.3e} (within 6 sigma = {six_sigma:.3e}); hits "
        f"{hits} equal to the plain count {plain} (exact: an integer sum); "
        f"{wall * 1e3:.4f} ms, {2 * n * 8 / wall / 1e9:.1f} GB/s read "
        f"{'ok' if ok else 'MISS'} [{card}]")
    if not ok:
        raise Fail("Monte-Carlo pi disagrees")
    del x, y, xt, yt


def io_files(rt, torch, card, window, root):
    """2^28 float64 (2 GiB) saved to .npy and .rtd and loaded back byte for
    byte, the host window at or under the chunk bound; an injected
    ``fileio:once`` is retried.  Cut to what the disk holds, and said."""
    import os
    import shutil

    from ramba_tpu_torch import fileio
    from ramba_tpu_torch.core import staging
    from ramba_tpu_torch.observe import registry
    from ramba_tpu_torch.resilience import faults

    n = IO_N
    free = shutil.disk_usage(root).free
    while n > 1 << 20 and 2 * n * 8 > free:
        n //= 2
    if n < IO_N:
        log(f"  io_path: the disk has {free} bytes free, the I/O size is cut "
            f"to {n} float64 values")
    nbytes = n * 8

    def run():
        rt.random.seed(99)
        v = rt.random.random(n)
        vt = v._value()
        for ext in ("npy", "rtd"):
            path = os.path.join(root, f"big.{ext}")
            fileio.io_stats.update(chunks=0, max_chunk_bytes=0,
                                   whole_array_reads=0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rt.save(path, v)
            t_save = time.perf_counter() - t0
            b, t_load = _synced(lambda: rt.load(path))
            st = dict(fileio.io_stats)
            ok = (bytes_equal(b, vt) and st["whole_array_reads"] == 0
                  and 0 < st["max_chunk_bytes"] <= staging.CHUNK_BYTES)
            log(f"  .{ext} {nbytes} bytes f64: save {t_save:.4f} s "
                f"({nbytes / t_save / 1e9:.2f} GB/s), load {t_load:.4f} s "
                f"({nbytes / t_load / 1e9:.2f} GB/s), byte-equal, {st['chunks']} "
                f"chunks, largest {st['max_chunk_bytes']} <= bound "
                f"{staging.CHUNK_BYTES} {'ok' if ok else 'MISS'} [{card}]")
            if not ok:
                raise Fail(f".{ext} round trip")
            del b
            if ext == "npy":
                r0 = registry.get("resilience.retries.fileio")
                faults.configure("fileio:once")
                try:
                    b = rt.load(path)._value()
                finally:
                    faults.configure(None)
                retried = registry.get("resilience.retries.fileio") - r0
                ok = retried == 1 and bytes_equal(b, vt)
                log(f"  .npy load under fileio:once: {retried} retry, "
                    f"byte-equal {'ok' if ok else 'MISS'}")
                if not ok:
                    raise Fail("fileio:once was not retried")
                del b
            if os.path.isdir(path):
                shutil.rmtree(path)
            else:
                os.remove(path)
        torch.cuda.empty_cache()

    window("io_path files", run, {})


def io_solver(rt, sk, torch, np, card, window, root):
    """An 8192^2 float32 grid from ``rt.random``, saved to .npy and loaded
    back; 100 star2 sweeps (``sstencil_iterate``, the stencil kernel's TMA
    path), a checkpoint, a restore into fresh state and 100 more sweeps,
    byte-equal to 200 sweeps straight; the digest sidecar verifies on
    restore; ``checkpoint_io:once`` is retried; a ``checkpoint:leaf`` flip
    makes restore raise."""
    import os

    from ramba_tpu_torch import checkpoint
    from ramba_tpu_torch.observe import registry
    from ramba_tpu_torch.resilience import faults, integrity

    sn = IO_GRID
    star2 = rt.stencil(star2_body)
    rt.random.seed(31)
    g = rt.random.random((sn, sn)).astype(np.float32)
    gpath = os.path.join(root, "grid.npy")
    rt.save(gpath, g)
    g2 = rt.load(gpath)
    os.remove(gpath)
    if not bytes_equal(g2._value(), g._value()):
        raise Fail("the grid's .npy round trip")
    del g
    ck = os.path.join(root, "ck")
    nbytes = sn * sn * 4 + 8

    def solve():
        t0 = time.perf_counter()
        y100 = rt.sstencil_iterate(star2, g2, 100)
        y100._value()
        torch.cuda.synchronize()
        t_sweeps = time.perf_counter() - t0
        t0 = time.perf_counter()
        checkpoint.save(ck, {"grid": y100, "step": 100})
        t_save = time.perf_counter() - t0
        del y100
        v0 = integrity.stats["verified"]
        t0 = time.perf_counter()
        state = checkpoint.restore(ck)  # its leaves are on the card
        t_restore = time.perf_counter() - t0
        verified = integrity.stats["verified"] - v0
        resumed = rt.sstencil_iterate(star2, state["grid"],
                                      200 - int(state["step"]))._value()
        straight = rt.sstencil_iterate(star2, g2, 200)._value()
        torch.cuda.synchronize()
        return (bytes_equal(resumed, straight), sk.launches_tma, t_sweeps,
                t_save, t_restore, verified)

    same, tma, t_sweeps, t_save, t_restore, verified = window(
        "checkpointed star2 solver 8192^2 f32", solve, {"stencil": 400})
    ok = same and tma == 400 and verified == 1 and \
        os.path.exists(checkpoint.digests_path(ck))
    log(f"  star2 8192^2 f32: 100 sweeps {t_sweeps:.4f} s, checkpoint save "
        f"{t_save:.4f} s ({nbytes / t_save / 1e9:.2f} GB/s), restore "
        f"{t_restore:.4f} s ({nbytes / t_restore / 1e9:.2f} GB/s), the "
        f"digest sidecar verified; 100 + 100 resumed sweeps byte-equal to "
        f"200 straight, {tma} of 400 launches on the TMA path "
        f"{'ok' if ok else 'MISS'} [{card}]")
    if not ok:
        raise Fail("the checkpointed solver")
    r0 = registry.get("resilience.retries.checkpoint_io")
    faults.configure("checkpoint_io:once")
    try:
        checkpoint.save(ck, {"grid": g2, "step": 0}, force=True)
    finally:
        faults.configure(None)
    back = checkpoint.restore(ck)
    retried = registry.get("resilience.retries.checkpoint_io") - r0
    ok = retried == 1 and bytes_equal(back["grid"]._value(), g2._value())
    log(f"  checkpoint save under checkpoint_io:once: {retried} retry, "
        f"restore byte-equal {'ok' if ok else 'MISS'}")
    if not ok:
        raise Fail("checkpoint_io:once was not retried")
    del back
    faults.configure("checkpoint:leaf:flip:bytes=1")
    try:
        checkpoint.restore(ck)
    except checkpoint.CheckpointCorruptError as e:
        log(f"  checkpoint:leaf flip: restore raised CheckpointCorruptError "
            f"({e}) ok")
    else:
        raise Fail("a flipped checkpoint leaf restored without an error")
    finally:
        faults.configure(None)



def groupby_path(rt, sg, torch, np, card, window):
    """groupby at a size users run: an hourly sensor series (2^28 float64
    readings, 24 hour-of-day groups) and 2^28 float32 values under 64
    random category codes (the classifier's largest G)."""
    n = 1 << 28

    def reductions(g, kinds, what):
        for kind in kinds:
            def call(kind=kind):
                t0 = time.perf_counter()
                r = getattr(g, kind)()
                v = r._value()
                torch.cuda.synchronize()
                return time.perf_counter() - t0, v

            cold, _v = window(f"{what} {kind} (cold)", call, {"segred": 1})
            wall, v = window(f"{what} {kind}", call, {"segred": 1})
            _t, direct = time_segred(sg, torch, g, kind, f"{what} {kind}", card)
            if not torch.equal(v.view(torch.uint8), direct.view(torch.uint8)):
                raise Fail(f"{what} {kind}: the user path's bytes differ from "
                           "a direct launch's")
            log(f"  {what} {kind}: wall per call {wall:.4f} s (first call "
                f"{cold:.4f} s), result {v.dtype}{tuple(v.shape)} byte-equal "
                f"to a direct launch [{card}]")

    x_t, hour = hourly_series(torch, np, n)
    x = rt.fromarray(x_t)
    g = x.groupby(0, hour, num_groups=24)
    reductions(g, ("sum", "min", "max", "count"), "groupby hourly n=2^28 f64 G=24")

    # mean and the anomaly: the generic lowering, group by group
    hour_t = torch.from_numpy(hour).cuda()
    ref_mean = torch.stack([x_t[hour_t == k].mean() for k in range(24)])
    bound = torch.stack([x_t[hour_t == k].abs().sum() for k in range(24)]) \
        * EPS["float64"]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    def mean_path():
        t0 = time.perf_counter()
        m = g.mean()
        mv = m._value()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated() - base
        a = g - m
        av = a._value()
        torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t1, peak, mv, av

    w_mean, w_anom, peak, mv, av = window(
        "groupby hourly mean + anomaly g - g.mean() (generic lowering)",
        mean_path, {"segred": 0, "elemred": 0})
    check_sums("groupby hourly mean n=2^28 f64 vs torch boolean-mask means", mv,
               ref_mean, bound, "eps*sum|x_g|")
    want = x_t - ref_mean[hour_t.long()]
    check_close("groupby hourly anomaly x - mean[hour] n=2^28 f64", av, want, 0.0,
                "the mean's bound plus one rounding",
                atol=float(bound.max()) + 4 * EPS["float64"] * float(x_t.abs().max()))
    mask_bytes = 24 * n  # a (G, n) bool mask, before any (G, n) values
    log(f"  groupby hourly mean: {w_mean:.4f} s, peak {peak / 1e9:.3f} GB above "
        f"the inputs (a (G, n) mask alone is {mask_bytes / 1e9:.3f} GB); anomaly "
        f"g - g.mean(): {w_anom:.4f} s [{card}]")
    if peak >= mask_bytes:
        raise Fail("the mean held a (G, n)-sized intermediate")
    del x, g, x_t, hour_t, want, av, mv
    torch.cuda.empty_cache()

    x_t, codes = category_series(torch, np, n, 64)
    g = rt.fromarray(x_t).groupby(0, codes, num_groups=64)
    reductions(g, ("sum", "max"), "groupby categories n=2^28 f32 G=64")
    del g, x_t
    torch.cuda.empty_cache()


def skeletons_path(rt, er, torch, np, card, window):
    """The skeleton layer at full size: smap (the docs' f1 form, a
    branching kernel, an np.sin kernel) over n = 2^28 float64, smap_index
    over a 16384^2 float32 grid, the smap result synced and summed (one
    elemred launch), sreduce (the docs' example, an np.maximum reducer, a
    SreduceReducer), scumulative (the odd/even cumsum over 2^28 float64
    and int64, a sequential EMA down a (4096, 65536) float32 array), spmd
    (a halo(1) 5-point update of an 8192^2 float32 array) and the new
    reductions over 2^28 float64.  Every call is timed cold (its first
    call in the process) and warm; skeletons.host_fallback must stay 0."""
    from ramba_tpu_torch import skeletons as skl

    n = 1 << 28
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    warm_walls = {}

    def fallback_zero(what):
        if skl.counters["skeletons.host_fallback"]:
            raise Fail(f"{what}: a traceable kernel reached the host fallback")

    def timed(name, call, need, moved_bytes=None):
        """``call()`` cold and warm (each result read to a tensor and
        synced), launches around the warm one; returns the warm value.
        The cold call's graph building (the kernel's dtype probe on the
        host included) is printed apart."""
        def run():
            t0 = time.perf_counter()
            v = call()
            t1 = time.perf_counter()
            v = v._value() if hasattr(v, "_value") else v
            torch.cuda.synchronize()
            return time.perf_counter() - t0, t1 - t0, v

        cold, cold_build, _v = run()
        del _v
        warm, _b, v = window(name, run, need)
        rate = ""
        if moved_bytes:
            gbs = moved_bytes / warm / 1e9
            rate = (f", {gbs:.1f} GB/s of {moved_bytes / 1e9:.2f} GB moved at "
                    f"least ({100 * gbs * 1e9 / HBM_BYTES_PER_S:.1f} % of "
                    f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
        log(f"  {name}: cold {cold:.4f} s ({cold_build:.4f} s building "
            f"the graph), warm {warm:.4f} s{rate} [{card}]")
        warm_walls[name] = warm
        fallback_zero(name)
        return v

    skl.counters["skeletons.host_fallback"] = 0
    a_t = torch.randn(n, generator=gen, device="cuda", dtype=torch.float64)
    b_t = torch.randn(n, generator=gen, device="cuda", dtype=torch.float64)
    a, b = rt.fromarray(a_t), rt.fromarray(b_t)
    c = np.arange(20)

    def f1(x, y, cc, d):
        return x * d + y - cc[5]

    got = timed("smap docs f1 (x * d + y - c[5]) n=2^28 f64",
                lambda: rt.smap(f1, a, b, c, 7), {}, 3 * n * 8)
    check_exact("smap f1 vs plain torch", got, a_t * 7 + b_t - 5,
                "the same three float64 ops in the same order")
    del got
    br0 = skl.counters["skeletons.branch_lowered"]
    got = timed("smap branching kernel x*x if x > 0 else -x n=2^28 f64",
                lambda: rt.smap(lambda x: x * x if x > 0 else -x, a), {},
                2 * n * 8)
    lowered = skl.counters["skeletons.branch_lowered"] - br0
    if lowered != 2:  # one per call: cold and warm
        raise Fail(f"branching smap lowered {lowered} times over two calls")
    check_exact("smap branch vs torch.where", got,
                torch.where(a_t > 0, a_t * a_t, -a_t), "one where of two sides")
    log(f"  smap branching kernel: skeletons.branch_lowered +1 per call "
        f"({lowered} over the cold and warm calls)")
    del got
    got = timed("smap np.sin kernel n=2^28 f64",
                lambda: rt.smap(lambda x: np.sin(x), a), {}, 2 * n * 8)
    check_exact("smap np.sin vs torch.sin", got, torch.sin(a_t),
                "np.sin rerouted to torch.sin on the card")

    # the smap result, synced, then summed: one elemred launch
    res = rt.smap(lambda x: np.sin(x), a)
    rt.sync()
    res_t = res._value()

    s = timed("sum of a synced smap result n=2^28 f64 (elemred)",
              lambda: rt.sum(res), {"elemred": 1}, n * 8)
    from ramba_tpu_torch.core import fuser

    _path, grid, ept = er.geometry(*fuser.prepare_program(
        [rt.sum(res).read_expr()]))
    check_sums("smap -> sum (elemred) vs torch.sum", s, res_t.sum(),
               sum_bound(er.depth(n, grid, ept), "float64",
                         float(res_t.abs().sum())),
               "2*depth*eps*sum|x|, elemred.depth")
    del res, res_t, got, s, b, b_t
    torch.cuda.empty_cache()

    g = 16384
    grid_t = torch.rand(g, g, generator=gen, device="cuda", dtype=torch.float32)
    grid_a = rt.fromarray(grid_t)
    got = timed("smap_index a + (i - j) on 16384^2 f32",
                lambda: rt.smap_index(
                    lambda idx, x: x + (idx[0] - idx[1]).astype(np.float32),
                    grid_a), {}, 2 * g * g * 4)
    ii = torch.arange(g, device="cuda", dtype=torch.int32)
    check_exact("smap_index vs plain torch", got,
                grid_t + (ii[:, None] - ii[None, :]).to(torch.float32),
                "int32 index planes, one float32 add")
    del got, grid_a, grid_t, ii
    torch.cuda.empty_cache()

    # sreduce: the docs' example at 2^28, held against the same fold of
    # halves in plain torch (its order) and printed beside torch.sum
    base = rt.init_array(n, lambda i: i * 11.0)
    base -= 7
    base = abs(base)
    rt.sync()
    base_t = base._value()

    def fold(t, comb):
        size = 1 << max(0, int(t.shape[0] - 1).bit_length())
        if size != t.shape[0]:
            raise Fail("fold expects a power of two")
        while t.shape[0] > 1:
            h = t.shape[0] // 2
            t = comb(t[:h], t[h:])
        return t[0]

    got = timed("sreduce docs (x/100, +) n=2^28 f64",
                lambda: rt.sreduce(lambda x: x / 100, lambda x, y: x + y, 0,
                                   base), {}, n * 8)
    # a divisor on the card: torch multiplies by the reciprocal of a
    # python-number divisor, the port divides by a 0-d tensor
    hundred = torch.full((), 100.0, device="cuda", dtype=torch.float64)
    check_exact("sreduce docs vs plain fold of halves", got,
                fold(base_t / hundred, torch.add), "the same tree of adds")
    ref = (base_t / hundred).sum()
    log(f"  sreduce docs: {float(got)!r}, torch.sum {float(ref)!r}, relative "
        f"difference {abs(float(got) - float(ref)) / abs(float(ref)):.3e}")
    got = timed("sreduce np.maximum reducer n=2^28 f64",
                lambda: rt.sreduce(lambda x: x, lambda x, y: np.maximum(x, y),
                                   -np.inf, a), {}, n * 8)
    check_exact("sreduce max vs torch.amax", got, a_t.amax(), "max is exact")
    got = timed("sreduce SreduceReducer(+, +) n=2^28 f64",
                lambda: rt.sreduce(lambda x: x, rt.SreduceReducer(
                    lambda x, y: x + y, lambda x, y: x + y), 0.0, a), {}, n * 8)
    check_exact("sreduce SreduceReducer vs plain fold of halves", got,
                fold(a_t, torch.add), "one card: the worker tree alone")
    del base, base_t, got
    torch.cuda.empty_cache()

    # scumulative: values k/2^20 keep every prefix sum exact in float64,
    # so the odd/even order and torch.cumsum must agree exactly
    k_t = torch.randint(-(1 << 19), 1 << 19, (n,), generator=gen,
                        device="cuda")
    q_t = k_t.to(torch.float64) * 2.0 ** -20
    q = rt.fromarray(q_t)
    got = timed("scumulative associative cumsum n=2^28 f64 (probe passes)",
                lambda: rt.scumulative(lambda x, cc: x + cc,
                                       lambda cc, blk: blk + cc, q),
                {}, 2 * n * 8)
    check_exact("scumulative f64 cumsum vs torch.cumsum", got,
                torch.cumsum(q_t, 0), "k/2^20 values: every prefix exact")
    del got, q, q_t
    # its order is fixed: two runs on randn values, are the bytes equal?
    r = rt.fromarray(torch.randn(n, generator=gen, device="cuda",
                                 dtype=torch.float64))

    def oddeven():
        return rt.scumulative(lambda x, cc: x + cc, lambda cc, blk: blk + cc,
                              r)._value()

    s1, s2 = oddeven(), oddeven()
    torch.cuda.synchronize()
    log(f"  scumulative odd/even cumsum of 2^28 randn f64 twice: byte-equal "
        f"{bytes_equal(s1, s2)} [{card}]")
    del r, s1, s2
    ki = rt.fromarray(k_t)
    got = timed("scumulative associative cumsum n=2^28 int64",
                lambda: rt.scumulative(lambda x, cc: x + cc,
                                       lambda cc, blk: blk + cc, ki),
                {}, 2 * n * 8)
    check_exact("scumulative int64 cumsum vs torch.cumsum", got,
                torch.cumsum(k_t, 0), "integers")
    del got, ki, k_t
    torch.cuda.empty_cache()

    rows, cols, alpha = 4096, 65536, 0.1
    e_t = torch.rand(rows, cols, generator=gen, device="cuda",
                     dtype=torch.float32)
    e = rt.fromarray(e_t)

    def ema():
        return rt.scumulative(lambda x, cc: alpha * x + (1 - alpha) * cc,
                              lambda cc, blk: blk, e, 0)

    got = timed("scumulative sequential EMA (4096, 65536) f32 axis 0", ema,
                {}, 2 * rows * cols * 4)
    want = torch.empty_like(e_t)
    want[0] = e_t[0]
    for i in range(1, rows):
        want[i] = alpha * e_t[i] + (1 - alpha) * want[i - 1]
    check_exact("scumulative EMA vs a plain torch loop", got, want,
                "the same float32 ops in the same order")
    ema_wall = warm_walls["scumulative sequential EMA (4096, 65536) f32 axis 0"]
    log(f"  sequential EMA: {ema_wall / (rows - 1) * 1e6:.1f} us per position "
        f"({rows - 1} positions, host-bound) [{card}]")
    del got, want, e, e_t
    torch.cuda.empty_cache()

    sn = 8192
    s_t = torch.rand(sn, sn, generator=gen, device="cuda", dtype=torch.float32)
    s_arr = rt.fromarray(s_t)

    def five_point(lv):
        h = lv.halo(1)
        lv.set_local(h[:-2, 1:-1] + h[2:, 1:-1] + h[1:-1, :-2] + h[1:-1, 2:]
                     - 4.0 * h[1:-1, 1:-1])

    def spmd_call():
        rt.spmd(five_point, s_arr)
        return s_arr

    got = timed("spmd halo(1) 5-point set_local 8192^2 f32", spmd_call, {},
                2 * sn * sn * 4)
    p = torch.nn.functional.pad(s_t, (1, 1, 1, 1))
    once = (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
            - 4.0 * p[1:-1, 1:-1])
    p = torch.nn.functional.pad(once, (1, 1, 1, 1))
    twice = (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
             - 4.0 * p[1:-1, 1:-1])
    check_exact("spmd 5-point (cold then warm: two updates) vs plain torch",
                got, twice, "the same float32 ops, zeros beyond the edge")
    del got, s_arr, s_t, p, once, twice
    torch.cuda.empty_cache()

    # reductions over 2^28 float64, each against its plain formula
    m_t = a_t.mean()
    var_plain = ((a_t - m_t) ** 2).sum() / torch.full(
        (), float(n), device="cuda", dtype=torch.float64)
    got = timed("var n=2^28 f64", lambda: rt.var(a), {}, n * 8)
    check_exact("var vs plain formula", got, var_plain,
                "jnp's mean-centred formula, the same torch ops")
    check_close("var vs torch.var (Welford)", got, a_t.var(correction=0),
                1e-12, "another algorithm")
    got = timed("std n=2^28 f64", lambda: rt.std(a), {}, n * 8)
    check_exact("std vs plain formula", got, var_plain.sqrt(), "sqrt of var")
    first_nan = n // 5 + 3
    a_t[first_nan] = float("nan")
    a_t[n - 7] = float("nan")
    got = timed("argmax with NaN n=2^28 f64", lambda: rt.argmax(a), {}, n * 8)
    check_exact("argmax vs the first NaN", got,
                torch.tensor(first_nan, device="cuda"), "the first NaN wins")
    got = timed("nanargmin n=2^28 f64", lambda: rt.nanargmin(a), {}, n * 8)
    check_exact("nanargmin vs torch.argmin of NaN -> inf", got,
                torch.argmin(torch.nan_to_num(a_t, nan=float("inf"))),
                "NaN skipped")
    a_t[first_nan] = 0.5
    a_t[n - 7] = -0.5
    got = timed("median n=2^28 f64", lambda: rt.median(a), {}, n * 8)
    srt = torch.sort(a_t).values
    check_exact("median vs sort midpoint", got,
                (srt[n // 2 - 1] + srt[n // 2]) * 0.5, "even n: the midpoint")
    del srt
    # torch.cumsum of float64 on the card is not reproducible bit for bit
    # from run to run (its scan's look-back order varies): exact values
    exact_t = torch.randint(-(1 << 19), 1 << 19, (n,), generator=gen,
                            device="cuda").to(torch.float64) * 2.0 ** -20
    exact = rt.fromarray(exact_t)
    got = timed("cumsum n=2^28 f64", lambda: rt.cumsum(exact), {}, 2 * n * 8)
    check_exact("cumsum vs torch.cumsum", got, torch.cumsum(exact_t, 0),
                "k/2^20 values: every prefix exact")
    again = torch.cumsum(a_t, 0)
    log(f"  torch.cumsum of 2^28 randn f64 twice: max_abs_diff "
        f"{(again - torch.cumsum(a_t, 0)).abs().max().item():.3e} "
        f"(0 if reproducible) [{card}]")
    del got, a, a_t, exact, exact_t, again
    torch.cuda.empty_cache()

    # the loud host fallback: 1024 elements through a float() kernel
    import warnings

    skl.reset_fallback_warnings()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        small = rt.arange(1024.0)
        got = rt.smap(lambda x: float(x) * 0.5, small)._value()
    warned = [w for w in rec if "host evaluation" in str(w.message)]
    if skl.counters["skeletons.host_fallback"] != 1 or len(warned) != 1:
        raise Fail("the host fallback did not warn once and count once")
    check_exact("host fallback float() kernel (1024 elements)", got,
                torch.arange(1024.0, device="cuda", dtype=torch.float64) * 0.5,
                "per element on the host, back on the card")
    log(f"  host fallback: one warning ({str(warned[0].message)[:60]}...), "
        f"skeletons.host_fallback = 1, result on {got.device}")
    skl.counters["skeletons.host_fallback"] = 0


def indexing_path(rt, sc, torch, np, card, window):
    """Indexing, the NumPy protocol, sort, matmul and cumsum at full size
    through ``rt``, each against plain torch on the card, timed (wall,
    synchronised) with the GB/s of the bytes it must move."""
    from ramba_tpu_torch.core.ndarray import ndarray as port_ndarray

    n = 1 << 28
    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)
    dev = torch.device("cuda", 0)

    def timed(name, call, moved_bytes, need=None):
        def run():
            t0 = time.perf_counter()
            v = call()
            v = v._value() if hasattr(v, "_value") else v
            torch.cuda.synchronize()
            return time.perf_counter() - t0, v

        wall, v = window(name, run, need or {})
        rate = (f"{moved_bytes / wall / 1e9:.1f} GB/s of {moved_bytes / 1e9:.3f}"
                f" GB it must move" if moved_bytes else "a view: no bytes moved")
        log(f"  {name}: {wall:.4f} s, {rate} [{card}]")
        return v

    # masked writes: the select runs on the card, nothing is compacted
    a_t = torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
    a = rt.fromarray(a_t.clone())

    def masked():
        a[a > 0] += 1.0
        a[a < 0] = 0
        return a

    got = timed("a[a > 0] += 1.0; a[a < 0] = 0 n=2^28 f64", masked, 2 * n * 8)
    want = torch.where(a_t > 0, a_t + 1.0, a_t)
    want = torch.where(want < 0, torch.zeros_like(want), want)
    check_exact("masked writes vs torch.where", got, want, "the same ops")
    del a, got, want

    # gather: 2^26 indices, a sixteenth past the end and a sixteenth below -n
    m = 1 << 26
    x = rt.fromarray(a_t)
    idx_t = torch.randint(-n, n, (m,), generator=gen, device=dev)
    idx_t[: m // 16] += n
    idx_t[m // 16: m // 8] -= n
    norm = torch.where(idx_t < 0, idx_t + n, idx_t).clamp(0, n - 1)
    idx = rt.fromarray(idx_t)
    got = timed("gather x[idx] 2^26 of 2^28 f64 (out of range, negative)",
                lambda: x[idx], m * 8 * 3)
    check_exact("gather vs the clamp rule", got, a_t[norm],
                "negative indices from the end, then clamped")
    torch.cuda.synchronize()  # a device assert would surface here
    del got, norm

    # scatter: 2^26 unique indices into 2^28 f64
    perm = torch.randperm(n, generator=gen, device=dev)[:m]
    vals_t = torch.randn(m, generator=gen, device=dev, dtype=torch.float64)
    y = rt.fromarray(a_t.clone())
    sidx, svals = rt.fromarray(perm), rt.fromarray(vals_t)

    def scatter():
        y[sidx] = svals
        return y

    got = timed("scatter y[idx] = v 2^26 unique of 2^28 f64", scatter,
                2 * n * 8 + 2 * m * 8)
    want = a_t.clone()
    want[perm] = vals_t
    check_exact("scatter vs torch index_put_", got, want, "unique indices")
    del got, want, y, sidx, svals, perm, vals_t, idx, idx_t, x
    torch.cuda.empty_cache()

    # a gather of rows and a slice of columns on a 16384^2 grid
    X_t = torch.randn(16384, 16384, generator=gen, device=dev,
                      dtype=torch.float32)
    rows_t = torch.randint(0, 16384, (8192,), generator=gen, device=dev)
    X = rt.fromarray(X_t)
    rows = rt.fromarray(rows_t)
    got = timed("X[rows, 1:9] 8192 rows of 16384^2 f32", lambda: X[rows, 1:9],
                8192 * (8 * 4 + 8 + 8 * 4))
    check_exact("X[rows, 1:9] vs torch", got, X_t[rows_t, 1:9], "a gather")
    del X, X_t, rows, rows_t, got

    # NumPy's functions on port arrays stay on the card
    h = n // 2
    p_t = a_t[:h].clone()
    q_t = a_t[h:].clone()
    p, q = rt.fromarray(p_t), rt.fromarray(q_t)
    for name, call, want_of, moved in (
            ("np.concatenate", lambda: np.concatenate([p, q]),
             lambda: torch.cat([p_t, q_t]), 2 * n * 8),
            ("np.stack", lambda: np.stack([p, q]),
             lambda: torch.stack([p_t, q_t]), 2 * n * 8),
            ("np.where", lambda: np.where(p > 0, p, q),
             lambda: torch.where(p_t > 0, p_t, q_t), 3 * h * 8),
            ("np.transpose", lambda: np.transpose(
                np.reshape(p, (16384, h // 16384))),
             lambda: p_t.reshape(16384, h // 16384).T, 0)):
        res = call()
        if not isinstance(res, port_ndarray):
            raise Fail(f"{name} on port arrays gave {type(res)}")
        got = timed(f"{name} on port arrays (2^27 f64 each)", lambda: res,
                    moved)
        if got.device != dev:
            raise Fail(f"{name}: the result lies on {got.device}")
        check_exact(f"{name} vs torch (a port ndarray on {got.device})", got,
                    want_of(), "data movement")
        del res, got
    del p, q, p_t, q_t
    torch.cuda.empty_cache()

    # sort / argsort of 2^28 f64 with NaNs (some negative) and signed zeros
    s_t = a_t.clone()
    s_t[:: 1 << 10] = float("nan")
    s_t[1 :: 1 << 11] = -float("nan")
    s_t[2 :: 1 << 9] = -0.0
    s_t[3 :: 1 << 9] = 0.0
    s = rt.fromarray(s_t)
    srt = timed("sort n=2^28 f64 (NaNs, signed zeros)", lambda: rt.sort(s),
                2 * n * 8)
    order = timed("argsort n=2^28 f64", lambda: rt.argsort(s), n * 8 + n * 8)
    nan = torch.isnan(s_t)
    k = int(nan.sum())
    body = srt[: n - k]
    ok_nan = bool(torch.isnan(srt[n - k:]).all()) and not bool(
        torch.isnan(body).any())
    ok_order = bool((body[1:] >= body[:-1]).all())
    gathered = bytes_equal(s_t[order], srt)
    zeros = torch.nonzero(s_t == 0).reshape(-1)  # input order of the zeros
    zsorted = srt[srt == 0]
    ok_zero = torch.equal(torch.signbit(zsorted), torch.signbit(s_t[zeros]))
    ties = order[n - k:]
    ok_stable = bool((ties[1:] > ties[:-1]).all())  # the NaNs keep their order
    ok = ok_nan and ok_order and gathered and ok_zero and ok_stable
    log(f"  sort/argsort: ascending {ok_order}, {k} NaNs last {ok_nan}, "
        f"signed zeros in input order {ok_zero}, ties stable {ok_stable}, "
        f"x[argsort] byte-equal to sort {gathered} "
        f"{'ok' if ok else 'MISS'}")
    if not ok:
        raise Fail("sort/argsort on the card")
    del s, s_t, srt, order, nan, body, zeros, zsorted, ties
    torch.cuda.empty_cache()

    # matmul: float32 with TF32 off, float64, each against a float64 product
    for dt, N, sample in ((torch.float32, 8192, None), (torch.float64, 4096, 64)):
        A_t = torch.randn(N, N, generator=gen, device=dev, dtype=dt)
        B_t = torch.randn(N, N, generator=gen, device=dev, dtype=dt)
        A, B = rt.fromarray(A_t), rt.fromarray(B_t)
        rt.set_matmul_precision(None)
        (A @ B)._value()  # warm: cuBLAS picks its kernel once
        torch.cuda.synchronize()
        C = timed(f"matmul {N}^2 {dt} (TF32 off)", lambda: A @ B, 3 * N * N *
                  A_t.element_size())
        t_ms = cuda_ms(lambda: (A @ B)._value(), 3)
        flops = 2 * N ** 3
        dname = str(dt).split(".")[1]
        if sample is None:
            ref = A_t.double() @ B_t.double()
            absprod = A_t.double().abs() @ B_t.double().abs()
            Cs = C
        else:
            rsel = torch.randperm(N, generator=gen, device=dev)[:sample]
            ref = (A_t[rsel].cpu() @ B_t.cpu()).to(dev)
            absprod = (A_t[rsel].abs().cpu() @ B_t.abs().cpu()).to(dev)
            Cs = C[rsel]
        if torch.backends.cuda.matmul.allow_tf32:
            raise Fail("the matmul left TF32 on")
        check_sums(f"matmul {N}^2 {dname} vs a float64 product"
                   f"{'' if sample is None else f' ({sample} sampled rows, CPU)'}",
                   Cs.double(), ref, N * EPS[dname] * absprod,
                   "K*eps*(|A||B|)")
        log(f"  matmul {N}^2 {dname}: {t_ms:.4f} ms, {flops / t_ms / 1e9:.1f} "
            f"TFLOP/s against the data sheet's {PEAK_MATMUL[dname] / 1e12:.0f} "
            f"TFLOP/s ({'CUDA cores, TF32 off' if dname == 'float32' else 'FP64 tensor cores'}) "
            f"[{card}]")
        del A, B, C, A_t, B_t, ref, absprod, Cs
        torch.cuda.empty_cache()

    # int64 matmul: cuBLAS has no integer product; the port's chunked path
    N = 2048
    Ai = torch.randint(-(1 << 20), 1 << 20, (N, N), generator=gen, device=dev)
    Bi = torch.randint(-(1 << 20), 1 << 20, (N, N), generator=gen, device=dev)
    try:
        torch.matmul(Ai[:2, :2], Bi[:2, :2])
        lib_int = "torch.matmul takes int64 on the card"
    except RuntimeError as e:
        lib_int = f"torch.matmul refuses int64 on the card ({str(e)[:50]})"
    log(f"  {lib_int}")
    Ci = timed(f"matmul {N}^2 int64 (chunked broadcast product)",
               lambda: rt.fromarray(Ai) @ rt.fromarray(Bi), 3 * N * N * 8)
    rsel = torch.randperm(N, generator=gen, device=dev)[:16]
    want = (Ai[rsel].cpu() @ Bi.cpu()).to(dev)
    check_exact(f"int64 matmul {N}^2 on 16 sampled rows vs the CPU's",
                Ci[rsel], want, "integers, exact")
    del Ai, Bi, Ci, want
    torch.cuda.empty_cache()

    # cumsum on the scan kernel: twice, the same bytes
    c = rt.fromarray(a_t)
    r1 = timed("rt.cumsum n=2^28 f64 (scan kernel)", lambda: rt.cumsum(c),
               2 * n * 8, {"scan": 1})
    r2 = rt.cumsum(c)._value()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lib = torch.cumsum(a_t, 0)
    torch.cuda.synchronize()
    lib_wall = time.perf_counter() - t0
    same = bytes_equal(r1, r2)
    plain = bytes_equal(r1, sc.scan_reference(a_t, "cumsum", 0))
    log(f"  rt.cumsum twice byte-equal {same}, byte-equal to the scan's plain "
        f"version {plain}; torch.cumsum {lib_wall:.4f} s beside it; byte bound "
        f"{1e3 * 2 * n * 8 / HBM_BYTES_PER_S:.4f} ms [{card}]")
    if not (same and plain):
        raise Fail("rt.cumsum is not reproducible bit for bit")
    del r1, r2, lib
    torch.cuda.empty_cache()
    for label in ("cold (after empty_cache)", "warm"):
        split_cumsum(rt, sc, torch, c, label, card)
    del c, a_t
    torch.cuda.empty_cache()


def breadth_path(rt, er, sg, sc, torch, np, card, window):
    """The rest of the NumPy surface at sizes users run, through ``rt``:
    complex values, ``ops/extras.py``, ``rt.fft``, ``rt.linalg``, the
    creation tail, the graph rewrites and the models.  Each check prints
    its tolerance; each timed item its wall (cold, then warm), the bytes
    it must move (GB/s) or its TFLOP/s, and the card."""
    log("  breadth_path: complex, extras, fft, linalg, creation, rewrite, "
        "models")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(41)

    def timed(name, call, moved_bytes=None, flops=None, need=None, warm=True):
        """One cold and (``warm``) one warm call in launch windows; the
        value of the warm call."""
        def run():
            t0 = time.perf_counter()
            v = call()
            v = v._value() if hasattr(v, "_value") else v
            torch.cuda.synchronize()
            return time.perf_counter() - t0, v

        cold, v = window(f"{name} (cold)", run, need or {})
        wall = cold
        if warm:
            del v
            wall, v = window(name, run, need or {})
        rate = []
        if moved_bytes:
            rate.append(f"{moved_bytes / wall / 1e9:.1f} GB/s of "
                        f"{moved_bytes / 1e9:.3f} GB it must move")
        if flops:
            rate.append(f"{flops / wall / 1e12:.3f} TFLOP/s of "
                        f"{flops / 1e12:.3f} TFLOP")
        log(f"  {name}: wall {wall:.4f} s (first call {cold:.4f} s), "
            f"{'; '.join(rate) or 'host boundary'} [{card}]")
        return v

    def sample_check(what, got, want, rtol, reason, atol=0.0):
        """A 2^20-element result against NumPy's on the same sample."""
        g = torch.as_tensor(np.asarray(got))
        w = torch.as_tensor(np.asarray(want))
        check_close(what, g, w, rtol, reason, atol=atol)

    # -- complex values: 2^26 complex128 ---------------------------------------
    nc, ns = 1 << 26, 1 << 20
    z_t = torch.complex(torch.randn(nc, generator=gen, device=dev,
                                    dtype=torch.float64),
                        torch.randn(nc, generator=gen, device=dev,
                                    dtype=torch.float64))
    w_t = torch.complex(torch.randn(nc, generator=gen, device=dev,
                                    dtype=torch.float64),
                        torch.randn(nc, generator=gen, device=dev,
                                    dtype=torch.float64))
    z, w = rt.fromarray(z_t), rt.fromarray(w_t)
    zs, ws = z_t[:ns].cpu().numpy(), w_t[:ns].cpu().numpy()
    cb = nc * 16
    got = timed("imag z 2^26 c128", lambda: rt.imag(z), cb + nc * 8)
    check_exact("imag vs torch.imag", got, z_t.imag.clone(), "a copy")
    sample_check("imag vs NumPy (2^20 sample)", got[:ns].cpu(), zs.imag, 0.0,
                 "a copy")
    got = timed("angle z 2^26 c128", lambda: rt.angle(z), cb + nc * 8)
    check_close("angle vs torch.angle", got, torch.angle(z_t), 4 * EPS["float64"],
                "atan2 of the parts, 4 eps relative")
    sample_check("angle vs NumPy", got[:ns].cpu(), np.angle(zs),
                 4 * EPS["float64"], "4 eps relative")
    del got
    got = timed("sign z 2^26 c128", lambda: rt.sign(z), 2 * cb)
    plain = z_t / z_t.abs()
    check_close("sign vs z/|z|", torch.view_as_real(got),
                torch.view_as_real(plain), 4 * EPS["float64"],
                "4 eps relative", atol=4 * EPS["float64"])
    sample_check("sign vs NumPy", torch.view_as_real(got[:ns].cpu()),
                 np.stack([np.sign(zs).real, np.sign(zs).imag], -1),
                 4 * EPS["float64"], "4 eps", atol=4 * EPS["float64"])
    del got, plain
    got = timed("var z 2^26 c128", lambda: rt.var(z), cb)
    m = z_t.mean()
    plain = ((z_t - m).real ** 2 + (z_t - m).imag ** 2).mean()
    check_sums("var vs mean |z - mean|^2", got, plain,
               sum_bound(64, "float64", float(plain) * nc), "a sum's depth")
    check_close("var vs NumPy (2^20 sample)",
                torch.as_tensor(float(rt.var(rt.fromarray(zs))._value())),
                torch.as_tensor(float(np.var(zs))), 1e-12,
                "sums of 2^20 terms in two orders")
    del got, plain
    got = timed("less z < w 2^26 c128", lambda: rt.less(z, w), 2 * cb + nc)
    plain = torch.where(z_t.real == w_t.real, z_t.imag < w_t.imag,
                        z_t.real < w_t.real)
    check_exact("less vs lexicographic compare", got, plain,
                "real parts, then imaginary")
    sample_check("less vs NumPy", got[:ns].cpu(), np.less(zs, ws), 0.0,
                 "NumPy orders complex lexicographically")
    del got, plain
    got = timed("max z 2^26 c128", lambda: rt.max(z), cb)
    top = z_t.real.max()
    plain = z_t[z_t.real == top][z_t[z_t.real == top].imag.argmax()]
    check_exact("max vs lexicographic max", got.reshape(1), plain.reshape(1),
                "one element selected")
    check_exact("max vs NumPy (2^20 sample)",
                rt.max(rt.fromarray(zs))._value().cpu().reshape(1),
                torch.as_tensor(np.max(zs)).reshape(1), "lexicographic")
    got = timed("sort z 2^26 c128", lambda: rt.sort(z), 4 * cb)
    first = torch.sort(z_t.imag, stable=True).indices
    second = torch.sort(z_t.real[first], stable=True).indices
    check_exact("sort vs two stable passes", torch.view_as_real(got),
                torch.view_as_real(z_t[first[second]]), "the same order")
    check_exact("sort vs NumPy (2^20 sample)",
                torch.view_as_real(rt.sort(rt.fromarray(zs))._value().cpu()),
                torch.view_as_real(torch.as_tensor(np.sort(zs))),
                "lexicographic")
    del got, first, second, z, w, z_t, w_t
    torch.cuda.empty_cache()

    # -- extras ---------------------------------------------------------------
    n = 1 << 28
    x_t = torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
    x_t[::16] = float("nan")
    x = rt.fromarray(x_t)
    for name in ("nancumsum", "nancumprod"):
        src = x_t if name == "nancumsum" else 1 + x_t * 1e-9
        arr = rt.fromarray(src)
        got = timed(f"{name} 2^28 f64 (NaN every 16th)",
                    lambda: getattr(rt, name)(arr), 2 * n * 8,
                    need={"scan": 1})
        fill = 0.0 if name == "nancumsum" else 1.0
        plain = sc.scan_reference(torch.where(torch.isnan(src),
                                              torch.full_like(src, fill), src),
                                  name[3:], 0)
        if not bytes_equal(got, plain):
            raise Fail(f"{name}: the scan's bytes differ from its plain "
                       "version's")
        log(f"  {name}: bytes equal to the scan's plain version (a NaN-to-"
            f"{fill:g} select, then the fixed-order scan) ok")
        del got, plain, arr, src
    torch.cuda.empty_cache()
    xf = torch.nan_to_num(x_t, nan=0.5)
    xfr = rt.fromarray(xf)
    hundred = torch.full((), 100.0, dtype=torch.float64, device=dev)
    reached = {}
    for name, fn, plain_fn, moved in (
            ("diff", lambda: rt.diff(xfr), lambda: xf[1:] - xf[:-1], 3 * n * 8),
            ("nan_to_num", lambda: rt.nan_to_num(x),
             lambda: torch.nan_to_num(x_t), 2 * n * 8),
            ("fix", lambda: rt.fix(xfr), lambda: torch.trunc(xf), 2 * n * 8),
            # a divisor on the card: torch divides by a python scalar as a
            # product with its reciprocal, which is not correctly rounded
            ("around(2)", lambda: rt.around(xfr, 2),
             lambda: torch.round(xf * hundred) / hundred, 2 * n * 8)):
        got = timed(f"{name} 2^28 f64", fn, moved)
        reached[name] = er.launches > 0  # the warm window's count
        check_exact(f"{name} vs torch", got, plain_fn(), "the same ops")
        del got
    got = timed("trapezoid 2^28 f64", lambda: rt.trapezoid(xfr), n * 8)
    plain = 0.5 * (xf[1:] + xf[:-1]).sum()
    check_sums("trapezoid vs 0.5 * sum(y[1:] + y[:-1])", got, plain,
               sum_bound(64, "float64", 2 * float(xf.abs().sum())),
               "a sum's depth")
    log(f"  extras on elemred (one program of maps over a 1-D operand, when "
        f"the classifier takes it): {reached} [{card}]")
    del x, x_t, xfr, got, plain
    torch.cuda.empty_cache()

    edges_t = torch.sort(torch.randn(1 << 24, generator=gen, device=dev,
                                     dtype=torch.float64)).values
    q_t = torch.randn(1 << 26, generator=gen, device=dev, dtype=torch.float64)
    edges, q = rt.fromarray(edges_t), rt.fromarray(q_t)
    qb = (1 << 26) * 12 + (1 << 24) * 8
    got = timed("searchsorted 2^26 queries into 2^24 edges f64",
                lambda: rt.searchsorted(edges, q), qb)
    check_exact("searchsorted vs torch.searchsorted",
                got, torch.searchsorted(edges_t, q_t).to(torch.int32),
                "int32, as ramba_tpu")
    got = timed("digitize 2^26 into 2^24 bins f64",
                lambda: rt.digitize(q, edges), qb)
    check_exact("digitize vs torch.searchsorted(right)", got,
                torch.searchsorted(edges_t, q_t, right=True).to(torch.int32),
                "increasing bins")
    del got, edges, q, edges_t, q_t
    e_t = torch.randint(0, 1 << 30, (1 << 26,), generator=gen, device=dev)
    t_t = torch.randint(0, 1 << 30, (1 << 20,), generator=gen, device=dev)
    t_t[: 1 << 16] = e_t[: 1 << 16]
    got = timed("isin 2^26 int64 in 2^20", lambda: rt.isin(rt.fromarray(e_t),
                                                          rt.fromarray(t_t)),
                (1 << 26) * 9 + (1 << 20) * 8)
    check_exact("isin vs torch.isin", got, torch.isin(e_t, t_t), "bools")
    del got, e_t, t_t
    xp_t = torch.sort(torch.rand(1 << 20, generator=gen, device=dev,
                                 dtype=torch.float64)).values
    fp_t = torch.sin(xp_t * 20)
    xi_t = torch.rand(1 << 26, generator=gen, device=dev, dtype=torch.float64)
    got = timed("interp 2^26 points on 2^20 knots f64",
                lambda: rt.interp(rt.fromarray(xi_t), rt.fromarray(xp_t),
                                  rt.fromarray(fp_t)),
                (1 << 26) * 16 + (1 << 20) * 16)
    sample_check("interp vs NumPy (2^20 sample)", got[:ns].cpu(),
                 np.interp(xi_t[:ns].cpu().numpy(), xp_t.cpu().numpy(),
                           fp_t.cpu().numpy()),
                 0.0, "8 eps of max|fp|", atol=8 * EPS["float64"])
    del got, xp_t, fp_t, xi_t
    a32 = torch.randn(1 << 26, generator=gen, device=dev)
    v32 = torch.randn(255, generator=gen, device=dev)
    flag = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # the port turns it off itself
    got = timed("convolve 2^26 f32 with 255 taps",
                lambda: rt.convolve(rt.fromarray(a32), rt.fromarray(v32)),
                (1 << 26) * 8, flops=2 * 255 * ((1 << 26) + 254))
    torch.backends.cudnn.allow_tf32 = flag
    ref64 = rt.convolve(rt.fromarray(a32.double()),
                        rt.fromarray(v32.double()))._value()
    bound = 255 * EPS["float32"] * float(a32.abs().max()) * \
        float(v32.abs().sum())
    check_close("convolve f32 vs its float64 run", got.double(), ref64, 0.0,
                "255 * eps32 * max|a| * sum|v| (TF32 would be 2^13 x that)",
                atol=bound)
    lib = cuda_ms(lambda: torch.nn.functional.conv1d(
        a32[None, None], v32.flip(0)[None, None], padding=254), 3)
    log(f"  convolve library call conv1d {lib:.4f} ms [{card}]")
    del got, ref64, a32, v32
    torch.cuda.empty_cache()
    qx_t = torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
    qx = rt.fromarray(qx_t)
    got = timed("quantile(0.1, 0.5, 0.9) 2^28 f64",
                lambda: rt.quantile(qx, [0.1, 0.5, 0.9]), 2 * n * 8)
    s_t = torch.sort(qx_t).values
    pos = torch.tensor([0.1, 0.5, 0.9], dtype=torch.float64,
                       device=dev) * (n - 1)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    plain = s_t[lo.long()] * (1 - (pos - lo)) + s_t[hi.long()] * (pos - lo)
    check_close("quantile vs sort and interpolate", got, plain,
                2 * EPS["float64"], "the same sort; 2 eps")
    qx_t[::7] = float("nan")
    qxn = rt.fromarray(qx_t)
    got = timed("nanquantile(0.5) 2^28 f64 (NaN every 7th)",
                lambda: rt.nanquantile(qxn, 0.5), 2 * n * 8)
    valid = qx_t[~torch.isnan(qx_t)]
    sv = torch.sort(valid).values
    p = 0.5 * (valid.numel() - 1)
    plain = sv[int(np.floor(p))] * (1 - (p - np.floor(p))) + \
        sv[int(np.ceil(p))] * (p - np.floor(p))
    check_close("nanquantile vs sort of the non-NaN", got.reshape(1),
                plain.reshape(1), 2 * EPS["float64"], "2 eps")
    del got, s_t, plain, qx, qxn, qx_t, valid, sv
    torch.cuda.empty_cache()
    lab_t = torch.randint(0, 4096, (n,), generator=gen, device=dev)
    wt_t = torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
    lab, wt = rt.fromarray(lab_t), rt.fromarray(wt_t)
    r1 = timed("weighted bincount 2^28 labels into 4096 bins f64",
               lambda: rt.bincount(lab, weights=wt), n * 16 + 4096 * 8)
    r2 = rt.bincount(lab, weights=wt)._value()
    if not bytes_equal(r1, r2):
        raise Fail("weighted bincount reruns differ")
    plain = torch.zeros(4096, dtype=torch.float64, device=dev)
    plain.index_add_(0, lab_t, wt_t)
    check_sums("weighted bincount vs index_add_", r1, plain,
               sum_bound(1 << 16, "float64", float(wt_t.sum())),
               "sequential per-bin sums of up to ~2^16 terms")
    log(f"  weighted bincount: two runs byte-equal (a stable sort by label, "
        f"then one sum per label) [{card}]")
    del r1, r2, plain, lab, wt, lab_t, wt_t
    torch.cuda.empty_cache()
    u_t = torch.randint(0, 1 << 20, (n,), generator=gen, device=dev)
    u = rt.fromarray(u_t)
    t0 = time.perf_counter()
    vals, counts = rt.unique(u, return_counts=True)
    wall = time.perf_counter() - t0
    plain_v, plain_c = torch.unique(u_t, return_counts=True)
    if not (np.array_equal(vals, plain_v.cpu().numpy())
            and np.array_equal(counts, plain_c.cpu().numpy())):
        raise Fail("unique disagrees with torch.unique")
    log(f"  unique 2^28 int64 (2^20 distinct), a host boundary: copied "
        f"{n * 8 / 1e9:.3f} GB to the host, wall {wall:.4f} s, values and "
        f"counts equal torch.unique's (exact) ok [{card}]")
    del u, u_t, plain_v, plain_c, vals, counts
    torch.cuda.empty_cache()
    cm_t = torch.randn(64, 1 << 22, generator=gen, device=dev,
                       dtype=torch.float64)
    got = timed("cov (64, 2^22) f64", lambda: rt.cov(rt.fromarray(cm_t)),
                64 * (1 << 22) * 8, flops=2 * 64 * 64 * (1 << 22))
    check_close("cov vs torch.cov", got, torch.cov(cm_t), 0.0,
                "two 2^22-term dot products over N - 1: 2 * 10 sqrt(K) eps "
                "max|x|^2 (Higham and Mary's probabilistic bound)",
                atol=2 * 10 * (1 << 11) * EPS["float64"]
                * float(cm_t.abs().max()) ** 2)
    del got, cm_t
    torch.cuda.empty_cache()

    # -- fft ------------------------------------------------------------------
    c_fft = 4  # the round trip's error: c * log2(n) * eps * max|x|
    nf = 1 << 27
    f_t = torch.complex(torch.randn(nf, generator=gen, device=dev,
                                    dtype=torch.float64),
                        torch.randn(nf, generator=gen, device=dev,
                                    dtype=torch.float64))
    f = rt.fromarray(f_t)
    got = timed("fft + ifft 2^27 c128", lambda: rt.fft.ifft(rt.fft.fft(f)),
                4 * nf * 16, flops=2 * 5 * nf * 27)
    check_close("ifft(fft(x)) vs x", torch.view_as_real(got),
                torch.view_as_real(f_t), 0.0,
                f"c * log2(n) * eps * max|x|, c = {c_fft}",
                atol=c_fft * 27 * EPS["float64"] * float(f_t.abs().max()))
    del got, f, f_t
    r_t = torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
    r = rt.fromarray(r_t)
    got = timed("rfft + irfft 2^28 f64",
                lambda: rt.fft.irfft(rt.fft.rfft(r), n=n),
                2 * n * 8 + 2 * (n // 2 + 1) * 16, flops=2 * 2.5 * n * 28)
    check_close("irfft(rfft(x)) vs x", got, r_t, 0.0,
                f"c * log2(n) * eps * max|x|, c = {c_fft}",
                atol=c_fft * 28 * EPS["float64"] * float(r_t.abs().max()))
    del got, r, r_t
    torch.cuda.empty_cache()
    m2 = 16384
    g_t = torch.complex(torch.randn(m2, m2, generator=gen, device=dev),
                        torch.randn(m2, m2, generator=gen, device=dev))
    g2 = rt.fromarray(g_t)
    got = timed("fft2 16384^2 c64", lambda: rt.fft.fft2(g2),
                2 * m2 * m2 * 8, flops=5 * m2 * m2 * 28)
    lib = cuda_ms(lambda: torch.fft.fft2(g_t), 2)
    back = rt.fft.ifft2(rt.fromarray(got))._value()
    check_close("ifft2(fft2(x)) vs x", torch.view_as_real(back),
                torch.view_as_real(g_t), 0.0,
                f"c * log2(n) * eps * max|x|, c = {c_fft}",
                atol=c_fft * 28 * EPS["float32"] * float(g_t.abs().max()))
    log(f"  fft2 library call torch.fft.fft2 {lib:.4f} ms [{card}]")
    got = timed("fftshift 16384^2 c64", lambda: rt.fft.fftshift(g2),
                2 * m2 * m2 * 8)
    check_exact("fftshift vs torch.fft.fftshift", torch.view_as_real(got),
                torch.view_as_real(torch.fft.fftshift(g_t)), "a roll")
    del got, back, g2, g_t
    torch.cuda.empty_cache()

    # -- linalg ---------------------------------------------------------------
    def resid(what, r, bound, reason):
        ok = bool(r <= bound)
        log(f"  {what}: residual {r:.3e} (bound {bound:.3e}: {reason}) "
            f"{'ok' if ok else 'MISS'}")
        if not ok:
            raise Fail(f"{what}: residual beyond its bound")

    N8 = 8192
    eps = EPS["float64"]
    A_t = torch.eye(N8, device=dev, dtype=torch.float64) + 0.25 / N8 ** 0.5 * \
        torch.randn(N8, N8, generator=gen, device=dev, dtype=torch.float64)
    b_t = torch.randn(N8, generator=gen, device=dev, dtype=torch.float64)
    A, b = rt.fromarray(A_t), rt.fromarray(b_t)
    anorm = float(torch.linalg.matrix_norm(A_t, ord=2))
    got = timed("solve 8192^2 f64", lambda: rt.linalg.solve(A, b),
                N8 * N8 * 8, flops=2 / 3 * N8 ** 3, warm=False)
    resid("solve |Ax - b| / (|A| |x|)",
          float(torch.linalg.vector_norm(A_t @ got - b_t)) /
          (anorm * float(torch.linalg.vector_norm(got))), 8 * N8 * eps,
          "8 n eps (backward stable)")
    got = timed("inv 8192^2 f64", lambda: rt.linalg.inv(A), 2 * N8 * N8 * 8,
                flops=2 * N8 ** 3, warm=False)
    resid("inv |A inv(A) - I|", float((A_t @ got - torch.eye(
        N8, device=dev, dtype=torch.float64)).abs().max()), 8 * N8 * eps * 4,
        "8 n eps cond(A), cond(A) <= 4")
    del got
    d = timed("det 8192^2 f64", lambda: rt.linalg.det(A), N8 * N8 * 8,
              flops=2 / 3 * N8 ** 3, warm=False)
    sign_, logabs = rt.linalg.slogdet(A)
    sign_v, logabs_v = float(sign_), float(logabs)
    lib_s, lib_l = torch.linalg.slogdet(A_t)
    check_close("slogdet vs torch.linalg.slogdet",
                torch.tensor([sign_v, logabs_v]),
                torch.tensor([float(lib_s), float(lib_l)]), 0.0,
                "8 n eps", atol=8 * N8 * eps)
    check_close("det vs sign * exp(logabsdet)", d.reshape(1).cpu(),
                torch.tensor([sign_v * np.exp(logabs_v)], dtype=torch.float64),
                8 * N8 * eps, "8 n eps relative")
    B_t = torch.randn(N8, N8, generator=gen, device=dev, dtype=torch.float64)
    S_t = B_t @ B_t.T / N8 + torch.eye(N8, device=dev, dtype=torch.float64)
    del B_t
    S = rt.fromarray(S_t)
    L = timed("cholesky 8192^2 f64", lambda: rt.linalg.cholesky(S),
              2 * N8 * N8 * 8, flops=N8 ** 3 / 3, warm=False)
    resid("cholesky |L L^T - A| / |A|", float((L @ L.T - S_t).abs().max()) /
          float(S_t.abs().max()), 8 * N8 * eps, "8 n eps")
    del L, S, S_t, A, A_t, b, b_t, d
    torch.cuda.empty_cache()
    N4 = 4096
    M_t = torch.randn(N4, N4, generator=gen, device=dev, dtype=torch.float64)
    M = rt.fromarray(M_t)
    mnorm = float(M_t.abs().max())
    eye4 = torch.eye(N4, device=dev, dtype=torch.float64)

    def qr():
        q_, r_ = rt.linalg.qr(M)
        return torch.stack([q_._value(), r_._value()])

    qr_v = timed("qr 4096^2 f64 (Q and R, one factorization)", qr,
                 3 * N4 * N4 * 8, flops=4 / 3 * N4 ** 3 * 2, warm=False)
    q_, r_ = qr_v[0], qr_v[1]
    resid("qr |A - QR| / |A|", float((q_ @ r_ - M_t).abs().max()) / mnorm,
          8 * N4 * eps, "8 n eps")
    resid("qr |Q^T Q - I|", float((q_.T @ q_ - eye4).abs().max()),
          8 * N4 * eps, "8 n eps")
    del qr_v, q_, r_

    def svd():
        u_, s_, vh_ = rt.linalg.svd(M)
        return u_._value(), s_._value(), vh_._value()

    u_, s_, vh_ = timed("svd 4096^2 f64 (U, S, Vh, one factorization)", svd,
                        3 * N4 * N4 * 8, flops=22 * N4 ** 3, warm=False)
    resid("svd |A - U S Vh| / |A|",
          float(((u_ * s_) @ vh_ - M_t).abs().max()) / mnorm, 8 * N4 * eps,
          "8 n eps")
    resid("svd |U^T U - I|", float((u_.T @ u_ - eye4).abs().max()),
          8 * N4 * eps, "8 n eps")
    del u_, vh_
    H_t = (M_t + M_t.T) / 2
    H = rt.fromarray(H_t)

    def eigh():
        w_, v_ = rt.linalg.eigh(H)
        return w_._value(), v_._value()

    w_, v_ = timed("eigh 4096^2 f64", eigh, 2 * N4 * N4 * 8,
                   flops=9 * N4 ** 3, warm=False)
    resid("eigh |A - V W V^T| / |A|",
          float(((v_ * w_) @ v_.T - H_t).abs().max()) /
          float(H_t.abs().max()), 8 * N4 * eps, "8 n eps")
    resid("eigh |V^T V - I|", float((v_.T @ v_ - eye4).abs().max()),
          8 * N4 * eps, "8 n eps")
    del w_, v_, H, H_t
    P = timed("pinv 4096^2 f64", lambda: rt.linalg.pinv(M), 2 * N4 * N4 * 8,
              flops=24 * N4 ** 3, warm=False)
    cond = float(s_[0] / s_[-1])
    resid("pinv |A pinv(A) A - A| / |A|",
          float((M_t @ P @ M_t - M_t).abs().max()) / mnorm,
          8 * N4 * eps * cond, f"8 n eps cond(A), cond(A) = {cond:.3e}")
    del P
    rank = timed("matrix_rank 4096^2 f64", lambda: rt.linalg.matrix_rank(M),
                 N4 * N4 * 8, flops=4 * N4 ** 3, warm=False)
    tol = float(s_.max()) * N4 * eps
    want_rank = int((s_ > tol).sum())
    if int(rank) != want_rank:
        raise Fail(f"matrix_rank {int(rank)} vs {want_rank}")
    log(f"  matrix_rank {int(rank)} = #(S > S.max * n * eps) (exact) ok")
    del M, M_t, s_, eye4
    torch.cuda.empty_cache()
    nv_t = torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
    got = timed("norm 2^28 f64", lambda: rt.linalg.norm(rt.fromarray(nv_t)),
                n * 8)
    check_close("norm vs sqrt(sum x^2)", got.reshape(1),
                (nv_t * nv_t).sum().sqrt().reshape(1), 64 * EPS["float64"],
                "a sum's depth, relative")
    del nv_t, got
    e_np = np.random.RandomState(7).rand(1024, 1024)
    e_rt = rt.fromarray(e_np)
    t0 = time.perf_counter()
    wv, _vv = rt.linalg.eig(e_rt)
    x_ls = rt.linalg.lstsq(e_rt, e_rt[:, 0])[0]
    wall = time.perf_counter() - t0
    if not (np.allclose(np.sort_complex(wv), np.sort_complex(
            np.linalg.eigvals(e_np)), rtol=1e-9, atol=1e-9)
            and np.allclose(x_ls, np.linalg.lstsq(e_np, e_np[:, 0],
                                                  rcond=None)[0])):
        raise Fail("eig / lstsq disagree with NumPy")
    log(f"  eig and lstsq 1024^2 f64, host boundaries: copied "
        f"{3 * 1024 * 1024 * 8 / 1e6:.1f} MB to the host, wall {wall:.4f} s, "
        f"equal NumPy's within 1e-9 ok [{card}]")

    # -- creation -------------------------------------------------------------
    E32 = 32768
    got = timed("eye 32768^2 f32", lambda: rt.eye(E32, dtype=np.float32),
                E32 * E32 * 4)
    check_exact("eye vs torch.eye", got, torch.eye(E32, device=dev),
                "zeros and ones")
    del got
    torch.cuda.empty_cache()
    got = timed("mgrid[0:16384, 0:16384]", lambda: rt.mgrid[0:16384, 0:16384],
                2 * 16384 * 16384 * 8)
    ii, jj = torch.meshgrid(torch.arange(16384, device=dev),
                            torch.arange(16384, device=dev), indexing="ij")
    check_exact("mgrid vs torch.meshgrid(ij)", got, torch.stack([ii, jj]),
                "int64 indices")
    del got, ii, jj
    gx = rt.arange(16384.0)
    got = timed("meshgrid 2 x 16384 f64",
                lambda: rt.stack(rt.meshgrid(gx, gx)),
                2 * 16384 * 16384 * 8)
    xx, yy = torch.meshgrid(torch.arange(16384.0, device=dev,
                                         dtype=torch.float64),
                            torch.arange(16384.0, device=dev,
                                         dtype=torch.float64), indexing="xy")
    check_exact("meshgrid vs torch.meshgrid(xy)", got, torch.stack([xx, yy]),
                "copies")
    del got, xx, yy
    torch.cuda.empty_cache()
    got = timed("logspace(0, 3, 2^28)", lambda: rt.logspace(0, 3, n), n * 8)
    t = torch.arange(n, device=dev, dtype=torch.float64)
    plain = 10.0 ** (t * (3.0 / (n - 1)))
    plain[-1] = 1000.0
    check_close("logspace vs 10 ** (start + step * i)", got, plain,
                8 * EPS["float64"], "pow of the same exponents, 8 eps")
    got = timed("geomspace(1, 2^20, 2^28)", lambda: rt.geomspace(1, 1 << 20, n),
                n * 8)
    plain = 10.0 ** (t * (np.log10(1 << 20) / (n - 1)))
    check_close("geomspace vs 10 ** (log10 steps)", got, plain,
                64 * EPS["float64"], "pow of exponents up to 6, 64 eps")
    del got, plain, t
    torch.cuda.empty_cache()

    # -- the rewrites ----------------------------------------------------------
    from ramba_tpu_torch import common as rt_common
    from ramba_tpu_torch.core import rewrite

    x_t, hour = hourly_series(torch, np, n)
    x = rt.fromarray(x_t)
    idx = [np.where(hour == g)[0] for g in range(24)]
    gb_sum = x.groupby(0, hour, num_groups=24).sum()._value()
    gb_max = x.groupby(0, hour, num_groups=24).max()._value()
    for kind, want in (("sum", gb_sum), ("max", gb_max)):
        fires = rewrite.stats["rewrite_stack_reduce_advindex"]
        # one call, not cold and warm: its wall is host-bound and read
        # the same twice (2.7-4.2 s on an H100); the whole run has a limit
        got = timed(f"stack([x[idx_g].{kind}() for 24 hours]) 2^28 f64",
                    lambda kind=kind: rt.stack([getattr(x[i], kind)()
                                                for i in idx]),
                    n * 8 + n * 4, need={"segred": 1}, warm=False)
        if rewrite.stats["rewrite_stack_reduce_advindex"] != fires + 1:
            raise Fail(f"the {kind} stack did not take the rewrite")
        if kind == "sum":
            check_sums("stack of group sums vs x.groupby(...).sum()", got,
                       want, sum_bound(sg.depth(n), "float64",
                                       float(x_t.abs().sum())),
                       "segred's rounding depth")
        else:
            check_exact("stack of group maxima vs x.groupby(...).max()", got,
                        want, "selection")
    log(f"  rewrite_stack_reduce_advindex fired once per flush, each a "
        f"segred launch [{card}]")
    del x, x_t, idx, gb_sum, gb_max, hour
    torch.cuda.empty_cache()
    X_t = torch.rand(2048, 65536, generator=gen, device=dev)
    month = np.random.RandomState(8).randint(0, 12, 65536)
    cols = [np.where(month == g)[0] for g in range(12)]
    M_t = torch.stack([X_t[:, torch.from_numpy(c).to(dev)].mean(1)
                       for c in cols])
    X, Mm = rt.fromarray(X_t), rt.fromarray(M_t)

    def anomaly():
        return rt.concatenate([X[:, c] - Mm[g][:, None]
                               for g, c in enumerate(cols)], axis=1)

    fires = rewrite.stats["rewrite_concat_binop_getitem"]
    got = timed("anomaly concatenate([X[:, idx_g] - m[g][:, None]]) "
                "(2048, 65536) f32", anomaly, 3 * 2048 * 65536 * 4)
    if rewrite.stats["rewrite_concat_binop_getitem"] != fires + 2:
        raise Fail("the anomaly idiom did not take the rewrite")
    rt_common.rewrite_enabled = False
    try:
        plain = timed("anomaly without the rewrites (RAMBA_TPU_REWRITE off)",
                      anomaly, 3 * 2048 * 65536 * 4, warm=False)
    finally:
        rt_common.rewrite_enabled = True
    check_exact("anomaly rewritten vs not", got, plain, "gather and subtract")
    if rewrite.stats["errors"]:
        raise Fail(f"rewrite rules raised: {rewrite.errors}")
    log(f"  rewrite.stats {dict(rewrite.stats)} (errors 0) ok [{card}]")
    del got, plain, X, Mm, X_t, M_t
    torch.cuda.empty_cache()

    # -- the models -------------------------------------------------------------
    from ramba_tpu_torch.models.kmeans import kmeans
    from ramba_tpu_torch.models.pi import integrate_pi

    def pi():
        f0 = rt.fuser_stats["flushes"]
        v = integrate_pi(1_000_000_000)
        if rt.fuser_stats["flushes"] - f0 != 1:
            raise Fail("integrate_pi did not run as one flush")
        return torch.tensor(v, dtype=torch.float64)

    # the sum's result is scaled by h in the same flush, so the program is
    # not one elemred takes (a reduce result feeds a later instruction):
    # the generic lowering runs it, as the launch counts show
    v = timed("integrate_pi(1e9)", pi, 0, flops=6e9)
    err = abs(float(v) - np.pi)
    log(f"  integrate_pi(1e9) = {float(v)!r}, |pi - value| {err:.3e} (bound "
        f"1e-12) {'ok' if err <= 1e-12 else 'MISS'}")
    if err > 1e-12:
        raise Fail("integrate_pi off pi")
    kn, kd, kk = 1 << 24, 32, 64
    cent = torch.randn(kk, kd, generator=gen, device=dev) * 50
    lab = torch.randint(0, kk, (kn,), generator=gen, device=dev)
    pts = cent[lab] + torch.randn(kn, kd, generator=gen, device=dev)
    del lab, cent
    pts_rt = rt.fromarray(pts)

    def km():
        c_, l_ = kmeans(pts_rt, k=kk, iters=KMEANS_ITERS)
        return torch.from_numpy(l_)

    labels = timed(f"kmeans 2^24 x 32 f32, 64 clusters, {KMEANS_ITERS} "
                   "iterations", km, KMEANS_ITERS * kn * kd * 4 * 2,
                   flops=KMEANS_ITERS * 2 * kn * kd * kk, warm=False)
    # the plain run: the same algorithm in torch, the same first centroids
    init = np.random.RandomState(0).choice(kn, size=kk, replace=False)
    # (the same torch calls the port's ops make, so the same bytes: a
    # batched product, then one masked sum per group)
    c = pts[torch.from_numpy(init).to(dev)]
    xsq = (pts * pts).sum(1)
    for _ in range(KMEANS_ITERS):
        # float32 in the first step, float64 after (the counts are float64
        # in the model, as NumPy promotes), the product in the wider dtype
        cross = torch.matmul(pts.to(c.dtype).reshape(1, kn, kd),
                             c.T.reshape(1, kd, kk)).reshape(kn, kk)
        dist = xsq[:, None] - 2.0 * cross + (c * c).sum(1)[None, :]
        lab_p = dist.argmin(1)
        sums = torch.stack([torch.where((lab_p == g)[:, None], pts,
                                        torch.zeros((), device=dev)).sum(0)
                            for g in range(kk)])
        cnt = torch.bincount(lab_p, minlength=kk).clamp(min=1)
        c = sums.double() / cnt[:, None].double()
    check_exact("kmeans labels vs its plain run", labels.to(dev),
                lab_p, "separated clusters")
    del pts, pts_rt, labels, lab_p, dist, xsq, c, sums
    torch.cuda.empty_cache()


# k-means iterations: 4 keep the whole run within its time limit
KMEANS_ITERS = 4

MESH_GRID = 8192
MESH_ODD = (4099, 4133)
MESH_REDUCE_N = 1 << 28
MESH_SCAN_N = 1 << 26


def star2_by_hand(h):
    """star2 written out over a block extended by 2 cells: the same
    operations in the same order as ``star2_body``."""
    c = slice(2, -2)
    return (0.25 * (h[c, 3:-1] + h[c, 1:-3] + h[3:-1, c] + h[1:-3, c])
            + 0.125 * (h[c, 4:] + h[c, :-4] + h[4:, c] + h[:-4, c]))


def mesh_path(rt, sk, sc, torch, np, card, window):
    """The mesh of shards in one process: a 2x2 mesh whose four positions
    all hold cuda:0 (``set_mesh``).  star2 through ``sstencil`` (30
    chained) and ``sstencil_iterate`` (100 sweeps) at 8192^2 float32 and
    at 4099x4133 (uneven shards, the padded path), each byte-equal to the
    one-shard kernel's result on the same input and held against the plain
    version, with the kernel launched once per shard per sweep; spmd with
    ``halo(2)``: star2 by hand on every halo-extended block, masked with
    ``valid_mask``, against sstencil's interior; sreduce with a
    SreduceReducer over 2^28 float64 (sum of squares) against the one-shard
    fold and itself rerun; scumulative's cumsum over 2^26 float64 on 4
    shards against ``rt.cumsum`` and itself rerun.  Returns the sharded
    stencil's numbers for the kernels line."""
    from ramba_tpu_torch import parallel
    from ramba_tpu_torch.observe import registry
    from ramba_tpu_torch.parallel import mesh as pm

    log("  mesh_path: a 2x2 mesh of shards, every position on cuda:0")
    one = pm.get_mesh()
    grid = pm.Mesh(np.array([torch.device("cuda", 0)] * 4,
                            dtype=object).reshape(2, 2), ("d0", "d1"))
    star2 = rt.stencil(star2_body)
    slots = (("arr", 0),)
    lo, hi, _t = star2.neighborhood(slots)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    rows = []
    try:
        for shape, chained, iters, want_path in (
                ((MESH_GRID, MESH_GRID), 30, 100, "tma"),
                (MESH_ODD, 10, 20, "cpasync")):
            rows.append(mesh_stencil(rt, sk, torch, card, window, pm, one,
                                     grid, star2, lo, hi, slots, gen, shape,
                                     chained, iters, want_path, registry,
                                     parallel))
        pm.set_mesh(grid)
        mesh_spmd(rt, torch, card, window, star2, gen)
        mesh_reduce_scan(rt, sc, torch, card, window, pm, one, grid, gen)
    finally:
        pm.set_mesh(one)
    return rows


def mesh_stencil(rt, sk, torch, card, window, pm, one, grid, star2, lo, hi,
                 slots, gen, shape, chained, iters, want_path, registry,
                 parallel):
    what = f"star2 {shape[0]}x{shape[1]} f32 on the 2x2 mesh"
    x_t = torch.rand(shape, generator=gen, device="cuda")
    x = rt.fromarray(x_t)

    def sweeps():
        t0 = time.perf_counter()
        y = x
        for _ in range(chained):
            y = rt.sstencil(star2, y)
        yc = y._value()
        torch.cuda.synchronize()
        t_chain = (time.perf_counter() - t0) / chained
        t0 = time.perf_counter()
        yi = rt.sstencil_iterate(star2, x, iters)._value()
        torch.cuda.synchronize()
        t_iter = (time.perf_counter() - t0) / iters
        return yc, yi, t_chain, t_iter

    pm.set_mesh(one)
    ref_chain, ref_iter, t1_chain, t1_iter = sweeps()
    one_ms = cuda_ms(lambda: rt.sstencil_iterate(star2, x, 20)._value(),
                     1) / 20
    pm.set_mesh(grid)
    h0 = registry.counters["stencil.halo_bytes_est"]
    a0 = parallel.comm_stats["shard_assemble_bytes"]
    yc, yi, t_chain, t_iter = window(
        f"mesh {what}: {chained} sstencil + {iters} sstencil_iterate",
        sweeps, {"stencil": 4 * (chained + iters)})
    paths = stencil_paths(sk)
    halo = (registry.counters["stencil.halo_bytes_est"] - h0) / (
        chained + iters)
    moved = (parallel.comm_stats["shard_assemble_bytes"] - a0) / (
        chained + iters)
    if paths[want_path] != 4 * (chained + iters):
        raise Fail(f"{what}: load paths {paths}, expected every launch on "
                   f"{want_path}")
    for name, got, want in (("chained", yc, ref_chain),
                            ("iterate", yi, ref_iter)):
        ok = bytes_equal(got, want)
        log(f"  {what} {name}: byte-equal to the one-shard kernel's result: "
            f"{ok}")
        if not ok:
            raise Fail(f"{what} {name} differs from the one-shard result")
    plain = x_t
    for _ in range(chained):
        plain = sk.stencil_reference(star2_body, lo, hi, slots, [plain])
    err = check_close(f"{what} {chained} chained sweeps vs the plain version",
                      yc, plain, 1e-6, "float32 per-op IEEE in both, "
                      "same order")
    del plain, ref_chain, ref_iter, yc, yi
    ms = cuda_ms(lambda: rt.sstencil_iterate(star2, x, 20)._value(), 1) / 20
    nbytes = 2 * x_t.numel() * 4
    bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    log(f"  {what}: {ms:.4f} ms/sweep on the card (20 iterate sweeps between "
        f"CUDA events) against {one_ms:.4f} ms one-shard and a {bound_ms:.4f} "
        f"ms bound; wall per sweep chained {1e3 * t_chain:.4f} ms (one-shard "
        f"{1e3 * t1_chain:.4f}), iterate {1e3 * t_iter:.4f} ms (one-shard "
        f"{1e3 * t1_iter:.4f}); 4 launches per sweep, load paths {paths}; "
        f"stencil.halo_bytes_est {halo:.0f} B/sweep, assembled "
        f"{moved:.0f} B/sweep [{card}]")
    del x, x_t
    torch.cuda.empty_cache()
    return {"shape": what, "ms_per_sweep": ms, "one_shard_ms_per_sweep": one_ms,
            "bound_ms": bound_ms, "launches_per_sweep": 4,
            "paths": {k: v for k, v in paths.items() if v},
            "halo_bytes_est_per_sweep": halo,
            "assembled_bytes_per_sweep": moved, "max_abs_err": err,
            "wall_ms_per_sweep_chained": 1e3 * t_chain,
            "wall_ms_per_sweep_iterate": 1e3 * t_iter}


def mesh_spmd(rt, torch, card, window, star2, gen):
    n = MESH_GRID
    x = rt.fromarray(torch.rand(n, n, generator=gen, device="cuda"))
    dst = rt.zeros((n, n), dtype="float32")

    def kernel(src, out):
        out.set_local(rt.where(src.valid_mask, star2_by_hand(src.halo(2)),
                               0.0))

    def run():
        t0 = time.perf_counter()
        rt.spmd(kernel, x, dst)
        v = dst._value()
        torch.cuda.synchronize()
        return v, time.perf_counter() - t0

    got, wall = window("mesh spmd halo(2) star2 by hand 8192^2 f32", run, {})
    want = rt.sstencil(star2, x)._value()
    c = (slice(2, -2), slice(2, -2))
    check_exact("mesh spmd star2 by hand vs sstencil on the interior",
                got[c], want[c], "float32 per-op IEEE in both, same order")
    log(f"  mesh spmd halo(2) 8192^2 f32: {wall:.4f} s (4 shard threads, "
        f"halo exchange and flush) [{card}]")
    del x, dst, got, want
    torch.cuda.empty_cache()


def mesh_reduce_scan(rt, sc, torch, card, window, pm, one, grid, gen):
    n = MESH_REDUCE_N
    x_t = torch.rand(n, generator=gen, device="cuda", dtype=torch.float64)
    x = rt.fromarray(x_t)
    red = rt.SreduceReducer(lambda a, b: a + b, lambda a, b: a + b)

    def reduce():
        t0 = time.perf_counter()
        v = rt.sreduce(lambda v: v * v, red, 0.0, x)._value()
        torch.cuda.synchronize()
        return v, time.perf_counter() - t0

    pm.set_mesh(one)
    r1, _w = reduce()
    pm.set_mesh(grid)
    ra, wall = window("mesh sreduce SreduceReducer sum of squares 2^28 f64",
                      reduce, {})
    rb, _w = reduce()
    # each order is a fold-halves tree of depth 28 (one shard) or 26 + 2
    bound = 2 * 28 * EPS["float64"] * float(r1)
    diff = abs(float(ra) - float(r1))
    ok = bytes_equal(ra, rb) and diff <= bound
    log(f"  mesh sreduce 2^28 f64 (4 shards, per-shard folds, then theirs): "
        f"{float(ra)!r} vs one shard {float(r1)!r}, |diff| {diff:.3e} <= "
        f"{bound:.3e} (2 x depth 28 x eps x sum); rerun byte-equal "
        f"{bytes_equal(ra, rb)}; {wall:.4f} s [{card}]")
    if not ok:
        raise Fail("mesh sreduce disagrees with the one-shard fold or itself")
    del x, x_t
    torch.cuda.empty_cache()

    m = MESH_SCAN_N
    c_t = torch.rand(m, generator=gen, device="cuda", dtype=torch.float64)
    c = rt.fromarray(c_t)

    def scan():
        t0 = time.perf_counter()
        v = rt.scumulative(lambda v, cc: v + cc, lambda cc, b: b + cc,
                           c)._value()
        torch.cuda.synchronize()
        return v, time.perf_counter() - t0

    sa, wall = window("mesh scumulative cumsum 2^26 f64 on 4 shards", scan, {})
    sb, _w = scan()
    pm.set_mesh(one)
    ref = rt.cumsum(c)._value()
    pm.set_mesh(grid)
    # the odd/even scan of a 2^24 block (2 x 24 levels), the carry fold
    # over 4 shards and the scan kernel's own depth
    depth = 2 * 24 + 4 + sc.depth(m)
    excess = ((sa - ref).abs() - depth * EPS["float64"] * ref.abs()).max()
    ok = bytes_equal(sa, sb) and float(excess) <= 0
    log(f"  mesh scumulative cumsum 2^26 f64 (4 shards): within "
        f"{depth} x eps x prefix of rt.cumsum: {float(excess) <= 0}, max abs "
        f"err {max_abs(sa, ref):.3e}; rerun byte-equal {bytes_equal(sa, sb)}; "
        f"{wall:.4f} s [{card}]")
    if not ok:
        raise Fail("mesh scumulative disagrees with rt.cumsum or itself")


def split_cumsum(rt, sc, torch, c, label, card):
    """One ``rt.cumsum(c)``, read and synchronised, split into the host
    time until the scan's entry point is called (graph, flush, the output
    and status allocations), the host time of that call (memset and
    launch enqueued), and the host time after it until the synchronised
    result; beside them the card's time for the memset and the kernel
    (CUDA events around the call)."""
    marks = {}
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    entry = sc._entry

    def traced(tdt, fname):
        fn = entry(tdt, fname)

        def call(*args):
            marks["enter"] = time.perf_counter()
            ev0.record()
            rc = fn(*args)
            ev1.record()
            marks["return"] = time.perf_counter()
            return rc
        return call

    sc._entry = traced
    try:
        t0 = time.perf_counter()
        v = rt.cumsum(c)._value()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    finally:
        sc._entry = entry
    if "enter" not in marks:
        raise Fail("rt.cumsum did not reach the scan kernel")
    del v
    log(f"  rt.cumsum n=2^28 f64 {label}: wall {1e3 * (t1 - t0):.4f} ms = "
        f"host to the launch {1e3 * (marks['enter'] - t0):.4f} ms + memset "
        f"and launch enqueued {1e3 * (marks['return'] - marks['enter']):.4f} "
        f"ms + after the launch until synchronised "
        f"{1e3 * (t1 - marks['return']):.4f} ms; the card ran the memset and "
        f"kernel in {ev0.elapsed_time(ev1):.4f} ms [{card}]")


DIST_RANKS = 4
DIST_GRID = 8192
DIST_ODD = (4099, 4133)
DIST_CHAIN_N = 10 ** 9
DIST_AXPY_N = 1 << 28
DIST_HALO1_N = 1 << 26
DIST_SCAN_N = 1 << 26
DIST_RED_N = 1 << 28
DIST_IO_N = 1 << 28
DIST_LIMIT_S = 420  # per launch of ranks, every rank of it


def dist_grid(rt, np, shape, distribution=None, dtype=None, k=(7919, 104729)):
    """The grid every rank and the parent build from indices alone:
    ((k0 i + k1 j) mod 65536) / 65536, float32 unless asked, under
    ``distribution`` (default: the default layout)."""
    return rt.fromfunction(
        lambda i, j: ((i * k[0] + j * k[1]) % 65536) * (1.0 / 65536),
        shape, dtype=dtype or np.float32, distribution=distribution)


def dist_vec(rt, n, k=7919):
    """((k i) mod 65536) / 65536 in float64, from indices alone."""
    return ((rt.arange(n) * k) % 65536) * (1.0 / 65536)


def digest(t) -> str:
    import hashlib

    return hashlib.sha256(t.detach().contiguous().cpu().reshape(-1)
                          .view(__import__("torch").uint8).numpy()
                          .tobytes()).hexdigest()


def card_digest(t) -> str:
    """A checksum of a tensor's bytes taken on the card: the wrapping
    int64 sums of its 8-byte words, plain, weighted by position and
    xor-ed with the weights, with its dtype and shape (sha256 of 2 GiB on
    the host would take seconds)."""
    import torch

    b = t.detach().contiguous().reshape(-1).view(torch.uint8)
    if b.numel() % 8:
        b = torch.cat([b, b.new_zeros(8 - b.numel() % 8)])
    w = b.view(torch.int64)
    k = torch.arange(1, w.numel() + 1, device=w.device,
                     dtype=torch.int64) * 0x2545F4914F6CDD1D
    sums = [int(w.sum()), int((w * k).sum()), int((w ^ k).sum())]
    return f"{t.dtype}{tuple(t.shape)}:" + ":".join(
        f"{v & (2 ** 64 - 1):016x}" for v in sums)


def _rank_window(er, sk, sc, name, fn, rep, sg=None):
    """Counts to 0, ``fn``, counts read: recorded under ``name``."""
    er.launches = er.launches_bulk = er.launches_plain = 0
    sk.launches = sk.launches_tma = sk.launches_cpasync = 0
    sk.launches_ldst = 0
    sc.launches = 0
    if sg is not None:
        sg.launches = 0
    out = fn()
    rep["launches"][name] = {"elemred": er.launches, "stencil": sk.launches,
                             "scan": sc.launches,
                             "tma": sk.launches_tma,
                             "cpasync": sk.launches_cpasync,
                             "segred": sg.launches if sg is not None else 0}
    return out


def dist_rank(argv) -> int:
    """One rank of ``dist_path`` or ``layout_path`` (``--rank R --world W
    --store S --out D [--nccl | --per-card | --layout]``):
    every program on this rank's blocks, a report of digests, counts,
    times and traffic written to ``D/rank<R>.json``."""
    import json
    import os

    import numpy as np
    import torch

    import ramba_tpu_torch as rt
    from ramba_tpu_torch import common, parallel
    from ramba_tpu_torch.core import fuser
    from ramba_tpu_torch.ops import elemred as er
    from ramba_tpu_torch.ops import scan as sc
    from ramba_tpu_torch.ops import stencil_kernel as sk
    from ramba_tpu_torch.parallel import distributed

    arg = dict(zip(argv[::2], argv[1::2]))
    rank, world = int(arg["--rank"]), int(arg["--world"])
    out = arg["--out"]
    nccl = "--nccl" in argv
    per_card = "--per-card" in argv  # one rank per card, over NCCL
    distributed.initialize("file://" + arg["--store"], world, rank,
                           backend="nccl" if nccl or per_card else None)
    if world == 1:
        rt.set_mesh(distributed.global_mesh())
    rep = {"rank": rank, "backend": distributed.backend(),
           "reason": distributed.backend_reason(),
           "device": str(common.device()), "in_driver": rt.in_driver(),
           "mesh": repr(rt.get_mesh()), "launches": {}, "digests": {},
           "values": {}, "ms": {}, "wall_s": {}}
    if nccl:
        g = distributed.all_gather_small(torch.arange(4.0, device="cuda"))
        rep["values"]["allgather_ok"] = bool(all(
            torch.equal(x, torch.arange(4.0, device="cuda")) for x in g))
        rep["values"]["allreduce"] = distributed.all_reduce_int(rank + 1,
                                                                "sum")
        distributed.barrier("nccl")
        a = dist_vec(rt, DIST_AXPY_N)
        b = dist_vec(rt, DIST_AXPY_N, 104729)
        rt.sync()  # materialised: elemred takes vector leaves
        rep["values"]["axpy_sum"] = _rank_window(
            er, sk, sc, "axpy", lambda: float(rt.sum(2.5 * a + b)), rep)
    elif "--layout" in argv:
        layout_rank_programs(rt, np, torch, er, sk, sc, fuser, rep, out)
    elif "--ladder" in argv:
        ladder_rank_programs(rt, np, torch, er, sk, sc, rep)
    elif "--observe" in argv:
        observe_rank_programs(rt, np, torch, er, sk, sc, rep)
    elif "--elastic" in argv:
        rep["case"] = arg["--elastic"]
        rep["root"] = os.environ["RAMBA_ELASTIC_ROOT"]
        elastic_rank_programs(rt, np, torch, er, sk, sc, rep, out)
    else:
        dist_rank_programs(rt, np, torch, er, sk, sc, fuser, rep, out)
    rep["gathered"] = fuser.stats["gathered"]
    rep["comm"] = dict(parallel.comm_stats)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(rep, f)
    distributed.shutdown()
    return 0


def _events_ms(torch, fn, reps):
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def dist_rank_programs(rt, np, torch, er, sk, sc, fuser, rep, out):
    import os

    st = rt.stencil(star2_body)
    win = lambda name, fn: _rank_window(er, sk, sc, name, fn, rep)  # noqa
    g0 = fuser.stats["gathered"]
    for shape, chained, iters, tag in (((DIST_GRID, DIST_GRID), 30, 100,
                                        "even"), (DIST_ODD, 10, 20, "odd")):
        x = dist_grid(rt, np, shape)
        rt.sync()

        def sweeps():
            t0 = time.perf_counter()
            y = x
            for _ in range(chained):
                y = rt.sstencil(st, y)
            rt.sync()
            t1 = time.perf_counter()
            yi = rt.sstencil_iterate(st, x, iters)
            rt.sync()
            torch.cuda.synchronize()
            return y, yi, t1 - t0, time.perf_counter() - t1

        y, yi, tc, ti = win(f"star2_{tag}", sweeps)
        rep["digests"][f"star2_{tag}_chained"] = digest(y._block())
        rep["digests"][f"star2_{tag}_iterate"] = digest(yi._block())
        rep["wall_s"][f"star2_{tag}"] = [tc / chained, ti / iters]
        rep["ms"][f"star2_{tag}"] = _events_ms(
            torch, lambda: rt.sstencil_iterate(st, x, 20)._block(), 20)
        del x, y, yi
    base = dist_vec(rt, DIST_CHAIN_N)
    rt.sync()  # the materialised base

    def chain():
        t0 = time.perf_counter()
        v = [float(rt.sum(rt.sin(base) ** 2 + rt.cos(base) ** 2))
             for _ in range(2)]
        return v, time.perf_counter() - t0

    rep["values"]["chain_sum"], rep["wall_s"]["chain"] = win("chain", chain)
    del base
    a = dist_vec(rt, DIST_AXPY_N)
    b = dist_vec(rt, DIST_AXPY_N, 104729)
    rt.sync()
    rep["values"]["axpy_sum"] = win("axpy", lambda: float(rt.sum(2.5 * a + b)))
    rep["gathered_main"] = fuser.stats["gathered"] - g0
    g1 = fuser.stats["gathered"]
    del a, b
    torch.cuda.empty_cache()

    src = dist_vec(rt, DIST_HALO1_N)
    dst = rt.zeros(DIST_HALO1_N)
    rt.sync()

    def sweep(s_, d_):
        h = s_.halo(1)
        d_.set_local(h[:-2] + h[1:-1] + h[2:])

    def halo1():
        t0 = time.perf_counter()
        rt.spmd(sweep, src, dst)
        rt.sync()
        return time.perf_counter() - t0

    rep["wall_s"]["spmd_halo1"] = win("spmd_halo1", halo1)
    rep["digests"]["spmd_halo1"] = digest(dst._block())
    del src, dst
    x = dist_grid(rt, np, (DIST_GRID, DIST_GRID))
    d2 = rt.zeros((DIST_GRID, DIST_GRID), dtype="float32")
    rt.sync()

    def kernel(s_, o_):
        o_.set_local(rt.where(s_.valid_mask, star2_by_hand(s_.halo(2)), 0.0))

    def halo2():
        t0 = time.perf_counter()
        rt.spmd(kernel, x, d2)
        rt.sync()
        return time.perf_counter() - t0

    rep["wall_s"]["spmd_halo2"] = win("spmd_halo2", halo2)
    got = d2._block()
    want = rt.sstencil(st, x)._block()
    rep["values"]["spmd_halo2_equal"] = bool(torch.equal(
        got[2:-2, 2:-2], want[2:-2, 2:-2]))
    del x, d2, got, want
    c = dist_vec(rt, DIST_SCAN_N)
    rt.sync()

    def scum():
        t0 = time.perf_counter()
        r = rt.scumulative(lambda v, cc: v + cc, lambda cc, b_: b_ + cc, c)
        rt.sync()
        return r, time.perf_counter() - t0

    r, rep["wall_s"]["scumulative"] = win("scumulative", scum)
    rep["digests"]["scumulative"] = digest(r._block())
    del c, r
    xr = dist_vec(rt, DIST_RED_N)
    rt.sync()
    red = rt.SreduceReducer(lambda p, q: p + q, lambda p, q: p + q)
    rep["values"]["sreduce"] = [
        win("sreduce", lambda: float(rt.sreduce(lambda v: v * v, red, 0.0,
                                                xr))) for _ in range(2)]
    rep["gathered_skeletons"] = fuser.stats["gathered"] - g1
    torch.cuda.empty_cache()

    io = xr
    for ext in ("rtd", "npy"):
        path = os.path.join(out, f"io.{ext}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rt.save(path, io)
        rt.distributed.barrier("io")
        t1 = time.perf_counter()
        back = rt.load(path)
        blk = back._block()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rep["wall_s"][f"save_{ext}"] = [t1 - t0, t2 - t1]
        rep["values"][f"load_{ext}_equal"] = bool(torch.equal(
            blk, io._block()))
        del back, blk
    del io, xr
    torch.cuda.empty_cache()
    g = rt.sstencil_iterate(st, dist_grid(rt, np, (DIST_GRID, DIST_GRID)), 100)
    ck = os.path.join(out, "ck")
    t0 = time.perf_counter()
    rt.checkpoint.save(ck, {"grid": g, "step": 100}, force=True)
    back = rt.checkpoint.restore(ck)
    rep["wall_s"]["checkpoint"] = time.perf_counter() - t0
    h = win("checkpoint_resume",
            lambda: rt.sstencil_iterate(st, back["grid"], 100)._block())
    rep["digests"]["checkpoint_200"] = digest(h)
    rep["values"]["step"] = int(back["step"])


def dist_start(world, tmp, extra=(), env=None):
    """Start ``world`` ranks of this script (``--rank``); returns them."""
    import os

    store = os.path.join(tmp, f"store{world}{''.join(extra)}")
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--world", str(world), "--store", store, "--out",
         os.path.join(tmp, f"w{world}"), *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(world)]


def dist_wait(procs, tmp, deadline):
    """Wait for every rank (all killed past ``deadline``); returns their
    reports."""
    import json
    import os

    world = len(procs)
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1, deadline - time.time()))[0])
    except subprocess.TimeoutExpired:
        raise Fail(f"{world} ranks ran past their limit")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise Fail(f"rank {r} of {world} exited {p.returncode}:\n"
                       + logs[r][-4000:])
    reps = []
    for r in range(world):
        with open(os.path.join(tmp, f"w{world}", f"rank{r}.json")) as f:
            reps.append(json.load(f))
    return reps


def dist_check(reps, ref, want_sum, want_sreduce, totals, card, backend,
               label, wall):
    """Hold the ranks' reports against the one-process results; add their
    launches to ``totals``; returns the numbers for the kernels line."""
    for r in reps:
        log(f"  rank {r['rank']}: backend {r['backend']} "
            f"({r['reason']}), device {r['device']}, {r['mesh']}, "
            f"in_driver {r['in_driver']}")
    if [r["in_driver"] for r in reps] != [True] + [False] * 3:
        raise Fail("in_driver() is not true on rank 0 alone")
    if any(r["backend"] != backend for r in reps):
        raise Fail(f"{label}: expected {backend}")
    positions = {k: divmod(k, 2) for k in range(4)}  # rank order, 2x2
    for name, by_pos in ref.items():
        ok = all(reps[k]["digests"][name] == by_pos[positions[k]]
                 for k in range(4))
        log(f"  dist {name}: every rank's block byte-equal to the "
            f"one-process result's: {ok}")
        if not ok:
            raise Fail(f"dist {name} differs from one process")
    n_terms = {"chain_sum": DIST_CHAIN_N, "axpy_sum": DIST_AXPY_N}
    for key, want in want_sum.items():
        got = [r["values"][key] for r in reps]
        got = [g for gg in got for g in (gg if isinstance(gg, list)
                                         else [gg])]
        same = len({repr(g) for g in got}) == 1
        # any two summation orders of n positive terms differ by at
        # most 2 (n - 1) eps sum
        bound = 2 * n_terms[key] * EPS["float64"] * abs(want)
        diff = abs(got[0] - want)
        log(f"  dist {key}: {got[0]!r} on every rank and rerun "
            f"({same}) vs one process {want!r}: |diff| {diff:.3e} <= "
            f"{bound:.3e} (2 n eps sum)")
        if not same or diff > bound:
            raise Fail(f"dist {key}")
    sr = [x for r in reps for x in r["values"]["sreduce"]]
    ok = len({repr(x) for x in sr}) == 1 and sr[0] == want_sreduce
    log(f"  dist sreduce SreduceReducer 2^28 f64: {sr[0]!r} on every "
        f"rank and rerun, byte-equal to the one-process 2x2 fold "
        f"{want_sreduce!r}: {ok}")
    if not ok:
        raise Fail("dist sreduce")
    for key in ("spmd_halo2_equal", "load_rtd_equal", "load_npy_equal"):
        if not all(r["values"][key] for r in reps):
            raise Fail(f"dist {key} is false on some rank")
    if any(r["values"]["step"] != 100 for r in reps):
        raise Fail("dist checkpoint step")
    log("  dist spmd halo(2) star2 by hand equal to sstencil's interior, "
        ".rtd and .npy loads equal to the saved blocks, checkpoint "
        "restored and run on: True on every rank")
    for r in reps:
        if r["gathered_main"] or r["gathered_skeletons"]:
            raise Fail(f"rank {r['rank']}: the main path took the "
                       f"gathered lowering {r['gathered_main']} + "
                       f"{r['gathered_skeletons']} times")
    need = {"star2_even": ("stencil", 130, "tma"),
            "star2_odd": ("stencil", 30, "cpasync"),
            "chain": ("elemred", None, None),
            "axpy": ("elemred", None, None),
            "scumulative": ("scan", 1, None),
            "checkpoint_resume": ("stencil", 100, "tma")}
    for name, (k, n, path) in need.items():
        for r in reps:
            got = r["launches"][name]
            if (got[k] == 0 if n is None else got[k] != n) or (
                    path and got[path] != got[k]):
                raise Fail(f"rank {r['rank']} {name}: launches {got}, "
                           f"expected {k} {n or '> 0'} on {path}")
    for k in totals:
        totals[k] += sum(c.get(k, 0) for r in reps
                         for c in r["launches"].values())
    slow = {name: max(r["ms"][name] for r in reps)
            for name in reps[0]["ms"]}
    walls = {name: max(r["wall_s"][name] if not isinstance(
        r["wall_s"][name], list) else max(r["wall_s"][name])
        for r in reps) for name in reps[0]["wall_s"]}
    gbs = {ext: DIST_IO_N * 8 / 1e9 / max(
        r["wall_s"][f"save_{ext}"][0] for r in reps)
        for ext in ("rtd", "npy")}
    comm = {k: sum(r["comm"].get(k, 0) for r in reps) for k in (
        "send_bytes", "recv_bytes", "allgather_bytes",
        "host_staged_bytes")}
    log(f"  dist launches per rank {reps[0]['launches']}; every stencil "
        "launch on its predicted load path, elemred and scan on every "
        "rank, gathered programs 0")
    log(f"  dist ms/sweep by CUDA events, slowest rank: "
        f"{json.dumps(slow)} [{card}]")
    log(f"  dist walls (s, slowest rank; star2: per sweep chained, "
        f"iterate; save/load: save, load): {json.dumps(walls)}; "
        f"save GB/s of 2 GiB {json.dumps(gbs)}; {label} in {wall:.1f} s "
        f"[{card}]")
    log(f"  dist traffic over all ranks: {json.dumps(comm)}")
    return {"ms_per_sweep_slowest_rank": slow, "walls_s": walls,
            "save_gb_per_s": gbs, "traffic": comm, "ranks_wall_s": wall}


def dist_path(rt, er, sk, sc, torch, np, card, totals):
    """The main path across processes: 4 ranks on cuda:0, each a process
    of this script, the default 2x2 mesh of ranks, gloo through pinned
    host buffers (NCCL refuses two ranks on one card).  Every result is
    held against the one-process result computed here first: block by
    block by digest (stencils, spmd, scumulative, a checkpoint resumed),
    exactly (sreduce against the one-process 2x2 mesh's fold), within a
    stated bound (the cross-rank sums against one elemred sum).  Then one
    rank over NCCL.  Launch counts of every rank go into ``totals``."""
    import os
    import tempfile

    from ramba_tpu_torch import common
    from ramba_tpu_torch.parallel import mesh as pm

    log(f"  dist_path: {DIST_RANKS} ranks on cuda:0, default 2x2 mesh of "
        "ranks")
    st = rt.stencil(star2_body)
    dev = common.device()
    grid2 = pm.Mesh(np.array([dev] * 4, dtype=object).reshape(2, 2),
                    ("d0", "d1"))
    ref, want_sum = {}, {}
    t0 = time.perf_counter()

    def blocks(name, t):
        sh = pm.NamedSharding(grid2, pm.default_spec(tuple(t.shape), grid2))
        ref[name] = {pos: digest(t[idx]) for pos, idx in
                     sh.shard_indices(tuple(t.shape))}

    for shape, chained, iters, tag in (((DIST_GRID, DIST_GRID), 30, 100,
                                        "even"), (DIST_ODD, 10, 20, "odd")):
        x = dist_grid(rt, np, shape)
        y = x
        for _ in range(chained):
            y = rt.sstencil(st, y)
        blocks(f"star2_{tag}_chained", y._value())
        blocks(f"star2_{tag}_iterate",
               rt.sstencil_iterate(st, x, iters)._value())
        if tag == "even":
            blocks("checkpoint_200",
                   rt.sstencil_iterate(st, x, 200)._value())
        del x, y
    base = dist_vec(rt, DIST_CHAIN_N)
    rt.sync()
    want_sum["chain_sum"] = float(rt.sum(rt.sin(base) ** 2
                                         + rt.cos(base) ** 2))
    del base
    a = dist_vec(rt, DIST_AXPY_N)
    b = dist_vec(rt, DIST_AXPY_N, 104729)
    want_sum["axpy_sum"] = float(rt.sum(2.5 * a + b))
    del a, b
    v = dist_vec(rt, DIST_HALO1_N)._value()
    h = torch.zeros_like(v)
    h[1:-1] = v[:-2] + v[1:-1] + v[2:]
    h[0] = v[0] + v[1]
    h[-1] = v[-2] + v[-1]
    blocks("spmd_halo1", h)
    # scumulative's one-process result: the same four blocks through the
    # scan kernel, their totals folded in order and added back
    c = dist_vec(rt, DIST_SCAN_N)._value()
    parts = [sc.launch(p.contiguous(), "cumsum", 0) for p in c.chunk(4)]
    tots = [p[-1].clone() for p in parts]
    carry = None
    for k in range(1, 4):
        carry = tots[k - 1] if carry is None else carry + tots[k - 1]
        parts[k] = parts[k] + carry
    blocks("scumulative", torch.cat(parts))
    del v, h, c, parts
    pm.set_mesh(grid2)
    try:
        red = rt.SreduceReducer(lambda p, q: p + q, lambda p, q: p + q)
        want_sreduce = float(rt.sreduce(lambda q: q * q, red, 0.0,
                                        dist_vec(rt, DIST_RED_N)))
    finally:
        pm.set_mesh(pm.Mesh([dev], ("d0",)))
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    torch.cuda.empty_cache()
    log(f"  dist_path: one-process references in {t_ref:.1f} s [{card}]")

    with tempfile.TemporaryDirectory(prefix="ramba_dist_") as tmp:
        for w in (DIST_RANKS, 1):
            os.makedirs(os.path.join(tmp, f"w{w}"))
        t0 = time.perf_counter()
        deadline = time.time() + DIST_LIMIT_S
        ranks = dist_start(DIST_RANKS, tmp)
        nccl = []
        try:
            reps = dist_wait(ranks, tmp, deadline)
            wall = time.perf_counter() - t0
            summary = dist_check(reps, ref, want_sum, want_sreduce,
                                 totals, card, "gloo",
                                 f"{DIST_RANKS} ranks on cuda:0", wall)

            # the NCCL rank after the four, so that its start-up does not
            # share the host with their timed sweeps
            t0 = time.perf_counter()
            nccl = dist_start(1, tmp, ("--nccl",))
            (one,) = dist_wait(nccl, tmp, time.time() + DIST_LIMIT_S)
            if one["backend"] != "nccl" or not one["values"]["allgather_ok"] \
                    or one["values"]["allreduce"] != 1 or one["gathered"] \
                    or one["launches"]["axpy"]["elemred"] < 1:
                raise Fail(f"one-rank NCCL group: {one}")
            diff = abs(one["values"]["axpy_sum"] - want_sum["axpy_sum"])
            if diff > 2 * DIST_AXPY_N * EPS["float64"] * abs(want_sum["axpy_sum"]):
                raise Fail("one-rank NCCL axpy sum")
            for k in totals:
                totals[k] += sum(c.get(k, 0) for c in one["launches"].values())
            log(f"  dist one rank over NCCL ({one['reason']}): all-gather, "
                f"all-reduce, barrier and axpy + sum (elemred "
                f"{one['launches']['axpy']['elemred']} launch), "
                f"{one['values']['axpy_sum']!r}, in "
                f"{time.perf_counter() - t0:.1f} s [{card}]")
        finally:
            for p in ranks + nccl:  # stop every process started
                if p.poll() is None:
                    p.kill()
                    p.wait()

    if torch.cuda.device_count() < DIST_RANKS:
        log(f"  dist: {torch.cuda.device_count()} card(s) on this machine, "
            f"so {DIST_RANKS} ranks, one per card over NCCL, did not run")
        return summary
    with tempfile.TemporaryDirectory(prefix="ramba_dist_") as tmp:
        os.makedirs(os.path.join(tmp, f"w{DIST_RANKS}"))
        t0 = time.perf_counter()
        ranks = dist_start(DIST_RANKS, tmp, ("--per-card",))
        try:
            reps = dist_wait(ranks, tmp, time.time() + DIST_LIMIT_S)
            summary["one_rank_per_card"] = dist_check(
                reps, ref, want_sum, want_sreduce, totals, card, "nccl",
                f"{DIST_RANKS} ranks, one per card", time.perf_counter() - t0)
        finally:
            for p in ranks:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return summary


# ---------------------------------------------------------------------------
# layout_path: layouts chosen and changed across ranks, and the governor
# ---------------------------------------------------------------------------

LAYOUT_GRID = 8192                 # star2 and reshard, float32
LAYOUT_MIXED = 16384               # sum(a * x + y), float64
LAYOUT_SERIES_N = 1 << 28          # the hourly series, float64, G = 24
LAYOUT_AXIS = 8192                 # axis sums, float64
LAYOUT_STAGE = "16m"               # the staged reshard's stage bytes
LAYOUT_SPLITS = {"rows": (4, 1), "cols": (1, 4)}
GB_KINDS = ("sum", "min", "max", "count", "mean", "var")
GOVERNOR_N = 1 << 28               # two 2 GiB float64 arrays


def division_table(n):
    """The reference's per-worker (starts, ends) table of a 2x2 split of
    an n x n grid."""
    import numpy as np

    h = n // 2
    return np.array([[[r * h, c * h], [(r + 1) * h, (c + 1) * h]]
                     for r in range(2) for c in range(2)])


def layout_spec(a):
    """The array's layout as text (each entry one axis or a tuple)."""
    from ramba_tpu_torch.parallel import mesh as pm

    return repr(pm.canonical(a.sharding.spec))


def layout_rank_programs(rt, np, torch, er, sk, sc, fuser, rep, out):
    """One rank of ``layout_path``: star2 on arrays made under chosen
    layouts, reshard round trips, a program over two layouts, groupby and
    axis sums on the blocks; digests, counts, times and traffic into
    ``rep``."""
    import os

    from ramba_tpu_torch import parallel
    from ramba_tpu_torch.core import rewrite
    from ramba_tpu_torch.observe import registry
    from ramba_tpu_torch.ops import segred as sg
    from ramba_tpu_torch.resilience import memory

    st = rt.stencil(star2_body)
    win = lambda name, fn: _rank_window(er, sk, sc, name, fn, rep, sg)  # noqa
    g0 = fuser.stats["gathered"]
    shape = (LAYOUT_GRID, LAYOUT_GRID)
    ax = ("d0", "d1")
    made = {
        "rows": lambda: dist_grid(rt, np, shape, LAYOUT_SPLITS["rows"]),
        "cols": lambda: dist_grid(rt, np, shape, LAYOUT_SPLITS["cols"]),
        "divisions": lambda: rt.create_array_with_divisions(
            shape, division_table(LAYOUT_GRID), dtype=np.float32)
        + dist_grid(rt, np, shape)}
    for tag, make in made.items():
        x = make()
        rt.sync()
        rep["values"][f"layout_{tag}"] = layout_spec(x)

        def sweeps():
            t0 = time.perf_counter()
            y = x
            for _ in range(30):
                y = rt.sstencil(st, y)
            rt.sync()
            t1 = time.perf_counter()
            yi = rt.sstencil_iterate(st, x, 100)
            rt.sync()
            torch.cuda.synchronize()
            return y, yi, t1 - t0, time.perf_counter() - t1

        y, yi, tc, ti = win(f"star2_{tag}", sweeps)
        rep["digests"][f"star2_{tag}_chained"] = digest(y._block())
        rep["digests"][f"star2_{tag}_iterate"] = digest(yi._block())
        rep["wall_s"][f"star2_{tag}"] = [tc / 30, ti / 100]
        rep["ms"][f"star2_{tag}"] = _events_ms(
            torch, lambda: rt.sstencil_iterate(st, x, 20)._block(), 20)
        del x, y, yi

    # reshard: row -> column -> 2x2 -> row, in one stage, then staged
    x = dist_grid(rt, np, shape, LAYOUT_SPLITS["rows"])
    rt.sync()
    src = digest(x._block())
    led = memory.ledger
    rep["reshard"] = {}
    for tag, stage in (("one_stage", None), ("staged", LAYOUT_STAGE)):
        if stage is None:
            os.environ.pop("RAMBA_RESHARD_STAGE_BYTES", None)
        else:
            os.environ["RAMBA_RESHARD_STAGE_BYTES"] = stage
        steps = []
        for name, spec in (("cols", (None, ax)), ("divisions", ax),
                           ("rows", (ax,))):
            sent0 = parallel.comm_stats["send_bytes"]
            st0 = registry.get("reshard.stages")
            src_bytes = x._block().numel() * 4
            base = led.live_bytes + led.transient_bytes
            led.peak_live_bytes = base
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rt.reshard(x, spec)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            blk = x._block()
            steps.append({
                "to": name, "wall_s": wall,
                "sent_bytes": parallel.comm_stats["send_bytes"] - sent0,
                "stages": registry.get("reshard.stages") - st0,
                "src_bytes": src_bytes, "dst_bytes": blk.numel() * 4,
                "peak_above_live": led.peak_live_bytes - base,
                "transient_after": led.transient_bytes,
                "layout": layout_spec(x)})
            rep["digests"][f"reshard_{tag}_{name}"] = digest(blk)
        rep["reshard"][tag] = steps
        rep["values"][f"reshard_{tag}_round_trip"] = \
            digest(x._block()) == src
    os.environ.pop("RAMBA_RESHARD_STAGE_BYTES", None)
    del x, blk

    # sum(a * x + y) over x row-split and y column-split
    m = (LAYOUT_MIXED, LAYOUT_MIXED)
    x = dist_grid(rt, np, m, LAYOUT_SPLITS["rows"], np.float64)
    y = dist_grid(rt, np, m, LAYOUT_SPLITS["cols"], np.float64,
                  (104729, 7919))
    rt.sync()
    n0 = rewrite.stats["rewrite_align_operand_layouts"]
    r0 = registry.get("reshard.completed")
    sent0 = parallel.comm_stats["send_bytes"]

    def mixed():
        t0 = time.perf_counter()
        v = float(rt.sum(2.5 * x + y))
        torch.cuda.synchronize()
        return v, time.perf_counter() - t0

    rep["values"]["mixed_sum"], rep["wall_s"]["mixed"] = win("mixed", mixed)
    rep["values"]["mixed_aligned"] = \
        rewrite.stats["rewrite_align_operand_layouts"] - n0
    rep["values"]["mixed_reshards"] = registry.get("reshard.completed") - r0
    rep["values"]["mixed_sent_bytes"] = \
        parallel.comm_stats["send_bytes"] - sent0
    del x, y
    torch.cuda.empty_cache()

    # the hourly series: groupby on each rank's block
    xs = dist_vec(rt, LAYOUT_SERIES_N)
    rt.sync()
    hour = np.arange(LAYOUT_SERIES_N, dtype=np.int32) % 24
    g = xs.groupby(0, hour, 24)
    ag0 = parallel.comm_stats["allgather_bytes"]
    for kind in GB_KINDS:
        def call(kind=kind):
            t0 = time.perf_counter()
            v = getattr(g, kind)()._value()
            torch.cuda.synchronize()
            return v, time.perf_counter() - t0

        v, rep["wall_s"][f"groupby_{kind}"] = win(f"groupby_{kind}", call)
        rep["digests"][f"groupby_{kind}"] = digest(v)
        if kind == "sum":  # a rerun gives the same bytes
            rep["values"]["groupby_sum_rerun"] = \
                digest(g.sum()._value()) == rep["digests"]["groupby_sum"]
        if rep["rank"] == 0:
            np.save(os.path.join(out, f"groupby_{kind}.npy"), v.cpu().numpy())
    rep["values"]["groupby_allgather_bytes"] = \
        parallel.comm_stats["allgather_bytes"] - ag0
    del xs, g, hour

    # sum(axis=0) and sum(axis=1) on the default 2x2 mesh of ranks
    xa = dist_grid(rt, np, (LAYOUT_AXIS, LAYOUT_AXIS), None, np.float64)
    rt.sync()
    for a in (0, 1):
        def axsum(a=a):
            t0 = time.perf_counter()
            r = rt.sum(xa, axis=a)
            rt.sync()
            torch.cuda.synchronize()
            return r, time.perf_counter() - t0

        r, rep["wall_s"][f"axis{a}"] = win(f"axis{a}", axsum)
        rep["values"][f"axis{a}_layout"] = layout_spec(r)
        v = r._value()
        rep["digests"][f"axis{a}"] = digest(v)
        if rep["rank"] == 0:
            np.save(os.path.join(out, f"axis{a}.npy"), v.cpu().numpy())
    del xa
    rep["gathered_layout"] = fuser.stats["gathered"] - g0
    rep["transient_bytes"] = led.transient_bytes


def layout_check(reps, ref, totals, card, wall, tmp):
    """Hold the layout ranks' reports against the one-process results;
    add their launches to ``totals``; returns the summary."""
    import os

    import numpy as np
    import torch

    from ramba_tpu_torch.common import parse_bytes

    positions = {k: divmod(k, 2) for k in range(4)}  # rank order, 2x2
    for r in reps:
        if r["gathered_layout"] or r["transient_bytes"]:
            raise Fail(f"rank {r['rank']}: {r['gathered_layout']} gathered "
                       f"programs, {r['transient_bytes']} transient bytes")
    want_layout = {"rows": "(('d0', 'd1'),)", "cols": "(None, ('d0', 'd1'))",
                   "divisions": "('d0', 'd1')"}
    for tag, spec in want_layout.items():
        if any(r["values"][f"layout_{tag}"] != spec for r in reps):
            raise Fail(f"layout {tag}: {reps[0]['values'][f'layout_{tag}']}"
                       f" instead of {spec}")
    for name, by_pos in ref["blocks"].items():
        ok = all(reps[k]["digests"][name] == by_pos[positions[k]]
                 for k in range(4))
        if not ok:
            raise Fail(f"layout {name} differs from one process")
    log("  layout: star2 under rows, columns and a 2x2 create_array_with_"
        "divisions, and every reshard step: every rank's block byte-equal "
        "to the one-process result's: True")
    paths = {}
    for tag in ("rows", "cols", "divisions"):
        for r in reps:
            got = r["launches"][f"star2_{tag}"]
            if got["stencil"] != 130:
                raise Fail(f"rank {r['rank']} star2 {tag}: {got}")
        paths[tag] = {k: reps[0]["launches"][f"star2_{tag}"][k]
                      for k in ("tma", "cpasync")}
    slow = {tag: max(r["ms"][f"star2_{tag}"] for r in reps)
            for tag in ("rows", "cols", "divisions")}
    walls = {tag: [max(r["wall_s"][f"star2_{tag}"][i] for r in reps)
                   for i in (0, 1)] for tag in ("rows", "cols", "divisions")}
    log(f"  layout star2 8192^2 f32, ms/sweep by CUDA events, slowest rank: "
        f"{json.dumps(slow)}; walls per sweep (chained, iterate) "
        f"{json.dumps(walls)}; launches per rank by load path "
        f"{json.dumps(paths)} [{card}]")
    # reshard
    summary = {"star2_ms_per_sweep_slowest_rank": slow, "star2_walls_s": walls,
               "star2_paths": paths, "reshard": {}}
    for tag in ("one_stage", "staged"):
        if not all(r["values"][f"reshard_{tag}_round_trip"] for r in reps):
            raise Fail(f"reshard {tag}: the round trip is not byte-identical")
        rows = []
        for i, step in enumerate(reps[0]["reshard"][tag]):
            w = max(r["reshard"][tag][i]["wall_s"] for r in reps)
            sent = sum(r["reshard"][tag][i]["sent_bytes"] for r in reps)
            peak = max(r["reshard"][tag][i]["peak_above_live"] for r in reps)
            slab = LAYOUT_GRID * LAYOUT_GRID * 4 if tag == "one_stage" else \
                parse_bytes(LAYOUT_STAGE)
            bound = step["dst_bytes"] + slab
            if peak > bound or any(r["reshard"][tag][i]["transient_after"]
                                   for r in reps):
                raise Fail(f"reshard {tag} to {step['to']}: peak {peak} "
                           f"above live, bound dst + slab {bound}")
            rows.append({"to": step["to"], "wall_s": w,
                         "crossed_bytes": sent,
                         "gb_per_s": sent / w / 1e9 if w else None,
                         "stages": step["stages"],
                         "peak_transient_bytes": peak,
                         "src_dst_slab_bytes": step["src_bytes"] + bound})
        summary["reshard"][tag] = rows
        log(f"  layout reshard 8192^2 f32 rows -> cols -> 2x2 -> rows "
            f"({tag}): round trip byte-identical on every rank, transient "
            f"bytes back to 0; per step {json.dumps(rows)} [{card}]")
    # the program over two layouts
    want = ref["mixed_sum"]
    got = [r["values"]["mixed_sum"] for r in reps]
    bound = 2 * LAYOUT_MIXED ** 2 * EPS["float64"] * abs(want)
    same = len({repr(g) for g in got}) == 1
    diff = abs(got[0] - want)
    for r in reps:
        lr = r["launches"]["mixed"]
        if lr["elemred"] < 1 or r["values"]["mixed_aligned"] != 1 or \
                r["values"]["mixed_reshards"] != 1:
            raise Fail(f"rank {r['rank']} mixed: launches {lr}, aligned "
                       f"{r['values']['mixed_aligned']}, reshards "
                       f"{r['values']['mixed_reshards']}")
    if not same or diff > bound:
        raise Fail(f"mixed sum {got} vs one process {want!r}")
    mixed_wall = max(r["wall_s"]["mixed"] for r in reps)
    mixed_sent = sum(r["values"]["mixed_sent_bytes"] for r in reps)
    n_er = reps[0]["launches"]["mixed"]["elemred"]
    log(f"  layout sum(2.5 * x + y) 16384^2 f64, x rows, y columns: one "
        f"aligning reshard and elemred ({n_er} launch) on every rank, no "
        f"gathered program: "
        f"{got[0]!r} on every rank vs one process {want!r}, |diff| "
        f"{diff:.3e} <= {bound:.3e} (2 n eps sum|.|); wall {mixed_wall:.4f} "
        f"s, {mixed_sent / 1e9:.3f} GB crossed ranks [{card}]")
    summary["mixed"] = {"wall_s": mixed_wall, "crossed_bytes": mixed_sent,
                        "max_abs_err": diff}
    # groupby
    parts = {"sum": 1, "min": 1, "max": 1, "count": 1, "mean": 2, "var": 3}
    gb = {}
    for kind in GB_KINDS:
        for r in reps:
            lr = r["launches"][f"groupby_{kind}"]
            if lr["segred"] != parts[kind]:
                raise Fail(f"rank {r['rank']} groupby {kind}: {lr}")
        if len({r["digests"][f"groupby_{kind}"] for r in reps}) != 1 or \
                not all(r["values"]["groupby_sum_rerun"] for r in reps):
            raise Fail(f"groupby {kind}: the ranks' bytes differ, or a rerun's")
        got = torch.from_numpy(np.load(os.path.join(tmp, "w4",
                                                    f"groupby_{kind}.npy")))
        want, bnd = ref["groupby"][kind]
        if bnd is None:
            ok = got.numpy().tobytes() == want.numpy().tobytes()
            log(f"  layout groupby {kind} 2^28 f64 G=24: byte-equal to one "
                f"process: {ok}")
            if not ok:
                raise Fail(f"groupby {kind} differs from one process")
        else:
            check_sums(f"layout groupby {kind} 2^28 f64 G=24 across ranks vs "
                       "one process", got, want, bnd, bnd_reason(kind))
        gb[kind] = max(r["wall_s"][f"groupby_{kind}"] for r in reps)
    ag = sum(r["values"]["groupby_allgather_bytes"] for r in reps)
    log(f"  layout groupby walls (s, slowest rank) {json.dumps(gb)}; segred "
        f"launches a rank {json.dumps(parts)}; {ag} bytes all-gathered over "
        f"all ranks for the six; the same bytes on every rank and on a "
        f"rerun; no gathered program [{card}]")
    summary["groupby"] = {"walls_s": gb, "allgather_bytes": ag}
    # axis sums
    ax = {}
    for a in (0, 1):
        if any(r["values"][f"axis{a}_layout"] != ("('d1',)" if a == 0
                                                  else "('d0',)")
               for r in reps):
            raise Fail(f"axis {a}: layout {reps[0]['values']}")
        got = torch.from_numpy(np.load(os.path.join(tmp, "w4",
                                                    f"axis{a}.npy")))
        want = ref["axis"][a]
        check_sums(f"layout sum(axis={a}) 8192^2 f64 on the 2x2 mesh of "
                   "ranks vs one process", got, want,
                   2 * LAYOUT_AXIS * EPS["float64"] * want.abs(),
                   "2 n eps sum|x|, n = 8192")
        ax[a] = max(r["wall_s"][f"axis{a}"] for r in reps)
    log(f"  layout axis sums walls (s, slowest rank) {json.dumps(ax)}, "
        f"results laid out P('d1') and P('d0') as GSPMD lays them out, no "
        f"gathered program [{card}]")
    summary["axis_walls_s"] = ax
    for k in totals:
        totals[k] += sum(c.get(k, 0) for r in reps
                         for c in r["launches"].values())
    summary["ranks_wall_s"] = wall
    return summary


def bnd_reason(kind):
    return {"sum": "segred's depth at n and at n/4, and 4 partials",
            "mean": "n_g eps sum|x_g| / count (the one-process mean is a "
                    "torch masked sum)",
            "var": "3 (n_g + depth) eps (E[x^2] + mean^2)"}[kind]


def layout_refs(rt, torch, np):
    """The one-process results ``layout_path`` holds the ranks against."""
    from ramba_tpu_torch.ops import segred as sg
    from ramba_tpu_torch.parallel import mesh as pm

    st = rt.stencil(star2_body)
    dev = rt.common.device()
    grid2 = pm.Mesh(np.array([dev] * 4, dtype=object).reshape(2, 2),
                    ("d0", "d1"))
    shape = (LAYOUT_GRID, LAYOUT_GRID)
    ref = {"blocks": {}}

    def blocks(name, t, spec):
        sh = pm.NamedSharding(grid2, pm.P(*spec))
        ref["blocks"][name] = {pos: digest(t[idx]) for pos, idx in
                               sh.shard_indices(tuple(t.shape))}

    specs = {"rows": ((("d0", "d1"),)), "cols": (None, ("d0", "d1")),
             "divisions": ("d0", "d1")}
    x = dist_grid(rt, np, shape)
    y = x
    for _ in range(30):
        y = rt.sstencil(st, y)
    yv, xv = y._value(), x._value()
    yi = rt.sstencil_iterate(st, x, 100)._value()
    for tag, spec in specs.items():
        blocks(f"star2_{tag}_chained", yv, spec)
        blocks(f"star2_{tag}_iterate", yi, spec)
        blocks(f"reshard_one_stage_{tag}", xv, spec)
        ref["blocks"][f"reshard_staged_{tag}"] = \
            ref["blocks"][f"reshard_one_stage_{tag}"]
    del x, y, yv, xv, yi
    m = (LAYOUT_MIXED, LAYOUT_MIXED)
    x = dist_grid(rt, np, m, None, np.float64)
    y = dist_grid(rt, np, m, None, np.float64, (104729, 7919))
    ref["mixed_sum"] = float(rt.sum(2.5 * x + y))
    del x, y
    torch.cuda.empty_cache()
    n = LAYOUT_SERIES_N
    xs = dist_vec(rt, n)
    hour = np.arange(n, dtype=np.int32) % 24
    g = xs.groupby(0, hour, 24)
    eps = EPS["float64"]
    res = {k: getattr(g, k)()._value() for k in GB_KINDS}
    s1 = res["sum"]  # every value >= 0: sum|x_g| is the sum
    s2 = (xs * xs).groupby(0, hour, 24).sum()._value()
    cnt = res["count"].double()
    n_g = float(cnt.max())
    d = sg.depth(n) + sg.depth(n // 4) + 4
    mean = s1 / cnt
    ref["groupby"] = {
        "sum": (s1, sum_bound(d, "float64", s1)),
        "min": (res["min"], None), "max": (res["max"], None),
        "count": (res["count"], None),
        "mean": (res["mean"], (n_g + d) * eps * s1 / cnt),
        "var": (res["var"], 3 * (n_g + d) * eps * (s2 / cnt + mean * mean))}
    ref["groupby"] = {k: (v.cpu(), None if b is None else b.cpu())
                      for k, (v, b) in ref["groupby"].items()}
    del xs, g, res, s2
    xa = dist_grid(rt, np, (LAYOUT_AXIS, LAYOUT_AXIS), None, np.float64)
    ref["axis"] = {a: rt.sum(xa, axis=a)._value().cpu() for a in (0, 1)}
    del xa
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return ref


def governor_phase(rt, torch, np, card):
    """One process, a budget that holds one 2 GiB float64 array and not
    two: placing the second spills the cold first one to pinned host
    memory; reading it restores it, byte-equal; ``del`` returns the
    ledger's live bytes to where they started."""
    import os

    from ramba_tpu_torch.core import fuser
    from ramba_tpu_torch.observe import registry
    from ramba_tpu_torch.resilience import memory, spill

    fuser.flush()
    torch.cuda.synchronize()
    led = memory.ledger
    live0 = led.live_bytes
    nbytes = GOVERNOR_N * 8

    def counters():
        return {k: registry.get(k) for k in (
            "memory.evictions", "memory.restores", "memory.live_bytes",
            "memory.spilled_bytes", "memory.governed_puts")}

    host_b = np.ones(GOVERNOR_N)  # the second array comes from the host
    a = rt.arange(GOVERNOR_N) * (1.0 / 3.0)
    rt.sync()
    want = digest(a._value())
    old = os.environ.get("RAMBA_HBM_BUDGET")
    # room under the watermark (0.9 of the budget) for what was live and
    # one and a half arrays: 3 GiB above it for two 2 GiB arrays
    os.environ["RAMBA_HBM_BUDGET"] = str(
        int((live0 + nbytes * 3 // 2) / 0.9) + 1)
    try:
        memory.ledger.snapshot()  # the gauges, now
        before = counters()
        t0 = time.perf_counter()
        freed = memory.reserve_headroom(nbytes, site="governor_phase")
        torch.cuda.synchronize()
        t_spill = time.perf_counter() - t0
        if not isinstance(a._expr.value, spill.SpilledArray) or \
                freed < nbytes:
            raise Fail(f"governor: placing an array beside another under a "
                       f"watermark 1.5 arrays above the live bytes freed "
                       f"{freed} bytes, the first array "
                       f"{type(a._expr.value).__name__}")
        b = rt.fromarray(host_b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back = a._value()
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        memory.ledger.snapshot()
        after = counters()
    finally:
        if old is None:
            os.environ.pop("RAMBA_HBM_BUDGET", None)
        else:
            os.environ["RAMBA_HBM_BUDGET"] = old
    ok = digest(back) == want
    del a, b, back
    back_to = led.live_bytes == live0
    log(f"  governor: spill of {nbytes / 2 ** 30:g} GiB to pinned host "
        f"memory {t_spill:.4f} s "
        f"({nbytes / t_spill / 1e9:.2f} GB/s), restore {t_restore:.4f} s "
        f"({nbytes / t_restore / 1e9:.2f} GB/s), restored array byte-equal "
        f"{ok}, live bytes back to {live0} after del {back_to}; memory.* "
        f"before {json.dumps(before)} after {json.dumps(after)} [{card}]")
    if not ok or not back_to or after["memory.evictions"] - \
            before["memory.evictions"] < 1 or after["memory.restores"] - \
            before["memory.restores"] != 1:
        raise Fail("governor phase")
    return {"spill_s": t_spill, "spill_gb_per_s": nbytes / t_spill / 1e9,
            "restore_s": t_restore,
            "restore_gb_per_s": nbytes / t_restore / 1e9,
            "counters_before": before, "counters_after": after}


def layout_path(rt, torch, np, card, totals):
    """Layouts chosen and changed across ranks: 4 ranks of this script
    (``--rank ... --layout``) on cuda:0, the default 2x2 mesh of ranks,
    gloo through pinned host buffers; every result held against the
    one-process result computed here first.  Then the governor phase in
    this process."""
    import os
    import tempfile

    log(f"  layout_path: {DIST_RANKS} ranks on cuda:0, layouts by "
        "distribution= and create_array_with_divisions, reshard, a program "
        "over two layouts, groupby and axis sums on the blocks")
    t0 = time.perf_counter()
    ref = layout_refs(rt, torch, np)
    log(f"  layout_path: one-process references in "
        f"{time.perf_counter() - t0:.1f} s [{card}]")
    with tempfile.TemporaryDirectory(prefix="ramba_layout_") as tmp:
        os.makedirs(os.path.join(tmp, f"w{DIST_RANKS}"))
        t0 = time.perf_counter()
        env = {k: v for k, v in os.environ.items()
               if k not in ("RAMBA_HBM_BUDGET", "RAMBA_RESHARD_STAGE_BYTES")}
        ranks = dist_start(DIST_RANKS, tmp, ("--layout",), env)
        try:
            reps = dist_wait(ranks, tmp, time.time() + DIST_LIMIT_S)
            summary = layout_check(reps, ref, totals, card,
                                   time.perf_counter() - t0, tmp)
        finally:
            for p in ranks:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    log(f"  layout_path: {DIST_RANKS} ranks started, run and checked in "
        f"{summary['ranks_wall_s']:.1f} s [{card}]")
    summary["governor"] = governor_phase(rt, torch, np, card)
    return summary


# compile_path's sizes: the pair's and the race's programs (2^28 float64,
# the hourly series G=24), the bucketed program (float32, pow2 bucket
# 2^25), the soaks, the segmented chain (500 pairs y * a + b over 2^27
# float64), the race's samples per backend, a child's time limit
COMPILE_N = 1 << 28
COMPILE_BUCKET_N = 3 * 10 ** 7
SOAK_FLUSHES = 240
SOAK_LENGTHS = (1 << 20, 1 << 26)
SEG_N = 1 << 27
SEG_PAIRS = 500
RACE_K = 3
COMPILE_CHILD_LIMIT_S = 300


def seg_chain(base):
    """500 pairs ``y = y * a + b`` with non-dyadic float64 constants: 1000
    instructions of arithmetic only, so every segmentation and either
    lowering gives the same bytes (the kernels build with --fmad=false)."""
    y = base
    for i in range(SEG_PAIRS):
        y = y * (1.0 + (i % 13 + 1) / 3e7) + (i % 11 + 1) / 7e9
    return y


def segment_plans(er, x):
    """The elemred plans of the chain's segments at 64 instructions (the
    first, the middle ones and the last differ), over tiny leaves."""
    import torch
    from ramba_tpu_torch.core import fuser

    p, vals = fuser.prepare_program([seg_chain(x)._expr])
    carried = torch.zeros_like(x._value())
    return [er.plan_for(seg, [vals[s] if s < p.n_leaves else carried
                              for s in ins])
            for seg, ins, _o, _t in fuser._iter_segments(
                p, fuser._last_use_map(p), 64)]


def race_programs(rt, torch, np):
    """The race's three programs, their data made from indices and a seed
    (a second process makes the same programs: the same fingerprints)."""
    n = COMPILE_N
    base = rt.arange(n) / 1000.0
    x = rt.sin(rt.arange(n) * 1e-3)
    y = rt.cos(rt.arange(n) * 1e-3)
    rt.sync()
    x_t, hour = hourly_series(torch, np, n)
    g = rt.fromarray(x_t).groupby(0, hour, num_groups=24)

    def chain():
        B, C = rt.sin(base), rt.cos(base)
        D = B * B + C * C
        del B, C
        s = rt.sum(D)
        return D._value(), s._value()

    def axpy():
        z = 2.5 * x + y
        s = rt.sum(z)
        return z._value(), s._value()

    def gsum():
        return (g.sum()._value(),)

    return {"sin/cos chain n=2^28 f64": chain,
            "axpy + sum n=2^28 f64": axpy,
            "groupby hourly sum n=2^28 f64 G=24": gsum}, \
        {"base": base, "x": x, "y": y, "x_t": x_t, "hour": hour}


def compile_child(argv) -> int:
    """One process of ``compile_path``: ``cold`` or ``warm`` runs the
    pair's three programs on the RAMBA_CACHE it was given; ``race2`` runs the race's programs once
    each on the RAMBA_AUTOTUNE_CACHE it was given.  Prints one JSON line."""
    import numpy as np
    import torch

    import ramba_tpu_torch as rt
    from ramba_tpu_torch import _build
    from ramba_tpu_torch.compile import classes, persist
    from ramba_tpu_torch.core import autotune
    from ramba_tpu_torch.observe import events, ledger, registry
    from ramba_tpu_torch.ops import elemred as er
    from ramba_tpu_torch.ops import segred as sg

    phase = argv[argv.index("--compile-child") + 1]
    rt.set_device("cuda:0")
    er.launches = sg.launches = 0
    out = {"phase": phase}
    if phase == "race2":
        if autotune.mode() != "race":
            raise Fail("the race child runs without RAMBA_AUTOTUNE=race")
        progs, _data = race_programs(rt, torch, np)
        out["programs"] = {}
        for name, fn in progs.items():
            e0, s0 = er.launches, sg.launches
            fn()
            span = events.last(1, type="flush")[-1]
            out["programs"][name] = {
                "fingerprint": span["fingerprint"],
                "backend": span["calls"][-1]["backend"],
                "elemred": er.launches - e0, "segred": sg.launches - s0}
        out["race_started"] = registry.get("autotune.race_started")
        out["race_skipped"] = registry.get("autotune.race_skipped")
        out["decisions"] = autotune.report()["decisions"]
    else:
        if not (persist.armed() and classes.enabled()):
            raise Fail(f"compile child {phase}: cache or classes not armed")
        n = COMPILE_N
        src0 = ledger.totals()["by_source"]
        per = out["programs"] = {}

        def ready(name):
            """Seconds by source each program's first call paid."""
            nonlocal src0
            src = ledger.totals()["by_source"]
            per[name] = {k: src[k] - src0[k] for k in src}
            src0 = src

        base = rt.arange(n) / 1000.0
        rt.sync()  # materialised: elemred takes the chain over it
        ready("arange / 1000 (generic lowering)")
        B, C = rt.sin(base), rt.cos(base)
        D = B * B + C * C
        del B, C
        s = rt.sum(D)
        sv = float(s)
        out["first_result_s"] = time.perf_counter() - T_START
        ready("elemred: sin/cos chain f64")
        dig = {"chain_D": card_digest(D._value()), "chain_sum": sv.hex()}
        del base, D, s
        x_t, hour = hourly_series(torch, np, n)
        g = rt.fromarray(x_t).groupby(0, hour, num_groups=24)
        dig["groupby_sum"] = card_digest(g.sum()._value())
        ready("segred: hourly sum f64")
        del g, x_t
        gen = torch.Generator(device="cuda")
        gen.manual_seed(14)
        xb = rt.fromarray(torch.rand(COMPILE_BUCKET_N, generator=gen,
                                     device="cuda", dtype=torch.float32))
        p0 = classes.snapshot()["padded"]
        dig["x2p1"] = card_digest((xb * 2.0 + 1.0)._value())
        ready("elemred: x * 2 + 1 f32, 3e7 (exact under pow2)")
        out["padded"] = classes.snapshot()["padded"] - p0
        out["classes"] = sorted({str(t) for t in classes.decisions().values()
                                 if t is not None})
        torch.cuda.synchronize()
        out["wall_s"] = time.perf_counter() - T_START
        t = ledger.totals()
        snap = persist.snapshot()
        out.update(digests=dig, nvcc_builds=_build.nvcc_builds,
                   disk_loads=_build.disk_loads, compiles=t["compiles"],
                   compile_s=t["compile_s"], by_source=t["by_source"],
                   persist_hits=snap["hits"],
                   persist_corrupt=snap["corrupt"])
    out["launches"] = {"elemred": er.launches, "segred": sg.launches}
    print(json.dumps(out), flush=True)
    return 0


def run_compile_child(phase, env):
    """One child of this script (``--compile-child phase``), waited for
    within its limit (killed past it); its JSON report."""
    try:
        p = subprocess.run([sys.executable, __file__, "--compile-child",
                            phase], env=env, capture_output=True, text=True,
                           timeout=COMPILE_CHILD_LIMIT_S)
    except subprocess.TimeoutExpired:
        raise Fail(f"compile child {phase} ran past "
                   f"{COMPILE_CHILD_LIMIT_S} s") from None
    if p.returncode != 0:
        raise Fail(f"compile child {phase} exited {p.returncode}:\n"
                   f"{p.stderr[-3000:]}")
    return json.loads(p.stdout.strip().splitlines()[-1])


def _child_env(**extra):
    import os

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("RAMBA_AUTOTUNE", "RAMBA_CACHE",
                                "RAMBA_COMPILE_CLASSES", "RAMBA_FAULTS",
                                "RAMBA_PERF"))}
    env.update(extra)
    return env


def compile_pair(tmp, card, totals):
    """(a) A cold and a warm process on one fresh RAMBA_CACHE, pow2."""
    import os

    env = _child_env(RAMBA_CACHE=os.path.join(tmp, "cache"),
                     RAMBA_COMPILE_CLASSES="pow2")
    reps = {}
    for phase in ("cold", "warm"):
        r = reps[phase] = run_compile_child(phase, env)
        for k in ("elemred", "segred"):
            totals[k] += r["launches"][k]
        src = {k: round(v, 4) for k, v in r["by_source"].items()}
        log(f"  compile_path {phase} process: first result "
            f"{r['first_result_s']:.2f} s after start, all three "
            f"{r['wall_s']:.2f} s; nvcc builds {r['nvcc_builds']}, libraries "
            f"loaded from disk {r['disk_loads']}; ledger compiles "
            f"{r['compiles']} ({r['compile_s']:.4f} s), seconds by source "
            f"{src}; persist hits {r['persist_hits']}; classes "
            f"{r['classes']}; launches {r['launches']} [{card}]")
        for name, src in r["programs"].items():
            log(f"  compile_path {phase} process, {name}: first call's "
                f"seconds by source {({k: round(v, 4) for k, v in src.items()})}"
                f" [{card}]")
        if not all(r["launches"].values()):
            raise Fail(f"compile_path {phase}: elemred or segred not launched")
        if r["padded"] != 0 or r["classes"]:
            raise Fail(f"compile_path {phase}: a program the kernels take "
                       f"was bucketed ({r['classes']})")
    cold, warm = reps["cold"], reps["warm"]
    if cold["nvcc_builds"] < 3:
        raise Fail(f"the cold process built {cold['nvcc_builds']} sources, "
                   "expected the three kernels'")
    if warm["nvcc_builds"] != 0 or warm["persist_hits"] < 3:
        raise Fail(f"the warm process built {warm['nvcc_builds']} sources "
                   f"and loaded {warm['persist_hits']} libraries from the "
                   "cache (want 0, >= 3)")
    if warm["by_source"]["nvcc"] != 0 or warm["persist_corrupt"] != 0:
        raise Fail("the warm process paid nvcc seconds or found a corrupt "
                   "library")
    if warm["digests"] != cold["digests"]:
        raise Fail(f"warm results differ from cold: {warm['digests']} vs "
                   f"{cold['digests']}")
    log(f"  compile_path warm vs cold: results byte-equal (checksums on "
        f"the card of the chain and the hourly sums and x * 2 + 1, the "
        f"chain's sum's bits); first "
        f"result {warm['first_result_s']:.2f} s against "
        f"{cold['first_result_s']:.2f} s [{card}]")
    return {k: {key: r[key] for key in (
        "first_result_s", "wall_s", "nvcc_builds", "disk_loads", "compiles",
        "compile_s", "by_source", "persist_hits", "programs")}
        for k, r in reps.items()}


def _soak(rt, torch, np, classes, registry, er, name, bases, exact, draws):
    """``draws`` flushes of ``x * 2 + 1`` over ``bases`` under the current
    compile-class policy, each byte-equal to the exact-shape result; the
    soak's numbers."""
    h0, m0 = registry.get("fuser.cache_hit"), registry.get("fuser.cache_miss")
    pad0 = dict(classes.stats)
    e0, p0 = er.launches, len(er._plans)
    walls = []
    for k in draws:
        t0 = time.perf_counter()
        v = (rt.fromarray(bases[k]) * 2.0 + 1.0)._value()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if not bytes_equal(v, exact[k]):
            raise Fail(f"{name}: a result differs from the exact shape's")
    hits = registry.get("fuser.cache_hit") - h0
    misses = registry.get("fuser.cache_miss") - m0
    pad = classes.stats["pad_bytes"] - pad0["pad_bytes"]
    leaf = classes.stats["leaf_bytes"] - pad0["leaf_bytes"]
    return {"flushes": len(walls), "compile_hit_rate": hits / (hits + misses),
            "pad_waste_frac": pad / leaf if leaf else 0.0,
            "p95_flush_ms": float(np.percentile(walls, 95)) * 1e3,
            "p50_flush_ms": float(np.percentile(walls, 50)) * 1e3,
            "total_ms": float(sum(walls)) * 1e3,
            "elemred_launches": er.launches - e0,
            "plans_built": len(er._plans) - p0}


def _fresh_plans(er):
    """Drop the compile cache and elemred's plans, so a soak starts from
    the plans a fresh process has (the libraries stay loaded)."""
    from ramba_tpu_torch.core import fuser

    with fuser._cache_lock:
        fuser._compile_cache.clear()
    with er._lock:
        er._plans.clear()


def compile_soak(rt, er, torch, np, card, window):
    """(b) The shape soaks: ramba_tpu's traffic (32 row counts in 1..300
    of 256 float32 columns, the generic lowering), then the same at the
    card's width (32 lengths in 2^20..2^26, float32, on elemred); the
    same 240 flushes from each working set with compile classes off and
    under pow2, in turns (off, pow2, pow2, off), each run from fresh
    plans.  On elemred the pow2 turns bucket the kernel's programs, which
    the port does not (``fuser._kernel_takes``: the comparison is why);
    a last pow2 run shows the port's policy, exact shapes."""
    import os

    from ramba_tpu_torch.compile import classes
    from ramba_tpu_torch.core import fuser
    from ramba_tpu_torch.observe import registry

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1400)
    rows = np.random.default_rng(14).integers(1, 301, size=32)
    lens = np.random.default_rng(14).integers(*SOAK_LENGTHS, size=32)
    sets = {
        "soak rows 1..300 x 256 f32 (generic lowering)":
            [torch.rand((int(r), 256), generator=gen, device="cuda")
             for r in rows],
        "soak lengths 2^20..2^26 f32 (elemred)":
            [torch.rand(int(m), generator=gen, device="cuda") for m in lens],
    }
    draws = np.random.default_rng(1400).integers(0, 32, size=SOAK_FLUSHES)
    saved = os.environ.get("RAMBA_COMPILE_CLASSES")
    kernel_takes = fuser._kernel_takes
    out = {}
    try:
        for name, bases in sets.items():
            on_kernel = "elemred" in name
            os.environ["RAMBA_COMPILE_CLASSES"] = "off"
            classes.reset()
            exact = [(rt.fromarray(b) * 2.0 + 1.0)._value() for b in bases]
            need = {"elemred": SOAK_FLUSHES} if on_kernel else {"elemred": 0}
            turns = ["off", "pow2", "pow2", "off"]
            if on_kernel:
                turns = ["off", "pow2 bucketed", "pow2 bucketed", "off",
                         "pow2"]
            runs = out[name] = {t: [] for t in turns}
            for turn in turns:
                os.environ["RAMBA_COMPILE_CLASSES"] = turn.split()[0]
                classes.reset()
                _fresh_plans(er)
                if turn == "pow2 bucketed":
                    fuser._kernel_takes = lambda *a: False
                try:
                    r = window(f"{name}, classes {turn}", lambda: _soak(
                        rt, torch, np, classes, registry, er, name, bases,
                        exact, draws), need)
                finally:
                    fuser._kernel_takes = kernel_takes
                runs[turn].append(r)
                log(f"  compile_path {name}, classes {turn}: "
                    f"{r['flushes']} flushes, compile hit rate "
                    f"{r['compile_hit_rate']:.4f}, pad waste "
                    f"{r['pad_waste_frac']:.4f}, flush p50 "
                    f"{r['p50_flush_ms']:.4f} ms p95 {r['p95_flush_ms']:.4f} "
                    f"ms, all {r['total_ms']:.2f} ms, elemred launches "
                    f"{r['elemred_launches']}, plans built "
                    f"{r['plans_built']}; every result byte-equal to the "
                    f"exact shape's [{card}]")
            if on_kernel and runs["pow2"][0]["pad_waste_frac"] != 0.0:
                raise Fail("pow2 bucketed a program the kernels take")
            del exact
    finally:
        fuser._kernel_takes = kernel_takes
        if saved is None:
            os.environ.pop("RAMBA_COMPILE_CLASSES", None)
        else:
            os.environ["RAMBA_COMPILE_CLASSES"] = saved
        classes.reset()
    del sets
    torch.cuda.empty_cache()
    return out


def compile_segments(rt, er, torch, np, card, window):
    """(c) The 1000-instruction chain over 2^27 float64 at segment sizes
    0, 384 and 64: the iterator's counts, one elemred launch a segment at
    64, the same bytes at every size."""
    from ramba_tpu_torch import common
    from ramba_tpu_torch.core import fuser

    base = rt.arange(SEG_N) / 3.0
    rt.sync()
    old = common.max_program_instrs
    res, out = {}, {}
    try:
        for size, segs in ((0, 0), (384, 3), (64, 16)):
            common.max_program_instrs = size

            def run():
                s0 = fuser.stats["segments"]
                t0 = time.perf_counter()
                v = seg_chain(base)._value()
                torch.cuda.synchronize()
                return time.perf_counter() - t0, fuser.stats["segments"] - s0, v

            wall, got, v = window(f"segmented chain at {size}", run,
                                  {"elemred": 16 if size == 64 else 0})
            if got != segs:
                raise Fail(f"the chain at {size} ran {got} segments, the "
                           f"iterator gives {segs}")
            res[size] = v
            out[size] = {"segments": got, "wall_s": wall}
            log(f"  compile_path chain of 1000 instructions over 2^27 f64, "
                f"max_program_instrs={size}: {got} segments, {wall:.4f} s "
                f"[{card}]")
    finally:
        common.max_program_instrs = old
    if not (bytes_equal(res[0], res[384]) and bytes_equal(res[0], res[64])):
        raise Fail("the segmented chain's bytes depend on the segment size")
    log("  compile_path chain: the runs at 0, 384 and 64 byte-equal")
    del base, res
    torch.cuda.empty_cache()
    return out


def compile_race(rt, er, sg, torch, np, card, window, totals, tmp):
    """(d) RAMBA_AUTOTUNE=race, K=3: the sin/cos chain and axpy + sum at
    2^28 float64 and the hourly groupby sum; every sample held against the
    plain version, both backends' p50 (CUDA events), the latched winner;
    then a second process given the written table."""
    import os

    from ramba_tpu_torch.core import autotune
    from ramba_tpu_torch.observe import events, ledger

    table = os.path.join(tmp, "autotune.json")
    progs, data = race_programs(rt, torch, np)
    n = COMPILE_N
    # the plain versions: vectors, sums, and the sums' bounds
    b_t = data["base"]._value()
    D = torch.sin(b_t) * torch.sin(b_t) + torch.cos(b_t) * torch.cos(b_t)
    z = 2.5 * data["x"]._value() + data["y"]._value()
    hour_t = torch.from_numpy(data["hour"]).cuda()
    xg = data["x_t"]
    groups = [xg[hour_t == k] for k in range(24)]
    want = {
        "sin/cos chain n=2^28 f64": (D, D.sum(), sum_bound(
            er.depth(n) + 1, "float64", float(D.abs().sum()))),
        "axpy + sum n=2^28 f64": (z, z.sum(), sum_bound(
            er.depth(n) + 1, "float64", float(z.abs().sum()))),
        "groupby hourly sum n=2^28 f64 G=24": (None, torch.stack(
            [v.sum() for v in groups]), sum_bound(sg.depth(n), "float64",
                                                  torch.stack([v.abs().sum()
                                                               for v in groups]))),
    }
    del D, z, groups, b_t, hour_t, xg
    autotune.reconfigure(mode="race", k=RACE_K, cache_path=table)
    out = {}
    try:
        for name, fn in progs.items():
            vec, sums, bound = want[name]
            bound = torch.as_tensor(bound, dtype=torch.float64,
                                    device=sums.device)
            fam = "segred" if "groupby" in name else "elemred"

            def race():
                worst, runs = 0.0, 0
                while runs < 4 * RACE_K:
                    got = fn()
                    span = events.last(1, type="flush")[-1]
                    runs += 1
                    for g in got:
                        if g.ndim == 1 and vec is not None:
                            excess = (g - vec).abs() - 1e-12 * (1 + vec.abs())
                            if float(excess.max()) > 0:
                                raise Fail(f"race {name}: a vector output "
                                           "left rtol 1e-12 of the plain "
                                           "version")
                            continue
                        e = (g.double() - sums.double()).abs()
                        worst = max(worst, float((e / bound).max()))
                        if bool((e > bound).any()):
                            raise Fail(f"race {name}: a sample left the sum "
                                       "bound of the plain version")
                    fp = span["fingerprint"]
                    if autotune.decision(fp) is not None:
                        return fp, runs, worst
                raise Fail(f"race {name}: nothing latched in {runs} runs")

            fp, runs, worst = window(f"race {name}", race, {fam: None})
            st = ledger.backend_stats(fp)
            d = autotune.decision(fp)
            out[name] = {"fingerprint": fp, "runs": runs, "winner":
                         d["backend"], "kernel_p50_ms": st["kernel"]["p50_s"]
                         * 1e3, "torch_p50_ms": st["torch"]["p50_s"] * 1e3,
                         "samples": {b: st[b]["count"] for b in st}}
            log(f"  compile_path race {name}: kernel p50 "
                f"{out[name]['kernel_p50_ms']:.4f} ms, torch p50 "
                f"{out[name]['torch_p50_ms']:.4f} ms (CUDA events, "
                f"{out[name]['samples']} samples), latched "
                f"{d['backend']} after {runs} runs; every sample within "
                f"rtol 1e-12 (vectors) and the sum bound (2*depth*eps*sum|x|) "
                f"of the plain version (largest err/bound {worst:.4f}) "
                f"[{card}]")
    finally:
        autotune.reconfigure(mode="off", cache_path="")
    del progs, data, want
    torch.cuda.empty_cache()
    r = run_compile_child("race2", _child_env(
        RAMBA_AUTOTUNE="race", RAMBA_AUTOTUNE_K=str(RACE_K),
        RAMBA_AUTOTUNE_CACHE=table))
    for k in ("elemred", "segred"):
        totals[k] += r["launches"][k]
    log(f"  compile_path second process on the table: race_started "
        f"{r['race_started']}, race_skipped {r['race_skipped']}; "
        f"{json.dumps(r['programs'])} [{card}]")
    if r["race_started"] != 0 or r["race_skipped"] < 3:
        raise Fail("the second process raced again")
    for name, p in r["programs"].items():
        win = out[name]["winner"]
        fam = "segred" if "groupby" in name else "elemred"
        if p["fingerprint"] != out[name]["fingerprint"] \
                or p["backend"] != win or (p[fam] > 0) != (win == "kernel"):
            raise Fail(f"the second process ran {name} on {p['backend']} "
                       f"({fam} {p[fam]}), the latched backend is {win}")
    out["second_process"] = {k: r[k] for k in ("race_started",
                                               "race_skipped")}
    return out


def compile_path(rt, er, sg, torch, np, card, window, totals):
    """Compile and caching: (a) a cold and a warm process on one
    RAMBA_CACHE, (b) the shape soaks under pow2, (c) segmentation, (d) the
    backend race and a second process on its table."""
    import tempfile

    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="ramba_compile_") as tmp:
        out["pair"] = compile_pair(tmp, card, totals)
        out["soak"] = compile_soak(rt, er, torch, np, card, window)
        out["segments"] = compile_segments(rt, er, torch, np, card, window)
        out["race"] = compile_race(rt, er, sg, torch, np, card, window,
                                   totals, tmp)
    out["wall_s"] = time.perf_counter() - t0
    log(f"  compile_path: {out['wall_s']:.1f} s [{card}]")
    return out


ANALYZE_N = 1 << 28               # the elementwise programs and the series
ANALYZE_SEG_N = 1 << 27           # the 1000-instruction chain
ANALYZE_GRID = 8192               # star2, float32 (TMA)
ANALYZE_ODD = (4099, 4133)        # star2, float32 (cp.async)
ANALYZE_SWEEPS = ((30, 100), (10, 20))  # (chained, iterate) per grid
ANALYZE_MESH_SWEEPS = (10, 20)    # on the 2x2 mesh of shards
ANALYZE_REPEATS = 100             # repeat flushes under each setting
ANALYZE_SMALL_N = 1 << 20         # the host-bound elementwise program
ANALYZE_DRAW_N = 1 << 24          # the seeded draws, float64
ANALYZE_SPILL_N = 1 << 24         # the cached entry the governor spills
ANALYZE_SWITCHES = ("RAMBA_VERIFY", "RAMBA_VERIFY_RULES", "RAMBA_VERIFY_SKIP",
                    "RAMBA_MEMO", "RAMBA_MEMO_BUDGET", "RAMBA_PLANCERT",
                    "RAMBA_COMPILE_CLASSES")


class _Env:
    """Set the analysis switches for a block (None: unset), and restore
    them after it."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        import os

        self.saved = {k: os.environ.get(k) for k in ANALYZE_SWITCHES}
        for k in ANALYZE_SWITCHES:
            v = self.values.get(k)
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return self

    def __exit__(self, *exc):
        import os

        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _launch_counts(er, sk, sg, sc):
    return {"elemred": er.launches, "stencil": sk.launches,
            "segred": sg.launches, "scan": sc.launches}


def _p(vals, q):
    import statistics

    if not vals:
        return None
    if q == 50:
        return statistics.median(vals)
    s = sorted(vals)
    return s[min(len(s) - 1, int(round(q / 100 * (len(s) - 1))))]


def analyze_programs(rt, torch, np, star2, seg_chain_fn):
    """The verified main path: (name, run) pairs; ``run()`` returns the
    program's results as card tensors."""
    from ramba_tpu_torch import common
    from ramba_tpu_torch.parallel import mesh as pm

    n = ANALYZE_N
    base = rt.arange(n) / 1000.0
    x = rt.sin(rt.arange(n) * 1e-3)
    y = rt.cos(rt.arange(n) * 1e-3)
    rt.sync()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    grids = {shape: rt.fromarray(torch.rand(shape, generator=gen,
                                            device="cuda"))
             for shape in ((ANALYZE_GRID, ANALYZE_GRID), ANALYZE_ODD)}
    x_t, hour = hourly_series(torch, np, n, seed=3)
    g = rt.fromarray(x_t).groupby(0, hour, num_groups=24)
    del x_t
    seg_base = rt.arange(ANALYZE_SEG_N) / 3.0
    rt.sync()

    def chain():
        B = rt.sin(base)
        C = rt.cos(base)
        D = B * B + C * C
        del B, C
        s = rt.sum(D)
        return [D._value(), s._value()]

    def axpy():
        z = 2.5 * x + y
        s = rt.sum(z)
        return [z._value(), s._value()]

    def stencil(shape, chained, iters):
        def run():
            a = grids[shape]
            for _ in range(chained):
                a = rt.sstencil(star2, a)
            return [a._value(),
                    rt.sstencil_iterate(star2, grids[shape], iters)._value()]
        return run

    def groupby():
        out = []
        for kind in ("sum", "min", "max", "count"):
            out.append(getattr(g, kind)()._value())  # one flush each
        return out

    def segments():
        old = common.max_program_instrs
        common.max_program_instrs = 64
        try:
            return [seg_chain_fn(seg_base)._value()]
        finally:
            common.max_program_instrs = old

    def on_mesh():
        one = pm.get_mesh()
        grid = pm.Mesh(np.array([common.device()] * 4,
                                dtype=object).reshape(2, 2), ("d0", "d1"))
        chained, iters = ANALYZE_MESH_SWEEPS
        pm.set_mesh(grid)
        try:
            a = grids[(ANALYZE_GRID, ANALYZE_GRID)]
            for _ in range(chained):
                a = rt.sstencil(star2, a)
            return [a._value(), rt.sstencil_iterate(
                star2, grids[(ANALYZE_GRID, ANALYZE_GRID)], iters)._value()]
        finally:
            pm.set_mesh(one)

    (c1, i1), (c2, i2) = ANALYZE_SWEEPS
    progs = [
        ("sin/cos chain over base n=2^28 f64", chain),
        ("axpy + sum n=2^28 f64", axpy),
        (f"star2 {ANALYZE_GRID}^2 f32 {c1} sstencil + {i1} iterate",
         stencil((ANALYZE_GRID, ANALYZE_GRID), c1, i1)),
        (f"star2 {ANALYZE_ODD[0]}x{ANALYZE_ODD[1]} f32 {c2} sstencil + {i2} "
         "iterate", stencil(ANALYZE_ODD, c2, i2)),
        ("groupby hourly sum/min/max/count n=2^28 f64 G=24", groupby),
        ("500 x (y * a + b) n=2^27 f64 at segment size 64", segments),
        (f"star2 {ANALYZE_GRID}^2 on the 2x2 mesh of shards "
         f"{ANALYZE_MESH_SWEEPS[0]} sstencil + {ANALYZE_MESH_SWEEPS[1]} "
         "iterate", on_mesh),
    ]
    return progs, (base, x, y, grids, g, seg_base)


def analyze_verified(rt, er, sk, sg, sc, torch, np, card, window, star2):
    """(1) The main path with RAMBA_VERIFY unset and strict: no error
    finding, the same bytes, the same launches; the verify stage's host
    time per flush."""
    from ramba_tpu_torch.observe import events, registry

    progs, keep = analyze_programs(rt, torch, np, star2, seg_chain)
    stages = []

    def tap(ev):
        if ev.get("type") == "flush" and "verify" in ev.get("stages", {}):
            stages.append(ev["stages"]["verify"])

    out = {}
    events.add_tap(tap)
    try:
        for name, run in progs:
            with _Env():
                plain = window(f"{name} (verify unset)", run, {})
                want = _launch_counts(er, sk, sg, sc)
            e0 = registry.get("analyze.findings.error")
            del stages[:]
            with _Env(RAMBA_VERIFY="strict"):
                got = window(f"{name} (RAMBA_VERIFY=strict)", run, want)
            if registry.get("analyze.findings.error") != e0:
                raise Fail(f"{name}: error findings under strict")
            if len(got) != len(plain) or not all(
                    bytes_equal(a, b) for a, b in zip(got, plain)):
                raise Fail(f"{name}: strict's bytes differ from verify "
                           "unset's")
            p50 = 1e6 * _p(stages, 50)
            log(f"  analyze_path verified {name}: byte-equal to verify "
                f"unset, launches {want} under both, {len(stages)} verified "
                f"flushes, verify stage p50 {p50:.1f} us/flush [{card}]")
            out[name] = {"launches": want, "flushes": len(stages),
                         "verify_p50_us": p50}
            del plain, got
    finally:
        events.remove_tap(tap)
    del keep
    torch.cuda.empty_cache()
    return out


def analyze_memo(rt, torch, card, window):
    """(2) RAMBA_MEMO=1: hits over the same buffers, misses over fresh
    ones, after an in-place write (directly and through a view), for a new
    seed; a result over the budget is not retained; a spilled entry
    restores byte-equal."""
    from ramba_tpu_torch.core import memo
    from ramba_tpu_torch.resilience import memory

    n = ANALYZE_N
    out = {}
    x_t = torch.sin(torch.arange(n, device="cuda", dtype=torch.float64)
                    * 1e-3)
    y_t = torch.cos(torch.arange(n, device="cuda", dtype=torch.float64)
                    * 1e-3)
    x, y = rt.fromarray(x_t), rt.fromarray(y_t)
    with _Env(RAMBA_MEMO="1"):
        walls = []

        def ten_same():
            vals = []
            for _ in range(10):
                t0 = time.perf_counter()
                vals.append(rt.sum(2.5 * x + y)._value())
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            return vals

        h0, m0 = memo.cache.hits, memo.cache.misses
        vals = window("memo: ten axpy + sum over the same buffers", ten_same,
                      {"elemred": 1})
        hits = memo.cache.hits - h0
        if hits != 9 or not all(bytes_equal(v, vals[0]) for v in vals):
            raise Fail(f"memo: {hits} hits of 9 over the same buffers")
        out["same"] = {"hits": hits, "misses": memo.cache.misses - m0,
                       "launch_wall_s": walls[0],
                       "hit_wall_s": _p(walls[1:], 50)}

        def ten_fresh():
            res = []
            for _ in range(10):
                xf = rt.fromarray(x_t.clone())
                res.append(rt.sum(2.5 * xf + y)._value())
                del xf
            return res

        h0 = memo.cache.hits
        fresh = window("memo: ten axpy + sum over fresh buffers", ten_fresh,
                       {"elemred": 10})
        if memo.cache.hits != h0 or not all(bytes_equal(v, vals[0])
                                            for v in fresh):
            raise Fail("memo: a fresh buffer hit, or its value differs")
        log(f"  analyze_path memo: same buffers {hits} hits, "
            f"{out['same']['misses']} miss, 1 launch "
            f"(launch {1e3 * walls[0]:.3f} ms, hit p50 "
            f"{1e6 * out['same']['hit_wall_s']:.1f} us wall), fresh buffers "
            f"10 launches, 0 hits [{card}]")

        # an adopted tensor written in place, directly and through a view
        t = torch.arange(n, device="cuda", dtype=torch.float64)
        a = rt.fromarray(t)
        if a._expr.value is not t:
            raise Fail("fromarray copied a tensor it should adopt")

        def mutations():
            res = []
            for step in ("first", "again", "add_", "view mul_"):
                if step == "add_":
                    t.add_(1)
                elif step == "view mul_":
                    t[:1024].mul_(2)
                h = memo.cache.hits
                got = rt.sum(2.5 * a + y)._value()
                want = (2.5 * t + y_t).sum()
                res.append((step, memo.cache.hits - h, got, want))
            return res

        res = window("memo: an adopted tensor written in place", mutations,
                     {"elemred": 3})
        for step, hit, got, want in res:
            if hit != (1 if step == "again" else 0):
                raise Fail(f"memo: {step}: {hit} hits")
            check_close(f"memo: sum(2.5 * t + y) after {step}", got, want,
                        ANALYZE_N * EPS["float64"], "two sums of 2^28 "
                        "float64 in different orders")
        log(f"  analyze_path memo: in-place add_ and a view's mul_ each "
            f"missed and gave the new value [{card}]")
        del a, t

        # the same seeded draw hits, a new seed misses
        def draw(seed):
            rt.random.seed(seed)
            return (rt.random.normal(size=(ANALYZE_DRAW_N,)) * 1.0)._value()

        h0 = memo.cache.hits
        d1, d2, d3 = draw(5), draw(5), draw(6)
        if memo.cache.hits - h0 != 1 or not bytes_equal(d1, d2) \
                or bytes_equal(d1, d3):
            raise Fail("memo: the seeded draw's hits are wrong")
        del d1, d2, d3

        # a 2 GiB result under the default 256m budget
        o0 = memo.cache.oversize
        big = (x * x)._value()
        if memo.cache.oversize != o0 + 1:
            raise Fail("memo: a 2 GiB result was retained under 256m")
        del big

        # a cached entry the governor spilled restores byte-equal
        s_t = torch.rand(ANALYZE_SPILL_N, device="cuda", dtype=torch.float64)
        s = rt.fromarray(s_t)
        first = (s * s)._value().clone()
        entry = list(memo.cache._entries.values())[-1]
        val = entry.consts[0].value
        with memory.ledger._lock:
            led = memory.ledger.entries[memory._key(val)]
            freed = memory.ledger._spill_entry(led)
        del val
        if not freed:
            raise Fail("memo: the governor did not spill the cached entry")
        r0, h0 = memory.ledger.restores, memo.cache.hits
        again = (s * s)._value()
        if memo.cache.hits != h0 + 1 or memory.ledger.restores != r0 + 1 \
                or not bytes_equal(first, again):
            raise Fail("memo: the spilled entry did not restore byte-equal "
                       "on a hit")
        out["spill_restored"] = True
        out["oversize"] = memo.cache.oversize
        log(f"  analyze_path memo: seeded draw hit, new seed missed; a 2 GiB "
            f"result not retained (oversize {memo.cache.oversize}); a "
            f"spilled entry ({freed} B) restored byte-equal on its hit; "
            f"totals {json.dumps(memo.cache.snapshot())} [{card}]")
        del s, s_t, first, again
    memo.cache.clear()  # the counters stay: the linter's check reads them
    del x, y, x_t, y_t
    torch.cuda.empty_cache()
    return out


def analyze_certs(rt, torch, card, window, star2, traced):
    """(3) 100 repeat flushes of a star2 sstencil on 8192^2 and of a small
    elementwise program on 2^20 f32 under three settings: verify off,
    strict, strict with certificates; the prepare-plus-verify host time
    per flush (``traced``: under RAMBA_TRACE, whose program events every
    setting pays)."""
    from ramba_tpu_torch.core import fuser, plancache

    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)
    grid = rt.fromarray(torch.rand((ANALYZE_GRID, ANALYZE_GRID),
                                   generator=gen, device="cuda"))
    small = rt.fromarray(torch.rand(ANALYZE_SMALL_N, generator=gen,
                                    device="cuda"))
    progs = (("star2 8192^2 f32 sstencil",
              lambda: rt.sstencil(star2, grid), "stencil"),
             ("x * 2 + 1 n=2^20 f32", lambda: small * 2.0 + 1.0, "elemred"))
    settings = (("off", {}), ("strict", {"RAMBA_VERIFY": "strict"}),
                ("strict+certs", {"RAMBA_VERIFY": "strict",
                                  "RAMBA_PLANCERT": "1"}))
    times = []
    real = fuser._prepare

    def timed(*a, **k):
        t0 = time.perf_counter()
        r = real(*a, **k)
        times.append(time.perf_counter() - t0)
        return r

    out = {"cert_hits": 0}
    fuser._prepare = timed
    try:
        for name, build, kernel in progs:
            res = {}
            for setting, env in settings:
                plancache.reset()
                with _Env(**env):
                    build()._value()  # the first flush: misses, certifies
                    del times[:]

                    def repeats():
                        v = None
                        for _ in range(ANALYZE_REPEATS - 1):
                            v = build()._value()
                        torch.cuda.synchronize()
                        return v

                    v = window(f"{name}: {ANALYZE_REPEATS - 1} repeat "
                               f"flushes ({setting})", repeats,
                               {kernel: ANALYZE_REPEATS - 1})
                hits = plancache.snapshot().get("hits", 0)
                out["cert_hits"] += hits
                if setting == "strict+certs" and \
                        hits != ANALYZE_REPEATS - 1:
                    raise Fail(f"{name}: {hits} certificate hits of "
                               f"{ANALYZE_REPEATS - 1}")
                res[setting] = {"p50_us": 1e6 * _p(times, 50),
                                "p95_us": 1e6 * _p(times, 95),
                                "cert_hits": hits, "value": v}
            for setting in ("strict", "strict+certs"):
                if not bytes_equal(res[setting]["value"], res["off"]["value"]):
                    raise Fail(f"{name}: {setting}'s bytes differ from off")
            for r in res.values():
                del r["value"]
            log(f"  analyze_path certificates {name} ("
                f"{'traced' if traced else 'untraced'}): prepare+verify "
                f"host us per flush (p50/p95) " + ", ".join(
                    f"{k} {r['p50_us']:.1f}/{r['p95_us']:.1f}"
                    for k, r in res.items())
                + f"; {res['strict+certs']['cert_hits']} certificate hits; "
                "byte-equal across the three [" + card + "]")
            out[name] = res
    finally:
        fuser._prepare = real
    plancache.reset()
    del grid, small
    torch.cuda.empty_cache()
    return out


def analyze_forged(rt, torch, card, window):
    """(4) The forged faults: compile:bucket under strict raises from
    compile-class before any launch; memo:insert from memo-safety;
    plan:stale raises under strict and re-analyzes under warn."""
    from ramba_tpu_torch.analyze.findings import ProgramVerificationError
    from ramba_tpu_torch.compile import classes
    from ramba_tpu_torch.core import fuser, plancache
    from ramba_tpu_torch.core.expr import Node
    from ramba_tpu_torch.parallel import mesh as pm
    from ramba_tpu_torch.resilience import faults

    out = {}
    zero = dict.fromkeys(("elemred", "stencil", "segred", "scan"), 0)
    v = rt.fromarray(torch.rand(1 << 20, device="cuda"))

    def expect(what, rule, fn):
        try:
            fn()
        except ProgramVerificationError as e:
            rules = sorted({f.rule for f in e.findings})
            if rule not in rules:
                raise Fail(f"{what}: raised from {rules}, not {rule}")
            return rules
        raise Fail(f"{what}: no ProgramVerificationError")

    with _Env(RAMBA_VERIFY="strict", RAMBA_COMPILE_CLASSES="pow2"):
        classes.reset()
        c0 = fuser.stats["compiles"]

        def forged_bucket():
            y = rt.sort(v) * 2.0  # the generic lowering's program
            with faults.active("compile:bucket:always"):
                return expect("compile:bucket", "compile-class",
                              lambda: y._value())

        try:
            out["compile:bucket"] = window(
                "forged compile:bucket under strict", forged_bucket, zero)
        finally:
            classes.reset()
    classes.reset()
    if fuser.stats["compiles"] != c0:
        raise Fail("compile:bucket: a program was lowered before the raise")
    with _Env(RAMBA_VERIFY="strict", RAMBA_MEMO="1"):
        sh = pm.NamedSharding(pm.get_mesh(), pm.P())

        def forged_memo():
            with faults.active("memo:insert:always"):
                return expect("memo:insert", "memo-safety", lambda: fuser.flush(
                    extra=[Node("shard_hint", (sh,), [v._expr])]))

        out["memo:insert"] = window("forged memo:insert under strict",
                                    forged_memo, zero)
    for mode in ("strict", "warn"):
        plancache.reset()
        with _Env(RAMBA_VERIFY=mode, RAMBA_PLANCERT="1"):
            want = (v * 2.0 + 1.0)._value()
            with faults.active("plan:stale:always"):
                if mode == "strict":
                    out["plan:stale"] = expect(
                        "plan:stale", "plan-stale",
                        lambda: (v * 2.0 + 1.0)._value())
                else:
                    got = (v * 2.0 + 1.0)._value()
                    if not bytes_equal(got, want):
                        raise Fail("plan:stale under warn: the re-analysis "
                                   "gave other bytes")
            snap = plancache.snapshot()
            if snap.get("forged_stale", 0) != 1:
                raise Fail(f"plan:stale under {mode}: {snap}")
    plancache.reset()
    fuser.flush()
    log(f"  analyze_path forged faults: {json.dumps(out)}; plan:stale under "
        f"warn re-analyzed to the same bytes [{card}]")
    del v
    return out


def analyze_lint(trace, live):
    """(5) ``python -m ramba_tpu_torch.analyze`` over the path's trace:
    ``--strict`` exits 0, the audits' hit counts equal the live
    counters."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "ramba_tpu_torch.analyze", trace]
    procs = {}
    try:
        # the three linters at once: each is a process of its own
        for flag in ("--strict", "--memo-audit", "--plan-audit"):
            args = cmd + [flag] + (["--json"] if flag != "--strict" else [])
            procs[flag] = subprocess.Popen(args, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True,
                                           cwd=here)
        res = {}
        for flag, p in procs.items():
            stdout, stderr = p.communicate(timeout=300)
            if p.returncode != 0:
                raise Fail(f"ramba-lint {flag} exited {p.returncode}: "
                           f"{stderr[-2000:]}")
            res[flag] = stdout
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    memo_rec = json.loads(res["--memo-audit"].strip().splitlines()[-1])
    plan_rec = json.loads(res["--plan-audit"].strip().splitlines()[-1])
    if memo_rec["live_hits"] != live["memo_hits"]:
        raise Fail(f"--memo-audit counts {memo_rec['live_hits']} hits, the "
                   f"live memo {live['memo_hits']}")
    if plan_rec["live_hits"] != live["cert_hits"]:
        raise Fail(f"--plan-audit counts {plan_rec['live_hits']} hits, the "
                   f"live plan cache {live['cert_hits']}")
    if plan_rec["proof_broken"]:
        raise Fail(f"--plan-audit: proofs broken {plan_rec['proof_broken']}")
    log(f"  analyze_path lint: --strict exit 0 over "
        f"{memo_rec['programs']} programs; --memo-audit live hits "
        f"{memo_rec['live_hits']} (would-be {memo_rec['would_hits']}), "
        f"--plan-audit live hits {plan_rec['live_hits']}, "
        f"{plan_rec['certificates']} certificates, every proof re-derives")
    return {"programs": memo_rec["programs"],
            "memo_live_hits": memo_rec["live_hits"],
            "plan_live_hits": plan_rec["live_hits"],
            "certificates": plan_rec["certificates"]}


def analyze_path(rt, er, sk, sg, sc, torch, np, card, window):
    """The static analyzer, the result memo and the plan certificates on
    the card (ROADMAP A.7 part two), at the main path's sizes: (1) the
    main path under RAMBA_VERIFY=strict against verify unset, (2) the
    memo, (3) 100 repeat flushes under three settings, (5) the offline
    linter over the trace of (1)-(3), then (3) again untraced, and (4)
    the forged faults, left out of the trace (their error findings are
    the point)."""
    import os
    import tempfile

    from ramba_tpu_torch.core import memo, plancache
    from ramba_tpu_torch.observe import events

    t0 = time.perf_counter()
    star2 = rt.stencil(star2_body)
    out = {}
    walls = {}

    def part(name, fn, *a, **k):
        t = time.perf_counter()
        out[name] = fn(*a, **k)
        walls[name] = time.perf_counter() - t

    memo.reset()
    plancache.reset()
    with tempfile.TemporaryDirectory(prefix="ramba_analyze_") as tmp:
        trace = os.path.join(tmp, "trace.jsonl")
        events.configure(trace)
        try:
            h0 = memo.cache.hits
            part("verified", analyze_verified, rt, er, sk, sg, sc, torch, np,
                 card, window, star2)
            part("memo", analyze_memo, rt, torch, card, window)
            part("certs", analyze_certs, rt, torch, card, window, star2,
                 traced=True)
            live = {"memo_hits": memo.cache.hits - h0,
                    "cert_hits": out["certs"]["cert_hits"]}
        finally:
            events.configure(None)
        part("lint", analyze_lint, trace, live)
    part("certs_untraced", analyze_certs, rt, torch, card, window, star2,
         traced=False)
    part("forged", analyze_forged, rt, torch, card, window)
    memo.reset()
    plancache.reset()
    out["wall_s"] = time.perf_counter() - t0
    out["part_walls_s"] = walls
    log(f"  analyze_path: {out['wall_s']:.1f} s, by part (s) "
        f"{json.dumps(walls)} [{card}]")
    return out


# ---------------------------------------------------------------------------
# ladder_path: the degradation ladder, admission, retries and the audit
# ---------------------------------------------------------------------------

LADDER_N = 1 << 28                 # the 1-D programs, float64
LADDER_HOST_N = 1 << 24            # the same on the host rung
LADDER_GRID = 8192                 # star2, float32 (TMA)
LADDER_ODD = (4099, 4133)          # star2, float32 (cp.async)
LADDER_HOST_GRID = 2048            # star2 on the host rung
LADDER_SWEEPS = (10, 20)           # (chained, iterate)
LADDER_CHAIN_N = 10 ** 9           # the headline chain
ADMIT_FLUSHES = 200                # healthy flushes timing admission
LADDER_FILL = 1 << 30              # bytes of one fill array in (d)
LADDER_RANKS = 4
LADDER_DIST_N = 1 << 28            # axpy + sum across ranks, float64
LADDER_DIST_GRID = 8192            # star2 across ranks, float32
LADDER_DIST_SWEEPS = 10
LADDER_LIMIT_S = 300               # per launch of ranks, every rank of it
# RAMBA_FAULTS for each rung below fused: an injected out-of-memory error
# at the fused rung's call gives split, at split's first segment too
# chunked, at chunked's too eager; an eager fault then gives host.  A
# one-instruction program is offered no split or chunked rung: its first
# fault gives eager.  bytes=1: each eviction spills one cold array, not all
RUNG_FAULTS = {"split": "oom:1:bytes=1", "chunked": "oom:2:bytes=1",
               "eager": "oom:3:bytes=1",
               "host": "oom:3:bytes=1,eager:once:oom:bytes=1"}


def _ew_bound(torch, f, ulps=8):
    """An elementwise result computed by another rung: within ``ulps``
    of the largest magnitude (a kernel's own sin/cos or an FMA against
    torch's ops)."""
    eps = EPS.get(str(f.dtype).replace("torch.", ""), 2.0 ** -52)
    ff = f.double()
    top = ff[torch.isfinite(ff)].abs().max().item() if ff.numel() else 0.0
    return ulps * eps * (ff.abs() + top)


def _ladder_cases(rt, np, torch, sc, star2):
    """name -> make(cut): each builds its inputs on the card (the host
    rung's cut sizes when ``cut``) and returns ``(run, need, bounds)``:
    ``run()`` builds, flushes and returns the output tensors; ``need`` the
    kernel launches of its fused rung; ``bounds(outs)`` each output's
    bound against another rung's (None: the elementwise rule) and why."""
    from ramba_tpu_torch.ops import elemred, segred

    def red_bound(n, s_abs, dtype="float64"):
        depth = max(elemred.depth(n), segred.depth(n))
        return sum_bound(depth, dtype, s_abs), \
            f"2 depth(n) eps sum|x|, depth {depth}"

    def sincos(cut):
        n = LADDER_HOST_N if cut else LADDER_N
        base = rt.arange(n) / 1000.0
        rt.sync()

        def run():
            B, C = rt.sin(base), rt.cos(base)
            D = B * B + C * C
            s = rt.sum(D)
            del B, C
            return [D._value(), s._value()]

        return run, {"elemred": 1}, lambda o: [
            (None, "8 ulp of the largest"),
            red_bound(n, abs(float(o[1])))]

    def axpy(cut):
        n = LADDER_HOST_N if cut else LADDER_N
        x = rt.sin(rt.arange(n) * 1e-3)
        y = rt.cos(rt.arange(n) * 1e-3)
        rt.sync()
        s_abs = float((2.5 * x._value() + y._value()).abs().sum())

        def run():
            return [rt.sum(2.5 * x + y)._value()]

        return run, {"elemred": 1}, lambda o: [red_bound(n, s_abs)]

    def star2_grid(shape, chained):
        def make(cut):
            sh = (LADDER_HOST_GRID, LADDER_HOST_GRID) if cut else shape
            x = rt.fromarray(torch.rand(sh, dtype=torch.float32,
                                        generator=_gen(torch, 3),
                                        device="cuda"))
            rt.sync()
            k = LADDER_SWEEPS[0] if chained else LADDER_SWEEPS[1]

            def run():
                if chained:
                    y = x
                    for _ in range(k):
                        y = rt.sstencil(star2, y)
                else:
                    y = rt.sstencil_iterate(star2, x, k)
                return [y._value()]

            return run, {"stencil": k}, lambda o: [
                (None, "8 ulp of the largest")]

        return make

    def groupby(cut):
        n = LADDER_HOST_N if cut else LADDER_N
        x_t, hour = hourly_series(torch, np, n)
        g = rt.fromarray(x_t).groupby(0, hour, num_groups=24)
        lab = torch.from_numpy(hour).to(x_t.device).long()
        g_abs = torch.zeros(24, dtype=torch.float64,
                            device=x_t.device).index_add_(0, lab, x_t.abs())
        del lab

        def run():
            return [g.sum()._value()]

        return run, {"segred": 1}, lambda o: [red_bound(n, g_abs)]

    def cumsum(cut):
        n = LADDER_HOST_N if cut else LADDER_N
        x = rt.sin(rt.arange(n) * 1e-3)
        rt.sync()

        def run():
            return [rt.cumsum(x)._value()]

        def bounds(o):
            prefix = torch.cumsum(x._value().abs(), 0)
            return [(sum_bound(sc.depth(n), "float64", prefix),
                     f"2 depth(n) eps prefix sum|x|, depth {sc.depth(n)}")]

        return run, {"scan": 1}, bounds

    def headline(cut):
        n = LADDER_HOST_N if cut else LADDER_CHAIN_N

        def run():
            A = rt.arange(n) / 1000.0
            D = rt.sin(A) ** 2 + rt.cos(A) ** 2
            del A
            return [rt.sum(D)._value()]

        return run, {}, lambda o: [red_bound(n, abs(float(o[0])))]

    return {"sincos": sincos, "axpy": axpy,
            "star2_chained": star2_grid((LADDER_GRID, LADDER_GRID), True),
            "star2_iterate": star2_grid((LADDER_GRID, LADDER_GRID), False),
            "star2_odd_chained": star2_grid(LADDER_ODD, True),
            "star2_odd_iterate": star2_grid(LADDER_ODD, False),
            "groupby": groupby, "cumsum": cumsum, "headline": headline}


def _gen(torch, seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


def _ladder_hold(torch, what, got, fused, bounds):
    """Each output of a rung against the fused rung's: byte-equal, else
    within its bound.  Returns whether every output was byte-equal."""
    same = True
    for i, (g, f, (b, why)) in enumerate(zip(got, fused, bounds)):
        if g.dtype != f.dtype or g.shape != f.shape:
            raise Fail(f"{what}[{i}]: {g.dtype}{tuple(g.shape)} against "
                       f"{f.dtype}{tuple(f.shape)}")
        if bytes_equal(g, f):
            continue
        same = False
        if b is None:
            b = _ew_bound(torch, f)
        gd, fd = g.double(), f.double()
        if not torch.equal(torch.isnan(gd), torch.isnan(fd)):
            raise Fail(f"{what}[{i}]: NaNs in other places")
        err = torch.where(torch.isnan(fd), torch.zeros_like(fd),
                          (gd - fd).abs())
        b = torch.as_tensor(b, dtype=torch.float64, device=err.device)
        ok = bool(((err <= b) | (gd == fd)).all())
        ratio = torch.where(b > 0, err / b, err).max().item()
        log(f"  {what}[{i}]: not byte-equal, max |diff| "
            f"{err.max().item():.3e}, largest diff/bound {ratio:.4f} ({why}) "
            f"{'ok' if ok else 'MISS'}")
        if not ok:
            raise Fail(f"{what}[{i}] disagrees with the fused rung")
    return same


def _ladder_run(torch, run, spec=None, evicted=None):
    """One flush of ``run`` (under the RAMBA_FAULTS ``spec``): its
    outputs, wall, span and the degrade steps it took; the bytes its
    drops' evictions spilled are appended to ``evicted`` when given."""
    from ramba_tpu_torch.observe import events, registry
    from ramba_tpu_torch.resilience import faults

    d0 = registry.get("resilience.degrade_steps")
    seen = []
    torch.cuda.synchronize()
    # every run starts from an empty allocator cache: another rung's
    # blocks otherwise leave it to free and map memory inside the wall
    torch.cuda.empty_cache()
    events.add_tap(seen.append)
    t0 = time.perf_counter()
    try:
        if spec:
            with faults.active(spec):
                outs = run()
        else:
            outs = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        events.remove_tap(seen.append)
    if evicted is not None:
        evicted.append(sum(e.get("freed_bytes", 0) for e in seen
                           if e.get("action") == "oom_evict"))
    spans = events.last(40, type="flush")
    return outs, wall, spans[-1], \
        registry.get("resilience.degrade_steps") - d0


def ladder_rungs(rt, np, torch, sc, card, window, star2):
    """(a) each main-path program with nothing forced: every flush on
    fused, no degrade step, the kernel launches its path gives; (b) each
    rung the ladder offers it, forced, held against the fused result
    (full size; the host rung at its cut size, against a fused run at
    that size)."""
    from ramba_tpu_torch.core import fuser

    cases = _ladder_cases(rt, np, torch, sc, star2)
    healthy, forced, same_bytes = {}, {}, {}
    for name, make in cases.items():
        run, need, bounds = make(False)
        # the first call builds and plans: not the fused wall
        _ladder_run(torch, run)
        fused, wall, span, steps = window(
            f"ladder (a) {name} fused", lambda: _ladder_run(torch, run),
            need)
        if span.get("degraded") or steps:
            raise Fail(f"ladder (a) {name}: rung {span.get('degraded')}, "
                       f"{steps} degrade steps with nothing forced")
        healthy[name] = wall
        bnds = bounds(fused)
        offered = fuser.rungs_for(span["instrs"], host=True)
        forced[name], same_bytes[name] = {"fused": wall}, ["fused"]
        evicted = []
        for rung in offered[1:-1]:
            # the first run builds its segments' kernels: the second's
            # wall is the rung's
            cold = _ladder_run(torch, run, RUNG_FAULTS[rung])[1]
            got, w, sp, steps = window(
                f"ladder (b) {name} {rung}",
                lambda: _ladder_run(torch, run, RUNG_FAULTS[rung],
                                    evicted), {})
            if sp.get("degraded") != rung:
                raise Fail(f"ladder (b) {name}: {RUNG_FAULTS[rung]} gave "
                           f"rung {sp.get('degraded')}, not {rung}")
            if _ladder_hold(torch, f"ladder (b) {name} {rung}", got, fused,
                            bnds):
                same_bytes[name].append(rung)
            forced[name][rung] = w
            forced[name][f"{rung}_first"] = cold
            del got
        del fused, run
        torch.cuda.empty_cache()
        # the host rung at its cut size
        run, need, bounds = make(True)
        _ladder_run(torch, run)
        fused, wall_c, _sp, _s = _ladder_run(torch, run)
        _ladder_run(torch, run, RUNG_FAULTS["host"])
        got, w, sp, steps = _ladder_run(torch, run, RUNG_FAULTS["host"])
        if sp.get("degraded") != "host":
            raise Fail(f"ladder (b) {name}: host fault gave rung "
                       f"{sp.get('degraded')}")
        if _ladder_hold(torch, f"ladder (b) {name} host (cut)", got, fused,
                        bounds(fused)):
            same_bytes[name].append("host")
        forced[name]["host_cut"] = [wall_c, w]
        del got, fused, run
        torch.cuda.empty_cache()
        walls = ", ".join(f"{k} {v if isinstance(v, float) else v[1]:.4f} s"
                          for k, v in forced[name].items()
                          if not k.endswith("_first"))
        firsts = ", ".join(f"{k[:-6]} {v:.4f} s" for k, v in
                           forced[name].items() if k.endswith("_first"))
        forced[name]["evicted_bytes"] = evicted
        log(f"  ladder {name}: rungs offered {offered}; walls {walls}, "
            f"second runs (first runs, building their segments' kernels: "
            f"{firsts or 'none'}; GiB the drops of each second run "
            f"spilled {[round(b / 2 ** 30, 3) for b in evicted]}) "
            f"(host at its cut size beside fused there "
            f"{forced[name]['host_cut'][0]:.4f} s); the fused bytes on "
            f"{same_bytes[name]} [{card}]")
    return {"fused_s": healthy, "rung_s": forced, "fused_bytes": same_bytes}


def ladder_admission(rt, np, torch, card, window):
    """(c) The 1e9 headline chain under a RAMBA_HBM_BUDGET below its
    estimated peak.  With the default bytes a segment, one result (8 GB)
    is larger than a segment: the chunked rung would keep the fused
    rung's live set, so admission keeps the fused rung ("over").  With
    bytes a segment past three results, admission rejects the fused rung
    and the flush runs chunked.  Both results equal the fused one within
    the depth bound; the peaks and walls are printed, and admission's
    own host time over healthy flushes (the span's ``admit`` stage)."""
    import os

    from ramba_tpu_torch.observe import events, registry
    from ramba_tpu_torch.ops import elemred, segred

    n = LADDER_CHAIN_N

    def run():
        A = rt.arange(n) / 1000.0
        D = rt.sin(A) ** 2 + rt.cos(A) ** 2
        del A
        return [rt.sum(D)._value()]

    def peak_run(label):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got, w, span, _s = window(label, lambda: _ladder_run(torch, run), {})
        return got, w, span, torch.cuda.max_memory_allocated() - base

    fused, w_f, span_f, peak_f = peak_run("ladder (c) headline fused")
    est = span_f["mem_peak_est"]
    budget = int(est * 0.9)
    depth = max(elemred.depth(n), segred.depth(n))
    bound = [(sum_bound(depth, "float64", abs(float(fused[0]))),
              f"2 depth(n) eps sum|x|, depth {depth}")]
    saved = {k: os.environ.get(k)
             for k in ("RAMBA_HBM_BUDGET", "RAMBA_CHUNK_BYTES")}
    out = {"est_bytes": est, "budget_bytes": budget,
           "peak_fused_bytes": peak_f, "fused_s": w_f}
    try:
        os.environ["RAMBA_HBM_BUDGET"] = str(budget)
        for mode, chunk in (("over", None), ("chunked", 3 * est // 2)):
            if chunk is None:
                os.environ.pop("RAMBA_CHUNK_BYTES", None)
            else:
                os.environ["RAMBA_CHUNK_BYTES"] = str(chunk)
            c0 = {k: registry.get(f"memory.admission_{k}")
                  for k in ("rejects", "over")}
            _ladder_run(torch, run)  # builds the segments' kernels
            got, w, span, peak = peak_run(f"ladder (c) headline {mode}")
            moved = {k: registry.get(f"memory.admission_{k}") - v
                     for k, v in c0.items()}
            same = _ladder_hold(torch, f"ladder (c) headline {mode}", got,
                                fused, bound)
            rung = span.get("degraded", "fused")
            log(f"  ladder (c) admission {mode}: estimate "
                f"{est / 2 ** 30:.3f} GiB, budget {budget / 2 ** 30:.3f} "
                f"GiB (watermark 0.9 of it), bytes a segment "
                f"{(chunk or 0) / 2 ** 30:.3f} GiB (0: the default), "
                f"memory.admission_rejects +{moved['rejects']}, "
                f"memory.admission_over +{moved['over']} (two runs), rung "
                f"{rung} ({span.get('segments')} segments); "
                f"max_memory_allocated {peak / 2 ** 30:.3f} GiB vs fused "
                f"{peak_f / 2 ** 30:.3f} GiB; walls {w:.4f} s, fused "
                f"{w_f:.4f} s; result byte-equal {same} [{card}]")
            want = {"rejects": 0, "over": 2} if mode == "over" else \
                {"rejects": 2, "over": 0}
            if moved != want or rung != ("fused" if mode == "over"
                                         else "chunked") \
                    or span.get("admission") != mode:
                raise Fail(f"ladder (c) {mode}: {moved}, span {span}")
            out[mode] = {"rung": rung, "peak_bytes": peak, "wall_s": w,
                         "byte_equal": same, **moved}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    # admission's host time on a healthy flush (the card's capacity is
    # the budget): the span's admit stage over small flushes
    x = rt.fromarray(np.arange(1 << 16, dtype=np.float64))
    float(rt.sum(x * 2.0 + 1.0))
    seen = []
    events.add_tap(seen.append)
    try:
        for k in range(ADMIT_FLUSHES):
            float(rt.sum(x * 2.0 + float(k)))
    finally:
        events.remove_tap(seen.append)
    admit_us = sorted(e["stages"]["admit"] * 1e6 for e in seen
                      if e.get("type") == "flush" and "admit" in
                      e.get("stages", {}))
    if len(admit_us) != ADMIT_FLUSHES:
        raise Fail(f"ladder (c): {len(admit_us)} admit stages of "
                   f"{ADMIT_FLUSHES} flushes")
    p50, p90 = admit_us[len(admit_us) // 2], admit_us[len(admit_us) * 9 // 10]
    log(f"  ladder (c) admission's host time, {ADMIT_FLUSHES} healthy "
        f"flushes of sum(x * 2 + k) over 2^16 f64: span stage admit p50 "
        f"{p50:.1f} us, p90 {p90:.1f} us [{card}]")
    out.update(admit_p50_us=p50, admit_p90_us=p90)
    return out


def ladder_real_oom(rt, np, torch, card, window):
    """(d) The card filled with governed, spillable arrays until a flush's
    fused attempt gets a real ``torch.cuda.OutOfMemoryError``: the
    eviction spills fill, the ladder drops, the result is right, and
    nothing of the failed attempt stays allocated."""
    import gc
    import os

    from ramba_tpu_torch.core import fuser
    from ramba_tpu_torch.observe import events, registry
    from ramba_tpu_torch.resilience import memory, spill

    n = LADDER_N
    old = os.environ.get("RAMBA_HBM_BUDGET")
    # a budget past the card: admission and placement never spill, so
    # the card itself runs out
    os.environ["RAMBA_HBM_BUDGET"] = "1000g"
    fill = []
    try:
        fuser.flush()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        x = rt.sin(rt.arange(n) * 1e-3)
        y = rt.cos(rt.arange(n) * 1e-3)
        rt.sync()
        want = 2.5 * x._value() + y._value()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        out_b = n * 8
        while True:
            torch.cuda.empty_cache()
            free = torch.cuda.mem_get_info()[0]
            if free < out_b * 3 // 4:
                break
            k = min(LADDER_FILL, free - out_b // 2) // 8
            fill.append(rt.zeros(k))
            rt.sync()
        fill_b = sum(int(f.size) * 8 for f in fill)
        ev0 = registry.get("memory.evictions")
        seen = []
        events.add_tap(seen.append)
        z = 2.5 * x + y
        try:
            got, wall, span, steps = window(
                "ladder (d) axpy on a full card",
                lambda: _ladder_run(torch, lambda: [z._value()]), {})
        finally:
            events.remove_tap(seen.append)
        freed = sum(e.get("freed_bytes", 0) for e in seen
                    if e.get("action") == "oom_evict")
        errs = [e.get("error") or "" for e in seen
                if e.get("type") == "degrade" and e.get("action") == "rung"]
        spilled = sum(int(f.size) * 8 for f in fill
                      if isinstance(f._expr.value, spill.SpilledArray))
        gc.collect()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        expect = base + out_b + (fill_b - spilled)
        extra = held - expect
        equal = bytes_equal(got[0], want)
        del got
        log(f"  ladder (d) real OOM: {len(fill)} fill arrays "
            f"({fill_b / 2 ** 30:.2f} GiB) left "
            f"{free / 2 ** 30:.2f} GiB free; the fused attempt raised "
            f"{errs[0][:60] if errs else 'nothing'!r}; evictions "
            f"{registry.get('memory.evictions') - ev0}, "
            f"{freed / 2 ** 30:.2f} GiB freed, {steps} rung(s) down to "
            f"{span.get('degraded')}, result byte-equal to a plain axpy "
            f"{equal}; allocated after the flush {held / 2 ** 30:.3f} GiB "
            f"against leaves + result + unspilled fill "
            f"{expect / 2 ** 30:.3f} GiB ({extra / 2 ** 20:+.1f} MiB); "
            f"wall {wall:.4f} s [{card}]")
        if not errs or "OutOfMemoryError" not in errs[0] or \
                span.get("degraded") in (None, "fused") or not equal or \
                freed <= 0 or abs(extra) > 64 << 20:
            raise Fail("ladder (d): a real out-of-memory error did not "
                       "evict, drop a rung and finish clean")
        return {"fill_bytes": fill_b, "freed_bytes": freed,
                "rung": span.get("degraded"), "extra_bytes": extra,
                "wall_s": wall}
    finally:
        del fill
        gc.collect()
        if old is None:
            os.environ.pop("RAMBA_HBM_BUDGET", None)
        else:
            os.environ["RAMBA_HBM_BUDGET"] = old
        torch.cuda.empty_cache()


def ladder_faults(rt, np, torch, er, card, window):
    """(e) A transient execute fault retried in place on fused; an
    injected fatal fault and a forged kernel build error raising with no
    degrade step, their roots quarantined, and a fresh array still
    flushing and launching its kernel."""
    import subprocess as sp

    from ramba_tpu_torch import _build
    from ramba_tpu_torch.core import fuser
    from ramba_tpu_torch.observe import registry
    from ramba_tpu_torch.resilience import faults

    x = rt.sin(rt.arange(LADDER_N) * 1e-3)
    y = rt.cos(rt.arange(LADDER_N) * 1e-3)
    rt.sync()
    out = {}
    r0 = registry.get("resilience.retries.flush")
    got, wall, span, steps = window(
        "ladder (e) transient execute fault",
        lambda: _ladder_run(torch, lambda: [rt.sum(2.5 * x + y)._value()],
                            "execute:once"), {"elemred": 1})
    retries = registry.get("resilience.retries.flush") - r0
    if retries != 1 or steps or span.get("degraded"):
        raise Fail(f"ladder (e): transient fault retried {retries}, "
                   f"{steps} steps, rung {span.get('degraded')}")
    out["transient"] = {"retries": retries, "wall_s": wall}

    def fatal(what, run):
        q0, d0 = fuser.stats["quarantined"], \
            registry.get("resilience.degrade_steps")
        try:
            run()
        except Exception as e:  # the expected failure
            err = f"{type(e).__name__}: {e}"[:120]
        else:
            raise Fail(f"ladder (e) {what}: no error")
        q = fuser.stats["quarantined"] - q0
        d = registry.get("resilience.degrade_steps") - d0
        fresh = window(f"ladder (e) after {what}", lambda: float(
            rt.sum(rt.fromarray(x._value()[:1 << 20]) * 3.0 + 1.0)),
            {"elemred": 1})
        log(f"  ladder (e) {what}: raised {err!r}, degrade steps {d}, "
            f"roots quarantined {q}; a fresh array flushed ({fresh!r}) "
            f"and launched elemred [{card}]")
        if d or q < 1:
            raise Fail(f"ladder (e) {what}: {d} degrade steps, {q} "
                       "quarantined")
        return {"error": err, "degrade_steps": d, "quarantined": q}

    z = 2.5 * x - y

    def injected():
        with faults.active("execute:once:fatal"):
            z._value()

    out["fatal"] = fatal("InjectedFatalFault", injected)
    forged = {"n": 0}
    real = _build._run_nvcc

    def no_nvcc(cmd):
        forged["n"] += 1
        return sp.CompletedProcess(cmd, 1, "", "forged: nvcc refused")

    w = x * 1.25 - rt.sqrt(rt.abs(y)) * 0.75  # a program not built yet

    def build():
        _build._run_nvcc = no_nvcc
        try:
            w._value()
        finally:
            _build._run_nvcc = real

    out["build"] = fatal("forged kernel build error", build)
    if forged["n"] < 1 or "KernelBuildError" not in out["build"]["error"]:
        raise Fail(f"ladder (e): the forged build did not raise "
                   f"KernelBuildError: {out['build']}")
    window("ladder (e) the unbuilt program, built", lambda: w._value(),
           {"elemred": 1})
    log(f"  ladder (e) transient execute fault: retried "
        f"{out['transient']['retries']} time in place, rung fused, "
        f"{wall:.4f} s [{card}]")
    return out


def ladder_audit(rt, np, torch, sc, card, window, star2):
    """(f) RAMBA_MEMO=1 RAMBA_AUDIT=1 on the elemred, segred and stencil
    programs: each clean audit ok or numeric, its wall beside the
    flush's; a flipped shadow a mismatch that serves the unaudited bytes
    and evicts, so the repeat launches again."""
    import os

    from ramba_tpu_torch.core import fuser, memo
    from ramba_tpu_torch.observe import events
    from ramba_tpu_torch.resilience import faults, integrity

    base = rt.arange(LADDER_N) / 1000.0
    x = rt.sin(rt.arange(LADDER_N) * 1e-3)
    y = rt.cos(rt.arange(LADDER_N) * 1e-3)
    x_t, hour = hourly_series(torch, np, LADDER_N)
    g = rt.fromarray(x_t).groupby(0, hour, num_groups=24)
    grid = rt.fromarray(torch.rand((LADDER_GRID, LADDER_GRID),
                                   dtype=torch.float32,
                                   generator=_gen(torch, 3), device="cuda"))
    rt.sync()
    progs = {"sincos": (lambda: rt.sin(base) * rt.sin(base)
                        + rt.cos(base) * rt.cos(base), {"elemred": 1}),
             "sincos_sum": (lambda: rt.sum(rt.sin(base) * rt.sin(base)
                                           + rt.cos(base) * rt.cos(base)),
                            {"elemred": 1}),
             "axpy_sum": (lambda: rt.sum(2.5 * x + y), {"elemred": 1}),
             "groupby_sum": (lambda: g.sum(), {"segred": 1})}
    old = {k: os.environ.get(k) for k in ("RAMBA_MEMO", "RAMBA_AUDIT")}
    for make, _need in progs.values():  # builds and plans outside the walls
        make()._value()
    os.environ["RAMBA_MEMO"] = "1"
    os.environ["RAMBA_AUDIT"] = "1"
    out = {}
    try:
        memo.reset()
        integrity.reset()
        for name, (make, need) in progs.items():
            v = window(f"ladder (f) {name} audited",
                       lambda: make()._value(), need)
            torch.cuda.synchronize()
            span = events.last(1, type="flush")[-1]
            ev = events.last(1, type="integrity_audit")[-1]
            out[name] = {"outcome": ev["outcome"], "flush_s": span["wall_s"],
                         "audit_s": span.get("audit_s")}
            log(f"  ladder (f) {name}: audit {ev['outcome']}, audit "
                f"{span.get('audit_s', 0):.4f} s beside the flush "
                f"{span['wall_s']:.4f} s [{card}]")
            if ev["outcome"] not in ("ok", "numeric") or \
                    not span.get("audited"):
                raise Fail(f"ladder (f) {name}: audit {ev}")
            del v
        # the stencil's body is a Python function: the memo cannot token
        # it, so its flushes are not eligible; the slack the audit would
        # apply, held here against the kernel's fused bytes
        a0 = integrity.snapshot()["audits"]
        for tag, make in (("chained", lambda: _chain10(rt, star2, grid)),
                          ("iterate", lambda: rt.sstencil_iterate(
                              star2, grid, LADDER_SWEEPS[1]))):
            arr = make()
            program, vals = fuser.prepare_program([arr._expr])
            fused = window(f"ladder (f) star2 {tag}", lambda: arr._value(),
                           {"stencil": None})
            t0 = time.perf_counter()
            shadow, slack = fuser._audit_rerun(program, vals)
            verdict = integrity._classify_divergence([fused], shadow, slack)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            outcome = "mismatch" if verdict[0] else \
                "numeric" if verdict[1] else "ok"
            out[f"star2_{tag}"] = {"outcome": outcome, "audit_s": dt,
                                   "eligible": False}
            log(f"  ladder (f) star2 {tag} 8192^2: not sampled (its body "
                f"has no memo token); the audit's classifier on its eager "
                f"rerun: {outcome}, {dt:.4f} s [{card}]")
            if verdict[0]:
                raise Fail(f"ladder (f) star2 {tag}: eager rerun "
                           "classified a mismatch")
            del arr, fused, shadow, vals
        if integrity.snapshot()["audits"] != a0:
            raise Fail("ladder (f): an uncertified stencil flush was audited")
        # a flipped shadow: fresh inputs, so the memo misses
        os.environ.pop("RAMBA_AUDIT")
        memo.reset()
        plain = (2.5 * y + x)._value().clone()
        memo.reset()
        os.environ["RAMBA_AUDIT"] = "1"
        faults.configure("audit:shadow:flip:bytes=4")
        try:
            served = window("ladder (f) flipped audit",
                            lambda: (2.5 * y + x)._value(), {"elemred": 1})
        finally:
            faults.configure(None)
        ev = events.last(1, type="integrity_audit")[-1]
        again = window("ladder (f) repeat after the mismatch",
                       lambda: (2.5 * y + x)._value(), {"elemred": 1})
        ok = ev["outcome"] == "mismatch" and bytes_equal(served, plain) \
            and bytes_equal(again, plain)
        log(f"  ladder (f) flipped shadow: audit {ev['outcome']}, served "
            f"bytes equal to the unaudited run {bytes_equal(served, plain)}, "
            f"memo entry evicted (the repeat launched elemred again) "
            f"[{card}]")
        if not ok:
            raise Fail(f"ladder (f) flipped audit: {ev}")
        out["flipped"] = ev["outcome"]
        out["snapshot"] = integrity.snapshot()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        memo.reset()
        integrity.reset()
    return out


def _chain10(rt, star2, grid):
    y = grid
    for _ in range(LADDER_SWEEPS[0]):
        y = rt.sstencil(star2, y)
    return y


def ladder_rank_programs(rt, np, torch, er, sk, sc, rep):
    """One rank of ``ladder_path`` (g): axpy + sum and star2 with nothing
    forced, with an ``oom`` on rank 1 alone, and a fatal fault on rank
    1; the healthy iterate timed by CUDA events."""
    from ramba_tpu_torch.observe import events, registry
    from ramba_tpu_torch.resilience import coherence, faults, retry

    rank = rep["rank"]
    st = rt.stencil(star2_body)
    a = dist_vec(rt, LADDER_DIST_N)
    b = dist_vec(rt, LADDER_DIST_N, 104729)
    x = dist_grid(rt, np, (LADDER_DIST_GRID, LADDER_DIST_GRID))
    rt.sync()
    rep["rungs"] = {}

    def rung_of(name, fn):
        r0 = registry.get("resilience.degrade_recovered")
        v = _rank_window(er, sk, sc, name, fn, rep)
        rung = "fused"
        if registry.get("resilience.degrade_recovered") != r0:
            rung = [e for e in events.last(80, type="degrade")
                    if e.get("action") == "recovered"][-1]["rung"]
        rep["rungs"][name] = rung
        return v

    for tag, spec in (("healthy", None), ("oom", "oom:1:bytes=1:rank=1")):
        with faults.active(spec or ""):
            rep["values"][f"axpy_{tag}"] = rung_of(
                f"axpy_{tag}", lambda: float(rt.sum(2.5 * a + b)))
        with faults.active(spec or ""):
            y = rung_of(f"star2_{tag}", lambda: rt.sstencil_iterate(
                st, x, LADDER_DIST_SWEEPS)._block())
        rep["digests"][f"star2_{tag}"] = digest(y)
        del y
    rep["ms"]["star2_iterate"] = _events_ms(
        torch, lambda: rt.sstencil_iterate(st, x, 20)._block(), 20)
    with faults.active("execute:once:fatal:rank=1"):
        try:
            rt.sstencil_iterate(st, x, 2)._block()
            rep["values"]["fatal"] = "no error"
        except Exception as e:  # recorded for the parent
            rep["values"]["fatal"] = f"{type(e).__name__}: {e}"[:200]
            rep["values"]["fatal_class"] = retry.classify(e)
    rep["values"]["after_fatal"] = float(rt.sum(a * 0.5))
    rep["epochs"] = coherence.epochs()
    rep["degrade_steps"] = registry.get("resilience.degrade_steps")


def ladder_ranks(rt, np, torch, card, totals, dist_ms):
    """(g) Four ranks on cuda:0 over gloo: an oom on rank 1 alone drops
    every rank to the same rung in the same rounds, with the one-process
    bytes; a fatal fault on rank 1 aborts every rank with one class; the
    healthy star2 iterate's ms per sweep beside dist_path's."""
    import os
    import tempfile

    from ramba_tpu_torch import common
    from ramba_tpu_torch.parallel import mesh as pm

    st = rt.stencil(star2_body)
    dev = common.device()
    grid2 = pm.Mesh(np.array([dev] * 4, dtype=object).reshape(2, 2),
                    ("d0", "d1"))
    t = rt.sstencil_iterate(st, dist_grid(rt, np, (LADDER_DIST_GRID,
                                                    LADDER_DIST_GRID)),
                            LADDER_DIST_SWEEPS)._value()
    sh = pm.NamedSharding(grid2, pm.default_spec(tuple(t.shape), grid2))
    ref = {pos: digest(t[idx]) for pos, idx in
           sh.shard_indices(tuple(t.shape))}
    want = float(rt.sum(2.5 * dist_vec(rt, LADDER_DIST_N)
                        + dist_vec(rt, LADDER_DIST_N, 104729)))
    del t
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="ramba_ladder_") as tmp:
        os.makedirs(os.path.join(tmp, f"w{LADDER_RANKS}"))
        t0 = time.perf_counter()
        ranks = dist_start(LADDER_RANKS, tmp, ("--ladder",),
                           env=dict(os.environ, RAMBA_RETRY_BASE_S="0",
                                    RAMBA_INIT_TIMEOUT_S="120"))
        try:
            reps = dist_wait(ranks, tmp, time.time() + LADDER_LIMIT_S)
        finally:
            for p in ranks:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
    positions = {k: divmod(k, 2) for k in range(4)}
    rungs = [r["rungs"] for r in reps]
    epochs = [r["epochs"] for r in reps]
    blocks = all(r["digests"][f"star2_{tag}"] == ref[positions[k]]
                 for k, r in enumerate(reps) for tag in ("healthy", "oom"))
    sums = {tag: {r["values"][f"axpy_{tag}"] for r in reps}
            for tag in ("healthy", "oom")}
    bound = 2 * LADDER_DIST_N * EPS["float64"] * abs(want)
    within = all(len(v) == 1 and abs(next(iter(v)) - want) <= bound
                 for v in sums.values())
    classes = {r["values"].get("fatal_class") for r in reps}
    fatal = [r["values"]["fatal"] for r in reps]
    slow = max(r["ms"]["star2_iterate"] for r in reps)
    for r in reps:
        for k in totals:
            totals[k] += sum(c.get(k, 0) for c in r["launches"].values())
    log(f"  ladder (g) {LADDER_RANKS} ranks on cuda:0: rungs {rungs[0]} on "
        f"every rank {all(x == rungs[0] for x in rungs)}; the same round "
        f"epochs {all(e == epochs[0] for e in epochs)} ({epochs[0]}); "
        f"star2 blocks byte-equal to one process {blocks}; axpy sums "
        f"{ {k: sorted(v) for k, v in sums.items()} } (one value a run on "
        f"every rank, within 2 n eps sum of one process's {want!r}: "
        f"{within}; the dropped rung's bytes the fused rung's: "
        f"{sums['healthy'] == sums['oom']}); fatal on rank 1: classes "
        f"{classes}, "
        f"{[f[:40] for f in fatal]}; {wall:.1f} s [{card}]")
    log(f"  ladder (g) healthy star2 iterate 8192^2, slowest rank: "
        f"{slow:.4f} ms/sweep (CUDA events) beside dist_path's "
        f"{dist_ms if dist_ms is not None else 'not run'} ms/sweep "
        f"[{card}]")
    if not (all(x == {"axpy_healthy": "fused", "star2_healthy": "fused",
                      "axpy_oom": "split", "star2_oom": "split"}
                for x in rungs) and all(e == epochs[0] for e in epochs)
            and blocks and within and classes == {"fatal"}
            and fatal[1].startswith("InjectedFatalFault")
            and all("another rank" in f for i, f in enumerate(fatal)
                    if i != 1)
            and len({r["values"]["after_fatal"] for r in reps}) == 1):
        raise Fail("ladder (g): the ranks' ladders disagree")
    return {"rungs": rungs[0], "epochs": epochs[0],
            "star2_ms_per_sweep_slowest": slow,
            "dist_star2_ms_per_sweep": dist_ms, "wall_s": wall}


def ladder_path(rt, er, sk, sg, sc, torch, np, card, window, totals,
                dist_ms=None):
    """The degradation ladder on the card (ROADMAP A.8 parts one and
    two), (a)-(g) as their functions say; ``dist_ms``: ``dist_path``'s
    star2 iterate ms per sweep on the slowest rank, when it ran."""
    from ramba_tpu_torch.observe import registry

    t0 = time.perf_counter()
    star2 = rt.stencil(star2_body)
    out, walls = {}, {}

    def part(name, fn, *a):
        t = time.perf_counter()
        out[name] = fn(*a)
        walls[name] = time.perf_counter() - t

    d0 = registry.get("resilience.degrade_steps")
    part("rungs", ladder_rungs, rt, np, torch, sc, card, window, star2)
    part("admission", ladder_admission, rt, np, torch, card, window)
    part("real_oom", ladder_real_oom, rt, np, torch, card, window)
    part("faults", ladder_faults, rt, np, torch, er, card, window)
    part("audit", ladder_audit, rt, np, torch, sc, card, window, star2)
    part("ranks", ladder_ranks, rt, np, torch, card, totals, dist_ms)
    out["degrade_steps"] = registry.get("resilience.degrade_steps") - d0
    out["wall_s"] = time.perf_counter() - t0
    out["part_walls_s"] = walls
    log(f"  ladder_path: {out['wall_s']:.1f} s, by part (s) "
        f"{json.dumps(walls)} [{card}]")
    return out


ELASTIC_N = 1 << 28                # the series and the 1-D programs, float64
ELASTIC_GRID = 8192                # star2 and the solver, float32 (TMA)
ELASTIC_SWEEPS = 20                # the iterated sweeps of (c)
ELASTIC_FLUSHES = 200              # flushes timing the armed watchdog
ELASTIC_SMALL_N = 1 << 16          # their operand, float64
ELASTIC_ARMED_S = 60.0             # the deadline armed with nothing seeded
ELASTIC_STALL_S = 1.0              # the deadline of the seeded stall
ELASTIC_INFLIGHT_S = 0.5           # the deadline below (c)'s wall
ELASTIC_BUILD_S = 0.3              # the deadline below a first nvcc build
ELASTIC_LOST_S = 3.0               # the barrier's deadline in (h)
ELASTIC_STEPS = 100                # the solver's sweeps
ELASTIC_EVERY = 25                 # its checkpoint cadence
ELASTIC_KEEP = 2                   # its retention
ELASTIC_HEARTBEAT_S = 0.01         # the beacon's interval in (d)
ELASTIC_RANKS = 4
ELASTIC_LIMIT_S = 300              # per launch of ranks or a child


def _elastic_env(**kw):
    """Set (a value) or clear (None) environment switches."""
    import os

    for k, v in kw.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)


def _zombies_done(timeout=30.0):
    """Wait for every call a deadline abandoned to end."""
    from ramba_tpu_torch.resilience import elastic

    if not elastic.wait_abandoned(timeout):
        raise Fail(f"an abandoned call still runs after {timeout} s")


def _pct(vals, q):
    s = sorted(vals)
    return s[min(len(s) - 1, int(q * len(s)))]


def elastic_armed(rt, np, torch, sc, card, window, star2):
    """(a) The main path's programs with the watchdog armed and nothing
    seeded: on the fused rung with the bytes and launches of unarmed;
    then the host microseconds of a flush armed against unarmed."""
    from ramba_tpu_torch.observe import registry

    cases = _ladder_cases(rt, np, torch, sc, star2)
    names = ("sincos", "axpy", "star2_chained", "star2_iterate",
             "star2_odd_chained", "star2_odd_iterate", "groupby", "cumsum")
    s0 = registry.get("elastic.stalls")
    for name in names:
        run, need, _bounds = cases[name](False)
        got = {}
        for arm in (None, ELASTIC_ARMED_S):
            _elastic_env(RAMBA_WATCHDOG_S=arm)
            tag = "armed" if arm else "unarmed"
            outs, wall, span, steps = window(
                f"elastic (a) {name} {tag}",
                lambda: _ladder_run(torch, run), need)
            if steps or span.get("degraded"):
                raise Fail(f"elastic (a) {name} {tag}: left the fused rung")
            got[tag] = (outs, wall)
        _elastic_env(RAMBA_WATCHDOG_S=None)
        same = all(bytes_equal(a, b) for a, b in zip(got["armed"][0],
                                                     got["unarmed"][0]))
        log(f"  elastic (a) {name}: fused armed and unarmed, bytes equal "
            f"{same}, wall {got['unarmed'][1]:.4f} s unarmed, "
            f"{got['armed'][1]:.4f} s armed [{card}]")
        if not same:
            raise Fail(f"elastic (a) {name}: armed bytes differ")
        del run, got
        torch.cuda.empty_cache()
    if registry.get("elastic.stalls") != s0:
        raise Fail("elastic (a): a stall with nothing seeded")
    x = rt.arange(ELASTIC_SMALL_N) * 1.0
    rt.sync()
    times = {"unarmed": [], "armed": []}

    def flushes():
        for tag in ("unarmed", "armed", "armed", "unarmed"):
            _elastic_env(RAMBA_WATCHDOG_S=ELASTIC_ARMED_S
                         if tag == "armed" else None)
            for i in range(ELASTIC_FLUSHES):
                t0 = time.perf_counter()
                float(rt.sum(x * 2.0 + float(i)))
                times[tag].append(time.perf_counter() - t0)
        _elastic_env(RAMBA_WATCHDOG_S=None)

    window("elastic (a) 4 x 200 flushes of sum(x * 2 + k), 2^16 f64",
           flushes, {"elemred": 4 * ELASTIC_FLUSHES})
    us = {k: (_pct(v, 0.5) * 1e6, _pct(v, 0.9) * 1e6)
          for k, v in times.items()}
    log(f"  elastic (a) host us a flush (wall to the result, order A B B A, "
        f"{2 * ELASTIC_FLUSHES} each): unarmed p50 {us['unarmed'][0]:.1f} "
        f"p90 {us['unarmed'][1]:.1f}; armed p50 {us['armed'][0]:.1f} p90 "
        f"{us['armed'][1]:.1f}; armed - unarmed p50 "
        f"{us['armed'][0] - us['unarmed'][0]:.1f} [{card}]")
    return {"flush_us": us}


def _launch_spy(mod):
    """Wrap ``mod._entry``, a kernel wrapper's build-and-bind: records,
    for each entry it returns and each call of the kernel's launch
    function, whether the calling thread's deadline had expired
    (``elastic.cancelled``).  Returns ``(record, undo)``."""
    from ramba_tpu_torch.resilience import elastic

    rec = {"entries": [], "launches": []}
    orig = mod._entry

    def entry(*a):
        t0 = time.perf_counter()
        fns = orig(*a)
        rec["entries"].append((elastic.cancelled(),
                               time.perf_counter() - t0))
        fn = fns[0]

        def launch(*b):
            rec["launches"].append(elastic.cancelled())
            return fn(*b)

        return (launch,) + tuple(fns[1:])

    mod._entry = entry
    return rec, lambda: setattr(mod, "_entry", orig)


def elastic_stall(rt, np, torch, sc, card, window, star2):
    """(b) A seeded ``dispatch`` hang on axpy + sum 2^28, the lower rungs
    not planned before: degrade-class stalls within two deadlines each
    (a lower rung whose first plan builds past the deadline stalls too),
    the result of the rung it recovers on within the ladder's bound.
    Then a first plan abandoned during its nvcc build: ``arctan`` over
    2^28 f64, a kernel no path built before, under a deadline below the
    build's time; the eager rung gives ``torch.atan``'s bytes, and the
    same program unarmed launches the built kernel.  Every zombie, when
    it wakes, launches and commits nothing, and the card's allocation
    returns to its level."""
    from ramba_tpu_torch.observe import events, registry

    import gc

    from ramba_tpu_torch.ops import elemred

    run, need, bounds = _ladder_cases(rt, np, torch, sc, star2)["axpy"](False)
    fused = window("elastic (b) axpy + sum fused", lambda: run(), need)
    x = rt.sin(rt.arange(ELASTIC_N) * 1e-3)
    rt.sync()
    want_atan = torch.atan(x._value())
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    ab0 = registry.get("elastic.abandoned_commits")
    hang = int(2.5 * ELASTIC_STALL_S * 1000)
    seen = []
    spy, undo = _launch_spy(elemred)
    events.add_tap(seen.append)
    try:
        _elastic_env(RAMBA_WATCHDOG_S=ELASTIC_STALL_S)
        try:
            outs, wall, span, steps = window(
                "elastic (b) axpy + sum under dispatch:hang",
                lambda: _ladder_run(torch, run,
                                    f"dispatch:hang:ms={hang}:after=0"), {})
        finally:
            _elastic_env(RAMBA_WATCHDOG_S=None)
        st = [e for e in seen if e.get("type") == "stall"]
        log(f"  elastic (b) events: {[(e.get('type'), e.get('site'), e.get('action') or e.get('phase'), e.get('to') or e.get('rung') or e.get('classification')) for e in seen if e.get('type') in ('stall', 'degrade', 'fault')]}; "
            f"span {span.get('degraded')}, steps {steps}")
        rung = span.get("degraded")
        ok = bool(st) and len(st) == steps \
            and rung in ("split", "chunked", "eager") \
            and all(e["classification"] == "degrade"
                    and e["waited_s"] < 2 * ELASTIC_STALL_S for e in st)
        same = _ladder_hold(torch, f"elastic (b) {rung}", outs, fused,
                            bounds(fused))
        del outs
        window("elastic (b) the zombies wake", lambda: _zombies_done(), {})
        hang_entries = list(spy["entries"])
        # a first plan abandoned during its build
        n_seen = len(seen)
        _elastic_env(RAMBA_WATCHDOG_S=ELASTIC_BUILD_S)
        try:
            got, bwall, bspan, bsteps = window(
                "elastic (b) arctan 2^28 f64, built under a deadline",
                lambda: _ladder_run(torch, lambda: [rt.arctan(x)._value()]),
                {})
        finally:
            _elastic_env(RAMBA_WATCHDOG_S=None)
        bst = [e for e in seen[n_seen:] if e.get("type") == "stall"]
        n_entries = len(spy["entries"])
        window("elastic (b) the building zombie wakes",
               lambda: _zombies_done(60.0), {})
        built = [t for c, t in spy["entries"][n_entries:] if c]
        b_same = bytes_equal(got[0], want_atan)
        log(f"  elastic (b) arctan: stalls "
            f"{[(e['site'], e['waited_s'], e['classification']) for e in bst]}"
            f" (deadline {ELASTIC_BUILD_S} s), recovered on "
            f"{bspan.get('degraded')} in {bwall:.3f} s, bytes equal to "
            f"torch.atan {b_same}; builds that ended on an abandoned thread "
            f"after {[round(t, 3) for t in built]} s [{card}]")
        ok = ok and len(bst) == 1 and bst[0]["classification"] == "degrade" \
            and bspan.get("degraded") == "eager" and b_same and built
        del got
    finally:
        events.remove_tap(seen.append)
        undo()
    zombie_launches = sum(spy["launches"])
    zombie_builds = sum(c for c, _t in spy["entries"])
    if zombie_launches:
        log(f"  elastic (b) kernel launches on abandoned threads: "
            f"{zombie_launches}")
        ok = False
    live, _w, lspan, _s = window(
        "elastic (b) arctan unarmed, the built kernel",
        lambda: _ladder_run(torch, lambda: [rt.arctan(x)._value()]),
        {"elemred": 1})
    if lspan.get("degraded"):
        raise Fail("elastic (b): arctan unarmed left the fused rung")
    _ladder_hold(torch, "elastic (b) arctan fused", [want_atan], live,
                 [(None, "8 ulp of the largest")])
    del live
    gc.collect()
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()  # x and want_atan live, as at mem0
    del x, want_atan
    ab = registry.get("elastic.abandoned_commits") - ab0
    st = st[0] if st else {"site": None, "waited_s": None,
                           "classification": None}
    log(f"  elastic (b) first stall at {st['site']} after {st['waited_s']} "
        f"s (deadline {ELASTIC_STALL_S} s) classified "
        f"{st['classification']}; recovered on {rung} in {wall:.3f} s after "
        f"{steps} stall(s), bytes equal to fused {same}; entries built or "
        f"bound on abandoned threads {zombie_builds} (the hang's "
        f"{sum(c for c, _t in hang_entries)}), kernel launches on them "
        f"{zombie_launches}; {ab} abandoned commits stopped; card "
        f"allocation {mem0} -> {mem1} [{card}]")
    # nothing of a zombie's stays allocated (an unrelated block freed
    # meanwhile may leave the level below where it was)
    if not (ok and ab == steps + len(bst) and mem1 <= mem0):
        raise Fail("elastic (b): the seeded stall")
    return {"waited_s": st["waited_s"], "wall_s": wall,
            "build_stall_s": bst[0]["waited_s"] if bst else None}


def elastic_inflight(rt, np, torch, card, window, star2):
    """(c) An attempt that blocks on the card past its deadline: under
    ``RAMBA_PERF=sync`` the fused rung waits for its launches (CUDA
    events); a spin kernel queued before the flush keeps the card busy
    longer than the deadline, so the fused attempt is abandoned with its
    launches in flight, the eager rung gives the result, and the card's
    allocation afterwards is what it was."""
    import gc

    from ramba_tpu_torch.observe import events, ledger, registry

    g = dist_grid(rt, np, (ELASTIC_GRID, ELASTIC_GRID))
    rt.sync()
    want = rt.sstencil_iterate(star2, g, ELASTIC_SWEEPS)._value()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    torch.cuda._sleep(100_000_000)
    e1.record()
    e1.synchronize()
    per_s = 100_000_000 / (e0.elapsed_time(e1) / 1e3)
    busy_s = 1.6 * ELASTIC_INFLIGHT_S
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    ab0 = registry.get("elastic.abandoned_commits")
    _elastic_env(RAMBA_WATCHDOG_S=ELASTIC_INFLIGHT_S, RAMBA_PERF="sync")
    ledger.reconfigure()

    def flush():
        t0 = time.perf_counter()
        torch.cuda._sleep(int(busy_s * per_s))
        y = rt.sstencil_iterate(star2, g, ELASTIC_SWEEPS)._value()
        torch.cuda.synchronize()
        return y, time.perf_counter() - t0

    try:
        y, wall = window("elastic (c) star2 iterate behind a busy card",
                         flush, {"stencil": None})
    finally:
        _elastic_env(RAMBA_WATCHDOG_S=None, RAMBA_PERF=None)
        ledger.reconfigure()
    span = events.last(1, type="flush")[-1]
    st = events.last(5, type="stall")[-1]
    same = bytes_equal(y, want)
    del y
    _zombies_done()
    gc.collect()
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()  # want live, as at mem0
    del want
    ab = registry.get("elastic.abandoned_commits") - ab0
    log(f"  elastic (c) card busy {busy_s:.2f} s (spin kernel, "
        f"{per_s / 1e9:.2f} G cycles/s) ahead of a 20-sweep star2 8192^2 "
        f"flush under RAMBA_PERF=sync: the fused attempt blocked on the "
        f"card past its {ELASTIC_INFLIGHT_S} s deadline (stall after "
        f"{st['waited_s']} s), recovered on {span.get('degraded')} in "
        f"{wall:.3f} s, bytes equal to the unarmed run {same}; {ab} "
        f"abandoned commit; card allocation {mem0} -> {mem1} [{card}]")
    if not (same and span.get("degraded") == "eager" and ab == 1
            and mem1 <= mem0):
        raise Fail("elastic (c): the in-flight abandonment")
    del g
    return {"wall_s": wall, "busy_s": busy_s}


def elastic_heartbeat(rt, np, torch, card, window, star2):
    """(d) Beats keep coming during 100 star2 sweeps; a seeded
    ``heartbeat`` hang is flagged as ``heartbeat_missed``."""
    from ramba_tpu_torch.observe import events
    from ramba_tpu_torch.resilience import elastic, faults

    g = dist_grid(rt, np, (ELASTIC_GRID, ELASTIC_GRID))
    rt.sync()
    elastic.start_heartbeat(ELASTIC_HEARTBEAT_S)
    fresh = []

    def sweeps():
        y = g
        t0 = time.monotonic()
        for i in range(ELASTIC_STEPS):
            y = rt.sstencil(star2, y)
            y._value()
            torch.cuda.synchronize()
            if i % 10 == 9:
                fresh.append(elastic.check_heartbeat())
        return time.monotonic() - t0

    try:
        wall = window("elastic (d) 100 star2 sweeps under the heartbeat",
                      sweeps, {"stencil": ELASTIC_STEPS})
    finally:
        elastic.stop_heartbeat()
    beats = [e["mono"] for e in events.last(4000, type="heartbeat")]
    gaps = [b - a for a, b in zip(beats, beats[1:])]
    ok = all(fresh) and len(beats) >= 3 and \
        max(gaps) <= 2 * ELASTIC_HEARTBEAT_S
    faults.configure("heartbeat:hang:ms=400:after=1")
    try:
        elastic.start_heartbeat(ELASTIC_HEARTBEAT_S)
        time.sleep(0.25)
        missed = elastic.check_heartbeat() is False
    finally:
        faults.configure(None)
        elastic.stop_heartbeat()
    flagged = any(e["phase"] == "heartbeat_missed"
                  for e in events.last(20, type="lifecycle"))
    log(f"  elastic (d) heartbeat every {ELASTIC_HEARTBEAT_S} s during 100 "
        f"star2 8192^2 sweeps ({wall:.3f} s): {len(beats)} beats, largest "
        f"gap {max(gaps) * 1e3:.1f} ms, fresh at every check {all(fresh)}; "
        f"a seeded heartbeat hang flagged heartbeat_missed "
        f"{missed and flagged} [{card}]")
    if not (ok and missed and flagged):
        raise Fail("elastic (d): the heartbeat")
    return {"beats": len(beats), "max_gap_s": max(gaps)}


def elastic_solve(rt, np, torch, root, steps_from=0, state=None,
                  kill_after=None, times=None):
    """The checkpointed star2 solver: one sweep a step up to
    ``ELASTIC_STEPS``, saved every ``ELASTIC_EVERY`` steps with
    ``ELASTIC_KEEP`` kept; ``kill_after`` kills the process (SIGKILL)
    after that step's save.  Returns the final grid."""
    import os
    import signal

    from ramba_tpu_torch.resilience import elastic

    star2 = rt.stencil(star2_body)
    mgr = elastic.CheckpointManager(root, keep=ELASTIC_KEEP,
                                    every_steps=ELASTIC_EVERY)
    g = state if state is not None else \
        dist_grid(rt, np, (ELASTIC_GRID, ELASTIC_GRID))
    for step in range(steps_from + 1, ELASTIC_STEPS + 1):
        g = rt.sstencil(star2, g)
        if step % ELASTIC_EVERY == 0:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr.maybe_save(step, {"grid": g, "step": step})
            if times is not None:
                times.append((step, time.perf_counter() - t0))
            if kill_after == step:
                os.kill(os.getpid(), signal.SIGKILL)
    return g


def elastic_child(argv) -> int:
    """One child process of ``elastic_path`` (e): ``--elastic-child solve
    ROOT`` runs the solver and is killed after step 50; ``--elastic-child
    resume ROOT OUT`` resumes the newest step and finishes, writing the
    grid's checksum to OUT."""
    import json

    import numpy as np
    import torch

    import ramba_tpu_torch as rt
    from ramba_tpu_torch.ops import stencil_kernel as sk
    from ramba_tpu_torch.resilience import elastic

    rt.set_device("cuda:0")
    i = argv.index("--elastic-child")
    what, root = argv[i + 1], argv[i + 2]
    if what == "solve":
        elastic_solve(rt, np, torch, root, kill_after=2 * ELASTIC_EVERY)
        return 1  # never reached: killed after step 50
    res = elastic.resume(root)
    g = elastic_solve(rt, np, torch, root, steps_from=res.step,
                      state=res.state["grid"])
    out = {"from_step": res.step, "digest": card_digest(g._value()),
           "stencil": sk.launches}
    with open(argv[i + 3], "w") as f:
        json.dump(out, f)
    return 0


def elastic_manager(rt, np, torch, card, window, tmp):
    """(e) The 8192^2 float32 star2 solver, 100 sweeps, saved every 25
    with keep 2 (each save's wall and GB/s, the steps GC deleted); a
    child killed after step 50 and a fresh process resuming from
    ``latest()`` end with the uninterrupted run's bytes."""
    import json
    import os

    from ramba_tpu_torch.observe import events

    from ramba_tpu_torch.resilience import elastic

    root = os.path.join(tmp, "solver")
    times, seen = [], []
    events.add_tap(seen.append)
    try:
        g = window("elastic (e) checkpointed star2 solver 8192^2 x 100",
                   lambda: elastic_solve(rt, np, torch, root, times=times),
                   {"stencil": ELASTIC_STEPS})
    finally:
        events.remove_tap(seen.append)
    gv = g._value()
    want = card_digest(gv)
    final = {"root": root, "step": ELASTIC_STEPS, "blocks": {
        "grid": _expected_blocks(torch, np, gv, (2, 2)),
        "star2": _expected_blocks(
            torch, np, rt.sstencil(rt.stencil(star2_body), g)._value(),
            (2, 2))}}
    del g, gv
    nbytes = ELASTIC_GRID * ELASTIC_GRID * 4 + 8
    deleted = [s for e in seen if e.get("phase") == "checkpoint_gc"
               for s in e["deleted_steps"]]

    mgr = elastic.CheckpointManager(root)
    log(f"  elastic (e) saves: " + ", ".join(
        f"step {s} {t:.4f} s ({nbytes / t / 1e9:.2f} GB/s)"
        for s, t in times) + f"; GC deleted steps {deleted}, kept "
        f"{mgr.valid_steps()} [{card}]")
    if [s for s, _ in times] != [25, 50, 75, 100] or \
            mgr.valid_steps() != [75, 100] or deleted != [25, 50]:
        raise Fail("elastic (e): the manager's cadence or retention")
    root2 = os.path.join(tmp, "solver_killed")
    t0 = time.perf_counter()
    me = os.path.abspath(__file__)
    p = subprocess.run([sys.executable, me, "--elastic-child", "solve",
                        root2], capture_output=True, text=True,
                       timeout=ELASTIC_LIMIT_S)
    latest = elastic.CheckpointManager(root2).latest()
    out = os.path.join(tmp, "resumed.json")
    q = subprocess.run([sys.executable, me, "--elastic-child", "resume",
                        root2, out], capture_output=True, text=True,
                       timeout=ELASTIC_LIMIT_S)
    if q.returncode != 0:
        raise Fail("elastic (e): the resuming child failed:\n"
                   + (q.stdout + q.stderr)[-4000:])
    with open(out) as f:
        got = json.load(f)
    wall = time.perf_counter() - t0
    ok = p.returncode == -9 and latest == 50 and got["from_step"] == 50 \
        and got["digest"] == want and got["stencil"] == 50
    log(f"  elastic (e) a child killed after step 50 (exit {p.returncode}, "
        f"latest() {latest}); a fresh process resumed step "
        f"{got['from_step']}, ran {got['stencil']} sweeps, and ended with "
        f"the uninterrupted run's bytes {got['digest'] == want}; "
        f"{wall:.1f} s for both children [{card}]")
    if not ok:
        raise Fail("elastic (e): the killed and resumed solver:\n"
                   + (p.stdout + p.stderr)[-2000:])
    return {"saves_s": times, "deleted": deleted, "children_s": wall,
            "final": final}


def _expected_blocks(torch, np, t, world_shape):
    """card_digest of each rank's block of ``t`` in the default layout
    of a mesh of ranks of ``world_shape`` (rank r at position
    ``unravel_index(r)``)."""
    from ramba_tpu_torch import common
    from ramba_tpu_torch.parallel import mesh as pm

    m = pm.Mesh(np.array([common.device()] * int(np.prod(world_shape)),
                         dtype=object).reshape(world_shape),
                tuple(f"d{i}" for i in range(len(world_shape))))
    sh = pm.NamedSharding(m, pm.default_spec(tuple(t.shape), m))
    idx = dict(sh.shard_indices(tuple(t.shape)))
    return [card_digest(t[idx[tuple(int(c) for c in
                                    np.unravel_index(r, world_shape))]])
            for r in range(int(np.prod(world_shape)))]


def elastic_rank_programs(rt, np, torch, er, sk, sc, rep, out):
    """One rank of ``elastic_path`` (``--elastic CASE``, the checkpoint
    root in ``RAMBA_ELASTIC_ROOT``):

    * ``lost-wedged`` / ``lost-crashed``: the grid and the series on the
      default 2x2 mesh of ranks; (wedged only) a live reshape to (4, 1),
      a sweep and a sum there, and step 1 saved; then rank 3 stops
      arriving at step 2's barrier (it sleeps, or it exits) and the
      others record what they raised and what a later collective raised;
    * ``resume``: the newest step resumed into this world, each block's
      checksum and a sweep; for the grid and the series also a sum, and
      the state saved again as the next step."""
    import json
    import os

    from ramba_tpu_torch.parallel import distributed
    from ramba_tpu_torch.parallel import mesh as pm
    from ramba_tpu_torch.resilience import elastic, retry

    rank, world = rep["rank"], distributed.process_count()
    case, root = rep["case"], rep["root"]
    star2 = rt.stencil(star2_body)
    win = lambda name, fn: _rank_window(er, sk, sc, name, fn, rep)  # noqa
    if case == "resume":
        res = win("resume", lambda: elastic.resume(root))
        g, x = res.state["grid"], res.state.get("series")
        rep["values"].update(step=res.step,
                             from_processes=res.manifest["process_count"])
        rep["digests"]["grid"] = card_digest(g._block())
        rep["digests"]["star2"] = card_digest(
            win("star2", lambda: rt.sstencil(star2, g)._block()))
        if x is None:
            return  # the solver's checkpoint: a grid and a step
        rep["digests"]["series"] = card_digest(x._block())
        rep["values"]["sum"] = win("sum", lambda: float(rt.sum(x)))
        mgr = elastic.CheckpointManager(root, keep=3)
        nxt = max(mgr.all_steps()) + 1  # past any torn step
        t0 = time.perf_counter()
        mgr.save(nxt, {"grid": g, "series": x, "step": nxt})
        rep["wall_s"]["save"] = time.perf_counter() - t0
        rep["values"]["saved"] = nxt
        return
    g = dist_grid(rt, np, (ELASTIC_GRID, ELASTIC_GRID))
    x = dist_vec(rt, ELASTIC_N)
    rt.sync()
    mgr = elastic.CheckpointManager(root, keep=3)
    if case == "lost-wedged":
        out_ = elastic.live_reshape(pm.rank_mesh((4, 1)))
        rep["values"]["reshape"] = out_
        rep["values"]["mesh"] = dict(rt.get_mesh().shape)
        rep["digests"]["grid"] = card_digest(g._block())
        rep["digests"]["series"] = card_digest(x._block())
        rep["digests"]["star2"] = card_digest(
            win("star2", lambda: rt.sstencil(star2, g)._block()))
        rep["values"]["sum"] = win("sum", lambda: float(rt.sum(x)))
        t0 = time.perf_counter()
        mgr.save(1, {"grid": g, "series": x, "step": 1})
        rep["wall_s"]["save"] = time.perf_counter() - t0
    _elastic_env(RAMBA_WATCHDOG_S=ELASTIC_LOST_S)
    if rank == world - 1:
        if case == "lost-wedged":
            time.sleep(2.5 * ELASTIC_LOST_S)
        os._exit(3)  # gone without a word: no shutdown, no destructors
    t0 = time.monotonic()
    try:
        mgr.save(2, {"grid": g, "series": x, "step": 2})
        rep["values"]["stall"] = "no error"
    except Exception as e:  # recorded for the parent
        rep["values"]["stall"] = f"{type(e).__name__}: {e}"[:300]
        rep["values"]["stall_class"] = retry.classify(e)
    rep["values"]["stall_s"] = time.monotonic() - t0
    t0 = time.monotonic()
    try:
        distributed.all_reduce_int(1)
        rep["values"]["after"] = "no error"
    except Exception as e:  # recorded for the parent
        rep["values"]["after"] = f"{type(e).__name__}: {e}"[:300]
        rep["values"]["after_class"] = retry.classify(e)
    rep["values"]["after_s"] = time.monotonic() - t0
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(rep, f)
    # a collective may still run on the barrier's helper thread: leave
    # without tearing the group down
    os._exit(0)


def elastic_ranks(world, tmp, case, root, totals, expect_rc=None):
    """``world`` ranks of this script on cuda:0 running ``case``; returns
    their reports (every rank must exit 0, or as ``expect_rc`` says)."""
    import json
    import os

    run = os.path.join(tmp, f"{case}_{world}")
    os.makedirs(os.path.join(run, f"w{world}"))
    ranks = dist_start(world, run, ("--elastic", case),
                       env=dict(os.environ, RAMBA_INIT_TIMEOUT_S="120",
                                RAMBA_ELASTIC_ROOT=root))
    logs = []
    try:
        for p in ranks:
            logs.append(p.communicate(timeout=ELASTIC_LIMIT_S)[0])
    except subprocess.TimeoutExpired:
        raise Fail(f"elastic: {world} ranks of {case} ran past their limit")
    finally:
        for p in ranks:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in ranks]
    want = expect_rc or [0] * world
    if rcs != want:
        raise Fail(f"elastic: {case} on {world} ranks exited {rcs}:\n"
                   + "\n".join(l[-3000:] for l in logs))
    reps = []
    for r in range(world):
        path = os.path.join(run, f"w{world}", f"rank{r}.json")
        if os.path.exists(path):
            with open(path) as f:
                reps.append(json.load(f))
    for r in reps:
        for c in r["launches"].values():
            for k in totals:
                totals[k] += c.get(k, 0)
    return reps


def elastic_worlds(rt, np, torch, card, window, totals, tmp, solver):
    """(f), the rank half of (g), and (h), on cuda:0 over gloo: four
    ranks reshape their mesh (2, 2) -> (4, 1) live and save step 1, then
    rank 3 stops arriving at step 2's barrier (wedged); again with rank 3
    exiting (crashed); the job restarts on 2 ranks and resumes step 1
    (4 -> 2) and saves step 3; this process resumes step 3 (2 -> 1) under
    a budget that makes the restore spill; four ranks resume the newest
    step of (e)'s solver, which one process saved (1 -> 4).  Every block
    against this process's bytes."""
    import os

    from ramba_tpu_torch.observe import events
    from ramba_tpu_torch.resilience import elastic, memory

    root = os.path.join(tmp, "worlds")
    star2 = rt.stencil(star2_body)
    g_ref = dist_grid(rt, np, (ELASTIC_GRID, ELASTIC_GRID))
    x_ref = dist_vec(rt, ELASTIC_N)
    rt.sync()
    gv, xv = g_ref._value(), x_ref._value()
    sv = rt.sstencil(star2, g_ref)._value()
    want = {"grid": card_digest(gv), "series": card_digest(xv)}
    blocks = {w: {"grid": _expected_blocks(torch, np, gv, w),
                  "series": _expected_blocks(torch, np, xv, w),
                  "star2": _expected_blocks(torch, np, sv, w)}
              for w in ((4, 1), (2,), (2, 2))}
    del gv, xv, sv
    torch.cuda.empty_cache()

    def held(reps, w, what):
        return all(r["digests"][k] == blocks[w][k][i]
                   for i, r in enumerate(reps) for k in what)

    t0 = time.perf_counter()
    lost = {}
    for case in ("lost-wedged", "lost-crashed"):
        reps = elastic_ranks(ELASTIC_RANKS, tmp, case, root, totals,
                             expect_rc=[0, 0, 0, 3])
        v = [r["values"] for r in reps]
        ok = len(reps) == 3 and all(
            x["stall"].startswith("RankStallError")
            and x["stall_class"] == "fatal"
            and x["stall_s"] < 2 * ELASTIC_LOST_S
            and x["after"].startswith("GroupBrokenError")
            and x["after_s"] < 0.5 for x in v)
        lost[case] = (max(x["stall_s"] for x in v),
                      max(x["after_s"] for x in v))
        log(f"  elastic (h) {case.split('-')[1]} rank 3 at step 2's "
            f"barrier: ranks 0-2 raised {sorted({x['stall'][:60] for x in v})}"
            f" class {sorted({x.get('stall_class') for x in v})} within "
            f"{lost[case][0]:.3f} s (deadline {ELASTIC_LOST_S} s); a later "
            f"collective raised {sorted({x['after'][:40] for x in v})} in "
            f"{lost[case][1] * 1e3:.3f} ms {'ok' if ok else 'MISS'} [{card}]")
        if not ok:
            raise Fail(f"elastic (h): {case}")
        if case == "lost-wedged":
            rs = [x["reshape"] for x in v]
            ok = all(r["mode"] == "live" for r in rs) and \
                all(x["mesh"] == {"d0": 4, "d1": 1} for x in v) and \
                held(reps, (4, 1), ("grid", "series", "star2"))
            log(f"  elastic (g) 4 ranks (2, 2) -> (4, 1) live: "
                f"{[r['bytes'] for r in rs]} bytes a rank in "
                f"{max(r['wall_s'] for r in rs):.3f} s "
                f"({sum(r['bytes'] for r in rs) / max(r['wall_s'] for r in rs) / 1e9:.2f} GB/s "
                f"over the ranks), blocks and a sweep byte-equal to one "
                f"process {ok}; sums {sorted({x['sum'] for x in v})}; step 1 "
                f"saved in {max(r['wall_s']['save'] for r in reps):.2f} s "
                f"[{card}]")
            if not ok or len({x["sum"] for x in v}) != 1:
                raise Fail("elastic (g): the live reshape of a rank mesh")
    if elastic.CheckpointManager(root).latest() != 1:
        raise Fail("elastic (h): the newest valid step is not step 1")
    reps = elastic_ranks(2, tmp, "resume", root, totals)
    ok = all(r["values"]["step"] == 1 and r["values"]["from_processes"] == 4
             for r in reps) and held(reps, (2,), ("grid", "series", "star2"))
    log(f"  elastic (f)/(h) restarted on 2 ranks: resumed step 1 saved by 4, "
        f"blocks and a sweep byte-equal {ok}; saved step "
        f"{reps[0]['values']['saved']} in "
        f"{max(r['wall_s']['save'] for r in reps):.2f} s [{card}]")
    if not ok:
        raise Fail("elastic (f): 4 -> 2")
    # 2 -> 1 in this process, under a budget that makes the restore spill
    live = memory.ledger.live_bytes
    incoming = ELASTIC_GRID * ELASTIC_GRID * 4 + ELASTIC_N * 8 + 8
    _elastic_env(RAMBA_HBM_BUDGET=live + incoming // 2)
    try:
        res = window("elastic (f) resume 2 -> 1 under a tight budget",
                     lambda: elastic.resume(root), {})
    finally:
        _elastic_env(RAMBA_HBM_BUDGET=None)
    adm = [e for e in events.last(20, type="lifecycle")
           if e["phase"] == "restore_admit"]
    freed = adm[-1]["freed_bytes"] if adm else 0
    g1, x1 = res.state["grid"], res.state["series"]
    ok = res.step == 3 and res.manifest["process_count"] == 2 and \
        card_digest(g1._value()) == want["grid"] and \
        card_digest(x1._value()) == want["series"] and freed > 0
    log(f"  elastic (f) resumed step 3 saved by 2 ranks in this process "
        f"under RAMBA_HBM_BUDGET = live + incoming / 2: admission freed "
        f"{freed} bytes, arrays byte-equal {ok} [{card}]")
    if not ok:
        raise Fail("elastic (f): 2 -> 1")
    del res, g1, x1
    torch.cuda.empty_cache()
    reps = elastic_ranks(ELASTIC_RANKS, tmp, "resume", solver["root"],
                         totals)
    ok = all(r["values"]["step"] == solver["step"]
             and r["values"]["from_processes"] == 1 for r in reps) and all(
        r["digests"][k] == solver["blocks"][k][i]
        for i, r in enumerate(reps) for k in ("grid", "star2"))
    wall = time.perf_counter() - t0
    log(f"  elastic (f) 1 -> 4 ranks: resumed step {solver['step']} of "
        f"(e)'s solver, saved by one process; blocks and a sweep "
        f"byte-equal {ok}; the worlds took {wall:.1f} s [{card}]")
    if not ok:
        raise Fail("elastic (f): 1 -> 4")
    # the spilled references come back byte-equal on their next read
    if card_digest(g_ref._value()) != want["grid"]:
        raise Fail("elastic (f): a spilled array came back changed")
    return {"lost": lost, "worlds_s": wall, "freed_bytes": freed}


def elastic_reshape(rt, np, torch, card, window, tmp):
    """(g) In one process: the grid and the series live on a 2x2 mesh of
    shards, reshaped to 4x1 and to one shard (bytes moved, wall to the
    card's end, GB/s), byte-equal, a stencil sweep and a sum on each new
    mesh equal to one shard's; then, the grid alone live, a
    ``reshard:stage`` fault back to 2x2 falls back to the checkpoint,
    byte-equal."""
    import gc
    import os

    from ramba_tpu_torch import common
    from ramba_tpu_torch.parallel import mesh as pm
    from ramba_tpu_torch.resilience import elastic, faults, memory

    dev = common.device()
    old = pm.get_mesh()
    star2 = rt.stencil(star2_body)

    def grid_mesh(*shape):
        return pm.Mesh(np.array([dev] * int(np.prod(shape)),
                                dtype=object).reshape(shape),
                       tuple(f"d{i}" for i in range(len(shape))))

    g0 = dist_grid(rt, np, (ELASTIC_GRID, ELASTIC_GRID))
    x0 = dist_vec(rt, ELASTIC_N)
    want = {"grid": card_digest(g0._value()), "series": card_digest(
        x0._value()), "star2": card_digest(rt.sstencil(star2, g0)._value()),
        "sum": float(rt.sum(x0))}
    del g0, x0
    torch.cuda.empty_cache()
    out = {}
    try:
        pm.set_mesh(grid_mesh(2, 2))
        g = dist_grid(rt, np, (ELASTIC_GRID, ELASTIC_GRID))
        x = dist_vec(rt, ELASTIC_N)
        rt.sync()
        gc.collect()
        live = [tuple(e.consts[0]().shape) for e in
                memory.ledger.entries.values() if e.consts[0]() is not None]

        def reshape(m):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = elastic.live_reshape(m)
            torch.cuda.synchronize()
            r["wall_s"] = time.perf_counter() - t
            return r

        for tag, m in (("4x1", grid_mesh(4, 1)), ("1", grid_mesh(1))):
            r = window(f"elastic (g) live reshape -> {tag}",
                       lambda: reshape(m), {})
            got = {"grid": card_digest(g._value()),
                   "series": card_digest(x._value())}
            got["star2"] = window(
                f"elastic (g) a sweep on {tag}",
                lambda: card_digest(rt.sstencil(star2, g)._value()),
                {"stencil": None})
            got["sum"] = window(f"elastic (g) a sum on {tag}",
                                lambda: float(rt.sum(x)), {"elemred": 1})
            ok = r["mode"] == "live" and got == want
            log(f"  elastic (g) one process 2x2 shards -> {tag}: "
                f"{r['arrays']} arrays (live: {live}), {r['bytes']} bytes "
                f"moved in "
                f"{r['wall_s']:.4f} s to the card's end "
                f"({r['bytes'] / r['wall_s'] / 1e9:.2f} GB/s), byte-equal, a "
                f"sweep and a sum equal to one shard's {ok} [{card}]")
            if not ok:
                raise Fail(f"elastic (g): the live reshape -> {tag}")
            out[tag] = r
        del x
        gc.collect()
        faults.configure("reshard:stage:always")
        try:
            r = elastic.live_reshape(grid_mesh(2, 2),
                                     manager=os.path.join(tmp, "fallback"))
        finally:
            faults.configure(None)
        ok = r["mode"] == "checkpoint" and \
            card_digest(g._value()) == want["grid"]
        log(f"  elastic (g) a reshard:stage fault on the way back to 2x2 "
            f"(the grid live, {r['arrays']} arrays, {r['bytes']} bytes): mode "
            f"{r['mode']} in {r['wall_s']:.2f} s, byte-equal {ok} [{card}]")
        if not ok:
            raise Fail("elastic (g): the checkpoint fallback")
        out["fallback"] = r
    finally:
        pm.set_mesh(old)
    return out


def elastic_path(rt, er, sk, sg, sc, torch, np, card, window, totals,
                 only=None):
    """The elastic plane on the card (ROADMAP A.8 part three), (a)-(h)
    as their functions say; ``only``: the parts to run (all: None)."""
    import tempfile

    t0 = time.perf_counter()
    star2 = rt.stencil(star2_body)
    out, walls = {}, {}

    def part(name, fn, *a):
        if only is not None and name not in only:
            return
        t = time.perf_counter()
        out[name] = fn(*a)
        walls[name] = time.perf_counter() - t
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="ramba_elastic_") as tmp:
        part("armed", elastic_armed, rt, np, torch, sc, card, window, star2)
        part("stall", elastic_stall, rt, np, torch, sc, card, window, star2)
        part("inflight", elastic_inflight, rt, np, torch, card, window,
             star2)
        part("heartbeat", elastic_heartbeat, rt, np, torch, card, window,
             star2)
        part("manager", elastic_manager, rt, np, torch, card, window, tmp)
        if only is None or "worlds" in only:
            if "manager" not in out:
                raise Fail("elastic (f) resumes (e)'s solver: run both")
            part("worlds", elastic_worlds, rt, np, torch, card, window,
                 totals, tmp, out["manager"]["final"])
        part("reshape", elastic_reshape, rt, np, torch, card, window, tmp)
    out["wall_s"] = time.perf_counter() - t0
    out["part_walls_s"] = walls
    log(f"  elastic_path: {out['wall_s']:.1f} s, by part (s) "
        f"{json.dumps(walls)} [{card}]")
    return out


OBSERVE_N = 10 ** 9                 # the sin/cos chain's base, float64
OBSERVE_VEC_N = 1 << 28             # axpy + sum, the series, cumsum
OBSERVE_GRID = 8192                 # star2, float32 (TMA)
OBSERVE_ODD = (4099, 4133)          # star2, float32 (cp.async)
OBSERVE_SWEEPS = (30, 100)          # (chained, iterated) per flush
OBSERVE_REPS = 7                    # flushes a program in (a)
OBSERVE_FLUSHES = 200               # small flushes a setting in (b)
OBSERVE_SMALL_N = 1 << 16           # their operand, float64
OBSERVE_CHAIN_REPS = 6              # chained-sweep flushes a setting in (b)
OBSERVE_SLO_FLUSHES = 25            # chained-sweep flushes in (d)
OBSERVE_SLO_SWEEPS = 24             # their sweeps: mid-bucket (6.1-6.7 ms
                                    # a flush, NVIDIA H100 80GB HBM3, 700 W)
OBSERVE_PROFILE_SWEEPS = 10         # one-sweep flushes in (f)
OBSERVE_RANKS = 4
OBSERVE_RANK_SWEEPS = 10
OBSERVE_SAMPLE = {"b": 16, "h": 4}  # RAMBA_ATTRIB=sample:<N> of (b), (h)
OBSERVE_LIMIT_S = 300               # per child or launch of ranks
OBSERVE_TOL = 0.10                  # device p50, rooflines, SLO quantiles


def _observe_cases(rt, np, torch, star2):
    """name -> make(): ``(run, need)``; ``run()`` builds, flushes and
    returns the output tensors of one main-path program at full width;
    ``need`` its launches a flush."""

    def sincos():
        base = rt.arange(OBSERVE_N) / 1000.0
        rt.sync()

        def run():
            B, C = rt.sin(base), rt.cos(base)
            D = B * B + C * C
            s = rt.sum(D)
            del B, C
            return [D._value(), s._value()]

        return run, {"elemred": 1}

    def axpy():
        x = rt.sin(rt.arange(OBSERVE_VEC_N) * 1e-3)
        y = rt.cos(rt.arange(OBSERVE_VEC_N) * 1e-3)
        rt.sync()
        return (lambda: [rt.sum(2.5 * x + y)._value()]), {"elemred": 1}

    def star2_grid(shape, chained):
        def make():
            x = rt.fromarray(torch.rand(shape, dtype=torch.float32,
                                        generator=_gen(torch, 3),
                                        device="cuda"))
            rt.sync()
            k = OBSERVE_SWEEPS[0] if chained else OBSERVE_SWEEPS[1]

            def run():
                if chained:
                    y = x
                    for _ in range(k):
                        y = rt.sstencil(star2, y)
                else:
                    y = rt.sstencil_iterate(star2, x, k)
                return [y._value()]

            return run, {"stencil": k}

        return make

    def groupby():
        x_t, hour = hourly_series(torch, np, OBSERVE_VEC_N)
        g = rt.fromarray(x_t).groupby(0, hour, num_groups=24)
        return (lambda: [g.sum()._value()]), {"segred": 1}

    def cumsum():
        x = rt.sin(rt.arange(OBSERVE_VEC_N) * 1e-3)
        rt.sync()
        return (lambda: [rt.cumsum(x)._value()]), {"scan": 1}

    # 4099x4133 iterated only: its chained flush is host-bound (on an
    # NVIDIA H100 80GB HBM3 at 700 W, 2.7-3.1 ms of host work a flush
    # against 30 kernels of 0.077 ms), so its fenced window carries the
    # host's jitter (+14 and +35 % against the same call alone in two of
    # four runs)
    g2 = (OBSERVE_GRID, OBSERVE_GRID)
    return {"sincos_1e9": sincos, "axpy": axpy,
            "star2_chained": star2_grid(g2, True),
            "star2_iterate": star2_grid(g2, False),
            "star2_odd_iterate": star2_grid(OBSERVE_ODD, False),
            "groupby": groupby, "cumsum": cumsum}


def _capture_calls(fuser):
    """Wrap ``fuser._execute_compiled``: the last ``(fn, leaf_vals)`` each
    fingerprint ran with.  Returns ``(calls, undo)``."""
    calls = {}
    orig = fuser._execute_compiled

    def spy(fn, program, leaf_vals, is_new, span, fp, *a, **kw):
        calls[fp] = (fn, list(leaf_vals))
        return orig(fn, program, leaf_vals, is_new, span, fp, *a, **kw)

    fuser._execute_compiled = spy
    return calls, lambda: setattr(fuser, "_execute_compiled", orig)


def _events_p50_ms(torch, fn, args, reps=5):
    """The p50 over ``reps`` of one call bracketed by its own CUDA events
    (a first call before them), and of the host's time to issue it."""
    fn(*args)
    ms, host = [], []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        fn(*args)
        e1.record()
        host.append((time.perf_counter() - t0) * 1e3)
        e1.synchronize()
        ms.append(e0.elapsed_time(e1))
    return sorted(ms)[len(ms) // 2], sorted(host)[len(host) // 2]


def _reconciles(span):
    st = span.get("stages", {})
    return abs(sum(st.values()) + span["unattributed_s"] - span["wall_s"]) \
        <= 2e-5 * (len(st) + 2)


def observe_main(rt, np, torch, card, window, star2):
    """(a) Every main-path program at full width with attribution on:
    each span reconciles (stages + unattributed = wall); the median
    unattributed share of a program's steady spans is at most 5 %; each
    kernel fingerprint's fenced device p50 agrees within 10 % with the
    same compiled call timed by this path's own CUDA events; its
    roofline reads ``bandwidth`` with a fraction of peak within 10 % of
    bound / device p50 from the ledger's counts; the results are
    byte-equal to ``RAMBA_ATTRIB=off``."""
    import statistics

    from ramba_tpu_torch.core import fuser
    from ramba_tpu_torch.observe import attrib, events, ledger

    attrib.reset()
    attrib.reconfigure()
    cases = _observe_cases(rt, np, torch, star2)
    out = {}
    for name, make in cases.items():
        run, need = make()
        seen = []
        events.add_tap(seen.append)
        calls, undo = _capture_calls(fuser)
        try:
            for r in range(OBSERVE_REPS):
                outs = window(f"observe (a) {name} #{r}", run, need)
        finally:
            undo()
            events.remove_tap(seen.append)
        spans = [e for e in seen if e.get("type") == "flush"]
        steady = [s for s in spans if s.get("cache") == "hit"]
        if not steady or not all(_reconciles(s) for s in spans):
            raise Fail(f"observe (a) {name}: spans do not reconcile: "
                       f"{spans[-1]}")
        fp = steady[-1]["fingerprint"]
        un = statistics.median(s["unattributed_s"] / s["wall_s"]
                               for s in steady)
        row = attrib.roofline_report().get(fp)
        if row is None or row["device_time_source"] != "fence":
            raise Fail(f"observe (a) {name}: no fenced roofline row {row}")
        dev_ms = row["device_p50_s"] * 1e3
        fn, lv = calls[fp]
        own_ms, own_host = _events_p50_ms(torch, fn, lv)
        issue = sorted(s["stages"]["dispatch"] for s in steady)[
            len(steady) // 2] * 1e3
        del calls, lv, fn
        k = ledger.snapshot()["kernels"][fp]
        flops, nbytes = float(k.get("flops") or 0.0), float(
            k.get("bytes_accessed") or 0.0)
        peaks = attrib.peak_table()
        bound_s = max(nbytes / (peaks["peak_gbps"] * 1e9),
                      flops / (peaks["peak_tflops"] * 1e12))
        want_frac = bound_s / row["device_p50_s"]
        _elastic_env(RAMBA_ATTRIB="off")
        attrib.reconfigure()
        try:
            off = run()
        finally:
            _elastic_env(RAMBA_ATTRIB=None)
            attrib.reconfigure()
        same = all(bytes_equal(a, b) for a, b in zip(outs, off))
        log(f"  observe (a) {name}: fp {fp}, {len(spans)} spans reconcile, "
            f"median unattributed {un:.2%} of wall, fenced device p50 "
            f"{dev_ms:.4f} ms against this path's CUDA events "
            f"{own_ms:.4f} ms ({dev_ms / own_ms - 1:+.2%}; host issue "
            f"{issue:.4f} ms in the flush, {own_host:.4f} ms alone), "
            f"roofline "
            f"{row['bound']} frac_of_peak {row['frac_of_peak']:.4f} "
            f"(bound/p50 {want_frac:.4f}, {flops:.4g} flops, {nbytes:.4g} "
            f"bytes, peaks {peaks['peak_gbps']:g} GB/s "
            f"{peaks['peak_tflops']:g} TFLOP/s from {peaks['source']}), "
            f"bytes equal to RAMBA_ATTRIB=off {same} [{card}]")
        out[name] = {"fp": fp, "spans": len(spans), "unattributed_median": un,
                     "device_p50_ms": dev_ms, "events_p50_ms": own_ms,
                     "issue_ms": issue, "issue_alone_ms": own_host,
                     "frac_of_peak": row["frac_of_peak"],
                     "bound_over_p50": want_frac, "flops": flops,
                     "bytes": nbytes, "byte_equal_off": same,
                     "stages": list(steady[-1]["stages"])}
        if un > 0.05:
            raise Fail(f"observe (a) {name}: median unattributed {un:.2%}")
        if abs(dev_ms - own_ms) > OBSERVE_TOL * own_ms:
            raise Fail(f"observe (a) {name}: device p50 {dev_ms} ms against "
                       f"{own_ms} ms")
        if row["bound"] != "bandwidth" or abs(
                row["frac_of_peak"] - want_frac) > OBSERVE_TOL * want_frac:
            raise Fail(f"observe (a) {name}: roofline {row}")
        if not same:
            raise Fail(f"observe (a) {name}: bytes differ under "
                       "RAMBA_ATTRIB=off")
        del run, outs, off, seen, spans, steady
        torch.cuda.empty_cache()
    return out


def observe_fence_cost(rt, np, torch, card, window, star2):
    """(b) What the fence costs: 30 chained star2 sweeps (8192^2) and 200
    flushes of ``sum(x * 2 + k)`` over 2^16 f64 with ``RAMBA_ATTRIB``
    unset, ``off`` and ``sample:16`` (order A B C C B A): ms a sweep and
    host us a flush at p50 and p90, the same bytes under all three, and
    ``sample:16`` fencing exactly sequences 0, 16, 32, ... of every
    fingerprint."""
    from ramba_tpu_torch.observe import attrib, events, observer

    n16 = OBSERVE_SAMPLE["b"]
    xs = rt.fromarray(torch.rand((OBSERVE_GRID, OBSERVE_GRID),
                                 dtype=torch.float32, generator=_gen(torch, 5),
                                 device="cuda"))
    x = rt.arange(OBSERVE_SMALL_N) * 1.0
    rt.sync()
    settings = (None, "off", f"sample:{n16}")
    sweep_ms = {s: [] for s in settings}
    flush_us = {s: [] for s in settings}
    stages = {s: [] for s in settings}
    fence_s = {s: [0.0, 0] for s in settings}
    ys, sums, fences = {}, {s: [] for s in settings}, None
    current = [None]

    def small_span(e):
        if e.get("type") == "flush" and e.get("out_bytes") == 8:
            stages[current[0]].append(e["stages"])

    def block(setting):
        nonlocal fences
        current[0] = setting
        _elastic_env(RAMBA_ATTRIB=setting)
        attrib.reconfigure()
        f0 = observer.snapshot()["components"].get(
            "fence", {"seconds": 0.0, "count": 0})
        if setting == f"sample:{n16}" and not sweep_ms[setting]:
            attrib.reset()  # the fence log counts from here
        for _ in range(OBSERVE_CHAIN_REPS // 2):
            t0 = time.perf_counter()
            y = xs
            for _ in range(OBSERVE_SWEEPS[0]):
                y = rt.sstencil(star2, y)
            float(rt.sum(y))
            sweep_ms[setting].append(
                (time.perf_counter() - t0) / OBSERVE_SWEEPS[0] * 1e3)
            ys[setting] = y._value()
        got = []
        events.add_tap(small_span)
        try:
            for i in range(OBSERVE_FLUSHES // 2):
                t0 = time.perf_counter()
                got.append(float(rt.sum(x * 2.0 + float(i))))
                flush_us[setting].append((time.perf_counter() - t0) * 1e6)
        finally:
            events.remove_tap(small_span)
        sums[setting].append(got)
        f1 = observer.snapshot()["components"].get(
            "fence", {"seconds": 0.0, "count": 0})
        fence_s[setting][0] += f1["seconds"] - f0["seconds"]
        fence_s[setting][1] += f1["count"] - f0["count"]
        if setting == f"sample:{n16}":
            fences = attrib.sampling_report()["fingerprints"]

    def all_blocks():
        _chained_flush(rt, star2, xs, OBSERVE_SWEEPS[0])  # warm: planned
        float(rt.sum(x * 2.0 + 0.5))
        for s in settings + settings[::-1]:
            block(s)
        _elastic_env(RAMBA_ATTRIB=None)
        attrib.reconfigure()

    window("observe (b) the fence's cost, A B C C B A", all_blocks,
           {"stencil": (6 * OBSERVE_CHAIN_REPS // 2 + 1) * OBSERVE_SWEEPS[0],
            "elemred": 6 * OBSERVE_FLUSHES // 2 + 1})
    same = all(bytes_equal(ys[s], ys[None]) for s in settings) and all(
        sums[s] == sums[None] for s in settings)
    lockstep = bool(fences) and all(
        d["fenced_seqs"] == list(range(0, d["calls"], n16))[:64]
        for d in fences.values())
    res = {}
    for s in settings:
        tag = s or "unset"

        def mean_us(k, s=s):
            v = [st.get(k, 0.0) for st in stages[s]]
            return sum(v) / max(1, len(v)) * 1e6

        res[tag] = {"sweep_ms_p50": _pct(sweep_ms[s], 0.5),
                    "sweep_ms_p90": _pct(sweep_ms[s], 0.9),
                    "flush_us_p50": _pct(flush_us[s], 0.5),
                    "flush_us_p90": _pct(flush_us[s], 0.9),
                    "stage_us_mean": {k: mean_us(k) for k in attrib.STAGES
                                      if any(k in st for st in stages[s])},
                    "fence_us_a_call": fence_s[s][0] / max(1, fence_s[s][1])
                    * 1e6, "fenced_calls": fence_s[s][1]}
        log(f"  observe (b) RAMBA_ATTRIB={tag}: chained star2 8192^2 "
            f"{res[tag]['sweep_ms_p50']:.4f} ms/sweep p50, "
            f"{res[tag]['sweep_ms_p90']:.4f} p90 ({len(sweep_ms[s])} flushes "
            f"of 30 sweeps, graph building included); sum(x * 2 + k) 2^16 "
            f"f64 host {res[tag]['flush_us_p50']:.1f} us/flush p50, "
            f"{res[tag]['flush_us_p90']:.1f} p90 ({len(flush_us[s])} "
            f"flushes; mean stages us "
            f"{ {k: round(v, 1) for k, v in res[tag]['stage_us_mean'].items()} }"
            f", the fence's wait {res[tag]['fence_us_a_call']:.1f} us a call "
            f"over {res[tag]['fenced_calls']} fenced calls of both "
            f"programs) [{card}]")
    log(f"  observe (b) the same bytes under all three {same}; "
        f"sample:{n16} fenced sequences 0, {n16}, {2 * n16}, ... of every "
        f"fingerprint {lockstep} "
        f"({ {fp: (d['calls'], d['fenced_seqs'][:4]) for fp, d in fences.items()} }) "
        f"[{card}]")
    if not same:
        raise Fail("observe (b): the fence settings give different bytes")
    if not lockstep:
        raise Fail(f"observe (b): sample:{n16} fence log {fences}")
    res["byte_equal"] = same
    return res


def observe_child(argv) -> int:
    """One process of ``observe_path`` (c): axpy + sum at 2^28 f64, nine
    flushes, under the environment's ``RAMBA_BASELINE_DIR``; prints its
    regressions, events and device p50 as one JSON line."""
    import torch

    import ramba_tpu_torch as rt
    from ramba_tpu_torch.observe import attrib, events

    rt.set_device("cuda:0")
    x = rt.sin(rt.arange(OBSERVE_VEC_N) * 1e-3)
    y = rt.cos(rt.arange(OBSERVE_VEC_N) * 1e-3)
    rt.sync()
    vals = [float(rt.sum(2.5 * x + y)) for _ in range(9)]
    torch.cuda.synchronize()
    regs = events.last(0, type="perf_regression")
    fps = {e.get("fingerprint") for e in events.last(0, type="flush")}
    p50 = {fp: r["device_p50_s"] for fp, r in
           attrib.roofline_report().items() if fp in fps}
    print(json.dumps({"regressions": len(regs), "events": regs,
                      "device_p50_s": p50, "sums": vals,
                      "baselines_loaded": attrib.load_baselines()}),
          flush=True)
    return 0


def _observe_child_run(env):
    import os

    p = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--observe-child"], env=env, capture_output=True,
                       text=True, timeout=OBSERVE_LIMIT_S)
    if p.returncode != 0:
        raise Fail(f"observe (c) child exited {p.returncode}:\n"
                   + (p.stdout + p.stderr)[-4000:])
    return json.loads(p.stdout.strip().splitlines()[-1])


def observe_drift(rt, np, torch, card, flight):
    """(c) The drift sentinel across processes: a child runs axpy + sum
    with ``RAMBA_BASELINE_DIR`` set and saves its baselines at exit; the
    file is edited to a third of each p50; a second child emits exactly
    one ``perf_regression`` and writes one flight dump, and the baseline
    it saves does not rise."""
    import glob
    import os
    import tempfile

    with tempfile.TemporaryDirectory(prefix="ramba_observe_base_") as base:
        env = dict(os.environ, RAMBA_BASELINE_DIR=base)
        for k in ("RAMBA_FLIGHT_DIR", "RAMBA_ATTRIB", "RAMBA_FAULTS"):
            env.pop(k, None)
        t0 = time.perf_counter()
        first = _observe_child_run(env)
        path = os.path.join(base, "perf_baseline.json")
        with open(path) as f:
            doc = json.load(f)
        saved = {fp: b["p50_s"] for fp, b in doc["kernels"].items()}
        for b in doc["kernels"].values():
            b["p50_s"] = b["p50_s"] / 3.0
        edited = {fp: b["p50_s"] for fp, b in doc["kernels"].items()}
        with open(path, "w") as f:
            json.dump(doc, f)
        second = _observe_child_run(dict(env, RAMBA_FLIGHT_DIR=flight))
        with open(path) as f:
            after = {fp: b["p50_s"] for fp, b in
                     json.load(f)["kernels"].items()}
        wall = time.perf_counter() - t0
    dumps = [json.load(open(p))["incident"]["type"]
             for p in glob.glob(os.path.join(flight, "flight_*.json"))]
    ev = second["events"][0] if second["events"] else {}
    not_raised = all(after[fp] <= edited[fp] for fp in edited)
    log(f"  observe (c) first child: device p50 {first['device_p50_s']}, "
        f"saved baselines {saved}, {first['regressions']} regressions; "
        f"edited to a third {edited}; second child: "
        f"{second['regressions']} perf_regression (drift "
        f"{ev.get('drift')}, why {ev.get('why')!r}), flight dumps "
        f"{dumps}, baseline after {after} (not raised {not_raised}); the "
        f"same sums {first['sums'] == second['sums']}; {wall:.1f} s "
        f"[{card}]")
    if first["regressions"] or second["regressions"] != 1 or \
            dumps != ["perf_regression"] or not not_raised or \
            first["sums"] != second["sums"]:
        raise Fail("observe (c): the drift sentinel across processes")
    return {"saved": saved, "edited": edited, "after": after,
            "drift": ev.get("drift"), "wall_s": wall}


def _chained_flush(rt, star2, xs, k):
    """One flush of ``k`` chained sweeps and their sum: (the sum, the wall
    of the flush as this script times it, graph building left out)."""
    y = xs
    for _ in range(k):
        y = rt.sstencil(star2, y)
    s = rt.sum(y)
    t0 = time.perf_counter()
    rt.sync()
    return float(s), time.perf_counter() - t0


def observe_slo(rt, np, torch, card, window, star2, flight):
    """(d) An objective below the chained sweep's p95 (half its p50):
    exactly one ``slo_breach``, carrying ``why``; the e2e histogram's
    p50 and p95 within 10 % of the same estimator over this path's own
    wall of each flush (the histogram's fixed buckets are the
    reference's; the exact quantiles are printed beside)."""
    import os

    from ramba_tpu_torch.observe import events, slo

    xs = rt.fromarray(torch.rand((OBSERVE_GRID, OBSERVE_GRID),
                                 dtype=torch.float32, generator=_gen(torch, 7),
                                 device="cuda"))
    rt.sync()
    k = OBSERVE_SLO_SWEEPS
    probe = [_chained_flush(rt, star2, xs, k)[1] for _ in range(10)]
    objective_ms = 0.5 * _pct(probe, 0.5) * 1e3
    os.environ["RAMBA_FLIGHT_DIR"] = flight
    slo.reset()
    slo.reconfigure(objective_ms=objective_ms, min_samples=20)
    b0 = len(events.last(0, type="slo_breach"))
    own = []

    def flushes():
        for _ in range(OBSERVE_SLO_FLUSHES):
            own.append(_chained_flush(rt, star2, xs, k)[1])

    try:
        window("observe (d) chained star2 flushes under an objective",
               flushes, {"stencil": OBSERVE_SLO_FLUSHES * k})
    finally:
        os.environ.pop("RAMBA_FLIGHT_DIR", None)
    breaches = events.last(0, type="slo_breach")[b0:]
    hist = slo.snapshot()["histograms"]["e2e"][""]
    ref = slo.Histogram()
    for w in own:
        ref.observe(w)
    mine = ref.summary()
    exact = (_pct(own, 0.5) * 1e3, _pct(own, 0.95) * 1e3)
    ok_q = all(abs(hist[q] - mine[q]) <= OBSERVE_TOL * mine[q]
               for q in ("p50_ms", "p95_ms"))
    why = breaches[0].get("why") if breaches else None
    log(f"  observe (d) objective {objective_ms:.3f} ms (half the probe's "
        f"p50): {len(breaches)} slo_breach, why {why!r}; e2e histogram "
        f"p50 {hist['p50_ms']} ms p95 {hist['p95_ms']} ms ({hist['count']} "
        f"flushes) against the same buckets over this path's own walls "
        f"p50 {mine['p50_ms']} p95 {mine['p95_ms']} (within 10 %: {ok_q}); "
        f"exact p50 {exact[0]:.4f} ms p95 {exact[1]:.4f} ms [{card}]")
    slo.reset()
    slo.reconfigure()
    if len(breaches) != 1 or not why or not ok_q or \
            hist["count"] != OBSERVE_SLO_FLUSHES:
        raise Fail("observe (d): the SLO breach or its histogram")
    return {"objective_ms": objective_ms, "why": why,
            "hist_p50_ms": hist["p50_ms"], "hist_p95_ms": hist["p95_ms"],
            "own_p50_ms": mine["p50_ms"], "own_p95_ms": mine["p95_ms"],
            "exact_p50_ms": exact[0], "exact_p95_ms": exact[1]}


def _scrape(port, path="/metrics"):
    import urllib.request

    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                  timeout=10).read().decode()


def _series(body, name):
    """``{labels: value}`` of one family in an exposition."""
    out = {}
    for ln in body.splitlines():
        if ln.startswith(name + "{"):
            lab, val = ln[len(name):].rsplit(" ", 1)
            out[lab] = float(val)
    return out


def observe_telemetry(rt, np, torch, card, window, star2, flight):
    """(e) The exporter on 127.0.0.1 (port 0) scraped during chained
    sweeps (every scrape's histogram buckets monotone); the flush and
    stage-seconds series of a scrape against the registry's and the
    attribution plane's snapshots taken after it; the text file read
    while it is rewritten every 20 ms (every read whole, no temporary
    left); the flight directory holding one dump per incident kind
    seeded in (c) and (d), and no more."""
    import glob
    import os
    import tempfile
    import threading

    from ramba_tpu_torch.observe import attrib, registry, telemetry

    xs = rt.fromarray(torch.rand((OBSERVE_GRID, OBSERVE_GRID),
                                 dtype=torch.float32, generator=_gen(torch, 9),
                                 device="cuda"))
    rt.sync()
    os.environ["RAMBA_METRICS_HOST"] = "127.0.0.1"
    tdir = tempfile.mkdtemp(prefix="ramba_observe_prom_")
    prom = os.path.join(tdir, "ramba.prom")
    port = telemetry.start(port=0)
    telemetry.start(path=prom, interval_s=0.02)
    errs, scrapes, reads = [], 0, 0
    done = threading.Event()

    def sweeps():
        try:
            for _ in range(10):
                _chained_flush(rt, star2, xs, OBSERVE_SWEEPS[0])
        except Exception as e:  # the scraping thread reports it
            errs.append(repr(e))
        finally:
            done.set()

    def run():
        nonlocal scrapes, reads
        t = threading.Thread(target=sweeps)
        t.start()
        while not done.is_set():
            per = {}
            for ln in _scrape(port).splitlines():
                if "_bucket{" in ln:
                    key = (ln.split("{")[0], ln.split('tenant="')[1]
                           .split('"')[0])
                    per.setdefault(key, []).append(float(ln.rsplit(" ", 1)[1]))
            if any(v != sorted(v) for v in per.values()):
                errs.append(f"buckets not monotone: {per}")
            scrapes += 1
            if os.path.exists(prom):
                text = open(prom).read()
                reads += 1
                if not (text.endswith("\n") and
                        "ramba_scrape_timestamp_seconds{" in text):
                    errs.append("a torn text file")
            time.sleep(0.005)
        t.join()

    try:
        window("observe (e) chained sweeps under the exporter", run,
               {"stencil": 10 * OBSERVE_SWEEPS[0]})
        body = _scrape(port)
        health = json.loads(_scrape(port, "/healthz"))
        rep, reg = attrib.attribution_report(), registry.snapshot()
    finally:
        telemetry.stop()
        os.environ.pop("RAMBA_METRICS_HOST", None)
    stages = {lab.split('stage="')[1].split('"')[0]: v
              for lab, v in _series(body, "ramba_stage_seconds_total").items()}
    flushes = list(_series(body, "ramba_flushes_attributed_total").values())
    hits = list(_series(body, "ramba_fuser_cache_hit_total").values())
    match = (stages == {k: float(v) for k, v in rep["stage_seconds"].items()}
             and flushes == [float(rep["flushes"])]
             and hits == [float(reg["counters"].get("fuser.cache_hit", 0))])
    tmp_left = [p for p in os.listdir(tdir) if p.endswith(".tmp")]
    kinds = sorted(json.load(open(p))["incident"]["type"]
                   for p in glob.glob(os.path.join(flight, "flight_*.json")))
    log(f"  observe (e) {scrapes} scrapes of 127.0.0.1:{port} during 10 "
        f"chained flushes, {reads} reads of the text file, errors {errs}; "
        f"series against the snapshots taken after the scrape: flushes "
        f"{flushes} vs {rep['flushes']}, stages match {match}; /healthz "
        f"ok {health['ok']} device {health['device_kind']!r}; temporaries "
        f"left {tmp_left}; flight dumps {kinds} [{card}]")
    import shutil

    shutil.rmtree(tdir, ignore_errors=True)
    if errs or not scrapes or not reads or not match or tmp_left or \
            kinds != ["perf_regression", "slo_breach"]:
        raise Fail("observe (e): the exporter, the text file or the flight "
                   "recorder")
    return {"scrapes": scrapes, "reads": reads, "flight": kinds,
            "healthz_ok": health["ok"]}


def _trace_events(path):
    with open(path) as f:
        doc = json.load(f)
    return doc["traceEvents"] if isinstance(doc, dict) else doc


def observe_profile(rt, np, torch, card, window, star2, er, sk):
    """(f) ``RAMBA_PROFILE_DIR`` with ``RAMBA_PROFILE=deep`` over 10 star2
    sweeps (a flush each) and one elemred chain: the exported trace holds
    a CUDA kernel event for each of the port's launches, inside its
    ``ramba_flush:<label>`` range; the ms a sweep the profiler adds."""
    import os
    import tempfile

    from ramba_tpu_torch.observe import profile

    xs = rt.fromarray(torch.rand((OBSERVE_GRID, OBSERVE_GRID),
                                 dtype=torch.float32,
                                 generator=_gen(torch, 11), device="cuda"))
    v = rt.sin(rt.arange(OBSERVE_VEC_N) * 1e-3)
    rt.sync()

    def sweeps():
        y = xs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(OBSERVE_PROFILE_SWEEPS):
            y = rt.sstencil(star2, y)
            y._value()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / OBSERVE_PROFILE_SWEEPS * 1e3
        float(rt.sum(v * 2.0 + 1.0))
        return ms

    need = {"stencil": OBSERVE_PROFILE_SWEEPS, "elemred": 1}
    off = window("observe (f) profiler off", sweeps, need)
    tdir = tempfile.mkdtemp(prefix="ramba_observe_prof_")
    _elastic_env(RAMBA_PROFILE_DIR=tdir, RAMBA_PROFILE="deep")
    profile.reconfigure()
    try:
        # the profiler starts at the first flush: its start (CUPTI's
        # set-up) stays out of the timed sweeps
        float(rt.sum(v * 3.0))
        if not profile.started():
            raise Fail("observe (f): RAMBA_PROFILE_DIR started no profiler")
        on = window("observe (f) profiler on", sweeps, need)
        launches = (sk.launches, er.launches)  # the window's own counts
        path = profile.stop()
    finally:
        _elastic_env(RAMBA_PROFILE_DIR=None, RAMBA_PROFILE=None)
        profile.reconfigure()
    evs = _trace_events(path)
    ranges = [e for e in evs if e.get("ph") == "X"
              and str(e.get("name", "")).startswith("ramba_flush:")]
    kernels = [e for e in evs if e.get("ph") == "X"
               and e.get("cat") == "kernel"]

    def inside(k):  # the kernel starts inside a flush's range
        return any(r["ts"] <= k["ts"] <= r["ts"] + r["dur"] for r in ranges)

    under = [k for k in kernels if inside(k)]
    st = sum("stencil_ring_kernel" in k["name"] for k in under)
    el = sum("elemred_kernel" in k["name"] for k in under)
    mb = os.path.getsize(path) / 2 ** 20
    import shutil

    shutil.rmtree(tdir, ignore_errors=True)
    whole = sum(any(r["ts"] <= k["ts"] and k["ts"] + k.get("dur", 0)
                    <= r["ts"] + r["dur"] for r in ranges) for k in under)
    log(f"  observe (f) trace {mb:.1f} MiB: {len(ranges)} ramba_flush "
        f"ranges, {len(kernels)} CUDA kernel events, {len(under)} starting "
        f"inside the ranges, {whole} of them ending inside too "
        f"({st} stencil_ring_kernel, {el} elemred_kernel) for "
        f"{launches[0]} stencil and {launches[1]} elemred launches; star2 "
        f"8192^2 a flush a sweep {off:.4f} ms off, {on:.4f} ms on "
        f"({on - off:+.4f} ms a sweep) [{card}]")
    if st < launches[0] or el < launches[1] or not ranges:
        raise Fail("observe (f): the trace lacks the port's launches")
    return {"ms_off": off, "ms_on": on, "ranges": len(ranges),
            "kernels_in_ranges": len(under), "trace_mib": mb}


def observe_diagnostics(rt, np, torch, card, window):
    """(g) ``diagnostics.report()`` prints every ported section,
    ``identity()`` names the card, ``dump()`` round-trips as JSON, and
    ``rt.profiler_trace``, ``rt.get_timing()``, ``rt.jit``, ``rt.remote``
    and ``rt.get`` work on the card."""
    import glob
    import io
    import os
    import tempfile

    from ramba_tpu_torch.core import memo, plancache
    from ramba_tpu_torch.observe import events
    from ramba_tpu_torch.resilience import elastic

    x = rt.sin(rt.arange(1 << 20) * 1e-3)
    y = rt.cos(rt.arange(1 << 20) * 1e-3)
    rt.sync()
    # every plane with state, so every section prints: the memo and the
    # certificates on a repeat flush, the heartbeat running, a verdict
    # in the ring (the slow_flush sentinel's, with why)
    _elastic_env(RAMBA_MEMO="1", RAMBA_PLANCERT="1")
    try:
        for _ in range(3):
            float(rt.sum(x * 3.0))
    finally:
        _elastic_env(RAMBA_MEMO=None, RAMBA_PLANCERT=None)
    elastic.start_heartbeat(0.05)
    if not any(e.get("why") for e in events.snapshot_ring()):
        raise Fail("observe (g): no incident verdict in the event ring")
    buf = io.StringIO()
    try:
        rt.diagnostics.report(file=buf)
    finally:
        elastic.stop_heartbeat()
        memo.reset()
        plancache.reset()
    text = buf.getvalue()
    # (the health section prints the health records still in the event
    # ring: a long process has rotated its bring-up record out)
    sections = ("-- counters --", "-- memory --",
                "-- kernels (top", "-- attribution --", "-- observer tax --",
                "-- incident explainer --", "-- result memo --",
                "-- plan cache --", "-- elastic lifecycle --", "-- last ",
                "timing summary", "comm stats (host boundary)")
    missing = [s for s in sections if s not in text]
    ident = rt.diagnostics.identity()
    tdir = tempfile.mkdtemp(prefix="ramba_observe_diag_")
    snap = json.load(open(rt.diagnostics.dump(os.path.join(tdir, "d.json"))))

    def traced():
        with rt.profiler_trace(tdir):
            return float(rt.sum(2.5 * x + y))

    window("observe (g) a flush under rt.profiler_trace", traced,
           {"elemred": 1})
    files = glob.glob(os.path.join(tdir, "trace_*.json"))
    kern = sum(e.get("cat") == "kernel" for e in _trace_events(files[0])) \
        if files else 0
    timers = rt.get_timing()["timers"]
    z = rt.jit(lambda a, b: 2.5 * a + b)(x, y)
    jit_ok = isinstance(z, rt.ndarray) and bytes_equal(
        z._value(), 2.5 * x._value() + y._value())
    fut = rt.remote(lambda a: float(rt.sum(a))).remote(x)
    remote_ok = rt.get(fut) == float(rt.sum(x))
    import shutil

    shutil.rmtree(tdir, ignore_errors=True)
    kind = torch.cuda.get_device_name(0)
    log(f"  observe (g) report: {len(sections) - len(missing)} of "
        f"{len(sections)} sections (missing {missing}), {len(text)} chars; "
        f"identity device_kind {ident['device_kind']!r}; dump round-trips "
        f"{snap['identity']['device_kind'] == kind}; profiler_trace "
        f"{len(files)} file, {kern} kernel events; get_timing "
        f"flush_execute {timers.get('flush_execute')}; jit bytes equal "
        f"{jit_ok}; remote/get {remote_ok} [{card}]")
    if missing or ident["device_kind"] != kind or \
            snap["identity"]["device_kind"] != kind or not kern or \
            "flush_execute" not in timers or not jit_ok or not remote_ok:
        raise Fail("observe (g): diagnostics or the remaining names")
    return {"sections": len(sections), "trace_kernels": kern}


def observe_rank_programs(rt, np, torch, er, sk, sc, rep):
    """One rank of ``observe_path`` (h): star2 8192^2, a flush a sweep,
    ``OBSERVE_RANK_SWEEPS`` sweeps under the environment's
    ``RAMBA_ATTRIB=sample:4``; the stage names of every flush span, the
    fence log, the block's digest."""
    from ramba_tpu_torch.observe import attrib, events

    st = rt.stencil(star2_body)
    y = dist_grid(rt, np, (OBSERVE_GRID, OBSERVE_GRID))
    rt.sync()
    seen = []
    events.add_tap(seen.append)

    def sweeps():
        nonlocal y
        for _ in range(OBSERVE_RANK_SWEEPS):
            y = rt.sstencil(st, y)
            rt.sync()

    _rank_window(er, sk, sc, "star2", sweeps, rep)
    events.remove_tap(seen.append)
    samp = attrib.sampling_report()["fingerprints"]
    rep["sigs"] = [[k for k in attrib.STAGES if k in e.get("stages", {})]
                   for e in seen if e.get("type") == "flush"]
    rep["reconciled"] = all(_reconciles(e) for e in seen
                            if e.get("type") == "flush")
    rep["fences"] = {fp: d["fenced_seqs"] for fp, d in samp.items()}
    rep["calls"] = {fp: d["calls"] for fp, d in samp.items()}
    rep["digests"]["star2"] = digest(y._block())


def observe_ranks(rt, np, torch, card, totals):
    """(h) Four ranks on cuda:0 (gloo) under ``RAMBA_ATTRIB=sample:4``:
    star2 8192^2 for 10 sweeps; every rank the same stage signature and
    the same fenced sequence numbers; every block byte-equal to one
    process."""
    import os
    import tempfile

    from ramba_tpu_torch import common
    from ramba_tpu_torch.parallel import mesh as pm

    st = rt.stencil(star2_body)
    y = dist_grid(rt, np, (OBSERVE_GRID, OBSERVE_GRID))
    for _ in range(OBSERVE_RANK_SWEEPS):
        y = rt.sstencil(st, y)
        rt.sync()
    t = y._value()
    dev = common.device()
    grid2 = pm.Mesh(np.array([dev] * 4, dtype=object).reshape(2, 2),
                    ("d0", "d1"))
    sh = pm.NamedSharding(grid2, pm.default_spec(tuple(t.shape), grid2))
    ref = {pos: digest(t[idx]) for pos, idx in
           sh.shard_indices(tuple(t.shape))}
    del t, y
    n4 = OBSERVE_SAMPLE["h"]
    with tempfile.TemporaryDirectory(prefix="ramba_observe_ranks_") as tmp:
        os.makedirs(os.path.join(tmp, f"w{OBSERVE_RANKS}"))
        t0 = time.perf_counter()
        ranks = dist_start(OBSERVE_RANKS, tmp, ("--observe",),
                           env=dict(os.environ, RAMBA_ATTRIB=f"sample:{n4}",
                                    RAMBA_INIT_TIMEOUT_S="120"))
        try:
            reps = dist_wait(ranks, tmp, time.time() + OBSERVE_LIMIT_S)
        finally:
            for p in ranks:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
    sigs = [r["sigs"] for r in reps]
    # a rank's own program (its block's offsets among the statics) has a
    # fingerprint of its own: the logs compare as (calls, fenced seqs)
    fences = [sorted((r["calls"][fp], seqs) for fp, seqs in
                     r["fences"].items()) for r in reps]
    same_sigs = all(s == sigs[0] for s in sigs) and len(sigs[0]) >= \
        OBSERVE_RANK_SWEEPS
    same_fences = all(f == fences[0] for f in fences) and bool(fences[0]) \
        and all(seqs == list(range(0, calls, n4))
                for calls, seqs in fences[0])
    blocks = all(r["digests"]["star2"] == ref[divmod(k, 2)]
                 for k, r in enumerate(reps))
    for r in reps:
        for k in totals:
            totals[k] += sum(c.get(k, 0) for c in r["launches"].values())
    log(f"  observe (h) {OBSERVE_RANKS} ranks on cuda:0, sample:{n4}: stage "
        f"signatures alike {same_sigs} ({len(sigs[0])} spans a rank, first "
        f"{sigs[0][:1]}); fence logs alike {same_fences} ({fences[0]}); "
        f"blocks byte-equal to one process {blocks}; launches a rank "
        f"{[r['launches']['star2']['stencil'] for r in reps]}; {wall:.1f} s "
        f"[{card}]")
    if not (same_sigs and same_fences and blocks and all(
            r["reconciled"] for r in reps)):
        raise Fail("observe (h): the ranks' attribution disagrees")
    return {"spans_a_rank": len(sigs[0]), "fences": fences[0],
            "wall_s": wall}


def observe_path(rt, er, sk, sg, sc, torch, np, card, window, totals,
                 only=None):
    """The observability plane on the card (ROADMAP A.9), (a)-(h) as
    their functions say; ``only``: the parts to run (all: None)."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    star2 = rt.stencil(star2_body)
    out, walls = {}, {}
    flight = tempfile.mkdtemp(prefix="ramba_observe_flight_")

    def part(name, fn, *a):
        if only is not None and name not in only:
            return
        t = time.perf_counter()
        out[name] = fn(*a)
        walls[name] = time.perf_counter() - t
        torch.cuda.empty_cache()

    try:
        part("main", observe_main, rt, np, torch, card, window, star2)
        part("fence", observe_fence_cost, rt, np, torch, card, window, star2)
        part("drift", observe_drift, rt, np, torch, card, flight)
        part("slo", observe_slo, rt, np, torch, card, window, star2, flight)
        part("telemetry", observe_telemetry, rt, np, torch, card, window,
             star2, flight)
        part("profile", observe_profile, rt, np, torch, card, window, star2,
             er, sk)
        part("diagnostics", observe_diagnostics, rt, np, torch, card, window)
        part("ranks", observe_ranks, rt, np, torch, card, totals)
    finally:
        shutil.rmtree(flight, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t0
    out["part_walls_s"] = walls
    log(f"  observe_path: {out['wall_s']:.1f} s, by part (s) "
        f"{json.dumps(walls)} [{card}]")
    return out


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if "--rank" in argv:  # one rank of dist_path
        return dist_rank(argv)
    if "--compile-child" in argv:  # one process of compile_path
        return compile_child(argv)
    if "--elastic-child" in argv:  # one process of elastic_path (e)
        return elastic_child(argv)
    if "--observe-child" in argv:  # one process of observe_path (c)
        return observe_child(argv)
    import numpy as np

    import ramba_tpu_torch as rt
    from ramba_tpu_torch import groupby as gb
    from ramba_tpu_torch.models import jacobi
    from ramba_tpu_torch.ops import elemred as er
    from ramba_tpu_torch.ops import segred as sg
    from ramba_tpu_torch.ops import stencil_kernel as sk

    from ramba_tpu_torch.ops import scan as sc

    rt.set_device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    log(f"phase 1: device {torch.cuda.get_device_name(0)} ({card}), "
        f"torch {torch.__version__}, cuda {torch.version.cuda}")
    t_all = time.perf_counter()
    phase_build(rt, er, sk, sg, gb, jacobi, sc)
    if "--dist" in argv:  # phase 1 and dist_path alone
        totals = dict.fromkeys(("elemred", "stencil", "segred", "scan"), 0)
        log(json.dumps({"dist": dist_path(rt, er, sk, sc, torch, np, card,
                                          totals), "launches": totals}))
        log(f"total {time.perf_counter() - t_all:.1f} s")
        print(card, flush=True)
        return 0
    if "--layout" in argv:  # phase 1 and layout_path alone
        totals = dict.fromkeys(("elemred", "stencil", "segred", "scan"), 0)
        log(json.dumps({"layout": layout_path(rt, torch, np, card, totals),
                        "launches": totals}))
        log(f"total {time.perf_counter() - t_all:.1f} s")
        print(card, flush=True)
        return 0
    if "--compile" in argv:  # phase 1 and compile_path alone
        totals = dict.fromkeys(("elemred", "stencil", "segred", "scan"), 0)
        window = launch_window(er, sk, sg, sc, totals, card)
        log(json.dumps({"compile": compile_path(rt, er, sg, torch, np, card,
                                                window, totals),
                        "launches": totals}))
        if not (totals["elemred"] and totals["segred"]):
            raise Fail("compile_path launched no elemred or no segred")
        log(f"total {time.perf_counter() - t_all:.1f} s")
        print(card, flush=True)
        return 0
    if "--analyze" in argv:  # phase 1 and analyze_path alone
        totals = dict.fromkeys(("elemred", "stencil", "segred", "scan"), 0)
        window = launch_window(er, sk, sg, sc, totals, card)
        out = analyze_path(rt, er, sk, sg, sc, torch, np, card, window)
        log(json.dumps({"analyze": {k: v for k, v in out.items()
                                    if k != "verified"},
                        "launches": totals}, default=str))
        for k in ("elemred", "stencil", "segred"):
            if not totals[k]:
                raise Fail(f"analyze_path launched no {k}")
        log(f"total {time.perf_counter() - t_all:.1f} s")
        print(card, flush=True)
        return 0
    if "--ladder" in argv:  # phase 1 and ladder_path alone
        totals = dict.fromkeys(("elemred", "stencil", "segred", "scan"), 0)
        window = launch_window(er, sk, sg, sc, totals, card)
        out = ladder_path(rt, er, sk, sg, sc, torch, np, card, window,
                          totals)
        log(json.dumps({"ladder": out, "launches": totals}, default=str))
        for k in totals:
            if not totals[k]:
                raise Fail(f"ladder_path launched no {k}")
        log(f"total {time.perf_counter() - t_all:.1f} s")
        print(card, flush=True)
        return 0
    if "--elastic" in argv:  # phase 1 and elastic_path alone
        totals = dict.fromkeys(("elemred", "stencil", "segred", "scan"), 0)
        window = launch_window(er, sk, sg, sc, totals, card)
        only = argv[argv.index("--parts") + 1].split(",") \
            if "--parts" in argv else None
        out = elastic_path(rt, er, sk, sg, sc, torch, np, card, window,
                           totals, only)
        log(json.dumps({"elastic": out, "launches": totals}, default=str))
        for k in totals:
            if not totals[k] and only is None:
                raise Fail(f"elastic_path launched no {k}")
        log(f"total {time.perf_counter() - t_all:.1f} s")
        print(card, flush=True)
        return 0
    if "--observe" in argv:  # phase 1 and observe_path alone
        totals = dict.fromkeys(("elemred", "stencil", "segred", "scan"), 0)
        window = launch_window(er, sk, sg, sc, totals, card)
        only = argv[argv.index("--parts") + 1].split(",") \
            if "--parts" in argv else None
        out = observe_path(rt, er, sk, sg, sc, torch, np, card, window,
                           totals, only)
        log(json.dumps({"observe": out, "launches": totals}, default=str))
        for k in totals:
            if not totals[k] and only is None:
                raise Fail(f"observe_path launched no {k}")
        log(f"total {time.perf_counter() - t_all:.1f} s")
        print(card, flush=True)
        return 0
    if "--mesh" in argv:  # phase 1 and mesh_path alone, a quicker check
        window = launch_window(er, sk, sg, sc, dict.fromkeys(
            ("elemred", "stencil", "segred", "scan"), 0), card)
        log(json.dumps({"sharded": mesh_path(rt, sk, sc, torch, np, card,
                                             window)}))
        log(f"total {time.perf_counter() - t_all:.1f} s")
        print(card, flush=True)
        return 0
    rows = phase_kernels(rt, er, sk, sg, jacobi, torch, np, card, sc)
    if "--quick" not in argv:
        totals, sharded, dist = phase_main_path(rt, er, sk, sg, jacobi,
                                                torch, np, card, sc)
        for row in rows:
            row["launches"] = totals[row["name"]]
            if row["name"] == "stencil":
                row["sharded"] = sharded
                row["dist"] = dist
    log(f"total {time.perf_counter() - t_all:.1f} s; stencil bodies turned "
        f"away: {sk.ineligible}")
    print(json.dumps({"kernels": list(rows), "card": card}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
