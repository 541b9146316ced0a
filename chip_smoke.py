#!/usr/bin/env python3
"""Smoke run of ramba_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py            # the whole run (about a minute or two)
    python3 chip_smoke.py --quick    # phases 1-2 only: build and check kernels

Phases, each reported on its own line:

1. device and build: the card's name and power limit, then every CUDA
   kernel of the main path built from this checkout's sources at once;
2. each kernel held against its plain PyTorch version on the card, at the
   main path's shapes, with the tolerance stated beside every check, and
   timed beside its bound and (where one PyTorch call computes the same
   function) that call;
3. the main path through ``import ramba_tpu_torch as rt``: the headline
   chain at n = 1e9, the sin/cos chain over a materialised base at n = 1e9,
   axpy + sum, the PRK star stencil (30 chained ``sstencil`` calls and 100
   ``sstencil_iterate`` sweeps at 8192^2) and ``jacobi2d`` at 4096^2.  Every
   kernel's launch count is set to 0 just before each path and read just
   after; a path that does not launch its kernel fails the run;
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

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# peak non-tensor-core rates on the H100 SXM (NVIDIA data sheet)
PEAK_OPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 67e12}
EPS = {"float32": 2.0 ** -23, "float64": 2.0 ** -52}


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


def check_sum(what, got, want, n, sum_abs, dtype_name, reason):
    """A float reduction: |got - want| <= n * eps * sum|x| (the two sum in
    different orders)."""
    err = abs(float(got) - float(want))
    bound = n * EPS[dtype_name] * float(sum_abs)
    ok = err <= bound and got.dtype == want.dtype
    log(f"  {what}: |err|={err:.3e} <= n*eps*sum|x|={bound:.3e} ({reason}) "
        f"{'ok' if ok else 'MISS'}")
    if not ok:
        raise Fail(f"{what} disagrees with its plain version")
    return err


# ---------------------------------------------------------------------------


def star2_body(a):
    return (
        0.25 * (a[0, 1] + a[0, -1] + a[1, 0] + a[-1, 0])
        + 0.125 * (a[0, 2] + a[0, -2] + a[2, 0] + a[-2, 0])
    )


def phase_build(rt, sk, jacobi):
    """Build every CUDA kernel of the main path at once."""
    import numpy as np
    from ramba_tpu_torch.core.expr import BF16

    K = jacobi._kernels()
    bodies = [(star2_body, 1, np.float32), (star2_body, 1, BF16),
              (K["sweep"].func, 2, np.float64), (K["lap"].func, 1, np.float64)]
    specs = []
    for func, n_slots, dt in bodies:
        tr = sk.trace(func, tuple(("arr", k) for k in range(n_slots)))
        spec = sk.spec_for(tr.expr, tr.lo, tr.hi, n_slots, dt)
        if spec is None:
            raise Fail(f"stencil kernel does not take {func.__name__} in {dt}")
        specs.append(spec)
    t0 = time.perf_counter()
    sk.build(specs)
    log(f"phase 1: built {len(specs)} CUDA stencil kernels in "
        f"{time.perf_counter() - t0:.2f} s (nvcc, sm_90a, in parallel)")


def _program(exprs_of):
    """(program, leaf values) of the expressions ``exprs_of()`` builds; the
    arrays it made are dropped, so nothing stays pending."""
    from ramba_tpu_torch.core import fuser

    arrays = exprs_of()
    exprs = [a._expr for a in arrays]
    del arrays
    return fuser.prepare_program(exprs)


def elemred_checks(rt, er, torch, np):
    """The four test programs at n = 2**24 + 37 (a ragged tail)."""
    n = (1 << 24) + 37
    rs = np.random.RandomState(0)
    worst = 0.0

    def leaves(dt):
        x = rt.fromarray(rs.rand(n).astype(dt))
        y = rt.fromarray(rs.rand(n).astype(dt))
        return x, y

    def compare(name, program, lv, dt, sum_abs=()):
        """Vector outputs elementwise; reductions: exact for integers and
        min/max, within n*eps*sum|x| (``sum_abs`` in output order) for
        float sums and means."""
        nonlocal worst
        got = er.launch(program, lv)
        want = er.elemred_reference(program, lv)
        torch.cuda.synchronize()
        bounds = iter(sum_abs)
        for k, (g, w) in enumerate(zip(got, want)):
            if g.ndim == 1 and dt == "int32":
                worst = max(worst, check_close(f"{name} out{k}", g, w, 0,
                                               "integers"))
            elif g.ndim == 1:
                rtol = 1e-6 if dt == "float32" else 1e-12
                worst = max(worst, check_close(
                    f"{name} out{k}", g, w, rtol,
                    f"{dt} elementwise; libdevice and torch math differ by ulps",
                    atol=rtol))
            else:
                b = next(bounds)
                if b is None:
                    check_close(f"{name} red{k}", g, w, 0,
                                "integer sum, or min/max: order-independent")
                else:
                    check_sum(f"{name} red{k}", g, w, n, b, dt,
                              "float sums taken in another order")
        return got

    for dt in ("float32", "float64"):
        x, y = leaves(dt)
        p, lv = _program(lambda: (lambda D: [D, rt.sum(D)])(
            rt.sin(x) * rt.sin(x) + rt.cos(x) * rt.cos(x)))
        g1 = compare(f"elemred sin/cos+sum {dt}", p, lv, dt, [2.0 * n])
        if dt == "float32":
            g2 = er.launch(p, lv)
            same = all(torch.equal(a.view(-1).view(torch.uint8),
                                   b.view(-1).view(torch.uint8))
                       for a, b in zip(g1, g2))
            log(f"  elemred sin/cos+sum float32 rerun byte-equal: {same}")
            if not same:
                raise Fail("elemred is not deterministic")
        xs, ys = x._value().double().abs().sum(), y._value().double().abs().sum()
        p, lv = _program(lambda: (lambda z: [z, rt.sum(z)])(2.5 * x + y))
        compare(f"elemred axpy+sum {dt}", p, lv, dt, [2.5 * xs + ys])
        p, lv = _program(lambda: (lambda v: [rt.mean(v), rt.min(v), rt.max(v)])(
            x * 3.0 - y))
        compare(f"elemred mean/min/max {dt}", p, lv, dt,
                [(3.0 * xs + ys) / n, None, None])
        p, lv = _program(lambda: [rt.sqrt(x) / (y - 0.5), (x * 7.0) // y,
                                  (x * 7.0) % (y - 0.5)])
        compare(f"elemred sqrt/divide/floor_divide/mod {dt}", p, lv, dt)
        del x, y
    a = rt.fromarray((rs.randint(-1000, 1000, n)).astype(np.int32))
    # divisors of both signs, and some zeros: integer x // 0 and x % 0 are 0
    b = rt.fromarray((rs.randint(0, 50, n) * rs.choice([-1, 1], n)).astype(np.int32))
    p, lv = _program(lambda: (lambda c: [c, rt.sum(c)])((a // b) + (a % b) * 3))
    compare("elemred int32 floor_divide/mod+sum", p, lv, "int32", [None])
    return worst


def phase_kernels(rt, er, sk, jacobi, torch, np):
    """Each kernel against its plain version on the card; timings."""
    log("phase 2: kernels against their plain versions")
    elemred_small_err = elemred_checks(rt, er, torch, np)

    slots1 = (("arr", 0),)
    tr = sk.trace(star2_body, slots1)
    lo, hi = tr.lo, tr.hi
    g = torch.Generator(device="cuda")
    g.manual_seed(1)

    def rand(*shape, dtype=torch.float32):
        return torch.rand(shape, generator=g, device="cuda", dtype=dtype)

    def stencil_case(name, func, slots, arrs, rtol, reason, atol=0.0):
        l, h = sk.trace(func, slots)[:2]
        if not sk.available(func, l, h, slots, arrs):
            raise Fail(f"{name}: the stencil kernel does not take it")
        got = sk.launch(func, l, h, slots, arrs, torch.empty_like(arrs[0]))
        want = sk.stencil_reference(func, l, h, slots, arrs)
        torch.cuda.synchronize()
        return check_close(name, got, want, rtol, reason, atol)

    f32 = "float32 per-op IEEE in both, same order"
    x8 = rand(8192, 8192)
    st_err = stencil_case("stencil star2 8192^2 f32", star2_body, slots1, [x8],
                          1e-6, f32)
    x30 = rand(30000, 30000)
    stencil_case("stencil star2 30000^2 f32", star2_body, slots1, [x30], 1e-6, f32)
    del x30
    torch.cuda.empty_cache()
    xo = rand(4099, 4133)
    stencil_case("stencil star2 4099x4133 f32", star2_body, slots1, [xo], 1e-6, f32)
    del xo
    K = jacobi._kernels()
    u = rand(4096, 4096, dtype=torch.float64)
    f = rand(4096, 4096, dtype=torch.float64)
    stencil_case("stencil jacobi sweep 4096^2 f64 (2 slots)", K["sweep"].func,
                 (("arr", 0), ("arr", 1)), [u, f], 1e-12,
                 "float64 per-op IEEE in both")
    stencil_case("stencil jacobi lap 4096^2 f64", K["lap"].func, slots1, [u],
                 1e-12, "float64 per-op IEEE in both")
    del u, f
    xb = x8.to(torch.bfloat16)
    stencil_case("stencil star2 8192^2 bf16", star2_body, slots1, [xb], 1e-2,
                 "bf16: kernel computes in float, the plain version rounds "
                 "every op to bf16", atol=1e-2 * 1.5)
    del xb

    # -- timings: the main path's shape, then the odd shape ----------------
    w = torch.zeros(1, 1, 5, 5, dtype=torch.float32, device="cuda")
    for (di, dj), c in {(0, 1): .25, (0, -1): .25, (1, 0): .25, (-1, 0): .25,
                        (0, 2): .125, (0, -2): .125, (2, 0): .125,
                        (-2, 0): .125}.items():
        w[0, 0, 2 + di, 2 + dj] = c

    def time_star2(x):
        out = torch.empty_like(x)
        ms = cuda_ms(lambda: sk.launch(star2_body, lo, hi, slots1, [x], out), 20)
        plain_ms = cuda_ms(
            lambda: sk.stencil_reference(star2_body, lo, hi, slots1, [x]), 5)
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False  # full float32, like the kernel
        try:
            x4 = x.view(1, 1, *x.shape)
            lib_ms = cuda_ms(lambda: torch.nn.functional.conv2d(x4, w), 20)
        finally:
            torch.backends.cudnn.allow_tf32 = prev
        H, W = x.shape
        t_bytes = 2 * H * W * 4 / HBM_BYTES_PER_S
        t_ops = 13 * (H - 4) * (W - 4) / PEAK_OPS["float32"]
        bound_ms = 1e3 * max(t_bytes, t_ops)
        log(f"  stencil star2 {H}x{W} f32: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, conv2d {lib_ms:.4f} ms, bound {bound_ms:.4f} ms")
        return ms, plain_ms, lib_ms, bound_ms, \
            "bytes" if t_bytes >= t_ops else "operations"

    ms, plain_ms, lib_ms, bound_ms, bound_by = time_star2(x8)
    stencil_row = {
        "name": "stencil", "route": "cuda",
        "source": "ramba_tpu_torch/csrc/stencil_tile.cuh",
        "replaces": "ramba_tpu/ops/stencil_pallas.py:261",
        "also_replaces": "ramba_tpu/ops/stencil_pallas.py:370",
        "launches": 0, "max_abs_err": st_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
        "shape": "star2 8192x8192 float32",
    }
    del x8
    time_star2(rand(4099, 4133))  # the shapes _run_padded took on the TPU
    torch.cuda.empty_cache()

    n = 10 ** 9
    base = (rt.arange(n) / 1000.0)
    base_t = base._value()
    p, lv = _program(lambda: (lambda D: [D, rt.sum(D)])(
        rt.sin(base) * rt.sin(base) + rt.cos(base) * rt.cos(base)))
    del base
    got = er.launch(p, lv)
    want = er.elemred_reference(p, lv)
    torch.cuda.synchronize()
    er_err = check_close("elemred sin/cos chain n=1e9 f64 (D)", got[0], want[0],
                         1e-12, "float64 elementwise", atol=1e-12)
    check_sum("elemred sin/cos chain n=1e9 f64 (sum)", got[1], want[1], n,
              got[0].abs().sum(dtype=torch.float64), "float64",
              "float sums taken in another order")
    del got, want
    ms = cuda_ms(lambda: er.launch(p, lv), 5)
    plain_ms = cuda_ms(lambda: er.elemred_reference(p, lv), 2)
    n_vec = sum(1 for op, _s, _a in p.instrs if op == "map")
    er_bytes = 2 * n * 8  # read base, write D
    er_ops = n_vec * n + n
    elemred_row = {
        "name": "elemred", "route": "triton",
        "source": "ramba_tpu_torch/ops/elemred.py",
        "replaces": "ramba_tpu/ops/pallas_backend.py:447",
        "launches": 0, "max_abs_err": max(er_err, elemred_small_err),
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": 1e3 * max(er_bytes / HBM_BYTES_PER_S,
                              er_ops / PEAK_OPS["float64"]),
        "bound_by": ("bytes" if er_bytes / HBM_BYTES_PER_S
                     >= er_ops / PEAK_OPS["float64"] else "operations"),
        "library_ms": None, "shape": "sin/cos chain + sum, n=1e9 float64",
    }
    log(f"  elemred sin/cos chain n=1e9 f64: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {elemred_row['bound_ms']:.4f} ms")
    del p, lv, base_t
    torch.cuda.empty_cache()
    return elemred_row, stencil_row


def phase_main_path(rt, er, sk, jacobi, torch, np, card):
    """The main path through the user API, launch counts around each."""
    log("phase 3: main path through `import ramba_tpu_torch as rt`")
    totals = {"elemred": 0, "stencil": 0}

    def window(name, fn, need):
        er.launches = 0
        sk.launches = 0
        res = fn()
        got = {"elemred": er.launches, "stencil": sk.launches}
        for k in totals:
            totals[k] += got[k]
        for k, want in need.items():
            ok = got[k] == want if isinstance(want, int) else got[k] > 0
            if not ok:
                raise Fail(f"{name}: {k} launches {got[k]}, expected "
                           f"{'> 0' if want is None else want}")
        log(f"  {name}: launches {got} [{card}]")
        return res

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
    return totals


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    import ramba_tpu_torch as rt
    from ramba_tpu_torch.models import jacobi
    from ramba_tpu_torch.ops import elemred as er
    from ramba_tpu_torch.ops import stencil_kernel as sk

    rt.set_device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    log(f"phase 1: device {torch.cuda.get_device_name(0)} ({card}), "
        f"torch {torch.__version__}, cuda {torch.version.cuda}")
    t_all = time.perf_counter()
    phase_build(rt, sk, jacobi)
    elemred_row, stencil_row = phase_kernels(rt, er, sk, jacobi, torch, np)
    if "--quick" not in argv:
        totals = phase_main_path(rt, er, sk, jacobi, torch, np, card)
        elemred_row["launches"] = totals["elemred"]
        stencil_row["launches"] = totals["stencil"]
    log(f"total {time.perf_counter() - t_all:.1f} s; stencil bodies turned "
        f"away: {sk.ineligible}")
    print(json.dumps({"kernels": [elemred_row, stencil_row],
                      "card": card}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
