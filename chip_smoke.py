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
   This phase also holds the repairs: integer ``// 0`` on the elemred and
   stencil kernels against the rule itself, a uint32 chain against NumPy
   and the bf16 stencil kernel exactly against its plain version;
3. the main path through ``import ramba_tpu_torch as rt``: the headline
   chain at n = 1e9, the sin/cos chain over a materialised base at n = 1e9,
   axpy + sum, the PRK star stencil (30 chained ``sstencil`` calls and 100
   ``sstencil_iterate`` sweeps at 8192^2), ``jacobi2d`` at 4096^2, and
   groupby over an hourly sensor series (n = 2^28 float64, 24 hour-of-day
   groups: sum, min, max, count on the segred kernel, then mean and the
   anomaly ``g - g.mean()`` on the generic lowering) and over n = 2^28
   float32 category codes (64 groups: sum, max).  Every kernel's launch
   count is set to 0 just before each path and read just after; a path
   that does not launch its kernel fails the run;
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


def phase_build(rt, sk, sg, gb, jacobi):
    """Build every CUDA kernel of the main path at once."""
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
    t0 = time.perf_counter()
    _build.build_many([(s.name, s.source) for s in specs + seg])
    log(f"phase 1: built {len(specs)} CUDA stencil and {len(seg)} CUDA segred "
        f"kernels in {time.perf_counter() - t0:.2f} s (nvcc, sm_90a, one "
        f"process per source, in parallel)")


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
        min/max, within :func:`sum_bound` of elemred's depth (``sum_abs``
        in output order; a mean's is sum|x| / n) for float sums and
        means."""
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
                    check_sums(f"{name} red{k}", g, w,
                               sum_bound(er.depth(n) + 1, dt, float(b)),
                               "2*depth*eps*sum|x|, another order")
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


def hourly_series(torch, np, n, seed=0):
    """An hourly sensor series: n float64 readings made on the card from a
    seed (a daily cycle plus noise) and their int32 hour-of-day labels."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    t = torch.arange(n, device="cuda", dtype=torch.float64)
    x = 20.0 + 5.0 * torch.sin(t * (2 * np.pi / 24)) \
        + torch.randn(n, generator=g, device="cuda", dtype=torch.float64)
    del t
    return x, (np.arange(n, dtype=np.int64) % 24).astype(np.int32)


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


def phase_kernels(rt, er, sk, sg, jacobi, torch, np, card):
    """Each kernel against its plain version on the card; timings."""
    log("phase 2: kernels against their plain versions")
    elemred_small_err = elemred_checks(rt, er, torch, np)
    segred_small_err = segred_checks(rt, sg, torch, np)
    repair_checks(rt, er, sk, torch, np)

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
    stencil_case("stencil star2 8192^2 bf16", star2_body, slots1, [xb], 0.0,
                 "bf16: both round every op to bf16")
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
    check_sums("elemred sin/cos chain n=1e9 f64 (sum)", got[1], want[1],
               sum_bound(er.depth(n), "float64",
                         float(got[0].abs().sum(dtype=torch.float64))),
               "2*depth*eps*sum|x|, another order")
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
    return elemred_row, stencil_row, segred_row


def phase_main_path(rt, er, sk, sg, jacobi, torch, np, card):
    """The main path through the user API, launch counts around each."""
    log("phase 3: main path through `import ramba_tpu_torch as rt`")
    totals = {"elemred": 0, "stencil": 0, "segred": 0}

    def window(name, fn, need):
        er.launches = 0
        sk.launches = 0
        sg.launches = 0
        res = fn()
        got = {"elemred": er.launches, "stencil": sk.launches,
               "segred": sg.launches}
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
    del fd
    torch.cuda.empty_cache()
    groupby_path(rt, sg, torch, np, card, window)
    return totals


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


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    import ramba_tpu_torch as rt
    from ramba_tpu_torch import groupby as gb
    from ramba_tpu_torch.models import jacobi
    from ramba_tpu_torch.ops import elemred as er
    from ramba_tpu_torch.ops import segred as sg
    from ramba_tpu_torch.ops import stencil_kernel as sk

    rt.set_device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    log(f"phase 1: device {torch.cuda.get_device_name(0)} ({card}), "
        f"torch {torch.__version__}, cuda {torch.version.cuda}")
    t_all = time.perf_counter()
    phase_build(rt, sk, sg, gb, jacobi)
    rows = phase_kernels(rt, er, sk, sg, jacobi, torch, np, card)
    if "--quick" not in argv:
        totals = phase_main_path(rt, er, sk, sg, jacobi, torch, np, card)
        for row in rows:
            row["launches"] = totals[row["name"]]
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
