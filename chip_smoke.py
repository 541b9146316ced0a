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
   the bf16 stencil kernel exactly against its plain version, saturating
   float-to-int casts and ``sign(-0.0)`` through elemred and the generic
   lowering; and the one-pass fixed-order scan (cumsum/cumprod of floats)
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
   host time, launch and card time, cold and warm.  Every kernel's launch
   count is set to 0 just before each
   path and read just after; a path that does not launch its kernel fails
   the run;
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
# the matmul paths' peaks (the same data sheet): float32 with TF32 off runs
# on the CUDA cores, float64 on the FP64 tensor cores
PEAK_MATMUL = {"float32": 67e12, "float64": 67e12}
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


def bytes_equal(a, b) -> bool:
    """The same bytes, shape and dtype."""
    import torch

    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8),
                            b.reshape(-1).view(torch.uint8)))


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
    cast_sign_checks(rt, er, torch)


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
    for dt in ("int32", "int64"):
        a = rt.fromarray(rs.randint(-5, 6, 64).astype(dt))
        b = rt.fromarray(rs.randint(1, 6, 64).astype(dt))
        for _name, f in int_checks(rt, a, b):
            plans.append(er.plan_for(*_program(f)))
    return plans


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


def phase_main_path(rt, er, sk, sg, jacobi, torch, np, card, sc):
    """The main path through the user API, launch counts around each."""
    log("phase 3: main path through `import ramba_tpu_torch as rt`")
    totals = {"elemred": 0, "stencil": 0, "segred": 0, "scan": 0}

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
    skeletons_path(rt, er, torch, np, card, window)
    indexing_path(rt, sc, torch, np, card, window)
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

    from ramba_tpu_torch.ops import scan as sc

    rt.set_device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    log(f"phase 1: device {torch.cuda.get_device_name(0)} ({card}), "
        f"torch {torch.__version__}, cuda {torch.version.cuda}")
    t_all = time.perf_counter()
    phase_build(rt, er, sk, sg, gb, jacobi, sc)
    rows = phase_kernels(rt, er, sk, sg, jacobi, torch, np, card, sc)
    if "--quick" not in argv:
        totals = phase_main_path(rt, er, sk, sg, jacobi, torch, np, card, sc)
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
