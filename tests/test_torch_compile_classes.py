"""Shape-bucketed compile classes (``ramba_tpu_torch/compile/classes.py``).

Held against ramba_tpu's ``compile/classes.py`` on the same NumPy inputs:
bucket math and policy parsing over a sweep of extents, exactly; plan
decisions (token, extent, bucket, padded leaves, pad-waste bytes) and
bail-outs for reduce, groupby, stencil and indexing programs, exactly.
Bucketed results byte-equal to the exact-shape results (classes off),
dtypes exact, and within rtol 2e-6 / atol 1e-6 of ramba_tpu's at exact
shapes (XLA's CPU compiler rewrites float32 transcendentals; ramba_tpu's
own bucketed path needs ``jax.spmd_mode``, gone from this jax); padded
rows of ``log``, ``// 0``, ``reciprocal`` and a division by zero raise
nothing and never reach the result (rtol 1e-12 of ramba_tpu).  The soak of
ramba_tpu's traffic (``bench.py``'s compile section) keeps the compile
cache's hit rate above 95 %, as ramba_tpu's soak test states.
"""

import os

import numpy as np
import pytest
import torch

import jax
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from ramba_tpu.compile import classes as jclasses
from ramba_tpu.core import fuser as jfuser
from ramba_tpu_torch import common
from ramba_tpu_torch.compile import classes
from ramba_tpu_torch.core import fuser
from ramba_tpu_torch.observe import events, ledger, registry
from ramba_tpu_torch.resilience import faults


@pytest.fixture(autouse=True)
def _isolate():
    """pow2 armed in both packages, the environment restored by hand so
    the final ``reset`` reads it back."""
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    torch.set_num_threads(1)
    saved = os.environ.get("RAMBA_COMPILE_CLASSES")
    rt.sync()
    rtj.sync()
    faults.configure(None)
    os.environ["RAMBA_COMPILE_CLASSES"] = "pow2"
    classes.reset()
    jclasses.reset()
    yield
    faults.reset()
    if saved is None:
        os.environ.pop("RAMBA_COMPILE_CLASSES", None)
    else:
        os.environ["RAMBA_COMPILE_CLASSES"] = saved
    classes.reset()
    jclasses.reset()


def _policy(value):
    os.environ["RAMBA_COMPILE_CLASSES"] = value
    classes.reset()
    jclasses.reset()


def _ref_exact(fn):
    """ramba_tpu's result at exact shapes (its bucketed path needs
    ``jax.spmd_mode``, which this jax no longer has)."""
    saved = os.environ["RAMBA_COMPILE_CLASSES"]
    os.environ["RAMBA_COMPILE_CLASSES"] = "off"
    jclasses.reset()
    try:
        return np.asarray(fn(rtj))
    finally:
        os.environ["RAMBA_COMPILE_CLASSES"] = saved
        jclasses.reset()


SWEEP = list(range(-3, 70)) + [127, 128, 129, 255, 256, 300, 1000, 1023,
                                1024, 1025, 2 ** 20 + 1, 3 * 10 ** 7,
                                2 ** 26 - 1]
POLICIES = [("pow2",), ("linear", 1), ("linear", 5), ("linear", 16),
            ("linear", 1000), ("off",)]


@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_bucket_math_matches_ramba_tpu(policy):
    got = [classes.bucket_for(n, policy) for n in SWEEP]
    assert got == [jclasses.bucket_for(n, policy) for n in SWEEP]
    for n, b in zip(SWEEP, got):
        assert b == n if n <= 0 or policy[0] == "off" else b >= n


@pytest.mark.parametrize("raw", ["", "off", "0", "none", "no", "pow2", "1",
                                 "on", "true", "POW2", "linear:16",
                                 "linear:1", "linear:0", "linear:zero",
                                 "linear:-4", "cubic", " pow2 "])
def test_policy_parse_matches_ramba_tpu(raw):
    assert classes._parse(raw) == jclasses._parse(raw)


def test_pow2_and_linear_values():
    assert [classes.bucket_for(n, ("pow2",)) for n in
            (1, 2, 3, 4, 5, 8, 9, 255, 256, 300)] == \
        [1, 2, 4, 4, 8, 8, 16, 256, 256, 512]
    assert [classes.bucket_for(n, ("linear", 5)) for n in
            (1, 4, 5, 6, 11, 300)] == [5, 5, 5, 10, 15, 300]


RS = np.random.default_rng(14)
X58 = RS.standard_normal((5, 8)).astype(np.float32)
X48 = RS.standard_normal((4, 8)).astype(np.float32)
ROW = RS.standard_normal((1, 8)).astype(np.float32)
V37 = RS.standard_normal(37)
LAB = RS.integers(0, 3, 37)
G64 = RS.random((12, 13)).astype(np.float32)


def _star(a):
    return 0.25 * (a[0, 1] + a[0, -1] + a[1, 0] + a[-1, 0])


PROGRAMS = {
    "affine_5x8": lambda m: [m.array(X58) * 2.0 + 1.0],
    "exact_pow2_4x8": lambda m: [m.array(X48) * 3.0],
    "broadcast_row": lambda m: [m.array(X58) + m.array(ROW)],
    "vector_37": lambda m: [m.array(V37) * 2.0 + 1.0],
    "two_outputs": lambda m: (lambda a: [a * a, m.sin(a) - 0.5])(m.array(V37)),
    "cast": lambda m: [(m.array(V37) * 10.0).astype(np.int32)],
    "round": lambda m: [m.around(m.array(V37) * 10.0, 1)],
    "reduce": lambda m: [m.sum(m.array(X58) * 2.0)],
    "axis_reduce": lambda m: [m.array(X58).sum(axis=0)],
    "groupby": lambda m: [m.array(V37).groupby(0, LAB, 3).sum()],
    "stencil": lambda m: [m.sstencil(m.stencil(_star), m.array(G64))],
    "flip": lambda m: [m.flip(m.array(V37) * 2.0, 0)],
    "getitem": lambda m: [m.array(V37)[3:20] * 2.0],
}
BAILS = {"reduce", "axis_reduce", "groupby", "stencil", "flip", "getitem"}


def _plans(name):
    roots = PROGRAMS[name](rt)
    p, vals = fuser.prepare_program([r._expr for r in roots])
    plan = classes.plan_for(p, vals)
    jroots = PROGRAMS[name](rtj)
    jp, jleaves, _ = jfuser._prepare_program([r._expr for r in jroots])
    jplan = jclasses.plan_for(jp, jfuser._gather_leaf_vals(jleaves)[0])
    return plan, jplan, (p, vals)


@pytest.mark.parametrize("policy", ["pow2", "linear:4", "linear:16"])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_plan_decisions_match_ramba_tpu(name, policy):
    _policy(policy)
    b0, jb0 = classes.snapshot()["bailouts"], jclasses.snapshot()["bailouts"]
    plan, jplan, (p, vals) = _plans(name)
    if name in BAILS:
        assert plan is None and jplan is None
        assert classes.snapshot()["bailouts"] == b0 + 1
        assert jclasses.snapshot()["bailouts"] == jb0 + 1
        return
    assert plan is not None and jplan is not None
    assert plan.token == jplan.token
    assert (plan.n, plan.bucket) == (jplan.n, jplan.bucket)
    assert plan.pad_waste_bytes == jplan.pad_waste_bytes
    assert len(plan.pad_slots) == len(jplan.pad_slots)
    assert all(vals[s].shape[0] == plan.n for s in plan.pad_slots)


def test_bailout_counts_in_the_registry():
    r0 = registry.get("compile.bucket_bailout")
    got = float(rt.sum(rt.array(X58) * 2.0))
    assert got == pytest.approx(float(np.sum(X58.astype(np.float64) * 2.0)),
                                rel=1e-6)
    assert registry.get("compile.bucket_bailout") > r0


def test_elementwise_flush_buckets_and_lands_on_span_and_ledger():
    out = rt.array(X58) * 2.0 + 1.0
    np.testing.assert_array_equal(out.asarray(), X58 * 2.0 + 1.0)
    assert out.dtype == np.float32 and out.shape == (5, 8)
    snap = classes.snapshot()
    assert snap["planned"] >= 1 and snap["padded"] >= 1
    assert snap["pad_bytes"] > 0 and snap["pad_waste_frac"] > 0
    span = events.last(1, type="flush")[-1]
    assert span["compile_class"] == ["pow2", 8]
    assert span["pad_waste_bytes"] == 3 * 8 * 4
    k = ledger.snapshot()["kernels"][span["fingerprint"]]
    assert k["compile_class"] == ["pow2", 8] and k["pad_waste"] >= 96
    assert classes.decisions()[span["fingerprint"]] == ("pow2", 8)


def test_linear_policy_token_and_off_plans_nothing():
    _policy("linear:4")
    np.asarray(rt.array(np.ones((6, 8), np.float32)) * 4.0)
    assert events.last(1, type="flush")[-1]["compile_class"] == ["linear:4", 8]
    _policy("off")
    np.asarray(rt.array(np.ones((5, 8), np.float32)) * 2.0)
    snap = classes.snapshot()
    assert snap["planned"] == 0 and snap["bailouts"] == 0
    assert "compile_class" not in events.last(1, type="flush")[-1]


_UNARY = [rt.tanh, rt.sin, rt.exp, lambda t: t * 1.5 - 0.25]
_JUNARY = [rtj.tanh, rtj.sin, rtj.exp, lambda t: t * 1.5 - 0.25]
_BINARY = [lambda t, u: t + u, lambda t, u: t * u,
           lambda t, u: t - 0.5 * u]


@pytest.mark.parametrize("trial", range(10))
def test_fuzz_bucketed_matches_exact(trial):
    """Seeded random map chains over random (n, k) leaves, run with
    classes off and with pow2: byte-equal, and equal to ramba_tpu's."""
    rng = np.random.default_rng(1414 + trial)
    n, k = int(rng.integers(1, 34)), int(rng.integers(1, 10))
    base = rng.standard_normal((n, k)).astype(np.float32)
    other = rng.standard_normal((n, k)).astype(np.float32)
    steps = [(int(rng.integers(len(_UNARY))), int(rng.integers(len(_BINARY))))
             for _ in range(int(rng.integers(1, 4)))]

    def compute(m, unary):
        x, y = m.array(base), m.array(other)
        z = x
        for ui, bi in steps:
            z = _BINARY[bi](unary[ui](z), y)
        return np.asarray(z.asarray() if m is rt else z)

    _policy("off")
    exact = compute(rt, _UNARY)
    _policy("pow2")
    bucketed = compute(rt, _UNARY)
    ref = _ref_exact(lambda m: compute(m, _JUNARY))
    assert exact.dtype == bucketed.dtype == ref.dtype == np.float32
    assert exact.tobytes() == bucketed.tobytes()
    np.testing.assert_allclose(bucketed, ref, rtol=2e-6, atol=1e-6)


@pytest.mark.parametrize("case", ["log", "floor_divide0", "reciprocal_int",
                                  "divide0", "arccosh"])
def test_padded_rows_raise_nothing_and_stay_out(case):
    # one column: a 1-D program is the kernels' and runs exact shapes
    xn = np.arange(1, 38, dtype=np.float64).reshape(37, 1)
    ints = np.arange(1, 38, dtype=np.int64).reshape(37, 1)
    fns = {
        "log": lambda m: m.log(m.array(xn)) * 2.0,
        "floor_divide0": lambda m: m.array(ints) // m.array(ints * 0 + 3),
        "reciprocal_int": lambda m: m.reciprocal(m.array(ints)),
        "divide0": lambda m: m.array(xn) / m.array(xn - 1.0),
        "arccosh": lambda m: m.arccosh(m.array(xn)),
    }
    _policy("off")
    exact = np.asarray(fns[case](rt).asarray())
    _policy("pow2")
    p0 = classes.snapshot()["padded"]
    got = fns[case](rt)
    out = np.asarray(got.asarray())
    assert classes.snapshot()["padded"] == p0 + 1
    assert out.shape == (37, 1) and out.dtype == exact.dtype
    assert out.tobytes() == exact.tobytes()
    ref = _ref_exact(fns[case])
    assert ref.dtype == out.dtype
    np.testing.assert_allclose(out, ref, rtol=1e-12)


@pytest.mark.parametrize("case", ["axpy", "chain_sum", "cast"])
def test_a_program_the_kernels_take_runs_exact_shapes(case):
    """Under pow2 a 1-D elementwise program (the kernels': elemred) is not
    bucketed: its leaves keep their length and its result is the exact
    one."""
    xn = np.arange(1, 38, dtype=np.float64) / 7.0
    yn = np.arange(37, 0, -1, dtype=np.float64)
    fns = {
        "axpy": lambda m: 2.5 * m.array(xn) + m.array(yn),
        "chain_sum": lambda m: m.sum(m.sin(m.array(xn)) * 3.0 + 1.0),
        "cast": lambda m: (m.array(xn) * 4.0).astype(np.int32),
    }
    _policy("off")
    exact = np.asarray(fns[case](rt).asarray())
    _policy("pow2")
    snap0 = classes.snapshot()
    got = np.asarray(fns[case](rt).asarray())
    snap = classes.snapshot()
    assert snap["planned"] == snap0["planned"]
    assert snap["padded"] == snap0["padded"]
    span = events.last(1, type="flush")[-1]
    assert "compile_class" not in span
    assert classes.decisions()[span["fingerprint"]] is None
    assert got.dtype == exact.dtype and got.tobytes() == exact.tobytes()
    np.testing.assert_allclose(got, _ref_exact(fns[case]), rtol=1e-12)


def test_forced_plan_skips_the_op_safety_proof():
    """``compile:bucket`` forges a claim for a program ``plan_for`` bails
    on (the seeded violation a verify rule is to catch)."""
    roots = PROGRAMS["flip"](rt)
    p, vals = fuser.prepare_program([r._expr for r in roots])
    assert classes.plan_for(p, vals) is None
    forged = classes.forced_plan(p, vals)
    assert forged is not None and forged.token == ("pow2", 64)
    jroots = PROGRAMS["flip"](rtj)
    jp, jleaves, _ = jfuser._prepare_program([r._expr for r in jroots])
    jforged = jclasses.forced_plan(jp, jfuser._gather_leaf_vals(jleaves)[0])
    assert jforged.token == forged.token
    assert jforged.pad_waste_bytes == forged.pad_waste_bytes
    rt.sync()
    with faults.inject("compile:bucket", "once"):
        np.asarray(rt.array(V37) * 2.0)
    assert events.last(1, type="flush")[-1]["compile_class"] == ["pow2", 64]


def test_shape_soak_holds_the_hit_rate():
    """ramba_tpu's soak traffic (``bench.py:1145-1200``): 32 row counts in
    1..300 of 256 float32 columns, 240 flushes drawn from them, pow2."""
    sizes = np.random.default_rng(14).integers(1, 301, size=32)
    draw = np.random.default_rng(1400)
    bases = {int(n): np.full((int(n), 256), float(i % 7), np.float32)
             for i, n in enumerate(sizes)}
    h0, m0 = registry.get("fuser.cache_hit"), registry.get("fuser.cache_miss")
    p0 = classes.snapshot()["planned"]
    for i in range(240):
        n = int(sizes[draw.integers(len(sizes))])
        out = rt.array(bases[n]) * 2.0 + 1.0
        got = np.asarray(out.asarray())
        assert got.shape == (n, 256)
        if i % 40 == 0:
            np.testing.assert_array_equal(got, bases[n] * 2.0 + 1.0)
    hits = registry.get("fuser.cache_hit") - h0
    misses = registry.get("fuser.cache_miss") - m0
    assert hits + misses >= 240
    assert hits / (hits + misses) > 0.95, (hits, misses)
    assert classes.snapshot()["planned"] - p0 >= 240
