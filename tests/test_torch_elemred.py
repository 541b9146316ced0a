"""The elemred kernel module (``ramba_tpu_torch/ops/elemred.py`` and the
classifier in ``ops/kernel_backend.py``) against ramba_tpu.

On the CPU the wrapper runs the kernel's plain version (the same
instructions through the port's op table); the CUDA kernel itself runs
only on the card (``chip_smoke.py`` and ``tests/test_torch_cuda.py``).

* ``classify`` agrees with ``ramba_tpu.ops.pallas_backend.classify``, apart
  from the documented differences: the port has no 128-lane rule (its
  kernel masks the tail) and takes GPU dtypes only (float32, float64,
  int32, int64, bool), with integer ``power`` on the generic lowering;
* every op of ``ELEM_OK`` through the port's path against ramba_tpu's
  default (XLA) lowering, the JAX package's own reference for elemred;
* four programs against ramba_tpu's elemred Pallas kernel, run in
  interpret mode off the TPU (``autotune`` forced to ``pallas``).

Tolerances: integers and bools exact; float64 rtol=atol=1e-12; float32
rtol=atol=1e-6 (torch's and XLA's math differ by ulps); float sums within
n * eps * sum|x|, since the two reduce in different orders.
"""

import numpy as np
import pytest
import torch

import jax
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from ramba_tpu.core import autotune as jautotune
from ramba_tpu.core import fuser as jfuser
from ramba_tpu.ops import pallas_backend
from ramba_tpu_torch import common, convert
from ramba_tpu_torch.core import fuser
from ramba_tpu_torch.ops import elemred
from ramba_tpu_torch.ops import kernel_backend as kb

RTOL = {"float32": 1e-6, "float64": 1e-12}
EPS = {"float32": 2.0 ** -23, "float64": 2.0 ** -52}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    # one thread: the tier-1 run shares the CPU among its workers, and
    # timing-sensitive tests of other files run beside these
    torch.set_num_threads(1)


def _pair(**arrays):
    ref = {k: rtj.fromarray(v) for k, v in arrays.items()}
    port = convert.state_from_reference({k: a.asarray() for k, a in ref.items()})
    return ref, port


def _same(got, want, what="", sum_n=None):
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype, f"{what}: port {g.dtype} vs ramba_tpu {w.dtype}"
    assert g.shape == w.shape, what
    if w.dtype.kind in "biu":
        np.testing.assert_array_equal(g, w, err_msg=what)
    elif sum_n is not None:
        bound = sum_n[0] * EPS[w.dtype.name] * sum_n[1]
        assert abs(float(g) - float(w)) <= bound, what
    else:
        r = RTOL[w.dtype.name]
        np.testing.assert_allclose(g, w, rtol=r, atol=r, err_msg=what)


def _programs(build, arrays):
    """(jax program, jax leaves, port program, port leaves) of ``build``."""
    ref, port = _pair(**arrays)
    jroots = build(rtj, ref)
    proots = build(rt, port)
    jp, jleaves = jfuser._linearize([a.read_expr() for a in jroots])
    pp, pvals = fuser.prepare_program([a.read_expr() for a in proots])
    return jp, [leaf.value for leaf in jleaves], pp, pvals


def _n(k=256, dt="float64", seed=0):
    return np.random.RandomState(seed).rand(k).astype(dt) + 0.25


def _ints(k=256, dt="int32", seed=0):
    rs = np.random.RandomState(seed)
    return rs.randint(-50, 50, k).astype(dt), \
        (rs.randint(1, 9, k) * rs.choice([-1, 1], k)).astype(dt)


CLASSIFY_CASES = {
    "sincos_sum": (lambda m, a: (lambda D: [D, m.sum(D)])(
        m.sin(a["x"]) * m.sin(a["x"]) + m.cos(a["x"]) ** 2),
        lambda: {"x": _n()}, "elemred", "elemred"),
    "axpy_sum": (lambda m, a: (lambda z: [z, m.sum(z)])(2.5 * a["x"] + a["y"]),
                 lambda: {"x": _n(), "y": _n(seed=1)}, "elemred", "elemred"),
    "mean_min_max": (lambda m, a: [m.mean(a["x"] * 3.0), m.min(a["x"]),
                                   m.max(a["x"] - a["y"])],
                     lambda: {"x": _n(), "y": _n(seed=1)}, "elemred", "elemred"),
    "int32_floordiv_mod": (
        lambda m, a: (lambda c: [c, m.sum(c)])(a["i"] // a["j"] + a["i"] % a["j"]),
        lambda: dict(zip("ij", _ints())), "elemred", "elemred"),
    "two_dim": (lambda m, a: [a["x"] * 2.0], lambda: {"x": _n(256).reshape(16, 16)},
                None, None),
    "reduce_feeds_map": (lambda m, a: [m.sum(a["x"]) + a["x"]],
                         lambda: {"x": _n()}, None, None),
    "over_64_instrs": (lambda m, a: [_chain(a["x"], 70)], lambda: {"x": _n()},
                       None, None),
    "not_elem_ok": (lambda m, a: [m.bitwise_and(a["i"], a["j"])],
                    lambda: dict(zip("ij", _ints())), None, None),
    "getitem": (lambda m, a: [a["x"][::2] + 1.0], lambda: {"x": _n()}, None, None),
    # documented differences
    "ragged_length": (lambda m, a: [m.sum(m.sin(a["x"]))], lambda: {"x": _n(100)},
                      None, "elemred"),
    "int16_dtype": (lambda m, a: [a["x"] * a["x"]],
                    lambda: {"x": _ints(dt="int16")[0]}, "elemred", None),
    "int_power": (lambda m, a: [a["i"] ** 5], lambda: {"i": _ints()[0]},
                  "elemred", None),
}


def _chain(x, k):
    for _ in range(k):
        x = x + 1.0
    return x


@pytest.mark.parametrize("name", sorted(CLASSIFY_CASES))
def test_classify_agrees_with_ramba_tpu(name):
    build, data, want_jax, want_port = CLASSIFY_CASES[name]
    jp, jvals, pp, pvals = _programs(build, data())
    assert pallas_backend.classify(jp, jvals) == want_jax
    assert kb.classify(pp, pvals) == want_port


def _domain(fname):
    if fname == "arccosh":
        return 1.1, 1.9
    if fname in ("arcsin", "arccos", "arctanh"):
        return -0.9, 0.9
    if fname in ("log", "log2", "log10", "sqrt", "reciprocal", "log1p"):
        return 0.1, 3.0
    return -3.0, 3.0


def _ufuncs(nin):
    return sorted(f for f in kb.ELEM_OK if f in rt.__dict__
                  and isinstance(getattr(np, f, None), np.ufunc)
                  and getattr(np, f).nin == nin)


UNARY_ELEM = _ufuncs(1)
BINARY_ELEM = _ufuncs(2)


def _through_kernel_path(port_arr):
    p, vals = fuser.prepare_program([port_arr.read_expr()])
    assert kb.classify(p, vals) == "elemred"


@pytest.mark.parametrize("fname", UNARY_ELEM)
def test_elem_ok_unary_op(fname):
    lo, hi = _domain(fname)
    rs = np.random.RandomState(len(fname))
    x = rs.uniform(lo, hi, 256)
    x[::17] = np.round(x[::17])  # integral values: floor/rint/sign edges
    if fname in ("arccosh",):
        x = np.maximum(x, 1.0)
    if fname in ("log", "log2", "log10", "sqrt", "reciprocal"):
        x = np.maximum(x, 0.1)
    ref, port = _pair(x=x, x32=x.astype(np.float32))
    for k in ("x", "x32"):
        got = getattr(rt, fname)(port[k])
        _through_kernel_path(got)
        _same(got, getattr(rtj, fname)(ref[k]), f"{fname}({k})")


@pytest.mark.parametrize("fname", BINARY_ELEM)
def test_elem_ok_binary_op(fname):
    rs = np.random.RandomState(len(fname))
    x = rs.uniform(-3, 3, 256)
    y = rs.uniform(0.5, 3, 256) * rs.choice([-1, 1], 256)
    x[::9] = y[::9]  # equal operands for the comparisons
    if fname == "power":
        x = np.abs(x) + 0.1
    ref, port = _pair(x=x, y=y, x32=x.astype(np.float32))
    got = getattr(rt, fname)(port["x"], port["y"])
    _through_kernel_path(got)
    _same(got, getattr(rtj, fname)(ref["x"], ref["y"]), f"{fname}(f64, f64)")
    got = getattr(rt, fname)(port["x32"], 1.5)
    _through_kernel_path(got)
    _same(got, getattr(rtj, fname)(ref["x32"], 1.5), f"{fname}(f32, weak)")


def test_elem_ok_where_and_int_ops():
    i, j = _ints(dt="int64")
    ref, port = _pair(x=_n(), i=i, j=j)
    for build in (lambda m, a: m.where(a["x"] > 0.7, a["x"], -1.0),
                  lambda m, a: a["i"] // a["j"], lambda m, a: a["i"] % a["j"],
                  lambda m, a: m.maximum(a["i"], a["j"]) * 3,
                  lambda m, a: m.sign(a["i"]) + m.absolute(a["j"])):
        got = build(rt, port)
        _through_kernel_path(got)
        _same(got, build(rtj, ref))


@pytest.fixture
def jax_elemred_interpreted():
    """ramba_tpu's elemred Pallas kernel, interpreted off the TPU; counts
    the programs it lowered so a silent fall-back to XLA fails the test."""
    lowered = []
    real = pallas_backend._build_elemred

    def counting(program):
        lowered.append(program)
        return real(program)

    jautotune.reconfigure(mode="force:pallas")
    jfuser._compile_cache.clear()
    pallas_backend._build_elemred = counting
    try:
        yield lowered
    finally:
        pallas_backend._build_elemred = real
        jautotune.reconfigure()


N_LANES = 128 * 8


@pytest.mark.parametrize("dt", ["float64", "float32"])
def test_sincos_sum_against_jax_pallas(jax_elemred_interpreted, dt):
    x = np.random.RandomState(3).rand(N_LANES).astype(dt) * 10
    ref, port = _pair(x=x)
    outs = []
    for m, a in ((rtj, ref), (rt, port)):
        D = m.sin(a["x"]) * m.sin(a["x"]) + m.cos(a["x"]) * m.cos(a["x"])
        s = m.sum(D)
        outs.append((np.asarray(D), np.asarray(s)))
    assert jax_elemred_interpreted, "ramba_tpu did not run its Pallas kernel"
    _same(outs[1][0], outs[0][0], "D")
    _same(outs[1][1], outs[0][1], "sum", sum_n=(N_LANES, N_LANES * 1.0))


def test_axpy_sum_against_jax_pallas(jax_elemred_interpreted):
    rs = np.random.RandomState(4)
    ref, port = _pair(x=rs.rand(N_LANES), y=rs.rand(N_LANES))
    outs = []
    for m, a in ((rtj, ref), (rt, port)):
        z = 2.5 * a["x"] + a["y"]
        outs.append((np.asarray(z), np.asarray(m.sum(z))))
    assert jax_elemred_interpreted
    _same(outs[1][0], outs[0][0], "z")
    _same(outs[1][1], outs[0][1], "sum", sum_n=(N_LANES, 3.5 * N_LANES))


def test_mean_min_max_against_jax_pallas(jax_elemred_interpreted):
    rs = np.random.RandomState(5)
    ref, port = _pair(x=rs.randn(N_LANES).astype(np.float32))
    outs = []
    for m, a in ((rtj, ref), (rt, port)):
        v = a["x"] * 3.0 - 1.0
        r = [m.mean(v), m.min(v), m.max(v)]
        outs.append([np.asarray(t) for t in r])
    assert jax_elemred_interpreted
    _same(outs[1][0], outs[0][0], "mean", sum_n=(N_LANES, 4.0 * 4))
    _same(outs[1][1], outs[0][1], "min")
    _same(outs[1][2], outs[0][2], "max")


def test_int32_chain_against_jax_pallas(jax_elemred_interpreted):
    i, j = _ints(N_LANES, seed=6)
    ref, port = _pair(i=i, j=j)
    outs = []
    for m, a in ((rtj, ref), (rt, port)):
        c = (a["i"] // a["j"]) * 3 + a["i"] % a["j"]
        outs.append((np.asarray(c), np.asarray(m.sum(c))))
    assert jax_elemred_interpreted
    _same(outs[1][0], outs[0][0], "chain")
    _same(outs[1][1], outs[0][1], "sum")


def test_wrapper_never_reaches_plain_version_off_cpu(monkeypatch):
    """On a tensor that is not on the CPU the wrapper launches or raises;
    it never runs the plain version."""
    x = rt.fromarray(_n())
    p, vals = fuser.prepare_program([(x * 2.0).read_expr()])
    meta = [v.to("meta") if isinstance(v, torch.Tensor) else v for v in vals]
    called = []
    monkeypatch.setattr(elemred, "elemred_reference",
                        lambda *a: called.append(a))
    with pytest.raises(RuntimeError, match="expected cuda"):
        elemred.run(p, meta)
    assert not called


def test_generated_source_per_program():
    """One generated CUDA source per program: scalars are kernel arguments
    passed by value, so a new constant reuses the source (and the built
    library); the cast plan is explicit: the weak float and int scalars
    arrive as double and long long and are cast to the float32 loop."""
    x = rt.fromarray(_n().astype(np.float32))
    plans = []
    for c in (2.5, 7.0):
        p, vals = fuser.prepare_program([(x * c + 1).read_expr()])
        plans.append(elemred.plan_for(p, vals))
    assert plans[0].source == plans[1].source
    assert plans[0].name == plans[1].name
    src = plans[0].source
    assert '#include "elemred.cuh"' in src
    assert "double s1" in src and "long long s2" in src
    assert "const double x1 = (double)p.s1;" in src
    assert "((float)(x1))" in src and "((float)(x2))" in src
    assert "Vec<float, V>" in src and "V = 4" in src  # 16-byte groups
    assert 'extern "C" int ramba_elemred_launch(' in src
    assert elemred.launches == 0  # nothing launched on the CPU
