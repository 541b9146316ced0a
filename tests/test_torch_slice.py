"""The first slice of the port as a whole, against ramba_tpu: the headline
fused chain, the chain over a materialised base (the elemred kernel's
program), jacobi2d on the stencil path, views that write through, and the
carrying of state between the packages.

Tolerances: float64 values rtol=atol=1e-12; float sums within
n * eps * sum|x| (the reduction order differs); integers, bools and dtypes
exact.
"""

import numpy as np
import pytest
import torch

import jax
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from ramba_tpu.models import jacobi as jjacobi
from ramba_tpu_torch import common, convert
from ramba_tpu_torch.core import autotune, fuser
from ramba_tpu_torch.core.expr import BF16
from ramba_tpu_torch.models import jacobi
from ramba_tpu_torch.ops import kernel_backend as kb
from ramba_tpu_torch.ops import stencil_kernel as sk

EPS64 = 2.0 ** -52


@pytest.fixture(autouse=True)
def _port_on_cpu():
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    # one thread: the tier-1 run shares the CPU among its workers, and
    # timing-sensitive tests of other files run beside these
    torch.set_num_threads(1)


def _headline(m, n):
    A = m.arange(n) / 1000.0
    B = m.sin(A)
    C = m.cos(A)
    D = B * B + C ** 2
    del A, B, C
    s = m.sum(D)
    return D, s


def test_headline_chain_is_one_flush_and_matches():
    n = 1 << 16
    D, s = _headline(rt, n)
    f0 = rt.fuser_stats["flushes"]
    sv = float(s)
    assert rt.fuser_stats["flushes"] - f0 == 1
    assert not fuser._default_stream.pending_roots()
    Dj, sj = _headline(rtj, n)
    assert D.dtype == Dj.dtype == np.float64
    np.testing.assert_allclose(np.asarray(D), np.asarray(Dj), rtol=1e-12,
                               atol=1e-12)
    assert abs(sv - float(sj)) <= n * EPS64 * n
    assert abs(sv - n) <= n * EPS64 * n


def test_materialised_chain_takes_the_elemred_program():
    n = 1 << 14
    base, basej = rt.arange(n) / 1000.0, rtj.arange(n) / 1000.0
    rt.sync()
    outs = []
    for m, b in ((rt, base), (rtj, basej)):
        B = m.sin(b)
        C = m.cos(b)
        D = B * B + C * C
        del B, C
        s = m.sum(D)
        if m is rt:
            p, vals = fuser.prepare_program([D.read_expr(), s.read_expr()])
            assert kb.classify(p, vals) == "elemred"
        outs.append((np.asarray(D), float(s)))
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=1e-12, atol=1e-12)
    assert abs(outs[0][1] - outs[1][1]) <= n * EPS64 * n


def test_kernel_and_generic_lowering_agree():
    """``force:torch`` pins the generic lowering for A/B runs."""
    x = rt.fromarray(np.random.RandomState(0).rand(4096))
    res = []
    try:
        for mode in ("force:kernel", "force:torch"):
            autotune.reconfigure(mode=mode)
            z = 2.5 * x + 1.0
            res.append((np.asarray(z), float(rt.sum(z))))
    finally:
        autotune.reconfigure()
    np.testing.assert_array_equal(res[0][0], res[1][0])
    assert abs(res[0][1] - res[1][1]) <= 4096 * EPS64 * 4096 * 3.5
    # an unknown mode raises (``race`` is a mode since the race was ported)
    with pytest.raises(ValueError):
        autotune.reconfigure(mode="fastest")
    autotune.reconfigure()


@pytest.mark.parametrize("fused_loop", [False, True])
def test_jacobi2d_matches_ramba_tpu(fused_loop):
    f = np.random.RandomState(1).rand(64, 64)
    before = sk.ineligible
    u = jacobi.jacobi2d(f, 20, fused_loop=fused_loop)
    uj = jjacobi.jacobi2d(f, 20, fused_loop=fused_loop)
    assert u.dtype == uj.dtype == np.float64
    np.testing.assert_allclose(np.asarray(u), np.asarray(uj), rtol=1e-12,
                               atol=1e-12)
    r, rj = jacobi.residual(u, f), jjacobi.residual(uj, f)
    assert abs(r - rj) <= 1e-12 * max(1.0, abs(rj))
    assert r < jacobi.residual(rt.zeros(f.shape), f)
    assert sk.ineligible == before  # every sweep took the kernel's path


def test_view_write_through():
    a = np.arange(12, dtype=np.float64).reshape(3, 4)
    for m in (rt, rtj):
        x = m.fromarray(a)
        t = x.T
        t += 1
        x[0, :] = -1.0
        s = x[1:, 1:]
        s *= 2
        r = x.reshape(4, 3)
        r[0, 0] = 7.0
        if m is rt:
            got = (np.asarray(x), np.asarray(t))
        else:
            want = (np.asarray(x), np.asarray(t))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_state_from_reference_keeps_dtypes():
    rs = np.random.RandomState(2)
    arrays = {
        "b": rs.rand(5) > 0.5, "i64": rs.randint(-9, 9, 5).astype(np.int64),
        "i32": rs.randint(-9, 9, 5).astype(np.int32), "f64": rs.rand(5),
        "f32": rs.rand(5).astype(np.float32), "bf16": rs.rand(5).astype(BF16),
    }
    ref = {k: rtj.fromarray(v) for k, v in arrays.items()}
    port = convert.state_from_reference({k: a.asarray() for k, a in ref.items()})
    for k, v in arrays.items():
        got = np.asarray(port[k])
        assert got.dtype == v.dtype, k
        np.testing.assert_array_equal(got.view(np.uint8), v.view(np.uint8))


def test_host_arrays_are_copied():
    a = np.arange(4.0)
    x = rt.fromarray(a)
    a[0] = 99.0
    assert float(x[0]) == 0.0
