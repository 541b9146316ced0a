"""``core/rewrite.py``: the port's graph rewrites against ramba_tpu's.

Each rule is driven through a real flush on the hand-expanded xarray
idioms of ``tests/test_xarray_pandas.py`` (xarray itself is not needed:
the stack and concatenate programs are built by hand) and on the fusion
cases of ``tests/test_fusion.py`` (all but its segmentation cases):

* each rule fires, counted in ``rewrite.stats`` (ramba_tpu's count goes up
  on the same program);
* the rewritten program agrees with the un-rewritten one (the flag
  ``common.rewrite_enabled`` off) and with ramba_tpu: sums, means and
  anomalies within ``n * eps * sum|x|`` per group (the reduction order
  changes), gathers and selections exactly, dtypes exactly;
* the 1-D stack of group sums is classified as a segred program by
  ``ops/kernel_backend.py`` (pure Python, so it runs here);
* no rule raises (``rewrite.stats["errors"]`` stays 0).
"""

import numpy as np
import pytest
import torch

import jax
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from ramba_tpu.core import rewrite as rewrite_j
from ramba_tpu_torch import common
from ramba_tpu_torch.core import expr as E
from ramba_tpu_torch.core import fuser, rewrite
from ramba_tpu_torch.ops import kernel_backend

EPS = 2.0 ** -52


@pytest.fixture(autouse=True)
def _port_on_cpu():
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    torch.set_num_threads(1)
    errors = rewrite.stats["errors"]
    yield
    assert rewrite.stats["errors"] == errors, rewrite.errors


def _host(x):
    return np.asarray(x.asarray() if hasattr(x, "asarray") else x)


def _monthly(seed, rows=3):
    labels = np.arange(365) * 12 // 365  # 12 months of a year, in order
    rs = np.random.RandomState(seed)
    labels = rs.permutation(labels)
    x = rs.rand(rows, 365)
    return x, labels, [np.where(labels == g)[0] for g in range(12)]


def _without_rewrites(fn):
    old = common.rewrite_enabled
    common.rewrite_enabled = False
    try:
        return fn()
    finally:
        common.rewrite_enabled = old


def _bound(x, cols):
    """n * eps * sum|x_g| per group (the reduction order differs)."""
    return max(len(c) for c in cols) * EPS * np.abs(x).sum()


@pytest.mark.parametrize("kind", ["mean", "sum", "min", "max", "prod",
                                  "nansum", "nanmean"])
def test_stack_reduce_advindex_fires_and_agrees(kind):
    x, labels, cols = _monthly(3)
    if kind == "prod":
        x = 1 + x / 64
    if kind.startswith("nan"):
        x[:, ::17] = np.nan

    def prog(m, X):
        return m.stack([getattr(m, kind)(X[:, idx], axis=1) for idx in cols],
                       axis=1)

    before = rewrite.stats["rewrite_stack_reduce_advindex"]
    before_j = rewrite_j.stats["rewrite_stack_reduce_advindex"]
    got = _host(prog(rt, rt.fromarray(x)))
    assert rewrite.stats["rewrite_stack_reduce_advindex"] == before + 1
    want = _host(prog(rtj, rtj.fromarray(x)))
    assert rewrite_j.stats["rewrite_stack_reduce_advindex"] == before_j + 1
    plain = _without_rewrites(lambda: _host(prog(rt, rt.fromarray(x))))
    assert rewrite.stats["rewrite_stack_reduce_advindex"] == before + 1
    assert got.dtype == want.dtype == plain.dtype and got.shape == want.shape
    bound = _bound(np.nan_to_num(x), cols) * (8 if kind == "prod" else 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=bound)
    np.testing.assert_allclose(got, plain, rtol=0, atol=bound)


def test_one_dimensional_group_sums_reach_the_segred_program():
    """stack([x[idx_g].sum() for g]) over 1-D data: the rewritten flush is
    ONE segment_reduce, which the segred classifier takes."""
    n, G = 24 * 30, 24
    rs = np.random.RandomState(4)
    x = rt.fromarray(rs.rand(n))
    hour = np.arange(n) % G
    idx = [np.where(hour == g)[0] for g in range(G)]
    rt.sync()
    s = rt.stack([x[i].sum() for i in idx])
    roots = rewrite.rewrite_roots([s.read_expr()])
    program, leaves = fuser.prepare_program(roots)
    assert [op for op, _s, _a in program.instrs] == ["segment_reduce"]
    assert kernel_backend.classify(program, leaves) == "segred"
    got = _host(s)
    want = np.array([x.asarray()[i].sum() for i in idx])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=n * EPS * np.abs(want).sum())
    for kind in ("max", "min", "prod"):
        m = rt.stack([getattr(x[i], kind)() for i in idx])
        program, leaves = fuser.prepare_program(
            rewrite.rewrite_roots([m.read_expr()]))
        assert kernel_backend.classify(program, leaves) == "segred", kind


def test_stack_reduce_rejects_what_it_cannot_rewrite():
    x, labels, cols = _monthly(5)
    X = rt.fromarray(x)
    before = rewrite.stats["rewrite_stack_reduce_advindex"]
    # overlapping groups, partial coverage, an index on the card
    bad = [[cols[0], cols[0]], cols[:11],
           [rt.fromarray(c) for c in cols]]
    for groups in bad:
        out = rt.stack([rt.sum(X[:, g], axis=1) for g in groups], axis=1)
        want = np.stack([x[:, np.asarray(_host(g))].sum(axis=1)
                         for g in groups], axis=1)
        np.testing.assert_allclose(_host(out), want, rtol=1e-13)
    assert rewrite.stats["rewrite_stack_reduce_advindex"] == before
    # an integer mean (float32) differs from the segment mean's float64:
    # left alone, so the dtype stays ramba_tpu's
    xi = (x * 100).astype(np.int32)
    out = rt.stack([rt.mean(rt.fromarray(xi)[:, g], axis=1) for g in cols],
                   axis=1)
    want = rtj.stack([rtj.mean(rtj.fromarray(xi)[:, g], axis=1)
                      for g in cols], axis=1)
    assert _host(out).dtype == _host(want).dtype


@pytest.mark.parametrize("form", ["newaxis", "plain"])
@pytest.mark.parametrize("op", ["subtract", "add", "multiply", "true_divide"])
def test_concat_binop_getitem_fires_and_agrees(op, form):
    x, labels, cols = _monthly(6)
    if form == "newaxis":
        m = np.stack([x[:, labels == g].mean(axis=1) for g in range(12)], 0)
    else:
        x = x.T.copy()  # groups on axis 0, m[g] broadcast along the rows
        m = np.stack([x[labels == g].mean(axis=0) for g in range(12)], 0)

    def prog(mod, X, M):
        f = getattr(mod, op)
        if form == "newaxis":
            parts = [f(X[:, idx], M[g][:, None]) for g, idx in
                     enumerate(cols)]
            return mod.concatenate(parts, axis=1)
        parts = [f(X[idx], M[g]) for g, idx in enumerate(cols)]
        return mod.concatenate(parts, axis=0)

    before = rewrite.stats["rewrite_concat_binop_getitem"]
    got = _host(prog(rt, rt.fromarray(x), rt.fromarray(m)))
    assert rewrite.stats["rewrite_concat_binop_getitem"] == before + 1
    want = _host(prog(rtj, rtj.fromarray(x), rtj.fromarray(m)))
    plain = _without_rewrites(
        lambda: _host(prog(rt, rt.fromarray(x), rt.fromarray(m))))
    assert got.dtype == want.dtype == plain.dtype
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, want)


def test_concat_of_a_different_shape_is_left_alone():
    x, labels, cols = _monthly(7)
    m = np.stack([x[:, labels == g].mean(axis=1) for g in range(12)], 0)
    X, M = rt.fromarray(x), rt.fromarray(m)
    before = rewrite.stats["rewrite_concat_binop_getitem"]
    # the group index of m out of step with the group of x
    parts = [X[:, idx] - M[(g + 1) % 12][:, None] for g, idx in
             enumerate(cols)]
    got = _host(rt.concatenate(parts, axis=1))
    assert rewrite.stats["rewrite_concat_binop_getitem"] == before
    want = np.concatenate([x[:, idx] - m[(g + 1) % 12][:, None]
                           for g, idx in enumerate(cols)], axis=1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["int32", "int64", "float32", "float64"])
def test_arange_reshape(dtype):
    before = rewrite.stats["rewrite_arange_reshape"]
    got = rt.arange(24, dtype=dtype).reshape(2, 3, 4) * 2
    g = _host(got)
    assert rewrite.stats["rewrite_arange_reshape"] == before + 1
    want = _host(rtj.arange(24, dtype=dtype).reshape(2, 3, 4) * 2)
    assert g.dtype == want.dtype
    np.testing.assert_array_equal(g, want)
    g2 = _host(rt.arange(1.5, 13.5, 0.5).reshape(4, 6))
    np.testing.assert_array_equal(g2, _host(rtj.arange(1.5, 13.5, 0.5)
                                            .reshape(4, 6)))


def test_rewrite_flag_reads_the_environment(monkeypatch):
    import importlib

    monkeypatch.setenv("RAMBA_TPU_REWRITE", "0")
    fresh = importlib.reload(common)
    try:
        assert fresh.rewrite_enabled is False
    finally:
        monkeypatch.delenv("RAMBA_TPU_REWRITE")
        importlib.reload(common)
        common.set_device("cpu")
    assert common.rewrite_enabled is True


def test_a_raising_rule_is_counted_and_skipped(monkeypatch):
    def broken(node):
        raise RuntimeError("broken rule")

    monkeypatch.setattr(rewrite, "RULES", [broken] + rewrite.RULES)
    before = rewrite.stats["errors"]
    x = rt.fromarray(np.arange(8.0))
    y = _host(x * 2 + 1)
    np.testing.assert_array_equal(y, np.arange(8.0) * 2 + 1)
    assert rewrite.stats["errors"] > before
    assert rewrite.errors[-1][0] == "broken"
    rewrite.stats["errors"] = before  # the fixture checks the real rules


def test_index_constants_keep_their_host_copy():
    idx = np.array([3, 1, 2])
    c = E.as_expr(idx)
    assert isinstance(c, E.Const) and c.host is not idx
    np.testing.assert_array_equal(c.host, idx)
    idx[0] = 0  # the caller's later writes do not reach the copy
    assert c.host[0] == 3
    assert E.as_expr(np.ones(3)).host is None  # data, not an index


# -- the fusion cases of tests/test_fusion.py (all but segmentation) ----------


def test_chain_fuses_into_one_flush():
    rt.sync()
    f0 = rt.fuser_stats["flushes"]
    a = rt.arange(1000) / 10.0
    d = rt.sin(a) * rt.sin(a) + rt.cos(a) ** 2
    total = float(rt.sum(d))
    assert rt.fuser_stats["flushes"] == f0 + 1
    assert abs(total - 1000) < 1e-9


def test_inplace_loop_single_flush():
    rt.sync()
    f0 = rt.fuser_stats["flushes"]
    x = rt.zeros(100)
    for _ in range(10):
        x += 1
    np.testing.assert_array_equal(x.asarray(), np.full(100, 10.0))
    assert rt.fuser_stats["flushes"] == f0 + 1


def test_repeat_program_hits_compile_cache():
    def run():
        x = rt.fromarray(np.arange(64.0))
        return float(rt.sum(rt.sqrt(x) * 2 + 1))

    run()
    c0 = rt.fuser_stats["compiles"]
    run()
    assert rt.fuser_stats["compiles"] == c0


def test_scalar_change_does_not_recompile():
    x = rt.fromarray(np.arange(64.0))
    float(rt.sum(x * 2.0))
    c0 = rt.fuser_stats["compiles"]
    float(rt.sum(x * 3.0))
    assert rt.fuser_stats["compiles"] == c0
