"""The shadow recompute audit (``RAMBA_AUDIT``,
``ramba_tpu_torch/resilience/integrity.py`` and the fuser's hook), x64
regime, on the CPU.

The counterparts of ``tests/test_integrity.py:548-610`` (a clean flush
audits without a mismatch, a flipped shadow is a mismatch that still
serves the primary result and seeds no memo entry, audits on and off give
the same bytes), then the port's own: the classifier's verdicts (bytes,
``numeric`` within a slack, NaN positions, integers, shapes), the slack
of a float reduction from the kernels' rounding depth (the reference's 64
ulp of the result calls a clean sum with cancellation a mismatch), the
sampling (one in N eligible flushes), eligibility (a certified memo plan,
the fused rung, no memo hit), and the main path's programs (the chain,
axpy + sum, the groupby sum) audited ``ok`` or ``numeric`` and served
with ``ramba_tpu``'s fused values.  ``ramba_tpu``'s own audit is red on
jax 0.9 (its eager rung calls ``jax.spmd_mode``): its fused results and
its stated contract are the oracle.
"""

import numpy as np
import pytest
import torch

import jax
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from ramba_tpu_torch import common
from ramba_tpu_torch.core import fuser, memo
from ramba_tpu_torch.observe import events
from ramba_tpu_torch.ops import elemred, segred
from ramba_tpu_torch.resilience import faults, integrity


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    torch.set_num_threads(1)
    monkeypatch.setenv("RAMBA_RETRY_BASE_S", "0")
    for k in ("RAMBA_MEMO", "RAMBA_AUDIT", "RAMBA_INTEGRITY"):
        monkeypatch.delenv(k, raising=False)
    fuser.flush()
    faults.configure(None)
    memo.reset()
    integrity.reset()
    yield
    faults.reset()
    memo.reset()
    integrity.reset()


@pytest.fixture
def audit(monkeypatch):
    monkeypatch.setenv("RAMBA_MEMO", "1")
    monkeypatch.setenv("RAMBA_AUDIT", "1")


def _audited_flush(scale):
    a = rt.fromarray(np.arange(512.0) / 100.0)
    b = rt.fromarray(np.arange(512.0) * 0.5 + 1.0)
    return float(rt.sum((a + b) * scale))


def _expect(scale):
    return float(np.sum((np.arange(512.0) / 100.0
                         + np.arange(512.0) * 0.5 + 1.0) * scale))


# -- tests/test_integrity.py's TestShadowAudit -------------------------------


def test_clean_flush_audits_without_mismatch(audit):
    assert _audited_flush(2.0) == pytest.approx(_expect(2.0), rel=1e-12)
    snap = integrity.snapshot()
    assert snap["audits"] >= 1 and snap["audit_every"] == 1, snap
    assert snap["audit_mismatches"] == 0 and snap["audit_errors"] == 0, snap
    span = events.last(1, type="flush")[-1]
    assert span["audited"] is True and span["audit_s"] >= 0


def test_flipped_shadow_flags_mismatch_serves_primary(audit):
    faults.configure("audit:shadow:flip:bytes=4")
    got = _audited_flush(3.0)  # the primary result is served
    assert got == pytest.approx(_expect(3.0), rel=1e-12)
    snap = integrity.snapshot()
    assert snap["audits"] >= 1 and snap["audit_mismatches"] >= 1, snap
    assert snap["audit_errors"] == 0, snap
    # a flush whose audit disagreed seeds no memo entry
    assert memo.cache.snapshot()["entries"] == 0
    assert any(e["site"] == "audit:shadow"
               for e in events.last(8, type="integrity"))
    assert events.last(1, type="integrity_audit")[-1]["outcome"] == \
        "mismatch"
    assert events.last(1, type="flush")[-1]["audit_mismatch"] is True


def test_audit_on_off_byte_identity(monkeypatch):
    monkeypatch.setenv("RAMBA_MEMO", "1")

    def chain():
        rng = np.random.default_rng(1234)
        outs = []
        a = rt.fromarray(rng.standard_normal(256))
        b = rt.fromarray(rng.standard_normal(256))
        for _ in range(4):
            k = float(rng.uniform(0.5, 2.0))
            c = (a * k + b) - 0.25
            outs.append(np.asarray(c).tobytes())
            outs.append(np.asarray(rt.sum(c * c)).tobytes())
        return outs

    baseline = chain()
    fuser.flush()
    memo.reset()
    integrity.reset()
    monkeypatch.setenv("RAMBA_AUDIT", "1")
    assert chain() == baseline
    snap = integrity.snapshot()
    assert snap["audits"] >= 1 and snap["audit_mismatches"] == 0, snap


# -- the classifier ----------------------------------------------------------


def _t(*v, dtype=torch.float64):
    return torch.tensor(v, dtype=dtype)


@pytest.mark.parametrize("primary,shadow,slack,want", [
    ([_t(1.0, 2.0)], [_t(1.0, 2.0)], None, (0, 0)),
    ([_t(1.0, 2.0)], [_t(1.0, 2.0 + 2e-15)], None, (0, 1)),
    ([_t(1.0, 2.0)], [_t(1.0, 2.5)], None, (1, 0)),
    ([_t(1.0, float("nan"))], [_t(1.0, float("nan"))], None, (0, 0)),
    ([_t(1.0, float("nan"))], [_t(float("nan"), 1.0)], None, (1, 0)),
    ([_t(float("inf"), 1.0)], [_t(float("inf"), 1.0 + 1e-15)], None, (0, 1)),
    ([_t(1, 2, dtype=torch.int64)], [_t(1, 3, dtype=torch.int64)], None,
     (1, 0)),
    ([_t(True, dtype=torch.bool)], [_t(False, dtype=torch.bool)], None,
     (1, 0)),
    ([_t(1.0, 2.0)], [_t(1.0, 2.0, 3.0)], None, (1, 0)),
    ([_t(1.0)], [_t(1.0), _t(2.0)], None, (1, 0)),
    ([_t(1.0, 2.0)], [_t(1.0, 2.0, dtype=torch.float32)], None, (1, 0)),
    # a reduction's own slack: the bound, not 64 ulp of the value
    ([_t(1e-3)], [_t(1e-3 + 1e-9)], [1e-8], (0, 1)),
    ([_t(1e-3)], [_t(1e-3 + 1e-7)], [1e-8], (1, 0)),
    ([_t(1 + 1j, dtype=torch.complex128)],
     [_t(1 + 1j + 1e-15, dtype=torch.complex128)], None, (0, 1)),
])
def test_classify_divergence(primary, shadow, slack, want):
    assert integrity._classify_divergence(primary, shadow, slack) == want


def test_a_clean_sum_with_cancellation_is_numeric_not_mismatch(audit):
    """Two orders of a sum whose terms cancel differ by far more than 64
    ulp of the result, within the depth bound of sum|x|: the slack the
    fuser derives classifies it numeric."""
    rs = np.random.RandomState(0)
    x = rs.standard_normal(1 << 16)
    x -= x.mean()
    t = torch.from_numpy(x)
    fused = t.reshape(256, 256).sum(1).sum()  # another order
    shadow = t.sum()
    diff = abs(float(fused - shadow))
    assert diff > 64 * 2.0 ** -52 * abs(float(shadow))  # the reference's slack
    program, vals = fuser.prepare_program([rt.sum(rt.fromarray(x))._expr])
    outs, slack = fuser._audit_rerun(program, vals)
    assert outs[0].numpy().tobytes() == shadow.numpy().tobytes()
    depth = max(elemred.depth(1 << 16), segred.depth(1 << 16))
    assert float(slack[0]) == pytest.approx(
        2 * depth * 2.0 ** -52 * np.abs(x).sum(), rel=1e-12)
    assert integrity._classify_divergence([fused], [shadow], slack) == (0, 1)
    assert integrity._classify_divergence([fused], [shadow], None) == (1, 0)


def test_slack_of_groupby_means_products_and_axis_sums():
    x = rt.fromarray(np.linspace(-1.0, 2.0, 600))
    g = x.groupby(0, np.arange(600) % 5, 5)
    for make, kinds in [(lambda: g.sum(), "sum"), (lambda: g.mean(), "mean"),
                        (lambda: rt.prod(x[:50] + 1.5), "prod"),
                        (lambda: rt.sum(x.reshape(20, 30), axis=0), "sum")]:
        program, vals = fuser.prepare_program([make()._expr])
        outs, slack = fuser._audit_rerun(program, vals)
        assert slack[0] is not None and slack[0].shape == outs[0].shape, kinds
        assert bool((slack[0] > 0).all()), kinds
    # integer and elementwise outputs keep the exact or 64-ulp rule
    for make in (lambda: rt.sum(rt.arange(10)), lambda: x * 2.0):
        program, vals = fuser.prepare_program([make()._expr])
        assert fuser._audit_rerun(program, vals)[1] == [None]


# -- sampling and eligibility ------------------------------------------------


def test_one_in_n_eligible_flushes(monkeypatch):
    monkeypatch.setenv("RAMBA_MEMO", "1")
    monkeypatch.setenv("RAMBA_AUDIT", "3")
    x = rt.fromarray(np.arange(64.0))
    for k in range(7):
        float(rt.sum(x * float(k + 1)))
    assert integrity.snapshot()["audits"] == 2


def test_only_certified_fused_unserved_flushes_are_audited(audit):
    x = rt.fromarray(np.arange(64.0))
    float(rt.sum(x * 2.0))
    assert integrity.snapshot()["audits"] == 1
    float(rt.sum(x * 2.0))  # a memo hit: not audited
    assert integrity.snapshot()["audits"] == 1
    assert events.last(1, type="flush")[-1]["cache"] == "memo"
    with faults.active("oom:1"):  # a degraded flush: not audited
        float(rt.sum(x * 3.0))
    assert events.last(1, type="flush")[-1]["degraded"] == "split"
    assert integrity.snapshot()["audits"] == 1
    st = rt.stencil(lambda a: a[0, 1] + a[0, -1])
    np.asarray(rt.sstencil(st, rt.fromarray(np.ones((8, 8)))))
    # the body is a function the memo cannot token: uncertified
    assert integrity.snapshot()["audits"] == 1
    float(rt.sum(x * 4.0))
    assert integrity.snapshot()["audits"] == 2


def test_unset_costs_no_audit_and_no_rerun(monkeypatch):
    monkeypatch.setenv("RAMBA_MEMO", "1")
    x = rt.fromarray(np.arange(64.0))
    float(rt.sum(x * 2.0))
    snap = integrity.snapshot()
    assert snap["audits"] == 0 and snap["audit_every"] == 0
    assert "audited" not in events.last(1, type="flush")[-1]


def test_integrity_off_disarms_the_audit(audit, monkeypatch):
    monkeypatch.setenv("RAMBA_INTEGRITY", "0")
    _audited_flush(2.0)
    assert integrity.snapshot()["audits"] == 0


def test_an_audit_that_raises_never_fails_the_flush(audit):
    with faults.active("eager:always:fatal"):
        got = _audited_flush(5.0)
    assert got == pytest.approx(_expect(5.0), rel=1e-12)
    snap = integrity.snapshot()
    assert snap["audit_errors"] == 1 and snap["audits"] == 0
    assert events.last(1, type="integrity_audit")[-1]["outcome"] == "error"


# -- the main path's programs, against ramba_tpu's fused results --------------


def _series():
    rs = np.random.RandomState(11)
    return rs.rand(4096) - 0.25, rs.randint(0, 24, 4096)


MAIN = {
    "chain": lambda m: (lambda A: m.sin(A) ** 2 + m.cos(A) ** 2)(
        m.fromarray(np.arange(4096) / 1000.0)),
    "chain_sum": lambda m: (lambda A: m.sum(m.sin(A) * m.sin(A)
                                            + m.cos(A) * m.cos(A)))(
        m.fromarray(np.arange(4096) / 1000.0)),
    "axpy_sum": lambda m: m.sum(
        2.5 * m.fromarray(np.sin(np.arange(4096) * 1e-3))
        + m.fromarray(np.cos(np.arange(4096) * 1e-3))),
    "groupby_sum": lambda m: (lambda d, lab: m.fromarray(d).groupby(
        0, lab, 24).sum())(*_series()),
}


@pytest.mark.parametrize("name", sorted(MAIN))
@pytest.mark.parametrize("flip", [False, True], ids=["clean", "flipped"])
def test_main_path_programs(audit, name, flip):
    want = np.asarray(MAIN[name](rtj))
    if flip:
        faults.configure("audit:shadow:flip:bytes=4")
    got = np.asarray(MAIN[name](rt))
    outcome = events.last(1, type="integrity_audit")[-1]["outcome"]
    assert integrity.snapshot()["audits"] == 1
    assert outcome == ("mismatch" if flip else "ok"), outcome
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=4096 * 2.0 ** -52)
    # served: the primary bytes, audited or not
    faults.configure(None)
    memo.reset()
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("RAMBA_AUDIT")
        plain = np.asarray(MAIN[name](rt))
    assert got.tobytes() == plain.tobytes()


def test_a_mismatch_evicts_so_the_repeat_runs_again(audit):
    x = rt.fromarray(np.arange(256.0))
    faults.configure("audit:shadow:flip:bytes=4")
    first = float(rt.sum(x * 2.0 + 1.0))
    faults.configure(None)
    m0 = memo.cache.misses
    again = float(rt.sum(x * 2.0 + 1.0))  # nothing cached: runs again
    assert memo.cache.misses == m0 + 1 and again == first
    assert integrity.snapshot()["audits"] == 2
    h0 = memo.cache.hits
    float(rt.sum(x * 2.0 + 1.0))  # the clean audit cached it
    assert memo.cache.hits == h0 + 1
