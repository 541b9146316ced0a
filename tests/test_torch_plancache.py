"""The port's plan certificates (``analyze/plancert.py`` +
``core/plancache.py``, ``RAMBA_PLANCERT``) on the CPU.

The cases of ``tests/test_plancache.py``: a hit gives the same bytes and
skips the analysis (a counting verifier proves it), every ambient input
a signature field reads (the rule set, the governor's budget band, the
mesh epoch) turns a certificate stale with the field named, a
``plan:stale``-forged verdict raises under strict and re-analyzes under
warn, forging fault sites make the cache stand down, certificates
round-trip through their payload, the batched agreement clears the
store on a divergent round, the store's cap evicts, and the offline
``--plan-audit`` re-derives every stored proof (and flags a broken one).
The shared tier (``RAMBA_ARTIFACTS``): a published certificate is
adopted by a process whose local store misses (``tier == "shared"``).
The admission estimate a certificate snapshots is held against
ramba_tpu's analytic one.
"""

import io
import json
import os

import numpy as np
import pytest
import torch

import jax
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from ramba_tpu.core import fuser as jfuser
from ramba_tpu.resilience import memory as jmemory
from ramba_tpu_torch import common, diagnostics
from ramba_tpu_torch.analyze import lint as alint
from ramba_tpu_torch.analyze import plancert
from ramba_tpu_torch.analyze.findings import ProgramVerificationError
from ramba_tpu_torch.core import fuser, memo, plancache
from ramba_tpu_torch.observe import events, registry
from ramba_tpu_torch.resilience import faults, memory


@pytest.fixture(autouse=True)
def _isolate(monkeypatch):
    """An armed plan cache under strict verify, an empty store, no
    faults; the ambient env the signatures read is scoped per test."""
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    torch.set_num_threads(1)
    fuser.flush()
    faults.configure(None)
    monkeypatch.setenv("RAMBA_PLANCERT", "1")
    monkeypatch.setenv("RAMBA_VERIFY", "strict")
    for k in ("RAMBA_VERIFY_RULES", "RAMBA_VERIFY_SKIP", "RAMBA_HBM_BUDGET",
              "RAMBA_ARTIFACTS", "RAMBA_MEMO", "RAMBA_PLANCERT_AGREE",
              "RAMBA_PLANCERT_MAX", "RAMBA_PLANCERT_SHARED"):
        monkeypatch.delenv(k, raising=False)
    plancache.reset()
    plancert.reset_caches()
    memo.reset()
    yield
    faults.reset()
    plancache.reset()
    plancert.reset_caches()
    memo.reset()


_A = np.arange(256.0).reshape(16, 16)


def _workload():
    a = rt.fromarray(_A)
    b = rt.fromarray(np.ones((16, 16)))
    return np.asarray((a + b) * 2.0 - 0.5)


def _counting_verifier(monkeypatch):
    calls = []
    inner = fuser._verify_if_enabled

    def wrapper(*args, **kwargs):
        calls.append(1)
        return inner(*args, **kwargs)

    monkeypatch.setattr(fuser, "_verify_if_enabled", wrapper)
    return calls


def test_off_by_default(monkeypatch):
    monkeypatch.setenv("RAMBA_PLANCERT", "0")
    _workload()
    _workload()
    snap = plancache.snapshot()
    assert not snap["enabled"]
    assert snap["entries"] == 0 and snap.get("lookups") is None


def test_repeat_hits_and_skips_analysis(monkeypatch):
    calls = _counting_verifier(monkeypatch)
    first = _workload()
    n_miss = len(calls)
    assert n_miss >= 1 and plancache.snapshot().get("stores", 0) >= 1
    second = _workload()
    snap = plancache.snapshot()
    assert snap.get("hits", 0) >= 1 and not snap.get("stale")
    assert len(calls) == n_miss  # no fresh verifier run
    assert first.tobytes() == second.tobytes()
    span = events.last(1, type="flush")[-1]
    assert span.get("plan_cache") == "hit"
    assert "prepare" in span["stages"] and "verify" not in span["stages"]


def test_certificate_snapshots_the_analysis():
    _workload()
    entry = next(iter(plancache._store.values()))
    cert = entry.cert
    assert cert.effect_class == "pure" and cert.effect_memoizable
    assert cert.chash is not None and cert.ruleset
    assert cert.admit_est_bytes > 0
    assert dict(cert.signature)["x64"] is True
    back = plancert.from_payload(
        json.loads(json.dumps(plancert.to_payload(cert))))
    assert back is not None
    assert back.signature == cert.signature
    assert back.sig_fields == cert.sig_fields
    assert back.findings_digest == cert.findings_digest
    assert back.aval_sig == cert.aval_sig


def test_ruleset_change_invalidates(monkeypatch):
    _workload()
    _workload()
    assert plancache.snapshot().get("hits", 0) >= 1
    monkeypatch.setenv("RAMBA_VERIFY_RULES", "shape-dtype")
    _workload()
    snap = plancache.snapshot()
    assert snap["stale_causes"].get("ruleset", 0) >= 1
    h0 = snap.get("hits", 0)
    _workload()  # re-certified under the new rule set
    assert plancache.snapshot().get("hits", 0) == h0 + 1


def test_budget_band_change_invalidates(monkeypatch):
    _workload()
    _workload()
    monkeypatch.setenv("RAMBA_HBM_BUDGET", str(1 << 30))
    _workload()
    snap = plancache.snapshot()
    assert snap.get("stale", 0) >= 1
    assert snap["stale_causes"].get("budget_band", 0) >= 1


def test_mesh_epoch_change_invalidates():
    from ramba_tpu_torch.parallel import mesh as pmesh

    _workload()
    _workload()
    pmesh.mesh_epoch += 1
    try:
        _workload()
        assert plancache.snapshot()["stale_causes"].get("mesh_epoch", 0) >= 1
    finally:
        pmesh.mesh_epoch -= 1


def test_forged_stale_strict_raises():
    first = _workload()
    _workload()
    with faults.active("plan:stale:always"):
        with pytest.raises(ProgramVerificationError, match="plan-stale"):
            _workload()
    fuser.flush()
    h0 = plancache.snapshot().get("hits", 0)
    again = _workload()
    assert plancache.snapshot().get("hits", 0) == h0 + 1
    assert again.tobytes() == first.tobytes()


def test_forged_stale_warn_reanalyzes(monkeypatch):
    monkeypatch.setenv("RAMBA_VERIFY", "warn")
    calls = _counting_verifier(monkeypatch)
    first = _workload()
    n_miss = len(calls)
    with faults.active("plan:stale:always"):
        second = _workload()
    assert len(calls) > n_miss
    assert second.tobytes() == first.tobytes()
    snap = plancache.snapshot()
    assert snap.get("forged_stale", 0) >= 1 and not snap.get("stale")


def test_forging_fault_sites_stand_down():
    _workload()
    s0 = plancache.snapshot().get("stores", 0)
    with faults.active("memo:insert:always"):
        _workload()
    snap = plancache.snapshot()
    assert snap.get("stores", 0) == s0 and snap.get("hits") is None


def test_memo_plan_is_rebuilt_from_the_certificate(monkeypatch):
    monkeypatch.setenv("RAMBA_MEMO", "1")
    a = rt.fromarray(_A)
    first = np.asarray(a * 3.0)
    second = np.asarray(a * 3.0)  # certificate hit, memo hit
    span = events.last(1, type="flush")[-1]
    assert span["plan_cache"] == "hit" and span["cache"] == "memo"
    assert first.tobytes() == second.tobytes()


def test_batched_agree_divergence_clears(monkeypatch):
    class _Stub:
        def engaged(self):
            return True

        def agree(self, name, n, reduce="min"):
            return n - 1  # a peer saw fewer hits

    monkeypatch.setattr(plancache, "_coherence", _Stub())
    monkeypatch.setenv("RAMBA_PLANCERT_AGREE", "2")
    _workload()
    _workload()
    snap = plancache.snapshot()
    assert snap.get("agree_rounds") is None
    assert snap["pending_agree_hits"] == 1
    _workload()
    snap = plancache.snapshot()
    assert snap.get("agree_rounds", 0) == 1
    assert snap.get("divergences", 0) == 1
    assert snap["entries"] == 0 and snap["pending_agree_hits"] == 0
    ev = events.last(1, type="plan_divergence")
    assert ev and ev[-1]["agreed"] == ev[-1]["proposed"] - 1


def test_eviction_cap(monkeypatch):
    monkeypatch.setenv("RAMBA_PLANCERT_MAX", "1")
    a = rt.fromarray(np.arange(16.0))
    np.asarray(a + 1.0)
    np.asarray(a * 3.0)
    snap = plancache.snapshot()
    assert snap["entries"] == 1 and snap.get("evictions", 0) >= 1


def test_plan_audit_over_live_trace(tmp_path, capsys):
    path = str(tmp_path / "plan.jsonl")
    events.configure(path)
    try:
        for _ in range(3):
            _workload()
    finally:
        events.configure(None)
    evs = alint.load_events(alint.discover(path)[0])
    assert any(e.get("type") == "plan_cert" for e in evs)
    assert alint.main(["--plan-audit", path]) == 0
    out = capsys.readouterr().out
    assert "proof re-derives" in out and "PROOF BROKEN" not in out
    rec = alint.plan_audit(evs, file=io.StringIO())
    assert rec["certificates"] >= 1 and rec["proof_broken"] == {}
    assert rec["live_hits"] == plancache.snapshot()["hits"] == 2
    assert rec["would_hits"] >= rec["live_hits"]
    for e in evs:
        if e.get("type") == "plan_cert":
            e["effect"][2] = "host-effecting"
    assert alint.plan_audit(evs, file=io.StringIO())["proof_broken"]


def test_the_shared_tier_and_the_report_name_their_items(monkeypatch,
                                                       tmp_path):
    from ramba_tpu_torch.fleet import artifacts

    # publish is the reference's with the tier off (the serve pipeline
    # calls it on every fresh certificate): False
    assert plancache.publish(None) is False
    assert plancache.publish(object()) is False
    # A.9's item landed: the diagnostics block is the cache's snapshot
    assert diagnostics.plancache_report() == plancache.snapshot()
    # the tier on: one process certifies and publishes ...
    monkeypatch.setenv("RAMBA_ARTIFACTS", str(tmp_path))
    artifacts.reset()
    try:
        want = _workload()
        certs = [e.cert for e in plancache._store.values()]
        assert certs and all(plancache.publish(c) for c in certs)
        assert plancache.snapshot()["publishes"] == len(certs)
        # ... and a store that misses adopts it: a shared hit, same bytes
        plancache.reset()
        np.testing.assert_array_equal(_workload(), want)
        snap = plancache.snapshot()
        assert snap["adopted"] >= 1 and snap["shared_hits"] >= 1
        assert registry.get("plancache.shared_hit") >= 1
        # a corrupt blob is evicted, never raised: the flush re-derives
        for name in os.listdir(tmp_path / "plancert"):
            (tmp_path / "plancert" / name).write_bytes(b"torn")
        plancache.reset()
        np.testing.assert_array_equal(_workload(), want)
        assert os.listdir(tmp_path / "plancert") == []
        assert plancache.snapshot().get("shared_hits", 0) == 0
        # RAMBA_PLANCERT_SHARED=0 keeps certificates off the tier
        monkeypatch.setenv("RAMBA_PLANCERT_SHARED", "0")
        assert not any(plancache.publish(c) for c in certs)
    finally:
        monkeypatch.delenv("RAMBA_ARTIFACTS")
        monkeypatch.delenv("RAMBA_PLANCERT_SHARED", raising=False)
        artifacts.reset()


@pytest.mark.parametrize("case", ["chain", "reduce", "matmul"])
def test_admission_estimate_matches_the_reference(case, monkeypatch):
    monkeypatch.setenv("RAMBA_HBM_ESTIMATE", "analytic")
    v = np.random.RandomState(2).rand(64, 32)

    def build(m):
        x = m.fromarray(v)
        if case == "chain":
            return [(m.sin(x) * 2.0 + x) * x]
        if case == "reduce":
            return [m.sum(x * x, axis=0), m.max(x)]
        return [x.T @ x]

    prog, vals = fuser.prepare_program([e._expr for e in build(rt)])
    jprog, jleaves, _ = jfuser._prepare_program(
        [e._expr for e in build(rtj)])
    jvals = [leaf.value for leaf in jleaves]
    assert memory.estimate_program_bytes(prog, vals) == \
        jmemory.estimate_program_bytes(jprog, jvals)
    fuser.flush()
    rtj.sync()
