"""The memory governor's core (``ramba_tpu_torch/resilience/memory.py``,
``spill.py``) against ramba_tpu's, x64 regime, on the CPU.

The counterparts of ``tests/test_memory.py``'s cases that do not route a
flush to the chunked rung (admission and that rung come with ROADMAP
A.8): the byte grammar; the budget, watermark and chunk knobs; no budget
on the CPU; the ledger tracking realized leaves, with the same byte counts
as ramba_tpu's ledger for the same program; the report's keys; host spill
and restore on the next touch, bit for bit and counted; a spilled leaf
computing correctly; no budget moving nothing; ``evict_for_oom`` sized
from the error's byte hint.  Both packages run each program in this
process (ramba_tpu on its virtual CPU mesh), each with its own ledger.
"""

import gc

import numpy as np
import pytest
import torch

import jax
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from ramba_tpu import common as rcommon
from ramba_tpu.core import fuser as rfuser
from ramba_tpu.resilience import faults as rfaults
from ramba_tpu.resilience import memory as rmemory
from ramba_tpu_torch import common
from ramba_tpu_torch.core import fuser
from ramba_tpu_torch.observe import attrib, registry
from ramba_tpu_torch.resilience import faults, memory, retry, spill

ENV = ("RAMBA_HBM_BUDGET", "RAMBA_HBM_WATERMARK", "RAMBA_HBM_ESTIMATE",
       "RAMBA_CHUNK_BYTES")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    torch.set_num_threads(1)
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    faults.configure(None)
    rfaults.configure(None)
    yield
    faults.reset()
    rfaults.reset()


# -- parse_bytes / knobs -----------------------------------------------------

@pytest.mark.parametrize("text", ["1g", "512k", "1.5m", "2kb", "2kib", "4T",
                                  "64", 128])
def test_parse_bytes_grammar(text):
    assert common.parse_bytes(text) == rcommon.parse_bytes(text)


@pytest.mark.parametrize("bad", ["", "abc", "12q"])
def test_parse_bytes_refuses(bad):
    for pkg in (common, rcommon):
        with pytest.raises(ValueError):
            pkg.parse_bytes(bad)


KNOBS = [
    {"RAMBA_HBM_BUDGET": "1m"},
    {"RAMBA_HBM_BUDGET": "1m", "RAMBA_HBM_WATERMARK": "0.5"},
    {"RAMBA_HBM_BUDGET": "1m", "RAMBA_HBM_WATERMARK": "700k"},
    {"RAMBA_HBM_BUDGET": "1m", "RAMBA_CHUNK_BYTES": "128k"},
    {"RAMBA_HBM_BUDGET": "3g", "RAMBA_HBM_WATERMARK": "0.75"},
    {"RAMBA_CHUNK_BYTES": "1"},
    {},
]


@pytest.mark.parametrize("env", KNOBS)
def test_budget_watermark_chunk_env(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert memory.budget_bytes() == rmemory.budget_bytes()
    assert memory.watermark_bytes() == rmemory.watermark_bytes()
    assert memory.chunk_target_bytes() == rmemory.chunk_target_bytes()


def test_no_budget_on_cpu_default():
    # the CPU reports no capacity and the env is clean: the governor is
    # off, not guessing
    assert memory.device_budget_bytes() is None
    assert memory.budget_bytes() is None
    assert memory.watermark_bytes() is None
    assert memory.reserve_headroom(1 << 40) == 0


def test_budget_is_the_card_share_of_each_rank(monkeypatch):
    # four ranks on one card get a quarter each; a rank alone the card
    from ramba_tpu_torch.parallel import distributed

    monkeypatch.setattr(distributed, "rank_devices",
                        lambda: [("h", "cuda:0")] * 4 + [("h", "cuda:1")])
    monkeypatch.setattr(distributed, "process_index", lambda: 2)
    assert memory._ranks_on_my_card() == 4
    monkeypatch.setattr(distributed, "process_index", lambda: 4)
    assert memory._ranks_on_my_card() == 1


# -- the ledger --------------------------------------------------------------

PROGRAMS = {
    "fromarray_f32": lambda m: [m.fromarray(np.ones(1024, np.float32))],
    "fromarray_2d_f64": lambda m: [m.fromarray(np.ones((32, 32)))],
    "flush_result_i64": lambda m: [m.arange(1000) * 2],
    "two_arrays": lambda m: (lambda x: [x, x + 1])(
        m.fromarray(np.ones(256, np.int32))),
    "created_f32": lambda m: [m.zeros((64, 64), dtype=np.float32) + 1],
    "bool_mask": lambda m: [m.arange(999) > 5],
}


def _live_delta(pkg, mem, fl, make):
    fl.flush()
    gc.collect()
    before = mem.ledger.live_bytes
    arrs = make(pkg)
    pkg.sync()
    grown = mem.ledger.live_bytes - before
    peak_ok = mem.ledger.peak_live_bytes >= before + grown
    del arrs
    gc.collect()
    return grown, peak_ok, mem.ledger.live_bytes - before


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_ledger_tracks_realized_leaves(name):
    make = PROGRAMS[name]
    got = _live_delta(rt, memory, fuser, make)
    want = _live_delta(rtj, rmemory, rfuser, make)
    assert got == want
    assert got[0] > 0 and got[1] and got[2] == 0


def test_memory_report_shape():
    from ramba_tpu import diagnostics

    fuser.flush()
    x = rt.fromarray(np.ones((32, 32), np.float32))
    y = rtj.fromarray(np.ones((32, 32), np.float32))
    rt.sync()
    rtj.sync()
    rep = memory.ledger.snapshot(top=100)
    ref = diagnostics.memory_report(top=100)
    assert set(ref) - {"tenant_live_bytes"} <= set(rep)
    assert rep["arrays"] >= 1
    assert any(r["nbytes"] == 4096 for r in rep["top"])
    assert set(rep["top"][0]) >= set(ref["top"][0]) - {"tenant"}
    del x, y


# -- spill / restore ---------------------------------------------------------


def test_spill_restore_round_trip_with_transfer_counters():
    fuser.flush()
    data = np.random.RandomState(1).rand(64, 64).astype(np.float32)
    x = rt.fromarray(data)
    rt.sync()
    d2h0 = registry.comm["device_to_host_bytes"]
    h2d0 = registry.comm["host_to_device_bytes"]
    restores0 = memory.ledger.restores
    ev0 = registry.get("memory.evictions")
    freed = memory.ledger.evict_until(memory.ledger.live_bytes or 1)
    assert freed >= data.nbytes
    assert isinstance(x._expr.value, spill.SpilledArray)
    assert memory.ledger.spilled_bytes >= data.nbytes
    assert registry.comm["device_to_host_bytes"] - d2h0 >= data.nbytes
    assert registry.get("memory.evictions") > ev0
    # touch restores transparently, bit for bit
    out = np.asarray(x)
    np.testing.assert_array_equal(out, data)
    assert isinstance(x._expr.value, torch.Tensor)
    assert memory.ledger.restores == restores0 + 1
    assert registry.get("memory.restores") >= 1
    assert registry.comm["host_to_device_bytes"] - h2d0 >= data.nbytes
    del x


def test_spilled_leaf_computes_correctly():
    # a chain whose leaf is spilled flushes correctly: the flush restores
    # the leaf before it runs; the same program in ramba_tpu
    fuser.flush()
    data = np.arange(2048, dtype=np.float32)
    outs = []
    for pkg, mem, fl, sp in ((rt, memory, fuser, spill.SpilledArray),
                             (rtj, rmemory, rfuser, None)):
        fl.flush()
        x = pkg.fromarray(data)
        pkg.sync()
        mem.ledger.evict_until(mem.ledger.live_bytes or 1)
        if sp is not None:
            assert isinstance(x._expr.value, sp)
        outs.append(float(pkg.sum(x * 2.0 + 1.0)))
        del x
    assert outs[0] == outs[1] == float(np.sum(data.astype(np.float64)
                                              * 2.0 + 1.0))


def test_views_of_one_storage_count_once_and_stay_resident():
    # two arrays over one storage (fromarray adopts a tensor): the ledger
    # counts the storage once, and does not spill it (spilling one view
    # would free nothing)
    fuser.flush()
    memory.ledger.evict_until(memory.ledger.live_bytes or 0)
    before = memory.ledger.live_bytes
    t = torch.arange(64, dtype=torch.float64)
    x = rt.fromarray(t)
    y = rt.fromarray(t[8:16])
    del t
    assert memory.ledger.live_bytes - before == 64 * 8
    assert memory.ledger.evict_until(1) == 0
    assert isinstance(y._expr.value, torch.Tensor)
    del x
    assert memory.ledger.live_bytes - before == 64 * 8  # y still owns it
    del y
    assert memory.ledger.live_bytes == before


def test_budget_unset_is_transparent():
    # no budget: the governor never spills, restores or copies; the only
    # host traffic is the scalar read itself
    fuser.flush()
    ev0 = registry.get("memory.evictions")
    rs0 = registry.get("memory.restores")
    h2d0 = registry.comm["host_to_device_bytes"]
    d2h0 = registry.comm["device_to_host_bytes"]
    got = float(rt.sum(rt.arange(2048) * 3.0 + 1.0))
    assert got == float(np.sum(np.arange(2048) * 3.0 + 1.0))
    assert registry.get("memory.evictions") == ev0
    assert registry.get("memory.restores") == rs0
    assert registry.comm["host_to_device_bytes"] == h2d0
    assert registry.comm["device_to_host_bytes"] == d2h0


def test_budget_spills_the_coldest_to_place_a_new_array(monkeypatch):
    fuser.flush()
    memory.ledger.evict_until(memory.ledger.live_bytes or 0)
    cold_np = np.random.RandomState(2).rand(256, 256)  # 512 KiB
    cold = rt.fromarray(cold_np)
    rt.sync()
    monkeypatch.setenv("RAMBA_HBM_BUDGET", "700k")
    ev0 = registry.get("memory.evictions")
    hot = rt.fromarray(np.ones((256, 256)))  # does not fit beside it
    rt.sync()
    assert registry.get("memory.evictions") == ev0 + 1
    assert isinstance(cold._expr.value, spill.SpilledArray)
    assert isinstance(hot._expr.value, torch.Tensor)
    np.testing.assert_array_equal(np.asarray(cold), cold_np)
    del cold, hot


# -- oom-class recovery ------------------------------------------------------


def test_classify_oom_is_distinct():
    assert retry.classify(faults.InjectedResourceExhausted("x", 1)) == "oom"
    assert retry.classify(RuntimeError("RESOURCE_EXHAUSTED: boom")) == "oom"


def test_evict_for_oom_sizes_from_bytes_hint():
    fuser.flush()
    # drain colder residents left by earlier tests, so LRU order below is
    # exactly a then b
    memory.ledger.evict_until(memory.ledger.live_bytes or 0)
    a = rt.fromarray(np.ones((64, 64), np.float32))    # 16 KB, colder
    b = rt.fromarray(np.ones((128, 128), np.float32))  # 64 KB, warmer
    rt.sync()
    exc = faults.InjectedResourceExhausted("oom", 1, nbytes=4096)
    freed = memory.evict_for_oom(exc)
    assert freed >= 4096
    # LRU: the colder array went first; the byte hint stopped it there
    assert isinstance(a._expr.value, spill.SpilledArray)
    assert isinstance(b._expr.value, torch.Tensor)
    del a, b


def test_evict_for_oom_reads_torchs_message():
    exc = RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB "
                       "(GPU 0; 79.11 GiB total capacity)")
    assert memory._oom_need(exc) == 2 << 30


def test_fault_bytes_payload():
    faults.configure("oom:once:bytes=1g")
    with pytest.raises(faults.InjectedResourceExhausted) as ei:
        faults.check("oom")
    assert ei.value.bytes == 1 << 30


def test_admission_and_quotas_name_their_items(monkeypatch):
    # admission landed with A.8: no budget admits the fused rung, a
    # budget the program cannot fit under routes it chunked
    x0 = rt.fromarray(np.ones(1024))
    prog0, vals0 = fuser.prepare_program([((x0 + 1.0) * 2.0)._expr])
    assert memory.admit(prog0, vals0, ()) is False
    monkeypatch.setenv("RAMBA_HBM_BUDGET", "16k")
    assert memory.admit(prog0, vals0, ()) is True
    monkeypatch.delenv("RAMBA_HBM_BUDGET")
    with pytest.raises(NotImplementedError, match="A.10"):
        memory.admit(prog0, vals0, (), tenant="t", quota=1)
    # the estimate is the analytic live-set walk (analyze.rules)
    x = rt.fromarray(np.ones(1024))
    prog, vals = fuser.prepare_program([((x + 1.0) * 2.0)._expr])
    # x, two float scalars, then both instruction results live at once
    assert memory.estimate_program_bytes(prog, vals) == 3 * 8192 + 16
    with pytest.raises(NotImplementedError, match="A.10"):
        memory.ledger.evict_until(1, tenant="t")


# -- admission, oom eviction and the chunked rung (ROADMAP A.8) ----------------
# The counterparts of tests/test_memory.py:166-360: both packages run the
# same program under the same budget (ramba_tpu with its analytic
# estimate), take the same rung and give the same values.


@pytest.fixture
def fast_retries(monkeypatch):
    monkeypatch.setenv("RAMBA_RETRY_BASE_S", "0")
    fuser.flush()
    rtj.sync()
    fuser._compile_cache.clear()
    rfuser._compile_cache.clear()


def _last_span():
    from ramba_tpu_torch.observe import events

    return events.last(1, type="flush")[-1]


def _memory_events(n=200):
    from ramba_tpu_torch.observe import events

    return [e for e in events.last(n) if e.get("type") == "memory"]


def test_tight_budget_evicts_and_routes_chunked(monkeypatch, fast_retries):
    from ramba_tpu import diagnostics as rdiag

    cold_np = np.random.RandomState(2).rand(256, 256).astype(np.float32)
    x_np = np.random.RandomState(3).rand(128, 128).astype(np.float32)
    cold, x = rt.fromarray(cold_np), rt.fromarray(x_np)
    rcold, rx = rtj.fromarray(cold_np), rtj.fromarray(x_np)
    fuser.flush()
    rtj.sync()
    monkeypatch.setenv("RAMBA_HBM_BUDGET", "150k")
    monkeypatch.setenv("RAMBA_HBM_ESTIMATE", "analytic")
    ev0 = registry.get("memory.evictions")
    rej0 = registry.get("memory.admission_rejects")

    def prog(m, a):
        y = a * 2.0 + 1.0
        return m.sum(m.sqrt(y) + y * 0.5)

    got, want = float(prog(rt, x)), float(prog(rtj, rx))
    exp = float(np.sum(np.sqrt(x_np * 2.0 + 1.0) + (x_np * 2.0 + 1.0) * 0.5))
    assert got == pytest.approx(exp, rel=1e-3)
    assert got == pytest.approx(want, rel=1e-5)  # float32 sums, two orders
    span, rspan = _last_span(), rdiag.last_flushes(1)[0]
    for s in (span, rspan):
        assert s.get("degraded") == "chunked", s
        assert s.get("admission") == "chunked"
        assert s.get("mem_peak_est", 0) > 0
        assert s.get("segments", 0) >= 2, s
    assert registry.get("memory.evictions") > ev0
    assert registry.get("memory.admission_rejects") == rej0 + 1
    assert isinstance(cold._expr.value, spill.SpilledArray)
    actions = {e.get("action") for e in _memory_events()}
    assert {"watermark", "spill", "reject"} <= actions, actions
    # the evicted array survives, restored on touch
    np.testing.assert_array_equal(np.asarray(cold), cold_np)
    del x, cold, rx, rcold


def test_a_result_past_the_chunk_target_stays_fused(monkeypatch,
                                                   fast_retries):
    """Over the watermark, but one result alone is larger than the
    chunked rung's bytes a segment: that rung would run one instruction
    a segment and keep the fused rung's live set, so admission keeps the
    fused rung, counted apart (ramba_tpu routes such a flush chunked: a
    kept divergence, ROADMAP C)."""
    x_np = np.random.RandomState(5).rand(16384)  # 128 KiB a result
    x = rt.fromarray(x_np)
    fuser.flush()
    monkeypatch.setenv("RAMBA_HBM_BUDGET", "150k")
    assert memory.chunk_target_bytes() == 64 << 10
    rej0 = registry.get("memory.admission_rejects")
    over0 = registry.get("memory.admission_over")
    got = np.asarray(rt.sqrt(x * 2.0 + 1.0) * 0.5)
    np.testing.assert_allclose(got, np.sqrt(x_np * 2.0 + 1.0) * 0.5,
                               rtol=1e-15)
    span = _last_span()
    assert span.get("admission") == "over" and "degraded" not in span, span
    assert span["mem_peak_est"] > 150 << 10
    assert registry.get("memory.admission_over") == over0 + 1
    assert registry.get("memory.admission_rejects") == rej0
    ev = [e for e in _memory_events() if e.get("action") == "reject"][-1]
    assert ev["route"] == "fused" and ev["largest_bytes"] == 16384 * 8
    del x


def test_admit_event_only_when_traced(monkeypatch, fast_retries, tmp_path):
    from ramba_tpu_torch.observe import events

    monkeypatch.setenv("RAMBA_HBM_BUDGET", "64m")
    float(rt.sum(rt.arange(1024) * 2.0))
    assert not any(e.get("action") == "admit" for e in _memory_events())
    events.configure(str(tmp_path / "t.jsonl"))
    try:
        float(rt.sum(rt.arange(1024) * 3.0))
    finally:
        events.configure(None)
    assert any(e.get("action") == "admit" and e["ok"]
               for e in _memory_events())


def test_roomy_budget_admits_fused(monkeypatch, fast_retries):
    monkeypatch.setenv("RAMBA_HBM_BUDGET", "64m")
    rej0 = registry.get("memory.admission_rejects")
    got = float(rt.sum(rt.arange(1024) * 2.0 + 1.0))
    assert got == float(rtj.sum(rtj.arange(1024) * 2.0 + 1.0))
    span = _last_span()
    assert "degraded" not in span and "admission" not in span
    assert span["stages"]["admit"] >= 0 and span["mem_peak_est"] > 0
    assert registry.get("memory.admission_rejects") == rej0


def test_budget_unset_is_transparent(fast_retries):
    from ramba_tpu_torch.observe.registry import comm

    ev0, rs0 = registry.get("memory.evictions"), registry.get("memory.restores")
    rej0 = registry.get("memory.admission_rejects")
    h2d0 = comm.get("host_to_device_bytes", 0)
    got = float(rt.sum(rt.arange(2048) * 3.0 + 1.0))
    assert got == float(np.sum(np.arange(2048) * 3.0 + 1.0))
    span = _last_span()
    for k in ("degraded", "admission", "mem_peak_est"):
        assert k not in span, span
    # the attribution plane stamps every flush's waterfall, admission's
    # stage included (as ramba_tpu's does): it ran and estimated nothing
    assert set(span["stages"]) <= set(attrib.STAGES), span
    assert registry.get("memory.evictions") == ev0
    assert registry.get("memory.restores") == rs0
    assert registry.get("memory.admission_rejects") == rej0
    assert comm.get("host_to_device_bytes", 0) == h2d0


def test_injected_oom_evicts_then_drops_one_rung(fast_retries):
    from ramba_tpu import diagnostics as rdiag

    cold_np = np.random.RandomState(4).rand(128, 128).astype(np.float32)
    cold = rt.fromarray(cold_np)
    fuser.flush()
    ev0 = registry.get("memory.evictions")
    with faults.active("oom:1"), rfaults.active("oom:1"):
        got = float(rt.sum(rt.arange(1024) * 5.0 + 7.0))
        want = float(rtj.sum(rtj.arange(1024) * 5.0 + 7.0))
    assert got == want == float(np.sum(np.arange(1024) * 5.0 + 7.0))
    assert _last_span().get("degraded") == "split"
    assert rdiag.last_flushes(1)[0].get("degraded") == "split"
    assert registry.get("memory.evictions") > ev0
    assert any(e.get("action") == "oom_evict" for e in _memory_events())
    np.testing.assert_array_equal(np.asarray(cold), cold_np)
    del cold


def test_chunk_bytes_env_drives_segment_count(monkeypatch, fast_retries):
    from ramba_tpu import diagnostics as rdiag

    monkeypatch.setenv("RAMBA_CHUNK_BYTES", "64k")
    n = 8192

    def prog(m):
        c = m.sqrt(m.arange(n) * 2.0 + 1.0) * 0.5
        return float(m.sum(c))

    with faults.active("execute:2:oom", seed=0), \
            rfaults.active("execute:2:oom", seed=0):
        got, want = prog(rt), prog(rtj)
    exp = float(np.sum(np.sqrt(np.arange(n) * 2.0 + 1.0) * 0.5))
    assert got == pytest.approx(exp, rel=1e-12)
    assert got == pytest.approx(want, rel=1e-12)
    span, rspan = _last_span(), rdiag.last_flushes(1)[0]
    # fused failed, split failed, chunked ran byte-bounded segments
    for s in (span, rspan):
        assert s.get("degraded") == "chunked", s
        assert s.get("chunk_bytes") == 64 << 10
    assert span["segments"] == rspan["segments"] >= 2


@pytest.mark.parametrize("budget", ["8k", "40k", "150k"])
def test_chunked_segments_follow_the_budget(monkeypatch, fast_retries,
                                            budget):
    """Admission routes the same flushes chunked in both packages, each
    cut into byte-bounded segments of at most the chunk target (the
    reference's estimate counts its own rewrites' program, so the
    segment counts are not compared)."""
    from ramba_tpu import diagnostics as rdiag

    monkeypatch.setenv("RAMBA_HBM_BUDGET", budget)
    monkeypatch.setenv("RAMBA_HBM_ESTIMATE", "analytic")

    def prog(m):
        a = m.arange(2048) * 0.5
        b = m.sin(a) * m.cos(a) + a
        return np.asarray(m.sqrt(m.abs(b)) + b * 2.0)

    got, want = prog(rt), prog(rtj)
    np.testing.assert_allclose(got, want, rtol=1e-13)
    span, rspan = _last_span(), rdiag.last_flushes(1)[0]
    assert span.get("degraded") == rspan.get("degraded")
    if span.get("degraded") == "chunked":
        assert span["chunk_bytes"] == memory.chunk_target_bytes()
        assert span["segments"] >= 1
