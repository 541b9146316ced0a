"""The port's effect-certified result memo (``core/memo.py``,
``RAMBA_MEMO``) against ramba_tpu's, x64 regime, on the CPU.

The cases of ``tests/test_memo.py``: byte identity of memo on against
memo off (a seeded fuzz, its values also held against ramba_tpu's),
version keying (the same inputs hit; fresh inputs, another scalar or a
new seed miss), the budget's LRU, a spilled entry restoring on a hit,
the ledger owning cached results.  The port's own cases: a torch
tensor is mutable, so an adopted tensor changed in place — directly or
through a view — must miss and give the new value, and a cached result
written in place is never served.  The serving plane's batch CSE and the
shared tier are ROADMAP A.10's: they raise ``NotImplementedError``; the
shadow audit's eviction of a suspect entry is A.8's
(``tests/test_torch_audit.py``).
"""

import numpy as np
import pytest
import torch

import jax
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from ramba_tpu.core import memo as jmemo
from ramba_tpu_torch import common, diagnostics
from ramba_tpu_torch.core import fuser, memo
from ramba_tpu_torch.observe import events, ledger, registry
from ramba_tpu_torch.resilience import faults, integrity, memory, spill


@pytest.fixture(autouse=True)
def _isolate(monkeypatch):
    """The port on the CPU, an armed memo with an empty cache in both
    packages, no faults; the memo env is scoped per test."""
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    torch.set_num_threads(1)
    fuser.flush()
    rtj.sync()
    faults.configure(None)
    monkeypatch.setenv("RAMBA_MEMO", "1")
    for k in ("RAMBA_MEMO_BUDGET", "RAMBA_VERIFY", "RAMBA_PLANCERT",
              "RAMBA_MEMO_SHARED"):
        monkeypatch.delenv(k, raising=False)
    memo.reset()
    jmemo.reset()
    yield
    faults.reset()
    memo.reset()
    jmemo.reset()


def test_off_by_default(monkeypatch):
    monkeypatch.setenv("RAMBA_MEMO", "0")
    a = rt.fromarray(np.arange(16.0))
    np.asarray(a * 2.0)
    np.asarray(a * 2.0)
    snap = memo.cache.snapshot()
    assert snap["entries"] == 0 and snap["hits"] == 0
    assert not snap["enabled"]


def test_repeat_over_same_buffers_hits():
    a = rt.fromarray(np.arange(16.0))
    b = rt.fromarray(np.ones(16))
    first = np.asarray((a + b) * 2.0)
    fp = events.last(1, type="flush")[-1]["fingerprint"]
    row0 = ledger.snapshot()["kernels"][fp]
    h0 = memo.cache.hits
    second = np.asarray((a + b) * 2.0)
    assert memo.cache.hits == h0 + 1
    np.testing.assert_array_equal(first, second)
    span = events.last(1, type="flush")[-1]
    assert span.get("cache") == "memo" and span.get("memo_hit") is True
    assert span.get("compile_s") == 0.0 and span["calls"] == []
    # the ledger counts a memo hit, not an execution
    row = ledger.snapshot()["kernels"][span["fingerprint"]]
    assert span["fingerprint"] == fp
    assert row.get("memo_hits", 0) == row0.get("memo_hits", 0) + 1
    assert row["exec"] == row0["exec"]


def test_fresh_buffers_miss():
    r1 = np.asarray(rt.fromarray(np.arange(16.0)) * 2.0)
    h0 = memo.cache.hits
    r2 = np.asarray(rt.fromarray(np.arange(16.0)) * 2.0)
    assert memo.cache.hits == h0
    np.testing.assert_array_equal(r1, r2)


def test_scalar_is_part_of_the_key():
    a = rt.fromarray(np.arange(16.0))
    np.asarray(a * 2.0)
    h0 = memo.cache.hits
    np.testing.assert_array_equal(np.asarray(a * 3.0), np.arange(16.0) * 3)
    assert memo.cache.hits == h0
    np.testing.assert_array_equal(np.asarray(a * 2.0), np.arange(16.0) * 2)
    assert memo.cache.hits == h0 + 1
    # 0.0 == -0.0, but the products differ in sign
    z = np.asarray(a * 0.0)
    nz = np.asarray(a * -0.0)
    assert not np.signbit(z[1]) and np.signbit(nz[1])


def test_commutative_swap_shares_canonical_hash():
    from ramba_tpu_torch import analyze

    a = rt.fromarray(np.arange(16.0))
    b = rt.fromarray(np.ones(16))
    p1, _l1, _ = fuser._prepare_program([(a + b)._expr])
    p2, _l2, _ = fuser._prepare_program([(b + a)._expr])
    assert analyze.canonicalize(p1).chash == analyze.canonicalize(p2).chash
    np.testing.assert_array_equal(np.asarray(a + b), np.asarray(b + a))


def test_seeded_draw_hits_and_a_new_seed_misses():
    rt.random.seed(0)
    s0 = np.asarray(rt.random.random((8,)) + 0.0)
    h0 = memo.cache.hits
    rt.random.seed(0)
    again = np.asarray(rt.random.random((8,)) + 0.0)
    assert memo.cache.hits == h0 + 1
    np.testing.assert_array_equal(s0, again)
    rt.random.seed(1)
    s1 = np.asarray(rt.random.random((8,)) + 0.0)
    assert memo.cache.hits == h0 + 1
    assert not np.array_equal(s0, s1)


@pytest.mark.parametrize("how", ["tensor", "view"])
def test_in_place_mutation_of_an_adopted_tensor_misses(how):
    t = torch.arange(4096, dtype=torch.float64)
    x = rt.fromarray(t)
    assert x._expr.value is t  # adopted, not copied
    first = float(rt.sum(x * 2.0 + 1.0))
    assert float(rt.sum(x * 2.0 + 1.0)) == first
    h0, m0 = memo.cache.hits, memo.cache.misses
    if how == "tensor":
        t.add_(1)
    else:
        t[:1024].mul_(2)
    got = float(rt.sum(x * 2.0 + 1.0))
    assert memo.cache.hits == h0 and memo.cache.misses == m0 + 1
    assert got == float((t * 2.0 + 1.0).sum()) != first


def test_a_cached_result_written_in_place_is_not_served():
    a = rt.fromarray(np.arange(8.0))
    y = a * 2.0
    val = y._value()
    [entry] = list(memo.cache._entries.values())
    assert entry.consts[0].value is val
    val.add_(100)  # a caller writing into the result's tensor
    again = np.asarray(a * 2.0)
    np.testing.assert_array_equal(again, np.arange(8.0) * 2)
    assert memo.cache.snapshot()["stale_outputs"] == 1


def test_an_exported_host_array_cannot_write_into_a_cached_result():
    # on the CPU the host array would share the cached tensor's memory,
    # and a NumPy write bumps no version counter: it is read-only, as the
    # reference's is, and a copy asked for is the caller's own
    x = rt.fromarray(np.arange(8.0))
    y = x * 2.0 + 1.0
    for a in (np.asarray(y), y.asarray()):
        assert a.flags.writeable == np.asarray(rtj.fromarray(
            np.arange(8.0)) * 2.0 + 1.0).flags.writeable
        with pytest.raises(ValueError):
            a[0] = 99.0
    mine = np.array(y)
    mine[0] = 99.0
    hits = memo.cache.hits
    again = np.asarray(x * 2.0 + 1.0)
    assert memo.cache.hits == hits + 1
    np.testing.assert_array_equal(again, np.arange(8.0) * 2 + 1)


def test_byte_identity_fuzz_memo_on_vs_off(monkeypatch):
    rng = np.random.RandomState(7)
    bases = [rng.rand(8, 8) for _ in range(3)]

    def workload(m, arrs):
        outs = []
        state = np.random.RandomState(42)
        for _ in range(12):
            i, j = state.randint(len(arrs)), state.randint(len(arrs))
            op = state.randint(4)
            if op == 0:
                e = arrs[i] + arrs[j]
            elif op == 1:
                e = arrs[i] * 2.0 - arrs[j]
            elif op == 2:
                e = m.maximum(arrs[i], arrs[j])
            else:
                e = (arrs[i] * arrs[j]).sum()
            outs.append(np.asarray(e))
        return outs

    monkeypatch.setenv("RAMBA_MEMO", "0")
    oracle = workload(rt, [rt.fromarray(b) for b in bases])
    reference = workload(rtj, [rtj.fromarray(b) for b in bases])
    monkeypatch.setenv("RAMBA_MEMO", "1")
    memo.reset()
    arrs = [rt.fromarray(b) for b in bases]
    first = workload(rt, arrs)
    h0 = memo.cache.hits
    second = workload(rt, arrs)  # the same buffers: every flush hits
    assert memo.cache.hits - h0 == 12, memo.cache.snapshot()
    for o, r, f, s in zip(oracle, reference, first, second):
        assert o.tobytes() == f.tobytes() == s.tobytes()
        np.testing.assert_allclose(o, r, rtol=1e-15, atol=0)


def test_lru_eviction_under_budget(monkeypatch):
    monkeypatch.setenv("RAMBA_MEMO_BUDGET", "1k")
    a = rt.fromarray(np.arange(64.0))  # 512 B a result
    for k in range(6):
        np.asarray(a + float(k))
    snap = memo.cache.snapshot()
    assert snap["evictions"] > 0 and snap["bytes"] <= 1024
    np.testing.assert_array_equal(np.asarray(a + 0.0), np.arange(64.0))


def test_a_result_over_the_budget_is_not_retained(monkeypatch):
    monkeypatch.setenv("RAMBA_MEMO_BUDGET", "256")
    a = rt.fromarray(np.arange(64.0))
    np.asarray(a * 2.0)  # 512 B > 256 B
    snap = memo.cache.snapshot()
    assert snap["entries"] == 0 and snap["oversize"] == 1


def test_spilled_cache_entry_restores_on_hit():
    data = np.random.RandomState(3).rand(64, 64)
    a = rt.fromarray(data)
    rt.sync()
    first = np.asarray(a * 2.0 + 1.0)
    assert memo.cache.snapshot()["entries"] == 1
    restores0 = memory.ledger.restores
    pins = memory.ledger.pin_values([a._expr.value])
    try:
        memory.ledger.evict_until(memory.ledger.live_bytes or 1)
    finally:
        memory.ledger.unpin(pins)
    [entry] = list(memo.cache._entries.values())
    assert isinstance(entry.consts[0].value, spill.SpilledArray)
    h0 = memo.cache.hits
    again = np.asarray(a * 2.0 + 1.0)
    assert memo.cache.hits == h0 + 1
    assert memory.ledger.restores > restores0
    assert first.tobytes() == again.tobytes()


def test_cached_buffer_is_ledger_owned():
    a = rt.fromarray(np.arange(32.0))
    np.asarray(a * 5.0)
    [entry] = list(memo.cache._entries.values())
    buf = entry.consts[0].value
    assert memory.ledger.owner_count(buf) >= 1
    memo.cache.clear()
    assert memory.ledger.owner_count(buf) == 0


def test_verify_strict_with_memo_is_clean(monkeypatch):
    monkeypatch.setenv("RAMBA_VERIFY", "strict")
    a = rt.fromarray(np.arange(16.0))
    np.asarray(a * 2.0)
    h0 = memo.cache.hits
    np.asarray(a * 2.0)
    assert memo.cache.hits == h0 + 1


def test_main_path_programs_are_memoizable():
    # the chip's main path: axpy + sum, the hourly groupby, a chain
    x = rt.fromarray(np.random.RandomState(5).rand(4096))
    y = rt.fromarray(np.random.RandomState(6).rand(4096))
    g = x.groupby(0, np.arange(4096) % 24, 24)  # its labels uploaded once
    progs = [lambda: rt.sum(2.5 * x + y),
             lambda: g.max(),
             lambda: rt.sin(x) * rt.cos(x) + 1.0]
    for p in progs:
        first = np.asarray(p())
        h0 = memo.cache.hits
        np.testing.assert_array_equal(np.asarray(p()), first)
        assert memo.cache.hits == h0 + 1


def test_later_items_raise_naming_their_roadmap_items(monkeypatch):
    with pytest.raises(NotImplementedError, match="A.10"):
        memo.batch_cse()
    # A.9's item landed: the diagnostics block is the cache's snapshot
    assert diagnostics.memo_report() == memo.cache.snapshot()
    # A.8's items landed: the chunked and eager rungs run a program, and
    # a suspect plan's memo entry is evicted
    x = rt.fromarray(np.arange(8.0))
    np.asarray(x * 2.0)  # the certified result enters the cache
    program, leaves = fuser._linearize([(x * 2.0)._expr])
    vals = [fuser.leaf_value(leaf) for leaf in leaves]
    plan = memo.plan_for(program, (), leaves, vals)
    assert integrity.evict_plan_blobs(None) is False
    n0 = memo.cache.snapshot()["entries"]
    assert integrity.evict_plan_blobs(plan) is True
    assert memo.cache.snapshot()["entries"] == n0 - 1
    for run in (fuser._run_chunked(program, vals),
                fuser._run_eager(program, vals, None)):
        np.testing.assert_array_equal(run[0].numpy(), np.arange(8.0) * 2)
    monkeypatch.setenv("RAMBA_MEMO_SHARED", "1")
    a = rt.fromarray(np.arange(4.0))
    b = a * 2.0
    with pytest.raises(NotImplementedError, match="A.10"):
        fuser.flush()
    monkeypatch.delenv("RAMBA_MEMO_SHARED")
    np.testing.assert_array_equal(np.asarray(b), np.arange(4.0) * 2)
    assert registry.get("memo.insert") >= 1
