"""The port's kernel cost ledger and slow-flush sentinel
(``ramba_tpu_torch/observe/ledger.py``).

Held against ramba_tpu's ledger where it is the same code: rolling-window
quantiles on the same samples and the mode table, exactly.  The rest is
held to the contract ramba_tpu's tests state (``tests/test_perf_ledger.py``):
fingerprints stable and distinct, compiles kept apart from execution
samples through real flushes, the sync window, the true-LRU compile cache
with its evict counter and event, the sentinel firing once per slow flush
under a ``delay:ms`` fault and silent at a factor <= 0.  The port's own
parts: compile seconds by origin (``nvcc``/``persist``/``memory``) and the
cost record (bytes only, no flops estimated).
"""

import numpy as np
import pytest
import torch

import jax
import ramba_tpu_torch as rt
from ramba_tpu.observe import ledger as jledger
from ramba_tpu_torch import common
from ramba_tpu_torch.core import fuser
from ramba_tpu_torch.observe import attrib, events, ledger, registry
from ramba_tpu_torch.resilience import faults


@pytest.fixture(autouse=True)
def _port_on_cpu():
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    torch.set_num_threads(1)
    rt.sync()
    yield
    ledger.reconfigure()


def _chain(n=512):
    a = rt.arange(n) * 3.0 + 1.0
    return float(rt.sum(a))


SAMPLE_SETS = {
    "ramp100": [float(i) for i in range(1, 101)],
    "window_spill": [1.0, 2.0, 3.0, 4.0, 100.0],
    "random": list(np.random.default_rng(3).exponential(size=97)),
    "ties": [0.5] * 9 + [0.25] * 4,
}


@pytest.mark.parametrize("window", [4, 16, 128])
@pytest.mark.parametrize("name", sorted(SAMPLE_SETS))
def test_rolling_window_matches_ramba_tpu(name, window):
    r, jr = ledger._Rolling(window=window), jledger._Rolling(window=window)
    for v in SAMPLE_SETS[name]:
        r.add(v)
        jr.add(v)
    for q in (0.0, 0.05, 0.5, 0.9, 0.95, 1.0):
        assert r.quantile(q) == jr.quantile(q)
    assert r.summary() == jr.summary()
    assert (r.count, r.total, r.min, r.max) == (jr.count, jr.total, jr.min,
                                                jr.max)


def test_rolling_window_quantile_math():
    r = ledger._Rolling(window=128)
    for i in range(1, 101):
        r.add(float(i))
    assert r.quantile(0.50) == 50.0 and r.quantile(0.95) == 95.0
    r2 = ledger._Rolling(window=4)
    for v in (1.0, 2.0, 3.0, 4.0, 100.0):
        r2.add(v)
    assert r2.count == 5 and r2.quantile(0.5) == 3.0
    assert ledger._Rolling(window=4).quantile(0.5) is None


@pytest.mark.parametrize("raw", ["", "0", "off", "false", "no", "1", "on",
                                 "sync", "SYNC", "yes", "anything"])
def test_mode_table_matches_ramba_tpu(raw):
    assert ledger._parse_mode(raw) == jledger._parse_mode(raw)
    ledger.reconfigure(mode=raw)
    jmode = jledger._parse_mode(raw)
    assert ledger.mode() == jmode
    assert ledger.sync_timing() == (jmode == "sync")
    assert ledger.cost_enabled() == (jmode in ("on", "sync"))


@pytest.mark.parametrize("key", [
    ("a", 1, 2.5, None, True), ((("map", ("add",), (0, 1)),), 2, ("C", "S")),
    {"b": (1, 2), "a": "x"}, (b"raw", -0.0, 10 ** 20)])
def test_fingerprint_serializes_plain_keys_as_ramba_tpu(key):
    assert ledger._token(key) == jledger._token(key)
    try:
        assert ledger.fingerprint(key) == jledger.fingerprint(key)
    except TypeError:  # a dict key: not hashable, serialized each time
        pass


def test_fingerprint_stable_and_distinct():
    x = rt.fromarray(np.arange(8.0))
    p, vals = fuser.prepare_program([(x * 2.0)._expr])
    p2, vals2 = fuser.prepare_program([(x * 2.0)._expr])
    k = fuser._cache_key(p, vals)
    fp = ledger.fingerprint(k)
    assert len(fp) == 12 and fp == ledger.fingerprint(fuser._cache_key(p2, vals2))
    # shapes, dtypes and the compile class are part of the identity
    y = rt.fromarray(np.arange(9.0))
    p3, vals3 = fuser.prepare_program([(y * 2.0)._expr])
    assert ledger.fingerprint(fuser._cache_key(p3, vals3)) != fp
    z = rt.fromarray(np.arange(8.0, dtype=np.float32))
    p4, vals4 = fuser.prepare_program([(z * 2.0)._expr])
    assert ledger.fingerprint(fuser._cache_key(p4, vals4)) != fp
    assert ledger.fingerprint(fuser._cache_key(p, vals, ("pow2", 8))) != fp
    # closures of one qualname fingerprint alike
    kc = (p.key, (lambda v: v,))
    kd = (p.key, (lambda v: v,))
    assert ledger.fingerprint(kc) == ledger.fingerprint(kd)


def test_ledger_accumulates_compile_and_exec():
    ledger.reset()
    fuser._compile_cache.clear()
    assert _chain() == _chain()
    snap = ledger.snapshot()
    fused = [k for k in snap["kernels"].values() if k["rungs"].get("fused")]
    k = max(fused, key=lambda e: e["cache"]["misses"])
    assert k["label"].startswith("prog_")
    assert k["compiles"] == 1 and k["compile_s"] > 0.0
    assert k["exec"]["count"] == 1
    assert k["exec"]["min_s"] <= k["exec"]["p50_s"] <= k["exec"]["max_s"]
    assert k["cache"] == {"hits": 1, "misses": 1, "evicts": 0}
    assert k["bytes_out"] > 0 and k["rungs"]["fused"] == 2
    # the first call's seconds by origin: nothing built, nothing loaded
    assert set(k["compile_s_by_source"]) == {"memory"}
    # a backend's slice holds its compile, and no sample outside a race
    assert k["backends"]["torch"]["compiles"] == 1
    assert k["backends"]["torch"]["exec"]["count"] == 0
    win = list(snap["flushes"].values())[0]
    assert win["count"] >= 2 and win["p50_s"] > 0.0
    t = ledger.totals()
    assert t["compiles"] >= 1 and t["by_source"]["nvcc"] == 0.0


def test_sync_mode_records_a_device_time_window():
    ledger.reconfigure(mode="sync")
    ledger.reset()
    fuser._compile_cache.clear()
    _chain()
    _chain()
    snap = ledger.snapshot()
    assert snap["mode"] == "sync"
    synced = [k for k in snap["kernels"].values() if k.get("sync")]
    assert synced and synced[0]["sync"]["count"] >= 1
    assert synced[0]["sync"]["p50_s"] > 0.0


def test_cost_records_bytes_and_no_estimated_flops():
    """The cost record: bytes, and flops only as a kernel family counts
    them (elemred: one operation per element per map), never estimated
    for the generic lowering; recorded under RAMBA_PERF and whenever the
    attribution fence is on, and not with both off."""
    ledger.reconfigure(mode="on")
    ledger.reset()
    fuser._compile_cache.clear()
    x = rt.fromarray(np.arange(1000.0))
    (x * 2.0 + 1.0).asarray()
    ks = [k for k in ledger.snapshot()["kernels"].values()
          if k.get("bytes_accessed")]
    assert ks and ks[0]["bytes_accessed"] == 8000 + 8000
    assert [k.get("flops") for k in ks] == [2 * 1000.0]
    ledger.reset()
    fuser._compile_cache.clear()
    m = rt.fromarray(np.arange(12.0).reshape(3, 4))
    (m * 2.0 + 1.0).asarray()  # 2-D: the generic lowering, bytes only
    ks = [k for k in ledger.snapshot()["kernels"].values()
          if k.get("bytes_accessed")]
    assert ks and ks[0]["bytes_accessed"] == 96 + 96
    assert all("flops" not in k for k in ks)
    ledger.reconfigure(mode="off")
    attrib.reconfigure(enabled=False)
    try:
        ledger.reset()
        fuser._compile_cache.clear()
        (x * 2.0 + 1.0).asarray()
        assert all("bytes_accessed" not in k
                   for k in ledger.snapshot()["kernels"].values())
    finally:
        attrib.reconfigure()


@pytest.mark.parametrize("origin", ["nvcc", "persist", "memory"])
def test_a_first_call_files_its_seconds_by_origin(monkeypatch, origin):
    """A program's first call counts as one compile whose seconds go to
    the origin ``_build``'s counts show across it: a build, a library
    loaded from disk, or neither (a plan, or the generic lowering)."""
    from ramba_tpu_torch import _build

    ledger.reset()
    fuser._compile_cache.clear()
    real = fuser._lower
    bump = {"nvcc": (1, 0), "persist": (0, 1), "memory": (0, 0)}[origin]

    def lower(program, leaf_vals, backend):
        fn = real(program, leaf_vals, backend)

        def call(*vals):
            monkeypatch.setattr(_build, "nvcc_builds",
                                _build.nvcc_builds + bump[0])
            monkeypatch.setattr(_build, "disk_loads",
                                _build.disk_loads + bump[1])
            return fn(*vals)
        return call

    monkeypatch.setattr(fuser, "_lower", lower)
    x = rt.fromarray(np.arange(100.0))
    np.testing.assert_array_equal((x * 4.0 - 1.0).asarray(),
                                  np.arange(100.0) * 4.0 - 1.0)
    t = ledger.totals()
    assert t["compiles"] == 1
    assert t["by_source"][origin] > 0.0
    assert all(v == 0.0 for k, v in t["by_source"].items() if k != origin)
    (x * 4.0 - 1.0).asarray()  # a cache hit: a sample, no compile
    assert ledger.totals()["compiles"] == 1


def test_backend_slice_takes_the_device_time_when_given():
    ledger.reset()
    ledger.record_execute("fp-b", "prog_b", 1, "fused", 0.5, False,
                          backend="kernel", backend_seconds=0.125)
    st = ledger.backend_stats("fp-b")
    assert st["kernel"]["count"] == 1 and st["kernel"]["p50_s"] == 0.125
    assert ledger.snapshot()["kernels"]["fp-b"]["exec"]["p50_s"] == 0.5


def test_compile_cache_true_lru_with_evict_counter(monkeypatch):
    monkeypatch.setattr(fuser, "_COMPILE_CACHE_MAX", 2)
    saved = dict(fuser._compile_cache)
    fuser._compile_cache.clear()
    try:
        x = rt.fromarray(np.arange(6.0))
        progs = [fuser.prepare_program([e._expr]) for e in
                 (x + 1.0, x * 2.0, x - 3.0)]
        keys = [fuser._cache_key(p, v) + ("kernel",) for p, v in progs]
        before = registry.get("fuser.cache_evict")
        _f, new0, fp0, _b, _v = fuser._get_compiled(*progs[0])
        _f, new1, _fp, _b, _v = fuser._get_compiled(*progs[1])
        _f, hit0, fp0b, _b, _v = fuser._get_compiled(*progs[0])  # refresh
        _f, new2, _fp, _b, _v = fuser._get_compiled(*progs[2])  # evicts 1
        assert new0 and new1 and not hit0 and new2 and fp0b == fp0
        assert keys[0] in fuser._compile_cache
        assert keys[1] not in fuser._compile_cache
        assert keys[2] in fuser._compile_cache
        assert registry.get("fuser.cache_evict") == before + 1
        fp1 = ledger.fingerprint(keys[1][:-1])
        ev = events.last(5, type="cache_evict")
        assert ev and ev[-1]["key"] == fp1 and ev[-1]["capacity"] == 2
        assert ledger.snapshot()["kernels"][fp1]["cache"]["evicts"] >= 1
    finally:
        fuser._compile_cache.clear()
        fuser._compile_cache.update(saved)


def _slow_flushes():
    """Slow flushes so far (a counter: the event ring drops old events)."""
    n = ledger.snapshot()["slow_flushes"]
    assert registry.get("perf.slow_flush") >= n
    return n


def test_slow_flush_sentinel_fires_once_per_offending_flush():
    ledger.reset()
    ledger.reconfigure(min_samples=3, factor=5.0)
    for _ in range(4):  # the rolling baseline
        _chain()
    base, r0 = _slow_flushes(), registry.get("perf.slow_flush")
    with faults.active("execute:delay:ms=150"):
        _chain()
    assert _slow_flushes() == base + 1
    with faults.active("execute:delay:ms=150"):
        _chain()
    assert _slow_flushes() == base + 2
    assert registry.get("perf.slow_flush") == r0 + 2
    ev = events.last(1, type="slow_flush")[-1]
    for k in ("label", "rung", "wall_s", "p50_s", "slowdown", "bytes_in",
              "bytes_out", "compile_s", "execute_s", "cache"):
        assert k in ev, k
    # the incident explainer stamps its verdict (ramba_tpu's contract,
    # tests/test_observer_tax.py): the delay lands before the launch,
    # in the host's dispatch stage
    assert ev["why_stage"] == "dispatch", ev
    assert ev["why_verdict"] == attrib._EXPLAIN_VERDICTS["dispatch"]
    assert ev["why"].endswith(ev["why_verdict"])
    assert ev["label"].startswith("prog_") and ev["rung"] == "fused"
    assert ev["wall_s"] > ev["p50_s"] * 5.0


def test_sentinel_quiet_on_healthy_flushes_and_disabled_by_factor():
    ledger.reset()
    # healthy flushes of one program: no flush is 1000x its own p50
    ledger.reconfigure(min_samples=3, factor=1000.0)
    base = _slow_flushes()
    for _ in range(6):
        _chain()
    assert _slow_flushes() == base
    ledger.reconfigure(min_samples=3, factor=0.0)
    with faults.active("execute:delay:ms=150"):
        _chain()
    assert _slow_flushes() == base


def test_flush_span_carries_what_the_sentinel_reads():
    _chain()
    span = events.last(1, type="flush")[-1]
    for k in ("label", "wall_s", "instrs", "leaf_bytes", "out_bytes",
              "compile_s", "execute_s", "cache", "fingerprint"):
        assert k in span, k
    assert span["cache"] in ("hit", "miss")


def test_reset_and_kernel_keys():
    _chain()
    assert ledger.kernel_keys() == sorted(ledger.kernel_keys())
    assert ledger.kernel_keys()
    ledger.reset()
    assert ledger.kernel_keys() == [] and ledger.snapshot()["flushes"] == {}
