"""Serving, part one (``ramba_tpu_torch/serve/`` and the fuser's flush
streams) against ramba_tpu, x64 regime, on the CPU.

The counterparts of every case of ``tests/test_serving.py``: the
``RoundRobin`` queue of both packages driven alike (FIFO within a
tenant, rotation, head-only coalescing, the cap, ``close`` waking a
blocked pop); stream isolation, a read chasing the owning stream, the
per-stream threshold and its hook, spans of the default stream without
serving fields; tickets (resolution, the empty flush, an error reaching
the ticket and quarantining, quarantine never crossing tenants),
coalescing, abandoned work healing, the tenant quota routing chunked,
tenant attribution in the reports; the registry, event-ring and ledger
hammers; and the eight-session soak under seeded faults.  Each program
runs through both packages on inputs made from a seed with NumPy and
carried by ``convert.state_from_reference``, and the results are held
equal in values, dtypes, sign bits and NaN positions.

Then what the port adds: a kernel build error on the worker reaching the
ticket unchanged (no shed, no lower rung), the worker carrying the
submitter's device and mesh scopes, a quota eviction touching only its
tenant, ``quiesce`` over several streams, the flush on a mesh of ranks
through the pipeline, and ``serve.__all__`` against ramba_tpu's.
"""

import io
import threading

import numpy as np
import pytest
import torch

import jax
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from ramba_tpu import serve as jserve
from ramba_tpu.core import fuser as jfuser
from ramba_tpu.resilience import faults as jfaults
from ramba_tpu.serve.fairness import RoundRobin as JRoundRobin
from ramba_tpu_torch import _build, common, convert, diagnostics, serve
from ramba_tpu_torch.core import fuser
from ramba_tpu_torch.core.expr import Const
from ramba_tpu_torch.observe import events, ledger, registry
from ramba_tpu_torch.parallel import mesh as pm
from ramba_tpu_torch.resilience import faults, memory
from ramba_tpu_torch.serve.fairness import RoundRobin
from ramba_tpu_torch.serve.pipeline import CompilePipeline

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean_serving(monkeypatch):
    """Fast retries, no leaked faults, no leaked pipeline worker and no
    half-open stream bleeding pending work into the next test, in both
    packages."""
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    monkeypatch.setenv("RAMBA_RETRY_BASE_S", "0.001")
    faults.configure(None)
    jfaults.configure(None)
    yield
    serve.shutdown()
    jserve.shutdown()
    faults.reset()
    jfaults.reset()
    fuser.sync()
    jfuser.sync()


@pytest.fixture(autouse=True)
def _keep_reference_counters():
    """ramba_tpu's counters as they were before the test: its own tests,
    run later in this worker process, read absolute counts (``serve.*``,
    ``serve.tenant.<t>.*``, ``telemetry.flight_dumps``)."""
    from ramba_tpu.observe import registry as _jreg

    with _jreg.lock:
        saved = (dict(_jreg.counters), set(_jreg._gauge_names))
    yield
    with _jreg.lock:
        _jreg.counters.clear()
        _jreg.counters.update(saved[0])
        _jreg._gauge_names.clear()
        _jreg._gauge_names.update(saved[1])


def _seeded(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


def _pair(x):
    """The same NumPy input in both packages: (port array, ramba_tpu
    array)."""
    return convert.state_from_reference({"x": x})["x"], rtj.fromarray(x)


def _same(got, want):
    """Values, dtype, sign bits and NaN positions equal."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.kind in "fc":
        assert np.array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(got)
        assert np.array_equal(got[ok], want[ok])
        assert np.array_equal(np.signbit(got.real), np.signbit(want.real))
    else:
        assert np.array_equal(got, want)


RR = [pytest.param(RoundRobin, id="port"),
      pytest.param(JRoundRobin, id="ramba_tpu")]


# -- RoundRobin --------------------------------------------------------------


@pytest.mark.parametrize("rr", RR)
def test_roundrobin_fifo_within_tenant(rr):
    q = rr()
    for i in range(5):
        q.push("a", ("a", i))
    got = [q.pop_group(1, timeout=0)[0] for _ in range(5)]
    assert got == [("a", i) for i in range(5)]
    assert q.pop_group(1, timeout=0) == []


@pytest.mark.parametrize("rr", RR)
def test_roundrobin_rotates_between_tenants(rr):
    q = rr()
    for i in range(3):
        q.push("a", ("a", i))
    q.push("b", ("b", 0))
    q.push("c", ("c", 0))
    order = [q.pop_group(1, timeout=0)[0] for _ in range(5)]
    assert order == [("a", 0), ("b", 0), ("c", 0), ("a", 1), ("a", 2)]


@pytest.mark.parametrize("rr", RR)
def test_roundrobin_coalesces_matching_heads_only(rr):
    q = rr()
    fp = {("a", 0): "X", ("a", 1): "X", ("a", 2): "Y", ("a", 3): "X",
          ("b", 0): "X"}
    for item in [("a", 0), ("a", 1), ("a", 2), ("a", 3)]:
        q.push("a", item)
    q.push("b", ("b", 0))
    g1 = q.pop_group(8, fingerprint_of=fp.get, timeout=0)
    assert g1 == [("a", 0), ("a", 1), ("b", 0)]
    assert q.pop_group(8, fingerprint_of=fp.get, timeout=0) == [("a", 2)]
    assert q.pop_group(8, fingerprint_of=fp.get, timeout=0) == [("a", 3)]


@pytest.mark.parametrize("rr", RR)
def test_roundrobin_coalesce_cap_and_close(rr):
    q = rr()
    for i in range(6):
        q.push("a", ("a", i))
    g = q.pop_group(4, fingerprint_of=lambda _: "same", timeout=0)
    assert g == [("a", i) for i in range(4)]
    q.close()
    assert q.pop_group(4, fingerprint_of=lambda _: "same") == \
        [("a", 4), ("a", 5)]
    assert q.pop_group(4) == []


@pytest.mark.parametrize("rr", RR)
def test_roundrobin_close_wakes_blocked_pop(rr):
    q = rr()
    out = []
    t = threading.Thread(target=lambda: out.append(q.pop_group(1,
                                                               timeout=30)))
    t.start()
    q.close()
    t.join(timeout=10)
    assert not t.is_alive() and out == [[]]


# -- FlushStream isolation ---------------------------------------------------


def _both_streams(pkg_fuser, name):
    return pkg_fuser.FlushStream(name=name + "1"), \
        pkg_fuser.FlushStream(name=name + "2")


def test_stream_isolation_pending_and_flush():
    x = _seeded(32, 1)
    got = {}
    for tag, f, (arr, _ref) in (("port", fuser, (_pair(x)[0], None)),
                                ("ref", jfuser, (rtj.fromarray(x), None))):
        f.flush()
        s1, s2 = _both_streams(f, "iso")
        with f.stream_scope(s1):
            a = arr * 2.0
        with f.stream_scope(s2):
            b = arr + 7.0

        def _has(stream, v):
            return any(r is v for r in stream.pending_roots())

        assert _has(s1, a) and not _has(s2, a)
        assert _has(s2, b) and not _has(s1, b)
        assert not _has(f.default_stream(), a)
        s1.flush()
        assert type(a._expr).__name__ == "Const"
        assert type(b._expr).__name__ != "Const"
        assert _has(s2, b)
        got[tag] = (np.asarray(a), np.asarray(b))
    for g, w in zip(got["port"], got["ref"]):
        _same(g, w)


def test_materialization_chases_owning_stream():
    x = _seeded(16, 2)
    res = []
    for f, arr in ((fuser, _pair(x)[0]), (jfuser, rtj.fromarray(x))):
        s = f.FlushStream(name="owner")
        with f.stream_scope(s):
            a = arr * 3.0
        res.append(np.asarray(a))  # read outside the stream's scope
        assert s.stats["flushes"] == 1
    _same(*res)


def test_per_stream_threshold_autoflush():
    fuser.flush()
    s = fuser.FlushStream(name="cap", max_pending_ops=4)
    before_default = fuser.default_stream().nodes_since_flush
    x = _seeded(8, 3)
    arr = _pair(x)[0]
    with fuser.stream_scope(s):
        arrs = [arr + float(i) for i in range(6)]
    assert s.stats["flushes"] >= 1  # the cap fired mid-build
    assert fuser.default_stream().nodes_since_flush == before_default
    refs = [rtj.fromarray(x) + float(i) for i in range(6)]
    for a, r in zip(arrs, refs):
        _same(np.asarray(a), np.asarray(r))


def test_threshold_hook_routes_instead_of_flushing():
    fired = []
    s = fuser.FlushStream(name="hook", max_pending_ops=2)
    s.on_threshold = fired.append
    x = _seeded(8, 4)
    arr = _pair(x)[0]
    with fuser.stream_scope(s):
        a = arr * 1.0
        b = arr * 2.0
    assert fired and all(v is s for v in fired)
    assert s.stats["flushes"] == 0  # the hook replaced the sync flush
    _same(np.asarray(b), np.asarray(rtj.fromarray(x) * 2.0))
    _same(np.asarray(a), np.asarray(rtj.fromarray(x) * 1.0))


def test_default_stream_spans_carry_no_serving_fields():
    fuser.flush()
    a = rt.fromarray(_seeded(64, 5)) * 1.5
    np.asarray(a)
    span = diagnostics.last_flushes(1)[0]
    for k in ("stream", "tenant", "trace_id", "deadline_ms", "coalesced",
              "async", "queue_s"):
        assert k not in span, k
    assert "queue_wait" not in span["stages"]


# -- async pipeline ----------------------------------------------------------


def _session_run(pkg, x, tenant, build):
    """``build(arr)`` inside a session of ``pkg`` (port or ramba_tpu),
    flushed through its pipeline: the result as NumPy."""
    arr = _pair(x)[0] if pkg is serve else rtj.fromarray(x)
    with pkg.Session(tenant=tenant) as s:
        a = build(arr)
        t = s.flush()
        assert t.wait(timeout=60) == []
        assert t.done
    assert s.stats["enqueued"] >= 1 and s.stats["flushes"] >= 1
    return np.asarray(a)


def test_session_async_flush_ticket():
    x = _seeded(128, 6)
    _same(_session_run(serve, x, "async1", lambda v: v * 2.0 + 1.0),
          _session_run(jserve, x, "async1", lambda v: v * 2.0 + 1.0))


def test_empty_flush_returns_finished_ticket():
    for pkg in (serve, jserve):
        with pkg.Session(tenant="empty") as s:
            t = s.flush()
            assert t.done and t.wait() == []


def test_ticket_propagates_flush_error_and_quarantines():
    x = _seeded(48, 7)
    res = []
    for pkg, f, fl, arr in ((serve, faults, fuser, _pair(x)[0]),
                            (jserve, jfaults, jfuser, rtj.fromarray(x))):
        fl._compile_cache.clear()
        with pkg.Session(tenant="doomed") as s:
            a = arr * 5.0
            with f.inject("compile", "once", kind="fatal"):
                t = s.flush()
                with pytest.raises(f.InjectedFault):
                    t.wait(timeout=60)
            assert s.stats["quarantined"] >= 1
            res.append(np.asarray(a))  # heals: the fault was one-shot
    _same(*res)


def test_quarantine_never_bleeds_across_tenants():
    x = _seeded(64, 8)
    res = []
    for pkg, f, fl, arr in ((serve, faults, fuser, _pair(x)[0]),
                            (jserve, jfaults, jfuser, rtj.fromarray(x))):
        fl.flush()
        fl._compile_cache.clear()
        pipe = pkg.CompilePipeline()
        bad = pkg.Session(tenant="bleed-bad", pipeline=pipe)
        good = pkg.Session(tenant="bleed-good", pipeline=pipe)
        with good:
            h = arr * 0.5
            with bad:
                b = arr * 9.0
                with f.inject("compile", "once", kind="fatal"):
                    t = bad.flush()
                    with pytest.raises(f.InjectedFault):
                        t.wait(timeout=60)
                assert bad.stream.stats["quarantined"] >= 1
            assert good.stream.stats["quarantined"] == 0
            assert any(v is h for v in good.stream.pending_roots())
            hv = np.asarray(h)
        assert good.stream.stats["quarantined"] == 0
        res.append((hv, np.asarray(b)))
        pipe.stop()
    for g, w in zip(*res):
        _same(g, w)


def test_coalescing_dispatches_matching_fingerprints_together():
    fuser.flush()
    pipe = CompilePipeline(coalesce=8)
    pipe._ensure_worker = lambda: None  # drive the dispatch loop by hand
    before = registry.get("serve.coalesced")
    x = _seeded(64, 9)
    arr = _pair(x)[0]
    with serve.Session(tenant="co", pipeline=pipe) as s:
        arrs, tickets = [], []
        for _ in range(3):
            arrs.append(arr * 2.0)  # identical structure each time
            tickets.append(s.flush())
        group = pipe.queue.pop_group(
            8, fingerprint_of=lambda t: t.work.fingerprint, timeout=0)
        assert len(group) == 3
        pipe._dispatch_group(group)
        for t in tickets:
            assert t.wait(timeout=60) == [] and t.coalesced == 3
            span = t.work.span
            assert span["coalesced"] == 3 and span["async"] is True
            assert "queue_wait" in span["stages"]
        want = np.asarray(rtj.fromarray(x) * 2.0)
        for a in arrs:
            _same(np.asarray(a), want)
    assert registry.get("serve.coalesced") - before == 3
    ev = events.last(5, type="serve_coalesce")
    assert ev and ev[-1]["n"] == 3 and ev[-1]["tenants"] == ["co"]
    pipe.stop()


def test_abandoned_session_work_self_heals():
    x = _seeded(32, 10)
    res = []
    for pkg, fl, arr in ((serve, fuser, _pair(x)[0]),
                         (jserve, jfuser, rtj.fromarray(x))):
        s = pkg.Session(tenant="abandon")
        tok = fl.activate_stream(s.stream)
        try:
            a = arr + 4.0
        finally:
            fl.deactivate_stream(tok)
        s.close(drain=False)  # nothing dispatched; the graph is kept
        res.append(np.asarray(a))
    _same(*res)


# -- tenant quotas & attribution ---------------------------------------------


def test_tenant_quota_routes_over_quota_flush_chunked():
    x = np.arange(16384.0)
    res = []
    for pkg, fl, arr, reg, diag in (
            (serve, fuser, _pair(x)[0], registry, diagnostics),
            (jserve, jfuser, rtj.fromarray(x), None, None)):
        fl.flush()
        before = registry.get("serve.quota_rejects") if reg else 0
        with pkg.Session(tenant="quota-t", quota="16k") as s:
            a = arr * 2.0 + 1.0  # 128 KiB of float64 >> 16 KiB
            s.flush(wait=True)
        res.append(np.asarray(a))
        rep = pkg.tenant_report()
        assert rep["quota-t"]["quota_rejects"] >= 1
        if reg is None:
            continue
        assert registry.get("serve.quota_rejects") - before >= 1
        spans = [f for f in diag.last_flushes(10)
                 if f.get("tenant") == "quota-t"]
        assert spans and spans[-1].get("tenant_admission") == "chunked"
        assert spans[-1].get("degraded") == "chunked"
    _same(*res)


def test_tenant_attribution_in_reports():
    fuser.flush()
    x = _seeded(96, 11)
    arr = _pair(x)[0]
    with serve.Session(tenant="acct") as s:
        a = arr * 3.0
        s.flush(wait=True)
    _same(np.asarray(a), np.asarray(rtj.fromarray(x) * 3.0))
    rep = serve.tenant_report()
    assert rep["acct"]["flushes"] >= 1 and rep["acct"]["nodes"] >= 1
    assert rep["acct"]["executes"] >= 1
    assert rep["acct"]["live_bytes"] >= x.nbytes
    assert set(rep["acct"]) >= {"flushes", "nodes", "quota_rejects",
                                "executes", "live_bytes", "e2e_p50_ms"}
    snap = ledger.snapshot()
    assert any("acct" in (k.get("tenants") or {})
               for k in snap["kernels"].values())
    assert diagnostics.snapshot()["serving"]["acct"]["flushes"] >= 1
    buf = io.StringIO()
    diagnostics.report(file=buf)
    assert "serving (per tenant)" in buf.getvalue()
    assert "acct" in buf.getvalue()


# -- thread-safety hammers ---------------------------------------------------


def _hammer(n_threads, fn):
    errs = []

    def run():
        try:
            fn()
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=run) for _ in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not errs, errs


def test_counter_registry_hammer():
    key = "test.serving.hammer"
    registry.counters.pop(key, None)
    n = 20000
    _hammer(8, lambda: [registry.inc(key) for _ in range(n)])
    assert registry.get(key) == 8 * n
    registry.counters.pop(key, None)


def test_event_ring_hammer():
    n = 2000
    _hammer(8, lambda: [events.emit({"type": "test_hammer"})
                        for _ in range(n)])
    seqs = [e["seq"] for e in events.ring if e.get("type") == "test_hammer"]
    assert len(seqs) == len(set(seqs))
    events.ring.clear()


def test_kernel_ledger_hammer():
    fp = "hammerfp"
    n = 2000
    _hammer(8, lambda: [
        ledger.record_execute(fp, "hammer", 1, "fused", 0.001, False,
                              tenant="ht")
        for _ in range(n)
    ])
    snap = ledger.snapshot()["kernels"].get(fp)
    assert snap is not None
    assert snap["exec"]["count"] == 8 * n
    assert snap["tenants"]["ht"] == 8 * n
    ledger.reset()


# -- the acceptance soak -----------------------------------------------------


_SOAK_SHAPES = [(257,), (64, 3), (31,), (8, 8, 2), (500,), (129,), (16, 17),
                (77,)]


def _soak_build(pkg, i, base):
    """Session ``i``'s workload over ``base`` (a seeded array of its
    shape): a few dependent elementwise programs, bitwise-deterministic
    whatever the flush boundaries."""
    a = base * (i + 1.0)
    b = pkg.sqrt(pkg.abs(a) + 1.0) + i
    c = b * 2.0 - base * 0.25
    d = pkg.abs(c) + b
    return a, d


def _soak_inputs(i):
    return _seeded(_SOAK_SHAPES[i % len(_SOAK_SHAPES)], 100 + i)


def test_threaded_soak_eight_sessions_byte_identical():
    fuser.sync()
    n_sessions = 8
    # the exact bytes each session must get: ramba_tpu, one stream
    expected = {}
    for i in range(n_sessions):
        a, d = _soak_build(rtj, i, rtj.fromarray(_soak_inputs(i)))
        expected[i] = (np.asarray(a), np.asarray(d))
    bases = {i: convert.state_from_reference({"x": _soak_inputs(i)})["x"]
             for i in range(n_sessions)}
    results = {}
    barrier = threading.Barrier(n_sessions)

    def session_worker(i):
        with serve.Session(tenant=f"soak{i % 4}") as s:
            barrier.wait(timeout=60)  # maximize interleaving
            a, d = _soak_build(rt, i, bases[i])
            s.flush()  # async mid-build flush races the builds below
            e = d * 1.0 + 0.0  # more work behind the async flush
            s.flush(wait=True)
            results[i] = (np.asarray(a), np.asarray(d), np.asarray(e),
                          s.stream)

    # seeded deterministic faults: retry absorbs them invisibly
    faults.configure("execute:2,compile:2", seed=7)
    try:
        threads = [threading.Thread(target=session_worker, args=(i,))
                   for i in range(n_sessions)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        faults.configure(None)
    assert len(results) == n_sessions
    for i in range(n_sessions):
        a, d, e, stream = results[i]
        _same(a, expected[i][0])
        _same(d, expected[i][1])
        _same(e, expected[i][1])
        assert stream.stats["quarantined"] == 0, (i, stream.stats)
    rep = serve.tenant_report()
    for t in range(4):
        assert rep[f"soak{t}"]["flushes"] >= 1
        assert rep[f"soak{t}"]["quota_rejects"] == 0


# -- what the port adds ------------------------------------------------------


def test_serve_exports_what_ramba_tpu_serve_exports():
    assert sorted(serve.__all__) == sorted(jserve.__all__)
    for name in serve.__all__:
        assert hasattr(serve, name), name
    assert rt.serve is serve


def test_kernel_build_error_reaches_the_ticket_unchanged(monkeypatch):
    """A build error on the worker is the ticket's error as it is: the
    ladder treats it as fatal, so no lower rung runs and nothing sheds."""
    fuser._compile_cache.clear()
    boom = _build.KernelBuildError("nvcc failed on the worker")

    def lower(program, leaf_vals, backend):
        raise boom

    monkeypatch.setattr(fuser, "_lower", lower)
    shed0, deg0 = registry.get("serve.shed"), registry.get(
        "resilience.degrade_steps")
    seen = []
    events.add_tap(seen.append)
    try:
        with serve.Session(tenant="build") as s:
            a = rt.fromarray(_seeded(32, 12)) * 2.0
            t = s.flush()
            with pytest.raises(_build.KernelBuildError) as ei:
                t.wait(timeout=60)
            assert ei.value is boom
            assert s.stats["quarantined"] == 1
            s.close(drain=False)
    finally:
        events.remove_tap(seen.append)
    assert registry.get("serve.shed") == shed0
    assert registry.get("resilience.degrade_steps") == deg0
    assert not [e for e in seen if e.get("type") in ("degrade", "shed")]
    assert serve.overload.breaker_for("build").snapshot()[
        "recent_failures"] == 1
    monkeypatch.undo()
    _same(np.asarray(a), _seeded(32, 12) * 2.0)  # heals once it builds


def test_worker_carries_the_submitters_device_and_mesh_scopes():
    seen = []
    real = fuser._flush_dispatch

    def spy(work, **kw):
        seen.append((threading.current_thread().name, common.device(),
                     pm.get_mesh(), fuser.current_tenant()))
        return real(work, **kw)

    fuser._flush_dispatch = spy
    try:
        with common.device_scope(CPU), pm.local_scope() as one:
            with serve.Session(tenant="scoped") as s:
                a = rt.fromarray(_seeded(16, 13)) + 1.0
                s.flush(wait=True)
    finally:
        fuser._flush_dispatch = real
    name, dev, msh, tenant = seen[0]
    assert name == "ramba-serve-dispatch"
    assert dev == CPU and msh is one and tenant == "scoped"
    _same(np.asarray(a), _seeded(16, 13) + 1.0)


def test_quota_eviction_touches_only_its_tenant():
    """A tenant over its quota spills its own cold arrays; another
    tenant's resident bytes do not change, and the result is the one
    the fused rung gives."""
    n = 1 << 12
    with serve.Session(tenant="other") as o:
        keep = rt.fromarray(_seeded(n, 14)) * 1.0
        o.flush(wait=True)
    other0 = memory.ledger.tenant_snapshot()["other"]
    with serve.Session(tenant="tight", quota=4 * n * 8) as s:
        cold = [rt.fromarray(_seeded(n, 15 + k)) * 1.0 for k in range(3)]
        s.flush(wait=True)
        ev0 = memory.ledger.evictions
        y = rt.fromarray(_seeded(n, 20)) * 2.0 + 1.0
        s.flush(wait=True)
    assert memory.ledger.evictions > ev0
    assert memory.ledger.tenant_snapshot()["other"] == other0
    spans = [f for f in diagnostics.last_flushes(5)
             if f.get("tenant") == "tight"]
    assert spans[-1]["tenant_admission"] in ("evicted", "chunked")
    _same(np.asarray(y), _seeded(n, 20) * 2.0 + 1.0)
    for k, c in enumerate(cold):  # the spilled arrays come back
        _same(np.asarray(c), _seeded(n, 15 + k))
    _same(np.asarray(keep), _seeded(n, 14))


def test_quiesce_flushes_every_stream_and_the_pipeline():
    pipe = serve.get_pipeline()
    streams0 = len(fuser.all_streams())
    sessions, arrs = [], []
    for i in range(3):
        s = serve.Session(tenant=f"q{i}")
        tok = fuser.activate_stream(s.stream)
        try:
            arrs.append(rt.fromarray(_seeded(32, 30 + i)) * float(i + 1))
            s.flush()
            arrs.append(arrs[-1] + 1.0)  # still pending on the stream
        finally:
            fuser.deactivate_stream(tok)
        sessions.append(s)
    n = serve.quiesce()
    assert n >= 4 and n >= streams0
    assert len(pipe.queue) == 0
    for s in sessions:
        assert not s.stream.inflight and not s.stream.pending_roots()
    for i in range(3):
        assert isinstance(arrs[2 * i]._expr, Const)
        assert isinstance(arrs[2 * i + 1]._expr, Const)
        _same(np.asarray(arrs[2 * i + 1]),
              _seeded(32, 30 + i) * float(i + 1) + 1.0)
    for s in sessions:
        s.close()


def test_a_read_from_another_thread_chases_the_session():
    x = _seeded(64, 40)
    with serve.Session(tenant="handoff") as s:
        a = rt.fromarray(x) * 4.0
    out = []
    t = threading.Thread(target=lambda: out.append(np.asarray(a)))
    t.start()
    t.join(timeout=60)
    _same(out[0], np.asarray(rtj.fromarray(x) * 4.0))
    assert s.stats["flushes"] >= 1


def test_a_default_flush_reads_each_new_switch_once_and_starts_nothing(
        monkeypatch):
    """The default stream's host cost: a flush outside any session reads
    ``RAMBA_DEADLINE_MS`` and ``RAMBA_HEDGE_FACTOR`` once each (unset),
    no ``RAMBA_SERVE_*`` switch, imports no serve module's state, starts
    no thread and enters no array into the session owner map."""
    import os as _os
    import types

    fuser.flush()
    reads = []

    class _Env:
        def get(self, key, default=None):
            reads.append(key)
            return _os.environ.get(key, default)

    monkeypatch.setattr(fuser, "os", types.SimpleNamespace(environ=_Env()))
    started = []
    orig_start = threading.Thread.start

    def start(self):
        started.append(self.name)
        return orig_start(self)

    monkeypatch.setattr(threading.Thread, "start", start)
    x = rt.fromarray(_seeded(64, 50))
    y = x * 2.0 + 1.0
    assert not fuser._arr_streams
    _same(np.asarray(y), _seeded(64, 50) * 2.0 + 1.0)
    assert reads.count("RAMBA_DEADLINE_MS") == 1
    assert reads.count("RAMBA_HEDGE_FACTOR") == 1
    assert not [k for k in reads if k.startswith("RAMBA_SERVE")]
    assert started == []
    assert serve.current_pipeline() is None
