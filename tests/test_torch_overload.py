"""The overload plane (``ramba_tpu_torch/serve/overload.py``) against
ramba_tpu, x64 regime, on the CPU.

The counterparts of every case of ``tests/test_overload.py``: deadlines
(the clock, minting, the watchdog clamp, a queued ticket shed at
dispatch and healing, a fresh one admitted, rung pruning by rolling
p50), CoDel, the brownout ladder and its gates, circuit breakers (the
full cycle, a failed probe, a tenant tripped by flush errors failing
fast), the bounded queue and the submit that unwinds, abandoned tickets
(dropped before dispatch, no write-back after), the shed classes being
fatal to the retry engine, hedging (the gates, a primary win, a hedge
win with the loser cancelled, the winner's error, the bytes with and
without a hedge), the ``serve:admit`` site, the free inactive verdict,
the report and the breaker incident.  The pure parts run on both
packages alike (``BOTH``); a flush through the pipeline runs in the port
on the inputs ramba_tpu gets and is held to its bytes.  The coherent
``serve:shed`` round across 2 and 4 gloo ranks is in
``tests/test_torch_distributed.py``.
"""

import threading
import time

import numpy as np
import pytest

import jax
import ramba_tpu as rtj
from ramba_tpu import serve as jserve
from ramba_tpu.observe import events as jevents
from ramba_tpu.observe import ledger as jledger
from ramba_tpu.observe import registry as jregistry
from ramba_tpu.resilience import elastic as jelastic
from ramba_tpu.resilience import faults as jfaults
from ramba_tpu.resilience import retry as jretry
from ramba_tpu.serve import overload as joverload
from ramba_tpu_torch import common, convert, serve
from ramba_tpu_torch.core import fuser
from ramba_tpu_torch.core.expr import Const
from ramba_tpu_torch.observe import events, ledger, registry, telemetry
from ramba_tpu_torch.resilience import elastic, faults, retry
from ramba_tpu_torch.serve import overload
from ramba_tpu_torch.serve.fairness import RoundRobin
from ramba_tpu_torch.serve.pipeline import CompilePipeline


@pytest.fixture(autouse=True)
def _clean_overload(monkeypatch):
    """Fast retries, clean breakers, brownout and faults in both
    packages, no leaked pipeline worker."""
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    monkeypatch.setenv("RAMBA_RETRY_BASE_S", "0.001")
    for k in ("RAMBA_HEDGE_FACTOR", "RAMBA_DEADLINE_MS",
              "RAMBA_SERVE_QUEUE_DEPTH", "RAMBA_SERVE_SOJOURN_MS"):
        monkeypatch.delenv(k, raising=False)
    faults.configure(None)
    jfaults.configure(None)
    overload.reset()
    joverload.reset()
    yield
    serve.shutdown()
    jserve.shutdown()
    faults.reset()
    jfaults.reset()
    fuser.sync()
    ledger.reconfigure()
    jledger.reconfigure()


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


PORT = (overload, registry, events, ledger, faults, retry, elastic)
REF = (joverload, jregistry, jevents, jledger, jfaults, jretry, jelastic)
BOTH = [pytest.param(PORT, id="port"), pytest.param(REF, id="ramba_tpu")]


def _seeded(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


def _port(x):
    return convert.state_from_reference({"x": x})["x"]


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(got)
    assert np.array_equal(got[ok], want[ok])
    assert np.array_equal(np.signbit(got), np.signbit(want))


def _manual_pipeline(**kw) -> CompilePipeline:
    """A pipeline whose worker never starts: tests dispatch inline."""
    pipe = CompilePipeline(**kw)
    pipe._ensure_worker = lambda: None
    return pipe


def _drive(pipe: CompilePipeline, max_group: int = 8) -> int:
    n = 0
    while True:
        group = pipe.queue.pop_group(
            max_group, fingerprint_of=lambda t: t.work.fingerprint,
            timeout=0)
        if not group:
            return n
        pipe._dispatch_group(group)
        n += 1


# -- deadlines ---------------------------------------------------------------


@pytest.mark.parametrize("pkg", BOTH)
def test_deadline_clock(pkg):
    ov = pkg[0]
    d = ov.Deadline(50.0)
    assert not d.expired()
    assert 0.0 < d.remaining_s() <= 0.05
    late = ov.Deadline(50.0, now=time.monotonic() - 1.0)
    assert late.expired() and late.remaining_s() < 0
    assert late.elapsed_ms() >= 1000.0


@pytest.mark.parametrize("pkg", BOTH)
def test_mint_deadline_opt_in(pkg, monkeypatch):
    ov = pkg[0]
    assert ov.mint_deadline(None) is None
    assert ov.mint_deadline(10.0).budget_ms == 10.0
    monkeypatch.setenv("RAMBA_DEADLINE_MS", "250")
    assert ov.mint_deadline(None).budget_ms == 250.0
    monkeypatch.setenv("RAMBA_DEADLINE_MS", "0")
    assert ov.mint_deadline(None) is None


@pytest.mark.parametrize("pkg", BOTH)
def test_clamp_watchdog(pkg):
    ov = pkg[0]
    d = ov.Deadline(10_000.0)
    assert ov.clamp_watchdog(30.0, d) < 10.0
    assert ov.clamp_watchdog(1.0, d) == 1.0
    assert ov.clamp_watchdog(None, d) <= 10.0
    assert ov.clamp_watchdog(5.0, None) == 5.0
    assert ov.clamp_watchdog(None, None) is None
    expired = ov.Deadline(10.0, now=time.monotonic() - 1.0)
    assert ov.clamp_watchdog(30.0, expired) == pytest.approx(0.001)


def test_expired_deadline_sheds_before_dispatch():
    """A queued flush whose budget expired is shed in O(ms) with a
    classified DeadlineExceededError before anything runs, and the array
    heals on its next read outside the session."""
    pipe = _manual_pipeline()
    x = _seeded((16, 16), 1)
    with serve.Session(tenant="dl", pipeline=pipe, deadline_ms=20) as s:
        a = _port(x) * 3.0
        ticket = s.flush()
        assert ticket.deadline is not None
        assert ticket.work.span["deadline_ms"] == 20.0
        time.sleep(0.05)  # budget spent while queued
        t0 = time.perf_counter()
        _drive(pipe)
        shed_wall = time.perf_counter() - t0
        with pytest.raises(overload.DeadlineExceededError) as ei:
            ticket.wait(5)
        assert ei.value.shed_classification == "deadline"
        assert ei.value.stage == "dispatch"
        assert shed_wall < 0.25
        assert registry.get("serve.shed.deadline") >= 1
        assert any(e["reason"] == "deadline"
                   for e in events.last(5, type="shed"))
        assert not isinstance(a._expr, Const)
        assert s.stream.stats["quarantined"] == 0  # a shed, not a failure
    _same(a.asarray(), np.asarray(rtj.fromarray(x) * 3.0))


def test_fresh_deadline_admits():
    pipe = _manual_pipeline()
    x = _seeded((8, 8), 2)
    with serve.Session(tenant="dl2", pipeline=pipe, deadline_ms=60_000) as s:
        a = _port(x) + 1.0
        ticket = s.flush()
        _drive(pipe)
        assert ticket.wait(5) == []
        _same(a.asarray(), np.asarray(rtj.fromarray(x) + 1.0))


@pytest.mark.parametrize("pkg", BOTH)
def test_deadline_rung_pruning_and_exhaustion(pkg):
    ov, reg, _ev, led = pkg[:4]
    led.reconfigure(min_samples=3)
    for _ in range(4):
        led.observe_flush({"label": "L", "wall_s": 10.0})
        led.observe_flush({"label": "L", "degraded": "split",
                           "wall_s": 0.001})
    assert led.rung_quantile("L", "fused", 0.5) == 10.0
    assert led.rung_quantile("L", "split", 0.5) == 0.001
    assert led.rung_quantile("L", "chunked", 0.5) is None
    d = ov.Deadline(100.0)
    rungs = [("fused", lambda: 1), ("split", lambda: 2),
             ("chunked", lambda: 3)]
    kept = ov.prune_rungs(rungs, d, "L")
    assert [n for n, _ in kept] == ["split", "chunked"]
    assert reg.get("serve.deadline_rung_skips") >= 1
    with pytest.raises(ov.DeadlineExceededError) as ei:
        ov.prune_rungs([("fused", lambda: 1)], d, "L")
    assert ei.value.stage == "ladder"
    assert ov.prune_rungs(rungs, None, "L") is rungs


def test_a_deadline_drops_the_slow_rung_of_a_real_flush(monkeypatch):
    """The ladder of a deadlined session flush skips a rung whose rolling
    p50 is over the remaining budget and runs the next (the bytes are
    the fused rung's)."""
    ledger.reset()  # the label's walls from earlier tests of this process
    ledger.reconfigure(min_samples=3)
    x = _seeded(64, 3)
    want = np.asarray(rtj.fromarray(x) * 2.0 + 1.0)
    with serve.Session(tenant="prune") as s:
        a = _port(x) * 2.0 + 1.0
        s.flush(wait=True)
    label = [f for f in events.last(5, type="flush")
             if f.get("tenant") == "prune"][-1]["label"]
    for _ in range(4):
        ledger.observe_flush({"label": label, "wall_s": 100.0})
    skips = registry.get("serve.deadline_rung_skips")
    with serve.Session(tenant="prune", deadline_ms=60_000) as s:
        b = _port(x) * 2.0 + 1.0
        s.flush(wait=True)
    assert registry.get("serve.deadline_rung_skips") == skips + 1
    span = [f for f in events.last(5, type="flush")
            if f.get("tenant") == "prune"][-1]
    assert span["degraded"] == "split" and span["deadline_ms"] == 60_000
    _same(a.asarray(), want)
    _same(b.asarray(), want)


# -- CoDel sojourn control ---------------------------------------------------


@pytest.mark.parametrize("pkg", BOTH)
def test_codel_tolerates_spikes_drops_standing_queue(pkg):
    c = pkg[0]._CoDel()
    t = 100.0
    assert not c.should_drop(0.01, target_s=0.05, interval_s=0.2, now=t)
    assert not c.should_drop(0.06, target_s=0.05, interval_s=0.2, now=t)
    assert not c.should_drop(0.07, target_s=0.05, interval_s=0.2,
                             now=t + 0.1)
    assert not c.should_drop(0.01, target_s=0.05, interval_s=0.2,
                             now=t + 0.15)
    assert not c.should_drop(0.08, target_s=0.05, interval_s=0.2,
                             now=t + 0.2)
    assert c.should_drop(0.08, target_s=0.05, interval_s=0.2, now=t + 0.45)
    assert c.drops == 1


@pytest.mark.parametrize("pkg", BOTH)
def test_sojourn_shed_via_dispatch_verdict(pkg, monkeypatch):
    ov, reg = pkg[:2]
    monkeypatch.setenv("RAMBA_SERVE_SOJOURN_MS", "5")
    monkeypatch.setenv("RAMBA_SERVE_SOJOURN_INTERVAL_MS", "1")
    old = time.perf_counter() - 1.0
    ov.dispatch_verdict(deadline=None, enqueued_at=old, tenant="sj",
                        priority=False, label="L")
    time.sleep(0.005)
    with pytest.raises(ov.ShedError) as ei:
        ov.dispatch_verdict(deadline=None, enqueued_at=old, tenant="sj",
                            priority=False, label="L")
    assert ei.value.reason == "sojourn"
    assert reg.get("serve.shed.sojourn") >= 1


# -- brownout state machine --------------------------------------------------


@pytest.mark.parametrize("pkg", BOTH)
def test_brownout_transitions_and_events(pkg):
    ov, _reg, ev = pkg[:3]
    b = ov._Brownout()
    assert b.state == "green"
    assert b.update(queue_ratio=0.6, memory_frac=0.0,
                    breached=False) == "yellow"
    assert b.update(queue_ratio=0.6, memory_frac=0.9,
                    breached=False) == "red"
    assert b.update(queue_ratio=0.96, memory_frac=0.0,
                    breached=False) == "red"
    assert b.update(queue_ratio=0.0, memory_frac=0.0,
                    breached=False) == "green"
    assert b.transitions["green->yellow"] == 1
    assert b.transitions["yellow->red"] == 1
    evs = ev.last(10, type="brownout")
    assert any(e["from"] == "yellow" and e["to"] == "red" for e in evs)


@pytest.mark.parametrize("pkg", BOTH)
def test_brownout_gates_speculative_and_red_sheds(pkg):
    ov = pkg[0]
    assert ov.allow_speculative()
    ov._brownout.update(queue_ratio=0.6, memory_frac=0.0, breached=False)
    assert not ov.allow_speculative()
    cap = ov.queue_depth_cap()
    with pytest.raises(ov.ShedError) as ei:
        ov.admit_submit(tenant="t", priority=False, queue_depth=cap)
    assert ei.value.reason == "brownout"
    assert ov.brownout_state() == "red"
    ov.admit_submit(tenant="t", priority=True, queue_depth=cap)


def test_brownout_reads_the_governors_memory_fraction(monkeypatch):
    """The memory signal is the ledger's live bytes over the watermark:
    a budget the live arrays nearly fill turns the state yellow."""
    from ramba_tpu_torch.resilience import memory

    keep = _port(_seeded(1 << 12, 4)) * 1.0
    keep.asarray()
    live = memory.ledger.live_bytes
    monkeypatch.setenv("RAMBA_HBM_BUDGET", str(int(live / 0.9 / 0.9) + 64))
    assert overload.refresh_brownout(0) == "yellow"
    assert overload.report()["brownout"]["signals"]["memory_frac"] >= 0.85
    monkeypatch.delenv("RAMBA_HBM_BUDGET")
    assert overload.refresh_brownout(0) == "green"
    del keep


def test_warm_work_shed_under_brownout():
    pipe = _manual_pipeline()
    overload._brownout.state = "yellow"
    ran = []
    t = pipe.submit_warm(lambda: ran.append(1), label="warm-test")
    assert t.done and t.wait(1) == []
    assert ran == [] and len(pipe.queue) == 0
    assert registry.get("serve.warm_shed") >= 1


def test_warm_ticket_runs_under_the_warm_compile_source():
    pipe = _manual_pipeline()
    seen = []
    t = pipe.submit_warm(lambda: seen.append(ledger.current_compile_source()),
                         label="warm-src")
    _drive(pipe)
    assert t.wait(5) == [] and seen == ["warm"]
    assert ledger.current_compile_source() == "demand"


# -- circuit breakers --------------------------------------------------------


@pytest.mark.parametrize("pkg", BOTH)
def test_breaker_full_cycle(pkg, monkeypatch):
    ov, _reg, ev = pkg[:3]
    monkeypatch.setenv("RAMBA_BREAKER_THRESHOLD", "3")
    monkeypatch.setenv("RAMBA_BREAKER_COOLDOWN_S", "0.05")
    b = ov.CircuitBreaker("acme")
    b.admit()
    b.record(False)
    b.record(False)
    assert b.state == "closed"
    b.record(False)
    assert b.state == "open" and b.trips == 1
    t0 = time.perf_counter()
    with pytest.raises(ov.CircuitOpenError) as ei:
        b.admit()
    assert (time.perf_counter() - t0) < 0.005
    assert ei.value.shed_classification == "breaker"
    assert ei.value.retry_after_s is not None
    time.sleep(0.06)
    b.admit()
    assert b.state == "half_open"
    with pytest.raises(ov.CircuitOpenError):
        b.admit()
    b.record(True)
    assert b.state == "closed"
    b.record(False)
    assert b.state == "closed"
    evs = ev.last(10, type="breaker")
    assert any(e["action"] == "open" for e in evs)
    assert any(e["action"] == "closed" for e in evs)


@pytest.mark.parametrize("pkg", BOTH)
def test_breaker_probe_failure_reopens(pkg, monkeypatch):
    ov = pkg[0]
    monkeypatch.setenv("RAMBA_BREAKER_THRESHOLD", "1")
    monkeypatch.setenv("RAMBA_BREAKER_COOLDOWN_S", "0.02")
    b = ov.CircuitBreaker("x")
    b.record(False)
    assert b.state == "open"
    time.sleep(0.03)
    b.admit()
    b.record(False)
    assert b.state == "open" and b.trips == 2


def test_breaker_trips_on_flush_errors_and_fails_fast(monkeypatch):
    monkeypatch.setenv("RAMBA_BREAKER_THRESHOLD", "2")
    monkeypatch.setenv("RAMBA_BREAKER_COOLDOWN_S", "30")
    pipe = _manual_pipeline()
    x = _seeded((8, 8), 5)
    with serve.Session(tenant="flaky", pipeline=pipe) as s:
        faults.configure("compile:always:fatal")
        doomed = []
        for _ in range(2):
            fuser._compile_cache.clear()
            doomed.append(_port(x) * 2.0)
            t = s.flush()
            _drive(pipe)
            with pytest.raises(faults.InjectedFault):
                t.wait(5)
        faults.configure(None)
        assert overload.breaker_for("flaky").state == "open"
        a = _port(x) * 5.0
        t0 = time.perf_counter()
        with pytest.raises(overload.CircuitOpenError):
            s.flush()
        assert (time.perf_counter() - t0) < 0.05
        _same(a.asarray(), np.asarray(rtj.fromarray(x) * 5.0))
        assert len(overload.breaker_for("flaky").failures) == 2
        s.close(drain=False)


def test_breaker_recovers_after_its_cooldown(monkeypatch):
    """An ``execute`` fault trips the breaker; after the cooldown the
    half-open probe flush succeeds and closes it."""
    monkeypatch.setenv("RAMBA_BREAKER_THRESHOLD", "1")
    monkeypatch.setenv("RAMBA_BREAKER_COOLDOWN_S", "0.05")
    pipe = _manual_pipeline()
    x = _seeded(32, 6)
    with serve.Session(tenant="heal", pipeline=pipe) as s:
        doomed = _port(x) * 2.0
        faults.configure("execute:always:fatal")
        t = s.flush()
        _drive(pipe)
        with pytest.raises(faults.InjectedFault):
            t.wait(5)
        faults.configure(None)
        assert overload.breaker_for("heal").state == "open"
        time.sleep(0.06)
        a = _port(x) * 3.0
        t = s.flush()  # the probe
        assert overload.breaker_for("heal").state == "half_open"
        _drive(pipe)
        assert t.wait(5) == []
        assert overload.breaker_for("heal").state == "closed"
        _same(a.asarray(), np.asarray(rtj.fromarray(x) * 3.0))
        s.close(drain=False)


# -- bounded fairness queue --------------------------------------------------


@pytest.mark.parametrize("pkg", BOTH)
def test_queue_depth_cap_rejects_with_classified_error(pkg):
    ov, reg, ev = pkg[:3]
    rr = RoundRobin if ov is overload else \
        __import__("ramba_tpu.serve.fairness", fromlist=["x"]).RoundRobin
    q = rr(depth_cap=2)
    q.push("a", 1)
    q.push("a", 2)
    before = reg.get("serve.shed.queue_full")
    with pytest.raises(ov.QueueFullError) as ei:
        q.push("a", 3)
    assert ei.value.tenant == "a" and ei.value.cap == 2
    assert reg.get("serve.shed.queue_full") == before + 1
    assert any(e["reason"] == "queue_full" for e in ev.last(5, type="shed"))
    q.push("b", 1)
    assert q.pop_group(1, timeout=0) == [1]
    q.push("a", 3)
    assert q.depth("a") == 2


def test_queue_depth_env_default(monkeypatch):
    monkeypatch.setenv("RAMBA_SERVE_QUEUE_DEPTH", "1")
    q = RoundRobin()
    q.push("a", 1)
    with pytest.raises(overload.QueueFullError):
        q.push("a", 2)
    monkeypatch.setenv("RAMBA_SERVE_QUEUE_DEPTH", "0")
    for i in range(100):
        q.push("a", i)


def test_submit_unwinds_on_queue_full(monkeypatch):
    monkeypatch.setenv("RAMBA_SERVE_QUEUE_DEPTH", "1")
    pipe = _manual_pipeline()
    x = _seeded((8, 8), 7)
    with serve.Session(tenant="qf", pipeline=pipe, priority=True) as s:
        a = _port(x) * 2.0
        t1 = s.flush()
        b = _port(x) * 7.0
        with pytest.raises(overload.QueueFullError):
            s.flush()
        assert len(s.stream.inflight) == 1
        _drive(pipe)
        assert t1.wait(5) == []
        _same(a.asarray(), np.asarray(rtj.fromarray(x) * 2.0))
        _same(b.asarray(), np.asarray(rtj.fromarray(x) * 7.0))


def test_a_burst_past_the_depth_sheds_non_priority_at_submit(monkeypatch):
    """A backlog at the cap reads as red: a non-priority burst sheds at
    submit (brownout) before a push could fail, and nothing detached is
    lost."""
    monkeypatch.setenv("RAMBA_SERVE_QUEUE_DEPTH", "4")
    pipe = _manual_pipeline()
    x = _seeded(16, 8)
    shed = 0
    arrs = []
    with serve.Session(tenant="burst", pipeline=pipe) as s:
        for i in range(12):
            arrs.append(_port(x) + float(i))
            try:
                s.flush()
            except overload.OverloadError:
                shed += 1
        assert shed >= 1 and overload.brownout_state() in ("yellow", "red")
        _drive(pipe)
        for i, a in enumerate(arrs):
            _same(a.asarray(), x + float(i))
        s.close(drain=False)


# -- ticket abandonment ------------------------------------------------------


def test_abandoned_ticket_discarded_not_written_back():
    pipe = _manual_pipeline()
    x = _seeded((8, 8), 9)
    with serve.Session(tenant="ab", pipeline=pipe) as s:
        a = _port(x) * 4.0
        ticket = s.flush()
        with pytest.raises(TimeoutError) as ei:
            ticket.wait(0.01)
        assert isinstance(ei.value, overload.TicketAbandoned)
        assert ticket.abandoned and not ticket.done
        before = registry.get("serve.abandoned_drop")
        _drive(pipe)
        assert registry.get("serve.abandoned_drop") == before + 1
        with pytest.raises(overload.TicketAbandoned):
            ticket.wait(5)
        assert any(e["reason"] == "abandoned"
                   for e in events.last(5, type="shed"))
        assert not isinstance(a._expr, Const)
        _same(a.asarray(), np.asarray(rtj.fromarray(x) * 4.0))
        s.close(drain=False)


def test_late_completion_skips_write_back():
    pipe = _manual_pipeline()
    x = _seeded((8, 8), 10)
    with serve.Session(tenant="late", pipeline=pipe) as s:
        a = _port(x) * 9.0
        ticket = s.flush()
        work = ticket.work
        work.is_abandoned = lambda: True
        result = fuser._flush_dispatch(work)
        assert registry.get("serve.abandoned_late") >= 1
        assert not isinstance(a._expr, Const)
        ticket._resolve(result)
        _same(a.asarray(), np.asarray(rtj.fromarray(x) * 9.0))
        s.close(drain=False)


# -- shed classification -----------------------------------------------------


@pytest.mark.parametrize("pkg", BOTH)
def test_sheds_classify_fatal_never_retryable(pkg):
    ov, rty = pkg[0], pkg[5]
    assert rty.classify(TimeoutError("bare")) == "retryable"
    for exc in (
        ov.DeadlineExceededError("d"),
        ov.QueueFullError("t", 5, 5),
        ov.ShedError("brownout"),
        ov.CircuitOpenError("t", "open"),
        ov.TicketAbandoned("gone"),
        ov.OverloadError("generic"),
    ):
        assert rty.classify(exc) == "fatal", type(exc).__name__


# -- hedged dispatch ---------------------------------------------------------


class _P:
    instrs = [("map", ("multiply",), (0, 1))]
    n_leaves = 2
    out_slots = (2,)


class _Host:
    instrs = [("apply", "<function f at 0x7f>", (0,))]
    n_leaves = 1
    out_slots = (1,)


@pytest.mark.parametrize("pkg", BOTH)
def test_hedge_threshold_gates(pkg, monkeypatch):
    ov, led = pkg[0], pkg[3]
    monkeypatch.delenv("RAMBA_HEDGE_FACTOR", raising=False)
    assert ov.hedge_threshold("L", _P(), ()) is None
    monkeypatch.setenv("RAMBA_HEDGE_FACTOR", "2.0")
    led.reconfigure(min_samples=3)
    for _ in range(4):
        led.observe_flush({"label": "HL", "wall_s": 0.1})
    assert ov.hedge_threshold("HL", _P(), ()) == pytest.approx(0.2)
    assert ov.hedge_threshold("nohist", _P(), ()) is None
    assert ov.hedge_threshold("HL", _Host(), ()) is None
    assert ov.hedge_threshold("HL", _P(), (0,)) is None


def test_hedge_is_gated_on_a_reproducible_lowering(monkeypatch):
    """A program whose generic lowering uses atomics (a segment
    reduction) is not hedged unless the hand kernels take it."""

    class _Seg:
        instrs = [("segment_reduce", ("sum", 0, 4), (0, 1))]
        n_leaves = 2
        out_slots = (2,)

    monkeypatch.setenv("RAMBA_HEDGE_FACTOR", "2.0")
    ledger.reconfigure(min_samples=3)
    for _ in range(4):
        ledger.observe_flush({"label": "SL", "wall_s": 0.1})
    assert overload.deterministic(_P())
    assert not overload.deterministic(_Seg())
    i0 = registry.get("serve.hedge.ineligible")
    assert overload.hedge_threshold("SL", _Seg(), ()) is None
    assert registry.get("serve.hedge.ineligible") == i0 + 1


@pytest.mark.parametrize("pkg", BOTH)
def test_run_hedged_primary_wins_no_hedge(pkg):
    ov, reg = pkg[:2]
    f0 = reg.get("serve.hedge.fired")
    out = ov.run_hedged(lambda sp: ("ok", "fused"), 5.0,
                        span={"calls": []}, label="L")
    assert out == ("ok", "fused")
    assert reg.get("serve.hedge.fired") == f0


@pytest.mark.parametrize("pkg", BOTH)
def test_run_hedged_hedge_wins_and_loser_cancelled(pkg):
    ov, reg, ev, el = pkg[0], pkg[1], pkg[2], pkg[6]
    release = threading.Event()
    primary_cancelled = threading.Event()
    calls = []
    f0, w0 = reg.get("serve.hedge.fired"), reg.get("serve.hedge.won_hedge")

    def execute(sp):
        calls.append(1)
        if len(calls) == 1:
            release.wait(10)
            if el.cancelled():
                primary_cancelled.set()
                raise RuntimeError("cancelled loser")
            return ("primary", "fused")
        return ("hedge", "fused")

    out = ov.run_hedged(execute, 0.02, span={"calls": []}, label="L")
    assert out == ("hedge", "fused")
    assert reg.get("serve.hedge.fired") == f0 + 1
    assert reg.get("serve.hedge.won_hedge") == w0 + 1
    release.set()
    assert primary_cancelled.wait(5)
    evs = ev.last(10, type="hedge")
    assert any(e["action"] == "fired" for e in evs)
    assert any(e.get("winner") == "hedge" for e in evs)


@pytest.mark.parametrize("pkg", BOTH)
def test_run_hedged_propagates_winner_error(pkg):
    ov = pkg[0]

    def execute(sp):
        raise ValueError("boom")

    with pytest.raises(ValueError, match="boom"):
        ov.run_hedged(execute, 5.0, span={"calls": []}, label="L")


def test_hedge_byte_identity_on_vs_off(monkeypatch):
    """A seeded ``serve:hedge`` delay makes the primary slow, the hedge
    fires and wins, and its bytes are the unhedged run's (and NumPy's)."""
    pipe = _manual_pipeline()
    x = _seeded((16, 16), 11)

    def run_once(tenant):
        with serve.Session(tenant=tenant, pipeline=pipe) as s:
            a = (_port(x) * 3.0) + 1.0
            t = s.flush()
            _drive(pipe)
            t.wait(10)
            return np.array(a.asarray())

    ledger.reset()  # the label's walls from earlier tests of this process
    ledger.reconfigure(min_samples=3)
    baseline = run_once("h0")
    # NumPy's bytes (XLA contracts ramba_tpu's x * 3 + 1 into one FMA)
    _same(baseline, x * 3.0 + 1.0)
    for i in range(4):
        _same(run_once(f"warm{i}"), baseline)
    monkeypatch.setenv("RAMBA_HEDGE_FACTOR", "0.5")
    faults.configure("serve:hedge:delay:ms=150")
    fired_before = registry.get("serve.hedge.fired")
    hedged = run_once("hedged")
    faults.configure(None)
    assert registry.get("serve.hedge.fired") == fired_before + 1
    assert registry.get("serve.hedge.won_hedge") >= 1
    _same(hedged, baseline)
    assert elastic.wait_abandoned(10)


# -- fault sites -------------------------------------------------------------


@pytest.mark.parametrize("pkg", BOTH)
def test_serve_admit_fault_becomes_shed(pkg):
    ov, reg, _ev, _led, flt = pkg[:5]
    flt.configure("serve:admit:2")
    with pytest.raises(ov.ShedError) as ei:
        ov.dispatch_verdict(deadline=None, enqueued_at=None, tenant="f",
                            priority=False, label="L")
    assert ei.value.reason == "fault"
    with pytest.raises(ov.ShedError):
        ov.dispatch_verdict(deadline=None, enqueued_at=None, tenant="f",
                            priority=False, label="L")
    ov.dispatch_verdict(deadline=None, enqueued_at=None, tenant="f",
                        priority=False, label="L")
    assert reg.get("serve.shed.fault") >= 2


@pytest.mark.parametrize("pkg", BOTH)
def test_verdict_inactive_is_free(pkg):
    ov, reg = pkg[:2]
    before = reg.get("serve.shed")
    ov.dispatch_verdict(deadline=None, enqueued_at=time.perf_counter(),
                        tenant="idle", priority=False, label="L")
    assert reg.get("serve.shed") == before


# -- observability -----------------------------------------------------------


def test_overload_report_and_diagnostics():
    import io

    from ramba_tpu_torch import diagnostics

    overload._brownout.update(queue_ratio=0.6, memory_frac=0.0,
                              breached=False)
    overload.breaker_for("rep").record(False)
    rep = overload.report()
    assert rep["brownout"]["state"] == "yellow"
    assert rep["breakers"]["rep"]["recent_failures"] == 1
    assert set(rep) == set(joverload.report())
    buf = io.StringIO()
    diagnostics.report(file=buf)
    assert "brownout=yellow" in buf.getvalue()


def test_breaker_trip_is_flight_incident():
    from ramba_tpu.observe import telemetry as jtelemetry

    for tel in (telemetry, jtelemetry):
        assert tel.is_incident({"type": "breaker", "action": "open"})
        assert not tel.is_incident({"type": "breaker", "action": "closed"})
        assert tel.is_incident({"type": "slo_breach"})


def test_health_signals_and_admission_verdict_match_the_reference():
    for ov in (overload, joverload):
        ov.reset()
        ov.breaker_for("h").record(False)
    assert set(overload.health_signals()) == set(joverload.health_signals())
    assert overload.admission_verdict("h") == joverload.admission_verdict("h")
    assert overload.admission_verdict(None) == \
        joverload.admission_verdict(None)


def test_brownout_reads_the_deepest_backlog():
    """The brownout's queue signal is the submitting tenant's own backlog,
    as ramba_tpu's submit reads it: with one tenant's queue at the depth
    cap, another tenant with nothing queued is admitted, while the deep
    tenant's own next plain submit is shed (``brownout``) before its push
    could fail.  Both packages agree, and every array reads right."""
    import os

    os.environ["RAMBA_SERVE_QUEUE_DEPTH"] = "4"
    try:
        states = []
        for pkg, ov, arr, fz in (
                (serve, overload, _port(_seeded(8, 12)), fuser),
                (jserve, joverload, rtj.fromarray(_seeded(8, 12)),
                 __import__("ramba_tpu.core.fuser", fromlist=["x"]))):
            pipe = pkg.CompilePipeline()
            pipe._ensure_worker = lambda: None
            deep = pkg.Session(tenant="deep", pipeline=pipe)
            deep.acquire()
            try:
                keep = []
                for k in range(4):
                    keep.append(arr * float(k))
                    deep.flush()
                assert pipe.queue.depth("deep") == 4
                more = arr - 1.0
                try:
                    deep.flush()
                    own = "admitted"
                except ov.ShedError as e:
                    own = e.reason
            finally:
                deep.release()
            idle = pkg.Session(tenant="idle", pipeline=pipe)
            tok = fz.activate_stream(idle.stream)
            b = arr + 1.0
            try:
                idle.flush()
                other = "admitted"
            except ov.ShedError as e:
                other = e.reason
            finally:
                fz.deactivate_stream(tok)
            states.append((own, other, ov.brownout_state()))
            while True:
                g = pipe.queue.pop_group(1, timeout=0)
                if not g:
                    break
                pipe._dispatch_group(g)
            _same(np.asarray(b), _seeded(8, 12) + 1.0)
            _same(np.asarray(more), _seeded(8, 12) - 1.0)
            for k, a in enumerate(keep):
                _same(np.asarray(a), _seeded(8, 12) * float(k))
            idle.close()
            deep.close()
            pipe.stop()
        assert states == [("brownout", "admitted", "green")] * 2
    finally:
        del os.environ["RAMBA_SERVE_QUEUE_DEPTH"]
