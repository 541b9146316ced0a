"""The fleet's snapshot spool, collector and health model
(``ramba_tpu_torch/observe/fleet.py``) against ramba_tpu's, on the CPU.

Every case of ``tests/test_fleet.py``: publishing (an atomic versioned
document named by replica id, the identity block, a monotone
``publish_seq``, the env-driven start off the flush path); the
collector's edge cases (stale, torn and empty documents classified, never
a crash; another schema_version; healthy -> stale -> dead as a document
ages past ``RAMBA_FLEET_STALE_X``/``_DEAD_X``); degraded from the
published signals; rollups (goodput reconciling with the documents, SLO
histograms merged exactly, dead replicas left out, cache and roofline
comparison); Prometheus federation; and traces stitched across replica
directories by ``scripts/trace_report.py``.

Parity: the same spool documents, made from a seed with NumPy, go through
both packages' ``classify``/``health``/``rollup``/``render``; the
verdicts, rollups and merged histograms are equal exactly (the
exposition too, but for its scrape timestamp).  What the port adds: the
publisher reads host state only, so it adds no flush span and no launch
and needs none of the fuser's locks.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import ramba_tpu_torch as rt
from ramba_tpu.observe import fleet as jfleet
from ramba_tpu_torch import common, diagnostics
from ramba_tpu_torch.core import fuser
from ramba_tpu_torch.observe import events, fleet, registry, slo
from ramba_tpu_torch.ops import elemred

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOW = 1_000_000.0

_ENV = ("RAMBA_FLEET_DIR", "RAMBA_FLEET_INTERVAL_S", "RAMBA_FLEET_STALE_X",
        "RAMBA_FLEET_DEAD_X", "RAMBA_FLEET_ENDPOINT")


@pytest.fixture(autouse=True)
def _clean_fleet(monkeypatch):
    common.set_device("cpu")
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    fleet.reset()
    jfleet.reset()
    yield
    fleet.reset()
    jfleet.reset()


def _doc(tmp_path, replica="h-1-0", age_s=0.0, interval_s=5.0,
         schema_version=None, signals=None, counters=None,
         diagnostics_extra=None, now=NOW):
    """One spool document, as a publisher writes it."""
    host, pid, rank = replica.rsplit("-", 2)
    ident = {"schema_version": diagnostics.SCHEMA_VERSION, "host": host,
             "pid": int(pid), "rank": int(rank), "nprocs": 1,
             "device_kind": "cpu", "start_time_wall": now - 3600.0,
             "start_time_mono": 1.0}
    sig = {"brownout": "green", "open_breakers": [], "breaker_trips": 0,
           "shed_total": 0, "slo_breached": [], "heartbeat_running": False,
           "heartbeat_age_s": None, "heartbeat_interval_s": None}
    sig.update(signals or {})
    diag = {"counters": counters or {}}
    diag.update(diagnostics_extra or {})
    doc = {"schema_version": (diagnostics.SCHEMA_VERSION
                              if schema_version is None else schema_version),
           "identity": ident, "replica": replica, "interval_s": interval_s,
           "published_at": now - age_s, "published_mono": 100.0 - age_s,
           "publish_seq": 7, "signals": sig, "diagnostics": diag}
    with open(os.path.join(tmp_path, f"{replica}.json"), "w") as f:
        json.dump(doc, f)
    return doc


# -- publisher ---------------------------------------------------------------


def test_publish_writes_versioned_identity_document(tmp_path):
    path = fleet.publish(str(tmp_path))
    assert path and os.path.exists(path)
    doc = json.load(open(path))
    assert doc["schema_version"] == diagnostics.SCHEMA_VERSION
    ident = doc["identity"]
    assert ident["pid"] == os.getpid()
    assert doc["replica"] == fleet.replica_id(ident)
    assert os.path.basename(path) == doc["replica"] + ".json"
    assert doc["publish_seq"] >= 1
    assert doc["signals"]["brownout"] in ("green", "yellow", "red")
    assert "counters" in doc["diagnostics"]
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]
    # a document of the port reads healthy through ramba_tpu's collector
    assert jfleet.health(str(tmp_path))["fleet_state"] == "healthy"


def test_publish_seq_monotone_and_single_file(tmp_path):
    p1 = fleet.publish(str(tmp_path))
    s1 = json.load(open(p1))["publish_seq"]
    p2 = fleet.publish(str(tmp_path))
    s2 = json.load(open(p2))["publish_seq"]
    assert p1 == p2, "one replica republishes in place"
    assert s2 == s1 + 1
    assert registry.get("fleet.publishes") >= 2


def test_publish_noop_without_fleet_dir():
    assert fleet.fleet_dir() is None
    assert fleet.publish() is None
    assert not fleet.started()


def test_ensure_started_spins_up_publisher_thread(tmp_path, monkeypatch):
    monkeypatch.setenv("RAMBA_FLEET_DIR", str(tmp_path))
    monkeypatch.setenv("RAMBA_FLEET_INTERVAL_S", "0.05")
    fleet.reset()
    # the flush path starts it: one flush, then documents appear
    float(rt.sum(rt.arange(8) * 2.0))
    assert fleet.started()

    def _docs():
        return [p for p in os.listdir(str(tmp_path)) if p.endswith(".json")]

    deadline = time.time() + 10
    while time.time() < deadline and not _docs():
        time.sleep(0.02)
    assert _docs(), "spool thread publishes without any explicit call"
    fleet.stop()
    assert not fleet.started()


def test_publisher_adds_no_flush_span_no_launch_and_takes_no_fuser_lock(
        tmp_path):
    """The publisher thread reads host state only: with the fuser's locks
    held by this thread, a publish still completes, and many publishes
    add no flush span and no kernel launch."""
    float(rt.sum(rt.arange(16) * 3.0))
    flushes0 = fuser.stats["flushes"]
    spans0 = events.last(0, type="flush")[-1]["seq"]
    launches0 = elemred.launches
    done = threading.Event()
    with fuser._cache_lock, fuser._reg_lock, fuser._stats_lock:
        t = threading.Thread(target=lambda: (fleet.publish(str(tmp_path)),
                                             done.set()))
        t.start()
        assert done.wait(10), "publish waited on a fuser lock"
    p0 = registry.get("fleet.publishes")
    fleet.start(str(tmp_path), 0.01)
    deadline = time.time() + 30
    while time.time() < deadline and registry.get("fleet.publishes") < p0 + 5:
        time.sleep(0.01)
    fleet.stop()
    assert registry.get("fleet.publishes") >= p0 + 5
    assert fuser.stats["flushes"] == flushes0
    assert events.last(0, type="flush")[-1]["seq"] == spans0
    assert elemred.launches == launches0


# -- classification ----------------------------------------------------------


def test_fresh_green_snapshot_is_healthy(tmp_path):
    _doc(str(tmp_path), age_s=0.5)
    h = fleet.health(str(tmp_path), now=NOW)
    row = h["replicas"]["h-1-0"]
    assert row["state"] == fleet.HEALTHY
    assert h["fleet_state"] == fleet.HEALTHY
    assert h["counts"][fleet.HEALTHY] == 1
    assert row["age_s"] == pytest.approx(0.5)


def test_healthy_to_stale_to_dead_as_snapshot_ages(tmp_path):
    _doc(str(tmp_path), interval_s=5.0, age_s=0.0)
    assert fleet.health(str(tmp_path), now=NOW)["fleet_state"] == fleet.HEALTHY
    # 7.5 s == 1.5 x 5 s is not yet stale (strict >); 7.6 s is
    assert fleet.health(str(tmp_path), now=NOW + 7.6)["fleet_state"] \
        == fleet.STALE
    assert fleet.health(str(tmp_path), now=NOW + 10.1)["fleet_state"] \
        == fleet.DEAD
    row = fleet.health(str(tmp_path), now=NOW + 10.1)["replicas"]["h-1-0"]
    assert row["state"] == fleet.DEAD
    assert "2x interval" in row["reason"]


def test_stale_and_dead_factors_from_env(tmp_path, monkeypatch):
    monkeypatch.setenv("RAMBA_FLEET_STALE_X", "3")
    monkeypatch.setenv("RAMBA_FLEET_DEAD_X", "6")
    _doc(str(tmp_path), interval_s=1.0, age_s=2.0)
    assert fleet.health(str(tmp_path), now=NOW)["fleet_state"] == fleet.HEALTHY
    assert fleet.health(str(tmp_path), now=NOW + 2.0)["fleet_state"] \
        == fleet.STALE
    assert fleet.health(str(tmp_path), now=NOW + 5.0)["fleet_state"] \
        == fleet.DEAD


def test_torn_document_classified_stale_never_crashes(tmp_path):
    _doc(str(tmp_path), replica="ok-1-0")
    with open(tmp_path / "torn-2-0.json", "w") as f:
        f.write('{"schema_version": 1, "identity": {"pid": 2, "ho')
    with open(tmp_path / "empty-3-0.json", "w") as f:
        f.write("")
    h = fleet.health(str(tmp_path), now=NOW)
    assert h["replicas"]["ok-1-0"]["state"] == fleet.HEALTHY
    assert h["replicas"]["torn-2-0"]["state"] == fleet.STALE
    assert "Error" in h["replicas"]["torn-2-0"]["reason"]
    assert h["replicas"]["empty-3-0"]["state"] == fleet.STALE
    assert h["fleet_state"] == fleet.STALE
    assert h == jfleet.health(str(tmp_path), now=NOW)


def test_mismatched_schema_version_skipped_as_stale(tmp_path):
    _doc(str(tmp_path), replica="old-1-0",
         schema_version=diagnostics.SCHEMA_VERSION + 1)
    row = fleet.health(str(tmp_path), now=NOW)["replicas"]["old-1-0"]
    assert row["state"] == fleet.STALE
    assert "schema_version" in row["reason"]


def test_degraded_from_signals(tmp_path):
    _doc(str(tmp_path), replica="brown-1-0", signals={"brownout": "red"})
    _doc(str(tmp_path), replica="breaker-2-0",
         signals={"open_breakers": ["acme"]})
    _doc(str(tmp_path), replica="slo-3-0", signals={"slo_breached": ["acme"]})
    _doc(str(tmp_path), replica="wedged-4-0",
         signals={"heartbeat_running": True, "heartbeat_age_s": 9.0,
                  "heartbeat_interval_s": 1.0})
    _doc(str(tmp_path), replica="suspect-5-0",
         signals={"integrity_suspect": True, "integrity_failures": 4})
    h = fleet.health(str(tmp_path), now=NOW)
    states = {r: row["state"] for r, row in h["replicas"].items()}
    assert states == {r: fleet.DEGRADED for r in states}
    assert "brownout red" in h["replicas"]["brown-1-0"]["reason"]
    assert "acme" in h["replicas"]["breaker-2-0"]["reason"]
    assert "SLO" in h["replicas"]["slo-3-0"]["reason"]
    assert "heartbeat" in h["replicas"]["wedged-4-0"]["reason"]
    assert "integrity" in h["replicas"]["suspect-5-0"]["reason"]
    assert h["fleet_state"] == fleet.DEGRADED


def test_empty_or_missing_dir_is_vacuously_healthy(tmp_path):
    h = fleet.health(str(tmp_path / "nope"))
    assert h["replicas"] == {} and h["fleet_state"] == fleet.HEALTHY


# -- rollup ------------------------------------------------------------------


def test_rollup_goodput_reconciles_and_excludes_dead(tmp_path):
    _doc(str(tmp_path), replica="a-1-0",
         counters={"fuser.flushes": 10, "fuser.nodes_flushed": 30,
                   "serve.flushes": 10, "serve.shed": 1})
    _doc(str(tmp_path), replica="b-2-0",
         counters={"fuser.flushes": 7, "fuser.nodes_flushed": 21,
                   "serve.flushes": 7})
    _doc(str(tmp_path), replica="dead-3-0", age_s=60.0,
         counters={"fuser.flushes": 1000})
    roll = fleet.rollup(str(tmp_path), now=NOW)
    assert roll["replicas"] == ["a-1-0", "b-2-0"]
    gp = roll["goodput"]
    assert gp["flushes"] == 17 and gp["nodes_flushed"] == 51
    assert gp["shed_total"] == 1
    assert gp["flushes"] == sum(r["flushes"] for r in gp["replicas"].values())
    assert gp["replicas"]["a-1-0"]["uptime_s"] == pytest.approx(3600.0)


def test_rollup_merges_slo_histograms_exactly(tmp_path):
    h1, h2, ref = slo.Histogram(), slo.Histogram(), slo.Histogram()
    for v in (0.001, 0.004, 0.004, 0.02):
        h1.observe(v)
        ref.observe(v)
    for v in (0.08, 0.3, 1.2):
        h2.observe(v)
        ref.observe(v)
    _doc(str(tmp_path), replica="a-1-0", diagnostics_extra={
        "slo": {"histograms": {"e2e": {"acme": h1.summary()}}}})
    _doc(str(tmp_path), replica="b-2-0", diagnostics_extra={
        "slo": {"histograms": {"e2e": {"acme": h2.summary()}}}})
    merged = fleet.rollup(str(tmp_path), now=NOW)["slo"]["e2e"]["acme"]
    want = ref.summary()
    assert merged["count"] == want["count"] == 7
    for q in ("p50_ms", "p95_ms", "p99_ms"):
        assert merged[q] == pytest.approx(want[q])
    assert merged["sum_s"] == pytest.approx(want["sum_s"])


def test_rollup_cache_and_roofline_comparison(tmp_path):
    _doc(str(tmp_path), replica="warm-1-0",
         counters={"fuser.cache_hit": 9, "fuser.cache_miss": 1},
         diagnostics_extra={"perf": {
             "compile": {"persist": {"hits": 5, "misses": 0}},
             "attribution": {"rooflines": {
                 "fp1": {"label": "prog_a", "bound": "memory",
                         "frac_of_peak": 0.8}}}}})
    _doc(str(tmp_path), replica="cold-2-0",
         counters={"fuser.cache_hit": 1, "fuser.cache_miss": 9},
         diagnostics_extra={"perf": {
             "compile": {"persist": {"hits": 0, "misses": 5}},
             "attribution": {"rooflines": {
                 "fp1": {"label": "prog_a", "bound": "memory",
                         "frac_of_peak": 0.1}}}}})
    roll = fleet.rollup(str(tmp_path), now=NOW)
    assert roll["caches"]["warm-1-0"]["jit_hit_rate"] == pytest.approx(0.9)
    assert roll["caches"]["cold-2-0"]["jit_hit_rate"] == pytest.approx(0.1)
    assert roll["caches"]["warm-1-0"]["aot_hits"] == 5
    worst = roll["rooflines"]
    assert worst[0]["replica"] == "cold-2-0"  # worst first
    assert worst[0]["frac_of_peak"] == pytest.approx(0.1)


# -- Prometheus federation ---------------------------------------------------


def test_render_fleet_exposition_with_replica_labels(tmp_path):
    _doc(str(tmp_path), replica="a-1-0", counters={"fuser.flushes": 4})
    _doc(str(tmp_path), replica="b-2-0", age_s=60.0)
    body = fleet.render(str(tmp_path), now=NOW)
    assert ('ramba_fleet_replica_state{replica="a-1-0",state="healthy"} 1'
            in body)
    assert ('ramba_fleet_replica_state{replica="b-2-0",state="dead"} 1'
            in body)
    assert 'ramba_fleet_replicas{state="healthy"} 1' in body
    assert 'ramba_fleet_replicas{state="dead"} 1' in body
    assert 'ramba_fleet_flushes_total{replica="a-1-0"} 4' in body
    assert "ramba_fleet_goodput_flushes_total 4" in body
    assert 'ramba_process_info{' in body and 'pid="1"' in body


def test_write_textfile_atomic(tmp_path):
    spool = tmp_path / "spool"
    spool.mkdir()
    _doc(str(spool), now=time.time())
    out = tmp_path / "fleet.prom"
    fleet.write_textfile(str(out), str(spool))
    assert "ramba_fleet_replicas" in out.read_text()
    assert not list(tmp_path.glob("*.tmp"))


# -- parity with ramba_tpu on seeded spools ----------------------------------


def _seeded_spool(d, seed):
    """A spool of 2-7 documents drawn from a seed: ages across the
    healthy/stale/dead bands, degraded signals, counters, SLO histograms
    of two tenants, rooflines, torn and other-schema files."""
    r = np.random.RandomState(seed)
    n = int(r.randint(2, 8))
    for i in range(n):
        name = f"h{i}-{100 + i}-{i % 2}"
        iv = float(r.choice([0.5, 1.0, 5.0]))
        age = float(r.choice([0.0, 0.3, 1.6, 2.5])) * iv
        sig = {}
        pick = r.randint(6)
        if pick == 1:
            sig["brownout"] = str(r.choice(["yellow", "red"]))
        elif pick == 2:
            sig["open_breakers"] = ["acme"]
        elif pick == 3:
            sig["slo_breached"] = ["globex"]
        hists = {}
        for tenant in ("acme", "globex"):
            h = slo.Histogram()
            for v in r.lognormal(-5.0, 1.5, size=r.randint(0, 20)):
                h.observe(float(v))
            hists[tenant] = h.summary()
        counters = {k: int(r.randint(0, 1000)) for k in (
            "fuser.flushes", "fuser.nodes_flushed", "serve.flushes",
            "serve.shed", "serve.slo_breach", "fuser.cache_hit",
            "fuser.cache_miss")}
        roofs = {f"fp{j}": {"label": f"prog_{j}", "bound": "bandwidth",
                            "frac_of_peak": round(float(r.rand()), 4)}
                 for j in range(r.randint(0, 4))}
        _doc(d, replica=name, age_s=age, interval_s=iv, signals=sig,
             counters=counters, diagnostics_extra={
                 "slo": {"histograms": {"e2e": hists, "dispatch": hists}},
                 "memo": {"hits": int(r.randint(0, 5)), "misses": 3,
                          "hit_rate": 0.25},
                 "perf": {"compile": {"persist": {
                     "hits": int(r.randint(0, 9)), "misses": 1}},
                     "attribution": {"rooflines": roofs}}})
    if r.rand() < 0.5:
        with open(os.path.join(d, "torn-9-0.json"), "w") as f:
            f.write('{"schema_version": 1, "ident')
    if r.rand() < 0.5:
        _doc(d, replica="new-8-0",
             schema_version=diagnostics.SCHEMA_VERSION + 1)


def _strip_scrape(body):
    return [ln for ln in body.splitlines()
            if not ln.startswith("ramba_fleet_scrape_timestamp_seconds")]


@pytest.mark.parametrize("seed", range(6))
def test_verdicts_rollups_and_exposition_equal_ramba_tpu(tmp_path, seed):
    d = str(tmp_path)
    _seeded_spool(d, seed)
    for entry in fleet.load_spool(d):
        assert fleet.classify(entry, now=NOW) == \
            jfleet.classify(entry, now=NOW)
    assert fleet.health(d, now=NOW) == jfleet.health(d, now=NOW)
    roll, jroll = fleet.rollup(d, now=NOW), jfleet.rollup(d, now=NOW)
    assert roll == jroll  # merged histograms included, exactly
    assert fleet.poll(d, now=NOW) == jfleet.poll(d, now=NOW)
    assert _strip_scrape(fleet.render(d, now=NOW)) == \
        _strip_scrape(jfleet.render(d, now=NOW))


# -- stitched traces ---------------------------------------------------------


def test_trace_stitching_across_replica_dirs_flags_orphans(tmp_path):
    """Two replicas' trace files under one directory: ``--trace`` stitches
    the spans sharing a trace id across the process boundary and flags
    the half whose parent span was never collected.  The first replica's
    events are the port's own (a session's span chain under its
    ``RAMBA_TRACE``)."""
    from ramba_tpu_torch import serve

    (tmp_path / "replica0").mkdir()
    (tmp_path / "replica1").mkdir()
    path0 = str(tmp_path / "replica0" / "trace.jsonl")
    events.configure(path0)
    try:
        with serve.Session(tenant="acme", trace_id="T1") as s:
            a = rt.fromarray(np.arange(64.0)) * 2.0 + 1.0
            s.flush().wait()
        float(rt.sum(a))
        root = s.root_span
    finally:
        events.configure(None)
        serve.shutdown()
    r1 = [
        {"type": "flush", "label": "prog_b", "trace_id": "T1",
         "span_id": "S2", "parent_span": root, "ts": time.time() + 1,
         "seq": 1, "wall_s": 0.02, "cache": "hit"},
        {"type": "degrade", "site": "flush", "action": "rung",
         "from": "fused", "to": "split", "trace_id": "T1",
         "parent_span": "S2", "ts": time.time() + 1.05, "seq": 2},
        {"type": "stall", "site": "flush", "waited_s": 1.0,
         "classification": "wedge", "trace_id": "T1",
         "parent_span": "LOST", "ts": time.time() + 1.2, "seq": 3},
    ]
    with open(tmp_path / "replica1" / "trace.jsonl", "w") as f:
        for e in r1:
            f.write(json.dumps(e) + "\n")
    run = lambda *a: subprocess.run(  # noqa: E731
        [sys.executable, os.path.join(REPO, "scripts", "trace_report.py"),
         *a], capture_output=True, text=True, timeout=60)
    r = run(str(tmp_path), "--trace", "T1")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "2 process(es)" in r.stdout
    assert "replica0/trace" in r.stdout and "replica1/trace" in r.stdout
    assert r.stdout.index("prog_") < r.stdout.index("prog_b")
    assert "fused->split" in r.stdout
    assert "ORPHANED" in r.stdout and "parent_span=LOST" in r.stdout
    m = run(str(tmp_path), "--merge-ranks")
    assert m.returncode == 0, m.stdout + m.stderr
    assert "2 rank(s)" in m.stdout


def test_observe_binds_fleet_as_ramba_tpu_does():
    import ramba_tpu.observe as jobserve
    import ramba_tpu_torch.observe as obs

    assert obs.fleet is fleet
    public = lambda m: {n for n in dir(m)  # noqa: E731
                        if not n.startswith("_")}
    # every name ramba_tpu.observe binds (fleet included), and every
    # public name of its fleet module
    assert public(jobserve) <= public(obs), sorted(public(jobserve)
                                                   - public(obs))
    assert public(jfleet) <= public(fleet), sorted(public(jfleet)
                                                   - public(fleet))
