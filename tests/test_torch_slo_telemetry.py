"""SLO histograms (``observe/slo.py``) and the telemetry plane
(``observe/telemetry.py``) of the port, against ramba_tpu, x64 regime,
on the CPU.

The counterparts of ``tests/test_telemetry.py``'s cases on the planes
the port has: ``Histogram`` buckets, quantiles and summaries equal to
ramba_tpu's on the same samples, ``merge_summaries`` equal on the same
summaries (lists from JSON too); spans routed to the prepare and
dispatch histograms and every flush's wall to e2e; the breach latch
firing once per episode (equal event fields in both packages) and
carrying ``why``; the Prometheus text (typing, tenant labels, buckets,
the rank label on every sample, escaping, the identity series); the
HTTP exporter scraped on 127.0.0.1 during flushes, its ``/healthz``; the
atomic text file and its per-rank name; the trace context stamped onto
events inside a flush's dispatch scope; and the flight recorder: one
dump per incident, a retention cap, off without a directory, the
incident classes.
"""

import glob
import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest

import jax
import ramba_tpu_torch as rt
from ramba_tpu.observe import slo as jslo
from ramba_tpu_torch import common, diagnostics
from ramba_tpu_torch.observe import (attrib, events, ledger, registry, slo,
                                     telemetry)
from ramba_tpu_torch.resilience import faults


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    for k in ("RAMBA_FLIGHT_DIR", "RAMBA_FLIGHT_MAX", "RAMBA_SLO_P95_MS",
              "RAMBA_METRICS_PORT", "RAMBA_METRICS_FILE", "RAMBA_FAULTS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("RAMBA_RETRY_BASE_S", "0.001")
    faults.configure(None)
    for s in (slo, jslo):
        s.reset()
        s.reconfigure(objective_ms=-1)
    yield
    telemetry.reset()
    faults.reset()
    for s in (slo, jslo):
        s.reset()
        s.reconfigure()
    ledger.reconfigure()


SAMPLES = [
    [0.0005, 0.003, 0.003, 0.07, 0.2, 42.0],
    [0.004] * 100,
    [0.0001 * k for k in range(1, 200)],
    [1.0, 2.0, 2.5, 3.0, 9.9, 10.0, 10.5],
    [],
]


@pytest.mark.parametrize("samples", SAMPLES)
def test_histogram_equals_ramba_tpu(samples):
    a, b = slo.Histogram(), jslo.Histogram()
    for v in samples:
        a.observe(v)
        b.observe(v)
    assert a.cumulative() == b.cumulative()
    assert a.summary() == b.summary()
    for q in (0.5, 0.9, 0.95, 0.99):
        assert a.quantile(q) == b.quantile(q)
    counts = [c for _, c in a.cumulative()]
    assert counts == sorted(counts) and counts[-1] == len(samples)


def test_histogram_quantile_interpolation_and_saturation():
    h = slo.Histogram()
    for _ in range(100):
        h.observe(0.004)
    assert 0.0025 <= h.quantile(0.5) <= 0.005
    h2 = slo.Histogram()
    h2.observe(99.0)
    assert h2.quantile(0.99) == slo.BUCKETS_S[-1]
    assert slo.Histogram().quantile(0.5) is None


@pytest.mark.parametrize("json_round_trip", [False, True])
def test_merge_summaries_equals_ramba_tpu(json_round_trip):
    sums = []
    for samples in SAMPLES:
        h = slo.Histogram()
        for v in samples:
            h.observe(v)
        s = h.summary()
        sums.append(json.loads(json.dumps(s)) if json_round_trip else s)
    sums.append(None)
    assert slo.merge_summaries(sums) == jslo.merge_summaries(sums)
    merged = slo.merge_summaries(sums)
    assert merged["count"] == sum(len(s) for s in SAMPLES)


def test_observe_span_routes_prepare_and_dispatch():
    slo.observe_span({"tenant": "t1", "wall_s": 0.03,
                      "stages": {"trace": 0.001, "prepare": 0.001}})
    snap = slo.snapshot()["histograms"]
    assert snap["prepare"]["t1"]["count"] == 1
    assert snap["prepare"]["t1"]["sum_s"] == 0.002
    assert snap["dispatch"]["t1"]["count"] == 1
    assert snap["e2e"] == {}


def test_flushes_feed_the_default_tenant():
    x = rt.fromarray(np.arange(512.0))
    for k in range(3):
        float(rt.sum(x + float(k)))
    h = slo.snapshot()["histograms"]
    for m in ("prepare", "dispatch", "e2e"):
        assert h[m][""]["count"] == 3, (m, h[m])
    assert slo.tenant_latency(None)["e2e_samples"] == 3
    assert slo.tenant_latency("nobody") == {}


def test_slo_breach_latch_equals_ramba_tpu():
    got = []
    for s, reg in ((slo, registry), (jslo, None)):
        s.reconfigure(objective_ms=10.0, min_samples=5)
        breaches = [ev for ev in (s.observe_e2e(0.05, tenant="hot",
                                                trace_id="tr1")
                                  for _ in range(10)) if ev is not None]
        assert len(breaches) == 1, "latched: one event per episode"
        ev = breaches[0]
        got.append({k: ev[k] for k in ("type", "metric", "p95_ms",
                                       "objective_ms", "samples", "tenant",
                                       "trace_id")})
        assert "hot" in s.breached_tenants()
        for _ in range(2000):
            s.observe_e2e(0.0001, tenant="hot")
        assert "hot" not in s.breached_tenants()
        for _ in range(3000):
            ev = s.observe_e2e(5.0, tenant="hot")
            if ev is not None:
                break
        assert ev is not None, "re-armed latch fires on the second episode"
    assert got[0] == got[1]
    assert registry.get("serve.tenant.hot.slo_breach") >= 2


def test_flush_breach_carries_why():
    """A breach tipped by a flush carries a verdict: the explainer's when
    a stage diverges, else the stage with the largest share of the wall
    (the steady state over its objective)."""
    x = rt.fromarray(np.arange(2048.0))
    slo.reconfigure(objective_ms=1e-6, min_samples=5)
    before = len(events.last(0, type="slo_breach"))
    for k in range(6):
        float(rt.sum(x * 2.0 + float(k)))
    evs = events.last(0, type="slo_breach")
    assert len(evs) == before + 1
    ev = evs[-1]
    assert ev["why"] and ev["why_stage"] in attrib.STAGES + ("unattributed",)
    assert ev["why"].endswith(ev["why_verdict"])


# ---------------------------------------------------------------------------
# exporter text
# ---------------------------------------------------------------------------


def test_render_counter_and_gauge_typing():
    registry.inc("probe.typing_hits", 3)
    registry.gauge("probe.typing_level", 1234)
    body = telemetry.render()
    assert "# TYPE ramba_probe_typing_hits_total counter" in body
    assert 'ramba_probe_typing_hits_total{rank="0"} 3' in body
    assert "# TYPE ramba_probe_typing_level gauge" in body
    assert 'ramba_probe_typing_level{rank="0"} 1234' in body


def test_render_tenant_counters_get_labels():
    registry.inc("serve.tenant.acme.flushes", 7)
    assert 'ramba_serve_tenant_flushes_total{rank="0",tenant="acme"} 7' \
        in telemetry.render()


def test_render_histogram_bucket_monotonicity_and_inf():
    for v in (0.0004, 0.002, 0.03, 0.4, 20.0):
        slo.observe("e2e", v, tenant="t")
    body = telemetry.render()
    buckets = []
    for line in body.splitlines():
        if line.startswith("ramba_flush_e2e_seconds_bucket") \
                and 'tenant="t"' in line:
            le = line.split('le="')[1].split('"')[0]
            buckets.append((le, float(line.rsplit(" ", 1)[1])))
    assert buckets and buckets[-1][0] == "+Inf"
    counts = [c for _, c in buckets]
    assert counts == sorted(counts) and counts[-1] == 5
    assert "ramba_flush_e2e_seconds_count" in body
    assert "ramba_flush_e2e_seconds_sum" in body


def test_render_every_sample_has_rank_label():
    float(rt.sum(rt.fromarray(np.arange(64.0)) * 2.0))
    for line in telemetry.render().splitlines():
        if line.startswith("#") or not line.strip():
            continue
        assert 'rank="' in line, f"unlabeled sample: {line}"


def test_render_label_escaping():
    registry.inc('serve.tenant.we"ird.flushes')
    assert 'tenant="we\\"ird"' in telemetry.render()


@pytest.mark.parametrize("family", [
    "ramba_process_info", "ramba_memory_live_bytes",
    "ramba_kernel_exec_total", "ramba_stage_seconds_total",
    "ramba_flushes_attributed_total", "ramba_observer_seconds_total",
    "ramba_heartbeats_total", "ramba_slow_flushes_total",
    "ramba_flush_dispatch_seconds_bucket", "ramba_scrape_timestamp_seconds",
])
def test_render_covers_the_ports_planes(family):
    x = rt.fromarray(np.arange(256.0))
    float(rt.sum(x * 2.0))
    assert family + "{" in telemetry.render()


def test_process_info_identity_series():
    lines = [ln for ln in telemetry.render().splitlines()
             if ln.startswith("ramba_process_info{")]
    assert len(lines) == 1
    line = lines[0]
    assert f'pid="{os.getpid()}"' in line
    assert f'schema_version="{diagnostics.SCHEMA_VERSION}"' in line
    assert 'device_kind="cpu"' in line and line.endswith(" 1")


# ---------------------------------------------------------------------------
# HTTP and text-file exporters
# ---------------------------------------------------------------------------


def _get(port, path):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                  timeout=5).read().decode()


def test_http_exporter_serves_metrics_on_ephemeral_port(monkeypatch):
    monkeypatch.setenv("RAMBA_METRICS_HOST", "127.0.0.1")
    registry.inc("fuser.flushes", 2)
    port = telemetry.start(port=0)
    assert port and port > 0 and telemetry.port() == port
    assert "ramba_fuser_flushes_total" in _get(port, "/metrics")
    health = json.loads(_get(port, "/healthz"))
    assert health["ok"] is True and health["pid"] == os.getpid()
    assert health["device_kind"] == "cpu"
    with pytest.raises(urllib.error.HTTPError):
        _get(port, "/nope")
    telemetry.stop()
    assert not telemetry.started()


def test_http_scrape_consistent_during_flushes(monkeypatch):
    """Scrapes taken while flushes run parse clean (histogram buckets
    monotone), and the flush and stage-seconds series read after the
    flushes match the registry's and the attribution plane's snapshots."""
    monkeypatch.setenv("RAMBA_METRICS_HOST", "127.0.0.1")
    port = telemetry.start(port=0)
    errs = []
    x = rt.fromarray(np.arange(4096.0))

    def hammer():
        try:
            for i in range(40):
                float(rt.sum(x * 2.0 + float(i)))
        except Exception as e:  # noqa: BLE001  (recorded for the assert)
            errs.append(repr(e))

    t = threading.Thread(target=hammer)
    t.start()
    try:
        for _ in range(5):
            per_series: dict = {}
            for line in _get(port, "/metrics").splitlines():
                if "_bucket{" in line:
                    key = (line.split("{")[0],
                           line.split('tenant="')[1].split('"')[0])
                    per_series.setdefault(key, []).append(
                        float(line.rsplit(" ", 1)[1]))
            for key, counts in per_series.items():
                assert counts == sorted(counts), (key, counts)
    finally:
        t.join()
    assert not errs, errs
    body = _get(port, "/metrics")
    rep = attrib.attribution_report()
    got = {ln.split('stage="')[1].split('"')[0]: float(ln.rsplit(" ", 1)[1])
           for ln in body.splitlines()
           if ln.startswith("ramba_stage_seconds_total{")}
    assert got == {k: float(v) for k, v in rep["stage_seconds"].items()}
    line = next(ln for ln in body.splitlines()
                if ln.startswith("ramba_flushes_attributed_total{"))
    assert float(line.rsplit(" ", 1)[1]) == rep["flushes"]
    hits = next(ln for ln in body.splitlines()
                if ln.startswith("ramba_fuser_cache_hit_total{"))
    assert int(hits.rsplit(" ", 1)[1]) == registry.get("fuser.cache_hit")


def test_textfile_export_atomic(tmp_path):
    registry.inc("textfile.probe")
    path = tmp_path / "metrics.prom"
    telemetry.write_textfile(str(path))
    assert 'ramba_textfile_probe_total{rank="0"} 1' in path.read_text()
    assert not list(tmp_path.glob("*.tmp"))
    registry.inc("textfile.probe", 41)
    telemetry.start(path=str(path), interval_s=0.05)
    want = 'ramba_textfile_probe_total{rank="0"} 42'
    deadline = time.time() + 5
    while time.time() < deadline and want not in path.read_text():
        time.sleep(0.02)
    assert want in path.read_text()


def test_textfile_path_multirank_suffix(tmp_path, monkeypatch):
    p = str(tmp_path / "m.prom")
    assert telemetry.textfile_path(p) == p
    monkeypatch.setattr(events, "_rank", (1, 2))
    try:
        assert telemetry.textfile_path(p) == f"{p}.rank1"
        telemetry.write_textfile(p)
        assert os.path.exists(f"{p}.rank1") and not os.path.exists(p)
        assert 'rank="1"' in open(f"{p}.rank1").read()
    finally:
        events.invalidate_rank()


def test_env_starts_the_exporter_at_a_flush(tmp_path, monkeypatch):
    path = tmp_path / "env.prom"
    monkeypatch.setenv("RAMBA_METRICS_FILE", str(path))
    monkeypatch.setenv("RAMBA_METRICS_INTERVAL_S", "0.05")
    telemetry.reset()
    float(rt.sum(rt.fromarray(np.arange(8.0))))
    assert telemetry.started()
    deadline = time.time() + 5
    while time.time() < deadline and not path.exists():
        time.sleep(0.02)
    assert "ramba_process_info" in path.read_text()


# ---------------------------------------------------------------------------
# trace context
# ---------------------------------------------------------------------------


def test_span_scope_stamps_events_and_nests():
    assert telemetry.current_context() is None
    with telemetry.span_scope("t-1", "s-1"):
        e = events.emit({"type": "probe"})
        with telemetry.span_scope("t-1", "s-2"):
            e2 = events.emit({"type": "probe"})
        assert telemetry.current_context() == ("t-1", "s-1")
    assert e["trace_id"] == "t-1" and e["parent_span"] == "s-1"
    assert e2["parent_span"] == "s-2"
    assert "trace_id" not in events.emit({"type": "probe"})
    with telemetry.span_scope(None, "x"):
        assert telemetry.current_context() is None
    a, b = telemetry.mint_id(), telemetry.mint_id()
    assert len(a) == 16 and a != b


def test_child_events_inherit_trace_via_dispatch_scope(monkeypatch):
    """An event emitted inside a flush's dispatch (a degrade step here)
    carries the flush span's trace context without per-site wiring."""
    seen = []
    real = rt.core.fuser._new_span

    def traced(*a, **kw):
        span = real(*a, **kw)
        span["trace_id"], span["span_id"] = "tr-9", "sp-9"
        return span

    monkeypatch.setattr(rt.core.fuser, "_new_span", traced)
    events.add_tap(seen.append)
    try:
        faults.configure("oom:1:bytes=1")
        float(rt.sum(rt.fromarray(np.arange(64.0)) * 2.0 + 1.0))
    finally:
        faults.configure(None)
        events.remove_tap(seen.append)
    deg = [e for e in seen if e.get("type") == "degrade"]
    assert deg and all(e["trace_id"] == "tr-9" and e["parent_span"] == "sp-9"
                       for e in deg)


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------


def test_flight_recorder_exactly_once_per_incident(tmp_path, monkeypatch):
    fd = tmp_path / "flight"
    monkeypatch.setenv("RAMBA_FLIGHT_DIR", str(fd))
    # a factor far below the seeded 200 ms and far above a sub-ms flush's
    # jitter on a loaded host
    ledger.reconfigure(factor=20.0, min_samples=2)
    telemetry.flight_reset()
    d0 = registry.get("telemetry.flight_dumps")
    faults.configure("dispatch:delay:ms=200:after=3")
    for i in range(6):
        (rt.ones((32,)) + float(i)).asarray()
    faults.configure(None)
    dumps = sorted(glob.glob(str(fd / "flight_*.json")))
    assert len(dumps) == 1, dumps
    rec = json.loads(open(dumps[0]).read())
    assert rec["incident"]["type"] == "slow_flush"
    assert rec["events"] and "captured_at" in rec["diagnostics"]
    assert rec["identity"]["pid"] == os.getpid()
    assert rec["identity"]["schema_version"] == diagnostics.SCHEMA_VERSION
    assert os.path.basename(dumps[0]).startswith(
        f"flight_{rec['incident']['seq']:06d}_")
    assert registry.get("telemetry.flight_dumps") - d0 == 1


def test_flight_recorder_cap_is_retention_gc(tmp_path, monkeypatch):
    monkeypatch.setenv("RAMBA_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("RAMBA_FLIGHT_MAX", "2")
    telemetry.flight_reset()
    gc0 = registry.get("telemetry.flight_gc")
    dumps0 = registry.get("telemetry.flight_dumps")
    for i in range(5):
        events.emit({"type": "slo_breach", "tenant": "x", "n": i})
    dumps = sorted(glob.glob(str(tmp_path / "flight_*.json")))
    assert len(dumps) == 2
    assert registry.get("telemetry.flight_dumps") - dumps0 == 5
    assert registry.get("telemetry.flight_gc") - gc0 == 3
    ns = sorted(json.loads(open(p).read())["incident"]["n"] for p in dumps)
    assert ns == [3, 4]


def test_flight_recorder_off_without_dir():
    assert "RAMBA_FLIGHT_DIR" not in os.environ
    events.emit({"type": "slo_breach", "tenant": "x"})
    assert telemetry.dump_flight({"type": "stall", "seq": 1}) is None


@pytest.mark.parametrize("event,incident", [
    ({"type": "stall", "site": "dispatch"}, True),
    ({"type": "flush_error"}, True),
    ({"type": "slow_flush"}, True),
    ({"type": "perf_regression"}, True),
    ({"type": "slo_breach"}, True),
    ({"type": "integrity"}, True),
    ({"type": "memory", "action": "oom_evict"}, True),
    ({"type": "memory", "action": "admit"}, False),
    ({"type": "flush"}, False),
    ({"type": "breaker", "action": "open"}, False),  # serving: A.10
])
def test_incident_classes(event, incident):
    assert telemetry.is_incident(event) is incident


def test_diagnostics_snapshot_stamped_once():
    snap = diagnostics.snapshot()
    assert isinstance(snap["captured_at"], float)
    assert isinstance(snap["captured_mono"], float)
    json.dumps(snap, default=str)



def test_an_incident_is_dumped_after_its_flush(tmp_path, monkeypatch):
    """A perf_regression fires inside a flush (the fenced call's device
    window): its dump (a snapshot of every plane) is written after the
    flush's span is final, so it is not in that flush's wall and the
    slow-flush sentinel does not read it as an incident of its own."""
    monkeypatch.setenv("RAMBA_FLIGHT_DIR", str(tmp_path / "flight"))
    telemetry.flight_reset()
    ledger.reconfigure(factor=0.0)  # no slow_flush on a loaded host
    attrib.reset()
    base = tmp_path / "base"
    attrib.reconfigure(baseline_dir=str(base), drift_min_samples=3)
    x = rt.fromarray(np.arange(4096.0))
    for _ in range(4):
        float(rt.sum(x * 2.0 + 1.0))
    assert attrib.save_baselines()
    doc = json.loads((base / "perf_baseline.json").read_text())
    for b in doc["kernels"].values():
        b["p50_s"] = b["p50_s"] / 1000.0
    (base / "perf_baseline.json").write_text(json.dumps(doc))
    attrib.reset()
    attrib.reconfigure(baseline_dir=str(base), drift_min_samples=3)
    real, when = telemetry.dump_flight, []

    def slow_dump(incident, directory=None):
        when.append(len(events.last(0, type="flush")))
        time.sleep(0.2)
        return real(incident, directory)

    monkeypatch.setattr(telemetry, "dump_flight", slow_dump)
    try:
        flushes0 = len(events.last(0, type="flush"))
        for _ in range(5):
            float(rt.sum(x * 2.0 + 1.0))
        regs = events.last(0, type="perf_regression")
        assert len(regs) == 1 and len(when) == 1
        # the flush that fired it had emitted its span before the dump
        assert when[0] > flushes0
        spans = events.last(0, type="flush")[flushes0:]
        assert max(s["wall_s"] for s in spans) < 0.2, spans
        dumps = glob.glob(str(tmp_path / "flight" / "flight_*.json"))
        assert len(dumps) == 1
    finally:
        attrib.reset()
        attrib.reconfigure()
