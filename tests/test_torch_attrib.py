"""The attribution plane (``ramba_tpu_torch/observe/attrib.py``) against
ramba_tpu, x64 regime, on the CPU.

The counterparts of ``tests/test_attrib.py``: every flush span carries a
stage waterfall in ``STAGES`` order whose stages plus ``unattributed_s``
equal ``wall_s``, the same stage names as ramba_tpu's span of the same
program, cold and warm; the median residual of a benched kernel under 5 %
of its wall; ``RAMBA_ATTRIB=off`` keeping every stage but
``device_execute``; ``classify`` and ``explain`` equal to ramba_tpu's on
the same inputs and forged spans; the peak table (built in: the H100 and
a CPU default, no TPU row; ``RAMBA_PEAKS_JSON`` inline and from a file);
live roofline rows from fenced windows with the kernel families' flops;
the perf-regression sentinel firing exactly once (and one flight dump)
under ``execute:delay:ms=150`` in both packages, silent on a clean soak,
ratcheting only down and persisting across two processes in both
packages; ``RAMBA_PROFILE=deep``'s annotation; the Prometheus series;
and the reference's ``scripts/trace_report.py --attrib`` and
``--merge-ranks`` reading the port's ``RAMBA_TRACE`` files unchanged.
Then what the port adds: the kernel families' flop and byte counts, and
the ``flush_error`` event the port's quarantine did not emit.
"""

import contextlib
import glob
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from ramba_tpu import diagnostics as jdiagnostics
from ramba_tpu.observe import attrib as jattrib
from ramba_tpu.observe import events as jevents
from ramba_tpu.observe import telemetry as jtelemetry
from ramba_tpu.resilience import faults as jfaults
from ramba_tpu_torch import common, diagnostics
from ramba_tpu_torch.core import fuser
from ramba_tpu_torch.core.expr import Aval
from ramba_tpu_torch.observe import attrib, events, ledger, profile, telemetry
from ramba_tpu_torch.ops import kernel_backend as kb
from ramba_tpu_torch.resilience import faults

REPO = Path(__file__).resolve().parents[1]

PORT = pytest.param((rt, attrib, events, faults, telemetry, diagnostics),
                    id="port")
REF = pytest.param((rtj, jattrib, jevents, jfaults, jtelemetry,
                    jdiagnostics), id="ramba_tpu")
BOTH = [PORT, REF]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    for k in ("RAMBA_ATTRIB", "RAMBA_FLIGHT_DIR", "RAMBA_BASELINE_DIR",
              "RAMBA_PEAKS_JSON", "RAMBA_PROFILE", "RAMBA_PROFILE_DIR",
              "RAMBA_FAULTS", "RAMBA_PERF"):
        monkeypatch.delenv(k, raising=False)
    for a in (attrib, jattrib):
        a.reset()
        a.reconfigure()
    yield
    for a in (attrib, jattrib):
        a.reset()
        a.reconfigure()
    profile.reconfigure()
    telemetry.flight_reset()
    jtelemetry.flight_reset()


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


def _chain(pkg, n=2711):
    a = pkg.arange(n) * 2.0 + 1.0
    return float(pkg.sum(a))


def _big_chain(pkg):
    a = pkg.arange(1_500_000) * 1.000001 + 0.5
    b = pkg.sqrt(a * a + 1.0)
    return float(pkg.sum(b))


@contextlib.contextmanager
def _env(**kv):
    saved = {k: os.environ.get(k) for k in kv}
    for k, v in kv.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _reconciles(span):
    st = span["stages"]
    total = sum(st.values()) + span["unattributed_s"]
    return abs(total - span["wall_s"]) <= 2e-5 * (len(st) + 2)


# ---------------------------------------------------------------------------
# stage ledger
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2711, 40_009])
def test_span_stages_ordered_and_reconcile_with_wall(n):
    """The same program through both packages, cold (its first flush) and
    warm: the same stage names, only canonical ones, in STAGES order, and
    stages plus the residual equal the wall."""
    sigs = {}
    for name, pkg, diag, a in (("port", rt, diagnostics, attrib),
                               ("ref", rtj, jdiagnostics, jattrib)):
        got = []
        for _ in range(2):
            _chain(pkg, n)
            span = diag.last_flushes(1)[0]
            st = span["stages"]
            assert set(st) <= set(a.STAGES), span
            assert list(st) == [k for k in a.STAGES if k in st] or \
                sorted(st, key=a.STAGES.index) == [
                    k for k in a.STAGES if k in st]
            assert _reconciles(span), span
            got.append(tuple(k for k in a.STAGES if k in st))
        sigs[name] = got
    assert sigs["port"] == sigs["ref"], sigs
    assert attrib.STAGES == jattrib.STAGES


def test_benched_kernel_stage_sum_within_5pct_of_wall():
    _big_chain(rt)
    for _ in range(5):
        _big_chain(rt)
    spans = diagnostics.last_flushes(5)
    label = spans[-1]["label"]
    fracs = sorted(s["unattributed_s"] / s["wall_s"]
                   for s in spans if s["label"] == label and s["wall_s"] > 0)
    assert fracs and fracs[len(fracs) // 2] <= 0.05, fracs


def test_attribution_report_aggregates():
    _chain(rt)
    rep = attrib.attribution_report()
    assert rep["flushes"] >= 1
    assert rep["stage_seconds"].get("prepare", 0.0) > 0.0
    assert rep["unattributed_s"] >= 0.0
    assert 0.0 <= rep["unattributed_frac"] <= 1.0
    assert rep["peaks"]["peak_gbps"] > 0
    assert rep["device_kind"] == "cpu"
    assert rep == diagnostics.perf_report()["attribution"]


@pytest.mark.parametrize("pkgs", BOTH)
def test_attrib_off_disables_fence_but_keeps_stages(pkgs):
    pkg, a, *_rest, diag = pkgs
    with _env(RAMBA_ATTRIB="off"):
        a.reconfigure()
        assert not a.fence_enabled()
        _chain(pkg, 2713)
        st = diag.last_flushes(1)[0]["stages"]
        assert "device_execute" not in st
        assert "dispatch" in st or "compile" in st
    a.reconfigure()
    assert a.fence_enabled()


def test_attrib_off_gives_the_same_bytes():
    x = rt.fromarray(np.sin(np.arange(3001.0)))
    on = np.asarray(rt.cumsum(x * 2.5 + 1.0))
    with _env(RAMBA_ATTRIB="off"):
        attrib.reconfigure()
        off = np.asarray(rt.cumsum(x * 2.5 + 1.0))
    assert on.tobytes() == off.tobytes()


# ---------------------------------------------------------------------------
# roofline math and peak tables
# ---------------------------------------------------------------------------

_PEAKS = {"peak_gbps": 100.0, "peak_tflops": 1.0}  # ridge = 10 flops/B


@pytest.mark.parametrize("case", [
    (1e6, 1e8, 1e-3, _PEAKS),
    (1e10, 1e6, 1e-2, _PEAKS),
    (0, 0, 1e-3, _PEAKS),
    (1e6, 1e6, 0.0, _PEAKS),
    (2e9, 1e8, 3e-3, {"peak_gbps": 3350.0, "peak_tflops": 67.0}),
    (5e5, 0, 1e-3, _PEAKS),
    (0, 7e7, 2e-3, {"peak_gbps": 0.0, "peak_tflops": 0.0}),
])
def test_classify_equals_ramba_tpu(case):
    assert attrib.classify(*case) == jattrib.classify(*case)


def test_classify_bandwidth_vs_compute_bound():
    r = attrib.classify(flops=1e6, bytes_accessed=1e8, device_s=1e-3,
                        peaks=_PEAKS)
    assert r["bound"] == "bandwidth" and r["achieved_gb_per_s"] == 100.0
    assert r["frac_of_peak"] == 1.0 and r["intensity"] == 0.01
    c = attrib.classify(flops=1e10, bytes_accessed=1e6, device_s=1e-2,
                        peaks=_PEAKS)
    assert c["bound"] == "compute" and c["compute_frac"] == 1.0
    assert attrib.classify(0, 0, 1e-3, _PEAKS) is None


def test_builtin_peak_table_has_the_h100_and_no_tpu_row():
    rows = attrib._BUILTIN_PEAKS
    assert set(rows) == {"h100", "default"}
    h = attrib.peak_table("NVIDIA H100 80GB HBM3")
    assert (h["peak_gbps"], h["peak_tflops"]) == (3350.0, 67.0)
    assert h["source"] == "builtin"
    for tpu in ("TPU v4", "TPU v5 lite", "TPU v5p"):
        assert attrib.peak_table(tpu)["source"] == "builtin:default"
    assert attrib.device_kind() == "cpu"
    assert attrib.peak_table()["device_kind"] == "cpu"


def test_peak_table_override_inline_and_file(tmp_path):
    table = {"zz99": {"peak_gbps": 123.0, "peak_tflops": 4.5},
             "default": {"peak_gbps": 7.0, "peak_tflops": 0.5}}
    with _env(RAMBA_PEAKS_JSON=json.dumps(table)):
        attrib.reconfigure()
        hit = attrib.peak_table("Super ZZ99 Chip")
        assert hit["peak_gbps"] == 123.0 and hit["peak_tflops"] == 4.5
        assert hit["source"] == "RAMBA_PEAKS_JSON"
        miss = attrib.peak_table("unknown-part")
        assert miss["peak_gbps"] == 7.0 and miss["source"].endswith(":default")
    p = tmp_path / "peaks.json"
    p.write_text(json.dumps(table))
    with _env(RAMBA_PEAKS_JSON=str(p)):
        attrib.reconfigure()
        assert attrib.peak_table("zz99 rev2")["peak_tflops"] == 4.5
    with _env(RAMBA_PEAKS_JSON="{not json"):
        attrib.reconfigure()  # a bogus override leaves the builtin table
        assert attrib.peak_table("NVIDIA H100")["peak_gbps"] == 3350.0


def test_live_roofline_rows_from_fenced_windows():
    x = rt.fromarray(np.arange(3217.0))  # a vector leaf: elemred takes it
    for _ in range(4):
        float(rt.sum(x * 2.0 + 1.0))
    rep = attrib.attribution_report()
    rows = [r for r in rep["rooflines"].values()
            if r["device_time_source"] == "fence"]
    assert rows, rep["rooflines"]
    r = rows[0]
    assert r["bound"] == "bandwidth"  # elemred's counts: 0.375 flops/byte
    assert r["frac_of_peak"] >= 0.0 and r["device_p50_s"] > 0.0
    assert r["intensity"] == round(3 * 3217 / (8 * 3217 + 8), 3)


# ---------------------------------------------------------------------------
# the kernel families' counts (ROADMAP A.7's leftover)
# ---------------------------------------------------------------------------


def _program(exprs):
    program, leaves = fuser._linearize([e._expr for e in exprs])
    return program, [fuser.leaf_value(leaf) for leaf in leaves]


def test_elemred_counts_chain_ops_per_element():
    x = rt.fromarray(np.arange(1000.0))
    y = rt.fromarray(np.arange(1000.0, dtype=np.float32))
    sx, cx = rt.sin(x), rt.cos(x)
    p, v = _program([sx * sx + cx * cx])
    assert kb.classify(p, v) == "elemred"
    # sin, mul, cos, mul, add (one sin and one cos: the graph shares them)
    assert kb.program_cost(p, v) == (5 * 1000.0, 2 * 8000.0)
    p, v = _program([rt.sum(x * 2.0 + y)])
    assert kb.classify(p, v) == "elemred"
    ops = sum(op in ("map", "reduce", "round") for op, _s, _a in p.instrs)
    assert kb.program_cost(p, v) == (ops * 1000.0, 8000.0 + 4000.0 + 8.0)


def test_segred_counts_one_add_per_element():
    data = rt.fromarray(np.arange(1200.0))
    g = data.groupby(0, np.arange(1200) % 24, 24)
    p, v = _program([g.sum()])
    assert kb.classify(p, v) == "segred"
    lab = [t for t in v if isinstance(t, torch.Tensor) and t.dtype in (
        torch.int32, torch.int64)][0]
    assert kb.program_cost(p, v) == (
        1200.0, 1200.0 * (8 + lab.element_size()) + 24 * 8)


def test_stencil_counts_body_ops_per_interior_cell():
    star2 = rt.stencil(lambda a: 0.25 * (a[0, 1] + a[0, -1] + a[1, 0]
                                         + a[-1, 0])
                       + 0.125 * (a[0, 2] + a[0, -2] + a[2, 0] + a[-2, 0]))
    g = rt.fromarray(np.random.RandomState(0).rand(40, 36).astype(np.float32))
    p, v = _program([rt.sstencil_iterate(star2, g, 7)])
    flops, nbytes = kb.program_cost(p, v)
    assert flops == 7 * 9 * 36 * 32 and nbytes == 7 * 2 * 40 * 36 * 4
    y = g
    for _ in range(3):
        y = rt.sstencil(star2, y)
    p, v = _program([rt.sum(y)])
    flops, nbytes = kb.program_cost(p, v)
    # three sweeps on the kernel, then the sum on the generic lowering
    assert flops == 3 * 9 * 36 * 32
    assert nbytes == 3 * 2 * 40 * 36 * 4 + 40 * 36 * 4 + 4


def test_scan_counts_one_add_per_element():
    x = rt.fromarray(np.arange(5000.0))
    p, v = _program([rt.cumsum(x)])
    assert kb.program_cost(p, v) == (5000.0, 2 * 5000.0 * 8)
    i = rt.fromarray(np.arange(50))
    p, v = _program([rt.cumsum(i)])
    assert kb.program_cost(p, v) is None  # integer scans: torch.cumsum


def test_generic_lowering_records_bytes_only():
    m = rt.fromarray(np.arange(12.0).reshape(3, 4))
    p, v = _program([m.T * 2.0])
    assert kb.classify(p, v) is None and kb.program_cost(p, v) is None


def test_stencil_cost_counts_nothing_ineligible():
    from ramba_tpu_torch.ops import stencil_kernel as sk

    before = sk.ineligible
    got = sk.cost(lambda a: a[0, 1] + a[0, -1], (0, -1), (0, 1),
                  (("arr", 0),), [Aval((8, 8), np.dtype("int64"), False)])
    assert got is None and sk.ineligible == before


# ---------------------------------------------------------------------------
# perf-regression sentinel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkgs", BOTH)
def test_sentinel_fires_exactly_once_with_flight_incident(pkgs, tmp_path):
    pkg, a, ev, flt, tel, diag = pkgs
    fdir = tmp_path / "flight"
    with _env(RAMBA_FLIGHT_DIR=str(fdir)):
        tel.flight_reset()
        a.reset()
        a.reconfigure(baseline_dir=str(tmp_path / "base"),
                      drift_min_samples=3)
        for _ in range(5):
            _chain(pkg, 4099)
        assert a.save_baselines()
        a.reset()
        a.reconfigure(baseline_dir=str(tmp_path / "base"),
                      drift_min_samples=3)
        base = len(ev.last(0, type="perf_regression"))
        with flt.active("execute:delay:ms=150"):
            for _ in range(4):
                _chain(pkg, 4099)
        evs = ev.last(0, type="perf_regression")
        assert len(evs) == base + 1, evs
        e = evs[-1]
        for k in ("fingerprint", "label", "p50_s", "baseline_p50_s", "drift",
                  "factor", "samples", "why", "why_stage"):
            assert k in e, k
        assert e["p50_s"] > e["baseline_p50_s"] * 2.0 and e["drift"] > 2.0
        recs = [json.load(open(p)) for p in glob.glob(str(fdir / "flight_*"))]
        assert [r["incident"]["type"] for r in recs].count(
            "perf_regression") == 1
        with flt.active("execute:delay:ms=150"):
            _chain(pkg, 4099)
        assert len(ev.last(0, type="perf_regression")) == base + 1
        sen = diag.perf_report()["attribution"]["sentinel"]
        assert sen["regressions"] == 1 and e["fingerprint"] in sen["regressed"]


def test_sentinel_silent_on_clean_soak(tmp_path):
    attrib.reconfigure(baseline_dir=str(tmp_path), drift_min_samples=3)
    for _ in range(5):
        _chain(rt, 4111)
    assert attrib.save_baselines()
    attrib.reset()
    attrib.reconfigure(baseline_dir=str(tmp_path), drift_min_samples=3)
    base = len(events.last(0, type="perf_regression"))
    for _ in range(8):
        _chain(rt, 4111)
    assert len(events.last(0, type="perf_regression")) == base
    attrib.reset()
    attrib.reconfigure(baseline_dir=str(tmp_path), drift_factor=0.0,
                       drift_min_samples=3)
    with faults.active("execute:delay:ms=150"):
        for _ in range(4):
            _chain(rt, 4111)
    assert len(events.last(0, type="perf_regression")) == base


@pytest.mark.parametrize("pkgs", BOTH)
def test_baseline_only_ratchets_down(pkgs, tmp_path):
    a = pkgs[1]
    fp = "aa" * 6
    seen = []
    for secs in (0.010, 0.500, 0.002):
        a.reset()
        a.reconfigure(baseline_dir=str(tmp_path), drift_min_samples=1)
        a.record_device(fp, "prog_x", secs)
        a.save_baselines()
        seen.append(a.load_baselines()[fp]["p50_s"])
    assert seen == [0.010, 0.010, 0.002]
    doc = json.loads((tmp_path / "perf_baseline.json").read_text())
    assert doc["version"] == 1 and fp in doc["kernels"]


_RECORD = (
    "import sys; sys.path.insert(0, sys.argv[1])\n"
    "import {pkg} as rt\n"
    "from {pkg}.observe import attrib\n"
    "{setup}"
    "for _ in range(5):\n"
    "    a = rt.arange(2711) * 2.0 + 1.0\n"
    "    float(rt.sum(a))\n"
    "p = attrib.save_baselines()\n"
    "assert p, 'no baseline written'\n"
    "print('SAVED', len(attrib.load_baselines()))\n"
)
_CHECK = (
    "import sys; sys.path.insert(0, sys.argv[1])\n"
    "import {pkg} as rt\n"
    "from {pkg}.observe import attrib, events\n"
    "{setup}"
    "assert attrib.load_baselines(), 'baseline file not restored'\n"
    "for _ in range(5):\n"
    "    a = rt.arange(2711) * 2.0 + 1.0\n"
    "    float(rt.sum(a))\n"
    "print('REGRESSIONS', len(events.last(0, type='perf_regression')))\n"
)


@pytest.mark.parametrize("pkg", ["ramba_tpu_torch", "ramba_tpu"])
def test_baseline_persist_restore_across_processes(pkg, tmp_path):
    """Process 1 records baselines; process 2 restores them from
    RAMBA_BASELINE_DIR and its seeded delay trips the sentinel exactly
    once: fingerprints are stable across processes, in both packages."""
    setup = ("import jax; jax.config.update('jax_enable_x64', True)\n"
             if pkg == "ramba_tpu" else "")
    env = dict(os.environ, JAX_PLATFORMS="cpu", RAMBA_TORCH_DEVICE="cpu",
               RAMBA_BASELINE_DIR=str(tmp_path),
               RAMBA_PERF_DRIFT_MIN_SAMPLES="3")
    for k in ("RAMBA_FAULTS", "RAMBA_TRACE", "RAMBA_ATTRIB"):
        env.pop(k, None)
    r1 = subprocess.run([sys.executable, "-c",
                         _RECORD.format(pkg=pkg, setup=setup), str(REPO)],
                        env=env, capture_output=True, text=True, cwd=REPO)
    assert r1.returncode == 0, r1.stdout + r1.stderr
    assert "SAVED" in r1.stdout
    assert (tmp_path / "perf_baseline.json").exists()
    env["RAMBA_FAULTS"] = "execute:delay:ms=150"
    r2 = subprocess.run([sys.executable, "-c",
                         _CHECK.format(pkg=pkg, setup=setup), str(REPO)],
                        env=env, capture_output=True, text=True, cwd=REPO)
    assert r2.returncode == 0, r2.stdout + r2.stderr
    assert "REGRESSIONS 1" in r2.stdout, r2.stdout


# ---------------------------------------------------------------------------
# the explainer on forged spans, against ramba_tpu
# ---------------------------------------------------------------------------


def _seed(a, fp, stages, n=5):
    for _ in range(n):
        span = {"stages": dict(stages), "wall_s": sum(stages.values())}
        a.finalize_span(span, fp=fp)


_BASE = {"trace": 0.001, "prepare": 0.002, "admit": 0.0005,
         "dispatch": 0.003, "device_execute": 0.01, "write_back": 0.0005}


@pytest.mark.parametrize("stage,value", [
    ("device_execute", 0.2), ("dispatch", 0.05), ("compile", 0.4),
    ("admit", 0.03), ("prepare", 0.09), ("write_back", 0.02),
    ("unattributed", 0.3), ("device_execute", 0.012),
])
def test_explain_equals_ramba_tpu_on_forged_spans(stage, value):
    fp = "bb" * 6
    got = []
    for a in (attrib, jattrib):
        a.reset()
        _seed(a, fp, _BASE)
        st = dict(_BASE)
        un = 0.0
        if stage == "unattributed":
            un = value
        else:
            st[stage] = value
        span = {"stages": st, "unattributed_s": un, "fingerprint": fp,
                "wall_s": sum(st.values()) + un}
        got.append(a.explain(span))
    assert got[0] == got[1]
    if stage == "device_execute" and value < 0.015:
        assert got[0] is None  # within 1.5x of its baseline
    else:
        assert got[0]["stage"] == stage


def test_explain_silent_without_history():
    span = {"stages": dict(_BASE), "wall_s": 0.1, "fingerprint": "cc" * 6}
    assert attrib.explain(span) is None
    assert jattrib.explain(span) is None


# ---------------------------------------------------------------------------
# profiler annotation, Prometheus, offline CLIs
# ---------------------------------------------------------------------------


def test_deep_profile_annotation_smoke():
    with _env(RAMBA_PROFILE="deep"):
        profile.reconfigure()
        assert profile.deep()
        ctx = profile.flush_annotation("ramba_flush:test", trace_id="tr-0042")
        assert isinstance(ctx, torch.profiler.record_function)
        assert ctx.name == "ramba_flush:test#tr-0042"
        with ctx:
            pass
        _chain(rt)  # a real flush dispatches under the annotation
    profile.reconfigure()
    assert not profile.deep()
    if common.timing_level <= 1:
        assert isinstance(profile.flush_annotation("x"),
                          type(contextlib.nullcontext()))


def test_prometheus_attrib_series():
    _chain(rt)
    text = telemetry.render()
    assert "ramba_flushes_attributed_total" in text
    assert 'ramba_stage_seconds_total{' in text
    assert 'stage="prepare"' in text
    assert "ramba_stage_unattributed_seconds_total" in text
    assert "ramba_perf_regressions_total" in text
    assert "ramba_compile_hit_rate" in text
    assert "ramba_roofline_frac_of_peak{" in text


def _trace_report(*args):
    return subprocess.run(
        [sys.executable, str(REPO / "scripts" / "trace_report.py"), *args],
        capture_output=True, text=True)


def test_trace_report_reads_the_ports_trace_attrib(tmp_path):
    """The reference's offline tool on a port trace: the schema check."""
    path = tmp_path / "t.jsonl"
    events.configure(str(path))
    try:
        for n in (2711, 2711, 3001):
            _chain(rt, n)
        events.sync()
    finally:
        events.configure(None)
    r = _trace_report(str(path), "--attrib")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "stage waterfall" in r.stdout
    assert "unattributed gap" in r.stdout
    label = diagnostics.last_flushes(1)[0]["label"]
    assert label in r.stdout


def test_trace_report_merge_ranks_reads_the_ports_traces(tmp_path):
    """Two rank files of the port's schema (one trace per rank, renamed
    as ``RAMBA_TRACE`` names them under a process group): the reference's
    merge reads their stage columns and finds no divergence."""
    base = tmp_path / "m.jsonl"
    for rank in range(2):
        p = tmp_path / f"r{rank}.jsonl"
        events.configure(str(p))
        try:
            for _ in range(2):
                _chain(rt, 2711)
            events.sync()
        finally:
            events.configure(None)
        lines = [json.loads(x) for x in p.read_text().splitlines()]
        flushes = [dict(e, rank=rank) for e in lines
                   if e.get("type") == "flush"]
        Path(f"{base}.rank{rank}").write_text(
            "\n".join(json.dumps(e) for e in flushes) + "\n")
    r = _trace_report(str(base), "--merge-ranks")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "stage seconds per rank:" in r.stdout
    assert "rank divergence: none" in r.stdout


# ---------------------------------------------------------------------------
# a repair: quarantine emits the reference's flush_error event
# ---------------------------------------------------------------------------


def test_quarantine_emits_flush_error(tmp_path):
    """A flush whose program raises emits ``flush_error`` (label, roots
    quarantined, the error), an incident the flight recorder dumps, as
    ramba_tpu's quarantine does; the port emitted none."""
    x = rt.fromarray(np.arange(16.0))
    before = len(events.last(0, type="flush_error"))
    with _env(RAMBA_FLIGHT_DIR=str(tmp_path)):
        telemetry.flight_reset()
        fuser._compile_cache.clear()
        y = x * 3.0
        with faults.inject("compile", "once", kind="fatal"):
            with pytest.raises(faults.InjectedFault):
                y.asarray()
    evs = events.last(0, type="flush_error")
    assert len(evs) == before + 1
    e = evs[-1]
    assert e["quarantined"] == 1 and "InjectedFatalFault" in e["error"]
    assert e["label"].startswith("prog_")
    recs = [json.load(open(p)) for p in glob.glob(str(tmp_path / "flight_*"))]
    assert [r["incident"]["type"] for r in recs] == ["flush_error"]
    np.testing.assert_array_equal(np.asarray(y), np.arange(16.0) * 3.0)


# -- the serve pipeline's stages ----------------------------------------------


def test_a_queued_ticket_stamps_queue_wait_and_coalesce():
    """A ticket of the serve pipeline adds ``queue_wait`` (submit to its
    dispatch, net of its batch) and, in a coalesced batch, ``coalesce``
    (group pop to its own dispatch); its span still reconciles, and the
    stages come in the canonical order of ramba_tpu's."""
    from ramba_tpu_torch import serve

    assert attrib.STAGES == jattrib.STAGES
    pipe = serve.CompilePipeline(coalesce=8)
    pipe._ensure_worker = lambda: None
    x = rt.fromarray(np.arange(512.0))
    try:
        with serve.Session(tenant="stages", pipeline=pipe) as s:
            arrs = [x * 2.0 + 1.0]
            t1 = s.flush()
            arrs.append(x * 2.0 + 1.0)
            t2 = s.flush()
            group = pipe.queue.pop_group(
                8, fingerprint_of=lambda t: t.work.fingerprint, timeout=0)
            assert len(group) == 2
            pipe._dispatch_group(group)
            t1.wait(10)
            t2.wait(10)
        for t in (t1, t2):
            span = t.work.span
            st = span["stages"]
            assert "queue_wait" in st and "coalesce" in st
            assert st["queue_wait"] >= 0.0
            assert abs(sum(st.values()) + span["unattributed_s"]
                       - span["wall_s"]) <= 2e-5 * (len(st) + 2)
            order = [k for k in attrib.STAGES if k in st]
            assert list(st) == order or set(st) == set(order)
        for a in arrs:
            np.testing.assert_array_equal(a.asarray(),
                                          np.arange(512.0) * 2.0 + 1.0)
    finally:
        pipe.stop()
        serve.shutdown()

