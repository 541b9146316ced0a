"""The port's ``diagnostics`` report and ``utils/debug.py`` against
ramba_tpu, x64 regime, on the CPU.

The counterparts of ``tests/test_observability.py``: the flush span of a
cold and a warm flush (miss then hit, the same keys as ramba_tpu's span
of the same program where the port keeps them), the report printing
every section the port has, ``dump`` round-tripping as JSON,
``snapshot``'s keys and schema version (ramba_tpu's), ``python -m
ramba_tpu_torch.diagnostics``, the memo and plan-cache blocks (stubs
before this slice), ``serving_report``/``overload_report`` naming ROADMAP
A.10, ``identity`` naming the device, ``reset``; then ``debug``: the dot
dump and the pending report of the same pending graph as ramba_tpu's,
``drain_effect_errors`` (None on the CPU) and ``RAMBA_TPU_HISTORY``.
"""

import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from ramba_tpu import diagnostics as jdiagnostics
from ramba_tpu.utils import debug as jdebug
from ramba_tpu_torch import common, diagnostics
from ramba_tpu_torch.core import fuser, memo, plancache
from ramba_tpu_torch.observe import attrib, events, slo
from ramba_tpu_torch.utils import debug

REPO = Path(__file__).resolve().parents[1]

# the reference's span keys the port's span carries too (it has no
# linearize_s, rewrite_fires or donation: torch donates nothing)
_SPAN_KEYS = ("label", "instrs", "leaf_bytes", "out_bytes", "segments",
              "cache", "compile_s", "execute_s", "wall_s", "calls",
              "stages", "unattributed_s", "fingerprint")


@pytest.fixture(autouse=True)
def _cpu():
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    rt.sync()


def _run_chain(pkg=rt):
    a = pkg.arange(512) * 3.0 + 1.0
    return float(pkg.sum(a))


def test_flush_span_miss_then_hit():
    fuser.flush()
    fuser._compile_cache.clear()
    v1 = _run_chain()
    span1 = diagnostics.last_flushes(1)[0]
    for k in _SPAN_KEYS:
        assert k in span1, f"flush span missing {k!r}"
    assert span1["type"] == "flush" and span1["cache"] == "miss"
    assert span1["compile_s"] > 0.0 and span1["wall_s"] >= span1["compile_s"]
    assert "compile" in span1["stages"]
    v2 = _run_chain()
    span2 = diagnostics.last_flushes(1)[0]
    assert span2["label"] == span1["label"] and span2["cache"] == "hit"
    assert span2["compile_s"] == 0.0 and span2["execute_s"] > 0.0
    assert "compile" not in span2["stages"]
    assert v1 == v2 == _run_chain(rtj)
    jspan = jdiagnostics.last_flushes(1)[0]
    assert {k for k in _SPAN_KEYS if k in jspan} >= set(_SPAN_KEYS) - {
        "leaf_bytes"}


_SECTIONS = ("=== ramba_tpu_torch diagnostics ===", "-- counters --",
             "-- memory --", "-- kernels (top", "-- attribution --",
             "-- observer tax --", "-- last ", "timing summary",
             "comm stats (host boundary)")


@pytest.mark.parametrize("section", _SECTIONS)
def test_report_prints_every_ported_section(section):
    x = rt.fromarray(np.arange(4096.0))
    for _ in range(3):
        float(rt.sum(x * 2.0 + 1.0))
    buf = io.StringIO()
    diagnostics.report(file=buf)
    assert section in buf.getvalue(), buf.getvalue()[:3000]


def test_report_prints_the_optional_sections_when_in_use(monkeypatch):
    monkeypatch.setenv("RAMBA_MEMO", "1")
    monkeypatch.setenv("RAMBA_PLANCERT", "1")
    try:
        x = rt.fromarray(np.arange(64.0))
        for _ in range(3):
            float(rt.sum(x * 5.0))
        slo.observe_e2e(0.001)
        buf = io.StringIO()
        diagnostics.report(file=buf)
        text = buf.getvalue()
        for sec in ("-- result memo --", "-- plan cache --"):
            assert sec in text, text[-2000:]
        assert "-- serving" not in text and "-- overload" not in text
    finally:
        memo.reset()
        plancache.reset()


def test_dump_round_trips_as_json(tmp_path):
    _run_chain()
    p = diagnostics.dump(str(tmp_path / "diag.json"))
    snap = json.loads(Path(p).read_text())
    for k in ("counters", "events", "memory", "perf", "elastic",
              "identity", "schema_version", "captured_at"):
        assert k in snap, k
    assert snap["schema_version"] == jdiagnostics.SCHEMA_VERSION
    assert "attribution" in snap["perf"]
    assert "serving" not in snap and "overload" not in snap


def test_identity_names_the_device():
    ident = diagnostics.identity()
    assert ident["device_kind"] == "cpu" and ident["pid"] == os.getpid()
    assert set(ident) == set(jdiagnostics.identity())


def test_serving_reports_name_their_item():
    for fn in (diagnostics.serving_report, diagnostics.overload_report):
        with pytest.raises(NotImplementedError, match="A.10"):
            fn()


def test_memo_and_plancache_reports_are_their_snapshots():
    assert diagnostics.memo_report() == memo.cache.snapshot()
    assert diagnostics.plancache_report() == plancache.snapshot()
    assert set(diagnostics.memo_report()) >= {"enabled", "entries", "hits",
                                              "misses", "hit_rate"}


def test_elastic_and_lifecycle_reports():
    rep = diagnostics.elastic_report()
    assert {"watchdog_s", "heartbeat_running", "stalls", "checkpoints",
            "resumes", "drains"} <= set(rep)
    events.emit({"type": "lifecycle", "phase": "probe"})
    assert diagnostics.lifecycle_events(1)[-1]["phase"] == "probe"


def test_the_module_entry_dumps_json(tmp_path):
    env = dict(os.environ, RAMBA_TORCH_DEVICE="cpu")
    r = subprocess.run([sys.executable, "-m", "ramba_tpu_torch.diagnostics",
                        "--json"], env=env, capture_output=True, text=True,
                       cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    snap = json.loads(r.stdout)
    assert snap["identity"]["device_kind"] == "cpu"
    out = tmp_path / "d.json"
    r = subprocess.run([sys.executable, "-m", "ramba_tpu_torch.diagnostics",
                        "-o", str(out)], env=env, capture_output=True,
                       text=True, cwd=REPO, timeout=300)
    assert r.returncode == 0 and json.loads(out.read_text())["counters"] \
        is not None
    r = subprocess.run([sys.executable, "-m", "ramba_tpu_torch.diagnostics"],
                       env=env, capture_output=True, text=True, cwd=REPO,
                       timeout=300)
    assert r.returncode == 0 and "ramba_tpu_torch diagnostics" in r.stdout


def test_reset_clears_counters_ring_ledger_and_slo():
    _run_chain()
    diagnostics.reset()
    assert diagnostics.counters() == {}
    assert diagnostics.last_flushes(5) == []
    assert diagnostics.perf_report()["kernels"] == {}
    assert not any(diagnostics.slo_report()["histograms"].values())
    attrib.reset()


# ---------------------------------------------------------------------------
# utils/debug.py
# ---------------------------------------------------------------------------


def _pending(pkg):
    a = pkg.arange(12) * 2.0
    b = pkg.sin(a) + 1.0
    return a, b


def test_output_dot_matches_ramba_tpu(tmp_path):
    outs = []
    for pkg, dbg in ((rt, debug), (rtj, jdebug)):
        keep = _pending(pkg)
        text = dbg.output_dot(str(tmp_path / f"{pkg.__name__}.dot"))
        ops = sorted(ln.split('label="')[1].split(" ")[0]
                     for ln in text.splitlines() if 'label="' in ln)
        edges = sum("->" in ln for ln in text.splitlines())
        outs.append((ops, edges))
        assert Path(tmp_path / f"{pkg.__name__}.dot").read_text() == text
        del keep
        pkg.sync()
    assert outs[0] == outs[1], outs


def test_report_pending_counts_and_names_ops():
    buf = io.StringIO()
    a, b = _pending(rt)
    assert debug.report_pending(file=buf) == 2
    text = buf.getvalue()
    assert "2 pending lazy array(s)" in text and "ops=4 [" in text
    rt.sync()
    buf = io.StringIO()
    assert debug.report_pending(file=buf) == 0
    assert "no pending lazy arrays" in buf.getvalue()


def test_drain_effect_errors_is_none_on_the_cpu():
    assert debug.drain_effect_errors() is None


def test_history_dump_at_exit(tmp_path):
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import ramba_tpu_torch as rt;"
            "float(rt.sum(rt.arange(64) * 2.0))")
    env = dict(os.environ, RAMBA_TORCH_DEVICE="cpu", RAMBA_TPU_HISTORY="1")
    r = subprocess.run([sys.executable, "-c", code, str(REPO)], env=env,
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    text = (tmp_path / "ramba_tpu_flush_history.txt").read_text()
    assert "flushes: 1" in text and "fuser.cache_miss: 1" in text
