"""The observer tax and sampled attribution of the port, against
ramba_tpu, x64 regime, on the CPU.

The counterparts of ``tests/test_observer_tax.py``'s cases on the
planes the port has: ``RAMBA_ATTRIB=sample:<N>`` parsed with the fence
still armed; ``fence_decision`` a pure function of each fingerprint's own
call counter (the same verdicts and fence logs as ramba_tpu's for the
same calls, replayable after a reset); ``device_source`` and
``fence_seq`` stamped on the span; off and always-on modes; unfenced
flushes carrying ``device_est_s`` and never a ``device_execute`` stage;
the observer-tax ledger, ``tax_frac`` over attributed flush wall (a
number after a flush: it was None before this slice), and its
diagnostics and Prometheus surfaces; the explainer's verdicts for four
dominant stages and its silence, equal to ramba_tpu's; the slow-flush
sentinel stamping ``why``.  Then across processes: gloo worlds of 2 and 4
ranks (``tests/torch_dist_worker.py``, mode ``observe``) under
``sample:4`` give every rank the same stage signature for every flush
and the same fence log (sequences 0, 4, 8 of each fingerprint).
"""

import contextlib
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
from ramba_tpu.observe import attrib as jattrib
from ramba_tpu.observe import observer as jobserver
from ramba_tpu_torch import common, diagnostics
from ramba_tpu_torch.observe import (attrib, events, ledger, observer,
                                     telemetry)
from ramba_tpu_torch.resilience import faults

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dist_worker as worker  # noqa: E402

WORKER = str(Path(__file__).resolve().parent / "torch_dist_worker.py")
LIMIT_S = 300


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    for k in ("RAMBA_ATTRIB", "RAMBA_PERF", "RAMBA_FAULTS"):
        monkeypatch.delenv(k, raising=False)
    for a in (attrib, jattrib):
        a.reset()
        a.reconfigure()
    yield
    for a in (attrib, jattrib):
        a.reset()
        a.reconfigure()
    ledger.reconfigure()


def _chain(pkg=rt, n=2711):
    a = pkg.arange(n) * 2.0 + 1.0
    return float(pkg.sum(a))


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


# ---------------------------------------------------------------------------
# deterministic fence sampling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("raw,armed,n", [
    ("sample:4", True, 4), ("sample:16", True, 16), ("sample:1", True, 1),
    ("sample:x", True, 1), ("off", False, 1), ("0", False, 1),
    ("1", True, 1), ("on", True, 1),
])
def test_attrib_env_parse_equals_ramba_tpu(raw, armed, n):
    with _env(RAMBA_ATTRIB=raw):
        got = []
        for a in (attrib, jattrib):
            a.reconfigure()
            got.append((a.fence_enabled(), a.sample_every(), a.sampling()))
    assert got[0] == got[1] == (armed, n, armed and n > 1)


@pytest.mark.parametrize("n", [2, 4, 16])
def test_fence_decision_deterministic_and_equal_to_ramba_tpu(n):
    logs = []
    for a in (attrib, jattrib):
        a.reset()
        a.reconfigure(sample_every=n)
        fp = "ab" * 6
        dec = [a.fence_decision(fp) for _ in range(3 * n + 1)]
        assert a.fence_decision("cd" * 6) is True  # a fresh fp: seq 0
        rep = a.sampling_report()
        assert rep["fingerprints"][fp]["fenced_seqs"] == [0, n, 2 * n, 3 * n]
        a.reset()
        assert [a.fence_decision(fp) for _ in range(3 * n + 1)] == dec
        logs.append((dec, rep))
    assert logs[0] == logs[1]


def test_fence_decision_stamps_device_source():
    attrib.reconfigure(sample_every=2)
    fp = "ee" * 6
    s0, s1 = {}, {}
    assert attrib.fence_decision(fp, s0) is True
    assert attrib.fence_decision(fp, s1) is False
    assert s0["device_source"] == "fenced" and s0["fence_seq"] == 0
    assert s1["device_source"] == "estimated" and s1["fence_seq"] == 1
    attrib.fence_decision(fp, s1)  # any fenced segment: fenced
    assert s1["device_source"] == "fenced"


def test_fence_decision_off_and_always_modes():
    with _env(RAMBA_ATTRIB="off"):
        attrib.reconfigure()
        assert attrib.fence_decision("ab" * 6) is False
    attrib.reconfigure()
    assert all(attrib.fence_decision("ab" * 6) for _ in range(3))
    assert not attrib.sampling() and attrib.sampling_report()[
        "fingerprints"] == {}


def test_estimated_device_source_on_real_flushes():
    with _env(RAMBA_ATTRIB="sample:2"):
        attrib.reconfigure()
        x = rt.fromarray(np.arange(3301.0))
        for _ in range(6):
            float(rt.sum(x * 2.0 + 1.0))
        spans = [s for s in diagnostics.last_flushes(6)
                 if s.get("device_source")]
        assert {"fenced", "estimated"} <= {s["device_source"] for s in spans}
        for s in spans:
            if s["device_source"] == "estimated":
                assert "device_execute" not in s["stages"], s
                assert s.get("fence_seq") is not None
        est = [s for s in spans if s["device_source"] == "estimated"
               and s.get("device_est_s") is not None]
        assert est and all(s["device_est_s"] > 0 for s in est)
        rep = attrib.attribution_report()
        assert rep["sampling"]["sample_every"] == 2


def test_estimated_device_s_needs_fenced_history():
    assert attrib.estimated_device_s("99" * 6) is None
    assert attrib.estimated_device_s(None) is None
    attrib.record_device("99" * 6, "prog_x", 0.004)
    attrib.record_device("99" * 6, "prog_x", 0.006)
    assert 0.004 <= attrib.estimated_device_s("99" * 6) <= 0.006


# ---------------------------------------------------------------------------
# the observer-tax ledger
# ---------------------------------------------------------------------------


def test_observer_ledger_accounting_equals_ramba_tpu():
    snaps = []
    for o in (observer, jobserver):
        o.reset()
        o.add("events", 0.002)
        o.add("events", 0.001)
        o.add("fence", 0.004)
        o.add("fence", -1.0)  # negative clock skew: ignored
        snaps.append({k: v for k, v in o.snapshot().items()
                      if k != "tax_frac"})
        o.reset()
        assert o.snapshot()["components"] == {}
    assert snaps[0] == snaps[1]
    assert snaps[0]["components"]["fence"]["count"] == 1


def test_observer_tax_frac_denominator_is_flush_wall():
    observer.reset()
    assert observer.tax_frac() is None  # no attributed wall yet
    _chain(rt, 3307)
    frac = observer.tax_frac()
    assert frac is not None and 0.0 < frac
    assert frac == round(observer.total_s() / attrib.flush_wall_total(), 6)
    snap = observer.snapshot()
    assert snap.get("tax_frac") == frac
    for comp in ("events", "ledger", "fence"):
        assert comp in snap["components"], snap
    observer.reset()


def test_observer_surfaces_in_diagnostics_and_telemetry():
    observer.reset()
    observer.add("flight", 0.001)
    rep = diagnostics.observer_report()
    assert rep["components"]["flight"]["seconds"] > 0
    assert "observer" in diagnostics.snapshot()
    buf = io.StringIO()
    diagnostics.report(file=buf)
    assert "observer tax" in buf.getvalue()
    line = next(ln for ln in telemetry.render().splitlines()
                if ln.startswith("ramba_observer_seconds_total{"))
    assert 'component="flight"' in line
    observer.reset()


# ---------------------------------------------------------------------------
# the incident explainer
# ---------------------------------------------------------------------------


def _seed_baseline(a, fp, n=5):
    for _ in range(n):
        span = {"stages": {"prepare": 0.001, "queue_wait": 0.001,
                           "dispatch": 0.004, "device_execute": 0.004},
                "wall_s": 0.011}
        a.finalize_span(span, fp=fp)


_SCENARIOS = {
    "overload": ({"prepare": 0.001, "queue_wait": 0.012, "dispatch": 0.004,
                  "device_execute": 0.004}, 0.0, 0.022),
    "cache miss": ({"prepare": 0.001, "queue_wait": 0.001, "compile": 0.050,
                    "dispatch": 0.004, "device_execute": 0.004}, 0.0, 0.061),
    "device regression": ({"prepare": 0.001, "queue_wait": 0.001,
                           "dispatch": 0.004, "device_execute": 0.040},
                          0.0, 0.047),
    "interference": ({"prepare": 0.001, "queue_wait": 0.001,
                      "dispatch": 0.004, "device_execute": 0.004},
                     0.030, 0.041),
    "at baseline": ({"prepare": 0.001, "queue_wait": 0.001,
                     "dispatch": 0.004, "device_execute": 0.004}, 0.0, 0.011),
}


@pytest.mark.parametrize("name", list(_SCENARIOS))
def test_explainer_verdicts_equal_ramba_tpu(name):
    st, un, wall = _SCENARIOS[name]
    got = []
    for a in (attrib, jattrib):
        a.reset()
        fp = "fe" * 6
        _seed_baseline(a, fp)
        got.append(a.explain({"stages": dict(st), "unattributed_s": un,
                              "wall_s": wall, "fingerprint": fp}))
    assert got[0] == got[1]
    if name == "at baseline":
        assert got[0] is None
    elif name == "interference":
        assert got[0]["stage"] == "unattributed"
    else:
        assert got[0]["verdict"] == name


def test_explainer_silent_without_history():
    assert attrib.explain({"stages": {"prepare": 0.001}, "wall_s": 0.001,
                           "fingerprint": "fd" * 6}) is None
    assert attrib.explain({"stages": {"prepare": 0.9}, "wall_s": 1.0}) is None


def test_slow_flush_event_carries_why_verdict():
    # the counts below read the bounded event ring: another file's tests
    # in this worker may have filled it
    events.ring.clear()
    ledger.reconfigure(factor=4.0)
    x = rt.fromarray(np.arange(4201.0))
    for _ in range(6):
        float(rt.sum(x * 2.0 + 1.0))
    base = len(events.last(0, type="slow_flush"))
    with faults.active("execute:delay:ms=200"):
        float(rt.sum(x * 2.0 + 1.0))
    evs = events.last(0, type="slow_flush")
    assert len(evs) == base + 1, evs[-2:]
    ev = evs[-1]
    assert ev.get("why") and ev["why_stage"] in attrib.STAGES + (
        "unattributed",)
    assert ev["why_verdict"] == attrib._EXPLAIN_VERDICTS[ev["why_stage"]]
    assert ev["why"].endswith(ev["why_verdict"])


# ---------------------------------------------------------------------------
# lockstep across gloo ranks
# ---------------------------------------------------------------------------


def _launch(world, tmp, env):
    outdir = tmp / "out"
    outdir.mkdir()
    store = tmp / "store"
    full_env = dict(os.environ, RAMBA_TORCH_DEVICE="cpu",
                    RAMBA_INIT_TIMEOUT_S="60", OMP_NUM_THREADS="1",
                    GLOO_SOCKET_IFNAME="lo", **env)
    full_env.pop("RAMBA_FAULTS", None)
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), str(store), str(outdir),
         "observe"], env=full_env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs, rcs = [], []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=LIMIT_S)
            logs.append(out)
            rcs.append(p.returncode)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert rcs == [0] * world, "\n".join(logs)
    return [json.loads((outdir / f"rank{r}.json").read_text())
            for r in range(world)]


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def observed(request, tmp_path_factory):
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    world = request.param
    return world, _launch(world, tmp_path_factory.mktemp(f"obs{world}"),
                          {"RAMBA_ATTRIB": "sample:4"})


def test_ranks_share_stage_signatures(observed):
    world, infos = observed
    sigs = [i["sigs"] for i in infos]
    assert len(sigs[0]) >= 2 * worker.OBSERVE_FLUSHES
    assert all(s == sigs[0] for s in sigs), sigs
    assert all(i["reconciled"] for i in infos)
    for sig in sigs[0]:
        assert sig == [k for k in attrib.STAGES if k in sig]
        assert "trace" in sig and "prepare" in sig and "write_back" in sig


def test_ranks_fence_the_same_sequence_numbers(observed):
    world, infos = observed
    fences = [i["fences"] for i in infos]
    assert all(f == fences[0] for f in fences), fences
    assert all(i["sample_every"] == 4 for i in infos)
    assert all(i["calls"] == infos[0]["calls"] for i in infos)
    for fp, seqs in fences[0].items():
        calls = infos[0]["calls"][fp]
        assert seqs == list(range(0, calls, 4)), (fp, seqs, calls)
    assert all(i["sources"] == infos[0]["sources"] for i in infos)


def test_ranks_agree_and_bill_the_tax(observed):
    world, infos = observed
    assert all(i["sums"] == infos[0]["sums"] for i in infos)
    assert all(i["tax_frac"] is not None and i["tax_frac"] > 0
               for i in infos)
    # the sums against one process of the port (the 1-D chain exactly,
    # star2's within its terms' rounding)
    g = rt.fromarray(np.random.RandomState(3).rand(
        *worker.OBSERVE_GRID).astype(np.float32))
    x = rt.fromarray(np.sin(np.arange(worker.OBSERVE_N, dtype=np.float64)))
    st = rt.stencil(worker.star2_body)
    for k in range(worker.OBSERVE_FLUSHES):
        s2 = float(rt.sum(rt.sstencil(st, g)))
        s1 = float(rt.sum(x * 2.0 + float(k)))
        got2, got1 = infos[0]["sums"][2 * k], infos[0]["sums"][2 * k + 1]
        assert abs(got2 - s2) <= 64 * 48 * 2 ** -23 * abs(s2)
        assert abs(got1 - s1) <= worker.OBSERVE_N * 2 ** -52 * sum(
            abs(2.0 * v + k) for v in np.sin(np.arange(worker.OBSERVE_N)))
