"""The elastic plane (``ramba_tpu_torch/resilience/elastic.py``) against
ramba_tpu, x64 regime, on the CPU.

The counterparts of the 32 cases of ``tests/test_elastic.py``: the
``hang:ms=``/``after=`` fault grammar, the watchdog (class defaults and
overrides, ``with_deadline`` timing and errors, seeded dispatch hangs
degrading and recovering, the fatal class propagating, an abandoned
rung), the heartbeat and its misses, ``CheckpointManager`` (manifest
keys, leaf paths, shapes and dtypes, retention and GC, torn and
mismatched manifests, the strict ``load``), ``resume``, drain-to-
checkpoint, the save's debris purge and the report.  Where ``ramba_tpu``
runs green on this image the same calls run through both packages and
the port is held to its behaviour; where it is red (its ``resume`` reads
Orbax metadata this Orbax no longer gives: ``StepMetadata`` has no
``shape``) the port is held to the reference's stated contract and to
NumPy.  Then what the port adds: the two ``live_reshape`` cases of
``tests/test_reshard.py`` on meshes of CPU shards, the host rung under an
armed watchdog (the caller's device and mesh scopes carried into the
helper thread), an abandoned attempt that commits nothing, the memo,
certificate and compile caches after a reshape, the unarmed flush (no
thread, one environment read), and ``scripts/trace_report.py`` reading a
port trace.  The elastic plane across 2 and 4 gloo ranks is in
``tests/test_torch_distributed.py``.
"""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from ramba_tpu.observe import events as jevents
from ramba_tpu.observe import registry as jregistry
from ramba_tpu.resilience import elastic as jelastic
from ramba_tpu.resilience import faults as jfaults
from ramba_tpu.resilience import retry as jretry
from ramba_tpu_torch import common
from ramba_tpu_torch.checkpoint import CheckpointCorruptError
from ramba_tpu_torch.core import fuser, memo, plancache
from ramba_tpu_torch.observe import events, ledger, registry
from ramba_tpu_torch.parallel import mesh as pm
from ramba_tpu_torch.parallel import reshard
from ramba_tpu_torch.resilience import elastic, faults, memory, retry

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """No leaked fault plans, watchdog arming or beacons between tests;
    near-zero retry backoff."""
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    monkeypatch.setenv("RAMBA_RETRY_BASE_S", "0.001")
    for k in ("RAMBA_WATCHDOG_S", "RAMBA_HBM_BUDGET", "RAMBA_DRAIN_S",
              "RAMBA_MEMO", "RAMBA_PLANCERT", "RAMBA_CKPT_KEEP",
              "RAMBA_CKPT_EVERY", "RAMBA_HEARTBEAT_S"):
        monkeypatch.delenv(k, raising=False)
    faults.configure(None)
    jfaults.configure(None)
    yield
    elastic.stop_heartbeat()
    jelastic.stop_heartbeat()
    faults.reset()
    jfaults.reset()


BOTH = [pytest.param((faults, events, registry, elastic, retry), id="port"),
        pytest.param((jfaults, jevents, jregistry, jelastic, jretry),
                     id="ramba_tpu")]


def _ck(tmp_path, name):
    return str(tmp_path / name)


def _zombies_done(timeout=10.0):
    """Wait for every call a deadline abandoned to end (in both
    packages: each leaves a thread a call)."""
    assert elastic.wait_abandoned(timeout)
    for th in threading.enumerate():
        if th.name.startswith("ramba-deadline-"):
            th.join(timeout)


def _mesh(*shape):
    n = int(np.prod(shape))
    names = tuple(f"d{i}" for i in range(len(shape)))
    return pm.Mesh(np.array([CPU] * n, dtype=object).reshape(shape), names)


@pytest.fixture
def restore_mesh():
    old = pm.get_mesh()
    yield
    pm.set_mesh(old)


# -- hang:ms / after= fault grammar -----------------------------------------


def test_hang_spec_parses():
    for f in (faults, jfaults):
        sp = f._parse_one("dispatch:hang:ms=250:after=2")
        assert (sp.mode, sp.kind, sp.delay_ms, sp.after_n) == \
            ("hang", "hang", 250.0, 2)
        assert f._parse_one("x:hang:ms=5").after_n is None


@pytest.mark.parametrize("bad", [
    "x:hang",                        # hang needs ms=
    "x:hang:ms=5:oom",               # hang takes no kind
    "x:hang:ms=5:after=-1",          # negative trigger
    "x:hang:ms=5:after=1:after=2",   # duplicate
    "x:once:after=1",                # after= payload only for delay/hang
])
def test_hang_spec_rejects(bad):
    for f in (faults, jfaults):
        with pytest.raises(ValueError):
            f._parse_one(bad)


@pytest.mark.parametrize("pkg", BOTH)
def test_hang_after_fires_exactly_once(pkg):
    f = pkg[0]
    f.configure("s:hang:ms=60:after=1")
    durations = []
    for _ in range(4):
        t0 = time.monotonic()
        f.check("s")  # never raises
        durations.append(time.monotonic() - t0)
    assert durations[1] > 0.05
    assert all(d < 0.03 for i, d in enumerate(durations) if i != 1)
    assert f.stats()["s"]["fired"] == 1


@pytest.mark.parametrize("pkg", BOTH)
def test_hang_without_after_fires_every_check(pkg):
    f, ev = pkg[0], pkg[1]
    f.configure("s:hang:ms=15")
    t0 = time.monotonic()
    f.check("s")
    f.check("s")
    assert time.monotonic() - t0 > 0.025
    last = ev.last(2, type="fault")
    assert last and last[-1]["kind"] == "hang" and last[-1]["ms"] == 15.0


# -- watchdog / RankStallError ----------------------------------------------


def test_stall_error_classification_routing():
    for cls in ("retryable", "degrade", "fatal"):
        assert retry.classify(elastic.RankStallError("s", 0.1, cls)) == cls
        assert jretry.classify(jelastic.RankStallError("s", 0.1, cls)) == cls
    assert rt.resilience.RankStallError is elastic.RankStallError
    assert retry.classify(elastic.GroupBrokenError("all_reduce", "x")) == \
        "fatal"


def test_stall_class_defaults_and_override(monkeypatch):
    sites = ("dispatch", "barrier", "drain", "heartbeat", "unknown_site")
    assert [elastic.stall_class_for(s) for s in sites] == \
        [jelastic.stall_class_for(s) for s in sites] == \
        ["degrade", "fatal", "fatal", "retryable", "degrade"]
    monkeypatch.setenv("RAMBA_WATCHDOG_CLASS_DISPATCH", "fatal")
    assert elastic.stall_class_for("dispatch") == \
        jelastic.stall_class_for("dispatch") == "fatal"
    monkeypatch.setenv("RAMBA_WATCHDOG_CLASS_DISPATCH", "bogus")
    assert elastic.stall_class_for("dispatch") == \
        jelastic.stall_class_for("dispatch") == "degrade"


@pytest.mark.parametrize("pkg", BOTH)
def test_with_deadline_unarmed_is_plain_call(pkg):
    el = pkg[3]
    assert el.watchdog_seconds() is None
    n0 = threading.active_count()
    assert el.with_deadline("dispatch", lambda: threading.active_count()) \
        == n0


@pytest.mark.parametrize("pkg", BOTH)
def test_with_deadline_raises_within_two_deadlines(pkg):
    ev, el = pkg[1], pkg[3]
    wd = 0.15
    t0 = time.monotonic()
    with pytest.raises(el.RankStallError) as ei:
        el.with_deadline("dispatch", lambda: time.sleep(1.0), timeout_s=wd)
    assert time.monotonic() - t0 < 2 * wd
    assert ei.value.stall_classification == "degrade"
    st = ev.last(1, type="stall")[-1]
    assert st["site"] == "dispatch" and st["deadline_s"] == wd


@pytest.mark.parametrize("pkg", BOTH)
def test_with_deadline_propagates_errors_and_results(pkg):
    el = pkg[3]
    assert el.with_deadline("s", lambda: "ok", timeout_s=5.0) == "ok"
    with pytest.raises(ZeroDivisionError):
        el.with_deadline("s", lambda: 1 / 0, timeout_s=5.0)


def test_seeded_dispatch_hang_degrades_and_recovers(monkeypatch):
    """A seeded dispatch hang trips the watchdog (degrade), the ladder
    drops a rung, and the flush gives ramba_tpu's answer (and NumPy's)."""
    wd = 0.25
    monkeypatch.setenv("RAMBA_WATCHDOG_S", str(wd))
    got = {}
    for name, f, ev, reg, mod in (("port", faults, events, registry, rt),
                                  ("ramba_tpu", jfaults, jevents, jregistry,
                                   rtj)):
        f.configure("dispatch:hang:ms=800:after=0")
        stalls0 = reg.get("elastic.stalls")
        got[name] = float((mod.arange(600) * 2.0 + 1.0).sum())
        st = ev.last(3, type="stall")
        assert st and st[-1]["classification"] == "degrade", name
        assert st[-1]["waited_s"] <= 2 * wd, name
        assert reg.get("elastic.stalls") >= stalls0 + 1, name
        assert ev.last(1, type="flush")[-1].get("degraded") in (
            "split", "chunked", "eager", "host"), name
        f.configure(None)
    assert got["port"] == got["ramba_tpu"] == \
        float((np.arange(600) * 2.0 + 1.0).sum())
    _zombies_done()


@pytest.mark.parametrize("pkg", [
    pytest.param((faults, rt), id="port"),
    pytest.param((jfaults, rtj), id="ramba_tpu")])
def test_seeded_hang_fatal_class_propagates(monkeypatch, pkg):
    f, mod = pkg
    monkeypatch.setenv("RAMBA_WATCHDOG_S", "0.3")
    monkeypatch.setenv("RAMBA_WATCHDOG_CLASS_DISPATCH", "fatal")
    f.configure("dispatch:hang:ms=900:after=0")
    a = mod.arange(100) * 3.0
    with pytest.raises(Exception) as ei:
        float(a.sum())
    assert type(ei.value).__name__ == "RankStallError"
    # the hang was one-shot: the quarantined graph heals on the next touch
    assert float(a.sum()) == float((np.arange(100) * 3.0).sum())
    _zombies_done()


@pytest.mark.parametrize("pkg", [
    pytest.param((faults, rt), id="port"),
    pytest.param((jfaults, rtj), id="ramba_tpu")])
def test_abandoned_rung_does_not_consume_buffers(monkeypatch, pkg):
    """A rung the watchdog gave up on must not wake later and consume
    (the reference: donate) the leaves the recovery still owns."""
    f, mod = pkg
    monkeypatch.setenv("RAMBA_WATCHDOG_S", "0.3")
    f.configure("dispatch:hang:ms=900:after=0")
    a = mod.arange(4096) * 1.5
    first = float(a.sum())
    _zombies_done()  # the abandoned thread wakes and (does not) run
    assert float(a.sum()) == first == float((np.arange(4096) * 1.5).sum())


# -- heartbeat ---------------------------------------------------------------


@pytest.mark.parametrize("pkg", BOTH)
def test_heartbeat_beacons_on_event_stream(pkg):
    ev, el = pkg[1], pkg[3]
    el.start_heartbeat(0.04)
    time.sleep(0.15)
    el.stop_heartbeat()
    beats = ev.last(20, type="heartbeat")
    assert len(beats) >= 2
    assert beats[-1]["n"] > beats[-2]["n"]
    assert beats[-1]["interval_s"] == 0.04


@pytest.mark.parametrize("pkg", BOTH)
def test_heartbeat_miss_detection_under_seeded_hang(pkg):
    f, ev, reg, el = pkg[:4]
    el.start_heartbeat(0.04)
    time.sleep(0.06)  # at least one clean beat
    assert el.check_heartbeat() is True
    # the NEXT beat's check stalls long past twice the interval
    f.configure("heartbeat:hang:ms=600:after=0")
    time.sleep(0.3)
    assert el.check_heartbeat() is False
    missed = ev.last(5, type="lifecycle")
    assert any(e["phase"] == "heartbeat_missed" for e in missed)
    assert reg.get("elastic.heartbeat_missed") >= 1


@pytest.mark.parametrize("pkg", BOTH)
def test_check_heartbeat_without_beacon_is_healthy(pkg):
    el = pkg[3]
    el.stop_heartbeat()
    assert el.check_heartbeat() is True
    assert el.last_beat_age() is None


# -- CheckpointManager -------------------------------------------------------


def _leaves(man):
    return [(lf["path"], tuple(lf["shape"]), lf["dtype"])
            for lf in man["leaves"]]


def test_manager_save_restore_roundtrip(tmp_path):
    """The same tree through both managers: the same manifest keys, leaf
    paths, shapes and dtypes; each round trip gives its values back."""
    w_np = np.arange(64).reshape(8, 8) * 1.5
    b_np = np.arange(8) * 0.25
    mans = {}
    for name, el, mod in (("port", elastic, rt), ("ramba_tpu", jelastic,
                                                    rtj)):
        mgr = el.CheckpointManager(_ck(tmp_path, name), keep=3)
        mgr.register("model", {"w": mod.arange(64).reshape(8, 8) * 1.5,
                               "b": mod.arange(8) * 0.25})
        d = mgr.save(7)
        assert os.path.isdir(d) and mgr.latest() == 7
        man = mgr.manifest(7)
        assert man["process_count"] == 1
        assert man["x64"] is True
        mans[name] = man
        back = mgr.load(7)
        assert np.array_equal(np.asarray(back["model"]["w"]), w_np)
        assert np.array_equal(np.asarray(back["model"]["b"]), b_np)
    assert set(mans["port"]) == set(mans["ramba_tpu"])
    assert _leaves(mans["port"]) == _leaves(mans["ramba_tpu"])
    assert sorted(tuple(lf["shape"]) for lf in mans["port"]["leaves"]) == \
        [(8,), (8, 8)]
    assert mans["port"]["digest"] == elastic._manifest_digest(mans["port"])


def test_manager_leaf_paths_beside_the_reference(tmp_path):
    """A nested tree with a list, a tuple, a scalar and a NumPy leaf: the
    port's manifest names each leaf as the reference's does (its
    ``keystr`` spelling), with the same shape and dtype."""
    def tree(mod):
        return {"opt": [mod.arange(4) * 1.0, (mod.arange(6).reshape(2, 3),)],
                "meta": {"lr": np.float32(0.5), "ids": np.arange(3)},
                "step": np.int64(11)}

    port = elastic.CheckpointManager(_ck(tmp_path, "p"))
    port.save(1, tree(rt))
    ref = jelastic._leaf_fingerprints(jax.tree.map(
        lambda x: x._value() if isinstance(x, rtj.ndarray) else np.asarray(x),
        tree(rtj)))
    assert _leaves(port.manifest(1)) == \
        [(lf["path"], tuple(lf["shape"]), lf["dtype"]) for lf in ref]
    back = port.load(1)
    assert np.array_equal(np.asarray(back["opt"][1][0]),
                          np.arange(6).reshape(2, 3))
    assert int(np.asarray(back["step"])) == 11


@pytest.mark.parametrize("pkg", BOTH)
def test_manager_save_requires_something(tmp_path, pkg):
    el = pkg[3]
    mgr = el.CheckpointManager(_ck(tmp_path, "mgr0"))
    with pytest.raises(ValueError, match="nothing to checkpoint"):
        mgr.save(1)


def test_manager_maybe_save_cadence(tmp_path):
    seen = []
    for name, el, mod in (("port", elastic, rt), ("ramba_tpu", jelastic,
                                                    rtj)):
        mgr = el.CheckpointManager(_ck(tmp_path, name), every_steps=3)
        mgr.register("s", {"x": mod.arange(10) * 1.0})
        got = [mgr.maybe_save(s) is not None for s in (1, 2, 3)]
        seen.append((got, mgr.valid_steps()))
    assert seen[0] == seen[1] == ([False, False, True], [3])


def test_manager_retention_gc(tmp_path):
    seen = []
    for name, el, mod in (("port", elastic, rt), ("ramba_tpu", jelastic,
                                                    rtj)):
        mgr = el.CheckpointManager(_ck(tmp_path, name), keep=2)
        mgr.register("s", {"x": mod.arange(12) * 1.0})
        for s in (1, 2, 3, 4):
            mgr.save(s)
        seen.append((mgr.all_steps(), mgr.latest()))
    assert seen[0] == seen[1] == ([3, 4], 4)


def test_manager_gc_never_deletes_newest_valid(tmp_path):
    seen = []
    for name, el, mod in (("port", elastic, rt), ("ramba_tpu", jelastic,
                                                    rtj)):
        mgr = el.CheckpointManager(_ck(tmp_path, name), keep=5)
        mgr.register("s", {"x": mod.arange(12) * 1.0})
        mgr.save(1)
        mgr.save(2)
        # tear step 2's manifest: step 1 becomes the newest VALID step
        with open(mgr.manifest_path(2), "w") as f:
            f.write('{"step": 2, "process_')
        latest = mgr.latest()
        deleted = el.CheckpointManager(mgr.root, keep=1).gc()
        seen.append((latest, deleted, os.path.isdir(mgr.step_dir(1)),
                     mgr.latest(), os.path.isdir(mgr.step_dir(2))))
    # the newest valid step stays, and torn debris NEWER than it is left
    # for a writer that may still be publishing it
    assert seen[0] == seen[1] == (1, [], True, 1, True)


# -- CheckpointCorruptError paths -------------------------------------------


def test_manifest_absent_raises(tmp_path):
    from ramba_tpu.checkpoint import CheckpointCorruptError as JCorrupt

    for name, el, mod, err in (("port", elastic, rt, CheckpointCorruptError),
                               ("ramba_tpu", jelastic, rtj, JCorrupt)):
        mgr = el.CheckpointManager(_ck(tmp_path, name))
        mgr.register("s", {"x": mod.arange(6) * 1.0})
        mgr.save(1)
        os.remove(mgr.manifest_path(1))
        assert mgr.latest() is None
        with pytest.raises(err, match="no manifest"):
            mgr.manifest(1)
        with pytest.raises(err, match="no valid checkpoint"):
            el.resume(mgr)


def test_manifest_truncated_raises(tmp_path):
    from ramba_tpu.checkpoint import CheckpointCorruptError as JCorrupt

    for name, el, mod, err in (("port", elastic, rt, CheckpointCorruptError),
                               ("ramba_tpu", jelastic, rtj, JCorrupt)):
        mgr = el.CheckpointManager(_ck(tmp_path, name))
        mgr.register("s", {"x": mod.arange(6) * 1.0})
        mgr.save(1)
        with open(mgr.manifest_path(1), "w") as f:
            f.write('{"step": 1, "proc')
        with pytest.raises(err, match="unreadable"):
            mgr.manifest(1)
        with pytest.raises(err):
            mgr.load(1)


def _restamp(el, mgr, step, **changes):
    """Rewrite a step's manifest as another environment would have
    written it (a valid digest), not as at-rest corruption."""
    man = mgr.manifest(step)
    man.update(changes)
    man["digest"] = el._manifest_digest(man)
    with open(mgr.manifest_path(step), "w") as f:
        json.dump(man, f)
    return man


def test_mesh_shape_mismatch_without_target_raises(tmp_path):
    """The strict load refuses a changed world and points at resume;
    resume rebuilds the target for the current mesh (the reference's
    resume is red here: held to NumPy)."""
    mgr = elastic.CheckpointManager(_ck(tmp_path, "mgrm"))
    mgr.register("s", {"x": rt.arange(32) * 1.0})
    mgr.save(1)
    man = mgr.manifest(1)
    man = _restamp(elastic, mgr, 1,
                   process_count=int(man["process_count"]) + 1,
                   mesh_devices=int(man["mesh_devices"]) * 2)
    with pytest.raises(CheckpointCorruptError, match="elastic.resume"):
        mgr.load(1)
    res = elastic.resume(mgr)
    assert np.array_equal(np.asarray(res.state["s"]["x"]),
                          np.arange(32) * 1.0)
    assert res.manifest["mesh_devices"] == man["mesh_devices"]
    # the reference refuses the same manifest the same way
    jmgr = jelastic.CheckpointManager(_ck(tmp_path, "jmgrm"))
    jmgr.register("s", {"x": rtj.arange(32) * 1.0})
    jmgr.save(1)
    jman = jmgr.manifest(1)
    _restamp(jelastic, jmgr, 1,
             process_count=int(jman["process_count"]) + 1,
             mesh_devices=int(jman["mesh_devices"]) * 2)
    with pytest.raises(Exception, match="elastic.resume"):
        jmgr.load(1)


def test_x64_flag_mismatch_raises(tmp_path):
    from ramba_tpu.checkpoint import CheckpointCorruptError as JCorrupt

    for name, el, mod, err in (("port", elastic, rt, CheckpointCorruptError),
                               ("ramba_tpu", jelastic, rtj, JCorrupt)):
        mgr = el.CheckpointManager(_ck(tmp_path, name))
        mgr.register("s", {"x": mod.arange(6) * 1.0})
        mgr.save(1)
        _restamp(el, mgr, 1, x64=not mgr.manifest(1)["x64"])
        with pytest.raises(err, match="jax_enable_x64"):
            mgr.load(1)
        with pytest.raises(err, match="jax_enable_x64"):
            el.resume(mgr)


def test_manifest_leaf_count_mismatch_raises(tmp_path):
    mgr = elastic.CheckpointManager(_ck(tmp_path, "mgrl"))
    mgr.register("s", {"x": rt.arange(6) * 1.0, "y": rt.arange(4) * 1.0})
    mgr.save(1)
    _restamp(elastic, mgr, 1, leaves=mgr.manifest(1)["leaves"][:1])
    with pytest.raises(CheckpointCorruptError, match="leaves"):
        elastic.resume(mgr)


def test_manifest_flipped_bit_fails_its_digest(tmp_path):
    mgr = elastic.CheckpointManager(_ck(tmp_path, "mgrf"))
    mgr.register("s", {"x": rt.arange(6) * 1.0})
    mgr.save(1)
    man = mgr.manifest(1)
    man["leaves"][0]["shape"] = [7]  # not re-stamped
    with open(mgr.manifest_path(1), "w") as f:
        json.dump(man, f)
    with pytest.raises(CheckpointCorruptError, match="self-digest"):
        mgr.manifest(1)
    assert mgr.latest() is None


# -- resume ------------------------------------------------------------------


def test_resume_picks_newest_valid_step(tmp_path):
    mgr = elastic.CheckpointManager(_ck(tmp_path, "mgrn"), keep=5)
    mgr.register("s", {"x": rt.arange(16) * 1.0})
    mgr.save(3)
    mgr.register("s", {"x": rt.arange(16) * 2.0})
    mgr.save(9)
    res = elastic.resume(mgr)
    assert res.step == 9
    assert np.array_equal(np.asarray(res.state["s"]["x"]),
                          np.arange(16) * 2.0)
    lc = [e["phase"] for e in events.last(10, type="lifecycle")]
    assert "resume_begin" in lc and "resume_complete" in lc
    # a torn newer step is skipped
    os.makedirs(mgr.step_dir(12))
    assert elastic.resume(mgr).step == 9


def test_resume_under_hbm_admission_spills(tmp_path, monkeypatch):
    mgr = elastic.CheckpointManager(_ck(tmp_path, "mgrb"))
    big = rt.arange(50_000) * 1.0
    mgr.register("s", {"x": big})
    mgr.save(1)
    float(big.sum())  # realized and in the ledger
    live = memory.ledger.live_bytes
    assert live > 0
    incoming = 50_000 * 8
    # a budget so tight the incoming restore must evict resident arrays
    monkeypatch.setenv("RAMBA_HBM_BUDGET", str(live + incoming // 2))
    evictions0 = registry.get("memory.evictions")
    res = elastic.resume(mgr)
    assert np.array_equal(np.asarray(res.state["s"]["x"]),
                          np.arange(50_000) * 1.0)
    assert registry.get("memory.evictions") > evictions0
    admits = [e for e in events.last(10, type="lifecycle")
              if e["phase"] == "restore_admit"]
    assert admits and admits[-1]["freed_bytes"] > 0
    # the spilled array comes back byte-equal on its next read
    assert np.array_equal(np.asarray(big), np.arange(50_000) * 1.0)


# -- drain-to-checkpoint -----------------------------------------------------


def test_drain_to_checkpoint_quiesces_pending_work(tmp_path):
    """Pending lazy work of the default stream flushes before the save
    (serve sessions: ``test_drain_to_checkpoint_quiesces_sessions``)."""
    root = _ck(tmp_path, "mgrd")
    x = rt.arange(256) * 3.0
    y = x + 1.0
    assert fuser._default_stream.pending_roots()
    d = elastic.drain_to_checkpoint(root, 5, {"y": y})
    assert not fuser._default_stream.pending_roots()
    mgr = elastic.CheckpointManager(root)
    assert mgr.latest() == 5 and os.path.isdir(d)
    res = elastic.resume(mgr)
    assert np.array_equal(np.asarray(res.state["y"]),
                          np.arange(256) * 3.0 + 1.0)
    phases = [e["phase"] for e in events.last(50, type="lifecycle")
              if e.get("step") == 5]
    assert phases[:3] == ["drain_begin", "drain_complete", "checkpoint_saved"]


@pytest.mark.parametrize("pkg", BOTH)
def test_drain_hang_is_fatal_stall(tmp_path, monkeypatch, pkg):
    el = pkg[3]
    monkeypatch.setenv("RAMBA_DRAIN_S", "0.1")
    monkeypatch.setattr(el, "quiesce", lambda: time.sleep(1.0))
    with pytest.raises(el.RankStallError) as ei:
        el.drain_to_checkpoint(_ck(tmp_path, "mgrw"), 1, {"x": 1})
    assert ei.value.stall_classification == "fatal"
    _zombies_done()


# -- checkpoint.save stale tmp debris ----------------------------------------


def test_save_purges_stale_tmp_siblings(tmp_path):
    """A crashed writer's debris goes before the next save: the port's
    two shapes (the staged tmp and anything under its prefix; the port
    writes no Orbax temp dirs)."""
    from ramba_tpu_torch import checkpoint

    p = _ck(tmp_path, "debris")
    junks = (p + ".ramba-tmp", p + ".ramba-tmp.partial-123")
    for junk in junks:
        os.makedirs(junk, exist_ok=True)
        with open(os.path.join(junk, "partial"), "w") as f:
            f.write("torn")
    purged0 = registry.get("checkpoint.tmp_purged")
    checkpoint.save(p, {"w": rt.arange(32) * 1.0})
    for junk in junks:
        assert not os.path.exists(junk), junk
    assert registry.get("checkpoint.tmp_purged") == purged0 + 2
    assert np.array_equal(np.asarray(checkpoint.restore(p)["w"]),
                          np.arange(32) * 1.0)


def test_save_does_not_purge_unrelated_siblings(tmp_path):
    from ramba_tpu import checkpoint as jcheckpoint
    from ramba_tpu_torch import checkpoint

    for name, ck, mod in (("port", checkpoint, rt),
                          ("ramba_tpu", jcheckpoint, rtj)):
        p = _ck(tmp_path, f"ckpt_{name}")
        other = _ck(tmp_path, f"ckpt_{name}2.ramba-tmp")  # not debris
        os.makedirs(other)
        ck.save(p, {"w": mod.arange(8) * 1.0})
        assert os.path.isdir(other)


# -- the report --------------------------------------------------------------


def test_elastic_report_shape():
    from ramba_tpu import diagnostics as jdiagnostics

    rep = elastic.report()
    assert set(rep) == set(jdiagnostics.elastic_report())
    for key in ("watchdog_s", "heartbeat_running", "heartbeats", "stalls",
                "checkpoints", "resumes", "drains"):
        assert key in rep
    assert "elastic" in dir(rt.resilience)


# -- what the port adds --------------------------------------------------------


def test_live_reshape_live_rung_byte_identical(restore_mesh):
    """A 2x2 mesh of CPU shards -> 4x1 -> one shard, live: byte-equal,
    and a stencil sweep and a sum on the new mesh match (the reference's
    case on its virtual devices, ``tests/test_reshard.py``)."""
    pm.set_mesh(_mesh(2, 2))
    data = np.arange(64 * 32, dtype=np.float32).reshape(64, 32)
    series = np.sin(np.arange(1003) * 1e-3)
    a, s = rt.fromarray(data), rt.fromarray(series)
    np.asarray(a)
    np.asarray(s)
    st = rt.stencil(lambda v: 0.25 * (v[0, 1] + v[0, -1] + v[1, 0] + v[-1, 0]))
    want = np.asarray(rt.sstencil(st, a))
    want_sum = float(rt.sum(s))
    live0 = elastic.report()["live_reshapes"]
    for shape in ((4, 1), (1,)):
        res = elastic.live_reshape(_mesh(*shape))
        assert res["mode"] == "live" and res["arrays"] >= 2
        assert tuple(pm.get_mesh().shape.values()) == shape
        assert a.sharding.mesh == pm.get_mesh()
        assert np.asarray(a).tobytes() == data.tobytes()
        assert np.asarray(rt.sstencil(st, a)).tobytes() == want.tobytes()
        assert float(rt.sum(s)) == want_sum
    assert elastic.report()["live_reshapes"] == live0 + 2
    ph = [e["phase"] for e in events.last(20, type="lifecycle")]
    assert "reshape_begin" in ph and "reshape_live_complete" in ph


def test_live_reshape_fault_falls_back_to_checkpoint(tmp_path, restore_mesh):
    """A reshard that fails falls back to drain + checkpoint + resume on
    the new mesh: ``mode == "checkpoint"``, byte-equal (the reference's
    case is red on this image: held to its contract and to NumPy)."""
    pm.set_mesh(_mesh(2, 2))
    data = np.arange(32 * 16, dtype=np.float32).reshape(32, 16)
    a = rt.fromarray(data)
    np.asarray(a)
    fb0 = elastic.report()["reshape_fallbacks"]
    faults.configure("reshard:plan:always")
    try:
        res = elastic.live_reshape(_mesh(4, 1), manager=str(tmp_path))
    finally:
        faults.configure(None)
    assert res["mode"] == "checkpoint"
    assert dict(pm.get_mesh().shape) == {"d0": 4, "d1": 1}
    assert np.asarray(a).tobytes() == data.tobytes()
    assert np.asarray(a + 1.0).tobytes() == (data + 1.0).tobytes()
    assert elastic.report()["reshape_fallbacks"] == fb0 + 1
    assert elastic.CheckpointManager(str(tmp_path)).latest() == 0


def test_live_reshape_counts_only_the_bytes_it_copies(restore_mesh):
    """``bytes`` is what the reshape copied: every array's bytes onto a
    new layout, none when each stays where it is."""
    pm.set_mesh(_mesh(2, 2))
    data = np.arange(64 * 32, dtype=np.float32).reshape(64, 32)
    series = np.sin(np.arange(1003) * 1e-3)
    a, s = rt.fromarray(data), rt.fromarray(series)
    np.asarray(a)
    np.asarray(s)
    copied = []
    orig = reshard.reshard_value

    def spy(value, *args, **kw):
        out = orig(value, *args, **kw)
        if out is not value:
            copied.append(out.value.numel() * out.value.element_size())
        return out

    reshard.reshard_value = spy
    try:
        res = elastic.live_reshape(_mesh(4, 1))
        assert res["mode"] == "live"
        assert res["bytes"] == sum(copied) >= data.nbytes + series.nbytes
        copied.clear()
        res = elastic.live_reshape(pm.get_mesh())  # the same layout
    finally:
        reshard.reshard_value = orig
    assert res["mode"] == "live" and res["arrays"] >= 2
    assert res["bytes"] == 0 and copied == []
    assert np.asarray(a).tobytes() == data.tobytes()


def test_a_fallback_without_a_manager_leaves_no_checkpoint(restore_mesh):
    """With no manager the fallback checkpoints to a temporary root and
    deletes it after the resume."""
    pm.set_mesh(_mesh(2, 2))
    data = np.arange(32 * 16, dtype=np.float32).reshape(32, 16)
    a = rt.fromarray(data)
    np.asarray(a)
    seen = []
    events.add_tap(seen.append)
    try:
        with faults.active("reshard:plan:always"):
            res = elastic.live_reshape(_mesh(4, 1))
    finally:
        events.remove_tap(seen.append)
    assert res["mode"] == "checkpoint"
    saved = [e["path"] for e in seen if e.get("phase") == "checkpoint_saved"]
    assert len(saved) == 1 and not os.path.exists(os.path.dirname(saved[0]))
    assert np.asarray(a).tobytes() == data.tobytes()


def test_a_swap_onto_a_buffer_other_arrays_still_hold():
    """The fallback adopts the restored arrays' buffers: while those
    arrays live, one entry holds both sets of owners, the buffer counted
    once, and their letting go leaves it to the adopting array."""
    a = rt.fromarray(np.arange(300.0))
    b = rt.fromarray(np.arange(300.0) * 2.0)
    np.asarray(a)
    np.asarray(b)
    old, new = a._const().value, b._const().value
    live0 = memory.ledger.live_bytes
    assert memory.ledger.swap_value(old, new)
    del old
    assert memory.ledger.live_bytes == live0 - 2400
    assert memory.ledger.owner_count(new) == 2
    del b
    assert memory.ledger.owner_count(new) == 1
    assert memory.ledger.live_bytes == live0 - 2400
    assert np.asarray(a).tobytes() == (np.arange(300.0) * 2.0).tobytes()
    del a
    assert memory.ledger.owner_count(new) == 0
    assert memory.ledger.live_bytes == live0 - 4800


def test_reshard_stage_fault_falls_back_too(tmp_path, restore_mesh):
    pm.set_mesh(_mesh(2, 2))
    data = np.arange(40 * 24.0).reshape(40, 24)
    a = rt.fromarray(data)
    np.asarray(a)
    with faults.active("reshard:stage:always"):
        res = elastic.live_reshape(_mesh(4, 1), manager=str(tmp_path),
                                   step=3, max_stage_bytes=1024)
    assert res["mode"] == "checkpoint"
    assert np.asarray(a).tobytes() == data.tobytes()
    assert elastic.CheckpointManager(str(tmp_path)).latest() == 3


def test_caches_after_a_reshape_serve_the_new_layout(monkeypatch,
                                                     restore_mesh):
    """A memoized result, a plan certificate and a compiled program made
    under the old mesh are not served after ``live_reshape``: the memo is
    dropped, certificates and the compile cache key on the mesh epoch."""
    monkeypatch.setenv("RAMBA_MEMO", "1")
    monkeypatch.setenv("RAMBA_PLANCERT", "1")
    memo.reset()
    plancache.reset()
    try:
        pm.set_mesh(_mesh(2, 2))
        x = rt.fromarray(np.arange(96.0).reshape(12, 8))
        np.asarray(x)
        want = float(np.sum(np.arange(96.0) * 2 + 1))
        assert [float(rt.sum(x * 2 + 1)) for _ in range(2)] == [want] * 2
        assert memo.cache.hits >= 1 and len(memo.cache) >= 1
        y = x * 3.0
        assert np.asarray(y).tobytes() == (np.arange(96.0) * 3.0).reshape(
            12, 8).tobytes()
        compiles0 = fuser.stats["compiles"]
        hits0 = memo.cache.hits
        epoch0 = pm.mesh_epoch
        elastic.live_reshape(_mesh(4, 1))
        assert pm.mesh_epoch > epoch0
        assert len(memo.cache) == 0  # dropped with the old layout
        assert float(rt.sum(x * 2 + 1)) == want
        assert memo.cache.hits == hits0  # recomputed, not served
        z = x * 3.0
        assert z.sharding.mesh == pm.get_mesh()
        assert np.asarray(z).tobytes() == np.asarray(y).tobytes()
        assert fuser.stats["compiles"] > compiles0  # the cache was emptied
        # the certificate made under the old mesh went stale on its epoch
        snap = plancache.snapshot()
        assert snap.get("stale", 0) >= 1
        assert snap["stale_causes"].get("mesh_epoch", 0) >= 1
    finally:
        memo.reset()
        plancache.reset()


def test_host_rung_under_an_armed_watchdog(monkeypatch, restore_mesh):
    """The host rung runs on the watchdog's helper thread; on a 2x2 mesh
    of shards it gives the fused rung's bytes."""
    pm.set_mesh(_mesh(2, 2))
    data = np.sin(np.arange(48 * 20.0)).reshape(48, 20)
    x = rt.fromarray(data)
    np.asarray(x)
    want = np.asarray(x * 2.0 + 1.0)
    monkeypatch.setenv("RAMBA_WATCHDOG_S", "30")
    faults.configure("oom:3:bytes=1,eager:once:oom")
    try:
        got = np.asarray(x * 2.0 + 1.0)
    finally:
        faults.configure(None)
    assert events.last(1, type="flush")[-1].get("degraded") == "host"
    assert got.tobytes() == want.tobytes()


def test_the_deadline_pool_under_contention():
    """16 threads make deadline calls at once, each on a helper thread of
    its own, every other call past a 20 ms deadline, with a short switch
    interval: each call returns its own value or raises a stall (every
    slow one stalls), and every abandoned call ends and is counted out."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    results, errors = [], []

    def caller(k):
        for i in range(12):
            slow = (k + i) % 2
            try:
                v = elastic.with_deadline(
                    "stress", lambda: (time.sleep(0.06) if slow else None,
                                       (k, i))[1], timeout_s=0.02)
                results.append((slow, v == (k, i)))
            except elastic.RankStallError:
                errors.append(slow)

    try:
        threads = [threading.Thread(target=caller, args=(k,))
                   for k in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(results) + len(errors) == 16 * 12
    assert all(ok for _slow, ok in results)  # never another call's value
    assert not any(slow for slow, _ok in results)  # a slow call never ends
    assert sum(errors) == 16 * 6                   # inside its deadline
    assert elastic.wait_abandoned(10)
    with elastic._abandoned_lock:
        assert elastic._abandoned[0] == 0
    assert not [th for th in threading.enumerate()
                if th.name == "ramba-deadline-stress"]


def test_with_deadline_carries_the_callers_thread_state(restore_mesh):
    """``common.device_scope`` and ``mesh.local_scope`` are per thread:
    the helper thread runs under the caller's."""
    pm.set_mesh(_mesh(2, 2))
    with common.device_scope("meta"), pm.local_scope():
        seen = elastic.with_deadline(
            "dispatch", lambda: (common.device(), pm.get_mesh().size,
                                 threading.current_thread().name),
            timeout_s=5.0)
    assert seen == (torch.device("meta"), 1, "ramba-deadline-dispatch")
    # the helper's scopes are its own: this thread's are restored
    assert common.device() == CPU and pm.get_mesh().size == 4


def _slow_first_call(monkeypatch, seconds):
    """The next program lowered sleeps ``seconds`` on its first call: an
    attempt that is still inside its launch when its deadline expires."""
    orig = fuser._lower
    armed = [True]

    def lower(program, leaf_vals, backend):
        fn = orig(program, leaf_vals, backend)

        def call(*a):
            if armed:
                armed.clear()
                time.sleep(seconds)
            return fn(*a)

        return call

    monkeypatch.setattr(fuser, "_lower", lower)


def _ledger_state():
    return {fp: (dict(e.rungs), e.compiles, e.bytes_accessed)
            for fp, e in ledger._kernels.items()}


def test_an_abandoned_attempt_commits_nothing(monkeypatch):
    """A seeded dispatch hang: the zombie wakes, stops before its rung,
    and the flush's result is the live rung's.  Then an attempt abandoned
    inside its launch (a rank's program, run as the rank flush runs it):
    when it wakes it records no execution or cost, fills no memo entry,
    certificate or span."""
    monkeypatch.setenv("RAMBA_WATCHDOG_S", "0.3")
    monkeypatch.setenv("RAMBA_MEMO", "1")
    monkeypatch.setenv("RAMBA_PERF", "on")
    ledger.reconfigure()
    memo.reset()
    try:
        x = rt.fromarray(np.arange(512.0))
        faults.configure("dispatch:hang:ms=900:after=0")
        y = x * 2.0 + 1.0
        got = np.asarray(y)
        faults.configure(None)
        state, n_memo = _ledger_state(), len(memo.cache)
        ab0 = registry.get("elastic.abandoned_commits")
        const = y._expr
        _zombies_done()
        assert registry.get("elastic.abandoned_commits") == ab0 + 1
        assert _ledger_state() == state and len(memo.cache) == n_memo
        assert y._expr is const and np.asarray(y).tobytes() == got.tobytes()
        assert got.tobytes() == (np.arange(512.0) * 2.0 + 1.0).tobytes()

        # abandoned inside its launch
        ledger.reset()
        memo.reset()
        program, leaf_vals = fuser.prepare_program([(x * 5.0 - 2.0)._expr])
        _slow_first_call(monkeypatch, 0.8)
        ab0 = registry.get("elastic.abandoned_commits")
        seen = []
        events.add_tap(seen.append)
        try:
            with pytest.raises(elastic.RankStallError):
                elastic.with_deadline(
                    "dispatch", lambda: fuser.run_program(program, leaf_vals,
                                                          rung="fused"),
                    timeout_s=0.2)
            state = _ledger_state()
            _zombies_done()
        finally:
            events.remove_tap(seen.append)
        assert registry.get("elastic.abandoned_commits") == ab0 + 1
        assert _ledger_state() == state
        assert all(sum(r.values()) == 0 for r, _c, _b in state.values())
        assert len(memo.cache) == 0
        assert not [e for e in seen if e.get("type") == "flush"]  # no span
        # the same program, live, commits as always
        out = fuser.run_program(program, leaf_vals, rung="fused")
        assert out[0].numpy().tobytes() == \
            (np.arange(512.0) * 5.0 - 2.0).tobytes()
        assert len(memo.cache) == 1
    finally:
        faults.configure(None)
        memo.reset()
        ledger.reset()
        monkeypatch.delenv("RAMBA_PERF")
        ledger.reconfigure()


def test_an_unarmed_flush_makes_no_thread_and_one_read(monkeypatch):
    """With the watchdog unset a flush starts no thread and reads its
    switch once; the bytes are those of an armed flush."""
    reads = []
    orig = elastic.watchdog_seconds

    def counted():
        reads.append(1)
        return orig()

    monkeypatch.setattr(fuser._elastic, "watchdog_seconds", counted)
    started = []
    orig_start = threading.Thread.start

    def start(self):
        started.append(self.name)
        return orig_start(self)

    monkeypatch.setattr(threading.Thread, "start", start)
    x = rt.fromarray(np.arange(1000.0))
    np.asarray(x)
    calls0 = registry.get("elastic.deadline_calls")
    s_off = float(rt.sum(x * 2.0 + 3.0))
    assert reads == [1]
    assert started == [] and registry.get("elastic.deadline_calls") == calls0
    monkeypatch.setenv("RAMBA_WATCHDOG_S", "30")
    s_on = float(rt.sum(x * 2.0 + 3.0))
    # one attempt, on a thread of its own
    assert registry.get("elastic.deadline_calls") == calls0 + 1
    assert started == ["ramba-deadline-dispatch"]
    assert s_on == s_off


def test_trace_report_reads_a_port_trace(tmp_path, monkeypatch):
    """A stall, heartbeats, a heartbeat miss, a checkpoint and a resume
    traced by the port: ``scripts/trace_report.py`` (unchanged) reads the
    lifecycle timeline and the liveness summary from it."""
    trace = tmp_path / "trace.jsonl"
    events.configure(str(trace))
    try:
        with pytest.raises(elastic.RankStallError):
            elastic.with_deadline("dispatch", lambda: time.sleep(0.5),
                                  timeout_s=0.05)
        elastic.start_heartbeat(0.03)
        time.sleep(0.1)
        faults.configure("heartbeat:hang:ms=300:after=0")
        time.sleep(0.2)
        elastic.check_heartbeat()
        faults.configure(None)
        elastic.stop_heartbeat()
        mgr = elastic.CheckpointManager(str(tmp_path / "ck"))
        mgr.save(4, {"x": rt.arange(8) * 1.0})
        elastic.resume(mgr)
        events.sync()
    finally:
        events.configure(None)
        _zombies_done()
    out = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "trace_report.py"),
         str(trace)], capture_output=True, text=True, timeout=60,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    text = out.stdout
    assert "lifecycle timeline" in text
    assert "STALL     dispatch" in text and "class=degrade" in text
    assert "heartbeat_missed" in text and "checkpoint_saved" in text
    assert "resume_complete" in text
    assert "checkpoints=1 resumes=1" in text
    assert "heartbeat" in text.split("lifecycle totals")[1]


def test_drain_to_checkpoint_quiesces_sessions(tmp_path):
    """A session's queued ticket and its still-pending work are drained
    before the save (``quiesce`` counts every live stream), and the
    restored state is the one NumPy gives."""
    from ramba_tpu_torch import serve

    root = _ck(tmp_path, "mgrs")
    try:
        with serve.Session(tenant="t0") as s:
            x = rt.arange(256) * 3.0
            s.flush()  # in flight through the pipeline
            y = x + 1.0
            d = elastic.drain_to_checkpoint(root, 5, {"y": y})
            assert not s.stream.inflight and not s.stream.pending_roots()
        mgr = elastic.CheckpointManager(root)
        assert mgr.latest() == 5 and os.path.isdir(d)
        res = elastic.resume(mgr)
        assert np.array_equal(np.asarray(res.state["y"]),
                              np.arange(256) * 3.0 + 1.0)
        done = [e for e in events.last(50, type="lifecycle")
                if e.get("step") == 5]
        assert [e["phase"] for e in done][:3] == [
            "drain_begin", "drain_complete", "checkpoint_saved"]
        assert done[1]["streams"] >= 2
    finally:
        serve.shutdown()
