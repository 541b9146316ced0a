"""The measured backend race (``ramba_tpu_torch/core/autotune.py``).

Held against ramba_tpu's autotuner on its mode table (its ``xla`` is the
port's ``torch``, its ``pallas`` the port's ``kernel``), and to the
contract ramba_tpu's tests state (``tests/test_autotune.py``): on a fake
ledger the faster backend latches after K samples each; a program the
classifier turns away never races; the decision table round-trips and a
later process skips the race.  The port's own rules: an unknown mode
raises, a kernel error during a race raises (no fallback), every rank
latches rank 0's winner (a gloo world of 2).  Values against NumPy:
float64 elementwise results exactly, sums within n * eps * sum|x|.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import ramba_tpu_torch as rt
from ramba_tpu.core import autotune as jautotune
from ramba_tpu_torch import common
from ramba_tpu_torch.core import autotune, fuser
from ramba_tpu_torch.observe import ledger, registry
from ramba_tpu_torch.ops import kernel_backend

EPS64 = 2.0 ** -52
WORKER = str(Path(__file__).resolve().parent / "torch_dist_worker.py")
NAMES = {"xla": "torch", "pallas": "kernel"}


@pytest.fixture(autouse=True)
def clean_autotune():
    """Autotune state pristine whatever the ambient environment says;
    the environment's configuration back afterwards."""
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    torch.set_num_threads(1)
    rt.sync()
    saved = {k: os.environ.pop(k, None) for k in
             ("RAMBA_AUTOTUNE", "RAMBA_AUTOTUNE_K", "RAMBA_AUTOTUNE_CACHE")}
    autotune.reconfigure()
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    autotune.reconfigure()


def _seed_exec(fp, backend, seconds, n=1):
    for _ in range(n):
        ledger.record_execute(fp, "fake", 1, "fused", seconds,
                              is_new=False, backend=backend)


@pytest.mark.parametrize("raw", ["", "0", "off", "false", "no", "race", "1",
                                 "on", "true", "yes", "force:pallas",
                                 "force:xla", "RACE", " on "])
def test_mode_table_matches_ramba_tpu(raw):
    jautotune.reconfigure(mode=raw)
    try:
        want = jautotune.mode()
        want_forced = jautotune._forced
    finally:
        jautotune.reconfigure()
    port_raw = raw.replace("pallas", "kernel").replace("xla", "torch")
    autotune.reconfigure(mode=port_raw)
    assert autotune.mode() == want
    assert autotune._forced == NAMES.get(want_forced)
    assert autotune.active() == (want != "off")


@pytest.mark.parametrize("raw", ["garbage", "force:xla", "force:pallas",
                                 "force:"])
def test_an_unknown_mode_raises(raw):
    with pytest.raises(ValueError):
        autotune.reconfigure(mode=raw)


@pytest.mark.parametrize("raw", ["race", "1", "on"])
def test_race_env_values_run_a_flush(raw, monkeypatch):
    """``RAMBA_AUTOTUNE=race|1|on`` is a documented switch of ramba_tpu;
    the port raised on it before the race was ported."""
    monkeypatch.setenv("RAMBA_AUTOTUNE", raw)
    autotune.reconfigure()
    assert autotune.mode() == "race"
    xn = np.random.default_rng(4).random(3000)
    x = rt.fromarray(xn)
    for _ in range(3):
        z = x * 2.5 + 1.0
        np.testing.assert_array_equal(z.asarray(), xn * 2.5 + 1.0)
        s = float(rt.sum(z))
        assert abs(s - float(np.sum(xn * 2.5 + 1.0))) <= \
            3000 * EPS64 * float(np.sum(np.abs(xn * 2.5 + 1.0)))


def test_off_mode_follows_the_classifier():
    x = rt.fromarray(np.arange(8.0))
    p, vals = fuser.prepare_program([(x * 2.0)._expr])
    assert autotune.select("fp-off", p, vals) == ("kernel", "default")
    p2, vals2 = fuser.prepare_program([rt.arange(8.0)._expr])
    assert autotune.select("fp-off2", p2, vals2) == ("torch", "default")


def test_force_modes(monkeypatch):
    monkeypatch.setattr(kernel_backend, "supports", lambda *a: True)
    autotune.reconfigure(mode="force:kernel")
    assert autotune.select("fp-f1", None, []) == ("kernel", "forced")
    autotune.reconfigure(mode="force:torch")
    assert autotune.select("fp-f1", None, []) == ("torch", "forced")
    # a program the kernels cannot take is never forced onto them
    monkeypatch.setattr(kernel_backend, "supports", lambda *a: False)
    autotune.reconfigure(mode="force:kernel")
    assert autotune.select("fp-f2", None, []) == ("torch", "default")


def test_fake_ledger_race_latches_the_faster_backend(monkeypatch):
    autotune.reconfigure(mode="race", k=2)
    monkeypatch.setattr(kernel_backend, "supports", lambda *a: True)
    fp = "fp-race-kernel-wins"
    before = registry.get("autotune.race_started")
    assert autotune.select(fp, None, []) == ("kernel", "racing")
    assert registry.get("autotune.race_started") == before + 1
    _seed_exec(fp, "kernel", 0.001, n=2)
    assert autotune.select(fp, None, []) == ("torch", "racing")
    _seed_exec(fp, "torch", 0.005, n=2)
    l0 = registry.get("autotune.latched")
    assert autotune.select(fp, None, []) == ("kernel", "autotune")
    assert registry.get("autotune.latched") == l0 + 1
    assert autotune.decision(fp) == {"backend": "kernel", "via": "autotune"}
    _seed_exec(fp, "torch", 0.0001, n=10)  # latched decisions stick
    assert autotune.select(fp, None, []) == ("kernel", "autotune")
    assert registry.get("autotune.race_started") == before + 1


def test_fake_ledger_race_torch_wins(monkeypatch):
    autotune.reconfigure(mode="race", k=1)
    monkeypatch.setattr(kernel_backend, "supports", lambda *a: True)
    fp = "fp-race-torch-wins"
    _seed_exec(fp, "kernel", 0.004)
    _seed_exec(fp, "torch", 0.002)
    assert autotune.select(fp, None, []) == ("torch", "autotune")
    rep = autotune.report()
    assert rep["races_latched"] >= 1 and rep["race_overhead_s"] >= 0.004
    g = autotune.generation()
    autotune.reset()
    assert autotune.generation() > g and autotune.decision(fp) is None


def test_unsupported_program_never_races(monkeypatch):
    autotune.reconfigure(mode="race", k=1)
    monkeypatch.setattr(kernel_backend, "supports", lambda *a: False)
    before = registry.get("autotune.race_started")
    assert autotune.select("fp-unsup", None, []) == ("torch", "default")
    assert registry.get("autotune.race_started") == before


def test_decision_table_roundtrip_skips_the_race(tmp_path, monkeypatch):
    cache = str(tmp_path / "autotune.json")
    monkeypatch.setattr(kernel_backend, "supports", lambda *a: True)
    autotune.reconfigure(mode="race", k=1, cache_path=cache)
    fp = "fp-persist"
    _seed_exec(fp, "kernel", 0.001)
    _seed_exec(fp, "torch", 0.005)
    assert autotune.select(fp, None, []) == ("kernel", "autotune")
    with open(cache) as f:
        assert json.load(f)["decisions"][fp]["backend"] == "kernel"
    # a restart: fresh in-memory state, the same table
    started = registry.get("autotune.race_started")
    skipped = registry.get("autotune.race_skipped")
    loaded = registry.get("autotune.table_loaded_decisions")
    autotune.reconfigure(mode="race", k=1, cache_path=cache)
    assert autotune.decision(fp) is None  # the table loads lazily
    assert autotune.select(fp, None, []) == ("kernel", "persisted")
    assert autotune.select(fp, None, []) == ("kernel", "persisted")
    assert registry.get("autotune.race_started") == started
    assert registry.get("autotune.race_skipped") == skipped + 1
    assert registry.get("autotune.table_loaded_decisions") == loaded + 1


def test_missing_or_broken_table_is_not_an_error(tmp_path, monkeypatch):
    monkeypatch.setattr(kernel_backend, "supports", lambda *a: True)
    autotune.reconfigure(mode="race", k=1,
                         cache_path=str(tmp_path / "nope.json"))
    assert autotune.select("fp-nocache", None, []) == ("kernel", "racing")
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    autotune.reconfigure(mode="race", k=1, cache_path=str(bad))
    assert autotune.select("fp-bad", None, []) == ("kernel", "racing")


def test_a_real_race_alternates_latches_and_keeps_the_bytes():
    """Through real flushes on the CPU: both lowerings gather K samples in
    their ledger slices, the race latches, every result equals NumPy."""
    autotune.reconfigure(mode="race", k=2)
    xn = np.random.default_rng(9).random(4096)
    x = rt.fromarray(xn)
    for _ in range(7):
        np.testing.assert_array_equal((x * 3.0 - 0.5).asarray(),
                                      xn * 3.0 - 0.5)
    p, vals = fuser.prepare_program([(x * 3.0 - 0.5)._expr])
    fp = ledger.fingerprint(fuser._cache_key(p, vals))
    st = ledger.backend_stats(fp)
    assert st["kernel"]["count"] >= 2 and st["torch"]["count"] >= 2
    d = autotune.decision(fp)
    assert d is not None and d["via"] == "autotune"
    assert d["backend"] in ("kernel", "torch")


def test_a_kernel_error_during_a_race_raises(monkeypatch):
    autotune.reconfigure(mode="race", k=2)
    fam = kernel_backend.family("elemred")

    def boom(program, vals):
        raise RuntimeError("elemred kernel launch failed: CUDA error 700")

    monkeypatch.setattr(fam, "run", boom)
    x = rt.fromarray(np.arange(100.0))
    y = x * 7.0 + 2.0
    q0 = fuser.stats["quarantined"]
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        y.asarray()
    assert fuser.stats["quarantined"] == q0 + 1
    p, vals = fuser.prepare_program([(x * 7.0 + 2.0)._expr])
    # no fallback decision was latched: the race stays open
    assert autotune.decision(ledger.fingerprint(fuser._cache_key(p, vals))) \
        is None


def test_every_rank_latches_rank_0s_winner(tmp_path):
    """A gloo world of 2: rank 0's evidence says the kernel wins, rank 1's
    says it loses; both latch the kernel, through coherence rounds, and
    both make the same class decisions."""
    outdir = tmp_path / "out"
    outdir.mkdir()
    env = dict(os.environ, RAMBA_TORCH_DEVICE="cpu",
               RAMBA_INIT_TIMEOUT_S="60", OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo", RAMBA_COMPILE_CLASSES="pow2")
    env.pop("RAMBA_FAULTS", None)
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), "2", str(tmp_path / "store"),
         str(outdir), "compile"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)
    info = [json.loads((outdir / f"rank{r}.json").read_text())
            for r in range(2)]
    assert info[0]["decisions"] and \
        info[0]["decisions"] == info[1]["decisions"]
    assert set(info[0]["decisions"].values()) == {"kernel"}
    assert info[0]["rounds"] == info[1]["rounds"] >= 1
    assert info[0]["classes"] == info[1]["classes"]
    assert ["pow2", 128] in info[0]["classes"].values()
    want = float(np.sum(np.arange(1000.0) * 2.0 + 1.0))
    assert all(s == want for s in info[0]["sums"] + info[1]["sums"])
    for r in range(2):
        z = np.load(outdir / f"rank{r}.npz")["z"]
        assert z.dtype == np.int16
        np.testing.assert_array_equal(
            z, np.arange(200, dtype=np.int16) * 3 - 1)


def test_samples_taken_outside_a_race_are_no_evidence():
    """Flushes run before the race (dispatch walls) leave the backend
    slices empty: the race latches on its own device-time samples only."""
    xn = np.random.default_rng(5).random(2048)
    x = rt.fromarray(xn)
    for _ in range(5):
        (x * 4.0 - 0.25).asarray()
    p, vals = fuser.prepare_program([(x * 4.0 - 0.25)._expr])
    fp = ledger.fingerprint(fuser._cache_key(p, vals))
    assert all(s["count"] == 0 for s in ledger.backend_stats(fp).values())
    autotune.reconfigure(mode="race", k=2)
    runs = 0
    while autotune.decision(fp) is None:
        np.testing.assert_array_equal((x * 4.0 - 0.25).asarray(),
                                      xn * 4.0 - 0.25)
        runs += 1
        assert runs < 10
    st = ledger.backend_stats(fp)
    assert runs >= 4 and st["kernel"]["count"] >= 2 \
        and st["torch"]["count"] >= 2
