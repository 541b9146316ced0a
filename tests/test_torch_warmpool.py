"""Program skeletons (``compile/persist.py``), the warm pool
(``compile/warmpool.py``) and autotune's race pre-warm
(``core/autotune.py::maybe_prewarm``), on the CPU.

ramba_tpu's AOT lane, warm start and warm pool are red on this image
(``tests/test_compile_classes.py``'s ``TestPersistCache``,
``TestWarmStart`` and ``TestWarmObservability``), so the port is held to
their stated contract and to NumPy: a fresh compile saves a skeleton that
rebuilds the same program and fingerprint; a skeleton whose statics do
not pickle counts ``store_errors`` and never raises; ``RAMBA_AOT=0`` keeps
the kernel libraries and turns the skeletons off; a corrupt skeleton or
entry is evicted, never raised (``compile:persist`` seeds it);
``save_topk`` writes the entries of the most executed programs and a
compile-cache miss finds them; a library another process built counts a
cross-writer hit, and its writer is checked with its digest; the warm
pool replays a trace's programs through ``submit_warm`` so the first real
flush of each is a compile-cache hit with NumPy's values, is shed by a
brownout and stops at its budget; and under ``RAMBA_AUTOTUNE=race`` with
a live pipeline a flush whose kernel libraries are still building runs
the generic lowering, named in its span, until the warm ticket ends, a
failed build raising from the next flush.  The CPU has no ``nvcc``:
library cases build with a stand-in compiler that copies a shared
library.  Values against NumPy exactly, but for sums (stated).
"""

import json
import os
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import _ctypes
import jax
import ramba_tpu_torch as rt
from ramba_tpu_torch import _build, common, serve
from ramba_tpu_torch.compile import persist, warmpool
from ramba_tpu_torch.core import autotune, fuser
from ramba_tpu_torch.observe import events, ledger, registry
from ramba_tpu_torch.ops import kernel_backend
from ramba_tpu_torch.resilience import faults
from ramba_tpu_torch.serve import overload
from ramba_tpu_torch.serve import pipeline as spipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARED_LIB = _ctypes.__file__  # any shared library stands in for a kernel


def _clear_compile_cache():
    with fuser._cache_lock:
        fuser._compile_cache.clear()


@pytest.fixture(autouse=True)
def _isolate(tmp_path, monkeypatch):
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    for k in ("RAMBA_AOT", "RAMBA_AUTOTUNE", "RAMBA_AUTOTUNE_CACHE",
              "RAMBA_TRACE", "RAMBA_FAULTS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("RAMBA_CACHE", str(tmp_path / "cache"))
    faults.configure(None)
    persist.reset()
    _clear_compile_cache()
    yield
    serve.shutdown()
    faults.reset()
    monkeypatch.delenv("RAMBA_CACHE", raising=False)
    monkeypatch.delenv("RAMBA_AUTOTUNE", raising=False)
    autotune.reconfigure()
    persist.reset()
    _clear_compile_cache()


@pytest.fixture
def fake_nvcc(monkeypatch):
    runs = []

    def run(cmd):
        out = cmd[cmd.index("-o") + 1]
        shutil.copyfile(SHARED_LIB, out)
        runs.append(out)
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_build, "_run_nvcc", run)
    monkeypatch.setattr(_build, "_libs", {})
    return runs


def _axpy_sum(n=1000, seed=0):
    r = np.random.RandomState(seed)
    xn, yn = r.rand(n), r.rand(n)
    x, y = rt.fromarray(xn), rt.fromarray(yn)
    z = 2.5 * x + y
    s = rt.sum(z)
    return (np.asarray(z), float(s)), (2.5 * xn + yn)


def _last_fp():
    return events.last(1, type="flush")[-1]["fingerprint"]


# -- skeletons -----------------------------------------------------------------


def test_fresh_compile_saves_a_skeleton_that_rebuilds_the_program():
    (z, s), want = _axpy_sum()
    np.testing.assert_array_equal(z, want)
    fp = _last_fp()
    assert fp in persist.saved_fingerprints()
    rec = persist.load_program(fp)
    assert rec["fp"] == fp and rec["donate"] == ()
    program = fuser._Program(rec["instrs"], rec["n_leaves"],
                             rec["leaf_kinds"], rec["out_slots"])
    vals = persist._example_vals(rec["sig"], rec["scalars"])
    assert persist.aval_sig(vals) == rec["sig"]
    assert [v for v in vals if not isinstance(v, torch.Tensor)] == [2.5]
    key = fuser._cache_key(program, vals, rec["compile_class"])
    assert ledger.fingerprint(key) == fp
    snap = persist.snapshot()
    assert snap["programs_saved"] >= 1 and snap["candidates"] >= 1
    assert snap["misses"] >= 1  # its compile-cache miss found no entry


def test_unpicklable_statics_count_store_errors_never_raise():
    def body(a):
        return a[-1, 0] + a[1, 0] + a[0, 0]

    st = rt.stencil(body)
    x = np.random.RandomState(1).rand(16, 16)
    e0 = persist.snapshot()["store_errors"]
    got = np.asarray(rt.sstencil(st, rt.fromarray(x)))
    want = np.zeros_like(x)
    want[1:-1, :] = x[:-2, :] + x[2:, :] + x[1:-1, :]
    np.testing.assert_allclose(got[1:-1, 1:-1], want[1:-1, 1:-1],
                               rtol=1e-15)
    assert persist.snapshot()["store_errors"] > e0


def test_aot_off_keeps_libraries_and_skips_skeletons(monkeypatch):
    monkeypatch.setenv("RAMBA_AOT", "0")
    persist.reset()
    assert persist.armed() and not persist.aot_armed()
    (z, _s), want = _axpy_sum()
    np.testing.assert_array_equal(z, want)
    assert persist.saved_fingerprints() == []
    assert persist.save_topk(8)["considered"] == 0
    assert _build.build_dir().endswith("kernels")


def test_corrupt_skeleton_is_evicted_never_raised():
    _axpy_sum()
    fp = _last_fp()
    path = os.path.join(persist.cache_dir(), "programs", f"{fp}.pkl")
    with open(path, "wb") as f:
        f.write(b"torn")
    c0 = persist.snapshot()["corrupt"]
    assert persist.load_program(fp) is None
    assert not os.path.exists(path)
    assert persist.snapshot()["corrupt"] == c0 + 1


def test_save_topk_writes_entries_and_a_miss_finds_them():
    ledger.reset()  # the ranking reads the process's ledger
    for seed in range(3):
        _axpy_sum(seed=seed)  # one program, three executions
    fp = _last_fp()
    np.asarray(rt.fromarray(np.arange(8.0)) * 3.0)
    rep = persist.save_topk(1)
    assert rep == {"considered": 1, "stored": 1, "skipped": 0, "errors": 0}
    assert os.listdir(os.path.join(persist.cache_dir(), "aot"))
    assert persist.save_topk(1)["skipped"] == 1
    _clear_compile_cache()
    h0, m0 = persist.snapshot()["entry_hits"], persist.snapshot()["misses"]
    (z, _s), want = _axpy_sum(seed=7)
    np.testing.assert_array_equal(z, want)
    assert _last_fp() == fp
    assert persist.snapshot()["entry_hits"] == h0 + 1
    assert persist.snapshot()["misses"] == m0


def test_compile_persist_fault_evicts_the_entry_and_the_flush_runs():
    _axpy_sum()
    assert persist.save_topk(4)["stored"] >= 1
    _clear_compile_cache()
    faults.configure("compile:persist:once")
    c0 = persist.snapshot()["corrupt"]
    (z, s), want = _axpy_sum(seed=3)
    np.testing.assert_array_equal(z, want)
    assert s == pytest.approx(float(want.sum()), rel=1e-13)  # fold order
    assert persist.snapshot()["corrupt"] == c0 + 1
    assert os.listdir(os.path.join(persist.cache_dir(), "aot")) == []


def test_an_entry_loads_its_libraries_without_a_build(fake_nvcc,
                                                      monkeypatch):
    src = "// a kernel source\n"
    monkeypatch.setattr(kernel_backend, "libraries",
                        lambda program, vals: [("k9", src)])
    _axpy_sum()
    assert persist.save_topk(1)["stored"] == 1
    assert len(fake_nvcc) == 1  # the entry's library, built once
    monkeypatch.setattr(_build, "_libs", {})
    _clear_compile_cache()
    h0 = persist.snapshot()["hits"]
    _axpy_sum(seed=2)
    assert _build.loaded(src) and len(fake_nvcc) == 1
    assert persist.snapshot()["hits"] == h0 + 1
    assert persist.snapshot()["cross_hits"] == 0  # this process built it
    # an entry whose library is gone is evicted, and the flush still runs
    os.unlink(_build.so_path("k9", src))
    monkeypatch.setattr(_build, "_libs", {})
    _clear_compile_cache()
    c0 = persist.snapshot()["corrupt"]
    (z, _s), want = _axpy_sum(seed=4)
    np.testing.assert_array_equal(z, want)
    assert persist.snapshot()["corrupt"] == c0 + 1


_OTHER_WRITER = """
import shutil, subprocess, sys
sys.path.insert(0, sys.argv[1])
from ramba_tpu_torch import _build
def run(cmd):
    shutil.copyfile(sys.argv[2], cmd[cmd.index("-o") + 1])
    return subprocess.CompletedProcess(cmd, 0, "", "")
_build.nvcc_path = lambda: "nvcc"
_build._run_nvcc = run
print(_build.build_so("k10", "// another writer's source\\n"))
"""


def test_a_library_another_process_built_is_a_cross_writer_hit(
        fake_nvcc, tmp_path):
    src = "// another writer's source\n"
    out = subprocess.run([sys.executable, "-c", _OTHER_WRITER, REPO,
                          SHARED_LIB], capture_output=True, text=True,
                         env=dict(os.environ), timeout=120)
    assert out.returncode == 0, out.stderr
    so = out.stdout.strip().splitlines()[-1]
    assert so == _build.so_path("k10", src)
    writer = _build.writer_of(so)
    assert writer["pid"] != os.getpid()
    h0, x0 = persist.snapshot()["hits"], persist.snapshot()["cross_hits"]
    c0 = registry.get("compile.persist_cross_hit")
    _build.load("k10", src)
    assert fake_nvcc == []  # loaded, never built
    assert persist.snapshot()["hits"] == h0 + 1
    assert persist.snapshot()["cross_hits"] == x0 + 1
    assert registry.get("compile.persist_cross_hit") == c0 + 1
    # the writer is checked with the digest: a forged writer evicts
    with open(so + ".sha", "rb") as f:
        raw = f.read()
    forged = raw.replace(str(writer["pid"]).encode(),
                         str(os.getpid()).encode())
    with open(so + ".sha", "wb") as f:
        f.write(forged)
    assert not _build.verified(so, "k10")
    assert not os.path.exists(so)


# -- the warm pool -------------------------------------------------------------


def _programs(seed=0):
    """Three programs of the main path's kinds at a small size: the
    sin/cos chain over a materialised base, axpy + sum, the hourly
    groupby sum."""
    r = np.random.RandomState(seed)
    n = 4096
    base = rt.fromarray(np.arange(n) / 1000.0)
    x, y = rt.fromarray(r.rand(n)), rt.fromarray(r.rand(n))
    hour = np.arange(n) % 24
    vals = r.rand(n)
    out = {}
    out["chain"] = float(rt.sum(rt.sin(base) * rt.sin(base)
                                + rt.cos(base) * rt.cos(base)))
    out["axpy"] = float(rt.sum(2.5 * x + y))
    out["hourly"] = np.asarray(rt.fromarray(vals).groupby(0, hour, 24).sum())
    b = np.arange(n) / 1000.0
    want = {"chain": float(np.sum(np.sin(b) ** 2 + np.cos(b) ** 2)),
            "axpy": float(np.sum(2.5 * np.asarray(x) + np.asarray(y))),
            "hourly": np.bincount(hour, vals, 24)}
    return out, want


def _trace(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    events.configure(path)
    try:
        _programs()
    finally:
        events.configure(None)
    return path


def test_compile_exports_match_ramba_tpu():
    import ramba_tpu.compile as jcompile
    import ramba_tpu.compile.warmpool as jwarmpool
    import ramba_tpu_torch.compile as tcompile

    assert tcompile.__all__ == jcompile.__all__
    assert tcompile.warmpool is warmpool
    public = lambda m: {n for n in dir(m)  # noqa: E731
                        if not n.startswith("_")}
    assert public(jwarmpool) <= public(warmpool)


def test_rank_trace_orders_by_arrivals_and_skips_junk(tmp_path):
    path = str(tmp_path / "t.jsonl")
    evs = ([{"type": "program", "fingerprint": "a"}] * 2
           + [{"type": "program", "fingerprint": "b",
               "compile_class": ["pow2", 64]}] * 3
           + [{"type": "program"}, {"type": "flush", "fingerprint": "c"}])
    with open(path, "w") as f:
        for e in evs:
            f.write(json.dumps(e) + "\n")
        f.write("not json\n\n")
    assert warmpool.rank_trace(path) == [("b", ("pow2", 64), 3),
                                         ("a", None, 2)]


def test_warm_pool_replays_a_trace_before_traffic(tmp_path):
    trace = _trace(tmp_path)
    ranked = warmpool.rank_trace(trace)
    assert len(ranked) >= 3
    _clear_compile_cache()  # a fresh process: nothing compiled
    ledger.reset()
    rep = warmpool.warm(trace, top_k=8)
    assert rep["considered"] == len(ranked)
    assert rep["submitted"] == rep["warmed"] == len(ranked)
    assert rep["failed"] == rep["shed"] == rep["unresolved"] == 0
    assert registry.get("compile.warmpool_submit") >= len(ranked)
    warm = sum(k.get("warm_compiles", 0)
               for k in ledger.snapshot()["kernels"].values())
    assert warm == len(ranked)
    # the first real flush of each program hits the compile cache
    seq0 = events.last(1)[-1]["seq"]
    got, want = _programs()
    spans = [e for e in events.last(0, type="flush") if e["seq"] > seq0]
    assert spans and all(c["cache"] == "hit"
                         for e in spans for c in e["calls"])
    np.testing.assert_allclose(got["hourly"], want["hourly"],
                               rtol=1e-13)  # fold order
    for k in ("chain", "axpy"):
        assert got[k] == pytest.approx(want[k], rel=1e-12)  # fold order


def test_warm_pool_counts_unresolved_and_stops_at_its_budget(tmp_path):
    trace = _trace(tmp_path)
    n = len(warmpool.rank_trace(trace))
    shutil.rmtree(os.path.join(persist.cache_dir(), "programs"))
    os.makedirs(os.path.join(persist.cache_dir(), "programs"))
    rep = warmpool.warm(trace, top_k=8)
    assert rep["unresolved"] == n and rep["submitted"] == 0
    rep = warmpool.warm(trace, top_k=8, budget_s=-1.0)
    assert rep["budget_stop"] == 1 and rep["submitted"] == 0
    assert warmpool.warm(trace, top_k=0)["considered"] == 0


def test_a_brownout_sheds_the_warm_work(tmp_path):
    trace = _trace(tmp_path)
    n = len(warmpool.rank_trace(trace))
    _clear_compile_cache()
    pipe = spipeline.get_pipeline()
    overload._brownout.update(queue_ratio=1.0, memory_frac=0.0,
                              breached=False)
    assert overload.brownout_state() == "red"
    s0 = registry.get("serve.warm_shed")
    rep = warmpool.warm(trace, top_k=8, pipeline=pipe)
    assert rep["submitted"] == rep["shed"] == n
    assert registry.get("serve.warm_shed") == s0 + n
    with fuser._cache_lock:
        assert not fuser._compile_cache  # nothing ran


def test_warmpool_cli_reports(tmp_path):
    trace = _trace(tmp_path)
    env = dict(os.environ, RAMBA_TORCH_DEVICE="cpu",
               RAMBA_CACHE=persist.cache_dir())
    out = subprocess.run([sys.executable,
                          os.path.join(REPO, "scripts", "warm_pool_torch.py"),
                          "--trace", trace, "--json"], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    assert rep["warmed"] == rep["submitted"] >= 3
    assert rep["unresolved"] == rep["failed"] == 0


# -- autotune's race pre-warm ---------------------------------------------------


@pytest.fixture
def race(monkeypatch):
    """RAMBA_AUTOTUNE=race with a live pipeline, and elemred's library
    reported unloaded until a warm ticket has launched the kernel."""
    monkeypatch.setenv("RAMBA_AUTOTUNE", "race")
    autotune.reconfigure()
    autotune.reset()
    ledger.reset()
    monkeypatch.setattr(kernel_backend, "libraries",
                        lambda program, vals: [("er", "src")])
    monkeypatch.setattr(_build, "loaded", lambda src: registry.get(
        "autotune.prewarm_done") > done0)
    done0 = registry.get("autotune.prewarm_done")
    return spipeline.get_pipeline()


def _wait_warm_tickets():
    for t in list(autotune._prewarm.values()):
        try:
            t.wait(60)
        except Exception:  # noqa: BLE001 — a failed ticket is read later
            pass


def _axpy_flush(seed):
    r = np.random.RandomState(seed)
    xn, yn = r.rand(512), r.rand(512)
    z = 2.5 * rt.fromarray(xn) + rt.fromarray(yn)
    s = rt.sum(z)
    fuser.flush()
    span = events.last(1, type="flush")[-1]
    return span, np.asarray(z), float(s), 2.5 * xn + yn


def test_race_prewarm_names_the_generic_route_until_the_warm_ends(
        race, monkeypatch):
    gate = threading.Event()
    real = persist._example_vals

    def held(sig, scalars=None):
        assert gate.wait(60)
        return real(sig, scalars)

    monkeypatch.setattr(persist, "_example_vals", held)
    served0 = registry.get("autotune.prewarm_served")
    span1, z1, s1, want1 = _axpy_flush(0)
    span2, z2, s2, want2 = _axpy_flush(1)  # the warm ticket still holds
    for span in (span1, span2):
        assert span["prewarm"] == span["fingerprint"]
        assert [c["backend"] for c in span["calls"]] == ["torch"]
    assert registry.get("autotune.prewarm_served") == served0 + 2
    assert registry.get("autotune.prewarm_submitted") >= 1
    gate.set()
    _wait_warm_tickets()
    span3, z3, s3, want3 = _axpy_flush(2)
    assert "prewarm" not in span3
    assert [c["backend"] for c in span3["calls"]] == ["kernel"]
    for z, want in ((z1, want1), (z2, want2), (z3, want3)):
        np.testing.assert_array_equal(z, want)
    for s, want in ((s1, want1), (s2, want2), (s3, want3)):
        assert s == pytest.approx(float(want.sum()), rel=1e-13)


def test_race_prewarm_failed_build_raises_from_the_next_flush(
        race, monkeypatch):
    def broken(sig, scalars=None):
        raise _build.KernelBuildError("nvcc failed for er (forged)")

    monkeypatch.setattr(persist, "_example_vals", broken)
    span1, z1, _s1, want1 = _axpy_flush(0)
    assert span1["prewarm"] == span1["fingerprint"]
    np.testing.assert_array_equal(z1, want1)
    _wait_warm_tickets()
    with pytest.raises(_build.KernelBuildError, match="forged"):
        _axpy_flush(1)


def test_no_prewarm_without_race_or_without_a_pipeline(monkeypatch):
    monkeypatch.setattr(kernel_backend, "libraries",
                        lambda program, vals: [("er", "src")])
    monkeypatch.setattr(_build, "loaded", lambda src: False)
    serve.shutdown()
    monkeypatch.setenv("RAMBA_AUTOTUNE", "race")
    autotune.reconfigure()
    span, z, _s, want = _axpy_flush(0)  # race, no pipeline
    assert "prewarm" not in span
    assert span["calls"][0]["backend"] == "kernel"
    monkeypatch.delenv("RAMBA_AUTOTUNE")
    autotune.reconfigure()
    spipeline.get_pipeline()
    span, z, _s, want = _axpy_flush(1)  # a pipeline, no race
    assert "prewarm" not in span
    assert span["calls"][0]["backend"] == "kernel"
    np.testing.assert_array_equal(z, want)
