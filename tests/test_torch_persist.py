"""The persistent kernel cache (``ramba_tpu_torch/compile/persist.py`` and
the digest checks and locks of ``ramba_tpu_torch/_build.py``).

ramba_tpu's AOT lane is red on this image (jax 0.9), so the port is held to
the contract ramba_tpu's docstrings and tests state
(``tests/test_compile_classes.py``'s ``TestPersistCache``,
``TestPersistInit`` and ``TestWarmStart``): the init status and its event,
a corrupt entry evicted and built again, never loaded, and a second
process with the same ``RAMBA_CACHE`` paying no build.  The port keeps
built kernel libraries, not executables (its program skeletons and
entries are ``tests/test_torch_warmpool.py``'s): a library
is checked against its digest before it loads, and a flipped byte (on
disk, or through the ``aot:blob`` flip seam) or a missing digest evicts it
and builds it again.  Builders of one source, threads or processes, take
its lock: one build, and a library always beside its own digest.  The CPU
has no ``nvcc``: those cases build with a stand-in compiler that copies a
shared library.  Values against NumPy exactly.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import _ctypes
import jax
import ramba_tpu_torch as rt
from ramba_tpu_torch import _build, common
from ramba_tpu_torch.compile import persist
from ramba_tpu_torch.core import fuser
from ramba_tpu_torch.observe import events, ledger, registry
from ramba_tpu_torch.resilience import faults

REPO = str(Path(__file__).resolve().parents[1])
SHARED_LIB = _ctypes.__file__  # any shared library stands in for a kernel


@pytest.fixture(autouse=True)
def _isolate():
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    torch.set_num_threads(1)
    saved = {"RAMBA_CACHE": os.environ.get("RAMBA_CACHE")}
    rt.sync()
    faults.configure(None)
    os.environ.pop("RAMBA_CACHE", None)
    persist.reset()
    yield
    faults.reset()
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    persist.reset()
    assert _build.build_dir() == _build.BUILD_DIR or persist.armed()


@pytest.fixture
def armed(tmp_path, monkeypatch):
    d = str(tmp_path / "cache")
    monkeypatch.setenv("RAMBA_CACHE", d)
    persist.reconfigure()
    assert persist.armed(), persist.snapshot()
    with fuser._cache_lock:
        fuser._compile_cache.clear()
    return d


@pytest.fixture
def fake_nvcc(monkeypatch):
    """A compiler that copies a shared library to the ``-o`` path."""
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


# -- init ----------------------------------------------------------------------


def test_disarmed_without_a_cache_dir():
    assert not persist.armed()
    assert persist.snapshot()["dir"] is None
    assert _build.build_dir() == _build.BUILD_DIR


def test_cache_status_fields_and_event(tmp_path, monkeypatch):
    d = str(tmp_path / "xc")
    monkeypatch.setenv("RAMBA_CACHE", d)
    st = common.setup_persistent_cache()
    assert st.ok and st.enabled and st.path == d and st.error is None
    ev = events.last(3, type="compile.persist_init")
    assert ev and ev[-1]["path"] == d and ev[-1]["ok"]
    assert persist.armed() and persist.cache_dir() == d
    assert os.path.exists(os.path.join(d, ".ramba_cache"))
    assert _build.build_dir() == os.path.join(d, "kernels")


def test_disabled_status_is_ok(monkeypatch):
    monkeypatch.delenv("RAMBA_CACHE", raising=False)
    monkeypatch.setattr(common, "cache_env", None)
    st = common.setup_persistent_cache()
    assert st.path is None and st.ok and not st.enabled


def test_ramba_cache_1_is_a_directory_of_the_ports_own(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("RAMBA_CACHE", "1")
    assert common.persistent_cache_path() == str(
        tmp_path / ".ramba_tpu_torch_cache")


def test_an_unusable_dir_disarms_and_reports(tmp_path, monkeypatch):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    monkeypatch.setenv("RAMBA_CACHE", str(blocker / "sub"))
    st = common.setup_persistent_cache()
    assert not st.ok and st.error
    assert not persist.armed()


def test_reconfigure_moves_the_build_dir_and_back(tmp_path):
    persist.reconfigure(str(tmp_path / "c"))
    assert persist.armed()
    assert _build.build_dir() == str(tmp_path / "c" / "kernels")
    assert os.path.isdir(_build.build_dir())
    # the skeleton lane's directories sit beside the libraries
    assert os.path.isdir(tmp_path / "c" / "programs")
    assert os.path.isdir(tmp_path / "c" / "aot")
    persist.reconfigure()
    assert not persist.armed()
    assert _build.build_dir() == _build.BUILD_DIR


# -- kernel libraries ----------------------------------------------------------


def test_a_build_lands_in_the_cache_with_its_digest(armed, fake_nvcc):
    b0 = _build.nvcc_builds
    lib = _build.load("k1", "// source one")
    assert lib is not None and _build.nvcc_builds == b0 + 1
    so = _build.so_path("k1", "// source one")
    assert os.path.dirname(so) == os.path.join(armed, "kernels")
    assert os.path.exists(so) and os.path.exists(so + ".sha")
    assert _build.verified(so, "k1")
    assert registry.get("compile.nvcc_builds") >= 1


def test_a_library_on_disk_loads_without_a_build(armed, fake_nvcc,
                                                  monkeypatch):
    _build.load("k2", "// source two")
    monkeypatch.setattr(_build, "_libs", {})  # as a second process
    b0, l0 = _build.counts()
    _build.load("k2", "// source two")
    assert _build.counts() == (b0, l0 + 1)
    assert len(fake_nvcc) == 1


def _replace_with(so, data):
    """Damage a library as another writer would: the damaged bytes go to
    a new file beside it, put in place with ``os.replace`` (a new inode).
    Writing over the file in place would change the pages this process
    mapped when it loaded the library, and the loader faults at exit."""
    tmp = so + ".damaged"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, so)


@pytest.mark.parametrize("damage", ["flip_on_disk", "truncate",
                                    "lost_digest", "flip_seam"])
def test_a_corrupt_library_is_evicted_and_built_again(armed, fake_nvcc,
                                                      monkeypatch, damage):
    src = "// source " + damage
    _build.load("k3", src)
    so = _build.so_path("k3", src)
    if damage == "flip_on_disk":
        raw = bytearray(open(so, "rb").read())
        raw[100] ^= 0xFF
        _replace_with(so, bytes(raw))
    elif damage == "truncate":
        raw = open(so, "rb").read()
        _replace_with(so, raw[: len(raw) // 3])
    elif damage == "lost_digest":
        os.unlink(so + ".sha")
    monkeypatch.setattr(_build, "_libs", {})
    c0, b0 = persist.snapshot()["corrupt"], _build.nvcc_builds
    if damage == "flip_seam":
        with faults.active("aot:blob:flip:bytes=4"):
            _build.load("k3", src)
    else:
        _build.load("k3", src)
    assert persist.snapshot()["corrupt"] == c0 + 1
    assert _build.nvcc_builds == b0 + 1  # evicted, then built again
    assert _build.verified(so, "k3")
    ev = events.last(1, type="integrity")[-1]
    assert ev["site"] == "aot:blob" and ev["lib"] == "k3"


def test_a_failed_build_raises_with_the_compilers_output(armed,
                                                         monkeypatch):
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_build, "_run_nvcc", lambda cmd: (
        subprocess.CompletedProcess(cmd, 1, "", "error: no such thing")))
    with pytest.raises(RuntimeError, match="no such thing"):
        _build.build_so("k4", "// broken")
    assert not os.path.exists(_build.so_path("k4", "// broken"))


@pytest.mark.parametrize("cache", ["armed", "disarmed"])
def test_a_library_loaded_from_the_cache_counts_a_persist_hit(
        tmp_path, monkeypatch, fake_nvcc, cache):
    if cache == "armed":
        monkeypatch.setenv("RAMBA_CACHE", str(tmp_path / "c"))
    persist.reconfigure()
    if cache == "disarmed":
        monkeypatch.setattr(_build, "_build_dir", str(tmp_path / "b"))
    _build.load("k5", "// source five")
    assert persist.snapshot()["hits"] == 0  # this process built it
    monkeypatch.setattr(_build, "_libs", {})  # as a second process
    r0 = registry.get("compile.persist_hit")
    _build.load("k5", "// source five")
    want = 1 if cache == "armed" else 0
    assert persist.snapshot()["hits"] == want
    assert registry.get("compile.persist_hit") == r0 + want
    assert len(fake_nvcc) == 1


@pytest.mark.parametrize("damage", ["flip_on_disk", "truncate"])
def test_ctypes_opens_only_a_verified_library(armed, fake_nvcc, monkeypatch,
                                              damage):
    src = "// source six " + damage
    _build.load("k6", src)
    so = _build.so_path("k6", src)
    raw = bytearray(open(so, "rb").read())
    if damage == "flip_on_disk":
        raw[200] ^= 0xFF
    else:
        raw = raw[: len(raw) // 2]
    _replace_with(so, bytes(raw))
    opened = []
    real = ctypes.CDLL

    def cdll(path, *a, **k):
        opened.append(_build.verified(path, "k6"))
        return real(path, *a, **k)

    monkeypatch.setattr(_build.ctypes, "CDLL", cdll)
    monkeypatch.setattr(_build, "_libs", {})
    _build.load("k6", src)
    assert opened == [True]
    assert persist.snapshot()["corrupt"] == 1


def _tagged_nvcc(monkeypatch, wait_s: float):
    """A stand-in compiler whose every run writes different bytes (the
    library with its run number appended, as nvcc's temporary names get
    into its output) and waits up to ``wait_s`` for a second run to
    start beside it."""
    runs = []
    lock = threading.Lock()
    other = threading.Event()

    def run(cmd):
        with lock:
            runs.append(cmd)
            k = len(runs)
            if k > 1:
                other.set()
        other.wait(wait_s)
        out = cmd[cmd.index("-o") + 1]
        shutil.copyfile(SHARED_LIB, out)
        with open(out, "ab") as f:
            f.write(b"run %d" % k)
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_build, "_run_nvcc", run)
    monkeypatch.setattr(_build, "_libs", {})
    return runs


@pytest.mark.parametrize("builders", [2, 4])
def test_builders_of_one_source_leave_one_matching_pair(armed, monkeypatch,
                                                       builders):
    runs = _tagged_nvcc(monkeypatch, wait_s=0.5)
    src = f"// source seven, {builders} builders"
    go = threading.Barrier(builders)
    errors, libs = [], []

    def build():
        try:
            go.wait()
            libs.append(_build.load("k7", src))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(builders)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    assert len(libs) == builders and all(lib is libs[0] for lib in libs)
    assert len(runs) == 1  # the others waited on the lock, then loaded
    assert _build.verified(_build.so_path("k7", src), "k7")
    assert persist.snapshot()["corrupt"] == 0


_BUILDER = """
import json, shutil, subprocess, sys, time
import _ctypes
from ramba_tpu_torch import _build
from ramba_tpu_torch.compile import persist
assert persist.armed()
def run(cmd):
    time.sleep(0.5)
    out = cmd[cmd.index("-o") + 1]
    shutil.copyfile(_ctypes.__file__, out)
    with open(out, "ab") as f:
        f.write(sys.argv[1].encode())
    return subprocess.CompletedProcess(cmd, 0, "", "")
_build.nvcc_path = lambda: "nvcc"
_build._run_nvcc = run
while time.time() < float(sys.argv[2]):
    time.sleep(0.005)
_build.load("k8", "// source eight")
so = _build.so_path("k8", "// source eight")
print(json.dumps({"builds": _build.nvcc_builds, "loads": _build.disk_loads,
                  "corrupt": persist.snapshot()["corrupt"],
                  "verified": _build.verified(so, "k8")}))
"""


def test_two_processes_building_one_source_build_it_once(tmp_path):
    import time

    env = dict(os.environ, RAMBA_TORCH_DEVICE="cpu", PYTHONPATH=REPO,
               RAMBA_CACHE=str(tmp_path / "cache"), OMP_NUM_THREADS="1")
    env.pop("RAMBA_FAULTS", None)
    start = str(time.time() + 8.0)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILDER, tag, start],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=REPO, env=env)
             for tag in ("process a", "process b")]
    reps = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-2000:]
        reps.append(json.loads(out.strip().splitlines()[-1]))
    assert sorted(r["builds"] for r in reps) == [0, 1], reps
    assert sorted(r["loads"] for r in reps) == [0, 1], reps
    assert all(r["corrupt"] == 0 and r["verified"] for r in reps), reps


# -- a second process ------------------------------------------------------------


_CHILD = """
import json, shutil, subprocess, sys
import _ctypes
import numpy as np
import ramba_tpu_torch as rt
from ramba_tpu_torch import _build, common
from ramba_tpu_torch.compile import classes, persist
from ramba_tpu_torch.observe import ledger
def nvcc(cmd):
    shutil.copyfile(_ctypes.__file__, cmd[cmd.index("-o") + 1])
    return subprocess.CompletedProcess(cmd, 0, "", "")
_build.nvcc_path = lambda: "nvcc"
_build._run_nvcc = nvcc
assert classes.enabled()
assert common.setup_persistent_cache().ok and persist.armed()
for k in ("a", "b"):
    _build.load("k_" + k, "// kernel " + k)
base = np.arange(48, dtype=np.float32).reshape(6, 8)
vec = np.arange(300.0) / 7.0
got = np.asarray(rt.array(base) * 2.0 + 1.0)
assert np.array_equal(got, base * 2.0 + 1.0)
got = np.asarray(rt.fromarray(vec) * 3.0 - 1.0)
assert np.array_equal(got, vec * 3.0 - 1.0)
t = ledger.totals()
print(json.dumps({"builds": _build.nvcc_builds, "hits":
                  persist.snapshot()["hits"], "compiles": t["compiles"],
                  "nvcc_s": t["by_source"]["nvcc"]}))
"""


def test_second_process_pays_zero_compiles(tmp_path):
    """The contract of ramba_tpu's red ``test_second_process_pays_zero_
    compiles`` in the port's terms: a second process on the same
    RAMBA_CACHE runs no kernel build (the costly compile here) and loads
    every library from the cache."""
    env = dict(os.environ, RAMBA_TORCH_DEVICE="cpu",
               RAMBA_COMPILE_CLASSES="pow2",
               RAMBA_CACHE=str(tmp_path / "cache"), PYTHONPATH=REPO,
               OMP_NUM_THREADS="1")
    for k in ("RAMBA_FAULTS", "RAMBA_TRACE", "RAMBA_PERF", "RAMBA_AUTOTUNE"):
        env.pop(k, None)
    reports = {}
    for phase in ("cold", "warm"):
        r = subprocess.run([sys.executable, "-c", _CHILD, phase],
                           capture_output=True, text=True, timeout=240,
                           cwd=REPO, env=env)
        assert r.returncode == 0, (phase, r.stderr[-2000:])
        reports[phase] = json.loads(r.stdout.strip().splitlines()[-1])
    assert reports["cold"]["builds"] == 2 and reports["cold"]["hits"] == 0
    assert reports["warm"]["builds"] == 0, reports
    assert reports["warm"]["hits"] == 2, reports
    assert reports["warm"]["nvcc_s"] == 0.0, reports
    # each process plans its two programs (a plan, not a build)
    assert reports["warm"]["compiles"] == reports["cold"]["compiles"] >= 2
