"""The timing names, ``profiler_trace``/``annotate``, ``RAMBA_PROFILE_DIR``
and ``jit``/``remote``/``get`` of the port against ramba_tpu, x64
regime, on the CPU.

The same calls through both packages' timers give the same
``get_timing()`` and ``get_timing_str`` (nested parents, orphans,
counts); ``timing_summary`` and ``print_comm_stats`` print; the
package-level names ramba_tpu exports exist in the port; a flush files
its first call and its later calls under ramba_tpu's timer names;
``profiler_trace`` writes a Chrome trace holding the flush's
``ramba_flush:<label>`` range (CPU activity here: the card's kernels are
in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``);
``RAMBA_PROFILE_DIR`` starts one profiler at the first flush and exports
it at exit; ``jit`` values equal ``ramba_tpu.jit``'s for the same
functions on the same inputs, a keyword raises ``TypeError``; ``remote``
runs functions and actors on a pool and ``get`` resolves them.
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
from ramba_tpu.utils import timing as jtiming
from ramba_tpu_torch import common
from ramba_tpu_torch.observe import profile
from ramba_tpu_torch.utils import timing

REPO = Path(__file__).resolve().parents[1]

NAMES = ("add_sub_time", "add_time", "annotate", "get_timing",
         "get_timing_str", "print_comm_stats", "profiler_trace",
         "reset_timing", "time_dict", "timing_summary", "timing",
         "diagnostics", "debug", "jit", "remote", "get", "observe")


@pytest.fixture(autouse=True)
def _clean():
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    for t in (timing, jtiming):
        t.reset()
    yield
    for t in (timing, jtiming):
        t.reset()


@pytest.mark.parametrize("name", NAMES)
def test_top_level_names(name):
    assert hasattr(rtj, name)
    assert hasattr(rt, name), name


def _feed(t):
    t.add_time("alpha", 1.5)
    t.add_time("alpha", 0.25)
    t.add_sub_time("alpha", "inner", 0.5)
    t.add_sub_time("orphan", "child", 0.125)
    t.add_func_time("prog_x", 0.75)
    with t.timer("beta"):
        pass
    with t.timer("gamma", parent="beta"):
        pass


@pytest.mark.parametrize("details", [False, True])
def test_timers_equal_ramba_tpu(details):
    for t in (timing, jtiming):
        _feed(t)
    a, b = timing.get_timing(), jtiming.get_timing()
    for key in ("timers", "sub_timers", "per_func"):
        assert set(a[key]) == set(b[key]), key
        for k in a[key]:
            assert a[key][k][1] == b[key][k][1], (key, k)
    assert a["timers"]["alpha"] == b["timers"]["alpha"] == (1.75, 2)
    strip = lambda s: [ln.split(":")[0] for ln in s.splitlines()]  # noqa: E731
    assert strip(timing.get_timing_str(details)) == strip(
        jtiming.get_timing_str(details))


def test_timing_summary_and_comm_stats_print():
    _feed(timing)
    timing.note_transfer("host_to_device", 4096)
    buf = io.StringIO()
    timing.timing_summary(file=buf)
    text = buf.getvalue()
    assert "timing summary" in text and "alpha" in text and "orphan" in text
    assert "-- per fused program --" in text
    buf = io.StringIO()
    rt.print_comm_stats(file=buf)
    assert "4,096 B" in buf.getvalue()
    rt.reset_timing()
    assert rt.get_timing() == {"timers": {}, "sub_timers": {},
                               "per_func": {}}


def test_flushes_file_under_ramba_tpus_timer_names():
    x = rt.fromarray(np.arange(777.0))
    for _ in range(3):
        float(rt.sum(x * 3.0))
    t = rt.get_timing()["timers"]
    assert t["trace_compile_first_call"][1] == 1
    assert t["flush_execute"][1] == 2
    assert rt.time_dict is timing.time_dict


def _trace_names(path):
    doc = json.loads(Path(path).read_text())
    evs = doc["traceEvents"] if isinstance(doc, dict) else doc
    return [e.get("name", "") for e in evs]


def test_profiler_trace_records_the_flush_range(tmp_path, monkeypatch):
    monkeypatch.setenv("RAMBA_PROFILE", "deep")  # flush ranges on
    profile.reconfigure()
    try:
        x = rt.fromarray(np.arange(1000.0))
        with rt.profiler_trace(str(tmp_path)):
            with rt.annotate("outer_region"):
                float(rt.sum(x * 2.0 + 1.0))
    finally:
        monkeypatch.delenv("RAMBA_PROFILE")
        profile.reconfigure()
    files = sorted(tmp_path.glob("trace_*.json"))
    assert len(files) == 1
    names = _trace_names(files[0])
    assert "outer_region" in names
    assert any(n.startswith("ramba_flush:prog_") for n in names), names[:50]


def test_profile_dir_starts_at_the_first_flush_and_exports_at_exit(tmp_path):
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import ramba_tpu_torch as rt;"
            "from ramba_tpu_torch.observe import profile;"
            "assert not profile.started();"
            "float(rt.sum(rt.arange(64) * 2.0));"
            "assert profile.started()")
    env = dict(os.environ, RAMBA_TORCH_DEVICE="cpu",
               RAMBA_PROFILE_DIR=str(tmp_path))
    r = subprocess.run([sys.executable, "-c", code, str(REPO)], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    files = list(tmp_path.glob("ramba_trace_*.json"))
    assert len(files) == 1
    assert any(n.startswith("ramba_flush:") for n in _trace_names(files[0]))


def test_profile_stop_without_start_is_none():
    assert not profile.started()
    assert profile.stop() is None


# ---------------------------------------------------------------------------
# jit, remote, get
# ---------------------------------------------------------------------------

FUNCS = {
    "axpy": lambda x, y: 2.5 * x + y,
    "pair": lambda x, y: (x * y, x - y),
    "dict": lambda x, y: {"s": x + y, "d": x / (y + 3.0)},
    "scalar": lambda x, y: (x * y).sum(),
}


@pytest.mark.parametrize("name", list(FUNCS))
def test_jit_values_equal_ramba_tpus(name):
    fn = FUNCS[name]
    xs = np.sin(np.arange(40.0))
    ys = np.cos(np.arange(40.0))
    got = rt.jit(fn)(rt.fromarray(xs), rt.fromarray(ys))
    want = rtj.jit(fn)(rtj.fromarray(xs), rtj.fromarray(ys))

    def flat(v):
        if isinstance(v, dict):
            return [flat(v[k]) for k in sorted(v)]
        if isinstance(v, (tuple, list)):
            return [flat(i) for i in v]
        return np.asarray(v)

    g, w = flat(got), flat(want)
    np.testing.assert_allclose(np.asarray(g, dtype=float),
                               np.asarray(w, dtype=float), rtol=1e-15,
                               atol=1e-15)
    if name != "scalar":
        leaves = got.values() if isinstance(got, dict) else (
            got if isinstance(got, tuple) else [got])
        assert all(isinstance(v, rt.ndarray) for v in leaves)


def test_jit_decorator_and_keywords():
    @rt.jit
    def f(x, k=1.0):
        return x * k

    out = f(rt.fromarray(np.arange(4.0)), k=3.0)
    np.testing.assert_array_equal(np.asarray(out), np.arange(4.0) * 3.0)
    assert rt.jit()(lambda x: x + 1)(rt.fromarray(np.ones(2))).shape == (2,)
    with pytest.raises(TypeError, match="static_argnums"):
        rt.jit(lambda x: x, static_argnums=(0,))


def test_remote_function_actor_and_get():
    @rt.remote
    def square(v):
        return v * v

    futs = [square.remote(i) for i in range(5)]
    assert rt.get(futs) == [0, 1, 4, 9, 16]
    assert rt.get(tuple(futs[:2])) == (0, 1)
    assert square(7) == 49 and rt.get(3) == 3

    @rt.remote
    class Counter:
        def __init__(self, start):
            self.n = start

        def add(self, k):
            self.n += k
            return self.n

    c = Counter.remote(10)
    outs = rt.get([c.add.remote(i) for i in range(1, 5)])
    assert outs == [11, 13, 16, 20]  # one method at a time, in order
    arr = rt.get(rt.remote(lambda: rt.fromarray(np.arange(3.0)) * 2).remote())
    np.testing.assert_array_equal(np.asarray(arr), [0.0, 2.0, 4.0])
