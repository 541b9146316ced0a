"""The degradation ladder (``ramba_tpu_torch/resilience/degrade.py`` and
the fuser's rungs) against ramba_tpu, x64 regime, on the CPU.

The counterparts of ``tests/test_resilience.py:229-345`` (a compile fault
retried in place, split on an out-of-memory fault, the eager and host
rungs, the fatal path, the quarantine, no counter moving without a
fault) and of ``tests/test_coherence.py:190-270`` (the coherent ladder
under ``RAMBA_COHERENCE=force``).  Then every rung forced on the main
path's programs (the chain and axpy + sum, the groupby sum, star2, a
1000-instruction chain, operands of int8, uint64, float16, bool and
complex128): each equals ``ramba_tpu``'s fused result in values and
dtypes, sign bits and NaN positions included (float sums within n * eps *
sum|x|: the packages sum in different orders), and gives the port's own
fused bytes.  A CUDA-error-like failure and a failed kernel build are
fatal: no rung below. ``ramba_tpu``'s own eager rung is red on jax 0.9
(``jax.spmd_mode``), so it is no oracle here: its fused result is.
Across 2 and 4 gloo ranks (``tests/torch_dist_worker.py``'s ``ladder``
mode) a failure on one rank drops every rank to the same rung, a fatal
one aborts every rank with one class, and nothing hangs.
"""

import errno
import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from ramba_tpu.core import fuser as jfuser
from ramba_tpu.resilience import faults as jfaults
from ramba_tpu_torch import _build, common
from ramba_tpu_torch.core import fuser
from ramba_tpu_torch.observe import events, registry
from ramba_tpu_torch.ops import kernel_backend
from ramba_tpu_torch.resilience import coherence, degrade, faults, retry

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dist_worker as worker  # noqa: E402
from test_torch_distributed import launch  # noqa: E402

EPS = {"float64": 2.0 ** -52, "float32": 2.0 ** -23, "float16": 2.0 ** -10,
       "complex128": 2.0 ** -52}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    torch.set_num_threads(1)
    monkeypatch.setenv("RAMBA_RETRY_BASE_S", "0")
    for k in ("RAMBA_HBM_BUDGET", "RAMBA_CHUNK_BYTES", "RAMBA_COHERENCE",
              "RAMBA_RETRY_ATTEMPTS"):
        monkeypatch.delenv(k, raising=False)
    faults.configure(None)
    jfaults.configure(None)
    fuser.flush()
    rtj.sync()
    yield
    faults.reset()
    jfaults.reset()
    coherence.reset()


def _span():
    return events.last(1, type="flush")[-1]


def _chain(scale, offset, n=1024):
    return float(rt.sum(rt.arange(n) * scale + offset))


def _expect(scale, offset, n=1024):
    return float(np.sum(np.arange(n) * scale + offset))


# -- tests/test_resilience.py's ladder cases ---------------------------------


def test_flush_retries_through_injected_compile_fault():
    fuser._compile_cache.clear()
    before = registry.get("resilience.retries.flush")
    with faults.inject("compile", "once"):
        got = _chain(3.0, 2.0)
    assert got == _expect(3.0, 2.0)
    assert registry.get("resilience.retries.flush") == before + 1
    evs = events.last(50)
    assert any(e["type"] == "fault" and e["site"] == "compile" for e in evs)
    assert any(e["type"] == "degrade" and e.get("action") == "retry"
               and e.get("site") == "flush" for e in evs)
    assert "degraded" not in _span(), "an in-place retry is not a rung change"


def test_ladder_split_on_injected_oom():
    fuser._compile_cache.clear()
    steps = registry.get("resilience.degrade.split")
    rec = registry.get("resilience.degrade_recovered")
    with faults.inject("oom", "1"):
        got = _chain(5.0, 7.0)
    assert got == _expect(5.0, 7.0)
    assert registry.get("resilience.degrade.split") == steps + 1
    assert registry.get("resilience.degrade_recovered") == rec + 1
    assert _span().get("degraded") == "split"
    evs = events.last(50)
    assert any(e.get("action") == "rung" and e.get("to") == "split"
               for e in evs)
    assert any(e.get("action") == "recovered" and e.get("rung") == "split"
               for e in evs)


def test_ladder_reaches_eager(monkeypatch):
    monkeypatch.setenv("RAMBA_RETRY_ATTEMPTS", "2")
    fuser._compile_cache.clear()
    ex0 = registry.get("resilience.retry_exhausted.flush")
    with faults.inject("compile", "always"):
        got = _chain(3.5, 1.0)
    assert got == _expect(3.5, 1.0)
    span = _span()
    assert span.get("degraded") == "eager"
    assert [c["cache"] for c in span["calls"]] == ["eager"]
    assert registry.get("resilience.degrade.eager") >= 1
    # fused, split and chunked exhausted their budgets first
    assert registry.get("resilience.retry_exhausted.flush") == ex0 + 3


def test_ladder_reaches_host(monkeypatch):
    monkeypatch.setenv("RAMBA_RETRY_ATTEMPTS", "2")
    fuser._compile_cache.clear()
    with faults.active("compile:always,eager:always"):
        got = _chain(2.0, -3.0, n=512)
    assert got == _expect(2.0, -3.0, n=512)
    span = _span()
    assert span.get("degraded") == "host"
    assert registry.get("resilience.degrade.host") >= 1
    rungs = [e.get("to") for e in events.last(80) if e.get("action") == "rung"]
    assert rungs[-4:] == ["split", "chunked", "eager", "host"]


def test_the_host_rungs_device_scope_is_its_threads_own():
    """While one thread runs under the host rung's device scope, another
    thread's arrays are created and flushed on the process device."""
    inside, leave = threading.Event(), threading.Event()
    seen = {}

    def rung():
        with common.device_scope("meta"):
            seen["own"] = common.device()
            inside.set()
            leave.wait(30)

    t = threading.Thread(target=rung)
    t.start()
    try:
        assert inside.wait(30)
        assert common.device() == torch.device("cpu")
        got = np.asarray(rt.arange(4.0) * 2.0 + 1.0)
    finally:
        leave.set()
        t.join(30)
    assert seen["own"] == torch.device("meta")
    np.testing.assert_array_equal(got, np.arange(4.0) * 2.0 + 1.0)


def test_fatal_flush_errors_skip_the_ladder():
    before = registry.prefixed("resilience.")
    with faults.inject("compile", "once", kind="fatal"):
        fuser._compile_cache.clear()
        with pytest.raises(faults.InjectedFault):
            _chain(9.0, 9.0)
    after = registry.prefixed("resilience.")
    moved = {k for k in after if after[k] != before.get(k, 0)}
    assert moved <= {"resilience.fault_injected",
                     "resilience.fault_injected.compile",
                     "resilience.flush_quarantined"}, moved


def test_failed_flush_quarantines_roots():
    a = rt.arange(256) * 3.0
    fuser._compile_cache.clear()
    before = registry.get("resilience.flush_quarantined")
    with faults.inject("compile", "once", kind="fatal"):
        with pytest.raises(faults.InjectedFault):
            np.asarray(a)
    assert registry.get("resilience.flush_quarantined") > before
    assert _chain(2.0, 1.0, n=128) == _expect(2.0, 1.0, n=128)
    np.testing.assert_array_equal(np.asarray(a), np.arange(256) * 3.0)


def test_no_faults_means_zero_resilience_counters():
    before = registry.prefixed("resilience.")
    assert _chain(1.5, -2.0, n=3000) == _expect(1.5, -2.0, n=3000)
    assert registry.prefixed("resilience.") == before
    assert "degraded" not in _span()


@pytest.mark.parametrize("site", ["kernel", "dispatch", "execute"])
def test_sites_that_feed_the_ladder(site):
    """An injected fault at the kernel lowering, before a rung or before
    a call is retried in place (once) or drops a rung (oom kind); the
    kernel site fails the fused rung and never swaps in the generic
    lowering."""
    x = rt.fromarray(np.arange(512.0))
    fuser._compile_cache.clear()
    with faults.inject(site, "once", kind="oom"):
        got = float(rt.sum(x * 2.0 + 1.0))
    assert got == float(np.sum(np.arange(512.0) * 2.0 + 1.0))
    assert _span().get("degraded") == "split"
    with faults.inject(site, "once"):
        got = float(rt.sum(x * 3.0 + 1.0))
    assert "degraded" not in _span()
    backends = {c.get("backend") for c in _span()["calls"]}
    assert backends == {"kernel"}, _span()


def _cuda_error(monkeypatch, tmp_path):
    raise RuntimeError("CUDA error: an illegal memory access was "
                       "encountered")


def _build_error(monkeypatch, tmp_path):
    raise _build.KernelBuildError("nvcc failed for elemred_x (1):\n"
                                  "error: identifier undefined")


def _nvcc_oserror(monkeypatch, tmp_path):
    """The compiler cannot be started (out of memory for the fork)."""
    def run(cmd):
        raise OSError(errno.ENOMEM, "Cannot allocate memory")

    monkeypatch.setattr(_build, "_run_nvcc", run)
    _build.build_so("elemred_x", "// source")


def _cdll_oserror(monkeypatch, tmp_path):
    """The library builds, but ctypes cannot open it (a missing
    libcudart)."""
    def run(cmd):
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"library")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    def cdll(path, *a, **k):
        raise OSError("libcudart.so.12: cannot open shared object file")

    monkeypatch.setattr(_build, "_run_nvcc", run)
    monkeypatch.setattr(_build.ctypes, "CDLL", cdll)
    _build.load("elemred_x", "// source")


@pytest.mark.parametrize("fail", [
    _cuda_error, _build_error, _nvcc_oserror, _cdll_oserror,
], ids=["cuda_error", "build_error", "nvcc_oserror", "cdll_oserror"])
def test_kernel_failures_are_fatal_and_skip_the_ladder(monkeypatch, tmp_path,
                                                       fail):
    """A failed launch, a failed build, or an OSError while a kernel is
    built or loaded raises from the fused rung: no retry, no rung below,
    the roots quarantined; an unrelated array still flushes and takes the
    kernels."""
    monkeypatch.setattr(_build, "_build_dir", str(tmp_path))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    with pytest.raises(RuntimeError) as info:
        fail(monkeypatch, tmp_path)
    assert retry.classify(info.value) == "fatal"
    if fail is not _cuda_error:
        assert isinstance(info.value, _build.KernelBuildError)
    fuser._compile_cache.clear()

    def broken(program, leaf_vals):
        fail(monkeypatch, tmp_path)

    x = rt.fromarray(np.arange(256.0))
    y = x * 2.0 + 1.0
    before = registry.prefixed("resilience.")
    q0 = fuser.stats["quarantined"]
    monkeypatch.setattr(kernel_backend, "lower_program", broken)
    with pytest.raises(type(info.value)):
        np.asarray(y)
    monkeypatch.undo()
    moved = {k for k, v in registry.prefixed("resilience.").items()
             if v != before.get(k, 0)}
    assert moved == {"resilience.flush_quarantined"}, moved
    assert fuser.stats["quarantined"] == q0 + 1
    got = float(rt.sum(rt.fromarray(np.arange(64.0)) * 2.0))
    assert got == float(np.sum(np.arange(64.0) * 2.0))
    assert {c.get("backend") for c in _span()["calls"]} == {"kernel"}
    np.testing.assert_array_equal(np.asarray(y), np.arange(256.0) * 2 + 1)


def test_the_host_rung_runs_on_one_shard():
    """Under a mesh of shards the host rung runs the program on one CPU
    shard (the process mesh holds the card's device, which the host
    rung's CPU values do not match), with the sharded result's bytes."""
    from ramba_tpu_torch import parallel
    from ramba_tpu_torch.parallel import mesh as pmesh

    old = pmesh.get_mesh()
    pmesh.set_mesh(pmesh.Mesh(np.array([torch.device("cpu")] * 2,
                                       dtype=object), ("d0",)))
    try:
        st = rt.stencil(worker.star2_body)
        g = rt.fromarray(np.random.RandomState(3).rand(32, 24))
        a0 = parallel.comm_stats["shard_assemble_count"]
        fused = np.asarray(rt.sstencil(st, g))
        assert parallel.comm_stats["shard_assemble_count"] > a0
        a1 = parallel.comm_stats["shard_assemble_count"]
        with faults.active("oom:1,eager:once:oom"):
            host = np.asarray(rt.sstencil(st, g))
        assert _span().get("degraded") == "host"
        assert parallel.comm_stats["shard_assemble_count"] == a1
        assert host.tobytes() == fused.tobytes()
    finally:
        pmesh.set_mesh(old)


def test_a_failed_rung_leaves_nothing_alive():
    """The frames of a failed attempt are cleared before the next rung
    runs: a tensor the failed rung held is collected."""
    import weakref

    seen = []

    def fused():
        t = torch.ones(1024)
        seen.append(weakref.ref(t))
        raise faults.InjectedResourceExhausted("oom", 1, nbytes=1)

    def split():
        import gc

        gc.collect()
        return seen[0]() is None

    out, rung = degrade.run_ladder("t_flush", [("fused", fused),
                                               ("split", split)])
    assert (out, rung) == (True, "split")


# -- tests/test_coherence.py's coherent ladder (loopback force mode) ---------


@pytest.fixture
def _force(monkeypatch):
    monkeypatch.setenv("RAMBA_COHERENCE", "force")
    coherence.reset()
    yield
    coherence.reset()


def _coherence_events():
    return [e for e in events.last(200) if e.get("type") == "coherence"]


def test_coherent_ladder_drop_and_recover(_force):
    seen = []

    def r0():
        seen.append("fused")
        raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")

    def r1():
        seen.append("split")
        return 99

    out, rung = degrade.run_ladder("t_flush", [("fused", r0), ("split", r1)])
    assert (out, rung) == (99, "split") and seen == ["fused", "split"]
    assert coherence.last_epoch("t_flush:rung") == 2


def test_coherent_ladder_fatal_aborts_everywhere(_force):
    def r0():
        raise TypeError("programming error")

    with pytest.raises(TypeError):
        degrade.run_ladder("t_flush", [("fused", r0), ("split", lambda: 1)])
    assert coherence.last_epoch("t_flush:rung") == 1


def test_coherent_ladder_inputs_gone_aborts(_force):
    def r0():
        raise retry.RetryBudgetExhausted("t_flush: budget gone")

    with pytest.raises(coherence.CoherentAbort) as ei:
        degrade.run_ladder("t_flush", [("fused", r0), ("split", lambda: 1)],
                           leaf_check=lambda: False)
    assert ei.value.coherent_classification == "fatal"
    assert "RetryBudgetExhausted" in str(ei.value)
    evs = [e for e in _coherence_events() if e["site"] == "t_flush:rung"]
    assert evs and evs[-1]["decision"] == coherence.P_FATAL


def test_coherent_ladder_forced_drop_with_dead_inputs(_force, monkeypatch):
    decisions = iter([coherence.P_DROP, coherence.P_FATAL])
    monkeypatch.setattr(coherence, "decide",
                        lambda site, local, **kw: next(decisions))
    alive = {"ok": True}

    def r0():
        alive["ok"] = False
        return "done"

    with pytest.raises(coherence.CoherentAbort) as ei:
        degrade.run_ladder("t_flush", [("fused", r0), ("split", lambda: 1)],
                           leaf_check=lambda: alive["ok"])
    assert ei.value.coherent_classification == "fatal"


def test_noncoherent_ladder_unchanged(monkeypatch):
    monkeypatch.setenv("RAMBA_COHERENCE", "off")

    def r0():
        raise retry.RetryBudgetExhausted("x")

    out, rung = degrade.run_ladder("t_flush",
                                   [("fused", r0), ("split", lambda: 7)])
    assert (out, rung) == (7, "split")
    assert coherence.last_epoch("t_flush:rung") == 0


def test_a_flush_under_force_runs_its_rounds(_force):
    """One process in the loopback mode: every flush's ladder runs its
    retry and rung rounds, and an out-of-memory fault evicts through its
    round before the drop."""
    assert _chain(1.0, 1.0) == _expect(1.0, 1.0)
    assert coherence.last_epoch("flush:rung") == 1
    assert coherence.last_epoch("retry:flush") == 1
    with faults.inject("oom", "1"):
        assert _chain(2.0, 1.0) == _expect(2.0, 1.0)
    assert coherence.last_epoch("flush:rung") == 3
    assert coherence.last_epoch("memory:oom_evict") == 1
    assert _span().get("degraded") == "split"


# -- every rung on the main path's programs, against ramba_tpu's fused ------

RUNG_FAULTS = {"fused": None, "split": "oom:1", "chunked": "oom:2",
               "eager": "oom:3", "host": "oom:3,eager:once:oom"}


def _star2(m, a):
    return m.sstencil(m.stencil(worker.star2_body), a)


def _series():
    rs = np.random.RandomState(11)
    return rs.rand(4096) - 0.25, rs.randint(0, 24, 4096)


def _operands(dtype):
    rs = np.random.RandomState(7)
    if dtype == "bool":
        return rs.rand(257) > 0.5, rs.rand(257) > 0.3
    if dtype == "complex128":
        return (rs.rand(257) + 1j * rs.rand(257),
                rs.rand(257) - 1j * rs.rand(257))
    if dtype == "float16":
        a = (rs.rand(257) * 8 - 4).astype(np.float16)
        a[:4] = [np.nan, -0.0, 0.0, np.inf]
        return a, (rs.rand(257) * 3).astype(np.float16)
    info = np.iinfo(dtype)
    lo, hi = max(info.min, -100), min(info.max, 100)
    return (rs.randint(lo, hi, 257).astype(dtype),
            rs.randint(max(lo, 1), hi, 257).astype(dtype))


def _dtype_prog(m, a, b, dtype):
    if dtype == "bool":
        return [(a & b) | ~a, a ^ b]
    if dtype == "float16":
        return [a * b - 1.5, m.sqrt(m.abs(a)) + b, -a * 0.0]
    if dtype == "complex128":
        return [a * b + a, a - b * 3, a / b]
    return [a * b + a, a - b * 3, a // b]


PROGRAMS = {
    # name: m -> the roots of its program in the package m
    "chain": lambda m: (lambda A: [m.sin(A) ** 2 + m.cos(A) ** 2,
                                   m.sum(m.sin(A) ** 2 + m.cos(A) ** 2)])(
        m.arange(4096) / 1000.0),
    "axpy_sum": lambda m: (lambda x, y: [m.sum(2.5 * x + y)])(
        m.fromarray(np.sin(np.arange(4096) * 1e-3)),
        m.fromarray(np.cos(np.arange(4096) * 1e-3))),
    "groupby_sum": lambda m: (lambda d, lab: [
        m.fromarray(d).groupby(0, lab, 24).sum()])(*_series()),
    "star2": lambda m: [_star2(m, m.fromarray(
        np.random.RandomState(3).rand(37, 41).astype(np.float32)))],
    "chain1000": lambda m: (lambda x: [_long_chain(m, x)])(
        m.fromarray(np.linspace(0.0, 1.0, 513))),
}
for _dt in ("int8", "uint64", "float16", "bool", "complex128"):
    PROGRAMS[_dt] = (lambda dt: lambda m: (lambda ab: _dtype_prog(
        m, m.fromarray(ab[0]), m.fromarray(ab[1]), dt))(_operands(dt)))(_dt)


def _long_chain(m, x):
    y = x
    for i in range(500):
        y = y * 1.0009765625 + (0.125 if i % 2 else -0.125)
    return y


def _roots(m, name):
    return PROGRAMS[name](m)


def _host(v):
    if isinstance(v, rt.ndarray):
        return np.asarray(v.asarray())
    if isinstance(v, rtj.ndarray):
        return np.asarray(v.asarray())
    return np.asarray(v)


def _same_bits(got, want, what):
    """Sign bits and NaN positions of floats, then the values."""
    assert got.dtype == want.dtype, f"{what}: {got.dtype} vs {want.dtype}"
    assert got.shape == want.shape, what
    if got.dtype.kind in "fc":
        for part in ((got.real, want.real), (got.imag, want.imag)) \
                if got.dtype.kind == "c" else ((got, want),):
            g, w = part
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w), what)
            np.testing.assert_array_equal(np.signbit(g[~np.isnan(g)]),
                                          np.signbit(w[~np.isnan(w)]), what)


# ulps of the largest magnitude an elementwise result may differ from
# ramba_tpu's by: XLA on the CPU contracts a * b + c into an FMA and
# computes float16 arithmetic in float32 (ROADMAP C's kept divergences);
# the 500 steps of the long chain compound it
ULPS = {"chain1000": 500}


def _held(got, want, what, terms=None, scale=None, ulps=4):
    _same_bits(got, want, what)
    if got.dtype.kind not in "fc":
        np.testing.assert_array_equal(got, want, what)
        return
    eps = EPS[got.dtype.name]
    if terms is not None:
        # a float sum in two orders: n * eps * sum|x| per result
        np.testing.assert_array_less(
            np.abs(got - want), terms * eps * scale + 1e-300, what)
        return
    finite = np.isfinite(want)
    top = float(np.max(np.abs(want[finite]))) if finite.any() else 0.0
    np.testing.assert_allclose(got, want, rtol=ulps * eps,
                               atol=ulps * eps * top, err_msg=what)


def _run(m, name, spec, jax_side=False):
    if jax_side:
        return [_host(v) for v in _roots(m, name)]
    fuser._compile_cache.clear()
    with faults.active(spec) if spec else faults.active(""):
        roots = _roots(m, name)
        fuser.flush()
    span = _span()
    return [_host(v) for v in roots], span


CASES = [(name, rung) for name in PROGRAMS for rung in RUNG_FAULTS]


@pytest.mark.parametrize("name,rung", CASES)
def test_every_rung_equals_the_fused_result(name, rung):
    want = _run(rtj, name, None, jax_side=True)
    fused, fspan = _run(rt, name, None)
    assert "degraded" not in fspan
    n_instrs = fspan["instrs"]
    offered = fuser.rungs_for(n_instrs, host=True)
    got, span = _run(rt, name, RUNG_FAULTS[rung])
    expect = rung if rung in offered else (
        "eager" if rung != "host" else "host")
    assert span.get("degraded", "fused") == expect, (span, offered)
    for i, (g, f, w) in enumerate(zip(got, fused, want)):
        what = f"{name}[{i}] on {expect}"
        # the port's rungs: the fused bytes, on the CPU
        assert g.dtype == f.dtype and g.tobytes() == f.tobytes(), what
        terms = scale = None
        if name in ("chain", "axpy_sum", "groupby_sum") and g.dtype.kind \
                == "f" and (g.ndim == 0 or name == "groupby_sum"):
            terms, scale = 4096, 4096.0 * 3.5
        _held(g, w, what + " vs ramba_tpu's fused", terms, scale,
              ULPS.get(name, 4))


# -- across 2 and 4 gloo ranks -----------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_a_coherent_ladder_across_ranks(tmp_path, world):
    rcs, logs, outdir = launch(world, tmp_path, mode="ladder", limit=240,
                               env={"RAMBA_INIT_TIMEOUT_S": "30",
                                    "RAMBA_RETRY_BASE_S": "0"})
    assert rcs == [0] * world, "\n".join(logs)
    info = [json.loads((outdir / f"rank{r}.json").read_text())
            for r in range(world)]
    res = [dict(np.load(outdir / f"rank{r}.npz")) for r in range(world)]
    want = worker.ladder_reference()
    for r, (i, got) in enumerate(zip(info, res)):
        # one rank's oom drops every rank to split, in the same rounds,
        # the empty-block and memo-served ranks among them
        assert i["rungs"] == {"healthy": "fused", "oom": "split",
                              "oom_iterate": "split", "transient": "fused",
                              "tiny": "split", "memo": "split"}, (r, i)
        assert i["retries"] == 1, (r, i)  # a retry on one is on every rank
        assert i["dispatch_checks"] == 1, (r, i)  # one a rung attempt
        # rank 0's own flush audited alone, with no round
        assert i["audits"] == (1 if r == 0 else 0), (r, i)
        assert i["epochs"] == info[0]["epochs"], (r, i)
        assert i["degrade_steps"] == 4 + 0, (r, i)
        # a fatal fault on rank 1 aborts every rank with one class
        assert i["fatal_class"] == "fatal", (r, i)
        if r == 1:
            assert i["fatal_error"].startswith("InjectedFatalFault"), i
        else:
            assert i["fatal_error"].startswith("RuntimeError") and \
                "another rank" in i["fatal_error"], i
        assert i["after_fatal"] == info[0]["after_fatal"]
        assert i["after_fatal"] == pytest.approx(want["after_fatal"],
                                                 rel=1e-12)
        # every rank the one-process bytes (whole arrays, gathered)
        for k in ("axpy", "star2", "iterate", "memo", "retried"):
            assert got[k].tobytes() == want[k].tobytes(), (r, k)
        np.testing.assert_array_equal(got["tiny"], [[3.0]])
    x = worker.ladder_inputs()[0]
    assert float(res[0]["local_audit"]) == pytest.approx(
        float(np.sum(x * 5.0 + 1.0)), rel=1e-12)
    assert info[1]["memo_hits"] >= 1  # a rank the memo served
    assert info[0]["epochs"]["flush:rung"] > 0
