"""The port's resilience plane against ramba_tpu's: fault injection, retry,
coherence and the integrity envelope.

* The same ``RAMBA_FAULTS`` spec and seed fire on exactly the same checks
  in both packages (50 checks each, probability mode, ``after=``,
  ``rank=`` and ``flip:bytes=`` among them), flip the same bytes, and a
  bad spec fails with the same error.
* ``retry.classify`` sorts a table of exceptions as the reference does,
  plus torch's errors by the port's own rules; backoff delays are equal.
* A blob stamped by ``integrity.wrap`` in one package verifies in the
  other, and every single-byte flip is caught.
* Coherence, single-process: not engaged, or (``RAMBA_COHERENCE=force``)
  the reference's epochs and decisions.

Each package is configured through its own ``configure()``/``inject()``
or ``monkeypatch``; nothing is left set in the process environment.
Mirrors ``tests/test_resilience.py:66-204`` and
``tests/test_integrity.py:76-170``.
"""

import json
import os

import pytest
import torch

import jax
from ramba_tpu.resilience import coherence as coherence_j
from ramba_tpu.resilience import faults as faults_j
from ramba_tpu.resilience import integrity as integrity_j
from ramba_tpu.resilience import retry as retry_j
from ramba_tpu_torch import common
from ramba_tpu_torch.observe import events, registry
from ramba_tpu_torch.resilience import coherence, faults, integrity, retry


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    if not jax.config.jax_enable_x64:
        pytest.skip("the port's tests run on the x64 leg only")
    common.set_device("cpu")
    monkeypatch.setenv("RAMBA_RETRY_BASE_S", "0.001")
    for k in ("RAMBA_INTEGRITY", "RAMBA_COHERENCE", "RAMBA_FAULTS",
              "RAMBA_FAULTS_SEED"):
        monkeypatch.delenv(k, raising=False)
    for f in (faults, faults_j):
        f.configure(None)
    for c in (coherence, coherence_j):
        c.reset()
    integrity.reset()
    yield
    for f in (faults, faults_j):
        f.reset()
    for c in (coherence, coherence_j):
        c.reset()
    integrity.reset()


def _fires(mod, site, n):
    out = []
    for _ in range(n):
        try:
            mod.check(site)
            out.append(None)
        except mod.InjectedFault as e:
            out.append(type(e).__name__)
    return out


# -- faults.py ---------------------------------------------------------------

SPECS = [
    ("a:once", 0), ("b:3", 0), ("c:after=7", 0), ("d:always", 0),
    ("p:0.3", 7), ("p:0.5", 123), ("p:0.05", 2), ("q:0.25:oom", 11),
    ("r:0.4:rank=0", 5), ("r:always:rank=1", 0), ("k:2:fatal", 0),
    ("oom:after=3:bytes=1g", 0), ("m:4:transient", 0),
    ("reshard:stage:always:rank=0", 0), ("checkpoint_io:0.5", 9),
    ("s:delay:ms=0", 0), ("h:hang:ms=0:after=2", 0),
]


@pytest.mark.parametrize("spec,seed", SPECS)
def test_fire_sequence_matches_reference(spec, seed):
    site = faults._parse_one(spec).site
    for f in (faults, faults_j):
        f.configure(spec, seed=seed)
    got, want = _fires(faults, site, 50), _fires(faults_j, site, 50)
    assert got == want
    assert faults.stats() == faults_j.stats()


@pytest.mark.parametrize("spec,seed", [
    ("m:flip:bytes=3", 0), ("m:flip:bytes=2:after=3", 4),
    ("m:flip:rank=0", 1), ("m:flip:bytes=5:rank=1", 0),
    ("checkpoint:leaf:flip:bytes=2", 7),
])
def test_flip_sequence_matches_reference(spec, seed):
    site = faults._parse_one(spec).site
    payload = bytes(range(256)) * 2
    for f in (faults, faults_j):
        f.configure(spec, seed=seed)
    got = [faults.corrupt(site, payload) for _ in range(50)]
    want = [faults_j.corrupt(site, payload) for _ in range(50)]
    assert got == want
    assert faults.stats() == faults_j.stats()


@pytest.mark.parametrize("spec", [
    "compile", "compile:sometimes", "compile:1.5", "x:once:weird",
    "x:delay", "x:delay:oom:ms=1", "x:flip:ms=3", "x:once:after=2",
    "x:once:rank=-1", "x:once:rank=a", "x:once:bytes=zz",
    "x:once:rank=1:rank=2", "x:-3", "x:once:oom:fatal", ":once",
])
def test_bad_spec_fails_the_same_way(spec):
    with pytest.raises(ValueError) as want:
        faults_j.configure(spec)
    with pytest.raises(ValueError) as got:
        faults.configure(spec)
    assert str(got.value) == str(want.value)


def test_fault_modes():
    faults.configure("a:once,b:2,c:after=2,d:always")
    assert _fires(faults, "a", 3) == ["InjectedFault", None, None]
    assert _fires(faults, "b", 4) == ["InjectedFault"] * 2 + [None] * 2
    assert _fires(faults, "c", 4) == [None, None] + ["InjectedFault"] * 2
    assert _fires(faults, "d", 3) == ["InjectedFault"] * 3
    assert _fires(faults, "unarmed", 2) == [None, None]
    st = faults.stats()
    assert st["a"] == {"calls": 3, "fired": 1}
    assert st["d"] == {"calls": 3, "fired": 3}
    faults.configure(None)
    assert not faults.enabled()


def test_probability_mode_is_deterministic():
    def pattern(seed):
        faults.configure("p:0.5", seed=seed)
        return _fires(faults, "p", 100)

    p1, p2 = pattern(7), pattern(7)
    assert p1 == p2
    assert 20 <= sum(x is not None for x in p1) <= 80
    assert pattern(8) != p1


def test_bad_env_chunk_warns_and_keeps_good_ones():
    with pytest.warns(UserWarning, match="malformed"):
        faults.configure("compile:sometimes,execute:once", strict=False)
    assert _fires(faults, "execute", 1) == ["InjectedFault"]


def test_oom_site_and_kinds():
    faults.configure("oom:once:bytes=2g")
    with pytest.raises(faults.InjectedResourceExhausted,
                       match="RESOURCE_EXHAUSTED") as ei:
        faults.check("oom")
    assert ei.value.bytes == 2 << 30
    faults.configure("x:once:fatal")
    with pytest.raises(faults.InjectedFault) as ei:
        faults.check("x")
    assert not ei.value.retryable


def test_inject_context_restores_previous_plan():
    faults.configure("fileio:always")
    with faults.inject("fileio", "once"):
        assert _fires(faults, "fileio", 2) == ["InjectedFault", None]
    assert _fires(faults, "fileio", 2) == ["InjectedFault"] * 2
    faults.configure(None)
    with faults.inject("checkpoint_io", "once"):
        assert _fires(faults, "checkpoint_io", 1) == ["InjectedFault"]
    assert not faults.enabled()


def test_active_restores_plan_and_seed():
    faults.configure("a:always", seed=3)
    with faults.active("b:once", seed=9):
        assert _fires(faults, "b", 2) == ["InjectedFault", None]
        assert _fires(faults, "a", 1) == [None]
    assert _fires(faults, "a", 1) == ["InjectedFault"]


def test_fault_event_and_counters():
    before = registry.get("resilience.fault_injected.unit_ev")
    faults.configure("unit_ev:once")
    _fires(faults, "unit_ev", 2)
    assert registry.get("resilience.fault_injected.unit_ev") == before + 1
    ev = events.last(4, type="fault")
    assert ev and ev[-1]["site"] == "unit_ev" and ev[-1]["mode"] == "once"


# -- retry.py ----------------------------------------------------------------


def _table(f, r):
    return [
        ValueError("bad operand"), TypeError("no"), TimeoutError("slow"),
        ConnectionResetError(), FileNotFoundError("gone"),
        PermissionError("no"), IsADirectoryError("dir"), OSError("hiccup"),
        RuntimeError("RESOURCE_EXHAUSTED: out of memory allocating"),
        RuntimeError("UNAVAILABLE: socket closed"),
        RuntimeError("DEADLINE_EXCEEDED"), RuntimeError("Out of memory"),
        RuntimeError("the host fallback is unavailable under "
                     "multi-controller execution"),
        r.RetryBudgetExhausted("x"), f.InjectedFault("s", 1),
        f.InjectedResourceExhausted("s", 1),
        f.InjectedFatalFault("s", 1, "boom"), KeyError("k"),
    ]


def test_classify_matches_reference():
    got = [retry.classify(e) for e in _table(faults, retry)]
    want = [retry_j.classify(e) for e in _table(faults_j, retry_j)]
    assert got == want
    assert got[:4] == ["fatal", "fatal", "retryable", "retryable"]


def test_classify_torch_errors():
    assert retry.classify(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB")) == "oom"
    assert retry.classify(RuntimeError(
        "CUDA error: an illegal memory access was encountered")) == "fatal"
    assert retry.classify(RuntimeError(
        "CUDA error: unspecified launch failure (UNAVAILABLE)")) == "fatal"
    if hasattr(torch, "AcceleratorError"):
        try:
            err = torch.AcceleratorError("CUDA error: launch failed")
        except TypeError:
            err = None
        if err is not None:
            assert retry.classify(err) == "fatal"


def test_backoff_delays_equal_reference():
    for args in [(6, 0.1, 0.3, 0.5, 7), (4, 0.05, 2.0, 0.0, 0),
                 (8, 0.01, 1.0, 1.0, 123)]:
        pol, pol_j = retry.RetryPolicy(*args), retry_j.RetryPolicy(*args)
        for site in ("site", "fileio", "checkpoint_io"):
            d = [pol.delay(site, a) for a in range(1, 8)]
            assert d == [pol_j.delay(site, a) for a in range(1, 8)]
    pol = retry.RetryPolicy(attempts=6, base_s=0.1, max_s=0.3, jitter=0.5,
                            seed=7)
    d1 = [pol.delay("site", a) for a in range(1, 6)]
    assert all(0 < d <= 0.3 * 1.25 + 1e-12 for d in d1), d1


def test_policy_for_reads_the_same_environment(monkeypatch):
    monkeypatch.setenv("RAMBA_RETRY_FILEIO_ATTEMPTS", "5")
    monkeypatch.setenv("RAMBA_RETRY_MAX_S", "0.7")
    for site in ("fileio", "checkpoint_io"):
        p, q = retry.policy_for(site), retry_j.policy_for(site)
        assert (p.attempts, p.base_s, p.max_s, p.jitter, p.seed) == \
            (q.attempts, q.base_s, q.max_s, q.jitter, q.seed)


def test_retry_recovers_and_records_health():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise TimeoutError("transient blip")
        return "ok"

    before = registry.get("resilience.retries.unit_site")
    assert retry.call("unit_site", flaky) == "ok"
    assert calls["n"] == 3
    assert registry.get("resilience.retries.unit_site") == before + 2
    hs = [e for e in events.last(50, type="health")
          if e.get("source") == "unit_site"]
    assert hs and hs[-1]["outcome"] == "recovered" and hs[-1]["retries"] == 2


def test_retry_budget_exhausted_chains_cause(monkeypatch):
    monkeypatch.setenv("RAMBA_RETRY_UNIT_X_ATTEMPTS", "2")
    calls = {"n": 0}

    def always_down():
        calls["n"] += 1
        raise TimeoutError("still down")

    before = registry.get("resilience.retry_exhausted.unit.x")
    with pytest.raises(retry.RetryBudgetExhausted) as ei:
        retry.call("unit.x", always_down)
    assert calls["n"] == 2
    assert isinstance(ei.value.__cause__, TimeoutError)
    assert "still down" in str(ei.value)
    assert registry.get("resilience.retry_exhausted.unit.x") == before + 1


def test_fatal_error_not_retried():
    calls = {"n": 0}

    def broken():
        calls["n"] += 1
        raise ValueError("programming error")

    before = registry.get("resilience.retries")
    with pytest.raises(ValueError, match="programming error"):
        retry.call("unit_fatal", broken)
    assert calls["n"] == 1
    assert registry.get("resilience.retries") == before


def test_coherent_retry_single_process_is_plain(monkeypatch):
    monkeypatch.setenv("RAMBA_COHERENCE", "force")
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 2:
            raise TimeoutError("blip")
        return 5

    assert retry.call("unit_coh", flaky, coherent=True) == 5
    assert coherence.epochs()["retry:unit_coh"] == 2


# -- coherence.py ------------------------------------------------------------


def test_coherence_not_engaged_single_process():
    assert not coherence.engaged()
    assert coherence.agree("retry:x", 3) == 3
    assert coherence.decide("flush:rung", 2) == 2
    coherence.propose("flush:rung", 4)
    assert coherence.epochs() == {}
    rep = coherence.report()
    assert rep["mode"] == "on" and not rep["engaged"]
    with pytest.raises(ValueError):
        coherence.agree("x", 1, reduce="sum")


def test_coherence_force_matches_reference(monkeypatch):
    monkeypatch.setenv("RAMBA_COHERENCE", "force")
    script = [("agree", "retry:x", 1, "max"), ("propose", "flush:rung", 3),
              ("decide", "flush:rung", 1, "max"),
              ("agree", "memory:chunk_bytes", 4096, "min"),
              ("decide", "flush:rung", 0, "max"),
              ("agree", "autotune:winner", 2, "bcast")]

    def run(c):
        out = []
        for step in script:
            if step[0] == "propose":
                c.propose(step[1], step[2])
                out.append(None)
            else:
                out.append(getattr(c, step[0])(step[1], step[2],
                                              reduce=step[3]))
        return out, c.epochs(), c.report()["pending"]

    assert run(coherence) == run(coherence_j)
    ev = events.last(10, type="coherence")
    assert ev and ev[-1]["site"] == "autotune:winner"


def test_coherence_across_processes_waits_for_multi_gpu(monkeypatch):
    # the round is an all-reduce over the process group
    # (tests/test_torch_distributed.py runs it across ranks); with no
    # group formed it reduces over this process's proposal alone
    monkeypatch.setattr(coherence, "_nprocs_cache", 2)
    assert coherence.engaged()
    e0 = coherence.last_epoch("retry:x")
    assert coherence.agree("retry:x", 1) == 1
    assert coherence.last_epoch("retry:x") == e0 + 1


def test_coherent_abort_classifies_as_agreed():
    err = coherence.CoherentAbort("retry:x", coherence.P_OOM)
    assert retry.classify(err) == "oom"
    assert coherence.decision_class(coherence.P_DROP) == "degrade"
    assert coherence.classification_code("fatal") == coherence.P_FATAL


# -- events ------------------------------------------------------------------


def test_trace_file_gets_one_line_per_event(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    events.configure(path)
    try:
        events.emit({"type": "unit", "n": 1})
        events.emit({"type": "unit", "n": 2})
        events.sync()
    finally:
        events.configure(None)
    lines = [json.loads(ln) for ln in open(path)]
    assert [e["n"] for e in lines] == [1, 2]
    assert lines[1]["seq"] == lines[0]["seq"] + 1
    assert "rank" not in lines[0]
    assert events.rank_info() == (0, 1)


# -- integrity envelope ------------------------------------------------------


@pytest.mark.parametrize("payload", [b"", b"ramba", bytes(range(256)) * 3])
@pytest.mark.parametrize("schema", ["memo.npz", "ckpt.digests.json"])
def test_envelope_crosses_packages(payload, schema):
    a, b = integrity.wrap(payload, schema), integrity_j.wrap(payload, schema)
    assert a == b
    assert integrity_j.unwrap(a, schema, site="t") == payload
    assert integrity.unwrap(b, schema, site="t") == payload
    assert integrity.verify_blob(b, schema) is None
    assert integrity_j.verify_blob(a, schema) is None


def test_every_single_byte_flip_is_detected():
    blob = bytearray(integrity.wrap(b"ramba", "memo.npz"))
    for i in range(len(blob)):
        bad = bytes(blob[:i]) + bytes([blob[i] ^ 0xFF]) + bytes(blob[i + 1:])
        with pytest.raises(integrity.IntegrityError):
            integrity.unwrap(bad, "memo.npz", site="test", record=False)
        assert integrity_j.verify_blob(bad, "memo.npz") == \
            integrity.verify_blob(bad, "memo.npz")


def test_unstamped_is_strict_and_recorded():
    with pytest.raises(integrity.IntegrityError) as ei:
        integrity.unwrap(b"no envelope here", "memo.npz", site="unit:blob")
    assert ei.value.reason == "unstamped"
    assert integrity.stats["failures"] == 1
    ev = events.last(4, type="integrity")
    assert ev and ev[-1]["site"] == "unit:blob"


def test_schema_confusion_is_detected():
    blob = integrity.wrap(b"payload", "aot.pkl")
    with pytest.raises(integrity.IntegrityError) as ei:
        integrity.unwrap(blob, "memo.npz", site="test", record=False)
    assert ei.value.reason == "schema"


def test_disabled_plane_strips_without_verifying(monkeypatch):
    blob = integrity.wrap(b"payload", "memo.npz")
    monkeypatch.setenv("RAMBA_INTEGRITY", "0")
    assert not integrity.enabled()
    assert integrity.unwrap(blob, "memo.npz", site="t") == b"payload"
    assert integrity.unwrap(b"raw", "memo.npz", site="t") == b"raw"
    bad = blob[:10] + bytes([blob[10] ^ 0xFF]) + blob[11:]
    integrity.unwrap(bad, "memo.npz", site="t")
    assert integrity.wrap(b"new", "memo.npz") == b"new"


def test_verify_blob_classifies_offline():
    blob = integrity.wrap(b"payload", "memo.npz")
    assert integrity.verify_blob(None, "memo.npz") == "missing"
    assert integrity.verify_blob(b"raw", "memo.npz") == "unstamped"
    bad = blob[:-2] + bytes([blob[-2] ^ 0xFF]) + blob[-1:]
    assert integrity.verify_blob(bad, "memo.npz") == "digest"
    other = integrity.wrap(b"payload", "aot.pkl")
    assert str(integrity.verify_blob(other, "memo.npz")).startswith("schema")
    assert integrity.stats["failures"] == 0


def test_suspect_after_threshold(monkeypatch):
    monkeypatch.setenv("RAMBA_INTEGRITY_THRESHOLD", "2")
    assert not integrity.suspect()
    integrity.failure("unit", "digest")
    assert not integrity.suspect()
    integrity.failure("unit", "digest")
    assert integrity.suspect() and integrity.snapshot()["suspect"]
    assert registry.get("integrity.suspect") == 1


def test_flip_mode_and_corrupt_file(tmp_path):
    data = bytes(range(256))
    faults.configure("memo:blob:flip:bytes=2", seed=7)
    first = faults.corrupt("memo:blob", data)
    faults.configure("memo:blob:flip:bytes=2", seed=7)
    assert faults.corrupt("memo:blob", data) == first != data
    diff = [i for i in range(len(data)) if first[i] != data[i]]
    assert 1 <= len(diff) <= 2 and all(first[i] ^ 0xFF == data[i] for i in diff)
    faults.configure("memo:blob:flip:bytes=1:after=1", seed=3)
    assert faults.corrupt("memo:blob", data) == data
    assert faults.corrupt("memo:blob", data) != data
    assert faults.corrupt("memo:blob", data) == data
    p = str(tmp_path / "blob.bin")
    raw = os.urandom(128)
    with open(p, "wb") as f:
        f.write(raw)
    faults.configure("checkpoint:leaf:flip:bytes=3", seed=1)
    assert faults.corrupt_file("checkpoint:leaf", p)
    now = open(p, "rb").read()
    assert now != raw and len(now) == len(raw)
    ev = events.last(4, type="fault")
    assert any(e.get("site") == "checkpoint:leaf" and e.get("mode") == "flip"
               for e in ev), ev
    faults.configure(None)
    assert faults.corrupt("memo:blob", data) is data
