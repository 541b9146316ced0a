"""The fleet's serving plane (``ramba_tpu_torch/fleet/``) against
ramba_tpu's, on the CPU.

Every case of ``tests/test_fleet_serve.py``: the shared artifact tier's
race discipline (atomic tmp + rename, two writer processes racing one key
while this process reads, never a torn blob; dead writers' temp files
swept; a corrupt blob evicted, never raised; content keys binding bytes,
not identity; the byte cap; the disarmed tier inert); session migration
(export/adopt round trip through the port's checkpoint format, manifest
checks, discard); the ``redirect`` rung of ``retry.classify`` in both
packages; ``fleet.poll``; ``overload.admission_verdict`` read-only; and
the router against in-process replica servers (the reference's
``two_servers``): failover healing by replay with the same digest, a
refusal redirecting without feeding the fleet breaker, an exhausted
fleet raising ``NoHealthyReplica``.

What the port adds: the cap checked before any copy of a tensor; the
shared memo lane serving a second replica; a step log through a
ramba_tpu replica and a port replica (arrays within 1 ulp, where XLA
contracts ``x * a + b`` into one rounding; the port's digest equal to
NumPy's, exactly); hedging only pure, reproducible steps; routed
migration; and the one subprocess case: a replica SIGKILLed mid-session,
healed on a survivor and read dead from the spool.  Tolerances: digests
and arrays exact, unless stated.
"""

import hashlib
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import jax
import ramba_tpu_torch as rt
from ramba_tpu.fleet import router as jrouter_mod
from ramba_tpu.resilience import retry as jretry
from ramba_tpu_torch import common, serve
from ramba_tpu_torch.core import memo
from ramba_tpu_torch.fleet import artifacts, migrate, replica
from ramba_tpu_torch.fleet.router import (NoHealthyReplica, ReplicaRefusal,
                                          ReplicaUnavailable, Router)
from ramba_tpu_torch.observe import fleet, registry, slo
from ramba_tpu_torch.resilience import elastic, integrity, retry
from ramba_tpu_torch.serve import overload

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ENV = ("RAMBA_ARTIFACTS", "RAMBA_MEMO_SHARED", "RAMBA_MEMO_SHARED_MAX",
        "RAMBA_HANDOFF_DIR", "RAMBA_FLEET_DIR", "RAMBA_FLEET_ENDPOINT",
        "RAMBA_ROUTER_HEDGE", "RAMBA_ROUTER_HEDGE_FACTOR",
        "RAMBA_BREAKER_THRESHOLD", "RAMBA_MEMO", "RAMBA_CACHE",
        "RAMBA_ROUTER_TIMEOUT_S")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    artifacts.reset()
    overload.reset()
    # state another file's tests leave in this process reaches the
    # published signals: a latched SLO breach, the integrity window, a
    # heartbeat still running
    slo.reset()
    integrity.reset()
    elastic.stop_heartbeat()
    yield
    serve.shutdown()
    artifacts.reset()
    overload.reset()
    fleet.reset()
    memo.reset()


# ---------------------------------------------------------------------------
# shared artifact tier
# ---------------------------------------------------------------------------


def test_store_blob_atomic_roundtrip(tmp_path):
    p = str(tmp_path / "blob.bin")
    assert artifacts.store_blob(p, b"one")
    assert artifacts.load_blob(p) == b"one"
    assert artifacts.store_blob(p, b"two")
    assert artifacts.load_blob(p) == b"two"
    assert artifacts.load_blob(str(tmp_path / "missing")) is None
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp-")]


def test_memo_roundtrip_and_stats(tmp_path):
    import torch

    artifacts.configure(str(tmp_path))
    outs = [np.arange(8, dtype=np.float32), torch.ones((2, 3),
                                                       dtype=torch.float64)]
    assert artifacts.memo_store("k" * 32, outs)
    got = artifacts.memo_load("k" * 32)
    assert len(got) == 2
    np.testing.assert_array_equal(got[0], outs[0])
    np.testing.assert_array_equal(got[1], np.ones((2, 3)))
    assert got[1].dtype == np.float64
    assert artifacts.memo_load("m" * 32) is None
    snap = artifacts.snapshot()
    assert snap["memo_stores"] == 1 and snap["memo_hits"] == 1
    assert snap["memo_misses"] == 1


def test_memo_corruption_evicted_never_raised(tmp_path):
    artifacts.configure(str(tmp_path))
    artifacts.memo_store("c" * 32, [np.arange(4)])
    path = os.path.join(str(tmp_path), "memo", "c" * 32 + ".npz")
    with open(path, "wb") as f:
        f.write(b"not an npz at all")
    assert artifacts.memo_load("c" * 32) is None
    assert not os.path.exists(path)
    assert artifacts.snapshot()["memo_corrupt"] == 1


def test_memo_size_cap(tmp_path, monkeypatch):
    monkeypatch.setenv("RAMBA_MEMO_SHARED_MAX", "64")
    artifacts.configure(str(tmp_path))
    assert not artifacts.memo_store("b" * 32, [np.zeros(1024)])
    assert artifacts.snapshot()["memo_skipped_large"] == 1
    assert artifacts.content_key("ch", [np.zeros(1024)], "fp") is None


def test_cap_is_checked_before_any_copy(tmp_path, monkeypatch):
    """A tensor over the cap is never copied to the host: its size is
    numel * element_size, read before ``_host`` would run."""
    import torch

    artifacts.configure(str(tmp_path))
    copies = []
    real = artifacts._host
    monkeypatch.setattr(artifacts, "_host",
                        lambda p: copies.append(p) or real(p))
    big = torch.zeros((8 << 20) // 8 + 1, dtype=torch.float64)
    assert artifacts.content_key("ch", [("s", "float", "1.0"), big],
                                 "fp") is None
    assert not artifacts.memo_store("d" * 32, [big])
    assert copies == []
    assert artifacts.snapshot()["memo_skipped_large"] == 2
    small = torch.arange(4, dtype=torch.float64)
    assert artifacts.content_key("ch", [small], "fp") == \
        artifacts.content_key("ch", [np.arange(4.0)], "fp")
    assert [c for c in copies if isinstance(c, torch.Tensor)] == [small]


def test_content_key_binds_bytes_not_identity(tmp_path):
    from ramba_tpu.fleet import artifacts as jartifacts

    artifacts.configure(str(tmp_path))
    jartifacts.configure(str(tmp_path))
    a = np.arange(16, dtype=np.float64)
    k1 = artifacts.content_key("chash", [a, ("scalar", 2.0)], "fp")
    k2 = artifacts.content_key("chash", [a.copy(), ("scalar", 2.0)], "fp")
    assert k1 == k2
    b = a.copy()
    b[3] += 1.0
    assert artifacts.content_key("chash", [b, ("scalar", 2.0)], "fp") != k1
    assert artifacts.content_key("other", [a, ("scalar", 2.0)], "fp") != k1
    assert artifacts.content_key("chash", [a, ("scalar", 2.0)], "fp2") != k1
    # the reference's key of the same NumPy parts
    assert jartifacts.content_key("chash", [a, ("scalar", 2.0)], "fp") == k1
    jartifacts.reset()


def test_gc_stale_tmp_sweeps_dead_writers(tmp_path):
    artifacts.configure(str(tmp_path))
    memo_dir = os.path.join(str(tmp_path), "memo")
    dead = os.path.join(memo_dir, ".tmp-deadwriter")
    with open(dead, "w") as f:
        f.write("partial")
    old = time.time() - 3600
    os.utime(dead, (old, old))
    fresh = os.path.join(memo_dir, ".tmp-livewriter")
    with open(fresh, "w") as f:
        f.write("partial")
    assert artifacts.gc_stale_tmp(max_age_s=300.0) == 1
    assert not os.path.exists(dead)
    assert os.path.exists(fresh)
    assert artifacts.snapshot()["tmp_gcd"] == 1


def test_disarmed_tier_is_inert(tmp_path):
    assert not artifacts.armed()
    assert not artifacts.memo_store("k" * 32, [np.arange(4)])
    assert artifacts.memo_load("k" * 32) is None
    assert artifacts.handoff_dir() is None
    assert artifacts.gc_stale_tmp() == 0


_RACE_WRITER = """
import os, sys, time
import numpy as np
sys.path.insert(0, sys.argv[5])
from ramba_tpu_torch.fleet import artifacts
d, val, n, go = sys.argv[1], float(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
artifacts.configure(d)
while not os.path.exists(go):
    time.sleep(0.01)
for i in range(n):
    assert artifacts.memo_store("racekey" + "0" * 25,
                                [np.full(2048, val)])
print("WRITER_DONE", flush=True)
"""


def test_cross_process_write_race(tmp_path):
    artifacts.configure(str(tmp_path))
    go = str(tmp_path / "go")
    writers = [
        subprocess.Popen([sys.executable, "-c", _RACE_WRITER, str(tmp_path),
                          val, "40", go, REPO],
                         cwd=REPO, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for val in ("1.0", "2.0")
    ]
    with open(go, "w") as f:
        f.write("go")
    key = "racekey" + "0" * 25
    reads = complete = 0
    deadline = time.time() + 120
    while any(w.poll() is None for w in writers) and time.time() < deadline:
        got = artifacts.memo_load(key)
        reads += 1
        if got is not None:
            (arr,) = got
            assert arr.shape == (2048,)
            v = arr[0]
            assert v in (1.0, 2.0)
            assert np.all(arr == v)
            complete += 1
    outs = [w.communicate(timeout=60)[0] for w in writers]
    assert all(w.returncode == 0 for w in writers), outs
    assert all("WRITER_DONE" in o for o in outs), outs
    memo_dir = os.path.join(str(tmp_path), "memo")
    blobs = [n for n in os.listdir(memo_dir) if n.endswith(".npz")]
    assert blobs == [key + ".npz"]
    assert reads > 0
    assert artifacts.snapshot()["memo_corrupt"] == 0
    final = artifacts.memo_load(key)[0]
    assert np.all(final == final[0]) and final[0] in (1.0, 2.0)
    assert complete >= 1
    artifacts.gc_stale_tmp(max_age_s=0.0)
    assert not [n for n in os.listdir(memo_dir) if n.startswith(".tmp-")]


def test_shared_memo_lane_serves_a_second_replica(tmp_path, monkeypatch):
    """The lane on (``RAMBA_ARTIFACTS`` + ``RAMBA_MEMO``): a second
    process (this one with its local cache emptied) is served the step
    log's certified results from the lane, with the same bytes."""
    monkeypatch.setenv("RAMBA_ARTIFACTS", str(tmp_path))
    monkeypatch.setenv("RAMBA_MEMO", "1")
    artifacts.reset()
    memo.reset()

    def run():  # one flush a step, as a replica's session runs them
        x = rt.full((256,), 2.0, dtype="float64")
        rt.sync()
        x = x * 1.01 + 1.0
        rt.sync()
        x = x * 1.01 + 2.0
        rt.sync()
        return np.asarray(x), float(rt.sum(x))

    first = run()
    stores = artifacts.snapshot()["memo_stores"]
    assert stores >= 3
    memo.reset()
    h0 = registry.get("memo.shared_hit")
    second = run()
    np.testing.assert_array_equal(second[0], first[0])
    assert second[1] == first[1]
    assert registry.get("memo.shared_hit") - h0 >= 3
    want = np.full(256, 2.0) * 1.01 + 1.0
    np.testing.assert_array_equal(first[0], want * 1.01 + 2.0)
    # RAMBA_MEMO_SHARED=0 turns the lane off
    monkeypatch.setenv("RAMBA_MEMO_SHARED", "0")
    memo.reset()
    h1 = registry.get("memo.shared_hit")
    run()
    assert registry.get("memo.shared_hit") == h1


# ---------------------------------------------------------------------------
# session migration
# ---------------------------------------------------------------------------


def test_migrate_export_adopt_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setenv("RAMBA_ARTIFACTS", str(tmp_path))
    artifacts.configure(str(tmp_path))
    state = {"x": rt.full([32], 3.5), "y": rt.arange(8),
             "_keep": rt.full([4], 1.0)}
    meta = {"tenant": "acme", "trace_id": "t1", "seq": 7}
    path = migrate.export_session("sid-1", meta, state)
    assert os.path.exists(path)
    assert "sid-1" in migrate.list_handoffs()
    manifest, adopted = migrate.adopt_session("sid-1")
    assert manifest["tenant"] == "acme" and manifest["seq"] == 7
    assert manifest["names"] == ["x", "y"]
    assert set(adopted) == {"x", "y"}
    np.testing.assert_array_equal(np.asarray(adopted["x"].asarray()),
                                  np.full(32, 3.5))
    np.testing.assert_array_equal(np.asarray(adopted["y"].asarray()),
                                  np.arange(8))
    migrate.discard("sid-1")
    assert "sid-1" not in migrate.list_handoffs()
    with pytest.raises(migrate.MigrateError):
        migrate.adopt_session("sid-1")


def test_migrate_manifest_validation(tmp_path, monkeypatch):
    monkeypatch.setenv("RAMBA_ARTIFACTS", str(tmp_path))
    artifacts.configure(str(tmp_path))
    with pytest.raises(migrate.MigrateError):
        migrate.load_manifest("never-exported")
    migrate.export_session("sid-2", {"seq": 1}, {"x": rt.full([4], 1.0)})
    src = os.path.join(artifacts.handoff_dir(), "sid-2.manifest.json")
    dst = os.path.join(artifacts.handoff_dir(), "sid-3.manifest.json")
    os.rename(src, dst)
    with pytest.raises(migrate.MigrateError):
        migrate.load_manifest("sid-3")
    # a truncated payload is a torn handoff, caught by the size census
    migrate.export_session("sid-4", {"seq": 1}, {"x": rt.full([64], 1.0)})
    files = migrate._payload_files(migrate._dir_for("sid-4", None))
    with open(files[-1], "ab") as f:
        f.write(b"junk")
    with pytest.raises(migrate.MigrateError, match="torn"):
        migrate.adopt_session("sid-4")


# ---------------------------------------------------------------------------
# the redirect rung
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", ["port", "ramba_tpu"])
def test_classify_redirect_rung(pkg):
    mod = (retry, ReplicaRefusal, ReplicaUnavailable, NoHealthyReplica,
           overload.CircuitOpenError) if pkg == "port" else (
        jretry, jrouter_mod.ReplicaRefusal, jrouter_mod.ReplicaUnavailable,
        jrouter_mod.NoHealthyReplica,
        __import__("ramba_tpu.serve.overload",
                   fromlist=["x"]).CircuitOpenError)
    r, Refusal, Unavailable, NoHealthy, Open = mod
    assert r.classify(Refusal("h:1", {"error": "CircuitOpenError",
                                      "classification": "breaker"})) \
        == "redirect"
    assert r.classify(Unavailable("h:1", "EOFError")) == "redirect"
    assert r.classify(Refusal("h:1", {"error": "QueueFullError",
                                      "classification": "queue_full"})) \
        == "redirect"
    assert r.classify(Open("t", "open")) == "fatal"
    assert r.classify(NoHealthy("all dead")) == "fatal"
    # the same verdict in both packages, for each other's errors too
    e = ReplicaRefusal("h:1", {"error": "x", "classification": "shed"})
    assert jretry.classify(e) == retry.classify(e) == "redirect"


# ---------------------------------------------------------------------------
# fleet.poll and the admission probe
# ---------------------------------------------------------------------------


def test_poll_is_health_plus_rollup(tmp_path, monkeypatch):
    monkeypatch.setenv("RAMBA_FLEET_ENDPOINT", "127.0.0.1:4242")
    d = str(tmp_path / "spool")
    fleet.publish(d)
    now = time.time()
    polled = fleet.poll(d, now=now)
    assert polled["dir"] == d
    ((rid, row),) = polled["health"]["replicas"].items()
    assert polled["health"]["counts"]["healthy"] == 1, row["reason"]
    assert row["state"] == "healthy", row["reason"]
    assert row["signals"]["endpoint"] == "127.0.0.1:4242"
    assert polled["health"] == fleet.health(d, now=now)
    assert "goodput" in polled["rollup"]


def test_admission_verdict_read_only(monkeypatch):
    v = overload.admission_verdict("acme")
    assert v["accepting"] and v["reasons"] == []
    assert v["breaker"] == "closed"
    monkeypatch.setenv("RAMBA_BREAKER_THRESHOLD", "1")
    overload.record_outcome("acme", False)
    v = overload.admission_verdict("acme")
    assert not v["accepting"]
    assert "breaker_open" in v["reasons"]
    assert v["open_breakers"] == ["acme"]
    assert overload.breaker_for("acme").snapshot()["state"] == "open"


# ---------------------------------------------------------------------------
# the router against in-process replica servers
# ---------------------------------------------------------------------------


SEQ = [("init", {"name": "x", "shape": [64], "fill": 2.0,
                 "dtype": "float64"}),
       ("affine", {"name": "x", "a": 1.01, "b": 1.0}),
       ("affine", {"name": "x", "a": 1.01, "b": 2.0})]


def _numpy_digest(n=64):
    x = np.full(n, 2.0)
    x = x * 1.01 + 1.0
    x = x * 1.01 + 2.0
    h = hashlib.sha256()
    for part in (b"x", b"float64", repr((n,)).encode(), x.tobytes()):
        h.update(part)
    return h.hexdigest()


def _servers(mod, n=2):
    servers, threads = [], []
    for _ in range(n):
        s = mod.ReplicaServer()
        t = threading.Thread(target=s.serve_forever, daemon=True)
        t.start()
        servers.append(s)
        threads.append(t)
    return servers, threads


@pytest.fixture()
def two_servers(monkeypatch):
    monkeypatch.setenv("RAMBA_BREAKER_THRESHOLD", "1")
    servers, threads = _servers(replica)
    yield servers
    for s in servers:
        s.stop()
    for t in threads:
        t.join(timeout=10)


def _run_session(router, tenant):
    sid = router.open_session(tenant=tenant)
    for w, p in SEQ:
        router.step(sid, w, p)
    digest = router.step(sid, "digest")["result"]
    router.close_session(sid)
    return digest


def test_router_failover_heals_by_replay(two_servers):
    a, b = two_servers
    router = Router(endpoints=[a.endpoint, b.endpoint])
    reference = _run_session(router, "acme")
    assert reference == _numpy_digest()
    redirects0 = registry.get("router.redirects")
    heals0 = registry.get("router.heals")
    sid = router.open_session(tenant="acme")
    for w, p in SEQ[:2]:
        router.step(sid, w, p)
    victim_ep = router.stats()["sessions"][sid]["endpoint"]
    victim = a if a.endpoint == victim_ep else b
    victim.stop()
    router.step(sid, *SEQ[2])
    digest = router.step(sid, "digest")["result"]
    assert digest == reference
    survivor_ep = b.endpoint if victim is a else a.endpoint
    assert router.stats()["sessions"][sid]["endpoint"] == survivor_ep
    assert registry.get("router.redirects") > redirects0
    assert registry.get("router.heals") > heals0
    assert router.stats()["replicas"][victim_ep]["breaker"]["trips"] >= 1
    router.close_session(sid)


def test_router_refusal_redirects_without_feeding_breaker(
        two_servers, monkeypatch):
    a, b = two_servers
    router = Router(endpoints=[a.endpoint, b.endpoint])
    sid = router.open_session(tenant="globex")
    router.step(sid, *SEQ[0])
    first_ep = router.stats()["sessions"][sid]["endpoint"]
    real = overload.admit_submit
    refusals = {"n": 0}

    def refuse_once(*, tenant=None, priority=False, **kw):
        if refusals["n"] == 0:
            refusals["n"] += 1
            raise overload.ShedError("test-refusal", tenant=tenant)
        return real(tenant=tenant, priority=priority, **kw)

    monkeypatch.setattr(overload, "admit_submit", refuse_once)
    reply = router.step(sid, *SEQ[1])
    assert reply["ok"] and refusals["n"] == 1
    moved_ep = router.stats()["sessions"][sid]["endpoint"]
    assert moved_ep != first_ep
    snap = router.stats()["replicas"][first_ep]["breaker"]
    assert snap == {"state": "closed", "trips": 0, "recent_failures": 0}
    router.close_session(sid)


def test_router_no_healthy_replica_is_terminal(two_servers):
    a, b = two_servers
    router = Router(endpoints=[a.endpoint, b.endpoint])
    sid = router.open_session(tenant="acme")
    router.step(sid, *SEQ[0])
    a.stop()
    b.stop()
    with pytest.raises(NoHealthyReplica):
        router.step(sid, *SEQ[1])


def test_step_log_through_both_packages(monkeypatch):
    """The same step log through a ramba_tpu replica and a port replica:
    the state arrays within 1 ulp (XLA may contract x * a + b into one
    rounding; the port rounds the product and the sum), the sums within
    1e-12 relative, and the port's digest equal to NumPy's exactly."""
    from ramba_tpu.fleet import replica as jreplica
    from ramba_tpu.fleet.router import Router as JRouter

    ours, t1 = _servers(replica, 1)
    theirs, t2 = _servers(jreplica, 1)
    try:
        r, jr = Router(endpoints=[ours[0].endpoint]), \
            JRouter(endpoints=[theirs[0].endpoint])
        sid, jsid = r.open_session(tenant="acme"), jr.open_session(
            tenant="acme")
        for w, p in SEQ:
            r.step(sid, w, p)
            jr.step(jsid, w, p)
        s, js = r.step(sid, "sum")["result"], jr.step(jsid, "sum")["result"]
        assert s == pytest.approx(js, rel=1e-12)
        a = np.asarray(ours[0]._sessions[sid].state["x"].asarray())
        ja = np.asarray(theirs[0]._sessions[jsid].state["x"].asarray())
        assert a.dtype == ja.dtype == np.float64
        np.testing.assert_array_max_ulp(a, ja, maxulp=1)
        assert r.step(sid, "digest")["result"] == _numpy_digest()
        r.close_session(sid)
        jr.close_session(jsid)
    finally:
        from ramba_tpu import serve as jserve

        for s in ours + theirs:
            s.stop()
        jserve.shutdown()


def test_hedges_only_pure_reproducible_steps(two_servers, monkeypatch):
    monkeypatch.setenv("RAMBA_ROUTER_HEDGE", "1")
    monkeypatch.setenv("RAMBA_ROUTER_HEDGE_FACTOR", "1e-9")
    a, b = two_servers
    router = Router(endpoints=[a.endpoint, b.endpoint])
    sid = router.open_session(tenant="acme")
    assert router.stats()["sessions"][sid]["standby"] is not None
    for w, p in SEQ:
        router.step(sid, w, p)
    sums = [router.step(sid, "sum")["result"] for _ in range(8)]
    assert len(set(sums)) == 1
    assert registry.get("router.hedges_fired") >= 1
    assert replica.workload_pure("sum") and replica.workload_reproducible(
        "sum")
    assert not replica.workload_pure("affine")
    # a step whose generic lowering is not reproducible is never hedged
    monkeypatch.setitem(replica.WORKLOAD_OPS, "sum", ("segment_reduce",))
    assert not replica.workload_reproducible("sum")
    fired = registry.get("router.hedges_fired")
    for _ in range(6):
        router.step(sid, "sum")
    assert registry.get("router.hedges_fired") == fired
    assert router.step(sid, "digest")["result"] == _numpy_digest()
    router.close_session(sid)


def test_routed_migration_moves_the_arrays(two_servers, monkeypatch,
                                           tmp_path):
    monkeypatch.setenv("RAMBA_ARTIFACTS", str(tmp_path))
    artifacts.reset()
    a, b = two_servers
    router = Router(endpoints=[a.endpoint, b.endpoint])
    sid = router.open_session(tenant="acme")
    for w, p in SEQ:
        router.step(sid, w, p)
    src = router.stats()["sessions"][sid]["endpoint"]
    dst = b.endpoint if src == a.endpoint else a.endpoint
    reply = router.migrate_session(sid, dst)
    assert reply["names"] == ["x"] and reply["seq"] == 3
    assert router.stats()["sessions"][sid]["endpoint"] == dst
    assert router.stats()["migrations"] >= 1
    assert migrate.list_handoffs() == []
    assert router.step(sid, "digest")["result"] == _numpy_digest()
    assert router.rebalance() == []  # nothing degraded
    assert "ramba_router_migrations_total" in router.metrics_text()
    router.close_session(sid)


def test_fleet_exports_match_ramba_tpu():
    import ramba_tpu.fleet as jfleet_pkg
    import ramba_tpu_torch.fleet as fleet_pkg

    assert getattr(fleet_pkg, "__all__", None) == getattr(
        jfleet_pkg, "__all__", None)
    public = lambda m: {n for n in dir(m)  # noqa: E731
                        if not n.startswith("_")}
    assert public(fleet_pkg) == public(jfleet_pkg)
    for name in ("artifacts", "migrate", "replica", "router"):
        assert public(getattr(jfleet_pkg, name)) <= public(
            getattr(fleet_pkg, name)), name
    # the top level binds the fleet only as far as ramba_tpu does
    import ramba_tpu as rtj

    assert hasattr(rt, "fleet") == hasattr(rtj, "fleet")


# ---------------------------------------------------------------------------
# the one subprocess case: a replica SIGKILLed mid-session
# ---------------------------------------------------------------------------


LIMIT_S = 180  # the case's own limit: its children are killed past it


def test_sigkilled_replica_heals_on_survivor_and_reads_dead(tmp_path,
                                                            monkeypatch):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import fleet_router_torch

    spool = str(tmp_path / "spool")
    env = {"RAMBA_TORCH_DEVICE": "cpu", "RAMBA_FLEET_DIR": spool,
           "RAMBA_FLEET_INTERVAL_S": "0.2",
           "RAMBA_ARTIFACTS": str(tmp_path / "artifacts"),
           "PYTHONPATH": REPO}
    monkeypatch.setenv("RAMBA_BREAKER_THRESHOLD", "1")
    monkeypatch.setenv("RAMBA_ROUTER_TIMEOUT_S", "20")
    t0 = time.monotonic()
    procs = [fleet_router_torch.start_replica(env) for _ in range(2)]
    guard = threading.Timer(LIMIT_S, lambda: [p.kill() for p in procs])
    guard.start()
    try:
        eps = [fleet_router_torch.wait_ready(p, 120) for p in procs]
        router = Router(fleet_dir=spool, endpoints=eps)
        sid = router.open_session(tenant="acme")
        for w, p in SEQ[:2]:
            router.step(sid, w, p)
        victim = eps.index(router.stats()["sessions"][sid]["endpoint"])
        procs[victim].send_signal(signal.SIGKILL)
        procs[victim].wait(timeout=30)
        t_kill = time.time()
        router.step(sid, *SEQ[2])
        assert router.step(sid, "digest")["result"] == _numpy_digest()
        st = router.stats()
        assert st["sessions"][sid]["endpoint"] == eps[1 - victim]
        assert st["redirects"] >= 1 and st["heals"] >= 1
        assert st["replicas"][eps[victim]]["breaker"]["trips"] >= 1
        # the spool reads the corpse dead within 2x its interval
        while time.time() - t_kill < 10:
            h = fleet.health(spool)
            rows = [r for r in h["replicas"].values()
                    if (r.get("signals") or {}).get("endpoint")
                    == eps[victim]]
            if rows and rows[0]["state"] == fleet.DEAD:
                break
            time.sleep(0.02)
        assert rows and rows[0]["state"] == fleet.DEAD
        assert time.time() - t_kill <= 10
        survivor = router.call_replica(eps[1 - victim], "stats")
        assert survivor["counters"]["fleet.replica_steps"] >= 4
        router.shutdown_fleet()
        procs[1 - victim].wait(timeout=30)
        assert time.monotonic() - t0 < LIMIT_S
    finally:
        guard.cancel()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
