"""``scripts/ramba_fsck_torch.py``, the port's offline integrity CLI,
held to the contract of the reference's ``scripts/ramba_fsck.py``: the
reference's smoke (``scripts/lint.sh``: seed, verify, flip a byte,
repair, rescan), then each leg on its own (the artifact tier's memo
blobs, certificates and handoffs; the cache's kernel libraries, entries
and skeletons; a checkpoint directory and a ``CheckpointManager`` root),
and exit 4 on nothing to scan.  Every check is exact (exit codes,
counts, paths).
"""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import ramba_tpu_torch as rt
from ramba_tpu_torch import checkpoint, common
from ramba_tpu_torch.fleet import artifacts, migrate
from ramba_tpu_torch.resilience import elastic, integrity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import ramba_fsck_torch as fsck  # noqa: E402

_ENV = ("RAMBA_ARTIFACTS", "RAMBA_CACHE", "RAMBA_MEMO", "RAMBA_MEMO_SHARED")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    common.set_device("cpu")
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    artifacts.reset()
    yield
    artifacts.reset()


def _flip(path, at=None):
    b = bytearray(open(path, "rb").read())
    b[len(b) // 2 if at is None else at] ^= 0xFF
    open(path, "wb").write(bytes(b))


def _seed_artifacts(root):
    artifacts.configure(root)
    assert artifacts.memo_store("fscksmoke0" * 3 + "ab", [np.arange(16.0)])
    assert artifacts.memo_store("fscksmoke1" * 3 + "cd", [np.ones(4)])


def test_reference_smoke_seed_verify_flip_repair_rescan(tmp_path):
    root = str(tmp_path / "tier")
    _seed_artifacts(root)
    r = fsck.scan(artifacts=root)
    assert r["status"] == 0 and r["scanned"] >= 2, r
    memo = os.path.join(root, "memo")
    blob = os.path.join(memo, sorted(os.listdir(memo))[0])
    _flip(blob)
    r = fsck.scan(artifacts=root)
    assert r["status"] == 1 and r["corrupt"] == 1, r
    r = fsck.scan(artifacts=root, repair=True)
    assert r["status"] == 1
    assert os.path.exists(os.path.join(root, "quarantine", "memo",
                                       os.path.basename(blob)))
    assert not os.path.exists(blob)
    r = fsck.scan(artifacts=root)
    assert r["status"] == 0 and r["scanned"] >= 1, r


def _cli(*args):
    env = dict(os.environ, RAMBA_TORCH_DEVICE="cpu")
    for k in _ENV:
        env.pop(k, None)
    return subprocess.run([sys.executable,
                           os.path.join(REPO, "scripts",
                                        "ramba_fsck_torch.py"), *args],
                          capture_output=True, text=True, env=env,
                          timeout=120)


def test_cli_exit_codes_and_json(tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    assert _cli("--artifacts", str(empty)).returncode == 4
    p = _cli()
    assert p.returncode == 4 and "nothing to scan" in p.stderr, p.stderr
    root = str(tmp_path / "tier")
    _seed_artifacts(root)
    p = _cli("--artifacts", root, "--json")
    assert p.returncode == 0, p.stderr
    doc = json.loads(p.stdout)
    assert doc["status"] == 0 and doc["scanned"] == 2
    memo = os.path.join(root, "memo")
    _flip(os.path.join(memo, sorted(os.listdir(memo))[1]))
    assert _cli("--artifacts", root).returncode == 1
    p = _cli("--artifacts", root, "--repair")
    assert p.returncode == 1 and "quarantined" in p.stdout
    assert _cli("--artifacts", root).returncode == 0


def test_nothing_to_scan_is_exit_4(tmp_path):
    assert fsck.scan()["status"] == 4
    assert fsck.scan(artifacts=str(tmp_path / "missing"),
                     cache=str(tmp_path / "missing2"),
                     checkpoints=[str(tmp_path / "nope")])["status"] == 4
    (tmp_path / "bare").mkdir()
    assert fsck.scan(artifacts=str(tmp_path / "bare"))["status"] == 4


def test_plan_certificates_and_handoffs(tmp_path):
    root = str(tmp_path / "tier")
    artifacts.configure(root)
    os.makedirs(os.path.join(root, "plancert"), exist_ok=True)
    cert = os.path.join(root, "plancert", "c0.json")
    with open(cert, "wb") as f:
        f.write(integrity.wrap(b'{"plan": 1}', "plancert.json"))
    x = rt.fromarray(np.arange(64.0))
    migrate.export_session("s1", {"tenant": "t"}, {"x": x},
                           os.path.join(root, "handoff"))
    r = fsck.scan(artifacts=root)
    # the certificate, the handoff manifest, its sidecar and its files
    assert r["status"] == 0 and r["scanned"] >= 4, r
    _flip(cert)
    r = fsck.scan(artifacts=root)
    assert r["corrupt"] == 1 and r["legs"][0]["corrupt"][0]["path"] == cert
    os.remove(cert)
    leaf = next(os.path.join(dp, n) for dp, _d, ns in
                os.walk(os.path.join(root, "handoff", "s1")) for n in ns
                if n.endswith(".npy"))
    _flip(leaf, at=os.path.getsize(leaf) - 1)
    r = fsck.scan(artifacts=root)
    assert r["status"] == 1
    assert [c["reason"] for c in r["legs"][0]["corrupt"]] == ["digest"]
    open(leaf, "ab").write(b"x")
    r = fsck.scan(artifacts=root)
    reasons = sorted(c["reason"] for c in r["legs"][0]["corrupt"])
    assert reasons[0].startswith("length:") and \
        reasons[1].startswith("payload_bytes:"), reasons


def _kernel(d, name, writer=None, body=b"\x7fELF library bytes"):
    so = os.path.join(d, name)
    with open(so, "wb") as f:
        f.write(body)
    doc = {"digest": hashlib.sha256(body).hexdigest(),
           "writer": writer or {"host": "h0", "pid": 7}}
    with open(so + ".sha", "wb") as f:
        f.write(integrity.wrap(json.dumps(doc).encode(), "kernel.so"))
    return so


def test_cache_kernels_entries_and_skeletons(tmp_path):
    root = str(tmp_path / "cache")
    for sub in ("kernels", "aot", "programs"):
        os.makedirs(os.path.join(root, sub))
    k0 = _kernel(os.path.join(root, "kernels"), "elemred_0.so")
    _kernel(os.path.join(root, "kernels"), "segred_1.so",
            writer={"host": "h1", "pid": 9})
    aot = os.path.join(root, "aot", "e.aot")
    with open(aot, "wb") as f:
        f.write(integrity.wrap(b"entry", "aot.pkl"))
    prog = os.path.join(root, "programs", "p.pkl")
    with open(prog, "wb") as f:
        f.write(integrity.wrap(b"skeleton", "program.pkl"))
    r = fsck.scan(cache=root)
    assert r["status"] == 0 and r["scanned"] == 4, r
    assert r["legs"][0]["writers"] == {"h0:7": 1, "h1:9": 1}
    # a flipped library, an entry under the wrong schema, a lone digest
    _flip(k0)
    with open(prog, "wb") as f:
        f.write(integrity.wrap(b"skeleton", "aot.pkl"))
    orphan = _kernel(os.path.join(root, "kernels"), "scan_2.so")
    os.remove(orphan)
    r = fsck.scan(cache=root)
    got = {os.path.basename(c["path"]): c["reason"]
           for c in r["legs"][0]["corrupt"]}
    assert got == {"elemred_0.so": "library",
                   "p.pkl": "schema:'aot.pkl'",
                   "scan_2.so.sha": "missing library"}, got
    r = fsck.scan(cache=root, repair=True)
    q = os.path.join(root, "quarantine")
    assert sorted(os.listdir(os.path.join(q, "kernels"))) == [
        "elemred_0.so", "elemred_0.so.sha", "scan_2.so.sha"]
    r = fsck.scan(cache=root)
    assert r["status"] == 0 and r["scanned"] == 2, r


def test_checkpoint_tree_and_manager_steps(tmp_path):
    path = str(tmp_path / "ck")
    checkpoint.save(path, {"a": rt.fromarray(np.arange(12.0).reshape(3, 4)),
                           "b": rt.fromarray(np.ones(5, np.int32))},
                    force=True)
    r = fsck.scan(checkpoints=[path])
    # the sidecar, its files, the tree manifest and its two leaves
    assert r["status"] == 0 and r["scanned"] >= 6, r
    leaf = os.path.join(path, sorted(n for n in os.listdir(path)
                                     if n.endswith(".npy"))[0])
    _flip(leaf, at=os.path.getsize(leaf) - 2)
    r = fsck.scan(checkpoints=[path])
    assert [c["reason"] for c in r["legs"][0]["corrupt"]] == ["digest"]
    r = fsck.scan(checkpoints=[path], repair=True)
    # the whole checkpoint moves, its sidecar with it: nothing is left
    q = os.path.join(str(tmp_path), "quarantine")
    assert sorted(os.listdir(q)) == ["ck", "ck.digests.json"]
    assert os.path.exists(os.path.join(q, "ck", os.path.basename(leaf)))
    assert fsck.scan(checkpoints=[path])["status"] == 4

    root = str(tmp_path / "mgr")
    mgr = elastic.CheckpointManager(root)
    for step in (1, 2):
        mgr.save(step, {"x": rt.fromarray(np.full(8, float(step)))})
    r = fsck.scan(checkpoints=[root])
    assert r["status"] == 0, r
    man = mgr.manifest_path(2)
    doc = json.load(open(man))
    doc["step"] = 3
    json.dump(doc, open(man, "w"))
    r = fsck.scan(checkpoints=[root])
    assert [(c["schema"], c["reason"]) for c in r["legs"][0]["corrupt"]] \
        == [("elastic.manifest", "digest")]
    fsck.scan(checkpoints=[root], repair=True)
    assert fsck.scan(checkpoints=[root])["status"] == 0
    # a flipped leaf of step 2: the step goes to quarantine, step 1 stays
    leaf = next(os.path.join(d, n) for d, _s, ns in
                os.walk(mgr.step_dir(2)) for n in ns if n.endswith(".npy"))
    _flip(leaf, at=os.path.getsize(leaf) - 1)
    r = fsck.scan(checkpoints=[root], repair=True)
    assert r["status"] == 1
    assert [q["to"] for q in r["legs"][0]["quarantined"]] == [
        os.path.join(root, "quarantine", os.path.basename(mgr.step_dir(2)))]
    r = fsck.scan(checkpoints=[root])
    assert r["status"] == 0 and r["scanned"] >= 4, r
    assert elastic.CheckpointManager(root).latest() == 1


def test_scan_strikes_no_suspect_window(tmp_path):
    integrity.reset()
    root = str(tmp_path / "tier")
    _seed_artifacts(root)
    memo = os.path.join(root, "memo")
    _flip(os.path.join(memo, sorted(os.listdir(memo))[0]))
    before = integrity.failure_count()
    assert fsck.scan(artifacts=root)["status"] == 1
    assert integrity.failure_count() == before
    assert not integrity.suspect()
    torch.set_num_threads(1)
