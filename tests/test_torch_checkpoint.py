"""``ramba_tpu_torch.checkpoint`` and ``integrity.array_digest`` against
ramba_tpu, x64 regime.

* ``array_digest`` of the same values equals ramba_tpu's exactly (dtype
  string, shape repr and C-order bytes), for every dtype here, 0-d and
  bool arrays among them, and for a leaf streamed from a tensor in many
  chunks.
* The digest sidecar of a checkpoint of the same tree names and digests
  its leaves as ramba_tpu's sidecar does (the files differ: Orbax there,
  ``.npy`` leaves here).
* The checkpoint cases of ``tests/test_resilience.py:363-447`` and
  ``tests/test_integrity.py:359-447`` that need no spill or memo plane:
  the atomic save, ``force``, ``checkpoint_io`` retries, corrupt and
  mismatched restores, the digest sidecar, a clobbered leaf, the
  ``checkpoint:leaf`` flip, an unstamped and a corrupt sidecar, the plane
  switched off.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import ml_dtypes
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from ramba_tpu.resilience import integrity as integrity_j
from ramba_tpu_torch import checkpoint, common
from ramba_tpu_torch.core import staging
from ramba_tpu_torch.observe import events, registry
from ramba_tpu_torch.resilience import faults, integrity, retry

DIGEST_CASES = {
    "f64": np.arange(64.0).reshape(8, 8) * 1.5,
    "f32": np.linspace(-3, 3, 17, dtype=np.float32),
    "f16": np.arange(10, dtype=np.float16) / 3,
    "i64": np.arange(-20, 20, dtype=np.int64).reshape(2, 4, 5),
    "i32": np.arange(9, dtype=np.int32),
    "i8": np.arange(-5, 5, dtype=np.int8),
    "u8": np.arange(200, 210, dtype=np.uint8),
    "u32": np.arange(5, dtype=np.uint32) * 7,
    "bool": np.arange(11) % 3 == 0,
    "c128": np.arange(6) * (1 + 2j),
    "bf16": (np.arange(12) / 7).astype(ml_dtypes.bfloat16).reshape(3, 4),
    "zero_d_f64": np.float64(3.25),
    "zero_d_bool": np.bool_(True),
    "zero_d_i64": np.int64(-7),
    "empty": np.zeros((0, 3)),
}


@pytest.fixture(autouse=True)
def _isolate(monkeypatch):
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    torch.set_num_threads(1)
    monkeypatch.setenv("RAMBA_RETRY_BASE_S", "0.001")
    for k in ("RAMBA_INTEGRITY", "RAMBA_FAULTS"):
        monkeypatch.delenv(k, raising=False)
    faults.configure(None)
    integrity.reset()
    yield
    faults.reset()
    integrity.reset()


@pytest.mark.parametrize("name", sorted(DIGEST_CASES))
def test_array_digest_equals_reference(name):
    v = np.asarray(DIGEST_CASES[name])
    want = integrity_j.array_digest(rtj.fromarray(v))
    assert integrity_j.array_digest(v) == want
    assert integrity.array_digest(rt.fromarray(v)) == want
    assert integrity.array_digest(rt.fromarray(v)._value()) == want
    assert integrity.array_digest(v) == want


def test_array_digest_streams_in_chunks(monkeypatch):
    v = np.random.RandomState(0).rand(37, 11)
    want = integrity_j.array_digest(v)
    monkeypatch.setattr(staging, "CHUNK_BYTES", 64)
    b0 = integrity.stats["digest_bytes"]
    assert integrity.array_digest(rt.fromarray(v)) == want
    assert integrity.stats["digest_bytes"] == b0 + v.nbytes
    # a non-contiguous tensor digests as its C-order copy
    t = torch.from_numpy(v.T.copy()).T
    assert not t.is_contiguous()
    assert integrity.array_digest(t) == want


def _tree():
    return {"w": rt.arange(64).reshape(8, 8) * 1.5, "b": rt.arange(8) * 0.25}


def _tree_j():
    return {"w": rtj.arange(64).reshape(8, 8) * 1.5,
            "b": rtj.arange(8) * 0.25}


def _sidecar(path, mod=checkpoint):
    with open(mod.digests_path(path), "rb") as f:
        raw = f.read()
    return json.loads(integrity.unwrap(raw, "ckpt.digests.json", site="t",
                                       record=False).decode())


def test_sidecar_leaves_match_reference(tmp_path):
    pytest.importorskip("orbax.checkpoint")
    from ramba_tpu import checkpoint as checkpoint_j

    p, pj = str(tmp_path / "ck"), str(tmp_path / "ckj")
    tree = {"grid": rt.arange(12.0).reshape(3, 4), "step": 100,
            "hist": [rt.arange(5), rt.ones(3, dtype=bool)]}
    tree_j = {"grid": rtj.arange(12.0).reshape(3, 4), "step": 100,
              "hist": [rtj.arange(5), rtj.ones(3, dtype=bool)]}
    checkpoint.save(p, tree)
    checkpoint_j.save(pj, tree_j)
    assert _sidecar(p)["leaves"] == _sidecar(pj, checkpoint_j)["leaves"]


def test_round_trip_of_a_nested_tree(tmp_path):
    p = str(tmp_path / "ck")
    tree = {"grid": rt.fromarray(np.arange(12.0).reshape(3, 4)), "step": 100,
            "opt": [rt.arange(5), None, (rt.ones(3, dtype=np.float32),)],
            "flag": np.bool_(True)}
    checkpoint.save(p, tree)
    back = checkpoint.restore(p)
    assert sorted(back) == ["flag", "grid", "opt", "step"]
    assert int(back["step"]) == 100 and back["step"].dtype == np.int64
    np.testing.assert_array_equal(back["grid"].asarray(),
                                  np.arange(12.0).reshape(3, 4))
    assert back["opt"][1] is None and isinstance(back["opt"][2], tuple)
    assert back["opt"][2][0].dtype == np.float32
    assert bool(back["flag"]) is True
    assert back["grid"]._value().device == common.device()
    with open(os.path.join(p, "leaf_0.npy"), "rb") as f:
        assert np.load(f).dtype == np.bool_  # "flag" sorts first


def test_failed_save_preserves_published(tmp_path, monkeypatch):
    monkeypatch.setenv("RAMBA_RETRY_ATTEMPTS", "2")
    p = str(tmp_path / "ck_atomic")
    checkpoint.save(p, {"w": rt.arange(100) * 1.0})
    with faults.inject("checkpoint_io", "always"):
        with pytest.raises(retry.RetryBudgetExhausted):
            checkpoint.save(p, {"w": rt.arange(100) * 3.0}, force=True)
    back = checkpoint.restore(p)
    np.testing.assert_allclose(back["w"].asarray(), np.arange(100) * 1.0)
    junk = p + ".ramba-tmp"
    os.makedirs(junk, exist_ok=True)
    with open(os.path.join(junk, "partial"), "w") as f:
        f.write("torn write")
    purged = registry.get("checkpoint.tmp_purged")
    checkpoint.save(p, {"w": rt.arange(100) * 3.0}, force=True)
    assert registry.get("checkpoint.tmp_purged") == purged + 1
    back2 = checkpoint.restore(p)
    np.testing.assert_allclose(back2["w"].asarray(), np.arange(100) * 3.0)
    assert not os.path.exists(junk)


def test_save_refuses_overwrite_without_force(tmp_path):
    p = str(tmp_path / "ck_nof")
    checkpoint.save(p, {"w": rt.arange(16) * 1.0})
    with pytest.raises(ValueError, match="force=True"):
        checkpoint.save(p, {"w": rt.arange(16) * 2.0})


def test_checkpoint_io_retries_transient_fault(tmp_path):
    p = str(tmp_path / "ck_retry")
    before = registry.get("resilience.retries.checkpoint_io")
    saves = registry.get("checkpoint.saves")
    with faults.inject("checkpoint_io", "once"):
        checkpoint.save(p, {"w": rt.arange(32) * 2.0})
    assert registry.get("resilience.retries.checkpoint_io") == before + 1
    assert registry.get("checkpoint.saves") == saves + 1
    with faults.inject("checkpoint_io", "once"):
        back = checkpoint.restore(p)
    assert registry.get("resilience.retries.checkpoint_io") == before + 2
    np.testing.assert_allclose(back["w"].asarray(), np.arange(32) * 2.0)


def test_restore_corrupt_raises_clear_error(tmp_path):
    with pytest.raises(checkpoint.CheckpointCorruptError,
                       match="no checkpoint directory"):
        checkpoint.restore(str(tmp_path / "ck_missing"))
    empty = tmp_path / "ck_empty"
    empty.mkdir()
    with pytest.raises(checkpoint.CheckpointCorruptError):
        checkpoint.restore(str(empty))


def test_unreadable_leaf_chains_the_cause(tmp_path):
    p = str(tmp_path / "ck")
    checkpoint.save(p, {"w": rt.arange(8) * 1.0})
    os.remove(checkpoint.digests_path(p))
    with open(os.path.join(p, "leaf_0.npy"), "wb") as f:
        f.write(b"not an npy file")
    with pytest.raises(checkpoint.CheckpointCorruptError) as ei:
        checkpoint.restore(p)
    assert ei.value.__cause__ is not None


def test_restore_target_mismatch(tmp_path):
    p = str(tmp_path / "ck_tgt")
    w = rt.arange(64) * 1.0
    checkpoint.save(p, {"w": w})
    with pytest.raises(checkpoint.CheckpointCorruptError):
        checkpoint.restore(p, {"w": np.zeros(32)})
    with pytest.raises(checkpoint.CheckpointCorruptError):
        checkpoint.restore(p, {"w": np.zeros(64, np.float32)})
    with pytest.raises(checkpoint.CheckpointCorruptError):
        checkpoint.restore(p, {"w": w, "extra": w})  # structure mismatch
    with pytest.raises(TypeError):
        checkpoint.restore(p, {"w": 3.0})
    back = checkpoint.restore(p, {"w": rt.zeros(64)})
    np.testing.assert_array_equal(back["w"].asarray(), np.arange(64) * 1.0)


def test_save_writes_sidecar_restore_verifies(tmp_path):
    p = str(tmp_path / "ck")
    written = registry.get("checkpoint.digests_written")
    checkpoint.save(p, _tree())
    assert registry.get("checkpoint.digests_written") == written + 1
    doc = _sidecar(p)
    assert sorted(doc["files"]) == ["leaf_0.npy", "leaf_1.npy", "tree.json"]
    assert sorted(doc["leaves"]) == ["['b']", "['w']"]
    v0 = integrity.stats["verified"]
    back = checkpoint.restore(p)
    np.testing.assert_allclose(back["w"].asarray(),
                               np.arange(64).reshape(8, 8) * 1.5)
    assert integrity.stats["verified"] > v0


def test_clobbered_leaf_file_raises(tmp_path):
    p = str(tmp_path / "ck")
    checkpoint.save(p, _tree())
    doc = _sidecar(p)
    rel = max(doc["files"], key=lambda r: doc["files"][r]["size"])
    full = os.path.join(os.path.abspath(p), rel)
    size = os.path.getsize(full)
    with open(full, "wb") as f:
        f.write(b"\x5a" * size)
    i0 = integrity.stats["failures"]
    with pytest.raises(checkpoint.CheckpointCorruptError):
        checkpoint.restore(p)
    assert integrity.stats["failures"] > i0
    ev = events.last(6, type="integrity")
    assert any(e["site"] == "checkpoint:leaf" for e in ev), ev


def test_truncated_leaf_file_raises(tmp_path):
    p = str(tmp_path / "ck")
    checkpoint.save(p, _tree())
    full = os.path.join(p, "leaf_1.npy")
    with open(full, "rb+") as f:
        f.truncate(os.path.getsize(full) - 8)
    with pytest.raises(checkpoint.CheckpointCorruptError, match="bytes"):
        checkpoint.restore(p)


def test_flip_seam_detected(tmp_path):
    p = str(tmp_path / "ck")
    checkpoint.save(p, _tree())
    faults.configure("checkpoint:leaf:flip:bytes=2")
    with pytest.raises(checkpoint.CheckpointCorruptError):
        checkpoint.restore(p)
    # the flip persisted on disk: a later restore with no faults armed
    # still refuses it
    faults.configure(None)
    with pytest.raises(checkpoint.CheckpointCorruptError):
        checkpoint.restore(p)


def test_leaf_digest_catches_what_the_files_miss(tmp_path, monkeypatch):
    # a leaf file rewritten with its sidecar entry forged: the logical
    # digest of the restored value still disagrees
    p = str(tmp_path / "ck")
    checkpoint.save(p, _tree())
    full = os.path.join(p, "leaf_0.npy")
    np.save(full, np.arange(8) * 0.5)
    doc = _sidecar(p)
    doc["files"]["leaf_0.npy"] = {"sha256": integrity.file_digest(full),
                                  "size": os.path.getsize(full)}
    with open(checkpoint.digests_path(p), "wb") as f:
        f.write(integrity.wrap(json.dumps(doc, sort_keys=True).encode(),
                               "ckpt.digests.json"))
    with pytest.raises(checkpoint.CheckpointCorruptError,
                       match="content-digest"):
        checkpoint.restore(p)


def test_legacy_checkpoint_without_sidecar_restores(tmp_path):
    p = str(tmp_path / "ck")
    checkpoint.save(p, _tree())
    os.remove(checkpoint.digests_path(p))
    back = checkpoint.restore(p)
    np.testing.assert_allclose(back["b"].asarray(), np.arange(8) * 0.25)


def test_corrupt_sidecar_raises(tmp_path):
    p = str(tmp_path / "ck")
    checkpoint.save(p, _tree())
    sp = checkpoint.digests_path(p)
    raw = bytearray(open(sp, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(sp, "wb").write(bytes(raw))
    with pytest.raises(checkpoint.CheckpointCorruptError):
        checkpoint.restore(p)


def test_disabled_plane_writes_no_sidecar(tmp_path, monkeypatch):
    monkeypatch.setenv("RAMBA_INTEGRITY", "0")
    p = str(tmp_path / "ck")
    checkpoint.save(p, _tree())
    assert not os.path.exists(checkpoint.digests_path(p))
    back = checkpoint.restore(p)
    np.testing.assert_allclose(back["b"].asarray(), np.arange(8) * 0.25)


def test_reference_sidecar_digest_of_its_tree(tmp_path):
    # the reference's own sidecar digests its leaves with the digest the
    # port computes for the same values
    pytest.importorskip("orbax.checkpoint")
    from ramba_tpu import checkpoint as checkpoint_j

    pj = str(tmp_path / "ckj")
    checkpoint_j.save(pj, _tree_j())
    leaves = _sidecar(pj, checkpoint_j)["leaves"]
    assert leaves["['w']"]["sha256"] == integrity.array_digest(_tree()["w"])
    assert leaves["['b']"]["sha256"] == integrity.array_digest(_tree()["b"])


def test_several_processes_wait_for_multi_gpu(tmp_path, monkeypatch):
    # several processes are the process group's (tests/test_torch_
    # distributed.py saves and restores across ranks); the event stream's
    # identity alone forms no group, so this is one process's checkpoint
    monkeypatch.setattr(events, "rank_info", lambda: (0, 2))
    checkpoint.save(str(tmp_path / "ck"), {"w": rt.arange(4)})
    got = checkpoint.restore(str(tmp_path / "ck"))["w"]
    np.testing.assert_array_equal(got.asarray(), np.arange(4))


def test_bfloat16_leaf_round_trips(tmp_path):
    # NumPy stores bfloat16 as raw 2-byte void; the manifest's dtype reads
    # it back
    v = (np.arange(24) / 7).astype(ml_dtypes.bfloat16).reshape(4, 6)
    p = str(tmp_path / "ck")
    checkpoint.save(p, {"g": rt.fromarray(v)})
    back = checkpoint.restore(p)["g"].asarray()
    assert back.dtype == v.dtype
    np.testing.assert_array_equal(back.view(np.uint16), v.view(np.uint16))
