"""Checkpoint/restore of trees of port arrays.

Counterpart of ``ramba_tpu/checkpoint.py``.  The reference writes through
Orbax; the port needs only NumPy and torch, so its format is its own: a
directory holding a tree manifest (``tree.json``: the tree's structure,
and each leaf's file, shape and dtype) and one ``.npy`` file per leaf,
readable by NumPy and covered by the digest sidecar.  Leaves go to and
from the card chunk by chunk (``fileio.write_npy``/``read_npy``), so no
leaf stands whole in host memory.  The port cannot read an Orbax
checkpoint and ``ramba_tpu`` cannot read the port's (a divergence kept
on purpose: Orbax is not installed beside the port).

Trees are dicts (keys sorted, as ``jax.tree_util`` orders them), lists,
tuples and None (an empty subtree); anything else is a leaf: a port array
stays on the device, any other value is saved as ``np.asarray(value)``.
Leaves are named by their path in ``jax.tree_util.keystr``'s spelling
(``['grid']``, ``[0]``), so the digest sidecar names leaves as the
reference's does.

Resilience contract (the reference's):

* ``save`` is **atomic**: it writes into ``<path>.ramba-tmp`` and renames
  it into place once complete, so the published path always holds either
  the old complete checkpoint or the new one.  Overwriting needs
  ``force=True``; a crashed writer's debris is purged before staging.
* Transient I/O failures retry under ``resilience.retry`` (site
  ``checkpoint_io``, also the ``RAMBA_FAULTS=checkpoint_io:...``
  injection site).
* A digest sidecar (``<path>.digests.json``, integrity-wrapped) records
  each leaf's logical digest (``integrity.array_digest``, equal to the
  reference's for the same values) and each file's sha256 and size;
  ``restore`` verifies the files before reading and the leaves after.
  ``RAMBA_FAULTS='checkpoint:leaf:flip:...'`` flips bytes of the first
  leaf file upstream of that check.
* ``restore`` validates what came back and wraps unreadable, corrupt or
  mismatched checkpoints in :class:`CheckpointCorruptError` with the
  original error chained.

Several processes (a mesh of ranks, ``parallel/distributed.py``): every
rank calls ``save`` and ``restore``.  ``save`` gathers each leaf to every
rank, the driver (rank 0) alone stages, writes, renames and writes the
digests, and every rank learns whether it succeeded (an all-reduce that
is also the barrier).  ``restore`` has each rank read only its block of
every leaf; the leaf digests are taken over the gathered leaves.

API:

    ramba_tpu_torch.checkpoint.save(path, {"w": W, "b": B})
    state = ramba_tpu_torch.checkpoint.restore(path)
    state = ramba_tpu_torch.checkpoint.restore(path, target)
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch

from ramba_tpu_torch import fileio
from ramba_tpu_torch.core.fuser import flush
from ramba_tpu_torch.core.ndarray import ndarray
from ramba_tpu_torch.observe import registry as _registry
from ramba_tpu_torch.resilience import faults as _faults
from ramba_tpu_torch.resilience import integrity as _integrity
from ramba_tpu_torch.parallel import distributed as _distributed
from ramba_tpu_torch.resilience import retry as _retry


class CheckpointCorruptError(RuntimeError):
    """The on-disk checkpoint is missing, unreadable, structurally wrong,
    or does not match the requested restore target."""


# Deterministic tmp sibling (not mkdtemp): a crashed writer's debris is
# findable.
_TMP_SUFFIX = ".ramba-tmp"
_MANIFEST = "tree.json"

# Digest sidecar published after the rename: logical per-leaf content
# digests plus a file-level digest map of the published directory.  Lives
# OUTSIDE the checkpoint directory.
_DIGESTS_SUFFIX = ".digests.json"
_DIGESTS_SCHEMA = "ckpt.digests.json"


def digests_path(path: str) -> str:
    return os.path.abspath(path) + _DIGESTS_SUFFIX


# ---------------------------------------------------------------------------
# trees: dict / list / tuple / None, everything else a leaf
# ---------------------------------------------------------------------------


def _flatten(tree, prefix=""):
    """``(treedef, [(keystr, leaf), ...])``: the structure as JSON-ready
    data, the leaves in order."""
    if tree is None:
        return {"t": "none"}, []
    if isinstance(tree, dict):
        keys = sorted(tree)
        defs, leaves = [], []
        for k in keys:
            d, ls = _flatten(tree[k], f"{prefix}[{k!r}]")
            defs.append(d)
            leaves += ls
        return {"t": "dict", "keys": keys, "c": defs}, leaves
    if isinstance(tree, (list, tuple)):
        defs, leaves = [], []
        for i, v in enumerate(tree):
            d, ls = _flatten(v, f"{prefix}[{i}]")
            defs.append(d)
            leaves += ls
        return {"t": type(tree).__name__, "c": defs}, leaves
    return {"t": "leaf"}, [(prefix, tree)]


def _unflatten(treedef, leaves):
    it = iter(leaves)

    def build(d):
        t = d["t"]
        if t == "none":
            return None
        if t == "leaf":
            return next(it)
        kids = [build(c) for c in d["c"]]
        if t == "dict":
            return dict(zip(d["keys"], kids))
        return tuple(kids) if t == "tuple" else kids

    return build(treedef)


def _leaf_value(x):
    """A leaf as saved: the tensor of a port array, a host array else."""
    if isinstance(x, ndarray):
        return x._value()
    if isinstance(x, torch.Tensor):
        return x
    return np.asarray(x)


# ---------------------------------------------------------------------------
# digests
# ---------------------------------------------------------------------------


def _write_digests(apath: str, items) -> None:
    """Sidecar publish (post-rename).  Best-effort: a failed digest pass
    removes any stale sidecar rather than leaving one that contradicts the
    new checkpoint."""
    side = apath + _DIGESTS_SUFFIX
    if not _integrity.enabled():
        try:  # a stale sidecar must not contradict the new checkpoint
            os.unlink(side)
        except OSError:
            pass
        return
    try:
        leaves = {}
        for keystr, v in items:
            shape, dtype = fileio._arr_meta(v)
            leaves[keystr] = {"sha256": _integrity.array_digest(v),
                              "shape": list(shape), "dtype": str(dtype)}
        files = {}
        for root, _dirs, names in os.walk(apath):
            for name in names:
                full = os.path.join(root, name)
                rel = os.path.relpath(full, apath)
                files[rel] = {"sha256": _integrity.file_digest(full),
                              "size": os.path.getsize(full)}
        doc = {"schema": 1, "leaves": leaves, "files": files}
        data = _integrity.wrap(json.dumps(doc, sort_keys=True).encode(),
                               _DIGESTS_SCHEMA)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(side) or ".",
                                   prefix=".tmp-")
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, side)
        _registry.inc("checkpoint.digests_written")
    except Exception:  # noqa: BLE001 — the sidecar must never fail a save
        try:
            os.unlink(side)
        except OSError:
            pass


def _load_digests(apath: str):
    """Parse a checkpoint's digest sidecar.  ``None`` when absent (an
    unstamped checkpoint restores unverified); a corrupt sidecar raises —
    an unverifiable checkpoint must not be served silently."""
    side = apath + _DIGESTS_SUFFIX
    try:
        with open(side, "rb") as f:
            raw = f.read()
    except OSError:
        return None
    if not _integrity.enabled():
        return None
    try:
        payload = _integrity.unwrap(raw, _DIGESTS_SCHEMA,
                                    site="checkpoint:leaf")
        return json.loads(payload.decode())
    except (_integrity.IntegrityError, ValueError) as e:
        raise CheckpointCorruptError(
            f"checkpoint digest sidecar at {side!r} is corrupt ({e})"
        ) from e


def _verify_files(path: str, apath: str, doc: dict) -> None:
    """Pre-restore scan: every file the save stamped must still be
    byte-identical.  This catches a clobbered or truncated leaf file even
    when its bytes would still parse."""
    files = doc.get("files") or {}
    if _faults.configured("checkpoint:leaf") and files:
        # flip seam (RAMBA_FAULTS='checkpoint:leaf:flip:...'): physically
        # corrupt the first stamped data file, upstream of verification
        rel = sorted(files)[0]
        _faults.corrupt_file("checkpoint:leaf", os.path.join(apath, rel))
    for rel, want in sorted(files.items()):
        full = os.path.join(apath, rel)
        try:
            size = os.path.getsize(full)
        except OSError as e:
            _integrity.failure("checkpoint:leaf", "missing", detail=rel)
            raise CheckpointCorruptError(
                f"checkpoint at {path!r} is missing leaf file {rel!r} "
                f"({e})") from e
        if size != want.get("size"):
            _integrity.failure("checkpoint:leaf", "length", detail=rel)
            raise CheckpointCorruptError(
                f"checkpoint at {path!r} leaf file {rel!r} is "
                f"{size} bytes, manifest says {want.get('size')}")
        if _integrity.file_digest(full) != want.get("sha256"):
            _integrity.failure("checkpoint:leaf", "digest", detail=rel)
            raise CheckpointCorruptError(
                f"checkpoint at {path!r} leaf file {rel!r} failed digest "
                f"verification (silent corruption)")


def _verify_leaves(path: str, items, doc: dict) -> None:
    """Post-restore logical check: the restored arrays' content digests
    (streamed from the device) must match what was stamped at save time —
    end-to-end coverage of the disk -> host -> device path."""
    leaves = doc.get("leaves")
    if not leaves:
        return
    for keystr, v in items:
        want = leaves.get(keystr)
        if want is None:
            continue
        if _integrity.array_digest(v) != want["sha256"]:
            _integrity.failure("checkpoint:leaf", "digest", detail=keystr)
            raise CheckpointCorruptError(
                f"checkpoint at {path!r} restored leaf {keystr!r} failed "
                f"content-digest verification (silent corruption)")


# ---------------------------------------------------------------------------
# save / restore
# ---------------------------------------------------------------------------


def _barrier(tag: str) -> None:
    """Cross-process sync point (``distributed.barrier``; nothing to do
    with one process)."""
    _distributed.barrier(tag)


def _on_driver(fn) -> None:
    """``fn()`` on the driver; with several processes every rank then
    learns whether it succeeded, so a failed write raises everywhere."""
    if _distributed.process_count() <= 1:
        fn()
        return
    err = None
    if _distributed.in_driver():
        try:
            fn()
        except Exception as e:  # re-raised below, after the agreement
            err = e
    failed = _distributed.all_reduce_int(0 if err is None else 1, "max")
    if err is not None:
        raise err
    if failed:
        raise RuntimeError("the driver (process 0) failed to write the "
                           "checkpoint; see its log for the original "
                           "exception")


def _purge_stale_tmp(apath: str) -> None:
    """Remove a crashed writer's staging debris (``<path>.ramba-tmp`` and
    anything under that prefix) before staging again."""
    parent, base = os.path.split(apath)
    tmp_base = base + _TMP_SUFFIX
    if os.path.isdir(parent):
        for name in os.listdir(parent):
            if name == tmp_base or name.startswith(tmp_base + "."):
                shutil.rmtree(os.path.join(parent, name), ignore_errors=True)
                _registry.inc("checkpoint.tmp_purged")


def _write_tree(dirpath: str, treedef, items) -> None:
    os.makedirs(dirpath)
    leaves = []
    for i, (keystr, v) in enumerate(items):
        fname = f"leaf_{i}.npy"
        fileio.write_npy(os.path.join(dirpath, fname), v)
        shape, dtype = fileio._arr_meta(v)
        leaves.append({"key": keystr, "file": fname, "shape": list(shape),
                       "dtype": str(dtype)})
    with open(os.path.join(dirpath, _MANIFEST), "w") as f:
        json.dump({"format": 1, "tree": treedef, "leaves": leaves}, f)


def save(path: str, tree, *, force: bool = False) -> None:
    """Write a tree of port arrays (chunk by chunk from the device).

    ``force=False`` errors if ``path`` already holds a checkpoint instead
    of deleting it; pass ``force=True`` to overwrite deliberately.  The
    write is staged + renamed, so with ``force=True`` a crash mid-save
    leaves the previous checkpoint intact."""
    apath = os.path.abspath(path)
    if os.path.exists(apath) and not force:
        raise ValueError(
            f"refusing to overwrite existing checkpoint at {path!r}; "
            f"pass force=True"
        )
    flush()
    treedef, items = _flatten(tree)
    items = [(k, _leaf_value(v)) for k, v in items]
    tmp = apath + _TMP_SUFFIX

    def write():
        _faults.check("checkpoint_io", op="save")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)  # debris from a failed earlier attempt
        _write_tree(tmp, treedef, items)

    def publish():
        _purge_stale_tmp(apath)
        _retry.call("checkpoint_io", write)
        if os.path.exists(apath):
            shutil.rmtree(apath)
        os.replace(tmp, apath)
        _write_digests(apath, items)

    _on_driver(publish)
    _registry.inc("checkpoint.saves")


def _read_manifest(path: str, apath: str) -> dict:
    try:
        with open(os.path.join(apath, _MANIFEST)) as f:
            man = json.load(f)
        if not isinstance(man, dict) or not {"tree", "leaves"} <= set(man):
            raise ValueError("no tree or leaves in the manifest")
        return man
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"checkpoint at {path!r} has an unreadable tree manifest "
            f"({type(e).__name__}: {e})"
        ) from e


def _target_meta(x) -> tuple:
    """(shape, dtype) a restore target leaf asks for: a port array, a
    tensor, or anything with ``shape`` and ``dtype`` (a NumPy array, a
    shape/dtype record)."""
    if isinstance(x, (ndarray, torch.Tensor, np.ndarray)):
        return fileio._arr_meta(x)
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return tuple(int(s) for s in x.shape), np.dtype(x.dtype)
    raise TypeError(
        f"restore target leaves must be arrays or shape/dtype records, got "
        f"{type(x).__name__}"
    )


def restore(path: str, target=None):
    """Read a checkpoint back as a tree of port arrays on the port's
    device.  With ``target`` (a tree of port arrays, tensors or shape/dtype
    records), the checkpoint must hold that tree structure and each
    leaf's shape and dtype, or :class:`CheckpointCorruptError` is raised
    before any bytes are read."""
    apath = os.path.abspath(path)
    if not os.path.isdir(apath):
        raise CheckpointCorruptError(f"no checkpoint directory at {path!r}")

    # Integrity pre-scan: verify the published files against the digest
    # sidecar BEFORE reading them.
    digests = _load_digests(apath)
    if digests is not None:
        _verify_files(path, apath, digests)
    man = _read_manifest(path, apath)
    tgt = None
    if target is not None:
        tdef, titems = _flatten(target)
        tgt = (tdef, [_target_meta(v) for _k, v in titems])
        _validate_target(path, man, tgt)

    def read():
        _faults.check("checkpoint_io", op="restore")
        return [fileio.load_npy(os.path.join(apath, leaf["file"]),
                                np.dtype(leaf["dtype"]))
                for leaf in man["leaves"]]

    try:
        vals = _retry.call("checkpoint_io", read)
    except (_retry.RetryBudgetExhausted, _faults.InjectedFault):
        raise
    except Exception as e:
        raise CheckpointCorruptError(
            f"checkpoint at {path!r} is unreadable ({type(e).__name__}: {e})"
        ) from e
    _validate(path, man, vals)
    if digests is not None:
        _verify_leaves(path, [(leaf["key"], v) for leaf, v in
                              zip(man["leaves"], vals)], digests)
    _registry.inc("checkpoint.restores")
    return _unflatten(man["tree"], vals)


def _validate_target(path: str, man: dict, tgt) -> None:
    """A restore target must match what the checkpoint actually holds —
    tree structure and per-leaf shape/dtype — before restore runs."""
    tdef, tmeta = tgt
    if man["tree"] != tdef:
        raise CheckpointCorruptError(
            f"checkpoint at {path!r} tree structure {man['tree']} does not "
            f"match restore target {tdef}"
        )
    for leaf, (shape, dtype) in zip(man["leaves"], tmeta):
        if tuple(leaf["shape"]) != shape or np.dtype(leaf["dtype"]) != dtype:
            raise CheckpointCorruptError(
                f"checkpoint at {path!r} holds leaf "
                f"{tuple(leaf['shape'])}/{np.dtype(leaf['dtype'])} but the "
                f"restore target wants {shape}/{dtype}"
            )


def _validate(path: str, man: dict, vals) -> None:
    """Post-read validation: every leaf has the shape and dtype its
    manifest entry records."""
    if len(vals) != len(man["leaves"]):
        raise CheckpointCorruptError(
            f"checkpoint at {path!r} holds {len(vals)} leaves, its manifest "
            f"{len(man['leaves'])}")
    for v, leaf in zip(vals, man["leaves"]):
        got = fileio._arr_meta(v)
        if got != (tuple(leaf["shape"]), np.dtype(leaf["dtype"])):
            raise CheckpointCorruptError(
                f"checkpoint at {path!r} leaf {leaf['key']} is {got}, its "
                f"manifest says {tuple(leaf['shape'])}/{leaf['dtype']}"
            )
