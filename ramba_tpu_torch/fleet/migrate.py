"""Drained-session handoff: move a live tenant between replicas.

Counterpart of ``ramba_tpu/fleet/migrate.py``, built on the port's
checkpoint format (``checkpoint.py``: a directory of ``.npy`` leaves and a
manifest, written atomically, digests checked on restore), so migration
inherits what checkpoints already prove.  The flow the router drives:

1. **Export** (source replica): drain the session (``Session.handoff``:
   every pending flush lands), checkpoint the session's named arrays
   under ``<handoff>/<sid>``, then publish the manifest
   ``<handoff>/<sid>.manifest.json`` atomically *last*: a manifest on
   disk always points at a complete checkpoint, and a checkpoint without
   a manifest is an aborted export.
2. **Adopt** (target replica): read the manifest, check the payload's
   size against it, restore the arrays onto the adopting process's
   device, and resume serving at the recorded step sequence.
3. **Discard**: the router deletes the handoff once the target
   acknowledged adoption, so a crashed migration can be retried from the
   still-complete export.

A SIGKILLed replica never gets to export: that path heals by
deterministic step-log replay on a survivor (``fleet/router.py``).
Migration is the graceful rung: no recompute, for a source replica that
is degraded but alive.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, Optional, Tuple

from ramba_tpu_torch.fleet import artifacts as _artifacts
from ramba_tpu_torch.observe import events as _events
from ramba_tpu_torch.observe import registry as _registry
from ramba_tpu_torch.resilience import faults as _faults
from ramba_tpu_torch.resilience import integrity as _integrity

MANIFEST_SCHEMA = 1


class MigrateError(RuntimeError):
    """The handoff is missing, torn, or structurally wrong."""


def _payload_files(path: str) -> list:
    """Every regular file under the handoff checkpoint, sorted by
    relative path — the byte population the manifest's
    ``payload_bytes`` covers."""
    out = []
    for root, _dirs, names in os.walk(path):
        for name in names:
            out.append(os.path.join(root, name))
    return sorted(out)


def _payload_bytes(path: str) -> int:
    total = 0
    for f in _payload_files(path):
        try:
            total += os.path.getsize(f)
        except OSError:
            pass
    return total


def _dir_for(sid: str, directory: Optional[str]) -> str:
    d = directory or _artifacts.handoff_dir()
    if d is None:
        raise MigrateError(
            "no handoff directory (set RAMBA_ARTIFACTS or "
            "RAMBA_HANDOFF_DIR)")
    return os.path.join(d, sid)


def _manifest_path(sid: str, directory: Optional[str]) -> str:
    return _dir_for(sid, directory) + ".manifest.json"


def export_session(sid: str, meta: Dict[str, Any], state: Dict[str, Any],
                   directory: Optional[str] = None) -> str:
    """Checkpoint a drained session's arrays + publish the manifest.
    ``state`` maps name -> ramba_tpu_torch ndarray; names beginning with
    ``_`` are scratch (keep-alives of earlier values) and are not
    exported."""
    from ramba_tpu_torch import checkpoint as _checkpoint

    path = _dir_for(sid, directory)
    tree = {k: v for k, v in state.items() if not k.startswith("_")}
    if not tree:
        raise MigrateError(f"session {sid!r} has no exportable arrays")
    t0 = time.perf_counter()
    _checkpoint.save(path, tree, force=True)
    manifest = {
        "schema": MANIFEST_SCHEMA,
        "sid": sid,
        "names": sorted(tree),
        "payload_bytes": _payload_bytes(path),
        "saved_at": round(time.time(), 6),
        **{k: meta[k] for k in ("tenant", "trace_id", "seq") if k in meta},
    }
    # manifest last: its presence certifies the checkpoint completed
    _artifacts.store_blob(_manifest_path(sid, directory),
                          json.dumps(manifest).encode())
    _registry.inc("fleet.migrate_exports")
    _events.emit({"type": "migrate", "action": "export", "sid": sid,
                  "tenant": meta.get("tenant"),
                  "trace_id": meta.get("trace_id"),
                  "names": manifest["names"],
                  "wall_ms": round((time.perf_counter() - t0) * 1e3, 2)})
    return path


def load_manifest(sid: str, directory: Optional[str] = None) -> dict:
    raw = _artifacts.load_blob(_manifest_path(sid, directory))
    if raw is None:
        raise MigrateError(f"no handoff manifest for session {sid!r}")
    try:
        manifest = json.loads(raw)
        if manifest.get("schema") != MANIFEST_SCHEMA:
            raise ValueError(f"schema {manifest.get('schema')!r}")
        if manifest.get("sid") != sid:
            raise ValueError("sid mismatch")
    except (ValueError, AttributeError) as e:
        raise MigrateError(f"corrupt handoff manifest for {sid!r}: {e}") \
            from e
    return manifest


def adopt_session(sid: str, directory: Optional[str] = None) -> \
        Tuple[dict, Dict[str, Any]]:
    """Restore an exported session on the calling replica.  Returns
    ``(manifest, state)``; restore errors (a torn checkpoint, a leaf
    that fails its digest) surface as :class:`MigrateError` with the
    original chained."""
    from ramba_tpu_torch import checkpoint as _checkpoint

    manifest = load_manifest(sid, directory)
    path = _dir_for(sid, directory)
    if _faults.configured("migrate:payload"):
        # flip seam (RAMBA_FAULTS='migrate:payload:flip:...'): seeded
        # corruption of the handoff payload before any check runs
        files = _payload_files(path)
        if files:
            _faults.corrupt_file("migrate:payload", files[0], sid=sid)
    want = manifest.get("payload_bytes")
    if want is not None:
        got = _payload_bytes(path)
        if got != want:
            # truncated / grown payload: the handoff is torn, and the
            # cheap size census catches it before any leaf is read
            _integrity.failure("migrate:payload", "length",
                               detail=f"{got} != {want}", sid=sid)
            raise MigrateError(
                f"handoff payload for {sid!r} is {got} bytes but the "
                f"manifest recorded {want} — torn or corrupt handoff")
    t0 = time.perf_counter()
    try:
        state = _checkpoint.restore(path)
    except Exception as e:  # noqa: BLE001 — classify, keep the chain
        raise MigrateError(
            f"handoff checkpoint for {sid!r} failed to restore: {e}") from e
    if sorted(state) != manifest["names"]:
        raise MigrateError(
            f"handoff {sid!r} names {sorted(state)} != manifest "
            f"{manifest['names']}")
    _registry.inc("fleet.migrate_adopts")
    _events.emit({"type": "migrate", "action": "adopt", "sid": sid,
                  "tenant": manifest.get("tenant"),
                  "trace_id": manifest.get("trace_id"),
                  "wall_ms": round((time.perf_counter() - t0) * 1e3, 2)})
    return manifest, dict(state)


def discard(sid: str, directory: Optional[str] = None) -> None:
    """Delete one handoff (manifest first, so a concurrent adopter
    never sees a manifest pointing at a half-deleted checkpoint)."""
    try:
        os.unlink(_manifest_path(sid, directory))
    except OSError:
        pass
    path = _dir_for(sid, directory)
    try:
        from ramba_tpu_torch.checkpoint import digests_path as _digests_path
        os.unlink(_digests_path(path))
    except OSError:
        pass
    shutil.rmtree(path, ignore_errors=True)


def list_handoffs(directory: Optional[str] = None) -> list:
    d = directory or _artifacts.handoff_dir()
    if d is None:
        return []
    try:
        names = os.listdir(d)
    except OSError:
        return []
    return sorted(n[:-len(".manifest.json")] for n in names
                  if n.endswith(".manifest.json"))
