#!/usr/bin/env python
"""ramba-fsck for the PyTorch port: offline integrity verification of
everything ``ramba_tpu_torch`` persists.  Run it before trusting a warm
cache or artifact tier, after a machine came back from a crash, or from
cron as a corruption tripwire.

What gets scanned (each an independent leg; a leg with nothing to scan
is skipped, and scanning nothing at all is its own exit code, so a
misconfigured cron job cannot pass for a clean fleet):

* the shared artifact tier (``--artifacts`` / ``RAMBA_ARTIFACTS``,
  ``fleet/artifacts.py``): memo blobs (``memo/*.npz``), plan
  certificates (``plancert/*.json``), migration handoffs
  (``handoff/*.manifest.json``, each checkpoint's byte census and its
  digest sidecar);
* the persistent cache (``--cache`` / ``RAMBA_CACHE``,
  ``compile/persist.py``): kernel libraries (``kernels/*.so``, each
  against the digest envelope beside it, ``<lib>.so.sha``, whose writer
  identity the report counts), entries (``aot/*.aot``) and program
  skeletons (``programs/*.pkl``);
* checkpoint trees (``--checkpoint PATH``, repeatable): the
  ``<path>.digests.json`` sidecar's file map re-verified byte for byte,
  the tree manifest (``tree.json``: every ``.npy`` leaf present with the
  shape and dtype it records), and ``CheckpointManager``'s
  ``MANIFEST.json`` self-digests, recursing over ``step_<n>/``.

Verification goes through ``ramba_tpu_torch.resilience.integrity.
verify_blob``, which emits no events and never strikes the live suspect
window: an offline scan must not quarantine the process running it.

``--repair`` moves every corrupt entry into a ``quarantine/`` directory
beside its scan root (cache entries are disposable: the runtime rebuilds
or recomputes on the miss).  A corrupt checkpoint file takes its whole
checkpoint along: a ``CheckpointManager``'s ``step_<n>/`` (the manager
then resumes from an older step), or a checkpoint directory and its
sidecar (a restore then fails loudly instead of serving corrupt
state).

Exit status: ``0`` everything verified, ``1`` corruption found (fix it or
run again with ``--repair``), ``4`` nothing to scan anywhere.

    python3 scripts/ramba_fsck_torch.py --artifacts DIR --cache DIR \\
        --checkpoint PATH [--checkpoint PATH ...] [--repair] [--json]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import sys
from typing import List, Optional

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

from ramba_tpu_torch.resilience import integrity as _integrity  # noqa: E402

# the schema tags of the scanned blobs (data: the modules that write them
# define the same strings)
_MEMO_SCHEMA = "memo.npz"
_CERT_SCHEMA = "plancert.json"
_AOT_SCHEMA = "aot.pkl"
_PROGRAM_SCHEMA = "program.pkl"
_KERNEL_SCHEMA = "kernel.so"
_DIGESTS_SCHEMA = "ckpt.digests.json"
_DIGESTS_SUFFIX = ".digests.json"
_TREE = "tree.json"

EXIT_CLEAN = 0
EXIT_CORRUPT = 1
EXIT_EMPTY = 4


def _read(path: str) -> Optional[bytes]:
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError:
        return None


def _quarantine(root: str, path: str, report: dict) -> None:
    """Move one corrupt entry into ``<root>/quarantine/``, keeping its
    relative layout so an operator can inspect what was pulled."""
    rel = os.path.relpath(path, root)
    if rel.startswith(".."):
        rel = os.path.basename(path)
    dest = os.path.join(root, "quarantine", rel)
    try:
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        shutil.move(path, dest)
        report["quarantined"].append({"path": path, "to": dest})
    except OSError as e:
        report["repair_errors"].append({"path": path, "error": str(e)})


def _bad(report: dict, root: str, path: str, schema: str, reason: str,
         repair: bool) -> None:
    report["corrupt"].append({"path": path, "schema": schema,
                              "reason": reason})
    if repair:
        _quarantine(root, path, report)


def _listing(d: str) -> list:
    try:
        return sorted(os.listdir(d))
    except OSError:
        return []


def _scan_blob_dir(report: dict, root: str, sub: str, suffix: str,
                   schema: str, repair: bool) -> None:
    d = os.path.join(root, sub)
    for name in _listing(d):
        if not name.endswith(suffix) or name.startswith(".tmp-"):
            continue
        path = os.path.join(d, name)
        report["scanned"] += 1
        reason = _integrity.verify_blob(_read(path), schema)
        if reason is not None:
            _bad(report, root, path, schema, reason, repair)


def _scan_kernels(report: dict, root: str, repair: bool) -> None:
    """Every kernel library against its digest envelope: the envelope's
    own digest, then the library's sha256 (a library without an envelope,
    or an envelope without its library, is corrupt; ``--repair`` moves
    both files)."""
    d = os.path.join(root, "kernels")
    names = _listing(d)
    for name in names:
        path = os.path.join(d, name)
        if name.endswith(".so.sha") and name[:-4] not in names:
            report["scanned"] += 1
            _bad(report, root, path, _KERNEL_SCHEMA, "missing library",
                 repair)
            continue
        if not name.endswith(".so"):
            continue
        report["scanned"] += 1
        side = path + ".sha"
        raw = _read(side)
        reason = _integrity.verify_blob(raw, _KERNEL_SCHEMA)
        writer = None
        if reason is None:
            payload = raw[raw.index(b"\n") + 1:].decode("utf-8", "replace")
            try:
                doc = json.loads(payload) if payload.startswith("{") \
                    else {"digest": payload}
                want, writer = str(doc["digest"]), doc.get("writer")
                if _integrity.file_digest(path) != want:
                    reason = "library"
            except (ValueError, KeyError):
                reason = "deserialize"
        else:
            reason = "envelope:" + reason
        if reason is not None:
            _bad(report, root, path, _KERNEL_SCHEMA, reason, repair)
            if repair and raw is not None:
                _quarantine(root, side, report)
            continue
        key = "unrecorded" if not isinstance(writer, dict) else \
            f"{writer.get('host')}:{writer.get('pid')}"
        report["writers"][key] = report["writers"].get(key, 0) + 1


def _payload_census(ckpt_dir: str) -> int:
    """The bytes of every file under one checkpoint directory, as
    ``fleet/migrate.py`` records them (``payload_bytes``)."""
    total = 0
    for r, _dirs, names in os.walk(ckpt_dir):
        for name in names:
            try:
                total += os.path.getsize(os.path.join(r, name))
            except OSError:
                pass
    return total


def _checkpoint_unit(side: str) -> list:
    """What ``--repair`` moves for a corrupt file of the checkpoint that
    sidecar ``side`` stamps: the whole ``step_<n>/`` of a
    ``CheckpointManager`` (the manager then resumes from an older step),
    else the checkpoint directory and its sidecar (a restore then fails
    loudly)."""
    apath = side[:-len(_DIGESTS_SUFFIX)]
    step = os.path.dirname(apath)
    if os.path.basename(step).startswith("step_"):
        return [step]
    return [apath, side]


def _scan_sidecar(report: dict, root: str, side: str, repair: bool) -> None:
    """One checkpoint digest sidecar: its own envelope, then every file
    it stamps, byte for byte; the first corrupt one takes its whole
    checkpoint into quarantine under ``--repair``."""
    apath = side[:-len(_DIGESTS_SUFFIX)]
    report["scanned"] += 1
    raw = _read(side)
    reason = _integrity.verify_blob(raw, _DIGESTS_SCHEMA)
    if reason is None:
        try:
            doc = json.loads(raw[raw.index(b"\n") + 1:])
            files = doc.get("files") or {}
        except (ValueError, AttributeError):
            reason = "deserialize"
    if reason is not None:
        _bad(report, root, side, _DIGESTS_SCHEMA, reason, False)
        files = {}
    bad = reason is not None
    for rel, want in sorted(files.items()):
        full = os.path.join(apath, rel)
        report["scanned"] += 1
        try:
            size = os.path.getsize(full)
        except OSError:
            size = None
        why = "missing" if size is None else \
            f"length:{size}!={want.get('size')}" if size != want.get("size") \
            else "digest" if _integrity.file_digest(full) != want.get(
                "sha256") else None
        if why is not None:
            _bad(report, root, full, "checkpoint:leaf", why, False)
            bad = True
    if bad and repair:
        for path in _checkpoint_unit(side):
            if os.path.exists(path):
                _quarantine(root, path, report)


def _scan_tree(report: dict, root: str, tpath: str, repair: bool) -> None:
    """A checkpoint's tree manifest: it parses, and every ``.npy`` leaf
    it names is there with the shape and dtype it records."""
    import numpy as np

    report["scanned"] += 1
    try:
        man = json.loads(_read(tpath) or b"")
        leaves = man["leaves"]
    except (ValueError, KeyError, TypeError):
        _bad(report, root, tpath, "checkpoint:tree", "deserialize", repair)
        return
    d = os.path.dirname(tpath)
    for leaf in leaves:
        full = os.path.join(d, str(leaf.get("file")))
        report["scanned"] += 1
        try:
            m = np.load(full, mmap_mode="r", allow_pickle=False)
            shape, dtype = m.shape, m.dtype
            del m
        except (OSError, ValueError):
            _bad(report, root, full, "checkpoint:leaf", "missing or no "
                 ".npy header", repair)
            continue
        if tuple(shape) != tuple(leaf.get("shape", ())) or \
                np.dtype(dtype) != np.dtype(leaf.get("dtype")):
            _bad(report, root, full, "checkpoint:leaf",
                 f"header:{tuple(shape)}/{np.dtype(dtype)}", repair)


def _scan_handoffs(report: dict, root: str, repair: bool) -> None:
    d = os.path.join(root, "handoff")
    for name in _listing(d):
        if not name.endswith(".manifest.json"):
            continue
        mpath = os.path.join(d, name)
        report["scanned"] += 1
        try:
            man = json.loads(_read(mpath) or b"")
        except ValueError:
            _bad(report, root, mpath, "handoff.manifest", "deserialize",
                 repair)
            continue
        ckpt = os.path.join(d, name[:-len(".manifest.json")])
        want = man.get("payload_bytes") if isinstance(man, dict) else None
        if want is not None and os.path.isdir(ckpt):
            got = _payload_census(ckpt)
            if got != want:
                _bad(report, root, mpath, "handoff.manifest",
                     f"payload_bytes:{got}!={want}", repair)
        side = ckpt + _DIGESTS_SUFFIX
        if os.path.exists(side):
            _scan_sidecar(report, root, side, repair)


def _scan_manifest_selfdigest(report: dict, root: str, mpath: str,
                              repair: bool) -> None:
    report["scanned"] += 1
    try:
        man = json.loads(_read(mpath) or b"")
    except ValueError:
        _bad(report, root, mpath, "elastic.manifest", "deserialize", repair)
        return
    want = man.get("digest") if isinstance(man, dict) else None
    if want is None:
        return  # a manifest without a digest: nothing to verify offline
    body = {k: v for k, v in man.items() if k != "digest"}
    got = hashlib.sha256(
        json.dumps(body, sort_keys=True).encode()).hexdigest()
    if got != want:
        _bad(report, root, mpath, "elastic.manifest", "digest", repair)


def _new_report(root: str, kind: str) -> dict:
    return {"kind": kind, "root": root, "scanned": 0, "corrupt": [],
            "quarantined": [], "repair_errors": [], "writers": {}}


def scan_artifacts(root: str, repair: bool = False) -> dict:
    report = _new_report(root, "artifacts")
    _scan_blob_dir(report, root, "memo", ".npz", _MEMO_SCHEMA, repair)
    _scan_blob_dir(report, root, "plancert", ".json", _CERT_SCHEMA, repair)
    _scan_handoffs(report, root, repair)
    return report


def scan_cache(root: str, repair: bool = False) -> dict:
    report = _new_report(root, "cache")
    _scan_kernels(report, root, repair)
    _scan_blob_dir(report, root, "aot", ".aot", _AOT_SCHEMA, repair)
    _scan_blob_dir(report, root, "programs", ".pkl", _PROGRAM_SCHEMA,
                   repair)
    return report


def scan_checkpoint(path: str, repair: bool = False) -> dict:
    """One checkpoint tree: a ``<path>.digests.json`` sidecar beside it,
    or a root holding ``step_<n>/`` layouts (``CheckpointManager``):
    every sidecar, tree manifest and MANIFEST self-digest under it."""
    root = os.path.abspath(path)
    report = _new_report(root, "checkpoint")
    side = root + _DIGESTS_SUFFIX
    if os.path.exists(side):
        _scan_sidecar(report, os.path.dirname(root) or root, side, repair)
    for r, dirs, names in os.walk(root):
        dirs[:] = sorted(x for x in dirs if x != "quarantine")
        for name in sorted(names):
            full = os.path.join(r, name)
            if name.endswith(_DIGESTS_SUFFIX):
                _scan_sidecar(report, root, full, repair)
            elif name == "MANIFEST.json":
                _scan_manifest_selfdigest(report, root, full, repair)
            elif name == _TREE:
                _scan_tree(report, root, full, repair)
    return report


def scan(artifacts: Optional[str] = None, cache: Optional[str] = None,
         checkpoints: Optional[List[str]] = None,
         repair: bool = False) -> dict:
    """The importable entry point.  Returns ``{"legs": [...], "scanned":
    n, "corrupt": n, "status": s}``, ``status`` the CLI's exit code."""
    legs = []
    if artifacts and os.path.isdir(artifacts):
        legs.append(scan_artifacts(artifacts, repair))
    if cache and os.path.isdir(cache):
        legs.append(scan_cache(cache, repair))
    for c in checkpoints or []:
        if os.path.exists(c) or os.path.exists(c + _DIGESTS_SUFFIX):
            legs.append(scan_checkpoint(c, repair))
    scanned = sum(leg["scanned"] for leg in legs)
    corrupt = sum(len(leg["corrupt"]) for leg in legs)
    status = EXIT_EMPTY if scanned == 0 else (
        EXIT_CORRUPT if corrupt else EXIT_CLEAN)
    return {"legs": legs, "scanned": scanned, "corrupt": corrupt,
            "status": status}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="ramba-fsck-torch",
        description="offline integrity verification of ramba_tpu_torch's "
                    "persisted artifacts, caches and checkpoints")
    ap.add_argument("--artifacts", default=os.environ.get("RAMBA_ARTIFACTS"),
                    help="shared artifact tier dir (default: "
                         "RAMBA_ARTIFACTS)")
    ap.add_argument("--cache", default=os.environ.get("RAMBA_CACHE"),
                    help="persistent cache dir (default: RAMBA_CACHE)")
    ap.add_argument("--checkpoint", action="append", default=[],
                    metavar="PATH",
                    help="checkpoint path or CheckpointManager root "
                         "(repeatable)")
    ap.add_argument("--repair", action="store_true",
                    help="move corrupt entries into quarantine/ beside "
                         "their scan root")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="print the whole report as JSON")
    args = ap.parse_args(argv)

    result = scan(artifacts=args.artifacts, cache=args.cache,
                  checkpoints=args.checkpoint, repair=args.repair)
    if args.as_json:
        json.dump(result, sys.stdout, indent=1, sort_keys=True)
        sys.stdout.write("\n")
    else:
        for leg in result["legs"]:
            print(f"ramba-fsck-torch: {leg['kind']} {leg['root']}: "
                  f"{leg['scanned']} scanned, "
                  f"{len(leg['corrupt'])} corrupt, "
                  f"{len(leg['quarantined'])} quarantined")
            for c in leg["corrupt"]:
                print(f"  CORRUPT {c['path']} [{c['schema']}] "
                      f"{c['reason']}")
        if not result["legs"]:
            print("ramba-fsck-torch: nothing to scan (set RAMBA_ARTIFACTS "
                  "/ RAMBA_CACHE or pass --checkpoint)", file=sys.stderr)
    if result["status"] == EXIT_CORRUPT and args.repair and all(
            not leg["repair_errors"] for leg in result["legs"]):
        print("ramba-fsck-torch: corrupt entries quarantined; run again "
              "to verify", file=sys.stderr if args.as_json else sys.stdout)
    return result["status"]


if __name__ == "__main__":
    raise SystemExit(main())
