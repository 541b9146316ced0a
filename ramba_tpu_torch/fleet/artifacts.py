"""Shared artifact tier: one directory that warms the whole fleet.

Counterpart of ``ramba_tpu/fleet/artifacts.py``.  Two caches are
content-addressed and therefore valid on any replica that runs the same
code and numerics regime:

* the **result memo** (``core/memo.py``): its in-process key binds inputs
  by tensor identity and version, which cannot cross a process boundary;
  this module adds the content-addressed form (sha256 over each input's
  dtype, shape and bytes in canonical leaf order), so a result computed
  on replica A is a memo hit on replica B;
* the **persistent kernel cache** (``compile/persist.py``): the built
  kernel libraries and program skeletons under ``RAMBA_CACHE``.  Pointing
  every replica's ``RAMBA_CACHE`` at one shared path is the shared tier
  of that cache; a library another process built loads without ``nvcc``
  and counts a cross-writer hit.

Write discipline: every writer stages into its own exclusive temp name
(``tempfile.mkstemp``) and publishes with ``os.replace``.  Two replicas
racing one key land exactly one complete winner (the entries are
content-addressed, so the loser's bytes were the same), a reader never
sees a torn blob, and a temp file on disk means a dead writer, which
:func:`gc_stale_tmp` sweeps by age.  Corruption on read is evicted and
recomputed, never raised: a shared cache may only make a replica faster.

The byte cap is checked before any copy: a tensor's size is
``numel * element_size``, so an input over the cap is skipped without
moving it from the card to the host (the reference converts every input
with ``np.asarray`` first).

Environment:

* ``RAMBA_ARTIFACTS`` — the shared directory; unset disarms the tier.
* ``RAMBA_MEMO_SHARED`` — ``0`` keeps the tier but turns off the shared
  memo lane (default on when the tier is armed; the lane also needs
  ``RAMBA_MEMO=1``).
* ``RAMBA_MEMO_SHARED_MAX`` — the per-entry byte cap of the lane
  (``common.parse_bytes``, default ``8m``): hashing inputs and
  serializing outputs is host work, so only small, hot results ride it.
"""

from __future__ import annotations

import hashlib
import io
import os
import tempfile
import threading
import time
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from ramba_tpu_torch import common as _common
from ramba_tpu_torch.observe import registry as _registry
from ramba_tpu_torch.resilience import faults as _faults
from ramba_tpu_torch.resilience import integrity as _integrity

_OFF = ("0", "off", "false", "no")

#: integrity-envelope schema tag for shared memo blobs
MEMO_SCHEMA = "memo.npz"

_lock = threading.Lock()
_state = {"dir": None}

#: running counters; snapshot() adds the configuration
stats = {
    "memo_stores": 0,
    "memo_store_errors": 0,
    "memo_hits": 0,
    "memo_misses": 0,
    "memo_corrupt": 0,
    "memo_skipped_large": 0,
    "tmp_gcd": 0,
}


def configure(directory: Optional[str] = None) -> None:
    """(Re)arm the tier on ``RAMBA_ARTIFACTS`` or an explicit directory
    (tests).  A directory that cannot be made disarms instead of
    raising."""
    with _lock:
        d = directory if directory is not None \
            else (os.environ.get("RAMBA_ARTIFACTS") or None)
        if not d:
            _state["dir"] = None
            return
        try:
            os.makedirs(os.path.join(d, "memo"), exist_ok=True)
            os.makedirs(os.path.join(d, "handoff"), exist_ok=True)
            _state["dir"] = d
        except OSError:
            _state["dir"] = None
            _registry.inc("artifacts.init_error")


def armed() -> bool:
    if _state["dir"] is None:
        configure()
    return _state["dir"] is not None


def artifacts_dir() -> Optional[str]:
    return _state["dir"]


def handoff_dir() -> Optional[str]:
    """Session-migration staging area (``fleet/migrate.py``):
    ``RAMBA_HANDOFF_DIR``, else ``<artifacts>/handoff``."""
    d = os.environ.get("RAMBA_HANDOFF_DIR")
    if d:
        try:
            os.makedirs(d, exist_ok=True)
            return d
        except OSError:
            return None
    if armed():
        return os.path.join(_state["dir"], "handoff")
    return None


def memo_shared_enabled() -> bool:
    raw = (os.environ.get("RAMBA_MEMO_SHARED") or "").strip().lower()
    return armed() and raw not in _OFF


def memo_shared_max_bytes() -> int:
    raw = os.environ.get("RAMBA_MEMO_SHARED_MAX")
    if raw:
        try:
            return max(0, _common.parse_bytes(raw))
        except ValueError:
            pass
    return 8 << 20


# ---------------------------------------------------------------------------
# atomic blob store (the race discipline)
# ---------------------------------------------------------------------------


def store_blob(path: str, data: bytes) -> bool:
    """Publish ``data`` at ``path`` atomically: an exclusive temp name
    (mkstemp), then one ``os.replace``, so a concurrent reader sees the
    old complete blob or the new complete blob."""
    try:
        parent = os.path.dirname(path)
        os.makedirs(parent, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=parent, prefix=".tmp-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return True
    except OSError:
        return False


def load_blob(path: str) -> Optional[bytes]:
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError:
        return None


def evict(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


def gc_stale_tmp(directory: Optional[str] = None,
                 max_age_s: float = 300.0) -> int:
    """Sweep dead writers' staging debris: any ``.tmp-*`` older than
    ``max_age_s`` in the tier's memo directory (or ``directory``).  A
    live writer holds its temp file for milliseconds, so age is the
    tombstone."""
    roots: List[str] = []
    if directory is not None:
        roots.append(directory)
    elif armed():
        roots.append(os.path.join(_state["dir"], "memo"))
    removed = 0
    now = time.time()
    for root in roots:
        try:
            names = os.listdir(root)
        except OSError:
            continue
        for name in names:
            if not name.startswith(".tmp-"):
                continue
            p = os.path.join(root, name)
            try:
                if now - os.stat(p).st_mtime > max_age_s:
                    os.unlink(p)
                    removed += 1
            except OSError:
                pass
    if removed:
        with _lock:
            stats["tmp_gcd"] += removed
        _registry.inc("artifacts.tmp_gcd", removed)
    return removed


# ---------------------------------------------------------------------------
# shared memo lane (content-addressed results)
# ---------------------------------------------------------------------------


def _nbytes(p: Any) -> Optional[int]:
    """Bytes of an array-like without copying it (None: not an array
    this lane can hash)."""
    if isinstance(p, torch.Tensor):
        return p.numel() * p.element_size()
    if isinstance(p, np.ndarray):
        return p.nbytes
    if isinstance(p, (bool, int, float, complex, np.generic)):
        return np.asarray(p).nbytes
    return None


def _host(p: Any) -> np.ndarray:
    """A host copy of an array-like (raises for a dtype NumPy lacks,
    bfloat16)."""
    if isinstance(p, torch.Tensor):
        return p.detach().cpu().numpy()
    return np.asarray(p)


def _skipped_large() -> None:
    with _lock:
        stats["memo_skipped_large"] += 1
    _registry.inc("artifacts.memo_skipped_large")


def content_key(chash: str, parts: Sequence[Any], fingerprint) -> \
        Optional[str]:
    """Content-addressed shared-memo key: canonical hash x sha256 over
    every input's (dtype, shape, bytes) in canonical leaf order x the
    semantic fingerprint.  ``parts`` entries are scalar tokens (tuples)
    or array-likes.  None when the inputs' bytes exceed the cap (checked
    before any copy) or a value cannot be hashed."""
    budget = memo_shared_max_bytes()
    seen = 0
    for p in parts:
        if isinstance(p, tuple):
            continue
        n = _nbytes(p)
        if n is None:
            return None
        seen += n
        if budget and seen > budget:
            _skipped_large()
            return None
    h = hashlib.sha256()
    h.update(chash.encode())
    for p in parts:
        if isinstance(p, tuple):  # scalar token from the memo plan
            h.update(repr(p).encode())
            continue
        try:
            a = np.require(_host(p), requirements="C")
        except Exception:  # noqa: BLE001 — unhashable input: no shared key
            return None
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    h.update(repr(fingerprint).encode())
    return h.hexdigest()[:32]


def _memo_path(key: str) -> str:
    return os.path.join(_state["dir"], "memo", f"{key}.npz")


def memo_store(key: str, outs: Sequence[Any]) -> bool:
    """Publish one flush's outputs under a content key.  Best-effort: an
    output past the cap (checked before any copy) or of a dtype NumPy
    cannot hold skips."""
    if not memo_shared_enabled():
        return False
    sizes = [_nbytes(v) for v in outs]
    if any(n is None for n in sizes):
        return False
    budget = memo_shared_max_bytes()
    if budget and sum(sizes) > budget:
        _skipped_large()
        return False
    buf = io.BytesIO()
    try:
        arrays = [_host(v) for v in outs]
        np.savez(buf, **{f"out{i}": a for i, a in enumerate(arrays)})
    except Exception:  # noqa: BLE001 — exotic dtypes: skip
        with _lock:
            stats["memo_store_errors"] += 1
        return False
    if not store_blob(_memo_path(key),
                      _integrity.wrap(buf.getvalue(), MEMO_SCHEMA)):
        with _lock:
            stats["memo_store_errors"] += 1
        _registry.inc("artifacts.memo_store_error")
        return False
    with _lock:
        stats["memo_stores"] += 1
    _registry.inc("artifacts.memo_store")
    gc_stale_tmp()
    return True


def memo_load(key: str) -> Optional[List[np.ndarray]]:
    """Probe the shared lane.  A corrupt blob is evicted and counted (the
    caller recomputes); the tier never raises."""
    if not memo_shared_enabled():
        return None
    path = _memo_path(key)
    raw = load_blob(path)
    if raw is None:
        with _lock:
            stats["memo_misses"] += 1
        _registry.inc("artifacts.memo_miss")
        return None
    # flip seam (RAMBA_FAULTS='memo:blob:flip:...'): seeded silent
    # corruption of the bytes just read, upstream of verification
    raw = _faults.corrupt("memo:blob", raw, key=key)
    try:
        payload = _integrity.unwrap(raw, MEMO_SCHEMA, site="memo:blob")
    except _integrity.IntegrityError:
        # digest mismatch or an unstamped entry: evict, never serve
        with _lock:
            stats["memo_corrupt"] += 1
        _registry.inc("artifacts.memo_corrupt")
        evict(path)
        return None
    try:
        with np.load(io.BytesIO(payload), allow_pickle=False) as z:
            arrays = [z[f"out{i}"] for i in range(len(z.files))]
    except Exception as e:  # noqa: BLE001 — a blob that passed its digest
        # but does not parse: an integrity failure, evicted
        with _lock:
            stats["memo_corrupt"] += 1
        _registry.inc("artifacts.memo_corrupt")
        _integrity.failure("memo:blob", "deserialize",
                           detail=repr(e)[:200], key=key)
        evict(path)
        return None
    with _lock:
        stats["memo_hits"] += 1
    _registry.inc("artifacts.memo_hit")
    return arrays


def snapshot() -> dict:
    with _lock:
        d = dict(stats)
    d["dir"] = _state["dir"]
    d["armed"] = _state["dir"] is not None
    d["memo_shared"] = memo_shared_enabled()
    d["memo_shared_max_bytes"] = memo_shared_max_bytes()
    return d


def reset() -> None:
    """Tests: zero the counters and re-read the environment."""
    with _lock:
        for k in stats:
            stats[k] = 0
        _state["dir"] = None
    configure()
