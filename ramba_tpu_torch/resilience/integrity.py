"""End-to-end data integrity plane: digests and suspect quarantine.

Counterpart of ``ramba_tpu/resilience/integrity.py``.  Every byte-carrying
seam trusts that bytes read back are the bytes written; this module makes
silent data corruption a first-class, classified fault.

**Content digests.**  :func:`wrap` stamps a payload with an envelope —
one header line carrying a schema tag and a sha256 over
``schema : length : payload`` — and :func:`unwrap` verifies it at adopt
time.  A mismatch (or a payload with no envelope at all: a flip that
lands on the header must not demote the blob to "legacy, trust it")
raises :class:`IntegrityError`.  Each failure is counted and emitted as
an ``integrity`` trace event.  The envelope is byte-for-byte the
reference's, so a blob stamped by either package verifies in the other.

:func:`array_digest` is the logical digest of one array leaf: sha256 over
the dtype string, the shape repr and the C-order bytes, equal to
``ramba_tpu``'s for the same values.  A tensor on the card is streamed to
the host in bounded chunks through pinned staging buffers
(``core/staging.py``), so a 2 GiB leaf never stands whole in host memory.

**Suspect quarantine.**  A process accumulating
``RAMBA_INTEGRITY_THRESHOLD`` digest failures (default 3) inside a
sliding ``RAMBA_INTEGRITY_WINDOW_S`` window (default 300 s) flips a
``suspect`` signal (the ``integrity.suspect`` gauge).

``RAMBA_INTEGRITY=0`` disables stamping and verification everywhere
(envelopes are still *stripped* on read so wrapped and raw blobs both
load).

The reference's shadow recompute audits (``RAMBA_AUDIT``,
``shadow_audit``) need the fuser's audit hook and the result memo; they
come with the compile and resilience queues.  The wired flip seam is
``checkpoint:leaf`` (``checkpoint.py``).
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from collections import deque
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ramba_tpu_torch.core import staging as _staging
from ramba_tpu_torch.core.expr import to_np_dtype
from ramba_tpu_torch.core.ndarray import ndarray
from ramba_tpu_torch.observe import events as _events
from ramba_tpu_torch.observe import registry as _registry

_OFF = ("0", "off", "false", "no")

#: envelope magic — one header line: ``RMBI1 <schema> <sha256hex>\n``
_MAGIC = b"RMBI1 "
_ENVELOPE_VERSION = 1


class IntegrityError(RuntimeError):
    """A payload failed digest verification (or carries no envelope at
    a seam that requires one).  ``site`` names the seam, ``reason`` the
    classified failure shape: ``unstamped`` | ``header`` | ``schema`` |
    ``length`` | ``digest`` | ``missing``."""

    def __init__(self, site: str, reason: str, detail: str = ""):
        self.site = site
        self.reason = reason
        msg = f"integrity failure at {site!r}: {reason}"
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)


_lock = threading.Lock()

#: running counters; snapshot() adds config + suspect state
stats = {
    "stamped": 0,
    "verified": 0,
    "failures": 0,
    "unstamped_evictions": 0,
    "digest_bytes": 0,
    "digest_wall_s": 0.0,
}

# sliding failure window backing the suspect verdict
_strikes: deque = deque()


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


def enabled() -> bool:
    """Digest stamping + verification gate (``RAMBA_INTEGRITY``,
    default on)."""
    return (os.environ.get("RAMBA_INTEGRITY") or "").strip().lower() \
        not in _OFF


def suspect_threshold() -> int:
    try:
        return max(1, int(os.environ.get("RAMBA_INTEGRITY_THRESHOLD", "")
                          or 3))
    except ValueError:
        return 3


def suspect_window_s() -> float:
    try:
        return max(1.0, float(os.environ.get("RAMBA_INTEGRITY_WINDOW_S", "")
                              or 300.0))
    except ValueError:
        return 300.0


# ---------------------------------------------------------------------------
# the envelope (content digests at every seam)
# ---------------------------------------------------------------------------


def _digest(payload: bytes, schema: str) -> str:
    h = hashlib.sha256()
    h.update(f"{schema}:{len(payload)}:".encode())
    h.update(payload)
    return h.hexdigest()


def wrap(payload: bytes, schema: str) -> bytes:
    """Stamp ``payload`` with its content-digest envelope.  Identity
    when the plane is disabled (``RAMBA_INTEGRITY=0``)."""
    if not enabled():
        return payload
    t0 = time.perf_counter()
    header = _MAGIC + schema.encode() + b" " + \
        _digest(payload, schema).encode() + b"\n"
    with _lock:
        stats["stamped"] += 1
        stats["digest_bytes"] += len(payload)
        stats["digest_wall_s"] += time.perf_counter() - t0
    return header + payload


def _split(data: bytes) -> Tuple[str, str, bytes]:
    """Parse an envelope into (schema, digest_hex, payload).  Raises
    ValueError on any malformed header."""
    if not data.startswith(_MAGIC):
        raise ValueError("no envelope magic")
    nl = data.find(b"\n", 0, 256)
    if nl < 0:
        raise ValueError("unterminated envelope header")
    fields = data[len(_MAGIC):nl].split(b" ")
    if len(fields) != 2:
        raise ValueError("malformed envelope header")
    return fields[0].decode("ascii", "replace"), \
        fields[1].decode("ascii", "replace"), data[nl + 1:]


def verify_blob(data: Optional[bytes], schema: str) -> Optional[str]:
    """Offline verification: returns ``None`` when the envelope checks
    out, else the classified reason.  Never emits events and never
    strikes the suspect window."""
    if data is None:
        return "missing"
    try:
        got_schema, got_digest, payload = _split(data)
    except ValueError as e:
        return "unstamped" if not data.startswith(_MAGIC) else \
            f"header:{e}"
    if got_schema != schema:
        return f"schema:{got_schema!r}"
    if got_digest != _digest(payload, schema):
        return "digest"
    return None


def unwrap(data: bytes, schema: str, *, site: str,
           record: bool = True) -> bytes:
    """Verify and strip a payload's envelope.

    STRICT at every runtime seam: a payload without an envelope raises
    ``IntegrityError("unstamped")`` — a flip landing on the header
    bytes cannot smuggle a blob past verification by making it look
    legacy.  With the plane disabled the envelope (when present)
    is stripped without verification so wrapped and raw blobs both
    load."""
    if not enabled():
        try:
            return _split(data)[2]
        except ValueError:
            return data
    t0 = time.perf_counter()
    try:
        got_schema, got_digest, payload = _split(data)
    except ValueError as e:
        reason = "unstamped" if not data.startswith(_MAGIC) else "header"
        if record:
            failure(site, reason, detail=str(e), schema=schema)
        raise IntegrityError(site, reason, str(e)) from None
    if got_schema != schema:
        if record:
            failure(site, "schema", detail=f"{got_schema!r} != {schema!r}")
        raise IntegrityError(site, "schema",
                             f"{got_schema!r} != {schema!r}")
    want = _digest(payload, schema)
    with _lock:
        stats["digest_bytes"] += len(payload)
        stats["digest_wall_s"] += time.perf_counter() - t0
    if got_digest != want:
        if record:
            failure(site, "digest", schema=schema)
        raise IntegrityError(site, "digest",
                             f"stored {got_digest[:12]}.. != "
                             f"recomputed {want[:12]}..")
    with _lock:
        stats["verified"] += 1
    return payload


def file_digest(path: str, chunk: int = 1 << 20) -> str:
    """Streamed sha256 over a file's raw bytes (checkpoint sidecars)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


# np.ascontiguousarray gives a 0-d array one dimension, and the
# reference hashes the shape of that copy
_ZERO_D_SHAPE = np.ascontiguousarray(np.zeros(())).shape


def _tensor_of(arr: Any) -> Optional[torch.Tensor]:
    if isinstance(arr, torch.Tensor):
        return arr
    if isinstance(arr, ndarray):
        return arr._value()
    return None


def array_digest(arr: Any) -> str:
    """Logical content digest of one array leaf: sha256 over dtype,
    shape and C-order bytes — the reference's digest of the same values.
    A port array or tensor is streamed to the host chunk by chunk."""
    t = _tensor_of(arr)
    if t is None:
        a = np.ascontiguousarray(np.asarray(arr))
        h = hashlib.sha256()
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
        return h.hexdigest()
    t0 = time.perf_counter()
    h = hashlib.sha256()
    h.update(str(to_np_dtype(t.dtype)).encode())
    shape = tuple(int(s) for s in t.shape) or _ZERO_D_SHAPE
    h.update(repr(shape).encode())
    for _box, chunk in _staging.to_host_chunks(t):
        h.update(chunk.reshape(-1).view(np.uint8))
    with _lock:
        stats["digest_bytes"] += t.numel() * t.element_size()
        stats["digest_wall_s"] += time.perf_counter() - t0
    return h.hexdigest()


# ---------------------------------------------------------------------------
# classified failures + suspect quarantine
# ---------------------------------------------------------------------------


def failure(site: str, reason: str, *, detail: str = "", **ctx) -> None:
    """Record one integrity failure: counters, an ``integrity`` trace
    event, and a strike on the suspect window."""
    now = time.time()
    with _lock:
        stats["failures"] += 1
        if reason == "unstamped":
            stats["unstamped_evictions"] += 1
        _strikes.append(now)
        window = suspect_window_s()
        while _strikes and now - _strikes[0] > window:
            _strikes.popleft()
        in_window = len(_strikes)
        is_suspect = in_window >= suspect_threshold()
    _registry.inc("integrity.failures")
    _registry.inc(f"integrity.failures.{site}")
    ev = {"type": "integrity", "site": site, "reason": reason,
          "failures_in_window": in_window, "suspect": is_suspect}
    if detail:
        ev["detail"] = detail
    ev.update(ctx)
    _events.emit(ev)
    if is_suspect:
        _registry.gauge("integrity.suspect", 1)


def failure_count(now: Optional[float] = None) -> int:
    """Digest failures inside the current sliding window."""
    now = time.time() if now is None else now
    window = suspect_window_s()
    with _lock:
        while _strikes and now - _strikes[0] > window:
            _strikes.popleft()
        return len(_strikes)


def suspect(now: Optional[float] = None) -> bool:
    """Whether this process has crossed the quarantine threshold."""
    return failure_count(now) >= suspect_threshold()


# ---------------------------------------------------------------------------
# diagnostics
# ---------------------------------------------------------------------------


AUDIT = ("the shadow recompute audit and its eviction of suspect result-memo "
         "entries: ROADMAP A.8")


def evict_plan_blobs(plan) -> None:
    """Evict a suspect flush's memo entry after a shadow audit disagreed
    (the reference's ``_evict_plan_blobs``): ROADMAP A.8."""
    raise NotImplementedError(AUDIT)


def snapshot() -> dict:
    with _lock:
        d = dict(stats)
        d["digest_wall_s"] = round(d["digest_wall_s"], 6)
    d["enabled"] = enabled()
    d["suspect"] = suspect()
    d["failures_in_window"] = failure_count()
    d["suspect_threshold"] = suspect_threshold()
    d["suspect_window_s"] = suspect_window_s()
    return d


def reset() -> None:
    """Tests: zero counters and the suspect window."""
    with _lock:
        for k in stats:
            stats[k] = 0.0 if isinstance(stats[k], float) else 0
        _strikes.clear()
