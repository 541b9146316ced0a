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

**Shadow recompute audits.**  ``RAMBA_AUDIT=<N>`` samples one in every
N eligible flushes (a certified memo plan, the fused rung, no memo hit:
the fuser's check) and re-runs the program on the eager rung
(:func:`shadow_audit`).  Byte-identical outputs are clean; float outputs
within the rung-to-rung slack are ``numeric``; anything else is a
``mismatch``: the primary outputs are still served, the memo insert is
skipped and the plan's entry evicted (:func:`evict_plan_blobs`).  A
float reduction's slack comes from the kernels' rounding depth and the
reduction of ``|x|`` (the fuser computes both beside the shadow run),
where the reference allows 64 ulp of the result.  The flip seams are
``checkpoint:leaf`` (``checkpoint.py``) and ``audit:shadow`` (the shadow
outputs).
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from collections import deque
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ramba_tpu_torch.core import staging as _staging
from ramba_tpu_torch.core.expr import to_np_dtype
from ramba_tpu_torch.core.ndarray import ndarray
from ramba_tpu_torch.observe import events as _events
from ramba_tpu_torch.observe import registry as _registry
from ramba_tpu_torch.resilience import faults as _faults

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
    "audits": 0,
    "audit_mismatches": 0,
    "audit_numeric": 0,
    "audit_errors": 0,
    "digest_bytes": 0,
    "digest_wall_s": 0.0,
    "audit_wall_s": 0.0,
}

# sliding failure window backing the suspect verdict
_strikes: deque = deque()
# eligible-flush counter for the deterministic 1-in-N audit sampling
_audit_counter = [0]


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


def enabled() -> bool:
    """Digest stamping + verification gate (``RAMBA_INTEGRITY``,
    default on)."""
    return (os.environ.get("RAMBA_INTEGRITY") or "").strip().lower() \
        not in _OFF


def audit_every() -> int:
    """``RAMBA_AUDIT=<N>`` — shadow-audit one in every N eligible
    flushes; 0 (or unset, or integrity disabled) disarms."""
    raw = (os.environ.get("RAMBA_AUDIT") or "").strip()
    if not raw or raw.lower() in _OFF or not enabled():
        return 0
    try:
        return max(0, int(raw))
    except ValueError:
        return 0


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
# shadow recompute audits
# ---------------------------------------------------------------------------


def _flat_bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes, as a flat uint8 tensor on its device."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def _out_bytes(outs: Sequence[Any]) -> List[bytes]:
    """Byte-identity view of one flush's outputs, on the host (the
    reference's; the audit itself compares on the device and goes
    through host bytes only at the ``audit:shadow`` flip seam)."""
    res: List[bytes] = []
    for o in outs:
        if isinstance(o, torch.Tensor):
            res.append(_flat_bits(o).cpu().numpy().tobytes())
        else:
            res.append(np.ascontiguousarray(np.asarray(o)).tobytes())
    return res


def _flip_seam(o, label: str):
    """A shadow output through the ``audit:shadow`` flip seam (identity
    unless a flip spec targets it)."""
    if not isinstance(o, torch.Tensor) or not _faults.configured(
            "audit:shadow"):
        return o
    data = _out_bytes([o])[0]
    got = _faults.corrupt("audit:shadow", data, label=label) or data
    if got == data:
        return o
    host = torch.frombuffer(bytearray(got), dtype=torch.uint8)
    return host.view(o.dtype).reshape(o.shape).to(o.device)


#: rung-to-rung numerical slack, in units of dtype eps, for a float
#: output with no slack of its own.  The fused program and the eager
#: rung may round differently (a kernel's own math functions, a
#: contraction into an FMA); a flipped byte moves a float by up to 255
#: ulp at its position, far past this slack, so a flip still classifies
#: as a mismatch; only a flip confined to the lowest mantissa bits is
#: indistinguishable from rounding, an inherent limit of a cross-rung
#: comparison.
_AUDIT_ULP_SLACK = 64.0


def _eps(dt: torch.dtype) -> float:
    if dt.is_complex:
        dt = torch.float64 if dt == torch.complex128 else torch.float32
    return float(torch.finfo(dt).eps)


def _classify_divergence(primary: Sequence[Any], shadow: Sequence[Any],
                         slack: Optional[Sequence[Any]] = None
                         ) -> Tuple[int, int]:
    """(mismatch, numeric): byte-identical pairs are clean; float or
    complex outputs with NaNs in the same places and every difference
    within the output's slack are ``numeric`` (``slack[i]``: an absolute
    bound, a number or a tensor of the output's shape; None: the
    reference's ``_AUDIT_ULP_SLACK`` ulp); anything else — shape or
    dtype skew, integer or bool differences, a float difference past
    its slack — is a mismatch."""
    if len(primary) != len(shadow):
        return 1, 0
    numeric = 0
    for i, (p, s) in enumerate(zip(primary, shadow)):
        if not isinstance(p, torch.Tensor) or not isinstance(s, torch.Tensor):
            if np.asarray(p).tobytes() != np.asarray(s).tobytes():
                return 1, numeric
            continue
        if p.dtype != s.dtype or p.shape != s.shape:
            return 1, numeric
        s = s.to(p.device)
        if torch.equal(_flat_bits(p), _flat_bits(s)):
            continue
        if not (p.is_floating_point() or p.is_complex()):
            return 1, numeric
        pd = torch.view_as_real(p) if p.is_complex() else p
        sd = torch.view_as_real(s) if s.is_complex() else s
        pd, sd = pd.double(), sd.double()
        if not torch.equal(torch.isnan(pd), torch.isnan(sd)):
            return 1, numeric
        bound = slack[i] if slack is not None and i < len(slack) else None
        diff = torch.where(torch.isnan(pd), torch.zeros_like(pd),
                           (pd - sd).abs())
        if bound is None:
            tol = _AUDIT_ULP_SLACK * _eps(p.dtype)
            ok = diff <= tol + tol * torch.where(
                torch.isnan(sd), torch.zeros_like(sd), sd.abs())
        else:
            bound = torch.as_tensor(bound, dtype=torch.float64,
                                    device=diff.device)
            if p.is_complex() and bound.dim():
                bound = bound.unsqueeze(-1)
            ok = diff <= bound
        # equal infinities give NaN differences: equal bits are fine
        ok = ok | (pd == sd)
        if not bool(ok.all()):
            return 1, numeric
        numeric += 1
    return 0, numeric


def shadow_audit(label: str, outs: Sequence[Any],
                 rerun: Callable[[], Tuple[Sequence[Any], Any]], *,
                 plan: Any = None, span: Optional[dict] = None,
                 coherent: bool = True) -> bool:
    """Maybe shadow-audit one flush; returns True iff the audit found a
    mismatch (the caller then skips the memo insert — the primary
    ``outs`` are still the ones served).

    Sampling is deterministic 1-in-N over eligible flushes
    (``RAMBA_AUDIT=<N>``; eligibility is the caller's check).
    ``rerun()`` re-executes the program on the eager rung and returns
    ``(outputs, slack)`` (``slack``: per output, as
    :func:`_classify_divergence` reads it, or None); its outputs pass
    through the ``audit:shadow`` flip seam.  An audit that raises never
    fails the flush: it counts ``audit_errors``.  ``coherent``: the flush
    is the whole job's, so its verdict goes through the
    ``integrity:audit`` round when the coherence layer is engaged; a
    rank's own flush (``coherent=False``: a spmd kernel's, one under
    ``mesh.local_scope``) keeps its own verdict and joins no round, which
    the other ranks would never enter."""
    n = audit_every()
    if n <= 0:
        return False
    with _lock:
        _audit_counter[0] += 1
        due = _audit_counter[0] % n == 0
    if not due:
        return False
    from ramba_tpu_torch.resilience import coherence as _coherence

    t0 = time.perf_counter()
    try:
        shadow, slack = rerun()
        shadow = [_flip_seam(o, label) for o in shadow]
        mismatch, numeric = _classify_divergence(list(outs), shadow, slack)
        del shadow, slack
    except Exception as e:  # noqa: BLE001 — the audit never fails a flush
        with _lock:
            stats["audit_errors"] += 1
        _registry.inc("integrity.audit_errors")
        _events.emit({"type": "integrity_audit", "label": label,
                      "outcome": "error", "error": repr(e)[:200]})
        return False
    decision = _coherence.agree("integrity:audit", mismatch, reduce="max") \
        if coherent else mismatch
    dt = time.perf_counter() - t0
    with _lock:
        stats["audits"] += 1
        stats["audit_wall_s"] += dt
        stats["audit_numeric"] += numeric
        if decision:
            stats["audit_mismatches"] += 1
    _registry.inc("integrity.audits")
    if span is not None:
        span["audited"] = True
        span["audit_s"] = round(dt, 6)
    if not decision:
        ev = {"type": "integrity_audit", "label": label,
              "outcome": "ok", "wall_ms": round(dt * 1e3, 3)}
        if numeric:
            ev["outcome"] = "numeric"
            ev["numeric_outs"] = numeric
        _events.emit(ev)
        return False
    _registry.inc("integrity.audit_mismatches")
    _events.emit({"type": "integrity_audit", "label": label,
                  "outcome": "mismatch", "wall_ms": round(dt * 1e3, 3)})
    failure("audit:shadow", "audit", detail=label,
            local_mismatch=bool(mismatch))
    if span is not None:
        span["audit_mismatch"] = True
    evict_plan_blobs(plan)
    return True


def evict_plan_blobs(plan: Any) -> bool:
    """A mismatched audit means the flush's bytes are suspect: evict the
    plan's memo entry and its shared-lane blob (``fleet/artifacts.py``)
    so neither is served again, here or to a peer (the reference's
    ``_evict_plan_blobs``).  Returns whether a local entry was dropped."""
    if plan is None:
        return False
    dropped = False
    try:
        from ramba_tpu_torch.core import memo as _memo

        dropped = _memo.evict(plan)
    except Exception:  # noqa: BLE001 — eviction is best-effort
        pass
    key = getattr(plan, "shared_key", None)
    if key:
        try:
            from ramba_tpu_torch.fleet import artifacts as _artifacts

            if _artifacts.armed():
                _artifacts.evict(_artifacts._memo_path(key))
        except Exception:  # noqa: BLE001
            pass
    return dropped


# ---------------------------------------------------------------------------
# diagnostics
# ---------------------------------------------------------------------------


def snapshot() -> dict:
    with _lock:
        d = dict(stats)
        d["digest_wall_s"] = round(d["digest_wall_s"], 6)
        d["audit_wall_s"] = round(d["audit_wall_s"], 6)
    d["enabled"] = enabled()
    d["audit_every"] = audit_every()
    d["suspect"] = suspect()
    d["failures_in_window"] = failure_count()
    d["suspect_threshold"] = suspect_threshold()
    d["suspect_window_s"] = suspect_window_s()
    return d


def reset() -> None:
    """Tests: zero counters, the suspect window and the audit sampler."""
    with _lock:
        for k in stats:
            stats[k] = 0.0 if isinstance(stats[k], float) else 0
        _strikes.clear()
        _audit_counter[0] = 0
