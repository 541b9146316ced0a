"""Shape-bucketed compile classes (``RAMBA_COMPILE_CLASSES``).

Counterpart of ``ramba_tpu/compile/classes.py``.  A workload whose request
shapes vary pays one compiled program per novel shape: in ramba_tpu an
XLA compile, in this port only a new compile-cache entry and ledger row
(no build: the generic lowering runs op by op, and the kernels' sources
do not depend on the extent).  This module maps dynamic leading
dimensions onto a small set of bucket sizes at flush time: leaf tensors
are zero-padded up to the bucket, the program runs at the bucket shape,
and outputs are sliced back to the exact extent.

Policy (env ``RAMBA_COMPILE_CLASSES``)::

    off            (default) exact shapes
    pow2           bucket the leading dim up to the next power of two
    linear:<step>  bucket up to the next multiple of <step>

Safety: padding is sound only when no instruction depends on the leading
extent, so only programs made of ``map`` / ``cast`` / ``round`` bucket,
and every output (and every full-rank leaf) must share one leading extent;
anything else bails out to exact shapes, counted
``compile.bucket_bailout``.  Padded rows compute on zeros: a ``log``, a
``// 0`` or a ``reciprocal`` of a padded 0 gives inf, NaN or the integer
rule's value in rows the slice drops, and none of them raises (the port's
ops never raise on values).  Rows ``0..n-1`` are computed exactly as the
exact-shape program computes them, so the stripped result is byte-equal.

Only the fused program buckets (``core/fuser.py``): a segmented program
runs exact shapes, and so does a program the kernels take (a 1-D
elementwise program runs elemred at its own length: a new length costs a
plan over the loaded library, and on the card that is cheaper than the
pad copy a bucket adds to every flush).  The decision is a pure function of (program, shapes,
policy), so ranks agree by construction; :func:`decisions` records it per
fingerprint.  Fault site ``compile:bucket`` forges a plan that skips the
op-safety proof (:func:`forced_plan`).
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from ramba_tpu_torch.core import expr as _expr
from ramba_tpu_torch.observe import registry as _registry

# Ops whose rows are computed independently of the leading extent.
SAFE_OPS = frozenset({"map", "cast", "round"})

_lock = threading.Lock()
_mode: tuple = ("off",)

#: running counters (``snapshot()`` adds the derived pad-waste fraction)
stats = {
    "planned": 0,     # flushes that got a bucket plan
    "padded": 0,      # plans whose bucket exceeds the extent
    "bailouts": 0,    # programs left at exact shapes
    "pad_bytes": 0,   # bytes of zero padding made
    "leaf_bytes": 0,  # leaf bytes of planned flushes (the waste's base)
}

# fingerprint -> class token (None: exact shapes), bounded
_decisions: dict = {}
_DECISIONS_MAX = 4096


def _parse(value: str) -> tuple:
    v = (value or "").strip().lower()
    if not v or v in ("0", "off", "false", "no", "none"):
        return ("off",)
    if v in ("1", "pow2", "on", "true"):
        return ("pow2",)
    if v.startswith("linear:"):
        try:
            step = int(v.split(":", 1)[1])
        except ValueError:
            step = 0
        if step >= 1:
            return ("linear", step)
    # an unknown policy keeps exact shapes, as ramba_tpu does
    return ("off",)


def reconfigure() -> None:
    """Re-read ``RAMBA_COMPILE_CLASSES``."""
    global _mode
    _mode = _parse(os.environ.get("RAMBA_COMPILE_CLASSES", ""))


def enabled() -> bool:
    return _mode[0] != "off"


def mode() -> tuple:
    return _mode


def bucket_for(n: int, policy: Optional[tuple] = None) -> int:
    """The bucket (padded leading extent) of an exact extent ``n``."""
    p = policy or _mode
    if n <= 0:
        return n
    if p[0] == "pow2":
        b = 1
        while b < n:
            b <<= 1
        return b
    if p[0] == "linear":
        step = p[1]
        return ((n + step - 1) // step) * step
    return n


class ClassPlan:
    """One flush's bucket decision: ``token`` joins the fuser's cache key,
    ``pad_slots`` are the leaf slots padded along axis 0 from ``n`` to
    ``bucket``, ``pad_waste_bytes`` is charged to the span and ledger."""

    __slots__ = ("token", "n", "bucket", "pad_slots", "pad_waste_bytes")

    def __init__(self, token, n, bucket, pad_slots, pad_waste_bytes):
        self.token = token
        self.n = n
        self.bucket = bucket
        self.pad_slots = pad_slots
        self.pad_waste_bytes = pad_waste_bytes

    def __repr__(self):  # pragma: no cover - debug aid
        return (f"ClassPlan({self.token!r}, n={self.n}, "
                f"bucket={self.bucket}, pads={len(self.pad_slots)})")


def check_program(program) -> Optional[str]:
    """Why the program does not bucket, or None when every instruction is
    independent of the leading extent."""
    for op, _static, _slots in program.instrs:
        if op not in SAFE_OPS:
            return f"shape-sensitive instr {op!r}"
    return None


def leaf_avals(leaf_vals: Sequence) -> Optional[list]:
    """Avals of the leaf values; None when one defies classification."""
    out = []
    for v in leaf_vals:
        try:
            out.append(_expr.aval_of(v))
        except Exception:
            return None
    return out


def slot_avals(program, lavals: Sequence) -> Optional[list]:
    """``infer_aval`` chained over the program; None on any failure."""
    avals = list(lavals)
    for op, static, argslots in program.instrs:
        try:
            avals.append(_expr.infer_aval(op, static,
                                          [avals[s] for s in argslots]))
        except Exception:
            return None
    return avals


def _itemsize(dt) -> int:
    try:
        return np.dtype(dt).itemsize
    except TypeError:  # bfloat16
        return 2


def shape_plan(program, lavals: Sequence,
               policy: Optional[tuple] = None) -> Optional[ClassPlan]:
    """The shape half of the safety argument: every output (and every
    full-rank leaf) shares one leading extent N, lower-rank leaves never
    broadcast onto axis 0.  Does not check op safety (``forced_plan``
    uses it to forge an unsafe claim)."""
    policy = policy or _mode
    avals = slot_avals(program, lavals)
    if avals is None:
        return None
    outs = [avals[s] for s in program.out_slots]
    if not outs or any(len(a.shape) < 1 for a in outs):
        return None
    n = outs[0].shape[0]
    if n < 1 or any(a.shape[0] != n for a in outs):
        return None
    ndim_max = max(len(a.shape) for a in avals)
    if any(len(a.shape) != ndim_max for a in outs):
        return None
    for a in avals:
        if len(a.shape) == ndim_max and a.shape[0] not in (n, 1):
            return None
    bucket = bucket_for(n, policy)
    pad_slots = tuple(
        i for i, a in enumerate(avals[: program.n_leaves])
        if len(a.shape) == ndim_max and a.shape[0] == n
    )
    waste = 0
    if bucket > n:
        for s in pad_slots:
            a = avals[s]
            row = int(np.prod(a.shape[1:], dtype=np.int64)) if len(
                a.shape) > 1 else 1
            waste += (bucket - n) * row * _itemsize(a.dtype)
    token = (policy[0] if policy[0] != "linear"
             else f"linear:{policy[1]}", bucket)
    return ClassPlan(token, n, bucket, pad_slots, waste)


def plan_for(program, leaf_vals) -> Optional[ClassPlan]:
    """Bucket decision for one flush, or None for exact shapes (a program
    that cannot bucket counts ``compile.bucket_bailout``)."""
    if _mode[0] == "off" or not program.instrs:
        return None
    if check_program(program) is not None:
        _bailout()
        return None
    lavals = leaf_avals(leaf_vals)
    if lavals is None:
        _bailout()
        return None
    plan = shape_plan(program, lavals)
    if plan is None:
        _bailout()
        return None
    with _lock:
        stats["planned"] += 1
        if plan.bucket > plan.n:
            stats["padded"] += 1
        stats["pad_bytes"] += plan.pad_waste_bytes
        stats["leaf_bytes"] += sum(
            int(np.prod(a.shape, dtype=np.int64)) * _itemsize(a.dtype)
            for a in lavals if a.shape
        )
    return plan


def forced_plan(program, leaf_vals) -> Optional[ClassPlan]:
    """Fault-injection hook (``compile:bucket``): a plan that skips the
    op-safety proof."""
    if _mode[0] == "off":
        return None
    lavals = leaf_avals(leaf_vals)
    if lavals is None:
        return None
    return shape_plan(program, lavals)


def _bailout() -> None:
    with _lock:
        stats["bailouts"] += 1
    _registry.inc("compile.bucket_bailout")


def apply(plan: ClassPlan, leaf_vals: Sequence) -> list:
    """Zero-pad the planned leaf slots from ``n`` to ``bucket`` along axis
    0, into fresh tensors on each leaf's device."""
    out = list(leaf_vals)
    if plan.bucket <= plan.n:
        return out
    for s in plan.pad_slots:
        v = out[s]
        buf = torch.empty((plan.bucket,) + tuple(v.shape[1:]),
                          dtype=v.dtype, device=v.device)
        buf[: plan.n].copy_(v)
        buf[plan.n:].zero_()
        out[s] = buf
    return out


def strip(plan: ClassPlan, outs: Sequence) -> tuple:
    """Slice bucket-shaped outputs back to the exact extent: rows
    ``0..n-1`` are the exact-shape program's rows, byte for byte."""
    if plan.bucket <= plan.n:
        return tuple(outs)
    return tuple(o[: plan.n] for o in outs)


def note_decision(fingerprint: str, plan: Optional[ClassPlan]) -> None:
    """Record the class decision of one fingerprint."""
    token = plan.token if plan is not None else None
    with _lock:
        if len(_decisions) >= _DECISIONS_MAX and fingerprint not in _decisions:
            return
        _decisions[fingerprint] = token


def decisions() -> dict:
    """fingerprint -> class token map (None: exact shapes)."""
    with _lock:
        return dict(_decisions)


def snapshot() -> dict:
    with _lock:
        d = dict(stats)
    d["mode"] = (":".join(str(p) for p in _mode)
                 if _mode[0] == "linear" else _mode[0])
    lb = d.pop("leaf_bytes")
    d["pad_waste_frac"] = (d["pad_bytes"] / lb) if lb else 0.0
    return d


def reset() -> None:
    with _lock:
        for k in stats:
            stats[k] = 0
        _decisions.clear()
    reconfigure()


reconfigure()
