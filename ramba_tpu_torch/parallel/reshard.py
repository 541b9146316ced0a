"""Layout changes with bounded peak memory and a coherence fence.

Counterpart of ``ramba_tpu/parallel/reshard.py``: ``reshard(arr,
new_spec)`` moves an array to another layout as a schedule of stages.

* **Plan** — :func:`plan_reshard` cuts the transfer into slabs along the
  array's longest axis, no slab above ``max_stage_bytes``
  (``RAMBA_RESHARD_STAGE_BYTES``, else the memory governor's chunk
  target).  It is the reference's function: the same shape, dtype and
  specs give the same stages and the same 31-bit plan hash.
* **Fence** — across ranks the plan hash goes through
  ``coherence.agree("reshard:plan", ...)`` (rank 0's hash, every rank
  checks its own) before anything moves: ranks that would run different
  schedules raise :class:`PlanMismatch` instead.
* **Stages** — in one process (every mesh position holds one device)
  each slab is copied into a new tensor, which carries the new layout.
  On a mesh of ranks each stage moves only the intersections of the
  ranks' source blocks with the other ranks' destination blocks inside
  the slab, in one ``distributed.exchange`` round (gloo through pinned
  host buffers where ranks share a card, NCCL where each has its own);
  a rank that holds a piece itself copies it, and a piece several ranks
  hold is sent by one of them.  The new block is allocated once; a
  stage's pieces in flight are the only other buffers, so peak live
  stays within ``src + dst + one slab``.  The destination and every
  stage go through the governor (``memory.reserve_headroom``) and ride
  in its transient bytes, which settle back to zero.
* **Rollback** — the source is never written.  A stage that fails
  (really, or by the ``reshard:stage`` fault site) drops the partial
  destination, emits a ``reshard``/``rollback`` event and raises
  :class:`ReshardError`; across ranks a fault on one rank is agreed
  before the stage's exchange, so every rank raises.

Fault sites ``reshard:plan`` (after the fence) and ``reshard:stage``
(before every stage) take the ``rank=``, ``after=`` and ``hang:ms=``
payloads.  Observable: ``reshard`` events (plan/stage/done/rollback), the
counters ``reshard.plans``, ``.stages``, ``.completed``, ``.rollbacks``
and ``.plan_mismatches``, and ``distributed.note_transfer("reshard",
bytes)`` per stage.
"""

from __future__ import annotations

import hashlib
import itertools
import math
import os
import threading
from typing import Optional

import numpy as np
import torch

from ramba_tpu_torch import common as _common
from ramba_tpu_torch.core.expr import Const, to_torch_dtype
from ramba_tpu_torch.observe import events as _events
from ramba_tpu_torch.observe import registry as _registry
from ramba_tpu_torch.parallel import distributed as _distributed
from ramba_tpu_torch.parallel import mesh as _mesh
from ramba_tpu_torch.resilience import coherence as _coherence
from ramba_tpu_torch.resilience import faults as _faults
from ramba_tpu_torch.resilience import memory as _memory


class ReshardError(RuntimeError):
    """A reshard schedule failed (a stage fault, diverging plans).  The
    source array is intact: callers may retry or surface the error."""


class PlanMismatch(ReshardError):
    """The coherence fence disagreed with this rank's plan hash: the
    ranks would have run different stage lists."""


# One epoch per reshard, advanced in lockstep across ranks (every rank
# runs the same reshards in the same order).
_epoch_counter = itertools.count(1)
_epoch_lock = threading.Lock()


def _next_epoch() -> int:
    with _epoch_lock:
        return next(_epoch_counter)


# ---------------------------------------------------------------------------
# plan (the reference's, to the byte: the hash is compared across ports)
# ---------------------------------------------------------------------------


def _norm_spec(spec) -> tuple:
    """Spec entries with trailing Nones stripped: ``P('x')`` and ``P('x',
    None)`` are one layout."""
    if spec is None:
        return ()
    entries = tuple(spec)
    while entries and entries[-1] is None:
        entries = entries[:-1]
    return entries


def default_stage_bytes() -> int:
    """Per-stage byte budget: ``RAMBA_RESHARD_STAGE_BYTES`` (at least 64
    KiB), else the governor's chunk target (agreed across ranks)."""
    raw = os.environ.get("RAMBA_RESHARD_STAGE_BYTES")
    if raw:
        try:
            return max(1 << 16, _common.parse_bytes(raw))
        except ValueError:
            pass
    return _memory.chunk_target_bytes()


class Stage:
    """One slab of the transfer: global rows ``[lo, hi)`` along
    ``plan.axis``."""

    __slots__ = ("index", "lo", "hi", "nbytes")

    def __init__(self, index: int, lo: int, hi: int, nbytes: int):
        self.index = index
        self.lo = lo
        self.hi = hi
        self.nbytes = nbytes

    def __repr__(self):
        return f"Stage({self.index}, [{self.lo}:{self.hi}), {self.nbytes}B)"


class ReshardPlan:
    """An agreed schedule for one layout change."""

    __slots__ = ("shape", "dtype", "src_spec", "dst_spec", "axis",
                 "stages", "total_bytes", "max_stage_bytes")

    def __init__(self, shape, dtype, src_spec, dst_spec, axis, stages,
                 total_bytes, max_stage_bytes):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self.src_spec = tuple(src_spec)
        self.dst_spec = tuple(dst_spec)
        self.axis = axis            # None for a single-stage plan
        self.stages = list(stages)
        self.total_bytes = int(total_bytes)
        self.max_stage_bytes = int(max_stage_bytes)

    @property
    def peak_bound_bytes(self) -> int:
        """Source + destination + the largest stage slab (one stage:
        source + destination)."""
        stage_max = max((s.nbytes for s in self.stages), default=0)
        if len(self.stages) <= 1:
            return 2 * self.total_bytes
        return 2 * self.total_bytes + stage_max

    def describe(self) -> str:
        """The canonical plan text the fence hashes."""
        rows = [
            f"shape={self.shape} dtype={self.dtype}",
            f"src={self.src_spec!r} dst={self.dst_spec!r} axis={self.axis}",
        ]
        rows += [f"stage {s.index}: [{s.lo}:{s.hi}) {s.nbytes}B"
                 for s in self.stages]
        return "\n".join(rows)

    def hash31(self) -> int:
        """The plan digest folded to 31 bits (the fence moves an int)."""
        h = hashlib.sha1(self.describe().encode()).digest()
        return int.from_bytes(h[:4], "big") & 0x7FFFFFFF


def plan_reshard(shape, dtype, src_spec, dst_spec, *,
                 max_stage_bytes: Optional[int] = None) -> ReshardPlan:
    """The stage schedule moving ``shape``/``dtype`` from ``src_spec`` to
    ``dst_spec``: one stage when it fits ``max_stage_bytes``, else slabs
    of whole rows of the longest axis.  Deterministic: the same on every
    rank."""
    shape = tuple(int(s) for s in shape)
    dtype = np.dtype(dtype)
    src = _norm_spec(src_spec)
    dst = _norm_spec(dst_spec)
    total = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize \
        if shape else dtype.itemsize
    if max_stage_bytes is None:
        max_stage_bytes = default_stage_bytes()
    max_stage_bytes = max(1, int(max_stage_bytes))
    if total <= max_stage_bytes or not shape:
        return ReshardPlan(shape, dtype, src, dst, None,
                           [Stage(0, 0, shape[0] if shape else 1, total)],
                           total, max_stage_bytes)
    axis = int(np.argmax(shape))
    n = shape[axis]
    row_bytes = max(1, total // max(1, n))
    rows_per_stage = max(1, max_stage_bytes // row_bytes)
    stages = []
    lo = 0
    i = 0
    while lo < n:
        hi = min(n, lo + rows_per_stage)
        stages.append(Stage(i, lo, hi, (hi - lo) * row_bytes))
        lo = hi
        i += 1
    return ReshardPlan(shape, dtype, src, dst, axis, stages, total,
                       max_stage_bytes)


def agree_plan(plan: ReshardPlan, epoch: int) -> int:
    """The fence: rank 0's plan hash against this rank's.  Returns the
    coherence epoch of the round (0 when not engaged); raises
    :class:`PlanMismatch` before anything has moved."""
    if not _coherence.engaged():
        return 0
    mine = plan.hash31()
    agreed = _coherence.agree("reshard:plan", mine, reduce="bcast")
    if agreed != mine:
        _registry.inc("reshard.plan_mismatches")
        raise PlanMismatch(
            f"reshard epoch {epoch}: plan hash {mine:#x} disagrees with "
            f"the group's {agreed:#x}")
    return _coherence.last_epoch("reshard:plan")


def _gate(site: str, ep: int, **ctx) -> None:
    """The fault check before a step, agreed across ranks: a fault
    injected on one rank aborts the step on every rank before its
    exchange (else the others would wait for it there)."""
    err: Optional[Exception] = None
    coh = _coherence.engaged()
    try:
        _faults.check(site, epoch=ep, **ctx)
    except Exception as e:
        if not coh:
            raise
        err = e
    if not coh:
        return
    my = _coherence.P_OK if err is None else _coherence.P_DROP
    decision = _coherence.agree(f"{site}:gate", my, reduce="max")
    if decision != _coherence.P_OK:
        if err is not None:
            raise err
        raise _coherence.CoherentAbort(f"{site}:gate", decision)


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------


def _source_sharding(c: Const, mesh) -> "_mesh.NamedSharding":
    """The layout a leaf holds: its own, else (one process) the default
    layout of ``mesh``, or (ranks) the whole value on every rank."""
    if c.sharding is not None:
        return c.sharding
    if _mesh.is_rank_mesh(mesh):
        return _mesh.NamedSharding(mesh, _mesh.P())
    return _mesh.NamedSharding(mesh, _mesh.default_spec(c.shape, mesh))


def _stage_done(ep: int, st: Stage) -> None:
    _registry.inc("reshard.stages")
    _distributed.note_transfer("reshard", st.nbytes)
    _events.emit({"type": "reshard", "action": "stage", "epoch": ep,
                  "stage": st.index, "bytes": st.nbytes})


def _slab(plan: ReshardPlan, st: Stage) -> tuple:
    """The stage's global ranges, one ``(start, stop)`` per dim."""
    out = [(0, n) for n in plan.shape]
    if plan.axis is not None:
        out[plan.axis] = (st.lo, st.hi)
    return tuple(out)


def _meet(a, b):
    """The intersection of two boxes of ranges, or None when empty."""
    out = tuple((max(x0, y0), min(x1, y1)) for (x0, x1), (y0, y1)
                in zip(a, b))
    return None if any(lo >= hi for lo, hi in out) else out


def _rel(box, base) -> tuple:
    """``box`` as slices into the block that starts at ``base``."""
    return tuple(slice(lo - b0, hi - b0) for (lo, hi), (b0, _b1)
                 in zip(box, base))


def _run_one_process(src, plan, dst_sh, ep):
    _memory.reserve_headroom(plan.total_bytes, site="reshard:dst")
    dst = torch.empty(tuple(src.shape), dtype=src.dtype, device=src.device)
    led = _memory.ledger
    led._begin_transient(plan.total_bytes)
    try:
        for st in plan.stages:
            _gate("reshard:stage", ep, stage=st.index)
            _memory.reserve_headroom(st.nbytes, site="reshard:stage")
            led._begin_transient(st.nbytes)
            try:
                idx = tuple(slice(lo, hi) for lo, hi in _slab(plan, st)) \
                    if plan.shape else ()
                dst[idx] = src[idx]
            finally:
                led._end_transient(st.nbytes)
            _stage_done(ep, st)
    finally:
        led._end_transient(plan.total_bytes)
    return Const(dst, sharding=dst_sh)


def _boxes(sh, q, shape) -> list:
    """The boxes of the blocks rank ``q`` holds (one empty block outside
    the mesh)."""
    held = sh.rank_blocks(q, shape)
    return [_mesh.index_box(i, shape) for _p, i in held] or [
        _mesh.index_box(sh.rank_index(q, shape), shape)]


def _run_ranks(src, plan, src_sh, dst_sh, ep):
    """Every stage's pieces across ranks in one exchange round: each
    destination block of each rank takes every piece of it from a rank
    holding the source block (itself where it holds one: a device copy);
    every rank lists the moves in the same order."""
    shape = plan.shape
    world = _distributed.process_count()
    me = _distributed.process_index()
    src_box = [_boxes(src_sh, q, shape) for q in range(world)]
    dst_box = [_boxes(dst_sh, q, shape) for q in range(world)]
    src_blocks = dict(zip(src_box[me], src_sh.split_local(src, shape)))
    # the distinct source blocks, each with the ranks that hold it
    holders: dict = {}
    for q, boxes in enumerate(src_box):
        for box in boxes:
            if all(lo < hi for lo, hi in box):
                holders.setdefault(box, []).append(q)
    item = plan.dtype.itemsize
    dst_bytes = sum(math.prod(hi - lo for lo, hi in box)
                    for box in dst_box[me]) * item
    _memory.reserve_headroom(dst_bytes, site="reshard:dst")
    dsts = [torch.empty(tuple(hi - lo for lo, hi in box),
                        dtype=to_torch_dtype(plan.dtype), device=src.device)
            for box in dst_box[me]]
    led = _memory.ledger
    led._begin_transient(dst_bytes)
    try:
        for st in plan.stages:
            _gate("reshard:stage", ep, stage=st.index)
            slab = _slab(plan, st)
            sends, recvs, into = [], [], []
            for q in range(world):
                for k, dbox in enumerate(dst_box[q]):
                    want = _meet(dbox, slab)
                    if want is None:
                        continue
                    for box, hs in holders.items():
                        piece = _meet(box, want)
                        if piece is None:
                            continue
                        sender = q if q in hs else hs[q % len(hs)]
                        if sender == me:
                            part = src_blocks[box][_rel(piece, box)]
                        if sender == me and q == me:
                            dsts[k][_rel(piece, dbox)] = part
                        elif sender == me:
                            sends.append((part, q))
                        elif q == me:
                            recvs.append((tuple(hi - lo for lo, hi in piece),
                                          dsts[k].dtype, sender))
                            into.append((k, _rel(piece, dbox)))
            flight = item * (sum(t.numel() for t, _q in sends)
                             + sum(math.prod(s) for s, _d, _r in recvs))
            _memory.reserve_headroom(flight, site="reshard:stage")
            led._begin_transient(flight)
            try:
                got = _distributed.exchange(sends, recvs)
                for (k, idx), v in zip(into, got):
                    dsts[k][idx] = v
                del got
            finally:
                led._end_transient(flight)
            _stage_done(ep, st)
    finally:
        led._end_transient(dst_bytes)
    return Const(_mesh.pack(dsts), sharding=dst_sh, shape=shape)


def execute_plan(value: Const, plan: ReshardPlan, *,
                 epoch: Optional[int] = None, mesh=None) -> Const:
    """Run a fenced plan over a leaf; returns the leaf under the new
    layout (on ``mesh``, default the current mesh), the source left as
    it was.  Any failure rolls back and raises :class:`ReshardError`."""
    from ramba_tpu_torch.core.fuser import leaf_value

    ep = epoch if epoch is not None else _next_epoch()
    mesh = mesh if mesh is not None else _mesh.get_mesh()
    dst_sh = _mesh.NamedSharding(mesh, _mesh.P(*_mesh.canonical(
        plan.dst_spec)))
    _registry.inc("reshard.plans")
    _events.emit({
        "type": "reshard", "action": "plan", "epoch": ep,
        "stages": len(plan.stages), "bytes": plan.total_bytes,
        "peak_bound_bytes": plan.peak_bound_bytes,
        "src": repr(plan.src_spec), "dst": repr(plan.dst_spec),
    })
    try:
        _gate("reshard:plan", ep)
        src_sh = _source_sharding(value, mesh)
        src = leaf_value(value)  # a spilled source comes back first
        ranks = _mesh.is_rank_mesh(src_sh.mesh)
        if ranks != _mesh.is_rank_mesh(mesh):
            raise ValueError("reshard between a mesh of ranks and a "
                             "mesh of one process")
        if ranks:
            out = _run_ranks(src, plan, src_sh, dst_sh, ep)
        else:
            out = _run_one_process(src, plan, dst_sh, ep)
    except ReshardError:
        raise
    except Exception as e:
        # the partial destination dies with this frame; the source was
        # never written: rolling back is dropping the work
        _registry.inc("reshard.rollbacks")
        _events.emit({
            "type": "reshard", "action": "rollback", "epoch": ep,
            "error": f"{type(e).__name__}: {e}"[:200],
        })
        raise ReshardError(
            f"reshard epoch {ep} failed; source sharding intact") from e
    _registry.inc("reshard.completed")
    _events.emit({
        "type": "reshard", "action": "done", "epoch": ep,
        "bytes": plan.total_bytes, "stages": len(plan.stages),
    })
    return out


def reshard_value(value, new_spec, *, max_stage_bytes: Optional[int] = None,
                  mesh=None) -> Const:
    """A leaf (a ``Const``, or a tensor in the current mesh's default
    layout) under ``new_spec`` (a spec, or a ``NamedSharding`` naming its
    mesh): plan, fence, stages.  Returns the leaf itself when it already
    has that layout."""
    if isinstance(new_spec, _mesh.NamedSharding):
        mesh, new_spec = new_spec.mesh, new_spec.spec
    if not isinstance(value, Const):
        value = Const(value)
    target = mesh if mesh is not None else _mesh.get_mesh()
    src_sh = _source_sharding(value, target)
    dst = _norm_spec(new_spec)
    src = _norm_spec(src_sh.spec)
    if _mesh.canonical(src) == _mesh.canonical(dst) \
            and src_sh.mesh == target:
        return value
    plan = plan_reshard(value.shape, value.dtype, src, dst,
                        max_stage_bytes=max_stage_bytes)
    ep = _next_epoch()
    agree_plan(plan, ep)
    return execute_plan(value, plan, epoch=ep, mesh=target)


def reshard(arr, new_spec, *, max_stage_bytes: Optional[int] = None):
    """Move an array to ``new_spec`` in place and return it.

    A port array is flushed, a spilled leaf restored, and its leaf
    swapped for the new layout's (views of it see the new leaf); a
    tensor gives a new array.  On failure the array is untouched: the
    same values under the same layout."""
    from ramba_tpu_torch.core.ndarray import ndarray

    if not isinstance(arr, ndarray):
        return ndarray(reshard_value(arr, new_spec,
                                     max_stage_bytes=max_stage_bytes))
    if arr._base is not None:
        raise ValueError("reshard: views cannot be resharded; "
                         "reshard the base array")
    c = arr._const()
    out = reshard_value(c, new_spec, max_stage_bytes=max_stage_bytes)
    if out is not c:
        arr._set_expr(out)
    return arr
