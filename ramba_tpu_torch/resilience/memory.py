"""The memory governor's core: device budget, live-bytes ledger, host spill.

Counterpart of ``ramba_tpu/resilience/memory.py`` (its budget, ledger,
spill, admission, oom-eviction and governed-placement parts):

* **Budget** — per-process device memory: ``RAMBA_HBM_BUDGET`` when set
  (``common.parse_bytes`` grammar, e.g. ``4g``), else the card's capacity
  (``torch.cuda.mem_get_info``) divided by the number of ranks that
  compute on that card (``distributed.rank_devices()``: four ranks on one
  card get a quarter each, so their budgets add up to the card), else
  *no budget* on the CPU, where the governor never spills or evicts.
* **Ledger** — live bytes of every realized ``Const`` an array owns,
  keyed by tensor storage (two arrays over one storage count it once),
  with weak references to the owning Consts, so it never pins memory
  itself.  ``ndarray`` feeds it through ``fuser.owner_incref`` /
  ``owner_decref``; a flush pins its leaves while it runs.
* **Spill** — LRU eviction of cold, unpinned entries to host memory
  (``resilience.spill``), restored on the next touch
  (``fuser.leaf_value``).  An entry is a candidate when every Const that
  owns it holds the same view and that view spans its storage (spilling a
  smaller view would free nothing).
* **Governed placement** — ``reserve_headroom`` spills LRU victims when a
  placement would cross the watermark (``RAMBA_HBM_WATERMARK``, default
  0.9 of the budget); ``governed_device_put`` places a tensor after that
  check and counts its bytes as transient until it dies.  Uploads
  (``ndarray.put_sharded``) and reshard stages go through them.
* **Admission** — before a flush runs, :func:`admit` holds its peak
  estimate (:func:`estimate_program_bytes`) plus the other live bytes
  against the watermark; when eviction cannot make it fit, the flush
  starts the degradation ladder (``resilience/degrade.py``) at the
  ``chunked`` rung.  An out-of-memory failure spills cold arrays
  (:func:`evict_for_oom`) before the ladder drops a rung.  Serving-tenant
  quotas come with serving (ROADMAP A.10).

The governor moves nothing between the card and the host unless a
placement or a flush's admission asks for room, an out-of-memory failure
asks for an eviction or the caller does, and every
spill and restore is counted (``memory.evictions``, ``memory.restores``,
the gauges ``memory.live_bytes`` and ``memory.spilled_bytes``, ``memory``
events, the host-boundary bytes in ``observe.registry.comm``).

The one sanctioned mutation of an expression node is the governor's: a
``Const.value`` swapped between a tensor and its :class:`SpilledArray`
(and a reshard's :meth:`Ledger.swap_value`).
"""

from __future__ import annotations

import itertools
import os
import re
import threading
import weakref
from typing import Optional

import torch

from ramba_tpu_torch import common as _common
from ramba_tpu_torch.observe import events as _events
from ramba_tpu_torch.observe import registry as _registry
from ramba_tpu_torch.resilience import coherence as _coherence
from ramba_tpu_torch.resilience import spill as _spill

TENANTS = "serving-tenant quotas come with serving: ROADMAP A.10"


def _key(v):
    """The ledger key of a value: its storage (device, base address) for
    a tensor, its identity for a spilled value; None for anything that
    holds no device bytes."""
    if isinstance(v, _spill.SpilledArray):
        return ("h", id(v))
    if not isinstance(v, torch.Tensor):
        return None
    st = v.untyped_storage()
    if st.nbytes() == 0:
        return None
    return (v.device.type, v.device.index, st.data_ptr())


def _nbytes(v) -> int:
    if isinstance(v, _spill.SpilledArray):
        return v.device_nbytes
    if isinstance(v, torch.Tensor):
        return v.untyped_storage().nbytes()
    return 0


# ---------------------------------------------------------------------------
# budget / watermark
# ---------------------------------------------------------------------------

_probe: dict = {}


def _ranks_on_my_card() -> int:
    from ramba_tpu_torch.parallel import distributed

    devs = distributed.rank_devices()
    if not devs:
        return 1
    mine = devs[distributed.process_index()]
    return max(1, sum(1 for d in devs if d == mine))


def device_budget_bytes() -> Optional[int]:
    """This process's share of its card: the card's capacity over the
    ranks computing on it (None on the CPU).  Probed once per device and
    process group."""
    dev = _common.device()
    if dev.type != "cuda":
        return None
    share = _ranks_on_my_card()
    k = (str(dev), share)
    if k not in _probe:
        _probe[k] = int(torch.cuda.mem_get_info(dev)[1]) // share
    return _probe[k]


_parsed: dict = {}  # RAMBA_HBM_BUDGET's text -> bytes (None: unparsable)


def budget_bytes() -> Optional[int]:
    """The effective budget; None disables the governor (the CPU
    default)."""
    raw = os.environ.get("RAMBA_HBM_BUDGET")
    if raw:
        if raw not in _parsed:
            try:
                _parsed[raw] = max(1, _common.parse_bytes(raw))
            except ValueError:
                _parsed[raw] = None
        if _parsed[raw] is not None:
            return _parsed[raw]
    return device_budget_bytes()


def watermark_bytes(budget: Optional[int] = None) -> Optional[int]:
    """The placement threshold: ``RAMBA_HBM_WATERMARK`` as a fraction of
    the budget when <= 1.0, a byte count otherwise; default 0.9."""
    if budget is None:
        budget = budget_bytes()
    if budget is None:
        return None
    raw = os.environ.get("RAMBA_HBM_WATERMARK")
    if raw:
        try:
            v = float(raw)
            if 0.0 < v <= 1.0:
                return int(budget * v)
        except ValueError:
            pass
        try:
            return max(1, _common.parse_bytes(raw))
        except ValueError:
            pass
    return int(budget * 0.9)


def chunk_target_bytes(agree: bool = True) -> int:
    """Per-segment byte target (a reshard's stage size by default, the
    chunked rung's bytes a segment): ``RAMBA_CHUNK_BYTES``, else a
    quarter of the watermark when a budget is known, else 256 MiB.
    Across ranks every rank takes the smallest rank's value
    (``coherence.agree``, in 64 KiB units), so the ranks cut the same
    stages; ``agree=False`` keeps this rank's own (a rank-local program
    holds no collective)."""
    raw = os.environ.get("RAMBA_CHUNK_BYTES")
    target = None
    if raw:
        try:
            target = max(1, _common.parse_bytes(raw))
        except ValueError:
            pass
    if target is None:
        b = budget_bytes()
        if b:
            target = max(1 << 16, (watermark_bytes(b) or b) // 4)
        else:
            target = 256 << 20
    if agree and _coherence.engaged():
        target = max(1 << 16, _coherence.agree(
            "memory:chunk_bytes", target >> 16, reduce="min") << 16)
    return target


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------


class _Entry:
    __slots__ = ("key", "nbytes", "consts", "owners", "seq", "pins",
                 "spilled")

    def __init__(self, key, nbytes: int, seq: int, spilled: bool):
        self.key = key
        self.nbytes = nbytes    # device bytes when resident
        self.consts: list = []  # weakrefs to the owning Consts
        self.owners = 0         # arrays holding one of those Consts
        self.seq = seq          # LRU clock: higher = touched later
        self.pins = 0           # > 0 while a flush reads it
        self.spilled = spilled


class Ledger:
    """Live-bytes accounting over every realized leaf an array owns.

    Holds no strong reference to a tensor or a Const: an entry leaves
    when its last owner lets go (:meth:`on_decref`), or when its Consts
    are all collected."""

    def __init__(self):
        self.entries: dict = {}
        self.live_bytes = 0
        self.spilled_bytes = 0
        self.peak_live_bytes = 0
        self.evictions = 0
        self.restores = 0
        # bytes placed outside the ledger's entries and still alive
        # (governed_device_put, reshard stage buffers), counted into
        # peak_live_bytes
        self.transient_bytes = 0
        self._clock = itertools.count(1)
        self._lock = threading.RLock()

    def _peak(self) -> None:
        now = self.live_bytes + self.transient_bytes
        if now > self.peak_live_bytes:
            self.peak_live_bytes = now

    def _account(self, e: _Entry, sign: int) -> None:
        if e.spilled:
            self.spilled_bytes += sign * e.nbytes
        else:
            self.live_bytes += sign * e.nbytes
            self._peak()

    # -- ownership (ndarray._set_expr and ndarray.__del__) -------------------

    def on_incref(self, const) -> None:
        k = _key(const.value)
        if k is None:
            return
        with self._lock:
            e = self.entries.get(k)
            if e is None:
                e = _Entry(k, _nbytes(const.value), next(self._clock),
                           isinstance(const.value, _spill.SpilledArray))
                self.entries[k] = e
                self._account(e, +1)
            else:
                e.seq = next(self._clock)
            e.owners += 1
            live = [r for r in e.consts if r() is not None]
            if not any(r() is const for r in live):
                live.append(weakref.ref(const))
            e.consts = live

    def on_decref(self, value) -> None:
        k = _key(value)
        if k is None:
            return
        with self._lock:
            e = self.entries.get(k)
            if e is None:
                return
            e.owners -= 1
            if e.owners > 0:
                return
            del self.entries[k]
            self._account(e, -1)

    def _drop(self, e: _Entry) -> None:
        """Remove an entry whose Consts all died without a decref."""
        with self._lock:
            if self.entries.pop(e.key, None) is not None:
                self._account(e, -1)

    def owner_count(self, value) -> int:
        """Arrays owning the storage of ``value`` (0 when untracked): the
        verifier's live-alias census."""
        k = _key(value)
        if k is None:
            return 0
        with self._lock:
            e = self.entries.get(k)
            return e.owners if e is not None else 0

    def touch(self, value) -> None:
        """Mark ``value``'s entry most recently used (a result-memo hit)."""
        k = _key(value)
        if k is None:
            return
        with self._lock:
            e = self.entries.get(k)
            if e is not None:
                e.seq = next(self._clock)

    # -- pinning: a flush's leaves are never spill candidates ----------------

    def pin_values(self, vals) -> list:
        keys = []
        with self._lock:
            if not self.entries:
                return keys
            for v in vals:
                k = _key(v)
                e = self.entries.get(k) if k is not None else None
                if e is not None:
                    e.pins += 1
                    e.seq = next(self._clock)
                    keys.append(k)
        return keys

    def unpin(self, keys) -> None:
        with self._lock:
            for k in keys:
                e = self.entries.get(k)
                if e is not None and e.pins > 0:
                    e.pins -= 1

    # -- spill / restore ------------------------------------------------------

    @staticmethod
    def _live_consts(e: _Entry) -> list:
        return [c for c in (r() for r in e.consts) if c is not None]

    def _rekey(self, e: _Entry, consts: list, value) -> None:
        del self.entries[e.key]
        e.key = _key(value)
        e.consts = [weakref.ref(c) for c in consts]
        self.entries[e.key] = e

    def _spill_entry(self, e: _Entry) -> int:
        """Spill one resident entry to host memory; returns the device
        bytes it frees (0 when it is not a candidate).  The caller holds
        the lock."""
        if e.spilled or e.pins or e.nbytes <= 0:
            return 0
        consts = self._live_consts(e)
        if not consts:
            self._drop(e)
            return 0
        v = consts[0].value
        if not isinstance(v, torch.Tensor) or any(
                c.value is not v for c in consts[1:]) \
                or v.numel() * v.element_size() != e.nbytes:
            return 0
        wrapper = _spill.spill_to_host(v)
        for c in consts:
            c.value = wrapper
        self._account(e, -1)
        e.spilled = True
        self._rekey(e, consts, wrapper)
        self._account(e, +1)
        self.evictions += 1
        _registry.inc("memory.evictions")
        _update_gauges(self)
        _events.emit({
            "type": "memory", "action": "spill", "bytes": e.nbytes,
            "shape": list(wrapper.shape), "dtype": str(wrapper.dtype),
            "live_bytes": self.live_bytes,
            "spilled_bytes": self.spilled_bytes,
        })
        return e.nbytes

    def restore(self, const):
        """Bring a spilled Const back to its device (every Const sharing
        the spilled value follows) and return the tensor."""
        with self._lock:
            wrapper = const.value
            if not isinstance(wrapper, _spill.SpilledArray):
                return wrapper
            e = self.entries.get(_key(wrapper))
            t = _spill.restore_to_device(wrapper)
            consts = self._live_consts(e) if e is not None else []
            if not any(c is const for c in consts):
                consts.append(const)
            for c in consts:
                c.value = t
            if e is not None:
                self._account(e, -1)
                e.spilled = False
                e.seq = next(self._clock)
                e.nbytes = _nbytes(t)
                self._rekey(e, consts, t)
                self._account(e, +1)
            self.restores += 1
        _registry.inc("memory.restores")
        _update_gauges(self)
        _events.emit({
            "type": "memory", "action": "restore", "bytes": _nbytes(t),
            "live_bytes": self.live_bytes,
            "spilled_bytes": self.spilled_bytes,
        })
        return t

    def swap_value(self, old, new) -> bool:
        """Replace a tracked value with ``new`` in place: every live Const
        owning ``old`` is repointed and the entry follows the buffer (its
        byte count included).  False when ``old`` is not tracked (nothing
        swapped)."""
        if old is new:
            return True
        with self._lock:
            e = self.entries.get(_key(old))
            if e is None or _key(new) is None:
                return False
            consts = self._live_consts(e)
            for c in consts:
                c.value = new
            self._account(e, -1)
            e.spilled = isinstance(new, _spill.SpilledArray)
            e.nbytes = _nbytes(new)
            e.seq = next(self._clock)
            self._rekey(e, consts, new)
            self._account(e, +1)
        _update_gauges(self)
        return True

    # -- transient placements ---------------------------------------------

    def _begin_transient(self, nbytes: int) -> None:
        with self._lock:
            self.transient_bytes += int(nbytes)
            self._peak()

    def _end_transient(self, nbytes: int) -> None:
        with self._lock:
            self.transient_bytes = max(0, self.transient_bytes - int(nbytes))

    def evict_until(self, need: int, tenant: Optional[str] = None) -> int:
        """Spill the least recently used candidates until ``need`` bytes
        are freed (or none is left); returns the bytes freed."""
        if tenant is not None:
            raise NotImplementedError(TENANTS)
        with self._lock:
            freed = 0
            cands = sorted((e for e in self.entries.values()
                            if not e.spilled and not e.pins),
                           key=lambda e: e.seq)
            for e in cands:
                if freed >= need:
                    break
                freed += self._spill_entry(e)
            return freed

    # -- reporting ----------------------------------------------------------

    def snapshot(self, top: int = 5) -> dict:
        with self._lock:
            rows = []
            pinned = 0
            for e in list(self.entries.values()):
                consts = self._live_consts(e)
                if not consts:
                    self._drop(e)
                    continue
                if e.pins and not e.spilled:
                    pinned += e.nbytes
                v = consts[0].value
                rows.append({
                    "nbytes": e.nbytes,
                    "shape": list(getattr(v, "shape", ())),
                    "dtype": str(getattr(v, "dtype", "?")),
                    "spilled": e.spilled,
                    "pinned": e.pins,
                    "owners": e.owners,
                })
            rows.sort(key=lambda r: r["nbytes"], reverse=True)
            _update_gauges(self)
            return {
                "budget_bytes": budget_bytes(),
                "watermark_bytes": watermark_bytes(),
                "live_bytes": self.live_bytes,
                "spilled_bytes": self.spilled_bytes,
                "pinned_bytes": pinned,
                "transient_bytes": self.transient_bytes,
                "peak_live_bytes": self.peak_live_bytes,
                "evictions": self.evictions,
                "restores": self.restores,
                "arrays": len(rows),
                "top": rows[:top],
            }


def _update_gauges(led: Ledger) -> None:
    _registry.gauge("memory.live_bytes", led.live_bytes)
    _registry.gauge("memory.spilled_bytes", led.spilled_bytes)


#: The process-wide ledger (``ndarray`` and the flush feed it).
ledger = Ledger()


def reset() -> None:
    """Forget all accounting (tests).  Does not restore spilled values."""
    global ledger
    ledger = Ledger()
    _probe.clear()


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------


_est_memo: dict = {}
_EST_MEMO_MAX = 4096


def estimate_program_bytes(program, leaf_vals, donate=(),
                           fingerprint=None) -> int:
    """Peak device footprint estimate for one linearized program: the
    analytic live-set walk of ``analyze.rules.estimate_peak_bytes``,
    memoized per structure and leaf avals (``fingerprint``: the flush's
    ledger fingerprint of both, when the caller has it: no key to build).
    The reference prefers XLA's ``memory_analysis`` and falls back to
    this walk (always under ``RAMBA_HBM_ESTIMATE=analytic``); the port
    has no compiler to ask, so the walk is its one estimate."""
    fp = None
    if fingerprint is not None:
        fp = (fingerprint, tuple(donate))
        cached = _est_memo.get(fp)
        if cached is not None:
            return cached
    from ramba_tpu_torch.analyze import rules as _rules
    from ramba_tpu_torch.core.expr import aval_of

    avals = [aval_of(v) for v in leaf_vals]
    if fp is None and program.key_hash != -1:  # else: an identity static
        fp = (program.key, tuple(donate),
              tuple((tuple(a.shape), str(a.dtype)) for a in avals))
        cached = _est_memo.get(fp)
        if cached is not None:
            return cached
    est = _rules.estimate_peak_bytes(program, avals, donate)
    if fp is not None:
        if len(_est_memo) >= _EST_MEMO_MAX:
            _est_memo.clear()
        _est_memo[fp] = est
    return est


def _resident_overlap(leaf_vals) -> int:
    """Resident bytes among ``leaf_vals`` the ledger already counts: the
    program estimate counts its arguments too, so they must not be
    billed twice."""
    resident = 0
    seen: set = set()
    with ledger._lock:
        if not ledger.entries:
            return 0
        for v in leaf_vals:
            k = _key(v)
            if k is None or k in seen:
                continue
            seen.add(k)
            e = ledger.entries.get(k)
            if e is not None and not e.spilled:
                resident += e.nbytes
    return resident


def _largest_result(program, leaf_vals) -> int:
    """Bytes of the program's largest instruction result (0 where none
    can be sized)."""
    from ramba_tpu_torch.analyze import rules as _rules
    from ramba_tpu_torch.core.expr import aval_of

    sizes = _rules.slot_nbytes(program, [aval_of(v) for v in leaf_vals])
    return max((b for s, b in sizes.items() if s >= program.n_leaves),
               default=0)


def _admit_budget(program, leaf_vals, donate_key,
                  span: Optional[dict] = None, fingerprint=None) -> bool:
    """The global-budget leg of :func:`admit`: True routes the flush to
    the chunked rung.  No-op (False) when no budget is known.  The
    ``admit`` event is built only when a trace is on (admission runs on
    every flush on the card).

    Unlike the reference, a flush over the watermark is not routed when
    one result alone is larger than the chunked rung's bytes a segment
    (``chunk_target_bytes``): that rung would then run one instruction a
    segment, keeping the live set the fused rung's generic lowering
    keeps, so it could not avert the out-of-memory error predicted and
    would only add latency.  Such a flush starts at the fused rung
    (``span["admission"] = "over"``, counted ``memory.admission_over``),
    where a real out-of-memory error still evicts and drops a rung."""
    budget = budget_bytes()
    if budget is None:
        return False
    wm = watermark_bytes(budget) or budget
    try:
        est = estimate_program_bytes(program, leaf_vals, donate_key,
                                     fingerprint)
    except Exception:  # an estimate that cannot be made admits
        return False
    live = ledger.live_bytes
    # this flush's resident leaves count once: in the estimate
    projected = live + est if live + est <= wm else \
        max(0, live - _resident_overlap(leaf_vals)) + est
    if span is not None:
        span["mem_live_bytes"] = live
        span["mem_peak_est"] = est
    if _events.trace_enabled():
        _update_gauges(ledger)
        _events.emit({
            "type": "memory", "action": "admit", "est_bytes": est,
            "live_bytes": live, "projected_bytes": projected,
            "watermark_bytes": wm, "budget_bytes": budget,
            "ok": projected <= wm,
        })
    if projected <= wm:
        return False
    _events.emit({
        "type": "memory", "action": "watermark",
        "over_bytes": projected - wm, "watermark_bytes": wm,
    })
    freed = ledger.evict_until(projected - wm)
    if projected - freed <= wm:
        if span is not None:
            span["admission"] = "evicted"
        return False
    try:
        largest = _largest_result(program, leaf_vals)
    except Exception:
        largest = 0
    route = largest <= chunk_target_bytes(agree=False)
    _registry.inc("memory.admission_rejects" if route
                  else "memory.admission_over")
    _registry.gauge("memory.admission_rejects.last_over_bytes",
                    projected - freed - wm)
    _events.emit({
        "type": "memory", "action": "reject",
        "route": "chunked" if route else "fused",
        "est_bytes": est, "freed_bytes": freed,
        "over_bytes": projected - freed - wm, "largest_bytes": largest,
    })
    if span is not None:
        span["admission"] = "chunked" if route else "over"
    return route


def admit(program, leaf_vals, donate_key, span: Optional[dict] = None, *,
          tenant: Optional[str] = None, quota: Optional[int] = None,
          coherent: bool = True, fingerprint=None) -> bool:
    """Pre-flush admission check: True when the flush should start the
    ladder at the ``chunked`` rung (it does not fit under the watermark
    even after eviction, and the chunked rung can cut it: see
    :func:`_admit_budget`), False admits the fused rung.  A no-op (False)
    when no budget is known.  Across ranks with a budget, every rank
    takes the verdict of a ``memory:admit`` round (chunked anywhere is
    chunked everywhere); ``coherent=False`` leaves the round to the
    caller.  ``fingerprint``: the flush's, keying the estimate's memo.
    A tenant's ``quota`` is ROADMAP A.10's."""
    if tenant is not None and quota:
        raise NotImplementedError(TENANTS)
    route = _admit_budget(program, leaf_vals, donate_key, span, fingerprint)
    if coherent and _coherence.engaged() and budget_bytes() is not None:
        agreed = bool(_coherence.agree("memory:admit", 1 if route else 0,
                                       reduce="max"))
        if agreed and not route and span is not None:
            span["admission"] = "coherent"
        route = agreed
    return route


# ---------------------------------------------------------------------------
# oom recovery and governed placement
# ---------------------------------------------------------------------------

_OOM_BYTES_RE = re.compile(r"(\d{4,})\s*bytes|[Aa]llocating\s+(\d+)|"
                           r"allocate\s+([\d.]+)\s*([GMK]i?B)")
_UNITS = {"G": 1 << 30, "M": 1 << 20, "K": 1 << 10}


def _oom_need(exc: BaseException) -> Optional[int]:
    need = getattr(exc, "bytes", None)
    if need:
        return int(need)
    m = _OOM_BYTES_RE.search(str(exc))
    if not m:
        return None
    if m.group(3):  # torch: "Tried to allocate 2.00 GiB"
        return int(float(m.group(3)) * _UNITS[m.group(4)[0]])
    return int(m.group(1) or m.group(2))


def evict_for_oom(exc: BaseException, coherent: bool = True) -> int:
    """Free at least what an out-of-memory error asked for (an injected
    fault's ``.bytes``, or the size torch's message names), or everything
    unpinned when the size is unknown; returns the bytes freed.  Across
    ranks every rank frees what the worst-off rank asked for
    (``coherent=False``: this rank's own need, no round)."""
    need = _oom_need(exc) or ledger.live_bytes or 1
    if coherent and _coherence.engaged():
        need = max(1, _coherence.agree(
            "memory:oom_evict", (int(need) + 0xFFFF) >> 16,
            reduce="max") << 16)
    freed = ledger.evict_until(int(need))
    _events.emit({
        "type": "memory", "action": "oom_evict", "need_bytes": int(need),
        "freed_bytes": freed, "live_bytes": ledger.live_bytes,
    })
    return freed


def reserve_headroom(nbytes: int, *, site: str = "transient") -> int:
    """Make room for a placement of ``nbytes``: when a budget is known and
    ``live + transient + nbytes`` crosses the watermark, spill LRU victims
    until it fits (or none is left).  Returns the bytes freed (0 with no
    budget, or when it fits)."""
    if nbytes <= 0:
        return 0
    budget = budget_bytes()
    if budget is None:
        return 0
    wm = watermark_bytes(budget) or budget
    with ledger._lock:
        projected = ledger.live_bytes + ledger.transient_bytes + int(nbytes)
    if projected <= wm:
        return 0
    _events.emit({
        "type": "memory", "action": "watermark", "site": site,
        "over_bytes": projected - wm, "watermark_bytes": wm,
    })
    return ledger.evict_until(projected - wm)


def governed_device_put(value, device=None, *, site: str = "device_put"):
    """Place ``value`` (a host array or a tensor) on ``device`` (default:
    the process device) through the governor: room is reserved first
    (:func:`reserve_headroom`), and the placed bytes count as transient
    (``ledger.transient_bytes``, ``peak_live_bytes``) until the returned
    tensor is collected."""
    from ramba_tpu_torch.core.expr import tensor_from_numpy

    dev = torch.device(device) if device is not None else _common.device()
    if isinstance(value, torch.Tensor):
        nbytes = value.numel() * value.element_size()
    else:
        nbytes = int(getattr(value, "nbytes", 0))
    reserve_headroom(nbytes, site=site)
    if isinstance(value, torch.Tensor):
        out = value.to(dev, copy=True)
    else:
        import numpy as np

        out = tensor_from_numpy(np.asarray(value), dev)
    placed = out.numel() * out.element_size()
    if placed > 0:
        ledger._begin_transient(placed)
        weakref.finalize(out, ledger._end_transient, placed)
        _registry.inc("memory.governed_puts")
        _events.emit({
            "type": "memory", "action": "governed_put", "site": site,
            "bytes": placed, "live_bytes": ledger.live_bytes,
            "transient_bytes": ledger.transient_bytes,
        })
    return out


# ---------------------------------------------------------------------------
# module-level hooks (``ndarray`` and the flush)
# ---------------------------------------------------------------------------


def on_incref(const) -> None:
    ledger.on_incref(const)


def on_decref(value) -> None:
    ledger.on_decref(value)


def restore(const):
    return ledger.restore(const)
