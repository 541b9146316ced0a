"""Per-kernel cost ledger and slow-flush sentinel.

Counterpart of ``ramba_tpu/observe/ledger.py``.  The flush span stream
(``observe/events.py``) records *that* a flush happened; this module
files cost under the unit users pay for, the compiled program, and
guards each program's flush walls against its own history:

* **Ledger.**  Every compile-cache interaction and every execution in
  ``core/fuser.py`` lands in one entry per program, keyed by a stable
  fingerprint of the fuser's ``_cache_key`` (structure, leaf signature,
  compile class).  Entries carry compiles and their seconds, split by
  where the seconds went (``nvcc``: a kernel source was built;
  ``persist``: a library was loaded from the cache directory; ``memory``:
  a plan over a library already loaded, or the generic lowering's first
  call), rolling execution stats (count/total/min/max/p50/p95 over the
  last ``RAMBA_PERF_WINDOW`` samples), bytes in/out, cache
  hit/miss/evict counts, per-rung counts and a per-backend slice
  (``kernel`` / ``torch``) the autotuner races on.
* **Timing regimes.**  Samples are dispatch walls by default (a CUDA
  launch returns before the card finishes).  ``RAMBA_PERF=sync`` adds a
  second window of device times, taken with CUDA events around the call
  on the card (a wall on the CPU).
* **Cost.**  :func:`capture_cost` records, once per program, its bytes
  and flops as each kernel family counts them from its own plan
  (``ops/kernel_backend.program_cost``: elemred's chain ops per element,
  the stencil kernel's body ops per cell, segred's and the scan's adds;
  each input read once, each output written once); a program on the
  generic lowering records the bytes its operands and results occupy,
  and no flops.  It is recorded under ``RAMBA_PERF`` and whenever the
  attribution plane's fence is on (the rooflines read it,
  ``observe/attrib.py``).
* **Slow-flush sentinel.**  Each flush's wall feeds a rolling window per
  program label; once a label has ``RAMBA_SLOW_FLUSH_MIN_SAMPLES``
  samples, a flush slower than ``RAMBA_SLOW_FLUSH_FACTOR`` x the rolling
  p50 emits one ``slow_flush`` event.  ``delay:ms=<n>`` on the fuser's
  ``execute`` fault site triggers it deterministically.

Environment: ``RAMBA_PERF`` (unset/0: ledger on, cost with the fence;
``1``/``on``: + cost; ``sync``: + device-time samples), ``RAMBA_SLOW_FLUSH_FACTOR``
(default 4.0; <= 0 disables the sentinel),
``RAMBA_SLOW_FLUSH_MIN_SAMPLES`` (default 5), ``RAMBA_PERF_WINDOW``
(default 64).
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import threading
import time as _time
from collections import deque
from typing import Optional

from ramba_tpu_torch.observe import events as _events
from ramba_tpu_torch.observe import observer as _observer
from ramba_tpu_torch.observe import registry as _registry

_lock = threading.RLock()

#: where a compile's seconds went (see the module docstring)
ORIGINS = ("nvcc", "persist", "memory")


# ---------------------------------------------------------------------------
# configuration (re-readable for tests via reconfigure())
# ---------------------------------------------------------------------------


def _parse_mode(v: Optional[str]) -> str:
    if not v or v in ("0", "off", "false", "no"):
        return ""
    if v.strip().lower() == "sync":
        return "sync"
    return "on"


_mode = ""
_slow_factor = 4.0
_min_samples = 5
_window = 64


def reconfigure(*, mode: Optional[str] = None,
                factor: Optional[float] = None,
                min_samples: Optional[int] = None,
                window: Optional[int] = None) -> None:
    """Reload configuration from the environment, with keyword overrides
    (tests).  Existing rolling windows keep their length."""
    global _mode, _slow_factor, _min_samples, _window
    _mode = _parse_mode(os.environ.get("RAMBA_PERF")) if mode is None \
        else _parse_mode(mode)
    try:
        _slow_factor = float(
            os.environ.get("RAMBA_SLOW_FLUSH_FACTOR", "4.0") or 4.0
        ) if factor is None else float(factor)
    except ValueError:
        _slow_factor = 4.0
    try:
        _min_samples = int(
            os.environ.get("RAMBA_SLOW_FLUSH_MIN_SAMPLES", "5") or 5
        ) if min_samples is None else int(min_samples)
    except ValueError:
        _min_samples = 5
    try:
        _window = max(4, int(
            os.environ.get("RAMBA_PERF_WINDOW", "64") or 64
        ) if window is None else int(window))
    except ValueError:
        _window = 64


def mode() -> str:
    return _mode


def sync_timing() -> bool:
    return _mode == "sync"


def cost_enabled() -> bool:
    return _mode in ("on", "sync")


# ---------------------------------------------------------------------------
# rolling statistics
# ---------------------------------------------------------------------------


class _Rolling:
    """Count/total/min/max over the whole history, quantiles over a
    bounded window of the newest samples."""

    __slots__ = ("count", "total", "min", "max", "window")

    def __init__(self, window: Optional[int] = None):
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.window: "deque[float]" = deque(maxlen=window or _window)

    def add(self, s: float) -> None:
        self.count += 1
        self.total += s
        if self.min is None or s < self.min:
            self.min = s
        if self.max is None or s > self.max:
            self.max = s
        self.window.append(s)

    def quantile(self, q: float) -> Optional[float]:
        """Nearest-rank quantile over the window (None when empty)."""
        if not self.window:
            return None
        srt = sorted(self.window)
        idx = max(0, min(len(srt) - 1,
                         int(-(-q * len(srt) // 1)) - 1))  # ceil - 1
        return srt[idx]

    def summary(self) -> dict:
        out = {
            "count": self.count,
            "total_s": round(self.total, 6),
            "min_s": round(self.min, 6) if self.min is not None else None,
            "max_s": round(self.max, 6) if self.max is not None else None,
        }
        p50, p95 = self.quantile(0.50), self.quantile(0.95)
        out["p50_s"] = round(p50, 6) if p50 is not None else None
        out["p95_s"] = round(p95, 6) if p95 is not None else None
        return out


# ---------------------------------------------------------------------------
# stable kernel fingerprints
# ---------------------------------------------------------------------------


def _token(x) -> str:
    """Canonical serialization of one cache-key element, stable across
    processes: plain values by repr, anything that could embed a memory
    address (closures in statics, tensors) by its type and qualname."""
    if x is None or isinstance(x, (bool, int, float, str, bytes)):
        return repr(x)
    if isinstance(x, (tuple, list)):
        return "(" + ",".join(_token(i) for i in x) + ")"
    if isinstance(x, dict):
        items = sorted(x.items(), key=lambda kv: repr(kv[0]))
        return "{" + ",".join(_token(k) + ":" + _token(v)
                              for k, v in items) + "}"
    name = getattr(x, "__qualname__", None) or getattr(x, "__name__", None)
    if name:
        return f"<{type(x).__name__}:{name}>"
    return f"<{type(x).__module__}.{type(x).__name__}>"


_fp_memo: dict = {}
_FP_MEMO_MAX = 4096


def fingerprint(cache_key) -> str:
    """12-hex stable fingerprint of a fuser ``_cache_key`` tuple, memoized
    on the key itself (one dict lookup per flush)."""
    try:
        fp = _fp_memo.get(cache_key)
    except TypeError:  # an unhashable element: serialize every time
        return hashlib.sha256(_token(cache_key).encode()).hexdigest()[:12]
    if fp is None:
        fp = hashlib.sha256(_token(cache_key).encode()).hexdigest()[:12]
        with _lock:
            if len(_fp_memo) >= _FP_MEMO_MAX:
                _fp_memo.clear()
            _fp_memo[cache_key] = fp
    return fp


# ---------------------------------------------------------------------------
# the ledger proper
# ---------------------------------------------------------------------------


class BackendStats:
    """One lowering's slice of a kernel entry (``kernel`` or ``torch``):
    the autotuner's evidence."""

    __slots__ = ("exec", "compiles", "compile_s", "flops",
                 "bytes_accessed", "_cost_tried")

    def __init__(self):
        self.exec = _Rolling()
        self.compiles = 0
        self.compile_s = 0.0
        self.flops: Optional[float] = None
        self.bytes_accessed: Optional[float] = None
        self._cost_tried = False

    def summary(self) -> dict:
        out = {
            "compiles": self.compiles,
            "compile_s": round(self.compile_s, 6),
            "exec": self.exec.summary(),
        }
        if self.flops is not None:
            out["flops"] = self.flops
        if self.bytes_accessed is not None:
            out["bytes_accessed"] = self.bytes_accessed
        return out


class KernelEntry:
    """All accumulated cost knowledge about one compiled program."""

    __slots__ = (
        "label", "instrs", "compiles", "compile_s", "by_origin",
        "compile_class", "pad_waste",
        "exec", "sync", "bytes_in", "bytes_out",
        "hits", "misses", "evicts", "memo_hits", "rungs",
        "flops", "bytes_accessed", "_cost_tried", "backends", "tenants",
        "warm_compiles", "warm_compile_s",
    )

    def __init__(self, label: str = "?", instrs: int = 0):
        self.label = label
        self.instrs = instrs
        self.compiles = 0
        self.compile_s = 0.0
        # origin -> seconds of compiles (ORIGINS)
        self.by_origin: dict = {}
        self.compile_class = None
        self.pad_waste = 0
        self.exec = _Rolling()
        self.sync: Optional[_Rolling] = None
        self.bytes_in = 0
        self.bytes_out = 0
        self.hits = 0
        self.misses = 0
        self.evicts = 0
        self.memo_hits = 0
        self.rungs: dict = {}
        self.flops: Optional[float] = None
        self.bytes_accessed: Optional[float] = None
        self._cost_tried = False
        self.backends: dict = {}
        # tenant -> executions (serving attribution; empty outside it)
        self.tenants: dict = {}
        # compiles paid inside compile_source("warm") (serve pipeline's
        # warm tickets)
        self.warm_compiles = 0
        self.warm_compile_s = 0.0

    def backend(self, name: str) -> BackendStats:
        b = self.backends.get(name)
        if b is None:
            b = self.backends[name] = BackendStats()
        return b

    def summary(self) -> dict:
        out = {
            "label": self.label,
            "instrs": self.instrs,
            "compiles": self.compiles,
            "compile_s": round(self.compile_s, 6),
            "exec": self.exec.summary(),
            "bytes_in": self.bytes_in,
            "bytes_out": self.bytes_out,
            "cache": {"hits": self.hits, "misses": self.misses,
                      "evicts": self.evicts},
            "rungs": dict(self.rungs),
        }
        if self.memo_hits:
            out["memo_hits"] = self.memo_hits
        if self.by_origin:
            out["compile_s_by_source"] = {
                k: round(v, 6) for k, v in self.by_origin.items()}
        if self.sync is not None:
            out["sync"] = self.sync.summary()
        if self.flops is not None:
            out["flops"] = self.flops
        if self.bytes_accessed is not None:
            out["bytes_accessed"] = self.bytes_accessed
        if self.compile_class is not None:
            out["compile_class"] = list(self.compile_class)
            out["pad_waste"] = self.pad_waste
        if self.backends:
            out["backends"] = {name: b.summary()
                               for name, b in self.backends.items()}
        if self.tenants:
            out["tenants"] = dict(self.tenants)
        if self.warm_compiles:
            out["warm_compiles"] = self.warm_compiles
            out["warm_compile_s"] = round(self.warm_compile_s, 6)
        return out


_kernels: "dict[str, KernelEntry]" = {}
# flush-program label -> rolling wall window (sentinel state)
_flush_walls: "dict[str, _Rolling]" = {}
# (label, rung) -> rolling wall window: the deadline-aware ladder
# (serve/overload.prune_rungs) reads each rung's own p50
_rung_walls: "dict[tuple, _Rolling]" = {}
_slow_flushes = 0

# Where compiles come from (thread-local): the serve pipeline runs a warm
# ticket's thunk in compile_source("warm"), so every compile it triggers
# is filed on the warm side.
_compile_source = threading.local()


@contextlib.contextmanager
def compile_source(source: str):
    """Scope within which compiles are attributed to ``source``
    (``"warm"`` for warm tickets; the default is ``"demand"``)."""
    prev = getattr(_compile_source, "value", None)
    _compile_source.value = source
    try:
        yield
    finally:
        _compile_source.value = prev


def current_compile_source() -> str:
    return getattr(_compile_source, "value", None) or "demand"


def _entry(fp: str, label: Optional[str] = None,
           instrs: int = 0) -> KernelEntry:
    e = _kernels.get(fp)
    if e is None:
        e = KernelEntry(label or "?", instrs)
        _kernels[fp] = e
    elif label is not None and e.label == "?":
        e.label = label
    return e


def _add_origin(e: KernelEntry, origin: Optional[str], seconds: float):
    if origin is not None:
        e.by_origin[origin] = e.by_origin.get(origin, 0.0) + seconds


def _compile_event(fp: str, seconds: float, origin: Optional[str]) -> None:
    if _events.trace_enabled():
        _events.emit({"type": "compile", "fingerprint": fp,
                      "seconds": round(seconds, 6), "origin": origin})


def record_compile(fp: str, seconds: float, label: Optional[str] = None,
                   compile_class=None, origin: Optional[str] = None) -> None:
    """One compile of a program: ``seconds`` of it, ``origin`` (one of
    :data:`ORIGINS`) saying where they went."""
    with _lock:
        e = _entry(fp, label)
        e.compiles += 1
        e.compile_s += seconds
        _add_origin(e, origin, seconds)
        if compile_class is not None:
            e.compile_class = tuple(compile_class)
    _compile_event(fp, seconds, origin)


def record_class(fp: str, compile_class, pad_waste: int,
                 label: Optional[str] = None) -> None:
    """A flush's compile-class decision on its program's entry (token and
    cumulative pad-waste bytes)."""
    with _lock:
        e = _entry(fp, label)
        e.compile_class = tuple(compile_class)
        e.pad_waste += int(pad_waste)


def record_cache(fp: str, kind: str, label: Optional[str] = None) -> None:
    """One compile-cache interaction: ``kind`` in hit|miss|evict."""
    with _lock:
        e = _entry(fp, label)
        if kind == "hit":
            e.hits += 1
        elif kind == "miss":
            e.misses += 1
        elif kind == "evict":
            e.evicts += 1


def record_memo_hit(fp: Optional[str], label: Optional[str] = None) -> None:
    """A flush the result cache served (``core/memo.py``): counted as a
    memo hit, never as an execution or a compile-cache interaction."""
    if fp is None:
        return
    with _lock:
        _entry(fp, label).memo_hits += 1


def record_execute(fp: str, label: str, instrs: int, rung: str,
                   seconds: float, is_new: bool,
                   bytes_in: int = 0, bytes_out: int = 0,
                   sync_seconds: Optional[float] = None,
                   backend: Optional[str] = None,
                   origin: Optional[str] = None,
                   backend_seconds: Optional[float] = None,
                   tenant: Optional[str] = None) -> None:
    """One execution of a program.  A first call (``is_new``) builds or
    plans its kernel and counts as a compile (by ``origin``; a warm one
    inside :func:`compile_source` ``("warm")``), not as an execution
    sample, so it never poisons the steady-state percentiles.
    ``backend`` also files the sample in that lowering's slice: the
    evidence ``core/autotune.py`` races on (``backend_seconds``, a device
    time, in place of ``seconds`` when given).  ``tenant`` (a serving
    session's) counts the execution on the entry's per-tenant split."""
    t_obs = _time.perf_counter()
    with _lock:
        e = _entry(fp, label, instrs)
        e.instrs = instrs or e.instrs
        e.bytes_in += int(bytes_in)
        e.bytes_out += int(bytes_out)
        e.rungs[rung] = e.rungs.get(rung, 0) + 1
        if tenant is not None:
            e.tenants[tenant] = e.tenants.get(tenant, 0) + 1
        if is_new:
            e.compiles += 1
            e.compile_s += seconds
            _add_origin(e, origin, seconds)
            if getattr(_compile_source, "value", None) == "warm":
                e.warm_compiles += 1
                e.warm_compile_s += seconds
        else:
            e.exec.add(seconds)
            if sync_seconds is not None:
                if e.sync is None:
                    e.sync = _Rolling()
                e.sync.add(sync_seconds)
        if backend is not None:
            b = e.backend(backend)
            if is_new:
                b.compiles += 1
                b.compile_s += seconds
            else:
                b.exec.add(seconds if backend_seconds is None
                           else backend_seconds)
    _observer.add("ledger", _time.perf_counter() - t_obs)
    if is_new:
        _compile_event(fp, seconds, origin)


def backend_stats(fp: str) -> dict:
    """Autotuner read API: backend name -> count, p50, total and compile
    seconds for one program ({} for an unknown fingerprint)."""
    with _lock:
        e = _kernels.get(fp)
        if e is None:
            return {}
        return {name: {"count": b.exec.count,
                       "p50_s": b.exec.quantile(0.50),
                       "total_s": b.exec.total,
                       "compile_s": b.compile_s}
                for name, b in e.backends.items()}


def capture_cost(fp: str, nbytes: int, backend: Optional[str] = None,
                 flops: Optional[float] = None) -> None:
    """Record, once per program (and once per backend), ``nbytes`` and
    ``flops`` (only where a kernel family counted them; never estimated
    here), when ``RAMBA_PERF`` is on or the attribution plane's fence
    is."""
    from ramba_tpu_torch.observe import attrib as _attrib

    if not (cost_enabled() or _attrib.fence_enabled()):
        return
    with _lock:
        e = _entry(fp)
        b = e.backend(backend) if backend is not None else None
        if b is not None:
            if b._cost_tried and e._cost_tried:
                return
            b._cost_tried = True
        elif e._cost_tried:
            return
        e._cost_tried = True
        if e.bytes_accessed is None:
            e.bytes_accessed = float(nbytes)
        if b is not None:
            b.bytes_accessed = float(nbytes)
        if flops is not None:
            if e.flops is None:
                e.flops = float(flops)
            if b is not None:
                b.flops = float(flops)


def observe_flush(span: dict) -> Optional[dict]:
    """Feed one finished flush span into the sentinel.  Emits (and
    returns) at most one ``slow_flush`` event when this flush's wall
    exceeds ``RAMBA_SLOW_FLUSH_FACTOR`` x its label's rolling p50, taken
    before this sample joins the window."""
    global _slow_flushes
    label = span.get("label", "?")
    wall = float(span.get("wall_s", 0.0) or 0.0)
    t_obs = _time.perf_counter()
    with _lock:
        win = _flush_walls.get(label)
        if win is None:
            win = _flush_walls[label] = _Rolling()
        fire_p50 = None
        if _slow_factor > 0 and win.count >= _min_samples:
            p50 = win.quantile(0.50)
            if p50 and wall > _slow_factor * p50:
                _slow_flushes += 1
                fire_p50 = (p50, win.count)
        win.add(wall)
        rkey = (label, span.get("degraded") or "fused")
        rwin = _rung_walls.get(rkey)
        if rwin is None:
            rwin = _rung_walls[rkey] = _Rolling()
        rwin.add(wall)
    _observer.add("ledger", _time.perf_counter() - t_obs)
    if fire_p50 is None:
        return None
    p50, samples = fire_p50
    _registry.inc("perf.slow_flush")
    ev = {
        "type": "slow_flush",
        "label": label,
        "rung": span.get("degraded", "fused"),
        "wall_s": round(wall, 6),
        "p50_s": round(p50, 6),
        "slowdown": round(wall / p50, 2),
        "factor": _slow_factor,
        "samples": samples,
        "instrs": span.get("instrs"),
        "bytes_in": span.get("leaf_bytes"),
        "bytes_out": span.get("out_bytes"),
        "compile_s": span.get("compile_s"),
        "execute_s": span.get("execute_s"),
        "cache": span.get("cache"),
    }
    if span.get("trace_id") is not None:
        ev["trace_id"] = span["trace_id"]
    # the incident explainer: this flush's waterfall against its
    # fingerprint's per-stage baselines names the divergent stage
    from ramba_tpu_torch.observe import attrib as _attrib

    why = _attrib.explain(span)
    if why is not None:
        ev["why"] = why["text"]
        ev["why_stage"] = why["stage"]
        ev["why_verdict"] = why["verdict"]
    return _events.emit(ev)


def flush_quantile(label: str, q: float) -> Optional[float]:
    """Rolling flush-wall quantile of ``label``, or None below the
    sentinel's sample floor (hedged dispatch reads its p95 here, so a
    hedge waits for real history)."""
    with _lock:
        win = _flush_walls.get(label)
        if win is None or win.count < _min_samples:
            return None
        return win.quantile(q)


def rung_quantile(label: str, rung: str, q: float) -> Optional[float]:
    """Rolling flush-wall quantile of one (label, rung) pair, or None
    below the sample floor: the deadline-aware ladder drops a rung whose
    p50 cannot fit the remaining budget."""
    with _lock:
        win = _rung_walls.get((label, rung))
        if win is None or win.count < _min_samples:
            return None
        return win.quantile(q)


def snapshot() -> dict:
    """JSON-serializable dump of the ledger."""
    with _lock:
        return {
            "mode": _mode or "off",
            "slow_flush_factor": _slow_factor,
            "slow_flush_min_samples": _min_samples,
            "window": _window,
            "slow_flushes": _slow_flushes,
            "kernels": {fp: e.summary() for fp, e in _kernels.items()},
            "flushes": {label: w.summary()
                        for label, w in _flush_walls.items()},
        }


def totals() -> dict:
    """Compiles and their seconds by origin summed over every entry: what
    a process paid to get its programs ready."""
    with _lock:
        out = {"compiles": 0, "compile_s": 0.0,
               "by_source": dict.fromkeys(ORIGINS, 0.0)}
        for e in _kernels.values():
            out["compiles"] += e.compiles
            out["compile_s"] += e.compile_s
            for k, v in e.by_origin.items():
                out["by_source"][k] = out["by_source"].get(k, 0.0) + v
        return out


def kernel_keys() -> list:
    """Sorted kernel fingerprints: ranks in lockstep report equal sets."""
    with _lock:
        return sorted(_kernels)


def reset() -> None:
    """Drop all accumulated state (tests, measurements)."""
    global _slow_flushes
    with _lock:
        _kernels.clear()
        _flush_walls.clear()
        _rung_walls.clear()
        _fp_memo.clear()
        _slow_flushes = 0


reconfigure()
