"""Critical-path attribution: stage waterfalls, rooflines, drift sentinel.

Counterpart of ``ramba_tpu/observe/attrib.py``.  The kernel ledger
(``observe/ledger.py``) answers "how long did program X take"; this
module answers the questions the ledger cannot:

* **Where does a flush's wall-clock go?**  Every flush span carries a
  ``stages`` dict stamped along the critical path of ``core/fuser.py``
  (``trace / prepare / verify / compile / admit / dispatch /
  device_execute / write_back``; a ticket of the serve pipeline adds
  ``queue_wait`` and ``coalesce``, stamped at its dispatch), and
  :func:`finalize_span` folds the residual into ``unattributed_s``, so
  the stages plus the residual equal ``wall_s``.

  The fence is the CUDA event pair the fuser already puts around a call
  (``fuser._execute_compiled``), one pair per call: ``device_execute``
  is the host's wait in ``end.synchronize()``, and the device window
  that feeds the rooflines and the drift sentinel is
  ``start.elapsed_time(end)``, the card's own time.  (The reference's
  window runs from the host's call entry through its
  ``block_until_ready``; here a host-side delay before the launch does
  not read as a device regression.)  On the CPU the window is the host
  wall from call entry through the call.  A CUDA error at the fence is
  raised, never swallowed.  ``RAMBA_ATTRIB=off`` disables the fence
  (stages other than ``device_execute`` are still stamped).

  ``RAMBA_ATTRIB=sample:<N>`` fences 1 call in N **per kernel
  fingerprint**: the decision is the fingerprint's own call counter
  modulo N (pure arithmetic, no collective), so ranks replaying the same
  program order fence the same sequence numbers in lockstep.  Unfenced
  calls carry ``device_source: "estimated"`` with a ``device_est_s``
  from the fingerprint's rolling fenced p50 (never stamped into
  ``stages``); rooflines and the sentinel read fenced samples only.

* **Why was THIS flush slow?**  :func:`finalize_span` keeps
  per-fingerprint per-stage rolling baselines; when an incident fires
  (``slow_flush``, ``perf_regression``, ``slo_breach``) :func:`explain`
  diffs the span's waterfall against them and names the dominant
  divergent stage ("compile 12.0x baseline -> cache miss").

* **How close does a kernel run to the card's peak?**  The ledger's cost
  record (bytes, and flops where a kernel family counts them) with the
  fenced device windows and a peak table per device kind (built in: the
  H100 and a CPU default; override with ``RAMBA_PEAKS_JSON``, inline
  JSON or a file path) gives an achieved fraction of peak and a
  bandwidth-vs-compute classification per fingerprint and backend.

A **perf-regression sentinel** rides on the device windows:
per-fingerprint baselines persist to
``RAMBA_BASELINE_DIR/perf_baseline.json`` (atomic tmp+rename, saved at
exit); when a fingerprint's rolling p50 drifts beyond
``RAMBA_PERF_DRIFT_FACTOR`` (default 2.0) x its baseline after
``RAMBA_PERF_DRIFT_MIN_SAMPLES`` (default 5) samples, it emits ONE
``perf_regression`` event (a flight-recorder trigger) and stays quiet
for that fingerprint until :func:`reset`.  Baselines only ratchet down.

Lock-guarded dict math on the host: no torch import at module scope.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
from typing import Optional

from ramba_tpu_torch.observe import events as _events
from ramba_tpu_torch.observe import ledger as _ledger
from ramba_tpu_torch.observe import registry as _registry

# Canonical stage order: a span's stages, iterated in this order, read as
# the flush's waterfall.  Keep in sync with the glossary in docs/index.md.
STAGES = (
    "trace",           # caller thread: rewrite + linearize + leaf gather
                       # (graph capture: unavoidable per flush)
    "prepare",         # caller thread: the analysis pipeline — class
                       # proof, fingerprint, memo certification, plan
                       # cache (skippable via a plan certificate)
    "verify",          # RAMBA_VERIFY eager shadow evaluation
    "queue_wait",      # serve pipeline: submit -> group pop
    "coalesce",        # serve pipeline: group pop -> this ticket's dispatch
    "compile",         # cache-miss call: kernel build or plan, or the
                       # generic lowering's first run
    "admit",           # memory-ledger admission sizing
    "dispatch",        # steady-state call: host launch until the end event
                       # is recorded, plus the ladder's host residual
    "device_execute",  # the end event's synchronize: the host's wait on
                       # the card
    "write_back",      # ladder return -> audit, memo insert, span finalized
)

_lock = threading.Lock()

# config (reread by reconfigure())
_enabled = True
_sample_n = 1  # fence 1-in-N calls per fingerprint (1 = always)
_drift_factor = 2.0
_drift_min_samples = 5
_baseline_dir: Optional[str] = None
_peaks_override: Optional[dict] = None

# state
_stage_totals: "dict[str, float]" = {}
_unattributed_total = 0.0
_flushes = 0
# fp -> {"label", "win": _Rolling, "backends": {name: _Rolling}}
_device: "dict[str, dict]" = {}
# sampled-fence bookkeeping: fp -> next flush-sequence number, and the
# (bounded) list of sequence numbers that were fenced — the lockstep
# proof two_process_suite --sampling-leg compares across ranks
_flush_seq: "dict[str, int]" = {}
_fence_log: "dict[str, list]" = {}
_FENCE_LOG_MAX = 64
# incident-explainer baselines: fp -> {stage|"unattributed": _Rolling}
_stage_base: "dict[str, dict]" = {}
_baselines: "dict[str, dict]" = {}
_baselines_loaded = False
_regressed: "set[str]" = set()
_regressions = 0
_atexit_armed = False

# Peak table per device-kind substring, matched case-insensitively
# against ``torch.cuda.get_device_name`` of the process device; "default"
# is the CPU.  One card row: the NVIDIA H100 SXM data sheet's HBM3
# bandwidth and its FP32 rate outside the tensor cores at 700 W (the
# figures of PERF.md section 3).  Override with RAMBA_PEAKS_JSON.
_BUILTIN_PEAKS = {
    "h100": {"peak_gbps": 3350.0, "peak_tflops": 67.0},
    "default": {"peak_gbps": 50.0, "peak_tflops": 1.0},
}


def reconfigure(*, enabled: Optional[bool] = None,
                sample_every: Optional[int] = None,
                drift_factor: Optional[float] = None,
                drift_min_samples: Optional[int] = None,
                baseline_dir: Optional[str] = None) -> None:
    """(Re)read env config; kwargs override env (tests)."""
    global _enabled, _sample_n, _drift_factor, _drift_min_samples
    global _baseline_dir, _peaks_override, _baselines_loaded
    raw = os.environ.get("RAMBA_ATTRIB", "1").strip().lower()
    if enabled is None:
        _enabled = raw not in ("0", "off", "false", "no")
    else:
        _enabled = bool(enabled)
    if sample_every is None:
        _sample_n = 1
        if raw.startswith("sample:"):
            try:
                _sample_n = max(1, int(raw.split(":", 1)[1]))
            except ValueError:
                _sample_n = 1
    else:
        _sample_n = max(1, int(sample_every))
    if drift_factor is None:
        try:
            _drift_factor = float(
                os.environ.get("RAMBA_PERF_DRIFT_FACTOR", "2.0"))
        except ValueError:
            _drift_factor = 2.0
    else:
        _drift_factor = float(drift_factor)
    if drift_min_samples is None:
        try:
            _drift_min_samples = int(
                os.environ.get("RAMBA_PERF_DRIFT_MIN_SAMPLES", "5"))
        except ValueError:
            _drift_min_samples = 5
    else:
        _drift_min_samples = int(drift_min_samples)
    new_dir = (baseline_dir if baseline_dir is not None
               else os.environ.get("RAMBA_BASELINE_DIR") or None)
    if new_dir != _baseline_dir:
        _baseline_dir = new_dir or None
        _baselines_loaded = False  # lazy re-load from the new dir
    _peaks_override = _load_peaks_override()


def _load_peaks_override() -> Optional[dict]:
    raw = os.environ.get("RAMBA_PEAKS_JSON")
    if not raw:
        return None
    try:
        text = raw
        if not raw.lstrip().startswith("{"):
            with open(raw) as f:
                text = f.read()
        obj = json.loads(text)
        return obj if isinstance(obj, dict) else None
    except (OSError, ValueError):
        return None


def fence_enabled() -> bool:
    """Is the device fence (a CUDA end event's synchronize) armed at
    all?  True under
    both always-on and ``sample:<N>`` — the per-call verdict is
    :func:`fence_decision`."""
    return _enabled


def sample_every() -> int:
    """The configured 1-in-N fence sampling period (1 = every call)."""
    return _sample_n


def sampling() -> bool:
    """Is sampled attribution (``RAMBA_ATTRIB=sample:<N>``) active?"""
    return _enabled and _sample_n > 1


def fence_decision(fp: Optional[str], span: Optional[dict] = None) -> bool:
    """Should THIS compiled call fence?  Always True outside sampling
    mode.  Under ``sample:<N>`` the verdict is ``seq % N == 0`` where
    ``seq`` is the fingerprint's own monotone call counter — a pure
    function of program order, so SPMD ranks that replay the same flush
    sequence fence the same calls without any cross-rank agreement (and
    a rank-skewed timing fault cannot desync them).  Stamps the span's
    ``device_source`` ("fenced"/"estimated"); a segmented flush with
    any fenced segment reads as fenced."""
    if not _enabled:
        return False
    if _sample_n <= 1:
        return True
    key = fp or ""
    with _lock:
        seq = _flush_seq.get(key, 0)
        _flush_seq[key] = seq + 1
        fenced = (seq % _sample_n == 0)
        if fenced:
            log = _fence_log.setdefault(key, [])
            if len(log) < _FENCE_LOG_MAX:
                log.append(seq)
    if span is not None:
        span["fence_seq"] = seq
        if fenced:
            span["device_source"] = "fenced"
        else:
            span.setdefault("device_source", "estimated")
    return fenced


def estimated_device_s(fp: Optional[str]) -> Optional[float]:
    """Rolling p50 of this fingerprint's *fenced* device windows — the
    stand-in device time an unfenced flush carries (``device_est_s``).
    None until at least one fenced sample exists."""
    if not fp:
        return None
    with _lock:
        ent = _device.get(fp)
        if ent is None:
            return None
        return ent["win"].quantile(0.50)


def sampling_report() -> dict:
    """Per-fingerprint fence decisions under sampling: call counts and
    the fenced sequence numbers (lockstep proof for the SPMD suite)."""
    with _lock:
        return {
            "enabled": _enabled,
            "sample_every": _sample_n,
            "fingerprints": {
                fp: {"calls": _flush_seq.get(fp, 0),
                     "fenced_seqs": list(_fence_log.get(fp, []))}
                for fp in sorted(_flush_seq)
            },
        }


def flush_wall_total() -> float:
    """Total attributed flush wall (stages + residual) — the observer
    tax's denominator (observe/observer.py)."""
    with _lock:
        return sum(_stage_totals.values()) + _unattributed_total


# ---------------------------------------------------------------------------
# stage ledger
# ---------------------------------------------------------------------------


def add_stage(span: Optional[dict], stage: str, seconds: float) -> None:
    """Accumulate ``seconds`` into ``span['stages'][stage]``."""
    if span is None or seconds < 0:
        return
    st = span.setdefault("stages", {})
    st[stage] = st.get(stage, 0.0) + seconds


def finalize_span(span: dict, fp: Optional[str] = None) -> None:
    """Round the span's stage ledger, fold the residual into
    ``unattributed_s``, and roll both into the global/per-fp totals
    (including the incident explainer's per-stage baselines).
    Called once per flush just before the span event is emitted."""
    st = span.get("stages")
    if st is None:
        return
    wall = float(span.get("wall_s") or 0.0)
    total = 0.0
    for k in list(st):
        v = float(st[k])
        total += v
        st[k] = round(v, 6)
    un = max(0.0, wall - total)
    span["unattributed_s"] = round(un, 6)
    global _unattributed_total, _flushes
    with _lock:
        _flushes += 1
        _unattributed_total += un
        for k, v in st.items():
            _stage_totals[k] = _stage_totals.get(k, 0.0) + v
        if fp:
            base = _stage_base.get(fp)
            if base is None:
                base = _stage_base[fp] = {}
            for k, v in st.items():
                win = base.get(k)
                if win is None:
                    win = base[k] = _ledger._Rolling()
                win.add(v)
            uwin = base.get("unattributed")
            if uwin is None:
                uwin = base["unattributed"] = _ledger._Rolling()
            uwin.add(un)


def _ordered(stages: dict) -> dict:
    out = {k: stages[k] for k in STAGES if k in stages}
    for k in stages:  # future stages survive the reorder
        out.setdefault(k, stages[k])
    return out


# ---------------------------------------------------------------------------
# incident explainer
# ---------------------------------------------------------------------------

# dominant divergent stage -> operator-facing verdict
_EXPLAIN_VERDICTS = {
    "queue_wait": "overload",
    "coalesce": "overload",
    "compile": "cache miss",
    "admit": "memory pressure",
    "device_execute": "device regression",
    "dispatch": "host dispatch slowdown",
    "write_back": "host dispatch slowdown",
    "trace": "host analysis slowdown",
    "prepare": "host analysis slowdown",
    "verify": "host analysis slowdown",
    "unattributed": "untracked interference (GC / lock convoy?)",
}
_EXPLAIN_MIN_SAMPLES = 3   # baseline window floor before a ratio is trusted
_EXPLAIN_FACTOR = 1.5      # a stage must exceed 1.5x its p50 to diverge
_EXPLAIN_NOVEL_FRAC = 0.25  # baseline-less stage must eat >=25% of wall


def explain(span: dict, fp: Optional[str] = None) -> Optional[dict]:
    """Diff one span's stage waterfall against its fingerprint's rolling
    per-stage baselines and name the dominant divergent stage.

    Returns ``{"stage", "verdict", "text", "ratio", "stage_s",
    "baseline_p50_s"}`` or None when nothing diverges (or no baseline
    history exists yet).  Dominance is by absolute excess over the
    baseline p50 — the stage that actually ate the wall, not the one
    with the flashiest ratio on a microsecond base.  A stage with no
    baseline at all (e.g. ``compile`` appearing on a steady-state
    fingerprint) is divergent by existence when it claims a meaningful
    share of the wall — that IS the cache-miss signature."""
    if fp is None:
        fp = span.get("fingerprint")
    st = dict(span.get("stages") or {})
    un = span.get("unattributed_s")
    if isinstance(un, (int, float)) and un > 0:
        st["unattributed"] = float(un)
    if not fp or not st:
        return None
    wall = float(span.get("wall_s") or 0.0)
    best = None  # (excess, stage, baseline_p50, value)
    with _lock:
        base = _stage_base.get(fp)
        if not base:
            return None
        for k, v in st.items():
            if not isinstance(v, (int, float)) or v <= 0:
                continue
            win = base.get(k)
            p50 = (win.quantile(0.50)
                   if win is not None and win.count >= _EXPLAIN_MIN_SAMPLES
                   else None)
            if p50 is None or p50 <= 0:
                if wall > 0 and v >= _EXPLAIN_NOVEL_FRAC * wall:
                    cand = (float(v), k, None, float(v))
                else:
                    continue
            else:
                if v <= p50 * _EXPLAIN_FACTOR:
                    continue
                cand = (float(v) - p50, k, p50, float(v))
            if best is None or cand[0] > best[0]:
                best = cand
    if best is None:
        return None
    _excess, stage, p50, value = best
    verdict = _EXPLAIN_VERDICTS.get(stage, "stage regression")
    if p50:
        ratio = value / p50
        text = f"{stage} {ratio:.1f}x baseline -> {verdict}"
    else:
        ratio = None
        text = f"{stage} -> {verdict}"
    return {
        "stage": stage,
        "verdict": verdict,
        "text": text,
        "ratio": round(ratio, 2) if ratio is not None else None,
        "stage_s": round(value, 6),
        "baseline_p50_s": round(p50, 6) if p50 else None,
    }


# ---------------------------------------------------------------------------
# fenced device-time windows + regression sentinel
# ---------------------------------------------------------------------------


def record_device(fp: str, label: str, seconds: float,
                  backend: Optional[str] = None) -> None:
    """Feed one fenced steady-state device window for kernel ``fp``
    (on the card ``start.elapsed_time(end)`` of the call's CUDA events;
    on the CPU the host wall from call entry through the call); checks
    the sentinel."""
    if not fp or seconds < 0:
        return
    fire = None
    with _lock:
        ent = _device.get(fp)
        if ent is None:
            ent = _device[fp] = {"label": label,
                                 "win": _ledger._Rolling(),
                                 "backends": {}}
        ent["label"] = label
        ent["win"].add(seconds)
        if backend:
            bwin = ent["backends"].get(backend)
            if bwin is None:
                bwin = ent["backends"][backend] = _ledger._Rolling()
            bwin.add(seconds)
        fire = _check_drift_locked(fp, ent)
    if fire is not None:
        _emit_regression(fire)


def _check_drift_locked(fp: str, ent: dict) -> Optional[dict]:
    """Sentinel compare under _lock; returns the event payload to emit
    (outside the lock) or None."""
    global _regressions
    if _drift_factor <= 0 or fp in _regressed:
        return None
    _load_baselines_locked()
    base = _baselines.get(fp)
    if not base:
        return None
    win = ent["win"]
    if win.count < _drift_min_samples:
        return None
    p50 = win.quantile(0.50)
    base_p50 = base.get("p50_s")
    if p50 is None or not base_p50 or base_p50 <= 0:
        return None
    if p50 <= base_p50 * _drift_factor:
        return None
    _regressed.add(fp)
    _regressions += 1
    _registry.inc("attrib.perf_regression")
    drift = round(p50 / base_p50, 3)
    return {
        "type": "perf_regression",
        "fingerprint": fp,
        "label": ent["label"],
        "p50_s": round(p50, 6),
        "baseline_p50_s": round(base_p50, 6),
        "drift": drift,
        "factor": _drift_factor,
        "samples": win.count,
        "baseline_device_kind": base.get("device_kind"),
        "device_kind": device_kind(),
        # the sentinel compares fenced device windows, so the dominant
        # divergent stage is device_execute by construction
        "why": f"device_execute {drift:.1f}x baseline -> device regression",
        "why_stage": "device_execute",
    }


def _emit_regression(ev: dict) -> None:
    try:
        _events.emit(ev)
    except Exception:
        pass


# ---------------------------------------------------------------------------
# baselines: persist / restore
# ---------------------------------------------------------------------------


def _baseline_path() -> Optional[str]:
    if not _baseline_dir:
        return None
    return os.path.join(_baseline_dir, "perf_baseline.json")


def _load_baselines_locked() -> None:
    global _baselines_loaded, _atexit_armed
    if _baselines_loaded:
        return
    _baselines_loaded = True
    if not _atexit_armed:
        _atexit_armed = True
        atexit.register(save_baselines)
    path = _baseline_path()
    if path is None:
        return
    try:
        with open(path) as f:
            obj = json.load(f)
        if isinstance(obj, dict):
            _baselines.update(
                {fp: b for fp, b in obj.get("kernels", {}).items()
                 if isinstance(b, dict)})
    except (OSError, ValueError):
        pass


def load_baselines() -> dict:
    """Force-load and return the persisted baselines (lazy elsewhere)."""
    with _lock:
        _load_baselines_locked()
        return {fp: dict(b) for fp, b in _baselines.items()}


def save_baselines() -> Optional[str]:
    """Fold this process's device windows into the baseline file.

    A fingerprint's baseline only moves DOWN (or in on first sight, or
    over on a device_kind change) — a regressed run cannot raise its own
    bar and mask the drift it caused.  Atomic tmp+rename write."""
    with _lock:
        path = _baseline_path()
        if path is None:
            return None
        _load_baselines_locked()
        kind = device_kind()
        for fp, ent in _device.items():
            win = ent["win"]
            if win.count < _drift_min_samples:
                continue
            p50 = win.quantile(0.50)
            if p50 is None or p50 <= 0:
                continue
            old = _baselines.get(fp)
            if (old and old.get("device_kind") == kind
                    and old.get("p50_s") and old["p50_s"] <= p50):
                continue
            _baselines[fp] = {"label": ent["label"],
                              "p50_s": round(p50, 6),
                              "samples": win.count,
                              "device_kind": kind}
        if not _baselines:
            return None
        payload = {"version": 1, "device_kind": kind,
                   "kernels": _baselines}
    try:
        os.makedirs(_baseline_dir, exist_ok=True)
        tmp = path + ".tmp.%d" % os.getpid()
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path
    except OSError:
        return None


# ---------------------------------------------------------------------------
# peak table + roofline math
# ---------------------------------------------------------------------------


_kind_cache: "dict[str, str]" = {}


def device_kind() -> Optional[str]:
    """``torch.cuda.get_device_name`` of the process device when it is a
    card, ``"cpu"`` otherwise; None when no device is usable yet.  Never
    initializes CUDA in a process that works on the CPU."""
    from ramba_tpu_torch import common

    try:
        dev = common.device()
    except RuntimeError:
        return None
    if dev.type != "cuda":
        return "cpu"
    key = str(dev)
    kind = _kind_cache.get(key)
    if kind is None:
        import torch

        try:
            kind = _kind_cache[key] = torch.cuda.get_device_name(dev)
        except Exception:
            return None
    return kind


def peak_table(kind: Optional[str] = None) -> dict:
    """Resolved ``{"peak_gbps", "peak_tflops", "source", "device_kind"}``
    for ``kind`` (default: the live device)."""
    if kind is None:
        kind = device_kind()
    table = dict(_BUILTIN_PEAKS)
    source = "builtin"
    if _peaks_override:
        table.update(_peaks_override)
        source = "RAMBA_PEAKS_JSON"
    low = (kind or "").lower()
    best = None
    for key, peaks in table.items():
        if key == "default" or not isinstance(peaks, dict):
            continue
        if key.lower() in low and (best is None or len(key) > len(best)):
            best = key
    entry = table.get(best) if best else table.get("default", {})
    entry = entry if isinstance(entry, dict) else {}
    return {
        "peak_gbps": float(entry.get("peak_gbps") or 0.0),
        "peak_tflops": float(entry.get("peak_tflops") or 0.0),
        "source": source if best else source + ":default",
        "device_kind": kind,
    }


def classify(flops: float, bytes_accessed: float, device_s: float,
             peaks: dict) -> Optional[dict]:
    """Pure roofline math: achieved rates, fraction of peak, and the
    bandwidth-vs-compute-bound verdict for one kernel."""
    if device_s <= 0 or (flops <= 0 and bytes_accessed <= 0):
        return None
    peak_gbps = float(peaks.get("peak_gbps") or 0.0)
    peak_tflops = float(peaks.get("peak_tflops") or 0.0)
    achieved_gbps = bytes_accessed / device_s / 1e9
    achieved_tflops = flops / device_s / 1e12
    bw_frac = achieved_gbps / peak_gbps if peak_gbps > 0 else 0.0
    fl_frac = achieved_tflops / peak_tflops if peak_tflops > 0 else 0.0
    out = {
        "achieved_gb_per_s": round(achieved_gbps, 3),
        "achieved_tflops": round(achieved_tflops, 4),
        "bandwidth_frac": round(bw_frac, 4),
        "compute_frac": round(fl_frac, 4),
        "frac_of_peak": round(max(bw_frac, fl_frac), 4),
    }
    # operational intensity vs the ridge point decides which ceiling the
    # kernel is under; degenerate cost models fall back to the larger
    # achieved fraction
    if bytes_accessed > 0 and peak_gbps > 0 and peak_tflops > 0:
        intensity = flops / bytes_accessed  # flops per byte
        ridge = peak_tflops * 1e12 / (peak_gbps * 1e9)
        out["intensity"] = round(intensity, 3)
        out["ridge"] = round(ridge, 3)
        out["bound"] = "bandwidth" if intensity < ridge else "compute"
    else:
        out["bound"] = "compute" if fl_frac >= bw_frac else "bandwidth"
    return out


def _device_p50(fp: str, kernel: dict) -> "tuple[Optional[float], str]":
    """Best available device-seconds estimate for a kernel: fenced attrib
    window, else ledger sync window, else host dispatch p50 (flagged)."""
    with _lock:
        ent = _device.get(fp)
        if ent is not None:
            p50 = ent["win"].quantile(0.50)
            if p50 is not None:
                return p50, "fence"
    sync = (kernel.get("sync") or {}).get("p50_s")
    if sync:
        return float(sync), "sync"
    ex = kernel.get("exec") or {}
    p50 = ex.get("p50_s")
    if p50:
        return float(p50), "dispatch"
    count, total = ex.get("count"), ex.get("total_s")
    if count and total:
        return float(total) / int(count), "dispatch"
    return None, "none"


def roofline_report(kernels: Optional[dict] = None,
                    peaks: Optional[dict] = None) -> dict:
    """Per-fingerprint roofline rows.  ``kernels`` defaults to the live
    ledger snapshot (offline callers pass a capture's kernels section);
    ``peaks`` defaults to the live resolved table."""
    if kernels is None:
        kernels = _ledger.snapshot().get("kernels", {})
    if peaks is None:
        peaks = peak_table()
    out = {}
    for fp, k in kernels.items():
        flops = float(k.get("flops") or 0.0)
        by = float(k.get("bytes_accessed") or 0.0)
        dev_s, src = _device_p50(fp, k)
        if dev_s is None:
            continue
        row = classify(flops, by, dev_s, peaks)
        if row is None:
            continue
        row["label"] = k.get("label", "?")
        row["device_p50_s"] = round(dev_s, 6)
        row["device_time_source"] = src
        backends = {}
        with _lock:
            ent = _device.get(fp)
            if ent is not None:
                for name, bwin in ent["backends"].items():
                    bp50 = bwin.quantile(0.50)
                    if bp50 is None:
                        continue
                    brow = classify(flops, by, bp50, peaks)
                    if brow is not None:
                        brow["device_p50_s"] = round(bp50, 6)
                        backends[name] = brow
        if backends:
            row["backends"] = backends
        out[fp] = row
    return out


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------


def sentinel_report() -> dict:
    with _lock:
        _load_baselines_locked()
        return {
            "drift_factor": _drift_factor,
            "min_samples": _drift_min_samples,
            "baseline_dir": _baseline_dir,
            "baselines": len(_baselines),
            "regressions": _regressions,
            "regressed": sorted(_regressed),
        }


def attribution_report() -> dict:
    """The full attribution plane in one dict (diagnostics/bench/CLI).
    Empty dict when no flush has been attributed yet."""
    with _lock:
        flushes = _flushes
        stage_totals = {k: round(v, 6) for k, v in _stage_totals.items()}
        un = round(_unattributed_total, 6)
        have_device = bool(_device)
    if not flushes and not have_device:
        return {}
    peaks = peak_table()
    out = {
        "flushes": flushes,
        "stage_seconds": _ordered(stage_totals),
        "unattributed_s": un,
        "device_kind": peaks["device_kind"],
        "peaks": {"peak_gbps": peaks["peak_gbps"],
                  "peak_tflops": peaks["peak_tflops"],
                  "source": peaks["source"]},
        "rooflines": roofline_report(peaks=peaks),
        "sentinel": sentinel_report(),
    }
    attributed = sum(stage_totals.values())
    denom = attributed + un
    out["unattributed_frac"] = round(un / denom, 4) if denom > 0 else 0.0
    if sampling():
        out["sampling"] = sampling_report()
    return out


def snapshot() -> dict:
    return attribution_report()


def reset() -> None:
    """Forget everything including loaded baselines (tests)."""
    global _unattributed_total, _flushes, _regressions, _baselines_loaded
    with _lock:
        _stage_totals.clear()
        _unattributed_total = 0.0
        _flushes = 0
        _device.clear()
        _flush_seq.clear()
        _fence_log.clear()
        _stage_base.clear()
        _baselines.clear()
        _baselines_loaded = False
        _regressed.clear()
        _regressions = 0


reconfigure()
