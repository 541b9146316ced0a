"""torch.profiler integration: RAMBA_PROFILE_DIR lines flushes up with
the profiler's timeline.

Counterpart of ``ramba_tpu/observe/profile.py``.  With
``RAMBA_PROFILE_DIR=<dir>`` set, the first flush starts one
``torch.profiler.profile`` (CPU activity, plus CUDA activity when the
process device is the card) and every flush dispatch runs inside a
``record_function`` range named by the fused program's label, so the
Perfetto timeline shows which program each kernel launch belongs to.
:func:`stop` (registered at exit) exports a Chrome trace,
``<dir>/ramba_trace_<pid>.json``.

``RAMBA_PROFILE=deep`` joins the attribution plane to the trace: the
flush range's name carries the span's trace id
(``ramba_flush:<label>#<trace_id>``), so a timeline row matches the
flush span (and its stage waterfall) in the ``RAMBA_TRACE`` stream.

CUDA activity needs CUPTI on the card's machine.  A profiler that was
asked for CUDA activity and recorded none while the process launched
kernels raises at :func:`stop`: it never writes a CPU-only trace in
place of the one asked for.
"""

from __future__ import annotations

import atexit
import contextlib
import os
import threading
from typing import Optional

_DIR = os.environ.get("RAMBA_PROFILE_DIR") or None
_deep = (os.environ.get("RAMBA_PROFILE") or "").lower() == "deep"
_lock = threading.Lock()
_prof = None
_cuda = False
_atexit_armed = False


def enabled() -> bool:
    return _DIR is not None


def deep() -> bool:
    return _deep


def reconfigure() -> None:
    """Re-read RAMBA_PROFILE_DIR / RAMBA_PROFILE (tests)."""
    global _DIR, _deep
    _DIR = os.environ.get("RAMBA_PROFILE_DIR") or None
    _deep = (os.environ.get("RAMBA_PROFILE") or "").lower() == "deep"


def started() -> bool:
    return _prof is not None


def ensure_started() -> None:
    """Start the profiler once (no-op unless RAMBA_PROFILE_DIR)."""
    global _prof, _cuda, _atexit_armed
    if _DIR is None or _prof is not None:
        return
    with _lock:
        if _prof is not None:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        from ramba_tpu_torch import common

        acts = [ProfilerActivity.CPU]
        _cuda = common.device().type == "cuda" and torch.cuda.is_available()
        if _cuda:
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(_DIR, exist_ok=True)
        prof = profile(activities=acts)
        prof.__enter__()
        _prof = prof
        if not _atexit_armed:
            _atexit_armed = True
            atexit.register(stop)


def _cuda_kernels(prof) -> "tuple[int, int]":
    """(kernel events on the device, kernel launches on the host)."""
    from torch.autograd import DeviceType

    kernels = launches = 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            kernels += 1
        elif ev.name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                         "cuLaunchKernel", "cuLaunchKernelEx"):
            launches += 1
    return kernels, launches


def stop() -> Optional[str]:
    """Stop the profiler and export its Chrome trace; returns the path
    (None when nothing was started).  Raises when CUDA activity was asked
    for and none was recorded while kernels were launched."""
    global _prof
    with _lock:
        prof, _prof = _prof, None
    if prof is None:
        return None
    prof.__exit__(None, None, None)
    if _cuda:
        kernels, launches = _cuda_kernels(prof)
        if launches and not kernels:
            raise RuntimeError(
                f"torch.profiler recorded {launches} kernel launches and no "
                "CUDA activity (CUPTI unavailable?): no trace written")
    path = os.path.join(_DIR or ".", f"ramba_trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    return path


def annotation(label: str):
    """``record_function`` range when profiling (or RAMBA_TIMING>=2) is
    on; a free nullcontext otherwise, safe on the per-flush hot path."""
    from ramba_tpu_torch import common

    if _DIR is None and common.timing_level <= 1 and not _deep:
        return contextlib.nullcontext()
    import torch.profiler as _tp

    return _tp.record_function(label)


def flush_annotation(label: str, trace_id=None):
    """Flush-dispatch range.  Under ``RAMBA_PROFILE=deep`` its name
    carries the flush span's trace id; otherwise it is
    :func:`annotation`."""
    if not _deep:
        return annotation(label)
    import torch.profiler as _tp

    if trace_id is not None:
        return _tp.record_function(f"{label}#{trace_id}")
    return _tp.record_function(label)
