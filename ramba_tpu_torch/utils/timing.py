"""Timing registry and profiler hooks.

Counterpart of ``ramba_tpu/utils/timing.py``, with the same names:

* ``time_dict`` counters with :func:`add_time`/:func:`add_sub_time`,
* ``RAMBA_TIMING`` gated atexit :func:`timing_summary`,
* per-fused-program execution times (``per_func``), and
* first-call accounting: the fuser files a program's first call under
  ``trace_compile_first_call`` (a kernel build or plan, or the generic
  lowering's first run) and every later call under ``flush_execute``.

The stores live in ``observe/registry.py``; this module aliases the same
dict objects, so ``diagnostics.snapshot()`` sees one registry.
:func:`profiler_trace` and :func:`annotate` use ``torch.profiler`` where
the reference uses ``jax.profiler``: the trace shows each flush's host
ranges and, on the card, its CUDA kernels.
"""

from __future__ import annotations

import atexit
import os
import sys
import time
from contextlib import contextmanager
from typing import Optional

from ramba_tpu_torch import common
from ramba_tpu_torch.observe import registry as _registry

# name -> [total_seconds, call_count]
time_dict: dict = _registry.timers
# (parent, name) -> [total_seconds, call_count]
sub_time_dict: dict = _registry.sub_timers
# program label -> [total_seconds, call_count]
per_func: dict = _registry.per_func


def add_time(name: str, seconds: float) -> None:
    """Accumulate into a top-level timer (under the registry lock: the
    two-field update is a read-modify-write)."""
    with _registry.lock:
        ent = time_dict[name]
        ent[0] += seconds
        ent[1] += 1


def add_sub_time(parent: str, name: str, seconds: float) -> None:
    """Accumulate into a nested timer."""
    with _registry.lock:
        ent = sub_time_dict[(parent, name)]
        ent[0] += seconds
        ent[1] += 1


_PER_FUNC_MAX = 1024


def add_func_time(label: str, seconds: float) -> None:
    """Per-fused-program execution time.  Bounded: beyond
    ``_PER_FUNC_MAX`` distinct labels, new ones aggregate under
    ``"<other>"``."""
    with _registry.lock:
        if label not in per_func and len(per_func) >= _PER_FUNC_MAX:
            label = "<other>"
        ent = per_func[label]
        ent[0] += seconds
        ent[1] += 1


@contextmanager
def timer(name: str, parent: Optional[str] = None):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if parent is None:
            add_time(name, dt)
        else:
            add_sub_time(parent, name, dt)


# Host<->device transfer accounting: uploads of host data and spills to
# host memory (traffic between cards and ranks is in
# ``parallel.comm_stats``).
comm_stats: dict = _registry.comm


def note_transfer(direction: str, nbytes: int) -> None:
    with _registry.lock:
        comm_stats[f"{direction}_bytes"] += int(nbytes)
        comm_stats[f"{direction}_count"] += 1


def print_comm_stats(file=None) -> None:
    file = file or sys.stderr
    print("=== ramba_tpu_torch comm stats (host boundary) ===", file=file)
    print(
        f"  host->device {comm_stats['host_to_device_bytes']:>14,d} B  "
        f"x{comm_stats['host_to_device_count']}", file=file,
    )
    print(
        f"  device->host {comm_stats['device_to_host_bytes']:>14,d} B  "
        f"x{comm_stats['device_to_host_count']}", file=file,
    )
    print(
        "  (traffic between shards and ranks: "
        "ramba_tpu_torch.parallel.comm_stats)", file=file,
    )


def reset() -> None:
    """Clear the timer stores (named counters reset through
    ``observe.registry`` or ``diagnostics.reset``)."""
    _registry.reset_timers()


def get_timing() -> dict:
    """Snapshot of all timers."""
    return {
        "timers": {k: tuple(v) for k, v in time_dict.items()},
        "sub_timers": {k: tuple(v) for k, v in sub_time_dict.items()},
        "per_func": {k: tuple(v) for k, v in per_func.items()},
    }


def get_timing_str(details: bool = False) -> str:
    """One ``name: seconds s(count)`` line per timer; ``details`` appends
    sub-timer lines (parents that only received sub-times are listed
    too)."""
    parents = list(time_dict)
    parents += [p for p, _ in sub_time_dict if p not in time_dict]
    seen = set()
    lines = []
    for k in parents:
        if k in seen:
            continue
        seen.add(k)
        if k in time_dict:
            secs, cnt = time_dict[k]
            lines.append(f"{k}: {secs}s({cnt})")
        else:
            lines.append(f"{k}:")
        if details:
            for (parent, sub), (ssecs, scnt) in sub_time_dict.items():
                if parent == k:
                    lines.append(f"  {sub}: {ssecs}s({scnt})")
    return "\n".join(lines) + ("\n" if lines else "")


def timing_summary(file=None) -> None:
    """Human-readable dump of every timer."""
    file = file or sys.stderr
    if not (time_dict or sub_time_dict or per_func):
        return
    print("=== ramba_tpu_torch timing summary ===", file=file)
    orphans = {p for p, _ in sub_time_dict if p not in time_dict}
    top = sorted(time_dict.items(), key=lambda kv: -kv[1][0])
    top += [(p, (0.0, 0)) for p in sorted(orphans)]
    for name, (tot, cnt) in top:
        print(f"  {name:<28s} {tot:10.4f}s  x{cnt}", file=file)
        for (parent, sub), (stot, scnt) in sorted(sub_time_dict.items()):
            if parent == name:
                print(f"    {sub:<26s} {stot:10.4f}s  x{scnt}", file=file)
    if per_func:
        print("  -- per fused program --", file=file)
        for label, (tot, cnt) in sorted(per_func.items(),
                                        key=lambda kv: -kv[1][0]):
            print(f"  {label:<28s} {tot:10.4f}s  x{cnt}", file=file)


if common.timing_level > 0:
    atexit.register(timing_summary)


def _activities():
    """CPU activity, plus CUDA activity when the process device is a
    card.  Never initializes CUDA in a process that works on the CPU."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if common.device().type == "cuda" and torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextmanager
def profiler_trace(logdir: str):
    """Record a ``torch.profiler`` trace of everything inside the block
    and export it as a Chrome trace (``<logdir>/trace_<pid>_<n>.json``,
    readable in Perfetto): host ranges of every flush and, on the card,
    each CUDA kernel with its device time."""
    import torch.profiler as _tp

    os.makedirs(logdir, exist_ok=True)
    prof = _tp.profile(activities=_activities())
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        global _trace_n
        _trace_n += 1
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{os.getpid()}_{_trace_n}.json"))


_trace_n = 0


def annotate(label: str):
    """Named range inside a profiler trace (``record_function``): a host
    range, and on the card the launches under it."""
    import torch.profiler as _tp

    return _tp.record_function(label)
