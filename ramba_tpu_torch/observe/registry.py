"""Single process-wide metrics store: counters + timers + comm gauges.

Counterpart of ``ramba_tpu/observe/registry.py``, the same stores and
names: every subsystem increments named counters here, so one snapshot
sees the whole system.

Counter naming convention: ``<subsystem>.<event>`` — e.g.
``fuser.cache_miss``, ``rewrite.rewrite_arange_reshape``,
``skeletons.host_fallback``, ``stencil.halo_bytes_est``,
``checkpoint.saves``.  ``*_bytes`` counters accumulate byte totals;
everything else counts occurrences.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict

# Process birth stamps, frozen at first import of the observability plane
# (one pair per process lifetime): a restarted process publishes a new
# start_wall.
START_WALL: float = round(time.time(), 6)
START_MONO: float = round(time.monotonic(), 6)

# One lock for the whole store: the stores are touched together (snapshot,
# reset) and individual updates are tiny, so finer grain buys nothing.
# RLock: a caller already holding it may update a store.  Unguarded
# ``d[k] += n`` is a read-modify-write that loses increments under
# contention between threads.
lock = threading.RLock()

# occurrence / byte counters: name -> int
counters: dict = defaultdict(int)

# names that were last written via gauge() — the metrics exporter types
# these as Prometheus gauges instead of counters
_gauge_names: set = set()

# name -> [total_seconds, call_count]
timers: dict = defaultdict(lambda: [0.0, 0])
# (parent, name) -> [total_seconds, call_count]
sub_timers: dict = defaultdict(lambda: [0.0, 0])
# program label -> [total_seconds, call_count]
per_func: dict = defaultdict(lambda: [0.0, 0])

# host<->device boundary traffic
comm: dict = {
    "host_to_device_bytes": 0, "host_to_device_count": 0,
    "device_to_host_bytes": 0, "device_to_host_count": 0,
}


def inc(name: str, n: int = 1) -> None:
    """Increment a named counter (hot-path safe: one dict add)."""
    with lock:
        counters[name] += n


def gauge(name: str, value) -> None:
    """Set a counter to an absolute level (e.g. ``memory.live_bytes``) —
    same store and naming convention as :func:`inc`, but last-write-wins
    semantics for quantities that go down as well as up."""
    with lock:
        counters[name] = int(value)
        _gauge_names.add(name)


def gauge_names() -> set:
    """Copy of the names with gauge (last-write-wins) semantics."""
    with lock:
        return set(_gauge_names)


def get(name: str) -> int:
    return counters.get(name, 0)


def prefixed(prefix: str) -> dict:
    """Counters under one subsystem prefix (e.g. ``prefixed("resilience.")``
    → every fault and retry counter)."""
    with lock:  # iteration would break under a concurrent inc of a new key
        return {k: v for k, v in counters.items() if k.startswith(prefix)}


def snapshot() -> dict:
    """Point-in-time copy of every store (JSON-serializable except
    sub_timers' tuple keys, which stringify as 'parent/name')."""
    with lock:
        return {
            "counters": dict(counters),
            "timers": {k: tuple(v) for k, v in timers.items()},
            "sub_timers": {f"{p}/{s}": tuple(v)
                           for (p, s), v in sub_timers.items()},
            "per_func": {k: tuple(v) for k, v in per_func.items()},
            "comm": dict(comm),
        }


def reset_counters() -> None:
    with lock:
        counters.clear()
        _gauge_names.clear()


def reset_timers() -> None:
    """Clear the timer stores."""
    with lock:
        timers.clear()
        sub_timers.clear()
        per_func.clear()
        for k in comm:
            comm[k] = 0


def reset() -> None:
    reset_counters()
    reset_timers()
