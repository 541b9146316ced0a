"""Observer-tax ledger: the observability plane meters itself.

Counterpart of ``ramba_tpu/observe/observer.py``.  Every measurement path
in ``observe/`` costs wall time that the work it measures must pay; each
one bills its wall seconds to a per-component ledger here.  The port's
only component so far is ``events`` (one ``events.emit``: stamp, ring
append, JSONL serialize and enqueue, the writer drain attempt).

Windows may nest, so the total is a slight over-count.

Import-light by design: stdlib only, so every other observe/ module can
bill itself without a cycle.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Optional

_lock = threading.Lock()

# component -> [total_seconds, count]
_tax: "dict[str, list]" = {}


def add(component: str, seconds: float) -> None:
    """Bill ``seconds`` of observer wall time to ``component``."""
    if seconds < 0:
        return
    with _lock:
        ent = _tax.get(component)
        if ent is None:
            ent = _tax[component] = [0.0, 0]
        ent[0] += seconds
        ent[1] += 1


@contextmanager
def taxed(component: str):
    """Scope whose wall time bills to ``component`` (even on error —
    a failing observer still spent the time)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        add(component, time.perf_counter() - t0)


def total_s() -> float:
    with _lock:
        return sum(ent[0] for ent in _tax.values())


def tax_frac() -> Optional[float]:
    """Observer seconds over attributed flush wall.  The port has no flush
    attribution yet (``observe/attrib.py`` waits for the observability
    queue), so there is no denominator: None."""
    return None


def snapshot() -> dict:
    """JSON-serializable ledger dump."""
    with _lock:
        comps = {k: {"seconds": round(v[0], 6), "count": v[1]}
                 for k, v in sorted(_tax.items())}
        total = sum(ent[0] for ent in _tax.values())
    return {"components": comps, "total_s": round(total, 6)}


def reset() -> None:
    with _lock:
        _tax.clear()
