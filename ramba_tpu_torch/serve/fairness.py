"""Round-robin fairness between tenants with queued flush work.

Counterpart of ``ramba_tpu/serve/fairness.py``: the compile pipeline's
queue.  Its invariants:

* **FIFO within a tenant** — a tenant's flushes dispatch in the order it
  enqueued them.  This is also a requirement across ranks: every rank
  must dispatch the same programs in the same order or their collectives
  deadlock, so coalescing below only ever takes items from queue *heads*
  (it can reorder BETWEEN tenants, which is safe in one process; ranks
  that serve give each rank the same submissions in the same order).
* **Round-robin between tenants** — the next dispatch comes from the
  next tenant in rotation that has work, so one tenant enqueueing 10k
  flushes delays the others by at most one batch, not 10k.
* **Bounded depth per tenant** — ``push`` rejects once a tenant's
  backlog reaches ``RAMBA_SERVE_QUEUE_DEPTH`` (default 4096, 0
  disables) with a classified
  :class:`~ramba_tpu_torch.serve.overload.QueueFullError`: backpressure
  surfaces at submit in O(ms) instead of as an unbounded deque that
  converts overload into universal timeout.
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque
from typing import Callable, List, Optional

from ramba_tpu_torch.observe import events as _events
from ramba_tpu_torch.observe import registry as _registry
from ramba_tpu_torch.serve import overload as _overload


class RoundRobin:
    """Per-tenant FIFO queues with round-robin popping, head-only
    fingerprint coalescing, and a per-tenant depth cap."""

    def __init__(self, depth_cap: Optional[int] = None):
        # tenant -> deque (insertion order gives the stable rotation base)
        self._queues: "OrderedDict[str, deque]" = OrderedDict()
        self._rotation: List[str] = []
        self._next = 0
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._closed = False
        # None -> read RAMBA_SERVE_QUEUE_DEPTH per push (monkeypatchable)
        self._depth_cap = depth_cap

    def push(self, tenant: str, item) -> None:
        cap = self._depth_cap
        if cap is None:
            cap = _overload.queue_depth_cap()
        with self._cond:
            q = self._queues.get(tenant)
            if q is None:
                q = self._queues[tenant] = deque()
                self._rotation.append(tenant)
            if cap and len(q) >= cap:
                _registry.inc("serve.shed")
                _registry.inc("serve.shed.queue_full")
                _events.emit({"type": "shed", "reason": "queue_full",
                              "stage": "submit", "tenant": tenant,
                              "depth": len(q), "cap": cap})
                raise _overload.QueueFullError(tenant, len(q), cap)
            q.append(item)
            self._cond.notify()

    def depth(self, tenant: str) -> int:
        with self._lock:
            q = self._queues.get(tenant)
            return len(q) if q else 0

    def max_depth(self) -> int:
        """Deepest per-tenant backlog — the brownout queue signal."""
        with self._lock:
            return max((len(q) for q in self._queues.values()), default=0)

    def __len__(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._queues.values())

    def close(self) -> None:
        """Wake every waiting pop_group with an empty result."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def _pop_one(self):
        """Next (tenant, item) in rotation; caller holds the lock and has
        checked that some queue is non-empty."""
        n = len(self._rotation)
        for off in range(n):
            tenant = self._rotation[(self._next + off) % n]
            q = self._queues.get(tenant)
            if q:
                self._next = (self._next + off + 1) % n
                return tenant, q.popleft()
        raise AssertionError("pop on empty rotation")

    def pop_group(self, max_group: int,
                  fingerprint_of: Optional[Callable] = None,
                  timeout: Optional[float] = None) -> list:
        """Block until work is available, then return the next batch.

        The batch starts with the round-robin next item; when
        ``fingerprint_of`` is given and ``max_group > 1``, it is extended
        with queue-HEAD items whose fingerprint matches — first more
        consecutive items from the same tenant's queue (their programs
        are identical, so dispatching them back-to-back is
        compile-cache-warm), then matching heads of the other tenants'
        queues in rotation order.  Only heads are taken, so every
        tenant's FIFO order survives coalescing.

        Returns ``[]`` on close() or timeout.
        """
        with self._cond:
            while not self._closed and not any(self._queues.values()):
                if not self._cond.wait(timeout=timeout):
                    return []
            if self._closed and not any(self._queues.values()):
                return []
            tenant, first = self._pop_one()
            group = [first]
            if fingerprint_of is None or max_group <= 1:
                return group
            fp = fingerprint_of(first)
            if fp is None:
                return group
            q = self._queues.get(tenant)
            while q and len(group) < max_group and \
                    fingerprint_of(q[0]) == fp:
                group.append(q.popleft())
            for other in self._rotation:
                if len(group) >= max_group:
                    break
                if other == tenant:
                    continue
                oq = self._queues.get(other)
                while oq and len(group) < max_group and \
                        fingerprint_of(oq[0]) == fp:
                    group.append(oq.popleft())
            return group
