"""Resilience layer: the control plane that acts on the observe/ signals.

Counterpart of ``ramba_tpu/resilience/``.  Ported so far:

* ``faults``    — the deterministic fault-injection harness (the whole
  ``RAMBA_FAULTS`` grammar, context managers, the byte-flip seams).
* ``retry``     — retry policy engine: exponential backoff with
  deterministic jitter, per-site budgets (``RAMBA_RETRY_*``), and the
  classification of retryable vs. degrade-worthy vs. fatal errors,
  torch's among them.  Wrapped around fileio reads/writes and checkpoint
  I/O.
* ``coherence`` — rank-coherent recovery decisions: one all-reduce round
  per decision across ranks.
* ``integrity`` — content digests (the envelope, file and array digests),
  the shadow recompute audit and the suspect quarantine.
* ``memory``    — the memory governor's core: the per-process device
  budget (``RAMBA_HBM_BUDGET``, else the card's share), the live-bytes
  ledger over every realized leaf, LRU host spill with restore on the
  next touch, governed placements.
* ``spill``     — the host-spill primitives the governor uses
  (``SpilledArray``, the copies to pinned host memory and back).
* ``degrade``   — the flush's degradation ladder (fused → split →
  chunked → eager → host), each rung under the retry engine, an
  out-of-memory failure evicting before the ladder drops a rung.

* ``elastic``   — the elastic job lifecycle: the watchdog deadline
  (``RankStallError``) around each flush attempt, the barrier and each
  coherence round, the heartbeat, ``CheckpointManager``,
  drain-to-checkpoint, ``resume`` into another world size and
  ``live_reshape``.

The governor also admits each flush (``memory.admit``), and the
integrity plane shadow-audits flushes (``RAMBA_AUDIT``).
"""

from ramba_tpu_torch.resilience import (  # noqa: F401
    coherence, degrade, elastic, faults, integrity, memory, retry, spill,
)
from ramba_tpu_torch.resilience.elastic import RankStallError  # noqa: F401
from ramba_tpu_torch.resilience.faults import (  # noqa: F401
    InjectedFault, InjectedResourceExhausted,
)
from ramba_tpu_torch.resilience.retry import RetryBudgetExhausted  # noqa: F401
