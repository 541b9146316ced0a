"""Resilience layer: the control plane that acts on the observe/ signals.

Counterpart of ``ramba_tpu/resilience/``.  Ported so far:

* ``faults``    — the deterministic fault-injection harness (the whole
  ``RAMBA_FAULTS`` grammar, context managers, the byte-flip seams).
* ``retry``     — retry policy engine: exponential backoff with
  deterministic jitter, per-site budgets (``RAMBA_RETRY_*``), and the
  classification of retryable vs. degrade-worthy vs. fatal errors,
  torch's among them.  Wrapped around fileio reads/writes and checkpoint
  I/O.
* ``coherence`` — rank-coherent recovery decisions, single-process (the
  cross-process round comes with multi-GPU).
* ``integrity`` — content digests (the envelope, file and array digests)
  and the suspect quarantine.

The degradation ladder, the memory governor, host spill and the elastic
job lifecycle (``degrade``, ``memory``, ``spill``, ``elastic``) come with
the resilience queue.
"""

from ramba_tpu_torch.resilience import coherence, faults, integrity, retry  # noqa: F401
from ramba_tpu_torch.resilience.faults import (  # noqa: F401
    InjectedFault, InjectedResourceExhausted,
)
from ramba_tpu_torch.resilience.retry import RetryBudgetExhausted  # noqa: F401
