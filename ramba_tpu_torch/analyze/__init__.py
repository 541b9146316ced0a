"""Static analysis over the deferred-op DAG (``ramba-lint`` + RAMBA_VERIFY).

Counterpart of ``ramba_tpu/analyze``, with the same names exported.  Two
entry points share one rule set (:mod:`ramba_tpu_torch.analyze.rules`):

* **Flush-time** — ``RAMBA_VERIFY=1`` verifies every program between
  linearization and lowering (``fuser._verify_if_enabled``); error
  findings raise :class:`ProgramVerificationError` in strict mode, or
  route the flush to the split rung otherwise (segments of half the
  instruction cap; the port's one rung below the fused program).
* **Offline** — ``python -m ramba_tpu_torch.analyze trace.jsonl``
  re-checks the ``program`` events a ``RAMBA_TRACE`` capture recorded and
  summarizes flush-time findings (:mod:`ramba_tpu_torch.analyze.lint`).
  Its event schema is the reference's, so either package lints the
  other's traces.
"""

from __future__ import annotations

from ramba_tpu_torch.analyze.canon import (
    COMMUTATIVE,
    CanonForm,
    NotCanonical,
    canonicalize,
    try_canonicalize,
)
from ramba_tpu_torch.analyze.effects import (
    EffectReport,
    classify_program,
    static_token,
)
from ramba_tpu_torch.analyze.findings import (
    SEVERITIES,
    Finding,
    ProgramVerificationError,
)
from ramba_tpu_torch.analyze.rules import RULES
from ramba_tpu_torch.analyze.verifier import (
    ProgramView,
    analyze_exprs,
    enabled_rules,
    mode,
    verify_flush,
    verify_program,
)

__all__ = [
    "COMMUTATIVE",
    "CanonForm",
    "EffectReport",
    "Finding",
    "NotCanonical",
    "ProgramVerificationError",
    "ProgramView",
    "RULES",
    "SEVERITIES",
    "analyze_exprs",
    "canonicalize",
    "classify_program",
    "enabled_rules",
    "mode",
    "static_token",
    "try_canonicalize",
    "verify_flush",
    "verify_program",
]
