"""Structured findings for the static program verifier.

Counterpart of ``ramba_tpu/analyze/findings.py``: the same records, so a
finding from either package compares equal.  One :class:`Finding` is one detected property of one program — the analyze
package's counterpart of a compiler diagnostic.  Findings are plain frozen
records so they can be asserted exactly in tests, serialized through
``observe/events.py`` for ``scripts/trace_report.py``, and compared across
the flush-time and offline (``python -m ramba_tpu_torch.analyze``) paths.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

#: Severity ladder, least to most severe.  Only ``error`` findings abort a
#: strict-mode flush; ``warning`` marks legal-but-lossy constructs (e.g. a
#: non-associative kernel over a sharded axis) and ``info`` is advisory.
SEVERITIES: Tuple[str, ...] = ("info", "warning", "error")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One verifier diagnostic.

    ``rule``     — registry name of the rule that produced it.
    ``severity`` — one of :data:`SEVERITIES`.
    ``node``     — program-relative anchor: ``leaf3``, ``instr7:sreduce``,
                   ``node2:shard_hint``, ``slot12``, or ``program``.
    ``message``  — human-readable statement of the defect.
    """

    rule: str
    severity: str
    node: str
    message: str

    def __post_init__(self) -> None:
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"unknown severity {self.severity!r}; want one of {SEVERITIES}"
            )

    def as_event(self, label: Optional[str] = None) -> Dict[str, Any]:
        """Event-dict form for ``observe.events.emit``."""
        ev: Dict[str, Any] = {
            "type": "finding",
            "rule": self.rule,
            "severity": self.severity,
            "node": self.node,
            "message": self.message,
        }
        if label is not None:
            ev["label"] = label
        return ev


class ProgramVerificationError(RuntimeError):
    """Raised by a strict-mode (``RAMBA_VERIFY=1``) flush when the verifier
    produced ``error``-severity findings — before the program is lowered,
    so the malformed program never builds or launches a kernel.
    ``.findings`` carries the structured records."""

    def __init__(self, findings: List[Finding]):
        self.findings: List[Finding] = list(findings)
        lines = [
            f"  [{f.rule}] {f.node}: {f.message}" for f in self.findings
        ]
        super().__init__(
            "program verification failed with "
            f"{len(self.findings)} error finding(s):\n" + "\n".join(lines)
        )
