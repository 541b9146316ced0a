"""Diagnostics blocks of the analysis caches.

The reference's ``ramba_tpu/diagnostics.py`` reports every plane; the
port's report comes with ROADMAP A.9.  Until then the result memo and
the plan cache are read through ``core.memo.cache.snapshot()`` and
``core.plancache.snapshot()``.
"""

from __future__ import annotations

REPORTS = ("the diagnostics report and its memo and plan-cache blocks: "
           "ROADMAP A.9")


def memo_report() -> dict:
    """The result memo's block of the diagnostics report: ROADMAP A.9."""
    raise NotImplementedError(REPORTS)


def plancache_report() -> dict:
    """The plan cache's block of the diagnostics report: ROADMAP A.9."""
    raise NotImplementedError(REPORTS)
