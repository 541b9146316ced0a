"""Backend selection for fused programs.

Counterpart of ``ramba_tpu/core/autotune.py``, modes ``off`` and
``force:<backend>`` only (the measured race and its persisted decision
table come later).  Two backends:

* ``"kernel"`` — the hand-written kernels (``ops/kernel_backend.py``);
* ``"torch"`` — the generic lowering (``fuser._build_callable``).

``RAMBA_AUTOTUNE`` unset/``off`` and ``force:kernel`` give every program
the classifier accepts to the kernels and the rest to the generic
lowering; ``force:torch`` pins the generic lowering for A/B runs.  Unlike
the JAX package there is no fallback after a failure: the choice is made
before anything runs, and a kernel that fails to build or launch raises.
"""

from __future__ import annotations

import os
from typing import Optional

KERNEL = "kernel"
TORCH = "torch"
BACKENDS = (KERNEL, TORCH)

_forced: Optional[str] = None


def reconfigure(*, mode: Optional[str] = None) -> None:
    """Reload the mode from ``RAMBA_AUTOTUNE`` (or the ``mode`` override).
    An unknown mode raises rather than silently meaning something else."""
    global _forced
    raw = os.environ.get("RAMBA_AUTOTUNE", "") if mode is None else mode
    raw = (raw or "").strip().lower()
    if raw in ("", "0", "off", "false", "no"):
        _forced = None
    elif raw.startswith("force:") and raw.split(":", 1)[1] in BACKENDS:
        _forced = raw.split(":", 1)[1]
    else:
        raise ValueError(
            f"RAMBA_AUTOTUNE={raw!r}: the port knows 'off', 'force:kernel' "
            "and 'force:torch'")


def select(program, leaf_vals) -> str:
    """Backend for this program."""
    if _forced == TORCH:
        return TORCH
    from ramba_tpu_torch.ops import kernel_backend

    return KERNEL if kernel_backend.supports(program, leaf_vals) else TORCH


reconfigure()
