"""Shape and index manipulation.

Counterpart of ``ramba_tpu/ops/manipulation.py``; only ``take`` is ported
so far (the gather that groupby's group-broadcast binops use).
"""

from __future__ import annotations

from ramba_tpu_torch.ops.creation import asarray


def take(a, indices, axis=None):
    return asarray(a).take(indices, axis)
