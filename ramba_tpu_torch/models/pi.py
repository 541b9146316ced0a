"""The midpoint-rule integral of 4/(1+x^2): the fused-chain showcase.

Counterpart of ``ramba_tpu/models/pi.py``: the chain builds one lazy
expression, and the flush runs it as one program whose only materialised
value is the scalar sum (on the card, one elemred launch).
"""

from __future__ import annotations


def integrate_pi(n: int = 10_000_000) -> float:
    """Midpoint-rule integral of 4/(1+x^2) on [0, 1] with n points."""
    import ramba_tpu_torch as rt

    h = 1.0 / n
    x = (rt.arange(n) + 0.5) * h
    return float(rt.sum(4.0 / (1.0 + x * x)) * h)
