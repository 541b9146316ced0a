"""Linear algebra.

Counterpart of ``ramba_tpu/ops/linalg.py``.  ``ramba_tpu`` leaves these
products to XLA (no Pallas kernel), so the port leaves them to
``torch.matmul``/``torch.einsum`` (``core/expr.py``'s matmul ops): float32
runs in full float32 (TF32 off) unless :func:`set_matmul_precision` asks
for a reduced precision; integer and bool products run in int64 on the
device, exact modulo 2**64 as NumPy wraps.  Result dtypes follow
``jnp``'s promotion, as in ``ramba_tpu``.  On a mesh of ranks the flush
runs ``matmul``, ``dot``, ``tensordot``, ``inner`` and a two-operand
``einsum`` partitioned, in GSPMD's layout (``core/rankdot.py``).
"""

from __future__ import annotations

import numpy as np

from ramba_tpu_torch.core.expr import Node
from ramba_tpu_torch.core.ndarray import as_exprable, ndarray
from ramba_tpu_torch.ops.creation import asarray


# The precision of the products built from now on (a static of each node)
_PRECISION = None


def set_matmul_precision(p):
    """None, "highest" or "float32": float32 products in full float32 (the
    default); "high", "default", "tensorfloat32", "bfloat16" or "fastest":
    TF32 on the card.  Set per product: torch's global flag is restored
    after each one."""
    global _PRECISION
    _PRECISION = p


def _prec():
    return _PRECISION


def matmul(a, b):
    return ndarray(Node("matmul", (_prec(),),
                        [as_exprable(asarray(a)), as_exprable(asarray(b))]))


def dot(a, b):
    return ndarray(Node("dot", (_prec(),),
                        [as_exprable(asarray(a)), as_exprable(asarray(b))]))


def vdot(a, b):
    a = asarray(a).ravel()
    b = asarray(b).ravel()
    return (a * b).sum()


def inner(a, b):
    a = asarray(a)
    b = asarray(b)
    if a.ndim == 0 or b.ndim == 0:
        return a * b
    return tensordot(a, b, axes=(a.ndim - 1, b.ndim - 1))


def outer(a, b):
    return ndarray(Node("outer", (),
                        [as_exprable(asarray(a).ravel()),
                         as_exprable(asarray(b).ravel())]))


def tensordot(a, b, axes=2):
    if isinstance(axes, (list, tuple)):
        axes = tuple(tuple(x) if isinstance(x, (list, tuple)) else (x,)
                     for x in axes)
    return ndarray(Node("tensordot", (axes, _prec()),
                        [as_exprable(asarray(a)), as_exprable(asarray(b))]))


def einsum(subscripts, *operands):
    return ndarray(Node("einsum", (subscripts, _prec()),
                        [as_exprable(asarray(o)) for o in operands]))


def einsum_path(subscripts, *operands, optimize="greedy"):
    """``numpy.einsum_path``: the contraction order depends on shapes
    only, so NumPy's planner runs over zero-stride stubs (no device data
    is read).  Both the subscripts string and the interleaved form."""

    def stub(o):
        if isinstance(o, (list, tuple)):  # an index sublist
            return o
        return np.broadcast_to(np.float64(0),
                               tuple(getattr(o, "shape", np.shape(o))))

    if isinstance(subscripts, str):
        return np.einsum_path(subscripts, *[stub(o) for o in operands],
                              optimize=optimize)
    return np.einsum_path(stub(subscripts), *[stub(o) for o in operands],
                          optimize=optimize)


def trace(a, offset=0, axis1=0, axis2=1):
    """The sum along the ``offset`` diagonal of ``axis1`` and ``axis2``;
    the other axes stay."""
    a = asarray(a)
    if a.ndim < 2:
        raise ValueError("trace requires an array of at least 2 dimensions")
    return ndarray(Node("trace", (int(offset), int(axis1), int(axis2)),
                        [as_exprable(a)]))
