"""Co-partitioning constraints between related arrays.

Counterpart of ``ramba_tpu/parallel/constraints.py``: ``smap(axis=...)``
records that its operands are partitioned identically along one axis;
:func:`add_constraint` pins each array to the same single-axis spec by
pushing a ``shard_hint`` node (``core/expr.py``) onto its expression.
The node computes nothing and holds the layout; the flush gives it to
the array, as ``with_sharding_constraint`` lays out an XLA output.  On a one-shard mesh there is nothing to pin: the constraint is
recorded and no node is pushed.
"""

from __future__ import annotations

import weakref
from collections import deque
from typing import Sequence

from ramba_tpu_torch.core.expr import Node
from ramba_tpu_torch.core.ndarray import ndarray
from ramba_tpu_torch.parallel import mesh as _mesh

# Recorded constraints, for introspection.  Bounded, and a Constraint
# holds only weakrefs, so recording never keeps arrays alive.
_constraints: deque = deque(maxlen=1024)


class Constraint:
    """These arrays are partitioned only along ``axis``, identically."""

    def __init__(self, arrays: Sequence[ndarray], axis: int):
        self._array_refs = [weakref.ref(a) for a in arrays]
        self.axis = int(axis)
        ndim = arrays[0].ndim if arrays else 1
        self.spec = axis_spec(ndim, axis)

    @property
    def arrays(self) -> list:
        """Still-live constrained arrays."""
        return [a for a in (r() for r in self._array_refs) if a is not None]

    def __repr__(self):
        return (f"Constraint(axis={self.axis}, n={len(self._array_refs)}, "
                f"spec={self.spec})")


def axis_spec(ndim: int, axis: int) -> _mesh.PartitionSpec:
    """Every mesh axis on ``axis``, the other dims whole."""
    axis = axis % ndim
    names = tuple(_mesh.get_mesh().axis_names)
    entries: list = [None] * ndim
    entries[axis] = names[0] if len(names) == 1 else names
    while entries and entries[-1] is None:
        entries.pop()
    return _mesh.P(*entries)


def add_constraint(arrays: Sequence[ndarray], axis: int) -> Constraint:
    """Co-partition ``arrays`` along ``axis``: each gets a sharding hint on
    its pending expression (arrays whose axis is shorter than the shard
    count stay as they are)."""
    arrs = [a for a in arrays if isinstance(a, ndarray)]
    con = Constraint(arrs, axis)
    k = _mesh.num_workers()
    for a in arrs:
        if a.ndim == 0 or k <= 1 or a.shape[axis % a.ndim] < k:
            continue
        sharding = _mesh.NamedSharding(_mesh.get_mesh(),
                                       axis_spec(a.ndim, axis))
        a.write_expr(Node("shard_hint", (sharding,), [a.read_expr()]))
    _constraints.append(con)
    return con


def get_constraints() -> list:
    return list(_constraints)


def clear_constraints() -> None:
    _constraints.clear()
