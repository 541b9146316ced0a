"""Boolean-mask arrays.

Counterpart of ``ramba_tpu/core/masked.py``.  ``a[a > 0]`` gives an array
that keeps the logical shape and carries a boolean mask: elementwise ops
apply under the mask, writes are guarded and write through to the parent,
and reductions consider only the selected elements.  Every masked op is a
``masked_fill`` select and every masked reduction a ``reduce_where``, so
nothing compacts on the card (torch's ``x[mask]`` would wait for the
mask's count); only :meth:`MaskedArray.compressed` gathers the selected
values, on the host, as in the reference.
"""

from __future__ import annotations

import numpy as np

from ramba_tpu_torch.core.expr import Node, make_map
from ramba_tpu_torch.core.ndarray import ViewOp, as_exprable, ndarray


class _IdentityView(ViewOp):
    def read(self, base_expr):
        return base_expr

    def write(self, base_expr, value_expr):
        return value_expr


class MaskedArray(ndarray):
    """Same logical shape as its parent; only mask-selected elements are
    meaningful.  In-place ops write through to the parent (guarded)."""

    __slots__ = ("_mask",)

    def __init__(self, parent: ndarray, mask: ndarray):
        super().__init__(base=parent, view=_IdentityView())
        if not isinstance(mask, ndarray):
            # a host boolean mask; True selects (the reference's polarity,
            # the inverse of numpy.ma's True = invalid)
            from ramba_tpu_torch.ops.creation import asarray as _as

            mask = _as(mask, dtype=bool)
        if tuple(mask.shape) != tuple(parent.shape):
            raise ValueError(
                f"mask shape {tuple(mask.shape)} does not match data shape "
                f"{tuple(parent.shape)}"
            )
        self._mask = mask

    # -- guarded elementwise ---------------------------------------------------

    def _map(self, fname, *others, reverse=False):
        dense = self.read_expr()
        operands = [dense] + [as_exprable(o) for o in others]
        if reverse:
            operands = operands[::-1]
        val = make_map(fname, operands)
        guarded = Node("masked_fill", (), [dense, self._mask.read_expr(), val])
        return MaskedArray(ndarray(guarded), self._mask)

    def _inplace_map(self, fname, other):
        dense = self.read_expr()
        val = make_map(fname, [dense, as_exprable(other)])
        if np.dtype(val.dtype) != self.dtype:
            val = Node("cast", (str(self.dtype),), [val])
        self._base.write_expr(
            Node("masked_fill", (), [dense, self._mask.read_expr(), val])
        )
        return self

    # -- masked reductions -----------------------------------------------------

    def _reduce(self, fname, axis=None, keepdims=False, ddof=None):
        from ramba_tpu_torch.core.ndarray import _norm_axis

        axis = _norm_axis(axis, self.ndim)
        if fname in ("var", "std"):
            # two passes through the masked mean; ddof rescales by
            # n / (n - ddof) with n the selected count per slice, and a
            # slice with n <= ddof gives 0 (numpy.ma masks it)
            m = self._reduce("mean", axis, True)
            d = ndarray(self.read_expr()) - m
            v = MaskedArray(d * d, self._mask)._reduce("mean", axis, keepdims)
            if ddof:
                from ramba_tpu_torch.ops.elementwise import where

                cnt = self._mask.sum(axis=axis, keepdims=keepdims)
                v = where(cnt > ddof, v * (cnt / (cnt - float(ddof))), 0.0)
            return v.sqrt() if fname == "std" else v
        return ndarray(
            Node("reduce_where", (fname, axis, bool(keepdims)),
                 [self.read_expr(), self._mask.read_expr()])
        )

    def count(self):
        """The number of selected elements, as a 0-d array."""
        return self._mask.sum()

    def compressed(self) -> np.ndarray:
        """The selected elements as a dense 1-D host array (its length
        depends on the data, so it is gathered on the host)."""
        return self.asarray()[self._mask.asarray()]
