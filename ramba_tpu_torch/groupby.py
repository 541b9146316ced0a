"""Groupby: per-group reductions and group-broadcast binary ops.

Counterpart of ``ramba_tpu/groupby.py``.  ``x.groupby(dim, labels,
num_groups)`` reduces ``x`` along ``dim`` into ``num_groups`` groups; its
binary operators broadcast a per-group operand back to the elements through
a gather by label (``take``) and one fused map.

Lowering.  A ``segment_reduce`` node of kind sum/prod/min/max/count over 1-D
data with integer labels and at most 64 groups is a program the segred
kernel takes (``ops/segred.py``, CUDA C++) when it is the only instruction
of its flush.  Everything else runs :func:`_op_segment_reduce`, the generic
lowering.  The JAX package's generic lowering is a ``(G, n)`` broadcast
compare-and-select that XLA fuses into the reduction loop; run eagerly it
would materialise the mask and the selected values (6 GB and 51 GB at
n = 2**28 float64, G = 24).  Here each group is one masked dense reduce over
the grouped axis, group after group: memory O(n * rest + G * rest), a fixed
combine order and no atomics, so reruns give the same bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from ramba_tpu_torch.core.expr import (
    Aval, Node, apply_map, as_tensor, defop, map_dtypes, reduce_dtype,
    reduce_tensor, to_np_dtype, to_torch_dtype,
)
from ramba_tpu_torch.core.ndarray import ndarray, as_exprable
from ramba_tpu_torch.ops.creation import asarray
from ramba_tpu_torch.ops.kernel_backend import reduce_identity_np

_NAN_KINDS = frozenset({"nansum", "nanmean", "nanvar", "nanstd"})


def _reduce_identity(op, tdt, dev) -> torch.Tensor:
    """Identity element of a segment reduction (sum -> 0, prod -> 1,
    min -> the dtype's max, ...), the value an empty group gets."""
    v = reduce_identity_np(op, to_np_dtype(tdt))
    return torch.full((), v.item(), dtype=tdt, device=dev)


# -- result dtype --------------------------------------------------------------


def _dt(fname, *dts):
    return map_dtypes(fname, [Aval((), np.dtype(d)) for d in dts])[1]


def segment_dtype(kind: str, dt) -> np.dtype:
    """Result dtype of ``segment_reduce``: the dtypes the lowering's steps
    take under NumPy's rules, as ``ramba_tpu`` computes under x64."""
    dt = np.dtype(dt)
    if kind in ("min", "max"):
        return dt
    if kind == "count":
        return np.dtype(np.int64)
    data = dt
    if kind in _NAN_KINDS:  # where(valid, x, 0) with a weak 0
        data = map_dtypes("where", [Aval((), np.dtype(bool)), Aval((), dt),
                                    Aval((), np.dtype(np.int64), True)])[1]
    s1 = reduce_dtype("sum", data)
    if kind in ("sum", "prod", "nansum"):
        return s1
    cnt = reduce_dtype("sum", dt)
    mean = _dt("true_divide", s1, cnt)
    if kind in ("mean", "nanmean"):
        return mean
    s2 = reduce_dtype("sum", _dt("multiply", data, data))
    v = _dt("subtract", _dt("true_divide", s2, cnt), _dt("multiply", mean, mean))
    return _dt("sqrt", v) if kind in ("std", "nanstd") else v


def _aval_segment_reduce(static, x, labels):
    kind, num_groups, dim = static
    shape = x.shape[:dim] + (int(num_groups),) + x.shape[dim + 1:]
    return Aval(shape, segment_dtype(kind, x.dtype), False)


# -- generic lowering ----------------------------------------------------------


def segment_multi(pairs, labels, num_groups):
    """Segment reductions of ``(op, data)`` pairs sharing one label array;
    ``data`` has the grouped axis first.  One masked dense reduce per group
    and pair, the group's mask shared by the pairs: no ``(G, n)`` value is
    ever built, and labels outside ``[0, G)`` match no group."""
    outs = [[] for _ in pairs]
    for g in range(num_groups):
        hit = labels == g
        for k, (op, d) in enumerate(pairs):
            m = hit.reshape(hit.shape + (1,) * (d.ndim - 1))
            ident = _reduce_identity(op, d.dtype, d.device)
            # the masked values live only until their reduction returns
            outs[k].append(reduce_tensor(op, torch.where(m, d, ident), axis=0))
    return [torch.stack(o) for o in outs]


def centred(data, mean, labels, valid=None):
    """``data - mean[label]`` with the grouped axis first (zero where
    ``valid`` is False; a label outside ``[0, G)`` reads group 0, and no
    group sums it)."""
    idx = labels.to(torch.int64).clamp(0, max(mean.shape[0] - 1, 0))
    d = apply_map("subtract", [data, mean.index_select(0, idx)])
    if valid is not None:
        d = torch.where(valid.reshape(valid.shape + (1,) * (d.ndim
                                                          - valid.ndim)),
                        d, torch.zeros((), dtype=d.dtype, device=d.device))
    return d


@defop("segment_reduce", _aval_segment_reduce)
def _op_segment_reduce(static, x, labels):
    kind, num_groups, dim = static
    x = torch.movedim(as_tensor(x), dim, 0)
    labels = as_tensor(labels)
    if kind in _NAN_KINDS:
        valid = apply_map("logical_not", [apply_map("isnan", [x])])
        data = apply_map("where", [valid, x, 0])
    else:
        valid = None
        data = x

    def seg(pairs):
        return segment_multi(pairs, labels, int(num_groups))

    def cnt_src():
        if valid is None:
            return torch.ones((), dtype=x.dtype, device=x.device).expand(x.shape)
        return valid.to(x.dtype)

    if kind in ("sum", "nansum", "prod", "min", "max"):
        (out,) = seg([("sum" if kind == "nansum" else kind, data)])
    elif kind == "count":
        ones = torch.ones((), dtype=torch.int64, device=x.device).expand(x.shape)
        if valid is not None:
            ones = torch.where(valid, ones, torch.zeros_like(ones))
        (out,) = seg([("sum", ones)])
    elif kind in ("mean", "nanmean"):
        s, cnt = seg([("sum", data), ("sum", cnt_src())])
        out = apply_map("true_divide", [s, cnt])
    elif kind in ("var", "std", "nanvar", "nanstd"):
        # in the result's dtype (no square in an integer dtype), centred on
        # each group's mean: count and sum, then the segment sums of
        # (x - mean[label])**2 (a one-pass E[x^2] - mean^2 loses every
        # digit where the mean is large against the spread)
        fdt = to_torch_dtype(segment_dtype(kind, to_np_dtype(x.dtype)))
        data = data.to(fdt)
        ones = torch.ones((), dtype=fdt, device=x.device).expand(x.shape)
        cnt, s1 = seg([("sum", ones if valid is None
                        else torch.where(valid, ones, 0)), ("sum", data)])
        mean = apply_map("true_divide", [s1, cnt])
        d = centred(data, mean, labels, valid)
        out = apply_map("true_divide", [
            seg([("sum", apply_map("multiply", [d, d]))])[0], cnt])
        if kind in ("std", "nanstd"):
            out = apply_map("sqrt", [out])
    else:
        raise ValueError(kind)
    return torch.movedim(out, 0, dim)


# -- the user API --------------------------------------------------------------


class RambaGroupby:
    """``ndarray.groupby(dim, value_to_group, num_groups)``.

    Reductions return an array whose grouped dimension has size
    ``num_groups``.  Binary operators broadcast a per-group operand back to
    the element level (the xarray climatology/anomaly pattern)."""

    def __init__(self, arr: ndarray, dim: int, value_to_group, num_groups=None):
        self.arr = arr
        self.dim = int(dim) % arr.ndim
        labels = np.asarray(value_to_group)
        if labels.ndim != 1 or labels.shape[0] != arr.shape[self.dim]:
            raise ValueError(
                "value_to_group must be 1-D with length equal to the grouped "
                f"dimension ({arr.shape[self.dim]}), got {labels.shape}"
            )
        self.labels = labels.astype(np.int32)
        self.num_groups = int(num_groups if num_groups is not None
                              else labels.max() + 1)
        self._labels_leaf = None

    def _labels(self):
        """The labels as a device leaf, uploaded once and shared by every
        reduction and binop of this groupby."""
        if self._labels_leaf is None:
            self._labels_leaf = as_exprable(self.labels)
        return self._labels_leaf

    # -- reductions -----------------------------------------------------------

    def _reduce(self, kind):
        return ndarray(Node("segment_reduce", (kind, self.num_groups, self.dim),
                            [self.arr.read_expr(), self._labels()]))

    def sum(self):
        return self._reduce("sum")

    def prod(self):
        return self._reduce("prod")

    def min(self):
        return self._reduce("min")

    def max(self):
        return self._reduce("max")

    def mean(self):
        return self._reduce("mean")

    def nanmean(self):
        return self._reduce("nanmean")

    def nansum(self):
        return self._reduce("nansum")

    def var(self):
        return self._reduce("var")

    def std(self):
        return self._reduce("std")

    def nanvar(self):
        return self._reduce("nanvar")

    def nanstd(self):
        return self._reduce("nanstd")

    def count(self):
        return self._reduce("count")

    # -- group-broadcast binary ops -------------------------------------------

    def _binop(self, fname, other, reverse=False):
        if np.isscalar(other) or getattr(other, "ndim", None) == 0:
            # a scalar operand: elementwise against the underlying array
            return self.arr._map(fname, other, reverse=reverse)
        other = asarray(other)
        if other.shape[self.dim] != self.num_groups:
            raise ValueError(
                f"group operand must have {self.num_groups} entries along "
                f"dim {self.dim}, got {other.shape}"
            )
        gathered = other.take(self._labels(), axis=self.dim)
        a, b = (gathered, self.arr) if reverse else (self.arr, gathered)
        return a._map(fname, b)


def _install_groupby_binops():
    table = {
        "add": "add", "sub": "subtract", "mul": "multiply",
        "truediv": "true_divide", "floordiv": "floor_divide", "mod": "mod",
        "pow": "power", "lt": "less", "le": "less_equal", "gt": "greater",
        "ge": "greater_equal", "eq": "equal", "ne": "not_equal",
    }
    for py, fname in table.items():
        def fwd(self, other, _f=fname):
            return self._binop(_f, other)

        def rev(self, other, _f=fname):
            return self._binop(_f, other, reverse=True)

        setattr(RambaGroupby, f"__{py}__", fwd)
        if py not in ("lt", "le", "gt", "ge", "eq", "ne"):
            setattr(RambaGroupby, f"__r{py}__", rev)


_install_groupby_binops()


def _ndarray_groupby(self, dim, value_to_group, num_groups=None):
    return RambaGroupby(self, dim, value_to_group, num_groups)


ndarray.groupby = _ndarray_groupby
