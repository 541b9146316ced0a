"""Pattern rewrites over the lazy expression graph.

Counterpart of ``ramba_tpu/core/rewrite.py``: the rules recognise the op
patterns xarray emits for groupby workloads and replace them with direct
forms, once per flush, bottom-up:

* ``rewrite_arange_reshape``: ``arange(n).reshape(s)`` becomes one node
  that generates the values in the target shape;
* ``rewrite_stack_reduce_advindex``: ``stack([reduce(x[..., idx_g, ...])
  for g])`` (the ``groupby().mean()`` expansion) becomes ONE
  ``segment_reduce``.  Over 1-D data with sum/min/max/prod and at most 64
  groups that is exactly the program the segred kernel takes
  (``ops/kernel_backend.py``);
* ``rewrite_concat_binop_getitem``: ``concatenate([x[..., idx_g] op m[g]
  for g])`` (the anomaly idiom) becomes two gathers and one map.

The matchers read the index constants on the host: a ``Const`` built from
a NumPy integer array keeps that array (``Const.host``), and a gather whose
index has no host copy (an index computed on the card) is not matched, so
a match never copies from the card.  The segment labels are scattered on
the device from the index tensors already there.  A rewritten node must give the aval
of the node it replaces; where the segment reduction's dtype differs (the
mean of integers) the rule leaves the graph alone.

A rule that raises is a bug: it is counted in ``stats["errors"]`` and
skipped for that node, and the flush goes on with the node as it was.
"""

from __future__ import annotations

import numpy as np

from ramba_tpu_torch.core.expr import (
    OPS, Const, Expr, Node, defop, tensor_from_numpy,
)

REDUCE_KINDS = {"mean", "nanmean", "sum", "nansum", "min", "max", "prod"}


def _aval_arange_nd(static, start, step):
    from ramba_tpu_torch.core.expr import Aval, infer_aval

    shape, n, dtype = static
    flat = infer_aval("arange", (n, dtype, None), [start, step])
    return Aval(tuple(shape), flat.dtype, False)


@defop("arange_nd", _aval_arange_nd)
def _op_arange_nd(static, start, step):
    """``start + step * flat_index`` in the target shape, computed as the
    arange it replaces computes it (the same bytes)."""
    shape, n, dtype = static
    return OPS["arange"]((n, dtype, None), start, step).reshape(shape)


def rewrite_arange_reshape(node: Node):
    """reshape(arange) -> one node in the target shape."""
    if node.op != "reshape":
        return None
    arg = node.args[0]
    if not (isinstance(arg, Node) and arg.op == "arange"):
        return None
    (shape,) = node.static
    n, dtype, _spec = arg.static
    start, step = arg.args
    return Node("arange_nd", (tuple(int(s) for s in shape), n, dtype),
                [start, step])


def _host_index(c: Const):
    """The index constant's host array, or None where it has none."""
    h = getattr(c, "host", None)
    return None if h is None else np.asarray(h)


def _single_axis_gather(e: Expr):
    """Match getitem_adv with exactly one integer index array and full
    slices elsewhere.  Returns (base_expr, dim, host index) or None."""
    if not (isinstance(e, Node) and e.op == "getitem_adv"):
        return None
    enc, arraypos = e.static
    if len(arraypos) != 1:
        return None
    p = arraypos[0]
    dim = 0
    for q, part in enumerate(enc):
        if q == p:
            break
        if part[0] != "s" or part[1:] != (None, None, None):
            return None
        dim += 1
    for q, part in enumerate(enc):
        if q != p and (part[0] != "s" or part[1:] != (None, None, None)):
            return None
    idx = e.args[1]
    if not isinstance(idx, Const):
        return None
    host = _host_index(idx)
    if host is None:
        return None
    return e.args[0], dim, host


def rewrite_stack_reduce_advindex(node: Node):
    """stack([reduce(x[..., idx_g, ...], axis=dim) for g]) ->
    segment_reduce (a reduction over all of a 1-D gather, axis None, is
    one over dim 0)."""
    if node.op != "stack" or len(node.args) < 2:
        return None
    (stack_axis,) = node.static
    kind = dim = base = None
    groups = []
    for a in node.args:
        if not (isinstance(a, Node) and a.op == "reduce"):
            return None
        k, raxis, keepdims, ddof = a.static
        if k not in REDUCE_KINDS or keepdims or ddof not in (None, 0):
            return None
        m = _single_axis_gather(a.args[0])
        if m is None:
            return None
        b, d, idx = m
        if raxis is None and len(b.aval.shape) == 1:
            raxis = 0
        if raxis != d:
            return None
        if base is None:
            base, dim, kind = b, d, k
        elif b is not base or d != dim or k != kind:
            return None
        groups.append((idx, a.args[0].args[1]))
    labels = _group_labels(groups, base.aval.shape[dim])
    if labels is None:
        return None
    out = Node("segment_reduce", (kind, len(groups), dim),
               [base, Const(labels)])
    # segment_reduce leaves the groups on `dim`; stack puts them on
    # stack_axis
    if stack_axis % len(node.aval.shape) != dim:
        out = Node("moveaxis", (dim, stack_axis), [out])
    if out.aval != node.aval:
        return None
    return out


def _group_labels(groups, n):
    """int32 labels of the n positions from each group's index (host
    array, Const of its tensor), or None unless the groups cover every
    position exactly once.  The check runs on the host arrays (as many
    indices as positions, all in range, every position marked in a bit
    map: then no position is taken twice, within a group or across); the
    labels are scattered on the device from the indices already there."""
    import torch

    from ramba_tpu_torch.core.expr import _index_long

    if sum(len(h) for h, _c in groups) != n:
        return None
    seen = np.zeros(n, bool)
    shifted = []
    for host, _c in groups:
        if host.ndim != 1:
            return None
        neg = False
        if host.size:
            lo, hi = host.min(), host.max()
            if lo < -n or hi >= n:
                return None
            neg = lo < 0
        seen[np.where(host < 0, host + n, host) if neg else host] = True
        shifted.append(neg)
    if np.count_nonzero(seen) != n:
        return None
    dev = groups[0][1].value.device
    labels = torch.empty(n, dtype=torch.int32, device=dev)
    for g, ((_h, c), neg) in enumerate(zip(groups, shifted)):
        t = _index_long(c.value).reshape(-1)
        labels[torch.where(t < 0, t + n, t) if neg else t] = g
    return labels


def _int_select(e: Expr, expect: int):
    """Match getitem picking integer ``expect`` on exactly one dim, full
    slices elsewhere.  Returns (base, dim) or None."""
    if not (isinstance(e, Node) and e.op == "getitem"):
        return None
    (enc,) = e.static
    dim = None
    at = 0
    for part in enc:
        if part[0] == "i":
            if dim is not None or part[1] != expect:
                return None
            dim = at
            at += 1
        elif part[0] == "s" and part[1:] == (None, None, None):
            at += 1
        else:
            return None
    if dim is None:
        return None
    return e.args[0], dim


def _int_select_chain(e: Expr, expect: int):
    """Match ``m[g]`` or ``m[g][:, None]``.  Returns
    (m_base, group_dim, has_trailing_newaxis) or None."""
    sel = _int_select(e, expect)
    if sel is not None:
        return sel[0], sel[1], False
    if not (isinstance(e, Node) and e.op == "getitem"):
        return None
    (enc,) = e.static
    if len(enc) < 1 or enc[-1] != ("n",):
        return None
    if any(part[0] != "s" or part[1:] != (None, None, None)
           for part in enc[:-1]):
        return None
    inner = _int_select(e.args[0], expect)
    if inner is None:
        return None
    return inner[0], inner[1], True


def rewrite_concat_binop_getitem(node: Node):
    """concatenate([binop(x[..., idx_g, ...], m[g]) for g]) ->
    binop(gather(x, cat(idx)), gather(m, group_of_position)).

    Two per-group operand forms: plain ``m[g]``, where trailing alignment
    puts the gathered group axis exactly on the concat axis; and
    ``m[g][:, None]`` with 2-D x and m, groups on x's axis 1 (the xarray
    anomaly idiom), lowered to take + transpose."""
    if node.op != "concatenate" or len(node.args) < 2:
        return None
    (axis,) = node.static
    base = dim = fname = m_base = swapped = m_dim = newaxis_form = None
    groups = []
    for gi, a in enumerate(node.args):
        if not (isinstance(a, Node) and a.op == "map" and len(a.args) == 2):
            return None
        (f,) = a.static
        lhs, rhs = a.args
        gl, gr = _single_axis_gather(lhs), _single_axis_gather(rhs)
        if gl is not None and gr is None:
            gather, other, sw = gl, rhs, False
        elif gr is not None and gl is None:
            gather, other, sw = gr, lhs, True
        else:
            return None
        b, d, idx = gather
        sel = _int_select_chain(other, gi)
        if sel is None:
            return None
        mb, mdim, nform = sel
        if base is None:
            base, dim, fname, m_base, swapped, m_dim, newaxis_form = (
                b, d, f, mb, sw, mdim, nform)
        elif (b is not base or d != dim or f != fname or mb is not m_base
              or sw != swapped or mdim != m_dim or nform != newaxis_form):
            return None
        groups.append(idx)
    x_ndim = len(base.aval.shape)
    if axis % x_ndim != dim:
        return None
    m_shape = tuple(m_base.aval.shape)
    if newaxis_form:
        if not (x_ndim == 2 and dim == 1 and len(m_shape) == 2
                and m_dim == 0):
            return None
    else:
        if len(m_shape) - m_dim != x_ndim - dim:
            return None
        if any(s != 1 for s in m_shape[:m_dim]):
            return None
    cat_idx = np.concatenate(groups).astype(np.int64)
    pos_group = np.concatenate(
        [np.full((len(g),), gi, np.int64) for gi, g in enumerate(groups)])
    enc = tuple(("i", 0) if q == dim else ("s", None, None, None)
                for q in range(x_ndim))
    gathered_x = Node("getitem_adv", (enc, (dim,)),
                      [base, Const(tensor_from_numpy(cat_idx), host=cat_idx)])
    gathered_m = Node("take", (m_dim, "clip"),
                      [m_base, Const(tensor_from_numpy(pos_group),
                                     host=pos_group)])
    if newaxis_form:
        # (n_positions, x_rows) -> (x_rows, n_positions) to align with x
        gathered_m = Node("permute", ((1, 0),), [gathered_m])
    args = [gathered_m, gathered_x] if swapped else [gathered_x, gathered_m]
    out = Node("map", (fname,), args)
    if out.aval != node.aval:
        return None
    return out


RULES = [
    rewrite_arange_reshape,
    rewrite_stack_reduce_advindex,
    rewrite_concat_binop_getitem,
]

# Per-rule fire counts, and the rules that raised (each a bug: the node
# stays as it was).
stats = {rule.__name__: 0 for rule in RULES}
stats["errors"] = 0
errors: list = []  # (rule name, repr of the exception), the last 16


def rewrite_roots(roots):
    """Apply RULES bottom-up across the expression forest (iterative: a
    chain can be deeper than Python's recursion limit)."""
    memo: dict[int, Expr] = {}
    out = []
    for root in roots:
        stack = [(root, False)]
        while stack:
            e, done = stack.pop()
            if id(e) in memo:
                continue
            if not isinstance(e, Node):
                memo[id(e)] = e
                continue
            if not done:
                stack.append((e, True))
                for a in e.args:
                    if id(a) not in memo:
                        stack.append((a, False))
                continue
            new_args = [memo[id(a)] for a in e.args]
            if all(n is o for n, o in zip(new_args, e.args)):
                cand = e
            else:
                cand = Node(e.op, e.static, new_args, aval=e.aval)
            for rule in RULES:
                try:
                    r = rule(cand)
                except Exception as exc:  # counted: chip_smoke fails on it
                    stats["errors"] += 1
                    errors.append((rule.__name__, repr(exc)))
                    del errors[:-16]
                    r = None
                if r is not None:
                    stats[rule.__name__] += 1
                    cand = r
                    break
            memo[id(e)] = cand
        out.append(memo[id(root)])
    return out
