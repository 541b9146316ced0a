"""A flush on a mesh of ranks: every rank runs the program on its blocks.

Every rank runs the same program (SPMD), and each realized array holds
only the rank's block (``Const.is_block``).  Before anything runs, a
``shard_hint`` over a leaf of another layout (the layout-aligning rewrite,
``core/rewrite.py``; a co-partitioning constraint) is lowered to a
reshard of that leaf (``parallel/reshard.py``), and the flush sorts the
program into one of three cases, the same on every rank because it reads
only the graph and the leaves' layouts:

* **shard-local** (:func:`local_plan`): every array leaf has the same
  global shape and the same layout (a block of it, a value every rank
  holds whole and cuts its block from, or a creation node that builds the
  block from global indices: ``arange``, ``full``, ``linspace``,
  ``fromfunction``; a ``shard_hint`` names the layout of what is under
  it, ``distribution=`` on a creation op among them), every instruction
  is elementwise (map, cast, round, ``masked_fill``, ``smap`` and
  ``smap_index``, whose kernel sees global indices) or a stencil (under
  any layout) or ``scumulative``, and a root may end in

  - a whole-array ``sum``/``prod``/``min``/``max``/``mean``/``any``/
    ``all`` or an ``sreduce``: the rank folds its block, the partials are
    all-gathered and folded in rank order, so every rank gets the same
    bytes and a rerun gives the same bytes;
  - the same reductions along some axes: each rank reduces its block;
    where a reduced axis is split, the partials of the ranks that hold
    the same block of the other axes are all-gathered and folded in rank
    order; the result keeps the source's layout on the axes left
    (``P('d1')`` for ``sum(axis=0)`` of a ``P('d0', 'd1')`` array, as
    GSPMD lays it out);
  - a ``segment_reduce`` (groupby) of kind sum/prod/min/max/count/mean/
    var/std over 1-D data: each rank runs one one-instruction program per
    partial on its block (the segred kernel on the card: sum, min, max,
    prod or count once; a mean its sum and count; var/std its sum, sum of
    squares and count), the ``G`` partials are all-gathered and folded in
    rank order, then finished as the generic lowering finishes them
    (``mean = sum / count``, ``var = sum_sq / count - mean**2``).

  A block that several ranks hold counts once in every fold (the rank at
  coordinate 0 of the mesh axes its layout leaves whole).  An
  elementwise program ending in whole-array folds over blocks of more
  than one dim runs on the blocks flattened (contiguous: a view), so
  elemred takes it on the card.
* **replicated**: no leaf is a block (scalars, values held whole): every
  rank runs the program whole, nothing moves.
* **gathered**: any other program.  Its block leaves are all-gathered,
  it runs as in one process (``mesh.local_scope``), and each rank keeps
  its block of every array result.  This is the lowering those programs
  have across processes, chosen before the run; it is counted
  (``fuser.stats["gathered"]``, ``parallel.comm_stats["allgather_bytes"]``).
  It takes: any other op (indexing, sort, matmul, reshapes), leaves of
  different shapes or layouts that no hint aligns (a lazy subtree of
  another layout), the nan-reductions, var/std/arg-reductions/medians
  along axes or whole, complex reductions, groupby of N-d data or of the
  nan-kinds, a ``shard_hint`` over a computed value of another layout.

Roots that no one plan takes together (arrays of other shapes or
layouts pending in one flush) are grouped into plans of their own, each
its own program; what none takes runs on the gathered lowering.

A program that raises on one rank raises on every rank: the ranks agree
on the outcome (one all-reduce) before any collective that would
otherwise leave the others waiting.

All of a plan's rank-local programs run together down the degradation
ladder (:func:`_laddered`, ``resilience/degrade.py``): fused, split,
chunked, eager (no host rung across ranks).  With the coherence layer
engaged (several processes), every rung attempt runs through the
``flush:gate`` (before its first launch: :func:`_gated`),
``retry:flush`` and ``flush:rung`` rounds, so a failure on one rank
drops every rank to the same rung, and a fatal one aborts every rank
with one class.  A rank with nothing to run (its block is empty) or
whose memo served its programs joins the same rounds: the rounds belong
to the plan, not to a program, and the rung list is the same on every
rank.  With a device budget, admission (``memory.admit``) runs before
the ladder behind one ``memory:admit`` round.  No other round runs
inside a rung: a retried attempt must not meet a collective the other
ranks skip.  A rank that fails before its first ladder joins the rounds
the others enter next (:func:`_join_and_raise`).

With the elastic watchdog armed (``RAMBA_WATCHDOG_S``, read once a
flush) each rank's attempt runs under ``elastic.with_deadline``: a rank
whose attempt hangs raises a degrade-class ``RankStallError``, joins the
gate round it skipped (proposing a failure), and its stall is proposed
to the next ``flush:rung`` round, so every rank drops together.  The
attempt it abandoned never enters a collective (the gate, a halo
exchange, a fold: ``distributed`` refuses it) and commits nothing.
"""

from __future__ import annotations

import math
import threading

import numpy as np
import torch

from ramba_tpu_torch.core import expr as E
from ramba_tpu_torch.core.expr import Const, Node, Scalar
from ramba_tpu_torch.parallel import distributed
from ramba_tpu_torch.parallel import mesh as _mesh
from ramba_tpu_torch.resilience import coherence

ELEMENTWISE = frozenset({"map", "cast", "round", "masked_fill"})
CREATION = frozenset({"arange", "full", "linspace", "fromfunction"})
STENCILS = frozenset({"stencil", "stencil_iter"})
FOLDS = frozenset({"sum", "prod", "min", "max", "mean", "any", "all"})
SEGMENTS = frozenset({"sum", "prod", "min", "max", "count", "mean", "var",
                      "std"})
# the partials a segment root reduces on each rank: (kind, of squares)
_SEGMENT_PARTS = {"mean": (("sum", False), ("count", False)),
                  "var": (("sum", False), ("sum", True), ("count", False)),
                  "std": (("sum", False), ("sum", True), ("count", False))}


class _Root:
    """One root of a shard-local plan.  ``kind``: "block", "reduce"
    (whole array), "axis" (along ``axes``), "segment" (groupby) or
    "sreduce"; ``expr`` the local expression (None: the block is empty
    and nothing runs); ``labels`` a segment root's local labels;
    ``out`` an axis root's result layout and global shape."""

    __slots__ = ("kind", "expr", "fname", "static", "dtype", "axes",
                 "keepdims", "labels", "out", "groups")

    def __init__(self, kind, expr, fname=None, static=None, dtype=None):
        self.kind, self.expr, self.fname = kind, expr, fname
        self.static, self.dtype = static, dtype
        self.axes = self.keepdims = self.labels = self.out = None
        self.groups = None


class Plan:
    """``owners[q]``: rank ``q``'s partials count in the folds (it holds
    a nonempty block, and is the first of the ranks holding it);
    ``boxes[q]``: rank ``q``'s block as ``(start, stop)`` per dim."""

    __slots__ = ("shape", "sharding", "index", "roots", "owners", "boxes")

    def __init__(self, shape, sharding, index, roots, owners, boxes):
        self.shape, self.sharding, self.index = shape, sharding, index
        self.roots, self.owners, self.boxes = roots, owners, boxes


def _axes(axis, nd) -> tuple:
    if axis is None:
        return tuple(range(nd))
    if isinstance(axis, (tuple, list)):
        return tuple(sorted({int(a) % nd for a in axis}))
    return (int(axis) % nd,)


def _fold_root(e):
    """``(kind, inner, fname, extra)`` of a root: a reduction the ranks
    can fold (whole or along axes), a groupby, an sreduce, or a plain
    block."""
    if isinstance(e, Node) and e.op == "reduce":
        fname, axis, keepdims, _ddof = e.static
        nd = len(e.args[0].shape)
        if fname in FOLDS and nd and e.args[0].dtype.kind != "c":
            axes = _axes(axis, nd)
            if len(axes) == nd and not keepdims:
                return "reduce", e.args[0], fname, None
            return "axis", e.args[0], fname, (axes, bool(keepdims))
    if isinstance(e, Node) and e.op == "segment_reduce":
        kind, _g, dim = e.static
        x, labels = e.args
        if (kind in SEGMENTS and len(x.shape) == 1 and dim == 0
                and x.dtype.kind != "c" and labels.shape == x.shape):
            return "segment", x, kind, labels
    if isinstance(e, Node) and e.op == "sreduce" and e.args[0].shape:
        return "sreduce", e.args[0], None, None
    return "block", e, None, None


def _is_local_op(node, shape) -> bool:
    op = node.op
    if op in ELEMENTWISE or op == "smap":
        return all(a.shape in ((), shape) for a in node.args) and (
            not (op == "smap" and node.static[2])
            or node.args[0].shape == shape)
    if op in CREATION:
        return op != "full" or node.args[0].shape == ()
    if op in STENCILS or op == "scumulative":
        return all(a.shape == shape for a in node.args)
    return op == "shard_hint"


def local_plan(exprs, mesh):
    """The shard-local plan of ``exprs`` on ``mesh``, or None."""
    roots = [_fold_root(e) for e in exprs]
    shapes = {tuple(inner.shape) for _k, inner, _f, _x in roots}
    if len(shapes) != 1:
        return None
    (shape,) = shapes
    if not shape:
        return None
    spec = None
    stencil = scan = False
    stencils = []
    seen = set()
    stack = [inner for _k, inner, _f, _x in roots]
    stack += [x for k, _i, _f, x in roots if k == "segment"]
    while stack:
        e = stack.pop()
        if id(e) in seen:
            continue
        seen.add(id(e))
        if isinstance(e, Scalar):
            continue
        if isinstance(e, Const):
            if e.shape == ():
                continue
            if e.shape != shape:
                return None
            if e.is_block:
                if e.sharding.mesh != mesh or (
                        spec is not None
                        and _mesh.canonical(e.sharding.spec) != spec):
                    return None
                spec = _mesh.canonical(e.sharding.spec)
            continue
        if not isinstance(e, Node) or e.shape != shape \
                or not _is_local_op(e, shape):
            return None
        if e.op == "shard_hint":
            hint = e.static[0]
            if hint.mesh != mesh or (spec is not None and
                                     _mesh.canonical(hint.spec) != spec):
                return None
            spec = _mesh.canonical(hint.spec)
        if e.op in STENCILS:
            stencil = True
            stencils.append(e)
        scan = scan or e.op == "scumulative"
        if e.op not in CREATION:
            stack.extend(e.args)
    sharding = _mesh.NamedSharding(mesh, _mesh.P(*(
        spec if spec is not None else _mesh.default_spec(shape, mesh))))
    if stencil:
        from ramba_tpu_torch.ops.stencil_sharded import fits

        for e in stencils:
            if not fits(e.static[1], e.static[2], shape, sharding):
                return None
    index = sharding.local_index(shape)
    local_shape = _mesh.index_shape(index, shape)
    # a rank with an empty block runs nothing, unless it is a member of
    # the mesh and a stencil needs it for the halo exchange
    pos = mesh.position_of(distributed.process_index())
    # (a scan's totals are all-gathered: every rank takes part)
    runs = (math.prod(local_shape) > 0 or scan
            or (stencil and pos is not None))
    world = distributed.process_count()
    boxes = [_mesh.index_box(sharding.rank_index(q, shape), shape)
             for q in range(world)]
    # a block held by several ranks (whole along some mesh axes) counts
    # once in a fold: at coordinate 0 of those axes
    used = {nm for en in sharding.spec for nm in _mesh.entry_names(en)}
    owners = []
    for q in range(world):
        qpos = mesh.position_of(q)
        owners.append(qpos is not None and all(
            lo < hi for lo, hi in boxes[q]) and all(
            p == 0 for nm, p in zip(mesh.axis_names, qpos)
            if nm not in used))
    memo: dict = {}
    out = []
    nonempty = math.prod(local_shape) > 0
    for (kind, inner, fname, extra), e in zip(roots, exprs):
        # an empty block folds nothing (a min of nothing would raise)
        loc = _localize(inner, shape, index, sharding, memo) if runs and (
            kind == "block" or nonempty) else None
        if kind == "reduce":
            dt = e.dtype
            if loc is not None:
                loc = Node("reduce", ("sum" if fname == "mean" else fname,
                                      None, False, None),
                           [_cast(loc, dt) if fname == "mean" else loc])
            out.append(_Root("reduce", loc, fname, dtype=dt))
        elif kind == "axis":
            axes, keepdims = extra
            if loc is not None:
                loc = Node("reduce", ("sum" if fname == "mean" else fname,
                                      axes, keepdims, None),
                           [_cast(loc, e.dtype) if fname == "mean"
                            else loc])
            r = _Root("axis", loc, fname, dtype=e.dtype)
            r.axes, r.keepdims = axes, keepdims
            r.out = _axis_layout(sharding, shape, axes, keepdims)
            r.groups = _axis_groups(plan_boxes=boxes, owners=owners,
                                    axes=axes, sharding=sharding,
                                    out=r.out)
            out.append(r)
        elif kind == "segment":
            r = _Root("segment", loc, fname, static=(e.static, inner.dtype),
                      dtype=e.dtype)
            if loc is not None:
                r.labels = _localize(extra, shape, index, sharding, memo)
            out.append(r)
        elif kind == "sreduce":
            worker, across, identity, _split = e.static
            if loc is not None:
                loc = Node("sreduce", (worker, worker, identity, False),
                           [loc], aval=E.Aval((), e.dtype, False))
            out.append(_Root("sreduce", loc, static=e.static,
                             dtype=e.dtype))
        else:
            out.append(_Root("block", loc, dtype=e.dtype))
    return Plan(shape, sharding, index, out, owners, boxes)


def _cast(e, dt):
    return Node("cast", (str(dt),), [e]) if e.dtype != dt else e


def _axis_layout(sharding, shape, axes, keepdims):
    """``(NamedSharding, shape)`` of a reduction along ``axes``: the
    source's entries on the axes left (None where ``keepdims`` keeps a
    reduced one)."""
    spec = tuple(sharding.spec) + (None,) * (len(shape) - len(sharding.spec))
    if keepdims:
        ents = [None if d in axes else spec[d] for d in range(len(shape))]
        oshape = tuple(1 if d in axes else n for d, n in enumerate(shape))
    else:
        ents = [spec[d] for d in range(len(shape)) if d not in axes]
        oshape = tuple(n for d, n in enumerate(shape) if d not in axes)
    return (_mesh.NamedSharding(sharding.mesh,
                                _mesh.P(*_mesh.canonical(ents))), oshape)


def _axis_groups(plan_boxes, owners, axes, sharding, out):
    """Per rank ``r``: the ranks whose partials make ``r``'s result block,
    in rank order (None: no reduced axis is split, so a rank's own
    partial is its result)."""
    counts = sharding.split_counts(len(plan_boxes[0]))
    if all(counts[d] == 1 for d in axes):
        return None
    keep = [d for d in range(len(plan_boxes[0])) if d not in axes]
    osh, oshape = out
    groups = []
    for r in range(len(plan_boxes)):
        obox = _mesh.index_box(osh.rank_index(r, oshape), oshape)
        want = tuple(obox[d] for d in keep) if len(obox) == len(
            plan_boxes[0]) else obox
        groups.append([q for q, box in enumerate(plan_boxes) if owners[q]
                       and tuple(box[d] for d in keep) == want])
    return groups


def _localize(e, shape, index, sharding, memo):
    """The expression of this rank's block of ``e``."""
    got = memo.get(id(e))
    if got is not None:
        return got
    from ramba_tpu_torch.core.fuser import leaf_value

    if isinstance(e, Scalar) or (isinstance(e, Const) and e.shape == ()):
        out = e
    elif isinstance(e, Const):
        v = leaf_value(e)
        out = Const(v) if e.is_block else Const(v[index].contiguous())
    elif e.op == "shard_hint":  # the layout is the plan's
        out = _localize(e.args[0], shape, index, sharding, memo)
    elif e.op in CREATION:
        out = _creation_block(e, shape, index)
    elif e.op == "smap" and e.static[2]:  # smap_index: global indices
        args = [_localize(a, shape, index, sharding, memo) for a in e.args]
        starts = tuple(sl.indices(n)[0] for sl, n in zip(index, shape))
        out = Node("smap_block", tuple(e.static) + (starts,), args,
                   aval=E.Aval(args[0].shape, e.dtype, False))
    elif e.op == "scumulative":
        (arg,) = [_localize(a, shape, index, sharding, memo) for a in e.args]
        out = Node("scumulative_block", (e.static, shape, sharding), [arg],
                   aval=E.Aval(arg.shape, e.dtype, False))
    elif e.op in STENCILS:
        args = [_localize(a, shape, index, sharding, memo) for a in e.args]
        iters = e.static[5] if e.op == "stencil_iter" else None
        local_shape = _mesh.index_shape(index, shape)
        out = Node("stencil_block", (e.static[:5], iters, shape, sharding),
                   args, aval=E.Aval(local_shape, e.dtype, False))
    else:
        args = [_localize(a, shape, index, sharding, memo) for a in e.args]
        out = Node(e.op, e.static, args)
    memo[id(e)] = out
    return out


def _creation_block(e, shape, index):
    """A creation node building only the block at ``index``."""
    local_shape = _mesh.index_shape(index, shape)
    starts = tuple(sl.indices(n)[0] for sl, n in zip(index, shape))
    if e.op == "full":
        dtype = e.static[1]
        return Node("full", (local_shape, dtype, None), e.args)
    if e.op == "arange":
        n, dtype, _spec = e.static
        return Node("arange_block", (starts[0], local_shape[0], dtype),
                    e.args, aval=E.Aval(local_shape, e.dtype, False))
    if e.op == "linspace":
        num, endpoint, dtype, _spec = e.static
        return Node("linspace_block", (num, endpoint, dtype, starts[0],
                                       local_shape[0]), e.args,
                    aval=E.Aval(local_shape, e.dtype, False))
    _shape, dtype, fn = e.static
    return Node("fromfunction_block", (local_shape, str(e.dtype), fn, starts),
                [], aval=E.Aval(local_shape, e.dtype, False))


# ---------------------------------------------------------------------------
# folds across ranks
# ---------------------------------------------------------------------------


def _combine(fname, a, b):
    if fname in ("sum", "mean", "count"):
        return a + b
    if fname == "prod":
        return a * b
    if fname == "any":
        return a | b
    if fname == "all":
        return a & b
    return torch.minimum(a, b) if fname == "min" else torch.maximum(a, b)


def _segment_parts(r):
    """``[(kind, of squares, torch dtype)]``: the partials of a segment
    root, in the dtypes the generic lowering reduces them in."""
    from ramba_tpu_torch.groupby import segment_dtype

    _static, xdt = r.static
    sq_dt = E.map_dtypes("multiply", [E.Aval((), xdt), E.Aval((), xdt)])[1]
    out = []
    for kind, sq in _SEGMENT_PARTS.get(r.fname, ((r.fname, False),)):
        dt = segment_dtype(kind, sq_dt if sq else xdt)
        out.append((kind, sq, E.to_torch_dtype(dt)))
    return out


def _part_specs(plan, r, q) -> list:
    """``[(shape, torch dtype)]`` of rank ``q``'s partials of root ``r``
    (empty where ``q`` contributes none)."""
    if r.kind == "block" or (r.kind == "axis" and r.groups is None) \
            or not plan.owners[q]:
        return []
    tdt = E.to_torch_dtype(r.dtype)
    if r.kind in ("reduce", "sreduce"):
        return [((), tdt)]
    if r.kind == "segment":
        G = int(r.static[0][1])
        return [((G,), dt) for _k, _s, dt in _segment_parts(r)]
    box = plan.boxes[q]
    shp = tuple(1 if d in r.axes else hi - lo
                for d, (lo, hi) in enumerate(box)
                if r.keepdims or d not in r.axes)
    return [(shp, tdt)]


def _nbytes(shape, dt) -> int:
    return math.prod(shape) * torch.empty((), dtype=dt).element_size()


def _identity(fname, shape, dt, dev):
    if fname in ("min", "max"):
        raise ValueError(f"zero-size array to reduction operation {fname} "
                         "which has no identity")
    fill = {"prod": 1, "all": True}.get(fname, 0)
    return torch.full(shape, fill, dtype=dt, device=dev)


def fold(plan, partials):
    """Every folded root's value on this rank: one all-gather of all the
    owners' partials (sizes known on every rank from the layout), then
    folds in rank order (``sreduce``: the driver reducer's halving fold
    over the partials in rank order, as one process folds its shards).
    Returns ``{root index: [folded partials]}``."""
    from ramba_tpu_torch.skeletons import _tree_reduce, call_kernel

    roots = plan.roots
    world = distributed.process_count()
    me = distributed.process_index()
    folded = [i for i, r in enumerate(roots) if r.kind in (
        "reduce", "sreduce", "segment") or (r.kind == "axis"
                                            and r.groups is not None)]
    if not folded:
        return {}
    dev = E.common.device()
    specs = [[_part_specs(plan, roots[i], q) for i in folded]
             for q in range(world)]
    sizes = [sum(_nbytes(s, dt) for per in specs[q] for s, dt in per)
             for q in range(world)]
    mine = [p.to(dt).reshape(-1).view(torch.uint8)
            for i, per in zip(folded, specs[me])
            for p, (_s, dt) in zip(partials[i] or (), per)]
    buf = torch.cat([m.to(dev) for m in mine]) if mine else \
        torch.empty(0, dtype=torch.uint8, device=dev)
    everyone = distributed.all_gather(buf, [(n,) for n in sizes])
    got = {}  # (root index, rank) -> [partials]
    for q in range(world):
        off = 0
        for i, per in zip(folded, specs[q]):
            vals = []
            for shp, dt in per:
                n = _nbytes(shp, dt)
                vals.append(everyone[q][off:off + n].clone().view(dt)
                            .reshape(shp))
                off += n
            got[(i, q)] = vals
    out = {}
    for i in folded:
        r = roots[i]
        if r.kind == "axis":
            ranks = r.groups[me]
        else:
            ranks = [q for q in range(world) if plan.owners[q]]
        vals = [got[(i, q)] for q in ranks]
        if r.kind == "sreduce":
            _w, across, identity, _s = r.static
            tdt = E.to_torch_dtype(r.dtype)
            ident = E.as_tensor(identity, r.dtype, dev)
            stacked = torch.stack([v[0] for v in vals]) if vals \
                else ident.reshape(1)
            out[i] = [_tree_reduce(
                stacked, ident,
                lambda a, b: call_kernel(across, a, b)).to(tdt)]
            continue
        if r.kind == "segment":
            G = int(r.static[0][1])
            kinds = [(k, (G,), d) for k, _q, d in _segment_parts(r)]
        else:
            shp = _out_block_shape(r) if r.kind == "axis" else ()
            kinds = [(r.fname, shp, E.to_torch_dtype(r.dtype))]
        if not vals:  # nothing held anywhere: the identity
            vals = [[_identity(k, shp, dt, dev) for k, shp, dt in kinds]]
        acc = list(vals[0])
        for v in vals[1:]:
            acc = [_combine(k, a, b) for (k, _s, _d), a, b
                   in zip(kinds, acc, v)]
        out[i] = acc
    return out


def _out_block_shape(r) -> tuple:
    osh, oshape = r.out
    return _mesh.index_shape(osh.local_index(oshape), oshape)


def _segment_finish(r, parts):
    """A segment root's result from its folded partials, as the generic
    lowering finishes it (``groupby._op_segment_reduce``)."""
    if r.fname not in _SEGMENT_PARTS:
        return parts[0]
    _static, xdt = r.static
    cnt = parts[-1].to(E.to_torch_dtype(E.reduce_dtype("sum", xdt)))
    mean = E.apply_map("true_divide", [parts[0], cnt])
    if r.fname == "mean":
        return mean
    out = E.apply_map("subtract", [
        E.apply_map("true_divide", [parts[1], cnt]),
        E.apply_map("multiply", [mean, mean])])
    return E.apply_map("sqrt", [out]) if r.fname == "std" else out


# ---------------------------------------------------------------------------
# the flush
# ---------------------------------------------------------------------------


def gather_const(c: Const) -> torch.Tensor:
    """The whole array of a block leaf, gathered from every rank."""
    from ramba_tpu_torch.core.fuser import leaf_value

    sh = c.sharding
    shape = tuple(c.shape)
    mine = leaf_value(c)
    parts = distributed.all_gather(mine, sh.rank_shapes(shape))
    if mine.device != E.common.device():
        parts = [p.to(E.common.device()) for p in parts]
    out = torch.empty(shape, dtype=mine.dtype, device=parts[0].device)
    for pos in np.ndindex(sh.mesh.devices.shape):
        out[sh.block_index(pos, shape)] = parts[sh.mesh.rank_at(pos)]
    return out


def _block_const(val, mesh, hint=None) -> Const:
    """A result every rank computed whole, cut to this rank's block of
    its layout (the sharding hint's, else the default)."""
    if not isinstance(val, torch.Tensor):
        return Const(val)
    sh = hint if hint is not None and hint.mesh == mesh else \
        _mesh.NamedSharding(mesh, _mesh.default_spec(val.shape, mesh))
    if not any(_mesh.entry_names(e) for e in sh.spec):
        return Const(val, sharding=sh)
    idx = sh.local_index(tuple(val.shape))
    return Const(val[idx].clone(), sharding=sh, shape=tuple(val.shape))


def _agree(ok: bool) -> bool:
    """Every rank learns whether every rank got this far without
    raising."""
    return distributed.all_reduce_int(1 if ok else 0, "min") == 1


def _execute(program, leaf_vals, split=False, rung="fused"):
    """The program through its lowering on ``rung`` (its leaves pinned
    against spilling), then the after-flush hooks.  ``split``: the
    verifier routed the flush (RAMBA_VERIFY=warn).  The result memo keys
    this rank-local program: it holds no collective (the folds run after
    it), so a hit on one rank and a miss on another cannot hang."""
    from ramba_tpu_torch.core import fuser
    from ramba_tpu_torch.resilience import memory

    pins = memory.ledger.pin_values(leaf_vals)
    try:
        return fuser.run_program(program, leaf_vals, split=split, rung=rung)
    finally:
        memory.ledger.unpin(pins)
        for hook in fuser.after_flush:
            hook()


def _admission(prepare):
    """True when the plan's main program starts at the chunked rung.
    Only with a device budget (the same verdict on every rank): the main
    program is prepared (``prepare()``: ``(program, leaf_vals)``, or None
    on a rank with nothing to run) and admitted here, then every rank
    takes the worst verdict of one ``memory:admit`` round, in which a
    rank that could not prepare its program proposes an abort."""
    from ramba_tpu_torch.resilience import memory

    if memory.budget_bytes() is None:
        return False
    err, code = None, 0
    try:
        p = prepare()
        if p is not None and memory.admit(p[0], p[1], (), coherent=False):
            code = 1
    except Exception as e:  # every rank must learn of it
        err, code = e, 2
    if coherence.engaged():
        code = coherence.agree("memory:admit", code, reduce="max")
    if code == 2:
        if err is not None:
            raise err
        raise coherence.CoherentAbort("memory:admit", coherence.P_FATAL)
    return code == 1


def _gated(run):
    """``run`` behind a launch gate: one ``flush:gate`` round an attempt,
    just before its first launch (``fuser.launch_gate``), or after the
    attempt where it launched nothing or failed first.  A rank-local
    program may exchange with other ranks inside it (a stencil's halos,
    scumulative's carries): a rank whose peer failed before launching
    raises a retryable ``CoherentAbort`` at the gate instead of waiting
    in an exchange the peer never joins, and the ladder's round then
    takes the peer's class.  A failure after the gate, inside such an
    exchange, is bounded by the watchdog's deadline when it is armed (the
    abandoned exchange then breaks the group), else by the group's
    timeout.  The gate is the attempt's own (a context variable the
    watchdog's helper thread carries) and opens once: when the watchdog
    abandons an attempt before its gate, the caller joins the round with
    a failure and the zombie, waking, finds it open and stops before its
    launch."""
    from ramba_tpu_torch.core import fuser

    def attempt(name):
        opened = []
        lock = threading.Lock()

        def gate(ok=True):
            with lock:
                if opened:
                    return
                opened.append(True)
            if coherence.agree("flush:gate", 0 if ok else 1) and ok:
                raise coherence.CoherentAbort("flush:gate",
                                              coherence.P_RETRY)

        token = fuser.launch_gate.set(gate)
        try:
            out = run(name)
            gate()
            return out
        except Exception:
            gate(ok=False)
            raise
        finally:
            fuser.launch_gate.reset(token)

    return attempt


def _laddered(run, split=False, route=False, wd=None):
    """``run(rung)`` down the degradation ladder: the same rung list on
    every rank (split and chunked offered whatever the program's length,
    no host rung), a fresh attempt at each rung behind one ``dispatch``
    fault check (on every rank, whether or not a program of its runs),
    under the watchdog's deadline when ``wd`` (seconds) is given, behind
    :func:`_gated` when the coherence layer is engaged.  Returns
    ``run``'s value."""
    from ramba_tpu_torch.core import fuser
    from ramba_tpu_torch.resilience import degrade, elastic, faults

    def checked(name):  # the dispatch site fails inside the gate
        faults.check("dispatch", rung=name)
        elastic.abandon_if_cancelled(f"the {name} rung")
        return run(name)

    body = checked
    if wd is not None:
        def body(name):
            return elastic.with_deadline("dispatch", lambda: checked(name),
                                         timeout_s=wd)

    go = _gated(body) if coherence.engaged() else body

    def rung(name):
        return lambda: go(name)

    names = fuser.rungs_for(None, split, route)
    return degrade.run_ladder("flush", [(n, rung(n)) for n in names])[0]


def _rebuild(exprs, fn):
    """``exprs`` with every node ``fn`` replaces (``fn(node)``: a new
    expression, or None to keep it; parents rebuilt bottom-up)."""
    memo: dict = {}
    out = []
    for root in exprs:
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
                stack.extend((a, False) for a in e.args if id(a) not in memo)
                continue
            args = [memo[id(a)] for a in e.args]
            cand = e if all(a is b for a, b in zip(args, e.args)) else \
                Node(e.op, e.static, args, aval=e.aval)
            new = fn(cand)
            memo[id(e)] = cand if new is None else new
        out.append(memo[id(root)])
    return out


def lower_hints(exprs, mesh):
    """Every ``shard_hint`` over a leaf becomes the leaf under that layout:
    a reshard where the layouts differ (collectives: every rank runs the
    same ones, in graph order)."""
    from ramba_tpu_torch.parallel.reshard import reshard_value

    def lower(e):
        if e.op != "shard_hint" or not isinstance(e.args[0], Const) \
                or e.static[0].mesh != mesh:
            return None
        return reshard_value(e.args[0], e.static[0].spec, mesh=mesh)

    return _rebuild(exprs, lower)


def flush_roots(stream, roots, extra, mesh):
    """``fuser._flush_roots`` on a mesh of ranks: materialize ``roots``
    (port arrays) and ``extra`` expressions; returns the whole values of
    ``extra``.  The watchdog's switch is read once for the flush, and
    its coherence rounds share one reading of theirs."""
    from ramba_tpu_torch.resilience import elastic

    exprs = [a._expr for a in roots] + list(extra)
    if not exprs:
        return []
    wd = elastic.watchdog_seconds()  # the flush's one read
    with coherence.flush_scope(wd):
        return _flush_roots(stream, roots, exprs, mesh, wd)


def _flush_roots(stream, roots, exprs, mesh, wd):
    from ramba_tpu_torch import common
    from ramba_tpu_torch.core import fuser

    err = None
    results = None
    try:
        try:
            if common.rewrite_enabled:
                from ramba_tpu_torch.core.rewrite import rewrite_roots

                exprs = rewrite_roots(exprs)
            exprs = lower_hints(exprs, mesh)
            split = fuser.verify_whole(exprs)
            plans = _plans(exprs, mesh)
        except Exception as e:
            _join_and_raise(e)
        results = []
        for idx, plan in plans:
            if plan is not None:
                results.append((idx, plan, _run_local(plan, split, wd)))
            else:
                results.append((idx, None, _run_whole(
                    [exprs[i] for i in idx], split, wd)))
    except Exception as e:  # every rank must learn of it: see _agree
        err = e
    ok = _agree(err is None)
    consts = [None] * len(exprs)
    n_instrs = 0
    try:
        if isinstance(err, coherence.CoherentAbort):
            # a peer's failure, agreed inside the ladder: this rank's
            # flush is abandoned with the agreed class
            abort = RuntimeError(
                "a flush raised on another rank of the group; this rank's "
                f"flush is abandoned ({err})")
            abort.coherent_classification = err.coherent_classification
            raise abort from err
        if err is not None:
            raise err
        if not ok:
            raise RuntimeError("a flush raised on another rank of the "
                               "group; this rank's flush is abandoned")
        for idx, plan, (outs, n) in results:
            n_instrs += n
            got = _finish_local(plan, outs) if plan is not None else [
                _block_const(v, mesh, _hint(exprs[i]))
                for v, i in zip(outs, idx)]
            for i, c in zip(idx, got):
                consts[i] = c
    except Exception as e:
        fuser._quarantine(stream, roots, e)
        raise
    for arr, c in zip(roots, consts):
        arr._set_expr(c)
    with fuser._stats_lock:
        fuser.stats["flushes"] += 1
        fuser.stats["nodes_flushed"] += n_instrs
    tail = []
    for c in consts[len(roots):]:
        tail.append(gather_const(c) if c.is_block else c.value)
    return tail


def _join_and_raise(err):
    """This rank failed before its first ladder: join the rounds the
    other ranks enter next (the first plan's admission round, then its
    ladder's first rung), proposing ``err``, so every rank raises
    together instead of one waiting in a round the other skipped."""
    if not coherence.engaged():
        raise err

    def fail(*_a):
        raise err

    _admission(fail)
    _laddered(fail)


_GROUPED_MAX = 64


def _plans(exprs, mesh):
    """``[(root indices, plan or None)]``: one shard-local plan for every
    root when there is one; else the roots grouped greedily into plans
    (roots of different shapes or layouts each run shard-local in their
    own program), the rest together on the gathered lowering."""
    plan = local_plan(exprs, mesh)
    if plan is not None or len(exprs) == 1 or len(exprs) > _GROUPED_MAX:
        return [(list(range(len(exprs))), plan)]
    groups, rest = [], []
    for i, e in enumerate(exprs):
        for g in groups:
            p = local_plan([exprs[j] for j in g[0]] + [e], mesh)
            if p is not None:
                g[0].append(i)
                g[1] = p
                break
        else:
            p = local_plan([e], mesh)
            if p is None:
                rest.append(i)
            else:
                groups.append([[i], p])
    out = [(idx, p) for idx, p in groups]
    if rest:
        out.append((rest, None))
    return out


def _hint(e):
    return e.static[0] if isinstance(e, Node) and e.op == "shard_hint" \
        else None


_FLAT_OPS = frozenset({"map", "cast", "round"})


def _flattened(exprs, local_shape):
    """An elementwise program (whole-array folds at its roots) over
    blocks of more than one dim, on the blocks flattened (views of the
    contiguous blocks): the 1-D program elemred takes.  None where the
    program is anything else."""
    if len(local_shape) < 2 or not math.prod(local_shape):
        return None
    leaves, stack, seen = [], list(exprs), set()
    while stack:
        e = stack.pop()
        if id(e) in seen:
            continue
        seen.add(id(e))
        if isinstance(e, Node):
            whole = e.op == "reduce" and e.static[1] is None \
                and not e.static[2]
            if not whole and e.op not in _FLAT_OPS:
                return None
            stack.extend(e.args)
        elif isinstance(e, Const) and e.shape != ():
            if tuple(e.shape) != tuple(local_shape) \
                    or not e.value.is_contiguous():
                return None
            leaves.append(e)
    flat = {id(c): Const(c.value.reshape(-1)) for c in leaves}

    def lower(e):  # every node anew: its aval is 1-D now
        return Node(e.op, e.static, [flat.get(id(a), a) for a in e.args])

    return [flat.get(id(e), e) for e in _rebuild(exprs, lower)]


def _run_segment(r, split=False, rung="fused"):
    """A segment root's partials on this rank: one one-instruction
    program per partial (the segred kernel's on the card)."""
    from ramba_tpu_torch.core import fuser

    def value(e):
        if isinstance(e, Const):
            return fuser.leaf_value(e)
        program, leaf_vals = fuser.prepare_program([e])
        return _execute(program, leaf_vals, split, rung)[0]

    data = value(r.expr)
    labels = value(r.labels)
    G = int(r.static[0][1])
    squares = None
    parts = []
    for kind, sq, _dt in _segment_parts(r):
        x = data
        if sq:
            if squares is None:
                squares = value(Node("map", ("multiply",),
                                     [Const(data), Const(data)]))
            x = squares
        node = Node("segment_reduce", (kind, G, 0),
                    [Const(x), Const(labels)])
        program, leaf_vals = fuser.prepare_program([node])
        parts.append(_execute(program, leaf_vals, split, rung)[0])
    return parts


def _run_local(plan, split=False, wd=None):
    """Run the plan's programs on this rank's blocks, down the ladder:
    ``(values, number of instructions)``, a value per root (None where
    nothing ran; a list of partials for a groupby)."""
    from ramba_tpu_torch.core import fuser

    live = [i for i, r in enumerate(plan.roots)
            if r.expr is not None and r.kind != "segment"]
    local_shape = _mesh.index_shape(plan.index, plan.shape)
    prepared = []

    def prepare():
        if not live:
            return None
        if not prepared:
            exprs = [plan.roots[i].expr for i in live]
            flat = _flattened(exprs, local_shape)
            prepared.append((fuser.prepare_program(flat or exprs),
                             flat is not None))
        return prepared[0][0]

    def run(rung):
        outs = [None] * len(plan.roots)
        n_instrs = 0
        if live:
            program, leaf_vals = prepare()
            vals = _execute(program, leaf_vals, split, rung)
            n_instrs += len(program.instrs)
            for i, v in zip(live, vals):
                if prepared[0][1] and plan.roots[i].kind == "block":
                    v = v.reshape(local_shape)
                outs[i] = v
        for i, r in enumerate(plan.roots):
            if r.kind == "segment" and r.expr is not None:
                outs[i] = _run_segment(r, split, rung)
                n_instrs += len(outs[i])
        return outs, n_instrs

    return _laddered(run, split, _admission(prepare), wd)


def _finish_local(plan, outs):
    """Block results become block leaves; reductions fold across ranks."""
    local_shape = _mesh.index_shape(plan.index, plan.shape)
    me = distributed.process_index()
    partials = [None if v is None else (v if r.kind == "segment" else [v])
                for r, v in zip(plan.roots, outs)]
    folded = fold(plan, [p if plan.owners[me] else None for p in partials])
    dev = E.common.device()
    consts = []
    for i, (r, v) in enumerate(zip(plan.roots, outs)):
        if r.kind == "block":
            if v is None:
                v = torch.empty(local_shape, dtype=E.to_torch_dtype(r.dtype),
                                device=dev)
            consts.append(Const(v, sharding=plan.sharding,
                                shape=plan.shape))
            continue
        if r.kind == "segment":
            consts.append(Const(_segment_finish(r, folded[i])))
            continue
        if r.kind == "axis":
            osh, oshape = r.out
            if r.groups is not None:
                v = folded[i][0]
            elif v is None:
                v = torch.empty(_out_block_shape(r),
                                dtype=E.to_torch_dtype(r.dtype), device=dev)
            if r.fname == "mean":
                n = math.prod(plan.shape[d] for d in r.axes)
                v = v / torch.tensor(n, dtype=v.dtype, device=v.device)
            consts.append(Const(v, sharding=osh, shape=oshape))
            continue
        total = folded[i][0]
        if r.fname == "mean":
            total = total / torch.tensor(math.prod(plan.shape),
                                         dtype=total.dtype,
                                         device=total.device)
        consts.append(Const(total))
    return consts


def _run_whole(exprs, split=False, wd=None):
    """Every rank runs the program whole: block leaves all-gathered (the
    gathered lowering, counted) or none (replicated)."""
    from ramba_tpu_torch.core import fuser

    program, leaves = fuser._linearize(list(exprs))
    gathered = any(isinstance(l, Const) and l.is_block for l in leaves)
    leaf_vals = [gather_const(l) if isinstance(l, Const) and l.is_block
                 else fuser.leaf_value(l) if isinstance(l, Const)
                 else l.value for l in leaves]
    if gathered:
        with fuser._stats_lock:
            fuser.stats["gathered"] += 1

    def run(rung):
        with _mesh.local_scope():
            return _execute(program, leaf_vals, split, rung)

    outs = _laddered(run, split, _admission(lambda: (program, leaf_vals)),
                     wd)
    return list(outs), len(program.instrs)
