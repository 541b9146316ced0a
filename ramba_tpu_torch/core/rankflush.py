"""A flush on a mesh of ranks: every rank runs the program on its blocks.

Every rank runs the same program (SPMD), and each realized array holds
only the rank's blocks (``Const.is_block``): one per distinct block of
the mesh positions it holds, packed into one tensor where it holds
several (``parallel/mesh.py``: ``rank_mesh((2, 2), ranks=[0, 0, 1, 1])``,
the checkerboard ``[[0, 1], [1, 0]]``).  Before anything runs, a
``shard_hint`` over a leaf of another layout (the layout-aligning rewrite,
``core/rewrite.py``; a co-partitioning constraint) is lowered to a
reshard of that leaf (``parallel/reshard.py``); a hint over a computed
value whose subtree is shard-local in its leaves' layout runs that
subtree as a plan of its own first, then reshards its result
(:func:`lower_hints`).  Then, in one bottom-up pass
(:func:`lower_movements`), every contraction ``core/rankdot.py`` takes
(matmul, dot, tensordot, inner, a two-operand einsum) runs partitioned,
and every movement ``core/rankmove.py`` takes (a basic getitem or
setitem, permute, reshape, broadcast_to, flip, pad, concatenate and
stack of operands of one layout) moves box by box; each operand is a
leaf or a subtree the rank flush takes without gathering, run first,
and each result becomes a block leaf in GSPMD's layout, so what lies
above it is shard-local.  In the same pass a fold under an elementwise
node runs first as a plan of its own (``x - x.mean()``), an index over
leaves inside a larger program runs on the gathered lowering as a
program of its own, and a block operand of a broadcasting shape that
splits its dims otherwise than the elementwise node it feeds is
resharded first.  The flush then sorts the program into one of three
cases, the same on every rank because it reads only the graph and the
leaves' layouts:

* **shard-local** (:func:`local_plan`): every array leaf has the same
  global shape and the same layout (a block of it, a value every rank
  holds whole and cuts its block from, or a creation node that builds the
  block from global indices: ``arange``, ``full``, ``linspace``,
  ``fromfunction``; a ``shard_hint`` names the layout of what is under
  it, ``distribution=`` on a creation op among them), or a shape that
  broadcasts into it (fewer dims, dims of 1) under a layout that splits
  only dims it has at full length, the way the program's layout splits
  them; every instruction is elementwise (map, cast, round,
  ``masked_fill``, ``smap`` and ``smap_index``, whose kernel sees global
  indices), ``tril``/``triu`` (each block masked by its global indices),
  a stencil (under any layout) or ``scumulative``, and a root may end in

  - a whole-array fold: ``sum``/``prod``/``min``/``max``/``mean``/
    ``any``/``all``, the nan-reductions (``nansum``, ``nanprod``,
    ``nanmin``, ``nanmax``, ``nanmean``), ``var``/``std`` and
    ``nanvar``/``nanstd`` of any ``ddof`` (per block ``(count, mean,
    M2)`` over the values, or the non-NaN ones, the mean carried as
    ``hi + lo``: the block's sum, then a centred pass, the sums of
    ``x - hi`` and of their squares; a complex value's mean complex, its
    M2 of ``|x - hi|**2``), ``count_nonzero`` (an int64 sum of ``x !=
    0``), ``ptp`` (a fold of max and min, one subtraction in the input
    dtype), ``argmin``/``argmax`` (per block the extreme and its global
    index), complex ``sum``/``prod``/``mean``, or an ``sreduce``;
  - a selection (:mod:`core.rankselect`): ``median``, ``nanmedian`` and
    the ``quantile`` node (``q`` a constant every rank holds: the
    quantiles and percentiles, plain and nan), and complex
    ``min``/``max``/``ptp`` (XLA folds complex extremes in order, so the
    partials are positions), whole or along axes.  Where the layout
    leaves every reduced axis whole, each block holds whole slices and
    runs the reduction itself (no exchange; the result keeps the
    source's layout on the axes left); otherwise every owner position's
    block is sorted once and the ranks run rounds of all-gathered counts
    that find each slice's values at the positions one process reads,
    exactly, then finish as one process does (the shared positions and
    finish: ``expr.median_positions``/``median_finish``,
    ``extras.quantile_positions``/``quantile_finish``);
  - the same folds along some axes (an arg-reduction along one): each
    block is reduced; where a reduced axis is split, the partials of the
    positions that hold the same block of the other axes are folded; the
    result keeps the source's layout on the axes left (``P('d1')`` for
    ``sum(axis=0)`` of a ``P('d0', 'd1')`` array, as GSPMD lays it out);
  - a ``segment_reduce`` (groupby) of kind sum/prod/min/max/count/mean/
    var/std and the nan kinds, over 1-D data or along one dim of N-d
    data: one one-instruction program per partial on each block (on the
    card 1-D data takes the segred kernel: sum, min, max, prod or count
    once; a mean its sum and count; var/std its count and sum, then the
    segment sums of the deviations from the rounded mean and of their
    squares; the nan kinds with the NaNs' labels moved out of range),
    then the folds and the finish of the generic lowering.

  Every fold runs over the mesh positions in grid order, whichever rank
  holds them: one all-gather of every owner position's partials, then
  ``_combine`` (var/std: Chan, Golub and LeVeque's pairwise update,
  :func:`chan`; argmin/argmax: the extreme, NaN first, the first index
  among equals, :func:`_pick`), so a world of any size on one mesh gives
  the same bytes, and a rerun the same bytes.  A block that several
  positions hold counts once (the position at coordinate 0 of the mesh
  axes its layout leaves whole).  An elementwise program ending in
  whole-array folds over blocks of more than one dim runs on the blocks
  flattened (contiguous: a view), so elemred takes it on the card.
  Each held block runs its own program; where the blocks exchange (a
  stencil's halos, a scan's carries) one program takes all of a rank's
  blocks (``Plan.joint``): a halo between two blocks of one rank is a
  device copy.
* **replicated**: no leaf is a block (scalars, values held whole): every
  rank runs the program whole, nothing moves.
* **gathered**: any other program.  Its block leaves are all-gathered,
  it runs as in one process (``mesh.local_scope``), and each rank keeps
  its blocks of every array result.  This is the lowering those programs
  have across processes, chosen before the run; it is counted
  (``fuser.stats["gathered"]``, ``parallel.comm_stats["allgather_bytes"]``).
  What still takes it, and why:

  - indexing (``getitem_adv``, ``setitem_adv``, ``take``): an index may
    read any block (GSPMD all-gathers most gathers and scatters too);
    inside a larger program an index over leaves runs as a gathered
    program of its own, and what lies above it stays partitioned;
  - sort and argsort: a whole-array permutation, not a per-slice value
    (GSPMD all-gathers a sort along a split axis too);
  - ``repeat``, ``tile`` and ``diag``: GSPMD replicates their results
    (``tile`` along the tiled dim, ``diag`` whole);
  - ``concatenate``/``stack`` of operands of different layouts: no one
    layout holds them (GSPMD reshards them into one it picks);
  - a ``pad`` wider than its dim: its index map wraps more than once;
  - an einsum of three or more operands: one pairwise order is not
    chosen here;
  - batched matmul whose operands split a batch dim differently (or
    broadcast one): no result layout holds both;
  - a contraction of two or more dims of an operand, of an operand of
    more than two dims besides the batch dims, or whose operand is no
    leaf and no shard-local subtree;
  - ``outer`` and ``kron``: not contractions;
  - leaves of shapes that do not broadcast into one, or of layouts that
    no hint aligns: an elementwise op whose operands no one layout holds
    (``A + A.T``: GSPMD all-gathers it too);
  - a ``shard_hint`` over a subtree that is not shard-local itself;
  - a quantile whose ``q`` is a computed array.

Roots that no one plan takes together (arrays of other shapes or
layouts pending in one flush) are grouped into plans of their own, each
its own program; what none takes runs on the gathered lowering.

A program that raises on one rank raises on every rank: the ranks agree
on the outcome (one all-reduce) before any collective that would
otherwise leave the others waiting.

All of a plan's rank-local programs (every held block's) run together
down the degradation ladder (:func:`_laddered`, ``resilience/degrade.py``): fused, split,
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

A plan with selections opens its gate at the start of every attempt,
before any launch, and runs the selections' rounds inside the attempt
(under the watchdog's deadline): a rank that fails after the gate (a
program, a sort) joins the first selection's census with a failure
flag, so every rank raises there, together.  A contraction runs the
same way, its own ladder behind one ``memory:admit`` round: each attempt
opens its gate, and every exchange round of ``core/rankdot.py`` starts
with the ranks agreeing whether one failed; so does a group of
movements (``core/rankmove.py``: a ``move:round`` before its exchange
and after its pieces).  Nothing retreats to the gathered lowering.

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
from ramba_tpu_torch.core.rankdot import _entries
from ramba_tpu_torch.parallel import distributed
from ramba_tpu_torch.parallel import mesh as _mesh
from ramba_tpu_torch.resilience import coherence

ELEMENTWISE = frozenset({"map", "cast", "round", "masked_fill"})
CREATION = frozenset({"arange", "full", "linspace", "fromfunction"})
STENCILS = frozenset({"stencil", "stencil_iter"})
TRI = frozenset({"tril", "triu"})
# an index over leaves inside a larger program runs as a gathered program
# of its own (lower_movements)
INDEXING = frozenset({"getitem_adv", "setitem_adv", "take"})
# the nodes a fold root is (_fold_root)
FOLD_OPS = frozenset({"reduce", "segment_reduce", "sreduce", "call"})
# ops whose block reads other blocks (halos, carries): on a rank holding
# several blocks they take all of them at once
_EXCHANGING = STENCILS | {"scumulative"}
FOLDS = frozenset({"sum", "prod", "min", "max", "mean", "any", "all",
                   "nansum", "nanprod", "nanmin", "nanmax", "nanmean",
                   "var", "std", "nanvar", "nanstd", "argmin", "argmax",
                   "count_nonzero", "ptp"})
# the folds of complex values (their min/max/ptp are selections: XLA
# folds complex extremes in order, so the partials are positions)
COMPLEX_FOLDS = frozenset({"sum", "prod", "mean", "var", "std", "nanvar",
                           "nanstd", "count_nonzero"})
# the reductions that select across ranks (core/rankselect.py)
SELECTS = frozenset({"median", "nanmedian"})
COMPLEX_SELECTS = frozenset({"min", "max", "ptp"})
_ARGS = frozenset({"argmin", "argmax"})
SEGMENTS = frozenset({"sum", "prod", "min", "max", "count", "mean", "var",
                      "std", "nansum", "nanmean", "nanvar", "nanstd"})
_SPREADS = frozenset({"var", "std", "nanvar", "nanstd"})


class _Root:
    """One root of a shard-local plan.  ``kind``: "block", "reduce"
    (whole array), "axis" (along ``axes``), "segment" (groupby),
    "sreduce" or "select" (a median, a quantile or a complex extreme,
    whole or along ``axes``); ``exprs[j]`` the local expressions of held
    block ``j`` (None: the block is empty and nothing runs; a fold's
    main-program partials otherwise); ``labels[j]`` a segment root's
    local labels; ``out`` an axis, select or N-d segment root's result
    layout and global shape; ``xdt`` the dtype of what it reduces;
    ``node`` a select root's node; ``local`` a select root that leaves
    every reduced axis whole, so each block runs ``node`` itself."""

    __slots__ = ("kind", "exprs", "fname", "static", "dtype", "axes",
                 "keepdims", "labels", "out", "xdt", "ddof", "dim", "node",
                 "local")

    def __init__(self, kind, fname=None, static=None, dtype=None):
        self.kind, self.fname = kind, fname
        self.static, self.dtype = static, dtype
        self.exprs = self.labels = None
        self.axes = self.keepdims = self.out = self.xdt = None
        self.ddof = self.dim = self.node = self.local = None


class Plan:
    """``blocks``: this rank's blocks ``[(position, index)]`` in grid
    order (a rank outside the mesh: one empty block at position None);
    ``boxes[p]``: mesh position ``p``'s block as ``(start, stop)`` per
    dim; ``owners``: the positions whose partials count in the folds (a
    nonempty block, at coordinate 0 of the mesh axes the layout leaves
    whole), in grid order; ``joint``: the blocks' programs exchange, so
    they run as one program."""

    __slots__ = ("shape", "sharding", "blocks", "roots", "owners", "boxes",
                 "joint")

    def __init__(self, shape, sharding, blocks, roots, owners, boxes,
                 joint):
        self.shape, self.sharding, self.blocks = shape, sharding, blocks
        self.roots, self.owners, self.boxes = roots, owners, boxes
        self.joint = joint

    def block_shape(self, j) -> tuple:
        return _mesh.index_shape(self.blocks[j][1], self.shape)

    def local_block(self, pos) -> int:
        """Which of this rank's blocks is mesh position ``pos``'s."""
        want = self.sharding.block_coords(pos, len(self.shape))
        for j, (p, _i) in enumerate(self.blocks):
            if p is not None and self.sharding.block_coords(
                    p, len(self.shape)) == want:
                return j
        raise KeyError(pos)


def _axes(axis, nd) -> tuple:
    if axis is None:
        return tuple(range(nd))
    if isinstance(axis, (tuple, list)):
        return tuple(sorted({int(a) % nd for a in axis}))
    return (int(axis) % nd,)


def _replicated(q) -> bool:
    """A quantile's q that every rank holds whole."""
    return isinstance(q, Scalar) or (isinstance(q, Const)
                                     and not q.is_block)


def _fold_root(e):
    """``(kind, inner, fname, extra)`` of a root: a reduction the ranks
    can fold (whole or along axes), a selection, a groupby, an sreduce,
    or a plain block."""
    if isinstance(e, Node) and e.op == "call" and e.static[0] == "quantile":
        a, q = e.args
        kw = dict(e.static[1])
        if len(a.shape) and _replicated(q):
            axes = _axes(kw.get("axis"), len(a.shape))
            return "select", a, "quantile", (axes, kw["keepdims"], None)
    if isinstance(e, Node) and e.op == "reduce":
        fname, axis, keepdims, ddof = e.static
        x = e.args[0]
        nd = len(x.shape)
        if x.dtype.kind not in "fc":
            fname = E.NAN_PLAIN.get(fname, fname)  # nothing to ignore
        if nd and (fname in SELECTS or (x.dtype.kind == "c"
                                        and fname in COMPLEX_SELECTS)):
            return "select", x, fname, (_axes(axis, nd), bool(keepdims),
                                        None)
        if fname in FOLDS and nd and (x.dtype.kind != "c"
                                      or fname in COMPLEX_FOLDS):
            axes = _axes(axis, nd)
            whole = len(axes) == nd and not keepdims
            if fname in _ARGS and not (whole or len(axes) == 1):
                return "block", e, None, None
            if whole:
                return "reduce", x, fname, (axes, False, ddof)
            return "axis", x, fname, (axes, bool(keepdims), ddof)
    if isinstance(e, Node) and e.op == "segment_reduce":
        kind, _g, dim = e.static
        x, labels = e.args
        if kind in SEGMENTS and x.dtype.kind != "c" and (
                labels.shape == x.shape if len(x.shape) == 1 else
                isinstance(labels, Const) and not labels.is_block
                and labels.shape == (x.shape[dim],)):
            return "segment", x, kind, labels
    if isinstance(e, Node) and e.op == "sreduce" and e.args[0].shape:
        return "sreduce", e.args[0], None, None
    return "block", e, None, None


def _broadcasts(s, shape) -> bool:
    """An operand of shape ``s`` broadcasts into ``shape`` (fewer dims,
    dims of 1)."""
    return len(s) <= len(shape) and all(
        a in (1, b) for a, b in zip(tuple(s)[::-1], tuple(shape)[::-1]))


def _is_local_op(node, shape) -> bool:
    op = node.op
    if op in ELEMENTWISE:
        return True  # its operands broadcast into it (checked by the walk)
    if op == "smap":
        return all(a.shape in ((), shape) for a in node.args) and (
            not node.static[2] or node.args[0].shape == shape)
    if op in CREATION:
        return op != "full" or node.args[0].shape == ()
    if op in STENCILS or op == "scumulative" or op in TRI:
        return all(a.shape == shape for a in node.args)
    return op == "shard_hint"


def _fits(c, sharding, shape) -> bool:
    """A block leaf of a shape that broadcasts into ``shape`` is
    shard-local under ``sharding`` where it splits only dims it has at
    full length, the way ``sharding`` splits them."""
    if c.sharding.mesh != sharding.mesh:
        return False
    lead = len(shape) - len(c.shape)
    mine = _entries(c.sharding, len(c.shape))
    theirs = _entries(sharding, len(shape))
    return all(mine[d] == (theirs[d + lead] if n == shape[d + lead] else ())
               for d, n in enumerate(c.shape))


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
    whole = False  # a replicated block leaf of the full shape
    bcast = []  # block leaves that broadcast into the shape
    stencil = exchanging = scan = False
    stencils = []
    seen = set()
    stack = [inner for _k, inner, _f, _x in roots]
    stack += [x for k, inner, _f, x in roots
              if k == "segment" and len(inner.shape) == 1]
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
                if not _broadcasts(e.shape, shape):
                    return None
                if e.is_block and _mesh.canonical(e.sharding.spec):
                    bcast.append(e)
                continue
            if e.is_block:
                c = _mesh.canonical(e.sharding.spec)
                if e.sharding.mesh != mesh or (spec is not None and c
                                               and c != spec):
                    return None
                if not c:  # every rank holds it whole
                    whole = True
                    continue
                spec = c
            continue
        if not isinstance(e, Node):
            return None
        if e.shape != shape:
            # an elementwise operand that broadcasts into the shape
            if e.op not in ELEMENTWISE or not _broadcasts(e.shape, shape):
                return None
        elif not _is_local_op(e, shape):
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
        exchanging = exchanging or e.op in _EXCHANGING
        scan = scan or e.op == "scumulative"
        if e.op not in CREATION:
            stack.extend(e.args)
    if spec is None and whole:
        spec = ()
    sharding = _mesh.NamedSharding(mesh, _mesh.P(*(
        spec if spec is not None else _mesh.default_spec(shape, mesh))))
    if not all(_fits(c, sharding, shape) for c in bcast):
        return None
    if stencil:
        from ramba_tpu_torch.ops.stencil_sharded import fits

        for e in stencils:
            if not fits(e.static[1], e.static[2], shape, sharding):
                return None
    me = distributed.process_index()
    blocks = sharding.rank_blocks(me, shape) or [
        (None, sharding.rank_index(me, shape))]
    positions = list(np.ndindex(mesh.devices.shape))
    boxes = {p: _mesh.index_box(sharding.block_index(p, shape), shape)
             for p in positions}
    # a block held by several positions (whole along some mesh axes)
    # counts once in a fold: at coordinate 0 of those axes
    used = {nm for en in sharding.spec for nm in _mesh.entry_names(en)}
    owners = [p for p in positions if all(lo < hi for lo, hi in boxes[p])
              and all(c == 0 for nm, c in zip(mesh.axis_names, p)
                      if nm not in used)]
    joint = exchanging and len(blocks) > 1
    plan = Plan(shape, sharding, blocks, [], owners, boxes, joint)
    memo: dict = {}
    for (kind, inner, fname, extra), e in zip(roots, exprs):
        plan.roots.append(_plan_root(plan, kind, inner, fname, extra, e,
                                     memo, stencil, scan))
    return plan


def _plan_root(plan, kind, inner, fname, extra, e, memo, stencil, scan):
    """One root of ``plan``: its local expressions for every held
    block."""
    r = _Root(kind, fname, dtype=e.dtype)
    r.xdt = inner.dtype
    shape = plan.shape
    r.exprs = []
    if kind == "segment":
        r.static = e.static
        r.dim = e.static[2]
        r.labels = []
        if len(shape) > 1:
            r.out = _axis_layout(plan.sharding, shape, (r.dim,), True,
                                 groups=int(e.static[1]))
    if kind in ("reduce", "axis", "select"):
        r.axes, r.keepdims, r.ddof = extra
        if kind == "axis":
            r.out = _axis_layout(plan.sharding, shape, r.axes, r.keepdims)
    if kind == "select":
        r.node = e
        r.out = _select_layout(plan.sharding, shape, r)
        r.local = not _split_axes(plan, r)
        owned = {plan.sharding.block_coords(p, len(shape))
                 for p in plan.owners}
    if kind == "sreduce":
        r.static = e.static
    for j, (pos, index) in enumerate(plan.blocks):
        nonempty = math.prod(_mesh.index_shape(index, shape)) > 0
        if kind == "select" and not r.local:
            # the owner position's copy selects
            nonempty = nonempty and pos is not None and \
                plan.sharding.block_coords(pos, len(shape)) in owned
        elif kind == "select":  # an empty extent still has a result
            nonempty = pos is not None
        # an empty block folds nothing (a min of nothing would raise); a
        # block of a position runs a stencil for the halo exchange, and
        # every rank joins a scan's all-gather of totals
        runs = nonempty or scan or (stencil and pos is not None)
        if not runs or (kind != "block" and not nonempty):
            r.exprs.append(None)
            if kind == "segment":
                r.labels.append(None)
            continue
        loc = _localize(inner, plan, j, memo)
        if kind in ("reduce", "axis"):
            r.exprs.append(_fold_parts(r, loc))
        elif kind == "select":
            r.exprs.append(Node(e.op, e.static, [loc] + list(e.args[1:]))
                           if r.local else loc)
        elif kind == "segment":
            r.exprs.append(loc)
            lab = extra
            if len(shape) > 1:
                from ramba_tpu_torch.core.fuser import leaf_value

                lab = Const(leaf_value(lab)[index[r.dim]].contiguous())
            else:
                lab = _localize(lab, plan, j, memo)
            r.labels.append(lab)
        elif kind == "sreduce":
            worker, _across, identity, _split = e.static
            r.exprs.append(Node("sreduce", (worker, worker, identity, False),
                                [loc], aval=E.Aval((), e.dtype, False)))
        else:
            r.exprs.append(loc)
    return r


def _cast(e, dt):
    return Node("cast", (str(dt),), [e]) if e.dtype != dt else e


def _select_layout(sharding, shape, r):
    """``(NamedSharding, shape)`` of a select root's result: a
    reduction's (:func:`_axis_layout`), a quantile's with q's dims first,
    whole."""
    osh, oshape = _axis_layout(sharding, shape, r.axes, r.keepdims)
    if r.fname != "quantile":
        return osh, oshape
    qshape = tuple(r.node.args[1].shape)
    spec = (None,) * len(qshape) + tuple(osh.spec) + (None,) * (
        len(oshape) - len(osh.spec))
    return (_mesh.NamedSharding(sharding.mesh,
                                _mesh.P(*_mesh.canonical(spec))),
            qshape + oshape)


def _fold_parts(r, loc):
    """The main program's partials of a reduce/axis root over one block:
    the block's own reduction (a mean's sum in the result dtype), a
    nanmean's sum and count, a var's sum (its count is the block's size;
    its centred pass runs after, :func:`_partials`), an arg-reduction's
    extreme and its index in the block."""
    fname, axes = r.fname, r.axes
    keep = r.keepdims and r.kind == "axis"

    def red(name, x, keepdims=keep):
        axis = None if r.kind == "reduce" else \
            axes[0] if name in _ARGS else axes
        return Node("reduce", (name, axis, keepdims, None), [x])

    def valid():
        return Node("map", ("logical_not",), [Node("map", ("isnan",),
                                                   [loc])])

    if fname == "mean":
        return [red("sum", _cast(loc, r.dtype))]
    if fname == "nanmean":
        return [red("nansum", _cast(loc, r.dtype)), red("sum", valid())]
    if fname in _SPREADS:
        # a complex value's mean and deviations stay complex
        w = loc if r.xdt.kind == "c" else _cast(loc, r.dtype)
        if fname.startswith("nan"):
            ok = valid()
            return [red("sum", Node("map", ("where",), [ok, w, Scalar(0)])),
                    red("sum", ok)]
        return [red("sum", w)]
    if fname == "count_nonzero":
        return [red("sum", Node("map", ("not_equal",), [loc, Scalar(0)]))]
    if fname == "ptp":
        return [red("max", loc), red("min", loc)]
    if fname in _ARGS:
        ext = "max" if fname == "argmax" else "min"
        return [red(ext, loc), red(fname, loc)]
    return [red(fname, loc)]


def _axis_layout(sharding, shape, axes, keepdims, groups=None):
    """``(NamedSharding, shape)`` of a reduction along ``axes``: the
    source's entries on the axes left (None where ``keepdims`` keeps a
    reduced one; a groupby's grouped dim becomes ``groups`` long)."""
    spec = tuple(sharding.spec) + (None,) * (len(shape) - len(sharding.spec))
    if keepdims:
        ents = [None if d in axes else spec[d] for d in range(len(shape))]
        oshape = tuple((1 if groups is None else groups) if d in axes else n
                       for d, n in enumerate(shape))
    else:
        ents = [spec[d] for d in range(len(shape)) if d not in axes]
        oshape = tuple(n for d, n in enumerate(shape) if d not in axes)
    return (_mesh.NamedSharding(sharding.mesh,
                                _mesh.P(*_mesh.canonical(ents))), oshape)


def _group(plan, r, out_index) -> list:
    """The owner positions whose partials make the result block at
    ``out_index`` of an axis or N-d segment root, in grid order."""
    axes = r.axes if r.kind == "axis" else (r.dim,)
    nd = len(plan.shape)
    keep = [d for d in range(nd) if d not in axes]
    _osh, oshape = r.out
    obox = _mesh.index_box(out_index, oshape)
    want = tuple(obox[d] for d in keep) if len(obox) == nd else obox
    return [p for p in plan.owners
            if tuple(plan.boxes[p][d] for d in keep) == want]


def _split_axes(plan, r) -> bool:
    """True when a reduced (or grouped) axis is split: the result blocks
    fold partials across positions."""
    axes = (r.dim,) if r.kind == "segment" else r.axes
    counts = plan.sharding.split_counts(len(plan.shape))
    return any(counts[d] > 1 for d in axes)


def _localize(e, plan, j, memo):
    """The expression of held block ``j`` of ``e``."""
    got = memo.get((id(e), j))
    if got is not None:
        return got
    from ramba_tpu_torch.core.fuser import leaf_value

    shape, sharding = plan.shape, plan.sharding
    index = plan.blocks[j][1]
    if isinstance(e, Scalar) or (isinstance(e, Const) and e.shape == ()):
        out = e
    elif isinstance(e, Const):
        v = leaf_value(e)
        full = tuple(e.shape) == tuple(shape)
        if e.is_block and _mesh.canonical(e.sharding.spec):
            if full:
                held = sharding.split_local(v, shape)
                out = Const(held[j] if held else v)
            else:
                out = Const(_operand_block(e, v, plan, j))
        else:  # every rank holds it whole: its block cut out
            out = Const(v[_broadcast_index(index, e.shape, shape)]
                        .contiguous())
    elif e.op == "shard_hint":  # the layout is the plan's
        out = _localize(e.args[0], plan, j, memo)
    elif e.op in CREATION:
        out = _creation_block(e, shape, index)
    elif e.op == "smap" and e.static[2]:  # smap_index: global indices
        args = [_localize(a, plan, j, memo) for a in e.args]
        starts = tuple(sl.indices(n)[0] for sl, n in zip(index, shape))
        out = Node("smap_block", tuple(e.static) + (starts,), args,
                   aval=E.Aval(args[0].shape, e.dtype, False))
    elif e.op in _EXCHANGING:
        out = _exchanging_block(e, plan, j, memo)
    elif e.op in TRI:  # masked by the block's global indices
        (k,) = e.static
        loc = _localize(e.args[0], plan, j, memo)
        r0, c0 = (sl.indices(n)[0] for sl, n in zip(index[-2:], shape[-2:]))
        out = Node("tri_block", (e.op, k + r0 - c0), [loc],
                   aval=E.Aval(loc.shape, e.dtype, False))
    else:
        args = [_localize(a, plan, j, memo) for a in e.args]
        out = Node(e.op, e.static, args)
    memo[(id(e), j)] = out
    return out


def _broadcast_index(index, s, shape) -> tuple:
    """A block's index of an operand of shape ``s`` broadcast into
    ``shape``: whole along its dims of 1 that broadcast."""
    lead = len(shape) - len(s)
    return tuple(index[d + lead] if n == shape[d + lead] else slice(None)
                 for d, n in enumerate(s))


def _operand_block(c, v, plan, j):
    """Held block ``j`` of the plan, of a block leaf in another layout
    that broadcasts into it (:func:`_fits`): the leaf's own block at the
    same mesh position."""
    pos, index = plan.blocks[j]
    nd = len(c.shape)
    if pos is None:  # a rank outside the mesh: an empty block
        return v[_broadcast_index(index, c.shape, plan.shape)]
    want = c.sharding.block_coords(pos, nd)
    held = c.sharding.split_local(v, c.shape)
    for (p, _i), b in zip(c.sharding.local_blocks(c.shape), held):
        if c.sharding.block_coords(p, nd) == want:
            return b
    raise KeyError(pos)


def _exchanging_block(e, plan, j, memo):
    """Held block ``j`` of a stencil or scumulative: one node takes every
    held block of its operands (slot-major) and gives them packed; each
    block is a view of it (one held block: the node is the block)."""
    key = (id(e), "blocks")
    node = memo.get(key)
    k = len(plan.blocks) if plan.joint else 1
    shapes = [plan.block_shape(i) for i in range(len(plan.blocks))]
    if node is None:
        which = range(k) if plan.joint else [j]
        args = [_localize(a, plan, i, memo) for a in e.args for i in which]
        out_shape = shapes[j] if k == 1 else (
            sum(math.prod(s) for s in shapes),)
        # the held blocks are the op's to read (``held_positions``), not
        # the static's: every rank's program keeps one fingerprint
        if e.op == "scumulative":
            node = Node("scumulative_block",
                        (e.static, plan.shape, plan.sharding), args,
                        aval=E.Aval(out_shape, e.dtype, False))
        else:
            iters = e.static[5] if e.op == "stencil_iter" else None
            node = Node("stencil_block", (e.static[:5], iters, plan.shape,
                                          plan.sharding),
                        args, aval=E.Aval(out_shape, e.dtype, False))
        if plan.joint:
            memo[key] = node
    if k == 1:
        return node
    off = sum(math.prod(s) for s in shapes[:j])
    return Node("block_view", (off, shapes[j]), [node],
                aval=E.Aval(shapes[j], e.dtype, False))


def held_positions(sharding, shape) -> list:
    """The positions of this rank's blocks of ``shape`` under
    ``sharding``, in grid order (``[None]`` outside the mesh: one empty
    block)."""
    return [p for p, _i in sharding.local_blocks(shape)] or [None]


@E.defop("block_view")
def _op_block_view(static, packed):
    """One block of a packed tensor of several."""
    off, shape = static
    return packed[off:off + math.prod(shape)].view(shape)


@E.defop("tri_block")
def _op_tri_block(static, x):
    """``tril``/``triu`` of a block, its diagonal moved by the block's
    global offset (``k + row start - column start``)."""
    kind, k = static
    fn = torch.tril if kind == "tril" else torch.triu
    return E._unbits(fn(E._bits(x), k), x.dtype)


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
# folds across positions
# ---------------------------------------------------------------------------


def _combine(fname, a, b):
    if fname in ("sum", "mean", "count", "nansum", "count_nonzero"):
        return a + b
    if fname in ("prod", "nanprod"):
        return a * b
    if fname == "any":
        return a | b
    if fname == "all":
        return a & b
    if fname == "nanmin":
        return torch.fmin(a, b)
    if fname == "nanmax":
        return torch.fmax(a, b)
    fn = torch.minimum if fname == "min" else torch.maximum
    w = E._WIDE_UNSIGNED.get(a.dtype)
    if w is not None:  # through the order-preserving signed carrier
        k = fn(E._ukey(E._to_carrier(a), w), E._ukey(E._to_carrier(b), w))
        return E._from_carrier(E._ukey(k, w), a.dtype)
    return fn(a, b)


def chan(a, b):
    """Two ``(count, mean, mean's low part, M2)`` partials of a variance
    as one (Chan, Golub and LeVeque's pairwise update).  The mean is
    carried as an unevaluated sum ``hi + lo``, so the difference of two
    means keeps its digits where the mean is large against the spread
    (``hi - hi`` is exact for close means); a side counting nothing
    leaves the other as it is."""
    na, ha, la, qa = a
    nb, hb, lb, qb = b
    n = na + nb
    nf = n.to(qa.dtype)
    safe = torch.where(n > 0, nf, torch.ones_like(nf))
    wb = nb.to(qa.dtype) / safe
    delta = (hb - ha) + (lb - la)
    step = delta * wb
    hi = ha + step
    lo = la + ((ha - hi) + step)
    # |delta|**2: a complex mean's spread is real, as jnp.var's
    sq = delta.real * delta.real + delta.imag * delta.imag \
        if delta.is_complex() else delta * delta
    m2 = qa + qb + sq * (na.to(qa.dtype) * wb)
    out = []
    for x, y, z in ((ha, hb, hi), (la, lb, lo), (qa, qb, m2)):
        out.append(torch.where(nb == 0, x, torch.where(na == 0, y, z)))
    return (n, *out)


def _pick(want_max, a, b):
    """Two ``(value, index)`` partials of an arg-reduction as one: the
    extreme, a NaN before any number, the first index among equals."""
    va, ia = a
    vb, ib = b
    na, nb = _isnan(va), _isnan(vb)
    better = (vb > va) if want_max else (vb < va)
    tie = (va == vb) | (na & nb)
    take_b = (nb & ~na) | (~na & ~nb & better) | (tie & (ib < ia))
    return torch.where(take_b, vb, va), torch.where(take_b, ib, ia)


def _isnan(v):
    return torch.isnan(v) if v.is_floating_point() else \
        torch.zeros_like(v, dtype=torch.bool)


def _segment_parts(r):
    """``[(kind, torch dtype)]``: the partials of a segment root, each a
    segment reduction of one block (a var's ``(count, mean, M2)``)."""
    from ramba_tpu_torch.groupby import segment_dtype

    xdt = r.xdt
    kind = r.fname
    i64 = torch.int64
    if kind in ("mean", "nanmean"):
        s = E.to_torch_dtype(segment_dtype("nansum" if kind == "nanmean"
                                           else "sum", xdt))
        return [("sum", s), ("count", i64)]
    if kind in _SPREADS:
        f = E.to_torch_dtype(segment_dtype(kind, xdt))
        return [("count", i64), ("mean", f), ("lo", f), ("m2", f)]
    return [(kind, E.to_torch_dtype(segment_dtype(kind, xdt)))]


def _part_specs(plan, r, p) -> list:
    """``[(shape, torch dtype)]`` of position ``p``'s partials of root
    ``r`` (empty where the root folds none)."""
    if r.kind in ("block", "select") or (r.kind in ("axis", "segment")
                             and r.out is not None
                             and not _split_axes(plan, r)):
        return []
    tdt = E.to_torch_dtype(r.dtype)
    box = plan.boxes[p]
    if r.kind == "segment":
        G = int(r.static[1])
        shp = tuple(G if d == r.dim else hi - lo
                    for d, (lo, hi) in enumerate(box))
        return [(shp, dt) for _k, dt in _segment_parts(r)]
    if r.kind == "sreduce":
        return [((), tdt)]
    if r.kind == "reduce":
        shp = ()
    else:
        shp = tuple(1 if d in r.axes else hi - lo
                    for d, (lo, hi) in enumerate(box)
                    if r.keepdims or d not in r.axes)
    i64 = torch.int64
    if r.fname == "nanmean":
        return [(shp, tdt), (shp, i64)]
    if r.fname in _SPREADS:
        return _part_specs_of(r, shp)
    if r.fname in _ARGS:
        return [(shp, E.to_torch_dtype(r.xdt)), (shp, i64)]
    if r.fname == "ptp":
        return [(shp, tdt), (shp, tdt)]
    return [(shp, tdt)]


def _nbytes(shape, dt) -> int:
    return math.prod(shape) * torch.empty((), dtype=dt).element_size()


def _identity(fname, shape, dt, dev):
    if fname in E.NO_IDENTITY:
        raise E.empty_reduction_error(fname)
    fill = {"prod": 1, "nanprod": 1, "all": True}.get(fname, 0)
    return torch.full(shape, fill, dtype=dt, device=dev)


def _folded(plan):
    return [i for i, r in enumerate(plan.roots)
            if r.kind in ("reduce", "sreduce")
            or (r.kind == "segment" and (r.out is None
                                         or _split_axes(plan, r)))
            or (r.kind == "axis" and _split_axes(plan, r))]


def _owned(plan, q, owner_set) -> list:
    """``[(position, block of rank q)]``: the owner positions rank ``q``
    holds, in grid order."""
    mesh = plan.sharding.mesh
    held = plan.sharding.rank_blocks(q, plan.shape)
    coords = [plan.sharding.block_coords(p, len(plan.shape))
              for p, _i in held]
    out = []
    for p in mesh.positions_of(q):
        if p in owner_set:
            out.append((p, coords.index(plan.sharding.block_coords(
                p, len(plan.shape)))))
    return out


def fold(plan, partials):
    """Every folded root's value on this rank: one all-gather of every
    owner position's partials (sizes known on every rank from the
    layout), then folds over the positions in grid order, whichever rank
    holds them, so a world of any size gives the same bytes (``sreduce``:
    the driver reducer's halving fold over the partials in grid order,
    as one process folds its shards).  ``partials[i][j]``: root ``i``'s
    partials of held block ``j``.  Returns ``{root index: [per result
    block: folded partials]}`` (one result block for a whole fold)."""
    from ramba_tpu_torch.skeletons import _tree_reduce, call_kernel

    roots = plan.roots
    world = distributed.process_count()
    me = distributed.process_index()
    folded = _folded(plan)
    if not folded:
        return {}
    dev = E.common.device()
    owner_set = set(plan.owners)
    owned = [_owned(plan, q, owner_set) for q in range(world)]
    sizes = [sum(_nbytes(s, dt) for p, _j in owned[q] for i in folded
                 for s, dt in _part_specs(plan, roots[i], p))
             for q in range(world)]
    mine = [t.to(dt).reshape(-1).view(torch.uint8)
            for p, j in owned[me] for i in folded
            for t, (_s, dt) in zip(partials[i][j],
                                   _part_specs(plan, roots[i], p))]
    buf = torch.cat([m.to(dev) for m in mine]) if mine else \
        torch.empty(0, dtype=torch.uint8, device=dev)
    everyone = distributed.all_gather(buf, [(n,) for n in sizes])
    got = {}  # (root index, position) -> [partials]
    for q in range(world):
        off = 0
        for p, _j in owned[q]:
            for i in folded:
                vals = []
                for shp, dt in _part_specs(plan, roots[i], p):
                    n = _nbytes(shp, dt)
                    vals.append(everyone[q][off:off + n].clone().view(dt)
                                .reshape(shp))
                    off += n
                got[(i, p)] = vals
    out = {}
    for i in folded:
        r = roots[i]
        if r.kind in ("axis", "segment") and r.out is not None:
            osh, oshape = r.out
            blocks = [(_group(plan, r, idx), _mesh.index_shape(idx, oshape))
                      for _p, idx in _out_blocks(osh, oshape)]
        else:
            blocks = [(plan.owners, (int(r.static[1]),)
                       if r.kind == "segment" else ())]
        out[i] = [_fold_group(r, [got[(i, p)] for p in g], shp, dev,
                              _tree_reduce, call_kernel)
                  for g, shp in blocks]
    return out


def _out_blocks(osh, oshape) -> list:
    """This rank's result blocks of a layout (an empty one outside the
    mesh)."""
    me = distributed.process_index()
    return osh.rank_blocks(me, oshape) or [(None, osh.rank_index(me,
                                                                 oshape))]


def _fold_group(r, vals, shape, dev, _tree_reduce, call_kernel):
    """The partials ``vals`` of one result block (of ``shape``), in grid
    order, folded."""
    if r.kind == "sreduce":
        _w, across, identity, _s = r.static
        tdt = E.to_torch_dtype(r.dtype)
        ident = E.as_tensor(identity, r.dtype, dev)
        stacked = torch.stack([v[0] for v in vals]) if vals \
            else ident.reshape(1)
        return [_tree_reduce(stacked, ident,
                             lambda a, b: call_kernel(across, a, b)).to(tdt)]
    if not vals:  # nothing held anywhere: the identity
        if r.kind == "segment":
            return [torch.zeros(shape, dtype=dt, device=dev)
                    for _k, dt in _segment_parts(r)]
        if r.fname in _SPREADS:
            return [torch.zeros(shape, dtype=dt, device=dev)
                    for _s, dt in _part_specs_of(r, shape)]
        if r.fname == "nanmean":
            return [torch.zeros(shape, dtype=E.to_torch_dtype(r.dtype),
                                device=dev),
                    torch.zeros(shape, dtype=torch.int64, device=dev)]
        return [_identity(r.fname, shape, E.to_torch_dtype(r.dtype), dev)]
    acc = list(vals[0])
    for v in vals[1:]:
        acc = _combine_parts(r, acc, v)
    return acc


def _part_specs_of(r, shp):
    """A var/std's partials: ``(count, mean hi, mean lo, M2)``, the mean
    complex for complex values (its M2 real)."""
    f = E.to_torch_dtype(r.dtype)
    m = E.to_torch_dtype(r.xdt) if r.xdt.kind == "c" else f
    return [(shp, torch.int64), (shp, m), (shp, m), (shp, f)]


def _combine_parts(r, a, b):
    kind = r.fname
    if kind in _SPREADS:
        return list(chan(a, b))
    if kind in _ARGS:
        return list(_pick(kind == "argmax", a, b))
    if kind == "ptp":
        return [_combine("max", a[0], b[0]), _combine("min", a[1], b[1])]
    if kind in ("mean", "nanmean") and len(a) == 2:
        return [a[0] + b[0], a[1] + b[1]]
    return [_combine(kind, a[0], b[0])]


def _segment_finish(r, parts):
    """A segment root's result from its folded partials, as the generic
    lowering finishes it (``groupby._op_segment_reduce``)."""
    from ramba_tpu_torch.groupby import segment_dtype

    kind, xdt = r.fname, r.xdt
    if kind in ("mean", "nanmean"):
        cnt = parts[1].to(E.to_torch_dtype(E.reduce_dtype("sum", xdt)))
        return E.apply_map("true_divide", [parts[0], cnt])
    if kind in _SPREADS:
        cnt, _hi, _lo, m2 = parts
        out = E.apply_map("true_divide", [m2, cnt.to(m2.dtype)])
        if kind in ("std", "nanstd"):
            out = E.apply_map("sqrt", [out])
        return out.to(E.to_torch_dtype(segment_dtype(kind, xdt)))
    return parts[0]


def _fold_finish(plan, r, parts):
    """A reduce/axis root's result from its folded partials."""
    if r.fname == "mean":
        n = math.prod(plan.shape[d] for d in r.axes)
        v = parts[0]
        return v / torch.tensor(n, dtype=v.dtype, device=v.device)
    if r.fname == "nanmean":
        s, cnt = parts
        return s / cnt.to(s.dtype)
    if r.fname in _SPREADS:
        cnt, _hi, _lo, m2 = parts
        n = cnt - int(r.ddof or 0)
        bad = n <= 0
        s = torch.where(bad, torch.full_like(m2, float("nan")), m2)
        v = s / torch.where(bad, torch.ones_like(n), n).to(s.dtype)
        return E.apply_map("sqrt", [v]) if r.fname.endswith("std") else v
    if r.fname in _ARGS:
        return parts[1]
    if r.fname == "ptp":  # in the input dtype: an integer's wraps
        return E.apply_map("subtract", parts)
    return parts[0]


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
    for q in range(len(parts)):
        for (_pos, idx), b in zip(sh.rank_blocks(q, shape),
                                  sh.split_held(parts[q], q, shape)):
            out[idx] = b
    return out


def _block_const(val, mesh, hint=None) -> Const:
    """A result every rank computed whole, cut to this rank's blocks of
    its layout (the sharding hint's, else the default)."""
    if not isinstance(val, torch.Tensor):
        return Const(val)
    sh = hint if hint is not None and hint.mesh == mesh else \
        _mesh.NamedSharding(mesh, _mesh.default_spec(val.shape, mesh))
    if not any(_mesh.entry_names(e) for e in sh.spec):
        return Const(val, sharding=sh)
    shape = tuple(val.shape)
    held = sh.local_blocks(shape)
    if not held:
        v = val[sh.local_index(shape)].clone()
    else:
        v = _mesh.pack([val[idx] for _p, idx in held]).clone()
    return Const(v, sharding=sh, shape=shape)


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


def _rebuild(exprs, fn, orig=False):
    """``exprs`` with every node ``fn`` replaces (``fn(node)``, or
    ``fn(node, original node)`` with ``orig``: a new expression, or None
    to keep it; parents rebuilt bottom-up).  A node's replacement is
    dropped once every parent is rebuilt, so the values a pass computes
    (a sweep's boxes and blocks) live no longer than their readers."""
    uses: dict = {}  # id(node) -> its parents not yet rebuilt
    stack, seen = list(exprs), set()
    while stack:
        e = stack.pop()
        if id(e) in seen or not isinstance(e, Node):
            continue
        seen.add(id(e))
        for a in e.args:
            uses[id(a)] = uses.get(id(a), 0) + 1
            stack.append(a)
    keep = {id(e) for e in exprs}
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
            new = fn(cand, e) if orig else fn(cand)
            memo[id(e)] = cand if new is None else new
            del args, cand, new
            for a in e.args:
                uses[id(a)] -= 1
                if not uses[id(a)] and id(a) not in keep:
                    memo.pop(id(a), None)
        out.append(memo[id(root)])
    return out


def _block_specs(e) -> set:
    """The layouts of the block leaves under ``e``."""
    specs, stack, seen = set(), [e], set()
    while stack:
        x = stack.pop()
        if id(x) in seen:
            continue
        seen.add(id(x))
        if isinstance(x, Const) and x.is_block:
            specs.add(tuple(_mesh.canonical(x.sharding.spec)))
        elif isinstance(x, Node) and x.op not in CREATION:
            stack.extend(x.args)
    return specs


def lower_hints(exprs, mesh, wd=None):
    """Every ``shard_hint`` over a leaf becomes the leaf under that layout:
    a reshard where the layouts differ (collectives: every rank runs the
    same ones, in graph order).  A hint over a computed value whose
    subtree is shard-local in the layout of its block leaves runs that
    subtree as a plan of its own (:func:`local_plan`; its result a block
    leaf in that layout), then reshards the result; a subtree that is not
    shard-local keeps its hint (the program takes the gathered
    lowering)."""
    from ramba_tpu_torch.parallel.reshard import reshard_value

    def lower(e):
        if e.op != "shard_hint" or e.static[0].mesh != mesh:
            return None
        src, want = e.args[0], _mesh.canonical(e.static[0].spec)
        if isinstance(src, Const):
            return reshard_value(src, e.static[0].spec, mesh=mesh)
        specs = _block_specs(src)
        if not isinstance(src, Node) or len(specs) != 1 \
                or list(specs)[0] == tuple(want):
            return None
        plan = local_plan([src], mesh)
        if plan is None or plan.roots[0].kind != "block":
            return None
        outs, _n = _run_local(plan, False, wd)
        (c,) = _finish_local(plan, outs)
        return reshard_value(c, e.static[0].spec, mesh=mesh)

    return _rebuild(exprs, lower)


def _dot_operand(e, mesh):
    """``(layout, plan)`` of a contraction's operand: a leaf's own layout
    (replicated for a value every rank holds whole) and no plan, or the
    shard-local plan of a subtree, to run first; None where the operand
    is neither (the contraction takes the gathered lowering)."""
    if isinstance(e, Const):
        if not e.shape:
            return None
        if e.is_block:
            return (e.sharding, None) if e.sharding.mesh == mesh else None
        return _mesh.NamedSharding(mesh, _mesh.P()), None
    if not isinstance(e, Node):
        return None
    plan = local_plan([e], mesh)
    if plan is None or plan.roots[0].kind != "block":
        return None
    return plan.sharding, plan


def _contract(con, consts, wd):
    """One contraction through :mod:`core.rankdot` down the ladder, its
    operands pinned against spilling: one ``memory:admit`` round (room
    made first for the bytes it may hold), then each attempt opens its
    gate before any launch and runs the contraction's rounds inside it
    (a failure joins the next round)."""
    from ramba_tpu_torch.core import fuser, rankdot
    from ramba_tpu_torch.core.fuser import leaf_value
    from ramba_tpu_torch.resilience import memory

    values = [leaf_value(c) for c in consts]
    me = distributed.process_index()

    def prepare():
        memory.reserve_headroom(con.bound_bytes(me), site="rankdot")

    def run(_rung):
        gate = fuser.launch_gate.get()
        if gate is not None:
            gate()
        return rankdot.contract(con, values)

    pins = memory.ledger.pin_values(values)
    try:
        return _laddered(run, False, _admission(prepare), wd)
    finally:
        memory.ledger.unpin(pins)


def _lower_contraction(e, mesh, wd):
    """A contraction :mod:`core.rankdot` takes (matmul, dot, tensordot,
    inner, two-operand einsum), run partitioned: its result, a block leaf
    in GSPMD's layout, or None where it is not taken.  Whether it is
    taken is read from the graph and the leaves' layouts only (the same
    on every rank): each operand a leaf or a shard-local subtree (run
    first as a plan of its own)."""
    from ramba_tpu_torch.core import rankdot

    if e.op not in rankdot.OPS or rankdot.form(e) is None:
        return None
    ops = [_dot_operand(x, mesh) for x in e.args]
    if None in ops:
        return None
    con = rankdot.plan(e, *[(tuple(x.shape), sh)
                            for x, (sh, _p) in zip(e.args, ops)], mesh)
    if con is None:
        return None
    consts = []
    for x, (_sh, plan) in zip(e.args, ops):
        if plan is None:
            consts.append(x)
        else:
            outs, _n = _run_local(plan, False, wd)
            consts.append(_finish_local(plan, outs)[0])
    return _contract(con, consts, wd)


def _move_arrays(e):
    """The indices of a movement node's array operands, or None where
    the node is not taken (a pad whose fill is an array)."""
    if e.op in ("concatenate", "stack"):
        return list(range(len(e.args)))
    if e.op == "setitem":
        return [0] if isinstance(e.args[1], Scalar) else [0, 1]
    if e.op == "pad" and len(e.args) > 1 and not (
            isinstance(e.args[1], Scalar) or (isinstance(e.args[1], Const)
                                              and not e.args[1].is_block
                                              and e.args[1].shape == ())):
        return None
    return [0]


def _move_operands(e, idx, mesh, wd):
    """A movement's array operands as leaves: a leaf as it is, a subtree
    that the rank flush takes without gathering run first as a plan of
    its own; None where one is neither (nothing runs)."""
    plans = []
    for i in idx:
        x = e.args[i]
        if isinstance(x, Const):
            if x.is_block and x.sharding.mesh != mesh:
                return None
            plans.append(None)
        elif isinstance(x, Node):
            p = local_plan([x], mesh)
            if p is None:
                return None
            plans.append(p)
        else:
            return None
    out = []
    for i, p in zip(idx, plans):
        if p is None:
            out.append(e.args[i])
        else:
            outs, _n = _run_local(p, False, wd)
            out.append(_finish_local(p, outs)[0])
    return out


def _layout(c, mesh):
    """A leaf's layout: its own, or replicated for a value every rank
    holds whole."""
    return c.sharding if c.is_block else _mesh.NamedSharding(mesh,
                                                             _mesh.P())


def _full_layout(e, shape, mesh):
    """The layout a shard-local plan of ``e`` takes: its first
    full-shape block leaf's (or hint's) reached through full-shape
    elementwise nodes, replicated where only replicated blocks are
    there, else the default."""
    stack, seen, whole = [e], set(), False
    while stack:
        x = stack.pop()
        if id(x) in seen:
            continue
        seen.add(id(x))
        if isinstance(x, Const) and x.is_block and x.shape == shape:
            c = _mesh.canonical(x.sharding.spec)
            if c:
                return x.sharding
            whole = True
        elif isinstance(x, Node) and x.shape == shape:
            if x.op == "shard_hint":
                return x.static[0]
            if x.op in ELEMENTWISE:
                stack.extend(x.args)
    return _mesh.NamedSharding(mesh, _mesh.P() if whole else
                               _mesh.default_spec(shape, mesh))


def _align_broadcast(e, mesh):
    """An elementwise node whose block operands of a broadcasting shape
    split dims the way its layout does not (:func:`_fits`): each such
    operand resharded first, to the node's entries on the dims it has at
    full length (GSPMD moves it too)."""
    from ramba_tpu_torch.parallel.reshard import reshard_value

    shape = tuple(e.shape)
    bad = [i for i, a in enumerate(e.args)
           if isinstance(a, Const) and a.is_block and a.shape not in (
               (), shape) and a.sharding.mesh == mesh
           and _broadcasts(a.shape, shape)]
    if not bad:
        return None
    target = _full_layout(e, shape, mesh)
    args = list(e.args)
    names = _entries(target, len(shape))
    changed = False
    for i in bad:
        a = args[i]
        if _fits(a, target, shape):
            continue
        lead = len(shape) - len(a.shape)
        want = [names[d + lead] if n == shape[d + lead] else ()
                for d, n in enumerate(a.shape)]
        args[i] = reshard_value(a, _mesh.P(*_mesh.canonical(
            [None if not w else w[0] if len(w) == 1 else tuple(w)
             for w in want])), mesh=mesh)
        changed = True
    return Node(e.op, e.static, args, aval=e.aval) if changed else None


def _isolated(e, mesh, wd):
    """An index (a gather, a scatter, a take) over leaves, some of them
    blocks, inside a larger program: run on the gathered lowering as a
    program of its own (counted), its result cut to the default layout,
    so what lies above it stays partitioned.  None where its operands
    are not all leaves."""
    if not all(isinstance(a, (Const, Scalar)) for a in e.args) or not any(
            isinstance(a, Const) and a.is_block for a in e.args):
        return None
    outs, _n = _run_whole([e], False, wd)
    return _block_const(outs[0], mesh)


def _folds_first(e, mesh, wd):
    """An elementwise node whose operands include a fold (a reduction,
    whole or along axes, a groupby, a selection) that the rank flush
    takes: each such fold run first as a plan of its own, its result a
    leaf (``x - x.mean()``, ``sums / counts[:, None]``); None where there
    is none."""
    args = list(e.args)
    changed = False
    for i, a in enumerate(args):
        if not (isinstance(a, Node) and a.op in FOLD_OPS):
            continue
        plan = local_plan([a], mesh)
        if plan is None or plan.roots[0].kind == "block":
            continue
        outs, _n = _run_local(plan, False, wd)
        args[i] = _finish_local(plan, outs)[0]
        changed = True
    return Node(e.op, e.static, args, aval=e.aval) if changed else None


def _move(group, consts, wd):
    """A group of movements through :mod:`core.rankmove` down the
    ladder, their operands pinned against spilling: one ``memory:admit``
    round (room made first for the bytes it may hold), then each attempt
    opens its gate before any launch and runs the group's rounds inside
    it."""
    from ramba_tpu_torch.core import fuser, rankmove
    from ramba_tpu_torch.core.fuser import leaf_value
    from ramba_tpu_torch.resilience import memory

    values = [leaf_value(c) for c in consts]
    me = distributed.process_index()

    def prepare():
        memory.reserve_headroom(group.bound_bytes(me), site="rankmove")

    def run(_rung):
        gate = fuser.launch_gate.get()
        if gate is not None:
            gate()
        return rankmove.move(group, values)

    pins = memory.ledger.pin_values(values)
    try:
        return _laddered(run, False, _admission(prepare), wd)
    finally:
        memory.ledger.unpin(pins)


def lower_movements(exprs, mesh, wd=None):
    """Every movement :mod:`core.rankmove` takes (a basic getitem or
    setitem, permute, reshape, broadcast_to, flip, pad, concatenate and
    stack of operands of one layout) becomes its result: a block leaf in
    GSPMD's layout, moved box by box across the ranks; every contraction
    :func:`_lower_contraction` takes, in the same bottom-up pass, so each
    may be the other's operand.  An operand is a leaf or a subtree that
    the rank flush takes without gathering (run first as a plan of its
    own).  The reads of one operand (its slices, flips, transposes,
    broadcasts, pads and reshapes in the program) run as one group: one
    exchange, and the boxes they need merged (``rankmove.Group``).  An
    elementwise node whose block operand of a broadcasting shape splits
    its dims otherwise reshards that operand first.  What is not taken
    keeps its node, and its program takes the gathered lowering.  Every
    decision reads the graph and the leaves' layouts only, the same on
    every rank.  A ``shard_hint`` over a contraction's or a movement's
    result reshards it."""
    from ramba_tpu_torch.core import rankmove
    from ramba_tpu_torch.parallel.reshard import reshard_value

    readers: dict = {}  # id(operand) -> the original reads of it
    stack, seen = list(exprs), set()
    while stack:
        x = stack.pop()
        if id(x) in seen or not isinstance(x, Node):
            continue
        seen.add(id(x))
        if x.op in rankmove.READS:
            readers.setdefault(id(x.args[0]), []).append(x)
        stack.extend(x.args)
    done: dict = {}  # id(original read) -> its result, lowered in a group
    made = set()
    roots = {id(e) for e in exprs}

    def lower(e, orig):
        if e.op == "shard_hint" and id(e.args[0]) in made \
                and e.static[0].mesh == mesh:
            return reshard_value(e.args[0], e.static[0].spec, mesh=mesh)
        if id(orig) in done:
            return done.pop(id(orig))
        if e.op in INDEXING and id(orig) not in roots:
            return _isolated(e, mesh, wd)
        out = _lower_contraction(e, mesh, wd)
        if out is None and e.op in rankmove.OPS:
            out = _lower_move(e, orig, mesh, wd, readers, done)
        if out is None and e.op in ELEMENTWISE:
            folded = _folds_first(e, mesh, wd)
            return _align_broadcast(folded or e, mesh) or folded
        if isinstance(out, Const):
            made.add(id(out))
        return out

    return _rebuild(exprs, lower, orig=True)


def _lower_move(e, orig, mesh, wd, readers, done):
    """A movement and the other reads of its operand, run as one group
    (one movement for reads that are the same read, as a loop's slices of
    an array it does not write); its result leaf, its node over leaves
    where its operands ran but the op is not taken, or None."""
    from ramba_tpu_torch.core import rankmove

    idx = _move_arrays(e)
    if idx is None:
        return None
    consts = _move_operands(e, idx, mesh, wd)
    if consts is None:
        return None
    args = list(e.args)
    for i, c in zip(idx, consts):
        args[i] = c
    node = Node(e.op, e.static, args, aval=e.aval)
    layouts = [_layout(c, mesh) for c in consts]
    spec = rankmove.result_spec(node, layouts)
    if spec is None:
        return node if any(c is not a for c, a in zip(args, e.args)) \
            else None
    operands = [rankmove.Operand(c.shape, sh, E.to_torch_dtype(c.dtype))
                for c, sh in zip(consts, layouts)]

    def same(n):  # reads that are one read share one result
        return n.op, n.static, tuple(id(a) for a in n.args[1:])

    nodes, index, sibs = [node], {same(node): 0}, []
    if e.op in rankmove.READS:
        for sib in readers.get(id(orig.args[0]), []):
            if sib is orig or id(sib) in done or (
                    sib.op == "pad" and _move_arrays(sib) is None):
                continue
            n = Node(sib.op, sib.static, [consts[0]] + list(sib.args[1:]),
                     aval=sib.aval)
            if same(n) not in index:
                if rankmove.result_spec(n, layouts) is None:
                    continue
                index[same(n)] = len(nodes)
                nodes.append(n)
            sibs.append((sib, index[same(n)]))
    moves = []
    for n in nodes:
        tdt = E.to_torch_dtype(n.dtype)
        scalar = n.args[1].value if n.op == "setitem" and isinstance(
            n.args[1], Scalar) else None
        osh = _mesh.NamedSharding(mesh, rankmove.result_spec(n, layouts))
        moves.append(rankmove.Move(rankmove.op_of(n, tdt, scalar), n.shape,
                                   osh, tdt, list(range(len(consts)))))
    outs = _move(rankmove.Group(moves, operands, mesh), consts, wd)
    for o, i in sibs:
        done[id(o)] = outs[i]
    return outs[0]


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
            exprs = lower_hints(exprs, mesh, wd)
            exprs = lower_movements(exprs, mesh, wd)
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
    fuser._registry.inc("fuser.flushes")
    fuser._registry.inc("fuser.nodes_flushed", n_instrs)
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


def _value(e, split=False, rung="fused"):
    """A local expression's value: a leaf's, or its one-root program's."""
    from ramba_tpu_torch.core import fuser

    if isinstance(e, Const):
        return fuser.leaf_value(e)
    program, leaf_vals = fuser.prepare_program([e])
    return _execute(program, leaf_vals, split, rung)[0]


def _run_segment(r, j, split=False, rung="fused"):
    """A segment root's partials of held block ``j``: one one-instruction
    program per partial (on the card, 1-D data takes the segred kernel:
    the nan kinds with the NaNs' labels moved out of range; a var's
    count, sum, then the segment sum of its centred squares)."""
    from ramba_tpu_torch.groupby import centred, segment_dtype

    data = _value(r.exprs[j], split, rung)
    labels = _value(r.labels[j], split, rung)
    G, dim = int(r.static[1]), r.dim
    kind = r.fname
    nan = kind.startswith("nan") and data.is_floating_point()
    base = kind[3:] if kind.startswith("nan") else kind
    valid = ~torch.isnan(data) if nan else None

    def seg(k, x, lab=labels):
        node = Node("segment_reduce", (k, G, dim), [Const(x), Const(lab)])
        return _value(node, split, rung)

    def clean(x):
        return x if valid is None else torch.where(
            valid, x, torch.zeros((), dtype=x.dtype, device=x.device))

    def count():
        if valid is None:
            return seg("count", data)
        if data.ndim == 1:  # the NaNs' labels read no group
            return seg("count", data, torch.where(
                valid, labels, torch.full_like(labels, -1)))
        return seg("sum", valid.to(torch.int64))

    if base in ("sum", "prod", "min", "max", "count"):
        return [seg(base, clean(data))]
    if base == "mean":
        return [seg("sum", clean(data)), count()]
    fdt = E.to_torch_dtype(segment_dtype(kind, r.xdt))
    xf = clean(data.to(fdt))
    cnt = count()
    mean = E.apply_map("true_divide", [seg("sum", xf), cnt.to(fdt)])
    d = centred(xf.movedim(dim, 0), mean.movedim(dim, 0), labels,
                None if valid is None else valid.movedim(dim, 0))
    return [cnt, mean] + _centred_parts(
        seg("sum", d.movedim(0, dim).contiguous()),
        seg("sum", (d * d).movedim(0, dim).contiguous()), cnt)


def _partials(plan, r, j, raw, split=False, rung="fused"):
    """A reduce/axis root's partials of held block ``j`` from its main
    program's values ``raw``: a var's ``(count, mean, M2)`` (M2 from a
    centred pass over the block, a program of its own that elemred takes
    for a whole fold), an arg-reduction's ``(extreme, global index)``."""
    from ramba_tpu_torch.core import fuser

    bshape = plan.block_shape(j)
    starts = [sl.indices(n)[0] for sl, n in zip(plan.blocks[j][1],
                                                plan.shape)]
    if r.fname in _SPREADS:
        s = raw[0]
        ok = None
        if r.fname.startswith("nan"):  # the non-NaN values only
            cnt = raw[1]
            mean = s / torch.where(cnt > 0, cnt, torch.ones_like(cnt)).to(
                s.dtype)
            ok, xf = r.exprs[j][0].args[0].args[:2]
        else:
            n = math.prod(bshape[d] for d in r.axes)
            cnt = torch.full(s.shape, n, dtype=torch.int64, device=s.device)
            mean = s / torch.tensor(n, dtype=s.dtype, device=s.device)
            xf = r.exprs[j][0].args[0]
        kshape = tuple(1 if d in r.axes else bshape[d]
                       for d in range(len(bshape)))
        m = mean if r.kind == "reduce" else mean.reshape(kshape)
        d = Node("map", ("subtract",), [xf, Const(m)])
        if ok is not None:
            d = Node("map", ("where",), [ok, d, Scalar(0)])
        if xf.dtype.kind == "c":  # |d|**2, real
            re, im = (Node("map", (f,), [d]) for f in ("real", "imag"))
            sq = Node("map", ("add",), [Node("map", ("multiply",), [re, re]),
                                        Node("map", ("multiply",), [im, im])])
        else:
            sq = Node("map", ("multiply",), [d, d])
        axis = None if r.kind == "reduce" else r.axes
        sums = []
        for term in (d, sq):
            # one program each: elemred takes each whole fold
            e = Node("reduce", ("sum", axis, bool(r.keepdims), None), [term])
            flat = _flattened([e], bshape) if r.kind == "reduce" else None
            program, leaf_vals = fuser.prepare_program(flat or [e])
            sums.append(_execute(program, leaf_vals, split, rung)[0])
        return [cnt, mean] + _centred_parts(sums[0], sums[1], cnt)
    if r.fname in _ARGS:
        val, idx = raw
        if r.kind == "axis":
            return [val, idx + starts[r.axes[0]]]
        out = torch.zeros_like(idx)
        rem = idx
        stride = 1
        for dd in range(len(bshape) - 1, -1, -1):
            out = out + (rem % bshape[dd] + starts[dd]) * stride
            rem = rem // bshape[dd]
            stride *= plan.shape[dd]
        return [val, out]
    return list(raw)


def _centred_parts(s1, s2, cnt):
    """``[mean's low part, M2]`` of a block from the sums of its
    deviations ``d = x - hi`` from the rounded mean ``hi`` and of their
    squares: ``lo = sum(d) / n`` and ``M2 = sum(d**2) - n lo**2``."""
    n = torch.where(cnt > 0, cnt, torch.ones_like(cnt)).to(s1.dtype)
    lo = s1 / n
    if lo.is_complex():  # n |lo|**2 = re(s1 conj(lo))
        return [lo, s2 - (s1 * lo.conj()).real]
    return [lo, s2 - s1 * lo]


def _run_local(plan, split=False, wd=None):
    """Run the plan's programs on this rank's blocks, down the ladder:
    ``(values, number of instructions)``, per root a value per held block
    (None where nothing ran; a list of partials for a fold).  Each held
    block runs its own program (an elementwise program with whole folds
    on its block flattened, so elemred takes it), and where the blocks
    exchange (a stencil's halos, a scan's carries) one program runs them
    all; the ladder's rounds are the plan's, once a rank."""
    k = len(plan.blocks)
    groups = [list(range(k))] if plan.joint else [[j] for j in range(k)]

    selects = [i for i, r in enumerate(plan.roots)
               if r.kind == "select" and not r.local]

    def items(g):
        out = []
        for i, r in enumerate(plan.roots):
            if r.kind == "segment" or i in selects:
                continue
            for j in g:
                e = r.exprs[j]
                if e is None:
                    continue
                parts = e if r.kind in ("reduce", "axis") else [e]
                out.extend((i, j, q, x) for q, x in enumerate(parts))
        return out

    work = [items(g) for g in groups]
    prepared = {}

    def prep(gi):
        from ramba_tpu_torch.core import fuser

        if gi not in prepared:
            exprs = [x for *_k, x in work[gi]]
            flat = None if plan.joint else _flattened(
                exprs, plan.block_shape(groups[gi][0]))
            prepared[gi] = fuser.prepare_program(flat or exprs)
        return prepared[gi]

    def prepare():  # admission reads the first program
        return next((prep(gi) for gi, its in enumerate(work) if its), None)

    def run(rung):
        if selects:
            # the selections' rounds are collectives inside the attempt:
            # every rank opens its gate here, before any launch, and a
            # failure from here on joins the first selection's census
            from ramba_tpu_torch.core import fuser

            gate = fuser.launch_gate.get()
            if gate is not None:
                gate()
        err = None
        try:
            outs, n_instrs = blocks(rung)
        except Exception as e:
            if not selects:
                raise
            err, outs, n_instrs = e, None, 0
        for i in selects:
            got = _run_select(plan, plan.roots[i], split, rung, err)
            outs[i] = got
        return outs, n_instrs

    def blocks(rung):
        raw = {}
        n_instrs = 0
        for gi, its in enumerate(work):
            if not its:
                continue
            program, leaf_vals = prep(gi)
            vals = _execute(program, leaf_vals, split, rung)
            n_instrs += len(program.instrs)
            for (i, j, q, _x), v in zip(its, vals):
                raw[(i, j, q)] = v
        outs = [[None] * k for _ in plan.roots]
        for i, r in enumerate(plan.roots):
            for j in range(k):
                if r.exprs[j] is None or i in selects:
                    continue
                if r.kind == "block":
                    outs[i][j] = raw[(i, j, 0)].reshape(plan.block_shape(j))
                elif r.kind == "select":  # its block's own result
                    outs[i][j] = raw[(i, j, 0)]
                elif r.kind == "segment":
                    outs[i][j] = _run_segment(r, j, split, rung)
                    n_instrs += len(outs[i][j])
                elif r.kind == "sreduce":
                    outs[i][j] = [raw[(i, j, 0)]]
                else:
                    outs[i][j] = _partials(
                        plan, r, j, [raw[(i, j, q)]
                                     for q in range(len(r.exprs[j]))],
                        split, rung)
        return outs, n_instrs

    return _laddered(run, split, _admission(prepare), wd)


def _select_dtype(r):
    """The dtype a select root orders (its operand cast as one process
    casts it): the medians' and quantiles' inexact dtype, a complex
    extreme's own."""
    if r.fname == "quantile":
        from ramba_tpu_torch.ops.extras import inexact

        return E.to_torch_dtype(inexact(r.xdt))
    if r.fname in SELECTS:
        return E.to_torch_dtype(E.reduce_dtype(r.fname, r.xdt))
    return E.to_torch_dtype(r.xdt)


def _run_select(plan, r, split=False, rung="fused", err=None):
    """A select root that a split axis spreads over positions: every
    owner position's block (this rank's computed here, cast and laid out
    with the reduced dims last), then ``core/rankselect.py``'s rounds,
    then the one-process finish on this rank's device.  ``err``: this
    rank already failed (every rank raises at the first round).  Returns
    the whole result on every rank."""
    from ramba_tpu_torch.core import rankselect

    shape = plan.shape
    nd = len(shape)
    axes = tuple(r.axes)
    kept = [d for d in range(nd) if d not in axes]
    gsizes = [shape[d] for d in axes]
    kshape = tuple(shape[d] for d in kept)
    nslices = math.prod(kshape)
    mesh = plan.sharding.mesh
    me = distributed.process_index()
    tdt = _select_dtype(r)
    dev = E.common.device()
    parts = []
    for p in plan.owners:
        box = plan.boxes[p]
        rows = torch.zeros((), dtype=torch.int64)
        for d in kept:
            lo, hi = box[d]
            rows = rows.unsqueeze(-1) * shape[d] + torch.arange(lo, hi)
        rows = rows.reshape(-1)
        part = rankselect.Part(rows, [box[d][0] for d in axes],
                               [box[d][1] - box[d][0] for d in axes],
                               mesh.rank_at(p))
        if part.rank == me and err is None:
            try:
                v = E.convert(_value(r.exprs[plan.local_block(p)], split,
                                     rung), tdt)
                part.values = v.permute(*kept, *axes).reshape(len(rows), -1)
            except Exception as e:  # joins the first round, then raises
                err = e
        parts.append(part)
    keep_shape = tuple(1 if d in axes else shape[d] for d in range(nd)) \
        if r.keepdims else kshape
    if r.fname in COMPLEX_SELECTS:
        got = {}
        for want_max in ((True, False) if r.fname == "ptp"
                         else (r.fname == "max",)):
            got[want_max] = rankselect.extreme(
                parts, nslices, gsizes, want_max, tdt, err).to(dev)
        res = E.apply_map("subtract", [got[True], got[False]]) \
            if r.fname == "ptp" else got[r.fname == "max"]
        return res.reshape(keep_shape)
    L = math.prod(gsizes)
    if r.fname != "quantile":
        skip_nan = r.fname == "nanmedian"

        def positions(valid):
            if skip_nan:
                return torch.stack(E.median_positions(L, valid))
            lo, hi = E.median_positions(L)
            return torch.tensor([[lo], [hi]]).expand(2, len(valid))

        vals, _n = rankselect.select(parts, nslices, gsizes, skip_nan,
                                     positions, tdt, err)
        low, high = vals.to(dev).unbind(0)
        return E.median_finish(low, high).reshape(keep_shape)
    from ramba_tpu_torch.core.fuser import leaf_value
    from ramba_tpu_torch.ops import extras

    kw = dict(r.node.static[1])
    q = r.node.args[1]
    qv = E.as_tensor(q.value) if isinstance(q, Scalar) else leaf_value(q)
    qshape = tuple(qv.shape)
    nan = kw["nan"]
    static_count = not nan or r.xdt.kind != "f"

    def weights(valid, where):
        qb = qv.to(where).reshape(qshape + (1,))
        top = valid.to(where, qv.dtype) - 1 if nan else torch.full(
            (), L - 1.0, dtype=qv.dtype, device=where)
        return extras.quantile_positions(qb, float(L), top, kw["percent"],
                                         static_count)

    seen = {}

    def positions(valid):
        seen["valid"] = valid
        low, high, _lw, _hw = weights(valid, "cpu")
        return torch.cat([x.expand(qshape + (nslices,)).reshape(-1, nslices)
                          for x in (low, high)])

    vals, _n = rankselect.select(parts, nslices, gsizes,
                                 nan and r.xdt.kind == "f", positions, tdt,
                                 err)
    nq = vals.shape[0] // 2
    lv, hv = (v.reshape(qshape + (nslices,)).to(dev)
              for v in (vals[:nq], vals[nq:]))
    _lo, _hi, lw, hw = weights(seen["valid"], dev)
    res = extras.quantile_finish(lv, hv, lw, hw, kw["method"], tdt)
    res = res.reshape(qshape + kshape)
    return extras.quantile_shape(qshape, shape, kw.get("axis"),
                                 kw["keepdims"], res)


def _finish_local(plan, outs):
    """Block results become block leaves (several held blocks packed);
    reductions fold across positions."""
    folded = fold(plan, outs)
    dev = E.common.device()
    consts = []

    def local(r, i, osh, oshape, finish):
        """A root whose result blocks are its held blocks' own."""
        vals = []
        for p, idx in _out_blocks(osh, oshape):
            got = None if p is None else outs[i][plan.local_block(p)]
            vals.append(torch.empty(_mesh.index_shape(idx, oshape),
                                    dtype=E.to_torch_dtype(r.dtype),
                                    device=dev)
                        if got is None else finish(got))
        return vals

    for i, r in enumerate(plan.roots):
        if r.kind == "block":
            vs = [torch.empty(plan.block_shape(j),
                              dtype=E.to_torch_dtype(r.dtype), device=dev)
                  if v is None else v for j, v in enumerate(outs[i])]
            consts.append(Const(_mesh.pack(vs), sharding=plan.sharding,
                                shape=plan.shape))
            continue
        if r.kind == "segment" and r.out is None:
            consts.append(Const(_segment_finish(r, folded[i][0])))
            continue
        if r.kind == "select" and not r.local:
            osh, oshape = r.out
            v = outs[i]
            consts.append(_block_const(v, plan.sharding.mesh, osh)
                          if v.ndim else Const(v))
            continue
        if r.kind == "select":
            osh, oshape = r.out
            vals = local(r, i, osh, oshape, lambda v: v)
            consts.append(Const(_mesh.pack(vals), sharding=osh,
                                shape=oshape) if oshape else
                          Const(vals[0]))
            continue
        if r.kind in ("axis", "segment"):
            osh, oshape = r.out

            def finish(parts, r=r):
                return _segment_finish(r, parts) if r.kind == "segment" \
                    else _fold_finish(plan, r, parts)

            if i in folded:
                vals = [finish(f) for f in folded[i]]
            else:
                vals = local(r, i, osh, oshape, finish)
            consts.append(Const(_mesh.pack(vals), sharding=osh,
                                shape=oshape))
            continue
        if r.kind == "sreduce":
            consts.append(Const(folded[i][0][0]))
            continue
        consts.append(Const(_fold_finish(plan, r, folded[i][0])))
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
