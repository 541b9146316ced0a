"""A flush on a mesh of ranks: every rank runs the program on its blocks.

Every rank runs the same program (SPMD), and each realized array holds
only the rank's block (``Const.is_block``).  Before anything runs, the
flush sorts the program into one of three cases, the same on every rank
because it reads only the graph and the leaves' layouts:

* **shard-local** (:func:`local_plan`): every array leaf has the same
  global shape and the same layout (a block of it, a value every rank
  holds whole and cuts its block from, or a creation node that builds the
  block from global indices: ``arange``, ``full``, ``linspace``,
  ``fromfunction``), every instruction is elementwise (map, cast, round,
  ``masked_fill``, ``smap`` and ``smap_index``, whose kernel sees global
  indices) or a stencil or ``scumulative``, and a root may end in a
  whole-array ``sum``/``prod``/``min``/``max``/``mean`` or an
  ``sreduce``.  The program runs on the rank's block through the usual
  lowering (elemred on the card; the sharded stencil exchanges halos with
  its neighbours over send/recv, ``ops/stencil_sharded.run_block``), and a
  whole-array reduction folds its block first, then the ranks' partials
  are all-gathered and folded in rank order on every rank: every rank
  gets the same bytes, and a rerun gives the same bytes.
* **replicated**: no leaf is a block (scalars, values held whole): every
  rank runs the program whole, nothing moves.
* **gathered**: any other program.  Its block leaves are all-gathered,
  it runs as in one process (``mesh.local_scope``), and each rank keeps
  its block of every array result.  This is the lowering those programs
  have across processes, chosen before the run; it is counted
  (``fuser.stats["gathered"]``, ``parallel.comm_stats["allgather_bytes"]``).

A program that raises on one rank raises on every rank: the ranks agree
on the outcome (one all-reduce) before any collective that would
otherwise leave the others waiting.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ramba_tpu_torch.core import expr as E
from ramba_tpu_torch.core.expr import Const, Node, Scalar
from ramba_tpu_torch.parallel import distributed
from ramba_tpu_torch.parallel import mesh as _mesh

ELEMENTWISE = frozenset({"map", "cast", "round", "masked_fill"})
CREATION = frozenset({"arange", "full", "linspace", "fromfunction"})
STENCILS = frozenset({"stencil", "stencil_iter"})
FOLDS = frozenset({"sum", "prod", "min", "max", "mean"})


class _Root:
    """One root of a shard-local plan: ``kind`` is "block", "reduce" or
    "sreduce"; ``expr`` the local expression (None: the block is empty
    and nothing runs)."""

    __slots__ = ("kind", "expr", "fname", "static", "dtype")

    def __init__(self, kind, expr, fname=None, static=None, dtype=None):
        self.kind, self.expr, self.fname = kind, expr, fname
        self.static, self.dtype = static, dtype


class Plan:
    """``owner``: this rank's partials count in the folds."""

    __slots__ = ("shape", "sharding", "index", "roots", "owner")

    def __init__(self, shape, sharding, index, roots, owner):
        self.shape, self.sharding, self.index = shape, sharding, index
        self.roots, self.owner = roots, owner


def _fold_root(e):
    """``(kind, inner, fname)`` of a root: a whole-array reduction of a
    kind the ranks can fold, an sreduce, or a plain block."""
    if isinstance(e, Node) and e.op == "reduce":
        fname, axis, keepdims, _ddof = e.static
        nd = len(e.args[0].shape)
        whole = axis is None or (isinstance(axis, tuple)
                                 and sorted(a % nd for a in axis)
                                 == list(range(nd)))
        if (fname in FOLDS and whole and not keepdims and nd
                and e.args[0].dtype.kind != "c"):
            return "reduce", e.args[0], fname
    if isinstance(e, Node) and e.op == "sreduce" and e.args[0].shape:
        return "sreduce", e.args[0], None
    return "block", e, None


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
    return False


def local_plan(exprs, mesh):
    """The shard-local plan of ``exprs`` on ``mesh``, or None."""
    roots = [_fold_root(e) for e in exprs]
    shapes = {tuple(inner.shape) for _k, inner, _f in roots}
    if len(shapes) != 1:
        return None
    (shape,) = shapes
    if not shape:
        return None
    spec = None
    stencil = scan = False
    stencils = []
    seen = set()
    stack = [inner for _k, inner, _f in roots]
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
                if e.sharding.mesh != mesh or (spec is not None
                                               and e.sharding.spec != spec):
                    return None
                spec = e.sharding.spec
            continue
        if not isinstance(e, Node) or e.shape != shape \
                or not _is_local_op(e, shape):
            return None
        if e.op in STENCILS:
            stencil = True
            stencils.append(e)
        scan = scan or e.op == "scumulative"
        if e.op not in CREATION:
            stack.extend(e.args)
    default = _mesh.default_spec(shape, mesh)
    if spec is None:
        spec = default
    elif stencil and tuple(spec) != tuple(default):
        return None  # the sharded stencil splits by the default layout
    sharding = _mesh.NamedSharding(mesh, spec)
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
    # a block held by several ranks (whole along some mesh axes) counts
    # once in a fold: at coordinate 0 of those axes
    used = {nm for en in spec for nm in _mesh.entry_names(en)}
    owner = pos is not None and math.prod(local_shape) > 0 and all(
        p == 0 for nm, p in zip(mesh.axis_names, pos) if nm not in used)
    memo: dict = {}
    out = []
    for (kind, inner, fname), e in zip(roots, exprs):
        # an empty block folds nothing (a min of nothing would raise)
        loc = _localize(inner, shape, index, sharding, memo) if runs and (
            kind == "block" or math.prod(local_shape)) else None
        if kind == "reduce":
            dt = e.dtype
            if fname == "mean":
                if loc is not None:
                    loc = Node("reduce", ("sum", None, False, None),
                               [Node("cast", (str(dt),), [loc])
                                if loc.dtype != dt else loc])
            elif loc is not None:
                loc = Node("reduce", (fname, None, False, None), [loc])
            out.append(_Root("reduce", loc, fname, dtype=dt))
        elif kind == "sreduce":
            worker, across, identity, _split = e.static
            if loc is not None:
                loc = Node("sreduce", (worker, worker, identity, False),
                           [loc], aval=E.Aval((), e.dtype, False))
            out.append(_Root("sreduce", loc, static=e.static,
                             dtype=e.dtype))
        else:
            out.append(_Root("block", loc, dtype=e.dtype))
    return Plan(shape, sharding, index, out, owner)


def _localize(e, shape, index, sharding, memo):
    """The expression of this rank's block of ``e``."""
    got = memo.get(id(e))
    if got is not None:
        return got
    if isinstance(e, Scalar) or (isinstance(e, Const) and e.shape == ()):
        out = e
    elif isinstance(e, Const):
        out = Const(e.value) if e.is_block else Const(
            e.value[index].contiguous())
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
    if fname in ("sum", "mean"):
        return a + b
    if fname == "prod":
        return a * b
    return torch.minimum(a, b) if fname == "min" else torch.maximum(a, b)


def fold(roots, partials):
    """Fold every reduction root's per-rank partials: one all-gather of
    all of them (a valid byte and the value's bytes per root), then a
    fold in rank order (``sreduce``: the driver reducer's halving fold
    over the partials in rank order, as one process folds its shards)."""
    from ramba_tpu_torch.skeletons import _tree_reduce, call_kernel

    dev = E.common.device()
    parts = []
    for r, p in zip(roots, partials):
        if r.kind == "block":
            continue
        tdt = E.to_torch_dtype(r.dtype)
        item = torch.empty((), dtype=tdt).element_size()
        if p is None:
            parts.append(torch.zeros(1 + item, dtype=torch.uint8, device=dev))
        else:
            v = p.to(tdt).reshape(1).view(torch.uint8)
            parts.append(torch.cat([torch.ones(1, dtype=torch.uint8,
                                               device=v.device), v]))
    if not parts:
        return []
    mine = torch.cat([q.to(dev) for q in parts])
    everyone = distributed.all_gather_small(mine)
    outs = []
    off = 0
    for r in roots:
        if r.kind == "block":
            continue
        tdt = E.to_torch_dtype(r.dtype)
        item = torch.empty((), dtype=tdt).element_size()
        vals = [g[off + 1:off + 1 + item].clone().view(tdt).reshape(())
                for g in everyone if int(g[off]) == 1]
        off += 1 + item
        if r.kind == "sreduce":
            _w, across, identity, _s = r.static
            ident = E.as_tensor(identity, r.dtype, dev)
            stacked = torch.stack(vals) if vals else ident.reshape(1)
            outs.append(_tree_reduce(
                stacked, ident,
                lambda a, b: call_kernel(across, a, b)).to(tdt))
            continue
        if not vals:
            if r.fname in ("min", "max"):
                raise ValueError(f"zero-size array to reduction operation "
                                 f"{r.fname} which has no identity")
            vals = [torch.zeros((), dtype=tdt, device=dev)
                    + (1 if r.fname == "prod" else 0)]
        acc = vals[0]
        for v in vals[1:]:
            acc = _combine(r.fname, acc, v)
        outs.append(acc)
    return outs



# ---------------------------------------------------------------------------
# the flush
# ---------------------------------------------------------------------------


def gather_const(c: Const) -> torch.Tensor:
    """The whole array of a block leaf, gathered from every rank."""
    sh = c.sharding
    shape = tuple(c.shape)
    parts = distributed.all_gather(c.value, sh.rank_shapes(shape))
    if c.value.device != E.common.device():
        parts = [p.to(E.common.device()) for p in parts]
    out = torch.empty(shape, dtype=c.value.dtype, device=parts[0].device)
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


def _execute(program, leaf_vals):
    """The program through its lowering, then the after-flush hooks."""
    from ramba_tpu_torch.core import fuser

    try:
        return fuser._get_compiled(program, leaf_vals)(*leaf_vals)
    finally:
        for hook in fuser.after_flush:
            hook()


def flush_roots(stream, roots, extra, mesh):
    """``fuser._flush_roots`` on a mesh of ranks: materialize ``roots``
    (port arrays) and ``extra`` expressions; returns the whole values of
    ``extra``."""
    from ramba_tpu_torch import common
    from ramba_tpu_torch.core import fuser

    root_exprs = [a._expr for a in roots]
    exprs = root_exprs + list(extra)
    if not exprs:
        return []
    err = None
    results = None
    try:
        if common.rewrite_enabled:
            from ramba_tpu_torch.core.rewrite import rewrite_roots

            exprs = rewrite_roots(exprs)
        plan = local_plan(exprs, mesh)
        if plan is not None:
            results = ("local", plan, _run_local(plan))
        else:
            results = ("whole", None, _run_whole(exprs))
    except Exception as e:  # every rank must learn of it: see _agree
        err = e
    ok = _agree(err is None)
    try:
        if err is not None:
            raise err
        if not ok:
            raise RuntimeError("a flush raised on another rank of the "
                               "group; this rank's flush is abandoned")
        kind, plan, (outs, n_instrs) = results
        if kind == "local":
            consts = _finish_local(plan, outs)
        else:
            consts = [_block_const(v, mesh, _hint(e))
                      for v, e in zip(outs, exprs)]
    except Exception:
        fuser._quarantine(stream, roots)
        raise
    for arr, c in zip(roots, consts):
        arr._set_expr(c)
    with fuser._stats_lock:
        fuser.stats["flushes"] += 1
        fuser.stats["nodes_flushed"] += n_instrs
    tail = []
    for c, v in zip(consts[len(roots):], outs[len(roots):]):
        tail.append(gather_const(c) if c.is_block else c.value)
    return tail


def _hint(e):
    return e.static[0] if isinstance(e, Node) and e.op == "shard_hint" \
        else None


def _run_local(plan):
    """Run the plan's program on this rank's blocks: ``(values, number
    of instructions)``, a value per root (None where nothing ran)."""
    live = [r.expr for r in plan.roots if r.expr is not None]
    if not live:
        return [None] * len(plan.roots), 0
    from ramba_tpu_torch.core import fuser

    program, leaf_vals = fuser.prepare_program(live)
    it = iter(_execute(program, leaf_vals))
    return ([next(it) if r.expr is not None else None
             for r in plan.roots], len(program.instrs))


def _finish_local(plan, outs):
    """Block results become block leaves; reductions fold across ranks."""
    local_shape = _mesh.index_shape(plan.index, plan.shape)
    folded = iter(fold(plan.roots, outs if plan.owner
                       else [None] * len(outs)))
    consts = []
    for r, v in zip(plan.roots, outs):
        if r.kind == "block":
            if v is None:
                v = torch.empty(local_shape, dtype=E.to_torch_dtype(r.dtype),
                                device=E.common.device())
            consts.append(Const(v, sharding=plan.sharding,
                                shape=plan.shape))
            continue
        total = next(folded)
        if r.fname == "mean":
            total = total / torch.tensor(math.prod(plan.shape),
                                         dtype=total.dtype,
                                         device=total.device)
        consts.append(Const(total))
    return consts


def _run_whole(exprs):
    """Every rank runs the program whole: block leaves all-gathered (the
    gathered lowering, counted) or none (replicated)."""
    from ramba_tpu_torch.core import fuser

    program, leaves = fuser._linearize(list(exprs))
    gathered = any(isinstance(l, Const) and l.is_block for l in leaves)
    leaf_vals = [gather_const(l) if isinstance(l, Const) and l.is_block
                 else l.value for l in leaves]
    if gathered:
        with fuser._stats_lock:
            fuser.stats["gathered"] += 1
    with _mesh.local_scope():
        outs = _execute(program, leaf_vals)
    return list(outs), len(program.instrs)
