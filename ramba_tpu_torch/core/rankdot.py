"""Contractions across ranks: matmul and the two-operand contractions on a
mesh of ranks, split the way GSPMD splits them.

A contraction is ``C[b..., m, n] = sum_k A[b..., m, k] B[b..., k, n]``
(:func:`form`): ``matmul``/``dot`` of 1-D and 2-D operands (matvec and
vecmat among them) and batched ``matmul`` whose batch dims are equal in
both operands; ``tensordot`` and ``inner`` contracting one dim of two
operands of one or two dims; a two-operand ``einsum`` with one contracted
letter, at most one free letter an operand and no repeated letter in an
operand.  ``m`` or ``n`` is absent for a vector operand.

**The result's layout** is GSPMD's (``jax.jit(jnp.matmul)`` over the
operands' ``NamedSharding``s, jax 0.9.0; :func:`result_spec`): the batch
dims keep the operands' entries (a batch dim the operands split
differently is not taken here), the larger operand's free dim keeps its
entry (A's on a tie), the other's keeps the longest leading run of its
entry whose mesh axes nothing before names, and an einsum's output
permutes that.  So ``P('d0',
'd1') @ P('d0', 'd1')`` is ``P('d0', 'd1')``, ``cols @ rows`` is
replicated, ``P('d0', 'd1') @ P('d0')`` is ``P('d0')`` and ``P('d0') @
P('d0', 'd1')`` is ``P('d1')``.

**Terms.** K is cut at every boundary of either operand's K blocks (the
common refinement of the two splits): term ``t`` is the product of A's
``(R.b, R.m, K_t)`` box by B's ``(R.b, K_t, R.n)`` box for a result block
``R``, and ``R`` is the sum of its terms in term order (integers and
bools in int64, wrapping modulo 2**64 as one process's product does,
then cast).  Each term's operands are made contiguous and aligned before
the product (a copy where a box is a strided slice of a block, or starts
off the alignment in a rank's packed blocks), so a box a rank holds and
a box it received make the same call on the same shapes: worlds of any
size on one mesh give the same bytes.

**Schedules** (:class:`Contraction`, decided from the layouts, the same
on every rank):

* *output-stationary*: a term runs on every rank that holds its result
  block; the boxes it lacks come from the rank holding them nearest in
  the mesh (:func:`parallel.mesh.nearest_holder`), each box fetched once
  a rank, through ``distributed.exchange``; a box the rank holds is a
  slice of its block, on its device.  ``P('d0', 'd1') @ P('d0', 'd1')``
  on four ranks: a rank receives a quarter of each operand.
* *split-K*: where the larger operand splits K on a mesh axis that the
  result leaves whole (``cols @ rows``, ``2-D @ 1-D``, ``1-D @ 2-D``): a
  term runs where the larger operand's box lies.  A rank holding that
  box computes the term (fetching the smaller operand's matching box
  where it lacks it: v's d1 range in ``P('d0', 'd1') @ P('d0')``); a
  rank holding the result block but not the box receives the product
  from the box's nearest holder.  The received products are folded in
  term order, so the result keeps GSPMD's layout (replicated where it
  all-reduces).

Each term is two rounds at most, each only where some rank moves
something in it: the boxes, then the products.  Before every round the
ranks agree (one all-reduce) whether a rank failed, so a rank whose
product raised makes every rank raise there, together, before any rank
waits in an exchange a peer skipped (``dot:round`` is checked before
every round, ``dot:product`` before every product); a last round agrees
the outcome.

**Memory.** Beyond its held operand blocks, a rank holds its result
blocks, one term's boxes (what it receives, sends and copies for it),
its products of that term and one product's temporary
(:meth:`Contraction.bound_bytes`; an integer product adds its chunk,
``expr._INT_CHUNK_BYTES``).

Counters: :data:`stats`; the last contraction's schedule and bounds:
:data:`last`.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ramba_tpu_torch.core import expr as E
from ramba_tpu_torch.parallel import distributed
from ramba_tpu_torch.parallel import mesh as _mesh
from ramba_tpu_torch.resilience import coherence, faults

# counters: contractions run, products computed on this rank, terms of the
# contractions, the products' flops (2 B M K N each), bytes this rank received (boxes and products), products
# received and folded, rounds, and this rank's seconds in the rounds
# against its seconds in the products
stats = {"contractions": 0, "products": 0, "terms": 0, "flops": 0,
         "bytes_received": 0, "folds": 0, "rounds": 0, "exchange_s": 0.0,
         "product_s": 0.0}

# the last contraction on this rank: its schedule and the device bytes it
# may hold (:meth:`Contraction.bound_bytes`)
last: dict = {}

OPS = frozenset({"matmul", "dot", "tensordot", "einsum"})
_ALIGN = {"cuda": 256, "cpu": 64}  # bytes a product's operand starts on


class Form:
    """A contraction node's roles: ``a``/``b`` the role of each operand
    dim (``"b<i>"``, ``"m"``, ``"k"``, ``"n"``), ``out`` the roles of the
    result's dims in order, ``prec`` the product's precision."""

    __slots__ = ("a", "b", "out", "prec")

    def __init__(self, a, b, out, prec):
        self.a, self.b, self.out, self.prec = a, b, out, prec

    @property
    def canon(self) -> list:
        """The result's roles in the product's order: batch, m, n."""
        batch = [r for r in self.a if r.startswith("b")]
        return batch + [r for r in ("m", "n") if r in self.a or r in self.b]


def form(node):
    """The :class:`Form` of a contraction node, or None where the node is
    no two-operand contraction of the kinds taken here."""
    if not isinstance(node, E.Node) or node.op not in OPS \
            or len(node.args) != 2:
        return None
    sa, sb = (tuple(x.shape) for x in node.args)
    na, nb = len(sa), len(sb)
    if not na or not nb:
        return None
    if node.op in ("matmul", "dot"):
        if na > 2 or nb > 2:
            if node.op == "dot" or na != nb or sa[:-2] != sb[:-2]:
                return None
            batch = [f"b{i}" for i in range(na - 2)]
            return Form(batch + ["m", "k"], batch + ["k", "n"],
                        batch + ["m", "n"], node.static[-1])
        a = ["m", "k"] if na == 2 else ["k"]
        b = ["k", "n"] if nb == 2 else ["k"]
        return Form(a, b, [r for r in ("m", "n") if r in a + b],
                    node.static[-1])
    if node.op == "tensordot":
        xa, xb = E._tensordot_axes(node.static[0], na, nb)
        if len(xa) != 1 or na > 2 or nb > 2:
            return None
        a = ["k" if d == xa[0] else "m" for d in range(na)]
        b = ["k" if d == xb[0] else "n" for d in range(nb)]
        return Form(a, b, [r for r in ("m", "n") if r in a + b],
                    node.static[-1])
    try:
        ops, out, _sizes = E.einsum_spec(node.static[0], [sa, sb])
    except ValueError:
        return None
    la, lb = ops
    if len(set(la)) != len(la) or len(set(lb)) != len(lb) \
            or len(set(out)) != len(out):
        return None
    size = {}
    for letters, shape in ((la, sa), (lb, sb)):
        for c, n in zip(letters, shape):
            if size.setdefault(c, n) != n:  # a broadcast size-1 letter
                return None
    contracted = [c for c in la if c in lb and c not in out]
    free_a = [c for c in la if c not in lb]
    free_b = [c for c in lb if c not in la]
    if len(contracted) != 1 or len(free_a) > 1 or len(free_b) > 1 \
            or any(c not in out for c in free_a + free_b):
        return None
    batch = [c for c in la if c in lb and c in out]
    role = {c: f"b{i}" for i, c in enumerate(batch)}
    role[contracted[0]] = "k"
    role.update({c: "m" for c in free_a})
    role.update({c: "n" for c in free_b})
    return Form([role[c] for c in la], [role[c] for c in lb],
                [role[c] for c in out], node.static[-1])


def _entries(sharding, ndim) -> tuple:
    spec = tuple(sharding.spec) + (None,) * (ndim - len(sharding.spec))
    return tuple(_mesh.entry_names(e) for e in spec)


def _entry(names):
    return None if not names else names[0] if len(names) == 1 \
        else tuple(names)


def result_spec(f: Form, sa, sb, shape_a, shape_b):
    """GSPMD's spec of the result (in ``f.out`` order) for operands of
    ``shape_a``/``shape_b`` laid out as ``sa``/``sb``, or None where a
    batch dim is split differently in the two.  The batch dims keep their
    entries; the larger operand's free dim keeps its entry (A's on a
    tie), the other's keeps the leading run of its entry's mesh axes that
    nothing before names."""
    ea = dict(zip(f.a, _entries(sa, len(shape_a))))
    eb = dict(zip(f.b, _entries(sb, len(shape_b))))
    got, used = {}, set()
    for r in f.canon:
        if r.startswith("b"):
            if ea[r] != eb[r]:
                return None
            got[r] = ea[r]
            used |= set(ea[r])
    first = ("n", "m") if math.prod(shape_b) > math.prod(shape_a) \
        else ("m", "n")
    for r in first:
        if r not in f.canon:
            continue
        keep = []
        for nm in (ea if r == "m" else eb)[r]:
            if nm in used:
                break
            keep.append(nm)
        got[r] = tuple(keep)
        used |= set(keep)
    return _mesh.P(*_mesh.canonical([_entry(got[r]) for r in f.out]))


class Side:
    """One operand: its global shape, layout, dims' roles and dtype;
    ``ranks``: per rank the block coordinates it holds (None: every rank
    holds the value whole)."""

    __slots__ = ("shape", "sharding", "roles", "ranks", "tdt", "item",
                 "nbytes")

    def __init__(self, shape, sharding, roles, tdt):
        self.shape, self.sharding, self.roles = shape, sharding, roles
        self.tdt = tdt
        self.item = torch.empty((), dtype=tdt).element_size()
        self.nbytes = math.prod(shape) * self.item
        mesh = sharding.mesh
        if not any(_entries(sharding, len(shape))):
            self.ranks = None
        else:
            self.ranks = {}
            for p in np.ndindex(mesh.devices.shape):
                self.ranks.setdefault(mesh.rank_at(p), set()).add(
                    sharding.block_coords(p, len(shape)))

    def holds(self, rank, coords) -> bool:
        return self.ranks is None or coords in self.ranks.get(rank, ())

    def block_box(self, coords) -> tuple:
        """The box of the block at ``coords``."""
        counts = self.sharding.split_counts(len(self.shape))
        out = []
        for n, c, i in zip(self.shape, counts, coords):
            sl = _mesh._block_range(n, c, i)
            out.append((sl.start, sl.stop))
        return tuple(out)

    def box(self, rbox, k):
        """The operand's box for the result box ``rbox`` (role ->
        ``(start, stop)``) and the K range ``k``."""
        return tuple(k if r == "k" else rbox[r] for r in self.roles)


class Job:
    """A term's product for one result block on one rank: ``pieces`` per
    operand ``[(coords, piece box, source rank)]``; ``to``: the ranks
    that fold it (this rank among them where it holds the block)."""

    __slots__ = ("block", "term", "rank", "anchor", "boxes", "pieces", "to")

    def __init__(self, block, term, rank, anchor, boxes):
        self.block, self.term, self.rank = block, term, rank
        self.anchor, self.boxes = anchor, boxes
        self.pieces, self.to = None, []


def _k_terms(n, ca, cb) -> list:
    """The common refinement of two splits of a K axis of ``n``."""
    cuts = {0, n}
    for c in (ca, cb):
        for i in range(c):
            sl = _mesh._block_range(n, c, i)
            cuts.update((sl.start, sl.stop))
    cuts = sorted(cuts)
    return [(lo, hi) for lo, hi in zip(cuts, cuts[1:]) if lo < hi]


def _intersect(a, b) -> tuple:
    return tuple((max(x0, y0), min(x1, y1)) for (x0, x1), (y0, y1)
                 in zip(a, b))


def _nbytes(box, itemsize) -> int:
    return math.prod(hi - lo for lo, hi in box) * itemsize


class Contraction:
    """The partitioned plan of one contraction: the result's layout and
    shape (``osharding``/``oshape``, and in the product's order
    ``csharding``/``cshape``), the K terms, the schedule and its jobs,
    the same on every rank."""

    def __init__(self, f, a: Side, b: Side, dtype, oshape, ospec, mesh):
        self.form, self.a, self.b = f, a, b
        self.sides = (a, b)
        self.tdt = E.to_torch_dtype(dtype)
        self.item = torch.empty((), dtype=self.tdt).element_size()
        # integer and bool products sum in int64, wrapping
        self.carrier = not (self.tdt.is_floating_point
                            or self.tdt.is_complex)
        self.mesh = mesh
        self.oshape = tuple(oshape)
        self.osharding = _mesh.NamedSharding(mesh, ospec)
        canon = f.canon
        self.perm = [f.out.index(r) for r in canon]  # canon dim -> out dim
        self.cshape = tuple(self.oshape[i] for i in self.perm)
        oent = _entries(self.osharding, len(self.oshape))
        self.csharding = _mesh.NamedSharding(mesh, _mesh.P(*_mesh.canonical(
            [_entry(oent[i]) for i in self.perm])))
        ka, kb = a.roles.index("k"), b.roles.index("k")
        self.terms = _k_terms(a.shape[ka], a.sharding.split_counts(
            len(a.shape))[ka], b.sharding.split_counts(len(b.shape))[kb])
        large = a if a.nbytes >= b.nbytes else b
        used = {nm for e in _entries(self.csharding, len(self.cshape))
                for nm in e}
        lent = dict(zip(large.roles, _entries(large.sharding,
                                              len(large.shape))))
        cent = dict(zip(canon, _entries(self.csharding, len(self.cshape))))
        # split-K: the larger operand splits K on an axis the result leaves
        # whole, and each of its boxes lies in one of its blocks
        self.split_k = bool(set(lent["k"]) - used) and all(
            lent[r] == cent[r] for r in large.roles if r != "k")
        self.large = large
        self._schedule()

    # -- the schedule ------------------------------------------------------

    def _rbox(self, cbox) -> dict:
        return dict(zip(self.form.canon, cbox))

    def _schedule(self):
        """Every rank's jobs, transfers and folds, the same everywhere."""
        mesh = self.mesh
        world = distributed.process_count()
        csh, cshape = self.csharding, self.cshape
        nd = len(cshape)
        self.blocks = []  # [(coords, box)] of the result, first seen order
        index = {}
        self.held = {}  # rank -> [block ids] in rank_blocks order
        for q in range(world):
            ids = []
            for pos, idx in csh.rank_blocks(q, cshape):
                coords = csh.block_coords(pos, nd)
                if coords not in index:
                    index[coords] = len(self.blocks)
                    self.blocks.append((coords, _mesh.index_box(idx,
                                                                cshape)))
                ids.append((index[coords], pos))
            self.held[q] = ids
        jobs = {}
        self.source = {}  # (rank, block, term) -> the job it folds
        for q in range(world):
            for bi, pos in self.held[q]:
                box = self.blocks[bi][1]
                if any(hi <= lo for lo, hi in box):
                    continue
                rbox = self._rbox(box)
                for t, k in enumerate(self.terms):
                    boxes = (self.a.box(rbox, k), self.b.box(rbox, k))
                    where, anchor = q, pos
                    if self.split_k:
                        lbox = boxes[0] if self.large is self.a else boxes[1]
                        ((coords, _bb),) = _mesh.covering(
                            self.large.sharding, self.large.shape, lbox)
                        if not self.large.holds(q, coords):
                            anchor = _mesh.nearest_holder(
                                self.large.sharding, len(self.large.shape),
                                coords, pos)
                            where = mesh.rank_at(anchor)
                    key = (bi, t, where)
                    job = jobs.get(key)
                    if job is None:
                        job = jobs[key] = Job(bi, t, where, anchor, boxes)
                    job.to.append(q)
                    self.source[(q, bi, t)] = job
        self.jobs = list(jobs.values())
        for job in self.jobs:
            job.pieces = [self._pieces(s, box, job)
                          for s, box in zip((self.a, self.b), job.boxes)]

    def _pieces(self, side, box, job) -> list:
        out = []
        for coords, bbox in _mesh.covering(side.sharding, side.shape, box):
            src = job.rank if side.holds(job.rank, coords) else \
                self.mesh.rank_at(_mesh.nearest_holder(
                    side.sharding, len(side.shape), coords, job.anchor))
            out.append((coords, _intersect(box, bbox), src))
        return out

    def moves(self, t):
        """Term ``t``'s transfers: ``(boxes, products)``, boxes as
        ``(operand, coords, piece box, source, destination)`` each once a
        destination, products as ``(job, destination)``."""
        boxes, seen = [], set()
        prods = []
        for job in self.jobs:
            if job.term != t:
                continue
            for s, pieces in enumerate(job.pieces):
                for coords, pbox, src in pieces:
                    key = (s, pbox, src, job.rank)
                    if src != job.rank and key not in seen:
                        seen.add(key)
                        boxes.append((s, coords, pbox, src, job.rank))
            prods.extend((job, q) for q in job.to if q != job.rank)
        return boxes, prods

    def block_shape(self, bi) -> tuple:
        return tuple(hi - lo for lo, hi in self.blocks[bi][1])

    def block_bytes(self, bi) -> int:
        """A result block's bytes (its accumulator's: int64 for integer
        and bool products)."""
        return _nbytes(self.blocks[bi][1], 8 if self.carrier else self.item)

    def bound_bytes(self, rank) -> int:
        """The device bytes a rank may hold beyond its operand blocks: its
        result blocks (and their accumulators), then per term what it
        receives, sends and copies and its products of the term, the
        largest term's; plus one product's temporary, and an integer
        product's chunk."""
        mine = {bi for bi, _p in self.held.get(rank, [])}
        res = sum(self.block_bytes(bi) for bi in mine)
        worst = 0
        for t in range(len(self.terms)):
            boxes, prods = self.moves(t)
            n = sum(_nbytes(pb, self.sides[s].item)
                    for s, _c, pb, src, dst in boxes if rank in (src, dst))
            n += sum(self.block_bytes(job.block) for job, q in prods
                     if q == rank)
            ops = 0
            for job in self.jobs:
                if job.term == t and job.rank == rank:
                    # its product, and (one product at a time) its
                    # operands assembled and copied once
                    n += self.block_bytes(job.block)
                    ops = max(ops, 2 * sum(_nbytes(bx, self.item)
                                           for bx in job.boxes))
            worst = max(worst, n + ops)
        top = max((self.block_bytes(bi) for bi in mine), default=0)
        return res + worst + top + (E._INT_CHUNK_BYTES if self.carrier
                                    else 0)


def plan(node, a, b, mesh):
    """The :class:`Contraction` of ``node`` over operands laid out as
    ``a``/``b`` (``(shape, NamedSharding)``), or None where this module
    does not take it (not a contraction of these kinds, or a batch dim
    split differently in the two operands)."""
    f = form(node)
    if f is None:
        return None
    (sha, sa), (shb, sb) = a, b
    if sa.mesh != mesh or sb.mesh != mesh:
        return None
    ospec = result_spec(f, sa, sb, sha, shb)
    if ospec is None:
        return None
    ta, tb = (E.to_torch_dtype(x.dtype) for x in node.args)
    return Contraction(f, Side(tuple(sha), sa, f.a, ta),
                       Side(tuple(shb), sb, f.b, tb), node.dtype,
                       node.shape, ospec, mesh)


# ---------------------------------------------------------------------------
# running it
# ---------------------------------------------------------------------------


def _held(side, value):
    """This rank's blocks of an operand: coordinates -> tensor."""
    sh, shape = side.sharding, side.shape
    if side.ranks is None:
        return {(0,) * len(shape): value}
    return {sh.block_coords(p, len(shape)): v
            for (p, _i), v in zip(sh.local_blocks(shape),
                                  sh.split_local(value, shape))}


def _ready(t):
    """A product operand as one call expects it in every world:
    contiguous, starting on the alignment."""
    if t.is_contiguous() and t.data_ptr() % _ALIGN.get(t.device.type,
                                                       64) == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


_MAGIC = 0x72616E6B646F74  # marks a contraction's round


def _round(err, site, tag, check="dot:round", magic=_MAGIC, counts=None):
    """One round: every rank learns whether any rank failed (the fault
    site ``check`` first: a raised fault is this rank's failure); the
    failed rank raises its error, the others a retryable
    ``CoherentAbort``.  The round is an all-gather of ``(flag, marker)``,
    wider than a coherence round's all-reduce, so a peer that left this
    contraction (or movement: its own ``magic``; abandoned under the
    watchdog) and entered another round does not pair with it unnoticed:
    the collectives disagree, or the marker does, and the group is
    broken.  ``counts``: the counters whose ``rounds`` it adds to."""
    try:
        faults.check(check, round=tag)
    except Exception as e:  # noqa: BLE001 - joins the round as a failure
        err = err or e
    (stats if counts is None else counts)["rounds"] += 1
    got = distributed.all_gather_small(torch.tensor(
        [0 if err is None else 1, magic], dtype=torch.int64))
    if any(int(g[1]) != magic for g in got):
        distributed.mark_broken(f"the round {site}/{tag!r} met another "
                                "collective")
        from ramba_tpu_torch.resilience import elastic

        raise elastic.GroupBrokenError(site, distributed.broken(),
                                       rank=distributed.process_index())
    if err is not None:
        raise err
    if any(int(g[0]) for g in got):
        raise coherence.CoherentAbort(site, coherence.P_RETRY)


def contract(con: Contraction, values):
    """Run ``con`` on this rank over its operands' held values
    (``values``: each operand's leaf value, this rank's blocks packed);
    returns the result as a leaf in the result's layout."""
    me = distributed.process_index()
    last.clear()
    last.update(schedule="split-K" if con.split_k else "output-stationary",
                bound_bytes=con.bound_bytes(me))
    return _Run(con, values).run()


class _Run:
    """One contraction's execution on this rank."""

    def __init__(self, con, values):
        self.con = con
        self.me = distributed.process_index()
        self.dev = E.common.device()
        self.held = [_held(s, v) for s, v in zip(con.sides, values)]

    def piece(self, s, coords, pbox):
        """A piece of a block this rank holds: a view."""
        bbox = self.con.sides[s].block_box(coords)
        return self.held[s][coords][tuple(
            slice(lo - b0, hi - b0) for (lo, hi), (b0, _b) in zip(pbox, bbox))]

    def operand(self, s, job, got):
        """Job ``job``'s box of operand ``s`` as ``(B, M, K)`` or ``(B, K,
        N)`` in the result's dtype, contiguous and aligned."""
        con = self.con
        side = con.sides[s]
        box = job.boxes[s]
        parts = [(pbox, self.piece(s, coords, pbox) if src == self.me
                  else got[(s, pbox, src)])
                 for coords, pbox, src in job.pieces[s]]
        if len(parts) == 1:
            x = parts[0][1]
        else:
            x = torch.empty(tuple(hi - lo for lo, hi in box),
                            dtype=side.tdt, device=self.dev)
            for pbox, t in parts:
                x[tuple(slice(lo - b0, hi - b0) for (lo, hi), (b0, _b)
                        in zip(pbox, box))] = t
        x = E.convert(x, con.tdt)
        roles = side.roles
        order = [r for r in roles if r.startswith("b")] + [
            r for r in (("m", "k") if s == 0 else ("k", "n")) if r in roles]
        x = x.permute(*[roles.index(r) for r in order])
        size = dict(zip(order, x.shape))
        nb = math.prod(size[r] for r in order if r.startswith("b"))
        x = x.reshape(nb, size.get("m", 1), size["k"]) if s == 0 else \
            x.reshape(nb, size["k"], size.get("n", 1))
        return _ready(x)

    def product(self, job, got):
        faults.check("dot:product", term=job.term)
        con = self.con
        a = self.operand(0, job, got)
        b = self.operand(1, job, got)
        stats["products"] += 1
        stats["flops"] += 2 * a.shape[0] * a.shape[1] * a.shape[2] * \
            b.shape[2]
        if con.carrier:  # int64, wrapping; cast once at the end
            p = E._int_matmul(E._carried(a), E._carried(b))
        else:
            p = E._bmm(a, b, con.form.prec)
        return p.reshape(con.block_shape(job.block))

    def run(self):
        con, me = self.con, self.me
        err = None
        mine = [bi for bi, _p in con.held.get(me, [])]
        acc = dict.fromkeys(mine)
        stats["contractions"] += 1
        stats["terms"] += len(con.terms)
        for t in range(len(con.terms)):
            boxes, prods = con.moves(t)
            got = {}
            if boxes:
                t0 = time.perf_counter()
                _round(err, "dot:boxes", ("boxes", t))
                sends = [(self.piece(s, c, pb), dst)
                         for s, c, pb, src, dst in boxes if src == me]
                keys = [(s, pb, src) for s, _c, pb, src, dst in boxes
                        if dst == me]
                vals = distributed.exchange(sends, [
                    (tuple(hi - lo for lo, hi in pb), con.sides[s].tdt, src)
                    for s, pb, src in keys])
                got = dict(zip(keys, vals))
                stats["bytes_received"] += sum(
                    v.numel() * v.element_size() for v in vals)
                stats["exchange_s"] += time.perf_counter() - t0
            done = {}
            t0 = time.perf_counter()
            try:
                if err is None:
                    for job in con.jobs:
                        if job.term == t and job.rank == me:
                            done[id(job)] = self.product(job, got)
                    if self.dev.type == "cuda":
                        torch.cuda.synchronize()
            except Exception as e:  # noqa: BLE001 - every rank learns of it
                err = e
            stats["product_s"] += time.perf_counter() - t0
            del got
            if prods:
                t0 = time.perf_counter()
                _round(err, "dot:products", ("products", t))
                mine_in = [job for job, q in prods if q == me]
                vals = distributed.exchange(
                    [(done[id(job)], q) for job, q in prods
                     if job.rank == me],
                    [(con.block_shape(job.block),
                      torch.int64 if con.carrier else con.tdt, job.rank)
                     for job in mine_in])
                for job, v in zip(mine_in, vals):
                    done[id(job)] = v
                stats["bytes_received"] += sum(
                    v.numel() * v.element_size() for v in vals)
                stats["folds"] += len(vals)
                stats["exchange_s"] += time.perf_counter() - t0
            if err is None:
                for bi in mine:
                    job = con.source.get((me, bi, t))
                    if job is not None:
                        p = done[id(job)]
                        acc[bi] = p if acc[bi] is None else acc[bi] + p
            del done
        _round(err, "dot:done", "done")
        return self.finish(acc)

    def finish(self, acc):
        """The result as a leaf: this rank's blocks in the result's
        layout, packed."""
        con = self.con
        osh, oshape = con.osharding, con.oshape
        inv = [con.perm.index(i) for i in range(len(oshape))]
        vals = []
        for bi, _pos in con.held.get(self.me, []):
            v = acc[bi]
            if v is None:  # an empty block, or an empty K
                v = torch.zeros(con.block_shape(bi), dtype=torch.int64
                                if con.carrier else con.tdt, device=self.dev)
            if con.carrier:
                v = E._uncarried(v, con.tdt)
            vals.append(v.permute(*inv).contiguous() if inv else v)
        if not oshape:
            return E.Const(vals[0] if vals else torch.zeros(
                (), dtype=con.tdt, device=self.dev))
        if not vals:  # a rank outside the mesh: its empty block
            vals = [torch.empty(_mesh.index_shape(osh.local_index(oshape),
                                                  oshape),
                                dtype=con.tdt, device=self.dev)]
        return E.Const(_mesh.pack(vals), sharding=osh, shape=oshape)
