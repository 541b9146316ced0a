"""Movement ops across ranks: slices, transposes, reshapes and the other
movement ops on a mesh of ranks, moved box by box the way GSPMD moves
them.

The ops (their nodes in ``core/expr.py``): ``getitem`` of a basic index
(slices of any step, integers, ``None``; ``split``, ``diff`` and the
slices of ``roll`` are such getitems), ``setitem`` through a basic index
(the write of a slice view), ``permute`` (``transpose``, ``swapaxes``,
``moveaxis``, the write of a transposed view), ``reshape`` (``ravel``,
``squeeze``, ``expand_dims``, the write of a reshaped view),
``broadcast_to``, ``flip``, ``concatenate`` and ``stack`` of operands of
one layout, and ``pad`` in its six modes where each side is at most its
dim long.  ``tril``/``triu`` move nothing: ``core/rankflush.py`` masks
each block by its global indices.

**The result's layout** is GSPMD's (:func:`result_spec`; ``jax.jit`` over
the operands' ``NamedSharding``s, jax 0.9.0): a slice keeps each kept
dim's entry, unless one of its slices has a step other than 1 or -1;
then every dim not taken whole (start 0, step 1, full length) is
replicated (``A[::2]`` of ``P('d0', 'd1')`` is ``P(None, 'd1')``,
``A[2:6, ::2]`` is ``P()``); an integer drops its dim and ``None`` adds
a whole one.  A transpose permutes the entries; ``broadcast_to`` keeps
the entries of the dims the operand has at full length; ``flip``,
``pad``, ``concatenate`` and ``setitem`` keep the operand's (the base's)
layout, ``stack`` adds a whole dim.  A reshape hands the mesh axes of
each merge or split group on through the common refinement of the two
shapes' dims (their atoms): an operand dim's axes sit on its atoms from
the major one, the next atom taking axes once one is split to one index
a block, and a result dim keeps the axes of its atoms the same way
(``(8, 8) P('d0', 'd1')`` to 64 is ``P('d0')``, 64 ``P(('d0', 'd1'))``
to ``(2, 32)`` is ``P('d0', 'd1')``, ``(8, 16) P(None, ('d1', 'd0'))``
to ``(16, 8)`` is ``P(None, 'd0')``; where the dims do not nest, only
the group's major dims keep theirs).  A dim that its axes do
not divide keeps them in blocks of ceil(n / parts), where GSPMD would
drop axes; layouts are compared with jax on shapes that divide.

**Pieces.** For each result block a rank holds, the op names the
operand boxes it reads (:meth:`_Affine.pieces`, :meth:`_Reshape.pieces`,
:meth:`_Setitem.pieces`): one for a slice, a flip, a transpose or a
broadcast, one for each operand a block meets in ``concatenate``/
``stack``, one for each run of the pad's index map (its modes as affine
runs of source indices, or a fill), and for a reshape one for each
flat-contiguous run of each merge or split group's result box, cut into
the operand boxes its flat range covers.  A rank's blocks of a 1-D array
that lie side by side are one region, so a slice of them is one view.

**Moving them, output-stationary.** A read box that lies in a block the
rank holds is a view of it: no exchange, no copy.  The others are
assembled: the boxes one operand's reads need for one result region are
merged while their bounding box is no larger than their sizes summed (the slices of
one leaf in one program share one copy of the block grown by the margins
they need: ``a[2:] - 2 a[1:-1] + a[:-2]`` costs a rank its block plus two
elements), and each merged box is filled from the blocks that meet it:
a rank's own as device copies, the others fetched once from their
nearest holder (``parallel.mesh.nearest_holder``) in one
``distributed.exchange``.  Then each piece's local op (a step, a flip, a
permutation, a fill, an expand, a reshape) runs on its box.  Movements
copy values, so every world gives the bytes one process gives.

**Rounds.** A movement runs one round before its exchange (where some
rank moves something) and one after its pieces: each an all-gather of a
failure flag and a marker (``rankdot._round``), the ``move:round`` fault
site checked first, so a rank that failed (``move:piece`` is checked
before every piece) makes every rank raise there together.

**Memory.** Beyond its operands, a rank holds the merged boxes it
assembles, the bytes it sends and receives, and its result blocks (and
their packed copy where it holds several blocks of more than one dim):
:meth:`Group.bound_bytes`.

Counters: :data:`stats`; the last movement's boxes and bound:
:data:`last`.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from ramba_tpu_torch.core import expr as E
from ramba_tpu_torch.core import rankdot
from ramba_tpu_torch.parallel import distributed
from ramba_tpu_torch.parallel import mesh as _mesh
from ramba_tpu_torch.resilience import faults

# counters: movements run on this rank, rounds, bytes it received, reads
# served as views of a held block, boxes assembled (copies)
stats = {"movements": 0, "rounds": 0, "bytes_received": 0, "views": 0,
         "copies": 0}

# the last group of movements on this rank: the boxes it assembled, the
# boxes it received and the device bytes it may hold (Group.bound_bytes)
last: dict = {}

OPS = frozenset({"getitem", "setitem", "permute", "reshape", "broadcast_to",
                 "flip", "concatenate", "stack", "pad"})
# ops that read one array operand: the reads of one operand share a copy
READS = frozenset({"getitem", "permute", "reshape", "broadcast_to", "flip",
                   "pad"})
PAD_MODES = frozenset({"constant", "empty", "edge", "wrap", "reflect",
                       "symmetric"})
_MAGIC = 0x72616E6B6D6F7665  # marks a movement's round


def _spec(names) -> "_mesh.P":
    return _mesh.P(*_mesh.canonical([None if not n else n[0] if len(n) == 1
                                     else tuple(n) for n in names]))


def _vol(box) -> int:
    return math.prod(max(0, hi - lo) for lo, hi in box)


def _empty(box) -> bool:
    return any(hi <= lo for lo, hi in box)


def _intersect(a, b) -> tuple:
    return tuple((max(x0, y0), min(x1, y1)) for (x0, x1), (y0, y1)
                 in zip(a, b))


def _inside(a, b) -> bool:
    """Box ``a`` lies in box ``b``."""
    return all(y0 <= x0 and x1 <= y1 for (x0, x1), (y0, y1) in zip(a, b))


def _rel(a, b) -> tuple:
    """Box ``a`` as slices of a tensor holding box ``b``."""
    return tuple(slice(x0 - y0, x1 - y0) for (x0, x1), (y0, _y) in zip(a, b))


def _bbox(a, b) -> tuple:
    return tuple((min(x0, y0), max(x1, y1)) for (x0, x1), (y0, y1)
                 in zip(a, b))


def _shape(box) -> tuple:
    return tuple(hi - lo for lo, hi in box)


# ---------------------------------------------------------------------------
# the ops: result layouts and pieces
# ---------------------------------------------------------------------------


class Piece:
    """Part of a result block: ``rsub`` the result box it fills (None for
    a write into the block), ``reads`` ``[(operand, box)]``, ``make(*X)``
    its values from a tensor of each read box; ``write`` the index into
    the block a ``setitem`` assigns."""

    __slots__ = ("rsub", "reads", "make", "write")

    def __init__(self, rsub, reads, make, write=None):
        self.rsub, self.reads, self.make, self.write = rsub, reads, make, write


def _basic(shape, enc):
    """A basic index over ``shape``: per result dim None (a new axis) or
    ``(dim, start, step, count)``, and ``{dim: index}`` for integers."""
    from ramba_tpu_torch.core.ndarray import expand_ellipsis

    idx = expand_ellipsis(E.decode_index(enc), len(shape))
    real = sum(1 for it in idx if it is not None)
    idx = tuple(idx) + (slice(None),) * (len(shape) - real)
    out, fixed, d = [], {}, 0
    for it in idx:
        if it is None:
            out.append(None)
            continue
        n = shape[d]
        if isinstance(it, slice):
            start, stop, step = it.indices(n)
            out.append((d, start, step, len(range(start, stop, step))))
        else:
            i = int(it)
            fixed[d] = i + n if i < 0 else i
        d += 1
    return out, fixed


def _getitem_names(shape, enc, names):
    dims, _fixed = _basic(shape, enc)
    strided = any(m is not None and abs(m[2]) > 1 for m in dims)
    out = []
    for m in dims:
        if m is None:
            out.append(())
            continue
        d, start, step, count = m
        whole = start == 0 and step == 1 and count == shape[d]
        out.append(names[d] if whole or not strided else ())
    return out


def _groups(S, T) -> list:
    """``[(operand dims, result dims)]``: the merge and split groups of a
    reshape of ``S`` into ``T`` (dims of length 1 in none)."""
    si = [d for d, n in enumerate(S) if n != 1]
    ti = [r for r, n in enumerate(T) if n != 1]
    out, i, j = [], 0, 0
    while i < len(si) and j < len(ti):
        gs, gt = [si[i]], [ti[j]]
        ps, pt = S[si[i]], T[ti[j]]
        i += 1
        j += 1
        while ps != pt:
            if ps < pt:
                gs.append(si[i])
                ps *= S[si[i]]
                i += 1
            else:
                gt.append(ti[j])
                pt *= T[ti[j]]
                j += 1
        out.append((gs, gt))
    return out


def _atoms(S, T):
    """The common refinement of two shapes of one group (``(sizes, the
    atoms of each dim of S, of each dim of T)``, each dim a run of
    atoms), or None where their dim boundaries do not nest."""
    bounds = {1}
    for dims in (S, T):
        p = 1
        for n in reversed(dims):
            p *= n
            bounds.add(p)
    b = sorted(bounds, reverse=True)
    if any(b[i] % b[i + 1] for i in range(len(b) - 1)):
        return None
    sizes = [b[i] // b[i + 1] for i in range(len(b) - 1)]

    def spans(dims):
        out, k = [], 0
        for n in dims:
            start, p = k, 1
            while p < n:
                p *= sizes[k]
                k += 1
            out.append(range(start, k))
        return out
    return sizes, spans(S), spans(T)


def _reshape_names(S, T, names, axis_size):
    out = [[] for _ in T]
    if 0 in S:
        return out
    for gs, gt in _groups(S, T):
        at = _atoms([S[d] for d in gs], [T[r] for r in gt])
        if at is None:  # the major dims only
            axes = []
            for d in gs:
                axes.extend(names[d])
                if math.prod(axis_size[a] for a in names[d]) != S[d]:
                    break
            k = 0
            for r in gt:
                got = 1
                while k < len(axes) and got * axis_size[axes[k]] <= T[r]:
                    got *= axis_size[axes[k]]
                    out[r].append(axes[k])
                    k += 1
                if got != T[r]:
                    break
            continue
        sizes, sspans, tspans = at
        on = [[] for _ in sizes]  # the axes on each atom, major first
        full = [False] * len(sizes)  # an atom split to one index a block
        for d, span in zip(gs, sspans):
            k, rem = span[0], sizes[span[0]]
            for a in names[d]:
                on[k].append(a)
                if rem % axis_size[a] or full[k]:
                    full[k] = False  # uneven: the axes after it go
                    break
                rem //= axis_size[a]
                if rem == 1:
                    full[k] = True
                    if k + 1 in span:
                        k, rem = k + 1, sizes[k + 1]
        for r, span in zip(gt, tspans):
            for k in span:
                out[r].extend(on[k])
                if not full[k]:
                    break
    return out


def result_spec(node, shardings):
    """GSPMD's spec of ``node``'s result for operands laid out as
    ``shardings`` (one per array operand), or None where the op is not
    taken here (operands of ``concatenate``/``stack`` in different
    layouts, a pad wider than its dim or of another mode)."""
    op = node.op
    shapes = [tuple(a.shape) for a in node.args]
    names = [rankdot._entries(sh, len(s))
             for sh, s in zip(shardings, shapes)]
    if op == "getitem":
        return _spec(_getitem_names(shapes[0], node.static[0], names[0]))
    if op == "setitem":
        return _spec(names[0])
    if op == "permute":
        return _spec([names[0][d] for d in node.static[0]])
    if op == "reshape":
        size = dict(shardings[0].mesh.shape)
        return _spec(_reshape_names(shapes[0], tuple(node.static[0]),
                                    names[0], size))
    if op == "broadcast_to":
        S, T = shapes[0], tuple(node.static[0])
        lead = len(T) - len(S)
        return _spec([() if r < lead or S[r - lead] != T[r]
                      else names[0][r - lead] for r in range(len(T))])
    if op == "flip":
        return _spec(names[0])
    if op in ("concatenate", "stack"):
        canon = {_mesh.canonical(_spec(n)) for n in names}
        if len(canon) != 1:
            return None
        out = list(names[0])
        if op == "stack":
            out.insert(node.static[0] % (len(shapes[0]) + 1), ())
        return _spec(out)
    if op == "pad":
        pw, mode = node.static
        if mode not in PAD_MODES or any(
                lo > n or hi > n or ((lo or hi) and not n and mode not in (
                    "constant", "empty"))
                for (lo, hi), n in zip(pw, shapes[0])):
            return None
        return _spec(names[0])
    return None


class _Affine:
    """A movement each of whose result dims reads one operand dim along
    runs of affine source indices: ``dims[r]`` the operand dim result dim
    ``r`` reads (None: a new axis), ``runs[r]`` ``[(lo, hi, src)]`` over
    the whole dim, ``src`` ``("map", k, start, step)`` (operand ``k``, None
    for every operand, reads ``start + step * (i - lo)``), ``("new", k)``
    or ``("fill",)``; ``fixed`` the operand dims an integer indexes."""

    def __init__(self, shapes, out_shape, tdt, dims, runs, fixed=None,
                 fill=None):
        self.shapes, self.out_shape, self.tdt = shapes, tuple(out_shape), tdt
        self.dims, self.runs = dims, runs
        self.fixed = fixed or {}
        self.fill = fill

    def pieces(self, rbox):
        if _empty(rbox):
            return []
        per = []
        for r, (lo, hi) in enumerate(rbox):
            cut = []
            for rl, rh, src in self.runs[r]:
                a, b = max(lo, rl), min(hi, rh)
                if a >= b:
                    continue
                if src[0] == "map":
                    _m, k, start, step = src
                    src = ("map", k, start + step * (a - rl), step)
                cut.append((a, b, src))
            per.append(cut)
        out = []
        for combo in itertools.product(*per):
            rsub = tuple((a, b) for a, b, _s in combo)
            if any(s[0] == "fill" for _a, _b, s in combo):
                out.append(Piece(rsub, [], self._filler(rsub)))
                continue
            ks = {s[1] for _a, _b, s in combo if s[1] is not None}
            k = ks.pop() if ks else 0
            shape = self.shapes[k]
            obox = [None] * len(shape)
            trans = [None] * len(shape)
            for d, i in self.fixed.items():
                obox[d], trans[d] = (i, i + 1), ("index",)
            order = []
            for (a, b, s), d in zip(combo, self.dims):
                if s[0] == "new":
                    order.append(None)
                    continue
                _m, _k, start, step = s
                c = b - a
                end = start + step * (c - 1)
                obox[d] = (min(start, end), max(start, end) + 1)
                trans[d] = ("slice", step, c)
                order.append(d)
            out.append(Piece(rsub, [(k, tuple(obox))], self._maker(
                trans, order, _shape(rsub))))
        return out

    def _maker(self, trans, order, shape):
        tdt = self.tdt

        def make(x):
            return E.convert(_affine(x, trans, order, shape), tdt)
        return make

    def _filler(self, rsub):
        fill, tdt, shape = self.fill, self.tdt, _shape(rsub)

        def make():
            dev = E.common.device()
            return E.as_tensor(0 if fill is None else fill,
                               E.to_np_dtype(tdt), dev).to(dev).expand(shape)
        return make


def _affine(x, trans, order, shape):
    """The values of an affine piece from ``x``, a tensor of exactly its
    operand box: steps and integers, flips, the result's dim order, new
    axes, broadcast dims expanded."""
    idx, flips, keep = [], [], []
    for d, t in enumerate(trans):
        if t[0] == "index":
            idx.append(0)
            continue
        _s, step, c = t
        idx.append(slice(0, None, abs(step)) if step else slice(0, 1))
        if step < 0 and c > 1:
            flips.append(len(keep))
        keep.append(d)
    y = x[tuple(idx)] if idx else x
    if flips:
        y = E._unbits(torch.flip(E._bits(y), flips), x.dtype)
    pos = {d: i for i, d in enumerate(keep)}
    perm = [pos[d] for d in order if d is not None]
    if perm != list(range(len(perm))):
        y = y.permute(*perm)
    for r, d in enumerate(order):
        if d is None:
            y = y.unsqueeze(r)
    return y if tuple(y.shape) == tuple(shape) else y.expand(shape)


def _pad_index(mode, n, lo, hi) -> np.ndarray:
    """Source positions of a padded axis (``expr._pad_index`` in NumPy)."""
    i = np.arange(-lo, n + hi, dtype=np.int64)
    if mode == "edge":
        return np.clip(i, 0, n - 1)
    if mode == "wrap":
        return np.mod(i, n)
    if mode == "reflect":
        if n == 1:
            return np.zeros_like(i)
        p = np.mod(i, 2 * (n - 1))
        return np.where(p >= n, 2 * (n - 1) - p, p)
    p = np.mod(i, 2 * n)  # symmetric
    return np.where(p >= n, 2 * n - 1 - p, p)


def _pad_runs(mode, n, lo, hi) -> list:
    """A padded dim as runs: the fills and the operand's body, or the
    source indices of the other modes cut into affine runs (step -1, 0
    or 1)."""
    if mode in ("constant", "empty"):
        out = [(0, lo, ("fill",))] if lo else []
        out.append((lo, lo + n, ("map", None, 0, 1)))
        return out + ([(lo + n, lo + n + hi, ("fill",))] if hi else [])
    src = _pad_index(mode, n, lo, hi)
    out, a = [], 0
    while a < len(src):
        b, step = a + 1, 1
        if b < len(src) and abs(int(src[b] - src[a])) <= 1:
            step = int(src[b] - src[a])
            while b < len(src) and src[b] - src[b - 1] == step:
                b += 1
        out.append((a, b, ("map", None, int(src[a]), step)))
        a = b
    return out


def _identity_runs(shape) -> list:
    return [[(0, n, ("map", None, 0, 1))] if n else [] for n in shape]


def affine_of(node, tdt):
    """The :class:`_Affine` of a getitem, permute, broadcast_to, flip,
    concatenate, stack or pad node."""
    op = node.op
    shapes = [tuple(a.shape) for a in node.args]
    out_shape = tuple(node.shape)
    S = shapes[0]
    if op == "getitem":
        dims, fixed = _basic(S, node.static[0])
        ds, runs = [], []
        for m in dims:
            if m is None:
                ds.append(None)
                runs.append([(0, 1, ("new", None))])
            else:
                d, start, step, count = m
                ds.append(d)
                runs.append([(0, count, ("map", None, start, step))]
                            if count else [])
        return _Affine(shapes, out_shape, tdt, ds, runs, fixed)
    if op == "permute":
        axes = tuple(node.static[0])
        return _Affine(shapes, out_shape, tdt, list(axes),
                       _identity_runs(out_shape))
    if op == "flip":
        axes = set(node.static[0])
        runs = [[(0, n, ("map", None, n - 1, -1))] if d in axes and n else
                [(0, n, ("map", None, 0, 1))] if n else []
                for d, n in enumerate(S)]
        return _Affine(shapes, out_shape, tdt, list(range(len(S))), runs)
    if op == "broadcast_to":
        lead = len(out_shape) - len(S)
        dims, runs = [], []
        for r, n in enumerate(out_shape):
            if r < lead:
                dims.append(None)
                runs.append([(0, n, ("new", None))] if n else [])
                continue
            d = r - lead
            dims.append(d)
            step = 0 if S[d] != n else 1
            runs.append([(0, n, ("map", None, 0, step))] if n else [])
        return _Affine(shapes, out_shape, tdt, dims, runs)
    if op == "concatenate":
        ax = node.static[0] % len(S)
        runs = _identity_runs(out_shape)
        off, cat = 0, []
        for k, s in enumerate(shapes):
            if s[ax]:
                cat.append((off, off + s[ax], ("map", k, 0, 1)))
            off += s[ax]
        runs[ax] = cat
        return _Affine(shapes, out_shape, tdt, list(range(len(S))), runs)
    if op == "stack":
        ax = node.static[0] % (len(S) + 1)
        runs = _identity_runs(out_shape)
        runs[ax] = [(k, k + 1, ("new", k)) for k in range(len(shapes))]
        dims = [d for d in range(len(S))]
        dims.insert(ax, None)
        return _Affine(shapes, out_shape, tdt, dims, runs)
    assert op == "pad", op
    pw, mode = node.static
    runs = [_pad_runs(mode, n, lo, hi) if n else
            ([(0, lo + hi, ("fill",))] if lo + hi else [])
            for n, (lo, hi) in zip(S, pw)]
    fill = node.args[1].value if mode == "constant" \
        and len(node.args) > 1 else None
    return _Affine(shapes[:1], out_shape, tdt, list(range(len(S))), runs,
                   fill=fill)


def _flat(box, shape) -> tuple:
    """The flat range ``[a, b)`` of a flat-contiguous box of ``shape``."""
    a = b = 0
    for (lo, hi), n in zip(box, shape):
        a = a * n + lo
        b = b * n + hi - 1
    return a, b + 1


def _flat_runs(box, shape) -> list:
    """``box`` cut into flat-contiguous boxes, in C order."""
    nd = len(box)
    j = next((j for j in range(nd) if box[j][1] - box[j][0] > 1), None)
    if j is None or all(box[i] == (0, shape[i]) for i in range(j + 1, nd)):
        return [box]
    out = []
    for v in range(*box[j]):
        out.extend(_flat_runs(box[:j] + ((v, v + 1),) + box[j + 1:], shape))
    return out


def _flat_boxes(a, b, shape) -> list:
    """The flat range ``[a, b)`` of ``shape`` as boxes, in C order."""
    if a >= b:
        return []
    if not shape:
        return [()]
    if len(shape) == 1:
        return [((a, b),)]
    inner = math.prod(shape[1:])
    i0, r0 = divmod(a, inner)
    i1, r1 = divmod(b, inner)
    if i0 == i1:
        return [((i0, i0 + 1),) + x for x in _flat_boxes(r0, r1, shape[1:])]
    out = []
    if r0:
        out += [((i0, i0 + 1),) + x for x in _flat_boxes(r0, inner,
                                                           shape[1:])]
        i0 += 1
    if i0 < i1:
        out.append(((i0, i1),) + tuple((0, n) for n in shape[1:]))
    if r1:
        out += [((i1, i1 + 1),) + x for x in _flat_boxes(0, r1, shape[1:])]
    return out


class _Reshape:
    """A reshape of ``S`` into ``T``: each merge or split group's result
    box in flat-contiguous runs, each run the operand boxes its flat range
    covers; a piece is one run of every group."""

    def __init__(self, S, T, tdt):
        self.S, self.out_shape, self.tdt = tuple(S), tuple(T), tdt
        self.groups = [] if 0 in S else _groups(self.S, self.out_shape)

    def pieces(self, rbox):
        if _empty(rbox):
            return []
        S, T = self.S, self.out_shape
        per = []
        for gs, gt in self.groups:
            ts, ss = [T[r] for r in gt], [S[d] for d in gs]
            runs = []
            for run in _flat_runs(tuple(rbox[r] for r in gt), ts):
                a, b = _flat(run, ts)
                subs = [(ob, _flat(ob, ss)[0] - a)
                        for ob in _flat_boxes(a, b, ss)]
                runs.append((run, b - a, subs))
            per.append(runs)
        out = []
        for combo in itertools.product(*per):
            rsub = list(rbox)
            for (_gs, gt), (run, _n, _s) in zip(self.groups, combo):
                for r, rng in zip(gt, run):
                    rsub[r] = rng
            rsub = tuple(rsub)
            lens = tuple(n for _r, n, _s in combo)
            reads, places = [], []
            for sc in itertools.product(*[subs for _r, _n, subs in combo]):
                obox = [(0, 1)] * len(S)
                for (gs, _gt), (ob, _off) in zip(self.groups, sc):
                    for d, rng in zip(gs, ob):
                        obox[d] = rng
                reads.append((0, tuple(obox)))
                places.append(tuple((off, off + _vol(ob)) for ob, off in sc))
            out.append(Piece(rsub, reads, self._maker(lens, places,
                                                      _shape(rsub))))
        return out

    def _maker(self, lens, places, shape):
        def make(*xs):
            if len(xs) == 1:
                return xs[0].reshape(shape)
            buf = torch.empty(lens, dtype=xs[0].dtype, device=xs[0].device)
            for x, pl in zip(xs, places):
                buf[tuple(slice(a, b) for a, b in pl)] = x.reshape(
                    tuple(b - a for a, b in pl))
            return buf.reshape(shape)
        return make


class _Setitem:
    """A write through a basic index: a result block is the base's block
    with the part of the view's region that falls in it written from the
    value's boxes (operand 1; a Python scalar where ``value`` is one)."""

    def __init__(self, base_shape, enc, value_shape, tdt, scalar=None):
        self.out_shape, self.tdt = tuple(base_shape), tdt
        self.dims, self.fixed = _basic(self.out_shape, enc)
        self.vshape = tuple(value_shape)
        self.scalar = scalar

    def pieces(self, rbox):
        if _empty(rbox):
            return []
        out = [Piece(rbox, [(0, rbox)], lambda x: x)]
        for d, i in self.fixed.items():
            if not rbox[d][0] <= i < rbox[d][1]:
                return out
        target = [slice(None)] * len(rbox)
        for d, i in self.fixed.items():
            target[d] = i - rbox[d][0]
        view, flips = [], []
        for m in self.dims:
            if m is None:
                view.append((0, 1))
                continue
            d, start, step, count = m
            lo, hi = rbox[d]
            # t with lo <= start + step t < hi
            if step > 0:
                t0 = max(0, -(-(lo - start) // step))
                t1 = min(count, -(-(hi - start) // step))
            else:
                t0 = max(0, -(-(start - hi + 1) // -step))
                t1 = min(count, (start - lo) // -step + 1)
            if t1 <= t0:
                return out
            p0, p1 = start + step * t0 - lo, start + step * (t1 - 1) - lo
            if step > 0:
                target[d] = slice(p0, p1 + 1, step)
            else:
                target[d] = slice(p1, p0 + 1, -step)
                if t1 - t0 > 1:
                    flips.append(len(view))
            view.append((t0, t1))
        lead = len(view) - len(self.vshape)
        vbox = tuple((0, 1) if n == 1 or lead + j < 0 else view[lead + j]
                     for j, n in enumerate(self.vshape))
        keep = [i for i, m in enumerate(self.dims) if m is not None]
        fl = [keep.index(i) for i in flips]
        tshape = tuple(view[i][1] - view[i][0] for i in keep)
        ndt, scalar, nv = E.to_np_dtype(self.tdt), self.scalar, len(view)

        def make(x=None):
            dev = E.common.device()
            if x is None:
                return E.as_tensor(scalar, ndt, dev).to(dev).expand(tshape)
            y = x.reshape(tuple(x.shape)[max(0, x.dim() - nv):])
            y = y.reshape((1,) * (nv - y.dim()) + tuple(y.shape))
            y = y[tuple(slice(None) if i in keep else 0 for i in range(nv))]
            if fl:
                y = E._unbits(torch.flip(E._bits(y), fl), y.dtype)
            return E.as_tensor(y, ndt).expand(tshape)
        reads = [] if scalar is not None else [(1, vbox)]
        out.append(Piece(None, reads, make, write=tuple(target)))
        return out


def op_of(node, tdt, scalar=None):
    """The piece generator of a movement node."""
    if node.op == "reshape":
        return _Reshape(node.args[0].shape, node.static[0], tdt)
    if node.op == "setitem":
        v = node.args[1]
        return _Setitem(node.args[0].shape, node.static[0],
                        () if scalar is not None else v.shape, tdt, scalar)
    return affine_of(node, tdt)


# ---------------------------------------------------------------------------
# the plan: the same on every rank
# ---------------------------------------------------------------------------


class Operand:
    """An array a movement reads: global shape, layout and dtype, and per
    rank its regions (its distinct blocks in grid order; blocks of a 1-D
    array that lie side by side merged into one)."""

    def __init__(self, shape, sharding, tdt):
        self.shape, self.sharding, self.tdt = tuple(shape), sharding, tdt
        self.item = torch.empty((), dtype=tdt).element_size()
        self._regions: dict = {}

    def blocks(self, q) -> list:
        """``[(coords, box, position)]`` of rank ``q``'s blocks."""
        sh, nd = self.sharding, len(self.shape)
        return [(sh.block_coords(p, nd), _mesh.index_box(i, self.shape), p)
                for p, i in sh.rank_blocks(q, self.shape)]

    def regions(self, q) -> list:
        """``[(box, positions, blocks)]``: rank ``q``'s regions, each with
        the positions and the indices (in its held order) of its
        blocks."""
        got = self._regions.get(q)
        if got is None:
            got = []
            for j, (_c, box, p) in enumerate(self.blocks(q)):
                if got and len(self.shape) == 1 \
                        and got[-1][0][0][1] == box[0][0]:
                    b0, ps, js = got[-1]
                    got[-1] = (((b0[0][0], box[0][1]),), ps + [p], js + [j])
                else:
                    got.append((box, [p], [j]))
            self._regions[q] = got
        return got

    def holds(self, q, coords) -> bool:
        return any(c == coords for c, _b, _p in self.blocks(q))

    def region_of(self, q, box):
        for i, (rb, _ps, _js) in enumerate(self.regions(q)):
            if _inside(box, rb):
                return i
        return None

    def local_regions(self, value) -> list:
        """This rank's region tensors of ``value`` (its packed blocks)."""
        me = distributed.process_index()
        held = self.sharding.split_local(value, self.shape)
        out = []
        for _box, _ps, js in self.regions(me):
            if len(js) == 1:
                out.append(held[js[0]])
            else:
                off = sum(held[j].numel() for j in range(js[0]))
                n = sum(held[j].numel() for j in js)
                out.append(value[off:off + n])
        return out


class Move:
    """One movement node: its piece generator, result shape, layout and
    dtype, the operands (indices into its group's) it reads."""

    def __init__(self, op, oshape, osharding, tdt, operands):
        self.op, self.oshape, self.osharding = op, tuple(oshape), osharding
        self.tdt, self.operands = tdt, operands
        self.out = Operand(oshape, osharding, tdt)


def _merge(need) -> list:
    """``[[operand, box, anchor, members]]``: the boxes the reads of one
    operand for one result region (its ``anchor``) need, merged while
    their bounding box is no larger than their sizes summed."""
    out = []
    for k, box, anchor in need:
        for e in out:
            if e[0] != k or e[2] != anchor:
                continue
            bb = _bbox(e[1], box)
            if _vol(bb) <= sum(_vol(m) for m in e[3]) + _vol(box):
                e[1] = bb
                e[3].append(box)
                break
        else:
            out.append([k, box, anchor, [box]])
    return out


class Group:
    """Movements planned and run together: they share their operands'
    exchange, and the reads of one operand share its merged boxes.
    ``plan[q]``: per move, per result region ``(box, pieces)``;
    ``where[q]``: read -> ``("region", i)``, ``("ext", i)`` or None (an
    empty box); ``exts[q]``: ``[(operand, box, [(coords, part, src)])]``;
    ``transfers``: ``(operand, part, src, dst)``, each once a
    destination, in one order on every rank."""

    def __init__(self, moves, operands, mesh):
        self.moves, self.operands, self.mesh = moves, operands, mesh
        world = distributed.process_count()
        self.plan, self.where, self.exts = {}, {}, {}
        self.transfers, seen = [], set()
        for q in range(world):
            reads = {}
            plan = []
            for m in moves:
                regs = []
                for box, ps, _js in m.out.regions(q):
                    pieces = m.op.pieces(box)
                    regs.append((box, pieces))
                    for p in pieces:
                        for k, ob in p.reads:
                            reads.setdefault((m.operands[k], ob), ps[0])
                plan.append(regs)
            self.plan[q] = plan
            where, need = {}, []
            for (k, ob), anchor in reads.items():
                if _empty(ob):
                    where[(k, ob)] = None
                    continue
                i = operands[k].region_of(q, ob)
                if i is not None:
                    where[(k, ob)] = ("region", i)
                else:
                    need.append((k, ob, anchor))
            exts = []
            for ei, (k, eb, anchor, members) in enumerate(_merge(need)):
                for ob in members:
                    where[(k, ob)] = ("ext", ei)
                opd = operands[k]
                parts = []
                for coords, bb in _mesh.covering(opd.sharding, opd.shape,
                                                 eb):
                    part = _intersect(eb, bb)
                    src = q if opd.holds(q, coords) else mesh.rank_at(
                        _mesh.nearest_holder(opd.sharding, len(opd.shape),
                                             coords, anchor))
                    parts.append((coords, part, src))
                    key = (k, part, src, q)
                    if src != q and key not in seen:
                        seen.add(key)
                        self.transfers.append(key)
                exts.append((k, eb, parts))
            self.where[q], self.exts[q] = where, exts

    def received(self, q) -> int:
        return sum(_vol(p) * self.operands[k].item
                   for k, p, _s, d in self.transfers if d == q)

    def bound_bytes(self, q) -> int:
        """The device bytes rank ``q`` may hold beyond its operands: the
        boxes it assembles, what it receives and sends, its result
        regions, and their packed copy where it holds several blocks of
        more than one dim."""
        n = sum(_vol(eb) * self.operands[k].item
                for k, eb, _p in self.exts[q])
        n += sum(_vol(p) * self.operands[k].item
                 for k, p, s, d in self.transfers if q in (s, d))
        for m in self.moves:
            regs = m.out.regions(q)
            res = sum(_vol(b) for b, _p, _j in regs) * m.out.item
            n += res * (2 if len(regs) > 1 else 1)
        return n


# ---------------------------------------------------------------------------
# running it
# ---------------------------------------------------------------------------


def _round(err, site, tag):
    rankdot._round(err, site, tag, check="move:round", magic=_MAGIC,
                   counts=stats)


def _pack(vals):
    """Several result regions as the tensor a rank holds (each flattened,
    in grid order); the bytes moved on a signed view (torch concatenates
    no uint16/32/64 on the card)."""
    if len(vals) == 1:
        return vals[0]
    tdt = vals[0].dtype
    return E._unbits(torch.cat([E._bits(v).reshape(-1) for v in vals]), tdt)


def move(group: Group, values) -> list:
    """Run ``group`` on this rank over its operands' held values (each
    operand's leaf value, its blocks packed); returns each movement's
    result as a leaf in its layout."""
    me = distributed.process_index()
    dev = E.common.device()
    stats["movements"] += len(group.moves)
    last.clear()
    last.update(exts=[(k, eb) for k, eb, _p in group.exts.get(me, [])],
                received=[(k, p, s) for k, p, s, d in group.transfers
                          if d == me],
                bound_bytes=group.bound_bytes(me))
    err = None
    held, sends, mine = [], [], []
    try:
        held = [opd.local_regions(v)
                for opd, v in zip(group.operands, values)]
        for k, p, s, d in group.transfers:
            if s == me:
                opd = group.operands[k]
                i = opd.region_of(me, p)
                sends.append((held[k][i][_rel(p, opd.regions(me)[i][0])],
                              d))
        mine = [(k, p, s) for k, p, s, d in group.transfers if d == me]
    except Exception as e:  # noqa: BLE001 - every rank learns of it
        err = e
    got = {}
    if group.transfers:
        # a rank that failed raises here, with every rank, before any
        # waits in an exchange it skipped
        _round(err, "move:boxes", "boxes")
        vals = distributed.exchange(sends, [
            (_shape(p), group.operands[k].tdt, s) for k, p, s in mine])
        got = dict(zip(mine, vals))
        stats["bytes_received"] += sum(v.numel() * v.element_size()
                                       for v in vals)
    outs = []
    try:
        if err is None:
            outs = _assemble(group, held, got, me, dev)
    except Exception as e:  # noqa: BLE001 - every rank learns of it
        err = e
    del got
    _round(err, "move:done", "done")
    return outs


def _assemble(group, held, got, me, dev):
    """The merged boxes filled, then every piece of every result region
    this rank holds; each movement's result as a leaf."""
    exts = []
    for k, eb, parts in group.exts.get(me, []):
        opd = group.operands[k]
        x = torch.empty(_shape(eb), dtype=opd.tdt, device=dev)
        xb = E._bits(x)
        for _c, part, src in parts:
            if src == me:
                i = opd.region_of(me, part)
                v = held[k][i][_rel(part, opd.regions(me)[i][0])]
            else:
                v = got[(k, part, src)]
            xb[_rel(part, eb)] = E._bits(v)
        exts.append(x)
        stats["copies"] += 1
    where = group.where.get(me, {})

    def read(k, ob):
        w = where[(k, ob)]
        if w is None:
            return torch.empty(_shape(ob), dtype=group.operands[k].tdt,
                               device=dev)
        if w[0] == "region":
            stats["views"] += 1
            box = group.operands[k].regions(me)[w[1]][0]
            return held[k][w[1]][_rel(ob, box)]
        return exts[w[1]][_rel(ob, group.exts[me][w[1]][1])]

    outs = []
    for m, regs in zip(group.moves, group.plan.get(me, [])):
        vals = []
        for box, pieces in regs:
            faults.check("move:piece")
            if len(pieces) == 1 and pieces[0].write is None \
                    and pieces[0].rsub == box:
                p = pieces[0]
                v = p.make(*[read(m.operands[k], ob) for k, ob in p.reads])
            else:
                v = torch.empty(_shape(box), dtype=m.tdt, device=dev)
                vb = E._bits(v)
                for p in pieces:
                    x = p.make(*[read(m.operands[k], ob)
                                 for k, ob in p.reads])
                    idx = p.write if p.write is not None \
                        else _rel(p.rsub, box)
                    vb[idx] = E._bits(x)
            vals.append(v)
        outs.append(_result(m, vals, dev))
    return outs


def _result(m, vals, dev):
    """A movement's result as a leaf: its regions packed, in its
    layout."""
    if not m.oshape:
        v = vals[0] if vals else torch.zeros((), dtype=m.tdt, device=dev)
        return E.Const(v.reshape(()))
    if not vals:  # a rank outside the mesh: its empty block
        vals = [torch.empty(_mesh.index_shape(
            m.osharding.local_index(m.oshape), m.oshape), dtype=m.tdt,
            device=dev)]
    return E.Const(_pack(vals), sharding=m.osharding, shape=m.oshape)
