"""The stencil over a mesh of shards: halo exchange, then the stencil on
each shard's halo-extended block.

Counterpart of ``ramba_tpu/ops/stencil_sharded.py``.  Each shard

1. receives halo slabs from its neighbours along each split dim, last dim
   first, so a later exchange ships the already-extended slab and corner
   halos ride along; end shards receive zeros;
2. evaluates the stencil over its extended block: through the CUDA
   stencil kernel on the card (``ops/stencil_kernel.py``, one launch per
   shard per sweep, eligibility decided once before the launches), else by
   shifted slices: the interior/strip schedule of :func:`_overlapped_val`
   wherever the block has an interior, as the reference takes it where its
   kernel does not run, else the kernel wrapper's plain version;
3. masks cells whose *global* neighbourhood leaves the array (sstencil
   writes only fully in-range cells; borders are zero).

The split is ``default_spec`` of the current mesh, whatever layout the
operands carry, as the reference's ``shard_map`` re-splits them on entry.
Inputs are zero-padded to a shard-divisible shape; the padding is masked
and sliced off.  One process drives every shard: a shard's extended block
is one buffer, its own cells copied in once and each halo slab written in
through :func:`parallel.transport` (an in-process read now; the
multi-process slice swaps in send/recv).  Per-shard results are written
into one output tensor (``parallel.comm_stats["shard_assemble_*"]``).
``stencil.halo_bytes_est`` counts, per run (per sweep), what the
reference's trace-time estimate counts per trace: per exchange, one slab
for every neighbouring pair along the split mesh axes.

Nothing falls back: a kernel that fails to build or launch raises, and a
stencil the kernel does not take is known before anything launches.
"""

from __future__ import annotations

import itertools
import math

import torch

from ramba_tpu_torch import common, parallel
from ramba_tpu_torch.observe import registry as _registry
from ramba_tpu_torch.parallel import mesh as _mesh


def _axis_entries(mesh, shape):
    """Mesh-axis names per array dim, from the default layout (not the
    one an operand carries)."""
    spec = _mesh.default_spec(shape, mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    return [_mesh.entry_names(e) for e in entries]


def _counts(mesh, ents):
    return [math.prod(mesh.shape[a] for a in e) if e else 1 for e in ents]


def eligible(lo, hi, arrs) -> bool:
    """True when the sharded halo path applies (any rank)."""
    mesh = _mesh.get_mesh()
    if mesh.size <= 1:
        return False
    shapes = {tuple(a.shape) for a in arrs}
    if len(shapes) != 1:
        return False
    (shape,) = shapes
    if len(shape) < 1 or len(shape) != len(lo):
        return False
    if math.prod(shape) < common.dist_threshold:
        return False  # replicated small arrays: local compute is free
    ents = _axis_entries(mesh, shape)
    if not any(ents):
        return False  # the layout keeps the array whole: nothing to exchange
    for d, n in enumerate(_counts(mesh, ents)):
        # each halo must fit inside one neighbouring shard
        if max(-lo[d], hi[d]) > -(-shape[d] // n):
            return False
    return True


def _region(nd, d, los, his, local, span_d):
    """Index of a halo slab inside an extended block: ``span_d`` along dim
    ``d``, the whole extended extent along the dims already exchanged
    (> d), the block's own cells along the others (< d)."""
    idx = []
    for e in range(nd):
        if e == d:
            idx.append(span_d)
        elif e > d:
            idx.append(slice(None))
        else:
            idx.append(slice(los[e], los[e] + local[e]))
    return tuple(idx)


def _exchange(exts, counts, d, los, his, local):
    """Fill every shard's halo slabs along dim ``d`` from its neighbours'
    extended blocks (zeros at the ends of the mesh)."""
    nd = len(local)
    slabs = []
    if los[d]:  # the lower neighbour's last cells
        slabs.append((slice(0, los[d]), -1,
                      slice(local[d], local[d] + los[d])))
    if his[d]:  # the upper neighbour's first cells
        top = los[d] + local[d]
        slabs.append((slice(top, top + his[d]), 1,
                      slice(los[d], los[d] + his[d])))
    flat = {c: k for k, c in enumerate(exts)}
    for dst_span, step, src_span in slabs:
        dst_idx = _region(nd, d, los, his, local, dst_span)
        src_idx = _region(nd, d, los, his, local, src_span)
        if counts[d] > 1:
            for e in next(iter(exts.values())):
                _registry.inc("stencil.halo_bytes_est", (counts[d] - 1)
                              * e[dst_idx].numel() * e.element_size())
        for c, bufs in exts.items():
            n = c[:d] + (c[d] + step,) + c[d + 1:]
            for k, e in enumerate(bufs):
                if 0 <= n[d] < counts[d]:
                    e[dst_idx] = parallel.transport(
                        exts[n][k][src_idx], flat[n], flat[c])
                else:
                    e[dst_idx] = 0


def _extended(blocks, counts, los, his, local, exts=None):
    """Per shard, one buffer per slot (``exts`` reuses earlier ones): the
    block's own cells in the middle and its halo slabs around them."""
    ext_shape = tuple(l + a + b for l, a, b in zip(local, los, his))
    centre = tuple(slice(a, a + l) for a, l in zip(los, local))
    if exts is None:
        exts = {c: [torch.empty(ext_shape, dtype=b.dtype, device=b.device)
                    for b in bs] for c, bs in blocks.items()}
    for c, bs in blocks.items():
        for e, b in zip(exts[c], bs):
            e[centre] = b
    for d in range(len(local) - 1, -1, -1):
        if los[d] or his[d]:
            _exchange(exts, counts, d, los, his, local)
    return exts


def _blocks(arrs, counts, local):
    """``coords -> [block of each slot]`` (views), coords in grid order."""
    out = {}
    for c in itertools.product(*[range(n) for n in counts]):
        idx = tuple(slice(k * l, (k + 1) * l) for k, l in zip(c, local))
        out[c] = [a[idx] for a in arrs]
    return out


def _pad(a, shape):
    if tuple(a.shape) == shape:
        return a
    out = torch.zeros(shape, dtype=a.dtype, device=a.device)
    out[tuple(slice(0, s) for s in a.shape)] = a
    return out


def _mask(out, shape, los, his):
    """Zero every cell whose global neighbourhood leaves the array (and the
    padding beyond ``shape``)."""
    for d in range(out.ndim):
        idx = [slice(None)] * out.ndim
        if los[d]:
            idx[d] = slice(0, los[d])
            out[tuple(idx)] = 0
        idx[d] = slice(max(shape[d] - his[d], 0), out.shape[d])
        out[tuple(idx)] = 0


def run(func, lo, hi, slots, arrs, iters=1):
    """The stencil over the mesh with halo exchange (any rank): ``iters``
    sweeps with slot 0 as the carry (already in the sweep's dtype when
    ``iters > 1``) and the other slots loop-invariant.  Returns the
    full-shape result with border cells zeroed."""
    from ramba_tpu_torch.ops import stencil_kernel

    if iters == 0:
        return arrs[0]
    mesh = _mesh.get_mesh()
    shape = tuple(arrs[0].shape)
    nd = len(shape)
    los = tuple(-l for l in lo)
    his = tuple(hi)
    counts = _counts(mesh, _axis_entries(mesh, shape))
    padded = tuple(-(-s // c) * c for s, c in zip(shape, counts))
    local = tuple(p // c for p, c in zip(padded, counts))
    inner = tuple(l - (a + b) for l, a, b in zip(local, los, his))
    dev = arrs[0].device
    carry = _pad(arrs[0], padded)
    rest_blocks = _blocks([_pad(a, padded) for a in arrs[1:]], counts, local)
    rest_exts = _extended(rest_blocks, counts, los, his, local)
    blocks = _blocks([carry], counts, local)
    exts = _extended(blocks, counts, los, his, local)

    # decided once, before any launch
    c0 = next(iter(exts))
    avail = nd == 2 and stencil_kernel.available(
        func, lo, hi, slots, exts[c0] + rest_exts[c0])
    kernel = avail and dev.type == "cuda"
    overlap = (not kernel and nd == 2
               and all(i > 0 for i in inner) and (any(los) or any(his)))
    scratch = torch.empty_like(exts[c0][0]) if kernel else None
    own = tuple(slice(a, a + l) for a, l in zip(los, local))
    outs = [None, None]
    for sweep in range(iters):
        if sweep:
            blocks = _blocks([carry], counts, local)
            exts = _extended(blocks, counts, los, his, local, exts)
        out = outs[sweep % 2]
        for c in blocks:
            ext = exts[c] + rest_exts[c]
            if kernel:
                val = stencil_kernel.launch(func, lo, hi, slots, ext,
                                            scratch)[own]
            elif overlap:
                val = _overlapped_val(func, lo, hi, slots,
                                      blocks[c] + rest_blocks[c], ext, local)
            else:
                val = _local_stencil(func, lo, hi, slots, ext, local, avail)
            if out is None:
                out = outs[sweep % 2] = torch.empty(
                    padded, dtype=val.dtype, device=dev)
            out[tuple(slice(k * l, (k + 1) * l)
                      for k, l in zip(c, local))] = val
            parallel.note_transfer("shard_assemble",
                                   val.numel() * val.element_size())
        _mask(out, shape, los, his)
        carry = out
    if padded == shape:
        return carry
    return carry[tuple(slice(0, s) for s in shape)].contiguous()


def _overlapped_val(func, lo, hi, slots, blocks, exts, shape):
    """Local ``(lh, lw)`` stencil values from five pieces: the interior,
    computed from the un-extended blocks alone (no dependence on the
    halos), and four border strips (top/bottom full width, left/right
    between them) computed from the extended blocks.  The pieces tile the
    block exactly: no cell is computed twice."""
    from ramba_tpu_torch.skeletons import stencil_interior

    lh, lw = shape
    top, left = -lo[0], -lo[1]
    bottom, right = hi[0], hi[1]
    hr, hc = top + bottom, left + right

    interior = stencil_interior(func, lo, hi, slots, blocks)

    def strip(r_lo, r_hi, c_lo, c_hi):
        # output cell (r, c) reads ext rows [r, r + hr], cols [c, c + hc]
        pieces = [e[r_lo:r_hi + hr, c_lo:c_hi + hc] for e in exts]
        return stencil_interior(func, lo, hi, slots, pieces)

    rows = []
    if top:
        rows.append(strip(0, top, 0, lw))
    mid = []
    if left:
        mid.append(strip(top, lh - bottom, 0, left))
    mid.append(interior)
    if right:
        mid.append(strip(top, lh - bottom, lw - right, lw))
    rows.append(mid[0] if len(mid) == 1 else torch.cat(mid, dim=1))
    if bottom:
        rows.append(strip(lh - bottom, lh, 0, lw))
    return rows[0] if len(rows) == 1 else torch.cat(rows, dim=0)


def _local_stencil(func, lo, hi, slots, exts, local, kernel):
    """Stencil over a halo-extended block: the local-shape values (no
    masking: the caller masks in global coordinates).  ``kernel``: the
    stencil kernel's wrapper takes the block (its plain version on CPU
    tensors)."""
    from ramba_tpu_torch.ops import stencil_kernel
    from ramba_tpu_torch.skeletons import stencil_interior

    if kernel:
        full = stencil_kernel.run(func, lo, hi, slots, exts)
        return full[tuple(slice(-l, -l + n) for l, n in zip(lo, local))]
    return stencil_interior(func, lo, hi, slots, exts)


# --- across ranks -------------------------------------------------------------


def fits(lo, hi, shape, sharding) -> bool:
    """True when every halo fits inside one neighbouring block of the
    layout (``run_block`` takes it)."""
    counts = sharding.split_counts(len(shape))
    return all(max(-l, h) <= -(-n // c)
               for l, h, n, c in zip(lo, hi, shape, counts) if c > 1)


def _rank_exchange(exts, held, d, los, his, local, sharding, shape,
                   counts):
    """Fill the halo slabs along dim ``d`` of this rank's extended blocks
    (``exts[j]``: the buffers of held position ``held[j]``).  Every rank
    walks one list of moves in the same order: for each rank, each of its
    held blocks, the low then the high halo, each buffer; a move from a
    block of the same rank is a device copy, the others go over
    send/recv (the lower neighbour sends its last cells, the upper its
    first), and a halo past the end of the mesh is zeros."""
    from ramba_tpu_torch.parallel import distributed

    nd = len(local)
    me = distributed.process_index()
    mesh = sharding.mesh
    top = los[d] + local[d]
    low_halo = _region(nd, d, los, his, local, slice(0, los[d]))
    high_halo = _region(nd, d, los, his, local, slice(top, top + his[d]))
    first = _region(nd, d, los, his, local, slice(los[d], los[d] + his[d]))
    last = _region(nd, d, los, his, local, slice(local[d], top))
    if exts and counts[d] > 1:
        for e in exts[0]:
            for width, idx in ((los[d], low_halo), (his[d], high_halo)):
                if width:
                    _registry.inc("stencil.halo_bytes_est", (counts[d] - 1)
                                  * e[idx].numel() * e.element_size())
    mine = {sharding.block_coords(p, nd): j for j, p in enumerate(held)}
    nbuf = len(exts[0]) if exts else 0
    sends, recvs, into = [], [], []
    for r in range(distributed.process_count()):
        for p, _idx in sharding.rank_blocks(r, shape):
            for width, halo, slab, step in ((los[d], low_halo, last, -1),
                                            (his[d], high_halo, first, 1)):
                if not width:
                    continue
                nb = sharding.neighbour_pos(p, nd, d, step)
                src = None if nb is None else mesh.rank_at(nb)
                if r != me and src != me:
                    continue
                for b in range(nbuf):
                    if nb is None:
                        exts[mine[sharding.block_coords(p, nd)]][b][halo] = 0
                        continue
                    frm = mine.get(sharding.block_coords(nb, nd))
                    if r == me and src == me:  # both blocks are this rank's
                        to = mine[sharding.block_coords(p, nd)]
                        exts[to][b][halo] = exts[frm][b][slab]
                    elif src == me:
                        sends.append((exts[frm][b][slab], r))
                    else:
                        e = exts[mine[sharding.block_coords(p, nd)]][b]
                        recvs.append((tuple(e[halo].shape), e.dtype, src))
                        into.append((e, halo))
    if sends or recvs:
        got = distributed.exchange(sends, recvs)
        for (e, idx), v in zip(into, got):
            e[idx] = v


def _mask_block(out, shape, los, his, origin):
    """Zero the cells of a block at ``origin`` whose global neighbourhood
    leaves the array (and the padding beyond ``shape``)."""
    for d in range(out.ndim):
        idx = [slice(None)] * out.ndim
        if los[d] > origin[d]:
            idx[d] = slice(0, los[d] - origin[d])
            out[tuple(idx)] = 0
        start = max(shape[d] - his[d] - origin[d], 0)
        if start < out.shape[d]:
            idx[d] = slice(start, out.shape[d])
            out[tuple(idx)] = 0


def run_block(func, lo, hi, slots, blocks, shape, sharding, iters=1,
              held=None):
    """The stencil over a mesh of ranks, on this rank's blocks:
    ``blocks[s]`` holds slot ``s``'s block of every held position
    ``held`` (grid order); ``iters`` sweeps with slot 0 as the carry
    (already in the sweep's dtype when ``iters > 1``) and the other slots
    loop-invariant.  Each block is zero-padded to the layout's uniform
    block (ceil(n / parts)), extended by halo slabs from the neighbouring
    blocks (last dim first, so corners arrive in two hops; a rank's own
    neighbour by a device copy, another's over send/recv), swept by the
    CUDA stencil kernel (one launch per block per sweep; its plain
    version on the CPU), masked in global coordinates and cut back to the
    block: the bytes of the one-process sharded stencil (:func:`run`).
    Returns the result blocks, in ``held`` order."""
    from ramba_tpu_torch.ops import stencil_kernel

    nd = len(shape)
    k = len(held)
    reals = [tuple(b.shape) for b in blocks[0]]
    if iters == 0:
        return list(blocks[0])
    los = tuple(-l for l in lo)
    his = tuple(hi)
    counts = sharding.split_counts(nd)
    local = tuple(-(-s // c) for s, c in zip(shape, counts))
    origins = [tuple(c * l for c, l in zip(sharding.block_coords(p, nd),
                                             local)) for p in held]
    ext_shape = tuple(l + a + b for l, a, b in zip(local, los, his))
    own = tuple(slice(a, a + l) for a, l in zip(los, local))

    def extend(per_block, exts=None):
        if exts is None:
            exts = [[torch.empty(ext_shape, dtype=b.dtype, device=b.device)
                     for b in bs] for bs in per_block]
        for ej, bs in zip(exts, per_block):
            for e, b in zip(ej, bs):
                e[own] = _pad(b, local)
        for d in range(nd - 1, -1, -1):
            if los[d] or his[d]:
                _rank_exchange(exts, held, d, los, his, local, sharding,
                               shape, counts)
        return exts

    rest_exts = extend([[blocks[s][j] for s in range(1, len(blocks))]
                        for j in range(k)])
    carries = list(blocks[0])
    exts = extend([[c] for c in carries])
    dev = carries[0].device
    avail = nd == 2 and stencil_kernel.available(func, lo, hi, slots,
                                                 exts[0] + rest_exts[0])
    kernel = avail and dev.type == "cuda"
    inner = tuple(l - (a + b) for l, a, b in zip(local, los, his))
    overlap = (not kernel and nd == 2
               and all(i > 0 for i in inner) and (any(los) or any(his)))
    scratch = torch.empty_like(exts[0][0]) if kernel else None
    outs = [[None, None] for _ in range(k)]
    for sweep in range(iters):
        if sweep:
            exts = extend([[c] for c in carries], exts)
        for j in range(k):
            ext = exts[j] + rest_exts[j]
            if kernel:
                val = stencil_kernel.launch(func, lo, hi, slots, ext,
                                            scratch)[own]
            elif overlap:
                bl = [e[own] for e in ext]
                val = _overlapped_val(func, lo, hi, slots, bl, ext, local)
            else:
                val = _local_stencil(func, lo, hi, slots, ext, local, avail)
            out = outs[j][sweep % 2]
            if out is None:
                out = outs[j][sweep % 2] = torch.empty(
                    local, dtype=val.dtype, device=dev)
            out.copy_(val)
            _mask_block(out, shape, los, his, origins[j])
            carries[j] = out
    return [c[tuple(slice(0, r) for r in real)].clone()
            for c, real in zip(carries, reals)]
