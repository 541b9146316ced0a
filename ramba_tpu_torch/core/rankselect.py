"""Order statistics across ranks: an exact k-th element selection and the
complex extremes, over the blocks of a mesh of ranks.

Every owner position of a plan (``core/rankflush.py``) is a :class:`Part`:
its block of the operand with the reduced dims flattened last, one row a
slice of the result (``rows``: the slices' global ids), the columns in
the slice's C order.  Every rank knows every part's rows and holder from
the layout; only the holder has its values.

:func:`select` returns the values at given positions of every slice's
sorted values, exactly: the order is ``jnp.sort``'s, by the integer key
of ``expr.order_key`` (both zeros equal, NaN last), equal values in the
slice's flat index order (as a stable sort of the whole slice leaves
them).  Each held part is sorted once along its rows (in pieces of at
most :data:`PIECE` keys, so the temporaries stay below the block), then
the ranks run rounds, each one all-gather of int64 counts:

1. a census: per slice the NaNs, the keys below 0, the zeros and the
   negative zeros.  Every rank then forms the positions from the counts
   (the caller's function: the medians' and quantiles' own,
   ``expr.median_positions``, ``extras.quantile_positions``);
2. a search over the key for every position whose value is not a
   zero: each round every part counts its keys below :data:`ARITY` - 1
   pivots (``searchsorted`` over its sorted pieces), the counts are
   summed, and the interval shrinks four-fold; the negative and the
   positive keys are split by the census, so each interval is narrower
   than 2**(width - 1): 32 rounds for float64, 16 for float32;
3. where the value is a zero and the slice holds zeros of both signs, a
   search over the flat index for the zero at that rank among the
   slice's zeros (its sign is the value's): each round counts the zeros,
   and the negative zeros, before ``A - 1`` pivots (prefix sums of a
   part's zeros), ``A`` chosen so these rounds stay within the width.

Every rank runs the same rounds (the stop is read from the gathered
counts), so a selection takes at most the key's width in rounds (33 for
float64 away from the zeros), and what crosses ranks is a few integers
per slice and position a round, never the values.  A rank whose sort or census failed
joins the census with a failure flag: every rank raises there
(``CoherentAbort``, retryable, on the others), before any round a peer
would wait in.  The ``select:round`` fault site is checked before every
round (``select:round:hang:ms=...:rank=1`` stalls one rank inside a
selection; under the watchdog the others' deadline breaks the group).

:func:`extreme` is ``jnp.max``/``jnp.min`` of complex values, which XLA
folds in order (``acc = acc if acc > v else v``, lexicographic, a NaN
comparing false): after the last element whose real part is NaN, the
largest real part; among its elements, after the last one whose
imaginary part is NaN, the largest imaginary part; the last among
equals (``expr._complex_extreme``'s closed form).  Three rounds find
the flat indices those clauses name (the last NaN real part; the largest
real part after it with the last index of its elements and of their NaN
imaginary parts; the largest imaginary part after that and its last
index), each part sending its candidates' indices and values, so the
result is the very element one process picks.
"""

from __future__ import annotations

import math
import time

import torch

from ramba_tpu_torch.core import expr as E
from ramba_tpu_torch.parallel import distributed
from ramba_tpu_torch.resilience import coherence, faults

PIECE = 1 << 22  # the longest run of keys sorted as one
ARITY = 4  # a value round's pivots split the key interval in four
CHUNK = 1 << 24  # keys made and sorted at once

# counters: selections and complex extremes run, their rounds (the last
# selection's too), the seconds of the selections' sorts and censuses on
# this rank and of their rounds
stats = {"selections": 0, "extremes": 0, "rounds": 0, "last_rounds": 0,
         "prep_s": 0.0, "round_s": 0.0}


class Part:
    """One owner position's block of a selection.  ``rows``: the global
    ids of its slices (int64, on the CPU); ``starts``/``sizes``: its box
    along the reduced dims; ``rank``: the rank holding it; ``values``:
    the block as ``(len(rows), prod(sizes))`` on the holder (None on
    every other rank)."""

    __slots__ = ("rows", "starts", "sizes", "rank", "values", "sorted",
                 "zeros", "census")

    def __init__(self, rows, starts, sizes, rank, values=None):
        self.rows, self.starts, self.sizes = rows, starts, sizes
        self.rank, self.values = rank, values
        self.sorted = self.census = self.zeros = None


def flat_index(part, cols, gsizes):
    """The flat index in the slice (C order over the reduced dims of the
    global extents ``gsizes``) of the part's columns ``cols``; increasing
    with the column."""
    out = torch.zeros_like(cols)
    rem = cols
    stride = 1
    for d in range(len(part.sizes) - 1, -1, -1):
        out = out + (rem % part.sizes[d] + part.starts[d]) * stride
        rem = rem // part.sizes[d]
        stride *= gsizes[d]
    return out


def _sorted_pieces(values):
    """The keys of ``values`` (``(R, L)``) sorted within pieces of at most
    :data:`PIECE` along each row: ``(R, pieces, width)``, the last piece
    padded with the key dtype's largest value (above every key)."""
    R, L = values.shape
    kdt = E._KEY_DTYPES[values.dtype]
    width = max(1, min(L, PIECE))
    npc = -(-L // width)
    out = torch.empty((R, npc, width), dtype=kdt, device=values.device)
    top = torch.iinfo(kdt).max

    def keys(v, c0, c1):  # the keys of columns [c0, c1) padded to pieces
        k = E.order_key(v[:, c0:min(c1, L)])
        if k.shape[1] < c1 - c0:
            k = torch.cat([k, torch.full((k.shape[0], c1 - c0 - k.shape[1]),
                                         top, dtype=kdt, device=k.device)],
                          dim=1)
        return k.reshape(k.shape[0], -1, width)

    if npc == 1:
        per = max(1, CHUNK // width)
        for r0 in range(0, R, per):
            out[r0:r0 + per] = torch.sort(
                keys(values[r0:r0 + per], 0, width), dim=-1).values
        return out
    per = max(1, CHUNK // width)  # pieces a chunk
    for r in range(R):
        for p0 in range(0, npc, per):
            p1 = min(npc, p0 + per)
            out[r, p0:p1] = torch.sort(
                keys(values[r:r + 1], p0 * width, p1 * width)[0],
                dim=-1).values
    return out


def _count_below(part, pivots):
    """``(R, P)``: the part's keys below ``pivots`` (``(R, P)``, int64),
    per row."""
    srt = part.sorted
    R, npc, _w = srt.shape
    piv = pivots.to(device=srt.device, dtype=srt.dtype)
    piv = piv.unsqueeze(1).expand(R, npc, piv.shape[1]).contiguous()
    return torch.searchsorted(srt, piv).sum(1)


def _gather_rounds(parts, payload, sizes_of, tag, head=0):
    """One round: this rank's payload (int64: ``head`` integers, then its
    held parts' in grid order), every rank's back, split per part by
    ``sizes_of(part)``.  Returns the parts' pieces, or with a ``head``
    ``(heads per rank, pieces)``."""
    faults.check("select:round", round=tag)
    world = distributed.process_count()
    per_rank = [head] * world
    for p in parts:
        per_rank[p.rank] += sizes_of(p)
    got = distributed.all_gather(payload, [(n,) for n in per_rank])
    stats["rounds"] += 1
    off = [head] * world
    out = []
    for p in parts:
        n = sizes_of(p)
        out.append(got[p.rank][off[p.rank]:off[p.rank] + n])
        off[p.rank] += n
    return ([g[:head] for g in got], out) if head else out


def _mine(parts):
    me = distributed.process_index()
    return [p for p in parts if p.rank == me]


def _census(part):
    """``(R, 4)`` int64 on the CPU: per row the NaNs, the keys below 0,
    the zeros and the negative zeros."""
    srt = part.sorted
    R, npc, w = srt.shape
    L = part.values.shape[1]
    nan_key = E.order_key(torch.full((1,), float("nan"),
                                     dtype=part.values.dtype,
                                     device=srt.device))
    piv = torch.stack([torch.zeros_like(nan_key[0]),
                       torch.ones_like(nan_key[0]), nan_key[0]])
    piv = piv.to(torch.int64).expand(R, 3)
    c = _count_below(part, piv)
    v = part.values
    negzero = ((v == 0) & torch.signbit(v)).sum(-1)
    return torch.stack([L - c[:, 2], c[:, 0], c[:, 1] - c[:, 0],
                        negzero], dim=1).cpu()


def _pivots(lo, hi, arity):
    """``(..., arity - 1)``: ``lo + floor(i (hi - lo) / arity)`` for ``i``
    in 1 .. arity - 1, without overflow (``hi - lo < 2**63``)."""
    w = (hi - lo).unsqueeze(-1)
    i = torch.arange(1, arity, dtype=torch.int64)
    return lo.unsqueeze(-1) + (w // arity) * i + ((w % arity) * i) // arity


def _zero_prefix(part, rows, gsizes):
    """The zeros of the part's local ``rows``: ``(cz, cn, flat)``, the
    count of zeros and of negative zeros before each column (a leading
    0 column: ``(len(rows), L + 1)``) and each column's flat index in the
    slice (increasing)."""
    v = part.values[rows]
    z = v == 0
    dt = torch.int32 if v.shape[1] < 2 ** 31 else torch.int64

    def prefix(m):
        return torch.cat([torch.zeros((m.shape[0], 1), dtype=dt,
                                      device=m.device),
                          torch.cumsum(m, dim=1, dtype=dt)], dim=1)

    cols = torch.arange(v.shape[1], device=v.device)
    return prefix(z), prefix(z & torch.signbit(v)), flat_index(
        part, cols, gsizes)


def select(parts, nslices, gsizes, skip_nan, positions_of, dtype,
           err=None):
    """The values at ``positions_of(valid)`` (``(P, nslices)`` int64,
    ``valid`` the count of each slice's values that order before NaN:
    ``(nslices,)`` int64) of every slice's sorted values, as a ``(P,
    nslices)`` tensor of ``dtype`` on the CPU.  ``parts``: every owner
    position's :class:`Part`, grid order; ``gsizes``: the global extents
    of the reduced dims; ``skip_nan``: a nan kind (a plain kind's slice
    holding a NaN is all NaN); ``err``: this rank failed before the
    selection (it joins the census with the flag, then raises it).
    Returns ``(values, rounds)``; an empty extent is NaN with no round
    (every rank reads that from the shapes)."""
    length = math.prod(gsizes)
    kdt = E._KEY_DTYPES[dtype]
    width = torch.iinfo(kdt).bits
    if length == 0 or nslices == 0:
        if err is not None:
            raise err
        pos = positions_of(torch.zeros(nslices, dtype=torch.int64))
        return torch.full(tuple(pos.shape[:1]) + (nslices,), float("nan"),
                          dtype=dtype), 0
    mine = _mine(parts)
    t0 = time.perf_counter()
    try:
        if err is None:
            for p in mine:
                p.sorted = _sorted_pieces(p.values)
                p.census = _census(p)  # on the host: waits for the sort
    except Exception as e:  # every rank must learn of it at the census
        err = e
    t1 = time.perf_counter()
    stats["prep_s"] += t1 - t0
    # counts cross as int32 where no part holds 2**31 values (every rank
    # reads that from the shapes)
    wire = torch.int32 if all(math.prod(p.sizes) < 2 ** 31 for p in parts) \
        else torch.int64
    # the census: a failure flag a rank first, then the parts' counts
    flag = torch.tensor([0 if err is None else 1], dtype=wire)
    payload = torch.cat([flag] + [
        p.census.reshape(-1).to(wire) if err is None else
        torch.zeros(len(p.rows) * 4, dtype=wire) for p in mine])
    heads, got = _gather_rounds(parts, payload, lambda p: len(p.rows) * 4,
                                0, head=1)
    rounds = 1
    if err is not None:
        raise err
    if any(int(h[0]) for h in heads):
        raise coherence.CoherentAbort("select:census", coherence.P_RETRY)
    tot = torch.zeros((nslices, 4), dtype=torch.int64)
    for p, g in zip(parts, got):
        tot.index_add_(0, p.rows, g.reshape(-1, 4).to(torch.int64))
    n_nan, n_neg, n_zero, n_negzero = tot.unbind(1)
    valid = length - n_nan if skip_nan else torch.where(
        n_nan > 0, torch.zeros_like(n_nan), torch.full_like(n_nan, length))
    pos = positions_of(valid).to(torch.int64)
    P = pos.shape[0]
    S = nslices
    pos = pos.expand(P, S)
    val_b = valid.expand(P, S)
    neg_b, zero_b = n_neg.expand(P, S), n_zero.expand(P, S)
    nz_b = n_negzero.expand(P, S)
    key = torch.zeros((P, S), dtype=torch.int64)
    isnan = pos >= val_b
    in_neg = ~isnan & (pos < neg_b)
    in_zero = ~isnan & ~in_neg & (pos < neg_b + zero_b)
    in_pos = ~isnan & ~in_neg & ~in_zero
    negative = torch.zeros((P, S), dtype=torch.bool)  # the zeros' sign
    value = in_neg | in_pos
    # the negative keys from -inf's, the positive ones below NaN's: each
    # interval narrower than 2**63
    lo = torch.where(in_neg, torch.full_like(pos, int(E.order_key(
        torch.full((1,), -math.inf, dtype=dtype))[0])), torch.ones_like(pos))
    nan_key = int(E.order_key(torch.full((1,), float("nan"),
                                         dtype=dtype))[0])
    hi = torch.where(in_neg, torch.zeros_like(pos),
                     torch.full_like(pos, nan_key))
    negative |= in_zero & (nz_b == zero_b)
    # a zero with both signs in its slice: the search over the flat index
    # for the zero at that rank among the slice's zeros, per entry its
    # interval [tlo, thi) and the negative zeros before either end
    tp, ts = torch.nonzero(in_zero & (nz_b > 0) & (nz_b < zero_b),
                           as_tuple=True)
    T = len(ts)
    bits = max(1, math.ceil(math.log2(length + 1)))
    arity = 1 << max(1, math.ceil(bits / (width - 1)))
    tlo = torch.zeros(T, dtype=torch.int64)
    thi = torch.full((T,), length, dtype=torch.int64)
    clo, chi = torch.zeros(T, dtype=torch.int64), nz_b[tp, ts].clone()
    tk = pos[tp, ts] - neg_b[tp, ts]
    steps = torch.arange(1, arity, dtype=torch.int64)
    tie_of = {}
    if T:
        for p in parts:  # the tie entries in each part's rows, its rows
            loc = torch.full((S,), -1, dtype=torch.int64)
            loc[p.rows] = torch.arange(len(p.rows))
            r = loc[ts]
            sel = torch.nonzero(r >= 0).reshape(-1)
            tie_of[id(p)] = (sel, r[sel])
        for p in mine:
            sel, rows = tie_of[id(p)]
            if len(sel):
                need, idx = torch.unique(rows, return_inverse=True)
                p.zeros = (_zero_prefix(p, need.to(p.values.device), gsizes),
                           idx)
    value &= (hi - 1) > lo

    masks, live = {}, -1
    while bool(value.any()) or bool(((thi - tlo) > 1).any()):
        n_live = int(value.sum())
        if n_live != live:  # entries only finish: masks change rarely
            live = n_live
            for p in parts:
                m = value[:, p.rows]
                masks[id(p)] = (m, int(m.sum()),
                                torch.nonzero(m, as_tuple=True),
                                bool(m.all()))
        piv = _pivots(lo, hi, ARITY)  # (P, S, ARITY - 1)
        tpiv = tlo.unsqueeze(1) + ((thi - tlo).unsqueeze(1) * steps) // arity
        pieces = []
        for p in mine:
            m, nv, _nz, full = masks[id(p)]
            if nv:
                pm = piv[:, p.rows].permute(1, 0, 2).reshape(len(p.rows), -1)
                c = _count_below(p, pm).reshape(len(p.rows), P, ARITY - 1)
                c = c.permute(1, 0, 2).cpu()
                pieces.append((c if full else c[m]).reshape(-1).to(wire))
            sel = tie_of.get(id(p), (torch.zeros(0, dtype=torch.int64),))[0]
            if len(sel):
                (cz, cn, flat), idx = p.zeros
                col = torch.searchsorted(flat, tpiv[sel].to(flat.device))
                row = idx.to(flat.device).unsqueeze(1)
                pieces.append(torch.stack([cz[row, col], cn[row, col]], -1)
                              .cpu().reshape(-1).to(wire))
        payload = torch.cat(pieces) if pieces else \
            torch.zeros(0, dtype=wire)
        sizes = {id(p): masks[id(p)][1] * (ARITY - 1) + 2 * (arity - 1) * len(
            tie_of.get(id(p), ((),))[0]) for p in parts}
        got = _gather_rounds(parts, payload, lambda p: sizes[id(p)], rounds)
        rounds += 1
        below = torch.zeros((P, S, ARITY - 1), dtype=torch.int64)
        tcount = torch.zeros((T, arity - 1, 2), dtype=torch.int64)
        for p, g in zip(parts, got):
            g = g.to(torch.int64)
            _m, nv, (pi, ri), full = masks[id(p)]
            nv *= ARITY - 1
            if nv and full:  # every entry of the part's rows: one add
                below[:, p.rows] += g[:nv].view(P, len(p.rows), ARITY - 1)
            elif nv:
                below.index_put_((pi, p.rows[ri]),
                                 g[:nv].reshape(-1, ARITY - 1),
                                 accumulate=True)
            sel = tie_of.get(id(p), (torch.zeros(0, dtype=torch.int64),))[0]
            if len(sel):
                tcount.index_add_(0, sel, g[nv:].view(len(sel), arity - 1, 2))
        # the pivots at or below the position's rank raise lo, the first
        # above it lowers hi (the counts rise with the pivot)
        n_le = (below <= pos.unsqueeze(-1)).sum(-1)
        last = torch.gather(piv, -1, (n_le - 1).clamp(min=0).unsqueeze(-1))
        first = torch.gather(piv, -1, n_le.clamp(max=ARITY - 2).unsqueeze(-1))
        lo = torch.where(value & (n_le > 0), last[..., 0], lo)
        hi = torch.where(value & (n_le < ARITY - 1), first[..., 0], hi)
        value &= (hi - 1) > lo
        if T:  # the same for the zeros' flat index
            n_le = (tcount[..., 0] <= tk.unsqueeze(1)).sum(-1)
            j0 = (n_le - 1).clamp(min=0).unsqueeze(1)
            j1 = n_le.clamp(max=arity - 2).unsqueeze(1)
            live_t = (thi - tlo) > 1
            up, down = live_t & (n_le > 0), live_t & (n_le < arity - 1)
            tlo = torch.where(up, torch.gather(tpiv, 1, j0)[:, 0], tlo)
            clo = torch.where(up, torch.gather(tcount[..., 1], 1, j0)[:, 0],
                              clo)
            thi = torch.where(down, torch.gather(tpiv, 1, j1)[:, 0], thi)
            chi = torch.where(down, torch.gather(tcount[..., 1], 1, j1)[:, 0],
                              chi)
    key = torch.where(in_neg | in_pos, lo, key)
    negative[tp, ts] = (chi - clo) == 1
    out = E.key_value(key.to(kdt), dtype)
    out = torch.where(in_zero & negative,
                      torch.full((), -0.0, dtype=dtype), out)
    out = torch.where(isnan, torch.full((), float("nan"), dtype=dtype), out)
    stats["selections"] += 1
    stats["last_rounds"] = rounds
    stats["round_s"] += time.perf_counter() - t1
    for p in mine:
        p.sorted = p.census = p.zeros = None
    return out, rounds


# ---------------------------------------------------------------------------
# the complex extremes
# ---------------------------------------------------------------------------


def _bits(v):
    """Float values as int64 carrying their bits (float32 widened first,
    exactly)."""
    return v.to(torch.float64).view(torch.int64)


def _cbits(z):
    """Complex values as ``(..., 2)`` int64 carrying their parts' bits."""
    r = torch.view_as_real(z)
    w = torch.int64 if r.dtype == torch.float64 else torch.int32
    return r.contiguous().view(w).to(torch.int64)


def _from_cbits(b, dtype):
    w = torch.int64 if dtype == torch.complex128 else torch.int32
    f = torch.float64 if dtype == torch.complex128 else torch.float32
    return torch.view_as_complex(b.to(w).clone().view(f))


def _last(mask, gf):
    """Per row: the largest flat index where ``mask`` holds (-1: none)
    and its column (0 where none)."""
    idx = torch.where(mask, gf, torch.full_like(gf, -1)).amax(-1) \
        if mask.shape[-1] else torch.full(mask.shape[:-1], -1,
                                          dtype=torch.int64,
                                          device=mask.device)
    col = torch.searchsorted(gf, idx.clamp(min=0)) if gf.numel() else idx
    return idx, col.clamp(max=max(gf.numel() - 1, 0))


def _at(z, col):
    return torch.gather(z, 1, col.unsqueeze(1))[:, 0] if z.shape[1] else \
        torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)


def extreme(parts, nslices, gsizes, want_max, dtype, err=None):
    """``jnp.max`` (``want_max``) or ``jnp.min`` of complex values per
    slice, as ``(nslices,)`` of ``dtype`` on the CPU: three rounds (see
    the module docstring), the first carrying a failure flag a rank
    (``err``, or a failure here, raises on every rank there)."""
    length = math.prod(gsizes)
    sgn = 1.0 if want_max else -1.0
    mine = _mine(parts)
    held = {}
    try:
        if err is None:
            for p in mine:
                z = p.values
                cols = torch.arange(z.shape[1], device=z.device)
                held[id(p)] = (z, sgn * z.real, sgn * z.imag,
                               flat_index(p, cols, gsizes))
    except Exception as e:  # every rank must learn of it in round 1
        err = e

    def rnd(per_row, nfield, tag):
        head = 1 if tag == "x1" else 0
        pieces = [] if err is not None else [
            per_row(p, *held[id(p)]).reshape(-1).cpu() for p in mine]
        if err is not None:
            pieces = [torch.zeros(len(p.rows) * nfield, dtype=torch.int64)
                      for p in mine]
        flag = [torch.tensor([int(err is not None)])] if head else []
        payload = torch.cat(flag + pieces) if flag or pieces else \
            torch.zeros(0, dtype=torch.int64)
        got = _gather_rounds(parts, payload,
                             lambda p: len(p.rows) * nfield, tag, head=head)
        if head:
            heads, got = got
            if err is not None:
                raise err
            if any(int(h[0]) for h in heads):
                raise coherence.CoherentAbort("select:extreme",
                                              coherence.P_RETRY)
        return [(p.rows, g.reshape(-1, nfield)) for p, g in zip(parts, got)]

    def best(fields, pick, width):
        """Per slice: the row of the part whose ``pick`` field is the
        largest (the parts' fields scattered by slice)."""
        out = torch.full((nslices, width), -1, dtype=torch.int64)
        have = torch.zeros(nslices, dtype=torch.bool)
        for rows, f in fields:
            key = pick(f)
            cur = pick(out[rows])
            take = ~have[rows] | (key > cur)
            out[rows[take]] = f[take]
            have[rows[take]] = True
        return out

    # 1: the last NaN real part
    def r1(p, z, cr, ci, gf):
        idx, col = _last(torch.isnan(cr), gf)
        return torch.cat([idx.unsqueeze(1), _cbits(_at(z, col))], 1)

    f1 = best(rnd(r1, 3, "x1"), lambda f: f[:, 0], 3)
    last_nan = f1[:, 0]
    result = _from_cbits(f1[:, 1:], dtype)
    done = last_nan == length - 1

    # 2: the largest real part after it, the last index of its elements
    # and of their NaN imaginary parts
    def r2(p, z, cr, ci, gf):
        after = gf.unsqueeze(0) > last_nan[p.rows].to(gf.device).unsqueeze(1)
        has = after.any(-1)
        top_re = torch.where(after, cr, torch.full_like(cr, -math.inf)
                             ).amax(-1) if cr.shape[1] else \
            torch.full((cr.shape[0],), -math.inf, dtype=cr.dtype,
                       device=cr.device)
        top = after & (cr == top_re.unsqueeze(1))
        tl, _c = _last(top, gf)
        pim, col = _last(top & torch.isnan(ci), gf)
        return torch.cat([has.to(torch.int64).unsqueeze(1),
                          _bits(top_re).unsqueeze(1), tl.unsqueeze(1),
                          pim.unsqueeze(1), _cbits(_at(z, col))], 1)

    f2 = rnd(r2, 6, "x2")
    best_re = torch.full((nslices,), -math.inf, dtype=torch.float64)
    for rows, f in f2:
        has = f[:, 0] == 1
        best_re[rows[has]] = torch.maximum(best_re[rows[has]],
                                           f[has, 1].view(torch.float64))
    win = [(rows, f[(f[:, 0] == 1) & (f[:, 1].view(torch.float64)
                                      == best_re[rows])],
            rows[(f[:, 0] == 1) & (f[:, 1].view(torch.float64)
                                   == best_re[rows])]) for rows, f in f2]
    tl = torch.full((nslices,), -1, dtype=torch.int64)
    for _rows, f, r in win:
        tl[r] = torch.maximum(tl[r], f[:, 2])
    f2b = best([(r, f) for _rows, f, r in win], lambda f: f[:, 3], 6)
    pim = f2b[:, 3]
    by_pim = (~done) & (pim >= 0) & (tl == pim)
    result = torch.where(by_pim, _from_cbits(f2b[:, 4:], dtype), result)
    done |= by_pim

    # 3: the largest imaginary part after the last NaN one among those
    # elements, and its last index
    def r3(p, z, cr, ci, gf):
        rows = p.rows
        dev = gf.device
        u = (gf.unsqueeze(0) > last_nan[rows].to(dev).unsqueeze(1)) & (
            cr.to(torch.float64) == best_re[rows].to(dev).unsqueeze(1)) & (
            gf.unsqueeze(0) > pim[rows].to(dev).unsqueeze(1))
        has = u.any(-1)
        bi = torch.where(u, ci, torch.full_like(ci, -math.inf)).amax(-1) \
            if ci.shape[1] else torch.full((ci.shape[0],), -math.inf,
                                           dtype=ci.dtype, device=dev)
        pick, col = _last(u & (ci == bi.unsqueeze(1)), gf)
        return torch.cat([has.to(torch.int64).unsqueeze(1),
                          _bits(bi).unsqueeze(1), pick.unsqueeze(1),
                          _cbits(_at(z, col))], 1)

    if not bool(done.all()):
        f3 = rnd(r3, 5, "x3")
        bi = torch.full((nslices,), -math.inf, dtype=torch.float64)
        for rows, f in f3:
            has = f[:, 0] == 1
            bi[rows[has]] = torch.maximum(bi[rows[has]],
                                          f[has, 1].view(torch.float64))
        cand = []
        for rows, f in f3:
            ok = (f[:, 0] == 1) & (f[:, 1].view(torch.float64) == bi[rows])
            cand.append((rows[ok], f[ok]))
        f3b = best(cand, lambda f: f[:, 2], 5)
        result = torch.where(done, result, _from_cbits(f3b[:, 3:], dtype))
    stats["extremes"] += 1
    return result
