"""Mesh of shards + partition planning.

Counterpart of ``ramba_tpu/parallel/mesh.py``.  A :class:`Mesh` is an n-d
grid of shard positions with one name per grid axis; a
:class:`PartitionSpec` names, per array dim, the mesh axes that dim is
split over; a :class:`NamedSharding` pairs the two.  The partition solver
(``compute_regular_schedule``: the split of the shard count that cuts the
least surface) and the spec choice (``default_spec``) are the
reference's, over the shard count.

A mesh takes one of two forms:

* **one process**: every position holds the same device (``Mesh(np.array(
  [dev] * 4, dtype=object).reshape(2, 2), ("d0", "d1"))``), and each
  array's shards are views into one tensor on it;
* **ranks** (``rank_mesh``, ``distributed.global_mesh``, and the default
  mesh once ``distributed.initialize`` formed a group of several
  processes): every position is held by one rank with the device it
  computes on, and each rank holds only the blocks of its own positions
  (:meth:`NamedSharding.local_blocks`).  A rank may hold several
  positions (``rank_mesh((2, 2), ranks=[0, 0, 1, 1])``, or the
  checkerboard ``[[0, 1], [1, 0]]``): it then holds one block per distinct
  block of its positions, packed into one tensor (:meth:`NamedSharding.
  split_local`, :func:`pack`).  A rank outside a capped mesh holds empty
  blocks and still takes part in every collective.

A grid of distinct devices in one process raises ``NotImplementedError``:
PyTorch drives several cards with one process per card
(``distributed.initialize``), not with a silent run on the first device.

The default mesh of one process is one shard on ``common.device()``; with
several ranks it is ``balanced_factors(min(world, RAMBA_WORKERS),
RAMBA_TPU_MESH_NDIM)`` over the ranks in rank order, as the reference's is
over its devices.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import threading
import time
from collections import OrderedDict
from functools import lru_cache
from typing import Optional, Sequence

import numpy as np
import torch

from ramba_tpu_torch import common

MULTI_PROCESS = ("a mesh of distinct devices in one process: the "
                 "multi-process slice of the port runs one process per "
                 "device (distributed.initialize) over a mesh of its ranks "
                 "(distributed.global_mesh); in one process repeat one "
                 "device, e.g. np.array([dev] * 4, dtype=object)"
                 ".reshape(2, 2)")


class PartitionSpec(tuple):
    """Per array dim: None (whole), a mesh axis name, or a tuple of names
    (split over their product, the first name major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def entry_names(entry) -> tuple:
    """Mesh axis names a spec entry splits over: () for None."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def canonical(spec) -> tuple:
    """A spec as a comparable tuple: each entry None, one axis name or a
    tuple of several, trailing Nones dropped (``P(("d0",), None)`` and
    ``P("d0")`` are one layout)."""
    out = []
    for e in spec or ():
        names = entry_names(e)
        out.append(None if not names else names[0] if len(names) == 1
                   else tuple(names))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


class Mesh:
    """An n-d grid of positions with axis names.  ``ranks`` (same shape,
    or None) names the rank of each position; ``devices`` the device each
    position computes on."""

    def __init__(self, devices, axis_names: Sequence[str], ranks=None):
        grid = np.empty(np.shape(devices), dtype=object)
        for pos in np.ndindex(grid.shape):
            grid[pos] = torch.device(np.asarray(devices, dtype=object)[pos])
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names) or grid.size == 0:
            raise ValueError(f"a {grid.shape} grid of devices needs "
                             f"{grid.ndim} axis names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis name in {axis_names}")
        if ranks is None:
            if len({str(d) for d in grid.flat}) > 1:
                raise NotImplementedError(MULTI_PROCESS)
        else:
            ranks = np.asarray(ranks, dtype=np.int64).reshape(grid.shape)
        self.devices = grid
        self.axis_names = axis_names
        self.ranks = ranks

    @property
    def shape(self) -> OrderedDict:
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device(self) -> torch.device:
        """The device this process computes on: the one every position
        holds, or on a mesh of ranks this rank's."""
        if self.ranks is None:
            return self.devices.flat[0]
        return common.device()

    def positions_of(self, rank: int) -> list:
        """Every grid position ``rank`` holds, in grid order."""
        if self.ranks is None:
            return []
        return [tuple(int(i) for i in hit)
                for hit in np.argwhere(self.ranks == int(rank))]

    def position_of(self, rank: int) -> Optional[tuple]:
        """The first grid position of ``rank`` (None: it holds none)."""
        held = self.positions_of(rank)
        return held[0] if held else None

    def local_positions(self) -> list:
        """The positions this process holds, in grid order: every one in
        one process, its own on a mesh of ranks (several where the rank
        holds several)."""
        if self.ranks is None:
            return list(np.ndindex(self.devices.shape))
        from ramba_tpu_torch.parallel import distributed

        return self.positions_of(distributed.process_index())

    def rank_at(self, pos) -> int:
        return int(self.ranks[tuple(pos)])

    def __eq__(self, other):
        if not (isinstance(other, Mesh)
                and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and (self.ranks is None) == (other.ranks is None)):
            return False
        if self.ranks is None:
            return self.device == other.device
        return (bool((self.ranks == other.ranks).all())
                and [str(d) for d in self.devices.flat]
                == [str(d) for d in other.devices.flat])

    def __hash__(self):
        if self.ranks is None:
            return hash((self.axis_names, self.devices.shape,
                         str(self.device)))
        return hash((self.axis_names, self.devices.shape,
                     tuple(self.ranks.flat)))

    def __repr__(self):
        axes = ", ".join(f"'{k}': {v}" for k, v in self.shape.items())
        if self.ranks is None:
            return f"Mesh({axes}, device={self.device})"
        return f"Mesh({axes}, ranks={self.ranks.tolist()})"


def is_rank_mesh(mesh: Mesh) -> bool:
    """True for a mesh whose positions are ranks of a group of several
    processes: its arrays are held as per-rank blocks."""
    return mesh.ranks is not None


def rank_mesh(shape: tuple, axis_names=None, ranks=None) -> Mesh:
    """A mesh of ``shape`` over ``ranks`` (default: 0, 1, ...) in grid
    order, each position on the device its rank published at bring-up."""
    from ramba_tpu_torch.parallel import distributed

    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    ranks = list(range(n) if ranks is None else ranks)[:n]
    if len(ranks) != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks, got {len(ranks)}")
    world = distributed.process_count()
    if max(ranks) >= world:
        raise ValueError(f"ranks {ranks} outside a world of {world}")
    devs = distributed.rank_devices() or [("", str(common.device()))]
    grid = np.empty(shape, dtype=object)
    for pos, r in zip(np.ndindex(shape), ranks):
        grid[pos] = torch.device(devs[r][1])
    if axis_names is None:
        axis_names = tuple(f"d{i}" for i in range(len(shape)))
    return Mesh(grid, axis_names, ranks=np.array(ranks).reshape(shape))


_mesh: Optional[Mesh] = None
_mesh_is_default = False
# Bumped every time the mesh changes.
mesh_epoch: int = 0
# A thread inside ``local_scope`` sees a one-shard mesh.
_scope = threading.local()


def _make_default_mesh() -> Mesh:
    from ramba_tpu_torch.parallel import distributed

    t0 = time.perf_counter()
    world = distributed.process_count()
    if world > 1:
        n = world
        if common.num_workers_env is not None:
            n = max(1, min(n, int(common.num_workers_env)))
        ndim = max(1, min(common.mesh_ndim, 3))
        factors = tuple(f for f in balanced_factors(n, ndim) if f > 1) or (1,)
        mesh = rank_mesh(factors)
    else:
        mesh = Mesh([common.device()], ("d0",))
    init_s = time.perf_counter() - t0
    from ramba_tpu_torch.observe import health as _health

    _health.record_mesh(mesh, init_s)
    return mesh


def reset_default() -> None:
    """Forget the default mesh (the process group formed or went away):
    the next ``get_mesh`` builds it anew."""
    global _mesh, _mesh_is_default, mesh_epoch
    if _mesh is None or _mesh_is_default:
        _mesh, _mesh_is_default = None, False
        mesh_epoch += 1


@contextlib.contextmanager
def local_scope():
    """Inside, this thread sees a one-shard mesh on its own device: what
    runs there is rank-local (an spmd kernel's body, a program every rank
    runs whole on gathered operands)."""
    prev = getattr(_scope, "mesh", None)
    _scope.mesh = Mesh([common.device()], ("d0",))
    try:
        yield _scope.mesh
    finally:
        _scope.mesh = prev


def get_mesh() -> Mesh:
    """The process mesh.  The default one follows ``common.device()``; a
    mesh a caller set must hold it."""
    global _mesh_is_default
    scoped = getattr(_scope, "mesh", None)
    if scoped is not None:
        return scoped
    if _mesh is None or (_mesh_is_default
                         and _mesh.device != common.device()):
        set_mesh(_make_default_mesh())
        _mesh_is_default = True
    elif _mesh.device != common.device():
        raise ValueError(f"the mesh holds {_mesh.device} but arrays are "
                         f"created on {common.device()}: set a mesh on it")
    return _mesh


def set_mesh(mesh: Mesh) -> None:
    """Install the process mesh.  Its device must be the one arrays are
    created on (``common.device()``); a mesh of ranks must cover this
    process's group."""
    global _mesh, _mesh_is_default, mesh_epoch
    if not isinstance(mesh, Mesh):
        raise TypeError(f"set_mesh takes a Mesh, got {type(mesh).__name__}")
    if mesh.ranks is None and mesh.device != common.device():
        raise ValueError(f"the mesh holds {mesh.device} but arrays are "
                         f"created on {common.device()}")
    if mesh.ranks is not None:
        from ramba_tpu_torch.parallel import distributed

        for me in mesh.positions_of(distributed.process_index()):
            if mesh.devices[me] != common.device():
                raise ValueError(f"this rank's position holds "
                                 f"{mesh.devices[me]} but arrays are "
                                 f"created on {common.device()}")
    _mesh, _mesh_is_default = mesh, False
    mesh_epoch += 1


def num_workers() -> int:
    return get_mesh().size


@lru_cache(maxsize=None)
def prime_factors(n: int) -> tuple:
    """Prime factorization, smallest first."""
    out = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1
    if n > 1:
        out.append(n)
    return tuple(out)


@lru_cache(maxsize=None)
def balanced_factors(n: int, k: int) -> tuple:
    """Split n into k factors as balanced as possible (largest first)."""
    factors = [1] * k
    for p in sorted(prime_factors(n), reverse=True):
        factors[int(np.argmin(factors))] *= p
    return tuple(sorted(factors, reverse=True))


@lru_cache(maxsize=4096)
def compute_regular_schedule(shape: tuple, n: int) -> tuple:
    """Per-dimension splits of ``n`` shards over ``shape`` that cut the
    least surface (every assignment of n's prime factors to dims is
    tried); splits never exceed the dim."""
    ndim = len(shape)
    if ndim == 0 or n <= 1:
        return (1,) * ndim
    best = None
    best_cost = math.inf
    primes = prime_factors(n)
    for assignment in itertools.product(range(ndim), repeat=len(primes)):
        splits = [1] * ndim
        for p, d in zip(primes, assignment):
            splits[d] *= p
        if any(s > max(1, shape[d]) for d, s in enumerate(splits)):
            continue
        total = math.prod(shape) if shape else 1
        cost = sum((s - 1) * (total / shape[d])
                   for d, s in enumerate(splits) if shape[d] > 0)
        if cost < best_cost:
            best_cost = cost
            best = tuple(splits)
    return best if best is not None else (1,) * ndim


def spec_parallelism(spec, mesh: Mesh) -> int:
    """How many distinct blocks ``spec`` cuts an array into on ``mesh``."""
    total = 1
    for e in spec:
        for nm in entry_names(e):
            total *= mesh.shape[nm]
    return total


def default_spec(shape: Sequence[int], mesh: Optional[Mesh] = None) -> P:
    """The spec of a new array of ``shape``: small arrays whole on every
    shard; otherwise the solver's splits realized on mesh axes, or the
    greedy largest-dim assignment where the mesh cannot realize them at
    full parallelism."""
    mesh = mesh or get_mesh()
    shape = tuple(int(s) for s in shape)
    if len(shape) == 0 or math.prod(shape) < common.dist_threshold:
        return P()
    n = mesh.size
    if n == 1:
        return P()
    solved = spec_from_splits(compute_regular_schedule(shape, n), mesh)
    if spec_parallelism(solved, mesh) == n:
        return solved
    greedy = _greedy_spec(shape, mesh)
    if spec_parallelism(greedy, mesh) > spec_parallelism(solved, mesh):
        return greedy
    return solved


def _greedy_spec(shape: tuple, mesh: Mesh) -> P:
    """Largest mesh axis to largest dim."""
    axes = sorted(mesh.shape.items(), key=lambda kv: -kv[1])
    dims_by_size = sorted(range(len(shape)), key=lambda d: -shape[d])
    assignment: dict = {}
    used_dims = set()
    for name, size in axes:
        placed = False
        for d in dims_by_size:
            if d in used_dims:
                continue
            if shape[d] >= size:
                assignment[d] = [name]
                used_dims.add(d)
                placed = True
                break
        if not placed:
            # stack this axis onto the largest assigned dim that absorbs
            # it, else leave it unused (whole along it)
            for d in dims_by_size:
                if d in used_dims and shape[d] >= size * math.prod(
                        mesh.shape[a] for a in assignment[d]):
                    assignment[d].append(name)
                    break
    entries = []
    for d in range(len(shape)):
        if d in assignment:
            names = assignment[d]
            entries.append(names[0] if len(names) == 1 else tuple(names))
        else:
            entries.append(None)
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def spec_from_splits(splits: Sequence[int], mesh: Optional[Mesh] = None) -> P:
    """Spec for explicit per-dimension split counts: each split > 1 takes
    unused mesh axes whose sizes multiply to it (one axis first, then the
    smallest group); a split the mesh cannot meet leaves its dim whole."""
    mesh = mesh or get_mesh()
    free = dict(mesh.shape)
    entries = []
    for s in splits:
        s = int(s)
        if s <= 1:
            entries.append(None)
            continue
        names = None
        for name, size in free.items():
            if size == s:
                names = [name]
                break
        if names is None:
            items = list(free.items())
            for r in range(2, len(items) + 1):
                for combo in itertools.combinations(items, r):
                    if math.prod(sz for _, sz in combo) == s:
                        names = [nm for nm, _ in combo]
                        break
                if names:
                    break
        if names:
            for nm in names:
                free.pop(nm)
            entries.append(names[0] if len(names) == 1 else tuple(names))
        else:
            entries.append(None)
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def _block_range(n: int, parts: int, i: int) -> slice:
    """Block ``i`` of a dim of ``n`` cut into ``parts``: blocks of
    ceil(n / parts), the last ones shorter or empty."""
    c = -(-n // parts)
    return slice(min(i * c, n), min((i + 1) * c, n))


class NamedSharding:
    """A mesh and a spec: where each block of an array lives."""

    def __init__(self, mesh: Mesh, spec=P()):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else P(*spec)
        for e in self.spec:
            for nm in entry_names(e):
                if nm not in mesh.shape:
                    raise ValueError(f"spec {self.spec} names axis {nm!r} "
                                     f"that the mesh {mesh} does not have")

    def __eq__(self, other):
        return (isinstance(other, NamedSharding) and self.mesh == other.mesh
                and tuple(self.spec) == tuple(other.spec))

    def __hash__(self):
        return hash((self.mesh, tuple(self.spec)))

    def __repr__(self):
        return f"NamedSharding(mesh={self.mesh!r}, spec={self.spec!r})"

    def split_counts(self, ndim: int) -> tuple:
        """Blocks per array dim."""
        spec = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        return tuple(math.prod(self.mesh.shape[nm] for nm in entry_names(e))
                     for e in spec)

    def block_coords(self, pos: tuple, ndim: int) -> tuple:
        """Block index per array dim of mesh position ``pos``."""
        spec = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        where = dict(zip(self.mesh.axis_names, pos))
        out = []
        for e in spec:
            k = 0
            for nm in entry_names(e):
                k = k * self.mesh.shape[nm] + where[nm]
            out.append(k)
        return tuple(out)

    def shard_indices(self, shape) -> list:
        """``(position, index)`` for every mesh position in grid order:
        the index is one slice per dim, ``slice(None)`` for a dim the
        position holds whole (``jax``'s ``devices_indices_map`` per
        position; uneven dims cut into blocks of ceil(n / parts))."""
        shape = tuple(int(s) for s in shape)
        counts = self.split_counts(len(shape))
        out = []
        for pos in np.ndindex(self.mesh.devices.shape):
            coords = self.block_coords(pos, len(shape))
            idx = tuple(slice(None) if c == 1
                        else _block_range(n, c, k)
                        for n, c, k in zip(shape, counts, coords))
            out.append((pos, idx))
        return out

    def block_index(self, pos, shape) -> tuple:
        """The index of the block mesh position ``pos`` holds."""
        shape = tuple(int(s) for s in shape)
        counts = self.split_counts(len(shape))
        coords = self.block_coords(tuple(pos), len(shape))
        return tuple(slice(None) if c == 1 else _block_range(n, c, k)
                     for n, c, k in zip(shape, counts, coords))

    def neighbour_pos(self, pos, ndim: int, d: int, step: int):
        """The position ``step`` blocks away from position ``pos``'s block
        along array dim ``d`` (the same coordinates along every other mesh
        axis), or None past the end of the mesh."""
        spec = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        names = entry_names(spec[d])
        if not names:
            return None
        where = dict(zip(self.mesh.axis_names, pos))
        k = 0
        for nm in names:
            k = k * self.mesh.shape[nm] + where[nm]
        k += step
        if not 0 <= k < math.prod(self.mesh.shape[nm] for nm in names):
            return None
        for nm in reversed(names):
            k, where[nm] = divmod(k, self.mesh.shape[nm])
        return tuple(where[nm] for nm in self.mesh.axis_names)

    def neighbour_rank(self, pos, ndim: int, d: int, step: int):
        """The rank holding :meth:`neighbour_pos` (None past the end)."""
        nb = self.neighbour_pos(pos, ndim, d, step)
        return None if nb is None else self.mesh.rank_at(nb)

    def rank_blocks(self, rank: int, shape) -> list:
        """``[(position, index)]``: the distinct blocks ``rank`` holds, in
        grid order, each under the first of its positions holding it (a
        layout whole along a mesh axis gives several positions one
        block)."""
        shape = tuple(int(s) for s in shape)
        out, seen = [], set()
        for pos in self.mesh.positions_of(rank):
            key = self.block_coords(pos, len(shape))
            if key not in seen:
                seen.add(key)
                out.append((pos, self.block_index(pos, shape)))
        return out

    def local_blocks(self, shape) -> list:
        """:meth:`rank_blocks` of this process (in one process: the whole
        array under position 0)."""
        if self.mesh.ranks is None:
            return [((0,) * self.mesh.devices.ndim,
                     tuple(slice(None) for _ in shape))]
        from ramba_tpu_torch.parallel import distributed

        return self.rank_blocks(distributed.process_index(), shape)

    def rank_index(self, rank: int, shape) -> tuple:
        """The index of the one block ``rank`` holds on a mesh of ranks,
        or empty along every split dim for a rank outside the mesh (whole
        along the others).  A rank holding several blocks raises: read
        them with :meth:`rank_blocks`."""
        held = self.rank_blocks(rank, shape)
        if len(held) == 1:
            return held[0][1]
        if held:
            raise ValueError(f"rank {rank} holds {len(held)} blocks of "
                             "this layout: read them with rank_blocks")
        counts = self.split_counts(len(shape))
        return tuple(slice(None) if c == 1 else slice(0, 0) for c in counts)

    def local_index(self, shape) -> tuple:
        """The index of this process's one block (the whole array in one
        process); see :meth:`rank_index`."""
        if self.mesh.ranks is None:
            return tuple(slice(None) for _ in shape)
        from ramba_tpu_torch.parallel import distributed

        return self.rank_index(distributed.process_index(), shape)

    def held_shape(self, rank: int, shape) -> tuple:
        """The shape of the tensor ``rank`` holds: its one block's, the
        empty block of a rank outside the mesh, or ``(n,)`` for several
        blocks packed (:func:`pack`: each flattened, in grid order)."""
        shape = tuple(int(s) for s in shape)
        held = self.rank_blocks(rank, shape)
        if len(held) > 1:
            return (sum(math.prod(index_shape(i, shape)) for _p, i in held),)
        return index_shape(self.rank_index(rank, shape), shape)

    def rank_shapes(self, shape) -> list:
        """Per rank of the group, the shape of the tensor it holds
        (:meth:`held_shape`)."""
        from ramba_tpu_torch.parallel import distributed

        return [self.held_shape(r, shape)
                for r in range(distributed.process_count())]

    def split_held(self, value, rank: int, shape) -> list:
        """The blocks in the tensor ``rank`` holds, in :meth:`rank_blocks`
        order: the tensor itself for one block, views into the packed
        tensor for several, none for a rank outside the mesh."""
        shape = tuple(int(s) for s in shape)
        held = self.rank_blocks(rank, shape)
        if len(held) <= 1:
            return [value] if held else []
        out, off = [], 0
        for _pos, idx in held:
            bs = index_shape(idx, shape)
            n = math.prod(bs)
            out.append(value[off:off + n].view(bs))
            off += n
        return out

    def split_local(self, value, shape) -> list:
        """:meth:`split_held` of this process's tensor."""
        if self.mesh.ranks is None:
            return [value]
        from ramba_tpu_torch.parallel import distributed

        return self.split_held(value, distributed.process_index(), shape)


def pack(blocks) -> "torch.Tensor":
    """The tensor a rank holds for its ``blocks`` (:meth:`NamedSharding.
    held_shape`): one block as it is, several flattened and concatenated
    in grid order."""
    if len(blocks) == 1:
        return blocks[0]
    return torch.cat([b.reshape(-1) for b in blocks])


def covering(sharding: NamedSharding, shape, box) -> list:
    """``[(coords, block box)]``: the distinct blocks of an array of
    ``shape`` under ``sharding`` that meet the index box ``box``
    (``(start, stop)`` per dim), in C order of their block coordinates;
    none for an empty box."""
    shape = tuple(int(s) for s in shape)
    per_dim = []
    for n, c, (lo, hi) in zip(shape, sharding.split_counts(len(shape)),
                              box):
        hits = []
        for i in range(c):
            sl = _block_range(n, c, i)
            if max(lo, sl.start) < min(hi, sl.stop):
                hits.append((i, (sl.start, sl.stop)))
        if not hits:
            return []
        per_dim.append(hits)
    return [(tuple(i for i, _r in combo), tuple(r for _i, r in combo))
            for combo in itertools.product(*per_dim)]


def holders(sharding: NamedSharding, ndim: int, coords) -> list:
    """Every mesh position holding the block at ``coords``, grid order."""
    coords = tuple(coords)
    return [p for p in np.ndindex(sharding.mesh.devices.shape)
            if sharding.block_coords(p, ndim) == coords]


def nearest_holder(sharding: NamedSharding, ndim: int, coords, anchor):
    """The position holding the block at ``coords`` that agrees with
    ``anchor`` on every mesh axis the layout leaves whole (the block's
    holders differ only there), so the ranks that fetch one block spread
    over its copies."""
    used = {nm for e in sharding.spec for nm in entry_names(e)}
    keep = [i for i, nm in enumerate(sharding.mesh.axis_names)
            if nm not in used]
    for p in holders(sharding, ndim, coords):
        if all(p[i] == anchor[i] for i in keep):
            return p
    raise KeyError(coords)


def index_box(idx, shape) -> tuple:
    """An index of slices as ``(start, stop)`` per dim."""
    out = []
    for sl, n in zip(idx, shape):
        a, b, _s = sl.indices(n)
        out.append((a, max(a, b)))
    return tuple(out)


def index_shape(idx, shape) -> tuple:
    """The shape ``x[idx]`` has for an ``x`` of ``shape`` (slices only)."""
    return tuple(len(range(*sl.indices(n))) for sl, n in zip(idx, shape))


def layout_of(arr, mesh: Mesh) -> P:
    """The spec of ``arr`` on ``mesh``: the layout its realized leaf
    carries (``put_sharded``, ``fromarray(distribution=)``, a sharding
    hint) where that was made on this mesh, else ``default_spec``, the
    layout every other array has."""
    e = arr._expr if arr._base is None else None
    sh = getattr(e, "sharding", None)
    if sh is not None and sh.mesh == mesh:
        return sh.spec
    return default_spec(arr.shape, mesh)


def default_sharding(shape: Sequence[int]) -> NamedSharding:
    mesh = get_mesh()
    return NamedSharding(mesh, default_spec(shape, mesh))


def replicated_sharding() -> NamedSharding:
    return NamedSharding(get_mesh(), P())
