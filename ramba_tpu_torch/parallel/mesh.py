"""Mesh of shards + partition planning.

Counterpart of ``ramba_tpu/parallel/mesh.py``.  A :class:`Mesh` is an n-d
grid of shard positions, each holding a ``torch.device``, with one name
per grid axis; a :class:`PartitionSpec` names, per array dim, the mesh
axes that dim is split over; a :class:`NamedSharding` pairs the two.  The
partition solver (``compute_regular_schedule``: the split of the shard
count that cuts the least surface) and the spec choice (``default_spec``)
are the reference's, over the shard count.

One process drives the whole mesh.  Every position of a mesh holds the
same device: a grid may repeat one device (``Mesh(np.array([dev] * 4,
dtype=object).reshape(2, 2), ("d0", "d1"))``), and each array's shards are
then views into one tensor on it.  A grid of distinct devices raises
``NotImplementedError``: PyTorch drives several GPUs with one process per
GPU over ``torch.distributed``, which is the multi-process slice of the
port (ROADMAP A.6, part two), not a silent run on the first device.

The default mesh is one shard on ``common.device()``, so every path runs
as it does without a mesh.
"""

from __future__ import annotations

import itertools
import math
import time
from collections import OrderedDict
from functools import lru_cache
from typing import Optional, Sequence

import numpy as np
import torch

from ramba_tpu_torch import common

MULTI_PROCESS = ("a mesh of distinct devices needs one process per device "
                 "over torch.distributed: the multi-process slice of the "
                 "port (ROADMAP A.6, part two). Build the mesh from one "
                 "device repeated, e.g. np.array([dev] * 4, dtype=object)"
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


class Mesh:
    """An n-d grid of ``torch.device`` positions with axis names."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.empty(np.shape(devices), dtype=object)
        for pos in np.ndindex(grid.shape):
            grid[pos] = torch.device(np.asarray(devices, dtype=object)[pos])
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names) or grid.size == 0:
            raise ValueError(f"a {grid.shape} grid of devices needs "
                             f"{grid.ndim} axis names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis name in {axis_names}")
        if len({str(d) for d in grid.flat}) > 1:
            raise NotImplementedError(MULTI_PROCESS)
        self.devices = grid
        self.axis_names = axis_names

    @property
    def shape(self) -> OrderedDict:
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device(self) -> torch.device:
        """The one device every position holds."""
        return self.devices.flat[0]

    def __eq__(self, other):
        return (isinstance(other, Mesh)
                and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and self.device == other.device)

    def __hash__(self):
        return hash((self.axis_names, self.devices.shape, str(self.device)))

    def __repr__(self):
        axes = ", ".join(f"'{k}': {v}" for k, v in self.shape.items())
        return f"Mesh({axes}, device={self.device})"


_mesh: Optional[Mesh] = None
_mesh_is_default = False
# Bumped every time the mesh changes.
mesh_epoch: int = 0


def _make_default_mesh() -> Mesh:
    t0 = time.perf_counter()
    mesh = Mesh([common.device()], ("d0",))
    init_s = time.perf_counter() - t0
    from ramba_tpu_torch.observe import health as _health

    _health.record_mesh(mesh, init_s)
    return mesh


def get_mesh() -> Mesh:
    """The process mesh.  The default one follows ``common.device()``; a
    mesh a caller set must hold it."""
    global _mesh_is_default
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
    created on (``common.device()``)."""
    global _mesh, _mesh_is_default, mesh_epoch
    if not isinstance(mesh, Mesh):
        raise TypeError(f"set_mesh takes a Mesh, got {type(mesh).__name__}")
    if mesh.device != common.device():
        raise ValueError(f"the mesh holds {mesh.device} but arrays are "
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
