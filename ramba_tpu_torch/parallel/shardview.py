"""Shard/distribution metadata queries.

Counterpart of ``ramba_tpu/parallel/shardview.py``: where each shard of an
array lies in global index space, derived from the array's
:class:`~ramba_tpu_torch.parallel.mesh.NamedSharding` (so it never goes
stale), and the division-table algebra over ``(n_shards, 2, ndim)``
start/end tables.  Pure index math: no data moves.
"""

from __future__ import annotations

import numpy as np

from ramba_tpu_torch.parallel import mesh as _mesh


def _layout(a):
    """``(sharding, shape)`` of an array (a port array is flushed first)."""
    from ramba_tpu_torch.core.ndarray import ndarray

    if isinstance(a, ndarray):
        return a.sharding, a.shape
    shape = tuple(np.shape(a))
    return _mesh.NamedSharding(_mesh.get_mesh(), _mesh.P()), shape


def shard_slices(a) -> list:
    """Per-shard global index ranges, one tuple of slices per mesh
    position, in grid order."""
    sh, shape = _layout(a)
    return [idx for _pos, idx in sh.shard_indices(shape)]


def _table(sh, shape) -> np.ndarray:
    out = []
    for _pos, idx in sh.shard_indices(shape):
        starts = [sl.start if sl.start is not None else 0 for sl in idx]
        ends = [sl.stop if sl.stop is not None else dim
                for sl, dim in zip(idx, shape)]
        out.append([starts, ends])
    return np.asarray(out, dtype=np.int64).reshape(len(out), 2, len(shape))


def divisions(a) -> np.ndarray:
    """``(n_shards, 2, ndim)`` start/end table of ``a``, every shard."""
    sh, shape = _layout(a)
    return _table(sh, shape)


def find_owning_worker(a, index) -> int:
    """Which shard (linear position in the mesh grid) owns global
    ``index``; the first one where several hold it."""
    sh, shape = _layout(a)
    index = tuple(int(i) for i in (
        index if isinstance(index, (tuple, list)) else (index,)))
    for k, (_pos, idx) in enumerate(sh.shard_indices(shape)):
        ok = True
        for d, i in enumerate(index):
            sl = idx[d] if d < len(idx) else slice(None)
            lo = sl.start if sl.start is not None else 0
            hi = sl.stop if sl.stop is not None else shape[d]
            if not lo <= i < hi:
                ok = False
                break
        if ok:
            return k
    raise IndexError(f"index {index} out of bounds for shape {shape}")


# ---------------------------------------------------------------------------
# Division-table algebra
# ---------------------------------------------------------------------------


def slice_divisions(divs: np.ndarray, index) -> np.ndarray:
    """Division table of ``a[index]`` in the sliced coordinate system.
    ``index`` is a tuple of slices and/or ints (negative allowed, NumPy
    semantics); steps must be positive unit.  Empty per-shard boxes come
    out start == end."""
    divs = np.asarray(divs)
    nd = divs.shape[2]
    if not isinstance(index, tuple):
        index = (index,)
    index = index + (slice(None),) * (nd - len(index))
    if len(index) != nd:
        raise IndexError(
            f"too many indices for a {nd}-dim division table: {index!r}")
    out = divs.copy()
    dims = divs[:, 1, :].max(axis=0) if len(divs) else np.zeros(nd, int)
    for d, sl in enumerate(index):
        dim = int(dims[d])
        if isinstance(sl, (int, np.integer)):
            i = int(sl)
            if i < 0:
                i += dim
            if not 0 <= i < dim:
                raise IndexError(
                    f"index {sl} out of bounds for dim {d} of size {dim}")
            sl = slice(i, i + 1)
        elif not isinstance(sl, slice):
            raise TypeError(
                f"slice_divisions supports slices and ints, got {sl!r}")
        start, stop, step = sl.indices(dim)
        if step != 1:
            raise NotImplementedError("slice_divisions: positive unit steps")
        lo = np.clip(divs[:, 0, d], start, stop) - start
        hi = np.clip(divs[:, 1, d], start, stop) - start
        out[:, 0, d] = lo
        out[:, 1, d] = np.maximum(lo, hi)
    return out


def intersect_divisions(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per-shard box intersection of two aligned tables."""
    a, b = np.asarray(a), np.asarray(b)
    lo = np.maximum(a[:, 0, :], b[:, 0, :])
    hi = np.minimum(a[:, 1, :], b[:, 1, :])
    return np.stack([lo, np.maximum(lo, hi)], axis=1)


def broadcast_divisions(divs: np.ndarray, shape) -> np.ndarray:
    """Expand a table to a broadcast ``shape``: new leading dims and
    size-1 dims cover the full broadcast extent on every shard."""
    divs = np.asarray(divs)
    n, _, nd = divs.shape
    shape = tuple(int(s) for s in shape)
    grow = len(shape) - nd
    if grow < 0:
        raise ValueError("broadcast shape has fewer dims than the table")
    out = np.zeros((n, 2, len(shape)), divs.dtype)
    out[:, 1, :grow] = np.asarray(shape[:grow])
    for d in range(nd):
        D = grow + d
        if np.all(divs[:, 1, d] <= 1) and shape[D] > 1:
            out[:, 0, D] = 0
            out[:, 1, D] = shape[D]
        else:
            out[:, 0, D] = divs[:, 0, d]
            out[:, 1, D] = divs[:, 1, d]
    return out


def make_uni_divisions(shape, worker: int = 0, n_workers=None) -> np.ndarray:
    """Whole array on one worker, empty boxes elsewhere."""
    shape = tuple(int(s) for s in shape)
    n = int(n_workers if n_workers is not None else _mesh.num_workers())
    out = np.zeros((n, 2, len(shape)), np.int64)
    out[worker, 1, :] = shape
    return out


def divisions_size(divs: np.ndarray) -> np.ndarray:
    """Element count per shard box."""
    divs = np.asarray(divs)
    return np.prod(np.maximum(0, divs[:, 1, :] - divs[:, 0, :]), axis=1)


def default_distribution(shape) -> np.ndarray:
    """Division table the default partitioner would choose for ``shape``
    (metadata only: nothing is allocated)."""
    shape = tuple(int(s) for s in shape)
    mesh = _mesh.get_mesh()
    return _table(_mesh.NamedSharding(mesh, _mesh.default_spec(shape, mesh)),
                  shape)
