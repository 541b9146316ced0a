"""File I/O: pluggable loaders keyed by file extension.

Counterpart of ``ramba_tpu/fileio.py``: ``load`` dispatches on the
extension through ``register_loader``, ``Dataset`` is a lazy handle, and
``save`` writes ``.npy``, ``.h5``/``.hdf5`` and the sharded directory
format ``.rtd``.  The HDF5, netCDF and image loaders are import-gated, as
in the reference.

Host memory stays bounded on one card the way the reference bounds it per
shard: every read and write goes through ``core/staging.py`` in C-order
chunks of at most ``staging.CHUNK_BYTES``, each through a reusable pinned
staging buffer into (or out of) its slice of the device tensor.  No array
is ever copied to the host whole (``io_stats["max_chunk_bytes"]`` shows
the bound).  Every chunk read and every file write runs under the
``fileio`` retry policy, which is also the fault-injection site
(``RAMBA_FAULTS=fileio:...``).

Loaded arrays land on the port's device (``common.device()``).

On a mesh of ranks (``parallel/distributed.py``) every rank runs the same
call: a load reads only the rank's block of the file; an ``.rtd`` save has
every rank write the blocks it owns and its own manifest part (``nproc``
is the world size), then a barrier; a single-file save gathers the array,
rank 0 (the driver) writes it, and every rank learns whether the write
succeeded.  The retries at the ``fileio`` site run per rank.
"""

from __future__ import annotations

import bisect
import glob
import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from ramba_tpu_torch import common
from ramba_tpu_torch.core import staging
from ramba_tpu_torch.core.expr import Const, to_np_dtype
from ramba_tpu_torch.core.ndarray import ndarray
from ramba_tpu_torch.ops.creation import fromarray
from ramba_tpu_torch.parallel import distributed as _distributed
from ramba_tpu_torch.parallel import mesh as _mesh
from ramba_tpu_torch.resilience import faults as _faults
from ramba_tpu_torch.resilience import retry as _retry

_LOADERS: dict = {}


def _resilient_io(op: str, fn):
    """Run one read/write thunk under the ``fileio`` retry policy (site for
    both the backoff budget and ``RAMBA_FAULTS=fileio:...`` injection).
    Transient I/O errors back off and re-run ``fn``; unrecoverable ones
    (missing file, permissions) propagate immediately."""

    def thunk():
        _faults.check("fileio", op=op)
        return fn()

    return _retry.call("fileio", thunk)


# Chunked-I/O observability: the tests and chip_smoke.py read the bound
# on host memory here.
io_stats = {"chunks": 0, "max_chunk_bytes": 0, "whole_array_reads": 0}


def _note_chunk(nbytes: int, whole: bool) -> None:
    if whole:
        io_stats["whole_array_reads"] += 1
    else:
        io_stats["chunks"] += 1
    io_stats["max_chunk_bytes"] = max(io_stats["max_chunk_bytes"],
                                      int(nbytes))


def _fits_one_chunk(shape, dtype) -> bool:
    n = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
    return n <= staging.CHUNK_BYTES


def read_tensor(shape, dtype, read_slice):
    """A tensor on the port's device whose every chunk is
    ``read_slice(box) -> array`` copied into its place, each chunk read
    under the ``fileio`` retry policy.  An array that fits one chunk is
    read in one piece (``whole_array_reads``)."""
    shape = tuple(int(s) for s in shape)
    whole = _fits_one_chunk(shape, dtype)

    def read_into(box, dst):
        # "equiv": a big-endian file lands in the native byte order
        _resilient_io("read", lambda: np.copyto(dst, read_slice(box),
                                                casting="equiv"))
        _note_chunk(dst.nbytes, whole)

    return staging.from_host_chunks(shape, dtype, read_into, common.device())


def _sharded_from_reader(shape, dtype, read_slice) -> ndarray:
    """Reference name: the array, read chunk by chunk.  In one process the
    card holds the one shard; on a mesh of ranks each rank reads only its
    blocks of the default layout."""
    shape = tuple(int(s) for s in shape)
    mesh = _mesh.get_mesh()
    if not _mesh.is_rank_mesh(mesh):
        return ndarray(Const(read_tensor(shape, dtype, read_slice)))
    sh = _mesh.NamedSharding(mesh, _mesh.default_spec(shape, mesh))
    idxs = [i for _p, i in sh.local_blocks(shape)] or [
        sh.local_index(shape)]

    def read(idx):
        starts = [sl.indices(n)[0] for sl, n in zip(idx, shape)]

        def read_block(box):
            return read_slice(tuple(slice(b.start + s, b.stop + s)
                                    for b, s in zip(box, starts)))

        return read_tensor(_mesh.index_shape(idx, shape), dtype, read_block)

    return ndarray(Const(_mesh.pack([read(i) for i in idxs]), sharding=sh,
                         shape=shape))


def register_loader(extensions, fn: Callable) -> None:
    """Reference: the loader registry by extension (fileio.py)."""
    if isinstance(extensions, str):
        extensions = [extensions]
    for e in extensions:
        _LOADERS[e.lower().lstrip(".")] = fn


class Dataset:
    """Lazy file handle (reference: fileio.Dataset) — records path/key and
    loads on first use."""

    def __init__(self, path: str, key: Optional[str] = None):
        self.path = path
        self.key = key
        self._arr: Optional[ndarray] = None

    def load(self) -> ndarray:
        if self._arr is None:
            self._arr = load(self.path, self.key)
        return self._arr

    def __getattr__(self, name):
        return getattr(self.load(), name)

    def __getitem__(self, idx):
        return self.load()[idx]


def load(path: str, key: Optional[str] = None) -> ndarray:
    """Reference: ramba.load — dispatch by extension."""
    ext = os.path.splitext(path)[1].lower().lstrip(".")
    if ext not in _LOADERS:
        raise ValueError(
            f"no loader registered for extension {ext!r} "
            f"(known: {sorted(_LOADERS)})"
        )
    return _LOADERS[ext](path, key)


# -- built-in loaders (import-gated like the reference) -----------------------


def _load_hdf5(path, key):
    try:
        import h5py  # type: ignore
    except ImportError as e:
        raise ImportError("h5py is required for HDF5 loading") from e
    with h5py.File(path, "r") as f:
        if key is None:
            key = next(iter(f.keys()))
        dset = f[key]

        def read_slice(index):
            if not index:
                return np.asarray(dset[()])
            out = np.empty(staging.box_shape(index), dset.dtype)
            dset.read_direct(out, source_sel=index)
            return out

        # chunked reads happen inside the open-file scope
        return _sharded_from_reader(dset.shape, dset.dtype, read_slice)


def _load_netcdf(path, key):
    try:
        import netCDF4  # type: ignore
    except ImportError as e:
        raise ImportError("netCDF4 is required for netCDF loading") from e
    ds = netCDF4.Dataset(path, "r")
    try:
        if key is None:
            key = next(iter(ds.variables.keys()))
        var = ds.variables[key]
        return _sharded_from_reader(
            var.shape, var.dtype,
            lambda index: np.asarray(var[tuple(index)]),
        )
    finally:
        ds.close()


def _load_image(path, key):
    try:
        from PIL import Image  # type: ignore
    except ImportError as e:
        raise ImportError("PIL is required for image loading") from e
    with Image.open(path) as im:
        return fromarray(np.asarray(im))


def _map_npy(path: str, dtype=None):
    """A read-only memmap of a ``.npy`` file.  NumPy writes bfloat16 as raw
    2-byte void; where the caller knows the dtype (a checkpoint or
    ``.rtd`` manifest records it), such bytes are viewed as it."""
    m = np.load(path, mmap_mode="r")
    if dtype is not None and m.dtype != dtype and m.dtype.kind == "V" \
            and m.dtype.itemsize == np.dtype(dtype).itemsize:
        m = m.view(dtype)
    return m


def read_npy(path: str, dtype=None):
    """A ``.npy`` file as a tensor on the port's device: a memmap read
    chunk by chunk (each chunk copied from the page cache into a pinned
    buffer, then to its slice of the device tensor).  ``dtype``: what
    the file holds where it stores it as raw void (bfloat16)."""
    m = _map_npy(path, dtype)
    try:
        return read_tensor(m.shape, m.dtype,
                           lambda index: m[index] if index else m[()])
    finally:
        _close_memmap(m)


def _load_npy(path, key):
    return load_npy(path)


def load_npy(path: str, dtype=None) -> ndarray:
    """A ``.npy`` file as a port array (each rank reads its block on a
    mesh of ranks); ``dtype`` as for :func:`read_npy`."""
    m = _map_npy(path, dtype)
    try:
        return _sharded_from_reader(
            m.shape, m.dtype, lambda index: m[index] if index else m[()])
    finally:
        _close_memmap(m)


def _close_memmap(m) -> None:
    mm = getattr(m, "_mmap", None)
    if mm is not None:
        mm.close()


register_loader(["h5", "hdf5"], _load_hdf5)
register_loader(["nc", "netcdf"], _load_netcdf)
register_loader(["png", "jpg", "jpeg", "bmp", "gif"], _load_image)
register_loader(["npy"], _load_npy)


def _shard_chunks(arr):
    """Yield ``(box, np_chunk)`` over an array in C order: a port array or
    tensor chunk by chunk from the device (host memory stays at one
    chunk), a host array in one piece."""
    if isinstance(arr, (ndarray, torch.Tensor)):
        t = arr._value() if isinstance(arr, ndarray) else arr
        whole = t.numel() * t.element_size() <= staging.CHUNK_BYTES
        for box, chunk in staging.to_host_chunks(t):
            _note_chunk(chunk.nbytes, whole)
            yield box, chunk
    else:
        data = np.asarray(arr)
        io_stats["whole_array_reads"] += 1
        yield tuple(slice(0, d) for d in data.shape), data


def _arr_meta(arr):
    if isinstance(arr, ndarray):
        return tuple(arr.shape), np.dtype(arr.dtype)
    if isinstance(arr, torch.Tensor):
        return tuple(arr.shape), to_np_dtype(arr.dtype)
    a = np.asarray(arr)
    return tuple(a.shape), np.dtype(a.dtype)


def _write_npy_file(path: str, arr) -> None:
    """``arr`` into a new ``.npy`` file at ``path``, chunk by chunk through
    ``np.lib.format.open_memmap``."""
    shape, dtype = _arr_meta(arr)
    out = np.lib.format.open_memmap(path, mode="w+", dtype=dtype,
                                    shape=shape)
    try:
        for idx, chunk in _shard_chunks(arr):
            if shape == ():
                out[()] = chunk
            else:
                out[idx] = chunk
        out.flush()
    finally:
        _close_memmap(out)
        del out


def write_npy(path: str, arr) -> None:
    """Write ``arr`` to ``path`` in the ``.npy`` format under the
    ``fileio`` retry policy (a retried attempt recreates the file)."""
    _resilient_io("write", lambda: _write_npy_file(path, arr))


# ---------------------------------------------------------------------------
# Sharded directory format (.rtd): per-shard .npy files + JSON manifests.
#
# The reference's multi-controller answer to single-file save: every
# process writes only the shards it owns plus its own manifest part, and
# load reassembles any set of boxes, so the reading layout may differ from
# the writing one.  The port writes one shard per device (one card: one
# shard) and reads any set of boxes, e.g. ramba_tpu's 8-device saves.
# ---------------------------------------------------------------------------


def _save_rtd(path: str, arr) -> None:
    if not isinstance(arr, (ndarray, torch.Tensor)):
        arr = np.asarray(arr)
    os.makedirs(path, exist_ok=True)
    pid = _distributed.process_index()
    try:
        # _write_rtd_part clears this process's stale files first, so a
        # retried attempt restarts from a clean slate
        _resilient_io("write", lambda: _write_rtd_part(path, arr, pid))
    finally:
        # every process must see every part before anyone may load; a
        # rank whose write failed still joins, or the others block
        _distributed.barrier("ramba_rtd_save")


def _owned_blocks(arr):
    """``[(tensor, start)]``: the blocks this process writes.  On a mesh
    of ranks a block held by several positions (whole along some mesh
    axes) is written by the rank holding the one at coordinate 0 of those
    axes, as the reference's first device in ``devices_indices_map``
    order; in one process the whole array (start None)."""
    if not isinstance(arr, ndarray):
        return [(arr, None)]
    sh = arr.sharding
    mesh = sh.mesh
    if not _mesh.is_rank_mesh(mesh):
        return [(arr, None)]
    used = {nm for e in sh.spec for nm in _mesh.entry_names(e)}
    nd = len(arr.shape)
    blocks = {sh.block_coords(p, nd): (i, b) for (p, i), b in zip(
        sh.local_blocks(arr.shape), arr._blocks())}
    out = []
    for pos in mesh.local_positions():
        if any(c for nm, c in zip(mesh.axis_names, pos) if nm not in used):
            continue
        idx, b = blocks[sh.block_coords(pos, nd)]
        if 0 in _mesh.index_shape(idx, arr.shape):
            continue
        out.append((b, [sl.indices(n)[0] for sl, n in zip(idx, arr.shape)]))
    return out


def _write_rtd_part(path: str, arr, pid: int) -> None:
    for stale in glob.glob(os.path.join(path, f"shard_p{pid}_*.npy")) + \
            glob.glob(os.path.join(path, f"manifest.p{pid}.json")):
        os.remove(stale)
    shape, dtype = _arr_meta(arr)
    entries = []
    for k, (data, start) in enumerate(_owned_blocks(arr)):
        start = start or [0] * len(shape)
        fname = f"shard_p{pid}_{k}.npy"
        _write_npy_file(os.path.join(path, fname), data)
        bshape, _dt = _arr_meta(data)
        entries.append({"file": fname, "start": list(start),
                        "stop": [a + n for a, n in zip(start, bshape)]})
    # atomic manifest publish (tmp + rename): a reader never sees a
    # half-written part
    mpath = os.path.join(path, f"manifest.p{pid}.json")
    with open(mpath + ".tmp", "w") as f:
        json.dump({"shape": list(shape), "dtype": dtype.name,
                   "nproc": _distributed.process_count(),
                   "shards": entries}, f)
    os.replace(mpath + ".tmp", mpath)


def _boxes_cover(shape, boxes) -> bool:
    """Exact union-coverage test for axis-aligned boxes via coordinate
    compression: cell count is bounded by (2 * nshards)^ndim, independent
    of the array size, so this runs at load time even for huge arrays."""
    nd = len(shape)
    coords = []
    for d in range(nd):
        cs = {0, shape[d]}
        for start, stop in boxes:
            cs.add(min(max(start[d], 0), shape[d]))
            cs.add(min(max(stop[d], 0), shape[d]))
        coords.append(sorted(cs))
    grid_shape = tuple(max(1, len(c) - 1) for c in coords)
    covered = np.zeros(grid_shape, bool)
    for start, stop in boxes:
        idx = tuple(
            slice(bisect.bisect_left(coords[d], min(max(start[d], 0),
                                                    shape[d])),
                  bisect.bisect_left(coords[d], min(max(stop[d], 0),
                                                    shape[d])))
            for d in range(nd)
        )
        covered[idx] = True
    return bool(covered.all())


def _load_rtd(path: str, key=None) -> ndarray:
    parts = sorted(glob.glob(os.path.join(path, "manifest.p*.json")))
    if not parts:
        raise FileNotFoundError(f"no .rtd manifests under {path!r}")
    shards = []
    shape = dtype = nproc = None
    for p in parts:
        with open(p) as f:
            m = json.load(f)
        meta = (tuple(m["shape"]), np.dtype(m["dtype"]),
                int(m.get("nproc", 1)))
        if shape is None:
            shape, dtype, nproc = meta
        elif (shape, dtype, nproc) != meta:
            raise ValueError(
                f"inconsistent .rtd manifests under {path!r}: {meta} vs "
                f"{(shape, dtype, nproc)} — mixed saves in one directory?"
            )
        for e in m["shards"]:
            shards.append((tuple(e["start"]), tuple(e["stop"]),
                           os.path.join(path, e["file"])))
    if len(parts) != nproc:
        raise ValueError(
            f".rtd checkpoint {path!r} was written by {nproc} processes "
            f"but {len(parts)} manifest parts are present — stale or "
            f"incomplete save"
        )
    missing = [f for _s, _t, f in shards if not os.path.exists(f)]
    if missing:
        raise FileNotFoundError(
            f"rtd checkpoint {path!r} is missing {len(missing)} shard "
            f"file(s), e.g. {missing[0]!r} — incomplete or corrupted save"
        )
    if shape != () and 0 not in shape and not _boxes_cover(
        shape, [(s, t) for s, t, _f in shards]
    ):
        raise ValueError(
            f"rtd checkpoint {path!r} does not cover the full "
            f"{shape} array — incomplete save?"
        )

    mmaps: dict = {}  # one open per shard file per load, not per region

    def shard_map(fname):
        if fname not in mmaps:
            mmaps[fname] = _map_npy(fname, dtype)
        return mmaps[fname]

    def read_slice(index):
        sel = tuple((sl.start, sl.stop) for sl in index)
        for start, stop, fname in shards:
            # a chunk inside one shard (every chunk of a one-shard save) is
            # a view of its map: no assembly buffer, no coverage mask
            if all(s <= a and b <= t
                   for (a, b), s, t in zip(sel, start, stop)):
                return shard_map(fname)[tuple(
                    slice(a - s, b - s) for (a, b), s in zip(sel, start))]
        out = np.empty(tuple(hi - lo for lo, hi in sel), dtype)
        covered = np.zeros(out.shape, bool)  # exact: overlaps don't fool it
        for start, stop, fname in shards:
            lo = tuple(max(a, s) for (a, _), s in zip(sel, start))
            hi = tuple(min(b, t) for (_, b), t in zip(sel, stop))
            if any(lo_ >= hi_ for lo_, hi_ in zip(lo, hi)):
                continue
            m = shard_map(fname)
            dst = tuple(slice(l_ - a, h_ - a)
                        for (a, _), l_, h_ in zip(sel, lo, hi))
            src = tuple(slice(l_ - s, h_ - s)
                        for s, l_, h_ in zip(start, lo, hi))
            out[dst] = m[src]
            covered[dst] = True
        if not covered.all():
            raise ValueError(
                f"rtd checkpoint {path!r} does not cover region {sel} "
                f"({int(covered.sum())}/{covered.size} elements covered "
                f"— incomplete save?)"
            )
        return out

    try:
        return _sharded_from_reader(shape, dtype, read_slice)
    finally:
        # the chunks were copied to the device; holding the mmaps until GC
        # can exhaust file descriptors in a long resume loop
        for m in mmaps.values():
            _close_memmap(m)
        mmaps.clear()


register_loader(["rtd"], _load_rtd)


def _single_writer(write_fn) -> None:
    """Single-writer file write: rank 0 (the driver) writes under the
    ``fileio`` retry policy, then every process learns whether the write
    succeeded (an all-reduce that is also the completion barrier), so a
    failed driver write raises on every rank.  Every process calls it."""
    if _distributed.process_count() <= 1:
        _resilient_io("write", write_fn)
        return
    err = None
    if _distributed.in_driver():
        try:
            _resilient_io("write", write_fn)
        except Exception as e:  # re-raised below, after the agreement
            err = e
    failed = _distributed.all_reduce_int(0 if err is None else 1, "max")
    _distributed.note_transfer("broadcast", 8)
    if err is not None:
        raise err
    if failed:
        raise RuntimeError("the driver (process 0) failed to write the "
                           "file; see its log for the original exception")


def save(path: str, arr) -> None:
    """Chunked save, dispatched by extension like ``load``: a port array
    is written chunk by chunk from the device, so host memory is bounded
    by one chunk.  On a mesh of ranks a single file is written by the
    driver from the gathered array."""
    ext = os.path.splitext(path)[1].lower().lstrip(".")
    if ext == "rtd":
        return _save_rtd(path, arr)
    if ext not in ("npy", "h5", "hdf5"):
        raise ValueError(
            f"no saver for extension {ext!r} (supported: npy, h5/hdf5, rtd)"
        )
    if isinstance(arr, ndarray) and _distributed.process_count() > 1:
        arr = arr._value()  # every rank takes part in the gather
    if ext == "npy":
        _single_writer(lambda: _write_npy_file(path, arr))
        return
    try:
        import h5py  # type: ignore
    except ImportError as e:
        raise ImportError("h5py is required for HDF5 saving") from e
    shape, dtype = _arr_meta(arr)

    def write_h5():
        with h5py.File(path, "w") as f:
            dset = f.create_dataset("data", shape=shape, dtype=dtype)
            for idx, chunk in _shard_chunks(arr):
                if shape == ():
                    dset[()] = chunk
                else:
                    dset[idx] = chunk

    _single_writer(write_h5)


def loadtxt(fname, dtype=float, comments="#", delimiter=None, skiprows=0,
            usecols=None, ndmin=0):
    """numpy.loadtxt → port array (host parse, uploaded on arrival)."""
    return fromarray(_resilient_io(
        "read",
        lambda: np.loadtxt(fname, dtype=dtype, comments=comments,
                           delimiter=delimiter, skiprows=skiprows,
                           usecols=usecols, ndmin=ndmin),
    ))


def genfromtxt(fname, **kwargs):
    return fromarray(_resilient_io("read",
                                   lambda: np.genfromtxt(fname, **kwargs)))


def savetxt(fname, X, fmt="%.18e", delimiter=" ", newline="\n", header="",
            footer="", comments="# "):
    """numpy.savetxt from a port array (a text file is written from the
    host, so the array is copied there)."""
    x = X.asarray() if hasattr(X, "asarray") else np.asarray(X)
    _single_writer(
        lambda: np.savetxt(fname, x, fmt=fmt, delimiter=delimiter,
                           newline=newline, header=header, footer=footer,
                           comments=comments)
    )
