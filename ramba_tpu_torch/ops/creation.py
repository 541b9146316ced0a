"""Array creation.

Counterpart of ``ramba_tpu/ops/creation.py``.  Every creation op is a lazy
node that generates its data on the device at flush time and fuses with
its consumers; ``fromarray`` uploads a host array as a leaf.  Explicit
distributions are not ported yet: a non-``None`` ``distribution`` raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ramba_tpu_torch import common
from ramba_tpu_torch.core import expr as E
from ramba_tpu_torch.core.expr import Const, Node
from ramba_tpu_torch.core.ndarray import ndarray, as_exprable, put_sharded
from ramba_tpu_torch.parallel import mesh as _mesh

# x64 regime: numpy's default int and float
_DEFAULT_INT = np.dtype(np.int64)
_DEFAULT_FLOAT = np.dtype(np.float64)


def _no_distribution(distribution):
    """Every creation op starts here: it refuses explicit distributions and
    resolves the device now, so a run with no card (and no request for the
    CPU) fails at the first array instead of at its first flush."""
    if distribution is not None:
        raise NotImplementedError(
            "explicit distributions are taken by fromarray only; the other "
            "creation ops take them with create_array_with_divisions, in the "
            "multi-process slice of the port (ROADMAP A.6, part three)")
    common.device()


def _canon_shape(shape):
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _np_dtype(dtype):
    if dtype is float:
        return _DEFAULT_FLOAT
    if dtype is int:
        return _DEFAULT_INT
    return E.to_np_dtype(dtype)


def empty(shape, dtype=float, local_border=0, distribution=None):
    return full(shape, 0, dtype, distribution=distribution)


def zeros(shape, dtype=float, local_border=0, distribution=None):
    return full(shape, 0, dtype, distribution=distribution)


def ones(shape, dtype=float, local_border=0, distribution=None):
    return full(shape, 1, dtype, distribution=distribution)


def full(shape, fill_value, dtype=None, local_border=0, distribution=None):
    _no_distribution(distribution)
    shape = _canon_shape(shape)
    if dtype is None:
        dtype = np.result_type(fill_value)
    dtype = _np_dtype(dtype)
    return ndarray(Node("full", (shape, str(dtype), None),
                        [as_exprable(fill_value)]))


def _like_shape_dtype(a, dtype):
    if isinstance(a, ndarray):
        return a.shape, (dtype or a.dtype)
    a = np.asarray(a)
    return a.shape, (dtype or a.dtype)


def empty_like(a, dtype=None, distribution=None):
    return zeros_like(a, dtype, distribution=distribution)


def zeros_like(a, dtype=None, distribution=None):
    shape, dtype = _like_shape_dtype(a, dtype)
    return full(shape, 0, dtype, distribution=distribution)


def ones_like(a, dtype=None, distribution=None):
    shape, dtype = _like_shape_dtype(a, dtype)
    return full(shape, 1, dtype, distribution=distribution)


def full_like(a, fill_value, dtype=None, distribution=None):
    shape, dtype = _like_shape_dtype(a, dtype)
    return full(shape, fill_value, dtype, distribution=distribution)


def arange(start, stop=None, step=None, dtype=None, local_border=0,
           distribution=None):
    _no_distribution(distribution)
    if stop is None:
        start, stop = 0, start
    if step is None:
        step = 1
    n = int(max(0, -(-(stop - start) // step) if step != 0 else 0))
    if dtype is None:
        ints = all(isinstance(x, (int, np.integer)) for x in (start, stop, step))
        dtype = _DEFAULT_INT if ints else _DEFAULT_FLOAT
    dtype = _np_dtype(dtype)
    return ndarray(Node("arange", (n, str(dtype), None),
                        [E.as_expr(start), E.as_expr(step)]))


def linspace(start, stop, num=50, endpoint=True, dtype=None,
             distribution=None):
    _no_distribution(distribution)
    dtype = _DEFAULT_FLOAT if dtype is None else _np_dtype(dtype)
    return ndarray(Node("linspace", (int(num), bool(endpoint), str(dtype),
                                     None),
                        [E.as_expr(start), E.as_expr(stop)]))


def fromfunction(function, shape, dtype=float, distribution=None, **kwargs):
    """An array whose element at ``index`` is ``function(*index)``;
    ``function`` receives int32 index planes (whole arrays) and runs at
    flush time, fused with its consumers."""
    _no_distribution(distribution)
    shape = _canon_shape(shape)
    dt = str(_np_dtype(dtype)) if dtype is not None else None
    return ndarray(Node("fromfunction", (shape, dt, function), []))


def init_array(shape, filler, dtype=float, distribution=None):
    """Reference API: ``init_array`` with a per-element filler."""
    return fromfunction(filler, shape, dtype=dtype, distribution=distribution)


def _resolve_distribution(distribution, shape):
    """A ``NamedSharding``, a ``PartitionSpec`` on the current mesh, or
    per-dim split counts (``spec_from_splits``); None: the default layout."""
    mesh = _mesh.get_mesh()
    if distribution is None:
        return _mesh.NamedSharding(mesh, _mesh.default_spec(shape, mesh))
    if isinstance(distribution, _mesh.NamedSharding):
        return distribution
    if isinstance(distribution, _mesh.PartitionSpec):
        return _mesh.NamedSharding(mesh, distribution)
    splits = tuple(int(s) for s in distribution)
    if len(splits) != len(shape):
        raise ValueError(f"distribution has {len(splits)} entries for a "
                         f"{len(shape)}-d array")
    return _mesh.NamedSharding(mesh, _mesh.spec_from_splits(splits, mesh))


def fromarray(arr, dtype=None, distribution=None):
    """Upload a host array (or adopt a tensor) as a leaf on the process
    device, dtype kept exactly, under ``distribution`` (a
    ``NamedSharding``, a ``PartitionSpec`` or per-dim split counts;
    default: ``default_spec`` of the current mesh)."""
    common.device()
    if isinstance(arr, torch.Tensor):
        t = arr if dtype is None else arr.to(E.to_torch_dtype(_np_dtype(dtype)))
    else:
        # a host array goes up as it is: on a mesh of ranks put_sharded
        # uploads only this rank's block
        t = np.asarray(arr) if dtype is None else np.asarray(arr, dtype=dtype)
    return put_sharded(t, _resolve_distribution(distribution,
                                                tuple(t.shape)))


def asarray(a, dtype=None):
    if isinstance(a, ndarray):
        if dtype is not None and _np_dtype(dtype) != a.dtype:
            return a.astype(dtype)
        return a
    return fromarray(a, dtype=dtype)


def array(a, dtype=None, copy=True):
    if isinstance(a, ndarray):
        out = a.copy() if copy else a
        return out.astype(dtype) if dtype is not None else out
    return fromarray(a, dtype=dtype)


def copy(a):
    return a.copy() if isinstance(a, ndarray) else fromarray(np.copy(a))


# -- the creation tail ---------------------------------------------------------
# eye, tri and indices are ``call`` nodes (``ops/extras.py``) generated on
# the card; the grids compose arange/linspace/fromfunction with views;
# r_/c_ and the from* readers build on the host, as in the reference.


def _call(name, *arrays, **kw):
    from ramba_tpu_torch.ops.extras import lazy

    return lazy(name, *arrays, **kw)


def eye(N, M=None, k=0, dtype=float, distribution=None):
    _no_distribution(distribution)
    M = N if M is None else M
    return _call("eye", n=int(N), m=int(M), k=int(k),
                 dtype=str(_np_dtype(dtype)))


def identity(n, dtype=float, distribution=None):
    return eye(n, dtype=dtype, distribution=distribution)


def tri(N, M=None, k=0, dtype=float):
    common.device()
    M = N if M is None else M
    return _call("tri", n=int(N), m=int(M), k=int(k),
                 dtype=str(_np_dtype(dtype)))


def indices(dimensions, dtype=int):
    common.device()
    return _call("indices", shape=_canon_shape(dimensions),
                 dtype=str(_np_dtype(dtype)))


def meshgrid(*xi, indexing="xy"):
    """Each input reshaped onto its axis and broadcast (copies, as the
    reference's)."""
    arrs = [asarray(x).reshape(-1) for x in xi]
    nd = len(arrs)
    lens = [a.size for a in arrs]
    swap = indexing == "xy" and nd >= 2
    shape = tuple([lens[1], lens[0]] + lens[2:]) if swap else tuple(lens)
    outs = []
    for d in range(nd):
        vs = [1] * nd
        vs[(1 if d == 0 else 0 if d == 1 else d) if swap else d] = lens[d]
        outs.append(arrs[d].reshape(tuple(vs)).broadcast_to(shape).copy())
    return outs


def _grid_axis(s):
    """One mgrid/ogrid slice as (n, start, step, is_float); a complex step
    is NumPy's point count (``0:1:5j``: 5 points, both ends)."""
    start = s.start or 0
    stop = s.stop
    step = s.step if s.step is not None else 1
    if isinstance(step, complex):
        n = int(abs(step))
        st = (stop - start) / (n - 1) if n > 1 else 0.0
        return n, float(start), float(st), True
    if step == 0:
        raise ValueError("slice step cannot be zero")
    n = int(max(0, -(-(stop - start) // step)))
    is_float = any(isinstance(v, float) for v in (start, stop, step))
    return n, start, step, is_float


class _MGrid:
    """np.mgrid: ``index * step + start`` per axis (float where a bound or
    step is), stacked; the complex-step form included."""

    def __getitem__(self, key):
        from ramba_tpu_torch.ops.manipulation import stack

        if not isinstance(key, tuple):
            key = (key,)
        axes = [_grid_axis(s) for s in key]
        shape = tuple(a[0] for a in axes)
        dt = _DEFAULT_FLOAT if any(a[3] for a in axes) else _DEFAULT_INT
        outs = []
        for d, (n, start, step, _f) in enumerate(axes):
            vs = [1] * len(shape)
            vs[d] = n
            ax = arange(n, dtype=dt) * step + start
            outs.append(ax.astype(dt).reshape(tuple(vs))
                        .broadcast_to(shape))
        return outs[0] if len(outs) == 1 else stack(outs)


mgrid = _MGrid()


class _OGrid:
    """np.ogrid: one broadcastable axis array per slice."""

    def __getitem__(self, key):
        single = not isinstance(key, tuple)
        if single:
            key = (key,)
        outs = []
        nd = len(key)
        for d, s in enumerate(key):
            n, start, step, is_float = _grid_axis(s)
            if is_float:
                ax = linspace(start, start + step * max(n - 1, 0), n)
            else:
                ax = arange(start, start + n * step, step)
            shape = [1] * nd
            shape[d] = n
            outs.append(ax.reshape(tuple(shape)))
        return outs[0] if single else outs


ogrid = _OGrid()


class _RConcat:
    """np.r_ / np.c_: host-side index-expression concatenators; the result
    is uploaded."""

    def __init__(self, np_obj):
        self._np = np_obj

    def __getitem__(self, key):
        def conv(x):
            return x.asarray() if isinstance(x, ndarray) else x

        key = tuple(conv(k) for k in key) if isinstance(key, tuple) \
            else conv(key)
        return fromarray(self._np[key])


r_ = _RConcat(np.r_)
c_ = _RConcat(np.c_)


def logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None,
             distribution=None):
    """``base ** linspace`` (fuses with its consumers)."""
    out = float(base) ** linspace(float(start), float(stop), num,
                                  endpoint=endpoint, distribution=distribution)
    return out.astype(dtype) if dtype is not None else out


def geomspace(start, stop, num=50, endpoint=True, dtype=None,
              distribution=None):
    """A geometric progression through logspace in log10 space."""
    import math

    if start == 0 or stop == 0:
        raise ValueError("Geometric sequence cannot include zero")
    if isinstance(start, complex) or isinstance(stop, complex):
        raise NotImplementedError(
            "complex start/stop is not supported; compute on host with "
            "numpy.geomspace and wrap with fromarray")
    sgn = 1.0
    if start < 0 and stop < 0:
        sgn, start, stop = -1.0, -start, -stop
    elif (start < 0) != (stop < 0):
        raise ValueError(
            "Geometric sequence cannot calculate the step between "
            f"start={start} and stop={stop} with different signs")
    out = sgn * logspace(math.log10(start), math.log10(stop), num,
                         endpoint=endpoint, distribution=distribution)
    return out.astype(dtype) if dtype is not None else out


def fromiter(iterable, dtype, count=-1):
    return fromarray(np.fromiter(iterable, dtype=dtype, count=count))


def frombuffer(buffer, dtype=float, count=-1, offset=0):
    return fromarray(np.frombuffer(buffer, dtype=dtype, count=count,
                                   offset=offset).copy())


def fromstring(string, dtype=float, sep=" "):
    return fromarray(np.fromstring(string, dtype=dtype, sep=sep))


def ascontiguousarray(a, dtype=None):
    # the card's arrays are dense: asarray and the cast
    out = asarray(a)
    return out.astype(dtype) if dtype is not None else out


asfortranarray = ascontiguousarray  # layout is torch's concern, not the user's


def asarray_chkfinite(a, dtype=None):
    from ramba_tpu_torch.ops import reductions
    from ramba_tpu_torch.ops.elementwise import isfinite

    out = asarray(a)
    if np.dtype(out.dtype).kind in "fc" and not bool(
            reductions.all(isfinite(out))):
        raise ValueError("array must not contain infs or NaNs")
    return out.astype(dtype) if dtype is not None else out


def rollaxis(a, axis, start=0):
    """numpy.rollaxis: negative values get +ndim (not a modulo); out of
    range raises."""
    from ramba_tpu_torch.ops.manipulation import moveaxis

    a = asarray(a)
    n = a.ndim
    if axis < 0:
        axis += n
    if not 0 <= axis < n:
        raise np.exceptions.AxisError(
            f"axis {axis} is out of bounds for array of dimension {n}")
    if start < 0:
        start += n
    if not 0 <= start <= n:
        raise np.exceptions.AxisError(
            f"start {start} is out of bounds for array of dimension {n}")
    if axis < start:
        start -= 1
    if axis == start:
        return a
    return moveaxis(a, axis, start)
