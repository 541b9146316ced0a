"""Shape and layout manipulation.

Counterpart of ``ramba_tpu/ops/manipulation.py``: views (reshape,
transpose, moveaxis, expand_dims, squeeze, split) where NumPy gives views,
graph nodes of ``core/expr.py`` for the rest (flip, concatenate and stack
in NumPy's common dtype, pad, repeat, tile, tril/triu, diag, and the
stable sort/argsort with NaNs last).
"""

from __future__ import annotations

import builtins

import numpy as np

from ramba_tpu_torch.core.expr import Node
from ramba_tpu_torch.core.ndarray import as_exprable, expand_ellipsis, ndarray
from ramba_tpu_torch.ops.creation import asarray


def reshape(a, shape, order="C"):
    return asarray(a).reshape(shape)


def reshape_copy(a, shape):
    """A reshape that is a copy, not a view."""
    return asarray(a).reshape(shape).copy()


def apply_index(shape, index):
    """The shape basic indexing gives and the canonical index:
    ``(dim_shapes, (canonical_index, axismap))``.  ``canonical_index`` has
    one ``slice`` per base dimension (an integer becomes a length-1
    slice); ``axismap`` lists the base dims kept in the result.  Integers
    out of range raise ``IndexError``."""
    if not isinstance(index, tuple):
        index = (index,)
    index = expand_ellipsis(index, len(shape))
    n_spec = builtins.sum(1 for it in index if it is not None)
    index = index + (slice(None),) * (len(shape) - n_spec)
    cindex, axismap, dim_shapes = [], [], []
    d = 0
    for it in index:
        if it is None:
            dim_shapes.append(1)
            continue
        size = shape[d]
        if isinstance(it, (int, np.integer)):
            i = int(it)
            if not -size <= i < size:
                raise IndexError(
                    f"index {i} is out of bounds for axis {d} with size {size}")
            i += size if i < 0 else 0
            cindex.append(slice(i, i + 1, 1))
        elif isinstance(it, slice):
            start, stop, step = it.indices(size)
            n = len(range(start, stop, step))
            # a reverse slice down to index 0 canonicalizes to stop=-1,
            # which as a literal means "the last element": keep None
            if step < 0 and stop < 0:
                stop = None
            cindex.append(slice(start, stop, step))
            axismap.append(d)
            dim_shapes.append(n)
        else:
            raise TypeError(f"apply_index handles basic indexing only, got "
                            f"{type(it).__name__}")
        d += 1
    return tuple(dim_shapes), (tuple(cindex), axismap)


def ravel(a):
    return asarray(a).ravel()


def transpose(a, axes=None):
    a = asarray(a)
    return a.transpose(axes) if axes is not None else a.transpose()


def _norm_axes(ax, ndim):
    axs = (ax,) if np.isscalar(ax) else tuple(ax)
    return tuple(int(a) % ndim for a in axs)


def moveaxis(a, source, destination):
    a = asarray(a)
    src = _norm_axes(source, a.ndim)
    dst = _norm_axes(destination, a.ndim)
    order = [n for n in range(a.ndim) if n not in src]
    for d, s in sorted(zip(dst, src)):
        order.insert(d, s)
    return a.transpose(order)


def swapaxes(a, axis1, axis2):
    return asarray(a).swapaxes(axis1, axis2)


def expand_dims(a, axis):
    a = asarray(a)
    axs = (axis,) if np.isscalar(axis) else tuple(axis)
    shape = list(a.shape)
    for ax in sorted(ax % (a.ndim + len(axs)) for ax in axs):
        shape.insert(ax, 1)
    return a.reshape(tuple(shape))


def squeeze(a, axis=None):
    return asarray(a).squeeze(axis)


def broadcast_to(a, shape):
    return asarray(a).broadcast_to(tuple(shape))


def flip(a, axis=None):
    a = asarray(a)
    if axis is None:
        axes = tuple(range(a.ndim))
    elif np.isscalar(axis):
        axes = (int(axis) % a.ndim,)
    else:
        axes = tuple(int(x) % a.ndim for x in axis)
    return ndarray(Node("flip", (axes,), [a.read_expr()]))


def roll(a, shift, axis=None):
    a = asarray(a)
    if axis is None:
        flat = a.ravel()
        n = flat.size
        s = shift % n if n else 0
        if s == 0:
            return a.copy()
        return concatenate([flat[n - s:], flat[: n - s]]).reshape(a.shape)
    shifts = (shift,) if np.isscalar(shift) else tuple(shift)
    axes = (axis,) if np.isscalar(axis) else tuple(axis)
    out = a
    for s, ax in zip(shifts, axes):
        ax = ax % a.ndim
        n = a.shape[ax]
        s = s % n if n else 0
        if s == 0:
            continue
        idx_a = [slice(None)] * a.ndim
        idx_b = [slice(None)] * a.ndim
        idx_a[ax] = slice(n - s, None)
        idx_b[ax] = slice(None, n - s)
        out = concatenate([out[tuple(idx_a)], out[tuple(idx_b)]], axis=ax)
    return out


def concatenate(arrays, axis=0):
    """One node; the operands join in NumPy's common dtype."""
    if axis is None:
        exprs = [as_exprable(asarray(a).ravel()) for a in arrays]
        axis = 0
    else:
        exprs = [as_exprable(asarray(a)) for a in arrays]
    return ndarray(Node("concatenate", (int(axis),), exprs))


def stack(arrays, axis=0):
    exprs = [as_exprable(asarray(a)) for a in arrays]
    return ndarray(Node("stack", (int(axis),), exprs))


def vstack(tup):
    arrs = [asarray(a) for a in tup]
    arrs = [a.reshape((1, a.size)) if a.ndim == 1 else a for a in arrs]
    return concatenate(arrs, axis=0)


def hstack(tup):
    arrs = [asarray(a) for a in tup]
    if arrs and arrs[0].ndim == 1:
        return concatenate(arrs, axis=0)
    return concatenate(arrs, axis=1)


def dstack(tup):
    arrs = []
    for a in tup:
        a = asarray(a)
        if a.ndim == 1:
            a = a.reshape((1, a.size, 1))
        elif a.ndim == 2:
            a = a.reshape(a.shape + (1,))
        arrs.append(a)
    return concatenate(arrs, axis=2)


def column_stack(tup):
    arrs = []
    for a in tup:
        a = asarray(a)
        if a.ndim == 1:
            a = a.reshape((a.size, 1))
        arrs.append(a)
    return concatenate(arrs, axis=1)


def split(ary, indices_or_sections, axis=0):
    """Views of consecutive pieces along ``axis``."""
    ary = asarray(ary)
    axis = axis % ary.ndim
    n = ary.shape[axis]
    if np.isscalar(indices_or_sections):
        k = int(indices_or_sections)
        if n % k != 0:
            raise ValueError("array split does not result in an equal division")
        points = [n // k * i for i in range(1, k)]
    else:
        points = list(indices_or_sections)
    out = []
    prev = 0
    for p in points + [n]:
        idx = [slice(None)] * ary.ndim
        idx[axis] = slice(prev, p)
        out.append(ary[tuple(idx)])
        prev = p
    return out


def array_split(ary, k, axis=0):
    ary = asarray(ary)
    axis = axis % ary.ndim
    n = ary.shape[axis]
    k = int(k)
    sizes = [n // k + (1 if i < n % k else 0) for i in range(k)]
    points = np.cumsum(sizes)[:-1].tolist()
    return split(ary, points, axis)


def pad(array, pad_width, mode="constant", constant_values=0):
    """Modes constant, empty, edge, wrap, reflect and symmetric."""
    a = asarray(array)
    if np.isscalar(pad_width):
        pw = tuple((int(pad_width), int(pad_width)) for _ in range(a.ndim))
    else:
        pw = np.asarray(pad_width)
        if pw.ndim == 1:
            pw = tuple((int(pw[0]), int(pw[-1])) for _ in range(a.ndim))
        else:
            pw = tuple((int(lo), int(hi)) for lo, hi in pw)
    args = [a.read_expr()]
    if mode == "constant":
        args.append(as_exprable(constant_values))
    return ndarray(Node("pad", (pw, mode), args))


def tril(m, k=0):
    return ndarray(Node("tril", (int(k),), [as_exprable(asarray(m))]))


def triu(m, k=0):
    return ndarray(Node("triu", (int(k),), [as_exprable(asarray(m))]))


def diag(v, k=0):
    return ndarray(Node("diag", (int(k),), [as_exprable(asarray(v))]))


def repeat(a, repeats, axis=None):
    a = asarray(a)
    if axis is None:
        a = a.ravel()
        axis = 0
    return ndarray(Node("repeat", (int(repeats), int(axis) % a.ndim),
                        [a.read_expr()]))


def tile(a, reps):
    a = asarray(a)
    reps = (int(reps),) if np.isscalar(reps) else tuple(int(r) for r in reps)
    return ndarray(Node("tile", (reps,), [a.read_expr()]))


def sort(a, axis=-1, kind=None, order=None, *, stable=None):
    """Stable, NaNs last (every ``kind`` is met by the stable sort);
    ``order`` needs structured dtypes, which the device has not."""
    if order is not None:
        raise ValueError("order= requires structured dtypes (unsupported)")
    return ndarray(Node("sort", (axis,), [as_exprable(asarray(a))]))


def argsort(a, axis=-1, kind=None, order=None, *, stable=None):
    if order is not None:
        raise ValueError("order= requires structured dtypes (unsupported)")
    return ndarray(Node("argsort", (axis,), [as_exprable(asarray(a))]))


def take(a, indices, axis=None):
    return asarray(a).take(indices, axis)


def atleast_1d(*arys):
    out = [asarray(a) if np.ndim(a) >= 1 else asarray(a).reshape((1,))
           for a in arys]
    return out[0] if len(out) == 1 else out


def atleast_2d(*arys):
    out = []
    for a in arys:
        a = asarray(a)
        if a.ndim == 0:
            a = a.reshape((1, 1))
        elif a.ndim == 1:
            a = a.reshape((1, a.size))
        out.append(a)
    return out[0] if len(out) == 1 else out
