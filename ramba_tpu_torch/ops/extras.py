"""The NumPy surface beyond the core op tables.

Counterpart of ``ramba_tpu/ops/extras.py``.  Its functions come in three
kinds:

* **compositions** of graph ops the port already has (``diff``,
  ``trapezoid``, ``nan_to_num``, ``fix``, ``around``, ``modf``,
  ``divmod``, ``polyval``, ``vander``, ``cov``, ``corrcoef``, ``unwrap``,
  ``nancumsum``/``nancumprod``, the split/stack family ...): the existing
  dtype rules and kernels carry them (a float ``nancumsum`` is a NaN-to-0
  select in front of ``cumulative``, so it reaches the scan kernel);
* **calls**: one ``call`` node per function, ``CALLS[name]`` holding a
  plain torch function and an explicit aval rule held against
  ``ramba_tpu`` (``searchsorted``/``digitize`` give int32, ``quantile`` of
  int32 gives float32, ...), never the dtype torch returns;
* **host boundaries**, where ``ramba_tpu`` draws them (data-dependent
  shapes: ``unique``, ``nonzero``, the set ops, ``insert``/``delete``,
  ``histogram``, ``polyfit``/``roots`` ...): the same arguments and the
  same NumPy results, the operands copied to the host.

The in-place writers (``copyto``, ``fill_diagonal``, ``putmask``,
``place``, ``put_along_axis``) build the new value as a graph and assign
it with ``a[...] = value``, so a write through a view reaches its base.
"""

from __future__ import annotations

import operator
import weakref

import numpy as np
import torch

from ramba_tpu_torch.core import expr as E
from ramba_tpu_torch.core import fuser
from ramba_tpu_torch.core.expr import Aval, Node, as_tensor, defop
from ramba_tpu_torch.core.ndarray import ndarray, as_exprable
from ramba_tpu_torch.ops.creation import asarray, fromarray

# ---------------------------------------------------------------------------
# jnp's dtype rules the calls follow
# ---------------------------------------------------------------------------


def inexact(dt) -> np.dtype:
    """jnp's ``promote_dtypes_inexact`` of one dtype under x64: bool and
    integers of 32 bits or fewer give float32, 64-bit integers float64,
    floats and complex values keep theirs."""
    dt = np.dtype(dt)
    if dt.kind in "biu":
        return np.dtype(np.float64 if dt.itemsize == 8 else np.float32)
    return dt


def promote_inexact(*avals) -> np.dtype:
    return inexact(E.jnp_promote(list(avals)))


def to_complex(dt) -> np.dtype:
    """jnp's ``to_complex_dtype``: complex128 for 64-bit values."""
    dt = inexact(dt)
    if dt.kind == "c":
        return dt
    return np.dtype(np.complex128 if dt.itemsize == 8 else np.complex64)


def _refuse_complex(fname, *avals):
    if any(a.dtype.kind == "c" for a in avals):
        raise ValueError(f"{fname} does not support complex input")


def _refuse_bool(fname, *avals):
    if any(a.dtype.kind == "b" for a in avals):
        raise TypeError(f"{fname} does not accept dtype bool")


# ---------------------------------------------------------------------------
# the call op
# ---------------------------------------------------------------------------

# name -> (plain torch function, aval rule(kw, *avals) -> Aval)
CALLS: dict = {}


def register_call(name, aval_rule):
    def deco(fn):
        CALLS[name] = (fn, aval_rule)
        return fn
    return deco


def _aval_call(static, *avals):
    fname, kw = static
    return CALLS[fname][1](dict(kw), *avals)


@defop("call", _aval_call)
def _op_call(static, *args):
    fname, kw = static
    fn, rule = CALLS[fname]
    out = fn(*[as_tensor(a) for a in args], **dict(kw))
    want = E.to_torch_dtype(rule(dict(kw), *[E.aval_of(a) for a in args]).dtype)
    return out if out.dtype == want else E.convert(out, want)


def lazy(fname, *arrays, **kwargs):
    """A ``call`` node of ``CALLS[fname]`` over ``arrays``."""
    kw = tuple(sorted(kwargs.items()))
    return ndarray(Node("call", (fname, kw), [as_exprable(a) for a in arrays]))


class SharedResult:
    """One result shared by the call nodes of a multi-output function
    (qr, svd, eigh, slogdet) that a flush evaluates together: the first
    node computes, the others read, so the factorization runs once.  Held
    by weak references to its inputs; cleared at the end of a flush."""

    _last = None

    @classmethod
    def get(cls, key, args, compute):
        last = cls._last
        if last is not None and last[0] == key and len(last[1]) == len(args) \
                and all(r() is a for r, a in zip(last[1], args)):
            return last[2]
        out = compute()
        cls._last = (key, [weakref.ref(a) for a in args], out)
        return out

    @classmethod
    def clear(cls):
        cls._last = None


fuser.after_flush.append(SharedResult.clear)


def _host(x):
    return x.asarray() if isinstance(x, ndarray) else np.asarray(x)


def _axis_arg(axis):
    """An int or a tuple of ints (numpy integers accepted)."""
    try:
        return operator.index(axis)
    except TypeError:
        return tuple(operator.index(d) for d in axis)


def _m():
    """The port's top-level namespace (its ops), imported late."""
    import ramba_tpu_torch as rt

    return rt


# ---------------------------------------------------------------------------
# compositions of graph ops
# ---------------------------------------------------------------------------


def _slice_axis(a, start, stop, axis):
    idx = [slice(None)] * a.ndim
    idx[axis] = slice(start, stop)
    return a[tuple(idx)]


def diff(a, n=1, axis=-1):
    """``jnp.diff``: ``a[1:] - a[:-1]`` ``n`` times (``!=`` for bool)."""
    a = asarray(a)
    axis = int(axis) % max(a.ndim, 1)
    for _ in range(int(n)):
        hi, lo = _slice_axis(a, 1, None, axis), _slice_axis(a, None, -1, axis)
        a = hi != lo if a.dtype == np.bool_ else hi - lo
    return a


def ediff1d(ary):
    return diff(asarray(ary).reshape(-1))


def trapezoid(y, x=None, dx=1.0, axis=-1):
    """``jnp.trapezoid``: ``0.5 * (dx * (y[1:] + y[:-1])).sum(-1)`` in the
    inexact dtype of the operands."""
    rt = _m()
    y = asarray(y)
    if x is not None:
        x = asarray(x)
        dt = promote_inexact(y._aval, x._aval)
        x = x.astype(dt)
        d = diff(x) if x.ndim == 1 else rt.moveaxis(diff(x, axis=axis), axis,
                                                    -1)
    else:
        dt = inexact(y.dtype)
        d = float(dx)
    y = rt.moveaxis(y.astype(dt), int(axis), -1)
    return (0.5 * (d * (y[..., 1:] + y[..., :-1]))).sum(-1)


trapz = trapezoid  # numpy<2 name


def nan_to_num(x, copy=True, nan=0.0, posinf=None, neginf=None):
    """``jnp.nan_to_num``: integers and bools unchanged; floats through
    three selects; complex values part by part."""
    rt = _m()
    x = asarray(x)
    dt = np.dtype(x.dtype)
    if dt.kind not in "fc":
        return x
    if dt.kind == "c":
        parts = [nan_to_num(p, nan=nan, posinf=posinf, neginf=neginf)
                 for p in (rt.real(x), rt.imag(x))]
        return lazy("complex", *parts)
    info = np.finfo(dt) if not E.is_bf16(dt) else None
    hi = info.max if posinf is None else posinf
    lo = info.min if neginf is None else neginf
    out = rt.where(rt.isnan(x), np.array(nan, dt), x)
    out = rt.where(rt.isinf(out) & (out > 0), np.array(hi, dt), out)
    return rt.where(rt.isinf(out) & (out < 0), np.array(lo, dt), out)


def fix(x):
    """numpy.fix: ``trunc`` (ramba_tpu lowers jnp.trunc: integers and
    bools keep their value and dtype)."""
    x = asarray(x)
    if np.dtype(x.dtype).kind == "c":
        raise TypeError("fix does not accept complex values")
    if np.dtype(x.dtype).kind in "biu":
        return x.copy()
    return _m().trunc(x)


def around(a, decimals=0):
    a = asarray(a)
    if a.dtype == np.bool_:
        raise ValueError("around does not accept dtype bool")
    return a.round(int(decimals))


def modf(x):
    """numpy.modf: (fractional, integral) parts, both with x's sign."""
    rt = _m()
    x = asarray(x)
    ip = rt.trunc(x)
    # x - trunc(x) would be inf - inf = nan at +-inf; numpy returns +-0.0
    frac = rt.where(rt.isinf(x), rt.copysign(0.0, x), x - ip)
    return frac, ip


def divmod(a, b):  # noqa: A001 - numpy name
    rt = _m()
    return rt.floor_divide(a, b), rt.mod(a, b)


def polyval(p, x):
    """``jnp.polyval``: Horner's rule in the operands' inexact dtype."""
    rt = _m()
    p, x = asarray(p), asarray(x)
    dt = promote_inexact(p._aval, x._aval)
    p, x = p.astype(dt), x.astype(dt)
    y = rt.zeros(x.shape, dtype=dt)
    for i in range(p.shape[0]):
        y = y * x + p[i]
    return y


def vander(x, N=None, increasing=False):
    """``jnp.vander``: ``x[:, None] ** iota`` in x's dtype."""
    x = asarray(x)
    if x.dtype == np.bool_:
        raise TypeError("vander does not accept dtype bool")
    if x.ndim != 1:
        raise ValueError("x must be a one-dimensional array or sequence.")
    n = x.shape[0] if N is None else int(N)
    iota = np.arange(n)[::-1] if not increasing else np.arange(n)
    return x[:, None] ** fromarray(iota.astype(x.dtype))[None, :]


def _cov_rows(m, y, rowvar):
    rt = _m()
    X = rt.atleast_2d(asarray(m))
    if not rowvar and X.shape[0] != 1:
        X = X.T
    if y is not None:
        Y = rt.atleast_2d(asarray(y))
        if not rowvar and Y.shape[0] != 1:
            Y = Y.T
        X = rt.concatenate([X, Y], axis=0)
    return X


def cov(m, y=None, rowvar=True, bias=False, ddof=None):
    """``jnp.cov``: rows are variables; centred rows times their
    conjugate transpose over ``N - ddof``, in the inexact dtype."""
    rt = _m()
    X = _cov_rows(m, y, rowvar)
    X = X.astype(inexact(X.dtype))
    if ddof is None:
        ddof = 1 if not bias else 0
    f = X.shape[1] - int(ddof)
    X = X - X.mean(axis=1)[:, None]
    c = rt.matmul(X, rt.conj(X.T)) / f
    return c.squeeze()


def corrcoef(x, y=None, rowvar=True):
    """``jnp.corrcoef``: cov over the outer product of the standard
    deviations, clipped into [-1, 1] (each part for complex values)."""
    rt = _m()
    c = cov(x, y, rowvar)
    if c.ndim == 0:
        return c / c
    d = rt.diag(c)
    std = rt.sqrt(rt.real(d))
    c = c / std[:, None]
    c = c / std[None, :]
    if np.dtype(c.dtype).kind == "c":
        return lazy("complex", rt.clip(rt.real(c), -1, 1),
                    rt.clip(rt.imag(c), -1, 1))
    return rt.clip(c, -1, 1)


def unwrap(p, discont=None, axis=-1, *, period=2 * np.pi):
    """``jnp.unwrap``: the jumps of more than ``discont`` folded into one
    period and their corrections summed along ``axis`` (a cumsum, the scan
    kernel's for floats).  Integers compute in float64, as ramba_tpu's."""
    rt = _m()
    p = asarray(p)
    if np.dtype(p.dtype).kind == "c":
        raise ValueError("jnp.unwrap does not support complex inputs.")
    if np.dtype(p.dtype).kind in "biu":
        p = p.astype(np.float64)
    axis = int(axis) % p.ndim
    discont = period / 2 if discont is None else float(discont)
    interval = period / 2
    dd = diff(p, axis=axis)
    ddmod = rt.mod(dd + interval, period) - interval
    ddmod = rt.where((ddmod == -interval) & (dd > 0), interval, ddmod)
    corr = rt.where(rt.absolute(dd) < discont, 0, ddmod - dd)
    return rt.concatenate([_slice_axis(p, 0, 1, axis),
                           _slice_axis(p, 1, None, axis)
                           + rt.cumsum(corr, axis=axis)], axis=axis)


def _nancum(fname, a, axis):
    """``jnp.nancumsum``/``nancumprod``: NaN (a NaN part) to the identity,
    then ``cumulative``; integers keep their dtype (wrapping), bools give
    int64."""
    rt = _m()
    a = asarray(a)
    dt = np.dtype(a.dtype)
    if dt.kind in "fc":
        a = rt.where(rt.isnan(a), 0 if fname == "cumsum" else 1, a)
    out = getattr(a, fname)(axis=axis)
    return out if dt.kind in "bfc" or out.dtype == dt else out.astype(dt)


def nancumsum(a, axis=None):
    return _nancum("cumsum", a, axis)


def nancumprod(a, axis=None):
    return _nancum("cumprod", a, axis)


def append(arr, values, axis=None):
    rt = _m()
    a, v = asarray(arr), asarray(values)
    if axis is None:
        return rt.concatenate([a.reshape(-1), v.reshape(-1)], axis=0)
    return rt.concatenate([a, v], axis=axis)


def rot90(m, k=1, axes=(0, 1)):
    """numpy.rot90 as flips and a transpose (views)."""
    rt = _m()
    m = asarray(m)
    a0, a1 = (int(a) % m.ndim for a in axes)
    k = int(k) % 4
    if k == 0:
        return m
    if k == 2:
        return rt.flip(rt.flip(m, a0), a1)
    perm = list(range(m.ndim))
    perm[a0], perm[a1] = perm[a1], perm[a0]
    if k == 1:
        return rt.transpose(rt.flip(m, a1), perm)
    return rt.flip(rt.transpose(m, perm), a1)


def fliplr(m):
    return _m().flip(asarray(m), 1)


def flipud(m):
    return _m().flip(asarray(m), 0)


def atleast_3d(*arys):
    outs = []
    for a in arys:
        a = asarray(a)
        if a.ndim == 0:
            a = a.reshape(1, 1, 1)
        elif a.ndim == 1:
            a = a.reshape(1, a.shape[0], 1)
        elif a.ndim == 2:
            a = a.reshape(a.shape + (1,))
        outs.append(a)
    return outs[0] if len(outs) == 1 else outs


def broadcast_arrays(*args):
    rt = _m()
    arrs = [asarray(a) for a in args]
    shape = np.broadcast_shapes(*[a.shape for a in arrs])
    return [rt.broadcast_to(a, shape) for a in arrs]


def vsplit(ary, indices_or_sections):
    if asarray(ary).ndim < 2:
        raise ValueError("vsplit only works on arrays of 2 or more dimensions")
    return _m().split(ary, indices_or_sections, axis=0)


def hsplit(ary, indices_or_sections):
    a = asarray(ary)
    return _m().split(a, indices_or_sections, axis=1 if a.ndim > 1 else 0)


def dsplit(ary, indices_or_sections):
    if asarray(ary).ndim < 3:
        raise ValueError("dsplit only works on arrays of 3 or more dimensions")
    return _m().split(ary, indices_or_sections, axis=2)


def row_stack(tup):
    return _m().vstack(tup)


def block(arrays):
    """numpy.block: the nested lists concatenated from the innermost
    level outward (the last axis first)."""
    rt = _m()

    def depth(x):
        return 1 + depth(x[0]) if isinstance(x, list) else 0

    d = depth(arrays)

    def build(x, level):
        if not isinstance(x, list):
            a = asarray(x)
            return a.reshape((1,) * (d - a.ndim) + a.shape) if a.ndim < d \
                else a
        parts = [build(e, level + 1) for e in x]
        return rt.concatenate(parts, axis=level - d)

    return build(arrays, 0)


def require(a, dtype=None, requirements=None):
    """Layout flags mean nothing for device arrays: only the dtype."""
    a = asarray(a)
    return a.astype(dtype) if dtype is not None else a


def _aval_complex(kw, re, im):
    dt = np.dtype(np.complex128 if re.dtype.itemsize == 8 else np.complex64)
    return Aval(tuple(np.broadcast_shapes(re.shape, im.shape)), dt)


@register_call("complex", _aval_complex)
def _complex(re, im):
    """A complex value from its parts (``lax.complex``)."""
    if re.dtype == torch.float16:
        re, im = re.float(), im.float()
    return torch.complex(*torch.broadcast_tensors(re, im))


def frexp(x):
    """(mantissa, exponent): the exponent is a call (int32), the mantissa
    ``x / 2**e`` (exact in binary floating point)."""
    rt = _m()
    x = asarray(x)
    e = lazy("frexp_exponent", x)
    return x / rt.exp2(e.astype(x.dtype)), e


def _aval_frexp(kw, x):
    if x.dtype.kind == "c":
        raise TypeError("frexp does not accept complex values")
    return Aval(x.shape, np.dtype(np.int32))


@register_call("frexp_exponent", _aval_frexp)
def _frexp_exponent(x):
    return torch.frexp(x.to(E.to_torch_dtype(inexact(E.to_np_dtype(x.dtype)))))[1]


# ---------------------------------------------------------------------------
# calls
# ---------------------------------------------------------------------------


def _search(a, v, right):
    """Positions of ``v`` in the sorted ``a`` in jnp's order (NaN last,
    complex values lexicographic)."""
    if a.is_complex() or v.is_complex():
        tdt = a.dtype if a.is_complex() else v.dtype
        a, v = a.to(tdt), v.to(tdt)
        out = torch.empty(v.shape, dtype=torch.int64, device=v.device)
        flat, res = v.reshape(-1), out.reshape(-1)
        step = max(1, (1 << 24) // max(1, a.numel()))
        cmp = torch.le if right else torch.lt
        for i in range(0, flat.numel(), step):
            c = E.lex_compare(cmp, a[None, :], flat[i:i + step, None])
            res[i:i + step] = c.sum(-1)
        return out
    ka, kv = _rank(a), _rank(v)
    return torch.searchsorted(ka.contiguous(), kv.contiguous(), right=right)


def _rank(t):
    """An integer key of ``t`` in jnp's sort order: floats through their
    bits as int64 (every NaN one NaN, past +inf; -0.0 and 0.0 tie, as
    they compare), the rest through ``sort_key``."""
    if not t.is_floating_point():
        return E.sort_key(t).to(torch.int64)
    d = t.to(torch.float64)
    d = torch.where(torch.isnan(d), torch.full_like(d, float("nan")), d)
    b = d.view(torch.int64)
    return torch.where(b < 0, -(b & 0x7FFFFFFFFFFFFFFF), b)


def _aval_int32_like_v(kw, a, v):
    return Aval(v.shape, np.dtype(np.int32))


@register_call("searchsorted", _aval_int32_like_v)
def _searchsorted(a, v, side="left"):
    return _search(a, v, side == "right")


def searchsorted(a, v, side="left", sorter=None):
    if sorter is not None:
        a = _m().take(asarray(a), sorter)
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    return lazy("searchsorted", a, v, side=side)


def _aval_digitize(kw, x, bins):
    if len(bins.shape) != 1:
        raise ValueError("digitize: bins must be a 1-dimensional array")
    return Aval(x.shape, np.dtype(np.int32))


@register_call("digitize", _aval_digitize)
def _digitize(x, bins, right=False):
    n = bins.shape[0]
    if n == 0:
        return torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    fwd = _search(bins, x, not right)
    back = n - _search(E._unbits(torch.flip(E._bits(bins), [0]), bins.dtype),
                       x, not right)
    inc = E.apply_map("greater_equal", [bins[-1], bins[0]])
    return torch.where(inc, fwd, back)


def digitize(x, bins, right=False):
    return lazy("digitize", x, bins, right=bool(right))


def _aval_isin(kw, e, t):
    return Aval(e.shape, np.dtype(bool))


@register_call("isin", _aval_isin)
def _isin(e, t, invert=False):
    dt = E.to_torch_dtype(E.jnp_promote([E.aval_of(e), E.aval_of(t)]))
    e, t = E.convert(e, dt), E.convert(t, dt).reshape(-1)
    if t.numel() == 0:
        hit = torch.zeros(e.shape, dtype=torch.bool, device=e.device)
    elif e.is_complex():
        hit = torch.zeros(e.numel(), dtype=torch.bool, device=e.device)
        flat = e.reshape(-1)
        step = max(1, (1 << 24) // t.numel())
        for i in range(0, flat.numel(), step):
            hit[i:i + step] = (flat[i:i + step, None] == t[None, :]).any(-1)
        hit = hit.reshape(e.shape)
    else:
        o = torch.sort(_rank(t), stable=True)
        pos = torch.searchsorted(o.values, _rank(e).contiguous())
        pos = pos.clamp(max=t.numel() - 1)
        tb = E._bits(t)[o.indices]  # uint16/32/64 move as signed bits
        hit = tb[pos.reshape(-1)].reshape(e.shape) == E._bits(e)
    return ~hit if invert else hit


def isin(element, test_elements, assume_unique=False, invert=False):
    return lazy("isin", element, test_elements, invert=bool(invert))


def in1d(ar1, ar2, assume_unique=False, invert=False):
    return isin(asarray(ar1).reshape(-1), ar2, invert=invert)


def _aval_interp(kw, x, xp, fp):
    _refuse_complex("interp", x, xp, fp)
    return Aval(x.shape, promote_inexact(x, xp, fp))


@register_call("interp", _aval_interp)
def _interp(x, xp, fp, left=None, right=None):
    """``jnp.interp`` without a period."""
    dt = E.to_torch_dtype(promote_inexact(*[E.aval_of(t) for t in (x, xp, fp)]))
    x, xp, fp = (E.convert(t, dt) for t in (x, xp, fp))
    i = _search(xp, x, True).clamp(1, xp.shape[0] - 1)
    x0, x1 = xp[i - 1], xp[i]
    f0, f1 = fp[i - 1], fp[i]
    df, dx, delta = f1 - f0, x1 - x0, x - x0
    eps = float(np.spacing(np.finfo(E.to_np_dtype(dt)).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, f0, f0 + (delta / torch.where(dx0, torch.ones_like(dx),
                                                       dx)) * df)
    lo = fp[0] if left is None else torch.full((), left, dtype=dt,
                                               device=x.device)
    hi = fp[-1] if right is None else torch.full((), right, dtype=dt,
                                                 device=x.device)
    f = torch.where(x < xp[0], lo, f)
    return torch.where(x > xp[-1], hi, f)


def interp(x, xp, fp, left=None, right=None, period=None):
    if period is not None:
        raise NotImplementedError("interp: period= is not ported")
    kw = {}
    if left is not None:
        kw["left"] = float(left)
    if right is not None:
        kw["right"] = float(right)
    return lazy("interp", x, xp, fp, **kw)


def _aval_conv(kw, a, v):
    if len(a.shape) != 1 or len(v.shape) != 1:
        raise ValueError(f"{kw['op']}() only support 1-dimensional inputs.")
    na, nv = a.shape[0], v.shape[0]
    if na == 0 or nv == 0:
        raise ValueError(f"{kw['op']}: inputs cannot be empty")
    n, m = max(na, nv), min(na, nv)
    size = {"full": n + m - 1, "same": n, "valid": n - m + 1}[kw["mode"]]
    return Aval((size,), promote_inexact(a, v))


@register_call("conv", _aval_conv)
def _conv(a, v, op="convolve", mode="full"):
    """``jnp.convolve``/``correlate`` as one ``conv1d`` (a correlation):
    convolve flips the kernel, correlate conjugates it.  TF32 is off for
    the call (cuDNN would take it for float32 by default)."""
    dt = E.to_torch_dtype(promote_inexact(E.aval_of(a), E.aval_of(v)))
    x, y = E.convert(a, dt), E.convert(v, dt)
    rev = False
    if op == "correlate":
        y = torch.conj_physical(y) if y.is_complex() else y
        if x.shape[0] < y.shape[0]:
            x, y, rev = y, x, True
    else:
        if x.shape[0] < y.shape[0]:
            x, y = y, x
        y = torch.flip(y, [0])
    m = y.shape[0]
    lo, hi = {"valid": (0, 0), "same": (m // 2, m - m // 2 - 1),
              "full": (m - 1, m - 1)}[mode]
    xp = torch.nn.functional.pad(x[None, None, :], (lo, hi))
    flag = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        if dt == torch.float16 and x.device.type == "cpu":
            out = torch.nn.functional.conv1d(xp.float(), y[None, None, :].float())
        else:
            out = torch.nn.functional.conv1d(xp, y[None, None, :])
    finally:
        torch.backends.cudnn.allow_tf32 = flag
    out = out[0, 0].to(dt)
    return torch.flip(out, [0]) if rev else out


def convolve(a, v, mode="full"):
    return lazy("conv", a, v, op="convolve", mode=mode)


def correlate(a, v, mode="valid"):
    return lazy("conv", a, v, op="correlate", mode=mode)


def _aval_kron(kw, a, b):
    _refuse_bool("kron", a, b)
    nd = max(len(a.shape), len(b.shape))
    sa = (1,) * (nd - len(a.shape)) + tuple(a.shape)
    sb = (1,) * (nd - len(b.shape)) + tuple(b.shape)
    return Aval(tuple(x * y for x, y in zip(sa, sb)), E.jnp_promote([a, b]))


@register_call("kron", _aval_kron)
def _kron(a, b):
    dt = E.to_torch_dtype(E.jnp_promote([E.aval_of(a), E.aval_of(b)]))
    a, b = E.convert(a, dt), E.convert(b, dt)
    nd = max(a.ndim, b.ndim)
    a = a.reshape((1,) * (nd - a.ndim) + tuple(a.shape))
    b = b.reshape((1,) * (nd - b.ndim) + tuple(b.shape))
    ae = a.reshape([s for d in a.shape for s in (d, 1)])
    be = b.reshape([s for d in b.shape for s in (1, d)])
    out = E._mul(*torch.broadcast_tensors(ae, be))
    return out.reshape([x * y for x, y in zip(a.shape, b.shape)])


def kron(a, b):
    return lazy("kron", a, b)


def _aval_cross(kw, a, b):
    _refuse_bool("cross", a, b)
    ax = kw["axis"]
    na, nb = a.shape[ax % len(a.shape)], b.shape[ax % len(b.shape)]
    if na not in (2, 3) or nb not in (2, 3):
        raise ValueError("incompatible dimensions for cross product "
                         "(dimension must be 2 or 3)")
    sa = tuple(np.delete(a.shape, ax % len(a.shape)))
    sb = tuple(np.delete(b.shape, ax % len(b.shape)))
    batch = tuple(np.broadcast_shapes(sa, sb))
    shape = batch if na == 2 and nb == 2 else batch + (3,)
    return Aval(shape, E.jnp_promote([a, b]))


@register_call("cross", _aval_cross)
def _cross(a, b, axis=-1):
    dt = E.to_torch_dtype(E.jnp_promote([E.aval_of(a), E.aval_of(b)]))
    a = torch.movedim(E.convert(a, dt), axis, -1)
    b = torch.movedim(E.convert(b, dt), axis, -1)

    def comp(t, i):
        return t[..., i] if i < t.shape[-1] else torch.zeros_like(t[..., 0])

    def det2(p, q, r, s):  # p*q - r*s in the dtype (wrapping integers)
        return E.apply_map("subtract", [E.apply_map("multiply", [p, q]),
                                        E.apply_map("multiply", [r, s])])

    a0, a1, a2 = (comp(a, i) for i in range(3))
    b0, b1, b2 = (comp(b, i) for i in range(3))
    a0, a1, a2, b0, b1, b2 = torch.broadcast_tensors(a0, a1, a2, b0, b1, b2)
    z = det2(a0, b1, a1, b0)
    if a.shape[-1] == 2 and b.shape[-1] == 2:
        return z
    return torch.stack([det2(a1, b2, a2, b1), det2(a2, b0, a0, b2), z],
                       dim=-1)


def cross(a, b, axis=-1):
    return lazy("cross", a, b, axis=int(axis))


def _aval_gradient(kw, f):
    if f.shape[kw["axis"]] < 2:
        raise ValueError("Shape of array too small to calculate a numerical "
                         "gradient, at least 2 elements are required.")
    return Aval(f.shape, inexact(f.dtype))


@register_call("gradient", _aval_gradient)
def _gradient(f, axis=0):
    """``jnp.gradient`` along one axis, unit spacing: one-sided
    differences at the edges, ``(f[2:] - f[:-2]) * 0.5`` inside."""
    a = E.convert(f, E.to_torch_dtype(inexact(E.to_np_dtype(f.dtype))))
    n = a.shape[axis]
    upper = a.narrow(axis, 1, 1) - a.narrow(axis, 0, 1)
    lower = a.narrow(axis, n - 1, 1) - a.narrow(axis, n - 2, 1)
    inner = (a.narrow(axis, 2, n - 2) - a.narrow(axis, 0, n - 2)) * 0.5
    return torch.cat([upper, inner, lower], dim=axis)


def gradient(f, *varargs, axis=None):
    if varargs or axis is not None:
        # spacings or an axis selection: NumPy's own, on the host (as the
        # reference does)
        out = np.gradient(_host(f), *[_host(v) for v in varargs],
                          **({"axis": axis} if axis is not None else {}))
        if isinstance(out, (list, tuple)):
            return [fromarray(o) for o in out]
        return fromarray(out)
    f = asarray(f)
    outs = [lazy("gradient", f, axis=i) for i in range(f.ndim)]
    return outs[0] if f.ndim == 1 else outs


def _aval_take_along(kw, a, idx):
    ax = kw["axis"]
    if len(a.shape) != len(idx.shape):
        raise ValueError("indices and arr must have the same number of "
                         "dimensions")
    shape = tuple(np.broadcast_shapes(
        tuple(s for d, s in enumerate(a.shape) if d != ax),
        tuple(s for d, s in enumerate(idx.shape) if d != ax)))
    shape = shape[:ax] + (idx.shape[ax],) + shape[ax:]
    return Aval(shape, a.dtype)


@register_call("take_along_axis", _aval_take_along)
def _take_along_axis(a, idx, axis=0):
    """``jnp.take_along_axis`` (its ``fill`` mode): negative indices from
    the end, still out of range gives the fill value."""
    shape = _aval_take_along({"axis": axis}, E.aval_of(a),
                             E.aval_of(idx)).shape
    n = a.shape[axis]
    i = idx.to(torch.int64)
    i = torch.where(i < 0, i + n, i)
    bad = (i < 0) | (i >= n)
    i = torch.where(bad, torch.zeros_like(i), i)
    full = [s if d != axis else a.shape[axis] for d, s in enumerate(shape)]
    src = E._bits(a).expand(full)
    out = torch.gather(src, axis, i.expand(shape))
    fill = torch.full((), E._fill_value(a.dtype), dtype=out.dtype,
                      device=a.device)
    return E._unbits(torch.where(bad.expand(shape), fill, out), a.dtype)


def take_along_axis(arr, indices, axis):
    if axis is None:
        return lazy("take_along_axis", asarray(arr).reshape(-1), indices,
                    axis=0)
    arr = asarray(arr)
    return lazy("take_along_axis", arr, indices, axis=int(axis) % arr.ndim)


def _aval_diagonal(kw, a):
    off, a1, a2 = kw["offset"], kw["axis1"], kw["axis2"]
    nd = len(a.shape)
    a1, a2 = a1 % nd, a2 % nd
    r, c = a.shape[a1], a.shape[a2]
    n = max(0, min(r + min(off, 0), c - max(off, 0)))
    rest = tuple(s for d, s in enumerate(a.shape) if d not in (a1, a2))
    return Aval(rest + (n,), a.dtype)


@register_call("diagonal", _aval_diagonal)
def _diagonal(a, offset=0, axis1=0, axis2=1):
    return E._unbits(torch.diagonal(E._bits(a), offset, axis1, axis2).clone(),
                     a.dtype)


def diagonal(a, offset=0, axis1=0, axis2=1):
    return lazy("diagonal", a, offset=int(offset), axis1=int(axis1),
                axis2=int(axis2))


def _aval_lexsort(kw, *keys):
    return Aval(tuple(np.broadcast_shapes(*[k.shape for k in keys])),
                np.dtype(np.int64))


@register_call("lexsort", _aval_lexsort)
def _lexsort(*keys, axis=-1):
    """Stable sorts by each key, the last key primary."""
    keys = torch.broadcast_tensors(*keys)
    ax = axis % keys[0].ndim
    order = None
    for k in keys:
        kk = k if order is None else \
            E._unbits(torch.gather(E._bits(k), ax, order), k.dtype)
        o = E.sort_order(kk, ax)
        order = o if order is None else torch.gather(order, ax, o)
    return order


def lexsort(keys, axis=-1):
    if not isinstance(keys, (list, tuple)):
        k = asarray(keys)
        keys = [k[i] for i in range(k.shape[0])]
    return lazy("lexsort", *[asarray(k) for k in keys], axis=int(axis))


def sort_complex(a):
    """``jnp.sort_complex``: sort, then the complex dtype."""
    a = _m().sort(asarray(a))
    return a.astype(to_complex(a.dtype))


def _aval_partition(kw, a):
    _refuse_bool("partition", a)
    return Aval(a.shape, a.dtype)


@register_call("partition", _aval_partition)
def _partition(a, kth=0, axis=-1):
    """``jnp.partition``: the ``kth + 1`` smallest ascending, then the
    rest in descending order (two top-k's)."""
    x = torch.movedim(a, axis, -1)
    n = x.shape[-1]
    order = E.sort_order(x, x.ndim - 1)
    s = torch.gather(E._bits(x), -1, order)
    out = torch.cat([s[..., :kth + 1], torch.flip(s[..., kth + 1:], [-1])],
                    dim=-1) if n else s
    return E._unbits(torch.movedim(out, -1, axis), x.dtype)


def _aval_argpartition(kw, a):
    _refuse_bool("argpartition", a)
    return Aval(a.shape, np.dtype(np.int32))


@register_call("argpartition", _aval_argpartition)
def _argpartition(a, kth=0, axis=-1):
    """``jnp.argpartition``: the indices of the ``kth + 1`` smallest by
    value, then the other indices in ascending order."""
    x = torch.movedim(a, axis, -1)
    n = x.shape[-1]
    order = E.sort_order(x, x.ndim - 1)
    bottom = order[..., :kth + 1]
    rest = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    rest.scatter_(-1, bottom, False)
    iota = torch.arange(n, device=x.device).expand(x.shape)
    top = torch.sort(torch.where(rest, iota, n), dim=-1).values[..., :n - kth - 1]
    return torch.movedim(torch.cat([bottom, top], dim=-1), -1, axis)


def partition(a, kth, axis=-1):
    try:
        k = operator.index(kth)
    except TypeError:  # a sequence of kth: NumPy's, on the host
        return np.partition(_host(a), kth, axis=axis)
    a = asarray(a)
    if np.dtype(a.dtype).kind == "c":  # as ramba_tpu: jnp refuses these
        return np.partition(_host(a), kth, axis=axis)
    if axis is None:
        return lazy("partition", a.reshape(-1), kth=k, axis=-1)
    return lazy("partition", a, kth=k, axis=int(axis))


def argpartition(a, kth, axis=-1):
    try:
        k = operator.index(kth)
    except TypeError:
        return np.argpartition(_host(a), kth, axis=axis)
    a = asarray(a)
    if np.dtype(a.dtype).kind == "c":
        return np.argpartition(_host(a), kth, axis=axis)
    if axis is None:
        return lazy("argpartition", a.reshape(-1), kth=k, axis=-1)
    return lazy("argpartition", a, kth=k, axis=int(axis))


def _aval_bincount(kw, x, *w):
    if x.dtype.kind not in "biu":
        raise TypeError("bincount: x must be of integer type")
    if w:
        _refuse_bool("bincount weights", w[0])
    return Aval((kw["length"],), w[0].dtype if w else np.dtype(np.int64))


@register_call("bincount", _aval_bincount)
def _bincount(x, *w, length=0):
    """Counts per label; weighted sums in a fixed order: a stable sort by
    label, then one sequential sum per label (``torch.segment_reduce``),
    so reruns give the same bytes (``index_add_`` adds with atomics on the
    card)."""
    x = x.reshape(-1).to(torch.int64).clamp(0, max(length - 1, 0))
    if not w:
        return torch.bincount(x, minlength=length)[:length]
    wt = w[0].reshape(-1)
    if not (wt.is_floating_point() or wt.is_complex()):
        # integer sums are exact in any order (modulo 2**64, then wrapped
        # to the weights' width as jnp's sum in that dtype)
        c = E._to_carrier(wt) if E._is_wide_unsigned(wt.dtype) \
            else wt.to(torch.int64)
        s = torch.zeros(length, dtype=torch.int64, device=wt.device)
        s.index_add_(0, x, c)
        return E._from_carrier(s, wt.dtype) if E._is_wide_unsigned(wt.dtype) \
            else s.to(wt.dtype)
    order = torch.sort(x, stable=True).indices
    counts = torch.bincount(x, minlength=length)[:length]
    vals = wt[order]
    if vals.dtype == torch.float16:
        vals = vals.float()  # summed in float32, rounded once
    if vals.is_complex():
        parts = [torch.segment_reduce(p, "sum", lengths=counts, unsafe=True)
                 for p in (vals.real, vals.imag)]
        out = torch.complex(*parts)
    else:
        out = torch.segment_reduce(vals, "sum", lengths=counts, unsafe=True)
    return out.to(wt.dtype)


def bincount(x, weights=None, minlength=0):
    # the length depends on max(x): one scalar read from the card, as in
    # ramba_tpu; the count itself stays on the card
    xa = asarray(x)
    if xa.size and int(xa.min()) < 0:
        raise ValueError("'x' argument must not be negative")
    n = int(xa.max()) + 1 if xa.size else 0
    length = max(n, int(minlength))
    if weights is None:
        return lazy("bincount", xa, length=length)
    return lazy("bincount", xa, weights, length=length)


def _aval_quantile(kw, a, q):
    if a.dtype.kind == "c":
        raise ValueError("quantile does not support complex input, as the "
                         "operation is poorly defined.")
    if len(q.shape) > 1:
        raise ValueError(f"q must be have rank <= 1, got shape {q.shape}")
    axis, keepdims = kw.get("axis"), kw["keepdims"]
    if axis is None:
        red = (1,) * len(a.shape) if keepdims else ()
    else:
        red = E._reduced_shape(a.shape, axis % len(a.shape), keepdims)
    return Aval(tuple(q.shape) + tuple(red), inexact(a.dtype))


QUANTILE_METHODS = ("linear", "lower", "higher", "midpoint", "nearest")


def quantile_positions(qb, n, top, percent, static_count):
    """``(low, high, lw, hw)`` of a quantile: the positions of the two
    values it reads in a sorted slice of ``n`` (``top``: the last valid
    position, in q's dtype: ``n - 1``, or a nan kind's count less one)
    and their weights, for ``qb`` (q broadcast against ``top``).

    ``percent``: q is in percent.  ramba_tpu divides by 100 under XLA,
    which turns ``q / 100 * (n - 1)`` into ``q * ((n - 1) / 100)`` where
    the count is static (``static_count``: a plain kind, or a dtype with
    no NaN, whose count XLA knows) and into ``(q * 0.01) * (count - 1)``
    where it is not; the position is formed the same way, so it rounds
    the same."""
    if percent and static_count:
        qq = qb * ((n - 1) / 100)
    elif percent:
        qq = (qb * (1 / 100)) * top
    else:
        qq = qb * top
    low, high = torch.floor(qq), torch.ceil(qq)
    hw = qq - low
    lw = 1 - hw
    zero = torch.zeros((), dtype=qb.dtype, device=qb.device)
    low = torch.maximum(zero, torch.minimum(low, top)).to(torch.int64)
    high = torch.maximum(zero, torch.minimum(high, top)).to(torch.int64)
    return low, high, lw, hw


def quantile_finish(lv, hv, lw, hw, method, out_dt):
    """A quantile from the values at its two positions: ``method``'s
    interpolation in q's dtype (the weights'), cast to ``out_dt``."""
    qd = lw.dtype
    if method == "linear":
        r = lv.to(qd) * lw + hv.to(qd) * hw
    elif method == "lower":
        r = lv
    elif method == "higher":
        r = hv
    elif method == "nearest":
        r = torch.where(hw <= 0.5, lv, hv)
    else:
        r = (lv + hv) * 0.5
    return r.to(out_dt)


def quantile_shape(qshape, shape, axis, keepdims, r):
    """The quantile's result ``r`` (``qshape + kept dims``) with the
    reduced dims kept as 1 where ``keepdims``."""
    if not keepdims:
        return r
    if axis is None:
        return r.reshape(tuple(qshape) + (1,) * len(shape))
    return r.unsqueeze(len(qshape) + axis % len(shape))


@register_call("quantile", _aval_quantile)
def _quantile(a, q, axis=None, keepdims=False, method="linear", nan=False,
              percent=False):
    """``jnp.quantile``/``nanquantile`` on the port's sort (torch.quantile
    refuses more than 2**24 elements): the positions
    (:func:`quantile_positions`) and the interpolation
    (:func:`quantile_finish`) are computed in q's dtype and cast to the
    inexact dtype of ``a`` at the end."""
    if method not in QUANTILE_METHODS:
        raise ValueError("method can only be 'linear', 'lower', 'higher', "
                         "'midpoint', or 'nearest'")
    out_dt = E.to_torch_dtype(inexact(E.to_np_dtype(a.dtype)))
    x = E.convert(a, out_dt)
    if axis is None:
        x, ax = x.reshape(-1), 0
    else:
        ax = axis % x.ndim
    x = torch.movedim(x, ax, -1)
    qd = q.dtype
    if x.shape[-1] == 0:  # nanquantile of nothing: NaN, as NumPy
        r = torch.full(tuple(q.shape) + tuple(x.shape[:-1]), float("nan"),
                       dtype=out_dt, device=x.device)
        return quantile_shape(q.shape, a.shape, axis, keepdims, r)
    qb = q.reshape(q.shape + (1,) * x.ndim)
    n = float(x.shape[-1])
    static_count = not nan or not a.is_floating_point()
    x = E.order_values(x, nan)
    if nan:
        top = (~torch.isnan(x)).sum(-1, keepdim=True).to(qd) - 1
    else:
        top = torch.full((), n - 1, dtype=qd, device=x.device)
    low, high, lw, hw = quantile_positions(qb, n, top, percent,
                                           static_count)
    s = E.sorted_values(x)
    sx = s.expand(q.shape + tuple(s.shape))
    lv = torch.gather(sx, -1, low.expand(q.shape + tuple(s.shape[:-1]) + (1,)))
    hv = torch.gather(sx, -1, high.expand(q.shape + tuple(s.shape[:-1]) + (1,)))
    r = quantile_finish(lv, hv, lw, hw, method, out_dt)[..., 0]
    return quantile_shape(q.shape, a.shape, axis, keepdims, r)


def _q_arg(q):
    """q as a constant every rank holds whole (on a mesh of ranks the
    quantile's selection reads it on every rank)."""
    return E.Const(E.tensor_from_numpy(np.asarray(q, dtype=float)))


def _quantile_call(a, q, axis, keepdims, method, nan, percent=False):
    kw = {"keepdims": bool(keepdims), "method": str(method), "nan": nan,
          "percent": percent}
    a = asarray(a)
    if not nan and a.ndim and E.reduces_nothing(
            a.shape, None if axis is None else int(axis) % a.ndim):
        # NumPy's error at the call: the last of nothing
        raise IndexError("index -1 is out of bounds for axis 0 with size 0")
    if axis is not None:
        kw["axis"] = int(axis)
    return lazy("quantile", a, q, **kw)


def quantile(a, q, axis=None, keepdims=False, *, method="linear"):
    return _quantile_call(a, _q_arg(q), axis, keepdims, method, False)


def percentile(a, q, axis=None, keepdims=False, *, method="linear"):
    return _quantile_call(a, _q_arg(q), axis, keepdims, method, False, True)


def nanquantile(a, q, axis=None, keepdims=False, *, method="linear"):
    return _quantile_call(a, _q_arg(q), axis, keepdims, method, True)


def nanpercentile(a, q, axis=None, keepdims=False, *, method="linear"):
    return _quantile_call(a, _q_arg(q), axis, keepdims, method, True, True)


# ---------------------------------------------------------------------------
# in-place writers: a new value, assigned through the setitem machinery
# ---------------------------------------------------------------------------


def _storage(values, dtype):
    return asarray(values).astype(dtype)


def copyto(dst, src, casting="same_kind", where=True):
    """numpy.copyto onto a port array: one select written through
    ``dst[...]`` (a view's base changes too)."""
    if not isinstance(dst, ndarray):
        return np.copyto(dst, _host(src), casting=casting,
                         where=where if isinstance(where, bool) else _host(where))
    if isinstance(src, (bool, int, float, complex)) and \
            not isinstance(src, np.generic):
        # python scalars are weak (NEP 50): NumPy's value-aware check
        np.copyto(np.empty((), dtype=dst.dtype), src, casting=casting)
        s = asarray(src)
    else:
        s = asarray(src)
        if not np.can_cast(s.dtype, dst.dtype, casting=casting):
            raise TypeError(f"Cannot cast array data from {s.dtype} to "
                            f"{dst.dtype} according to the rule '{casting}'")
    s = s.astype(dst.dtype).broadcast_to(dst.shape)
    if where is True:
        dst[...] = s
        return None
    dst[...] = _m().where(asarray(where), s, dst)


def _aval_first(kw, a, *rest):
    return Aval(a.shape, a.dtype)


@register_call("fill_diagonal", _aval_first)
def _fill_diagonal(a, val, wrap=False):
    """numpy.fill_diagonal's new value: the diagonal of the leading
    square (numpy's wrapped diagonal ``a.flat[::ncols + 1]`` for a tall
    2-D ``a`` with ``wrap``), ``val`` cycled over it."""
    flat = E._bits(a).reshape(-1).clone()
    if a.ndim == 2 and wrap:
        step = a.shape[1] + 1
        pos = torch.arange(0, a.numel(), step, device=a.device)
    else:
        n = min(a.shape)
        stride = sum(int(np.prod(a.shape[d + 1:], dtype=np.int64))
                     for d in range(a.ndim))
        pos = torch.arange(n, device=a.device) * stride
    v = E._bits(val.to(a.dtype)).reshape(-1)
    fills = v[torch.arange(pos.numel(), device=a.device) % max(v.numel(), 1)]
    flat[pos] = fills
    return E._unbits(flat.reshape(a.shape), a.dtype)


def fill_diagonal(a, val, wrap=False):
    if not isinstance(a, ndarray):
        return np.fill_diagonal(a, _host(val), wrap=wrap)
    if a.ndim < 2:
        raise ValueError("array must be at least 2-d")
    if a.ndim > 2 and any(s != a.shape[0] for s in a.shape[1:]):
        raise ValueError("All dimensions of input must be of equal length")
    a[...] = lazy("fill_diagonal", a, _storage(val, a.dtype),
                  wrap=bool(wrap and a.ndim == 2 and a.shape[0] > a.shape[1]))


@register_call("putmask", _aval_first)
def _putmask(a, mask, values):
    """numpy.putmask cycles ``values`` over the flat positions of ``a``."""
    v = E._bits(values.to(a.dtype)).reshape(-1)
    cyc = v[torch.arange(a.numel(), device=a.device) % v.numel()]
    out = torch.where(mask.reshape(a.shape).to(torch.bool),
                      cyc.reshape(a.shape), E._bits(a))
    return E._unbits(out, a.dtype)


@register_call("place", _aval_first)
def _place(a, mask, vals):
    """numpy.place cycles ``vals`` over the True positions, in order."""
    m = mask.reshape(-1).to(torch.bool)
    k = torch.cumsum(m.to(torch.int64), 0) - 1
    v = E._bits(vals.to(a.dtype)).reshape(-1)
    picked = v[torch.remainder(k.clamp(min=0), v.numel())]
    out = torch.where(m, picked, E._bits(a).reshape(-1))
    return E._unbits(out.reshape(a.shape), a.dtype)


def _size_of(x) -> int:
    if isinstance(x, ndarray):
        return x.size
    return np.asarray(x).size


def _host_masked_write(np_fn, a, mask, values):
    """NumPy's own semantics and errors where the target is not a port
    array or ``values`` is empty."""
    buf = _host(a).copy() if isinstance(a, ndarray) else a
    np_fn(buf, _host(mask), np.asarray(_host(values)).astype(buf.dtype,
                                                             copy=False))
    if isinstance(a, ndarray):
        a[...] = buf


def putmask(a, mask, values):
    if not isinstance(a, ndarray) or _size_of(values) == 0:
        return _host_masked_write(np.putmask, a, mask, values)
    a[...] = lazy("putmask", a, asarray(mask), _storage(values, a.dtype))


def place(arr, mask, vals):
    if not isinstance(arr, ndarray) or _size_of(vals) == 0:
        return _host_masked_write(np.place, arr, mask, vals)
    arr[...] = lazy("place", arr, asarray(mask), _storage(vals, arr.dtype))


@register_call("put_along_axis", _aval_first)
def _put_along_axis(a, idx, values, axis=0):
    """``jnp.put_along_axis``: ``values`` (broadcast to the indices'
    shape) scattered along ``axis``; negative indices from the end."""
    n = a.shape[axis]
    i = idx.to(torch.int64)
    i = torch.where(i < 0, i + n, i)
    shape = list(np.broadcast_shapes(tuple(a.shape[:axis]) + (1,) +
                                     tuple(a.shape[axis + 1:]),
                                     tuple(i.shape)))
    shape[axis] = i.shape[axis]
    i = i.expand(shape)
    v = E._bits(values.to(a.dtype)).expand(shape)
    out = E._bits(a).clone()
    out.scatter_(axis, i, v.contiguous())
    return E._unbits(out, a.dtype)


def put_along_axis(arr, indices, values, axis):
    if not isinstance(arr, ndarray):
        return np.put_along_axis(arr, _host(indices), _host(values), axis)
    vals = _storage(values, arr.dtype)
    if axis is None:
        flat = lazy("put_along_axis", arr.reshape(-1), indices, vals, axis=0)
        arr[...] = flat.reshape(arr.shape)
        return None
    arr[...] = lazy("put_along_axis", arr, indices, vals,
                    axis=int(axis) % arr.ndim)


# ---------------------------------------------------------------------------
# host boundaries (data-dependent shapes, as in ramba_tpu): each copies its
# array operands to the host and returns NumPy's result
# ---------------------------------------------------------------------------


def unique(ar, return_index=False, return_inverse=False, return_counts=False):
    return np.unique(_host(ar), return_index=return_index,
                     return_inverse=return_inverse,
                     return_counts=return_counts)


def nonzero(a):
    return np.nonzero(_host(a))


def flatnonzero(a):
    return np.flatnonzero(_host(a))


def argwhere(a):
    return np.argwhere(_host(a))


def extract(condition, arr):
    return np.extract(_host(condition), _host(arr))


def compress(condition, a, axis=None):
    return np.compress(_host(condition), _host(a), axis=axis)


def setdiff1d(ar1, ar2):
    return np.setdiff1d(_host(ar1), _host(ar2))


def union1d(ar1, ar2):
    return np.union1d(_host(ar1), _host(ar2))


def intersect1d(ar1, ar2):
    return np.intersect1d(_host(ar1), _host(ar2))


def setxor1d(ar1, ar2):
    return np.setxor1d(_host(ar1), _host(ar2))


def insert(arr, obj, values, axis=None):
    return np.insert(_host(arr), obj, _host(values), axis=axis)


def delete(arr, obj, axis=None):
    return np.delete(_host(arr), obj, axis=axis)


def histogram(a, bins=10, range=None, density=None, weights=None):
    w = _host(weights) if weights is not None else None
    return np.histogram(_host(a), bins=bins, range=range, weights=w,
                        density=density)


def histogram2d(x, y, bins=10, range=None, density=None, weights=None):
    w = _host(weights) if weights is not None else None
    return np.histogram2d(_host(x), _host(y), bins=bins, range=range,
                          weights=w, density=density)


def packbits(a, axis=None, bitorder="big"):
    return np.packbits(_host(a), axis=axis, bitorder=bitorder)


def unpackbits(a, axis=None, count=None, bitorder="big"):
    return np.unpackbits(_host(a), axis=axis, count=count, bitorder=bitorder)


def array_equiv(a1, a2):
    return bool(np.array_equiv(_host(a1), _host(a2)))


def trim_zeros(filt, trim="fb"):
    return np.trim_zeros(_host(filt), trim=trim)


def resize(a, new_shape):
    return fromarray(np.resize(_host(a), new_shape))


def poly(seq_of_zeros):
    return np.poly(_host(seq_of_zeros))


def polyfit(x, y, deg, **kw):
    return np.polyfit(_host(x), _host(y), deg, **kw)


def roots(p):
    return np.roots(_host(p))


def real_if_close(a, tol=100):
    # the result's dtype depends on the data
    return fromarray(np.real_if_close(_host(a), tol=tol))


def piecewise(x, condlist, funclist, *args, **kw):
    return np.piecewise(_host(x), [_host(c) for c in condlist], funclist,
                        *args, **kw)


def apply_along_axis(func1d, axis, arr, *args, **kwargs):
    return np.apply_along_axis(func1d, axis, _host(arr), *args, **kwargs)


def apply_over_axes(func, a, axes):
    return np.apply_over_axes(func, _host(a), axes)


def unravel_index(indices, shape):
    return np.unravel_index(_host(indices), shape)


def ravel_multi_index(multi_index, dims, mode="raise", order="C"):
    return np.ravel_multi_index(tuple(_host(i) for i in multi_index), dims,
                                mode=mode, order=order)


# host index helpers: shape arithmetic, NumPy's own
tril_indices = np.tril_indices
triu_indices = np.triu_indices
tril_indices_from = np.tril_indices_from
triu_indices_from = np.triu_indices_from
diag_indices = np.diag_indices
ix_ = np.ix_


# window generators: host-computed constants, uploaded


def bartlett(M):
    return fromarray(np.bartlett(M))


def blackman(M):
    return fromarray(np.blackman(M))


def hamming(M):
    return fromarray(np.hamming(M))


def hanning(M):
    return fromarray(np.hanning(M))


def kaiser(M, beta):
    return fromarray(np.kaiser(M, beta))


# the NumPy names ramba_tpu re-exports from here that the port keeps in
# ops/reductions.py
from ramba_tpu_torch.ops.reductions import nanmedian  # noqa: E402,F401


# -- creation calls (``ops/creation.py``) ----------------------------------------


def _aval_eye(kw):
    return Aval((kw["n"], kw["m"]), np.dtype(kw["dtype"]))


def _cdev():
    from ramba_tpu_torch import common

    return common.device()


@register_call("eye", _aval_eye)
def _eye(n, m, k, dtype):
    i = torch.arange(n, device=_cdev())[:, None]
    j = torch.arange(m, device=_cdev())[None, :]
    return (j - i == k).to(E.to_torch_dtype(dtype))


@register_call("tri", _aval_eye)
def _tri(n, m, k, dtype):
    i = torch.arange(n, device=_cdev())[:, None]
    j = torch.arange(m, device=_cdev())[None, :]
    return (j - i <= k).to(E.to_torch_dtype(dtype))


def _aval_indices(kw):
    shape = tuple(kw["shape"])
    return Aval((len(shape),) + shape, np.dtype(kw["dtype"]))


@register_call("indices", _aval_indices)
def _indices(shape, dtype):
    tdt = E.to_torch_dtype(dtype)
    axes = [torch.arange(s, device=_cdev()).to(tdt) for s in shape]
    if not axes:
        return torch.zeros((0,), dtype=tdt, device=_cdev())
    return torch.stack(torch.meshgrid(*axes, indexing="ij"))
