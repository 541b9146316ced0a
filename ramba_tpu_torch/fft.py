"""``ramba_tpu_torch.fft`` — the numpy.fft namespace.

Counterpart of ``ramba_tpu/fft.py``.  Every transform is one ``call`` node
(``ops/extras.py``) on ``torch.fft`` (cuFFT on the card).  Result dtypes
follow ``ramba_tpu``, not torch: integers and bools are cast by jnp's
inexact rule before the transform (``fft`` of int32 gives complex64,
``rfft`` of float32 complex64, float16 computes in float32), and
``irfft``/``hfft`` give the real dtype of that width.  ``norm=`` takes
``"backward"``, ``"ortho"`` and ``"forward"``.  ``fftfreq``/``rfftfreq``
are built on the host, as in the reference; ``fftshift``/``ifftshift``
are rolls on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ramba_tpu_torch.core import expr as E
from ramba_tpu_torch.core.expr import Aval
from ramba_tpu_torch.ops.creation import asarray, fromarray
from ramba_tpu_torch.ops.extras import (
    _axis_arg, lazy, register_call, to_complex,
)

# name -> kind: "c" complex to complex, "rc" real to complex, "cr" complex
# to real
_ONE_D = {"fft": "c", "ifft": "c", "rfft": "rc", "irfft": "cr",
          "hfft": "cr", "ihfft": "rc"}
_N_D = {"fft2": "c", "ifft2": "c", "rfft2": "rc", "irfft2": "cr",
        "fftn": "c", "ifftn": "c", "rfftn": "rc", "irfftn": "cr"}
_NORMS = (None, "backward", "ortho", "forward")


def _real_of(dt) -> np.dtype:
    c = to_complex(dt)
    return np.dtype(np.float64 if c.itemsize == 16 else np.float32)


def _dtypes(kind, dt):
    """(compute dtype of the input, output dtype)."""
    if kind == "rc":
        # jnp's refusals: complex input, and float16 (XLA's RFFT takes
        # float32 and float64 only)
        if np.dtype(dt).kind == "c":
            raise ValueError("only real valued inputs supported for rfft")
        if np.dtype(dt) == np.float16:
            raise ValueError("RFFT input must be float32 or float64, got "
                             "float16")
        return _real_of(dt), to_complex(dt)
    if kind == "cr":
        return to_complex(dt), _real_of(dt)
    return to_complex(dt), to_complex(dt)


def _out_len(kind, n_in, n):
    if kind == "rc":
        return (n if n is not None else n_in) // 2 + 1
    if kind == "cr":
        return n if n is not None else 2 * (n_in - 1)
    return n if n is not None else n_in


def _aval_fft(kw, x):
    name = kw["name"]
    nd = len(x.shape)
    kind = _ONE_D.get(name) or _N_D[name]
    _cdt, out = _dtypes(kind, x.dtype)
    shape = list(x.shape)
    if name in _ONE_D:
        ax = kw.get("axis", -1) % nd
        shape[ax] = _out_len(kind, x.shape[ax], kw.get("n"))
        return Aval(tuple(shape), out)
    axes, s = _nd_axes(kw, nd)
    for i, ax in enumerate(axes):
        last = i == len(axes) - 1
        n = None if s is None else s[i]
        if last:
            shape[ax] = _out_len(kind, x.shape[ax], n)
        elif n is not None:
            shape[ax] = n
    return Aval(tuple(shape), out)


def _nd_axes(kw, nd):
    s, axes = kw.get("s"), kw.get("axes")
    if axes is None:
        axes = tuple(range(nd - len(s), nd)) if s is not None \
            else tuple(range(nd))
    return tuple(a % nd for a in axes), s


@register_call("fft", _aval_fft)
def _fft(x, name, **kw):
    kind = _ONE_D.get(name) or _N_D[name]
    cdt, _out = _dtypes(kind, E.to_np_dtype(x.dtype))
    x = E.convert(x, E.to_torch_dtype(cdt))
    norm = kw.get("norm") or "backward"
    fn = getattr(torch.fft, name)
    if name in _ONE_D:
        out = fn(x, n=kw.get("n"), dim=kw.get("axis", -1), norm=norm)
    else:
        axes, s = _nd_axes(kw, x.ndim)
        out = fn(x, s=s, dim=axes, norm=norm)
    return out.resolve_conj()  # ihfft returns a lazily conjugated view


def _check_norm(norm):
    if norm not in _NORMS:
        raise ValueError(f'Invalid norm value {norm}; should be "backward", '
                         '"ortho" or "forward".')


def _fft1(name, a, n=None, axis=-1, norm=None):
    _check_norm(norm)
    kw = {"name": name, "axis": int(axis)}
    if n is not None:
        kw["n"] = int(n)
    if norm is not None:
        kw["norm"] = norm
    return lazy("fft", a, **kw)


def fft(a, n=None, axis=-1, norm=None):
    return _fft1("fft", a, n, axis, norm)


def ifft(a, n=None, axis=-1, norm=None):
    return _fft1("ifft", a, n, axis, norm)


def rfft(a, n=None, axis=-1, norm=None):
    return _fft1("rfft", a, n, axis, norm)


def irfft(a, n=None, axis=-1, norm=None):
    return _fft1("irfft", a, n, axis, norm)


def hfft(a, n=None, axis=-1, norm=None):
    return _fft1("hfft", a, n, axis, norm)


def ihfft(a, n=None, axis=-1, norm=None):
    return _fft1("ihfft", a, n, axis, norm)


def _fftn(name, a, s=None, axes=None, norm=None):
    _check_norm(norm)
    kw = {"name": name}
    if s is not None:
        kw["s"] = tuple(int(x) for x in s)
    if axes is not None:
        kw["axes"] = tuple(int(x) for x in axes)
    if norm is not None:
        kw["norm"] = norm
    return lazy("fft", a, **kw)


def fft2(a, s=None, axes=(-2, -1), norm=None):
    return _fftn("fft2", a, s, axes, norm)


def ifft2(a, s=None, axes=(-2, -1), norm=None):
    return _fftn("ifft2", a, s, axes, norm)


def rfft2(a, s=None, axes=(-2, -1), norm=None):
    return _fftn("rfft2", a, s, axes, norm)


def irfft2(a, s=None, axes=(-2, -1), norm=None):
    return _fftn("irfft2", a, s, axes, norm)


def fftn(a, s=None, axes=None, norm=None):
    return _fftn("fftn", a, s, axes, norm)


def ifftn(a, s=None, axes=None, norm=None):
    return _fftn("ifftn", a, s, axes, norm)


def rfftn(a, s=None, axes=None, norm=None):
    return _fftn("rfftn", a, s, axes, norm)


def irfftn(a, s=None, axes=None, norm=None):
    return _fftn("irfftn", a, s, axes, norm)


def _aval_shift(kw, x):
    return Aval(x.shape, x.dtype)


@register_call("fftshift", _aval_shift)
def _shift(x, inverse=False, axes=None):
    dims = tuple(range(x.ndim)) if axes is None else \
        ((axes,) if isinstance(axes, int) else tuple(axes))
    fn = torch.fft.ifftshift if inverse else torch.fft.fftshift
    return E._unbits(fn(E._bits(x), dim=dims), x.dtype)


def fftshift(x, axes=None):
    kw = {} if axes is None else {"axes": _axis_arg(axes)}
    return lazy("fftshift", asarray(x), **kw)


def ifftshift(x, axes=None):
    kw = {} if axes is None else {"axes": _axis_arg(axes)}
    return lazy("fftshift", asarray(x), inverse=True, **kw)


def fftfreq(n, d=1.0):
    return fromarray(np.fft.fftfreq(int(n), d=float(d)))


def rfftfreq(n, d=1.0):
    return fromarray(np.fft.rfftfreq(int(n), d=float(d)))

