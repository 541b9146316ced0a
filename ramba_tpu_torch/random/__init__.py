"""Random number generation on the port's device.

Counterpart of ``ramba_tpu/random/__init__.py``.  Every draw is one
``random`` node (``core/expr.py``) whose key is a host value: a 0-d int64
leaf, not part of the node's static tuple.  At run time the op seeds a
generator on the device from that key, so a draw is a pure function of its
key (a re-run of the program gives the same bytes) and a new seed reuses
the compiled program.

Keys come from a counter-based stream on the host: ``seed(s)`` starts the
stream ``(s, 0)`` and every draw takes the next counter, mixed through
splitmix64.  Nothing reads the device to split a key.  A
:class:`RandomState` carries its own stream, so drawing from it leaves the
global stream where it was.

The values differ from ``ramba_tpu``'s (threefry there, torch's Philox on
the card and its CPU generator on the CPU, which differ from each other
too): shapes, dtypes, supports and distributions agree, and seeded draws
reproduce within the port on one device type.  Dtypes follow
``ramba_tpu``'s x64 regime: float64 for the real draws, int64 (NumPy's
``int``) for randint, poisson, binomial and ``permutation(n)``.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ramba_tpu_torch.core.expr import Const, Node
from ramba_tpu_torch.core.ndarray import as_exprable, ndarray

_M64 = (1 << 64) - 1
_FLOAT = np.dtype(np.float64)
_INT = np.dtype(int)


def _mix(x: int) -> int:
    """splitmix64's finaliser."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


class _Stream:
    """Keys ``mix(mix(seed) ^ counter)``: one per draw, on the host."""

    def __init__(self, s: int):
        self._base = _mix(int(s) & _M64)
        self._counter = 0
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            self._counter += 1
            c = self._counter
        # a 63-bit key: it seeds torch's generators as a non-negative int64
        return _mix(self._base ^ c) >> 1


_stream = _Stream(0)


def seed(s: int) -> None:
    """Reference: ramba.random.seed."""
    global _stream
    _stream = _Stream(s)


def _key_leaf(key: int) -> Const:
    return Const(torch.tensor(key, dtype=torch.int64))


def _canon_shape(size):
    if size is None:
        return ()
    if isinstance(size, (int, np.integer)):
        return (int(size),)
    return tuple(int(s) for s in size)


def _node(stream, kind, shape, dtype, operands=()):
    return ndarray(Node("random", (kind, shape, str(np.dtype(dtype)), None),
                        [_key_leaf(stream.next())]
                        + [as_exprable(p) for p in operands]))


def _rand(kind, size, dtype, params=()):
    return _node(_stream, kind, _canon_shape(size), dtype, params)


def _unit(v, c) -> bool:
    return np.ndim(v) == 0 and not isinstance(v, ndarray) and v == c


def random(size=None):
    return _rand("uniform", size, _FLOAT)


random_sample = random
sample = random


def rand(*shape):
    return random(shape)


def randn(*shape):
    return normal(size=shape)


def normal(loc=0.0, scale=1.0, size=None):
    out = _rand("normal", size, _FLOAT)
    if not _unit(scale, 1.0):
        out = out * scale
    if not _unit(loc, 0.0):
        out = out + loc
    return out


def uniform(low=0.0, high=1.0, size=None):
    return _rand("uniform_range", size, _FLOAT, (float(low), float(high)))


def randint(low, high=None, size=None, dtype=int):
    if high is None:
        low, high = 0, low
    if int(high) <= int(low):
        raise ValueError(f"randint: low >= high ({low} >= {high})")
    return _rand("randint", size, np.dtype(dtype), (int(low), int(high)))


class RandomState:
    """Reference: RandomState passthrough, with its own key stream."""

    def __init__(self, s=None):
        self._stream = _Stream(0 if s is None else int(s))

    def random(self, size=None):
        return _node(self._stream, "uniform", _canon_shape(size), _FLOAT)

    def normal(self, loc=0.0, scale=1.0, size=None):
        out = _node(self._stream, "normal", _canon_shape(size), _FLOAT)
        return out * scale + loc


def default_rng(s=None):
    return RandomState(s)


# -- the rest of the numpy.random surface ---------------------------------------


def standard_normal(size=None):
    return _rand("normal", size, _FLOAT)


def exponential(scale=1.0, size=None):
    out = _rand("exponential", size, _FLOAT)
    return out if _unit(scale, 1.0) else out * scale


def poisson(lam=1.0, size=None):
    return _rand("poisson", size, _INT, (float(lam),))


def beta(a, b, size=None):
    return _rand("beta", size, _FLOAT, (float(a), float(b)))


def gamma(shape, scale=1.0, size=None):
    out = _rand("gamma", size, _FLOAT, (float(shape),))
    return out if _unit(scale, 1.0) else out * scale


def binomial(n, p, size=None):
    return _rand("binomial", size, _INT, (int(n), float(p)))


def permutation(x):
    """numpy.random.permutation: permuted range for an int, a shuffled
    copy (along axis 0) for an array."""
    from ramba_tpu_torch.ops.creation import asarray as _asarray

    if isinstance(x, (int, np.integer)):
        n = int(x)
        return _rand("permutation", (n,), np.int64)
    a = _asarray(x)
    if a.ndim == 0:
        raise ValueError("permutation: x must be an integer or at least "
                         "1-dimensional")
    return _node(_stream, "permutation_array", a.shape, a.dtype, (a,))


def shuffle(x):
    """numpy.random.shuffle: permute the array along axis 0 IN PLACE
    (written back through the port's setitem)."""
    x[...] = permutation(x)


def choice(a, size=None, replace=True, p=None):
    from ramba_tpu_torch.ops.creation import asarray as _asarray

    if isinstance(a, (int, np.integer)):
        a = _asarray(np.arange(int(a)))
    else:
        a = _asarray(a)
    shape = _canon_shape(size)
    if not replace and int(np.prod(shape, dtype=np.int64)) > a.shape[0]:
        raise ValueError("Cannot take a larger sample than population when "
                         "'replace=False'")
    operands = [a]
    if p is not None:
        operands.append(_asarray(np.asarray(p, dtype=float)))
    return _node(_stream, "choice" if replace else "choice_norepl", shape,
                 a.dtype, operands)
