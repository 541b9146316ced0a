"""Lazy expression graph over torch tensors.

Counterpart of ``ramba_tpu/core/expr.py``.  Nodes are immutable; evaluation
semantics live in the ``OPS`` table (plain Python functions over torch
tensors).  Dtypes never come from torch's promotion: every ``map`` casts its
inputs to NumPy's loop dtypes (``ufunc.resolve_dtypes`` under NEP 50, with
python scalars weakly typed) and its output to NumPy's result dtype, so the
port follows NumPy exactly, as the JAX package's x64 regime does.

An ``Aval`` (shape, dtype, weak) stands in for ``jax.ShapeDtypeStruct``;
:func:`infer_aval` computes it from shape broadcasting plus the rule table,
never by running an op.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch

from ramba_tpu_torch import common

# ---------------------------------------------------------------------------
# dtypes
# ---------------------------------------------------------------------------


def _make_bf16() -> np.dtype:
    try:
        import ml_dtypes
    except ImportError:
        # without ml_dtypes numpy has no bfloat16; a 2-byte tagged stand-in
        # lets avals, the dtype rules and the kernels' codegen still name it
        return np.dtype([("bfloat16", np.uint16)])
    return np.dtype(ml_dtypes.bfloat16)


BF16 = _make_bf16()


def is_bf16(dt) -> bool:
    return not isinstance(dt, torch.dtype) and np.dtype(dt) == BF16


def to_torch_dtype(dt) -> torch.dtype:
    if isinstance(dt, torch.dtype):
        return dt
    if is_bf16(dt):
        return torch.bfloat16
    return getattr(torch, np.dtype(dt).name)


def to_np_dtype(dt) -> np.dtype:
    if isinstance(dt, torch.dtype):
        if dt == torch.bfloat16:
            return BF16
        return np.dtype(str(dt).split(".")[1])
    return np.dtype(dt)


class Aval(NamedTuple):
    """Shape, NumPy dtype and JAX-style weak-type flag of a value."""

    shape: tuple
    dtype: np.dtype
    weak: bool = False


_WEAK_DTYPE = {bool: np.dtype(bool), int: np.dtype(np.int64),
               float: np.dtype(np.float64), complex: np.dtype(np.complex128)}


def aval_of(v) -> Aval:
    """Aval of a runtime value: a tensor, a numpy scalar or a python scalar
    (python int/float/complex are weak, as in JAX; bool is not)."""
    if isinstance(v, torch.Tensor):
        return Aval(tuple(v.shape), to_np_dtype(v.dtype), False)
    if isinstance(v, (np.generic, np.ndarray)):
        return Aval(tuple(np.shape(v)), np.dtype(v.dtype), False)
    if isinstance(v, bool):
        return Aval((), np.dtype(bool), False)
    for t in (int, float, complex):
        if isinstance(v, t):
            return Aval((), _WEAK_DTYPE[t], True)
    raise TypeError(f"no aval for {type(v)}")


# ---------------------------------------------------------------------------
# Nodes
# ---------------------------------------------------------------------------


class Expr:
    """Base class.  ``aval`` is an :class:`Aval`."""

    __slots__ = ("aval", "__weakref__")

    @property
    def shape(self):
        return self.aval.shape

    @property
    def dtype(self):
        return self.aval.dtype


class Const(Expr):
    """Leaf holding a concrete tensor."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value
        self.aval = aval_of(value)


class Scalar(Expr):
    """Leaf holding a python or numpy scalar.  Passed to the lowering as a
    runtime argument, so changing its value never rebuilds a kernel."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value
        self.aval = aval_of(value)


class Node(Expr):
    """Interior node: ``OPS[op](static, *args)``."""

    __slots__ = ("op", "static", "args")

    def __init__(self, op: str, static: tuple, args: Sequence[Expr], aval=None):
        self.op = op
        self.static = static
        self.args = tuple(args)
        if aval is None:
            aval = infer_aval(op, static, [a.aval for a in self.args])
        self.aval = aval


def as_expr(x: Any) -> Expr:
    if isinstance(x, Expr):
        return x
    if isinstance(x, (bool, int, float, complex, np.bool_, np.integer,
                      np.floating)):
        return Scalar(x)
    if isinstance(x, torch.Tensor):
        return Const(x)
    if isinstance(x, np.ndarray):
        return Const(tensor_from_numpy(x))
    raise TypeError(f"cannot lift {type(x)} into an expression")


def tensor_from_numpy(a: np.ndarray, dev=None) -> torch.Tensor:
    """Host array -> tensor on ``dev`` (default: the process device), dtype
    kept exactly; bfloat16 goes through its uint16 bit pattern."""
    # a copy, as NumPy's array() makes: the array never aliases the
    # caller's buffer (on the CPU ``to`` alone would)
    a = np.array(a, copy=True, order="C")
    if is_bf16(a.dtype):
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(common.device() if dev is None else dev)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view(BF16)
    return t.numpy()


# ---------------------------------------------------------------------------
# NumPy's dtype rules
# ---------------------------------------------------------------------------


def _rule_arg(av: Aval):
    """What ``resolve_dtypes`` sees for one operand: python types for weak
    values (NEP 50), float16 standing in for bfloat16."""
    if av.weak:
        return {"b": bool, "i": int, "u": int, "f": float,
                "c": complex}.get(av.dtype.kind, av.dtype)
    if is_bf16(av.dtype):
        return np.dtype(np.float16)
    return av.dtype


def loop_dtypes(fname: str, avals: Sequence[Aval]):
    """NumPy's exact (input..., output) dtypes for this ufunc application
    under NEP 50, or None when ``fname`` is not a one-output numpy ufunc.
    Raises TypeError when NumPy has no loop for the operands.  bfloat16 is
    resolved as float16 and mapped back, which gives JAX's bf16 lattice for
    bf16 against weak scalars, bf16 and bool."""
    uf = getattr(np, fname, None)
    if not isinstance(uf, np.ufunc) or uf.nin != len(avals) or uf.nout != 1:
        return None
    try:
        loop = uf.resolve_dtypes(tuple(_rule_arg(a) for a in avals) + (None,))
    except Exception as e:
        raise TypeError(
            f"no numpy loop for {fname} on {[str(a.dtype) for a in avals]}"
        ) from e
    if any(is_bf16(a.dtype) for a in avals) and not any(
            a.dtype == np.dtype(np.float16) for a in avals):
        loop = tuple(BF16 if d == np.float16 else d for d in loop)
    return tuple(np.dtype(d) for d in loop)


_FLOAT_ONLY = frozenset({"sinc", "i0", "angle"})


def map_dtypes(fname: str, avals: Sequence[Aval]):
    """(per-arg computation dtypes | None for "leave as is", output dtype)
    of one ``map``.  ``where`` casts its value operands to their common
    (``add``) dtype and leaves the condition alone."""
    if fname == "where":
        loop = loop_dtypes("add", avals[1:])
        return (None, loop[-1], loop[-1]), loop[-1]
    loop = loop_dtypes(fname, avals)
    if loop is not None:
        return loop[:-1], loop[-1]
    # the few MAPFN entries that are not numpy ufuncs
    dt = np.result_type(*[_rule_arg(a) for a in avals])
    if fname in _FLOAT_ONLY and dt.kind not in "fc":
        # jnp's inexact promotion: float64 for 64-bit integers and for
        # angle, float32 below that
        wide = fname == "angle" or dt.itemsize == 8
        dt = np.dtype(np.float64 if wide else np.float32)
    if fname in ("real", "imag") and dt.kind == "c":
        dt = np.dtype(np.float64 if dt.itemsize == 16 else np.float32)
    return tuple(dt for _ in avals), dt


def reduce_dtype(fname: str, dt: np.dtype) -> np.dtype:
    """Result dtype of a whole-array reduction, as ``jnp`` gives it under
    x64: sum/prod widen sub-64-bit integers and bool, mean goes inexact
    (float32 for integers of 32 bits or fewer), any/all give bool."""
    dt = np.dtype(dt)
    if fname in ("any", "all"):
        return np.dtype(bool)
    if fname in ("sum", "prod"):
        if dt.kind == "b":
            return np.dtype(np.int64)
        if dt.kind in "iu" and dt.itemsize < 8:
            return np.dtype(np.int64 if dt.kind == "i" else np.uint64)
        return dt
    if fname == "mean":
        if dt.kind in "biu":
            return np.dtype(np.float64 if dt.itemsize == 8 else np.float32)
        return dt
    return dt


# ---------------------------------------------------------------------------
# Shape/dtype inference
# ---------------------------------------------------------------------------

AVAL_RULES: dict[str, Callable] = {}


def infer_aval(op: str, static: tuple, arg_avals: Sequence[Aval]) -> Aval:
    return AVAL_RULES[op](static, *arg_avals)


def _rule(name):
    def deco(fn):
        AVAL_RULES[name] = fn
        return fn
    return deco


@_rule("map")
def _aval_map(static, *avals):
    (fname,) = static
    shape = tuple(np.broadcast_shapes(*[a.shape for a in avals]))
    _casts, out = map_dtypes(fname, avals)
    return Aval(shape, out, False)


@_rule("cast")
def _aval_cast(static, x):
    return Aval(x.shape, np.dtype(static[0]), False)


@_rule("round")
def _aval_round(static, x):
    return Aval(x.shape, x.dtype, x.weak)


def _reduced_shape(shape, axis, keepdims):
    if axis is None:
        axes = set(range(len(shape)))
    elif isinstance(axis, tuple):
        axes = set(axis)
    else:
        axes = {axis}
    if keepdims:
        return tuple(1 if i in axes else s for i, s in enumerate(shape))
    return tuple(s for i, s in enumerate(shape) if i not in axes)


@_rule("reduce")
def _aval_reduce(static, x):
    fname, axis, keepdims, _ddof = static
    return Aval(_reduced_shape(x.shape, axis, keepdims),
                reduce_dtype(fname, x.dtype), False)


def _index_shape(shape, enc):
    # a zero-stride view answers numpy's basic-indexing shape rules for free
    probe = np.broadcast_to(np.empty((), np.int8), shape)
    return tuple(probe[decode_index(enc)].shape)


@_rule("getitem")
def _aval_getitem(static, x):
    return Aval(_index_shape(x.shape, static[0]), x.dtype, x.weak)


@_rule("setitem")
def _aval_setitem(static, x, v):
    return Aval(x.shape, x.dtype, x.weak)


@_rule("permute")
def _aval_permute(static, x):
    return Aval(tuple(x.shape[a] for a in static[0]), x.dtype, x.weak)


@_rule("reshape")
def _aval_reshape(static, x):
    return Aval(tuple(static[0]), x.dtype, x.weak)


@_rule("arange")
def _aval_arange(static, start, step):
    n, dtype, _spec = static
    # start + step * iota(dtype): float start/step against an integer dtype
    # promote, as the reference's expression does
    _c, out = map_dtypes("add", [start, Aval((n,), np.dtype(dtype))])
    _c, out = map_dtypes("add", [step, Aval((n,), out)])
    return Aval((n,), out, False)


@_rule("linspace")
def _aval_linspace(static, start, stop):
    num, _endpoint, dtype, _spec = static
    return Aval((num,), np.dtype(dtype), False)


@_rule("full")
def _aval_full(static, fill):
    shape, dtype, _spec = static
    return Aval(tuple(shape), np.dtype(dtype), False)


# ---------------------------------------------------------------------------
# Op evaluation table
# ---------------------------------------------------------------------------

OPS: dict[str, Callable] = {}


def defop(name: str, aval_rule: Callable = None) -> Callable[[Callable], Callable]:
    def deco(fn: Callable) -> Callable:
        OPS[name] = fn
        if aval_rule is not None:
            AVAL_RULES[name] = aval_rule
        return fn

    return deco


# -- elementwise maps --------------------------------------------------------
# Each entry computes one numpy ufunc on operands already cast to its loop
# dtypes.  Where torch and NumPy differ on such operands the entry says how.


def _sign(x):
    s = torch.sign(x)
    # numpy and jnp: sign(nan) is nan
    return torch.where(torch.isnan(x), x, s) if x.is_floating_point() else s


def _reciprocal(x):
    if x.is_floating_point() or x.is_complex():
        return torch.reciprocal(x)
    # integer reciprocal is C integer division 1/x
    return torch.div(torch.ones_like(x), x, rounding_mode="trunc")


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _absolute(x):
    return x if x.dtype == torch.bool else torch.abs(x)


def _invert(x):
    return torch.logical_not(x) if x.dtype == torch.bool else torch.bitwise_not(x)


def _imag(x):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


UNARY: dict[str, Callable] = {
    "negative": torch.neg, "positive": lambda x: x,
    "absolute": _absolute, "abs": _absolute, "fabs": torch.abs,
    "sqrt": torch.sqrt, "square": torch.square, "cbrt": _cbrt,
    "reciprocal": _reciprocal, "sign": _sign,
    "exp": torch.exp, "exp2": torch.exp2, "expm1": torch.expm1,
    "log": torch.log, "log2": torch.log2, "log10": torch.log10,
    "log1p": torch.log1p, "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.asin, "arccos": torch.acos, "arctan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "arcsinh": torch.asinh, "arccosh": torch.acosh, "arctanh": torch.atanh,
    "floor": torch.floor, "ceil": torch.ceil, "trunc": torch.trunc,
    "rint": torch.round,  # round half to even, as rint
    "isnan": torch.isnan, "isinf": torch.isinf, "isfinite": torch.isfinite,
    "logical_not": torch.logical_not, "invert": _invert,
    "conj": torch.conj_physical, "conjugate": torch.conj_physical,
    "real": torch.real, "imag": _imag,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
    "deg2rad": torch.deg2rad, "rad2deg": torch.rad2deg,
    "signbit": torch.signbit, "sinc": torch.sinc, "i0": torch.i0,
    "angle": torch.angle,
}

def floor_div_by_zero(a: torch.Tensor) -> torch.Tensor:
    """Integer ``a // 0`` as ``ramba_tpu`` gives it (XLA's division by zero,
    then jnp's floor correction): the dtype's maximum for unsigned types;
    -1 where ``a == 0`` and -2 elsewhere for signed ones."""
    if not a.dtype.is_signed:
        return torch.full_like(a, torch.iinfo(a.dtype).max)
    return torch.where(a == 0, torch.full_like(a, -1), torch.full_like(a, -2))


def _float_floor_divide(a, b):
    """Float ``a // b`` as ``ramba_tpu`` gives it: NumPy's quotient, but a
    zero quotient takes the divisor's sign (jnp computes ``(a - fmod(a, b))
    / b``, whose numerator is +0 there), so ``-0.0 // 2.0`` is 0.0 and
    ``-0.0 // -2.0`` is -0.0; NumPy signs it by ``a / b`` instead."""
    q = torch.floor_divide(a, b)
    return torch.where(q == 0, torch.copysign(torch.zeros_like(q), b), q)


def _int_zero_safe(fn, by_zero, float_fn=None):
    """Integer division by zero gives ``by_zero(a)`` where torch raises;
    floats keep IEEE inf/nan (through ``float_fn`` where given)."""

    def op(a, b):
        if a.is_floating_point() or a.is_complex():
            return (float_fn or fn)(a, b)
        if a.dtype == torch.bool:
            a, b = a.to(torch.int8), b.to(torch.int8)
        zero = b == 0
        out = fn(a, torch.where(zero, torch.ones_like(b), b))
        return torch.where(zero, by_zero(a), out)

    return op


BINARY: dict[str, Callable] = {
    "add": torch.add, "subtract": torch.sub, "multiply": torch.mul,
    "true_divide": torch.true_divide, "divide": torch.true_divide,
    # floored division and modulo with numpy's signs (torch implements
    # numpy's npy_divmod for floats), zero quotients signed as in ramba_tpu;
    # integer x % 0 is 0 in both packages
    "floor_divide": _int_zero_safe(torch.floor_divide, floor_div_by_zero,
                                   _float_floor_divide),
    "mod": _int_zero_safe(torch.remainder, torch.zeros_like),
    "remainder": _int_zero_safe(torch.remainder, torch.zeros_like),
    "fmod": _int_zero_safe(torch.fmod, torch.zeros_like),
    "power": torch.pow, "float_power": torch.float_power,
    "arctan2": torch.atan2, "hypot": torch.hypot,
    # maximum/minimum propagate NaN, fmax/fmin ignore it: same in torch
    "maximum": torch.maximum, "minimum": torch.minimum,
    "fmax": torch.fmax, "fmin": torch.fmin,
    "logaddexp": torch.logaddexp, "logaddexp2": torch.logaddexp2,
    "logical_and": torch.logical_and, "logical_or": torch.logical_or,
    "logical_xor": torch.logical_xor,
    "bitwise_and": torch.bitwise_and, "bitwise_or": torch.bitwise_or,
    "bitwise_xor": torch.bitwise_xor,
    "left_shift": torch.bitwise_left_shift,
    "right_shift": torch.bitwise_right_shift,
    "equal": torch.eq, "not_equal": torch.ne, "less": torch.lt,
    "less_equal": torch.le, "greater": torch.gt, "greater_equal": torch.ge,
    "copysign": torch.copysign, "nextafter": torch.nextafter,
    "heaviside": torch.heaviside, "gcd": torch.gcd, "lcm": torch.lcm,
    "ldexp": torch.ldexp,
}


def _where(c, a, b):
    return torch.where(c if c.dtype == torch.bool else c != 0, a, b)


MAPFN: dict[str, Callable] = {}
MAPFN.update(UNARY)
MAPFN.update(BINARY)
MAPFN["where"] = _where


# -- unsigned integers wider than 8 bits -------------------------------------
# torch has conversions, views and copies for uint16/uint32/uint64 but almost
# no arithmetic.  Such values are computed in an int64 carrier (uint16 and
# uint32 by value, uint64 by bit pattern) and wrapped back to their width.
# add, subtract, multiply, power, negative, the bitwise ops and equality
# agree with the signed ops modulo 2**width; the table below holds the ops
# that need the unsigned forms.

_WIDE_UNSIGNED = {torch.uint16: 16, torch.uint32: 32, torch.uint64: 64}
_SIGN_BIT = -(1 << 63)


def _is_wide_unsigned(tdt) -> bool:
    return tdt in _WIDE_UNSIGNED


def _to_carrier(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int64) if t.dtype == torch.uint64 else t.to(torch.int64)


def _from_carrier(c: torch.Tensor, tdt: torch.dtype) -> torch.Tensor:
    if tdt == torch.uint64:
        return c.view(torch.uint64)
    return (c & ((1 << _WIDE_UNSIGNED[tdt]) - 1)).to(tdt)


def _ukey(c, w):
    """Order-preserving signed image of a carrier: compare these."""
    return c ^ _SIGN_BIT if w == 64 else c


def _umax(c, w):
    return torch.full_like(c, -1 if w == 64 else (1 << w) - 1)


def _udivmod(a, b, w):
    """Unsigned floored quotient and remainder of carriers (b != 0)."""
    if w < 64:
        return torch.div(a, b, rounding_mode="floor"), torch.remainder(a, b)
    big = b < 0  # a divisor of 2**63 or more: the quotient is 0 or 1
    bs = torch.where(big, torch.ones_like(b), b)
    # halve the dividend into int64 range, divide, double, correct once
    q = torch.div((a >> 1) & ~_SIGN_BIT, bs, rounding_mode="floor") << 1
    r = a - q * bs
    fix = _ukey(r, 64) >= _ukey(bs, 64)
    q = torch.where(fix, q + 1, q)
    r = torch.where(fix, r - bs, r)
    q_big = (_ukey(a, 64) >= _ukey(b, 64)).to(torch.int64)
    return (torch.where(big, q_big, q),
            torch.where(big, a - q_big * b, r))


def _u_floor_divide(a, b, w):
    zero = b == 0
    q, _r = _udivmod(a, torch.where(zero, torch.ones_like(b), b), w)
    return torch.where(zero, _umax(q, w), q)


def _u_remainder(a, b, w):
    zero = b == 0
    _q, r = _udivmod(a, torch.where(zero, torch.ones_like(b), b), w)
    return torch.where(zero, torch.zeros_like(r), r)


def _u_shift(a, s, w, left):
    # a shift by the width or more gives 0 (XLA's rule)
    big = _ukey(s, w) >= _ukey(torch.full_like(s, min(w, 64)), w)
    s = torch.where(big, torch.zeros_like(s), s)
    if left:
        out = a << s
    elif w < 64:
        out = a >> s
    else:  # logical shift of the bit pattern
        out = (a >> s) & ~(torch.full_like(a, -1) << (64 - s))
    return torch.where(big, torch.zeros_like(out), out)


def _u_gcd(a, b, w):
    a, b = torch.broadcast_tensors(a, b)
    if w < 64:
        return torch.gcd(a, b)
    while True:  # Euclid with the unsigned remainder
        nz = b != 0
        if not bool(nz.any()):
            return a
        r = _u_remainder(a, b, w)
        a, b = torch.where(nz, b, a), torch.where(nz, r, b)


def _u_lcm(a, b, w):
    g = _u_gcd(a, b, w)
    zero = g == 0
    q, _r = _udivmod(b, torch.where(zero, torch.ones_like(g), g), w)
    return torch.where(zero, torch.zeros_like(g), a * q)


def _u_pick(cmp):
    return lambda a, b, w: torch.where(cmp(_ukey(a, w), _ukey(b, w)), a, b)


_UNSIGNED: dict[str, Callable] = {
    "floor_divide": _u_floor_divide, "mod": _u_remainder,
    "remainder": _u_remainder, "fmod": _u_remainder,
    "left_shift": lambda a, s, w: _u_shift(a, s, w, True),
    "right_shift": lambda a, s, w: _u_shift(a, s, w, False),
    "less": lambda a, b, w: _ukey(a, w) < _ukey(b, w),
    "less_equal": lambda a, b, w: _ukey(a, w) <= _ukey(b, w),
    "greater": lambda a, b, w: _ukey(a, w) > _ukey(b, w),
    "greater_equal": lambda a, b, w: _ukey(a, w) >= _ukey(b, w),
    "maximum": _u_pick(torch.ge), "fmax": _u_pick(torch.ge),
    "minimum": _u_pick(torch.le), "fmin": _u_pick(torch.le),
    "absolute": lambda a, w: a, "abs": lambda a, w: a,
    "sign": lambda a, w: (a != 0).to(torch.int64),
    # jnp: integer 1 // x, with 1 // 0 the dtype's maximum
    "reciprocal": lambda a, w: torch.where(
        a == 0, _umax(a, w), (a == 1).to(torch.int64)),
    "gcd": _u_gcd, "lcm": _u_lcm,
}


def _unsigned_map(fname: str, cargs, tdt: torch.dtype) -> torch.Tensor:
    """One ufunc whose loop dtype ``tdt`` is uint16/32/64, through the
    carrier."""
    w = _WIDE_UNSIGNED[tdt]
    carried = [_to_carrier(a) if a.dtype == tdt else a for a in cargs]
    if fname in _UNSIGNED:
        out = _UNSIGNED[fname](*carried, w)
    else:
        out = MAPFN[fname](*carried)
    return _from_carrier(out, tdt) if out.dtype == torch.int64 else out


def _device_of(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return common.device()


def as_tensor(v, dtype=None, dev=None) -> torch.Tensor:
    """A runtime value as a tensor of numpy ``dtype`` (default: its own)."""
    if dtype is None:
        dtype = aval_of(v).dtype
    tdt = to_torch_dtype(dtype)
    if isinstance(v, torch.Tensor):
        return v if v.dtype == tdt else v.to(tdt)
    if isinstance(v, np.generic):
        v = v.item()
    # torch.full launches a fill kernel: no host-to-device copy, no sync
    return torch.full((), v, dtype=tdt,
                      device=common.device() if dev is None else dev)


def apply_map(fname: str, args: Sequence) -> torch.Tensor:
    """Evaluate one numpy ufunc on runtime values with numpy's dtypes."""
    casts, out_dt = map_dtypes(fname, [aval_of(a) for a in args])
    dev = _device_of(args)
    cargs = [a if d is None and isinstance(a, torch.Tensor)
             else as_tensor(a, d if d is not None else None, dev)
             for a, d in zip(args, casts)]
    loop_tdt = cargs[-1].dtype
    if _is_wide_unsigned(loop_tdt):
        out = _unsigned_map(fname, cargs, loop_tdt)
    else:
        out = MAPFN[fname](*cargs)
    tdt = to_torch_dtype(out_dt)
    return out if out.dtype == tdt else out.to(tdt)


@defop("map")
def _op_map(static, *args):
    (fname,) = static
    return apply_map(fname, args)


def make_map(fname: str, operands: Sequence[Expr]) -> Expr:
    """Build an elementwise map node, strength-reducing ``power`` by a small
    static integer exponent into a multiply chain (as the JAX package does,
    so both lower ``x**2`` to one multiply)."""
    if fname == "power" and len(operands) == 2:
        e = operands[1]
        if (
            isinstance(e, Scalar)
            and isinstance(e.value, (int, np.integer))
            and not isinstance(e.value, (bool, np.bool_))
            and 1 <= int(e.value) <= 4
            and operands[0].dtype != np.bool_
        ):
            x = operands[0]
            out = x
            for _ in range(int(e.value) - 1):
                out = Node("map", ("multiply",), [out, x])
            return out
    return Node("map", (fname,), list(operands))


@defop("cast")
def _op_cast(static, x):
    (dtype,) = static
    return as_tensor(x, np.dtype(dtype))


def round_half_even(x: torch.Tensor, decimals: int) -> torch.Tensor:
    """``jnp.round``: round half to even, scaled by 10**decimals for
    floats; integers with decimals >= 0 are unchanged."""
    if not x.is_floating_point():
        if decimals >= 0:
            return x
        f = 10 ** (-decimals)
        return torch.round(x.double() / f).to(x.dtype) * f
    if decimals == 0:
        return torch.round(x)
    factor = torch.full((), 10.0 ** decimals, dtype=x.dtype, device=x.device)
    return torch.round(x * factor) / factor


@defop("round")
def _op_round(static, x):
    (decimals,) = static
    return round_half_even(as_tensor(x), int(decimals))


# -- reductions --------------------------------------------------------------


def _dims(axis, ndim):
    if axis is None:
        return tuple(range(ndim))
    return tuple(axis) if isinstance(axis, tuple) else (axis,)


def _reduce_unsigned(fname, x, out_dt, dims, keepdims):
    """sum/prod/min/max of uint16/32/64 through the int64 carrier: sums and
    products wrap modulo 2**64 exactly as the uint64 result does."""
    w = _WIDE_UNSIGNED[x.dtype]
    c = _to_carrier(x)
    if fname in ("min", "max"):
        k = _ukey(c, w)
        r = _ukey(reduce_tensor(fname, k, tuple(dims), keepdims), w)
        return _from_carrier(r, x.dtype)
    r = reduce_tensor(fname, c, tuple(dims), keepdims)
    return _from_carrier(r, out_dt)


def reduce_tensor(fname, x: torch.Tensor, axis=None, keepdims=False):
    out_dt = to_torch_dtype(reduce_dtype(fname, to_np_dtype(x.dtype)))
    dims = _dims(axis, x.ndim)
    if x.ndim == 0:
        dims = ()
    if _is_wide_unsigned(x.dtype) and fname in ("sum", "prod", "min", "max"):
        return _reduce_unsigned(fname, x, out_dt, dims, keepdims)
    if fname in ("sum", "prod", "mean"):
        # accumulate in the result dtype, as numpy and jnp do
        y = x if x.dtype == out_dt else x.to(out_dt)
        if fname == "prod":
            for d in sorted(dims, reverse=True):
                y = torch.prod(y, dim=d, keepdim=keepdims)
            return y
        fn = torch.sum if fname == "sum" else torch.mean
        return fn(y, dim=dims, keepdim=keepdims) if dims else y.clone()
    if fname in ("min", "max"):
        if not dims:
            return x.clone()
        fn = torch.amin if fname == "min" else torch.amax
        return fn(x, dim=dims, keepdim=keepdims)
    if fname in ("any", "all"):
        y = x if x.dtype == torch.bool else x != 0
        fn = torch.any if fname == "any" else torch.all
        for d in sorted(dims, reverse=True):
            y = fn(y, dim=d, keepdim=keepdims)
        return y
    raise NotImplementedError(f"reduction {fname!r} is not ported yet")


@defop("reduce")
def _op_reduce(static, x):
    fname, axis, keepdims, _ddof = static
    return reduce_tensor(fname, as_tensor(x), axis, keepdims)


# -- indexing / views --------------------------------------------------------


def encode_index(idx) -> tuple:
    """Canonical hashable encoding of a basic index tuple."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    out = []
    for it in idx:
        if it is None:
            out.append(("n",))
        elif it is Ellipsis:
            out.append(("e",))
        elif isinstance(it, slice):
            out.append(("s", it.start, it.stop, it.step))
        elif isinstance(it, (int, np.integer)) and not isinstance(it, bool):
            out.append(("i", int(it)))
        else:
            raise TypeError(f"not a basic index: {it!r}")
    return tuple(out)


def decode_index(enc: tuple):
    out = []
    for it in enc:
        if it[0] == "n":
            out.append(None)
        elif it[0] == "e":
            out.append(Ellipsis)
        elif it[0] == "s":
            out.append(slice(it[1], it[2], it[3]))
        else:
            out.append(it[1])
    return tuple(out)


def _torch_index(shape, enc):
    """Basic index -> (torch index with positive steps, dims to flip).
    torch slicing refuses negative steps; a negative-step slice becomes the
    equivalent positive-step slice followed by a flip."""
    idx = decode_index(enc)
    out, flips = [], []
    dim_in, dim_out = 0, 0
    n_real = sum(1 for it in idx if it is not None and it is not Ellipsis)
    for it in idx:
        if it is None:
            out.append(None)
            dim_out += 1
            continue
        if it is Ellipsis:
            k = len(shape) - n_real
            out.append(Ellipsis)
            dim_in += k
            dim_out += k
            continue
        if isinstance(it, slice):
            start, stop, step = it.indices(shape[dim_in])
            if step < 0:
                r = range(start, stop, step)
                if len(r) == 0:
                    out.append(slice(0, 0, 1))
                else:
                    out.append(slice(r[-1], r[0] + 1, -step))
                    flips.append(dim_out)
            else:
                out.append(slice(start, stop, step))
            dim_in += 1
            dim_out += 1
        else:
            out.append(int(it))
            dim_in += 1
    return tuple(out), flips


@defop("getitem")
def _op_getitem(static, x):
    (enc,) = static
    idx, flips = _torch_index(tuple(x.shape), enc)
    y = x[idx]
    return torch.flip(y, flips) if flips else y


@defop("setitem")
def _op_setitem(static, x, v):
    (enc,) = static
    idx, flips = _torch_index(tuple(x.shape), enc)
    out = x.clone()
    v = as_tensor(v, to_np_dtype(x.dtype), x.device)
    if flips and v.ndim:
        # flips index the result view; align a full-rank value with it
        shift = out[idx].ndim - v.ndim
        v = torch.flip(v, [d - shift for d in flips if d - shift >= 0])
    out[idx] = v
    return out


def _aval_take(static, x, indices):
    axis, _mode = static
    return Aval(x.shape[:axis] + indices.shape + x.shape[axis + 1:],
                x.dtype, x.weak)


@defop("take", _aval_take)
def _op_take(static, x, indices):
    """``jnp.take`` along ``axis``: ``clip`` clamps every index into
    ``[0, n)`` (so -1 reads element 0), ``wrap`` takes it modulo n."""
    axis, mode = static
    n = x.shape[axis]
    idx = as_tensor(indices, dev=x.device).long()
    if mode == "clip":
        idx = idx.clamp(0, n - 1)
    elif mode == "wrap":
        idx = torch.remainder(idx, n)
    else:
        raise NotImplementedError(f"take mode {mode!r} is not ported yet")
    return x[(slice(None),) * axis + (idx,)]


@defop("permute")
def _op_permute(static, x):
    (axes,) = static
    return x.permute(*axes)


@defop("reshape")
def _op_reshape(static, x):
    (shape,) = static
    return x.reshape(shape)


# -- creation ----------------------------------------------------------------


@defop("arange")
def _op_arange(static, start, step):
    n, dtype, _spec = static
    tdt = to_torch_dtype(dtype)
    ints = all(isinstance(v, (int, np.integer)) and not isinstance(v, bool)
               for v in (start, step))
    if ints and np.dtype(dtype).kind in "iu":
        # exact in integers: one pass instead of iota, multiply and add
        start, step = int(start), int(step)
        return torch.arange(start, start + step * n, step, dtype=tdt,
                            device=common.device())[:n]
    iota = torch.arange(n, dtype=tdt, device=common.device())
    return apply_map("add", [start, apply_map("multiply", [step, iota])])


@defop("linspace")
def _op_linspace(static, start, stop):
    num, endpoint, dtype, _spec = static
    dt = np.dtype(dtype)
    div = (num - 1) if endpoint else num
    # jnp.linspace: start + step * iota in float64, endpoint pinned exactly
    iota = torch.arange(num, dtype=torch.float64, device=common.device())
    if div > 0:
        step = (float(stop) - float(start)) / div
        out = float(start) + iota * step
        if endpoint and num > 1:
            out[-1] = float(stop)
    else:
        out = torch.full((num,), float(start), dtype=torch.float64,
                         device=common.device())
    if dt.kind in "iu":
        out = torch.floor(out)
    return out.to(to_torch_dtype(dt))


@defop("full")
def _op_full(static, fill):
    shape, dtype, _spec = static
    if isinstance(fill, torch.Tensor):
        return fill.to(to_torch_dtype(dtype)).expand(tuple(shape)).clone()
    if isinstance(fill, np.generic):
        fill = fill.item()
    return torch.full(tuple(shape), fill, dtype=to_torch_dtype(dtype),
                      device=common.device())
