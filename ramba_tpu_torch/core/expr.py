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

import contextlib
import functools
import math
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


_TORCH_DTYPES: dict = {}


def to_torch_dtype(dt) -> torch.dtype:
    if isinstance(dt, torch.dtype):
        return dt
    t = _TORCH_DTYPES.get(dt)  # every op asks: numpy's name lookup is slow
    if t is None:
        t = torch.bfloat16 if is_bf16(dt) else getattr(torch, np.dtype(dt).name)
        _TORCH_DTYPES[dt] = t
    return t


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
    """Leaf holding a concrete tensor.  ``host`` keeps the NumPy array an
    upload was made from (None otherwise), so graph rewrites can read
    index constants without copying them back from the card.
    ``sharding`` is the layout a realized array carries (a
    ``parallel.mesh.NamedSharding``; None: the default layout of the
    current mesh).  On a mesh of ranks ``value`` is this rank's block and
    ``shape`` the array's global shape (:attr:`is_block`)."""

    __slots__ = ("value", "host", "sharding")

    def __init__(self, value, host=None, sharding=None, shape=None):
        self.value = value
        self.host = host
        self.sharding = sharding
        self.aval = aval_of(value)
        if shape is not None:
            self.aval = Aval(tuple(shape), self.aval.dtype, False)

    @property
    def is_block(self) -> bool:
        """True when ``value`` is one rank's block of a larger array."""
        sh = self.sharding
        return sh is not None and sh.mesh.ranks is not None


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
                      np.floating, np.complexfloating)):
        return Scalar(x)
    if isinstance(x, torch.Tensor):
        return Const(x)
    if isinstance(x, np.ndarray):
        if x.dtype.kind not in "iu":
            return Const(tensor_from_numpy(x))
        # an integer array may be an index: the rewrites read it, so the
        # Const keeps the private copy the upload is made from (no op
        # writes into a Const's value or host array)
        a = np.array(x, copy=True, order="C")
        return Const(tensor_from_numpy(a, copy=False), host=a)
    raise TypeError(f"cannot lift {type(x)} into an expression")


def tensor_from_numpy(a: np.ndarray, dev=None, copy=True) -> torch.Tensor:
    """Host array -> tensor on ``dev`` (default: the process device), dtype
    kept exactly; bfloat16 goes through its uint16 bit pattern.
    ``copy=False``: ``a`` is already a private C-ordered copy (on the CPU
    the tensor then shares its memory)."""
    # a copy, as NumPy's array() makes: the array never aliases the
    # caller's buffer (on the CPU ``to`` alone would)
    if copy:
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
    return _loop_dtypes(fname, tuple(Aval((), a.dtype, a.weak) for a in avals))


@functools.lru_cache(maxsize=4096)
def _loop_dtypes(fname: str, avals: tuple):
    # shapes never change the answer: one entry per (ufunc, dtypes, weak)
    uf = getattr(np, fname, None)
    if not isinstance(uf, np.ufunc) or uf.nin != len(avals) or uf.nout != 1:
        return None
    try:
        loop = uf.resolve_dtypes(tuple(_rule_arg(a) for a in avals) + (None,))
    except Exception as e:
        if fname in _JNP_COMPLEX and any(a.dtype.kind == "c" for a in avals):
            # NumPy has no complex loop; jnp computes in the complex dtype
            dt = np.result_type(*[_rule_arg(a) for a in avals])
            return (dt,) * (len(avals) + 1)
        raise TypeError(
            f"no numpy loop for {fname} on {[str(a.dtype) for a in avals]}"
        ) from e
    if any(is_bf16(a.dtype) for a in avals) and not any(
            a.dtype == np.dtype(np.float16) for a in avals):
        loop = tuple(BF16 if d == np.float16 else d for d in loop)
    return tuple(np.dtype(d) for d in loop)


_FLOAT_ONLY = frozenset({"sinc", "i0", "angle"})
# ufuncs NumPy refuses on complex values that jnp computes all the same
_JNP_COMPLEX = frozenset({"arctan2", "deg2rad", "degrees", "rad2deg",
                          "radians", "logaddexp", "logaddexp2"})
# maps whose complex operand keeps its dtype and whose result is real
_COMPLEX_TO_REAL = frozenset({"real", "imag", "angle"})


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
    if fname in _COMPLEX_TO_REAL and dt.kind == "c":
        # computed on the complex value, the result in its real width
        return (dt,), np.dtype(np.float64 if dt.itemsize == 16 else np.float32)
    if fname in _FLOAT_ONLY and dt.kind not in "fc":
        # jnp's inexact promotion: float64 for 64-bit integers and for
        # angle, float32 below that
        wide = fname == "angle" or dt.itemsize == 8
        dt = np.dtype(np.float64 if wide else np.float32)
    return tuple(dt for _ in avals), dt


# Every reduction name ``ramba_tpu`` lowers (its ``REDFN`` table).
REDFN = (
    "sum", "prod", "min", "max", "any", "all", "mean", "var", "std",
    "nansum", "nanprod", "nanmin", "nanmax", "nanmean", "nanvar", "nanstd",
    "argmin", "argmax", "nanargmin", "nanargmax", "count_nonzero", "median",
    "nanmedian", "ptp",
)
# the NaN-ignoring kinds, and what each is on a dtype without NaN
NAN_PLAIN = {"nansum": "sum", "nanprod": "prod", "nanmin": "min",
             "nanmax": "max", "nanmean": "mean", "nanvar": "var",
             "nanstd": "std", "nanargmin": "argmin", "nanargmax": "argmax",
             "nanmedian": "median"}
_INEXACT_RED = frozenset({"mean", "var", "std", "nanmean", "nanvar", "nanstd",
                          "median", "nanmedian"})
_ARG_RED = frozenset({"argmin", "argmax", "nanargmin", "nanargmax"})
# the spreads of a complex value are real: var/std of |x - mean|
_REAL_RED = frozenset({"var", "std", "nanvar", "nanstd"})
_INDEX_RED = _ARG_RED | {"count_nonzero"}
# the reductions with no identity, by the ufunc NumPy names in its error
NO_IDENTITY = {"min": "minimum", "max": "maximum", "nanmin": "fmin",
               "nanmax": "fmax", "ptp": "maximum", "argmin": None,
               "argmax": None, "nanargmin": None, "nanargmax": None}


def empty_reduction_error(fname: str) -> ValueError:
    """NumPy's error for a reduction in ``NO_IDENTITY`` over an empty
    extent."""
    if fname in _ARG_RED:
        return ValueError(f"attempt to get {fname.replace('nan', '')} of "
                          "an empty sequence")
    return ValueError("zero-size array to reduction operation "
                      f"{NO_IDENTITY.get(fname, fname)} which has no "
                      "identity")


def reduces_nothing(shape, axis) -> bool:
    """True when reducing ``shape`` over ``axis`` (None, an int or a
    tuple) folds an empty extent."""
    return any(shape[d] == 0 for d in _dims(axis, len(shape)))


def reduce_dtype(fname: str, dt: np.dtype) -> np.dtype:
    """Result dtype of a reduction, as ``jnp`` gives it under x64:
    sum/prod (and their nan-kinds) widen sub-64-bit integers and bool; the
    mean family, var/std and the medians go inexact (float32 for integers
    of 32 bits or fewer, float64 for 64-bit ones); the arg-reductions and
    count_nonzero give int64; any/all give bool; min/max/ptp keep the
    dtype (ptp refuses bool, whose subtraction jnp rejects)."""
    dt = np.dtype(dt)
    if dt.kind == "c" and fname in ("median", "nanmedian"):
        raise ValueError("quantile does not support complex input, as the "
                         "operation is poorly defined.")
    if fname in ("any", "all"):
        return np.dtype(bool)
    if fname in ("sum", "prod", "nansum", "nanprod"):
        if dt.kind == "b":
            return np.dtype(np.int64)
        if dt.kind in "iu" and dt.itemsize < 8:
            return np.dtype(np.int64 if dt.kind == "i" else np.uint64)
        return dt
    if fname in _INEXACT_RED:
        if dt.kind in "biu":
            return np.dtype(np.float64 if dt.itemsize == 8 else np.float32)
        if dt.kind == "c" and fname in _REAL_RED:
            return np.dtype(np.float64 if dt.itemsize == 16 else np.float32)
        return dt
    if dt.kind == "c" and fname in _ARG_RED:
        raise TypeError(f"{fname}: complex values have no order to take the "
                        "index of (as jnp's lt/gt)")
    if fname in _INDEX_RED:
        return np.dtype(np.int64)
    if fname == "ptp" and dt.kind == "b":
        raise TypeError("ptp: subtract does not accept dtype bool")
    if fname not in REDFN:
        raise NotImplementedError(f"reduction {fname!r}")
    return dt


def cumulative_dtype(dt: np.dtype) -> np.dtype:
    """``cumsum``/``cumprod`` widen sub-64-bit integers and bool to the
    64-bit integer of their kind, as NumPy and ``ramba_tpu`` under x64."""
    dt = np.dtype(dt)
    if dt.kind in "biu" and (dt.kind == "b" or dt.itemsize < 8):
        return np.dtype(np.uint64 if dt.kind == "u" else np.int64)
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
    # jnp.round refuses bools, and integers to negative decimals
    if x.dtype.kind == "b":
        raise ValueError("round: the dtype bool is not accepted")
    if x.dtype.kind in "iu" and int(static[0]) < 0:
        raise NotImplementedError("integer np.round not implemented for "
                                  "decimals < 0")
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
    if fname in _ARG_RED and isinstance(axis, tuple):
        raise TypeError(f"{fname}: axis must be an int or None, not a tuple")
    return Aval(_reduced_shape(x.shape, axis, keepdims),
                reduce_dtype(fname, x.dtype), False)


_WHERE_IDENTITY = {"sum": 0, "prod": 1, "any": False, "all": True}


@_rule("reduce_where")
def _aval_reduce_where(static, x, mask):
    fname, axis, keepdims = static
    if fname not in _WHERE_IDENTITY and fname not in ("min", "max", "mean"):
        raise NotImplementedError(f"masked reduction {fname!r}")
    shape = _reduced_shape(x.shape, axis, keepdims)
    if fname == "mean":
        # ramba_tpu divides the masked sum by the mask's int64 count under
        # jnp's promotion: floats keep their dtype, integers give float64
        dt = reduce_dtype("sum", x.dtype)
        return Aval(shape, dt if dt.kind in "fc" else np.dtype(np.float64))
    return Aval(shape, reduce_dtype(fname, x.dtype), False)


@_rule("cumulative")
def _aval_cumulative(static, x):
    return Aval(x.shape, cumulative_dtype(x.dtype), False)


@_rule("broadcast_to")
def _aval_broadcast_to(static, x):
    (shape,) = static
    np.broadcast_shapes(x.shape, shape)  # raises where numpy would
    if tuple(np.broadcast_shapes(x.shape, shape)) != tuple(shape):
        raise ValueError(f"cannot broadcast {x.shape} to {shape}")
    return Aval(tuple(shape), x.dtype, x.weak)


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
    if x.is_complex():
        return _complex_sign(x)
    s = torch.sign(x)
    if not x.is_floating_point():
        return s
    # numpy and jnp: sign(nan) is nan; ramba_tpu keeps the zero's sign
    # (sign(-0.0) is -0.0, where numpy gives 0.0)
    return torch.where(torch.isnan(x) | (x == 0), x, s)


def _reciprocal(x):
    if x.is_floating_point() or x.is_complex():
        return torch.reciprocal(x)
    # integer reciprocal is C integer division 1/x; 1/0 is the dtype's
    # maximum, as in ramba_tpu (the integer ``// 0`` rule)
    zero = x == 0
    q = torch.div(torch.ones_like(x), torch.where(zero, torch.ones_like(x), x),
                  rounding_mode="trunc")
    return torch.where(zero, torch.full_like(x, torch.iinfo(x.dtype).max), q)


def _sqrt(x):
    """IEEE's correctly rounded square root.  torch's CPU kernel is not
    (with AVX-512 it misrounds about 0.7 % of float32 and float64
    inputs by one ulp); NumPy's is, as the card's ``sqrt`` is, so a CPU
    tensor of those dtypes takes NumPy's."""
    if x.device.type == "cpu" and x.dtype in (torch.float32, torch.float64):
        return torch.from_numpy(np.asarray(np.sqrt(x.numpy())))
    return torch.sqrt(x)


def _cbrt(x):
    # copysign keeps the sign of a zero: cbrt(-0.0) is -0.0
    return torch.copysign(torch.abs(x).pow(1.0 / 3.0), x)


def _heaviside(x, h):
    """jnp's ``where(x < 0, 0, where(x > 0, 1, h))``: ``heaviside(nan, h)``
    is ``h`` (NumPy gives NaN there)."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(x < 0, zero, torch.where(x > 0, zero + 1, h))


def _absolute(x):
    if x.is_complex():
        # XLA: a NaN part makes the modulus NaN (hypot would give inf
        # beside an infinite part)
        r = torch.abs(x)
        return torch.where(torch.isnan(x), torch.full_like(r, float("nan")), r)
    return x if x.dtype == torch.bool else torch.abs(x)


def _invert(x):
    return torch.logical_not(x) if x.dtype == torch.bool else torch.bitwise_not(x)


def _next_up_half(x):
    """``nextafter(x, inf)`` of float16 through its bit pattern (torch's
    CUDA nextafter has no half loop): +1 on the pattern of a non-negative
    value, -1 on a negative one, -0.0 to the smallest subnormal; inf and
    NaN stay."""
    b = x.view(torch.int16)
    up = torch.where(b >= 0, b + 1, b - 1)
    up = torch.where(b == -(1 << 15), torch.ones_like(b), up)
    return torch.where(torch.isnan(x) | (x == float("inf")), x,
                       up.view(torch.float16))


def _spacing(x):
    """jnp.spacing, as ``ramba_tpu`` gives it: the step to the next value
    away from zero, carrying the sign of ``x`` (``-0.0`` gives the negative
    smallest subnormal, where NumPy gives the positive one); NaN and +-inf
    give NaN.  float16 takes the step toward +inf (jnp's rule for it)."""
    if x.dtype == torch.float16:
        return _next_up_half(x) - x
    inf = torch.full((), float("inf"), dtype=x.dtype, device=x.device)
    r = torch.nextafter(x, torch.copysign(inf, x)) - x
    tiny = float(np.finfo(to_np_dtype(x.dtype)).smallest_subnormal)
    return torch.where(r == 0, torch.copysign(torch.full_like(x, tiny), x), r)


def _imag(x):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


def _real(x):
    return torch.real(x) if x.is_complex() else x


# -- complex values --------------------------------------------------------------
# ramba_tpu computes complex ops with jnp/XLA, whose rules differ from
# torch's: ordering is lexicographic (real parts, then imaginary parts where
# the real parts are equal; a comparison with a NaN part is false), sign is
# x/|x|, 0**0 is 1, rint rounds each part, and the few ufuncs NumPy has no
# complex loop for (arctan2, the degree conversions, logaddexp) still
# compute, by jnp's formulas.


def _complex_or(complex_fn, real_fn):
    """``complex_fn`` where the (first) operand is complex, ``real_fn``
    elsewhere."""
    def op(*args):
        return complex_fn(*args) if args[0].is_complex() else real_fn(*args)
    return op


def lex_compare(cmp, a, b):
    """``cmp`` (torch.lt, torch.le, torch.gt or torch.ge) of complex values
    in jnp's lexicographic order."""
    return torch.where(a.real == b.real, cmp(a.imag, b.imag),
                       cmp(a.real, b.real))


def _lex(cmp):
    return _complex_or(lambda a, b: lex_compare(cmp, a, b), cmp)


def _lex_select(cmp, skip_nan=False):
    """maximum/minimum of complex values: ``b`` unless ``a`` is strictly
    beyond it, as XLA selects; fmax/fmin (``skip_nan``) take ``a`` also
    where ``b`` has a NaN part."""
    def op(a, b):
        take_a = lex_compare(cmp, a, b)
        if skip_nan:
            take_a = take_a | torch.isnan(b)
        return torch.where(take_a, a, b)
    return op


def _complex_sign(x):
    a = torch.abs(x)
    return torch.where(x == 0, x, torch.complex(x.real / a, x.imag / a))


def _complex_rint(x):
    return torch.complex(torch.round(x.real), torch.round(x.imag))


def _complex_pow(x, y):
    """XLA's complex power, |x|**c * exp(-d arg x) * cis(c arg x +
    d ln|x|), for x = a+bi, y = c+di, with x**0 = 1."""
    a, b, c, d = x.real, x.imag, y.real, y.imag
    aa_bb = a * a + b * b
    arg = torch.atan2(b, a)
    coeff = torch.exp(-d * arg) * torch.pow(aa_bb, c * 0.5)
    q = d * torch.log(aa_bb) * 0.5 + c * arg
    out = torch.complex(coeff * torch.cos(q), coeff * torch.sin(q))
    # a real base of positive sign to a real power: the real pow
    real = (b == 0) & (a >= 0) & (d == 0)
    out = torch.where(real, torch.complex(torch.pow(a, c), torch.zeros_like(c)),
                      out)
    one = torch.ones((), dtype=out.dtype, device=out.device)
    return torch.where(y == 0, one, out)


def _partwise(fn):
    """add/subtract of complex values part by part, as XLA does (torch
    scales the second operand by a complex alpha of 1, which turns a NaN
    or infinite part into NaN in the other part too)."""
    return lambda a, b: torch.complex(fn(a.real, b.real), fn(a.imag, b.imag))


def _times(factor):
    """The degree conversions of complex values: jnp multiplies by the
    constant as a complex number."""
    return lambda x: x * torch.full((), complex(factor, 0.0), dtype=x.dtype,
                                    device=x.device)


def _wrap_between(x, a):
    rem = torch.fmod(x + a, 2 * a)
    rem = torch.where(rem < 0, rem + 2 * a, rem)
    return rem - a


def _complex_logaddexp(base2):
    """jnp's complex logaddexp/logaddexp2: ``amax + log1p(exp(x1 + x2 -
    2 amax))``, the imaginary part wrapped into [-pi, pi] (over ln 2 for
    base 2)."""
    def op(x1, x2):
        amax = _lex_select(torch.gt)(x1, x2)
        delta = (x1 + x2) - amax * 2
        if base2:
            out = amax + (1 / np.log(2)) * torch.log1p(torch.exp2(delta))
            period = np.pi / np.log(2)
        else:
            out = amax + torch.log1p(torch.exp(delta))
            period = np.pi
        return torch.complex(out.real, _wrap_between(out.imag, period))
    return op


def _complex_atan2(y, x):
    """XLA's complex atan2: -i log((x + iy) / sqrt(x**2 + y**2))."""
    iy = torch.complex(-y.imag, y.real)
    r = torch.log((x + iy) / torch.sqrt(x * x + y * y))
    return torch.complex(r.imag, -r.real)


UNARY: dict[str, Callable] = {
    "negative": torch.neg, "positive": lambda x: x,
    "absolute": _absolute, "abs": _absolute, "fabs": torch.abs,
    "sqrt": _sqrt, "square": torch.square, "cbrt": _cbrt,
    "reciprocal": _reciprocal, "sign": _sign,
    "exp": torch.exp, "exp2": torch.exp2, "expm1": torch.expm1,
    "log": torch.log, "log2": torch.log2, "log10": torch.log10,
    "log1p": torch.log1p, "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.asin, "arccos": torch.acos, "arctan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "arcsinh": torch.asinh, "arccosh": torch.acosh, "arctanh": torch.atanh,
    "floor": torch.floor, "ceil": torch.ceil, "trunc": torch.trunc,
    # round half to even, as rint; complex values part by part
    "rint": _complex_or(_complex_rint, torch.round),
    "isnan": torch.isnan, "isinf": torch.isinf, "isfinite": torch.isfinite,
    "logical_not": torch.logical_not, "invert": _invert,
    "conj": torch.conj_physical, "conjugate": torch.conj_physical,
    "real": _real, "imag": _imag,
    "degrees": _complex_or(_times(180 / np.pi), torch.rad2deg),
    "radians": _complex_or(_times(np.pi / 180), torch.deg2rad),
    "deg2rad": _complex_or(_times(np.pi / 180), torch.deg2rad),
    "rad2deg": _complex_or(_times(180 / np.pi), torch.rad2deg),
    "signbit": torch.signbit, "spacing": _spacing, "sinc": torch.sinc,
    "i0": torch.i0, "angle": torch.angle,
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
    "add": _complex_or(_partwise(torch.add), torch.add),
    "subtract": _complex_or(_partwise(torch.sub), torch.sub),
    "multiply": torch.mul,
    "true_divide": torch.true_divide, "divide": torch.true_divide,
    # floored division and modulo with numpy's signs (torch implements
    # numpy's npy_divmod for floats), zero quotients signed as in ramba_tpu;
    # integer x % 0 is 0 in both packages
    "floor_divide": _int_zero_safe(torch.floor_divide, floor_div_by_zero,
                                   _float_floor_divide),
    "mod": _int_zero_safe(torch.remainder, torch.zeros_like),
    "remainder": _int_zero_safe(torch.remainder, torch.zeros_like),
    "fmod": _int_zero_safe(torch.fmod, torch.zeros_like),
    "power": _complex_or(_complex_pow, torch.pow),
    "float_power": _complex_or(_complex_pow, torch.float_power),
    "arctan2": _complex_or(_complex_atan2, torch.atan2), "hypot": torch.hypot,
    # maximum/minimum propagate NaN, fmax/fmin ignore it: same in torch
    "maximum": _complex_or(_lex_select(torch.gt), torch.maximum),
    "minimum": _complex_or(_lex_select(torch.lt), torch.minimum),
    "fmax": _complex_or(_lex_select(torch.gt, True), torch.fmax),
    "fmin": _complex_or(_lex_select(torch.lt, True), torch.fmin),
    "logaddexp": _complex_or(_complex_logaddexp(False), torch.logaddexp),
    "logaddexp2": _complex_or(_complex_logaddexp(True), torch.logaddexp2),
    "logical_and": torch.logical_and, "logical_or": torch.logical_or,
    "logical_xor": torch.logical_xor,
    "bitwise_and": torch.bitwise_and, "bitwise_or": torch.bitwise_or,
    "bitwise_xor": torch.bitwise_xor,
    "left_shift": torch.bitwise_left_shift,
    "right_shift": torch.bitwise_right_shift,
    "equal": torch.eq, "not_equal": torch.ne, "less": _lex(torch.lt),
    "less_equal": _lex(torch.le), "greater": _lex(torch.gt),
    "greater_equal": _lex(torch.ge),
    "copysign": torch.copysign, "nextafter": torch.nextafter,
    "heaviside": _heaviside, "gcd": torch.gcd, "lcm": torch.lcm,
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


def _is_integer(tdt) -> bool:
    return not (tdt.is_floating_point or tdt.is_complex or tdt == torch.bool)


def convert(t: torch.Tensor, tdt: torch.dtype) -> torch.Tensor:
    """``t`` in dtype ``tdt``.  A float to an integer type saturates as
    ``ramba_tpu`` (XLA's convert) does: NaN gives 0, and values at or
    beyond the type's range give its maximum or minimum (128.5 to int8 is
    127); in range it truncates toward zero.  torch's own conversion
    wraps on the CPU, as C casts and NumPy do."""
    if t.dtype == tdt:
        return t
    if not (t.is_floating_point() and _is_integer(tdt)):
        return t.to(tdt)
    info = torch.iinfo(tdt)
    # both limits are powers of two, exact in every float type (bfloat16
    # and float16 round 2**63 to inf and compare right all the same)
    big = t >= float(info.max + 1)
    small = t <= float(info.min - 1) if info.min else t < 0
    nan = torch.isnan(t)
    # unsigned targets: -1 < t < 0 truncates to 0 through the zero fill
    out = _bits(torch.where(big | small | nan, torch.zeros_like(t), t).to(tdt))
    # the limits as the signed view's bit patterns (torch selects no
    # uint16/32/64 on the card)
    width = 8 * out.element_size()
    hi, lo = (v - (1 << width) if v >= 1 << (width - 1) else v
              for v in (info.max, info.min))
    out = torch.where(big, torch.full_like(out, hi), out)
    out = torch.where(small, torch.full_like(out, lo), out)
    return _unbits(out, tdt)


def wrap_int(v, tdt: torch.dtype):
    """A Python int in integer dtype ``tdt``, wrapped modulo 2**bits when it
    lies outside the type's range (``u8 + 300`` adds 44), as ``ramba_tpu``
    converts it.  Anything else passes unchanged."""
    if not (isinstance(v, int) and not isinstance(v, bool)
            and _is_integer(tdt)):
        return v
    info = torch.iinfo(tdt)
    if info.min <= v <= info.max:
        return v
    v &= (1 << info.bits) - 1
    return v - (1 << info.bits) if v > info.max else v


# comparison -> the same comparison with its operands swapped
_CMP_SWAP = {"less": "greater", "less_equal": "greater_equal",
             "greater": "less", "greater_equal": "less_equal",
             "equal": "equal", "not_equal": "not_equal"}


def int_compare_outside(fname: str, avals: Sequence[Aval], values):
    """NumPy compares an integer array with a Python int outside the
    array's dtype exactly (``u8 < 300`` is all True), where converting the
    int would wrap it.  Such a comparison is one constant for every element:
    returns it (a bool), or None when the comparison is an ordinary one.
    ``values`` holds each operand's Python value, or None for an array."""
    if fname not in _CMP_SWAP or len(avals) != 2:
        return None
    for k in (0, 1):
        v = values[k]
        if not (isinstance(v, int) and not isinstance(v, bool)
                and avals[k].weak):
            continue
        loop = loop_dtypes(fname, avals)
        if loop is None or loop[k].kind not in "iu":
            return None
        info = np.iinfo(loop[k])
        if info.min <= v <= info.max:
            return None
        # every element lies below v (v above the range) or above it
        op = fname if k == 1 else _CMP_SWAP[fname]  # array OP v
        above = v > info.max
        return {"less": above, "less_equal": above, "greater": not above,
                "greater_equal": not above, "equal": False,
                "not_equal": True}[op]
    return None


def as_tensor(v, dtype=None, dev=None) -> torch.Tensor:
    """A runtime value as a tensor of numpy ``dtype`` (default: its own).
    A Python int outside an integer dtype wraps (:func:`wrap_int`)."""
    if dtype is None:
        dtype = aval_of(v).dtype
    tdt = to_torch_dtype(dtype)
    if isinstance(v, torch.Tensor):
        return convert(v, tdt)
    if isinstance(v, np.generic):
        v = v.item()
    v = wrap_int(v, tdt)
    dev = common.device() if dev is None else dev
    if isinstance(v, float) and _is_integer(tdt):
        return convert(torch.full((), v, dtype=torch.float64, device=dev), tdt)
    # torch.full launches a fill kernel: no host-to-device copy, no sync
    return torch.full((), v, dtype=tdt, device=dev)


def apply_map(fname: str, args: Sequence) -> torch.Tensor:
    """Evaluate one numpy ufunc on runtime values with numpy's dtypes."""
    avals = [aval_of(a) for a in args]
    dev = _device_of(args)
    if fname == "positive" and avals[0].dtype == np.bool_:
        return as_tensor(args[0], dev=dev)  # ramba_tpu: unchanged
    const = int_compare_outside(
        fname, avals, [None if isinstance(a, torch.Tensor) else a for a in args])
    if const is not None:
        shape = np.broadcast_shapes(*[a.shape for a in avals])
        return torch.full(shape, const, dtype=torch.bool, device=dev)
    casts, out_dt = map_dtypes(fname, avals)
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
    so both lower ``x**2`` to one multiply).  Two cases never become a map:
    ``positive`` of bool is its operand, as in ``ramba_tpu`` (NumPy has no
    such loop), and a comparison of an integer array with a Python int
    outside its dtype is the constant NumPy gives (:func:`int_compare_outside`;
    ``ramba_tpu`` wraps the int first), on every path alike."""
    if fname == "positive" and len(operands) == 1 \
            and operands[0].dtype == np.bool_:
        return operands[0]
    const = int_compare_outside(
        fname, [o.aval for o in operands],
        [o.value if isinstance(o, Scalar) else None for o in operands])
    if const is not None:
        shape = tuple(np.broadcast_shapes(*[o.shape for o in operands]))
        return Node("full", (shape, "bool", None), [Scalar(const)])
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
    floats (each part of a complex value); integers with decimals >= 0
    are unchanged."""
    if x.is_complex():
        return torch.complex(round_half_even(x.real, decimals),
                             round_half_even(x.imag, decimals))
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
    c = _to_carrier(x)
    if fname in ("min", "max"):
        w = _WIDE_UNSIGNED[x.dtype]
        k = _ukey(c, w)
        r = _ukey(reduce_tensor(fname, k, tuple(dims), keepdims), w)
        return _from_carrier(r, x.dtype)
    r = reduce_tensor(fname, c, tuple(dims), keepdims)
    return _from_carrier(r, out_dt)


def reduce_tensor(fname, x: torch.Tensor, axis=None, keepdims=False,
                  ddof=None):
    """One reduction of ``REDFN`` over ``axis`` with ``ramba_tpu``'s result
    dtype (``reduce_dtype``) and its formulas: var/std centre on the mean
    and divide by ``N - ddof`` (NaN where that is not positive), the
    nan-kinds replace NaN by the identity, arg-reductions return the first
    NaN, the medians sort and average the two middle values."""
    out_dt = to_torch_dtype(reduce_dtype(fname, to_np_dtype(x.dtype)))
    dims = _dims(axis, x.ndim)
    if x.ndim == 0:
        dims = ()
    if not (x.is_floating_point() or x.is_complex()) and fname in NAN_PLAIN:
        fname = NAN_PLAIN[fname]  # nothing to ignore
    if (_is_wide_unsigned(x.dtype) and fname in ("min", "max")) or (
            _is_wide_unsigned(out_dt) and fname in ("sum", "prod")):
        # uint8 sums and products too: torch would promote them to int64
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
        if x.is_complex():
            return _complex_extreme(x, dims, keepdims, fname == "max")
        fn = torch.amin if fname == "min" else torch.amax
        return fn(x, dim=dims, keepdim=keepdims)
    if fname in ("any", "all"):
        y = x if x.dtype == torch.bool else x != 0
        fn = torch.any if fname == "any" else torch.all
        for d in sorted(dims, reverse=True):
            y = fn(y, dim=d, keepdim=keepdims)
        return y
    if fname in ("nansum", "nanprod"):
        fill = 0 if fname == "nansum" else 1
        y = torch.where(torch.isnan(x), torch.full_like(x, fill), x)
        return reduce_tensor(fname[3:], y, axis, keepdims)
    if fname in ("nanmin", "nanmax"):
        # jnp: NaN becomes the identity, an all-NaN slice gives NaN (a
        # complex value with a NaN part is NaN)
        inf = float("inf") if fname == "nanmin" else float("-inf")
        nan = torch.isnan(x)
        r = reduce_tensor(fname[3:], torch.where(nan, torch.full_like(x, inf), x),
                          axis, keepdims)
        allnan = reduce_tensor("all", nan, axis, keepdims)
        return torch.where(allnan, torch.full_like(r, float("nan")), r)
    if fname == "nanmean":
        nan = torch.isnan(x)
        s = reduce_tensor("nansum", x, axis, keepdims)
        cnt = reduce_tensor("sum", ~nan, axis, keepdims)
        return s / cnt.to(s.dtype)
    if fname in ("var", "std", "nanvar", "nanstd"):
        y = x if x.is_complex() else x.to(out_dt)
        r = _variance(y, dims, keepdims, int(ddof or 0),
                      fname.startswith("nan"))
        return _sqrt(r) if fname.endswith("std") else r
    if fname in _ARG_RED:
        return _arg_reduce(fname, x, axis, keepdims)
    if fname == "count_nonzero":
        y = _to_carrier(x) if _is_wide_unsigned(x.dtype) else x
        return reduce_tensor("sum", y != 0, axis, keepdims)
    if fname in ("median", "nanmedian"):
        return _median(x.to(out_dt), dims, keepdims, fname == "nanmedian")
    if fname == "ptp":
        return apply_map("subtract", [reduce_tensor("max", x, axis, keepdims),
                                      reduce_tensor("min", x, axis, keepdims)])
    raise NotImplementedError(f"reduction {fname!r} is not ported yet")


def _count(shape, dims) -> int:
    return int(np.prod([shape[d] for d in dims], dtype=np.int64))


def _variance(y, dims, keepdims, ddof, skip_nan):
    """``jnp.var``/``jnp.nanvar`` in the computation dtype of ``y``: the
    mean-centred sum of squares over ``N - ddof`` (NaN where that is not
    positive); ``nanvar`` counts and sums the non-NaN elements only."""
    def total(t, keep):
        return torch.sum(t, dim=dims, keepdim=keep) if dims else t.clone()

    if skip_nan:
        nan = torch.isnan(y)
        m = total(torch.where(nan, torch.zeros_like(y), y), True) / \
            total(~nan, True).to(y.dtype)
        c = torch.where(nan, torch.zeros_like(y), y - m)
        n = total((~nan).to(torch.int64), keepdims) - ddof
    else:
        m = torch.mean(y, dim=dims, keepdim=True) if dims else y
        c = y - m
        n = torch.full((), _count(tuple(y.shape), dims) - ddof,
                       dtype=torch.int64, device=y.device)
    # |c|**2 of a complex value: real(c * conj(c)), as jnp.var
    s = total(c.real * c.real + c.imag * c.imag if c.is_complex() else c * c,
              keepdims)
    bad = n <= 0
    s = torch.where(bad, torch.full_like(s, float("nan")), s)
    return s / torch.where(bad, torch.ones_like(n), n).to(s.dtype)


def _last_index(mask, n):
    """Per row of ``mask`` (reduced positions last): the last position
    that holds, -1 where none does."""
    iota = torch.arange(n, device=mask.device)
    return torch.amax(torch.where(mask, iota, -1), dim=-1, keepdim=True)


def _complex_extreme(x, dims, keepdims, want_max):
    """jnp.max/jnp.min of complex values.  XLA folds the slice in order,
    ``acc = acc if acc > v else v`` (lexicographic ``>``, ``<`` for min),
    so a NaN part decides the result by its position.  The fold's result
    in closed form: after the last element with a NaN real part (which
    every comparison adopts), the extreme real part wins; among its
    elements, after the last one with a NaN imaginary part, the extreme
    imaginary part; ties go to the last occurrence."""
    nd = x.ndim
    dims = sorted(dims)  # the fold runs over the reduced dims in C order
    keep = [d for d in range(nd) if d not in dims]
    z = x.permute(*keep, *dims).reshape(*[x.shape[d] for d in keep], -1)
    n = z.shape[-1]
    pos = torch.arange(n, device=x.device)
    ext = torch.amax if want_max else torch.amin
    far = float("-inf") if want_max else float("inf")

    def stage(parts, live):
        # within ``live``: after the last NaN of ``parts``, the extremes
        p = _last_index(live & torch.isnan(parts), n)
        after = live & (pos > p)
        best = ext(torch.where(after, parts, far), dim=-1, keepdim=True)
        return p, after & (parts == best)

    live = torch.ones_like(z.real, dtype=torch.bool)
    p_re, top = stage(z.real, live)
    p_im, top_im = stage(z.imag, top)
    pick = _last_index(top_im, n)
    # a NaN last in its stage is the result itself
    pick = torch.where(_last_index(top, n) == p_im, p_im, pick)
    pick = torch.where(pick < 0, p_re, pick)
    pick = torch.where(p_re == n - 1, p_re, pick)
    r = torch.gather(z, -1, pick.clamp(0, max(n - 1, 0)))[..., 0]
    if keepdims:
        return r.reshape([1 if d in dims else x.shape[d] for d in range(nd)])
    return r


def _arg_reduce(fname, x, axis, keepdims):
    """``jnp.argmin``/``argmax`` (the first extreme, the first NaN where
    one is present) and ``jnp.nanargmin``/``nanargmax`` (NaN replaced by
    the far infinity, -1 for an all-NaN slice)."""
    want_max = fname.endswith("max")
    y = x.reshape(-1) if axis is None else x
    dim = 0 if axis is None else axis
    if y.ndim == 0:
        r = torch.zeros((), dtype=torch.int64, device=x.device)
        return r.reshape((1,) * x.ndim) if keepdims else r
    if y.dtype == torch.bool:
        y = y.to(torch.int8)
    elif _is_wide_unsigned(y.dtype):
        y = _ukey(_to_carrier(y), _WIDE_UNSIGNED[y.dtype])
    fn = torch.argmax if want_max else torch.argmin
    if y.is_floating_point():
        nan = torch.isnan(y)
        far = float("-inf") if want_max else float("inf")
        r = fn(torch.where(nan, torch.full_like(y, far), y), dim=dim)
        if fname.startswith("nan"):
            r = torch.where(torch.all(nan, dim=dim), torch.full_like(r, -1), r)
        else:
            first_nan = torch.argmax(nan.to(torch.int8), dim=dim)
            r = torch.where(torch.any(nan, dim=dim), first_nan, r)
    else:
        r = fn(y, dim=dim)
    if keepdims:
        r = r.reshape((1,) * x.ndim) if axis is None else r.unsqueeze(dim)
    return r


# ---------------------------------------------------------------------------
# order statistics: the medians here, the quantiles in ops/extras.py, and
# across ranks core/rankselect.py all take their positions and their
# finish from these functions, so each path rounds alike by construction
# ---------------------------------------------------------------------------

_KEY_DTYPES = {torch.float16: torch.int16, torch.bfloat16: torch.int16,
               torch.float32: torch.int32, torch.float64: torch.int64}


def order_values(z: torch.Tensor, skip_nan: bool) -> torch.Tensor:
    """The values a median or quantile orders along the last dim: every
    NaN the one positive NaN (a nan kind skips them: they order last),
    or, for the plain kinds, every slice holding a NaN all NaN (as
    ``jnp.quantile`` squashes them)."""
    nan = torch.isnan(z)
    if not skip_nan:
        nan = torch.any(nan, dim=-1, keepdim=True)
    return torch.where(nan, torch.full((), float("nan"), dtype=z.dtype,
                                       device=z.device), z)


def order_key(v: torch.Tensor) -> torch.Tensor:
    """The order-preserving integer image of float values (the signed
    integer of their width): negative values' magnitude bits flipped,
    both zeros the key 0, every NaN the positive NaN's, the largest key.  ``jnp.sort``
    orders by these keys, equal keys in index order (it canonicalizes
    zeros and NaNs in its comparator), so a stable sort of them is its
    order, on the CPU and on the card alike."""
    kdt = _KEY_DTYPES[v.dtype]
    bits = v.view(kdt)
    flip = torch.iinfo(kdt).max
    key = torch.where(bits < 0, bits ^ flip, bits)
    key = torch.where(v == 0, torch.zeros((), dtype=kdt, device=v.device),
                      key)
    nan = torch.full((), float("nan"), dtype=v.dtype, device=v.device)
    return torch.where(torch.isnan(v), nan.view(kdt), key)


def key_value(key: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The float of an order key (:func:`order_key`'s inverse; the key 0
    is +0.0)."""
    flip = torch.iinfo(key.dtype).max
    return torch.where(key < 0, key ^ flip, key).view(dtype)


def sorted_values(z: torch.Tensor) -> torch.Tensor:
    """``z`` sorted along its last dim as ``jnp.sort`` sorts it: by
    :func:`order_key`, stably, so equal values (the two zeros) keep their
    index order."""
    idx = torch.sort(order_key(z), dim=-1, stable=True).indices
    return torch.gather(z, -1, idx)


def median_positions(n: int, cnt=None):
    """``(low, high)``: the positions of a median's two middle values in
    a slice of ``n`` sorted values, or of ``cnt`` non-NaN ones (a nan
    kind: a tensor of counts; an empty slice reads position 0)."""
    if cnt is None:
        return (n - 1) // 2, n // 2
    top = torch.clamp(cnt - 1, min=0)
    lo = torch.div(cnt - 1, 2, rounding_mode="floor")
    hi = cnt - 1 - lo
    lo = torch.minimum(torch.clamp(lo, min=0), top)
    hi = torch.minimum(torch.clamp(hi, min=0), top)
    return lo, hi


def median_finish(low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
    """The midpoint ``(low + high) * 0.5`` of a median's middle values,
    in their dtype."""
    half = torch.full((), 0.5, dtype=low.dtype, device=low.device)
    return (low + high) * half


def _median(y, dims, keepdims, skip_nan):
    """``jnp.median`` (a NaN anywhere in the slice gives NaN) and
    ``jnp.nanmedian``: order the reduced dims flattened last
    (:func:`order_values`, :func:`sorted_values`), then the midpoint of
    the two middle values (of the non-NaN ones for ``nanmedian``)."""
    nd = y.ndim
    keep = [d for d in range(nd) if d not in dims]
    out_shape = tuple(1 if d in dims else y.shape[d] for d in range(nd)) \
        if keepdims else tuple(y.shape[d] for d in keep)
    z = y.permute(*keep, *dims).reshape(*[y.shape[d] for d in keep], -1)
    n = z.shape[-1]
    if n == 0:
        return torch.full(out_shape, float("nan"), dtype=y.dtype, device=y.device)
    z = order_values(z, skip_nan)
    s = sorted_values(z)
    if skip_nan:
        lo, hi = median_positions(
            n, torch.sum(~torch.isnan(z), dim=-1, keepdim=True))
        low = torch.gather(s, -1, lo)[..., 0]
        high = torch.gather(s, -1, hi)[..., 0]
    else:
        lo, hi = median_positions(n)
        low, high = s[..., lo], s[..., hi]
    return median_finish(low, high).reshape(out_shape)


@defop("reduce")
def _op_reduce(static, x):
    fname, axis, keepdims, ddof = static
    return reduce_tensor(fname, as_tensor(x), axis, keepdims, ddof)


def _where_identity(fname, x):
    """The value a masked-out element takes in ``reduce_where`` (the
    dtype's extremes for min/max, as ramba_tpu's finfo/iinfo)."""
    if fname not in ("min", "max"):
        return _WHERE_IDENTITY[fname]
    if x.dtype == torch.bool:
        return fname == "min"
    # complex values: the real extremes, as jnp.finfo gives them
    info = np.finfo(to_np_dtype(x.dtype)) if x.is_complex() else \
        torch.finfo(x.dtype) if x.is_floating_point() else \
        np.iinfo(to_np_dtype(x.dtype))
    return info.max if fname == "min" else info.min


@defop("reduce_where")
def _op_reduce_where(static, x, mask):
    """Masked reduction: masked-out elements take the identity."""
    fname, axis, keepdims = static
    x, mask = as_tensor(x), as_tensor(mask)
    mask = mask if mask.dtype == torch.bool else mask != 0
    if fname == "mean":
        s = reduce_tensor("sum", torch.where(mask, x, torch.zeros_like(x)),
                          axis, keepdims)
        cnt = reduce_tensor("sum", mask.expand(x.shape), axis, keepdims)
        out_dt = s.dtype if s.is_floating_point() or s.is_complex() \
            else torch.float64
        return s.to(out_dt) / cnt.to(out_dt)
    ident = as_tensor(_where_identity(fname, x), to_np_dtype(x.dtype), x.device)
    return reduce_tensor(fname, torch.where(mask, x, ident), axis, keepdims)


@defop("cumulative")
def _op_cumulative(static, x):
    """cumsum/cumprod along one axis in the widened dtype.  Floats go
    through the fixed-order scan (``ops/scan.py``: the same bytes on every
    run; torch's own float scan on the card varies between calls).
    Integer scans stay on ``torch.cumsum``/``cumprod``: addition and
    multiplication modulo 2**64 give the same bits in any order."""
    from ramba_tpu_torch.ops import scan

    fname, axis = static
    x = as_tensor(x)
    out_dt = to_torch_dtype(cumulative_dtype(to_np_dtype(x.dtype)))
    if _is_wide_unsigned(out_dt):  # modulo 2**64 in the carrier
        c = torch.cumsum(_to_carrier(x), axis) if fname == "cumsum" \
            else torch.cumprod(_to_carrier(x), axis)
        return _from_carrier(c, out_dt)
    y = x if x.dtype == out_dt else x.to(out_dt)
    if y.dtype in scan.DTYPES:
        return scan.run(y, fname, axis)
    return torch.cumsum(y, axis) if fname == "cumsum" else torch.cumprod(y, axis)


@defop("broadcast_to")
def _op_broadcast_to(static, x):
    (shape,) = static
    return as_tensor(x).expand(tuple(shape)).contiguous()


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


# -- data movement -----------------------------------------------------------
# torch moves uint16/uint32/uint64 through few of its ops (no flip, tril,
# index_select or index_put on the CPU); data movement runs on a signed
# view of the same bits.

_SIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32,
                torch.uint64: torch.int64}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(_SIGNED_VIEW[t.dtype]) if t.dtype in _SIGNED_VIEW else t


def _unbits(t: torch.Tensor, tdt: torch.dtype) -> torch.Tensor:
    return t.view(tdt) if tdt in _SIGNED_VIEW else t


def _fill_value(tdt: torch.dtype):
    """``jnp.take(mode="fill")``'s default fill: NaN for inexact types, the
    minimum of signed integers, the maximum of unsigned ones, True; for
    uint16/32/64 as the bit pattern of their signed view (-1)."""
    if tdt == torch.bool:
        return True
    if tdt.is_floating_point or tdt.is_complex:
        return float("nan")
    if tdt in _SIGNED_VIEW:
        return -1
    return torch.iinfo(tdt).min if tdt.is_signed else torch.iinfo(tdt).max


def _aval_take(static, x, indices):
    axis, _mode = static
    return Aval(x.shape[:axis] + indices.shape + x.shape[axis + 1:],
                x.dtype, x.weak)


@defop("take", _aval_take)
def _op_take(static, x, indices):
    """``jnp.take`` along ``axis``: ``clip`` clamps every index into
    ``[0, n)`` (so -1 reads element 0), ``wrap`` takes it modulo n,
    ``fill`` reads negative indices from the end and gives the fill value
    (``_fill_value``) for any index still out of range."""
    axis, mode = static
    n = x.shape[axis]
    idx = as_tensor(indices, dev=x.device).long()
    if mode == "clip":
        idx = idx.clamp(0, max(n - 1, 0))
    elif mode == "wrap":
        idx = torch.remainder(idx, n)
    elif mode == "fill":
        idx = torch.where(idx < 0, idx + n, idx)
        bad = (idx < 0) | (idx >= n)
        idx = torch.where(bad, torch.zeros_like(idx), idx)
    else:
        raise NotImplementedError(f"take mode {mode!r}")
    out = _unbits(_bits(x)[(slice(None),) * axis + (idx,)], x.dtype)
    if mode == "fill":
        bad = bad.reshape((1,) * axis + tuple(bad.shape)
                          + (1,) * (x.ndim - axis - 1))
        ob = _bits(out)
        fill = torch.full((), _fill_value(x.dtype), dtype=ob.dtype,
                          device=x.device)
        out = _unbits(torch.where(bad, fill, ob), x.dtype)
    return out


@defop("permute")
def _op_permute(static, x):
    (axes,) = static
    return x.permute(*axes)


@defop("reshape")
def _op_reshape(static, x):
    (shape,) = static
    return x.reshape(shape)


# -- advanced and boolean indexing -------------------------------------------
# ``getitem_adv``/``setitem_adv`` take an index whose array positions
# (``arraypos``) hold placeholders in ``enc``; the index arrays follow the
# operand as arguments.  NumPy's rules place the result: integers count as
# arrays once any array is present, the arrays broadcast together, and the
# broadcast dims go where the arrays stand when those are adjacent in the
# index, else in front.  Out-of-range indices never reach a torch index
# call (a CUDA device assert would poison the context): a gather
# normalises negative indices and clamps, as XLA does; a scatter drops
# the write, through a scratch slot past the end of the flat operand.


class AdvPlan(NamedTuple):
    comps: tuple   # per index item: ("new",) | ("slice", dim, slice) |
                   # ("adv", dim, k) with k the array's position in arrays
    bshape: tuple  # the broadcast shape of the index arrays
    bpos: int      # where the broadcast dims stand in the result
    shape: tuple   # the result's shape


def adv_plan(shape, enc, arraypos, ishapes) -> AdvPlan:
    idx = decode_index(enc)
    comps, arrays, dim, k = [], [], 0, 0
    for p, it in enumerate(idx):
        if p in arraypos:
            comps.append(("adv", dim, k))
            arrays.append(tuple(ishapes[k]))
            k += 1
            dim += 1
        elif it is None:
            comps.append(("new",))
        elif it is Ellipsis:
            raise IndexError("expand the ellipsis before planning")
        elif isinstance(it, slice):
            comps.append(("slice", dim, it))
            dim += 1
        else:  # an integer among arrays is a 0-d index array
            comps.append(("adv", dim, None))
            arrays.append(())
            dim += 1
    if dim > len(shape):
        raise IndexError(f"too many indices for array: array is "
                         f"{len(shape)}-dimensional, but {dim} were indexed")
    comps += [("slice", d, slice(None)) for d in range(dim, len(shape))]
    try:
        bshape = tuple(np.broadcast_shapes(*arrays))
    except ValueError as e:
        raise IndexError(f"shape mismatch: indexing arrays could not be "
                         f"broadcast together with shapes {arrays}") from e
    where = [i for i, c in enumerate(comps) if c[0] == "adv"]
    adjacent = where == list(range(where[0], where[-1] + 1))
    rest = []
    bpos = 0
    for i, c in enumerate(comps):
        if c[0] == "new":
            rest.append(1)
        elif c[0] == "slice":
            rest.append(len(range(*c[2].indices(shape[c[1]]))))
        if adjacent and i < where[0] and c[0] != "adv":
            bpos = len(rest)
    out = tuple(rest[:bpos]) + bshape + tuple(rest[bpos:])
    return AdvPlan(tuple(comps), bshape, bpos, out)


def _index_tensors(plan, indexers, dev):
    """The index arrays in plan order as int64 tensors (the integers of
    the index among them as 0-d tensors)."""
    out = []
    for c in plan.comps:
        if c[0] != "adv":
            continue
        if c[2] is None:
            out.append(None)
            continue
        t = as_tensor(indexers[c[2]], dev=dev)
        if t.dtype == torch.bool or t.is_floating_point() or t.is_complex():
            raise IndexError("arrays used as indices must be of integer type")
        out.append(_index_long(t))
    return out


def _index_long(t: torch.Tensor) -> torch.Tensor:
    """An index tensor as int64 (uint64 by its bits)."""
    return t.view(torch.int64) if t.dtype == torch.uint64 else t.long()


def _plan_of(static, x, indexers):
    enc, arraypos = static
    return adv_plan(tuple(x.shape), enc, arraypos,
                    [tuple(aval_of(i).shape) for i in indexers])


def _aval_getitem_adv(static, x, *indexers):
    enc, arraypos = static
    plan = adv_plan(x.shape, enc, arraypos, [i.shape for i in indexers])
    return Aval(plan.shape, x.dtype, x.weak)


def _int_items(static):
    """The integers of the index, by plan order of the "adv" items."""
    enc, arraypos = static
    return [int(it[1]) for p, it in enumerate(enc)
            if p not in arraypos and it[0] == "i"]


@defop("getitem_adv", _aval_getitem_adv)
def _op_getitem_adv(static, x, *indexers):
    """Gather: basic slicing first (each adv dim kept whole), then one
    torch gather over the adv dims moved to the front."""
    plan = _plan_of(static, x, indexers)
    ints = iter(_int_items(static))
    basic, flips, adv_dims = [], [], []
    for c in plan.comps:
        if c[0] == "new":
            basic.append(None)
        elif c[0] == "adv":
            adv_dims.append(len(basic))
            basic.append(slice(None))
        else:
            start, stop, step = c[2].indices(x.shape[c[1]])
            r = range(start, stop, step)
            if step < 0 and len(r):
                basic.append(slice(r[-1], r[0] + 1, -step))
                flips.append(len(basic) - 1)
            else:
                basic.append(slice(start, stop, step) if len(r)
                             else slice(0, 0, 1))
    y = _bits(x)[tuple(basic)]
    if flips:
        y = torch.flip(y, flips)
    idx = []
    for c, t in zip([c for c in plan.comps if c[0] == "adv"],
                    _index_tensors(plan, indexers, x.device)):
        n = x.shape[c[1]]
        if t is None:
            t = torch.full((), next(ints), dtype=torch.int64, device=x.device)
        t = torch.where(t < 0, t + n, t).clamp(0, max(n - 1, 0))
        idx.append(t)
    rest = [d for d in range(y.ndim) if d not in adv_dims]
    r = y.permute(*adv_dims, *rest)[tuple(idx)]
    nb = len(plan.bshape)
    if plan.bpos:
        r = r.movedim(tuple(range(nb)), tuple(range(plan.bpos, plan.bpos + nb)))
    return _unbits(r.reshape(plan.shape), x.dtype)


def _aval_setitem_adv(static, x, v, *indexers):
    return Aval(x.shape, x.dtype, x.weak)


@defop("setitem_adv", _aval_setitem_adv)
def _op_setitem_adv(static, x, v, *indexers):
    """Scatter: every written element's flat position in ``x``, broadcast
    over the result's shape; a position whose index is out of range
    (after negative indices count from the end) goes to a scratch slot
    past the end, so the write is dropped, as XLA drops it.  Duplicate
    positions: one of the written values wins (XLA leaves the winner
    unspecified too)."""
    plan = _plan_of(static, x, indexers)
    ints = iter(_int_items(static))
    dev = x.device
    nd = len(plan.shape)
    nb = len(plan.bshape)
    strides = [int(np.prod(x.shape[d + 1:], dtype=np.int64))
               for d in range(x.ndim)]
    numel = x.numel()
    lin = torch.zeros((), dtype=torch.int64, device=dev)
    valid = torch.ones((), dtype=torch.bool, device=dev)
    tensors = iter(_index_tensors(plan, indexers, dev))
    pos = 0  # non-adv items so far: the broadcast dims stand at bpos
    for c in plan.comps:
        if c[0] == "new":
            pos += 1
            continue
        if c[0] == "adv":
            t = next(tensors)
            n = x.shape[c[1]]
            if t is None:
                t = torch.full((), next(ints), dtype=torch.int64, device=dev)
            t = torch.where(t < 0, t + n, t)
            t = t.reshape((1,) * (plan.bpos + nb - t.ndim) + tuple(t.shape)
                          + (1,) * (nd - plan.bpos - nb))
            valid = valid & (t >= 0) & (t < n)
            lin = lin + t * strides[c[1]]
            continue
        d = pos if pos < plan.bpos else pos + nb
        r = torch.arange(*c[2].indices(x.shape[c[1]]), device=dev)
        lin = lin + (r * strides[c[1]]).reshape(
            (1,) * d + (len(r),) + (1,) * (nd - d - 1))
        pos += 1
    lin = torch.where(valid, lin, torch.full_like(lin, numel))
    lin = lin.expand(plan.shape) if lin.ndim else lin.reshape((1,) * nd)
    vals = as_tensor(v, to_np_dtype(x.dtype), dev)
    while vals.ndim > nd and vals.shape[0] == 1:
        vals = vals[0]
    vals = vals.expand(plan.shape)
    flat = torch.empty(numel + 1, dtype=x.dtype, device=dev)
    fb = _bits(flat)
    fb[:numel] = _bits(x).reshape(-1)
    fb.index_put_((lin.reshape(-1),), _bits(vals.contiguous()).reshape(-1))
    return flat[:numel].reshape(x.shape)


def _aval_masked_fill(static, x, mask, v):
    shape = tuple(np.broadcast_shapes(x.shape, mask.shape, v.shape))
    return Aval(shape, x.dtype, x.weak)


@defop("masked_fill", _aval_masked_fill)
def _op_masked_fill(static, x, mask, v):
    """Boolean-mask write as a select: ``v`` (cast to ``x``'s dtype) where
    the mask holds, ``x`` elsewhere.  Nothing is compacted, so nothing
    waits on the mask's count."""
    x = as_tensor(x)
    mask = as_tensor(mask, dev=x.device)
    mask = mask if mask.dtype == torch.bool else mask != 0
    v = as_tensor(v, to_np_dtype(x.dtype), x.device)
    return _unbits(torch.where(mask, _bits(v), _bits(x)), x.dtype)


# -- structural ----------------------------------------------------------------


def _same_aval(static, x):
    return Aval(x.shape, x.dtype, x.weak)


@defop("flip", _same_aval)
def _op_flip(static, x):
    (axes,) = static
    return _unbits(torch.flip(_bits(x), list(axes)), x.dtype) if axes else x


def join_dtype(dtypes) -> np.dtype:
    """NumPy's common dtype of arrays that a join puts together (what
    ``ramba_tpu`` casts concatenate's and stack's operands to)."""
    return np.result_type(*[np.dtype(np.float16) if is_bf16(d) else d
                            for d in dtypes]) \
        if not all(is_bf16(d) for d in dtypes) else BF16


def _aval_concatenate(static, *xs):
    (axis,) = static
    nd = len(xs[0].shape)
    if any(len(a.shape) != nd for a in xs) or nd == 0:
        raise ValueError("all the input arrays must have same number of "
                         "dimensions (and at least one)")
    ax = axis % nd
    for a in xs:
        if any(a.shape[d] != xs[0].shape[d] for d in range(nd) if d != ax):
            raise ValueError("all the input array dimensions except for the "
                             "concatenation axis must match exactly")
    shape = list(xs[0].shape)
    shape[ax] = sum(a.shape[ax] for a in xs)
    return Aval(tuple(shape), join_dtype([a.dtype for a in xs]), False)


def _joined(xs):
    tdt = to_torch_dtype(join_dtype([to_np_dtype(t.dtype) for t in xs]))
    return [_bits(convert(as_tensor(t), tdt)) for t in xs], tdt


@defop("concatenate", _aval_concatenate)
def _op_concatenate(static, *xs):
    (axis,) = static
    ts, tdt = _joined(xs)
    return _unbits(torch.cat(ts, dim=axis % ts[0].ndim), tdt)


def _aval_stack(static, *xs):
    (axis,) = static
    if any(a.shape != xs[0].shape for a in xs):
        raise ValueError("all input arrays must have the same shape")
    nd = len(xs[0].shape) + 1
    if not -nd <= axis < nd:
        raise np.exceptions.AxisError(axis, nd)
    shape = list(xs[0].shape)
    shape.insert(axis % nd, len(xs))
    return Aval(tuple(shape), join_dtype([a.dtype for a in xs]), False)


@defop("stack", _aval_stack)
def _op_stack(static, *xs):
    (axis,) = static
    ts, tdt = _joined(xs)
    return _unbits(torch.stack(ts, dim=axis % (ts[0].ndim + 1)), tdt)


def _aval_pad(static, x, *consts):
    pad_width, _mode = static
    return Aval(tuple(s + lo + hi for s, (lo, hi) in zip(x.shape, pad_width)),
                x.dtype, x.weak)


def _pad_index(mode, n, lo, hi, dev):
    """Source positions of a padded axis for the index-based modes."""
    i = torch.arange(-lo, n + hi, device=dev)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return torch.remainder(i, n)
    if mode == "reflect":  # mirrored about the edge elements
        if n == 1:
            return torch.zeros_like(i)
        p = torch.remainder(i, 2 * (n - 1))
        return torch.where(p >= n, 2 * (n - 1) - p, p)
    if mode == "symmetric":  # mirrored with the edge elements repeated
        p = torch.remainder(i, 2 * n)
        return torch.where(p >= n, 2 * n - 1 - p, p)
    raise NotImplementedError(f"pad mode {mode!r}")


@defop("pad", _aval_pad)
def _op_pad(static, x, *consts):
    """``jnp.pad``: constant (the value cast to the dtype, as
    ``constant_values``), empty (zeros), edge, wrap, reflect and
    symmetric, one axis at a time."""
    pad_width, mode = static
    x = as_tensor(x)
    tdt = x.dtype
    y = _bits(x)
    for ax, (lo, hi) in enumerate(pad_width):
        if lo == 0 and hi == 0:
            continue
        if mode in ("constant", "empty"):
            c = consts[0] if consts and mode == "constant" else 0
            fill = _bits(as_tensor(c, to_np_dtype(tdt), x.device))
            parts = []
            for w in (lo, hi):
                shp = list(y.shape)
                shp[ax] = w
                parts.append(fill.expand(shp))
            y = torch.cat([parts[0], y, parts[1]], dim=ax)
        else:
            if y.shape[ax] == 0:
                raise ValueError(f"can't pad an empty axis in mode {mode!r}")
            y = torch.index_select(
                y, ax, _pad_index(mode, y.shape[ax], lo, hi, x.device))
    return _unbits(y, tdt)


def _aval_moveaxis(static, x):
    src, dst = static
    order = [d for d in range(len(x.shape)) if d != src % len(x.shape)]
    order.insert(dst % len(x.shape), src % len(x.shape))
    return Aval(tuple(x.shape[d] for d in order), x.dtype, x.weak)


@defop("moveaxis", _aval_moveaxis)
def _op_moveaxis(static, x):
    src, dst = static
    return torch.movedim(x, src, dst)


def _aval_repeat(static, x):
    repeats, axis = static
    shape = list(x.shape)
    shape[axis] *= repeats
    return Aval(tuple(shape), x.dtype, x.weak)


@defop("repeat", _aval_repeat)
def _op_repeat(static, x):
    repeats, axis = static
    return _unbits(torch.repeat_interleave(_bits(x), repeats, dim=axis),
                   x.dtype)


def _aval_tile(static, x):
    (reps,) = static
    nd = max(len(reps), len(x.shape))
    r = (1,) * (nd - len(reps)) + tuple(reps)
    s = (1,) * (nd - len(x.shape)) + tuple(x.shape)
    return Aval(tuple(a * b for a, b in zip(r, s)), x.dtype, x.weak)


@defop("tile", _aval_tile)
def _op_tile(static, x):
    (reps,) = static
    return _unbits(torch.tile(_bits(x), tuple(reps)), x.dtype)


def _aval_tri(static, x):
    if len(x.shape) < 2:
        raise ValueError("tril/triu: the array must be at least 2-D")
    return Aval(x.shape, x.dtype, x.weak)


@defop("tril", _aval_tri)
def _op_tril(static, x):
    (k,) = static
    return _unbits(torch.tril(_bits(x), k), x.dtype)


@defop("triu", _aval_tri)
def _op_triu(static, x):
    (k,) = static
    return _unbits(torch.triu(_bits(x), k), x.dtype)


def _aval_diag(static, x):
    (k,) = static
    if len(x.shape) == 1:
        n = x.shape[0] + abs(k)
        return Aval((n, n), x.dtype, x.weak)
    if len(x.shape) != 2:
        raise ValueError("Input must be 1- or 2-d.")
    r, c = x.shape
    return Aval((max(0, min(r + min(k, 0), c - max(k, 0))),), x.dtype, x.weak)


@defop("diag", _aval_diag)
def _op_diag(static, x):
    (k,) = static
    return _unbits(torch.diag(_bits(x), k), x.dtype)


def _aval_sort(static, x):
    (axis,) = static
    shape = (int(np.prod(x.shape, dtype=np.int64)),) if axis is None \
        else x.shape
    return Aval(shape, x.dtype, x.weak)


def _aval_argsort(static, x):
    return Aval(_aval_sort(static, x).shape, np.dtype(np.int64), False)


def sort_key(x: torch.Tensor) -> torch.Tensor:
    """A key whose stable torch order is ``jnp.sort``'s order of ``x``:
    every NaN (a negative one too) becomes the one NaN, which sorts last;
    bools sort as uint8; unsigned types by value through the int64
    carrier, uint64 with its sign bit flipped."""
    if x.is_floating_point():
        return torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
    if x.dtype == torch.bool:
        return x.to(torch.uint8)
    if _is_wide_unsigned(x.dtype):
        return _ukey(_to_carrier(x), _WIDE_UNSIGNED[x.dtype])
    return x


def _sort_operand(x, axis):
    x = as_tensor(x)
    return (x.reshape(-1), 0) if axis is None else (x, axis % max(x.ndim, 1))


def sort_order(x: torch.Tensor, ax: int) -> torch.Tensor:
    """The stable ascending order of ``x`` along ``ax`` as ``jnp.sort``
    gives it.  Complex values sort lexicographically (NaN parts last):
    a stable pass on the imaginary parts, then one on the real parts."""
    if not x.is_complex():
        return torch.sort(sort_key(x), dim=ax, stable=True).indices
    first = torch.sort(sort_key(x.imag), dim=ax, stable=True).indices
    re = torch.gather(x.real, ax, first)
    second = torch.sort(sort_key(re), dim=ax, stable=True).indices
    return torch.gather(first, ax, second)


@defop("sort", _aval_sort)
def _op_sort(static, x):
    """Stable ascending sort along ``axis`` (None: the flattened array),
    NaNs last; the values are gathered back through the order, so every
    value (-0.0 and 0.0 in their input order) keeps its bits."""
    (axis,) = static
    x, ax = _sort_operand(x, axis)
    if x.ndim == 0:
        return x.clone()
    return _unbits(torch.gather(_bits(x), ax, sort_order(x, ax)), x.dtype)


@defop("argsort", _aval_argsort)
def _op_argsort(static, x):
    (axis,) = static
    x, ax = _sort_operand(x, axis)
    if x.ndim == 0:
        return torch.zeros((), dtype=torch.int64, device=x.device)
    return sort_order(x, ax)


# -- linear algebra -------------------------------------------------------------
# ramba_tpu types these products by jnp's promotion lattice (int32 @ float32
# is float32, uint8 @ int8 is int16), not by NumPy's rules, and computes them
# outside any Pallas kernel: they stay on torch here.  Float products go to
# torch.matmul with TF32 off unless ``set_matmul_precision`` asks for it;
# integer and bool products run in int64, modulo 2**64 exactly as NumPy
# wraps, by a chunked broadcast multiply and sum (cuBLAS has no integer
# product; float64 would be inexact above 2**53).

_LATTICE = {
    "bool": ["i*"], "i*": ["uint8", "int8", "f*"], "f*": ["bfloat16",
    "float16", "c*"], "c*": ["complex64"],
    "uint8": ["uint16", "int16"], "uint16": ["uint32", "int32"],
    "uint32": ["uint64", "int64"], "uint64": ["f*"],
    "int8": ["int16"], "int16": ["int32"], "int32": ["int64"],
    "int64": ["f*"], "bfloat16": ["float32"], "float16": ["float32"],
    "float32": ["float64", "complex64"], "float64": ["complex128"],
    "complex64": ["complex128"], "complex128": [],
}
_WEAK_NODE = {"i": "i*", "u": "i*", "b": "bool", "f": "f*", "c": "c*"}
_WEAK_DEFAULT = {"i*": "int64", "f*": "float64", "c*": "complex128"}


@functools.lru_cache(maxsize=None)
def _upper(node: str) -> frozenset:
    out = {node}
    for nxt in _LATTICE[node]:
        out |= _upper(nxt)
    return frozenset(out)


def jnp_promote(avals) -> np.dtype:
    """``jnp``'s result dtype of operands under x64: the least upper bound
    in its promotion lattice; python scalars (weak avals) join as i*, f*
    or c*, and a weak result takes the 64-bit default."""
    nodes = []
    for a in avals:
        if a.weak:
            nodes.append(_WEAK_NODE[a.dtype.kind])
        else:
            nodes.append("bfloat16" if is_bf16(a.dtype) else a.dtype.name)
    common_ = functools.reduce(lambda u, n: u & _upper(n), nodes[1:],
                               _upper(nodes[0]))
    (lub,) = [n for n in common_ if _upper(n) == common_]
    lub = _WEAK_DEFAULT.get(lub, lub)
    return BF16 if lub == "bfloat16" else np.dtype(lub)


_TF32_NAMES = ("tensorfloat32", "high", "default", "fastest", "bfloat16")


def tf32_allowed(precision) -> bool:
    """Whether a float32 product may run in TF32: only where
    ``set_matmul_precision`` named a reduced precision."""
    return str(precision).lower().split(".")[-1] in _TF32_NAMES


_INT_CHUNK_BYTES = 1 << 28  # the broadcast product's temporary per chunk


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, M, K) @ (B, K, N) of int64, exact modulo 2**64 (the sum wraps):
    the K axis in chunks whose (B, M, k, N) product stays bounded."""
    B, M, K = a.shape
    N = b.shape[2]
    out = torch.zeros((B, M, N), dtype=torch.int64, device=a.device)
    kc = max(1, min(K, _INT_CHUNK_BYTES // max(1, 8 * B * M * N)))
    for k0 in range(0, K, kc):
        k1 = min(K, k0 + kc)
        out += (a[:, :, k0:k1, None] * b[:, None, k0:k1, :]).sum(2)
    return out


def _carried(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.uint64:
        return t.view(torch.int64)
    return t.to(torch.int64)


def _uncarried(c: torch.Tensor, tdt: torch.dtype) -> torch.Tensor:
    if tdt == torch.bool:
        return c != 0
    if tdt == torch.uint64:
        return c.view(torch.uint64)
    if tdt in _WIDE_UNSIGNED:
        return _from_carrier(c, tdt)
    return c.to(tdt)


@contextlib.contextmanager
def _tf32(precision):
    """torch's global TF32 flag for one float product, restored after."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32_allowed(precision)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def _bmm(a: torch.Tensor, b: torch.Tensor, precision) -> torch.Tensor:
    """Batched (B, M, K) @ (B, K, N) in the operands' common dtype."""
    if a.is_floating_point() or a.is_complex():
        with _tf32(precision):
            return torch.matmul(a, b)
    return _uncarried(_int_matmul(_carried(a), _carried(b)), a.dtype)


def _mul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """An elementwise product in the operands' common dtype (integers
    wrapping through the carrier, bools as ``and``)."""
    if x.dtype == torch.bool:
        return x & y
    if _is_integer(x.dtype):
        return _uncarried(_carried(x) * _carried(y), x.dtype)
    return x * y


def _to_common(args, dt):
    tdt = to_torch_dtype(dt)
    return [convert(as_tensor(t), tdt) for t in args]


def _matmul_shape(sa, sb):
    if not sa or not sb:
        raise ValueError("matmul: Input operand does not have enough "
                         "dimensions")
    a2 = (1,) + tuple(sa) if len(sa) == 1 else tuple(sa)
    b2 = tuple(sb) + (1,) if len(sb) == 1 else tuple(sb)
    if a2[-1] != b2[-2]:
        raise ValueError(f"matmul: mismatch in core dimension ({a2[-1]} vs "
                         f"{b2[-2]})")
    batch = tuple(np.broadcast_shapes(a2[:-2], b2[:-2]))
    out = batch + (a2[-2], b2[-1])
    if len(sa) == 1:
        out = out[:-2] + out[-1:]
    if len(sb) == 1:
        out = out[:-1]
    return out


def _aval_matmul(static, a, b):
    return Aval(_matmul_shape(a.shape, b.shape), jnp_promote([a, b]), False)


@defop("matmul", _aval_matmul)
def _op_matmul(static, a, b):
    """``numpy.matmul``: 1-D operands gain and lose a unit dim, batch dims
    broadcast."""
    (prec,) = static
    out_shape = _aval_matmul(static, aval_of(a), aval_of(b)).shape
    dt = jnp_promote([aval_of(a), aval_of(b)])
    a, b = _to_common([a, b], dt)
    a2 = a.reshape(1, -1) if a.ndim == 1 else a
    b2 = b.reshape(-1, 1) if b.ndim == 1 else b
    batch = tuple(np.broadcast_shapes(tuple(a2.shape[:-2]),
                                      tuple(b2.shape[:-2])))
    a3 = a2.expand(batch + tuple(a2.shape[-2:])).reshape(-1, *a2.shape[-2:])
    b3 = b2.expand(batch + tuple(b2.shape[-2:])).reshape(-1, *b2.shape[-2:])
    return _bmm(a3, b3, prec).reshape(out_shape)


def _tensordot_axes(axes, na, nb):
    if isinstance(axes, (int, np.integer)):
        k = int(axes)
        return tuple(range(na - k, na)), tuple(range(k))
    xa, xb = axes
    xa = (xa,) if isinstance(xa, (int, np.integer)) else tuple(xa)
    xb = (xb,) if isinstance(xb, (int, np.integer)) else tuple(xb)
    return tuple(int(d) % na for d in xa), tuple(int(d) % nb for d in xb)


def _aval_tensordot(static, a, b):
    axes, _prec = static
    xa, xb = _tensordot_axes(axes, len(a.shape), len(b.shape))
    if len(xa) != len(xb) or any(a.shape[i] != b.shape[j]
                                 for i, j in zip(xa, xb)):
        raise ValueError("shape-mismatch for sum")
    shape = tuple(s for d, s in enumerate(a.shape) if d not in xa) + \
        tuple(s for d, s in enumerate(b.shape) if d not in xb)
    return Aval(shape, jnp_promote([a, b]), False)


def tensordot_tensors(a, b, xa, xb, precision, out_dt):
    """Contract ``a``'s axes ``xa`` with ``b``'s ``xb`` through one
    (M, K) @ (K, N) product."""
    a, b = _to_common([a, b], out_dt)
    fa = [d for d in range(a.ndim) if d not in xa]
    fb = [d for d in range(b.ndim) if d not in xb]
    M = int(np.prod([a.shape[d] for d in fa], dtype=np.int64))
    N = int(np.prod([b.shape[d] for d in fb], dtype=np.int64))
    K = int(np.prod([a.shape[d] for d in xa], dtype=np.int64))
    a2 = a.permute(*fa, *xa).reshape(1, M, K)
    b2 = b.permute(*xb, *fb).reshape(1, K, N)
    out = _bmm(a2, b2, precision)
    return out.reshape([a.shape[d] for d in fa] + [b.shape[d] for d in fb])


@defop("tensordot", _aval_tensordot)
def _op_tensordot(static, a, b):
    axes, prec = static
    av = _aval_tensordot(static, aval_of(a), aval_of(b))
    xa, xb = _tensordot_axes(axes, len(aval_of(a).shape),
                             len(aval_of(b).shape))
    return tensordot_tensors(a, b, xa, xb, prec, av.dtype)


def _dot_axes(na, nb):
    if na == 0 or nb == 0:
        return None
    return (na - 1,), ((nb - 2,) if nb >= 2 else (0,))


def _aval_dot(static, a, b):
    (prec,) = static
    axes = _dot_axes(len(a.shape), len(b.shape))
    if axes is None:
        return Aval(tuple(np.broadcast_shapes(a.shape, b.shape)),
                    jnp_promote([a, b]), False)
    return _aval_tensordot((axes, prec), a, b)


@defop("dot", _aval_dot)
def _op_dot(static, a, b):
    """``numpy.dot``: a product for 0-d operands, else the contraction of
    ``a``'s last axis with ``b``'s second to last (its only one, 1-D)."""
    (prec,) = static
    av = _aval_dot(static, aval_of(a), aval_of(b))
    axes = _dot_axes(len(aval_of(a).shape), len(aval_of(b).shape))
    if axes is None:
        return _mul(*_to_common([a, b], av.dtype))
    return tensordot_tensors(a, b, axes[0], axes[1], prec, av.dtype)


def einsum_spec(subscripts, shapes):
    """(operand letter lists, output letters, letter sizes) of an einsum,
    with each ``...`` spelled out as capital letters."""
    sub = subscripts.replace(" ", "")
    lhs, arrow, rhs = sub.partition("->")
    terms = lhs.split(",")
    if len(terms) != len(shapes):
        raise ValueError("einsum: more operands than subscripts, or fewer")
    ell_nd = 0
    for t, s in zip(terms, shapes):
        if "..." in t:
            ell_nd = max(ell_nd, len(s) - (len(t) - 3))
    ell = [chr(ord("A") + i) for i in range(ell_nd)]
    ops, sizes = [], {}
    for t, s in zip(terms, shapes):
        if "..." in t:
            k = len(s) - (len(t) - 3)
            pre, post = t.split("...")
            letters = list(pre) + ell[ell_nd - k:] + list(post)
        else:
            letters = list(t)
        if len(letters) != len(s):
            raise ValueError(f"einsum: operand {t!r} has {len(s)} dims")
        for c, n in zip(letters, s):
            if c in sizes and n not in (1, sizes[c]) and sizes[c] != 1:
                raise ValueError(f"einsum: size of label {c!r} differs")
            if c not in sizes or sizes[c] == 1:
                sizes[c] = n
        ops.append(letters)
    if arrow:
        out = []
        for part in rhs.split("..."):
            out.append(list(part))
        out = out[0] + (ell + out[1] if len(out) > 1 else [])
    else:
        once = sorted(c for c in sizes if c.islower()
                      and sum(o.count(c) for o in ops) == 1)
        out = ell + once
    return ops, out, sizes


def _aval_einsum(static, *xs):
    subscripts, _prec = static
    _ops, out, sizes = einsum_spec(subscripts, [x.shape for x in xs])
    return Aval(tuple(sizes[c] for c in out), jnp_promote(list(xs)), False)


@defop("einsum", _aval_einsum)
def _op_einsum(static, *xs):
    subscripts, prec = static
    av = _aval_einsum(static, *[aval_of(x) for x in xs])
    ts = _to_common(xs, av.dtype)
    if ts[0].is_floating_point() or ts[0].is_complex():
        with _tf32(prec):
            return torch.einsum(subscripts, *ts)
    # integers: every operand laid out over all the labels, multiplied
    # and summed over the labels the output drops (int64, wrapping)
    ops, out, sizes = einsum_spec(subscripts, [tuple(t.shape) for t in ts])
    labels = out + sorted(c for c in sizes if c not in out)
    acc = None
    for letters, t in zip(ops, ts):
        c, uniq = _carried(t), []
        for ch in letters:
            if ch in uniq:  # a repeated label reads the diagonal
                j = uniq.index(ch)
                c = torch.diagonal(c, dim1=j, dim2=len(uniq)).movedim(-1, j)
            else:
                uniq.append(ch)
        order = sorted(uniq, key=labels.index)
        c = c.permute(*[uniq.index(ch) for ch in order])
        c = c.reshape([c.shape[order.index(ch)] if ch in order else 1
                       for ch in labels])
        acc = c if acc is None else acc * c
    acc = acc.expand([sizes[ch] for ch in labels])
    if len(labels) > len(out):
        acc = acc.sum(dim=tuple(range(len(out), len(labels))))
    return _uncarried(acc, ts[0].dtype)


def _aval_outer(static, a, b):
    n = int(np.prod(a.shape, dtype=np.int64))
    m = int(np.prod(b.shape, dtype=np.int64))
    return Aval((n, m), jnp_promote([a, b]), False)


@defop("outer", _aval_outer)
def _op_outer(static, a, b):
    x, y = _to_common([a, b], jnp_promote([aval_of(a), aval_of(b)]))
    return _mul(x.reshape(-1, 1), y.reshape(1, -1))


def _aval_trace(static, a):
    offset, axis1, axis2 = static
    nd = len(a.shape)
    if nd < 2:
        raise ValueError("diag requires an array of at least two dimensions")
    a1, a2 = axis1 % nd, axis2 % nd
    rest = tuple(s for d, s in enumerate(a.shape) if d not in (a1, a2))
    return Aval(rest, reduce_dtype("sum", a.dtype), False)


@defop("trace", _aval_trace)
def _op_trace(static, a):
    """``jnp.trace``: the sum along the ``offset`` diagonal of ``axis1`` and
    ``axis2``, in the sum's dtype (integers widen to 64 bits)."""
    offset, axis1, axis2 = static
    a = as_tensor(a)
    nd = a.ndim
    d = torch.diagonal(_bits(a) if a.dtype in _SIGNED_VIEW else a,
                       offset=offset, dim1=axis1 % nd, dim2=axis2 % nd)
    d = _unbits(d, a.dtype)
    return reduce_tensor("sum", d, d.ndim - 1, False)


# -- creation ----------------------------------------------------------------


@defop("arange")
def _op_arange(static, start, step):
    n, dtype, _spec = static
    return _arange_values(start, step, 0, n, dtype)


def _arange_values(start, step, lo, m, dtype):
    """Elements ``[lo, lo + m)`` of ``start + step * iota(dtype)``: the
    same bytes whether built whole or one block at a time."""
    tdt = to_torch_dtype(dtype)
    ints = all(isinstance(v, (int, np.integer)) and not isinstance(v, bool)
               for v in (start, step))
    if ints and np.dtype(dtype).kind in "iu":
        # exact in integers: one pass instead of iota, multiply and add
        start, step = int(start) + int(step) * lo, int(step)
        return torch.arange(start, start + step * m, step, dtype=tdt,
                            device=common.device())[:m]
    iota = torch.arange(lo, lo + m, dtype=tdt, device=common.device())
    return apply_map("add", [start, apply_map("multiply", [step, iota])])


def _arange_block_aval(static, start, step):
    _lo, m, dtype = static
    _c, out = map_dtypes("add", [start, Aval((m,), np.dtype(dtype))])
    _c, out = map_dtypes("add", [step, Aval((m,), out)])
    return Aval((m,), out, False)


@defop("arange_block", _arange_block_aval)
def _op_arange_block(static, start, step):
    """One rank's block of an ``arange`` (``core/rankflush.py``)."""
    lo, m, dtype = static
    return _arange_values(start, step, lo, m, dtype)


@defop("linspace")
def _op_linspace(static, start, stop):
    num, endpoint, dtype, _spec = static
    return _linspace_values(start, stop, num, endpoint, dtype, 0, num)


def _linspace_values(start, stop, num, endpoint, dtype, lo, m):
    """Elements ``[lo, lo + m)`` of ``jnp.linspace`` (jax 0.9's
    ``_linspace``), not NumPy's formula: in the computation dtype
    (``dtype`` if inexact, else float32, or float64 for 64-bit integers)
    ``start * (1 - t) + stop * t`` with ``t = iota / div`` in its real
    dtype (XLA's CPU compiler turns ``iota / div`` into ``iota * (1 /
    div)``, and the port computes that), ``stop`` itself at the endpoint,
    then ``floor`` for integer dtypes.  So ``linspace(0, 1, 7, dtype=float32)[5]`` is 0.8333333730697632,
    as in ramba_tpu, where NumPy gives 0.8333333134651184."""
    dt = np.dtype(dtype)
    if dt.kind in "fc" or is_bf16(dt):
        comp = dt
    else:
        comp = np.dtype(np.float64 if dt.itemsize == 8 and dt.kind in "iu"
                        else np.float32)
    ctd = to_torch_dtype(comp)
    rtd = torch.empty((), dtype=ctd).real.dtype if comp.kind == "c" else ctd
    dev = common.device()
    s = torch.tensor(start, dtype=ctd, device=dev)
    e = torch.tensor(stop, dtype=ctd, device=dev)
    div = (num - 1) if endpoint else num
    if num > 1:
        i = torch.arange(lo, lo + m, dtype=torch.int64, device=dev)
        # XLA folds the division by the constant ``div`` into a product
        # with its reciprocal, rounded in the real dtype: so does the port
        inv = torch.tensor(1.0, dtype=rtd) / torch.tensor(div, dtype=rtd)
        t = (i.to(rtd) * inv.to(dev)).to(ctd)
        one = torch.ones((), dtype=ctd, device=dev)
        out = s * (one - t) + e * t
        if endpoint:
            out = torch.where(i == num - 1, e, out)
    else:
        out = s.expand(m).clone()
    if dt.kind in "iu":
        out = torch.floor(out)
    return out.to(to_torch_dtype(dt))


@defop("linspace_block", lambda static, start, stop: Aval(
    (static[4],), np.dtype(static[2]), False))
def _op_linspace_block(static, start, stop):
    """One rank's block of a ``linspace`` (``core/rankflush.py``)."""
    num, endpoint, dtype, lo, m = static
    return _linspace_values(start, stop, num, endpoint, dtype, lo, m)


@defop("full")
def _op_full(static, fill):
    shape, dtype, _spec = static
    if isinstance(fill, torch.Tensor):
        return fill.to(to_torch_dtype(dtype)).expand(tuple(shape)).clone()
    if isinstance(fill, np.generic):
        fill = fill.item()
    tdt = to_torch_dtype(dtype)
    return torch.full(tuple(shape), wrap_int(fill, tdt), dtype=tdt,
                      device=common.device())


def _aval_fromfunction(static):
    shape, dtype, fn = static
    if dtype is None:
        # the filler's own dtype, from one call on one-element index planes
        from ramba_tpu_torch.skeletons import fromfunction_values

        dtype = to_np_dtype(fromfunction_values(
            fn, (1,) * len(shape), None, "cpu", count=False).dtype)
    return Aval(tuple(shape), np.dtype(dtype), False)


@defop("fromfunction_block", lambda static: Aval(
    tuple(static[0]), np.dtype(static[1]), False))
def _op_fromfunction_block(static):
    """One rank's block of a ``fromfunction``: the filler over the global
    index planes of the block (``core/rankflush.py``)."""
    from ramba_tpu_torch.skeletons import fromfunction_values

    shape, dtype, fn, starts = static
    return fromfunction_values(fn, shape, dtype, common.device(),
                               starts=starts)


@defop("fromfunction", _aval_fromfunction)
def _op_fromfunction(static):
    """Index-space filler: ``fn`` over int32 index planes through the
    skeletons' kernel route (NumPy ufuncs rerouted, data branches lowered
    to ``where``)."""
    from ramba_tpu_torch.skeletons import fromfunction_values

    shape, dtype, fn = static
    return fromfunction_values(fn, shape, dtype, common.device())


# -- layouts -------------------------------------------------------------------


@defop("shard_hint", lambda static, x: x)
def _op_shard_hint(static, x):
    """``static`` is ``(NamedSharding,)``: the layout a flush gives the
    value.  It computes nothing: the flush stamps the layout on a root,
    and across ranks an operand leaf of another layout is resharded
    before the program runs (``core/rankflush.py``)."""
    return x


# -- random draws --------------------------------------------------------------


def _aval_random(static, key, *params):
    kind, shape, dtype, _spec = static
    shape = tuple(shape)
    if kind in ("choice", "choice_norepl"):
        shape += tuple(params[0].shape[1:])  # rows of an n-d population
    return Aval(shape, np.dtype(dtype), False)


def _rows(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``arr[idx]`` along axis 0 (uint16/32/64 through their signed view:
    torch gathers none of them on the card)."""
    return _unbits(_bits(arr)[idx], arr.dtype)


@defop("random", _aval_random)
def _op_random(static, key, *params):
    """One draw, a pure function of its key: a generator on the process
    device is seeded from the key on every execution (never the global
    generator), so re-running the program gives the same bytes.  The key
    is a 0-d int64 leaf on the host (no device sync to read it) and stays
    out of ``static``, so a new seed reuses the compiled program.
    ``static`` is ``ramba_tpu``'s ``(kind, shape, dtype, spec)``; ``spec``
    places nothing on one card."""
    kind, shape, dtype, _spec = static
    shape = tuple(shape)
    dev = common.device()
    tdt = to_torch_dtype(dtype)
    g = torch.Generator(device=dev)
    g.manual_seed(int(key))

    def full(v, dt=torch.float64):
        return torch.full(shape, float(v), dtype=dt, device=dev)

    if kind == "uniform":
        return torch.rand(shape, generator=g, dtype=tdt, device=dev)
    if kind == "normal":
        return torch.randn(shape, generator=g, dtype=tdt, device=dev)
    if kind == "uniform_range":
        lo, hi = params
        u = torch.rand(shape, generator=g, dtype=tdt, device=dev)
        # jax.random.uniform: lo + (hi - lo) * u, held at or above lo
        return torch.clamp_min(u * (hi - lo) + lo, lo)
    if kind == "randint":
        lo, hi = params
        return torch.randint(int(lo), int(hi), shape, generator=g, dtype=tdt,
                             device=dev)
    if kind == "permutation":
        return torch.randperm(shape[0], generator=g, dtype=torch.int64,
                              device=dev).to(tdt)
    if kind == "permutation_array":
        (arr,) = params
        return _rows(arr, torch.randperm(arr.shape[0], generator=g,
                                         device=dev))
    if kind == "exponential":
        return torch.empty(shape, dtype=tdt, device=dev).exponential_(
            generator=g)
    if kind == "poisson":
        (lam,) = params
        return torch.poisson(full(lam), generator=g).to(tdt)
    if kind == "gamma":
        (a,) = params
        return torch._standard_gamma(full(a, tdt), generator=g)
    if kind == "beta":
        # a ratio of gammas, as jax.random.beta draws it
        a, b = params
        x = torch._standard_gamma(full(a, tdt), generator=g)
        y = torch._standard_gamma(full(b, tdt), generator=g)
        return x / (x + y)
    if kind == "binomial":
        n, p = params
        return torch.binomial(full(n), full(p), generator=g).to(tdt)
    if kind in ("choice", "choice_norepl"):
        arr, *p = params
        k = math.prod(shape)
        m = arr.shape[0]
        if k == 0:
            idx = torch.zeros(0, dtype=torch.int64, device=dev)
        elif p:
            idx = torch.multinomial(p[0].to(torch.float64), k,
                                    replacement=kind == "choice", generator=g)
        elif kind == "choice":
            idx = torch.randint(0, m, (k,), generator=g, device=dev)
        else:
            idx = torch.randperm(m, generator=g, device=dev)[:k]
        return _rows(arr, idx).reshape(shape + tuple(arr.shape[1:]))
    raise ValueError(kind)
