"""The port's dtype rules against ramba_tpu's x64 regime.

The port never takes a dtype from torch's promotion: every map follows
NumPy's loop dtypes with python scalars weakly typed (NEP 50), the rule
table ramba_tpu enforces under x64.  Each case runs the same inputs (made
with numpy from a seed, carried across with ``convert.state_from_reference``)
through both packages and requires the dtypes to be exactly equal.

Tolerances: integers and bools exact; float64 rtol=atol=1e-12, float32
rtol=atol=1e-6 and float16 (NumPy's loop for some bool operands)
rtol=atol=1e-3: XLA's and torch's math libraries differ by a few ulps.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from ramba_tpu_torch import common, convert

DTYPES = ["bool", "int32", "int64", "float32", "float64"]
WEAK = {"weak_int": 3, "weak_float": 2.5, "weak_bool": True}
RTOL = {"float16": 1e-3, "float32": 1e-6, "float64": 1e-12}
N = 16


@pytest.fixture(autouse=True)
def _port_on_cpu():
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    # one thread: the tier-1 run shares the CPU among its workers, and
    # timing-sensitive tests of other files run beside these
    torch.set_num_threads(1)


def _data(dtype, seed, positive=False):
    rs = np.random.RandomState(seed)
    if dtype == "bool":
        # a divisor must not be zero: integer x // 0 is 0 in NumPy, -1 in XLA
        return np.ones(N, bool) if positive else rs.rand(N) > 0.5
    if dtype in ("int32", "int64"):
        lo = 1 if positive else -5
        v = rs.randint(lo, 6, N)
        v[v == 0] = 1  # no integer division by zero
        return v.astype(dtype)
    v = rs.rand(N) * 4 + 0.25
    if not positive:
        v = v * rs.choice([-1, 1], N)
    return v.astype(dtype)


def _pair(**arrays):
    """Both packages' arrays on identical inputs."""
    ref = {k: rtj.fromarray(v) for k, v in arrays.items()}
    port = convert.state_from_reference({k: a.asarray() for k, a in ref.items()})
    return ref, port


def _same(got, want, what=""):
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype, f"{what}: port {g.dtype} vs ramba_tpu {w.dtype}"
    assert g.shape == w.shape, what
    if w.dtype.kind in "biu":
        np.testing.assert_array_equal(g, w, err_msg=what)
    else:
        r = RTOL[w.dtype.name]
        np.testing.assert_allclose(g, w, rtol=r, atol=r, err_msg=what)


def _numpy_has_loop(fn, *args):
    try:
        with warnings.catch_warnings(), np.errstate(all="ignore"):
            warnings.simplefilter("ignore")
            fn(*args)
        return True
    except (TypeError, ValueError):
        return False


BINARY = ["add", "subtract", "multiply", "true_divide", "floor_divide", "mod",
          "power", "maximum", "minimum", "fmax", "less", "equal",
          "logical_and", "arctan2", "hypot", "copysign"]


@pytest.mark.parametrize("rhs", DTYPES + list(WEAK))
@pytest.mark.parametrize("lhs", DTYPES)
def test_binary_dtype_sweep(lhs, rhs):
    a = _data(lhs, 1)
    b = WEAK[rhs] if rhs in WEAK else _data(rhs, 2, positive=True)
    ref, port = _pair(a=a, **({} if rhs in WEAK else {"b": b}))
    rb = b if rhs in WEAK else ref["b"]
    pb = b if rhs in WEAK else port["b"]
    names = [f for f in BINARY if _numpy_has_loop(getattr(np, f), a, b)]
    if rhs in WEAK and lhs == "bool":
        names = [f for f in names if f != "power"]  # jnp: bool ** 3 is int8
    assert names
    got = [getattr(rt, f)(port["a"], pb) for f in names]
    want = [getattr(rtj, f)(ref["a"], rb) for f in names]
    for f, g, w in zip(names, got, want):
        _same(g, w, f"{f}({lhs}, {rhs})")


@pytest.mark.parametrize("lhs", DTYPES)
def test_operators_and_reversed_scalars(lhs):
    a = _data(lhs, 3, positive=True)
    ref, port = _pair(a=a)
    x, y = ref["a"], port["a"]
    cases = [
        ("a * 2", lambda v: v * 2), ("2.5 - a", lambda v: 2.5 - v),
        ("a / 2", lambda v: v / 2), ("1 + a", lambda v: 1 + v),
        ("-a", lambda v: -v if lhs != "bool" else ~v),
        ("a ** 2", lambda v: v ** 2 if lhs != "bool" else v),
        ("a > 1", lambda v: v > 1), ("a == 2.0", lambda v: v == 2.0),
    ]
    for what, fn in cases:
        _same(fn(y), fn(x), f"{what} on {lhs}")


UNARY = ["negative", "absolute", "sqrt", "exp", "log", "sin", "cos", "tanh",
         "floor", "ceil", "trunc", "rint", "sign", "isnan", "isfinite",
         "logical_not", "square", "expm1", "log1p", "arctan"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_unary_dtype_sweep(dtype):
    a = _data(dtype, 4, positive=True)
    ref, port = _pair(a=a)
    names = [f for f in UNARY if _numpy_has_loop(getattr(np, f), a)]
    got = [getattr(rt, f)(port["a"]) for f in names]
    want = [getattr(rtj, f)(ref["a"]) for f in names]
    for f, g, w in zip(names, got, want):
        _same(g, w, f"{f}({dtype})")


@pytest.mark.parametrize("src", DTYPES)
def test_cast_sweep(src):
    a = _data(src, 5, positive=True)
    ref, port = _pair(a=a)
    for dst in DTYPES:
        _same(port["a"].astype(dst), ref["a"].astype(dst), f"{src}->{dst}")


@pytest.mark.parametrize("dtype", ["int32", "int64", "float32", "float64"])
def test_round_half_even(dtype):
    a = (np.arange(-8, 8) * 0.5 + 0.25 * (dtype[0] == "f"))
    a = np.concatenate([a, [2.5, -2.5, 3.5, 0.125]]).astype(dtype)
    ref, port = _pair(a=a)
    for d in (0, 1, 2):
        _same(rt.round(port["a"], d), rtj.round(ref["a"], d),
              f"round({dtype}, {d})")


@pytest.mark.parametrize("dtype", DTYPES)
def test_reduce_dtype_sweep(dtype):
    a = _data(dtype, 6, positive=True)[:7]
    ref, port = _pair(a=a)
    for f in ("sum", "prod", "min", "max", "mean", "any", "all"):
        _same(getattr(rt, f)(port["a"]), getattr(rtj, f)(ref["a"]),
              f"{f}({dtype})")


def test_reduce_axis_and_where():
    a = np.random.RandomState(7).rand(4, 6)
    ref, port = _pair(a=a)
    _same(rt.sum(port["a"], axis=0), rtj.sum(ref["a"], axis=0), "sum axis0")
    _same(rt.max(port["a"], axis=1, keepdims=True),
          rtj.max(ref["a"], axis=1, keepdims=True), "max axis1 keepdims")
    _same(rt.mean(port["a"], axis=(0, 1)), rtj.mean(ref["a"], axis=(0, 1)),
          "mean axes")
    _same(rt.where(port["a"] > 0.5, port["a"], 0),
          rtj.where(ref["a"] > 0.5, ref["a"], 0), "where")


def test_creation_dtypes():
    for mk in (lambda m: m.arange(10), lambda m: m.arange(10) / 1000.0,
               lambda m: m.arange(0.5, 4.0, 0.5), lambda m: m.zeros((3, 2)),
               lambda m: m.ones(4, dtype=np.int32), lambda m: m.full(3, 2.5),
               lambda m: m.full(3, True), lambda m: m.linspace(0, 1, 7),
               lambda m: m.arange(10, dtype=np.float32) * 2):
        _same(mk(rt), mk(rtj))


def test_torch_promotion_is_not_used():
    # two places torch's own promotion differs from NumPy's
    ref, port = _pair(i=np.array([1, 2], np.int64))
    _same(port["i"] / 2, ref["i"] / 2, "int / int")
    assert (port["i"] / 2).dtype == np.float64
    assert (port["i"] * 1.5).dtype == np.float64


def test_getitem_setitem_basic():
    a = np.arange(30, dtype=np.float64).reshape(5, 6)
    ref, port = _pair(a=a)
    for idx in [(slice(1, -1), slice(1, -1)), (2,), (slice(None, None, -1),),
                (Ellipsis, 3), (None, slice(0, 4, 2))]:
        _same(port["a"][idx], ref["a"][idx], repr(idx))
    port["a"][1:3, ::2] = -1.0
    ref["a"][1:3, ::2] = -1.0
    _same(port["a"], ref["a"], "setitem")
