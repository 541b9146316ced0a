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
from ramba_tpu_torch.core import expr as E

DTYPES = ["bool", "int32", "int64", "float32", "float64", "complex64",
          "complex128"]
WEAK = {"weak_int": 3, "weak_float": 2.5, "weak_bool": True}
RTOL = {"float16": 1e-3, "float32": 1e-6, "float64": 1e-12, "complex64": 1e-6,
        "complex128": 1e-12}
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
    if dtype.startswith("complex"):
        v = v + 1j * (rs.rand(N) * 4 - 2)
    return v.astype(dtype)


def _pair(**arrays):
    """Both packages' arrays on identical inputs."""
    ref = {k: rtj.fromarray(v) for k, v in arrays.items()}
    port = convert.state_from_reference({k: a.asarray() for k, a in ref.items()})
    return ref, port


def _same(got, want, what="", rtol=None):
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype, f"{what}: port {g.dtype} vs ramba_tpu {w.dtype}"
    assert g.shape == w.shape, what
    if w.dtype.kind in "biu":
        np.testing.assert_array_equal(g, w, err_msg=what)
    else:
        r = rtol or RTOL[w.dtype.name]
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


# -- integer division by zero ------------------------------------------------
# ramba_tpu's x // 0 (XLA's division by zero, then jnp's floor correction)
# and x % 0; the expected values come from ramba_tpu, never from a table.

DIV0_DTYPES = ["int8", "int32", "int64", "uint8", "uint32"]


def _div0_data(dtype):
    hi = 250 if dtype.startswith("u") else 100
    a = np.array([7, 0, 3, 0, hi, 5, 0, 9], dtype)
    if dtype[0] == "i":
        a[[1, 4]] = [-7, -hi]
    b = np.array([0, 0, 2, 5, 0, 0, 3, 4], dtype)
    return a, b


@pytest.mark.parametrize("layout", ["1d", "2d"])
@pytest.mark.parametrize("divisor", ["array", "python_zero"])
@pytest.mark.parametrize("dtype", DIV0_DTYPES)
def test_integer_floor_divide_by_zero(dtype, divisor, layout):
    """1-D int32/int64 programs are the ones the elemred classifier takes
    (on the CPU its wrapper runs the plain version); 2-D ones and the other
    dtypes run the generic lowering."""
    from ramba_tpu_torch.core import fuser
    from ramba_tpu_torch.ops import kernel_backend as kb

    a, b = _div0_data(dtype)
    if layout == "2d":
        a, b = a.reshape(2, 4), b.reshape(2, 4)
    ref, port = _pair(a=a, b=b)
    rb, pb = (ref["b"], port["b"]) if divisor == "array" else (0, 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = [ref["a"] // rb, ref["a"] % rb]
    got = [port["a"] // pb, port["a"] % pb]
    elem = layout == "1d" and dtype in ("int32", "int64")
    for g in got:
        p, vals = fuser.prepare_program([g.read_expr()])
        assert kb.classify(p, vals) == ("elemred" if elem else None)
    _same(got[0], want[0], f"{dtype} // 0")
    _same(got[1], want[1], f"{dtype} % 0")


@pytest.mark.parametrize("layout", ["1d", "2d"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_float_floor_divide_signed_zeros(dtype, layout):
    """``-0.0 // 2.0`` is 0.0 and ``-0.0 // -2.0`` is -0.0 in ramba_tpu
    (NumPy gives the opposite signs); every quotient's sign bit is compared
    as well as its value.  Dividends are zeros of both signs and normal
    values (no subnormals: XLA on the CPU flushes them to zero), divisors
    of both signs.  1-D programs are the ones the elemred classifier takes
    (on the CPU its wrapper runs the plain version); 2-D ones run the
    generic lowering."""
    from ramba_tpu_torch.core import fuser
    from ramba_tpu_torch.ops import kernel_backend as kb

    a = np.array([-0.0, 0.0, 1.5, -1.5, 3.0, -3.0, 0.25, -7.0] * 2, dtype)
    b = np.array([2.0] * 8 + [-2.0] * 8, dtype)
    if layout == "2d":
        a, b = a.reshape(4, 4), b.reshape(4, 4)
    ref, port = _pair(a=a, b=b)
    pairs = [(port["a"] // port["b"], ref["a"] // ref["b"]),
             (port["a"] // 2.0, ref["a"] // 2.0),
             (port["a"] // -2.0, ref["a"] // -2.0)]
    for g, _w in pairs:  # before any flush materialises them
        p, vals = fuser.prepare_program([g.read_expr()])
        assert kb.classify(p, vals) == ("elemred" if layout == "1d" else None)
    for k, (g, w) in enumerate(pairs):
        _same(g, w, f"{dtype} floor_divide case {k}")
        np.testing.assert_array_equal(np.signbit(np.asarray(g)),
                                      np.signbit(np.asarray(w)),
                                      err_msg=f"{dtype} sign bits, case {k}")
    assert np.asarray(pairs[0][0]).ravel()[0] == 0.0
    assert not np.signbit(np.asarray(pairs[0][0]).ravel()[0])


# -- unsigned integers wider than 8 bits ---------------------------------------
# every ufunc of the port's UNARY/BINARY tables with a NumPy loop for the
# dtype, and the whole-array reductions, against ramba_tpu.  One ramba_tpu
# flush per dtype computes every op's reference (``_unsigned_refs``).

UNSIGNED = ["uint16", "uint32", "uint64"]
REDUCTIONS = ["sum", "prod", "min", "max", "mean", "any", "all"]
# operands kept small: jnp's integer power reads 6 exponent bits, and
# ldexp's exponent is a float in jnp
SMALL_RHS = {"power", "ldexp", "float_power"}


def _unsigned_data(dtype):
    mx = int(np.iinfo(dtype).max)
    a = np.array([0, 1, 2, 3, 7, 100, mx, mx - 1, mx // 2 + 1, mx // 3, 5, 12],
                 dtype)
    b = np.array([0, 3, 1, 2, 0, 7, 2, mx, 3, mx // 2 + 3, 5, 9], dtype)
    return a, b


def _unsigned_ops(dtype):
    a, b = _unsigned_data(dtype)
    ops = [f for f in sorted(E.UNARY)
           if _numpy_has_loop(getattr(np, f, None) or _no_loop, a)]
    ops += [f for f in sorted(E.BINARY)
            if _numpy_has_loop(getattr(np, f, None) or _no_loop, a, b)]
    return ops + ["reduce_" + r for r in REDUCTIONS]


def _no_loop(*args):
    raise TypeError


def _apply(m, op, x, y, ys):
    if op.startswith("reduce_"):
        return getattr(m, op[len("reduce_"):])(x)
    fn = getattr(m, op)
    if op in E.UNARY:
        return fn(x)
    return fn(x, ys if op in SMALL_RHS else y)


_unsigned_cache: dict = {}


def _unsigned_refs(dtype):
    """ramba_tpu's result of every op on the dtype's data, in one flush."""
    if dtype not in _unsigned_cache:
        a, b = _unsigned_data(dtype)
        x, y, ys = (rtj.fromarray(v) for v in (a, b, b % 13))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            lazy = {op: _apply(rtj, op, x, y, ys) for op in _unsigned_ops(dtype)}
            _unsigned_cache[dtype] = {k: np.asarray(v) for k, v in lazy.items()}
    return _unsigned_cache[dtype]


UNSIGNED_CASES = [(d, op) for d in UNSIGNED for op in _unsigned_ops(d)]


@pytest.mark.parametrize("dtype,op", UNSIGNED_CASES,
                         ids=[f"{d}-{op}" for d, op in UNSIGNED_CASES])
def test_unsigned_op(dtype, op):
    want = _unsigned_refs(dtype)[op]
    a, b = _unsigned_data(dtype)
    port = convert.state_from_reference({"a": a, "b": b, "bs": b % 13})
    got = _apply(rt, op, port["a"], port["b"], port["bs"])
    # float32 results (uint16's float loops) at arguments up to 65535:
    # XLA's float32 exp2 is 18 ulp off at 2**100, so rtol 1e-5 there
    _same(got, want, f"{op}({dtype})",
          rtol=1e-5 if np.asarray(want).dtype == np.float32 else None)


CAST_SOURCES = np.array([128.5, -129.5, np.nan, np.inf, -np.inf, 1e30, -1e30,
                         2.0 ** 63, -2.0 ** 63, 2.0 ** 64, 1.7, -1.7, 255.9,
                         -0.5, 0.0, 65504.0, -65504.0, 3e9, -3e9])


@pytest.mark.parametrize("src", ["float16", "float32", "float64"])
@pytest.mark.parametrize("dst", ["int8", "int16", "int32", "int64", "uint8",
                                 "uint16", "uint32", "uint64", "bool"])
def test_float_to_int_casts_saturate(src, dst):
    """NaN gives 0, values at or past the range its maximum or minimum
    (``astype(int8)`` of 128.5 is 127), as XLA's convert in ramba_tpu;
    NumPy and torch wrap instead."""
    with np.errstate(over="ignore", invalid="ignore"):
        x = CAST_SOURCES.astype(src)
    ref, port = _pair(x=x)
    got = port["x"].astype(dst)
    want = ref["x"].astype(dst)
    g, w = np.asarray(got.asarray()), np.asarray(want.asarray())
    assert g.dtype == w.dtype == np.dtype(dst)
    np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", ["int8", "uint8", "int32"])
def test_inplace_float_add_into_ints_saturates(dtype):
    """``a += 1.5`` on an integer array casts the float result back as
    ramba_tpu does (NumPy would refuse: same_kind)."""
    info = np.iinfo(dtype)
    x = np.array([info.max - 1, info.min + 1, 5, 0], dtype)
    ref, port = _pair(x=x)
    for arr in (ref["x"], port["x"]):
        arr += 10.5
    g, w = port["x"].asarray(), ref["x"].asarray()
    assert g.dtype == w.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(g, w)
    ref, port = _pair(x=x)
    for arr in (ref["x"], port["x"]):
        arr[1:3] = -1e10
    np.testing.assert_array_equal(port["x"].asarray(), ref["x"].asarray())


@pytest.mark.parametrize("dtype", ["float16", "float32", "float64"])
def test_sign_keeps_signed_zeros(dtype):
    """``sign(-0.0)`` is -0.0 in ramba_tpu (NumPy gives 0.0): compared by
    sign bit, which ``assert_array_equal`` does not see."""
    x = np.array([-0.0, 0.0, -2.5, 3.0, np.nan, -np.inf], dtype)
    ref, port = _pair(x=x)
    g = np.asarray(rt.sign(port["x"]).asarray())
    w = np.asarray(rtj.sign(ref["x"]).asarray())
    assert g.dtype == w.dtype
    np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(np.signbit(g), np.signbit(w))
    assert np.signbit(g[0]) and not np.signbit(g[1])
