"""Faults C.8-C.13 of the port's queue C, each held against ramba_tpu (x64
regime) where ramba_tpu computes, and against the rule the port chose where
it does not.

* C.8: a flush that raises takes its roots out of the pending registry
  (``fuser.stats["quarantined"]``, ``resilience.flush_quarantined``), so an
  unrelated array still flushes, and a read of the failed array runs its
  graph again alone and raises its own error again.  Checked for every op
  the port knows to raise at run time: a failed allocation, a
  ``fromfunction`` whose function raises, a ``scumulative`` kernel that
  raises.
* C.9: a Python int outside an integer array's dtype wraps modulo the
  dtype in arithmetic, ``clip``, ``maximum``/``minimum``, ``where`` and
  ``full``, as ramba_tpu converts it; comparisons are exact, as NumPy
  computes them (ramba_tpu wraps there too: a divergence kept on purpose).
* C.10: ``cbrt(-0.0)`` is -0.0 (sign bits compared).
* C.11: integer ``reciprocal(0)`` is the dtype's maximum (bool: int8 127).
* C.12: ``heaviside(nan, h)`` is ``h`` (NumPy gives NaN).
* C.13: ``positive`` of bool returns the values unchanged, as ramba_tpu.
* C.14: ``sqrt`` of a CPU float32/float64 array is correctly rounded, as
  NumPy's, ramba_tpu's and the card's are (torch's CPU kernel misrounds
  about 0.7 % of inputs by one ulp with AVX-512); so is the root ``std``
  takes of its variance.

Tolerances: every comparison here is exact (integers, bools, sign bits).
"""

import numpy as np
import pytest
import torch

import jax
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from ramba_tpu_torch import common
from ramba_tpu_torch.core import fuser
from ramba_tpu_torch.observe import registry


@pytest.fixture(autouse=True)
def _port_on_cpu():
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    torch.set_num_threads(1)


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got) if got.dtype.kind == "f"
                                  else got, np.isnan(want)
                                  if want.dtype.kind == "f" else want)
    if got.dtype.kind == "f":
        ok = ~np.isnan(want)
        np.testing.assert_array_equal(got[ok], want[ok])
        np.testing.assert_array_equal(np.signbit(got[ok]),
                                      np.signbit(want[ok]))


# -- C.8 ------------------------------------------------------------------


def _boom(*_):
    raise ZeroDivisionError("boom")


RUNTIME_FAILURES = {
    "allocation": lambda: rt.zeros(2 ** 42),
    "fromfunction": lambda: rt.fromfunction(_boom, (4,), dtype=float),
    "scumulative": lambda: rt.scumulative(_boom, lambda c, b: c + b,
                                          rt.arange(4.0), associative=False),
}


@pytest.mark.parametrize("op", sorted(RUNTIME_FAILURES))
def test_failed_flush_does_not_poison_later_flushes(op):
    q0 = fuser.stats["quarantined"]
    r0 = registry.counters["resilience.flush_quarantined"]
    a = RUNTIME_FAILURES[op]()
    with pytest.raises(Exception):
        rt.sync()
    assert fuser.stats["quarantined"] == q0 + 1
    assert registry.counters["resilience.flush_quarantined"] == r0 + 1
    # an unrelated array flushes
    np.testing.assert_array_equal((rt.arange(4) * 2).asarray(), [0, 2, 4, 6])
    # the failed one raises again when read: the error still reaches the
    # caller, nothing falls back
    with pytest.raises(Exception):
        a.asarray()
    np.testing.assert_array_equal((rt.arange(3) + 1).asarray(), [1, 2, 3])


def test_allocation_probe_of_the_roadmap():
    a = rt.zeros(2 ** 42)
    with pytest.raises(RuntimeError):
        (rt.arange(4) * 2).asarray()  # flushes a too, which fails
    np.testing.assert_array_equal((rt.arange(4) * 2).asarray(), [0, 2, 4, 6])
    with pytest.raises(RuntimeError):
        a.asarray()


def test_co_pending_innocent_array_gets_its_value():
    b = rt.arange(5.0) + 1.0
    a = rt.zeros(2 ** 42)
    with pytest.raises(RuntimeError):
        rt.sync()
    np.testing.assert_array_equal(b.asarray(), np.arange(5.0) + 1.0)
    del a


def test_dependent_of_a_failed_array_fails_too():
    a = rt.fromfunction(_boom, (4,), dtype=float)
    b = a + 1.0
    with pytest.raises(ZeroDivisionError):
        b.asarray()
    with pytest.raises(ZeroDivisionError):
        a.asarray()
    np.testing.assert_array_equal(rt.ones(2).asarray(), [1.0, 1.0])


# -- C.9 ------------------------------------------------------------------

U8 = np.array([5, 3, 0, 100, 255], np.uint8)
I8 = np.array([5, -3, 0, 100, -128], np.int8)
I32 = np.array([5, -3, 0, 100, 2 ** 31 - 1], np.int32)

WRAPS = {
    "u8+300": (U8, lambda m, x: x + 300),
    "300+u8": (U8, lambda m, x: 300 + x),
    "u8-300": (U8, lambda m, x: x - 300),
    "i8*200": (I8, lambda m, x: x * 200),
    "i32+2**40": (I32, lambda m, x: x + 2 ** 40),
    "i32*-2**35": (I32, lambda m, x: x * -(2 ** 35)),
    "clip": (U8, lambda m, x: m.clip(x, 2, 300)),
    "maximum": (U8, lambda m, x: m.maximum(x, 1000)),
    "minimum": (I8, lambda m, x: m.minimum(x, -1000)),
    "where": (U8, lambda m, x: m.where(x > 3, x, 300)),
    "u8//256": (U8, lambda m, x: x // 256),
    "u8+(-1)": (U8, lambda m, x: x + (-1)),
    "i8&300": (I8, lambda m, x: x & 300),
}


@pytest.mark.parametrize("case", sorted(WRAPS))
def test_out_of_range_python_int_wraps_as_reference(case):
    x, f = WRAPS[case]
    want = f(rtj, rtj.fromarray(x)).asarray()
    _same(f(rt, rt.fromarray(x)).asarray(), want)


COMPARES = {
    "u8<300": (U8, lambda x: x < 300),
    "u8<=300": (U8, lambda x: x <= 300),
    "u8>300": (U8, lambda x: x > 300),
    "u8>=-1": (U8, lambda x: x >= -1),
    "u8==300": (U8, lambda x: x == 300),
    "u8!=300": (U8, lambda x: x != 300),
    "300>u8": (U8, lambda x: 300 > x),
    "-1<u8": (U8, lambda x: -1 < x),
    "i8<-129": (I8, lambda x: x < -129),
    "i32>2**40": (I32, lambda x: x > 2 ** 40),
    "i64<2**70": (I32.astype(np.int64), lambda x: x < 2 ** 70),
    "u64>-1": (U8.astype(np.uint64), lambda x: x > -1),
}


@pytest.mark.parametrize("case", sorted(COMPARES))
def test_out_of_range_comparison_is_exact_as_numpy(case):
    x, f = COMPARES[case]
    _same(f(rt.fromarray(x)).asarray(), f(x))


def test_in_range_comparison_unchanged():
    _same((rt.fromarray(U8) < 100).asarray(), U8 < 100)
    _same((rt.fromarray(U8) == 255).asarray(), U8 == 255)


def test_wide_unsigned_and_full_keep_their_rules():
    u64 = np.array([5, 3, 0, 100], np.uint64)
    # u64 + 2**63 is in range: NumPy's answer (ramba_tpu raises there)
    _same((rt.fromarray(u64) + 2 ** 63).asarray(), u64 + np.uint64(2 ** 63))
    _same(rt.full(3, 300, dtype=np.uint8).asarray(),
          rtj.full(3, 300, dtype=np.uint8).asarray())
    a = rt.zeros(3, dtype=np.int8)
    a[1] = 200
    _same(a.asarray(), np.array([0, -56, 0], np.int8))


def test_skeleton_kernels_follow_the_same_rule():
    x = rt.fromarray(U8)
    _same(rt.smap(lambda v: v + 300, x).asarray(),
          rtj.smap(lambda v: v + 300, rtj.fromarray(U8)).asarray())
    _same(rt.smap(lambda v: v < 300, x).asarray(), U8 < 300)


# -- C.10 - C.13 ----------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float16", "float32", "float64"])
def test_cbrt_keeps_the_sign_of_zero(dtype):
    x = np.array([-0.0, 0.0, -8.0, 27.0, np.nan, -np.inf, np.inf, -0.125],
                 dtype)
    want = rtj.cbrt(rtj.fromarray(x)).asarray()
    got = rt.cbrt(rt.fromarray(x)).asarray()
    _same(got, want)
    assert np.signbit(got[0])


@pytest.mark.parametrize("dtype", ["int8", "int16", "int32", "int64", "uint8",
                                   "uint16", "uint32", "uint64", "bool"])
def test_integer_reciprocal_of_zero_is_the_maximum(dtype):
    if dtype == "bool":
        x = np.array([False, True, True, False])
    elif np.dtype(dtype).kind == "u":
        x = np.array([0, 1, 2, 7], dtype)
    else:
        x = np.array([0, 1, 2, -1], dtype)
    want = rtj.reciprocal(rtj.fromarray(x)).asarray()
    _same(rt.reciprocal(rt.fromarray(x)).asarray(), want)


@pytest.mark.parametrize("dtype", ["float16", "float32", "float64"])
def test_heaviside_of_nan_is_h(dtype):
    x = np.array([np.nan, -1.0, -0.0, 0.0, 2.0, np.inf], dtype)
    h = np.array([0.5, 0.5, 0.25, 0.75, 0.5, 0.5], dtype)
    for hh in (h, 0.25):
        ref_h = rtj.fromarray(hh) if isinstance(hh, np.ndarray) else hh
        port_h = rt.fromarray(hh) if isinstance(hh, np.ndarray) else hh
        want = rtj.heaviside(rtj.fromarray(x), ref_h).asarray()
        _same(rt.heaviside(rt.fromarray(x), port_h).asarray(), want)
    assert rt.heaviside(rt.fromarray(x), 0.25).asarray()[0] == 0.25


def test_positive_of_bool_returns_it_unchanged():
    b = np.array([True, False, True])
    want = rtj.positive(rtj.fromarray(b)).asarray()
    _same(rt.positive(rt.fromarray(b)).asarray(), want)
    _same((+rt.fromarray(b)).asarray(), b)
    _same(np.positive(rt.fromarray(b)).asarray(), b)
    _same(rt.smap(lambda v: np.positive(v), rt.fromarray(b)).asarray(), b)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sqrt_is_correctly_rounded(dtype):
    x = (np.abs(np.random.default_rng(14).standard_normal(20000)) * 1e3
         ).astype(dtype)
    got = rt.sqrt(rt.fromarray(x)).asarray()
    want = np.sqrt(x)
    assert got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()
    assert got.tobytes() == np.asarray(rtj.sqrt(rtj.fromarray(x))).tobytes()
    m = x.reshape(100, 200)
    sd = rt.std(rt.fromarray(m), axis=1).asarray()
    var = rt.var(rt.fromarray(m), axis=1).asarray()
    assert sd.tobytes() == np.sqrt(var).tobytes()


# -- C.15 -----------------------------------------------------------------
#
# A reduction with no identity over an empty extent raises at the call,
# with NumPy's class and message (ramba_tpu raises jnp's ValueError there
# too, with jnp's wording); ``initial=`` gives NumPy's answer, where
# ramba_tpu raises (held against NumPy).

NO_IDENTITY = ["min", "max", "amin", "amax", "nanmin", "nanmax", "ptp",
               "argmin", "argmax", "nanargmin", "nanargmax"]
EMPTY = [((0,), None), ((3, 0), 1), ((0, 4), 0), ((2, 0, 3), (0, 1))]


def _numpy_error(fn):
    try:
        fn()
    except Exception as e:  # the class and message the port must give
        return e
    raise AssertionError("NumPy did not raise")


@pytest.mark.parametrize("shape,axis", EMPTY)
@pytest.mark.parametrize("op", NO_IDENTITY)
def test_empty_reduction_raises_numpys_error_at_the_call(op, shape, axis):
    if op in ("argmin", "argmax", "nanargmin", "nanargmax") and \
            isinstance(axis, tuple):
        axis = axis[1]  # one axis: the empty one
    x = np.zeros(shape)
    want = _numpy_error(lambda: getattr(np, op)(x, axis=axis))
    a = rt.array(x)
    with pytest.raises(type(want)) as got:
        getattr(rt, op)(a, axis=axis)  # no flush: the call raises
    assert str(got.value) == str(want)
    rjerr = _numpy_error(lambda: getattr(rtj, op)(rtj.array(x), axis=axis))
    assert isinstance(rjerr, type(want))
    if op in ("min", "max", "argmin", "argmax"):
        with pytest.raises(type(want)) as got:
            getattr(a, op)(axis=axis)
        assert str(got.value) == str(want)


def test_a_nonempty_reduced_axis_of_an_empty_array_is_fine():
    x = np.zeros((3, 0))
    for op in ("min", "max", "argmax", "nanmin"):
        _same(getattr(rt, op)(rt.array(x), axis=0).asarray(),
              getattr(np, op)(x, axis=0))


@pytest.mark.parametrize("dtype", ["float64", "int64", "int32", "float32"])
@pytest.mark.parametrize("op", ["min", "max", "amin", "amax", "nanmin",
                                "nanmax"])
def test_empty_reduction_with_initial_is_numpys_value(op, dtype):
    for shape, axis, kd in (((0,), None, False), ((3, 0), 1, False),
                            ((3, 0), 1, True), ((0, 2), (0, 1), True)):
        x = np.zeros(shape, dtype)
        want = getattr(np, op)(x, axis=axis, initial=2.5, keepdims=kd)
        got = getattr(rt, op)(rt.array(x), axis=axis, initial=2.5,
                              keepdims=kd)
        _same(got.asarray(), np.asarray(want))


@pytest.mark.parametrize("fn", ["percentile", "quantile"])
def test_empty_quantiles_raise_at_the_call(fn):
    q = 50 if fn == "percentile" else 0.5
    for shape, axis in (((0,), None), ((3, 0), 1)):
        x = np.zeros(shape)
        want = _numpy_error(lambda: getattr(np, fn)(x, q, axis=axis))
        with pytest.raises(type(want)) as got:
            getattr(rt, fn)(rt.array(x), q, axis=axis)
        assert str(got.value) == str(want)


@pytest.mark.parametrize("fn", ["nanpercentile", "nanquantile", "median",
                                "nanmedian"])
def test_empty_nan_quantiles_and_medians_are_nan(fn):
    args = (50,) if fn == "nanpercentile" else (0.5,) if fn == \
        "nanquantile" else ()
    for shape, axis in (((0,), None), ((3, 0), 1)):
        x = np.zeros(shape)
        with np.errstate(all="ignore"), pytest.warns(RuntimeWarning):
            want = getattr(np, fn)(x, *args, axis=axis)
        _same(getattr(rt, fn)(rt.array(x), *args, axis=axis).asarray(),
              np.asarray(want))


# -- C.16 and C.17 --------------------------------------------------------
#
# Groupby var/std square in the result's float dtype (integers no longer
# wrap) and centre on each group's mean (a large mean no longer cancels
# every digit).  ramba_tpu is wrong on both (it squares in the data's dtype
# and subtracts mean**2), so both are held against NumPy's per-group var:
# integers within 1e-12 relative (float64 results), f64 1e8 + N(0, 1)
# within 1e-12 relative.  f32 data is held within 2e-6 relative of the
# group's var: its mean is rounded once to f32 (|mean| * 2**-24 off), and
# that error enters the centred sum only squared, so what is left is the
# f32 summation of n_g squares, a few n_g * 2**-24 of the result.

INT_WRAP = {"int8": 120, "int16": 30000, "int32": 2 * 10 ** 9,
            "int64": 10 ** 17, "uint8": 250, "uint16": 65000,
            "uint32": 4 * 10 ** 9, "uint64": 10 ** 18}


def _per_group(x, labels, G, fn):
    return np.array([fn(x[labels == g].astype(np.float64))
                     for g in range(G)])


@pytest.mark.parametrize("kind", ["var", "std"])
@pytest.mark.parametrize("dtype", sorted(INT_WRAP))
def test_groupby_spread_of_integers_does_not_wrap(dtype, kind):
    rs = np.random.RandomState(3)
    hi = INT_WRAP[dtype]
    lo = 0 if dtype.startswith("u") else -hi
    x = rs.randint(lo, hi, 300, dtype=np.int64 if hi < 2 ** 62 else
                   np.uint64).astype(dtype)
    labels = rs.randint(0, 5, 300)
    got = getattr(rt.fromarray(x).groupby(0, labels, 5), kind)().asarray()
    want = _per_group(x, labels, 5, getattr(np, kind))
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("kind", ["var", "std", "nanvar", "nanstd"])
def test_groupby_spread_keeps_its_digits_when_the_mean_is_large(kind):
    rs = np.random.RandomState(0)
    x = 1e8 + rs.randn(400)
    labels = rs.randint(0, 3, 400)
    got = getattr(rt.fromarray(x).groupby(0, labels, 3), kind)().asarray()
    want = _per_group(x, labels, 3, getattr(np, kind.replace("nan", "")))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    # 2-D data grouped along either dim
    x2 = 1e8 + rs.randn(400, 3)
    got = getattr(rt.fromarray(x2).groupby(0, labels, 3), kind)().asarray()
    want = np.stack([getattr(np, kind.replace("nan", ""))(
        x2[labels == g], axis=0) for g in range(3)])
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_groupby_var_of_float32_with_a_large_mean():
    rs = np.random.RandomState(1)
    x = (1e4 + rs.randn(400)).astype(np.float32)
    labels = rs.randint(0, 3, 400)
    got = rt.fromarray(x).groupby(0, labels, 3).var().asarray()
    assert got.dtype == np.float32
    want = _per_group(x, labels, 3, np.var)
    np.testing.assert_allclose(got, want, rtol=2e-6)
