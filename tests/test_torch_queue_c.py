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
