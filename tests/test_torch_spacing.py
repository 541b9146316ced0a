"""``spacing``: the port against ramba_tpu, x64 regime.

``rt.spacing`` and ``np.spacing`` of a port array must give ramba_tpu's
values bit for bit (sign bits compared, since ``assert_array_equal``
takes -0.0 for 0.0 and ramba_tpu's ``spacing(-0.0)`` is the negative
smallest subnormal, where NumPy gives the positive one) and its dtypes:
float16/32/64 keep their width, integers take NumPy's loop dtype (float64
for int32/int64, float16 for int8/uint8/bool).  The elemred classifier
turns ``spacing`` away: it runs on the generic lowering, as ``nextafter``
does.
"""

import numpy as np
import pytest
import torch

import jax
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from ramba_tpu_torch import common
from ramba_tpu_torch.core import fuser
from ramba_tpu_torch.ops import kernel_backend as kb

TINY = np.finfo(np.float64).smallest_subnormal
FLOATS = [0.0, -0.0, TINY, -TINY, 1e-310, -1e-310, 1.0, -1.0, 1e300, -1e300,
          np.inf, -np.inf, np.nan, -np.nan, 65504.0, -65504.0, 6e-8, -6e-8,
          1e-40, -1e-40, 3.4e38, -3.4e38, np.finfo(np.float64).max,
          -np.finfo(np.float64).max, 2.5, 1e-7]
INTS = [0, 1, -1, 5, 100, 127, -128, 2 ** 40, -(2 ** 40)]


@pytest.fixture(autouse=True)
def _port_on_cpu():
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    torch.set_num_threads(1)


def _inputs(dtype):
    vals = FLOATS if np.dtype(dtype).kind == "f" else INTS
    with np.errstate(over="ignore", invalid="ignore"):
        return np.array(vals).astype(dtype)


def _same_bits(got, want):
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[ok], want[ok])
    np.testing.assert_array_equal(np.signbit(got[ok]), np.signbit(want[ok]))


@pytest.mark.parametrize("dtype", ["float16", "float32", "float64", "int8",
                                   "int32", "int64", "uint8", "bool"])
def test_spacing_matches_reference(dtype):
    x = _inputs(dtype)
    want = rtj.spacing(rtj.fromarray(x)).asarray()
    _same_bits(rt.spacing(rt.fromarray(x)).asarray(), want)


@pytest.mark.parametrize("dtype", ["float16", "float32", "float64", "int64"])
def test_np_spacing_dispatches(dtype):
    x = _inputs(dtype)
    got = np.spacing(rt.fromarray(x))
    assert isinstance(got, rt.ndarray)
    _same_bits(got.asarray(), rtj.spacing(rtj.fromarray(x)).asarray())


def test_spacing_of_negative_zero_is_negative():
    got = rt.spacing(rt.fromarray(np.array([-0.0, 0.0]))).asarray()
    assert np.signbit(got[0]) and not np.signbit(got[1])
    assert abs(got[0]) == TINY and got[1] == TINY


def test_spacing_scalar_and_special_values():
    assert float(rt.spacing(1.0)) == np.finfo(np.float64).eps
    got = rt.spacing(rt.fromarray(np.array([np.inf, -np.inf, np.nan]))).asarray()
    assert np.isnan(got).all()


def test_spacing_stays_on_the_generic_lowering():
    x = rt.fromarray(np.linspace(-2.0, 2.0, 64))
    program, leaves = fuser.prepare_program([rt.spacing(x * 2.0)._expr])
    assert kb.classify(program, leaves) is None
