"""The port's reductions against ramba_tpu's, x64 regime.

Every reduction of ``ramba_tpu/ops/reductions.py`` runs on the same inputs
(made with numpy from a seed, carried across by
``convert.state_from_reference``) through both packages, crossed with
bool, int8-int64, uint8-uint64 and float16-float64 data, axis None/0/1/
(0, 1), keepdims, ddof, ``where=`` and all-NaN slices; then
``cumsum``/``cumprod`` dtype widening, ``average`` with 1-D weights and the
masked ``reduce_where`` op.

Tolerances: dtypes and shapes always exact; integers, bools, arg-reductions,
min/max/ptp/median and NaN positions exact; float64 rtol=atol=1e-12,
float32 rtol=atol=1e-5 and float16 rtol=atol=2e-3 (two ulps: both packages
accumulate float16 in float32 and round once) where the summation orders
differ (torch's and XLA's reductions and scans group their additions
differently).
"""

import numpy as np
import pytest
import torch

import jax
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from ramba_tpu_torch import common, convert
from ramba_tpu_torch.core import expr as E

DTYPES = ["bool", "int8", "int16", "int32", "int64", "uint8", "uint16",
          "uint32", "uint64", "float16", "float32", "float64", "complex64",
          "complex128"]
# ramba_tpu fails on complex values in its masked mean (it lifts no complex
# scalar) and masked min/max (iinfo of a complex dtype): those two sweeps
# stay on the real dtypes
REALS = [d for d in DTYPES if not d.startswith("complex")]
AXES = [None, 0, 1, (0, 1)]
RTOL = {"float16": 2e-3, "float32": 1e-5, "float64": 1e-12, "complex64": 1e-5,
        "complex128": 1e-12}
SHAPE = (6, 7)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    torch.set_num_threads(1)


def _data(dtype, seed, nan=False):
    rs = np.random.RandomState(seed)
    if dtype == "bool":
        return rs.rand(*SHAPE) > 0.5
    if np.dtype(dtype).kind == "i":
        return rs.randint(-9, 10, SHAPE).astype(dtype)
    if np.dtype(dtype).kind == "u":
        return rs.randint(0, 10, SHAPE).astype(dtype)
    v = (rs.randn(*SHAPE) * 3).astype(dtype)
    if np.dtype(dtype).kind == "c":
        v = v + 1j * (rs.randn(*SHAPE) * 3).astype(dtype)
    if nan:
        v[rs.rand(*SHAPE) < 0.2] = np.nan
        v[:, 2] = np.nan  # one all-NaN column
        if np.dtype(dtype).kind == "c":  # a NaN in the imaginary part only
            v.imag[rs.rand(*SHAPE) < 0.1] = np.nan
    return v


def _pair(**arrays):
    ref = {k: rtj.fromarray(v) for k, v in arrays.items()}
    port = convert.state_from_reference({k: a.asarray() for k, a in ref.items()})
    return ref, port


def _same(got, want, what):
    g, w = np.asarray(got.asarray()), np.asarray(want.asarray())
    assert g.dtype == w.dtype, f"{what}: port {g.dtype} vs ramba_tpu {w.dtype}"
    assert g.shape == w.shape, f"{what}: port {g.shape} vs ramba_tpu {w.shape}"
    if w.dtype.kind in "biu":
        np.testing.assert_array_equal(g, w, err_msg=what)
    else:
        r = RTOL[w.dtype.name]
        np.testing.assert_allclose(g, w, rtol=r, atol=r, err_msg=what)


def _both(name, ref, port, **kw):
    """The reduction in both packages, or the exception both raise."""
    return _both_cases(name, ref, port, [kw])[0]


def _both_cases(name, ref, port, cases):
    """``_both`` for each kwargs of ``cases``.  ramba_tpu builds every case
    before the first read, so one flush (one compiled program) serves
    them all; an exception at build or read is held against the port's
    case by case."""
    built = []
    for kw in cases:
        try:
            built.append(getattr(rtj, name)(ref, **kw))
        except (TypeError, ValueError) as e:
            built.append(e)
    out = []
    for kw, want in zip(cases, built):
        if not isinstance(want, Exception):
            try:
                want.asarray()
            except (TypeError, ValueError) as e:
                want = e
        if isinstance(want, Exception):
            with pytest.raises(type(want)):
                getattr(rt, name)(port, **kw).asarray()
            out.append((None, None))
        else:
            out.append((getattr(rt, name)(port, **kw), want))
    return out


PLAIN = ["sum", "prod", "min", "max", "mean", "any", "all", "ptp",
         "count_nonzero", "median"]
VAR = ["var", "std", "nanvar", "nanstd"]
NAN = ["nansum", "nanprod", "nanmin", "nanmax", "nanmean"]
ARG = ["argmin", "argmax"]


@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", PLAIN + NAN + ARG)
def test_reduction_sweep(name, dtype, axis):
    ref, port = _pair(a=_data(dtype, 1))
    if name in ARG and isinstance(axis, tuple):
        with pytest.raises(TypeError):
            getattr(rt, name)(port["a"], axis=axis)
        return
    cases = [{"axis": axis, "keepdims": k} for k in (False, True)]
    for kw, (got, want) in zip(cases, _both_cases(name, ref["a"], port["a"],
                                                  cases)):
        if got is not None:
            _same(got, want, f"{name}({dtype}, axis={axis}, "
                             f"keepdims={kw['keepdims']})")


@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", VAR)
def test_variance_ddof(name, dtype, axis):
    ref, port = _pair(a=_data(dtype, 2))
    # ddof 7 leaves no degrees of freedom on every axis
    cases = [{"axis": axis, "ddof": d, "keepdims": k}
             for d in (0, 1, 7) for k in (False, True)]
    for kw, (got, want) in zip(cases, _both_cases(name, ref["a"], port["a"],
                                                  cases)):
        _same(got, want, f"{name}({dtype}, axis={axis}, ddof={kw['ddof']}, "
                         f"keepdims={kw['keepdims']})")


@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("dtype", ["float32", "float64", "complex64",
                                   "complex128"])
@pytest.mark.parametrize(
    "name", NAN + ["nanvar", "nanstd", "nanmedian", "median", "argmin",
                   "argmax", "min", "max", "mean", "ptp"])
def test_nan_slices(name, dtype, axis):
    """NaN anywhere, and one all-NaN column: the nan-kinds skip NaN (an
    all-NaN slice gives NaN), the others propagate it, arg-reductions
    return the first NaN.  Complex values with a NaN in either part too
    (XLA's in-order fold decides their min, max and ptp)."""
    ref, port = _pair(a=_data(dtype, 3, nan=True))
    for keepdims in (False, True):
        got, want = _both(name, ref["a"], port["a"], axis=axis,
                          keepdims=keepdims)
        if got is not None:  # both refuse complex medians and arg-reductions
            _same(got, want, f"{name}({dtype}, NaN, axis={axis})")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["nanargmin", "nanargmax"])
def test_nanarg_all_nan_slice_raises(name, dtype):
    """Both packages raise on an all-NaN slice (axis 0 reaches one) and
    agree where no slice is all NaN."""
    ref, port = _pair(a=_data(dtype, 4, nan=dtype.startswith("float")))
    for axis in (None, 0, 1):
        got, want = _both(name, ref["a"], port["a"], axis=axis)
        if got is not None:
            _same(got, want, f"{name}({dtype}, axis={axis})")
    if dtype.startswith("float"):
        with pytest.raises(ValueError, match="All-NaN"):
            getattr(rt, name)(port["a"], axis=0)


@pytest.mark.parametrize("dtype", ["int32", "int64", "float32", "float64"])
@pytest.mark.parametrize("name", ["sum", "prod", "any", "all", "nansum",
                                  "min", "max"])
def test_where_mask(name, dtype):
    a = _data(dtype, 5)
    mask = np.random.RandomState(6).rand(*SHAPE) > 0.4
    ref, port = _pair(a=a, m=mask)
    kw = {"initial": 0} if name in ("min", "max") else {}
    for axis in (None, 0, 1):
        got = getattr(rt, name)(port["a"], axis=axis, where=port["m"], **kw)
        want = getattr(rtj, name)(ref["a"], axis=axis, where=ref["m"], **kw)
        _same(got, want, f"{name}({dtype}, where=, axis={axis})")
    with pytest.raises(ValueError, match="identity"):
        rt.min(port["a"], where=port["m"])


@pytest.mark.parametrize("dtype", REALS)
def test_masked_mean(dtype):
    ref, port = _pair(a=_data(dtype, 7),
                      m=np.random.RandomState(8).rand(*SHAPE) > 0.3)
    for axis in (None, 0, 1):
        got = rt.mean(port["a"], axis=axis, where=port["m"])
        want = rtj.mean(ref["a"], axis=axis, where=ref["m"])
        _same(got, want, f"mean({dtype}, where=, axis={axis})")


@pytest.mark.parametrize(
    "dtype", ["bool", "int8", "uint8", "int16", "int32", "uint32", "int64",
              "float32", "float64", "complex64", "complex128"])
def test_cumulative_widening(dtype):
    a = (np.arange(1, 13) % 5).reshape(3, 4).astype(dtype)
    ref, port = _pair(a=a)
    for name in ("cumsum", "cumprod"):
        for axis in (None, 0, 1, -1):
            _same(getattr(rt, name)(port["a"], axis),
                  getattr(rtj, name)(ref["a"], axis),
                  f"{name}({dtype}, axis={axis})")
            _same(getattr(port["a"], name)(axis), getattr(ref["a"], name)(axis),
                  f"ndarray.{name}({dtype}, axis={axis})")


@pytest.mark.parametrize("dtype", ["int32", "float32", "float64"])
def test_average(dtype):
    a = _data(dtype, 9)
    w1 = np.random.RandomState(10).rand(SHAPE[1])
    w2 = np.random.RandomState(11).rand(*SHAPE).astype(dtype)
    ref, port = _pair(a=a, w1=w1, w2=w2)
    for axis in (None, 0, 1, (0, 1)):
        _same(rt.average(port["a"], axis), rtj.average(ref["a"], axis),
              f"average({dtype}, axis={axis})")
        g, gs = rt.average(port["a"], axis, returned=True)
        w, ws = rtj.average(ref["a"], axis, returned=True)
        _same(gs, ws, f"average sum of weights, axis={axis}")
    for axis in (1, -1):
        g, gs = rt.average(port["a"], axis, weights=port["w1"], returned=True)
        w, ws = rtj.average(ref["a"], axis, weights=ref["w1"], returned=True)
        _same(g, w, f"average 1-D weights axis={axis}")
        _same(gs, ws, f"average 1-D weights sum, axis={axis}")
    _same(rt.average(port["a"], None, weights=port["w2"]),
          rtj.average(ref["a"], None, weights=ref["w2"]), "full weights")
    with pytest.raises(TypeError, match="Axis must be specified"):
        rt.average(port["a"], None, weights=port["w1"])
    with pytest.raises(ValueError, match="Length of weights"):
        rt.average(port["a"], 0, weights=port["w1"])


@pytest.mark.parametrize("dtype", ["int32", "int64", "float32", "float64"])
def test_ndarray_methods(dtype):
    ref, port = _pair(a=_data(dtype, 12))
    x, y = port["a"], ref["a"]
    for axis in (None, 0, 1):
        _same(x.var(axis), y.var(axis), f"var axis={axis}")
        _same(x.std(axis, ddof=1), y.std(axis, ddof=1), f"std axis={axis}")
        _same(x.var(axis, keepdims=True), y.var(axis, keepdims=True),
              "var keepdims")
        _same(x.argmin(axis), y.argmin(axis), f"argmin axis={axis}")
        _same(x.argmax(axis), y.argmax(axis), f"argmax axis={axis}")


@pytest.mark.parametrize("name,dtype", [
    (n, d) for n in ["sum", "prod", "min", "max", "mean", "any", "all"]
    for d in (REALS if n in ("min", "max") else DTYPES)])
def test_reduce_where_op(name, dtype):
    """The masked ``reduce_where`` node ramba_tpu's masked arrays build."""
    from ramba_tpu.core.expr import Node as JNode

    from ramba_tpu_torch.core.expr import Node

    a = _data(dtype, 13)
    mask = np.random.RandomState(14).rand(*SHAPE) > 0.5
    ref, port = _pair(a=a, m=mask)
    cases = [(axis, k) for axis in (None, 0, 1) for k in (False, True)]
    # ramba_tpu's identity for a masked uint64 min, iinfo(uint64).max,
    # overflows jnp's argument parsing (OverflowError): held against NumPy
    numpy_only = name == "min" and dtype == "uint64"
    # every ramba_tpu case is built before the first read: one flush
    wants = [] if numpy_only else [
        type(ref["a"])(JNode("reduce_where", (name, axis, keepdims),
                             [ref["a"].read_expr(), ref["m"].read_expr()]))
        for axis, keepdims in cases]
    for k, (axis, keepdims) in enumerate(cases):
        got = rt.ndarray(Node("reduce_where", (name, axis, keepdims),
                              [port["a"].read_expr(),
                               port["m"].read_expr()]))
        if numpy_only:
            want = np.min(a, axis=axis, keepdims=keepdims, where=mask,
                          initial=np.iinfo(np.uint64).max)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got.asarray(), want)
            continue
        assert got.dtype == wants[k].dtype
        _same(got, wants[k], f"reduce_where {name}({dtype}, axis={axis})")


def test_reduce_dtype_table():
    """The aval rule gives each reduction's dtype without running it."""
    for name in E.REDFN:
        for dtype in DTYPES:
            x = rtj.fromarray(np.ones(3, dtype))
            try:
                want = getattr(rtj, name)(x).asarray().dtype
            except (TypeError, ValueError) as e:
                with pytest.raises(type(e)):
                    E.reduce_dtype(name, np.dtype(dtype))
                continue
            assert E.reduce_dtype(name, np.dtype(dtype)) == want, (name, dtype)


def test_median_midpoint_and_sort_order():
    v = np.array([[4.0, -1.0, 7.0, 2.5, 9.0, 0.0],
                  [1.0, 1.0, 1.0, 3.0, np.nan, 2.0]])
    ref, port = _pair(a=v)
    for name in ("median", "nanmedian"):
        for axis in (None, 0, 1):
            _same(getattr(rt, name)(port["a"], axis=axis),
                  getattr(rtj, name)(ref["a"], axis=axis), f"{name} {axis}")


@pytest.mark.parametrize("name", ["sum", "prod", "nansum", "nanprod"])
def test_uint8_sums_are_uint64(name):
    """uint8 sums and products give uint64, as in ramba_tpu and NumPy (torch
    promotes them to int64): the function, the method and ``where=``."""
    a = np.arange(1, 43, dtype=np.uint8).reshape(SHAPE) % 5 + 1
    mask = np.random.RandomState(15).rand(*SHAPE) > 0.3
    ref, port = _pair(a=a, m=mask)
    for axis in (None, 0, 1):
        got = getattr(rt, name)(port["a"], axis=axis)
        assert got.asarray().dtype == np.uint64
        _same(got, getattr(rtj, name)(ref["a"], axis=axis), f"{name} {axis}")
        got = getattr(rt, name)(port["a"], axis=axis, where=port["m"])
        assert got.asarray().dtype == np.uint64
        _same(got, getattr(rtj, name)(ref["a"], axis=axis, where=ref["m"]),
              f"{name} where= {axis}")
    if name in ("sum", "prod"):
        got = getattr(port["a"], name)(axis=1)
        assert got.asarray().dtype == np.uint64
        _same(got, getattr(ref["a"], name)(axis=1), f"ndarray.{name}")
