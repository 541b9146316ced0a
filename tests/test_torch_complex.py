"""Complex values: the port against ramba_tpu, x64 regime.

Every op runs through both packages on complex64 and complex128 inputs whose
parts range over 0.0, -0.0, finite values, +-inf and NaN (every pairing of
them), carried across with ``convert.state_from_reference``.  Values and
dtypes are compared exactly (NaN where NaN, the signs of zeros too) for the
ops that select, order or round; where the port computes a formula in a
different order than XLA, each part is held within k ulp of ramba_tpu's at
the modulus of the result, NaN and infinities where ramba_tpu has them: 2
ulp for sign's x/|x|, angle, abs, the variances and the degree
conversions (arctan2 at modulus 1, the log of a unit value), 4 for the
nan-sums and products (another summation order), 8 for power (exp, log,
sin and cos of two math libraries composed) and 16 for the logaddexps
(log1p of exp, its cancellation near amax).

The max/min reductions run over short rows: XLA folds a complex slice in
order, so a NaN part decides the result by its position, and the port
follows that fold.
"""

import numpy as np
import pytest
import torch

import jax
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from ramba_tpu_torch import common, convert

CDTYPES = ["complex64", "complex128"]
PARTS = [0.0, -0.0, 1.5, -2.25, np.inf, -np.inf, np.nan]


@pytest.fixture(autouse=True)
def _port_on_cpu():
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    torch.set_num_threads(1)


def _grid(dtype):
    """Every (real, imag) pairing of PARTS: 49 values."""
    re, im = np.meshgrid(PARTS, PARTS, indexing="ij")
    return _pairs(re.ravel(), im.ravel(), dtype)


def _pairs(re, im, dtype):
    out = np.empty(len(re), dtype)
    out.real = re
    out.imag = im
    return out


def _shuffled(v, seed):
    return v[np.random.RandomState(seed).permutation(len(v))]


def _randc(dtype, shape, seed, nan_every=0):
    rs = np.random.RandomState(seed)
    out = np.empty(shape, dtype)
    out.real = rs.randn(*shape) * 3
    out.imag = rs.randn(*shape) * 3
    if nan_every:
        flat = out.reshape(-1)
        flat.real[::nan_every] = np.nan
        flat.imag[3::nan_every] = np.nan
        flat[1] = complex(-0.0, 0.0)
    return out


def _pair(**arrays):
    ref = {k: rtj.fromarray(v) for k, v in arrays.items()}
    port = convert.state_from_reference({k: a.asarray()
                                         for k, a in ref.items()})
    return ref, port


def _host(x):
    return np.asarray(x.asarray() if hasattr(x, "asarray") else x)


def _parts(a):
    a = np.asarray(a)
    if a.dtype.kind == "c":
        return [a.real, a.imag]
    return [a]


def _same(got, want, what):
    g, w = _host(got), _host(want)
    assert g.dtype == w.dtype, f"{what}: port {g.dtype} vs ramba_tpu {w.dtype}"
    assert g.shape == w.shape, f"{what}: port {g.shape} vs ramba_tpu {w.shape}"
    for gp, wp in zip(_parts(g), _parts(w)):
        np.testing.assert_array_equal(gp, wp, err_msg=what)
        if gp.dtype.kind == "f":
            np.testing.assert_array_equal(
                np.signbit(gp) & ~np.isnan(gp), np.signbit(wp) & ~np.isnan(wp),
                err_msg=f"{what}: signs of zeros")


def _ulps(got, want, what, ulps=2, floor=0.0):
    """Each part within ``ulps`` units in the last place of the value's
    modulus (the larger of the two results'); NaN and infinities equal."""
    g, w = _host(got), _host(want)
    assert g.dtype == w.dtype, f"{what}: port {g.dtype} vs ramba_tpu {w.dtype}"
    assert g.shape == w.shape, f"{what}: port {g.shape} vs ramba_tpu {w.shape}"
    # of the whole complex value, at least ``floor``
    mag = np.maximum(np.maximum(np.abs(g), np.abs(w)), floor)
    for gp, wp in zip(_parts(g), _parts(w)):
        np.testing.assert_array_equal(np.isnan(gp), np.isnan(wp),
                                      err_msg=f"{what}: NaN positions")
        inf = np.isinf(wp)
        np.testing.assert_array_equal(gp[inf], wp[inf],
                                      err_msg=f"{what}: infinities")
        fin = np.isfinite(wp) & np.isfinite(mag)
        scale = mag[fin]
        tol = ulps * np.spacing(scale.astype(wp.dtype))
        bad = np.abs(gp[fin] - wp[fin]) > tol
        assert not bad.any(), (
            f"{what}: {int(bad.sum())} values beyond {ulps} ulp, e.g. port "
            f"{gp[fin][bad][:4]} vs ramba_tpu {wp[fin][bad][:4]}")


def _run(fn_name, *arrays, **kw):
    ref, port = _pair(**{f"a{i}": a for i, a in enumerate(arrays)})
    want = getattr(rtj, fn_name)(*ref.values(), **kw)
    got = getattr(rt, fn_name)(*port.values(), **kw)
    return got, want


# -- the fault table: one test per row -----------------------------------------


@pytest.mark.parametrize("dtype", CDTYPES)
@pytest.mark.parametrize("fn", ["imag", "real"])
def test_real_imag_parts(fn, dtype):
    """imag was all zeros (the operand cast away before the op ran)."""
    got, want = _run(fn, _grid(dtype))
    _same(got, want, f"{fn} {dtype}")


@pytest.mark.parametrize("dtype", CDTYPES)
def test_angle_is_real(dtype):
    got, want = _run("angle", _grid(dtype))
    _ulps(got, want, f"angle {dtype}")


@pytest.mark.parametrize("dtype", CDTYPES)
@pytest.mark.parametrize("fn", ["absolute", "abs"])
def test_absolute(fn, dtype):
    got, want = _run(fn, _grid(dtype))
    _ulps(got, want, f"{fn} {dtype}")


@pytest.mark.parametrize("dtype", CDTYPES)
@pytest.mark.parametrize("fn", ["var", "std", "nanvar", "nanstd"])
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_spreads_are_real(fn, axis, dtype):
    """var/std were complex: the square of x - mean without the modulus."""
    x = _randc(dtype, (6, 9), 3, nan_every=7 if fn.startswith("nan") else 0)
    got, want = _run(fn, x, axis=axis)
    _ulps(got, want, f"{fn} axis={axis} {dtype}")
    got, want = _run(fn, x, axis=axis, ddof=1)
    _ulps(got, want, f"{fn} ddof=1 axis={axis} {dtype}")


@pytest.mark.parametrize("dtype", CDTYPES)
@pytest.mark.parametrize("fn", ["nansum", "nanprod", "nanmean"])
@pytest.mark.parametrize("axis", [None, 1])
def test_nan_reductions_drop_nan_parts(fn, axis, dtype):
    """A value with a NaN in either part is dropped (was kept)."""
    x = _randc(dtype, (5, 6), 4, nan_every=4)
    if fn == "nanprod":
        x = x / 3
    got, want = _run(fn, x, axis=axis)
    # sums and products of up to 30 terms in another order: 4 ulp
    _ulps(got, want, f"{fn} axis={axis} {dtype}", ulps=4)


@pytest.mark.parametrize("dtype", CDTYPES)
@pytest.mark.parametrize("fn", ["power", "float_power"])
def test_power_zero_to_zero(fn, dtype):
    """0j ** 0j is 1 (was NaN), and the rest follows XLA's complex power."""
    z = np.zeros(4, dtype)
    z[1] = complex(-0.0, 0.0)
    got, want = _run(fn, z, z)
    _same(got, want, f"{fn} 0**0 {dtype}")
    x = _randc(dtype, (40,), 5) / 3
    y = _randc(dtype, (40,), 6) / 3
    got, want = _run(fn, x, y)
    # exp, log, sin and cos of two math libraries composed: 8 ulp
    _ulps(got, want, f"{fn} {dtype}", ulps=8)


@pytest.mark.parametrize("dtype", CDTYPES)
def test_power_special_values(dtype):
    g = _grid(dtype)
    got, want = _run("power", g, _shuffled(g, 7))
    _ulps(got, want, f"power grid {dtype}", ulps=8)


@pytest.mark.parametrize("dtype", CDTYPES)
def test_sign_is_unit_vector(dtype):
    """sign raised (torch.sign takes no complex values)."""
    got, want = _run("sign", _grid(dtype))
    _ulps(got, want, f"sign {dtype}")
    x = _randc(dtype, (30,), 8)
    got, want = _run("sign", x)
    _ulps(got, want, f"sign random {dtype}")


@pytest.mark.parametrize("dtype", CDTYPES)
@pytest.mark.parametrize("fn", ["maximum", "minimum", "fmax", "fmin", "less",
                                "less_equal", "greater", "greater_equal"])
def test_lexicographic_binary(fn, dtype):
    """These raised (torch has no complex order)."""
    g = _grid(dtype)
    got, want = _run(fn, g, _shuffled(g, 9))
    _same(got, want, f"{fn} {dtype}")
    got, want = _run(fn, g, g)  # ties: which operand a select keeps
    _same(got, want, f"{fn} ties {dtype}")


@pytest.mark.parametrize("dtype", CDTYPES)
@pytest.mark.parametrize("fn", ["max", "min", "ptp", "nanmax", "nanmin"])
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_lexicographic_reductions(fn, axis, dtype):
    """max/min/ptp raised; XLA's in-order fold decides where NaN parts
    stand, on rows of 7 values of the grid."""
    g = _shuffled(_grid(dtype), 10).reshape(7, 7)
    got, want = _run(fn, g, axis=axis)
    if fn == "ptp":
        _ulps(got, want, f"{fn} axis={axis} {dtype}")
    else:
        _same(got, want, f"{fn} axis={axis} {dtype}")


@pytest.mark.parametrize("dtype", CDTYPES)
def test_lexicographic_reductions_finite(dtype):
    x = _randc(dtype, (8, 5), 11)
    x.real[2, 3] = x.real[5, 3]  # a tie on the real parts
    for fn in ("max", "min"):
        for axis in (None, 0, 1):
            got, want = _run(fn, x, axis=axis)
            _same(got, want, f"{fn} axis={axis} {dtype}")


@pytest.mark.parametrize("dtype", CDTYPES)
@pytest.mark.parametrize("fn", ["sort", "argsort"])
def test_sort_lexicographic(fn, dtype):
    """sort/argsort raised (sort_key had no complex branch); NaN parts
    last, equal values (0j and -0j) in input order."""
    g = _shuffled(_grid(dtype), 12)
    got, want = _run(fn, g)
    _same(got, want, f"{fn} {dtype}")
    g2 = np.concatenate([g, g[:7]]).reshape(8, 7)
    for axis in (0, 1, None):
        got, want = _run(fn, g2, axis=axis)
        _same(got, want, f"{fn} axis={axis} {dtype}")


@pytest.mark.parametrize("dtype", CDTYPES)
def test_rint_rounds_each_part(dtype):
    """rint raised (torch.round takes no complex values)."""
    x = _grid(dtype)
    h = _pairs(np.array([0.5, 1.5, -2.5, 2.4999]), np.array([-0.5, 3.5, 7.5,
                                                             -0.4]), dtype)
    got, want = _run("rint", np.concatenate([x, h]))
    _same(got, want, f"rint {dtype}")


@pytest.mark.parametrize("dtype", CDTYPES)
@pytest.mark.parametrize("fn", ["deg2rad", "degrees", "rad2deg", "radians"])
def test_degree_conversions_compute(fn, dtype):
    """ramba_tpu computes these on complex values (jnp multiplies by the
    constant as a complex number); the port raised TypeError."""
    got, want = _run(fn, _grid(dtype))
    _ulps(got, want, f"{fn} {dtype}")


@pytest.mark.parametrize("dtype", CDTYPES)
@pytest.mark.parametrize("fn", ["arctan2", "logaddexp", "logaddexp2"])
def test_jnp_complex_binaries_compute(fn, dtype):
    """ramba_tpu computes these on complex values by jnp's formulas (NumPy
    has no complex loop for them); the port raised TypeError.  arctan2 is
    a log of a value of modulus 1, so its error is counted at modulus 1."""
    x = _randc(dtype, (40,), 13) / 2
    y = _randc(dtype, (40,), 14) / 2
    got, want = _run(fn, x, y)
    _ulps(got, want, f"{fn} {dtype}", ulps=2 if fn == "arctan2" else 16,
          floor=1.0 if fn == "arctan2" else 0.0)


@pytest.mark.parametrize("dtype", CDTYPES)
@pytest.mark.parametrize("fn", ["median", "nanmedian"])
def test_median_refuses_complex(fn, dtype):
    ref, port = _pair(a=_randc(dtype, (5,), 15))
    with pytest.raises(ValueError):
        getattr(rtj, fn)(ref["a"]).asarray()
    with pytest.raises(ValueError):
        getattr(rt, fn)(port["a"]).asarray()


@pytest.mark.parametrize("dtype", CDTYPES)
@pytest.mark.parametrize("fn", ["argmax", "argmin", "nanargmax", "nanargmin"])
def test_arg_reductions_refuse_complex(fn, dtype):
    ref, port = _pair(a=_randc(dtype, (5,), 16))
    with pytest.raises(TypeError):
        np.asarray(getattr(rtj, fn)(ref["a"]))
    with pytest.raises(TypeError):
        getattr(rt, fn)(port["a"]).asarray()


@pytest.mark.parametrize("dtype", CDTYPES)
def test_complex_chain_through_one_flush(dtype):
    """A program mixing the repaired ops flushes once and matches."""
    x = _randc(dtype, (64,), 17, nan_every=9)

    def prog(m, a):
        return m.where(m.isnan(a), 0, m.sign(a) * m.conj(a)) + m.imag(a) \
            - m.angle(a)

    ref, port = _pair(a=x)
    _ulps(prog(rt, port["a"]),
          prog(rtj, ref["a"]), f"chain {dtype}", ulps=4)
