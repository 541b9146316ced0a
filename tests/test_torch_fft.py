"""``ramba_tpu_torch.fft``: the port against ramba_tpu, x64 regime.

Every name of ``ramba_tpu/fft.py`` runs through both packages on the same
seeded inputs (``convert.state_from_reference``) over the dtype sweep,
bool to complex128; the result dtypes must be ramba_tpu's exactly (int32
gives complex64, float32 complex64, 64-bit values complex128) and the
values lie within ``c * log2(n) * eps * max|x| * n`` of ramba_tpu's, where
``n`` is the transform's length and ``c = 4`` (two FFTs of the same length
each round O(log2 n) times per element; the unnormalised transform scales
by up to n).  The shifts and frequency helpers move values only: exact.
The cases follow ``tests/test_fft_namespace.py``.
"""

import math

import numpy as np
import pytest
import torch

import jax
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from ramba_tpu_torch import common, convert

SWEEP = ["bool", "int8", "int16", "int32", "int64", "uint8", "uint16",
         "uint32", "uint64", "float16", "float32", "float64", "complex64",
         "complex128"]
EPS = {"float16": 2.0 ** -10, "float32": 2.0 ** -23, "float64": 2.0 ** -52}
C = 4


@pytest.fixture(autouse=True)
def _port_on_cpu():
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    torch.set_num_threads(1)


def _values(dtype, shape, seed):
    rs = np.random.RandomState(seed)
    if dtype == "bool":
        return rs.rand(*shape) > 0.5
    kind = np.dtype(dtype).kind
    if kind in "iu":
        return rs.randint(0, 20, shape).astype(dtype)
    if kind == "c":
        out = np.empty(shape, dtype)
        out.real, out.imag = rs.rand(*shape), rs.rand(*shape)
        return out
    return rs.rand(*shape).astype(dtype)


def _pair(**arrays):
    ref = {k: rtj.fromarray(v) for k, v in arrays.items()}
    port = convert.state_from_reference({k: a.asarray()
                                         for k, a in ref.items()})
    return ref, port


def _host(x):
    return np.asarray(x.asarray() if hasattr(x, "asarray") else x)


def _eps(dt):
    dt = np.dtype(dt)
    if dt.kind == "c":
        return EPS["float64" if dt.itemsize == 16 else "float32"]
    return EPS.get(dt.name, 0.0)


def _close(got, want, n, scale, what):
    g, w = _host(got), _host(want)
    assert g.dtype == w.dtype, f"{what}: port {g.dtype} vs ramba_tpu {w.dtype}"
    assert g.shape == w.shape, f"{what}: port {g.shape} vs ramba_tpu {w.shape}"
    bound = C * max(1.0, math.log2(max(n, 2))) * _eps(g.dtype) * scale * n
    err = np.abs(g.astype(np.complex128) - w.astype(np.complex128)).max() \
        if g.size else 0.0
    assert err <= bound, f"{what}: error {err} beyond {bound}"


def _scale(x):
    return float(np.abs(np.asarray(x).astype(np.complex128)).max())


CASES_1D = {
    "fft": lambda m, a: m.fft.fft(a),
    "fft_n": lambda m, a: m.fft.fft(a, n=40),
    "fft_ortho": lambda m, a: m.fft.fft(a, norm="ortho"),
    "fft_forward": lambda m, a: m.fft.fft(a, norm="forward"),
    "ifft": lambda m, a: m.fft.ifft(a),
    "rfft": lambda m, a: m.fft.rfft(a),
    "rfft_n": lambda m, a: m.fft.rfft(a, n=31),
    "irfft": lambda m, a: m.fft.irfft(a),
    "irfft_n": lambda m, a: m.fft.irfft(a, n=48),
    "hfft": lambda m, a: m.fft.hfft(a),
    "ihfft": lambda m, a: m.fft.ihfft(a),
    "fft_axis0": lambda m, a: m.fft.fft(a.reshape(8, 4), axis=0),
}
CASES_ND = {
    "fft2": lambda m, a: m.fft.fft2(a),
    "ifft2": lambda m, a: m.fft.ifft2(a),
    "rfft2": lambda m, a: m.fft.rfft2(a),
    "irfft2": lambda m, a: m.fft.irfft2(a),
    "fftn": lambda m, a: m.fft.fftn(a),
    "fftn_axes": lambda m, a: m.fft.fftn(a, axes=(0,)),
    "fftn_s": lambda m, a: m.fft.fftn(a, s=(4, 6)),
    "ifftn": lambda m, a: m.fft.ifftn(a, norm="ortho"),
    "rfftn": lambda m, a: m.fft.rfftn(a),
    "irfftn": lambda m, a: m.fft.irfftn(a, s=(8, 10)),
}


def _run(case, x, n, what):
    ref, port = _pair(a=x)
    try:
        want = case(rtj, ref["a"])
        _host(want)
    except Exception as e:
        with pytest.raises(type(e)):
            _host(case(rt, port["a"]))
        return
    _close(case(rt, port["a"]), want, n, _scale(x), what)


@pytest.mark.parametrize("dtype", SWEEP)
@pytest.mark.parametrize("name", sorted(CASES_1D))
def test_one_dimensional(name, dtype):
    _run(CASES_1D[name], _values(dtype, (32,), 1), 48, f"{name} {dtype}")


@pytest.mark.parametrize("dtype", SWEEP)
@pytest.mark.parametrize("name", sorted(CASES_ND))
def test_n_dimensional(name, dtype):
    _run(CASES_ND[name], _values(dtype, (8, 6), 2), 80, f"{name} {dtype}")


@pytest.mark.parametrize("dtype", SWEEP)
def test_round_trips(dtype):
    x = _values(dtype, (64,), 3)
    ref, port = _pair(a=x)
    for m, a in ((rt, port["a"]), (rtj, ref["a"])):
        back = _host(m.fft.ifft(m.fft.fft(a)))
        ref_back = np.asarray(x).astype(back.dtype)
        bound = C * 6 * _eps(back.dtype) * _scale(x) * 2
        assert np.abs(back - ref_back).max() <= bound, m.__name__
    if np.dtype(dtype).kind != "c" and dtype != "float16":  # both refuse
        back = _host(rt.fft.irfft(rt.fft.rfft(port["a"]), n=64))
        assert np.abs(back - np.asarray(x).astype(back.dtype)).max() <= \
            C * 6 * _eps(back.dtype) * _scale(x) * 2


@pytest.mark.parametrize("dtype", SWEEP)
@pytest.mark.parametrize("fn", ["fftshift", "ifftshift"])
def test_shifts_exact(fn, dtype):
    x = _values(dtype, (6, 7), 4)
    ref, port = _pair(a=x)
    for kw in ({}, {"axes": 0}, {"axes": (1,)}, {"axes": np.int64(1)}):
        g = _host(getattr(rt.fft, fn)(port["a"], **kw))
        w = _host(getattr(rtj.fft, fn)(ref["a"], **kw))
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_frequencies():
    for fn, args in (("fftfreq", (64, 0.5)), ("fftfreq", (7,)),
                     ("rfftfreq", (64,)), ("rfftfreq", (9, 0.1))):
        g = _host(getattr(rt.fft, fn)(*args))
        w = _host(getattr(rtj.fft, fn)(*args))
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_bad_norm_refused():
    for m in (rt, rtj):
        with pytest.raises(ValueError):
            _host(m.fft.fft(m.fromarray(np.ones(4)), norm="unitary"))


def test_numpy_dispatch_and_one_flush():
    x = np.random.RandomState(5).rand(128)
    a = rt.fromarray(x)
    got = np.fft.rfft(a)
    assert isinstance(got, rt.ndarray)
    _close(got, rt.fft.rfft(a), 128, 1.0, "np.fft.rfft")
    rt.sync()
    f0 = rt.fuser_stats["flushes"]
    total = float(rt.sum(rt.abs(rt.fft.rfft(a * 2.0)) ** 2))
    assert rt.fuser_stats["flushes"] == f0 + 1
    np.testing.assert_allclose(total, (np.abs(np.fft.rfft(x * 2)) ** 2).sum(),
                               rtol=1e-12)
    from ramba_tpu_torch.core.interop import HANDLED_FUNCTIONS
    for n in ("fft", "ifft", "rfft", "irfft", "hfft", "ihfft", "fft2", "ifft2",
              "rfft2", "irfft2", "fftn", "ifftn", "rfftn", "irfftn",
              "fftshift", "ifftshift", "fftfreq", "rfftfreq"):
        assert HANDLED_FUNCTIONS[getattr(np.fft, n)] is getattr(rt.fft, n)
