"""The manipulation names, sort/argsort and the rest of ``ndarray``: the
port against ramba_tpu, x64 regime.

Every case runs one program through both packages on inputs made with
numpy from a seed (carried across with ``convert.state_from_reference``);
values and dtypes are compared exactly, NaN where NaN, and for sort the
sign bits of its zeros too (-0.0 and 0.0 keep their input order).  The
cases follow ``tests/test_distributed_array.py`` (concatenate, stack and
split, pad, triu/tril, flip/roll, repeat/tile, expand/squeeze, moveaxis)
over the small and unsigned dtypes as well.
"""

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

# ramba_tpu/__init__.py:51-56, every name of ops/manipulation.py
NAMES = [
    "apply_index", "argsort", "array_split", "atleast_1d", "atleast_2d",
    "broadcast_to", "column_stack", "concatenate", "diag", "dstack",
    "expand_dims", "flip", "hstack", "moveaxis", "pad", "ravel", "repeat",
    "reshape", "reshape_copy", "roll", "sort", "split", "squeeze", "stack",
    "swapaxes", "take", "tile", "transpose", "tril", "triu", "vstack",
]


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
    if kind == "u":
        return rs.randint(0, 200, shape).astype(dtype)
    if kind == "i":
        return rs.randint(-100, 100, shape).astype(dtype)
    if kind == "c":
        return (rs.randn(*shape) * 10 + 1j * rs.randn(*shape) * 10).astype(dtype)
    return (rs.randn(*shape) * 10).astype(dtype)


def _pair(**arrays):
    ref = {k: rtj.fromarray(v) for k, v in arrays.items()}
    port = convert.state_from_reference({k: a.asarray()
                                         for k, a in ref.items()})
    return ref, port


def _host(x):
    return np.asarray(x.asarray() if hasattr(x, "asarray") else x)


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [y for x in out for y in _flat(x)]
    return [out]


def _same(got, want, what):
    g, w = _host(got), _host(want)
    assert g.dtype == w.dtype, f"{what}: port {g.dtype} vs ramba_tpu {w.dtype}"
    assert g.shape == w.shape, f"{what}: port {g.shape} vs ramba_tpu {w.shape}"
    np.testing.assert_array_equal(g, w, err_msg=what)
    if g.dtype.kind == "f":
        np.testing.assert_array_equal(np.signbit(g) & ~np.isnan(g),
                                      np.signbit(w) & ~np.isnan(w),
                                      err_msg=f"{what}: signs of zeros")


def _both(program, what, **arrays):
    ref, port = _pair(**arrays)
    want = _flat(program(rtj, ref))
    got = _flat(program(rt, port))
    assert len(got) == len(want), what
    for k, (g, w) in enumerate(zip(got, want)):
        if isinstance(w, (rtj.ndarray, np.ndarray)) or np.isscalar(w):
            _same(g, w, f"{what} [{k}]")
        else:
            assert g == w, f"{what} [{k}]: {g} vs {w}"


# one program per name: each runs on x (1-D), X (2-D) and Y (3-D)
CASES = {
    "apply_index": lambda m, a: m.apply_index((4, 5, 6), (1, slice(None, None, -1), None, Ellipsis)),
    "argsort": lambda m, a: (m.argsort(a["x"]), m.argsort(a["X"], axis=0),
                             m.argsort(a["Y"], axis=None)),
    "array_split": lambda m, a: m.array_split(a["x"], 3),
    "atleast_1d": lambda m, a: (m.atleast_1d(a["x"]), m.atleast_1d(a["x"][0])),
    "atleast_2d": lambda m, a: (m.atleast_2d(a["x"]), m.atleast_2d(a["X"])),
    "broadcast_to": lambda m, a: m.broadcast_to(a["x"][:5], (3, 5)),
    "column_stack": lambda m, a: m.column_stack([a["x"], a["x"][::-1]]),
    "concatenate": lambda m, a: (m.concatenate([a["X"], a["X"][:2]], axis=0),
                                 m.concatenate([a["X"], a["X"]], axis=-1),
                                 m.concatenate([a["X"], a["Y"][0]], axis=None)),
    "diag": lambda m, a: (m.diag(a["x"][:4]), m.diag(a["x"][:3], 2),
                          m.diag(a["X"]), m.diag(a["X"], -2), m.diag(a["X"], 3)),
    "dstack": lambda m, a: m.dstack([a["X"], a["X"]]),
    "expand_dims": lambda m, a: (m.expand_dims(a["X"], 0),
                                 m.expand_dims(a["X"], (0, -1))),
    "flip": lambda m, a: (m.flip(a["X"]), m.flip(a["Y"], 1),
                          m.flip(a["Y"], (0, 2))),
    "hstack": lambda m, a: (m.hstack([a["x"], a["x"]]), m.hstack([a["X"], a["X"]])),
    "moveaxis": lambda m, a: (m.moveaxis(a["Y"], -1, 0), m.moveaxis(a["Y"], 0, -1),
                              m.moveaxis(a["Y"], [0, 1], [2, 0])),
    "pad": lambda m, a: tuple(
        [m.pad(a["X"], 1), m.pad(a["X"], ((1, 2), (0, 1)), mode="edge"),
         m.pad(a["X"], 2, mode="wrap"), m.pad(a["x"], (2, 3), mode="reflect"),
         m.pad(a["x"], (3, 1), mode="symmetric"),
         m.pad(a["X"], (1, 2), constant_values=7)]),
    "ravel": lambda m, a: m.ravel(a["Y"]),
    "repeat": lambda m, a: (m.repeat(a["x"], 3), m.repeat(a["X"], 2, axis=1),
                            m.repeat(a["X"], 2)),
    "reshape": lambda m, a: (m.reshape(a["Y"], (6, 10)), m.reshape(a["x"], (-1, 3))),
    "reshape_copy": lambda m, a: m.reshape_copy(a["Y"], (10, 6)),
    "roll": lambda m, a: (m.roll(a["x"], 3), m.roll(a["X"], -1, axis=0),
                          m.roll(a["Y"], (1, 2), axis=(0, 2))),
    "sort": lambda m, a: (m.sort(a["x"]), m.sort(a["X"], axis=0),
                          m.sort(a["Y"], axis=None)),
    "split": lambda m, a: m.split(a["X"], [1, 3], axis=0),
    "squeeze": lambda m, a: (m.squeeze(a["Y"][:1, :, 2:3]),
                             m.squeeze(a["Y"][:1], 0)),
    "stack": lambda m, a: (m.stack([a["x"], a["x"]]), m.stack([a["X"], a["X"]], axis=-1)),
    "swapaxes": lambda m, a: m.swapaxes(a["Y"], 0, 2),
    "take": lambda m, a: (m.take(a["x"], np.array([0, 5, -1, 40])),
                          m.take(a["X"], np.array([[1, 2]]), axis=1)),
    "tile": lambda m, a: (m.tile(a["x"], 2), m.tile(a["X"], (2, 1)),
                          m.tile(a["x"][:3], (2, 2))),
    "transpose": lambda m, a: (m.transpose(a["Y"]), m.transpose(a["Y"], (1, 0, 2))),
    "tril": lambda m, a: (m.tril(a["X"]), m.tril(a["X"], -1), m.tril(a["Y"], 1)),
    "triu": lambda m, a: (m.triu(a["X"]), m.triu(a["X"], 2)),
    "vstack": lambda m, a: (m.vstack([a["x"], a["x"]]), m.vstack([a["X"], a["X"]])),
}


def test_every_name_has_a_case():
    assert sorted(CASES) == sorted(NAMES)
    for name in NAMES:
        assert callable(getattr(rt, name))


@pytest.mark.parametrize("dtype", ["int64", "float32"])
@pytest.mark.parametrize("name", NAMES)
def test_manipulation(name, dtype):
    _both(CASES[name], f"{name} {dtype}", x=_values(dtype, (12,), 1),
          X=_values(dtype, (4, 5), 2), Y=_values(dtype, (3, 4, 5), 3))


MOVERS = ["concatenate", "stack", "flip", "pad", "repeat", "tile", "tril",
          "triu", "diag", "roll", "sort", "argsort", "take"]


@pytest.mark.parametrize("dtype", SWEEP)
@pytest.mark.parametrize("name", MOVERS)
def test_data_movement_dtype_sweep(name, dtype):
    _both(CASES[name], f"{name} {dtype}", x=_values(dtype, (12,), 4),
          X=_values(dtype, (4, 5), 5), Y=_values(dtype, (3, 4, 5), 6))


@pytest.mark.parametrize("pair", [("int32", "float32"), ("uint8", "int8"),
                                  ("bool", "int16"), ("float16", "float64"),
                                  ("uint64", "int64"), ("uint32", "int8")])
def test_join_common_dtype(pair):
    """concatenate and stack join in NumPy's common dtype."""
    _both(lambda m, a: (m.concatenate([a["p"], a["q"]]), m.stack([a["p"], a["q"]]),
                        m.vstack([a["q"], a["p"]])), f"join {pair}",
          p=_values(pair[0], (5,), 7), q=_values(pair[1], (5,), 8))


SORT_F = np.array([3.0, np.nan, -0.0, 0.0, 1.0, -np.nan, -0.0, np.inf, -np.inf,
                   0.0, 1.0, -2.0])


@pytest.mark.parametrize("dtype", ["float16", "float32", "float64"])
def test_sort_nans_last_and_signed_zeros_in_order(dtype):
    x = SORT_F.astype(dtype)

    def program(m, a):
        return (m.sort(a["x"]), m.argsort(a["x"]), m.sort(a["X"], axis=1),
                m.argsort(a["X"], axis=0), m.sort(a["X"], axis=None))

    _both(program, f"sort {dtype}", x=x, X=np.stack([x, x[::-1], -x]))
    got = rt.sort(rt.fromarray(x)).asarray()
    assert np.isnan(got[-2:]).all()
    zeros = got[got == 0]
    np.testing.assert_array_equal(np.signbit(zeros), [True, False, True, False])


def test_argsort_stable_ties_and_gathers_to_sort():
    x = np.array([2, 1, 2, 1, 0, 2, 1] * 3, np.int64)
    got = rt.argsort(rt.fromarray(x)).asarray()
    np.testing.assert_array_equal(got, np.argsort(x, kind="stable"))
    assert got.dtype == np.int64
    v = rt.fromarray(np.random.RandomState(9).randn(50))
    np.testing.assert_array_equal(v.asarray()[rt.argsort(v).asarray()],
                                  rt.sort(v).asarray())


def test_sort_unsigned_above_the_sign_bit():
    u = np.array([2 ** 63 + 5, 3, 2 ** 64 - 1, 0, 2 ** 63], np.uint64)
    _both(lambda m, a: (m.sort(a["u"]), m.argsort(a["u"])), "uint64", u=u)
    np.testing.assert_array_equal(rt.sort(rt.fromarray(u)).asarray(), np.sort(u))


def test_sort_refuses_order():
    with pytest.raises(ValueError):
        rt.sort(rt.arange(3), order="x")


# -- the rest of ndarray -----------------------------------------------------


NDARRAY = {
    "squeeze": lambda m, a: (a["Y"][:1, :, 2:3].squeeze(), a["Y"][:1].squeeze(0),
                             a["Y"][:, :1].squeeze(axis=(1,))),
    "reshape_copy": lambda m, a: a["Y"].reshape_copy(6, 10),
    "conj": lambda m, a: a["X"].conj(),
    "divmod": lambda m, a: divmod(a["X"], 3),
    "divmod_array": lambda m, a: divmod(a["X"], a["X"][0] + 100),
    "dot_method": lambda m, a: a["X"].dot(a["X"].T),
    "matmul_ops": lambda m, a: (a["X"] @ a["X"].T, np.ones(4) @ a["X"]),
}


@pytest.mark.parametrize("case", sorted(NDARRAY))
def test_ndarray_methods(case):
    dtype = "float64" if case in ("dot_method", "matmul_ops") else "int64"
    _both(NDARRAY[case], case, X=_values(dtype, (4, 5), 10),
          Y=_values(dtype, (3, 4, 5), 11))


def test_flags_and_flat():
    a = rt.arange(6.0)
    assert a.flags.writeable and a.flags["WRITEABLE"]
    v = a[1:4]
    a.flags.writeable = False
    w = a[2:]
    with pytest.raises(ValueError, match="read-only"):
        a[0] = 1.0
    with pytest.raises(ValueError, match="read-only"):
        w[0] = 1.0
    v[0] = 9.0  # taken before the base was frozen: writes through
    assert a.asarray()[1] == 9.0
    with pytest.raises(ValueError):
        w.flags.writeable = True
    assert list(rt.arange(4).reshape(2, 2).flat) == [0, 1, 2, 3]


def test_squeeze_refuses_a_wide_axis():
    with pytest.raises(ValueError):
        rt.zeros((2, 1)).squeeze(0)
