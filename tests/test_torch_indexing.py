"""Advanced, boolean and mixed indexing and MaskedArray: the port against
ramba_tpu, x64 regime.

Every case runs one program, on inputs made with numpy from a seed and
carried across with ``convert.state_from_reference``, through both packages;
values and dtypes must be equal exactly (NaN where NaN), except masked
float reductions, within rtol=atol=1e-12 of float64 (torch and XLA sum in
other orders).  The cases follow
the indexing cases of ``tests/test_distributed_array.py`` (fancy get and
set, mixed indices, masked writes and reductions) and NumPy's placement
rules for mixed and separated index arrays, with out-of-range and negative
indices: a gather normalises negative indices and clamps, a scatter drops
what stays out of range (XLA's rules, which ramba_tpu inherits).  Scatter
cases use unique indices: the winner of a duplicated index is unspecified
in both packages.
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


def _same(got, want, what, rtol=0.0):
    g, w = _host(got), _host(want)
    assert g.dtype == w.dtype, f"{what}: port {g.dtype} vs ramba_tpu {w.dtype}"
    assert g.shape == w.shape, f"{what}: port {g.shape} vs ramba_tpu {w.shape}"
    if rtol:
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol, err_msg=what)
    else:
        np.testing.assert_array_equal(g, w, err_msg=what)


def _both(program, what, rtol=0.0, **arrays):
    """``program(package, arrays)`` in both packages; every output equal."""
    ref, port = _pair(**arrays)
    want = program(rtj, ref)
    got = program(rt, port)
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    for k, (g, w) in enumerate(zip(got, want)):
        _same(g, w, f"{what} [{k}]", rtol)


def _raises_both(program, **arrays):
    ref, port = _pair(**arrays)
    with pytest.raises(Exception) as e_ref:
        _host(program(rtj, ref))
    kinds = (IndexError, TypeError, ValueError, NotImplementedError)
    assert isinstance(e_ref.value, kinds)
    want = next(k for k in kinds if isinstance(e_ref.value, k))
    with pytest.raises(want):
        _host(program(rt, port))


# -- gathers -------------------------------------------------------------------

I1 = np.array([1, 12, -11, -1, 0, 9])
GATHERS = {
    "list_oob_neg": lambda m, a: a["x"][[1, 12, -11]],
    "numpy_idx": lambda m, a: a["x"][I1],
    "port_idx": lambda m, a: a["x"][m.asarray(I1)],
    "int32_idx": lambda m, a: a["x"][I1.astype(np.int32)],
    "uint8_idx": lambda m, a: a["x"][np.array([3, 250, 0], np.uint8)],
    "idx_2d": lambda m, a: a["x"][np.array([[0, 1], [2, -3]])],
    "of_view": lambda m, a: a["x"][2:][[0, 1, -1]],
    "of_neg_step": lambda m, a: a["x"][::-2][[0, 2, 4]],
}
GATHERS_2D = {
    "rows_slice": lambda m, a: a["X"][np.array([0, 2]), 1:3],
    "pairs": lambda m, a: a["X"][[0, 2], [1, 3]],
    "cols": lambda m, a: a["X"][:, [0, 2]],
    "slice_cols_oob": lambda m, a: a["X"][1:3, [0, 7]],
    "neg_step_rows": lambda m, a: a["X"][::-1, [1, 3]],
    "rows_step": lambda m, a: a["X"][[1, -1], ::2],
    "int_and_array": lambda m, a: a["X"][np.array([0, 2]), 1],
    "broadcast": lambda m, a: a["X"][np.array([[0], [3]]), np.array([1, 2, 4])],
    "newaxis": lambda m, a: a["X"][None, [0, 3]],
    "of_transpose": lambda m, a: a["X"].T[[4, 0]],
}
GATHERS_3D = {
    "separated": lambda m, a: a["Y"][[0, 1], :, [1, 2]],
    "adjacent": lambda m, a: a["Y"][:, [0, 1], [1, 2]],
    "newaxis_separated": lambda m, a: a["Y"][None, [0, 1], 1:3, 0],
    "int_slice_array": lambda m, a: a["Y"][0, :, [1, 2]],
    "ellipsis": lambda m, a: a["Y"][..., [0, 4]],
    "ellipsis_newaxis": lambda m, a: a["Y"][[0], ..., None, 1],
    "none_between": lambda m, a: a["Y"][:, [0, 1], None, [0]],
    "all_arrays": lambda m, a: a["Y"][[2, 0], [3, -1], [4, 0]],
}


@pytest.mark.parametrize("case", sorted(GATHERS))
def test_gather_1d(case):
    _both(lambda m, a: GATHERS[case](m, a), case, x=_values("float64", (10,), 1))


@pytest.mark.parametrize("case", sorted(GATHERS_2D))
def test_gather_2d(case):
    _both(lambda m, a: GATHERS_2D[case](m, a), case,
          X=_values("float64", (4, 5), 2))


@pytest.mark.parametrize("case", sorted(GATHERS_3D))
def test_gather_3d(case):
    _both(lambda m, a: GATHERS_3D[case](m, a), case,
          Y=_values("float32", (3, 4, 5), 3))


def test_gather_clamp_rule():
    """Negative indices are normalised first, then every index clamped:
    ``arange(10.)[[1, 12, -11]]`` is ``[1, 9, 0]``."""
    got = rt.arange(10.0)[[1, 12, -11]]
    np.testing.assert_array_equal(got.asarray(), [1.0, 9.0, 0.0])


@pytest.mark.parametrize("dtype", SWEEP)
def test_gather_dtype_sweep(dtype):
    _both(lambda m, a: (a["X"][[2, -1, 7], 1:], a["X"][:, [0, 3]]), dtype,
          X=_values(dtype, (6, 4), 4))


# -- scatters ------------------------------------------------------------------

SCATTERS = {
    "oob_dropped": lambda m, a: a["b"].__setitem__([1, 12], 5.0),
    "neg_values": lambda m, a: a["b"].__setitem__(
        [1, -1, -11], np.array([5.0, 6.0, 7.0])),
    "port_idx": lambda m, a: a["b"].__setitem__(
        m.asarray(np.array([3, 7, 1, 42, 0])), 7.0),
    "int_cast": lambda m, a: a["b"].__setitem__(np.array([0, 4]), 2.7),
    "port_value": lambda m, a: a["b"].__setitem__(np.array([2, 3]), a["v"]),
}
SCATTERS_ND = {
    "int_slice_array": (lambda m, a: a["Z"].__setitem__(
        (0, slice(None), [1, 2]), np.arange(8.0).reshape(2, 4))),
    "neg_step": (lambda m, a: a["Z"].__setitem__(
        (slice(None, None, -1), [1, 3], slice(1, 4, 2)),
        np.arange(12.0).reshape(3, 2, 2))),
    "newaxis_oob": (lambda m, a: a["Z"].__setitem__(
        (None, [0, 2], slice(1, 3), [4, 9]), 7.0)),
    "mixed_scalar": (lambda m, a: a["Z"].__setitem__(
        (m.asarray(np.array([0, 2])), 1), 9.0)),
    "broadcast_value": (lambda m, a: a["Z"].__setitem__(
        (slice(None), [0, -1]), np.arange(5.0))),
    "pairs": (lambda m, a: a["Z"].__setitem__(([0, 1, 2], [3, 2, 1]),
                                              np.arange(15.0).reshape(3, 5))),
}


def _after(setter):
    def program(m, a):
        setter(m, a)
        return tuple(a[k] for k in sorted(a))

    return program


@pytest.mark.parametrize("case", sorted(SCATTERS))
def test_scatter_1d(case):
    b = _values("int64" if case == "int_cast" else "float64", (10,), 5)
    _both(_after(SCATTERS[case]), case, b=b, v=np.array([-1.5, 2.5]))


@pytest.mark.parametrize("case", sorted(SCATTERS_ND))
def test_scatter_nd(case):
    _both(_after(SCATTERS_ND[case]), case, Z=_values("float64", (3, 4, 5), 6))


def test_scatter_drop_rule():
    """A write whose index stays out of range is dropped:
    ``b[[1, 12]] = 5`` changes only ``b[1]``."""
    b = rt.arange(10.0)
    b[[1, 12]] = 5
    np.testing.assert_array_equal(b.asarray(), [0, 5, 2, 3, 4, 5, 6, 7, 8, 9])


@pytest.mark.parametrize("dtype", SWEEP)
def test_scatter_dtype_sweep(dtype):
    v = _values(dtype, (3, 2), 7)

    def program(m, a):
        a["X"][[4, -1, 0], 1:3] = a["v"]
        a["X"][[2], [0]] = a["v"][0, 0]
        return a["X"]

    _both(program, dtype, X=_values(dtype, (6, 4), 8), v=v)


def test_scatter_through_views():
    """A scatter into a view writes the base (NumPy's aliasing)."""
    def program(m, a):
        t = a["X"].T
        t[[0, 2]] = -1.0
        r = a["X"][1:]
        r[[0, -1], [1, 1]] = 5.0
        return a["X"]

    _both(program, "views", X=_values("float64", (4, 3), 9))


def test_duplicate_scatter_holds_a_written_value():
    x = rt.zeros(8)
    x[[1, 1, 3, 3, 3]] = np.array([10.0, 20.0, 30.0, 40.0, 50.0])
    got = x.asarray()
    assert got[1] in (10.0, 20.0) and got[3] in (30.0, 40.0, 50.0)
    assert got[[0, 2, 4, 5, 6, 7]].tolist() == [0.0] * 6


# -- errors --------------------------------------------------------------------

ERRORS = {
    "float_index": lambda m, a: a["X"][m.arange(2.0)],
    "bool_in_tuple": lambda m, a: a["X"][np.array([True, False, True, False]), 0],
    "bool_list": lambda m, a: a["X"][[True, False, True, False]],
    "int_oob_basic": lambda m, a: a["X"][7],
    "take_raise": lambda m, a: a["X"].take(np.array([1]), mode="raise"),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_index_errors(case):
    _raises_both(lambda m, a: ERRORS[case](m, a), X=_values("float64", (4, 5), 10))


# -- take ------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bool", "int8", "int32", "uint8", "uint32",
                                   "uint64", "float16", "float64",
                                   "complex128"])
@pytest.mark.parametrize("mode", ["clip", "wrap", "fill"])
def test_take_modes(mode, dtype):
    idx = np.array([1, 12, -3, -13, 0])

    def program(m, a):
        return (a["x"].take(idx, mode=mode),
                a["X"].take(idx.reshape(1, 5), axis=1, mode=mode),
                m.take(a["x"], np.array([[2, 1], [0, 3]])))

    _both(program, f"take {mode} {dtype}", x=_values(dtype, (10,), 11),
          X=_values(dtype, (3, 4), 12))


def test_take_pinned_values():
    a = rt.arange(10.0)
    np.testing.assert_array_equal(a.take(np.array([1, 12, -3]), mode="clip")
                                  .asarray(), [1.0, 9.0, 0.0])
    np.testing.assert_array_equal(a.take(np.array([1, 12, -3]), mode="fill")
                                  .asarray(), [1.0, np.nan, 7.0])
    got = rt.arange(10).astype("int32").take(np.array([1, 12, -3]), mode="fill")
    np.testing.assert_array_equal(got.asarray(), [1, -2147483648, 7])
    with pytest.raises(NotImplementedError):
        a.take(np.array([1]), mode="raise")


# -- boolean masks and MaskedArray -------------------------------------------


def test_mask_gives_masked_array():
    m = rt.arange(-3.0, 4.0)
    mm = m[m > 0]
    assert isinstance(mm, rt.MaskedArray) and mm.shape == (7,)
    np.testing.assert_array_equal(np.asarray(mm), np.arange(-3.0, 4.0))
    np.testing.assert_array_equal(mm.compressed(), [1.0, 2.0, 3.0])
    c = mm.count()
    assert isinstance(c, rt.ndarray) and c.shape == () and int(c) == 3
    m[m > 0] += 10
    np.testing.assert_array_equal(m.asarray(), [-3, -2, -1, 0, 11, 12, 13])
    mm += 1  # guarded: only the selected elements change
    np.testing.assert_array_equal(m.asarray(), [-3, -2, -1, 0, 12, 13, 14])


MASKED = {
    "inplace_add": lambda m, a: (a["a"].__setitem__(
        a["a"] > 10, a["a"][a["a"] > 10] + 100.0), a["a"])[1],
    "iadd": lambda m, a: _iadd_masked(a["a"]),
    "set_scalar": lambda m, a: (a["a"].__setitem__(a["a"] < 5, -1.0),
                                a["a"])[1],
    "set_array": lambda m, a: (a["a"].__setitem__(a["a"] < 0, a["b"]),
                               a["a"])[1],
    "host_mask": lambda m, a: (a["a"].__setitem__(np.arange(20) % 3 == 0, 7),
                               a["a"])[1],
    "masked_map": lambda m, a: m.asarray(
        np.asarray(a["a"][a["a"] > 0] * 2.0)),
    "reductions": lambda m, a: tuple(
        getattr(a["a"][a["a"] > 0], r)() for r in ("sum", "mean", "min", "max",
                                                   "prod")),
    "axis_reductions": lambda m, a: tuple(
        getattr(a["a"].reshape(4, 5)[a["a"].reshape(4, 5) > 0], r)(axis=1)
        for r in ("sum", "mean", "max")),
    "var_std": lambda m, a: tuple(
        r for d in (0, 1, 2) for r in (a["a"][a["a"] > 0].var(ddof=d),
                                       a["a"][a["a"] > 0].std(ddof=d))),
    "count": lambda m, a: a["a"][a["a"] > -3].count(),
    "int_inplace_cast": lambda m, a: _iadd_int(a["i"]),
    "bool_minmax": lambda m, a: (a["t"][a["t"]].max(), a["t"][a["t"]].min()),
}


def _iadd_masked(x):
    mm = x[x > 0]
    mm += 1.5
    mm *= 2
    return x


def _iadd_int(i):
    mm = i[i > 0]
    mm += 0.7  # cast back to int32, guarded
    return i


SUMMED = ("reductions", "axis_reductions", "var_std")


@pytest.mark.parametrize("case", sorted(MASKED))
def test_masked(case):
    rs = np.random.RandomState(13)
    _both(lambda m, a: MASKED[case](m, a), case,
          rtol=1e-12 if case in SUMMED else 0.0,
          a=np.round(rs.randn(20) * 10, 3), b=rs.randn(20),
          i=rs.randint(-5, 5, 20).astype(np.int32),
          t=np.array([True, False, True]))


def test_masked_array_host_mask_and_shape_check():
    v = np.random.RandomState(7).rand(8, 8)
    sel = v <= 0.8
    m = rt.MaskedArray(rt.fromarray(v), mask=sel)
    want = rtj.MaskedArray(rtj.fromarray(v), mask=sel)
    for got, ref in ((m.mean(), want.mean()), (m.var(ddof=1), want.var(ddof=1)),
                     (m.count(), want.count())):
        _same(got, ref, "host mask", rtol=1e-12)
    with pytest.raises(ValueError, match="mask shape"):
        rt.MaskedArray(rt.fromarray(v), mask=sel[:4])


def test_masked_never_compacts_on_the_graph():
    """A masked write and a masked reduction are one select and one
    ``reduce_where`` node: nothing waits on the mask's count."""
    a = rt.arange(-5.0, 5.0)
    a[a > 0] += 1.0
    assert a.read_expr().op == "masked_fill"
    s = a[a < 0].sum()
    assert s.read_expr().op == "reduce_where"
    assert float(s) == -15.0
