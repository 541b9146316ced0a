"""``ops/extras.py``: the port against ramba_tpu, x64 regime.

Every name of ``ramba_tpu/__init__.py:57-72`` runs through both packages on
the same seeded inputs (carried across with ``convert.state_from_reference``)
over the dtype sweep, bool to complex128, wherever ramba_tpu accepts the
dtype; where it refuses one, the port must refuse it with the same
exception class.  Values and dtypes are compared exactly (NaN where NaN,
the signs of zeros too) where the arithmetic is the same; where the order
of a float sum differs (trapezoid's and cov's sums, the scan behind
nancumsum and unwrap, conv1d's products, bincount's weighted sums), each
value is held within ``k`` ulp of ramba_tpu's at the magnitude of the
values summed, with ``k`` stated per case.  The host boundaries return
NumPy's results, compared exactly.  The cases follow
``tests/test_numpy_breadth.py``.
"""

import numpy as np
import pytest
import torch

import jax
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from ramba_tpu_torch import common, convert
from ramba_tpu_torch.ops import scan

SWEEP = ["bool", "int8", "int16", "int32", "int64", "uint8", "uint16",
         "uint32", "uint64", "float16", "float32", "float64", "complex64",
         "complex128"]
REALS = [d for d in SWEEP if not d.startswith("complex")]
FLOATS = ["float16", "float32", "float64"]

# ramba_tpu/__init__.py:57-72, every name it takes from ops/extras.py
NAMES = [
    "append", "apply_along_axis", "apply_over_axes", "argpartition",
    "argwhere", "around", "array_equiv", "atleast_3d", "bartlett",
    "bincount", "blackman", "block", "broadcast_arrays", "compress",
    "convolve", "copyto", "corrcoef", "correlate", "cov", "cross", "delete",
    "diag_indices", "diagonal", "diff", "digitize", "divmod", "dsplit",
    "ediff1d", "extract", "fill_diagonal", "fix", "flatnonzero", "fliplr",
    "flipud", "frexp", "gradient", "hamming", "hanning", "histogram",
    "histogram2d", "hsplit", "in1d", "insert", "interp", "intersect1d",
    "isin", "ix_", "kaiser", "kron", "lexsort", "modf", "nan_to_num",
    "nancumprod", "nancumsum", "nanmedian", "nanpercentile", "nanquantile",
    "nonzero", "packbits", "partition", "percentile", "piecewise", "place",
    "poly", "polyfit", "polyval", "put_along_axis", "putmask", "quantile",
    "ravel_multi_index", "real_if_close", "require", "resize", "roots",
    "rot90", "row_stack", "searchsorted", "setdiff1d", "setxor1d",
    "sort_complex", "take_along_axis", "trapezoid", "trapz", "tril_indices",
    "tril_indices_from", "trim_zeros", "triu_indices", "triu_indices_from",
    "union1d", "unique", "unpackbits", "unravel_index", "unwrap", "vander",
    "vsplit",
]


@pytest.fixture(autouse=True)
def _port_on_cpu():
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    torch.set_num_threads(1)


def _values(dtype, shape, seed, special=False):
    rs = np.random.RandomState(seed)
    if dtype == "bool":
        return rs.rand(*shape) > 0.5
    kind = np.dtype(dtype).kind
    if kind == "u":
        return rs.randint(0, 60, shape).astype(dtype)
    if kind == "i":
        return rs.randint(-50, 50, shape).astype(dtype)
    if kind == "c":
        out = np.empty(shape, dtype)
        out.real = rs.randn(*shape) * 4
        out.imag = rs.randn(*shape) * 4
        if special:
            flat = out.reshape(-1)
            flat.real[::5] = np.nan
            flat.imag[2] = np.inf
            flat[3] = complex(-0.0, 0.0)
        return out
    out = (rs.randn(*shape) * 4).astype(dtype)
    if special:
        flat = out.reshape(-1)
        flat[::5] = np.nan
        flat[2] = np.inf
        flat[3] = -np.inf
        flat[4] = -0.0
    return out


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


def _parts(a):
    return [a.real, a.imag] if a.dtype.kind == "c" else [a]


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


def _ulps(got, want, what, k, scale=None):
    """Within ``k`` ulp of ramba_tpu's at ``scale`` (default: the largest
    magnitude in the result); NaN and infinities where ramba_tpu has
    them."""
    g, w = _host(got), _host(want)
    assert g.dtype == w.dtype, f"{what}: port {g.dtype} vs ramba_tpu {w.dtype}"
    assert g.shape == w.shape, f"{what}: port {g.shape} vs ramba_tpu {w.shape}"
    if g.dtype.kind not in "fc":
        np.testing.assert_array_equal(g, w, err_msg=what)
        return
    for gp, wp in zip(_parts(g), _parts(w)):
        np.testing.assert_array_equal(np.isnan(gp), np.isnan(wp),
                                      err_msg=f"{what}: NaN positions")
        inf = np.isinf(wp)
        np.testing.assert_array_equal(gp[inf], wp[inf],
                                      err_msg=f"{what}: infinities")
        fin = np.isfinite(wp)
        if not fin.any():
            continue
        s = scale if scale is not None else np.abs(w[np.isfinite(w)]).max()
        tol = k * np.spacing(np.asarray(s, dtype=gp.dtype))
        err = np.abs(gp[fin].astype(np.float64) - wp[fin].astype(np.float64))
        assert (err <= tol).all(), (
            f"{what}: max error {err.max()} beyond {k} ulp at {s} ({tol})")


def _run(case, arrays, dtype):
    """Run ``case(m, **arrays)`` through both packages: the same exception
    class, or results of the same dtypes and shapes."""
    ref, port = _pair(**arrays)
    try:
        want = case(rtj, **ref)
        want = [_host(w) for w in _flat(want)]
    except Exception as e:  # ramba_tpu refuses: so must the port
        with pytest.raises(type(e)):
            got = case(rt, **port)
            [_host(g) for g in _flat(got)]
        return None, None
    got = [_host(g) for g in _flat(case(rt, **port))]
    assert len(got) == len(want)
    return got, want


def _check(case, arrays, dtype, what, k=0, scale=None):
    got, want = _run(case, arrays, dtype)
    if got is None:
        return
    for i, (g, w) in enumerate(zip(got, want)):
        if k:
            _ulps(g, w, f"{what}[{i}] {dtype}", k, scale)
        else:
            _same(g, w, f"{what}[{i}] {dtype}")


# -- compositions ---------------------------------------------------------------

COMPOSED = {
    "diff": lambda m, a, b: m.diff(a),
    "diff_n2_axis0": lambda m, a, b: m.diff(b, n=2, axis=0),
    "ediff1d": lambda m, a, b: m.ediff1d(b),
    "nan_to_num": lambda m, a, b: m.nan_to_num(a),
    "nan_to_num_values": lambda m, a, b: m.nan_to_num(a, nan=-1.5,
                                                      posinf=9.0, neginf=-9.0),
    "fix": lambda m, a, b: m.fix(a),
    "around": lambda m, a, b: m.around(a),
    "around_1": lambda m, a, b: m.around(a, 1),
    "around_-1": lambda m, a, b: m.around(a, -1),
    "modf": lambda m, a, b: m.modf(a),
    "divmod": lambda m, a, b: m.divmod(b, b[0] + (b[0] == 0)),
    "polyval": lambda m, a, b: m.polyval(b[1, :4], a),
    "vander": lambda m, a, b: m.vander(b[0, :5], 4),
    "vander_increasing": lambda m, a, b: m.vander(b[0, :5], increasing=True),
    "rot90": lambda m, a, b: [m.rot90(b, k) for k in range(4)],
    "fliplr_flipud": lambda m, a, b: [m.fliplr(b), m.flipud(b)],
    "atleast_3d": lambda m, a, b: [m.atleast_3d(a), m.atleast_3d(b)],
    "broadcast_arrays": lambda m, a, b: m.broadcast_arrays(b, b[0]),
    "splits": lambda m, a, b: [m.vsplit(b, 3), m.hsplit(b, 2),
                               m.hsplit(a, [2, 5]),
                               m.dsplit(b.reshape(3, 2, 2), 2)],
    "row_stack": lambda m, a, b: m.row_stack([b, b]),
    "append": lambda m, a, b: [m.append(a, b), m.append(b, b, axis=1)],
    "block": lambda m, a, b: m.block([[b, b], [b, b]]),
    "require": lambda m, a, b: m.require(a),
    "frexp": lambda m, a, b: m.frexp(a),
    "take_along_axis": lambda m, a, b: m.take_along_axis(
        b, m.argsort(b, axis=1), 1),
    "diagonal": lambda m, a, b: [m.diagonal(b), m.diagonal(b, 1),
                                 m.diagonal(b, -1)],
    "gradient": lambda m, a, b: [m.gradient(a)] + list(m.gradient(b)),
    "kron": lambda m, a, b: m.kron(b[:, :2], b[:2]),
    "cross": lambda m, a, b: [m.cross(b[:, :3], b[:, 1:]),
                              m.cross(a[:2], a[2:4])],
    "lexsort": lambda m, a, b: m.lexsort([b[0], b[1]]),
    "sort_complex": lambda m, a, b: m.sort_complex(a),
    "partition": lambda m, a, b: [m.partition(a, 3), m.partition(b, 1, axis=0)],
    "argpartition": lambda m, a, b: [m.argpartition(a, 3),
                                     m.argpartition(b, 1)],
    "searchsorted": lambda m, a, b: [m.searchsorted(m.sort(a), b),
                                     m.searchsorted(m.sort(a), b,
                                                    side="right")],
    "digitize": lambda m, a, b: [m.digitize(b, m.sort(a)),
                                 m.digitize(b, m.sort(a), right=True),
                                 m.digitize(b, m.flip(m.sort(a)))],
    "isin": lambda m, a, b: [m.isin(b, a[::3]), m.in1d(b, a[::3])],
    "interp": lambda m, a, b: [m.interp(b, m.sort(a), a),
                               m.interp(b, m.sort(a), a, left=-1, right=2)],
}

# values that move through the same arithmetic: exact; the sums: k ulp
SUMS = {
    "trapezoid": (lambda m, a, b: [m.trapezoid(b), m.trapezoid(b, dx=0.5),
                                   m.trapezoid(a, m.sort(a))], 8),
    "cov": (lambda m, a, b: [m.cov(b), m.cov(b, rowvar=False),
                             m.cov(b, bias=True), m.cov(b[0], b[1], ddof=0)],
            32),
    "corrcoef": (lambda m, a, b: m.corrcoef(b), 32),
    "nancumsum": (lambda m, a, b: [m.nancumsum(a), m.nancumsum(b, axis=1)],
                  16),
    "nancumprod": (lambda m, a, b: [m.nancumprod(a / 4 if a.dtype.kind in "fc"
                                                 else a),
                                    m.nancumprod(b, axis=0)], 16),
    "unwrap": (lambda m, a, b: m.unwrap(a * 3), 16),
    "convolve": (lambda m, a, b: [m.convolve(a, b[0, :3]),
                                  m.convolve(a, b[0, :3], "same"),
                                  m.convolve(b[0, :3], a, "valid")], 16),
    "correlate": (lambda m, a, b: [m.correlate(a, b[0, :3]),
                                   m.correlate(b[0, :3], a, "full"),
                                   m.correlate(a, b[0, :3], "same")], 16),
}


# float results of arithmetic XLA's CPU compiler rewrites (a division by a
# constant into a product with its reciprocal, products and sums into fused
# multiply-adds, exp2 by its own approximation): within k ulp of the
# largest magnitude in the result; integer results stay exact
ARITH = {"around_1": 2, "cross": 4, "frexp": 4, "interp": 4, "kron": 2,
         "polyval": 4, "vander": 4, "vander_increasing": 4}


@pytest.mark.parametrize("dtype", SWEEP)
@pytest.mark.parametrize("name", sorted(COMPOSED))
def test_composed_and_calls(name, dtype):
    a = _values(dtype, (12,), 1)
    b = _values(dtype, (3, 4), 2)
    if name.startswith("nan_to_num"):
        a = _values(dtype, (12,), 1, special=True)
    _check(COMPOSED[name], {"a": a, "b": b}, dtype, name, k=ARITH.get(name, 0))


@pytest.mark.parametrize("dtype", SWEEP)
@pytest.mark.parametrize("name", sorted(SUMS))
def test_sums_within_ulps(name, dtype):
    case, k = SUMS[name]
    special = name.startswith("nancum")
    a = _values(dtype, (12,), 3, special=special)
    b = _values(dtype, (3, 4), 4, special=special)
    if special:  # the cumulative values run far past the inputs
        fin = np.where(np.isfinite(a.astype(np.complex128)), a, 0)
        scale = float(np.sum(np.abs(fin.astype(np.complex128))) ** 2 + 1)
        _check(case, {"a": a, "b": b}, dtype, name, k=k, scale=scale)
    else:
        _check(case, {"a": a, "b": b}, dtype, name, k=k)


@pytest.mark.parametrize("dtype", SWEEP)
@pytest.mark.parametrize("fn", ["quantile", "percentile", "nanquantile",
                                "nanpercentile"])
@pytest.mark.parametrize("method", ["linear", "lower", "higher", "nearest",
                                    "midpoint"])
def test_quantiles(fn, method, dtype):
    a = _values(dtype, (15,), 5, special=fn.startswith("nan"))
    if np.dtype(dtype).kind == "f" and fn.startswith("nan"):
        a[np.isinf(a)] = 1.5  # NaNs dropped, infinities kept out
    b = _values(dtype, (3, 5), 6)
    q = 0.3 if fn.endswith("quantile") else 30.0
    qs = [0.1, 0.5, 0.9] if fn.endswith("quantile") else [10.0, 50.0, 90.0]

    def case(m, a, b):
        f = getattr(m, fn)
        return [f(a, q, method=method), f(a, qs, method=method),
                f(b, q, axis=1, method=method),
                f(b, qs, axis=0, keepdims=True, method=method),
                f(b, q, keepdims=True, method=method)]

    # linear and midpoint interpolate: XLA fuses the products and sums (2
    # ulp of the largest value); the others select, exactly
    k = 2 if method in ("linear", "midpoint") else 0
    _check(case, {"a": a, "b": b}, dtype, f"{fn} {method}", k=k)


@pytest.mark.parametrize("dtype", SWEEP)
def test_bincount(dtype):
    x = np.random.RandomState(7).randint(0, 9, 40)
    w = _values(dtype, (40,), 8)

    def case(m, x, w):
        return [m.bincount(x), m.bincount(x, minlength=12),
                m.bincount(x, weights=w)]

    k = 8 if np.dtype(dtype).kind in "fc" else 0
    _check(case, {"x": x, "w": w}, dtype, "bincount", k=k)


def test_bincount_refuses_negative():
    for m in (rtj, rt):
        with pytest.raises(ValueError):
            m.bincount(m.fromarray(np.array([1, -1, 2])))


# -- nancumsum reaches the scan (the CPU runs its plain version) ---------------


def test_nancumsum_is_a_select_before_the_scan():
    x = rt.fromarray(_values("float64", (64,), 9, special=True))
    y = rt.nancumsum(x)
    ops = []
    stack = [y.read_expr()]
    while stack:
        e = stack.pop()
        if hasattr(e, "op"):
            ops.append(e.op if e.op != "map" else e.static[0])
            stack.extend(e.args)
    assert ops[0] == "cumulative" and "where" in ops and "isnan" in ops
    assert np.dtype(y.dtype) == np.float64
    assert "float64" in [str(d) for d in scan.DTYPES] or torch.float64 in \
        scan.DTYPES


# -- in-place writers ------------------------------------------------------------


WRITERS = {
    "copyto": lambda m, a, b: m.copyto(a, b),
    "copyto_where": lambda m, a, b: m.copyto(a, b, where=b > b[0, 0]),
    "fill_diagonal": lambda m, a, b: m.fill_diagonal(a, b[0, :2]),
    "fill_diagonal_wrap": lambda m, a, b: m.fill_diagonal(a, 7, wrap=True),
    "putmask": lambda m, a, b: m.putmask(a, b > b[1, 1], b[0, :3]),
    "place": lambda m, a, b: m.place(a, b > b[1, 1], b[0, :3]),
    "put_along_axis": lambda m, a, b: m.put_along_axis(
        a, m.argsort(b, axis=1)[:, :2], b[:, :2], 1),
}


@pytest.mark.parametrize("dtype", REALS)
@pytest.mark.parametrize("name", sorted(WRITERS))
def test_in_place_writers(name, dtype):
    a0 = _values(dtype, (7, 4) if "wrap" in name else (4, 4), 10)
    b = _values(dtype, (4, 4), 11)
    ref, port = _pair(a=a0, b=b)
    WRITERS[name](rtj, ref["a"], ref["b"])
    WRITERS[name](rt, port["a"], port["b"])
    _same(port["a"], ref["a"], name)


@pytest.mark.parametrize("name", ["copyto", "fill_diagonal", "putmask",
                                  "place"])
def test_writer_through_a_view_mutates_its_base(name):
    a0 = _values("float64", (6, 8), 12)
    b = _values("float64", (4, 4), 13)
    ref, port = _pair(a=a0, b=b)
    for m, d in ((rtj, ref), (rt, port)):
        WRITERS[name](m, d["a"][1:5, 2:6], d["b"])
    _same(port["a"], ref["a"], f"{name} through a view")


# -- host boundaries -------------------------------------------------------------


HOST = {
    "unique": lambda m, a: m.unique(a, return_index=True, return_inverse=True,
                                    return_counts=True),
    "nonzero": lambda m, a: m.nonzero(a),
    "flatnonzero": lambda m, a: m.flatnonzero(a),
    "argwhere": lambda m, a: m.argwhere(a),
    "extract": lambda m, a: m.extract(a > 0, a),
    "compress": lambda m, a: m.compress([True, False, True], a),
    "setops": lambda m, a: [m.setdiff1d(a, a[:3]), m.union1d(a, a[:3]),
                            m.intersect1d(a, a[2:5]), m.setxor1d(a, a[:4])],
    "insert_delete": lambda m, a: [m.insert(a, 2, a[:2]), m.delete(a, [0, 3])],
    "histogram": lambda m, a: list(m.histogram(a, bins=4)),
    "histogram2d": lambda m, a: list(m.histogram2d(a, a, bins=3)),
    "trim_zeros": lambda m, a: m.trim_zeros(a),
    "array_equiv": lambda m, a: m.array_equiv(a, a),
    "resize": lambda m, a: m.resize(a, (3, 5)),
    "real_if_close": lambda m, a: m.real_if_close(a),
    "poly_roots": lambda m, a: [m.poly(a[:3]), m.roots(a[:3])],
    "polyfit": lambda m, a: m.polyfit(a, a * 2, 1),
    "piecewise": lambda m, a: m.piecewise(a, [a < 0, a >= 0],
                                          [lambda v: -v, lambda v: v]),
    "apply": lambda m, a: [m.apply_along_axis(np.sum, 0, a),
                           m.apply_over_axes(np.sum, a, [0])],
    "unravel": lambda m, a: [m.unravel_index(np.array([3, 7]), (2, 5)),
                             m.ravel_multi_index(([1, 0], [2, 3]), (2, 5))],
}


@pytest.mark.parametrize("dtype", ["int32", "int64", "float32", "float64"])
@pytest.mark.parametrize("name", sorted(HOST))
def test_host_boundaries(name, dtype):
    a = _values(dtype, (12,), 14)
    a[[4, 9]] = 0
    _check(HOST[name], {"a": a}, dtype, name)


@pytest.mark.parametrize("name", ["packbits", "unpackbits"])
def test_bit_packing(name):
    bits = _values("uint8", (16,), 15) % 2
    _check(lambda m, a: getattr(m, name)(a), {"a": bits.astype(np.uint8)},
           "uint8", name)


def test_windows_and_index_helpers():
    for fn, args in [("bartlett", (7,)), ("blackman", (7,)), ("hamming", (7,)),
                     ("hanning", (7,)), ("kaiser", (7, 3.0))]:
        _same(getattr(rt, fn)(*args), getattr(rtj, fn)(*args), fn)
    for fn, args in [("tril_indices", (4,)), ("triu_indices", (4, 1)),
                     ("diag_indices", (3,)), ("ix_", ([0, 1], [2, 3]))]:
        for g, w in zip(_flat(getattr(rt, fn)(*args)),
                        _flat(getattr(rtj, fn)(*args))):
            _same(g, w, fn)
    x = np.zeros((3, 3))
    for fn in ("tril_indices_from", "triu_indices_from"):
        for g, w in zip(getattr(rt, fn)(x), getattr(rtj, fn)(x)):
            _same(g, w, fn)


def test_every_name_is_exported_and_registered():
    from ramba_tpu_torch.core.interop import HANDLED_FUNCTIONS

    missing = [n for n in NAMES if not hasattr(rt, n)]
    assert not missing, missing
    ref = [n for n in NAMES if getattr(np, n, None) in
           rtj.core.interop.HANDLED_FUNCTIONS]
    unregistered = [n for n in ref if getattr(np, n) not in HANDLED_FUNCTIONS]
    assert not unregistered, unregistered


@pytest.mark.parametrize("name", ["diff", "cov", "quantile", "searchsorted",
                                  "convolve", "nancumsum", "unique", "isin",
                                  "interp", "trapezoid", "kron", "bincount"])
def test_numpy_dispatch_returns_the_ports_result(name):
    a = rt.fromarray(np.abs(_values("float64", (12,), 16)))
    i = rt.fromarray(np.arange(12) % 4)
    args = {"diff": (a,), "cov": (a.reshape(3, 4),), "quantile": (a, 0.4),
            "searchsorted": (rt.sort(a), a), "convolve": (a, a[:3]),
            "nancumsum": (a,), "unique": (i,), "isin": (i, i[:2]),
            "interp": (a, rt.sort(a), a), "trapezoid": (a,),
            "kron": (a[:3], a[:2]), "bincount": (i,)}[name]
    got = getattr(np, name)(*args)
    want = getattr(rt, name)(*args)
    assert type(got) is type(want)
    for g, w in zip(_flat(got), _flat(want)):
        _same(g, w, f"np.{name}")
