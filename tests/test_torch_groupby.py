"""groupby in the port (``ramba_tpu_torch/groupby.py``) against ramba_tpu.

The same seeded numpy inputs go through ``ramba_tpu`` and
``ramba_tpu_torch`` on the CPU.  1-D sum/prod/min/max/count programs are
the ones the segred classifier takes (on the CPU its wrapper runs the plain
version, ``tests/test_torch_segred.py`` holds it against ramba_tpu's Pallas
kernel); every other reduction runs the port's generic lowering.

Tolerances: integers, bools, min, max and count exactly, dtypes always
exactly; float sums, products, means and the binops rtol=1e-12 (float64) and
rtol=1e-5 (float32): the two packages add in other orders.  var is
``s2/cnt - mean*mean``, which cancels: it is held within the same rtol times
the largest x**2, and std is held by its square.
"""

import numpy as np
import pytest
import torch

import jax
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from ramba_tpu_torch import common, convert
from ramba_tpu_torch.core import fuser
from ramba_tpu_torch.ops import kernel_backend as kb

KINDS = ["sum", "prod", "min", "max", "count", "mean", "var", "std",
         "nansum", "nanmean", "nanvar", "nanstd"]
DTYPES = ["bool", "int32", "int64", "float32", "float64", "complex64",
          "complex128"]
RTOL = {"float32": 1e-5, "float64": 1e-12, "complex64": 1e-5,
        "complex128": 1e-12}
G = 3


@pytest.fixture(autouse=True)
def _port_on_cpu():
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    # one thread: the tier-1 run shares the CPU among its workers, and
    # timing-sensitive tests of other files run beside these
    torch.set_num_threads(1)


def _pair(**arrays):
    ref = {k: rtj.fromarray(v) for k, v in arrays.items()}
    port = convert.state_from_reference({k: a.asarray() for k, a in ref.items()})
    return ref, port


def _same(got, want, what="", var_of=None):
    """``var_of``: the data of a var/std result (its cancellation bound)."""
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype, f"{what}: port {g.dtype} vs ramba_tpu {w.dtype}"
    assert g.shape == w.shape, what
    if w.dtype.kind in "biu":
        np.testing.assert_array_equal(g, w, err_msg=what)
        return
    r = RTOL[w.dtype.name]
    atol = 0.0
    if var_of is not None:
        atol = r * float(np.nanmax(np.square(var_of.astype(np.float64))))
        if "std" in what:
            g, w = np.square(g.astype(np.float64)), np.square(w.astype(np.float64))
    np.testing.assert_allclose(g, w, rtol=r, atol=atol, err_msg=what)


# labels of the 12 grouped entries: three groups, one label below the range
# and one above it (both dropped)
LABELS = np.array([0, 1, 2, 0, -1, 2, 0, 1, 2, 3, 1, 2])


def _data(dtype, layout, seed=0):
    rs = np.random.RandomState(seed)
    shape = {"1d": (12,), "dim0": (12, 5), "dim1": (4, 12)}[layout]
    if dtype == "bool":
        return rs.rand(*shape) > 0.4
    if dtype.startswith("int"):
        return rs.randint(-4, 6, shape).astype(dtype)
    x = (rs.rand(*shape) + 0.5).astype(dtype)
    if dtype.startswith("complex"):
        x = x + 1j * (rs.rand(*shape) - 0.5).astype(dtype)
    x.reshape(-1)[5] = np.nan  # nan kinds skip it, the others propagate it
    return x


_ref_cache: dict = {}


def _refs(dtype, layout):
    """ramba_tpu's result of every kind, in one flush."""
    key = (dtype, layout)
    if key not in _ref_cache:
        g = rtj.fromarray(_data(dtype, layout)).groupby(
            1 if layout == "dim1" else 0, LABELS, G)
        lazy = {k: getattr(g, k)() for k in KINDS}
        _ref_cache[key] = {k: np.asarray(v) for k, v in lazy.items()}
    return _ref_cache[key]


@pytest.mark.parametrize("layout", ["1d", "dim0", "dim1"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_reduction_matches_ramba_tpu(kind, dtype, layout):
    (x,) = convert.state_from_reference(
        {"x": _data(dtype, layout)}).values()
    g = x.groupby(1 if layout == "dim1" else 0, LABELS, G)
    got = getattr(g, kind)()
    p, vals = fuser.prepare_program([got.read_expr()])
    seg = (layout == "1d" and kind in kb.SEG_OK
           and not (dtype == "bool" and kind in ("min", "max"))
           and dtype in kb.GPU_DTYPES)  # complex data: the generic lowering
    assert kb.classify(p, vals) == ("segred" if seg else None)
    _same(got, _refs(dtype, layout)[kind], f"{kind} {dtype} {layout}",
          var_of=_data(dtype, layout) if "var" in kind or "std" in kind
          else None)


def test_segment_reduce_dtype_rule_matches_ramba_tpu():
    """The aval rule (no op run) gives ramba_tpu's dtypes: int32 sums in
    int64, means in float64, float32 stays float32, count is int64."""
    from ramba_tpu_torch.groupby import segment_dtype

    for dtype in DTYPES:
        for kind in KINDS:
            want = _refs(dtype, "dim0")[kind].dtype
            assert segment_dtype(kind, dtype) == want, (kind, dtype)
    assert segment_dtype("sum", "int32") == np.int64
    assert segment_dtype("mean", "int32") == np.float64
    assert segment_dtype("var", "float32") == np.float32


def test_out_of_range_labels_are_dropped():
    labels = np.arange(1024) % 8
    labels[::97] = 9
    labels[5::101] = -1
    x = np.ones(1024)
    ref, port = _pair(x=x)
    gp, gj = port["x"].groupby(0, labels, 8), ref["x"].groupby(0, labels, 8)
    got = [gp.count(), gp.sum()]
    for gg, w in zip(got, [gj.count(), gj.sum()]):
        _same(gg, w, "dropped labels")
    assert int(np.asarray(got[0]).sum()) == int(((labels >= 0) & (labels < 8)).sum())


def test_nan_kinds():
    v = np.random.RandomState(1).rand(12, 5)
    v[0, 0] = v[4, 2] = np.nan
    ref, port = _pair(v=v)
    for kind in ("nansum", "nanmean", "nanvar", "nanstd", "sum", "min", "max"):
        _same(getattr(port["v"].groupby(0, LABELS, G), kind)(),
              getattr(ref["v"].groupby(0, LABELS, G), kind)(), kind)
    # against numpy, as the reference's own tests do
    got = port["v"].groupby(0, LABELS, G).nanmean().asarray()
    want = np.stack([np.nanmean(v[LABELS == k], axis=0) for k in range(G)])
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_group_broadcast_binops():
    v = np.random.RandomState(2).rand(12, 5)
    per_group = np.random.RandomState(3).rand(G, 5) + 0.5
    ref, port = _pair(v=v, p=per_group)
    for build in (lambda g, a: g - g.mean(), lambda g, a: g * a["p"],
                  lambda g, a: a["p"] / g, lambda g, a: g + per_group,
                  lambda g, a: g > a["p"], lambda g, a: 2.0 ** g,
                  lambda g, a: g * 2.0, lambda g, a: 1.0 + g):
        got = build(port["v"].groupby(0, LABELS, G), port)
        want = build(ref["v"].groupby(0, LABELS, G), ref)
        _same(got, want)
    # the anomaly the climatology idiom computes, against numpy (a label
    # outside the range is clipped by take, as jnp.take's "clip" does)
    anom = (port["v"].groupby(0, LABELS, G)
            - port["v"].groupby(0, LABELS, G).mean()).asarray()
    means = np.stack([v[LABELS == k].mean(axis=0) for k in range(G)])
    np.testing.assert_allclose(anom, v - means[np.clip(LABELS, 0, G - 1)],
                               rtol=1e-12, atol=1e-15)


def test_take_matches_ramba_tpu():
    x = np.arange(20.0).reshape(4, 5)
    idx = np.array([-1, 0, 3, 7, 2])
    ref, port = _pair(x=x)
    for axis in (None, 0, 1):
        _same(port["x"].take(idx, axis=axis), ref["x"].take(idx, axis=axis),
              f"take axis={axis}")
    _same(rt.take(port["x"], idx), rtj.take(ref["x"], idx), "take()")
    _same(port["x"].take(idx, axis=1, mode="wrap"),
          ref["x"].take(idx, axis=1, mode="wrap"), "take wrap")


def test_errors():
    for m in (rtj, rt):
        with pytest.raises(ValueError):
            m.fromarray(np.zeros((4, 4))).groupby(0, np.array([0, 1]))
        with pytest.raises(ValueError):
            m.fromarray(np.zeros((4, 4))).groupby(0, np.zeros((4, 1), int))
        g = m.fromarray(np.zeros((4, 4))).groupby(0, np.array([0, 1, 0, 1]), 2)
        with pytest.raises(ValueError, match="group operand"):
            g - m.fromarray(np.zeros((3, 4)))
    assert rt.RambaGroupby is type(rt.zeros((2, 2)).groupby(0, [0, 1]))
    # jnp.take refuses mode="raise" (bounds are not checked on the device)
    with pytest.raises(NotImplementedError):
        rt.zeros(4).take(np.array([1]), mode="raise")


# -- the reference's own groupby cases (tests/test_skeletons.py), each run
#    through both packages --------------------------------------------------


def _both(fn, *arrays):
    """fn(module, *arrays as that module's ndarrays) for both packages."""
    ref, port = _pair(**{f"a{k}": v for k, v in enumerate(arrays)})
    want = fn(rtj, *ref.values())
    got = fn(rt, *port.values())
    return np.asarray(got), np.asarray(want)


def _skel_data():
    np.random.seed(0)
    v = np.random.rand(12, 5)
    labels = np.array([0, 1, 2, 0, 1, 2, 0, 1, 2, 0, 1, 2])
    return v, labels


@pytest.mark.parametrize("red", ["sum", "mean", "min", "max", "prod", "var",
                                 "std"])
def test_skeletons_reductions(red):
    v, labels = _skel_data()
    got, want = _both(lambda m, a: getattr(a.groupby(0, labels, 3), red)(), v)
    _same(got, want, red)
    expected = np.stack([getattr(np, red)(v[labels == k], axis=0)
                         for k in range(3)])
    np.testing.assert_allclose(got, expected, rtol=1e-10)


def test_skeletons_count_nanmean_anomaly_axis1():
    v, labels = _skel_data()
    got, want = _both(lambda m, a: a.groupby(0, labels, 3).count(), v)
    _same(got, want)
    assert (got == 4).all()
    v2 = v.copy()
    v2[0, 0] = np.nan
    got, want = _both(lambda m, a: a.groupby(0, labels, 3).nanmean(), v2)
    _same(got, want, "nanmean")
    got, want = _both(lambda m, a: (lambda g: g - g.mean())(
        a.groupby(0, labels, 3)), v)
    _same(got, want, "anomaly")
    w = np.arange(24, dtype=float).reshape(4, 6)
    lab1 = np.array([0, 0, 1, 1, 1, 0])
    got, want = _both(lambda m, a: a.groupby(1, lab1, 2).sum(), w)
    _same(got, want, "axis1")
    np.testing.assert_allclose(
        got, np.stack([w[:, lab1 == k].sum(axis=1) for k in range(2)], axis=1))


def test_skeletons_scalar_binop():
    v = np.arange(12, dtype=float).reshape(6, 2)
    labels = np.array([0, 1, 0, 1, 0, 1])
    got, want = _both(lambda m, a: a.groupby(0, labels, 2) * 2.0, v)
    _same(got, want)
    np.testing.assert_allclose(got, v * 2.0)
    got, want = _both(lambda m, a: 1.0 + a.groupby(0, labels, 2), v)
    _same(got, want)
    np.testing.assert_allclose(got, 1.0 + v)


def test_skeletons_variations():
    x = np.arange(400.0 * 2).reshape(2, 400)
    labels = np.arange(365) % 365
    got, want = _both(lambda m, a: (lambda gb: gb - gb.mean())(
        a[:, 25:25 + 365].groupby(1, labels, num_groups=365)), x)
    _same(got, want, "slice")
    x = np.arange(35.0).reshape(7, 5)
    got, want = _both(lambda m, a: (lambda gb: gb - gb.mean())(
        a.T.groupby(1, np.arange(7) % 3, num_groups=3)), x)
    _same(got, want, "transpose")
    x = np.arange(120.0).reshape(10, 12)
    lab = np.arange(7) % 4
    for fn in (lambda m, a: a[2:9, 1:11].T.groupby(1, lab, num_groups=4).mean(),
               lambda m, a: (lambda gb: gb - gb.mean())(
                   a[2:9, 1:11].T.groupby(1, lab, num_groups=4))):
        got, want = _both(fn, x)
        _same(got, want, "slice transpose")


def test_skeletons_labels_as_ramba_array():
    x = np.arange(24.0).reshape(4, 6)
    lab = np.array([0, 1, 0, 1, 2, 2])
    got, want = _both(lambda m, a: a.groupby(1, m.fromarray(lab),
                                             num_groups=3).sum(), x)
    _same(got, want)
    np.testing.assert_allclose(got, np.stack(
        [x[:, [0, 2]].sum(axis=1), x[:, [1, 3]].sum(axis=1),
         x[:, [4, 5]].sum(axis=1)], axis=1))
