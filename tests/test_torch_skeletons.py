"""The port's skeletons (smap, sreduce, scumulative, spmd, fromfunction)
against ramba_tpu's, x64 regime.

The cases of ``tests/test_skeletons.py`` for smap, sreduce, scumulative,
spmd and barrier run through both packages on the same inputs (made with
numpy from a seed, carried across by ``convert.state_from_reference``).
The port runs on one card, so where ramba_tpu's answer depends on how its
mesh splits the data (sreduce's tree, scumulative's carry fix-up, spmd's
blocks) ramba_tpu runs under a one-device mesh (``one_device``), restored
afterwards.  Also held here: int32 index planes, the ``_KVal``-first
kernel route (``np.sin`` in a kernel stays on the asked device and never
reaches the host fallback), a non-elementwise kernel (the port matches
ramba_tpu or raises, never reduces across elements), the host fallback's
warning and counter, and the ``skeletons.branch_lowered`` counter.

Tolerances: dtypes, shapes, integers and bools exact; one-device float
``sreduce`` and the odd/even ``scumulative`` order exact (the same
additions in the same order, over maps that round alike in both: XLA on
the CPU divides by a constant through its reciprocal and contracts
``a*c + b*c`` into fused multiply-adds, so a rounding map such as ``x / 3``
would differ by an ulp); float64 rtol=atol=1e-12 and float32
rtol=atol=1e-5 where the orders or the math libraries differ.

Kernels here use one kind per operation, or ints with int32 index
planes, or floats with python scalars: where a kernel mixes kinds,
``ramba_tpu`` runs jnp's lattice on its tracers and the port NumPy's rule
table (``test_mixed_kinds_follow_the_rule_table``).
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from ramba_tpu_torch import common, convert, skeletons as sk

RTOL = {"float32": 1e-5, "float64": 1e-12}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    torch.set_num_threads(1)


@pytest.fixture
def one_device():
    """ramba_tpu on a one-device mesh, the port's shard count."""
    from jax.sharding import Mesh

    from ramba_tpu.parallel import mesh as M

    old = M.get_mesh()
    M.set_mesh(Mesh(np.array(jax.devices()[:1]), ("d0",)))
    try:
        yield
    finally:
        M.set_mesh(old)


def _pair(**arrays):
    ref = {k: rtj.fromarray(v) for k, v in arrays.items()}
    port = convert.state_from_reference({k: a.asarray() for k, a in ref.items()})
    return ref, port


def _same(got, want, what="", exact=False):
    g = np.asarray(got.asarray() if hasattr(got, "asarray") else got)
    w = np.asarray(want.asarray() if hasattr(want, "asarray") else want)
    assert g.dtype == w.dtype, f"{what}: port {g.dtype} vs ramba_tpu {w.dtype}"
    assert g.shape == w.shape, f"{what}: port {g.shape} vs ramba_tpu {w.shape}"
    if exact or w.dtype.kind in "biu":
        np.testing.assert_array_equal(g, w, err_msg=what)
    else:
        r = RTOL[w.dtype.name]
        np.testing.assert_allclose(g, w, rtol=r, atol=r, err_msg=what)


def _both(fn, *arrays):
    """``fn(pkg, *arrays)`` in both packages on identical inputs."""
    ref, port = _pair(**{f"a{i}": a for i, a in enumerate(arrays)})
    return (fn(rt, *[port[f"a{i}"] for i in range(len(arrays))]),
            fn(rtj, *[ref[f"a{i}"] for i in range(len(arrays))]))


# ---------------------------------------------------------------------------
# smap
# ---------------------------------------------------------------------------


def f1(a, b, c, d):
    return a * d + b - c[5]


SMAP_CASES = {
    "docs_f1": (lambda m, a, b: m.smap(f1, a, b, np.arange(20), 7),
                ["float64", "float64"]),
    "docs_f2_index": (lambda m, a, b: m.smap_index(
        lambda index, a, b: (a + b + index[0]) * index[0], a, b),
        ["float64", "float64"]),
    "branch": (lambda m, a: m.smap(lambda x: x * x if x > 0 else -x, a),
               ["float64"]),
    "nested_branch": (lambda m, a: m.smap(
        lambda x: (x + 1 if x > 1 else x - 1) if x > 0 else 2 * x, a),
        ["float32"]),
    "numpy_ufuncs": (lambda m, a: m.smap(
        lambda x: np.sin(x) + np.maximum(x, 0.5) * np.exp(-x * x), a),
        ["float64"]),
    "np_where_clip": (lambda m, a: m.smap(
        lambda x: np.where(x > 0, np.clip(x, 0.2, 0.8), x), a), ["float32"]),
    "int_data": (lambda m, a, b: m.smap(lambda x, y: x * 3 - y // 2, a, b),
                 ["int32", "int64"]),
    "int32_scalar": (lambda m, a: m.smap(lambda x: x * 2 + 1, a), ["int32"]),
    "bool_logic": (lambda m, a, b: m.smap(lambda x, y: (x > 0) & (y < 1), a, b),
                   ["float64", "int32"]),
    "mixed_f32_f64": (lambda m, a, b: m.smap(lambda x, y: x + y, a, b),
                      ["float32", "float64"]),
    "literal_scalar_only": (lambda m, a: m.smap(lambda x: 2.5, a), ["int32"]),
    "shape_is_0d": (lambda m, a: m.smap(lambda x: x + len(x.shape), a),
                    ["float64"]),
    "astype": (lambda m, a: m.smap(lambda x: x.astype(np.float32) * 2, a),
               ["int64"]),
    "np_round": (lambda m, a: m.smap(
        lambda x: np.round(x) + np.round(x, 1) + np.around(x, decimals=2), a),
        ["float64"]),
    "index_int32_dtype": (lambda m, a: m.smap_index(
        lambda i, x: i[0] * 2, a), ["int32"]),
    "index_mixes_int32": (lambda m, a: m.smap_index(
        lambda i, x: x + i[0], a), ["int32"]),
}


def _smap_data(dtype, seed, shape=(64,)):
    rs = np.random.RandomState(seed)
    if dtype.startswith("int"):
        return rs.randint(-5, 6, shape).astype(dtype)
    return (rs.randn(*shape) * 2).astype(dtype)


@pytest.mark.parametrize("case", sorted(SMAP_CASES))
def test_smap_cases(case):
    fn, dtypes = SMAP_CASES[case]
    arrays = [_smap_data(d, i) for i, d in enumerate(dtypes)]
    got, want = _both(fn, *arrays)
    _same(got, want, case)


def test_smap_docs_example_values():
    a, b = rt.ones(100), rt.zeros(100)
    e = rt.smap(f1, a, b, np.arange(20), 7)
    np.testing.assert_array_equal(e.asarray(), np.full(100, 2.0))
    f = rt.smap_index(lambda index, a, b: (a + b + index[0]) * index[0], a, b)
    i = np.arange(100)
    np.testing.assert_array_equal(f.asarray(), (1 + i) * i)


def test_mixed_kinds_follow_the_rule_table():
    """float32 + int32 in a kernel: NumPy's float64 in the port, jnp's
    float32 in ramba_tpu (ROADMAP, queue C); the values agree."""
    got, want = _both(lambda m, a: m.smap_index(lambda i, x: x + i[0], a),
                      np.ones(8, np.float32))
    assert got.dtype == np.float64 and want.dtype == np.float32
    np.testing.assert_array_equal(got.asarray(), want.asarray())


def test_smap_2d_index_int32():
    got, want = _both(lambda m, a: m.smap_index(
        lambda index, a: a + index[0] * 10 + index[1], a),
        np.zeros((4, 5)))
    _same(got, want, "2-D index", exact=True)
    i, j = np.mgrid[0:4, 0:5]
    np.testing.assert_array_equal(got.asarray(), i * 10 + j)
    # the planes themselves are int32, as ramba_tpu's iotas
    got, want = _both(lambda m, a: m.smap_index(
        lambda index, a: index[0] * 100 + index[1], a), np.zeros((3, 4)))
    assert got.dtype == np.int32
    _same(got, want, "index planes", exact=True)


def test_smap_fuses():
    rt.sync()
    before = dict(rt.fuser_stats)
    a = rt.arange(100).astype(float)
    b = rt.smap(lambda x: x * 2 + 1, a) + 5
    rt.sync()
    assert rt.fuser_stats["flushes"] == before["flushes"] + 1
    np.testing.assert_array_equal(b.asarray(), np.arange(100.0) * 2 + 6)


def test_smap_np_sin_stays_on_the_device_route():
    """np.sin on a kernel value goes through the port's op table: the
    result is a tensor on the asked device, and the host fallback is not
    taken (on a CUDA tensor the same call would otherwise raise)."""
    before = dict(sk.counters)
    out = rt.smap(lambda x: np.sin(x), rt.arange(16.0))
    v = out._value()
    assert isinstance(v, torch.Tensor) and v.device == common.device()
    assert sk.counters["skeletons.host_fallback"] == \
        before["skeletons.host_fallback"]
    np.testing.assert_allclose(out.asarray(), np.sin(np.arange(16.0)),
                               rtol=1e-15)


def test_branch_lowered_counter():
    before = sk.counters["skeletons.branch_lowered"]
    r = rt.smap(lambda x: x * x if x > 0 else -x, rt.arange(-3.0, 4.0))
    assert sk.counters["skeletons.branch_lowered"] == before  # not yet run
    r.asarray()
    assert sk.counters["skeletons.branch_lowered"] == before + 1
    assert sk.counters["skeletons.host_fallback"] >= 0


def test_non_elementwise_kernel_raises():
    """np.sum over a kernel value: ramba_tpu sums one element (its kernel
    sees 0-d values); the port refuses the call, never summing across
    elements."""
    x = np.arange(8.0)
    want = rtj.smap(lambda v: v - np.sum(v), rtj.fromarray(x)).asarray()
    np.testing.assert_array_equal(want, np.zeros(8))
    with pytest.raises(TypeError, match="sum"):
        rt.smap(lambda v: v - np.sum(v), rt.fromarray(x)).asarray()
    with pytest.raises((TypeError, IndexError)):
        rt.smap(lambda v: v[0] + 1, rt.fromarray(x)).asarray()
    with pytest.raises(TypeError):
        rt.smap(lambda v: [e for e in v], rt.fromarray(x)).asarray()


def test_host_fallback_warns_once_and_counts():
    def halve(x):
        return float(x) / 2  # a host conversion: not traceable

    sk.reset_fallback_warnings()
    n0 = sk.counters["skeletons.host_fallback"]
    x = np.arange(-3.0, 5.0)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got = rt.smap(halve, rt.fromarray(x))
        g = got.asarray()
        rt.smap(halve, rt.fromarray(x)).asarray()
    msgs = [str(w.message) for w in rec if "host evaluation" in str(w.message)]
    assert len(msgs) == 1, msgs
    assert sk.counters["skeletons.host_fallback"] == n0 + 2
    assert halve in sk.fallback_warned_kernels()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = rtj.smap(halve, rtj.fromarray(x)).asarray()
    assert g.dtype == want.dtype
    np.testing.assert_array_equal(g, want)
    assert got._value().device == common.device()


def test_host_fallback_index_and_dtype():
    def f(i, x):
        return int(x) + i[0] if x > 0 else 0.5

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got, want = _both(lambda m, a: m.smap_index(f, a),
                          np.array([-1, 2, 3, -4], np.int64))
        _same(got, want, "host fallback index + promotion")


def test_classifier_rejects_smap():
    from ramba_tpu_torch.core import fuser
    from ramba_tpu_torch.ops import kernel_backend

    a = rt.fromarray(np.arange(64.0))
    m = rt.smap(lambda x: x * 2, a)
    program, leaves = fuser.prepare_program([m.read_expr()])
    assert program.instrs[0][0] == "smap"
    assert kernel_backend.classify(program, leaves) is None


def test_smap_axis_validated():
    a = rt.ones((4, 3))
    np.testing.assert_array_equal(
        rt.smap(lambda x: x + 1, a, axis=1).asarray(), np.full((4, 3), 2.0))
    with pytest.raises(ValueError, match="axis"):
        rt.smap(lambda x: x + 1, a, axis=2)
    with pytest.raises(TypeError):
        rt.smap(lambda x: x + 1, a, axis="rows")


# ---------------------------------------------------------------------------
# fromfunction / init_array
# ---------------------------------------------------------------------------


FILLERS = {
    "docs_init_array": (lambda i: i * 11.0, (100,), float),
    "int_no_dtype": (lambda i, j: i * 10 + j, (4, 5), None),
    "branch": (lambda i, j: i - j if i > j else j * 2, (5, 6), None),
    "ufunc": (lambda i: np.sin(i) * 0.5, (33,), np.float32),
    "cast_int": (lambda i: i / 3, (9,), np.int64),
}


@pytest.mark.parametrize("case", sorted(FILLERS))
def test_fromfunction(case):
    fn, shape, dtype = FILLERS[case]
    got = rt.fromfunction(fn, shape, dtype=dtype)
    want = rtj.fromfunction(fn, shape, dtype=dtype)
    _same(got, want, case)
    _same(rt.init_array(shape, fn, dtype=dtype),
          rtj.init_array(shape, fn, dtype=dtype), case)


# ---------------------------------------------------------------------------
# sreduce
# ---------------------------------------------------------------------------


def test_sreduce_docs_example(one_device):
    def run(m):
        a = m.init_array(100, lambda i: i * 11.0)
        a -= 7
        a = abs(a)
        return m.sreduce(lambda x: x / 100, lambda x, y: x + y, 0, a)

    got, want = run(rt), run(rtj)
    _same(got, want, "docs sreduce", exact=True)
    assert float(got) == pytest.approx(
        np.abs(np.arange(100) * 11.0 - 7).sum() / 100)


SREDUCE_CASES = {
    "sum_f64": (lambda m, a: m.sreduce(lambda x: x, lambda x, y: x + y, 0.0, a),
                "float64", 1000),
    "sum_f32_pow2": (lambda m, a: m.sreduce(
        lambda x: x * 2, lambda x, y: x + y, 0, a), "float32", 1024),
    "max": (lambda m, a: m.sreduce(
        lambda x: x, lambda x, y: np.maximum(x, y), -np.inf, a),
        "float64", 100),
    "branch_max": (lambda m, a: m.sreduce(
        lambda x: x, lambda x, y: x if x > y else y, -np.inf, a),
        "float64", 77),
    "int_sum": (lambda m, a: m.sreduce(lambda x: x * x, lambda x, y: x + y,
                                       0, a), "int64", 333),
    "int32_max": (lambda m, a: m.sreduce(
        lambda x: x, lambda x, y: np.maximum(x, y), np.iinfo(np.int32).min, a),
        "int32", 50),
    "reducer_split": (lambda m, a: m.sreduce(
        lambda x: x, m.SreduceReducer(lambda x, y: x + y, lambda x, y: x + y),
        0.0, a), "float64", 64),
    "reducer_split_odd": (lambda m, a: m.sreduce(
        lambda x: x * 4, m.SreduceReducer(lambda x, y: x + y,
                                          lambda x, y: x + y), 0.0, a),
        "float64", 999),
    "index": (lambda m, a: m.sreduce_index(
        lambda idx, x: x * idx[0], lambda x, y: x + y, 0.0, a),
        "float64", 50),
}


@pytest.mark.parametrize("case", sorted(SREDUCE_CASES))
def test_sreduce_one_device_exact(case, one_device):
    fn, dtype, n = SREDUCE_CASES[case]
    got, want = _both(fn, _smap_data(dtype, 3, (n,)))
    _same(got, want, case, exact=True)


def test_sreduce_values():
    r = rt.sreduce_index(lambda idx, x: x * idx[0], lambda x, y: x + y, 0.0,
                         rt.ones(50))
    assert float(r) == sum(range(50))
    r = rt.sreduce(lambda x: x, lambda x, y: np.maximum(x, y), -np.inf,
                   rt.arange(100).astype(float))
    assert float(r) == 99.0


# ---------------------------------------------------------------------------
# scumulative
# ---------------------------------------------------------------------------


def _add(x, c):
    return x + c


def _rebase(c, b):
    return b + c


SCAN_CASES = {
    "cumsum_f64": (lambda m, a: m.scumulative(_add, _rebase, a),
                   "float64", (1000,)),
    "cumsum_odd": (lambda m, a: m.scumulative(_add, _rebase, a),
                   "float64", (1003,)),
    "cumsum_int64": (lambda m, a: m.scumulative(_add, _rebase, a),
                     "int64", (777,)),
    "running_max": (lambda m, a: m.scumulative(
        lambda xi, prev: np.maximum(xi, prev),
        lambda carry, block: np.maximum(block, carry), a), "float64", (50,)),
    "forced_sequential": (lambda m, a: m.scumulative(
        _add, _rebase, a, associative=False), "float64", (300,)),
    "ema": (lambda m, a: m.scumulative(
        lambda x, c: 0.5 * x + 0.5 * c, lambda c, b: b, a), "float64", (64,)),
    "ema_f32_2d": (lambda m, a: m.scumulative(
        lambda x, c: 0.25 * x + 0.75 * c, lambda c, b: b, a, 0),
        "float32", (40, 9)),
    "clamp": (lambda m, a: m.scumulative(
        lambda v, c: np.maximum(0.0, v + c), lambda c, b: b, a),
        "float64", (64,)),
    "axis1": (lambda m, a: m.scumulative(_add, _rebase, a, 1),
              "float64", (6, 10)),
    "axis_neg1": (lambda m, a: m.scumulative(_add, _rebase, a, -1),
                  "float32", (6, 10)),
    "axis0_2d": (lambda m, a: m.scumulative(_add, _rebase, a, 0),
                 "float64", (257, 4)),
    "dtype_arg": (lambda m, a: m.scumulative(_add, _rebase, a, 0, np.float64),
                  "int32", (20,)),
}


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_scumulative(case, one_device):
    fn, dtype, shape = SCAN_CASES[case]
    got, want = _both(fn, _smap_data(dtype, 5, shape))
    _same(got, want, case)


def test_scumulative_odd_even_order_exact(one_device):
    """The associative path adds in jax.lax.associative_scan's order."""
    got, want = _both(lambda m, a: m.scumulative(_add, _rebase, a,
                                                 associative=True),
                      np.random.RandomState(2).rand(1001))
    _same(got, want, "odd/even scan", exact=True)


def test_scumulative_against_numpy():
    v = np.random.RandomState(0).rand(1000)
    for assoc in (True, False):
        got = rt.scumulative(_add, _rebase, rt.fromarray(v),
                             associative=assoc).asarray()
        np.testing.assert_allclose(got, np.cumsum(v), rtol=1e-12)
    want = [v[0]]
    for xi in v[1:64]:
        want.append(max(0.0, xi - 0.5 + want[-1]))
    got = rt.scumulative(lambda x, c: np.maximum(0.0, x - 0.5 + c),
                         lambda c, b: b, rt.fromarray(v[:64])).asarray()
    np.testing.assert_allclose(got[1:], np.array(want)[1:], rtol=1e-12)


def test_associative_probe_matches_reference():
    from ramba_tpu.skeletons import _probe_associative as ref_probe

    pairs = [
        (lambda x, c: x + c, lambda c, b: b + c),
        (lambda x, c: np.maximum(x, c), lambda c, b: np.maximum(b, c)),
        (lambda x, c: 0.5 * x + 0.5 * c, lambda c, b: b + 0 * c),
        (lambda v, c: np.maximum(0.0, v + c),
         lambda c, b: np.maximum(0.0, b + c)),
        (lambda x, c: x * c, lambda c, b: b * c),
        (lambda x, c: x - c, lambda c, b: b - c),
    ]
    for lf, ff in pairs:
        assert sk._probe_associative(lf, ff) == ref_probe(lf, ff)
    assert sk._probe_associative(*pairs[0]) and not sk._probe_associative(
        *pairs[2])


def test_scumulative_dtype_and_out():
    xi = np.random.RandomState(6).randint(0, 5, size=20)
    g = rt.scumulative(_add, _rebase, rt.fromarray(xi), 0, np.float64)
    assert g.dtype == np.float64
    np.testing.assert_array_equal(g.asarray(), np.cumsum(xi).astype(float))
    out = rt.zeros(20)
    ret = rt.scumulative(_add, _rebase, rt.fromarray(xi.astype(float)), 0,
                         out=out)
    assert ret is out
    np.testing.assert_array_equal(out.asarray(), np.cumsum(xi).astype(float))
    with pytest.raises(ValueError, match="out shape"):
        rt.scumulative(_add, _rebase, rt.ones(8), out=rt.zeros(9))


def test_scumulative_axis_out_of_range_and_carry_dtype():
    with pytest.raises(ValueError, match="axis"):
        rt.scumulative(_add, _rebase, rt.ones(8), 1)
    # a kernel that changes the carry's dtype is refused, as lax.scan does
    with pytest.raises(TypeError, match="dtype"):
        rt.scumulative(lambda x, c: x + c * np.float64(0.5), _rebase,
                       rt.ones(8, np.float32), associative=False).asarray()


def test_nonassociative_scan_never_warns_on_one_card():
    """ramba_tpu warns when a non-associative scan's axis is split over
    devices (per-block carries); one card never splits it."""
    v = np.random.RandomState(9).rand(4096)
    want = [v[0]]
    for xi in v[1:]:
        want.append(max(0.0, xi - 0.5 + want[-1]))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = rt.scumulative(lambda x, c: np.maximum(0.0, x - 0.5 + c),
                             lambda c, b: b, rt.fromarray(v),
                             associative=False).asarray()
    np.testing.assert_allclose(got, np.array(want), rtol=1e-12)


# ---------------------------------------------------------------------------
# spmd on one card
# ---------------------------------------------------------------------------


def _spmd_both(worker_of, x):
    """Run ``spmd`` with ``worker_of(pkg)`` on both packages' copies of
    ``x``; returns the two arrays after the call."""
    ref, port = _pair(a=x)
    rtj.sync()
    rt.spmd(worker_of(rt), port["a"])
    rtj.spmd(worker_of(rtj), ref["a"])
    return port["a"], ref["a"]


def test_spmd_set_local(one_device):
    def worker_of(m):
        def worker(local):
            local.set_local(local.get_local() + 1.0)
        return worker

    got, want = _spmd_both(worker_of, np.zeros(800))
    _same(got, want, "set_local", exact=True)
    np.testing.assert_array_equal(got.asarray(), np.ones(800))


def test_spmd_worker_id_global_start_local_valid(one_device):
    seen = {}

    def worker_of(m):
        def worker(lv):
            wid = m.worker_id()
            seen[m.__name__] = (np.dtype(wid.dtype),
                                np.dtype(lv.global_start[0].dtype),
                                np.dtype(lv.local_valid[0].dtype),
                                tuple(lv.global_shape))
            lv.set_local(lv.get_local() + wid.astype(lv.dtype) + 1.0
                         + lv.local_valid[0].astype(lv.dtype))
        return worker

    got, want = _spmd_both(worker_of, np.zeros(1001))
    _same(got, want, "worker_id + local_valid", exact=True)
    i32 = np.dtype(np.int32)
    assert seen["ramba_tpu_torch"] == seen["ramba_tpu"] == (i32, i32, i32,
                                                            (1001,))

    def values(lv):
        seen["values"] = (int(rt.worker_id()), int(lv.global_start[0]),
                          int(lv.local_valid[0]), bool(rt.all(lv.valid_mask)))

    rt.spmd(values, rt.zeros(7))
    assert seen["values"] == (0, 0, 7, True)


def test_spmd_valid_mask_and_no_pad_warning(one_device):
    import jax.numpy as jnp

    def worker_of(m):
        xp = rt if m is rt else jnp  # ramba_tpu's blocks are jax arrays

        def w(lv):
            blk = lv.get_local()
            masked_min = xp.min(xp.where(lv.valid_mask, blk, np.inf))
            lv.set_local(blk - masked_min)
        return w

    ref, port = _pair(a=np.full(1001, 5.0))
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # one card never pads or replicates
        rt.spmd(worker_of(rt), port["a"])
    rtj.spmd(worker_of(rtj), ref["a"])
    _same(port["a"], ref["a"], "valid_mask", exact=True)
    np.testing.assert_array_equal(port["a"].asarray(), np.zeros(1001))


def test_spmd_halo_5_point(one_device):
    """A halo(1) 5-point update: zeros beyond the global edge."""
    x = np.random.RandomState(3).rand(12, 9)

    def worker_of(m):
        def w(lv):
            h = lv.halo(1)
            lv.set_local(h[:-2, 1:-1] + h[2:, 1:-1] + h[1:-1, :-2]
                         + h[1:-1, 2:] - 4.0 * h[1:-1, 1:-1])
        return w

    got, want = _spmd_both(worker_of, x)
    _same(got, want, "halo 5-point")
    p = np.pad(x, 1)
    np.testing.assert_allclose(
        got.asarray(),
        p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:] - 4 * x,
        rtol=1e-15)


def test_spmd_halo_depth_and_validation(one_device):
    shapes = {}

    def worker_of(m):
        def w(lv):
            shapes[m.__name__] = (tuple(lv.halo(10).shape),
                                  tuple(lv.halo((0, 2)).shape))
            lv.set_local(lv.halo(3)[3:-3, 3:-3] * 2.0)
        return w

    got, want = _spmd_both(worker_of, np.arange(12.0).reshape(3, 4))
    _same(got, want, "halo then crop", exact=True)
    assert shapes["ramba_tpu_torch"] == shapes["ramba_tpu"] == ((23, 24),
                                                                (3, 8))
    # a larger block written back keeps its leading corner, in both
    got, want = _spmd_both(lambda m: lambda lv: lv.set_local(lv.halo((1, 0))),
                           np.arange(12.0).reshape(3, 4))
    _same(got, want, "grown block cropped", exact=True)
    with pytest.raises(ValueError, match="block for a"):
        rt.spmd(lambda lv: lv.set_local(lv.get_local()[1:]), rt.ones(4))
    with pytest.raises(ValueError, match="non-negative"):
        rt.spmd(lambda lv: lv.halo(-1), rt.ones(4))
    with pytest.raises(ValueError, match="inside spmd"):
        sk.LocalView(np.ones(4)).halo(1)
    with pytest.raises(ValueError, match="inside spmd"):
        sk.LocalView(np.ones(4)).global_start


def test_spmd_halo_reflects_set_local_and_write_back_crop(one_device):
    def worker_of(m):
        def w(src, dst):
            src.set_local(src.get_local() + 1.0)
            dst.set_local(src.halo(1)[2:])
        return w

    n = 40
    ref_a, port_a = _pair(a=np.zeros(n))
    ref_b, port_b = _pair(b=np.zeros(n))
    rt.spmd(worker_of(rt), port_a["a"], port_b["b"])
    rtj.spmd(worker_of(rtj), ref_a["a"], ref_b["b"])
    _same(port_b["b"], ref_b["b"], "halo after set_local", exact=True)
    _same(port_a["a"], ref_a["a"], "source", exact=True)
    exp = np.ones(n)
    exp[-1] = 0.0
    np.testing.assert_array_equal(port_b["b"].asarray(), exp)


def test_spmd_passes_literals_and_barrier():
    a = rt.zeros(5)
    rt.spmd(lambda lv, k, arr: lv.set_local(lv.get_local() + k + arr[1]),
            a, 3.0, np.array([0.0, 2.0]))
    np.testing.assert_array_equal(a.asarray(), np.full(5, 5.0))
    rt.barrier()
    rtj.barrier()
