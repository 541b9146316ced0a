"""The skeletons' cross-shard parts against ramba_tpu's, x64 regime: spmd
over a mesh of shards (``LocalView`` with the real ``global_start``,
``local_valid``, ``valid_mask`` and ``halo``; uneven padding; whole
arrays; the replicated-write rule; ``worker_id``), scumulative's per-shard
scan and carry fix-up, and ``SreduceReducer``'s two folds.

Both packages run on meshes of the same shape (2, 4 and 8 shards; 2x2
and 4x2 grids): ramba_tpu on its first k virtual CPU devices, the port on
shard positions that all hold the CPU (one thread per shard inside spmd),
both restored afterwards.  The cases mirror ``tests/test_skeletons.py``.
spmd kernels are written twice, once with ``jax.numpy`` for ramba_tpu's
traced blocks and once with the port's functions.

Tolerances: spmd results, integer scans and reductions exactly; float
scans and SreduceReducer folds exactly too (the same blocks, the same
odd/even scan and fold-halves orders, the same carry fold), except the
non-associative ``ema`` case (``0.5*x + 0.5*c``: XLA contracts it into a
fused multiply-add), rtol=atol=1e-12.  Warnings and the counter
``skeletons.scan_allgather_bytes_est`` are compared with ramba_tpu's.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP
from ramba_tpu import skeletons as rsk
from ramba_tpu.observe import registry as rreg
from ramba_tpu.parallel import mesh as rmesh
from ramba_tpu_torch import common, parallel
from ramba_tpu_torch import skeletons as psk
from ramba_tpu_torch.observe import registry as preg
from ramba_tpu_torch.parallel import mesh as pmesh

MESHES = [(2,), (4,), (8,), (2, 2), (4, 2)]


@pytest.fixture(autouse=True)
def _port_on_cpu():
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    torch.set_num_threads(1)


@pytest.fixture
def meshes(request):
    """Both packages on a mesh of ``request.param`` shards."""
    shape = request.param
    k = int(np.prod(shape))
    if len(jax.devices()) < k:
        pytest.skip(f"needs {k} devices")
    names = tuple(f"d{i}" for i in range(len(shape)))
    old_r, old_p = rmesh.get_mesh(), pmesh.get_mesh()
    rmesh.set_mesh(JMesh(np.array(jax.devices()[:k]).reshape(shape), names))
    pmesh.set_mesh(pmesh.Mesh(
        np.array([torch.device("cpu")] * k, dtype=object).reshape(shape),
        names))
    try:
        yield shape
    finally:
        rmesh.set_mesh(old_r)
        pmesh.set_mesh(old_p)


def _same(got, want, exact=True):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    if exact or want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def _spmd_both(kern_ref, kern_port, *values):
    """Run an spmd kernel over arrays made from ``values`` in both packages;
    returns (ramba_tpu arrays, port arrays)."""
    ra = [rtj.fromarray(v) for v in values]
    pa = [rt.fromarray(v) for v in values]
    rtj.sync()
    rtj.spmd(kern_ref, *ra)
    rt.spmd(kern_port, *pa)
    for r, p in zip(ra, pa):
        _same(p.asarray(), r.asarray())
    return ra, pa


# -- spmd -----------------------------------------------------------------


def _plus_one(lv):
    lv.set_local(lv.get_local() + 1.0)


def _plus_wid_ref(lv):
    lv.set_local(lv.get_local() + rtj.worker_id().astype(lv.dtype))


def _plus_wid_port(lv):
    lv.set_local(lv.get_local() + rt.worker_id().astype(lv.dtype))


@pytest.mark.parametrize("meshes", MESHES, indirect=True)
@pytest.mark.parametrize("shape", [(800,), (96, 64), (13, 9), (1001,),
                                   (801,)])
def test_set_local(meshes, shape):
    _spmd_both(_plus_one, _plus_one, np.zeros(shape))


@pytest.mark.parametrize("meshes", MESHES, indirect=True)
@pytest.mark.parametrize("n", [100, 1001])
def test_worker_id(meshes, n):
    nw = rt.num_workers()
    psk._uneven_pad_warned = rsk._uneven_pad_warned = True
    _spmd_both(_plus_wid_ref, _plus_wid_port, np.zeros(n * nw if n == 100
                                                       else n))
    assert int(rt.worker_id()) == 0  # outside spmd


@pytest.mark.parametrize("meshes", MESHES, indirect=True)
def test_global_start_and_views(meshes):
    seen = {"ref": [], "port": []}

    def ref(v):
        seen["ref"].append((v.global_shape, v.shape))
        v.set_local(jnp.full(v.get_local().shape, v.global_start[0],
                             v.get_local().dtype))

    def port(v):
        seen["port"].append((v.global_shape, v.shape,
                             int(v.global_start[0]),
                             tuple(int(x) for x in v.local_valid)))
        v.set_local(rt.full(v.get_local().shape, v.global_start[0],
                            v.get_local().dtype))

    _spmd_both(ref, port, np.zeros(1024))
    nw = rt.num_workers()
    bs = 1024 // nw
    assert sorted(s[2] for s in seen["port"]) == [k * bs for k in range(nw)]
    assert {s[:2] for s in seen["port"]} == set(seen["ref"]) == {
        ((1024,), (bs,))}
    assert {s[3] for s in seen["port"]} == {(bs,)}


@pytest.mark.parametrize("meshes", MESHES, indirect=True)
def test_respects_user_sharding(meshes):
    from ramba_tpu.core.expr import Const as RConst
    from ramba_tpu.core.ndarray import put_sharded as rput
    from ramba_tpu_torch.core.ndarray import put_sharded as pput

    axes = tuple(pmesh.get_mesh().axis_names)
    n_all = rt.num_workers()
    v = np.zeros((16, 8 * n_all))
    ra = rtj.fromarray(v)
    ra.write_expr(RConst(rput(v, JNamedSharding(rmesh.get_mesh(),
                                                 JP(None, axes)))))
    pa = pput(v, pmesh.NamedSharding(pmesh.get_mesh(), pmesh.P(None, axes)))
    shapes = {"ref": [], "port": []}

    def kern(key):
        def k(lv):
            shapes[key].append(lv.shape)
            lv.set_local(lv.get_local() + 1.0)
        return k

    rtj.spmd(kern("ref"), ra)
    rt.spmd(kern("port"), pa)
    assert set(shapes["port"]) == set(shapes["ref"]) == {(16, 8)}
    _same(pa.asarray(), ra.asarray())


@pytest.mark.parametrize("meshes", MESHES, indirect=True)
def test_whole_array_and_divergent_write(meshes):
    def ref(lv):
        assert lv.shape == (10,)
        lv.set_local(lv.get_local() * 2.0)

    def port(lv):
        assert lv.shape == (10,)
        lv.set_local(lv.get_local() * 2.0)

    psk._replicated_write_warned = rsk._replicated_write_warned = True
    _spmd_both(ref, port, np.arange(10.0))
    # divergent writes to a whole (replicated) array: coordinate 0 wins
    psk._replicated_write_warned = rsk._replicated_write_warned = False
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        _spmd_both(_plus_wid_ref, _plus_wid_port, np.zeros(10))
    msgs = [str(w.message) for w in rec if "coordinate-0" in str(w.message)]
    assert len(msgs) == 2 and msgs[0] == msgs[1]
    # a no-op kernel leaves it unchanged
    a = rt.fromarray(np.arange(50.0))
    rt.spmd(lambda lv: None, a)
    _same(a.asarray(), np.arange(50.0))


@pytest.mark.parametrize("meshes", [(2, 2), (4, 2)], indirect=True)
def test_partial_sharding_divergent_write(meshes):
    from ramba_tpu.core.expr import Const as RConst
    from ramba_tpu.core.ndarray import put_sharded as rput
    from ramba_tpu_torch.core.ndarray import put_sharded as pput

    axes = tuple(pmesh.get_mesh().axis_names)
    d0 = pmesh.get_mesh().shape[axes[0]]
    n = d0 * 16
    ra = rtj.fromarray(np.zeros(n))
    ra.write_expr(RConst(rput(np.zeros(n), JNamedSharding(
        rmesh.get_mesh(), JP(axes[0])))))
    pa = pput(np.zeros(n), pmesh.NamedSharding(pmesh.get_mesh(),
                                               pmesh.P(axes[0])))
    psk._replicated_write_warned = rsk._replicated_write_warned = False
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        rtj.spmd(_plus_wid_ref, ra)
        rt.spmd(_plus_wid_port, pa)
    _same(pa.asarray(), ra.asarray())
    rest = rt.num_workers() // d0
    _same(pa.asarray(), np.repeat(np.arange(d0) * rest, 16).astype(float))
    assert sum("coordinate-0" in str(w.message) for w in rec) == 2


@pytest.mark.parametrize("meshes", MESHES, indirect=True)
def test_uneven_pad_warns_and_valid_mask(meshes):
    def ref(lv):
        blk = lv.get_local()
        lv.set_local(blk - jnp.min(jnp.where(lv.valid_mask, blk, jnp.inf)))

    def port(lv):
        blk = lv.get_local()
        lv.set_local(blk - rt.min(rt.where(lv.valid_mask, blk, np.inf)))

    psk._uneven_pad_warned = rsk._uneven_pad_warned = False
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        _spmd_both(ref, port, np.full(1001, 5.0) + np.arange(1001) % 7)
    msgs = [str(w.message) for w in rec if "zero-padded" in str(w.message)]
    assert len(msgs) == 2 and msgs[0] == msgs[1]


@pytest.mark.parametrize("meshes", MESHES, indirect=True)
def test_local_valid_bound(meshes):
    def ref(lv):
        n_valid = lv.local_valid[0]
        assert lv.global_shape == (1001,)
        block = lv.get_local()
        idx = jnp.arange(block.shape[0])
        lv.set_local(jnp.where(idx < n_valid,
                               block + n_valid.astype(block.dtype), block))

    def port(lv):
        n_valid = lv.local_valid[0]
        assert lv.global_shape == (1001,)
        block = lv.get_local()
        idx = rt.arange(block.shape[0])
        lv.set_local(rt.where(idx < n_valid,
                              block + n_valid.astype(block.dtype), block))

    psk._uneven_pad_warned = rsk._uneven_pad_warned = True
    _spmd_both(ref, port, np.ones(1001))


def _sum3(h):
    return h[:-2] + h[1:-1] + h[2:]


@pytest.mark.parametrize("meshes", MESHES, indirect=True)
def test_halo_1d(meshes):
    def kern(src, dst):
        dst.set_local(_sum3(src.halo(1)))

    v = np.arange(800, dtype=float)
    _, (pa, po) = _spmd_both(kern, kern, v, np.zeros(800))
    exp = np.zeros(800)
    exp[1:-1] = v[:-2] + v[1:-1] + v[2:]
    exp[0], exp[-1] = v[0] + v[1], v[-2] + v[-1]
    _same(po.asarray(), exp)


def _box(h):
    return sum(h[1 + di:h.shape[0] - 1 + di, 1 + dj:h.shape[1] - 1 + dj]
               for di in (-1, 0, 1) for dj in (-1, 0, 1))


@pytest.mark.parametrize("meshes", MESHES, indirect=True)
def test_halo_2d_corners(meshes):
    def kern(src, dst):
        dst.set_local(_box(src.halo(1)))

    m = np.random.RandomState(3).randint(0, 100, size=(64, 48)).astype(float)
    _, (_pa, po) = _spmd_both(kern, kern, m, np.zeros((64, 48)))
    _same(po.asarray(), _box(np.pad(m, 1)))


@pytest.mark.parametrize("meshes", MESHES, indirect=True)
def test_halo_depth2_star_matches_sstencil(meshes):
    # the star2 update written by hand from halo(2), masked to the interior
    def star(h):
        c = slice(2, -2)
        return (0.25 * (h[c, 3:-1] + h[c, 1:-3] + h[3:-1, c] + h[1:-3, c])
                + 0.125 * (h[c, 4:] + h[c, :-4] + h[4:, c] + h[:-4, c]))

    def kern(src, dst):
        dst.set_local(star(src.halo(2)))

    x = np.random.RandomState(5).rand(64, 64)
    _, (_pa, po) = _spmd_both(kern, kern, x, np.zeros((64, 64)))

    def body(a):
        return (0.25 * (a[0, 1] + a[0, -1] + a[1, 0] + a[-1, 0])
                + 0.125 * (a[0, 2] + a[0, -2] + a[2, 0] + a[-2, 0]))

    st = rt.sstencil(rt.stencil(body), rt.fromarray(x)).asarray()
    inner = (slice(2, -2), slice(2, -2))
    assert po.asarray()[inner].tobytes() == st[inner].tobytes()


@pytest.mark.parametrize("meshes", MESHES, indirect=True)
def test_halo_reflects_set_local_and_pads_whole_dims(meshes):
    def kern(src, dst):
        src.set_local(src.get_local() + 1.0)
        dst.set_local(src.halo(1)[2:])

    _, (_pa, po) = _spmd_both(kern, kern, np.zeros(800), np.zeros(800))
    exp = np.ones(800)
    exp[-1] = 0.0
    _same(po.asarray(), exp)
    got = {}

    def small(lv):
        got[rt.worker_id().item()] = lv.halo(10).shape
        lv.set_local(lv.get_local())

    psk._replicated_write_warned = True
    rt.spmd(small, rt.fromarray(np.arange(6.0)))
    assert set(got.values()) == {(26,)}


@pytest.mark.parametrize("meshes", [(4,), (2, 2)], indirect=True)
def test_halo_validation_and_outside_spmd(meshes):
    b = rt.fromarray(np.random.RandomState(4).rand(256, 256))
    with pytest.raises(ValueError, match="exceeds the local block"):
        rt.spmd(lambda lv: lv.set_local(
            lv.halo(10 ** 6)[:lv.shape[0], :lv.shape[1]]), b)
    with pytest.raises(ValueError, match="inside spmd"):
        rt.LocalView(np.ones(4)).halo(1)
    # shards that reach different collectives end the run
    with pytest.raises(RuntimeError, match="different collectives"):
        rt.spmd(lambda lv: lv.halo(1) if rt.worker_id().item() == 0
                else None, b)
    # a kernel error reaches the caller, raised once
    with pytest.raises(ZeroDivisionError):
        rt.spmd(lambda lv: 1 / 0, b)


# -- scumulative ----------------------------------------------------------


def _add(x, c):
    return x + c


def _rebase(c, b):
    return b + c


SCANS = {
    "cumsum": (lambda m, a: m.scumulative(_add, _rebase, a), (10000,),
               "float64", True),
    "odd_length": (lambda m, a: m.scumulative(_add, _rebase, a), (1003,),
                   "float64", True),
    "int64": (lambda m, a: m.scumulative(_add, _rebase, a), (777,),
              "int64", True),
    "running_max": (lambda m, a: m.scumulative(
        lambda x, c: np.maximum(x, c), lambda c, b: np.maximum(b, c), a),
        (500,), "float64", True),
    "axis0_2d": (lambda m, a: m.scumulative(_add, _rebase, a, 0),
                 (4096, 4), "float64", True),
    "axis1_2d": (lambda m, a: m.scumulative(_add, _rebase, a, 1),
                 (4, 4096), "float64", True),
    "forced_sequential": (lambda m, a: m.scumulative(
        _add, _rebase, a, associative=False), (300,), "float64", True),
    "ema": (lambda m, a: m.scumulative(
        lambda x, c: 0.5 * x + 0.5 * c, lambda c, b: b, a), (256,),
        "float64", False),
}


@pytest.mark.parametrize("meshes", MESHES, indirect=True)
@pytest.mark.parametrize("case", sorted(SCANS))
def test_scumulative_matches(meshes, case):
    fn, shape, dtype, exact = SCANS[case]
    rng = np.random.RandomState(7)
    v = (rng.randint(-9, 9, size=shape) if dtype == "int64"
         else rng.rand(*shape)).astype(dtype)
    rsk._warned_nonassoc = psk._warned_nonassoc = True
    r0 = rreg.counters["skeletons.scan_allgather_bytes_est"]
    p0 = preg.counters["skeletons.scan_allgather_bytes_est"]
    want = fn(rtj, rtj.fromarray(v)).asarray()
    got = fn(rt, rt.fromarray(v)).asarray()
    _same(got, want, exact)
    # ramba_tpu counts at every trace and traces a new program twice
    assert 2 * (preg.counters["skeletons.scan_allgather_bytes_est"] - p0) \
        == rreg.counters["skeletons.scan_allgather_bytes_est"] - r0


@pytest.mark.parametrize("meshes", [(8,), (2, 2)], indirect=True)
def test_scumulative_distributes_where_the_axis_is_split(meshes):
    v = np.random.RandomState(8).rand(4096)
    p0 = preg.counters["skeletons.scan_allgather_bytes_est"]
    rt.scumulative(_add, _rebase, rt.fromarray(v)).asarray()
    assert preg.counters["skeletons.scan_allgather_bytes_est"] > p0
    # a short array scans whole: no carry fix-up
    p1 = preg.counters["skeletons.scan_allgather_bytes_est"]
    rt.scumulative(_add, _rebase, rt.fromarray(v[:64])).asarray()
    assert preg.counters["skeletons.scan_allgather_bytes_est"] == p1
    np.testing.assert_allclose(
        rt.scumulative(_add, _rebase, rt.fromarray(v)).asarray(),
        np.cumsum(v), rtol=1e-12)


@pytest.mark.parametrize("meshes", [(8,), (2, 2)], indirect=True)
def test_nonassociative_sharded_warns_once(meshes):
    def clamp(x, c):
        return np.maximum(0.0, x + c)

    v = np.random.RandomState(9).rand(4096)
    for mod, sk in ((rtj, rsk), (rt, psk)):
        sk._warned_nonassoc = False
        with pytest.warns(RuntimeWarning, match="per-block carry") as rec:
            mod.scumulative(clamp, clamp, mod.fromarray(v),
                            associative=False).asarray()
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            mod.scumulative(clamp, clamp, mod.fromarray(v[:32]),
                            associative=False).asarray()
        msg = [str(w.message) for w in rec]
        if mod is rtj:
            want = msg
    assert msg == want


# -- sreduce --------------------------------------------------------------


@pytest.mark.parametrize("meshes", MESHES, indirect=True)
@pytest.mark.parametrize("n", [64, 1000, 1003, 4096])
def test_sreduce_reducer_split(meshes, n):
    v = np.random.RandomState(10).rand(n)

    def red(m):
        return m.sreduce(lambda x: x * x,
                         m.SreduceReducer(lambda x, y: x + y,
                                          lambda x, y: y + x), 0.0,
                         m.fromarray(v))

    _same(red(rt).asarray(), red(rtj).asarray())
    assert red(rt).asarray().tobytes() == red(rt).asarray().tobytes()


@pytest.mark.parametrize("meshes", MESHES, indirect=True)
def test_sreduce_second_reducer_folds_the_partials(meshes):
    # per-shard sums, then their max: the largest shard sum
    v = np.arange(1024.0)

    def red(m):
        return m.sreduce(lambda x: x, m.SreduceReducer(
            lambda x, y: x + y, lambda x, y: np.maximum(x, y)), 0.0,
            m.fromarray(v))

    want = red(rtj).asarray()
    _same(red(rt).asarray(), want)
    nw = rt.num_workers()
    assert float(want) == v.reshape(nw, -1).sum(axis=1).max()


@pytest.mark.parametrize("meshes", MESHES, indirect=True)
def test_sreduce_plain_reducer_ignores_the_mesh(meshes):
    v = np.random.RandomState(11).rand(1000)

    def red(m):
        return m.sreduce(lambda x: x, lambda x, y: x + y, 0.0,
                         m.fromarray(v))

    _same(red(rt).asarray(), red(rtj).asarray())


def test_sreduce_reducer_on_one_shard_folds_unsplit(monkeypatch):
    # the default one-shard mesh: the worker reducer folds the flat data
    # in 1-D halves, as a plain reducer does, and the driver one is unused
    monkeypatch.setattr(pmesh, "_mesh", None)
    monkeypatch.setattr(pmesh, "_mesh_is_default", False)
    seen = []

    def worker(x, y):
        seen.append(x.ndim)
        return x + y

    v = np.random.RandomState(12).rand(1000)
    got = rt.sreduce(lambda x: x, rt.SreduceReducer(worker, None), 0.0,
                     rt.fromarray(v)).asarray()
    want = rt.sreduce(lambda x: x, lambda x, y: x + y, 0.0,
                      rt.fromarray(v)).asarray()
    assert got.tobytes() == want.tobytes()
    assert seen and set(seen) == {1}


def test_one_shard_mesh_runs_in_the_calling_thread():
    import threading

    seen = []
    a = rt.fromarray(np.zeros(8))
    rt.spmd(lambda lv: seen.append(threading.current_thread().name), a)
    assert seen == [threading.current_thread().name]
    assert parallel.comm_stats is parallel.comm_stats


@pytest.mark.parametrize("meshes", [(8,)], indirect=True)
def test_shard_threads_under_a_short_switch_interval(meshes):
    # eight shard threads meeting at five halo rounds, with the
    # interpreter switching threads as often as it can: every round must
    # see every shard's state of that round (a lost or stale post would
    # change the sums)
    import sys

    v = np.arange(800, dtype=np.float64)

    def kern(src):
        for _ in range(5):
            src.set_local(_sum3(src.halo(1)))

    want = v.copy()
    for _ in range(5):
        p = np.pad(want, 1)
        want = p[:-2] + p[1:-1] + p[2:]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        a = rt.fromarray(v)
        t0 = __import__("time").monotonic()
        rt.spmd(kern, a)
        got = a.asarray()
        assert __import__("time").monotonic() - t0 < 120
    finally:
        sys.setswitchinterval(old)
    _same(got, want)
