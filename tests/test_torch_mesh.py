"""The port's mesh of shards (``ramba_tpu_torch/parallel``) against
ramba_tpu's, x64 regime.

ramba_tpu runs on a mesh of the first k of its virtual CPU devices
(``tests/conftest.py`` makes 8), the port on a mesh of the same shape whose
positions all hold the CPU; both meshes are restored afterwards.  Meshes of
2, 4 and 8 shards and 2x2 and 4x2 grids; a mesh larger than
``jax.devices()`` skips (the ``RAMBA_TEST_DEVICES=2`` leg).

Held here: the partition solver, ``default_spec``/``spec_from_splits``/
the greedy spec, the layouts arrays get (``fromarray``, flush results,
``put_sharded``, ``fromarray(distribution=)``), ``shardview``'s queries and
division algebra, ``constraints`` and ``smap(axis=)``, the default
one-shard mesh, a mesh of distinct devices (refused), and the health
record of the default mesh.  Everything here is index math, ints or exact
copies: every comparison is exact.

Uneven layouts are the port's own rule (blocks of ceil(n / parts)): jax
0.9 refuses a ``NamedSharding`` that does not divide the shape, and
ramba_tpu then keeps such an array on one device.  They are held against
the rule, not against ramba_tpu.
"""

import numpy as np
import pytest
import torch

import jax
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP
from ramba_tpu.parallel import constraints as rcon
from ramba_tpu.parallel import mesh as rmesh
from ramba_tpu.parallel import shardview as rsv
from ramba_tpu_torch import common, parallel
from ramba_tpu_torch.core import fuser
from ramba_tpu_torch.observe import events, health
from ramba_tpu_torch.parallel import constraints as pcon
from ramba_tpu_torch.parallel import mesh as pmesh
from ramba_tpu_torch.parallel import shardview as psv

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


def _spec(s):
    return tuple(s)


# -- the solver and the specs -------------------------------------------------

SOLVER = [
    ((8192, 8192), 8), ((8192, 8192), 4), ((8192, 8192), 16),
    ((100000, 10), 8), ((10, 100000), 8), ((1 << 20,), 8),
    ((64, 64, 64), 8), ((4, 100000), 8), ((37, 53), 6), ((3,), 4),
    ((5, 7, 11), 12), ((2, 2), 9),
]


@pytest.mark.parametrize("shape,n", SOLVER)
def test_compute_regular_schedule_matches(shape, n):
    assert pmesh.compute_regular_schedule(shape, n) == \
        rmesh.compute_regular_schedule(shape, n)


def test_schedule_of_the_card_mesh():
    # the solver factorises the shard count, not the device count
    assert pmesh.compute_regular_schedule((8192, 8192), 4) == (2, 2)


@pytest.mark.parametrize("n", range(1, 17))
def test_factors_match(n):
    assert pmesh.prime_factors(n) == rmesh.prime_factors(n)
    for k in (1, 2, 3):
        assert pmesh.balanced_factors(n, k) == rmesh.balanced_factors(n, k)


SHAPES = [(1024, 1024), (1 << 16,), (4, 4), (100000, 10), (10, 100000),
          (64, 64, 64), (64, 48), (2, 4096), (3, 5, 4096), (128,), (8, 8)]


@pytest.mark.parametrize("meshes", MESHES, indirect=True)
@pytest.mark.parametrize("shape", SHAPES)
def test_default_spec_matches(meshes, shape):
    assert _spec(pmesh.default_spec(shape)) == _spec(rmesh.default_spec(shape))
    assert _spec(pmesh._greedy_spec(shape, pmesh.get_mesh())) == \
        _spec(rmesh._greedy_spec(shape, rmesh.get_mesh()))


@pytest.mark.parametrize("meshes", MESHES, indirect=True)
@pytest.mark.parametrize("splits", [(2,), (4,), (8,), (2, 2), (4, 2),
                                    (1, 4), (2, 1, 2), (3,), (8, 1)])
def test_spec_from_splits_matches(meshes, splits):
    assert _spec(pmesh.spec_from_splits(splits)) == \
        _spec(rmesh.spec_from_splits(splits))


@pytest.mark.parametrize("meshes", MESHES, indirect=True)
def test_mesh_surface_matches(meshes):
    pm, rm = pmesh.get_mesh(), rmesh.get_mesh()
    assert dict(pm.shape) == dict(rm.shape)
    assert pm.axis_names == tuple(rm.axis_names)
    assert pm.devices.shape == rm.devices.shape
    assert pmesh.num_workers() == rmesh.num_workers() == rt.num_workers()
    assert rt.get_mesh() is pm
    assert _spec(pmesh.replicated_sharding().spec) == ()


def test_default_mesh_is_one_shard_on_the_device(monkeypatch):
    monkeypatch.setattr(pmesh, "_mesh", None)
    m = pmesh.get_mesh()
    assert dict(m.shape) == {"d0": 1} and m.device == torch.device("cpu")
    assert pmesh.default_spec((8192, 8192)) == pmesh.P()
    assert pmesh.num_workers() == rt.num_workers() == 1


def test_default_mesh_follows_the_device(monkeypatch):
    monkeypatch.setattr(pmesh, "_mesh", None)
    monkeypatch.setattr(pmesh, "_mesh_is_default", False)
    assert pmesh.get_mesh().device == torch.device("cpu")
    monkeypatch.setattr(common, "_device", torch.device("meta"))
    assert pmesh.get_mesh().device == torch.device("meta")
    # a mesh a caller set does not follow the device: reading it raises
    monkeypatch.setattr(common, "_device", torch.device("cpu"))
    pmesh.set_mesh(pmesh.Mesh(np.array([torch.device("cpu")] * 2,
                                       dtype=object), ("d0",)))
    monkeypatch.setattr(common, "_device", torch.device("meta"))
    with pytest.raises(ValueError, match="set a mesh on it"):
        pmesh.get_mesh()


def test_default_mesh_records_health(monkeypatch):
    monkeypatch.setattr(pmesh, "_mesh", None)
    monkeypatch.setattr(health, "_mesh_recorded", False)
    pmesh.get_mesh()
    ev = [e for e in events.last(50, type="health")
          if e.get("source") == "default_mesh"]
    assert ev and ev[-1]["device_count"] == 1
    assert ev[-1]["mesh_shape"] == {"d0": 1}


def test_distinct_devices_are_refused():
    with pytest.raises(NotImplementedError, match="multi-process slice"):
        pmesh.Mesh(np.array([torch.device("cpu"), torch.device("meta")],
                            dtype=object), ("d0",))


def test_mesh_on_another_device_is_refused():
    m = pmesh.Mesh(np.array([torch.device("meta")] * 2, dtype=object),
                   ("d0",))
    with pytest.raises(ValueError, match="arrays are created on"):
        pmesh.set_mesh(m)


def test_mesh_epoch_bumps():
    e0 = pmesh.mesh_epoch
    pmesh.set_mesh(pmesh.get_mesh())
    assert pmesh.mesh_epoch == e0 + 1


# -- layouts and the shardview queries ---------------------------------------


def _layout_pair(v):
    return rtj.fromarray(v), rt.fromarray(v)


@pytest.mark.parametrize("meshes", MESHES, indirect=True)
@pytest.mark.parametrize("shape", [(64, 48), (256,), (16, 8, 32), (4, 4)])
def test_shardview_queries_match(meshes, shape):
    v = np.arange(int(np.prod(shape)), dtype=np.float64).reshape(shape)
    ra, pa = _layout_pair(v)
    assert psv.shard_slices(pa) == rsv.shard_slices(ra)
    np.testing.assert_array_equal(psv.divisions(pa), rsv.divisions(ra))
    np.testing.assert_array_equal(psv.default_distribution(shape),
                                  rsv.default_distribution(shape))
    rng = np.random.RandomState(0)
    for _ in range(6):
        idx = tuple(int(rng.randint(0, s)) for s in shape)
        assert psv.find_owning_worker(pa, idx) == \
            rsv.find_owning_worker(ra, idx)
    with pytest.raises(IndexError):
        psv.find_owning_worker(pa, tuple(s for s in shape))
    # every shard is a view of the one tensor: its block is the slice
    t = pa._value()
    for sh in pa.addressable_shards:
        assert sh.data.data_ptr() == t[sh.index].data_ptr()
        np.testing.assert_array_equal(sh.data.numpy(), v[sh.index])


@pytest.mark.parametrize("meshes", MESHES, indirect=True)
def test_flush_results_take_the_default_layout(meshes):
    v = np.random.RandomState(1).rand(64, 48)
    ra, pa = _layout_pair(v)
    rb, pb = ra * 2.0 + 1.0, pa * 2.0 + 1.0
    np.testing.assert_array_equal(pb.asarray(), rb.asarray())
    assert psv.shard_slices(pb) == rsv.shard_slices(rb)
    assert _spec(pb.sharding.spec) == _spec(pmesh.default_spec((64, 48)))


@pytest.mark.parametrize("meshes", MESHES, indirect=True)
def test_put_sharded_matches(meshes):
    from ramba_tpu.core.expr import Const as RConst
    from ramba_tpu.core.ndarray import put_sharded as rput
    from ramba_tpu_torch.core.ndarray import put_sharded as pput

    axes = tuple(pmesh.get_mesh().axis_names)
    v = np.random.RandomState(1).rand(64, 64)
    ra = rtj.fromarray(v)
    ra.write_expr(RConst(rput(v, JNamedSharding(rmesh.get_mesh(),
                                                 JP(None, axes)))))
    pa = pput(v, pmesh.NamedSharding(pmesh.get_mesh(), pmesh.P(None, axes)))
    assert psv.shard_slices(pa) == rsv.shard_slices(ra)
    np.testing.assert_array_equal(psv.divisions(pa), rsv.divisions(ra))
    np.testing.assert_array_equal(pa.asarray(), ra.asarray())
    assert pa.dtype == np.dtype(ra.dtype)


@pytest.mark.parametrize("meshes", [(4,), (2, 2), (4, 2)], indirect=True)
@pytest.mark.parametrize("dist", ["spec", "splits", "sharding"])
def test_fromarray_distribution_matches(meshes, dist):
    axes = tuple(pmesh.get_mesh().axis_names)
    v = np.arange(64 * 32.0).reshape(64, 32)
    k = pmesh.num_workers()
    if dist == "spec":
        rd, pd = JP(axes), pmesh.P(axes)
    elif dist == "splits":
        rd = pd = (1, k)
    else:
        rd = JNamedSharding(rmesh.get_mesh(), JP(None, axes[0]))
        pd = pmesh.NamedSharding(pmesh.get_mesh(), pmesh.P(None, axes[0]))
    ra, pa = rtj.fromarray(v, distribution=rd), rt.fromarray(v,
                                                           distribution=pd)
    np.testing.assert_array_equal(psv.divisions(pa), rsv.divisions(ra))
    np.testing.assert_array_equal(pa.asarray(), ra.asarray())


def test_uneven_layout_rule():
    m = pmesh.Mesh(np.array([torch.device("cpu")] * 4, dtype=object),
                   ("d0",))
    sh = pmesh.NamedSharding(m, pmesh.P("d0"))
    assert [idx for _p, idx in sh.shard_indices((10,))] == [
        (slice(0, 3),), (slice(3, 6),), (slice(6, 9),), (slice(9, 10),)]
    assert [idx for _p, idx in sh.shard_indices((3,))] == [
        (slice(0, 1),), (slice(1, 2),), (slice(2, 3),), (slice(3, 3),)]
    with pytest.raises(ValueError, match="does not have"):
        pmesh.NamedSharding(m, pmesh.P("d9"))


def test_other_creation_ops_refuse_distributions():
    # they refused before A.6 part three; now every creation op takes one
    # (tests/test_torch_creation.py holds each against ramba_tpu): on the
    # one-shard default mesh a split it cannot realize leaves it whole,
    # as the reference's spec_from_splits does
    a = rt.zeros((8, 8), distribution=(2, 1))
    assert tuple(a.sharding.spec) == ()
    np.testing.assert_array_equal(a.asarray(), np.zeros((8, 8)))


def test_one_shard_mesh_keeps_the_bytes():
    # the default mesh changes nothing: same values, one whole shard
    v = np.random.RandomState(2).rand(300)
    pa = rt.fromarray(v)
    assert len(pa.addressable_shards) == 1
    assert pa.addressable_shards[0].index == (slice(None),)
    np.testing.assert_array_equal((pa * 3.0).asarray(), v * 3.0)


# -- division algebra ----------------------------------------------------------


@pytest.mark.parametrize("meshes", MESHES, indirect=True)
def test_division_algebra_matches(meshes):
    rt_a, pt_a = rtj.zeros((64, 64)), rt.zeros((64, 64))
    rtj.sync()
    d_r, d_p = rsv.divisions(rt_a), psv.divisions(pt_a)
    np.testing.assert_array_equal(d_p, d_r)
    for index in [(slice(10, 50), slice(None, 32)), (7,), (-1,),
                  (slice(None), 5), (slice(60, None),)]:
        np.testing.assert_array_equal(psv.slice_divisions(d_p, index),
                                      rsv.slice_divisions(d_r, index))
    for bad, err in [((64,), IndexError), ((None,), TypeError)]:
        with pytest.raises(err):
            psv.slice_divisions(d_p, bad)
    shifted = d_p.copy()
    shifted[:, :, 0] += 32
    np.testing.assert_array_equal(psv.intersect_divisions(d_p, shifted),
                                  rsv.intersect_divisions(d_r, shifted))
    np.testing.assert_array_equal(psv.divisions_size(d_p),
                                  rsv.divisions_size(d_r))
    n = len(d_p)
    one = np.zeros((n, 2, 2), np.int64)
    one[:, 0, 0] = np.arange(n)
    one[:, 1, 0] = np.arange(n) + 1
    one[:, 1, 1] = 1
    np.testing.assert_array_equal(psv.broadcast_divisions(one, (3, n, 5)),
                                  rsv.broadcast_divisions(one, (3, n, 5)))
    np.testing.assert_array_equal(psv.make_uni_divisions((4, 4), worker=1),
                                  rsv.make_uni_divisions((4, 4), worker=1))


# -- constraints ----------------------------------------------------------------


@pytest.mark.parametrize("meshes", MESHES, indirect=True)
@pytest.mark.parametrize("axis", [0, 1, -1])
def test_add_constraint_matches(meshes, axis):
    v = np.random.RandomState(3).rand(64, 64)
    ra, pa = rtj.fromarray(v) + 1.0, rt.fromarray(v) + 1.0
    rb, pb = rtj.fromarray(v) * 2.0, rt.fromarray(v) * 2.0
    rcon.clear_constraints()
    rt.clear_constraints()
    rc = rcon.add_constraint([ra, rb], axis)
    pc = rt.add_constraint([pa, pb], axis)
    assert _spec(pc.spec) == _spec(rc.spec)
    assert _spec(pcon.axis_spec(2, axis)) == _spec(rcon.axis_spec(2, axis))
    assert pc.axis == rc.axis and len(pc.arrays) == 2
    for r, p in ((ra, pa), (rb, pb)):
        np.testing.assert_array_equal(p.asarray(), r.asarray())
        assert psv.shard_slices(p) == rsv.shard_slices(r)
        assert _spec(p.sharding.spec) == _spec(pc.spec)
    assert rt.get_constraints() == [pc]
    rt.clear_constraints()
    assert rt.get_constraints() == []


@pytest.mark.parametrize("meshes", [(4,), (2, 2)], indirect=True)
def test_only_hinted_roots_carry_a_layout(meshes):
    # an ordinary flush result carries none (its layout is default_spec of
    # the mesh it is read on); a hinted root carries the hint's
    v = np.random.RandomState(6).rand(64, 64)
    a, b = rt.fromarray(v) + 1.0, rt.fromarray(v) * 2.0
    rt.add_constraint([b], 1)
    rt.sync()
    assert a._expr.sharding is None
    assert _spec(a.sharding.spec) == _spec(pmesh.default_spec((64, 64)))
    assert b._expr.sharding == pmesh.NamedSharding(pmesh.get_mesh(),
                                                   pcon.axis_spec(2, 1))
    assert _spec(pmesh.layout_of(b, pmesh.get_mesh())) == \
        _spec(pcon.axis_spec(2, 1))
    rt.clear_constraints()


@pytest.mark.parametrize("meshes", [(4,), (2, 2)], indirect=True)
def test_smap_axis_copartitions(meshes):
    v = np.random.RandomState(4).rand(32, 16)
    w = np.random.RandomState(5).rand(32, 16)
    rt.clear_constraints()
    ra, rb = rtj.fromarray(v) + 0.0, rtj.fromarray(w) + 0.0
    pa, pb = rt.fromarray(v) + 0.0, rt.fromarray(w) + 0.0
    r = rtj.smap(lambda x, y: x + y, ra, rb, axis=0)
    p = rt.smap(lambda x, y: x + y, pa, pb, axis=0)
    np.testing.assert_array_equal(p.asarray(), r.asarray())
    (con,) = rt.get_constraints()
    assert con.axis == 0 and len(con.arrays) == 2
    assert psv.shard_slices(pa) == rsv.shard_slices(ra)
    assert _spec(pa.sharding.spec) == _spec(pcon.axis_spec(2, 0))


def test_constraint_on_one_shard_adds_no_node():
    a = rt.arange(64.0) + 1.0
    before = a.read_expr()
    c = rt.add_constraint([a], 0)
    assert a.read_expr() is before and c.arrays == [a]
    rt.clear_constraints()


def test_assemble_counter_starts_at_views():
    # reading a sharded leaf whole copies nothing
    before = dict(parallel.comm_stats)
    v = np.arange(64.0)
    np.testing.assert_array_equal(rt.fromarray(v).asarray(), v)
    assert parallel.comm_stats == before
    assert fuser.stats["flushes"] >= 0
