"""The creation tail of ``ops/creation.py`` and the namespace constants:
the port against ramba_tpu, x64 regime.

Each function runs through both packages with the same arguments; values
and dtypes are compared exactly (the grids and progressions are the same
arithmetic: ``index * step + start``, ``base ** linspace``), except where
XLA's compiler rewrites the arithmetic (logspace's and geomspace's power,
within 4 ulp of the largest value; cast to an integer dtype, within one
unit, since values that close can straddle an integer).  The dtype sweep
covers every dtype ramba_tpu's creation functions take.
"""

import numpy as np
import pytest
import torch

import jax
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from ramba_tpu_torch import common

SWEEP = ["bool", "int8", "int16", "int32", "int64", "uint8", "uint16",
         "uint32", "uint64", "float16", "float32", "float64", "complex64",
         "complex128"]


@pytest.fixture(autouse=True)
def _port_on_cpu():
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    torch.set_num_threads(1)


def _host(x):
    return np.asarray(x.asarray() if hasattr(x, "asarray") else x)


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [y for x in out for y in _flat(x)]
    return [out]


def _same(got, want, what, ulps=0):
    g, w = _host(got), _host(want)
    assert g.dtype == w.dtype, f"{what}: port {g.dtype} vs ramba_tpu {w.dtype}"
    assert g.shape == w.shape, f"{what}: port {g.shape} vs ramba_tpu {w.shape}"
    if ulps and g.dtype.kind in "fc" and g.size:
        tol = ulps * np.spacing(np.abs(w).max().astype(w.real.dtype))
        assert np.abs(g - w).max() <= tol, what
        return
    if ulps and g.dtype.kind in "iu" and g.size:
        # the float values within ``ulps`` of each other truncate to
        # integers one apart where they straddle one
        assert np.abs(g.astype(np.int64) - w.astype(np.int64)).max() <= 1, what
        return
    np.testing.assert_array_equal(g, w, err_msg=what)


def _both(case, what, ulps=0):
    try:
        want = _flat(case(rtj))
        want = [_host(w) for w in want]
    except Exception as e:
        with pytest.raises(type(e)):
            [_host(g) for g in _flat(case(rt))]
        return
    got = _flat(case(rt))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _same(g, w, f"{what}[{i}]", ulps)


@pytest.mark.parametrize("dtype", SWEEP)
def test_eye_identity_tri(dtype):
    _both(lambda m: [m.eye(4, dtype=dtype), m.eye(3, 5, k=1, dtype=dtype),
                     m.eye(5, 3, k=-2, dtype=dtype),
                     m.identity(3, dtype=dtype), m.tri(4, dtype=dtype),
                     m.tri(3, 5, k=1, dtype=dtype),
                     m.tri(4, 2, k=-1, dtype=dtype)], f"eye/tri {dtype}")


def test_default_dtypes():
    _both(lambda m: [m.eye(3), m.identity(2), m.tri(3), m.indices((2, 3))],
          "defaults")


@pytest.mark.parametrize("dtype", ["int8", "int32", "int64", "float32",
                                   "float64"])
def test_indices(dtype):
    _both(lambda m: [m.indices((2, 3, 4), dtype=dtype),
                     m.indices((5,), dtype=dtype)], f"indices {dtype}")


@pytest.mark.parametrize("dtype", SWEEP)
def test_meshgrid(dtype):
    x = np.arange(4).astype(dtype)
    y = np.arange(3).astype(dtype)
    _both(lambda m: m.meshgrid(m.fromarray(x), m.fromarray(y))
          + m.meshgrid(m.fromarray(x), m.fromarray(y), indexing="ij")
          + m.meshgrid(m.fromarray(x), m.fromarray(y), m.fromarray(x[:2])),
          f"meshgrid {dtype}")


def test_mgrid_ogrid():
    _both(lambda m: [m.mgrid[0:4, 0:3], m.mgrid[0:5], m.mgrid[-1:1:5j],
                     m.mgrid[0:2:0.5, 1:3], m.mgrid[0:1:4j, 0:3]], "mgrid")
    _both(lambda m: list(m.ogrid[0:4, 0:3]) + [m.ogrid[0:5],
                                               m.ogrid[0:1:5j]], "ogrid")


def test_r_c():
    _both(lambda m: [m.r_[m.fromarray(np.arange(3)), 7, 8],
                     m.r_[0:4, m.fromarray(np.ones(2))],
                     m.c_[m.fromarray(np.arange(3)), m.fromarray(np.ones(3))]],
          "r_/c_")


@pytest.mark.parametrize("dtype", [None, "float32", "float64", "int64"])
def test_logspace_geomspace(dtype):
    _both(lambda m: [m.logspace(0, 3, 7, dtype=dtype),
                     m.logspace(1, 2, 5, endpoint=False, dtype=dtype),
                     m.logspace(0, 4, 5, base=2.0, dtype=dtype)],
          f"logspace {dtype}", ulps=4)
    _both(lambda m: [m.geomspace(1, 1000, 4, dtype=dtype),
                     m.geomspace(-1, -64, 7, dtype=dtype),
                     m.geomspace(2, 3, 5, endpoint=False, dtype=dtype)],
          f"geomspace {dtype}", ulps=4)


def test_geomspace_refusals():
    for args in ((0, 5), (-1, 5)):
        _both(lambda m, a=args: m.geomspace(*a, 3), f"geomspace{args}")


def test_host_readers():
    buf = np.arange(6, dtype=np.float32).tobytes()
    _both(lambda m: [m.fromiter(range(5), dtype=np.int16),
                     m.fromiter((i * 0.5 for i in range(4)), float, count=3),
                     m.frombuffer(buf, dtype=np.float32),
                     m.frombuffer(buf, dtype=np.float32, count=2, offset=4),
                     m.fromstring("1 2 3", dtype=int, sep=" ")], "from*")


@pytest.mark.parametrize("dtype", SWEEP)
def test_layout_and_checks(dtype):
    x = (np.arange(12) % 5).reshape(3, 4).astype(dtype)
    _both(lambda m: [m.ascontiguousarray(m.fromarray(x)),
                     m.asfortranarray(m.fromarray(x)),
                     m.ascontiguousarray(m.fromarray(x), dtype=np.float64),
                     m.asarray_chkfinite(m.fromarray(x))], f"layout {dtype}")


def test_asarray_chkfinite_refuses():
    for bad in (np.array([1.0, np.nan]), np.array([np.inf, 1.0])):
        _both(lambda m, b=bad: m.asarray_chkfinite(m.fromarray(b)),
              "chkfinite")


def test_rollaxis():
    x = np.arange(24).reshape(2, 3, 4)
    for axis, start in ((2, 0), (0, 3), (-1, 1), (1, -2), (1, 1)):
        _both(lambda m, a=axis, s=start: m.rollaxis(m.fromarray(x), a, s),
              f"rollaxis({axis}, {start})")
    for axis, start in ((3, 0), (0, 4)):
        _both(lambda m, a=axis, s=start: m.rollaxis(m.fromarray(x), a, s),
              f"rollaxis({axis}, {start}) refused")


def test_namespace_constants_and_printing():
    names = ["pi", "e", "inf", "nan", "euler_gamma", "bool_", "int8", "int16",
             "int32", "int64", "uint8", "uint16", "uint32", "uint64",
             "float16", "float32", "float64", "complex64", "complex128",
             "dtype", "float_", "int_", "byte", "ubyte", "short", "ushort",
             "intc", "uintc", "uint", "longlong", "ulonglong", "half",
             "single", "double", "longdouble", "csingle", "cdouble",
             "clongdouble", "iinfo", "finfo", "s_", "index_exp", "ndindex",
             "broadcast_shapes", "errstate", "printoptions",
             "set_printoptions", "get_printoptions", "promote_types",
             "can_cast", "issubdtype", "newaxis"]
    for n in names:
        a, b = getattr(rt, n), getattr(rtj, n)
        assert a is b or (isinstance(a, float) and (a == b or a != a)), n
    x = np.arange(6.0).reshape(2, 3)
    p, r = rt.fromarray(x), rtj.fromarray(x)
    assert rt.array2string(p) == rtj.array2string(r)
    assert rt.array_repr(p) == rtj.array_repr(r)
    assert rt.array_str(p) == rtj.array_str(r)
    assert list(rt.ndenumerate(p)) == list(rtj.ndenumerate(r))
    assert np.array2string(p) == np.array2string(x)
    rt.init()


def test_creation_is_exported_and_registered():
    from ramba_tpu_torch.core.interop import HANDLED_FUNCTIONS

    names = ["arange", "array", "asarray", "asarray_chkfinite",
             "ascontiguousarray", "asfortranarray", "copy", "empty",
             "empty_like", "eye", "frombuffer", "fromarray", "fromfunction",
             "fromiter", "fromstring", "full", "c_", "full_like", "geomspace",
             "identity", "indices", "init_array", "linspace", "logspace",
             "meshgrid", "mgrid", "ogrid", "ones", "ones_like", "r_",
             "rollaxis", "tri", "zeros", "zeros_like"]
    assert [n for n in names if not hasattr(rt, n)] == []
    # every name of ramba_tpu's dispatch registry is registered here too
    missing = [f.__name__ for f in rtj.core.interop.HANDLED_FUNCTIONS
               if f not in HANDLED_FUNCTIONS]
    assert missing == [], missing


# -- linspace: jax 0.9's formula --------------------------------------------
# The port computes jnp.linspace's ``start * (1 - t) + stop * t`` with
# ``t = iota * (1 / div)`` (XLA's CPU compiler folds the division by the
# constant ``div`` into that product), not NumPy's ``start + step * iota``.
# One divergence stays: XLA contracts the product and the sum into an
# FMA, the port rounds both, so an element may differ by one ulp of
# max(|start|, |stop|) in the requested dtype (float16 too: XLA computes
# it in float32).  Integer dtypes floor the same values: exact.


@pytest.mark.parametrize("dtype", ["float16", "float32", "float64", "int32"])
@pytest.mark.parametrize("endpoint", [True, False])
@pytest.mark.parametrize("start, stop, num", [
    (0.0, 1.0, 7), (-3.3, 7.1, 33), (-5.0, 5.0, 11), (2.5, -1000.0, 100),
    (-1.0, 1.0, 2), (3.0, 3.0, 1), (0.0, 1.0, 0), (-7.0, 9.0, 1000)])
def test_linspace_follows_jnp(dtype, endpoint, start, stop, num):
    got = rt.linspace(start, stop, num, endpoint=endpoint,
                      dtype=dtype).asarray()
    want = np.asarray(rtj.linspace(start, stop, num, endpoint=endpoint,
                                   dtype=dtype))
    assert got.dtype == want.dtype and got.shape == want.shape
    if dtype == "int32":
        np.testing.assert_array_equal(got, want)
        return
    ulp = np.spacing(np.asarray(max(abs(start), abs(stop)), dtype=dtype))
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert (diff <= float(ulp)).all(), (diff.max(), float(ulp))


def test_linspace_is_not_numpys_formula():
    # the value the old comment's formula (NumPy's) gets wrong
    got = rt.linspace(0, 1, 7, dtype=np.float32).asarray()[5]
    assert float(got) == 0.8333333730697632
    assert float(np.linspace(0, 1, 7, dtype=np.float32)[5]) == \
        0.8333333134651184


# -- distribution= on every creation op ------------------------------------------
# Both packages on a mesh of k shards (ramba_tpu: its first k virtual CPU
# devices; the port: k positions on the CPU), restored afterwards.  Every
# shard's index must be the one ramba_tpu's sharding gives the device at
# that position, and the values equal.  Even shapes only: jax 0.9 keeps an
# uneven layout on one device (the port cuts blocks of ceil(n / parts)).

DIST_MESHES = [(2,), (4,), (8,), (2, 2)]


@pytest.fixture
def dist_mesh(request):
    from jax.sharding import Mesh as JMesh

    from ramba_tpu.parallel import mesh as rmesh
    from ramba_tpu_torch.parallel import mesh as pmesh

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


def _same_layout(got, want, what):
    """The port's shards sit where ramba_tpu's sharding puts each device
    of the same mesh position, with the same values."""
    jv = want._value()
    jidx = jv.sharding.devices_indices_map(want.shape)
    jmesh = jv.sharding.mesh
    shape = tuple(got.shape)
    shards = got.addressable_shards
    assert len(shards) == jmesh.devices.size, what
    for s in shards:
        jw = jidx[jmesh.devices[s.position]]
        assert [sl.indices(n) for sl, n in zip(s.index, shape)] == \
            [sl.indices(n) for sl, n in zip(jw, shape)], (what, s.position)
    _same(got, want, what)


def _dist_cases(k):
    """``(name, make(package, distribution), distributions)``: every
    creation op that takes ``distribution=``."""
    two = [(k, 1), (1, k)]
    return [
        ("zeros", lambda m, d: m.zeros((32, 16), distribution=d), two),
        ("ones", lambda m, d: m.ones((32, 16), dtype="int32",
                                     distribution=d), two),
        ("empty", lambda m, d: m.empty((32, 16), distribution=d) * 0, two),
        ("full", lambda m, d: m.full((32, 16), 2.5, distribution=d), two),
        ("zeros_like", lambda m, d: m.zeros_like(
            np.ones((32, 16)), distribution=d), two),
        ("ones_like", lambda m, d: m.ones_like(
            np.ones((32, 16), np.float32), distribution=d), two),
        ("empty_like", lambda m, d: m.empty_like(
            np.ones((32, 16)), distribution=d) * 0, two),
        ("full_like", lambda m, d: m.full_like(
            np.ones((32, 16)), 7, distribution=d), two),
        ("fromfunction", lambda m, d: m.fromfunction(
            lambda i, j: i * 100 + j, (32, 16), dtype="int64",
            distribution=d), two),
        ("init_array", lambda m, d: m.init_array(
            (32, 16), lambda i, j: i - j, dtype="int32", distribution=d),
         two),
        ("eye", lambda m, d: m.eye(32, 16, k=1, distribution=d), two),
        ("identity", lambda m, d: m.identity(32, distribution=d), two),
        ("arange", lambda m, d: m.arange(1024, distribution=d), [(k,)]),
        ("arange_float", lambda m, d: m.arange(
            -3.0, 1021.0, dtype="float32", distribution=d), [(k,)]),
        ("linspace", lambda m, d: m.linspace(
            0.0, 1.0, 1024, distribution=d), [(k,)]),
        ("fromarray", lambda m, d: m.fromarray(
            np.arange(512.0).reshape(32, 16), distribution=d), two),
    ]


@pytest.mark.parametrize("dist_mesh", DIST_MESHES, indirect=True)
@pytest.mark.parametrize("case", range(16))
def test_creation_takes_distribution(dist_mesh, case):
    k = int(np.prod(dist_mesh))
    name, make, dists = _dist_cases(k)[case]
    for d in dists:
        _same_layout(make(rt, d), make(rtj, d), f"{name} {d}")


@pytest.mark.parametrize("dist_mesh", [(4,), (2, 2)], indirect=True)
def test_creation_takes_a_partition_spec(dist_mesh):
    from jax.sharding import PartitionSpec as JP

    from ramba_tpu_torch.parallel import mesh as pmesh

    names = tuple(f"d{i}" for i in range(len(dist_mesh)))
    for entries in [(names[0],), (None, names[-1]), (names,)]:
        _same_layout(rt.zeros((32, 16), distribution=pmesh.P(*entries)),
                     rtj.zeros((32, 16), distribution=JP(*entries)),
                     f"zeros {entries}")


@pytest.mark.parametrize("dist_mesh", DIST_MESHES, indirect=True)
def test_create_array_with_divisions_both_forms(dist_mesh):
    k = int(np.prod(dist_mesh))
    # per-dim split counts
    for splits in [(k, 1), (1, k)]:
        for dt in (None, "float32", "int64"):
            _same_layout(
                rt.create_array_with_divisions((32, 16), splits, dtype=dt),
                rtj.create_array_with_divisions((32, 16), splits, dtype=dt),
                f"counts {splits} {dt}")
    # the reference's per-worker (starts, ends) table: k row blocks
    rows = np.array([[[i * 32 // k, 0], [(i + 1) * 32 // k, 16]]
                     for i in range(k)])
    a = rt.create_array_with_divisions((32, 16), rows, local_border=2)
    b = rtj.create_array_with_divisions((32, 16), rows, local_border=2)
    _same_layout(a, b, "ranges")
    a[:] = 1.0
    b[:] = 1.0
    assert float(a.sum()) == float(b.sum()) == 512.0


@pytest.mark.parametrize("dist_mesh", [(2, 2)], indirect=True)
def test_elementwise_keeps_the_chosen_layout(dist_mesh):
    # an elementwise result of one array with a chosen layout keeps it
    for d in [(4, 1), (1, 4)]:
        got = rt.zeros((32, 16), distribution=d)
        assert tuple(got.sharding.spec) == tuple(
            rtj.zeros((32, 16), distribution=d)._value().sharding.spec)


def test_distribution_on_another_mesh_is_refused():
    from ramba_tpu_torch.parallel import mesh as pmesh

    other = pmesh.Mesh(np.array([torch.device("cpu")] * 2, dtype=object),
                       ("x",))
    with pytest.raises(ValueError, match="different mesh"):
        rt.zeros((8, 8), distribution=pmesh.NamedSharding(other,
                                                          pmesh.P("x")))
