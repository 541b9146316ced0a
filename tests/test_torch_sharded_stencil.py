"""The sharded stencil (``ramba_tpu_torch/ops/stencil_sharded.py``) against
ramba_tpu's (``ramba_tpu/ops/stencil_sharded.py``), x64 regime.

Both packages run on meshes of the same shape (2, 4 and 8 shards; 2x2
and 4x2 grids): ramba_tpu on its first k virtual CPU devices, the port on
shard positions that all hold the CPU, both restored afterwards.  The
cases mirror ``tests/test_sharded_stencil.py``: star2, odd shapes (the
padded path), asymmetric and corner offsets, two input arrays, a literal
argument, 1-D and 3-D stencils, and ``sstencil_iterate``.

Tolerances: the port's sharded result equals the port's one-shard result
byte for byte (the same operations on the same values, halos included);
against ramba_tpu, dtypes exactly and float64 values within rtol=atol=1e-12
(XLA on the CPU contracts ``0.25*a + 0.125*b`` into fused multiply-adds);
integer stencils exactly.  Counters: ``stencil.halo_bytes_est`` counts
what ramba_tpu's trace-time estimate counts for one sweep, per sweep
(ramba_tpu counts per trace, and traces a new program twice);
``parallel.comm_stats`` counts one assembled block per shard per sweep.
"""

import numpy as np
import pytest
import torch

import jax
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from jax.sharding import Mesh as JMesh
from ramba_tpu.observe import registry as rreg
from ramba_tpu.ops import stencil_sharded as rss
from ramba_tpu.parallel import mesh as rmesh
from ramba_tpu_torch import common, parallel
from ramba_tpu_torch.observe import registry as preg
from ramba_tpu_torch.ops import stencil_kernel as psk
from ramba_tpu_torch.ops import stencil_sharded as pss
from ramba_tpu_torch.parallel import mesh as pmesh

MESHES = [(2,), (4,), (8,), (2, 2), (4, 2)]
TOL = 1e-12


@pytest.fixture(autouse=True)
def _port_on_cpu():
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    torch.set_num_threads(1)


def _set(shape):
    k = int(np.prod(shape))
    names = tuple(f"d{i}" for i in range(len(shape)))
    rmesh.set_mesh(JMesh(np.array(jax.devices()[:k]).reshape(shape), names))
    pmesh.set_mesh(pmesh.Mesh(
        np.array([torch.device("cpu")] * k, dtype=object).reshape(shape),
        names))


@pytest.fixture
def meshes(request):
    """Both packages on a mesh of ``request.param`` shards."""
    shape = request.param
    if len(jax.devices()) < int(np.prod(shape)):
        pytest.skip(f"needs {int(np.prod(shape))} devices")
    old_r, old_p = rmesh.get_mesh(), pmesh.get_mesh()
    try:
        yield shape
    finally:
        rmesh.set_mesh(old_r)
        pmesh.set_mesh(old_p)


@pytest.fixture
def spy(monkeypatch):
    """Counts the port's sharded runs."""
    calls = {"n": 0}
    real = pss.run

    def run(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(pss, "run", run)
    return calls


def star2(a):
    return (0.25 * (a[0, 1] + a[0, -1] + a[1, 0] + a[-1, 0])
            + 0.125 * (a[0, 2] + a[0, -2] + a[2, 0] + a[-2, 0]))


def shifted(a):
    return a[-3, 0] + a[0, 2]


def diag(a):
    return a[-1, -1] + a[1, 1]


def mix(a, b):
    return a[0, 0] + 0.5 * (b[-1, 0] + b[1, 0])


def scaled(a, w):
    return w * (a[0, -1] + a[0, 1])


def avg3(a):
    return (a[-1] + a[0] + a[1]) / 3.0


def diff(a):
    return a[1] - a[-1]


def seven(a):
    return a[0, 0, 0] + (a[-1, 0, 0] + a[1, 0, 0] + a[0, -1, 0]
                         + a[0, 1, 0] + a[0, 0, -1] + a[0, 0, 1]) / 6.0


def odd3(a):
    return a[-1, 0, 1] + a[1, -1, 0]


def ints(a):
    return a[-1, 0] + 2 * a[0, 1] - a[1, 1]


# name -> (body, array shapes, literal args, dtype)
CASES = {
    "star2": (star2, [(64, 48)], (), np.float64),
    "odd_shape": (star2, [(37, 53)], (), np.float64),
    "asymmetric": (shifted, [(40, 24)], (), np.float64),
    "corner": (diag, [(32, 32)], (), np.float64),
    "two_inputs": (mix, [(24, 40), (24, 40)], (), np.float64),
    "literal": (scaled, [(16, 32)], (0.5,), np.float64),
    "1d": (avg3, [(4096,)], (), np.float64),
    "1d_diff": (diff, [(2048,)], (), np.float64),
    "3d": (seven, [(16, 24, 12)], (), np.float64),
    "3d_odd": (odd3, [(9, 13, 7)], (), np.float64),
    "int64": (ints, [(33, 41)], (), np.int64),
    "float32": (star2, [(48, 64)], (), np.float32),
}


def _inputs(shapes, dtype, seed=0):
    rng = np.random.RandomState(seed)
    if np.dtype(dtype).kind == "i":
        return [rng.randint(-50, 50, size=s).astype(dtype) for s in shapes]
    return [rng.rand(*s).astype(dtype) for s in shapes]


def _run(m, body, xs, lits, iters=None):
    st = m.stencil(body)
    arrs = [m.fromarray(x) for x in xs]
    if iters is None:
        return np.asarray(m.sstencil(st, *arrs, *lits).asarray())
    return np.asarray(m.sstencil_iterate(st, arrs[0], iters,
                                         *arrs[1:], *lits).asarray())


def _close(got, want):
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if want.dtype.kind in "iu":
        np.testing.assert_array_equal(got, want)
    else:
        tol = 1e-6 if want.dtype == np.float32 else TOL
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("meshes", MESHES, indirect=True)
@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_stencil_matches(meshes, case, spy):
    body, shapes, lits, dtype = CASES[case]
    xs = _inputs(shapes, dtype)
    one = _run(rt, body, xs, lits)  # the one-shard mesh
    _set(meshes)
    got = _run(rt, body, xs, lits)
    assert spy["n"] == 1
    assert got.dtype == one.dtype
    assert got.tobytes() == one.tobytes()
    _close(got, _run(rtj, body, xs, lits))


@pytest.mark.parametrize("meshes", MESHES, indirect=True)
@pytest.mark.parametrize("case", ["star2", "odd_shape", "two_inputs", "1d",
                                  "3d_odd"])
def test_iterate_matches(meshes, case, spy):
    body, shapes, lits, dtype = CASES[case]
    xs = _inputs(shapes, dtype, seed=1)
    one = _run(rt, body, xs, lits, iters=4)
    _set(meshes)
    got = _run(rt, body, xs, lits, iters=4)
    assert spy["n"] == 1  # one node: all sweeps in one run
    assert got.tobytes() == one.tobytes()
    _close(got, _run(rtj, body, xs, lits, iters=4))
    # the same as chained sstencil calls
    y = rt.fromarray(xs[0])
    for _ in range(4):
        y = rt.sstencil(rt.stencil(body), y, *[rt.fromarray(x)
                                               for x in xs[1:]], *lits)
    assert y.asarray().tobytes() == got.tobytes()


@pytest.mark.parametrize("meshes", [(4,), (2, 2)], indirect=True)
def test_iterate_zero_and_promoting(meshes):
    _set(meshes)
    x = np.random.RandomState(21).rand(64, 64)
    st = rt.stencil(lambda a: a[0, 0] + a[1, 0])
    np.testing.assert_array_equal(
        rt.sstencil_iterate(st, rt.fromarray(x), 0).asarray(), x)

    def five(a):
        return a[0, 0] + 0.25 * (a[-1, 0] + a[1, 0] + a[0, -1] + a[0, 1])

    xi = np.arange(64 * 32, dtype=np.int32).reshape(64, 32)
    y = rt.fromarray(xi)
    for _ in range(2):
        y = rt.sstencil(rt.stencil(five), y)
    it = rt.sstencil_iterate(rt.stencil(five), rt.fromarray(xi), 2)
    assert it.dtype == y.dtype == np.float64
    assert it.asarray().tobytes() == y.asarray().tobytes()
    _close(it.asarray(), rtj.sstencil_iterate(rtj.stencil(five),
                                              rtj.fromarray(xi), 2).asarray())


ELIGIBLE = [
    ((-2, -2), (2, 2), (64, 64)), ((-1,), (1,), (4096,)),
    ((-1,), (1,), (64,)), ((-1, -1), (1, 1), (4, 4)),
    ((-3, 0), (0, 2), (40, 24)), ((-5, -5), (5, 5), (16, 16)),
    ((-1, 0, 0), (1, 0, 1), (9, 13, 7)), ((-2, -2), (2, 2), (37, 53)),
]


@pytest.mark.parametrize("meshes", MESHES, indirect=True)
@pytest.mark.parametrize("lo,hi,shape", ELIGIBLE)
def test_eligibility_matches(meshes, lo, hi, shape):
    _set(meshes)
    x = np.zeros(shape)
    assert pss.eligible(lo, hi, [torch.zeros(shape)]) == \
        rss.eligible(lo, hi, [jax.numpy.asarray(x)])


def test_one_shard_mesh_never_takes_the_sharded_path():
    assert not pss.eligible((-2, -2), (2, 2), [torch.zeros(64, 64)])


@pytest.mark.parametrize("meshes", MESHES, indirect=True)
@pytest.mark.parametrize("case", ["star2", "odd_shape", "two_inputs",
                                  "corner", "1d", "3d"])
def test_halo_bytes_counter_matches(meshes, case):
    body, shapes, lits, dtype = CASES[case]
    xs = _inputs(shapes, dtype)
    _set(meshes)
    r0 = rreg.counters["stencil.halo_bytes_est"]
    p0 = preg.counters["stencil.halo_bytes_est"]
    # a fresh body: ramba_tpu traces (and counts) it once
    _run(rtj, lambda *a: body(*a), xs, lits)
    _run(rt, body, xs, lits)
    want = rreg.counters["stencil.halo_bytes_est"] - r0
    got = preg.counters["stencil.halo_bytes_est"] - p0
    # ramba_tpu counts at every trace, and traces a new program twice
    # (its aval rule and its compile)
    assert 2 * got == want
    # sstencil_iterate exchanges the carry every sweep, the other slots
    # once
    _run(rt, body, xs, lits, iters=3)
    if len(xs) == 1:
        assert preg.counters["stencil.halo_bytes_est"] - p0 == 4 * got


@pytest.mark.parametrize("meshes", [(2, 2), (4, 2)], indirect=True)
def test_assembly_is_counted_per_shard(meshes):
    _set(meshes)
    x = np.random.RandomState(3).rand(64, 64)
    c0 = parallel.comm_stats["shard_assemble_count"]
    b0 = parallel.comm_stats["shard_assemble_bytes"]
    _run(rt, star2, [x], (), iters=3)
    k = pmesh.num_workers()
    assert parallel.comm_stats["shard_assemble_count"] - c0 == 3 * k
    assert parallel.comm_stats["shard_assemble_bytes"] - b0 == 3 * x.nbytes


@pytest.mark.parametrize("meshes", [(2, 2), (8,)], indirect=True)
@pytest.mark.parametrize("overlap", [True, False])
def test_overlap_on_and_off_agree(meshes, overlap, monkeypatch):
    # a block with an interior takes the interior/strip schedule; one too
    # thin for it (an (8, 16) array leaves 4 or 2 cells per shard along a
    # split dim, and star2 reads 2 each way) takes the kernel's wrapper
    x = np.random.RandomState(4).rand(*((64, 48) if overlap else (8, 16)))
    one = _run(rt, star2, [x], ())
    _set(meshes)
    used = {"overlap": 0, "wrapper": 0}
    real_ov, real_run = pss._overlapped_val, psk.run

    def ov(*a, **k):
        used["overlap"] += 1
        return real_ov(*a, **k)

    def wrapper(*a, **k):
        used["wrapper"] += 1
        return real_run(*a, **k)

    monkeypatch.setattr(pss, "_overlapped_val", ov)
    monkeypatch.setattr(psk, "run", wrapper)
    got = _run(rt, star2, [x], ())
    assert got.tobytes() == one.tobytes()
    k = pmesh.num_workers()
    # on the CPU: the interior/strip schedule, or the kernel's wrapper
    # (its plain version) once per shard
    assert used == ({"overlap": k, "wrapper": 0} if overlap
                    else {"overlap": 0, "wrapper": k})


@pytest.mark.parametrize("meshes", [(2, 2)], indirect=True)
def test_ineligible_body_takes_shifted_slices(meshes, monkeypatch):
    # an int64 body: the kernel does not take it, so no wrapper call
    _set(meshes)
    calls = {"n": 0}
    real = psk.run
    monkeypatch.setattr(psk, "run", lambda *a, **k: (
        calls.__setitem__("n", calls["n"] + 1), real(*a, **k))[1])
    xs = _inputs([(33, 41)], np.int64)
    got = _run(rt, ints, xs, ())
    assert calls["n"] == 0
    _close(got, _run(rtj, ints, xs, ()))
