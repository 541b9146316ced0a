"""Layout changes (``ramba_tpu_torch/parallel/reshard.py``) against
ramba_tpu's, x64 regime, on the CPU.

The counterparts of ``tests/test_reshard.py``'s schedule, execution,
rollback, view, spill, rewrite and governed-placement cases, on
one-process meshes of 2, 4 and 8 shards and 2x2 (ramba_tpu on the same
number of its virtual CPU devices, both meshes restored afterwards):

* ``plan_reshard`` gives the same stages and the same 31-bit hash as
  ramba_tpu's over a grid of shapes, dtypes, layout pairs and stage caps;
* round trips (row -> column -> replicated -> row) are byte-identical,
  every step's shards sit where ramba_tpu's reshard puts them, the
  ``reshard.*`` counters move and the ledger's transient bytes settle at
  0; a staged reshard runs exactly its plan's stages;
* a ``reshard:stage`` fault rolls back: the same bytes under the same
  layout, and the rerun completes;
* views are refused, a spilled array is restored and then staged, and a
  plan hash that disagrees with the group's raises ``PlanMismatch``;
* ``x + y`` over two layouts is aligned by the rewrite, counted once;
* ``memory.governed_device_put`` counts its bytes as transient until the
  tensor dies.
Across processes the same moves are held in
``tests/test_torch_distributed.py``.
"""

import gc

import numpy as np
import pytest
import torch

import jax
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from jax.sharding import Mesh as JMesh
from ramba_tpu.parallel import mesh as rmesh
from ramba_tpu.parallel import reshard as rreshard
from ramba_tpu.resilience import faults as rfaults
from ramba_tpu_torch import common
from ramba_tpu_torch.core import rewrite
from ramba_tpu_torch.observe import registry
from ramba_tpu_torch.parallel import mesh as pmesh
from ramba_tpu_torch.parallel import reshard as preshard
from ramba_tpu_torch.resilience import coherence, faults, memory, spill

MESHES = [(2,), (4,), (8,), (2, 2)]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    torch.set_num_threads(1)
    monkeypatch.delenv("RAMBA_HBM_BUDGET", raising=False)
    monkeypatch.delenv("RAMBA_RESHARD_STAGE_BYTES", raising=False)
    faults.configure(None)
    rfaults.configure(None)
    yield
    faults.reset()
    rfaults.reset()


@pytest.fixture
def meshes(request):
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
        yield names if len(names) > 1 else names[0]
    finally:
        rmesh.set_mesh(old_r)
        pmesh.set_mesh(old_p)


def _same_shards(got, want, what):
    """The port's array holds ramba_tpu's bytes, each shard at the index
    ramba_tpu's sharding gives the device at that position."""
    jv = want._value()
    jidx = jv.sharding.devices_indices_map(want.shape)
    jmesh = jv.sharding.mesh
    shape = tuple(got.shape)
    for s in got.addressable_shards:
        jw = jidx[jmesh.devices[s.position]]
        assert [sl.indices(n) for sl, n in zip(s.index, shape)] == \
            [sl.indices(n) for sl, n in zip(jw, shape)], (what, s.position)
    assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), what


# -- schedule construction ---------------------------------------------------


def test_plan_single_stage_when_under_budget():
    p = preshard.plan_reshard((8, 8), np.float32, (), (("d0",),),
                              max_stage_bytes=1 << 20)
    assert len(p.stages) == 1
    assert p.total_bytes == 8 * 8 * 4
    assert p.stages[0].nbytes == p.total_bytes
    assert p.peak_bound_bytes == 2 * p.total_bytes


def test_plan_staged_slab_math():
    shape, cap = (128, 64), 1 << 12
    p = preshard.plan_reshard(shape, np.float32, (("d0",),),
                              ((None, ("d1",))), max_stage_bytes=cap)
    assert len(p.stages) > 1
    assert p.axis == 0  # the longest dim
    assert p.stages[0].lo == 0
    assert p.stages[-1].hi == shape[0]
    for a, b in zip(p.stages, p.stages[1:]):
        assert a.hi == b.lo
    assert sum(s.nbytes for s in p.stages) == p.total_bytes
    assert all(s.nbytes <= cap for s in p.stages)
    assert p.peak_bound_bytes == 2 * p.total_bytes + max(
        s.nbytes for s in p.stages)


def test_plan_hash_is_31_bit_and_layout_sensitive():
    a = preshard.plan_reshard((64, 32), np.float32, (("d0",),),
                              ((None, ("d1",))))
    b = preshard.plan_reshard((64, 32), np.float32, (("d0",),),
                              ((None, ("d1",))))
    c = preshard.plan_reshard((64, 32), np.float32, (("d0",),), ())
    assert a.hash31() == b.hash31()
    assert a.hash31() != c.hash31()
    for p in (a, c):
        assert 0 <= p.hash31() < 2 ** 31


PLAN_SHAPES = [(8, 8), (128, 64), (64, 128), (1000,), (3, 5, 7), (256, 64)]
PLAN_DTYPES = ["float32", "float64", "int32", "bool"]
PLAN_SPECS = [((), (("d0",),)), ((("d0",),), (None, ("d1",))),
              (("d0",), ()), ((None, "d0"), ("d0", None)),
              ((("d0", "d1"),), (None, ("d0", "d1")))]
PLAN_CAPS = [None, 1 << 12, 1000]


@pytest.mark.parametrize("cap", PLAN_CAPS)
@pytest.mark.parametrize("specs", PLAN_SPECS)
@pytest.mark.parametrize("dtype", PLAN_DTYPES)
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_and_hash_equal_ramba_tpus(shape, dtype, specs, cap):
    src, dst = specs
    got = preshard.plan_reshard(shape, dtype, src, dst, max_stage_bytes=cap)
    want = rreshard.plan_reshard(shape, dtype, src, dst, max_stage_bytes=cap)
    assert got.describe() == want.describe()
    assert got.hash31() == want.hash31()
    assert got.peak_bound_bytes == want.peak_bound_bytes
    assert [(s.index, s.lo, s.hi, s.nbytes) for s in got.stages] == \
        [(s.index, s.lo, s.hi, s.nbytes) for s in want.stages]


@pytest.mark.parametrize("raw, want", [("1", 1 << 16), ("2m", 2 << 20),
                                       ("junk", None)])
def test_stage_bytes_env(monkeypatch, raw, want):
    monkeypatch.setenv("RAMBA_RESHARD_STAGE_BYTES", raw)
    assert preshard.default_stage_bytes() == rreshard.default_stage_bytes()
    if want is not None:
        assert preshard.default_stage_bytes() == want


# -- execution ---------------------------------------------------------------


@pytest.mark.parametrize("meshes", MESHES, indirect=True)
def test_roundtrip_byte_identical_with_counters(meshes):
    ax = meshes
    data = np.arange(64 * 32, dtype=np.float32).reshape(64, 32)
    a, b = rt.asarray(data), rtj.asarray(data)
    before = registry.get("reshard.completed")
    for spec in [(None, ax), (), (ax,)]:  # row -> column -> whole -> row
        rt.reshard(a, spec)
        rtj.reshard(b, spec)
        assert pmesh.canonical(a.sharding.spec) == pmesh.canonical(spec)
        _same_shards(a, b, f"reshard to {spec}")
    assert np.asarray(a).tobytes() == data.tobytes()
    assert registry.get("reshard.completed") == before + 3
    assert memory.ledger.transient_bytes == 0


@pytest.mark.parametrize("meshes", MESHES, indirect=True)
def test_staged_execution_bounded_and_identical(meshes):
    ax = meshes
    data = np.arange(256 * 64, dtype=np.float32).reshape(256, 64)
    a, b = rt.asarray(data), rtj.asarray(data)
    plan = preshard.plan_reshard(a.shape, a.dtype, (ax,), (None, ax),
                                 max_stage_bytes=1 << 12)
    assert len(plan.stages) > 1
    s0 = registry.get("reshard.stages")
    memory.ledger.peak_live_bytes = 0
    rt.reshard(a, (None, ax), max_stage_bytes=1 << 12)
    rtj.reshard(b, (None, ax), max_stage_bytes=1 << 12)
    _same_shards(a, b, "staged")
    assert registry.get("reshard.stages") - s0 == len(plan.stages)
    assert memory.ledger.transient_bytes == 0
    # the high-water mark saw the destination and a slab, never more
    # than the plan's bound above what was live
    assert memory.ledger.peak_live_bytes >= data.nbytes
    assert memory.ledger.peak_live_bytes <= \
        memory.ledger.live_bytes + plan.peak_bound_bytes


@pytest.mark.parametrize("meshes", MESHES, indirect=True)
def test_rollback_on_stage_fault_leaves_source_intact(meshes):
    ax = meshes
    data = np.arange(256 * 64, dtype=np.float32).reshape(256, 64)
    a = rt.asarray(data)
    np.asarray(a)
    layout = a.sharding
    faults.configure("reshard:stage:after=2")
    r0 = registry.get("reshard.rollbacks")
    with pytest.raises(preshard.ReshardError, match="sharding intact"):
        rt.reshard(a, (None, ax), max_stage_bytes=1 << 12)
    assert registry.get("reshard.rollbacks") == r0 + 1
    assert a.sharding == layout
    assert np.asarray(a).tobytes() == data.tobytes()
    faults.configure(None)
    rt.reshard(a, (None, ax), max_stage_bytes=1 << 12)
    assert np.asarray(a).tobytes() == data.tobytes()
    assert memory.ledger.transient_bytes == 0


def test_plan_fault_rolls_back_before_any_stage():
    faults.configure("reshard:plan:once")
    a = rt.asarray(np.arange(64.0).reshape(8, 8))
    s0 = registry.get("reshard.stages")
    with pytest.raises(preshard.ReshardError):
        rt.reshard(a, ("d0",))
    assert registry.get("reshard.stages") == s0


def test_views_are_rejected():
    a = rt.asarray(np.arange(64, dtype=np.float32).reshape(8, 8))
    v = a[2:6]
    with pytest.raises(ValueError, match="views"):
        rt.reshard(v, ())


@pytest.mark.parametrize("meshes", [(4,)], indirect=True)
def test_spilled_array_reshards_after_restore(meshes):
    ax = meshes
    data = np.arange(64 * 32, dtype=np.float32).reshape(64, 32)
    a = rt.asarray(data)
    np.asarray(a)
    memory.ledger.evict_until(memory.ledger.live_bytes or 1)
    assert isinstance(a._expr.value, spill.SpilledArray)
    rt.reshard(a, (None, ax))
    assert not isinstance(a._expr.value, spill.SpilledArray)
    assert np.asarray(a).tobytes() == data.tobytes()


def test_a_diverging_plan_raises_plan_mismatch(monkeypatch):
    monkeypatch.setattr(coherence, "engaged", lambda: True)
    monkeypatch.setattr(coherence, "agree",
                        lambda site, v, reduce="max": v ^ 1
                        if site == "reshard:plan" else v)
    p0 = registry.get("reshard.plan_mismatches")
    a = rt.asarray(np.arange(64.0).reshape(8, 8))
    with pytest.raises(preshard.PlanMismatch):
        rt.reshard(a, ("d0",), max_stage_bytes=1 << 20)
    assert registry.get("reshard.plan_mismatches") == p0 + 1


def test_a_tensor_gives_a_new_array():
    t = torch.arange(12.0).reshape(3, 4)
    out = rt.reshard(t, ())
    assert isinstance(out, rt.ndarray)
    assert np.asarray(out).tobytes() == t.numpy().tobytes()


# -- the rewrite that aligns layouts -----------------------------------------


@pytest.mark.parametrize("meshes", MESHES, indirect=True)
def test_rewrite_aligns_disagreeing_operand_layouts(meshes):
    ax = meshes
    da = np.arange(64 * 32, dtype=np.float32).reshape(64, 32)
    db = np.linspace(0.0, 1.0, 64 * 32, dtype=np.float32).reshape(64, 32)
    outs = []
    for pkg, stats in ((rt, rewrite.stats),
                       (rtj, __import__("ramba_tpu.core.rewrite",
                                        fromlist=["stats"]).stats)):
        a, b = pkg.asarray(da), pkg.asarray(db)
        pkg.reshard(b, (None, ax))  # now a and b disagree on layout
        n0 = stats.get("rewrite_align_operand_layouts", 0)
        outs.append(np.asarray(a + b))
        assert stats.get("rewrite_align_operand_layouts", 0) == n0 + 1
    assert outs[0].tobytes() == outs[1].tobytes() == (da + db).tobytes()


@pytest.mark.parametrize("meshes", [(2, 2)], indirect=True)
def test_rewrite_aligns_the_leaves_under_an_elementwise_operand(meshes):
    # sum(2.5 * x + y): x and y meet under the sum's operand, not as one
    # map's operands; the rule aligns them once, toward the earlier leaf
    ax = meshes
    dx = np.arange(32 * 16, dtype=np.float64).reshape(32, 16)
    x = rt.fromarray(dx, distribution=(4, 1))
    y = rt.fromarray(dx[::-1].copy(), distribution=(1, 4))
    n0 = rewrite.stats["rewrite_align_operand_layouts"]
    z = 2.5 * x + y
    np.testing.assert_array_equal(np.asarray(z), 2.5 * dx + dx[::-1])
    assert rewrite.stats["rewrite_align_operand_layouts"] == n0 + 1
    assert pmesh.canonical(z.sharding.spec) == (ax,)


# -- governed device_put -----------------------------------------------------


def test_governed_device_put_accounts_transient_bytes():
    data = np.arange(1024, dtype=np.float32)
    g0 = registry.get("memory.governed_puts")
    out = memory.governed_device_put(data, site="test")
    assert np.asarray(out).tobytes() == data.tobytes()
    assert registry.get("memory.governed_puts") == g0 + 1
    assert memory.ledger.transient_bytes >= data.nbytes
    del out
    gc.collect()
    assert memory.ledger.transient_bytes == 0
    assert "transient_bytes" in memory.ledger.snapshot()


# -- what the packages bind --------------------------------------------------


@pytest.mark.parametrize("pkg, names", [
    ("ramba_tpu_torch.parallel", ("shardview", "reshard")),
    ("ramba_tpu_torch.resilience", ("memory", "spill")),
])
def test_subpackages_bind_their_modules(pkg, names):
    # in a fresh process: importing the subpackage alone binds them (no
    # other import has loaded them first), as ramba_tpu's do
    import subprocess
    import sys
    from pathlib import Path

    code = (f"import sys; sys.path.insert(0, sys.argv[1]); import {pkg} as p;"
            f" print([type(getattr(p, n)).__name__ for n in {names!r}])")
    out = subprocess.run(
        [sys.executable, "-c", code, str(Path(__file__).resolve().parents[1])],
        capture_output=True, text=True, timeout=120,
        env={**__import__("os").environ, "RAMBA_TORCH_DEVICE": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == repr(["module"] * len(names))


def test_the_layout_names_are_ported():
    missing = set(dir(rtj)) - set(dir(rt))
    assert not {"reshard", "create_array_with_divisions"} & missing
