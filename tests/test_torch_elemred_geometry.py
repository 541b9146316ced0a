"""elemred's launch geometry, schedule, load path, rounding depth and
generated source, on the CPU.

The CUDA kernel (``csrc/elemred.cuh``) runs only on the card; everything
about its launch but the occupancy is decided in ``ops/elemred.py``, which
mirrors the kernel's order.  These tests hold the mirror to what the kernel
needs:

* every element of [0, n) is computed exactly once by one (CTA, tile,
  thread, position), for ragged n and several grids, whatever the leaf's
  alignment; on the bulk path a tile's bulk copy moves whole 16-byte runs
  from 16-byte aligned sources and plain loads cover the rest below n;
* ``depth(n, grid)`` equals the longest chain of roundings of a Python
  simulation of the kernel's reduction order, and stays at most 3936
  (four times the Triton kernel's 984) at n = 1e9 on an H100;
* alignment picks the path; mixed dtypes share one group width and one
  number of elements per thread;
* the generated source: one ``sincos`` for sin and cos of one operand, two
  calls for two operands, the NaN-propagating min/max combine.
"""

import os

import numpy as np
import pytest
import torch

import ramba_tpu_torch as rt
from ramba_tpu_torch import _build, common
from ramba_tpu_torch.core import fuser
from ramba_tpu_torch.ops import elemred as er

NS = [1, 15, 16, 17, 1023, (1 << 16) + 37, 10 ** 6 + 3]
GRIDS = [1, 132, 264, 528]


@pytest.fixture(autouse=True)
def _port_on_cpu():
    common.set_device("cpu")


def _program(build, **arrays):
    port = {k: rt.fromarray(v) for k, v in arrays.items()}
    roots = build(port)
    return fuser.prepare_program([a.read_expr() for a in roots])


@pytest.mark.parametrize("misalign", [0, 4, 8])
@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("n", NS)
def test_schedule_covers_every_element_once(n, grid, misalign):
    itemsize = 4 if misalign == 4 else 8  # a float32 leaf may sit 4 bytes in
    vec = er.vec_width([itemsize])
    ept = max(er.CONFIG.ept, vec)
    base = 4096 + misalign
    path = er.load_path([base])
    assert path == ("bulk" if misalign == 0 else "plain")
    tiles = er.n_tiles(n, ept)
    grid = er.schedule(n, ept, grid)
    assert 1 <= grid <= tiles
    seen = np.zeros(n, np.int64)
    for b in range(grid):
        for tile in er.tile_range(b, grid, tiles):
            el = er.tile_elements(tile, ept, vec)
            assert el.shape == (er.NT, ept)
            # a thread's group is vec consecutive elements, aligned to vec
            assert (el[:, ::vec] % vec == 0).all()
            assert (np.diff(el.reshape(er.NT, ept // vec, vec), axis=2) == 1).all()
            ok = el[el < n]
            np.add.at(seen, ok, 1)
            if path == "bulk":
                t0 = tile * er.NT * ept
                count = n - t0
                moved = er.bulk_elements(count, ept, itemsize)
                assert (moved * itemsize) % 16 == 0
                assert (base + t0 * itemsize) % 16 == 0
                rest = min(count, er.NT * ept) - moved
                assert 0 <= rest < 16 // itemsize
                assert rest == 0 or tile == tiles - 1  # only the last tile
    assert (seen == 1).all()


def _simulated_depth(n, grid, ept):
    """The kernel's reduction order, with each value's longest chain of
    roundings: combine(a, b) has max(depth a, depth b) + 1."""
    tiles = er.n_tiles(n, ept)
    grid = er.schedule(n, ept, grid)
    partials = []
    for b in range(grid):
        k = len(er.tile_range(b, grid, tiles))
        acc = np.full((er.NT, ept), k)  # identity + one element per tile
        s = ept // 2
        while s:
            acc[:, :s] = np.maximum(acc[:, :s], acc[:, s:2 * s]) + 1
            s //= 2
        partials.append(_block_tree(acc[:, 0]))
    v = np.zeros(er.NT, np.int64)
    for b, d in enumerate(partials):
        t = b % er.NT
        v[t] = max(v[t], d) + 1
    return _block_tree(v)


def _block_tree(v):
    """The CTA's tree: shuffles down by 16 .. 1 in each warp, then warp 0
    over the warps' values (lanes past them hold the identity)."""
    v = np.asarray(v, np.int64).reshape(-1, 32).copy()
    off = 16
    while off:
        src = np.concatenate([v[:, off:], v[:, -off:]], axis=1)  # out of range: own
        src[:, 32 - off:] = v[:, 32 - off:]
        v = np.maximum(v, src) + 1
        off //= 2
    w = np.zeros(32, np.int64)
    w[:v.shape[0]] = v[:, 0]
    off = v.shape[0] // 2
    while off:
        src = np.concatenate([w[off:], w[-off:]])
        src[32 - off:] = w[32 - off:]
        w = np.maximum(w, src) + 1
        off //= 2
    return int(w[0])


@pytest.mark.parametrize("n,grid,ept", [(1, 1, 8), (2049, 1, 8), (5000, 3, 8),
                                        (70001, 7, 4), (10 ** 5, 132, 8),
                                        (10 ** 6 + 3, 264, 16),
                                        (3 << 20, 528, 8)])
def test_depth_is_the_longest_rounding_chain(n, grid, ept):
    assert er.depth(n, grid, ept) == _simulated_depth(n, grid, ept)


def test_depth_at_1e9_on_an_h100():
    p, lv = _program(lambda a: (lambda D: [D, rt.sum(D)])(
        rt.sin(a["b"]) * rt.sin(a["b"]) + rt.cos(a["b"]) * rt.cos(a["b"])),
        b=np.arange(64.0))
    plan = er.plan_for(p, lv)
    grid = er.H100_SMS * plan.config.min_ctas  # the fewest CTAs it runs on
    assert er.depth(10 ** 9) == er.depth(10 ** 9, grid, plan.ept)
    assert er.depth(10 ** 9) <= 3936  # 4x the Triton kernel's 984
    assert er.depth(10 ** 9, er.H100_SMS, plan.ept) <= 3936  # one CTA per SM


def test_alignment_picks_the_path():
    assert er.load_path([0, 16, 4096]) == "bulk"
    assert er.load_path([0, 8]) == "plain"
    assert er.load_path([4]) == "plain"
    assert er.load_path([1]) == "plain"
    assert er.load_path([0], ring_fits=False) == "plain"
    x = torch.arange(33, dtype=torch.float64)
    assert er.load_path([x.data_ptr()]) == "bulk"  # torch allocates on 64 B
    assert er.load_path([x[1:].data_ptr()]) == "plain"


def test_mixed_dtypes_share_one_group_width():
    """A program over bool, int32 and float64 leaves: one group of two
    elements (16 bytes of float64) and one number of elements per thread
    for every operand; each operand's group is one aligned access."""
    rs = np.random.RandomState(0)
    p, lv = _program(
        lambda a: (lambda c: [c, rt.sum(c), rt.max(a["i"])])(
            rt.where(a["m"], a["i"] * 2, a["x"])),
        m=rs.rand(100) > 0.5, i=rs.randint(-9, 9, 100).astype(np.int32),
        x=rs.rand(100))
    plan = er.plan_for(p, lv)
    assert plan.vec == 2 and plan.ept == er.CONFIG.ept
    for ct in ("bool", "int", "double"):
        assert f"Vec<{ct}, V>" in plan.source
    for s in plan.vec_leaves + plan.vec_out:
        nbytes = plan.vec * plan.avals[s].dtype.itemsize
        assert nbytes <= 16 and 16 % nbytes == 0
    f32 = er.plan_for(*_program(lambda a: [a["y"] * 2.0],
                                y=rs.rand(100).astype(np.float32)))
    assert f32.vec == 4
    bools = er.plan_for(*_program(lambda a: [rt.logical_not(a["m"])],
                                  m=rs.rand(100) > 0.5))
    assert bools.vec == 16 and bools.ept == 16  # at least one group


def test_ring_shrinks_to_fit():
    """Many wide leaves: fewer stages, then fewer elements per thread, until
    the ring fits a block's shared memory."""
    cfg, vec = er.config_for([8] * 20, [8])
    assert vec == 2
    assert er.smem_bytes([8] * 20, cfg.ept, cfg.stages) <= er.SMEM_LIMIT
    assert cfg.stages < er.CONFIG.stages or cfg.ept < er.CONFIG.ept
    cfg1, _ = er.config_for([8], [8])
    assert (cfg1.ept, cfg1.stages) == (er.CONFIG.ept, er.CONFIG.stages)


def test_source_fuses_sin_and_cos_of_one_operand():
    rs = np.random.RandomState(1)
    one = er.plan_for(*_program(
        lambda a: [rt.sin(a["x"]) * rt.sin(a["x"]) + rt.cos(a["x"])], x=rs.rand(64)))
    # the k-th sin of an operand pairs with its k-th cos: a program that
    # spells sin twice keeps one of them apart
    assert one.source.count("sincos(") == 1
    assert one.source.replace("sincos(", "").count("sin(") == 1
    four = er.plan_for(*_program(
        lambda a: [rt.sin(a["x"]) * rt.sin(a["x"]) + rt.cos(a["x"]) * rt.cos(a["x"])],
        x=rs.rand(64)))
    assert four.source.count("sincos(") == 2
    main = er.plan_for(*_program(
        lambda a: (lambda B, C: [B * B + C * C])(rt.sin(a["x"]), rt.cos(a["x"])),
        x=rs.rand(64)))
    assert main.source.count("sincos(") == 1
    assert "sin(" not in main.source.replace("sincos(", "")
    two = er.plan_for(*_program(
        lambda a: [rt.sin(a["x"]) + rt.cos(a["y"])], x=rs.rand(64), y=rs.rand(64)))
    assert "sincos" not in two.source
    assert two.source.count("sin(") == 1 and two.source.count("cos(") == 1
    f32 = er.plan_for(*_program(
        lambda a: [rt.sin(a["x"]) - rt.cos(a["x"])], x=rs.rand(64).astype(np.float32)))
    assert f32.source.count("sincosf(") == 1
    p, lv = _program(lambda a: [rt.sin(a["x"]) + rt.cos(a["x"])], x=rs.rand(64))
    off = er.plan_for(p, lv, er.CONFIG._replace(sincos=False))
    assert "sincos" not in off.source and off.name != er.plan_for(p, lv).name


def test_source_min_max_propagate_nan():
    rs = np.random.RandomState(2)
    plan = er.plan_for(*_program(lambda a: [rt.min(a["x"] * 2.0),
                                            rt.max(a["x"] - 1.0)], x=rs.rand(64)))
    assert "OpMin::comb" in plan.source and "OpMax::comb" in plan.source
    assert "((double)(INFINITY))" in plan.source  # min's identity
    assert "((double)(-INFINITY))" in plan.source
    header = open(os.path.join(_build.CSRC_DIR, "elemred.cuh")).read()
    assert "return nan_min(a, b);" in header and "return nan_max(a, b);" in header
    ufunc = open(os.path.join(_build.CSRC_DIR, "ufunc.cuh")).read()
    assert "(a != a) ? a : ((b != b) ? b : (a < b ? a : b))" in ufunc


def test_scalar_leaves_are_passed_by_value():
    """A host scalar (a python or numpy value, or a 0-d CPU tensor) is a
    kernel argument of type double or long long; only a 0-d CUDA tensor
    would be passed by pointer and read on the card."""
    rs = np.random.RandomState(3)
    p, lv = _program(lambda a: [a["x"] * 3 + np.float32(0.5)], x=rs.rand(64))
    plan = er.plan_for(p, lv)
    assert plan.kinds == ["vec", "host", "host"]
    assert "long long s1;" in plan.source and "double s2;" in plan.source
    assert er._leaf_kind(torch.tensor(3)) == "host"
    assert er._leaf_kind(torch.zeros(4)) == "vec"
