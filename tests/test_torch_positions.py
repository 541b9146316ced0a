"""A rank holding several positions of a mesh of ranks
(``parallel/mesh.py``, ``core/rankflush.py``), on the CPU.

Four gloo worlds run the same programs over one (2, 2) mesh
(``tests/torch_dist_worker.py``, mode ``positions``): one rank holding all
four positions, two ranks holding a row each (``[[0, 0], [1, 1]]``), two
ranks on the checkerboard (``[[0, 1], [1, 0]]``) and four ranks, one
position each.  The programs: star2 chained and iterated on an even and
an uneven grid; the nan-reductions, var/std (ddof 0 and 1),
argmin/argmax (with NaNs) whole and along each axis, complex sum, prod
and mean; groupby of 1-D data (sum, mean, var, std, count, the nan
kinds; the series' mean is 1e8) and of 2-D data along either dim;
``scumulative`` along either axis; spmd ``halo(1)``; a reshard there and
back; a checkpoint saved by the checkerboard world, resumed by four ranks
and saved again, then resumed by one rank.

Held:

* every result has the same bytes in all four worlds: every fold runs
  over the positions in grid order, whichever rank holds them;
* no program takes the gathered lowering (``fuser.stats["gathered"]`` is
  0), and the folds' all-gathered bytes stay below what gathering the
  operands would move;
* the results equal ``ramba_tpu`` on a one-device mesh: integers and
  indices exactly, floats within rtol 1e-12 (float sums fold in another
  order); stencils, spmd and the reshard exactly against the port in one
  process and NumPy; where ``ramba_tpu`` is wrong (groupby var/std: C.16,
  C.17) against NumPy within rtol 1e-12 (the series' var is about 1, its
  mean 1e8: the centred pass keeps the digits, a relative error of a few
  n eps).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import ramba_tpu as rtj
from jax.sharding import Mesh as JMesh
from ramba_tpu.parallel import mesh as rmesh
from ramba_tpu_torch import common

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dist_worker as worker  # noqa: E402

WORKER = str(Path(__file__).resolve().parent / "torch_dist_worker.py")
LIMIT_S = 300
WORLDS = {"one": (1, "0,0,0,0"), "rows": (2, "0,0,1,1"),
          "checker": (2, "0,1,1,0"), "four": (4, "0,1,2,3")}


def _x64():
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")


@pytest.fixture(autouse=True)
def _port_on_cpu():
    _x64()
    common.set_device("cpu")


def _start(world, ranks, tmp, env=None):
    outdir = tmp / "out"
    outdir.mkdir()
    full_env = dict(os.environ, RAMBA_TORCH_DEVICE="cpu",
                    RAMBA_INIT_TIMEOUT_S="60", OMP_NUM_THREADS="1",
                    GLOO_SOCKET_IFNAME="lo", RAMBA_POSITIONS_RANKS=ranks)
    full_env.pop("RAMBA_FAULTS", None)
    full_env.update(env or {})
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), str(tmp / "store"),
         str(outdir), "positions"], env=full_env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    return procs, outdir


def _wait(procs, outdir, world):
    logs, rcs = [], []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=LIMIT_S)
            logs.append(out)
            rcs.append(p.returncode)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert rcs == [0] * world, "\n".join(logs)
    return ([dict(np.load(outdir / f"rank{r}.npz")) for r in range(world)],
            [json.loads((outdir / f"rank{r}.json").read_text())
             for r in range(world)])


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world's results (rank 0's, after checking that all ranks of
    a world agree), the four worlds started at once."""
    _x64()
    started = {}
    for name, (world, ranks) in WORLDS.items():
        tmp = tmp_path_factory.mktemp(name)
        started[name] = (_start(world, ranks, tmp), world)
    out = {}
    for name, ((procs, outdir), world) in started.items():
        res, info = _wait(procs, outdir, world)
        for r in range(1, world):
            assert sorted(res[r]) == sorted(res[0])
            for k in res[0]:
                assert res[r][k].tobytes() == res[0][k].tobytes(), (name, k)
        out[name] = (res[0], info[0])
    return out


def test_every_world_gives_the_same_bytes(worlds):
    base, _info = worlds["four"]
    assert len(base) == 73
    for name in ("one", "rows", "checker"):
        res, _ = worlds[name]
        assert sorted(res) == sorted(base), name
        bad = [k for k in base if res[k].dtype != base[k].dtype
               or res[k].tobytes() != base[k].tobytes()]
        assert not bad, (name, bad)


def test_no_program_is_gathered(worlds):
    grid_bytes = np.prod(worker.POSITIONS_GRID) * 8
    for name, (_res, info) in worlds.items():
        assert all(v == 0 for v in info["gathered"].values()), \
            (name, info["gathered"])
        # 43 results read back (a gather of each that is a block
        # leaf) and the partials of 43 folds: far below the 43 grids a
        # gathered lowering would move to every rank
        assert info["allgather_bytes"]["folds"] < 30 * grid_bytes, name


def test_positions_and_blocks(worlds):
    _res, info = worlds["checker"]
    assert info["held"] == [[0, 0], [1, 1]]
    assert [b[0] for b in info["blocks"]] == [[0, 0], [1, 1]]
    assert info["blocks"][1][1] == [[12, 23], [10, 19]]
    _res, info = worlds["one"]
    assert info["held"] == [[0, 0], [0, 1], [1, 0], [1, 1]]


def _close(got, want, key, rtol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (key, got.dtype, want.dtype)
    assert got.shape == want.shape, key
    if got.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=key)
        return
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                  err_msg=key)
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=1e-300,
                               err_msg=key)


@pytest.fixture(scope="module")
def reference():
    """ramba_tpu's results of the folds, groupby and scans on a one-device
    mesh."""
    _x64()
    prev = rmesh.get_mesh()
    rmesh.set_mesh(JMesh(np.array(jax.devices()[:1]), ("d0",)))
    try:
        progs = worker.positions_programs(rtj)
        return {f"{name}/{k}": np.asarray(v)
                for name in ("folds", "groupby", "scans")
                for k, v in progs[name]().items()}
    finally:
        rmesh.set_mesh(prev)


def test_folds_match_ramba_tpu(worlds, reference):
    res, _ = worlds["checker"]
    keys = [k for k in reference if k.startswith("folds/")]
    assert len(keys) == 43
    for k in keys:
        _close(res[k], reference[k], k)


def test_groupby_matches_ramba_tpu_and_numpy(worlds, reference):
    res, _ = worlds["rows"]
    grid, grid_nan, series, series_nan, labels, rows, _c = \
        worker.positions_inputs()
    G = worker.POSITIONS_G
    for k in reference:
        if not k.startswith("groupby/"):
            continue
        kind = k.split("_", 1)[1]
        if kind.replace("nan", "") in ("var", "std"):
            continue  # ramba_tpu cancels its digits here (C.17)
        _close(res[k], reference[k], k)

    def per_group(x, lab, n, fn, axis=0):
        xm = np.moveaxis(x, axis, 0)
        return np.moveaxis(np.stack([fn(xm[lab == g], axis=0)
                                     for g in range(n)]), 0, axis)

    _close(res["groupby/s_var"], per_group(series, labels, G, np.var),
           "s_var")
    _close(res["groupby/s_std"], per_group(series, labels, G, np.std),
           "s_std")
    _close(res["groupby/n_nanvar"], per_group(series_nan, labels, G,
                                              np.nanvar), "n_nanvar")
    _close(res["groupby/n_nanstd"], per_group(series_nan, labels, G,
                                              np.nanstd), "n_nanstd")
    _close(res["groupby/g0_var"], per_group(grid, rows, G, np.var), "g0")
    _close(res["groupby/g1_var"], per_group(grid, rows[:grid.shape[1]] % 3,
                                            3, np.var, axis=1), "g1")
    with np.errstate(all="ignore"):
        want = per_group(grid_nan, rows, G, np.nanvar)
    _close(res["groupby/gn_nanvar"], want, "gn_nanvar")


def test_scans_match_ramba_tpu(worlds, reference):
    res, _ = worlds["one"]
    for k in ("scans/scum0", "scans/scum1"):
        _close(res[k], reference[k], k)


def test_stencils_spmd_and_reshard_match_one_process(worlds):
    import ramba_tpu_torch as rt

    res, _ = worlds["checker"]
    grid = worker.positions_inputs()[0]
    st = rt.stencil(worker.star2_body)
    for name, shape in (("even", (24, 20)), ("odd", worker.POSITIONS_GRID)):
        x = np.resize(grid, shape)
        y = rt.fromarray(x)
        for _ in range(3):
            y = rt.sstencil(st, y)
        assert res[f"stencils/{name}_chained"].tobytes() == \
            y.asarray().tobytes()
        it = rt.sstencil_iterate(st, rt.fromarray(x), 4).asarray()
        assert res[f"stencils/{name}_iterate"].tobytes() == it.tobytes()
    h = np.pad(grid, 1)
    want = h[1:-1, 2:] + h[1:-1, :-2] + h[2:, 1:-1] + h[:-2, 1:-1]
    assert res["spmd/halo1"].tobytes() == want.tobytes()
    assert res["reshard/mid"].tobytes() == grid.tobytes()
    assert res["reshard/back"].tobytes() == grid.tobytes()


def test_checkpoint_saved_by_two_ranks_resumes_in_four_then_one(
        tmp_path):
    root = str(tmp_path / "ck")
    grid, _gn, series, *_r = worker.positions_inputs()
    steps = (("save", "checker"), ("resume", "four"), ("resume", "one"))
    for i, (case, name) in enumerate(steps):
        world, ranks = WORLDS[name]
        d = tmp_path / f"step{i}"
        d.mkdir()
        procs, outdir = _start(world, ranks, d, env={
            "RAMBA_POSITIONS_CASE": case, "RAMBA_POSITIONS_ROOT": root})
        res, info = _wait(procs, outdir, world)
        if case == "resume":
            assert info[0]["step"] == i
            assert info[0]["from_processes"] == (2 if i == 1 else 4)
            assert res[0]["grid"].tobytes() == grid.tobytes()
            assert res[0]["series"].tobytes() == series.tobytes()
            _close(res[0]["sum"], np.sum(grid * 3.0), "sum")
