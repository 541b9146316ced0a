"""Medians, quantiles and the last folds across ranks
(``core/rankselect.py``, ``core/rankflush.py``), on the CPU.

Four gloo worlds run the same programs over one (2, 2) mesh
(``tests/torch_dist_worker.py``, mode ``select``): one rank holding all
four positions, two ranks holding a row each, two ranks on the
checkerboard and four ranks.  The programs: ``median``, ``nanmedian``,
``quantile``, ``nanquantile``, ``percentile`` and ``nanpercentile`` (all
five methods) whole and along each axis, on a 23x19 float64 grid with
NaNs and an all-NaN row, on the grid in int8, uint8-uint64 (uint64 near
its top), int64 (near both limits), float16, float32 and bool, and on
signed zeros around the middle; the same along an axis that the layout
leaves whole (each block reduces its own slices, no round);
``nanvar``/``nanstd`` (ddof 0 and 1),
``count_nonzero`` and ``ptp``; complex ``min``/``max``/``ptp``/``var``/
``std`` with NaN parts and ties; empty extents; a ``shard_hint`` over a
computed value of another layout.

Held:

* every result has the same bytes on every rank and in all four worlds;
* no program takes the gathered lowering; the selections' all-gathered
  bytes stay under :func:`_bound` (rounds x slices x positions, never the
  values), and a hint over a subtree that is not shard-local still
  gathers, counted;
* the selections, integer results and complex extremes equal the port in
  one process bit for bit (sign bits compared, NaN positions compared);
  the float folds are within rtol 1e-12 (float64) or 16 n eps (float32:
  Chan's fold in grid order against one two-pass sum);
* the results agree with ``ramba_tpu`` on a one-device mesh: selections
  and integers exactly (linear and midpoint interpolation, and the
  medians' midpoint, within 2 ulp of the largest value: XLA fuses the
  products and sums), nanvar/nanstd within rtol 1e-12;
* a selection runs at most the key width + 2 rounds (33 for float64),
  the same on every rank, and its all-gathered bytes do not grow with
  the operand (two sizes);
* a rank stalled inside a selection's rounds, under the watchdog, makes
  every rank raise (``RankStallError``/``GroupBrokenError``) within the
  deadline's reach.
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
GROUPS = ("medians", "quantiles", "dtypes", "folds", "complex", "local")


def _x64():
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")


@pytest.fixture(autouse=True)
def _port_on_cpu():
    _x64()
    common.set_device("cpu")


def _start(world, ranks, tmp, case="main", env=None):
    outdir = tmp / "out"
    outdir.mkdir()
    full_env = dict(os.environ, RAMBA_TORCH_DEVICE="cpu",
                    RAMBA_INIT_TIMEOUT_S="60", OMP_NUM_THREADS="1",
                    GLOO_SOCKET_IFNAME="lo", RAMBA_POSITIONS_RANKS=ranks,
                    RAMBA_SELECT_CASE=case)
    full_env.pop("RAMBA_FAULTS", None)
    full_env.pop("RAMBA_WATCHDOG_S", None)
    full_env.update(env or {})
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), str(tmp / "store"),
         str(outdir), "select"], env=full_env, stdout=subprocess.PIPE,
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


def _reference(rt_pkg):
    return {f"{name}/{k}": np.asarray(v)
            for name, fn in worker.select_programs(rt_pkg).items()
            for k, v in fn().items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world's results (rank 0's, after checking that all ranks of
    a world agree byte for byte) and the two-size case's, all started at
    once; while they run, the port's results in one process and
    ``ramba_tpu``'s on a one-device mesh."""
    _x64()
    import ramba_tpu_torch as rt

    started = {}
    for name, (world, ranks) in WORLDS.items():
        tmp = tmp_path_factory.mktemp(name)
        started[name] = (_start(world, ranks, tmp), world)
    sizes = _start(*WORLDS["rows"], tmp_path_factory.mktemp("sizes"),
                   case="sizes")
    common.set_device("cpu")
    one = _reference(rt)
    prev = rmesh.get_mesh()
    rmesh.set_mesh(JMesh(np.array(jax.devices()[:1]), ("d0",)))
    try:
        ref = _reference(rtj)
    finally:
        rmesh.set_mesh(prev)
    out = {}
    for name, ((procs, outdir), world) in started.items():
        res, info = _wait(procs, outdir, world)
        for r in range(1, world):
            assert sorted(res[r]) == sorted(res[0])
            for k in res[0]:
                assert res[r][k].tobytes() == res[0][k].tobytes(), (name, k)
            assert info[r]["rounds"] == info[0]["rounds"], name
        out[name] = (res[0], info[0])
    return {"worlds": out, "one": one, "ref": ref,
            "sizes": _wait(*sizes, WORLDS["rows"][0])[1]}


@pytest.fixture(scope="module")
def worlds(runs):
    return runs["worlds"]


@pytest.fixture(scope="module")
def one_process(runs):
    """The port's results in one process (no mesh of ranks)."""
    return runs["one"]


@pytest.fixture(scope="module")
def reference(runs):
    """ramba_tpu's results on a one-device mesh."""
    return runs["ref"]


def _same_bits(got, want, key):
    """The same dtype and shape, NaN in the same places, every other
    value bit for bit (a zero's sign included)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (key, got.dtype, want.dtype)
    assert got.shape == want.shape, (key, got.shape, want.shape)
    if got.dtype.kind in "fc":
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan, err_msg=key)
        got, want = got[~nan], want[~nan]
    assert got.tobytes() == want.tobytes(), (key, got, want)


def _close(got, want, key, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (key, got.dtype, want.dtype)
    assert got.shape == want.shape, key
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=key)
    np.testing.assert_allclose(got[~nan], want[~nan], rtol=rtol, atol=0,
                               err_msg=key)


def _is_fold(key):
    """A float fold (Chan's fold in grid order, not one process's
    two-pass sum): nanvar/nanstd, complex var/std."""
    return any(f"_{fn}_" in key for fn in ("nanvar", "nanstd", "var", "std"))


def test_every_world_gives_the_same_bytes(worlds):
    base, _info = worlds["four"]
    assert len(base) == 255
    for name in ("one", "rows", "checker"):
        res, _ = worlds[name]
        assert sorted(res) == sorted(base), name
        bad = [k for k in base if res[k].dtype != base[k].dtype
               or res[k].tobytes() != base[k].tobytes()]
        assert not bad, (name, bad)


def test_no_program_is_gathered(worlds):
    for name, (_res, info) in worlds.items():
        assert all(v == 0 for v in info["gathered"].values()), \
            (name, info["gathered"])
        assert info["hint_gathered"] == 0, name
        # a subtree that is not shard-local keeps its hint, counted
        assert info["hint_not_local_gathered"] == 1, name


@pytest.mark.parametrize("group", GROUPS)
def test_results_equal_the_port_in_one_process(worlds, one_process, group):
    res, _ = worlds["checker"]
    keys = [k for k in one_process if k.startswith(group + "/")]
    assert keys
    for k in keys:
        if _is_fold(k):
            f32 = res[k].dtype == np.float32
            # float32: 16 n eps32 (n = 437 values folded in another order)
            _close(res[k], one_process[k], k,
                   16 * 437 * 2.0 ** -23 if f32 else 1e-12)
        else:
            _same_bits(res[k], one_process[k], k)


def _ulp_bound(want, k):
    """``k`` ulp of the largest finite magnitude of ``want``."""
    w = np.asarray(want)
    fin = np.abs(w[np.isfinite(w)]) if w.size else np.zeros(0)
    top = fin.max() if fin.size else 0.0
    return k * np.spacing(np.asarray(top, dtype=w.dtype)).astype(np.float64)


@pytest.mark.parametrize("group", GROUPS)
def test_results_agree_with_ramba_tpu(worlds, reference, group):
    res, _ = worlds["rows"]
    keys = [k for k in reference if k.startswith(group + "/")]
    assert keys
    for k in keys:
        got, want = res[k], reference[k]
        if _is_fold(k):
            f32 = got.dtype == np.float32
            _close(got, want, k, 16 * 437 * 2.0 ** -23 if f32 else 1e-12)
            continue
        interpolates = "median" in k or (
            ("quantile" in k or "percentile" in k) and not any(
                m in k for m in ("lower", "higher", "nearest")))
        if got.dtype.kind == "f" and interpolates:
            assert got.dtype == want.dtype and got.shape == want.shape, k
            nan = np.isnan(want)
            np.testing.assert_array_equal(np.isnan(got), nan, err_msg=k)
            err = np.abs(got[~nan].astype(np.float64)
                         - want[~nan].astype(np.float64))
            assert err.size == 0 or err.max() <= _ulp_bound(want, 2), k
        else:
            _same_bits(got, want, k)


def _bound(world, slices, positions, owners_per_slice=2):
    """All-gathered bytes a selection may move (the stated bound): at most
    66 rounds of int32 counts, each all-gather padding every rank to the
    widest; a round carries a flag, then per slice and owner position the
    census's 4 counts, or per position the value search's ARITY - 1 = 3
    counts and a zero's search's 2 (A - 1) <= 6.  It does not grow with
    the values."""
    per_round = 1 + max(4, 9 * positions) * slices * owners_per_slice
    return 66 * world * 4 * per_round


def test_allgathered_bytes_stay_under_the_bound(worlds):
    grid_bytes = np.prod(worker.POSITIONS_GRID) * 8
    for name, (_res, info) in worlds.items():
        world = WORLDS[name][0]
        ag = info["allgather_bytes"]
        # one slice, two positions (a median), over four owners
        assert ag["sel/median"] <= _bound(world, 1, 2, 4), name
        assert ag["sel/median"] < grid_bytes, name
        assert ag["sel/quantile5"] <= _bound(world, 1, 10, 4), name
        # nanvar: one fold of (count, mean hi, mean lo, M2) a position
        assert ag["sel/nanvar"] <= world * 4 * 32, name


def test_rounds_are_bounded_and_the_same_on_every_rank(worlds):
    for name, (_res, info) in worlds.items():
        # float64: 1 census + 32 four-way splits of a 63-bit interval
        # (the bound is the key width + 2 = 66)
        assert info["rounds"]["sel/median"] == 33, name
        assert info["rounds"]["sel/quantile5"] == 33, name
        # a layout that leaves the reduced axis whole: no round at all
        assert info["rounds"]["local"] == 0, name
    # the fixture already held every rank's rounds equal to rank 0's


def test_selection_bytes_do_not_grow_with_the_operand(runs):
    world, _ranks = WORLDS["rows"]
    info = runs["sizes"]
    for r in info:
        assert r["rounds"] == info[0]["rounds"]
    ag, rounds = info[0]["allgather_bytes"], info[0]["rounds"]
    assert all(v == 0 for v in info[0]["gathered"].values())
    for prog in ("median", "quantile"):
        assert rounds[f"small_{prog}"] == rounds[f"large_{prog}"] <= 66
        assert ag[f"small_{prog}"] == ag[f"large_{prog}"], prog
        assert ag[f"large_{prog}"] < 92 * 76 * 8
    # along an axis the counts grow with the slices (76 against 19), not
    # with their length
    assert ag["large_median_a0"] <= _bound(world, 76, 2)


def test_hint_over_a_computed_value_is_resharded(worlds, tmp_path):
    import ramba_tpu_torch as rt

    g = worker.select_inputs()["g64"]
    want_y = np.asarray(2.5 * rt.fromarray(g) + 1)
    want_sum = float(np.sum((2.5 * g + 1) + g[::-1]))
    for name, (res, info) in worlds.items():
        assert info["hint_from"] == "PartitionSpec(('d0', 'd1'),)", name
        assert info["hint_to"] == "PartitionSpec(None, ('d0', 'd1'))", name
        _same_bits(res["hint/y"], want_y, name)
        # one reshard of the grid's bytes, and the sum's partials
        assert info["hint_comm"]["reshard_bytes"] == g.nbytes, name
        assert info["hint_comm"]["reshard_count"] == 1, name
        assert info["hint_comm"].get("allgather_bytes", 0) < g.nbytes
        np.testing.assert_allclose(res["hint/sum"], want_sum, rtol=1e-13)
        np.testing.assert_allclose(res["hint/gathered_sum"],
                                   np.sum(2.0 * g[::-1] + g[::-1]),
                                   rtol=1e-13)


def test_empty_extents_raise_at_the_call_or_are_nan(worlds):
    for name, (res, info) in worlds.items():
        assert info["empty_errors"] == {"quantile": "IndexError",
                                        "ptp": "ValueError",
                                        "cmax": "ValueError"}, name
        for k in ("empty/nanmedian", "empty/nanquantile"):
            assert res[k].shape == (5,) and np.isnan(res[k]).all(), (name, k)


@pytest.mark.parametrize("world", [2, 4])
def test_a_rank_stalled_in_a_selection_raises_under_the_watchdog(
        tmp_path, world):
    ranks = WORLDS["rows" if world == 2 else "four"][1]
    procs, outdir = _start(
        world, ranks, tmp_path, case="stall",
        env={"RAMBA_WATCHDOG_S": "1", "RAMBA_COHERENCE_TIMEOUT_S": "3",
             "RAMBA_RETRY_BASE_S": "0"})
    _res, info = _wait(procs, outdir, world)
    for r in info:
        assert r["error"] in ("RankStallError", "GroupBrokenError"), r
        # the deadline (1 s) and the coherence rounds' (3 s) bound it,
        # well before the stall (4 s) or the group's timeout (60 s)
        assert r["seconds"] < 10, r
