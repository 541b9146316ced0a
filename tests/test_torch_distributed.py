"""The port across processes (``ramba_tpu_torch/parallel/distributed.py``,
``core/rankflush.py``) against ramba_tpu, x64 regime, on the CPU.

Each world size (1, 2 and 4 ranks, and 4 ranks with ``RAMBA_WORKERS=2``)
is one launch of ``tests/torch_dist_worker.py`` per rank: a gloo group
formed through a ``file://`` store in the test's temporary directory (no
port to race for under xdist), every rank on the CPU.  Each launch has its
own wall-clock limit, and a launch that runs past it is killed whole.
Every rank runs the same fixed list of programs (``programs``: the
reference smoke's chain, sum, spmd halo sweep, sstencil_iterate, ``.rtd``
and ``.npy`` round trips and ``in_driver``; the chain's sum, mean, min and
max; star2 on even and uneven shapes; spmd ``halo(1)``/``halo(2)``;
``scumulative``; a ``SreduceReducer``; a sort and a gather, which take
the gathered lowering; a checkpoint restored and run on) and writes its
results.  ramba_tpu runs the same programs in this process on a mesh of
virtual devices of the same shape (``tests/conftest.py`` makes 8).

Held: every result equals ramba_tpu's in value and dtype, exactly, except
whole-array float sums, which are held within n * eps * sum|x_i| (n
terms, any summation order, one rounding per term; every summand here is
positive, so sum|x_i| is the sum itself); every rank gets the same bytes,
and a rerun of a sum the same bytes; the main path's programs take the
gathered lowering zero times; each rank's block sits at the index
ramba_tpu's sharding gives the device at its position.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import ramba_tpu as rtj
from jax.sharding import Mesh as JMesh
from ramba_tpu.parallel import mesh as rmesh
from ramba_tpu_torch import common
from ramba_tpu_torch.parallel import distributed

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dist_worker as worker  # noqa: E402

WORKER = str(Path(__file__).resolve().parent / "torch_dist_worker.py")
LIMIT_S = 300  # per launch, every rank of it
MESH_OF = {1: (1,), 2: (2,), 4: (2, 2)}
EPS = float(np.finfo(np.float64).eps)


def _x64():
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")


@pytest.fixture(autouse=True)
def _port_on_cpu():
    _x64()
    common.set_device("cpu")


def launch(world, tmp, mode="main", env=None, limit=LIMIT_S):
    """Start ``world`` ranks and wait for all of them (at most ``limit``
    seconds, then every one is killed).  Returns ``(rcs, logs, outdir)``."""
    outdir = tmp / "out"
    outdir.mkdir()
    store = tmp / "store"
    # gloo on the loopback interface: every rank is on this host
    full_env = dict(os.environ, RAMBA_TORCH_DEVICE="cpu",
                    RAMBA_INIT_TIMEOUT_S="60", OMP_NUM_THREADS="1",
                    GLOO_SOCKET_IFNAME="lo")
    full_env.pop("RAMBA_FAULTS", None)
    full_env.update(env or {})
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), str(store), str(outdir),
         mode], env=full_env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs, rcs = [], []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=limit)
            logs.append(out)
            rcs.append(p.returncode)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"{world} ranks ran past {limit} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return rcs, logs, outdir


def _load(outdir, world):
    res = [dict(np.load(outdir / f"rank{r}.npz")) for r in range(world)]
    info = [json.loads((outdir / f"rank{r}.json").read_text())
            for r in range(world)]
    return res, info


def _ok(world, tmp, env=None):
    rcs, logs, outdir = launch(world, tmp, env=env)
    assert rcs == [0] * world, "\n".join(logs)
    return _load(outdir, world)


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    _x64()
    return _ok(1, tmp_path_factory.mktemp("w1"))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    # the connect's first attempt fails on every rank and is retried
    _x64()
    return _ok(2, tmp_path_factory.mktemp("w2"),
               env={"RAMBA_FAULTS": "init_connect:once"})


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    _x64()
    return _ok(4, tmp_path_factory.mktemp("w4"))


@pytest.fixture(scope="module")
def world4_capped(tmp_path_factory):
    _x64()
    return _ok(4, tmp_path_factory.mktemp("w4c"), env={"RAMBA_WORKERS": "2"})


_REF: dict = {}


def reference(shape, tmp):
    """ramba_tpu's results of every program on a mesh of ``shape``."""
    if shape in _REF:
        return _REF[shape]
    k = int(np.prod(shape))
    if len(jax.devices()) < k:
        pytest.skip(f"needs {k} devices")
    pytest.importorskip("orbax.checkpoint")
    old = rmesh.get_mesh()
    names = tuple(f"d{i}" for i in range(len(shape)))
    rmesh.set_mesh(JMesh(np.array(jax.devices()[:k]).reshape(shape), names))
    try:
        out = {}
        for name, fn in worker.programs(rtj, str(tmp)).items():
            for key, v in fn().items():
                out[f"{name}/{key}"] = np.asarray(v)
    finally:
        rmesh.set_mesh(old)
    _REF[shape] = out
    return out


def _world(request, name):
    return request.getfixturevalue(name)


PROGRAMS = list(worker.programs(rtj, "/nonexistent"))
WORLDS = ["world1", "world2", "world4"]
SIZES = {"world1": 1, "world2": 2, "world4": 4}


def _held(key, got, want):
    prog, item = key.split("/")
    assert got.dtype == want.dtype, (key, got.dtype, want.dtype)
    if item in worker.SUMS:
        bound = worker.SUMS[item] * EPS * abs(float(want))
        assert abs(float(got) - float(want)) <= bound, (key, got, want)
    elif item in worker.SCANS:
        # ramba_tpu: 2 log2(n) odd/even levels; the port: the scan
        # kernel's own depth, then one rebase per rank before
        from ramba_tpu_torch.ops import scan

        n = worker.SCANS[item]
        depth = 2 * int(np.ceil(np.log2(n))) + scan.depth(n) + 4
        np.testing.assert_array_less(np.abs(got - want),
                                     depth * EPS * np.abs(want) + 1e-300)
    elif prog.startswith("groupby"):
        # per group of n_g terms: min, max and count exactly; sums, means
        # and products within (n_g + 1) eps of their magnitude (every
        # value is positive; any order of roundings); var = E[x^2] -
        # mean^2 within (n_g + 2) eps of the terms it subtracts (values
        # below 1.5: each term below 2.25)
        n_g = -(-worker.SERIES_N // int(prog[len("groupby"):]))
        if item in ("min", "max", "count"):
            np.testing.assert_array_equal(got, want, err_msg=key)
        elif item == "var":
            np.testing.assert_array_less(np.abs(got - want),
                                         4 * (n_g + 2) * EPS * 2.25)
        else:
            np.testing.assert_array_less(np.abs(got - want),
                                         2 * (n_g + 1) * EPS * np.abs(want))
    elif prog == "axis_sums" and item in ("ax0", "ax1", "kd0", "mean0",
                                          "col_ax0", "col_ax1"):
        # 24 or 20 positive terms a sum, folded across ranks in another
        # order: within n eps of the sum
        np.testing.assert_array_less(np.abs(got - want),
                                     25 * EPS * np.abs(want))
    elif item == "lin":
        start, stop, num = worker.LINSPACE
        ulp = np.spacing(max(abs(start), abs(stop)))
        np.testing.assert_array_less(np.abs(got - want), ulp * 1.0001)
        import ramba_tpu_torch as rt

        one = rt.linspace(start, stop, num)._value().numpy()
        assert got.tobytes() == one.tobytes()
    else:
        np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("wname", WORLDS)
@pytest.mark.parametrize("prog", PROGRAMS)
def test_programs_match_ramba_tpu(request, wname, prog, tmp_path):
    res, _info = _world(request, wname)
    ref = reference(MESH_OF[SIZES[wname]], tmp_path)
    keys = [k for k in ref if k.split("/")[0] == prog]
    assert keys
    for key in keys:
        _held(key, res[0][key], ref[key])


@pytest.mark.parametrize("wname", WORLDS + ["world4_capped"])
def test_every_rank_gets_the_same_bytes(request, wname):
    res, _info = _world(request, wname)
    keys = [k for k in res[0] if not k.startswith("block/")]
    for r in res[1:]:
        for k in keys:
            assert r[k].tobytes() == res[0][k].tobytes(), k
    # a rerun of the cross-rank sum gives the same bytes, and of a groupby
    assert res[0]["chain/rerun"].tobytes() == \
        res[0]["chain/chain_sum"].tobytes()
    for G in (24, 64):
        assert res[0][f"groupby{G}/sum_rerun"].tobytes() == \
            res[0][f"groupby{G}/sum"].tobytes()


@pytest.mark.parametrize("wname", WORLDS + ["world4_capped"])
def test_main_path_gathers_nothing(request, wname):
    _res, info = _world(request, wname)
    for rank_info in info:
        for prog in worker.MAIN_PATH + worker.LAYOUT_PATH + (
                "spmd_halo1", "spmd_halo2", "scum", "sred", "smaps"):
            assert rank_info["gathered"][prog] == 0, (prog, rank_info)
        # a sort and a gather do take the gathered lowering, counted
        assert rank_info["gathered"]["gathered"] >= 1
        assert rank_info["comm"]["allgather_bytes"] > 0


@pytest.mark.parametrize("wname", ["world2", "world4"])
def test_blocks_sit_at_ramba_tpus_shard_index(request, wname):
    res, info = _world(request, wname)
    shape = MESH_OF[SIZES[wname]]
    k = int(np.prod(shape))
    if len(jax.devices()) < k:
        pytest.skip(f"needs {k} devices")
    whole = np.arange(23 * 17.0).reshape(23, 17)
    names = tuple(f"d{i}" for i in range(len(shape)))
    jm = JMesh(np.array(jax.devices()[:k]).reshape(shape), names)
    old = rmesh.get_mesh()
    rmesh.set_mesh(jm)
    try:
        # an even shape: jax 0.9 keeps an uneven one on one device
        even = np.arange(24 * 20.0).reshape(24, 20)
        jarr = rtj.fromarray(even)._value()
        jidx = jarr.sharding.devices_indices_map(even.shape)
    finally:
        rmesh.set_mesh(old)
    from ramba_tpu_torch.parallel import mesh as pmesh

    for rr, ri in zip(res, info):
        assert len(ri["blocks"]) == 1
        pos = tuple(ri["blocks"][0]["position"])
        got = rr["block/0"]
        idx = tuple(slice(a, b) for a, b in ri["blocks"][0]["index"])
        np.testing.assert_array_equal(got, whole[idx])
        # the port's rule on the even shape is ramba_tpu's index
        pm = pmesh.Mesh(np.array([torch.device("cpu")] * k,
                                 dtype=object).reshape(shape), names)
        psh = pmesh.NamedSharding(pm, pmesh.default_spec(even.shape, pm))
        pidx = psh.block_index(pos, even.shape)
        want = jidx[jm.devices[pos]]
        assert [sl.indices(n) for sl, n in zip(pidx, even.shape)] == \
            [sl.indices(n) for sl, n in zip(want, even.shape)]


@pytest.mark.parametrize("wname", WORLDS)
def test_checkpoint_digests_are_one_process_digests(request, wname):
    # the leaf digests a multi-rank save records are taken over the
    # gathered leaf: the one-process digest, which is ramba_tpu's
    # (tests/test_torch_checkpoint.py::test_sidecar_leaves_match_reference)
    import ramba_tpu_torch as rt
    from ramba_tpu_torch.resilience import integrity

    res, _info = _world(request, wname)
    grid = np.random.default_rng(12)
    grid.random(1003)
    g = rt.sstencil_iterate(rt.stencil(worker.star2_body),
                            rt.fromarray(grid.random((24, 20))), 2)
    assert str(res[0]["ckpt/sidecar"]) == integrity.array_digest(g)


def test_capped_mesh_gives_the_same_answers(world4_capped, world2):
    # RAMBA_WORKERS=2 in a world of 4: a mesh of ranks 0 and 1; ranks 2
    # and 3 hold empty blocks and take part in every collective
    res, info = world4_capped
    res2, _info2 = world2
    for k in res2[0]:
        if k.startswith("block/"):
            continue
        assert res[0][k].tobytes() == res2[0][k].tobytes(), k
    assert "ranks=[0, 1]" in info[0]["mesh"]
    assert [len(i["blocks"]) for i in info] == [1, 1, 0, 0]


@pytest.mark.parametrize("wname", WORLDS)
def test_in_driver_on_rank_0_alone(request, wname):
    _res, info = _world(request, wname)
    assert [i["in_driver"] for i in info] == \
        [True] + [False] * (SIZES[wname] - 1)


@pytest.mark.parametrize("wname", WORLDS)
def test_backend_is_reported(request, wname):
    _res, info = _world(request, wname)
    for i in info:
        assert i["backend"] == "gloo" and "on the CPU" in i["reason"]
        assert i["comm"]["host_staged_bytes"] == 0  # CPU tensors: no staging


@pytest.mark.parametrize("wname", ["world2", "world4", "world4_capped"])
def test_a_reshard_fault_on_one_rank_rolls_back_every_rank(request, wname):
    # reshard:stage on the last rank alone: every rank raises ReshardError,
    # keeps its source, and the rerun completes
    res, _info = _world(request, wname)
    assert [bool(r["reshard_fault/raised"]) for r in res] == \
        [True] * len(res)


def test_init_connect_once_is_retried(world2):
    _res, info = world2
    assert [i["retries"] for i in info] == [1, 1]


@pytest.mark.parametrize("devices, requested, want", [
    ([("h", "cpu")] * 4, None, ("gloo", False)),
    ([("h", "cuda:0"), ("h", "cuda:1")], None, ("nccl", False)),
    ([("a", "cuda:0"), ("b", "cuda:0")], None, ("nccl", False)),
    ([("h", "cuda:0")] * 4, None, ("gloo", True)),
    ([("h", "cuda:0"), ("h", "cuda:1")], "gloo", ("gloo", True)),
    ([("h", "cuda:0")], "nccl", ("nccl", False)),
])
def test_backend_choice(devices, requested, want):
    backend, staged, reason = distributed.choose_backend(devices, requested)
    assert (backend, staged) == want
    assert reason


@pytest.mark.parametrize("devices, requested", [
    ([("h", "cuda:0")] * 2, "nccl"),
    ([("h", "cpu"), ("h", "cuda:0")], None),
    ([("h", "cpu")] * 2, "nccl"),
])
def test_backend_choice_refuses(devices, requested):
    with pytest.raises(ValueError):
        distributed.choose_backend(devices, requested)


def test_a_raising_rank_raises_everywhere(tmp_path):
    _x64()
    rcs, logs, outdir = launch(2, tmp_path, mode="fail",
                               env={"RAMBA_INIT_TIMEOUT_S": "15"}, limit=120)
    r0 = json.loads((outdir / "rank0.json").read_text())
    r1 = json.loads((outdir / "rank1.json").read_text())
    # inside a flush: the rank whose kernel raised re-raises its error,
    # the other learns of it at the outcome agreement
    assert r1["flush"].startswith("ValueError"), logs
    assert r0["flush"].startswith("RuntimeError") and "another rank" in \
        r0["flush"], logs
    # outside any collective (rank 1 left): rank 0's next collective
    # raises within the group's timeout instead of waiting forever
    assert r0["collective"] != "no error"
    assert r0["waited_s"] < 60
    assert rcs[1] == 3


def test_the_analyzer_across_ranks(tmp_path):
    """A strict verifier error raises on both ranks; a repeated program
    hits the result memo on each rank and the whole program's plan
    certificate on both alike, agreed every two hits."""
    _x64()
    rcs, logs, outdir = launch(
        2, tmp_path, mode="analyze", limit=120,
        env={"RAMBA_VERIFY": "strict", "RAMBA_MEMO": "1",
             "RAMBA_PLANCERT": "1", "RAMBA_PLANCERT_AGREE": "2"})
    assert rcs == [0, 0], logs
    info = [json.loads((outdir / f"rank{r}.json").read_text())
            for r in range(2)]
    want = float(np.sum(np.arange(1000.0) * 2.0 + 1.0))
    for r in info:
        assert r["strict"].startswith("ProgramVerificationError"), r
        assert "bogus_axis" in r["strict"]
        assert r["sums"] == [want] * 5
        assert r["memo_hits"] == 4
        assert r["cert_hits"] == 4 and r["agree_rounds"] == 2
        assert r["rounds"] == 2


# -- the elastic plane across ranks (resilience/elastic.py) --------------------

ELASTIC_WD = 1.5  # the watchdog's deadline in the stall cases, seconds
ELASTIC_LIMIT_S = 120  # per launch of ranks, every rank of it


def elastic_launch(world, tmp, case, root, env=None):
    tmp.mkdir(parents=True, exist_ok=True)
    return launch(world, tmp, mode="elastic", limit=ELASTIC_LIMIT_S,
                  env={"RAMBA_ELASTIC_CASE": case,
                       "RAMBA_ELASTIC_ROOT": str(root), **(env or {})})


def _same_bytes(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


@pytest.fixture(scope="module")
def elastic_chain(tmp_path_factory):
    """A checkpoint saved on 4 ranks, resumed on 2 (and saved again),
    resumed in one process (and saved again), resumed on 2."""
    _x64()
    root = tmp_path_factory.mktemp("elastic_ck")
    links = []
    for i, (world, case) in enumerate(((4, "save"), (2, "resume"),
                                       (1, "resume"), (2, "resume"))):
        rcs, logs, outdir = elastic_launch(
            world, tmp_path_factory.mktemp(f"elastic_chain{i}"), case, root)
        assert rcs == [0] * world, "\n".join(logs)
        links.append((world, _load(outdir, world)))
    return links


@pytest.mark.parametrize("link", [1, 2, 3], ids=["4to2", "2to1", "1to2"])
def test_resume_into_another_world_size(elastic_chain, link):
    """Each rank reads its block of the newest step in the new world's
    default layout: byte-equal to NumPy, the manifest naming the world
    that wrote it."""
    grid, series = worker.elastic_state()
    prev = elastic_chain[link - 1][0]
    world, (res, info) = elastic_chain[link]
    want_layout = {1: "PartitionSpec()", 2: "PartitionSpec('d0',)"}[world]
    for r in range(world):
        assert info[r]["step"] == 6 + link
        assert info[r]["from_processes"] == prev
        assert info[r]["layout"] == want_layout
        assert _same_bytes(res[r]["grid"], grid)
        assert _same_bytes(res[r]["series"], series)
        assert int(res[r]["step"]) == 6 + link


def test_the_manifest_records_the_world(elastic_chain):
    _world, (_res, info) = elastic_chain[0]
    man = info[0]["manifest"]
    assert (man["process_count"], man["mesh_devices"], man["mesh_shape"],
            man["x64"]) == (4, 4, {"d0": 2, "d1": 2}, True)
    assert [(lf["path"], lf["shape"], lf["dtype"]) for lf in
            man["leaves"]] == [("['grid']", [24, 20], "float32"),
                               ("['series']", [1003], "float64"),
                               ("['step']", [], "int64")]
    assert all(r["manifest"] == man for r in info)


@pytest.mark.parametrize("case,world", [("wedged", 4), ("crashed", 4),
                                        ("wedged", 2), ("crashed", 2)])
def test_a_lost_rank_at_a_barrier(tmp_path, case, world):
    """The last rank stops arriving at a checkpoint's barrier (asleep, or
    exited): the live ranks raise a fatal error within two deadlines, a
    later collective on the broken group raises at once, and a job
    restarted on 2 ranks resumes the newest valid step byte-equal."""
    _x64()
    root = tmp_path / "ck"
    rcs, logs, outdir = elastic_launch(
        world, tmp_path / "run", case, root,
        env={"RAMBA_WATCHDOG_S": str(ELASTIC_WD)})
    assert rcs == [0] * (world - 1) + [3], "\n".join(logs)
    for r in range(world - 1):
        info = json.loads((outdir / f"rank{r}.json").read_text())
        assert info["stall"].startswith("RankStallError"), info
        assert info["stall_class"] == "fatal"
        assert info["stall_s"] < 2 * ELASTIC_WD
        assert info["after"].startswith("GroupBrokenError"), info
        assert info["after_class"] == "fatal"
        assert info["after_s"] < 0.5
        assert info["broken"] and "barrier" in info["broken"]
        assert info["valid_steps"] == [1]
    rcs, logs, outdir = elastic_launch(2, tmp_path / "restart", "resume",
                                       root)
    assert rcs == [0, 0], "\n".join(logs)
    res, info = _load(outdir, 2)
    grid, series = worker.elastic_state()
    for r in range(2):
        assert info[r]["step"] == 1 and info[r]["from_processes"] == world
        assert _same_bytes(res[r]["grid"], grid)
        assert _same_bytes(res[r]["series"], series)


@pytest.fixture(scope="module")
def elastic_reshape(tmp_path_factory):
    _x64()
    rcs, logs, outdir = elastic_launch(
        4, tmp_path_factory.mktemp("elastic_reshape"), "reshape",
        tmp_path_factory.mktemp("elastic_reshape_ck"))
    assert rcs == [0] * 4, "\n".join(logs)
    return _load(outdir, 4)


def _one_process_star2(grid):
    import ramba_tpu_torch as rt

    return np.asarray(rt.sstencil(rt.stencil(worker.star2_body),
                                  rt.fromarray(grid)))


def test_live_reshape_of_a_rank_mesh(elastic_reshape):
    """(2, 2) -> (4, 1) live: every array byte-equal, a stencil sweep on
    the new mesh byte-equal to one process, one sum on every rank."""
    res, info = elastic_reshape
    grid, series = worker.elastic_state()
    want = _one_process_star2(grid)
    sums = {r["sum_live"] for r in info}
    for r in range(4):
        assert info[r]["live"]["mode"] == "live"
        assert info[r]["live"]["arrays"] >= 2
        assert info[r]["mesh"] == {"d0": 4, "d1": 1}
        assert _same_bytes(res[r]["grid_live"], grid)
        assert _same_bytes(res[r]["series_live"], series)
        assert _same_bytes(res[r]["star2_live"], want)
    assert len(sums) == 1
    assert abs(sums.pop() - float(np.sum(series))) <= \
        1003 * EPS * float(np.sum(series))


def test_live_reshape_of_a_rank_mesh_falls_back(elastic_reshape):
    """A ``reshard:stage`` fault on the way back to (2, 2): every rank
    takes the checkpoint rung together, byte-equal."""
    res, info = elastic_reshape
    grid, series = worker.elastic_state()
    for r in range(4):
        assert info[r]["fallback"]["mode"] == "checkpoint"
        assert info[r]["mesh_fallback"] == {"d0": 2, "d1": 2}
        assert _same_bytes(res[r]["grid_fallback"], grid)
        assert _same_bytes(res[r]["series_fallback"], series)
        assert info[r]["sum_fallback"] == info[r]["sum_live"]


def test_live_reshape_of_a_rank_mesh_falls_back_without_a_manager(
        elastic_reshape):
    """The fallback with no manager: every rank writes and reads one
    temporary root (rank 0's, named to the others), which is gone after
    the resume; byte-equal on the new mesh."""
    res, info = elastic_reshape
    grid, series = worker.elastic_state()
    roots = {tuple(r["tmp_roots"]) for r in info}
    assert len(roots) == 1 and len(roots.pop()) == 1
    for r in range(4):
        assert info[r]["fallback_tmp"]["mode"] == "checkpoint"
        assert info[r]["mesh_tmp"] == {"d0": 4, "d1": 1}
        assert info[r]["tmp_left"] == [False]
        assert _same_bytes(res[r]["grid_tmp"], grid)
        assert _same_bytes(res[r]["series_tmp"], series)


def test_an_unarmed_rank_flush_reads_its_switches_once(tmp_path):
    """With the watchdog unset, a flush across 2 ranks starts no thread,
    reads the watchdog's switch once and the rounds' deadline once,
    however many coherence rounds it runs."""
    _x64()
    rcs, logs, outdir = elastic_launch(2, tmp_path, "one_read",
                                       tmp_path / "ck")
    assert rcs == [0, 0], "\n".join(logs)
    _grid, series = worker.elastic_state()
    info = [json.loads((outdir / f"rank{r}.json").read_text())
            for r in range(2)]
    for r in info:
        assert r["rounds"] >= 2, r
        assert r["reads"] == {"watchdog": 1, "coherence": 1}, r
        assert r["threads"] == [], r
        assert r["sum"] == info[0]["sum"]
    want = float(np.sum(series * 2.0 + 1.0))
    assert abs(info[0]["sum"] - want) <= 2 * 1003 * EPS * abs(want)


@pytest.mark.parametrize("world", [2, 4])
def test_a_stalled_rank_drops_every_rank_together(tmp_path, world):
    """Rank 1's dispatch hangs past the watchdog's deadline: its stall is
    proposed to the ``flush:rung`` round, every rank drops to split in
    the same rounds, the sum is one value on every rank, and the
    abandoned attempt stops when it wakes (the group stays whole)."""
    _x64()
    rcs, logs, outdir = elastic_launch(
        world, tmp_path, "rung_stall", tmp_path / "ck",
        env={"RAMBA_WATCHDOG_S": "1", "RAMBA_COHERENCE_TIMEOUT_S": "20",
             "RAMBA_RETRY_BASE_S": "0"})
    assert rcs == [0] * world, "\n".join(logs)
    info = [json.loads((outdir / f"rank{r}.json").read_text())
            for r in range(world)]
    _grid, series = worker.elastic_state()
    want = float(np.sum(2.5 * series + series[::-1]))
    for r in info:
        assert r["rung"] == "split" and r["degrade_steps"] == 1
        assert r["epochs"] == info[0]["epochs"]
        assert r["sum"] == info[0]["sum"]
        assert r["broken"] is None
        assert r["after"] == info[0]["after"]
    assert abs(info[0]["sum"] - want) <= 2 * 1003 * EPS * abs(want)
    assert "dispatch" in info[1]["stalls"]
    assert info[1]["abandoned"] >= 1


# -- the serving plane across ranks (serve/overload.py) -----------------------


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_sheds_the_same_flushes(tmp_path, world):
    """``serve:admit:3:rank=1`` makes rank 1 alone propose a shed for its
    first three dispatches; the ``serve:shed`` round (severity max)
    makes every rank shed those three on the same epochs, the shed
    arrays heal on their next read, and every block is the one the same
    program gives on the default stream."""
    _x64()
    rcs, logs, outdir = launch(
        world, tmp_path, mode="serve", limit=120,
        env={"RAMBA_FAULTS": "serve:admit:3:rank=1",
             "RAMBA_RETRY_BASE_S": "0"})
    assert rcs == [0] * world, "\n".join(logs)
    info = [json.loads((outdir / f"rank{r}.json").read_text())
            for r in range(world)]
    for r in info:
        assert [k for k, _reason, _ep in r["shed"]] == [0, 1, 2], r
        assert all(reason == "fault" for _k, reason, _ep in r["shed"])
        assert r["shed"] == info[0]["shed"]
        assert r["same_blocks"] and r["quarantined"] == 0
    epochs = [ep for _k, _r, ep in info[0]["shed"]]
    assert all(isinstance(e, int) and e > 0 for e in epochs)
    assert len(set(epochs)) == 3
