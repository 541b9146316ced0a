"""Slices, transposes, reshapes and the other movement ops across ranks
(``core/rankmove.py``, ``core/rankflush.py``'s ``lower_movements``), on
the CPU.

Four gloo worlds run the same programs over one (2, 2) mesh
(``tests/torch_dist_worker.py``, mode ``move``): one rank holding all
four positions, two ranks holding a row each, two ranks on the
checkerboard and four ranks.  The programs: basic slices (negative
steps, integers, ``None``, ``Ellipsis``), ``split``, ``array_split``,
``diff``; writes through a slice, a transposed and a reshaped view; the
transposes; reshapes (``ravel``, ``flatten``, ``squeeze``,
``expand_dims``); ``broadcast_to`` and elementwise operands that
broadcast; ``flip``, ``fliplr``, ``flipud``, ``rot90``; ``concatenate``,
``stack``, ``hstack``, ``vstack``, ``roll``; ``pad`` in its six modes;
``tril``/``triu``; on a 23x19 float64 grid and a 257-vector, and the
chains of slices, pads, transposes and joins in bool, int8, uint64,
float16, float32, float64 and complex128 near each dtype's limits (NaN,
inf, signed zeros, subnormals); even programs on 16x16 and 256 for
GSPMD's layouts; Jacobi sweeps written with slices; what still gathers.

Held:

* every result has the same bytes on every rank and in all four worlds;
* every movement and elementwise result is byte-equal to the port in one
  process and to ``ramba_tpu`` (sign bits and NaN positions with it, as
  bytes); the folds over moved values within n eps sum|x|;
* no movement takes the gathered lowering; what still does is counted
  there, once a program;
* the layouts are GSPMD's (``jax.jit`` over the same ``NamedSharding``s
  on the CPU devices), and ``rankmove.result_spec`` agrees with jax over
  sampled cases of each op;
* the bytes a rank receives equal closed forms written out here from
  the blocks' ranges;
* the port's ``models/jacobi.residual`` and one ``models/kmeans``
  iteration give ``ramba_tpu``'s results on four ranks, k-means
  gathering only for its pick of centroids;
* a rank failing inside a movement makes every rank raise (a transient
  failure is retried down the ladder and gives the same bytes), and a
  rank stalled before a round, under the watchdog, makes every rank
  raise ``RankStallError`` or ``GroupBrokenError``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import ramba_tpu as rtj
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding as JSharding
from jax.sharding import PartitionSpec as JP
from ramba_tpu.parallel import mesh as rmesh
from ramba_tpu_torch import common

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dist_worker as worker  # noqa: E402

WORKER = str(Path(__file__).resolve().parent / "torch_dist_worker.py")
LIMIT_S = 300
WORLDS = {"one": (1, "0,0,0,0"), "rows": (2, "0,0,1,1"),
          "checker": (2, "0,1,1,0"), "four": (4, "0,1,2,3")}
# results that fold moved values: held within a bound of one process
FOLDS = ("folds/three", "folds/flip", "bytes_three/c", "bytes_flip/c",
         "broadcast/keep")


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
                    RAMBA_MOVE_CASE=case)
    for k in ("RAMBA_FAULTS", "RAMBA_WATCHDOG_S", "RAMBA_HBM_BUDGET"):
        full_env.pop(k, None)
    full_env.update(env or {})
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), str(tmp / "store"),
         str(outdir), "move"], env=full_env, stdout=subprocess.PIPE,
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


def _results(rt_pkg):
    """Every movement program's results through ``rt_pkg`` in one
    process."""
    put = lambda x, spec: rt_pkg.fromarray(x)  # noqa: E731
    out = {f"{name}/{k}": np.asarray(v)
           for name, fn in worker.move_programs(rt_pkg, put).items()
           for k, v in fn().items()}
    ev = worker.move_even_inputs()
    for name, ops in worker.MOVE_EVEN_PROGRAMS.items():
        out[f"even/{name}/c"] = np.asarray(worker.move_even_call(
            rt_pkg, name, *[put(ev[k], s) for k, s in ops]))
    return out


def _jspec(spec):
    return JP(*spec) if spec else JP()


def _canon(spec):
    """A jax spec as the port's canonical form (a list of entries)."""
    out = []
    for e in spec:
        names = () if e is None else (e,) if isinstance(e, str) else tuple(e)
        out.append(None if not names else names[0] if len(names) == 1
                   else list(names))
    while out and out[-1] is None:
        out.pop()
    return out


def _jmesh():
    return JMesh(np.array(jax.devices()[:4]).reshape(2, 2), ("d0", "d1"))


def _gspmd_layouts():
    """GSPMD's result layout for each even program, read from jax."""
    mesh = _jmesh()
    ev = worker.move_even_inputs()
    out = {}
    for name, ops in worker.MOVE_EVEN_PROGRAMS.items():
        args = [jax.device_put(ev[k], JSharding(mesh, _jspec(s)))
                for k, s in ops]
        fn = jax.jit(lambda *x, name=name: worker.move_even_call(
            jnp, name, *x))
        out[f"even/{name}/c"] = _canon(fn(*args).sharding.spec)
    return out


def _kmeans_reference():
    """``ramba_tpu``'s Jacobi residual and k-means iteration on the
    models program's inputs (one device)."""
    from ramba_tpu.models import jacobi, kmeans

    d = worker.move_inputs()
    F = d["F"]
    u = np.zeros_like(F)
    ru = rtj.fromarray(u)
    rf = rtj.fromarray(F)
    for _ in range(worker.MOVE_SWEEPS):
        ru[1:-1, 1:-1] = 0.25 * (ru[:-2, 1:-1] + ru[2:, 1:-1]
                                 + ru[1:-1, :-2] + ru[1:-1, 2:]
                                 - rf[1:-1, 1:-1])
    u = np.asarray(ru)
    res = jacobi.residual(rtj.fromarray(u), rf)
    cent, labels = kmeans.kmeans(d["P"], 3, iters=1, seed=0)
    return {"u": u, "residual": np.float64(res),
            "centroids": np.asarray(cent), "labels": np.asarray(labels)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world's results (rank 0's, after checking that all ranks of
    a world agree byte for byte), all started at once; while they run,
    the port's results in one process, ``ramba_tpu``'s on a one-device
    mesh and GSPMD's layouts."""
    _x64()
    import ramba_tpu_torch as rt

    started = {}
    for name, (world, ranks) in WORLDS.items():
        tmp = tmp_path_factory.mktemp(name)
        started[name] = (_start(world, ranks, tmp), world)
    common.set_device("cpu")
    one = _results(rt)
    prev = rmesh.get_mesh()
    rmesh.set_mesh(JMesh(np.array(jax.devices()[:1]), ("d0",)))
    try:
        ref = _results(rtj)
        models = _kmeans_reference()
    finally:
        rmesh.set_mesh(prev)
    layouts = _gspmd_layouts()
    out = {}
    for name, ((procs, outdir), world) in started.items():
        res, info = _wait(procs, outdir, world)
        for r in range(1, world):
            assert sorted(res[r]) == sorted(res[0])
            for k in res[0]:
                assert res[r][k].tobytes() == res[0][k].tobytes(), (name, k)
            assert info[r]["spec"] == info[0]["spec"], name
        out[name] = (res[0], info)
    return {"worlds": out, "one": one, "ref": ref, "layouts": layouts,
            "models": models}


@pytest.fixture(scope="module")
def worlds(runs):
    return runs["worlds"]


def test_every_world_gives_the_same_bytes(worlds):
    base, _info = worlds["four"]
    assert len(base) == 136
    for name in ("one", "rows", "checker"):
        res, _ = worlds[name]
        assert sorted(res) == sorted(base), name
        bad = [k for k in base if res[k].dtype != base[k].dtype
               or res[k].shape != base[k].shape
               or res[k].tobytes() != base[k].tobytes()]
        assert not bad, (name, bad)


def test_no_movement_is_gathered(worlds):
    for name, (_res, info) in worlds.items():
        for r in info:
            progs = r["main_programs"] + [f"even/{n}"
                                          for n in r["even_programs"]]
            got = {k: r["gathered"][k] for k in progs if r["gathered"][k]}
            assert not got, (name, got)
            assert all(r["stats"][k]["movements"] >= 1 for k in progs
                       if k not in ("tri", "even/tril")), name
            # tril/triu mask each block by its global indices
            assert r["stats"]["tri"]["movements"] == 0


@pytest.mark.parametrize("program", worker.MOVE_GATHERED)
def test_what_still_gathers_is_counted(worlds, program):
    for name, (_res, info) in worlds.items():
        for r in info:
            assert r["gathered"][program] == 1, (name, program)


def _groups(keys):
    return sorted({k.split("/")[0] for k in keys})


def _bits_equal(got, want):
    return got.dtype == want.dtype and got.shape == want.shape and \
        got.tobytes() == want.tobytes()


@pytest.mark.parametrize("which", ["one", "ref"])
def test_movements_are_byte_equal_to_one_process(worlds, runs, which):
    res, _ = worlds["checker"]
    want = runs[which]
    keys = [k for k in want if k not in FOLDS]
    assert len(keys) == 118
    bad = [k for k in keys if not _bits_equal(res[k], want[k])]
    assert not bad, bad


@pytest.mark.parametrize("which", ["one", "ref"])
def test_folds_are_within_n_eps_of_one_process(worlds, runs, which):
    res, _ = worlds["four"]
    d = worker.move_inputs()
    for k in FOLDS:
        got, want = res[k], runs[which][k]
        assert got.dtype == want.dtype and got.shape == want.shape, k
        x = d["e"] if k.startswith("bytes") else d["a"] if k.startswith(
            "folds/") else d["A"]
        bound = 4 * x.size * np.finfo(np.float64).eps * float(
            np.abs(x).max()) ** 2 * x.size
        assert np.all(np.abs(got - want) <= bound), k


@pytest.mark.parametrize("key", sorted(f"even/{n}/c"
                                       for n in worker.MOVE_EVEN_PROGRAMS))
def test_result_layouts_are_gspmds(worlds, runs, key):
    want = runs["layouts"][key]
    for name, (_res, info) in worlds.items():
        assert info[0]["spec"][key] == want, (name, key)


def _ranks_of(ranks):
    grid = [int(r) for r in ranks.split(",")]
    return {(i, j): grid[2 * i + j] for i in range(2) for j in range(2)}


def _want_bytes(program, grid, rank):
    """What ``rank`` receives, written out from the blocks' ranges (the
    positions ``grid`` gives the rank; a 1-D layout over both mesh axes
    puts position (i, j) at block 2 i + j):

    * ``bytes_three`` (``x[2:] - 2 x[1:-1] + x[:-2]``, 256 float64, blocks
      of 64): result block b reads two elements of block b + 1, for b < 3;
    * ``bytes_flip`` (``x * flip(x)``): result block b reads block 3 - b;
    * ``sweeps`` (Jacobi on 24 x 24, blocks of 12, result blocks of 11,
      three sweeps): block (i, j) reads a row of 11 from (1 - i, j), a
      column of 11 from (i, 1 - j) and the corner from (1 - i, 1 - j);
      the write moves nothing;
    * ``even/ravel`` (16 x 16 ``P('d0', 'd1')`` to 256 ``P('d0')``):
      result block i reads the blocks (i, 0) and (i, 1), each of 64."""
    own = {p for p, r in grid.items() if r == rank}
    flat = {2 * i + j for i, j in own}
    if program == "bytes_three":
        return 16 * sum(1 for b in flat if b < 3 and b + 1 not in flat)
    if program == "bytes_flip":
        return 8 * 64 * sum(1 for b in flat if 3 - b not in flat)
    if program == "sweeps":
        per = sum(11 * ((1 - i, j) not in own) + 11 * ((i, 1 - j) not in own)
                  + ((1 - i, 1 - j) not in own) for i, j in own)
        return 8 * per * worker.MOVE_SWEEPS
    assert program == "even/ravel"
    rows = {i for i, _j in own}
    return 8 * 64 * sum((i, j) not in own for i in rows for j in range(2))


@pytest.mark.parametrize("program", ["bytes_three", "bytes_flip", "sweeps",
                                     "even/ravel"])
def test_bytes_received_equal_the_closed_form(worlds, program):
    for name, (world, ranks) in WORLDS.items():
        _res, info = worlds[name]
        grid = _ranks_of(ranks)
        for r, rep in enumerate(info):
            assert rep["stats"][program]["bytes_received"] == _want_bytes(
                program, grid, r), (name, r, program)


def test_reads_of_one_leaf_share_one_copy(worlds):
    """``x[2:] - 2 x[1:-1] + x[:-2]`` on four ranks: ``x[:-2]`` is a view
    of the rank's block, the two others views into one copy of it grown
    by two elements (none on the last rank)."""
    _res, info = worlds["four"]
    for r, rep in enumerate(info):
        st = rep["stats"]["bytes_three"]
        assert st["copies"] == (1 if r < 3 else 0), (r, st)
        # a round before the exchange, one after the pieces
        assert st["rounds"] == 2, (r, st)


def test_models_give_ramba_tpus_results(worlds, runs):
    want = runs["models"]
    for name, (res, info) in worlds.items():
        assert res["models/u"].tobytes() == want["u"].tobytes(), name
        assert res["models/residual"] == want["residual"], name
        np.testing.assert_array_equal(res["models/labels"], want["labels"])
        np.testing.assert_allclose(res["models/centroids"],
                                   want["centroids"], rtol=1e-13, atol=0)
        # k-means gathers only its pick of centroids (an advanced index)
        assert info[0]["gathered"]["models"] == 1, name


# the sampled cases of each op: (jax call, port node op and static,
# operand shapes); shapes are powers of two, so every layout divides
def _sample(op, rng):
    shapes = [(8, 16), (16, 8, 4), (32,), (4, 8)]
    if op == "getitem":
        s = shapes[rng.integers(0, 3)]
        idx = []
        for n in s:
            c = rng.integers(0, 6)
            idx.append([slice(None), slice(n // 4, 3 * n // 4),
                        slice(None, None, 2), slice(None, None, -1), 1,
                        slice(1, None, 2)][c])
        if rng.random() < 0.3:
            idx.insert(int(rng.integers(0, len(idx) + 1)), None)
        idx = tuple(idx)
        return (lambda x: x[idx]), ("getitem", (_enc(idx),)), [s]
    if op == "permute":
        s = shapes[rng.integers(0, 2)]
        p = tuple(int(v) for v in rng.permutation(len(s)))
        return (lambda x: jnp.transpose(x, p)), ("permute", (p,)), [s]
    if op == "reshape":
        s, targets = [((8, 16), [(128,), (16, 8), (2, 64), (4, 4, 8),
                                 (2, 2, 32), (32, 4)]),
                      ((16, 8, 4), [(512,), (16, 32), (128, 4), (2, 8, 32),
                                    (4, 4, 32)]),
                      ((32,), [(2, 16), (4, 8), (16, 2), (2, 2, 8)])][
            rng.integers(0, 3)]
        t = targets[rng.integers(0, len(targets))]
        return (lambda x: x.reshape(t)), ("reshape", (t,)), [s]
    if op == "broadcast_to":
        s, t = [((8, 1), (8, 16)), ((16,), (4, 16)), ((1, 8), (8, 8)),
                ((8, 16), (2, 8, 16))][rng.integers(0, 4)]
        return (lambda x: jnp.broadcast_to(x, t)), ("broadcast_to", (t,)), [s]
    if op == "flip":
        s = shapes[rng.integers(0, 2)]
        ax = tuple(sorted({int(a) for a in rng.integers(0, len(s), 2)}))
        return (lambda x: jnp.flip(x, ax)), ("flip", (ax,)), [s]
    if op in ("concatenate", "stack"):
        s = shapes[rng.integers(0, 2)]
        ax = int(rng.integers(0, len(s) + (op == "stack")))
        fn = jnp.concatenate if op == "concatenate" else jnp.stack
        return (lambda x, y: fn([x, y], ax)), (op, (ax,)), [s, s]
    if op == "pad":
        s = shapes[rng.integers(0, 2)]
        pw = tuple((int(w), int(w)) for w in rng.integers(0, 3, len(s)))
        mode = ("constant", "edge", "wrap", "reflect", "symmetric")[
            rng.integers(0, 5)]
        return (lambda x: jnp.pad(x, pw, mode=mode)), ("pad", (pw, mode)), [s]
    assert op == "setitem"
    s = shapes[rng.integers(0, 2)]
    idx = tuple(slice(1, n - 1) if rng.random() < 0.5 else slice(None, None,
                                                                 2)
                for n in s)
    return (lambda x: x.at[idx].set(2.0)), ("setitem", (_enc(idx),)), [s]


def _enc(idx):
    from ramba_tpu_torch.core import expr as E

    return E.encode_index(idx)


_ENTRIES = (None, "d0", "d1", ("d0", "d1"), ("d1", "d0"))


def _layout(shape, rng):
    """A layout of an array of ``shape`` naming each mesh axis once, its
    dims divisible by their entries."""
    while True:
        spec = tuple(_ENTRIES[i] for i in rng.integers(0, 5, len(shape)))
        names = [n for e in spec if e for n in ((e,) if isinstance(e, str)
                                                 else e)]
        parts = [1 if e is None else 2 if isinstance(e, str) else 4
                 for e in spec]
        if len(names) == len(set(names)) and all(
                n % p == 0 for n, p in zip(shape, parts)):
            return spec


def _divides(spec, shape):
    parts = [1 if e is None else 2 if isinstance(e, str) else 4
             for e in list(spec) + [None] * len(shape)]
    return all(n % p == 0 for n, p in zip(shape, parts))


@pytest.mark.parametrize("op", ["getitem", "setitem", "permute", "reshape",
                                "broadcast_to", "flip", "concatenate",
                                "stack", "pad"])
def test_the_layout_rule_is_gspmds(op):
    """``rankmove.result_spec`` against jax's result layout over 16
    sampled cases of each op (operands of one layout where the op joins
    them), wherever the result divides its layout."""
    import torch
    from ramba_tpu_torch.core import expr as E
    from ramba_tpu_torch.core import rankmove
    from ramba_tpu_torch.parallel import mesh as pm

    jmesh = _jmesh()
    tmesh = pm.Mesh(np.array([torch.device("cpu")] * 4, dtype=object)
                    .reshape(2, 2), ("d0", "d1"))
    rng = np.random.default_rng(["getitem", "setitem", "permute", "reshape",
                                 "broadcast_to", "flip", "concatenate",
                                 "stack", "pad"].index(op))
    compared = 0
    for _ in range(16):
        fn, (name, static), shapes = _sample(op, rng)
        spec = _layout(shapes[0], rng)
        args = [E.Const(torch.ones(s, dtype=torch.float64)) for s in shapes]
        if name == "setitem":
            args.append(E.Scalar(2.0))
        node = E.Node(name, static, args)
        want = rankmove.result_spec(node, [pm.NamedSharding(
            tmesh, pm.P(*spec))] * len(shapes))
        if not _divides(tuple(want), node.shape):
            continue
        xs = [jax.device_put(np.ones(s), JSharding(jmesh, _jspec(spec)))
              for s in shapes]
        got = jax.jit(fn)(*xs).sharding.spec
        assert _canon(want) == _canon(got), (op, static, shapes, spec)
        compared += 1
    assert compared >= 8, compared


def _failing(tmp_path, world, fault, env=None):
    ranks = WORLDS["rows" if world == 2 else "four"][1]
    procs, outdir = _start(world, ranks, tmp_path, case="fail",
                           env=dict({"RAMBA_MOVE_FAULT": fault,
                                     "RAMBA_RETRY_BASE_S": "0"},
                                    **(env or {})))
    return _wait(procs, outdir, world)


@pytest.mark.parametrize("world", [2, 4])
def test_a_rank_failing_in_a_movement_raises_on_every_rank(tmp_path, world):
    _res, info = _failing(tmp_path, world, "move:piece:always:rank=1")
    for r in info:
        assert r["error"] is not None, r
        assert r["gathered"] == 0, r


def test_a_transient_failure_is_retried_to_the_same_bytes(tmp_path):
    res, info = _failing(tmp_path, 4, "move:piece:once:rank=1")
    e = worker.move_inputs()["e"]
    for rr, r in zip(res, info):
        assert r["error"] is None and r["gathered"] == 0, r
        assert rr["c"].tobytes() == (e[2:] + e[:-2]).tobytes()


@pytest.mark.parametrize("world", [2, 4])
def test_a_rank_stalled_in_a_movement_raises_under_the_watchdog(
        tmp_path, world):
    ranks = WORLDS["rows" if world == 2 else "four"][1]
    procs, outdir = _start(
        world, ranks, tmp_path, case="stall",
        env={"RAMBA_MOVE_FAULT": "move:round:hang:ms=4000:after=1:rank=1",
             "RAMBA_WATCHDOG_S": "1", "RAMBA_COHERENCE_TIMEOUT_S": "3",
             "RAMBA_RETRY_BASE_S": "0"})
    _res, info = _wait(procs, outdir, world)
    for r in info:
        assert r["error"] in ("RankStallError", "GroupBrokenError"), r
        assert r["gathered"] == 0, r
        # the deadline (1 s) and the coherence rounds' (3 s) bound it,
        # well before the stall (4 s) or the group's timeout (60 s)
        assert r["seconds"] < 10, r
