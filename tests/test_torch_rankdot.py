"""Matmul and the two-operand contractions across ranks
(``core/rankdot.py``, ``core/rankflush.py``'s ``lower_contractions``), on
the CPU.

Four gloo worlds run the same programs over one (2, 2) mesh
(``tests/torch_dist_worker.py``, mode ``dot``): one rank holding all
four positions, two ranks holding a row each, two ranks on the
checkerboard and four ranks.  The programs: every row of the layout
table GSPMD gives for ``jnp.matmul`` (``P('d0', 'd1') @ P('d0', 'd1')``,
rows @ rows, cols @ rows, rows @ cols, rows @ replicated, cols @ cols,
matvec, vecmat), a truncated ``n`` entry, both free dims on one axis
(the larger operand keeps it), batched matmul, ``einsum``
(and its transposed output), ``tensordot`` (``axes=1`` and ``A^T B``),
``inner``, ``dot`` (matrices and vectors), ``sum(2 (A @ B) + D)``, a
computed operand and a product of a product, on 23x19 @ 19x17 float64,
and ``P('d0', 'd1') @ P('d0', 'd1')`` in float32, complex128, int64 (near
its limits: the sums wrap), uint8 and bool; what still gathers (an
einsum of three operands, ``outer``, batch dims split differently).

Held:

* every result has the same bytes on every rank and in all four worlds;
* no contraction takes the gathered lowering; the three that still do
  are counted there;
* every result has the layout GSPMD gives the same operands
  (``jax.jit`` over the same ``NamedSharding``s on the CPU devices), and
  ``rankdot.result_spec`` agrees with jax over sampled layout pairs of
  each form (A larger, B larger, a tie, vectors, transposed operands,
  einsum, batch dims);
* integer and bool products equal the port in one process and
  ``ramba_tpu`` byte for byte; a float result is within gamma_K (|A| @
  |B|) of both, gamma_K = K eps / (1 - K eps) (complex: sqrt(2)
  gamma_{K+2}, Higham's bound for complex inner products);
* the bytes a rank receives equal the schedule's formula, written out
  here from the blocks' ranges (a quarter of each operand a rank for
  ``P('d0', 'd1') @ P('d0', 'd1')`` on four ranks), and each rank runs a
  quarter of the product's flops there;
* a rank failing inside a product makes every rank raise (a transient
  failure is retried down the ladder and gives the same bytes), and a
  rank stalled before a round, under the watchdog, makes every rank
  raise ``RankStallError`` or ``GroupBrokenError``; nothing retreats to
  the gathered lowering.
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
                    RAMBA_DOT_CASE=case)
    for k in ("RAMBA_FAULTS", "RAMBA_WATCHDOG_S", "RAMBA_HBM_BUDGET"):
        full_env.pop(k, None)
    full_env.update(env or {})
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), str(tmp / "store"),
         str(outdir), "dot"], env=full_env, stdout=subprocess.PIPE,
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
    """Every program's results through ``rt_pkg`` in one process."""
    put = lambda x, spec: rt_pkg.fromarray(x)  # noqa: E731
    return {f"{name}/{k}": np.asarray(v)
            for name, fn in worker.dot_programs(rt_pkg, put).items()
            for k, v in fn().items()}


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


def _gspmd_layouts():
    """GSPMD's result layout for each table program, read from jax (on
    even shapes of the same dims: jax lays out no uneven split)."""
    mesh = JMesh(np.array(jax.devices()[:4]).reshape(2, 2), ("d0", "d1"))
    m, k, n = worker.DOT_EVEN
    shapes = {"A": (m, k), "B": (k, n), "v": (k,), "w": (m,),
              "A3": (4, m, k), "B3": (4, k, n), "At": (k, m), "Bt": (n, k)}
    operands = {"mv": ("A", "v"), "vm": ("w", "A"), "batched": ("A3", "B3"),
                "conflict": ("Bt", "At")}

    def laid(x, spec):
        return jax.device_put(np.ones(shapes[x]), JSharding(mesh, _jspec(
            spec)))

    out = {}
    for name, (sa, sb) in worker.DOT_LAYOUTS.items():
        xa, xb = operands.get(name, ("A", "B"))
        out[f"{name}/c"] = _canon(jax.jit(jnp.matmul)(
            laid(xa, sa), laid(xb, sb)).sharding.spec)
    dd = worker.DOT_LAYOUTS["dd"]
    forms = {"einsum/ki": (("A", "B"), lambda a, b: jnp.einsum(
                 "ij,jk->ki", a, b)),
             "tensordot/at_b": (("At", "B"), lambda a, b: jnp.tensordot(
                 a, b, axes=((0,), (0,)))),
             "inner/mat": (("A", "Bt"), jnp.inner)}
    for key, ((xa, xb), fn) in forms.items():
        out[key] = _canon(jax.jit(fn)(laid(xa, dd[0]),
                                      laid(xb, dd[1])).sharding.spec)
    return out


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
    return {"worlds": out, "one": one, "ref": ref, "layouts": layouts}


@pytest.fixture(scope="module")
def worlds(runs):
    return runs["worlds"]


def test_every_world_gives_the_same_bytes(worlds):
    base, _info = worlds["four"]
    assert len(base) == 34
    for name in ("one", "rows", "checker"):
        res, _ = worlds[name]
        assert sorted(res) == sorted(base), name
        bad = [k for k in base if res[k].dtype != base[k].dtype
               or res[k].shape != base[k].shape
               or res[k].tobytes() != base[k].tobytes()]
        assert not bad, (name, bad)


def test_no_contraction_is_gathered(worlds):
    for name, (_res, info) in worlds.items():
        for r in info:
            got = {k: v for k, v in r["gathered"].items()
                   if k in r["main_programs"]}
            assert not any(got.values()), (name, got)
            assert all(r["stats"][k]["contractions"] >= 1
                       for k in r["main_programs"]), name


def test_a_hint_over_a_product_reshards_it(worlds):
    for name, (res, info) in worlds.items():
        assert info[0]["hinted"] == {"spec": [None, ["d0", "d1"]],
                                     "gathered": 0}, name
        assert res["hinted/c"].tobytes() == res["dd/c"].tobytes(), name


@pytest.mark.parametrize("program", worker.DOT_GATHERED)
def test_what_still_gathers_is_counted(worlds, program):
    for name, (_res, info) in worlds.items():
        for r in info:
            assert r["gathered"][program] == 1, (name, program)
            assert r["stats"][program]["contractions"] == 0, name


@pytest.mark.parametrize("key", sorted(
    ["einsum/ki", "tensordot/at_b", "inner/mat"]
    + [f"{n}/c" for n in worker.DOT_LAYOUTS]))
def test_result_layouts_are_gspmds(worlds, runs, key):
    want = runs["layouts"][key]
    for name, (_res, info) in worlds.items():
        assert info[0]["spec"][key] == want, (name, key)


# the contractions whose rule is probed against jax over sampled layouts:
# (call, the port's node op and static, A's shape, B's shape), A larger,
# B larger, equal
_M, _K, _N = 8, 4, 16
_FORMS = {
    "matmul_a": (jnp.matmul, ("matmul", (None,)), (_N, _K), (_K, _M)),
    "matmul_b": (jnp.matmul, ("matmul", (None,)), (_M, _K), (_K, _N)),
    "matmul_tie": (jnp.matmul, ("matmul", (None,)), (_M, _K), (_K, _M)),
    "matvec": (jnp.matmul, ("matmul", (None,)), (_M, _K), (_K,)),
    "vecmat": (jnp.matmul, ("matmul", (None,)), (_K,), (_K, _M)),
    "at_b": (lambda a, b: jnp.tensordot(a, b, axes=((0,), (0,))),
             ("tensordot", (((0,), (0,)), None)), (_K, _N), (_K, _M)),
    "inner": (jnp.inner, ("tensordot", (((1,), (1,)), None)), (_M, _K),
              (_N, _K)),
    "einsum_ki": (lambda a, b: jnp.einsum("ij,jk->ki", a, b),
                  ("einsum", ("ij,jk->ki", None)), (_N, _K), (_K, _M)),
    "einsum_batch": (lambda a, b: jnp.einsum("bij,bjk->ibk", a, b),
                     ("einsum", ("bij,bjk->ibk", None)), (4, _M, _K),
                     (4, _K, _N)),
    "batched": (jnp.matmul, ("matmul", (None,)), (4, _N, _K), (4, _K, _M)),
}
_ENTRIES = (None, "d0", "d1", ("d0", "d1"), ("d1", "d0"))


def _layouts(shape, rng, batch=None):
    """A layout of an array of ``shape`` naming each mesh axis once (its
    first entry ``batch`` where one is given)."""
    while True:
        spec = tuple(_ENTRIES[i] for i in rng.integers(0, 5, len(shape)))
        if batch is not None:
            spec = (batch[0],) + spec[1:]
        names = [n for e in spec if e for n in ((e,) if isinstance(e, str)
                                                 else e)]
        if len(names) == len(set(names)):
            return spec


@pytest.mark.parametrize("name", sorted(_FORMS))
def test_the_layout_rule_is_gspmds(name):
    """``rankdot.result_spec`` against jax's result layout over 16 sampled
    layout pairs of each form (a batch dim split alike in both)."""
    import torch
    from ramba_tpu_torch.core import expr as E
    from ramba_tpu_torch.core import rankdot
    from ramba_tpu_torch.parallel import mesh as pm

    fn, (op, static), sa, sb = _FORMS[name]
    jmesh = JMesh(np.array(jax.devices()[:4]).reshape(2, 2), ("d0", "d1"))
    tmesh = pm.Mesh(np.array([torch.device("cpu")] * 4, dtype=object)
                    .reshape(2, 2), ("d0", "d1"))
    node = E.Node(op, static, [E.Const(torch.ones(sa)),
                               E.Const(torch.ones(sb))])
    f = rankdot.form(node)
    rng = np.random.default_rng(sorted(_FORMS).index(name))
    for _ in range(16):
        ea = _layouts(sa, rng)
        eb = _layouts(sb, rng, ea if len(sa) == 3 else None)
        want = rankdot.result_spec(f, pm.NamedSharding(tmesh, pm.P(*ea)),
                                   pm.NamedSharding(tmesh, pm.P(*eb)), sa, sb)
        a = jax.device_put(np.ones(sa), JSharding(jmesh, _jspec(ea)))
        b = jax.device_put(np.ones(sb), JSharding(jmesh, _jspec(eb)))
        got = jax.jit(fn)(a, b).sharding.spec
        assert _canon(want) == _canon(got), (name, ea, eb)


def _operands(key):
    """The host operands of a float program's result ``key`` and whether
    it is an epilogue."""
    d = worker.dot_inputs()
    name, sub = key.split("/")
    pairs = {"mv": ("A", "v"), "vm": ("w", "A"), "batched": ("A3", "B3"),
             "dd_even": ("Ae", "Be"), "dd_float32": ("A_float32",
                                                     "B_float32"),
             "dd_complex128": ("A_complex128", "B_complex128"),
             "conflict": ("Bt", "At")}
    if name in pairs:
        x, y = pairs[name]
        return d[x], d[y]
    if key == "tensordot/at_b":
        return d["At"].T, d["B"]
    if key == "inner/mat":
        return d["A"], d["Bt"].T
    if key in ("inner/vec", "dot/vv"):
        return d["v"], d["u"]
    if key == "computed/c":
        return 2.0 * d["A"] + 1.0, d["B"]
    return d["A"], d["B"]


def _gamma(k, dt):
    eps = np.finfo(dt).eps
    return k * eps / (1 - k * eps)


def _bound(key, got):
    """gamma_K (|A| @ |B|) for a float result (complex: sqrt(2)
    gamma_{K+2}); the epilogue's and the chain's from their terms."""
    d = worker.dot_inputs()
    if key == "epilogue/sum":
        A, B, D = d["A"], d["B"], d["D"]
        prod = np.abs(A) @ np.abs(B)
        n = prod.size
        k = A.shape[1]
        return 2 * _gamma(k, np.float64) * prod.sum() + _gamma(n, np.float64) \
            * (2 * prod + np.abs(D)).sum()
    if key == "chain/c":
        A, B, E = d["A"], d["B"], d["E"]
        k = A.shape[1] + B.shape[1]
        return _gamma(k, np.float64) * ((np.abs(A) @ np.abs(B)) @ np.abs(E))
    a, b = _operands(key)
    k = a.shape[-1]
    if np.iscomplexobj(got):
        return np.sqrt(2) * _gamma(k + 2, np.float64) * (np.abs(a)
                                                         @ np.abs(b))
    return _gamma(k, got.dtype) * (np.abs(a).astype(np.float64)
                                   @ np.abs(b).astype(np.float64))


def _floats(one):
    return sorted(k for k, v in one.items() if v.dtype.kind in "fc")


def _ints(one):
    return sorted(k for k, v in one.items() if v.dtype.kind in "biu")


def _hold(got, want, key):
    assert got.dtype == want.dtype and got.shape == want.shape, key
    if key == "einsum/ki":  # the bound is the product's, transposed
        bound = _bound("einsum/ik", got).T
    else:
        bound = _bound(key, got)
    err = np.abs(got.astype(np.complex128) - want.astype(np.complex128))
    assert np.all(err <= bound), (key, float(np.max(err - bound)))


@pytest.mark.parametrize("which", ["one", "ref"])
def test_integer_products_are_byte_equal(worlds, runs, which):
    res, _ = worlds["four"]
    want = runs[which]
    keys = _ints(runs["one"])
    assert len(keys) == 5
    for k in keys:
        assert res[k].dtype == want[k].dtype, k
        assert res[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("which", ["one", "ref"])
def test_floats_are_within_gamma_k(worlds, runs, which):
    res, _ = worlds["checker"]
    keys = _floats(runs["one"])
    assert len(keys) == 25
    for k in keys:
        _hold(res[k], runs[which][k], k)


def _ranks_of(ranks):
    grid = [int(r) for r in ranks.split(",")]
    return {(i, j): grid[2 * i + j] for i in range(2) for j in range(2)}


def _range(n, parts, i):
    c = -(-n // parts)
    return min(i * c, n), min((i + 1) * c, n)


def _span(n, parts, i):
    lo, hi = _range(n, parts, i)
    return hi - lo


def _want_bytes(program, world_ranks, rank):
    """What ``rank`` receives, written out from the blocks' ranges:

    * ``dd`` (output-stationary): for each result block (i, j) it holds,
      A's box (i, t) and B's box (t, j) of each K half t it holds at none
      of its positions, each box once;
    * ``cols_rows`` (split-K, replicated): the product of each K half
      whose A block it does not hold (M x N each);
    * ``mv`` (split-K): for each result block i it holds and each K half
      t, the product (M_i long) where it does not hold A's block (i, t),
      else v's half t where it holds no position (t, *), each half
      once."""
    M, K, N = (worker.DOT_EVEN if program == "dd_even" else
               (worker.DOT_M, worker.DOT_K, worker.DOT_N))
    own = [p for p, r in world_ranks.items() if r == rank]
    if program in ("dd", "dd_even"):
        boxes = set()
        for i, j in own:
            for t in range(2):
                if (i, t) not in own:
                    boxes.add(("A", i, t))
                if (t, j) not in own:
                    boxes.add(("B", t, j))
        return 8 * sum(_span(M, 2, i) * _span(K, 2, t) if w == "A" else
                       _span(K, 2, i) * _span(N, 2, t)
                       for w, i, t in boxes)
    if program == "cols_rows":
        rows = {i for i, _j in own}
        return 8 * M * N * sum(1 for t in range(2) if t not in rows)
    assert program == "mv"
    rows = {i for i, _j in own}
    got, halves = 0, set()
    for i in rows:
        for t in range(2):
            if (i, t) not in own:
                got += 8 * _span(M, 2, i)
            elif t not in rows:
                halves.add(t)
    return got + 8 * sum(_span(K, 2, t) for t in halves)


@pytest.mark.parametrize("program", ["dd", "dd_even", "cols_rows", "mv"])
def test_bytes_received_equal_the_formula(worlds, program):
    for name, (world, ranks) in WORLDS.items():
        _res, info = worlds[name]
        grid = _ranks_of(ranks)
        for r, rep in enumerate(info):
            assert rep["stats"][program]["bytes_received"] == _want_bytes(
                program, grid, r), (name, r, program)


def test_four_ranks_receive_a_quarter_of_each_operand(worlds):
    m, k, n = worker.DOT_EVEN
    _res, info = worlds["four"]
    for rep in info:
        st = rep["stats"]["dd_even"]
        assert st["bytes_received"] == (m * k + k * n) * 8 // 4
        # a quarter of the product's flops, in two K terms
        assert st["flops"] * 4 == 2 * m * k * n
        assert st["products"] == st["terms"] == 2


def test_split_k_folds_the_products_it_receives(worlds):
    _res, info = worlds["four"]
    for rep in info:
        st = rep["stats"]["cols_rows"]
        assert st["products"] == 1 and st["folds"] == 1, st
        assert rep["stats"]["mv"]["folds"] == 1


def _failing(tmp_path, world, fault, env=None):
    ranks = WORLDS["rows" if world == 2 else "four"][1]
    procs, outdir = _start(world, ranks, tmp_path, case="fail",
                           env=dict({"RAMBA_DOT_FAULT": fault,
                                     "RAMBA_RETRY_BASE_S": "0"}, **(env or {})))
    return _wait(procs, outdir, world)


@pytest.mark.parametrize("world", [2, 4])
def test_a_rank_failing_in_a_product_raises_on_every_rank(tmp_path, world):
    _res, info = _failing(tmp_path, world, "dot:product:always:rank=1")
    for r in info:
        assert r["error"] is not None, r
        assert r["gathered"] == 0, r


def test_a_transient_failure_is_retried_to_the_same_bytes(tmp_path, worlds):
    res, info = _failing(tmp_path, 4, "dot:product:once:rank=1")
    base, _ = worlds["one"]
    for rr, r in zip(res, info):
        assert r["error"] is None and r["gathered"] == 0, r
        assert rr["c"].tobytes() == base["dd/c"].tobytes()


@pytest.mark.parametrize("world", [2, 4])
def test_a_rank_stalled_in_a_contraction_raises_under_the_watchdog(
        tmp_path, world):
    ranks = WORLDS["rows" if world == 2 else "four"][1]
    procs, outdir = _start(
        world, ranks, tmp_path, case="stall",
        env={"RAMBA_DOT_FAULT": "dot:round:hang:ms=4000:after=1:rank=1",
             "RAMBA_WATCHDOG_S": "1", "RAMBA_COHERENCE_TIMEOUT_S": "3",
             "RAMBA_RETRY_BASE_S": "0"})
    _res, info = _wait(procs, outdir, world)
    for r in info:
        assert r["error"] in ("RankStallError", "GroupBrokenError"), r
        assert r["gathered"] == 0, r
        # the deadline (1 s) and the coherence rounds' (3 s) bound it,
        # well before the stall (4 s) or the group's timeout (60 s)
        assert r["seconds"] < 10, r
