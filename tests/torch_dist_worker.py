"""One rank of a ``ramba_tpu_torch`` process group on the CPU.

``tests/test_torch_distributed.py`` starts ``world`` copies of this file,
each with its rank, over a gloo group formed through a ``file://`` store:

    python tests/torch_dist_worker.py RANK WORLD STORE OUTDIR [MODE]

``MODE`` ``main`` (the default) runs every program of :func:`programs`
and writes each rank's results (``OUTDIR/rank<r>.npz``) and counters
(``OUTDIR/rank<r>.json``); ``fail`` makes rank 1 raise, once inside a
flush and once outside any collective, and records how rank 0 learned of
it; ``compile`` races the backends of one program on every rank (rank 1's
evidence skewed the other way) and buckets another, and records each
rank's latched decisions and class decisions; ``analyze`` runs the
static analyzer, the result memo and the plan cache across ranks (a
strict verifier error on every rank, memo hits per rank, certificate
hits agreed in batches); ``elastic`` the elastic plane (``_elastic``:
checkpoints saved and resumed in worlds of other sizes, a barrier that a
wedged or crashed rank never reaches, a live reshape of the rank mesh
and its fallback, a dispatch stall on one rank); ``observe`` the
attribution plane (each rank's stage signatures and sampled fence
logs); ``serve`` star2 flushes of a serve session on every rank through
the pipeline under a rank-skewed ``serve:admit`` fault (the shed set
each rank records, with its agreed epochs, and its blocks against the
same programs on the default stream); ``positions`` ranks that hold
several positions of a (2, 2) mesh (:func:`_positions`); ``select``
medians, quantiles and the last folds across those worlds
(:func:`_select`); ``dot`` matmul and the contractions across them
(:func:`_dot`); ``move`` slices, transposes, reshapes and the other
movement ops across them (:func:`_move`).  On the card
(``tests/test_torch_cuda.py``), ``card`` runs star2
through the CUDA stencil kernel on each rank's block and ``nccl`` one
rank's collectives over NCCL.  :func:`programs` takes the package as an argument, so the test runs
the same programs through ``ramba_tpu`` for the reference.

Imports only ``torch``, ``numpy`` and the port.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

import numpy as np


def star2_body(a):
    return (0.25 * (a[0, 1] + a[0, -1] + a[1, 0] + a[-1, 0])
            + 0.125 * (a[0, 2] + a[0, -2] + a[2, 0] + a[-2, 0]))


def star2_by_hand(h):
    c = slice(2, -2)
    return (0.25 * (h[c, 3:-1] + h[c, 1:-3] + h[3:-1, c] + h[1:-3, c])
            + 0.125 * (h[c, 4:] + h[c, :-4] + h[4:, c] + h[:-4, c]))


# results that are whole-array float sums (held within a bound, not
# exactly, against the reference), with their number of terms
SUMS = {"chain_sum": 1001, "chain_mean": 1001, "rerun": 1001,
        "base_sum": 1003,
        "axpy_sum": 1003, "sred": 1003, "ckpt_sum": 24 * 20}
# scans whose rank blocks run on the scan kernel: held within their
# rounding depth of ramba_tpu's odd/even scan (every prefix positive)
SCANS = {"scum": 1003}
# linspace keeps a divergence from ramba_tpu (XLA contracts its
# ``start * (1 - t) + stop * t`` into an FMA): held within one ulp of
# max(|start|, |stop|), and exactly against the port in one process
LINSPACE = (-2.0, 3.0, 1001)
# programs of the main path: no gathered flush allowed
MAIN_PATH = ("chain", "base", "star2_even", "star2_odd", "ints",
             "creation")
# layouts chosen and changed across ranks: no gathered flush allowed
LAYOUT_PATH = ("creation_dist", "reshard", "reshard_fault", "mixed",
               "groupby24", "groupby64", "axis_sums")
SUMS.update({"mixed_sum": 480})
# groupby results over the series of length SERIES_N: held exactly
# (min, max, count) or within a bound stated in the test
SERIES_N = 1003


def layout(rt, a) -> np.ndarray:
    """The layout of a realized array, as comparable text: per dim None,
    one mesh axis or a tuple of several, trailing Nones dropped."""
    sh = a.sharding if rt.__name__ == "ramba_tpu_torch" else \
        a._value().sharding
    out = []
    for e in tuple(getattr(sh, "spec", ())):
        names = () if e is None else (e,) if isinstance(e, str) else tuple(e)
        out.append(None if not names else names[0] if len(names) == 1
                   else names)
    while out and out[-1] is None:
        out.pop()
    return np.asarray(repr(tuple(out)))


def programs(rt, tmp):
    """``name -> fn``; ``fn()`` returns ``{key: numpy value}``.  The same
    calls run through ``ramba_tpu`` and the port."""
    rng = np.random.default_rng(12)
    base = rng.random(1003)
    grid_even = rng.random((24, 20))
    grid_odd = rng.random((23, 17))
    idx = rng.integers(0, 1003, 300)
    st = rt.stencil(star2_body)

    # (no product feeds a sum and no division by a constant: XLA's CPU
    # compiler contracts the one into an FMA and turns the other into a
    # product with the reciprocal, which the port, like NumPy, does not)
    def chain():
        a = rt.arange(1001) * 0.001
        d = (a + 1.0) * (a + 0.5)
        return {"d": np.asarray(d), "chain_sum": float(rt.sum(d)),
                "chain_mean": float(rt.mean(d)), "chain_min":
                float(rt.min(d)), "chain_max": float(rt.max(d)),
                "rerun": float(rt.sum(d))}

    def base_():
        x = rt.fromarray(base)
        y = rt.fromarray(base[::-1].copy())
        z = (x + y) * 2.5
        return {"z": np.asarray(z), "base_sum": float(rt.sum((x + 1.0) * x)),
                "axpy_sum": float(rt.sum(z))}

    def ints():
        a = rt.arange(1000, dtype=np.int32) * 3 - 7
        return {"a": np.asarray(a), "sum": int(rt.sum(a)),
                "min": int(rt.min(a)), "max": int(rt.max(a)),
                "prod": int(rt.prod(rt.arange(1, 15, dtype=np.int64)))}

    def creation():
        return {"lin": np.asarray(rt.linspace(*LINSPACE) * 1.0),
                "fill": np.asarray(rt.full((37, 29), 7.0) + 1.0),
                "ff": np.asarray(rt.fromfunction(
                    lambda i, j: i * 100 + j, (37, 29), dtype=np.int64) + 0),
                "ar": np.asarray(rt.arange(-5.0, 995.0) * 2.0)}

    def star2(grid, chained, iters):
        x = rt.fromarray(grid)
        y = x
        for _ in range(chained):
            y = rt.sstencil(st, y)
        return {"chained": np.asarray(y),
                "iterate": np.asarray(rt.sstencil_iterate(st, x, iters))}

    def spmd_halo1():
        n = 1001
        src = rt.arange(n, dtype=float)
        out = rt.zeros(n)

        def sweep(s_, d_):
            h = s_.halo(1)
            d_.set_local(h[:-2] + h[1:-1] + h[2:])

        rt.spmd(sweep, src, out)
        return {"out": np.asarray(out)}

    def spmd_halo2():
        x = rt.fromarray(grid_even)
        dst = rt.zeros(grid_even.shape)

        def kernel(src, out):
            out.set_local(star2_by_hand(src.halo(2)))

        rt.spmd(kernel, x, dst)
        return {"out": np.asarray(dst)[2:-2, 2:-2]}

    def scum():
        x = rt.fromarray(base)
        return {"scum": np.asarray(rt.scumulative(
            lambda v, c: v + c, lambda c, b: b + c, x))}

    def sred():
        red = rt.SreduceReducer(lambda a, b: a + b, lambda a, b: a + b)
        x = rt.fromarray(base)
        return {"sred": float(rt.sreduce(lambda v: v * v, red, 0.0, x))}

    def smaps():
        x = rt.fromarray(grid_odd)
        return {"smap": np.asarray(rt.smap(lambda v: v * 2.0 + 1.0, x)),
                "smap_index": np.asarray(rt.smap_index(
                    lambda i, v: v * 0.0 + i[0] * 100 + i[1], x))}

    def gathered():
        x = rt.fromarray(base)
        return {"sort": np.asarray(rt.sort(x)),
                "take": np.asarray(x[rt.fromarray(idx)])}

    def files():
        x = rt.fromarray(grid_odd)
        rt.save(os.path.join(tmp, "g.rtd"), x)
        rt.save(os.path.join(tmp, "g.npy"), x)
        return {"rtd": np.asarray(rt.load(os.path.join(tmp, "g.rtd"))),
                "npy": np.asarray(rt.load(os.path.join(tmp, "g.npy")))}

    def ckpt():
        g = rt.sstencil_iterate(st, rt.fromarray(grid_even), 2)
        back = {"grid": g, "step": 2}
        out = {}
        if rt.__name__ == "ramba_tpu_torch":
            # (ramba_tpu's Orbax restore of this tree does not run on its
            # virtual CPU mesh: its reference sweeps on without it)
            path = os.path.join(tmp, "ck")
            rt.checkpoint.save(path, back, force=True)
            side = rt.checkpoint._load_digests(os.path.abspath(path))
            out["sidecar"] = side["leaves"]["['grid']"]["sha256"]
            back = rt.checkpoint.restore(path)
        h = rt.sstencil_iterate(st, back["grid"], 2)
        return dict(out, grid=np.asarray(h), step=int(back["step"]),
                    ckpt_sum=float(rt.sum(h)))

    def split_axes():
        names = tuple(rt.get_mesh().axis_names)
        return names if len(names) > 1 else names[0]

    def creation_dist():
        k = rt.num_workers()
        rows = [[[i * 24 // k, 0], [(i + 1) * 24 // k, 20]] for i in range(k)]
        out = {"div_counts": np.asarray(rt.create_array_with_divisions(
                   (24, 20), (1, k)) + 2.0),
               "div_ranges": np.asarray(rt.create_array_with_divisions(
                   (24, 20), np.array(rows)) - 1.0),
               "ar": np.asarray(rt.arange(1000, distribution=(k,)) * 3),
               "lin": np.asarray(rt.linspace(*LINSPACE, distribution=(k,))
                                 * 1.0)}
        for i, d in enumerate(((k, 1), (1, k))):
            z = rt.zeros((24, 20), distribution=d) + 1.0
            out[f"zeros{i}"] = np.asarray(z)
            out[f"layout_zeros{i}"] = layout(rt, z)
            out[f"ones{i}"] = np.asarray(
                rt.ones((24, 20), dtype=np.int32, distribution=d) * 5)
            out[f"full{i}"] = np.asarray(
                rt.full((24, 20), 3.0, distribution=d) * 2.0)
            out[f"ff{i}"] = np.asarray(rt.fromfunction(
                lambda a, b: a * 100 + b, (24, 20), dtype=np.int64,
                distribution=d) + 0)
        return out

    def reshard():
        ax = split_axes()
        x = rt.fromarray(grid_even)
        rt.reshard(x, (ax,))
        out = {"row": np.asarray(x)}
        rt.reshard(x, (None, ax), max_stage_bytes=1 << 10)
        out["col"] = np.asarray(x)
        rt.reshard(x, (ax,), max_stage_bytes=1 << 10)
        out["back"] = np.asarray(x)
        out["stencil"] = np.asarray(rt.sstencil(st, x))
        return out

    def reshard_fault():
        ax = split_axes()
        x = rt.fromarray(grid_even * 3.0)  # even: ramba_tpu reshards no other
        out = {}
        if rt.__name__ == "ramba_tpu_torch":
            # every rank raises for a fault on the last rank alone
            from ramba_tpu_torch.parallel.reshard import ReshardError

            world = rt.distributed.process_count()
            rt.resilience.faults.configure(
                f"reshard:stage:after=1:rank={world - 1}")
            try:
                rt.reshard(x, (None, ax), max_stage_bytes=1 << 10)
                out["raised"] = np.asarray(False)
            except ReshardError:
                out["raised"] = np.asarray(True)
            finally:
                rt.resilience.faults.configure(None)
        out["intact"] = np.asarray(x)
        rt.reshard(x, (None, ax), max_stage_bytes=1 << 10)
        out["after"] = np.asarray(x)
        return out

    def mixed():
        k = rt.num_workers()
        x = rt.fromarray(grid_even, distribution=(k, 1))
        y = rt.fromarray(grid_even[::-1].copy(), distribution=(1, k))
        return {"z": np.asarray((x + y) * 2.5),
                "mixed_sum": float(rt.sum(x + y))}

    def groupby(G):
        x = rt.fromarray(base[:SERIES_N] + 0.5)
        g = x.groupby(0, np.arange(SERIES_N) % G, G)
        out = {kind: np.asarray(getattr(g, kind)()) for kind in (
            "sum", "prod", "min", "max", "count", "mean", "var")}
        if rt.__name__ == "ramba_tpu_torch":
            out["sum_rerun"] = np.asarray(g.sum())
        return out

    def axis_sums():
        k = rt.num_workers()
        x = rt.fromarray(grid_even)
        xc = rt.fromarray(grid_even, distribution=(1, k))
        xi = rt.fromarray((grid_even * 1000).astype(np.int32))
        res = {"ax0": rt.sum(x, axis=0), "ax1": rt.sum(x, axis=1),
               "kd0": rt.sum(x, axis=0, keepdims=True),
               "mean0": rt.mean(x, axis=0), "max1": rt.max(x, axis=1),
               "col_ax0": rt.sum(xc, axis=0), "col_ax1": rt.sum(xc, axis=1),
               "int_ax0": rt.sum(xi, axis=0)}
        out = {k: np.asarray(v) for k, v in res.items()}
        out.update({f"layout_{k}": layout(rt, v) for k, v in res.items()})
        return out

    return {"chain": chain, "base": base_, "ints": ints,
            "creation": creation,
            "star2_even": lambda: star2(grid_even, 3, 4),
            "star2_odd": lambda: star2(grid_odd, 2, 3),
            "spmd_halo1": spmd_halo1, "spmd_halo2": spmd_halo2,
            "scum": scum, "sred": sred, "smaps": smaps,
            "gathered": gathered,
            "files": files, "ckpt": ckpt,
            "creation_dist": creation_dist, "reshard": reshard,
            "reshard_fault": reshard_fault, "mixed": mixed,
            "groupby24": lambda: groupby(24), "groupby64": lambda: groupby(64),
            "axis_sums": axis_sums}


def _main(rt, rank, outdir):
    from ramba_tpu_torch import parallel
    from ramba_tpu_torch.core import fuser
    from ramba_tpu_torch.parallel import distributed

    results, gathered = {}, {}
    for name, fn in programs(rt, outdir).items():
        g0 = fuser.stats["gathered"]
        for k, v in fn().items():
            results[f"{name}/{k}"] = np.asarray(v)
        gathered[name] = fuser.stats["gathered"] - g0
    # a block and where it sits, for the layout check
    x = rt.fromarray(np.arange(23 * 17.0).reshape(23, 17))
    blocks = [{"position": list(s.position),
               "index": [[sl.start, sl.stop] for sl in s.index]}
              for s in x.addressable_shards]
    for i, s in enumerate(x.addressable_shards):
        results[f"block/{i}"] = s.data.numpy()
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **results)
    from ramba_tpu_torch.observe import registry

    info = {"gathered": gathered, "blocks": blocks,
            "in_driver": distributed.in_driver(),
            "backend": distributed.backend(),
            "reason": distributed.backend_reason(),
            "mesh": repr(rt.get_mesh()),
            "comm": {k: v for k, v in parallel.comm_stats.items()},
            "retries": registry.counters.get(
                "resilience.retries.init_connect", 0)}
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)


def _fail(rt, rank, outdir):
    """Rank 1 raises inside a flush (its smap kernel), then outside any
    collective; rank 0 records how each reached it."""
    seen = {}
    x = rt.fromarray(np.arange(400.0))
    armed = []

    def kernel(v):
        if armed:
            raise ValueError("rank 1's kernel fails")
        return v + 1.0

    y = rt.smap(kernel, x)
    if rank == 1:
        armed.append(True)  # after the node's dtype probe
    try:
        y.asarray()
        seen["flush"] = "no error"
    except Exception as e:  # recorded for the test
        seen["flush"] = f"{type(e).__name__}: {e}"
    if rank == 1:
        with open(os.path.join(outdir, "rank1.json"), "w") as f:
            json.dump(seen, f)
        # leaves the group without a word: no shutdown, no destructors
        # (a live gloo group torn down at exit may abort the process)
        os._exit(3)
    t0 = time.perf_counter()
    try:
        float(rt.sum(x))
        seen["collective"] = "no error"
    except Exception as e:  # recorded for the test
        seen["collective"] = f"{type(e).__name__}"
    seen["waited_s"] = time.perf_counter() - t0
    with open(os.path.join(outdir, "rank0.json"), "w") as f:
        json.dump(seen, f)


def _compile(rt, rank, outdir):
    """The race and the compile classes across ranks: every rank must
    latch rank 0's winner, even where its own samples say otherwise, and
    make the same class decisions."""
    from ramba_tpu_torch.compile import classes
    from ramba_tpu_torch.core import autotune
    from ramba_tpu_torch.observe import ledger
    from ramba_tpu_torch.resilience import coherence

    autotune.reconfigure(mode="race", k=2)
    classes.reset()
    # rank 0's evidence: the kernel wins; rank 1's: it loses by far
    real = ledger.backend_stats

    def skewed(fp):
        st = real(fp)
        if "kernel" in st:
            st["kernel"]["p50_s"] = 1e-9 if rank == 0 else 1e9
        return st

    ledger.backend_stats = skewed
    x = rt.fromarray(np.arange(1000.0))
    sums = [float(rt.sum(x * 2.0 + 1.0)) for _ in range(8)]
    # int16: the generic lowering's program, which buckets (a float one
    # is the kernels' and runs exact shapes)
    y = rt.fromarray(np.arange(200, dtype=np.int16))
    z = np.asarray(y * 3 - 1)
    info = {"decisions": {fp: d["backend"] for fp, d in
                          autotune.report()["decisions"].items()},
            "classes": {fp: None if t is None else list(t)
                        for fp, t in classes.decisions().items()},
            "rounds": coherence.last_epoch("autotune:winner"),
            "sums": sums}
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), z=z)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)


def _analyze(rt, rank, outdir):
    """RAMBA_VERIFY=strict, RAMBA_MEMO and RAMBA_PLANCERT across ranks:
    a hint naming a mesh axis no mesh has raises on every rank; a repeat
    of a program hits the memo on each rank (its local program) and the
    certificate of the whole program on every rank alike."""
    import torch

    from ramba_tpu_torch.core import memo, plancache
    from ramba_tpu_torch.core.expr import Node
    from ramba_tpu_torch.parallel import mesh as pmesh
    from ramba_tpu_torch.resilience import coherence

    info = {}
    x = rt.fromarray(np.arange(1000.0))
    other = pmesh.Mesh([torch.device("cpu")], ("bogus_axis",))
    bad = rt.ndarray(Node("shard_hint", (pmesh.NamedSharding(
        other, pmesh.P("bogus_axis")),), [x.read_expr()]))
    try:
        bad.asarray()
        info["strict"] = "no error"
    except Exception as e:  # recorded for the test
        info["strict"] = f"{type(e).__name__}: {e}"
    del bad
    info["sums"] = [float(rt.sum(x * 2.0 + 1.0)) for _ in range(5)]
    info["memo_hits"] = memo.cache.hits
    snap = plancache.snapshot()
    info["cert_hits"] = snap.get("hits", 0)
    info["agree_rounds"] = snap.get("agree_rounds", 0)
    info["rounds"] = coherence.last_epoch("plan:hits")
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)


LADDER_N = 3001        # axpy's vectors, float64
LADDER_GRID = (64, 48)  # star2's grid, float32


def ladder_inputs():
    x = np.sin(np.arange(LADDER_N) * 1e-3)
    y = np.cos(np.arange(LADDER_N) * 1e-3)
    g = np.random.default_rng(9).random(LADDER_GRID).astype(np.float32)
    return x, y, g


def ladder_reference():
    """The ladder mode's whole results in one process: the port on the
    CPU, every flush on its fused rung."""
    import ramba_tpu_torch as rt

    x, y, g = ladder_inputs()
    ax, ay = rt.fromarray(x), rt.fromarray(y)
    st = rt.stencil(star2_body)
    it = np.asarray(rt.sstencil_iterate(st, rt.fromarray(g), 3))
    return {"axpy": np.asarray(2.5 * ax + ay),
            "star2": np.asarray(rt.sstencil(st, rt.fromarray(g))),
            "iterate": it, "retried": it,
            "memo": np.asarray(3.0 * ax + ay),
            "after_fatal": float(np.sum(4.0 * x + y))}


def _ladder(rt, rank, outdir):
    """The coherent ladder across ranks: a healthy flush on fused; an
    ``oom`` on rank 1 alone (axpy, star2, its iterate), on a rank that
    holds data where another's block is empty, and on rank 0 where the
    other ranks' memo serves the flush: every rank drops to split in
    the same rounds; a fatal fault on rank 1 aborts every rank with one
    class, and the next flush runs.  A healthy flush checks the
    ``dispatch`` site once on every rank; a rank's own flush (under
    ``mesh.local_scope``) audited on rank 0 alone joins no round."""
    from ramba_tpu_torch.core import memo
    from ramba_tpu_torch.observe import events, registry
    from ramba_tpu_torch.parallel import mesh
    from ramba_tpu_torch.resilience import coherence, faults, integrity, retry

    def rung_of(fn):
        r0 = registry.get("resilience.degrade_recovered")
        v = fn()
        if registry.get("resilience.degrade_recovered") == r0:
            return v, "fused"
        ev = [e for e in events.last(80, type="degrade")
              if e.get("action") == "recovered"]
        return v, ev[-1]["rung"]

    x, y, g = ladder_inputs()
    ax, ay, ag = rt.fromarray(x), rt.fromarray(y), rt.fromarray(g)
    st = rt.stencil(star2_body)
    info, res, rungs = {}, {}, {}
    with faults.active("dispatch:delay:ms=0"):
        res["axpy"], rungs["healthy"] = rung_of(
            lambda: np.asarray(2.5 * ax + ay))
        info["dispatch_checks"] = faults.stats()["dispatch"]["calls"]
    with faults.active("oom:1:rank=1"):
        res["star2"], rungs["oom"] = rung_of(
            lambda: np.asarray(rt.sstencil(st, ag)))
    with faults.active("oom:1:rank=1"):
        res["iterate"], rungs["oom_iterate"] = rung_of(
            lambda: np.asarray(rt.sstencil_iterate(st, ag, 3)))
    # a transient fault on rank 1 before its halo exchange: every rank
    # retries the attempt in place, none waits in the exchange
    r0 = registry.get("resilience.retries.flush")
    with faults.active("dispatch:once:rank=1"):
        res["retried"], rungs["transient"] = rung_of(
            lambda: np.asarray(rt.sstencil_iterate(st, ag, 3)))
    info["retries"] = registry.get("resilience.retries.flush") - r0
    # a 1x1 array: one rank holds it, the others' blocks are empty
    with faults.active("oom:1:rank=0"):
        res["tiny"], rungs["tiny"] = rung_of(
            lambda: np.asarray(rt.ones((1, 1)) * 2.0 + 1.0))
    os.environ["RAMBA_MEMO"] = "1"
    try:
        np.asarray(3.0 * ax + ay)  # every rank caches its block's result
        if rank == 0:
            memo.reset()
        with faults.active("oom:1:rank=0"):
            res["memo"], rungs["memo"] = rung_of(
                lambda: np.asarray(3.0 * ax + ay))
        info["memo_hits"] = memo.cache.hits
        # rank 0's own flush, audited: its verdict is its own (the other
        # ranks run no flush here and would never enter a round)
        os.environ["RAMBA_AUDIT"] = "1"
        a0 = integrity.snapshot()["audits"]
        if rank == 0:
            with mesh.local_scope():
                res["local_audit"] = np.asarray(
                    rt.sum(rt.fromarray(x) * 5.0 + 1.0))
        info["audits"] = integrity.snapshot()["audits"] - a0
    finally:
        del os.environ["RAMBA_MEMO"]
        os.environ.pop("RAMBA_AUDIT", None)
        memo.reset()
    with faults.active("execute:once:fatal:rank=1"):
        try:
            np.asarray(4.0 * ax + ay)
            info["fatal_error"] = "no error"
        except Exception as e:  # recorded for the test
            info["fatal_error"] = f"{type(e).__name__}: {e}"
            info["fatal_class"] = retry.classify(e)
    info["after_fatal"] = float(rt.sum(4.0 * ax + ay))
    info["rungs"] = rungs
    info["epochs"] = coherence.epochs()
    info["degrade_steps"] = registry.get("resilience.degrade_steps")
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **res)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)


ELASTIC_GRID = (24, 20)
ELASTIC_SERIES = 1003


def elastic_state():
    """The elastic mode's arrays as NumPy: a float32 grid and a float64
    series, from a seed."""
    rng = np.random.default_rng(17)
    return (rng.random(ELASTIC_GRID).astype(np.float32),
            rng.random(ELASTIC_SERIES))


def _elastic(rt, rank, outdir):
    """The elastic plane across ranks; ``RAMBA_ELASTIC_CASE`` picks:

    * ``save``: checkpoint the grid, the series and a step (7) under
      ``RAMBA_ELASTIC_ROOT``;
    * ``resume``: resume the newest step into this world, write what came
      back, and save it again as step 8 (the next link of a chain);
    * ``wedged`` / ``crashed``: save step 1 on every rank, then the last
      rank stops arriving at step 2's barrier (it sleeps, or it exits);
      the others record what they raised, how long it took, and what a
      later collective on the group raised;
    * ``reshape``: a live reshape of the rank mesh (2, 2) -> (4, 1), a
      stencil sweep and a sum on the new mesh, then a ``reshard:stage``
      fault on the way back, which falls back to the checkpoint, and
      again with no manager given (a temporary root);
    * ``rung_stall``: rank 1's first ``dispatch`` check hangs past the
      watchdog's deadline during ``sum(2.5 * x + y)``;
    * ``one_read``: an unarmed flush, counting the threads it starts, its
      coherence rounds and its reads of the watchdog's and the rounds'
      deadline switches.
    """
    from ramba_tpu_torch.observe import events, registry
    from ramba_tpu_torch.parallel import distributed
    from ramba_tpu_torch.parallel import mesh as pm
    from ramba_tpu_torch.resilience import coherence, elastic, faults, retry

    case = os.environ["RAMBA_ELASTIC_CASE"]
    root = os.environ.get("RAMBA_ELASTIC_ROOT", os.path.join(outdir, "ck"))
    world = distributed.process_count()
    grid, series = elastic_state()
    res, info = {}, {"case": case, "world": world}

    def record():
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **res)
        with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
            json.dump(info, f)

    if case == "save":
        mgr = elastic.CheckpointManager(root, keep=2)
        g, x = rt.fromarray(grid), rt.fromarray(series)
        mgr.save(7, {"grid": g, "series": x, "step": 7})
        info["manifest"] = mgr.manifest(7)
    elif case == "resume":
        back = elastic.resume(root)
        st = back.state
        info["step"] = back.step
        info["from_processes"] = back.manifest["process_count"]
        info["layout"] = str(st["grid"].sharding.spec)
        res["grid"] = np.asarray(st["grid"])
        res["series"] = np.asarray(st["series"])
        res["step"] = np.asarray(st["step"])
        elastic.CheckpointManager(root, keep=2).save(
            back.step + 1, {"grid": st["grid"], "series": st["series"],
                            "step": back.step + 1})
    elif case in ("wedged", "crashed"):
        mgr = elastic.CheckpointManager(root, keep=2)
        g, x = rt.fromarray(grid), rt.fromarray(series)
        mgr.save(1, {"grid": g, "series": x, "step": 1})
        if rank == world - 1:
            if case == "wedged":
                time.sleep(float(os.environ["RAMBA_WATCHDOG_S"]) * 2.5)
            os._exit(3)  # gone without a word: no shutdown, no destructors
        t0 = time.monotonic()
        try:
            mgr.save(2, {"grid": g * 2.0, "series": x, "step": 2})
            info["stall"] = "no error"
        except Exception as e:  # recorded for the test
            info["stall"] = f"{type(e).__name__}: {e}"[:300]
            info["stall_class"] = retry.classify(e)
        info["stall_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        try:
            distributed.all_reduce_int(1)
            info["after"] = "no error"
        except Exception as e:  # recorded for the test
            info["after"] = f"{type(e).__name__}: {e}"[:300]
            info["after_class"] = retry.classify(e)
        info["after_s"] = time.monotonic() - t0
        info["broken"] = distributed.broken()
        info["valid_steps"] = mgr.valid_steps()
        record()
        # a collective may still be running on the barrier's helper
        # thread: leave without tearing the group down
        os._exit(0)
    elif case == "reshape":
        g, x = rt.fromarray(grid), rt.fromarray(series)
        st = rt.stencil(star2_body)
        np.asarray(g)
        info["before"] = str(g.sharding.spec)
        out = elastic.live_reshape(pm.rank_mesh((4, 1)))
        info["live"] = out
        info["after"] = str(g.sharding.spec)
        info["mesh"] = dict(rt.get_mesh().shape)
        res["grid_live"] = np.asarray(g)
        res["series_live"] = np.asarray(x)
        res["star2_live"] = np.asarray(rt.sstencil(st, g))
        info["sum_live"] = float(rt.sum(x))
        with faults.active("reshard:stage:always"):
            out = elastic.live_reshape(pm.rank_mesh((2, 2)),
                                       manager=os.path.join(outdir, "fb"))
        info["fallback"] = out
        info["after_fallback"] = str(g.sharding.spec)
        info["mesh_fallback"] = dict(rt.get_mesh().shape)
        res["grid_fallback"] = np.asarray(g)
        res["series_fallback"] = np.asarray(x)
        info["sum_fallback"] = float(rt.sum(x))
        # no manager: the checkpoint goes to a temporary root that every
        # rank names alike, deleted after the resume
        seen = []
        events.add_tap(seen.append)
        try:
            with faults.active("reshard:stage:always"):
                out = elastic.live_reshape(pm.rank_mesh((4, 1)))
        finally:
            events.remove_tap(seen.append)
        info["fallback_tmp"] = out
        saved = [e["path"] for e in seen
                 if e.get("phase") == "checkpoint_saved"]
        info["tmp_roots"] = [os.path.dirname(p) for p in saved]
        distributed.barrier("worker_tmp_gone")
        info["tmp_left"] = [os.path.exists(p) for p in info["tmp_roots"]]
        info["mesh_tmp"] = dict(rt.get_mesh().shape)
        res["grid_tmp"] = np.asarray(g)
        res["series_tmp"] = np.asarray(x)
    elif case == "one_read":
        # an unarmed rank flush: no thread, one read of the watchdog's
        # switch, its coherence rounds sharing one read of their deadline
        reads = {"watchdog": 0, "coherence": 0}
        wd, ct = elastic.watchdog_seconds, coherence._timeout_s

        def wd_counted():
            reads["watchdog"] += 1
            return wd()

        def ct_counted(*a):
            reads["coherence"] += 1
            return ct(*a)

        started = []
        start = threading.Thread.start

        def counted_start(self):
            started.append(self.name)
            return start(self)

        x = rt.fromarray(series)
        np.asarray(x)
        r0 = registry.get("coherence.rounds")
        elastic.watchdog_seconds, coherence._timeout_s = wd_counted, ct_counted
        threading.Thread.start = counted_start
        try:
            info["sum"] = float(rt.sum(x * 2.0 + 1.0))
        finally:
            elastic.watchdog_seconds, coherence._timeout_s = wd, ct
            threading.Thread.start = start
        info["rounds"] = registry.get("coherence.rounds") - r0
        info["reads"] = reads
        info["threads"] = started
    elif case == "rung_stall":
        x, y = rt.fromarray(series), rt.fromarray(series[::-1].copy())
        d0 = registry.get("resilience.degrade_steps")
        with faults.active("dispatch:hang:ms=2500:after=0:rank=1"):
            info["sum"] = float(rt.sum(2.5 * x + y))
        info["degrade_steps"] = registry.get("resilience.degrade_steps") - d0
        rec = [e for e in events.last(80, type="degrade")
               if e.get("action") == "recovered"]
        info["rung"] = rec[-1]["rung"] if rec else "fused"
        info["stalls"] = [e["site"] for e in events.last(20, type="stall")]
        info["epochs"] = coherence.epochs()
        time.sleep(2.0)  # the zombie wakes, and stops
        info["abandoned"] = registry.get("elastic.abandoned_commits")
        info["after"] = float(rt.sum(x))
        info["broken"] = distributed.broken()
    record()


CARD_GRID = (1024, 1024)
CARD_SERIES = (1 << 20) + 37
SEG_KINDS = ("sum", "min", "max", "count")


OBSERVE_GRID = (64, 48)  # star2's grid, float32: even blocks on 2 and 4
OBSERVE_N = 4000         # the 1-D chain, float64
OBSERVE_FLUSHES = 10


def _observe(rt, rank, outdir):
    """The attribution plane across ranks (run under
    ``RAMBA_ATTRIB=sample:<N>``): star2 sweeps with a sum and a 1-D chain
    with a sum, ``OBSERVE_FLUSHES`` flushes each; every rank records the
    stage names of each of its flush spans, its fence log per kernel
    fingerprint, the sums, and the observer tax."""
    from ramba_tpu_torch.observe import attrib, events, observer

    spans = []

    def tap(e):
        if e.get("type") == "flush":
            spans.append(e)

    events.add_tap(tap)
    g = rt.fromarray(np.random.RandomState(3).rand(
        *OBSERVE_GRID).astype(np.float32))
    x = rt.fromarray(np.sin(np.arange(OBSERVE_N, dtype=np.float64)))
    st = rt.stencil(star2_body)
    sums = []
    for k in range(OBSERVE_FLUSHES):
        sums.append(float(rt.sum(rt.sstencil(st, g))))
        sums.append(float(rt.sum(x * 2.0 + float(k))))
    events.remove_tap(tap)
    samp = attrib.sampling_report()
    info = {
        "sigs": [[k for k in attrib.STAGES if k in e.get("stages", {})]
                 for e in spans],
        "reconciled": all(
            abs(sum(e["stages"].values()) + e["unattributed_s"]
                - e["wall_s"]) <= 2e-5 * (len(e["stages"]) + 2)
            for e in spans),
        "fences": {fp: d["fenced_seqs"]
                   for fp, d in samp["fingerprints"].items()},
        "calls": {fp: d["calls"] for fp, d in samp["fingerprints"].items()},
        "sample_every": samp["sample_every"],
        "sources": [e.get("device_source") for e in spans],
        "sums": sums,
        "tax_frac": observer.tax_frac(),
    }
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)


SERVE_GRID = (24, 20)
SERVE_FLUSHES = 6


def _serve(rt, rank, outdir):
    """Star2 flushes of one serve session through the pipeline (run
    under ``RAMBA_FAULTS=serve:admit:3:rank=1``): each rank records which
    tickets were shed, why and on which ``serve:shed`` epoch, then reads
    every result (a shed one heals) and compares its block with the same
    program flushed on the default stream."""
    import hashlib

    from ramba_tpu_torch.resilience import faults
    from ramba_tpu_torch.serve import overload

    st = rt.stencil(star2_body)
    g = rt.fromarray(np.random.RandomState(3).rand(
        *SERVE_GRID).astype(np.float32))
    ys, tickets, shed = [], [], []
    with rt.serve.Session(tenant="ranked") as s:
        for k in range(SERVE_FLUSHES):
            ys.append(rt.sstencil(st, g) * float(k + 1))
            tickets.append(s.flush())
        for k, t in enumerate(tickets):
            try:
                t.wait(60)
            except overload.ShedError as e:
                shed.append([k, e.reason, e.epoch])
        blocks = [hashlib.sha256(y._block().numpy().tobytes()).hexdigest()
                  for y in ys]
    faults.configure(None)
    want = [hashlib.sha256((rt.sstencil(st, g) * float(k + 1))._block()
                           .numpy().tobytes()).hexdigest()
            for k in range(SERVE_FLUSHES)]
    info = {"shed": shed, "same_blocks": blocks == want,
            "blocks": blocks, "quarantined": s.stats["quarantined"]}
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)


# a rank holding several positions: the (2, 2) mesh's ranks in grid
# order, from RAMBA_POSITIONS_RANKS ("0,0,1,1", the checkerboard
# "0,1,1,0", "0,0,0,0" for one rank)
POSITIONS_GRID = (23, 19)
POSITIONS_SERIES = 203
POSITIONS_G = 5


def positions_inputs():
    """The positions mode's arrays as NumPy, from a seed: a float64 grid
    with NaNs, a float64 series with a large mean and NaNs, labels of the
    series and of the grid's rows, a complex series."""
    rng = np.random.default_rng(23)
    grid = rng.standard_normal(POSITIONS_GRID)
    grid_nan = grid.copy()
    grid_nan[rng.random(POSITIONS_GRID) < 0.1] = np.nan
    grid_nan[3, :] = np.nan  # an all-NaN row
    series = 1e8 + rng.standard_normal(POSITIONS_SERIES)
    series_nan = series.copy()
    series_nan[rng.random(POSITIONS_SERIES) < 0.1] = np.nan
    labels = rng.integers(0, POSITIONS_G, POSITIONS_SERIES)
    rows = rng.integers(0, POSITIONS_G, POSITIONS_GRID[0])
    cplx = rng.standard_normal(64) + 1j * rng.standard_normal(64)
    return grid, grid_nan, series, series_nan, labels, rows, cplx


def positions_programs(rt):
    """The programs every world of the positions mode runs (each a dict of
    results), ``rt`` either package on a one-device mesh for the
    reference (its folds only: the grid's stencils and groupby are held
    against NumPy where ramba_tpu is wrong)."""
    grid, grid_nan, series, series_nan, labels, rows, cplx = \
        positions_inputs()

    def stencils():
        st = rt.stencil(star2_body)
        out = {}
        for name, shape in (("even", (24, 20)), ("odd", POSITIONS_GRID)):
            x = rt.fromarray(grid[:shape[0], :shape[1]].copy()
                             if shape[0] <= grid.shape[0] else
                             np.resize(grid, shape))
            y = x
            for _ in range(3):
                y = rt.sstencil(st, y)
            out[f"{name}_chained"] = np.asarray(y)
            out[f"{name}_iterate"] = np.asarray(rt.sstencil_iterate(st, x, 4))
        return out

    def folds():
        x = rt.fromarray(grid_nan)
        g = rt.fromarray(grid)
        out = {}
        for fn in ("nansum", "nanprod", "nanmin", "nanmax", "nanmean"):
            out[fn] = np.asarray(getattr(rt, fn)(x))
            for ax in (0, 1):
                out[f"{fn}{ax}"] = np.asarray(getattr(rt, fn)(x, axis=ax))
        for fn in ("var", "std"):
            for ddof in (0, 1):
                out[f"{fn}_d{ddof}"] = np.asarray(getattr(rt, fn)(g, ddof=ddof))
                for ax in (0, 1):
                    out[f"{fn}{ax}_d{ddof}"] = np.asarray(
                        getattr(rt, fn)(g, axis=ax, ddof=ddof))
        for fn in ("argmin", "argmax"):
            out[fn] = np.asarray(getattr(rt, fn)(g))
            out[f"{fn}_nan"] = np.asarray(getattr(rt, fn)(x))
            for ax in (0, 1):
                out[f"{fn}{ax}"] = np.asarray(getattr(rt, fn)(g, axis=ax))
                out[f"{fn}{ax}_nan"] = np.asarray(getattr(rt, fn)(x, axis=ax))
        c = rt.fromarray(np.resize(cplx, (16, 12)))
        out["csum"] = np.asarray(rt.sum(c))
        out["cprod"] = np.asarray(rt.prod(c / 1.5))
        out["cmean"] = np.asarray(rt.mean(c))
        out["csum0"] = np.asarray(rt.sum(c, axis=0))
        return out

    def groupby():
        out = {}
        x = rt.fromarray(series)
        xn = rt.fromarray(series_nan)
        for kind in ("sum", "mean", "var", "std", "count"):
            out[f"s_{kind}"] = np.asarray(
                getattr(x.groupby(0, labels, POSITIONS_G), kind)())
        for kind in ("nansum", "nanmean", "nanvar", "nanstd"):
            out[f"n_{kind}"] = np.asarray(
                getattr(xn.groupby(0, labels, POSITIONS_G), kind)())
        g = rt.fromarray(grid)
        gn = rt.fromarray(grid_nan)
        for kind in ("sum", "max", "mean", "var"):
            out[f"g0_{kind}"] = np.asarray(
                getattr(g.groupby(0, rows, POSITIONS_G), kind)())
            out[f"g1_{kind}"] = np.asarray(
                getattr(g.groupby(1, rows[:POSITIONS_GRID[1]] % 3, 3),
                        kind)())
        for kind in ("nansum", "nanmean", "nanvar"):
            out[f"gn_{kind}"] = np.asarray(
                getattr(gn.groupby(0, rows, POSITIONS_G), kind)())
        return out

    def scans():
        g = rt.fromarray(grid)
        return {"scum0": np.asarray(rt.scumulative(
                    lambda v, c: v + c, lambda c, b: c + b, g, axis=0)),
                "scum1": np.asarray(rt.scumulative(
                    lambda v, c: v + c, lambda c, b: c + b, g, axis=1))}

    return {"stencils": stencils, "folds": folds, "groupby": groupby,
            "scans": scans}


def _positions(rt, rank, outdir):
    """A rank holding several positions of a (2, 2) mesh
    (``RAMBA_POSITIONS_RANKS``); ``RAMBA_POSITIONS_CASE``: ``main`` runs
    :func:`positions_programs`, spmd ``halo(1)`` and a reshard there and
    back, recording each program's gathered flushes and all-gathered
    bytes; ``save`` checkpoints the grid and the series under
    ``RAMBA_POSITIONS_ROOT``; ``resume`` reads the newest step back into
    this world, records it, and saves it again as the next step."""
    from ramba_tpu_torch import parallel
    from ramba_tpu_torch.core import fuser
    from ramba_tpu_torch.parallel import mesh as pm
    from ramba_tpu_torch.resilience import elastic

    ranks = [int(r) for r in os.environ["RAMBA_POSITIONS_RANKS"].split(",")]
    rt.set_mesh(pm.rank_mesh((2, 2), ranks=ranks))
    case = os.environ.get("RAMBA_POSITIONS_CASE", "main")
    root = os.environ.get("RAMBA_POSITIONS_ROOT", os.path.join(outdir, "ck"))
    grid, _gn, series, *_rest = positions_inputs()
    res, info = {}, {"gathered": {}, "allgather_bytes": {}}
    if case == "main":
        progs = positions_programs(rt)

        def spmd_halo():
            x = rt.fromarray(grid)
            dst = rt.zeros(grid.shape)

            def k(src, out):
                h = src.halo(1)
                out.set_local(h[1:-1, 2:] + h[1:-1, :-2] + h[2:, 1:-1]
                              + h[:-2, 1:-1])

            rt.spmd(k, x, dst)
            return {"halo1": np.asarray(dst)}

        def reshard():
            x = rt.fromarray(grid)
            rt.reshard(x, (None, ("d0", "d1")), max_stage_bytes=1 << 10)
            mid = np.asarray(x)
            info["reshard_spec"] = str(x.sharding.spec)
            rt.reshard(x, ("d0", "d1"))
            return {"mid": mid, "back": np.asarray(x),
                    "sum": np.asarray(rt.sum(x * 2.0))}

        progs.update({"spmd": spmd_halo, "reshard": reshard})
        for name, fn in progs.items():
            g0 = fuser.stats["gathered"]
            b0 = parallel.comm_stats["allgather_bytes"]
            for key, v in fn().items():
                res[f"{name}/{key}"] = np.asarray(v)
            info["gathered"][name] = fuser.stats["gathered"] - g0
            info["allgather_bytes"][name] = \
                parallel.comm_stats["allgather_bytes"] - b0
        x = rt.fromarray(grid)
        info["blocks"] = [[list(s.position), [[sl.start, sl.stop]
                                              for sl in s.index]]
                          for s in x.addressable_shards]
        info["held"] = [list(p) for p in rt.get_mesh().local_positions()]
    elif case == "save":
        mgr = elastic.CheckpointManager(root, keep=4)
        mgr.save(1, {"grid": rt.fromarray(grid), "series":
                     rt.fromarray(series), "step": 1})
    else:
        back = elastic.resume(root)
        st = back.state
        info["step"] = back.step
        info["from_processes"] = back.manifest["process_count"]
        res["grid"] = np.asarray(st["grid"])
        res["series"] = np.asarray(st["series"])
        res["sum"] = np.asarray(rt.sum(st["grid"] * 3.0))
        elastic.CheckpointManager(root, keep=4).save(
            back.step + 1, {"grid": st["grid"], "series": st["series"],
                            "step": back.step + 1})
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **res)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)


# order statistics across ranks (core/rankselect.py): the worlds of the
# positions mode, over its grid
SELECT_QS = (0.001, 0.25, 0.5, 0.75, 0.999)
SELECT_METHODS = ("lower", "higher", "midpoint", "nearest")
SELECT_DTYPES = ("int8", "uint8", "uint16", "uint32", "uint64", "int64",
                 "float16", "float32", "bool")


def select_inputs(shape=POSITIONS_GRID):
    """The select mode's arrays as NumPy, from a seed: the positions
    grid with NaNs (an all-NaN row), the grid in every dtype of the sweep
    (int64 and uint64 near their limits), signed zeros around the middle,
    complex values with NaN parts."""
    grid, grid_nan, *_r = positions_inputs()
    if shape != POSITIONS_GRID:
        rng = np.random.default_rng(29)
        grid = rng.standard_normal(shape)
        grid_nan = np.where(rng.random(shape) < 0.1, np.nan, grid)
        grid_nan[3, :] = np.nan
    rng = np.random.default_rng(31)
    out = {"f64": grid_nan, "g64": grid}
    ints = np.round(grid * 40)
    out["int8"] = np.clip(ints, -128, 127).astype(np.int8)
    for dt in ("uint8", "uint16", "uint32"):
        out[dt] = np.abs(ints).astype(dt)
    out["uint64"] = (np.uint64(2 ** 64 - 1)
                     - np.abs(ints).astype(np.uint64) * np.uint64(997))
    big = np.abs(ints).astype(np.int64) * 1009
    out["int64"] = np.where(grid > 0, np.int64(2 ** 63 - 1) - big,
                            np.int64(-2 ** 63) + big)
    out["float16"] = grid_nan.astype(np.float16)
    out["float32"] = grid_nan.astype(np.float32)
    out["bool"] = grid > 0.3
    z = np.where(rng.random(shape) < 0.5, -0.0, 0.0)
    r = rng.random(shape)
    z[r < 0.2] = -1.5
    z[r > 0.8] = 2.5
    out["zeros"] = z
    c = grid + 1j * np.roll(grid, 1, axis=1)
    c[np.round(grid * 7) == 3] = np.nan  # NaN real and imaginary parts
    c.imag[np.round(grid * 9) == -4] = np.nan
    c.real[np.round(grid * 11) == 5] = np.nan
    c.real[:, 4] = np.round(c.real[:, 4])  # ties on the real part
    out["c128"] = c
    out["c64"] = c.astype(np.complex64)
    out["c128full"] = grid + 1j * np.roll(grid, 1, axis=1)
    return out


def select_programs(rt, shape=POSITIONS_GRID):
    """The programs every world of the select mode runs (each a dict of
    NumPy results), ``rt`` either package (``ramba_tpu`` on a one-device
    mesh for the reference)."""
    d = select_inputs(shape)
    axes = (None, 0, 1)

    def key(a):
        return "w" if a is None else f"a{a}"

    def medians():
        out = {}
        x, g = rt.fromarray(d["f64"]), rt.fromarray(d["g64"])
        for a in axes:
            for src, nm in ((x, "nan"), (g, "full")):
                out[f"median_{nm}_{key(a)}"] = np.asarray(rt.median(src, axis=a))
                out[f"nanmedian_{nm}_{key(a)}"] = np.asarray(
                    rt.nanmedian(src, axis=a))
        out["median_keep"] = np.asarray(rt.median(g, axis=0, keepdims=True))
        out["nanmedian_keep"] = np.asarray(rt.nanmedian(x, keepdims=True))
        return out

    def quantiles():
        out = {}
        x, g = rt.fromarray(d["f64"]), rt.fromarray(d["g64"])
        qs = list(SELECT_QS)
        for a in axes:
            k = key(a)
            out[f"quantile_nan_{k}"] = np.asarray(rt.quantile(x, qs, axis=a))
            for m in ("linear",) + SELECT_METHODS:
                out[f"quantile_{m}_{k}"] = np.asarray(rt.quantile(
                    g, qs if m == "linear" else 0.5, axis=a, method=m))
                out[f"nanquantile_{m}_{k}"] = np.asarray(
                    rt.nanquantile(x, qs, axis=a, method=m))
                out[f"percentile_{m}_{k}"] = np.asarray(rt.percentile(
                    g, [1.0, 37.0, 99.0], axis=a, method=m))
                out[f"nanpercentile_{m}_{k}"] = np.asarray(
                    rt.nanpercentile(x, 37, axis=a, method=m))
        out["quantile_keep"] = np.asarray(
            rt.quantile(g, qs, axis=1, keepdims=True))
        out["nanquantile_keep"] = np.asarray(
            rt.nanquantile(x, 0.3, keepdims=True))
        return out

    def dtypes():
        out = {}
        for dt in SELECT_DTYPES:
            v = rt.fromarray(d[dt])
            out[f"{dt}_median_w"] = np.asarray(rt.median(v))
            out[f"{dt}_median_a0"] = np.asarray(rt.median(v, axis=0))
            out[f"{dt}_quantile_a1"] = np.asarray(
                rt.quantile(v, [0.25, 0.999], axis=1))
            out[f"{dt}_nanpercentile_a0"] = np.asarray(
                rt.nanpercentile(v, 37, axis=0, method="nearest"))
        z = rt.fromarray(d["zeros"])
        for a in axes:
            out[f"zeros_median_{key(a)}"] = np.asarray(rt.median(z, axis=a))
        out["zeros_nanmedian_a1"] = np.asarray(rt.nanmedian(z, axis=1))
        for a in (None, 1):
            for m in ("linear",) + SELECT_METHODS:
                out[f"zeros_quantile_{m}_{key(a)}"] = np.asarray(
                    rt.quantile(z, [0.3, 0.5, 0.7], axis=a, method=m))
        return out

    def folds():
        out = {}
        for dt in ("f64", "float32", "c128"):
            v = rt.fromarray(d[dt])
            for fn in ("nanvar", "nanstd"):
                for ddof in (0, 1):
                    for a in axes:
                        out[f"{dt}_{fn}_d{ddof}_{key(a)}"] = np.asarray(
                            getattr(rt, fn)(v, axis=a, ddof=ddof))
        for dt in ("f64", "int8", "uint64", "bool", "c128"):
            v = rt.fromarray(d[dt])
            for a in axes:
                out[f"{dt}_count_nonzero_{key(a)}"] = np.asarray(
                    rt.count_nonzero(v, axis=a))
        for dt in ("f64", "g64", "int8", "uint64", "float32"):
            v = rt.fromarray(d[dt])
            for a in axes:
                out[f"{dt}_ptp_{key(a)}"] = np.asarray(rt.ptp(v, axis=a))
        return out

    def complexes():
        out = {}
        for dt in ("c128", "c64", "c128full"):
            v = rt.fromarray(d[dt])
            for fn in ("min", "max", "ptp", "var", "std"):
                for a in axes:
                    out[f"{dt}_{fn}_{key(a)}"] = np.asarray(
                        getattr(rt, fn)(v, axis=a))
        out["c128_max_keep"] = np.asarray(rt.max(rt.fromarray(d["c128"]),
                                                 axis=0, keepdims=True))
        return out

    def local():
        # rows over all four positions: a reduction along axis 1 reads
        # whole slices in every block, so each block reduces its own
        out = {}
        x = rt.fromarray(d["f64"], distribution=(4, 1))
        g = rt.fromarray(d["g64"], distribution=(4, 1))
        c = rt.fromarray(d["c128"], distribution=(4, 1))
        qs = list(SELECT_QS)
        out["median_a1"] = np.asarray(rt.median(g, axis=1))
        out["nanmedian_a1"] = np.asarray(rt.nanmedian(x, axis=1))
        out["quantile_a1"] = np.asarray(rt.quantile(g, qs, axis=1))
        out["nanquantile_keep_a1"] = np.asarray(
            rt.nanquantile(x, qs, axis=1, keepdims=True))
        out["cmax_a1"] = np.asarray(rt.max(c, axis=1))
        out["cptp_a1"] = np.asarray(rt.ptp(c, axis=1))
        return out

    return {"medians": medians, "quantiles": quantiles, "dtypes": dtypes,
            "folds": folds, "complex": complexes, "local": local}


def _select(rt, rank, outdir):
    """The select mode (``RAMBA_POSITIONS_RANKS``: the (2, 2) mesh's
    ranks); ``RAMBA_SELECT_CASE``: ``main`` runs :func:`select_programs`,
    recording each program's gathered flushes, all-gathered bytes and
    selection rounds, the empty extents' errors, and a hint over a
    computed value of another layout (and one over a subtree that is not
    shard-local); ``sizes`` runs whole and axis selections at two sizes
    and records each one's all-gathered bytes and rounds; ``stall``
    stalls rank 1 inside a selection under the watchdog."""
    from ramba_tpu_torch import parallel
    from ramba_tpu_torch.core import fuser, rankselect
    from ramba_tpu_torch.parallel import distributed
    from ramba_tpu_torch.parallel import mesh as pm
    from ramba_tpu_torch.resilience import faults

    ranks = [int(r) for r in os.environ["RAMBA_POSITIONS_RANKS"].split(",")]
    rt.set_mesh(pm.rank_mesh((2, 2), ranks=ranks))
    case = os.environ.get("RAMBA_SELECT_CASE", "main")
    res, info = {}, {"gathered": {}, "allgather_bytes": {}, "rounds": {}}

    def record():
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **res)
        with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
            json.dump(info, f)

    def flushed(name, make):
        """``make()`` flushed alone: its gathered programs, all-gathered
        bytes and selection rounds recorded, then read back."""
        g0 = fuser.stats["gathered"]
        b0 = parallel.comm_stats.get("allgather_bytes", 0)
        r0 = rankselect.stats["rounds"]
        out = make()
        rt.sync()
        info["gathered"][name] = fuser.stats["gathered"] - g0
        info["allgather_bytes"][name] = \
            parallel.comm_stats.get("allgather_bytes", 0) - b0
        info["rounds"][name] = rankselect.stats["rounds"] - r0
        res[name] = np.asarray(out)

    if case == "stall":
        x = rt.fromarray(select_inputs()["g64"])
        rt.sync()
        t0 = time.monotonic()
        try:
            with faults.active("select:round:hang:ms=4000:after=5:rank=1"):
                float(rt.median(x))
            info["error"] = None
        except Exception as e:  # noqa: BLE001 - the class is the result
            info["error"] = type(e).__name__
        info["seconds"] = time.monotonic() - t0
        info["broken"] = distributed.broken() is not None
        record()
        os._exit(0)  # a helper thread may still wait in gloo
    if case == "sizes":
        for tag, shape in (("small", POSITIONS_GRID), ("large", (92, 76))):
            g = rt.fromarray(select_inputs(shape)["g64"])
            rt.sync()
            flushed(f"{tag}_median", lambda: rt.median(g))
            flushed(f"{tag}_quantile", lambda: rt.quantile(g, [0.25, 0.75]))
            flushed(f"{tag}_median_a0", lambda: rt.median(g, axis=0))
        record()
        return
    progs = select_programs(rt)
    for name, fn in progs.items():
        g0 = fuser.stats["gathered"]
        b0 = parallel.comm_stats.get("allgather_bytes", 0)
        r0 = rankselect.stats["rounds"]
        for k, v in fn().items():
            res[f"{name}/{k}"] = np.asarray(v)
        info["gathered"][name] = fuser.stats["gathered"] - g0
        info["allgather_bytes"][name] = \
            parallel.comm_stats.get("allgather_bytes", 0) - b0
        info["rounds"][name] = rankselect.stats["rounds"] - r0
    d = select_inputs()
    g = rt.fromarray(d["g64"])
    flushed("sel/median", lambda: rt.median(g))
    flushed("sel/quantile5", lambda: rt.quantile(g, list(SELECT_QS)))
    flushed("sel/nanvar", lambda: rt.nanvar(rt.fromarray(d["f64"])))
    # the empty extents raise at the call, from the shapes
    e = rt.fromarray(np.zeros((0, 5)))
    errs = {}
    for nm, fn in (("quantile", lambda: rt.quantile(e, 0.5, axis=0)),
                   ("ptp", lambda: rt.ptp(e, axis=0)),
                   ("cmax", lambda: rt.max(rt.fromarray(
                       np.zeros((0, 5), complex)), axis=0))):
        try:
            fn()
            errs[nm] = None
        except Exception as ex:  # noqa: BLE001 - the class is the result
            errs[nm] = type(ex).__name__
    res["empty/nanmedian"] = np.asarray(rt.nanmedian(e, axis=0))
    res["empty/nanquantile"] = np.asarray(rt.nanquantile(e, 0.5, axis=0))
    info["empty_errors"] = errs
    # a hint over a computed value: 2.5 x + 1 of x in rows, into columns
    x = rt.fromarray(d["g64"], distribution=(4, 1))
    y2 = rt.fromarray(d["g64"][::-1].copy(), distribution=(1, 4))
    rt.sync()
    info["hint_from"] = str(x.sharding.spec)
    s0 = dict(parallel.comm_stats)
    g0 = fuser.stats["gathered"]
    y = 2.5 * x + 1
    rt.add_constraint([y], 1)
    total = rt.sum(y + y2)
    rt.sync()
    info["hint_gathered"] = fuser.stats["gathered"] - g0
    info["hint_comm"] = {k: v - s0.get(k, 0)
                         for k, v in parallel.comm_stats.items()
                         if v != s0.get(k, 0)}
    info["hint_to"] = str(y.sharding.spec)
    res["hint/y"] = np.asarray(y)
    res["hint/sum"] = np.asarray(total)
    # a subtree that is not shard-local keeps its hint: gathered
    g0 = fuser.stats["gathered"]
    w = rt.fromarray(d["g64"], distribution=(4, 1))
    v = w[::-1] * 2.0
    rt.add_constraint([v], 1)
    res["hint/gathered_sum"] = np.asarray(rt.sum(v + y2))
    info["hint_not_local_gathered"] = fuser.stats["gathered"] - g0
    rt.clear_constraints()
    record()


# contractions across ranks (core/rankdot.py): the worlds of the positions
# mode, over uneven shapes
DOT_M, DOT_K, DOT_N = 23, 19, 17
DOT_EVEN = (24, 20, 16)
# the result layouts GSPMD gives (jax.jit(jnp.matmul) over a (2, 2) mesh):
# per program its operands' specs, as tuples of entries
DOT_LAYOUTS = {
    "dd": (("d0", "d1"), ("d0", "d1")),
    "rows": (("d0", None), ("d0", None)),
    "cols_rows": ((None, "d0"), ("d0", None)),
    "rows_cols": (("d0", None), (None, "d1")),
    "rows_rep": (("d0", None), ()),
    "cols_cols": ((None, "d1"), (None, "d1")),
    "mv": (("d0", "d1"), ("d0",)),
    "vm": (("d0",), ("d0", "d1")),
    "truncated": (("d0", None), (None, ("d1", "d0"))),
    # both free dims on d0: the larger operand (here B) keeps it
    "conflict": (("d0", None), (None, "d0")),
    "batched": (("d0", None, "d1"), ("d0", "d1", None)),
}
DOT_DTYPES = ("float32", "complex128", "int64", "uint8", "bool")


def dot_inputs():
    rng = np.random.default_rng(23)
    M, K, N = DOT_M, DOT_K, DOT_N
    d = {"A": rng.standard_normal((M, K)), "B": rng.standard_normal((K, N)),
         "At": rng.standard_normal((K, M)), "Bt": rng.standard_normal((N, K)),
         "E": rng.standard_normal((N, 13)), "D": rng.standard_normal((M, N)),
         "v": rng.standard_normal(K), "w": rng.standard_normal(M),
         "u": rng.standard_normal(K),
         "A3": rng.standard_normal((4, M, K)),
         "B3": rng.standard_normal((4, K, N))}
    m, k, n = DOT_EVEN
    d["Ae"], d["Be"] = rng.standard_normal((m, k)), rng.standard_normal((k, n))
    for dt in DOT_DTYPES:
        for nm, shape in (("A", (M, K)), ("B", (K, N))):
            if dt == "bool":
                x = rng.random(shape) < 0.3
            elif dt == "uint8":
                x = rng.integers(0, 256, shape).astype(np.uint8)
            elif dt == "int64":  # products and sums that wrap modulo 2**64
                x = rng.integers(-2 ** 62, 2 ** 62, shape, dtype=np.int64)
            elif dt == "complex128":
                x = rng.standard_normal(shape) + 1j * rng.standard_normal(
                    shape)
            else:
                x = rng.standard_normal(shape).astype(dt)
            d[f"{nm}_{dt}"] = x
    return d


def dot_programs(rt, put):
    """Every contraction program: ``put(x, spec)`` lays a host array out
    (a spec of the (2, 2) mesh's axes; in one process it is ignored).
    Each program returns ``{key: result}``."""
    d = dot_inputs()
    L = DOT_LAYOUTS

    def mm(name, x, y, fn=None):
        sa, sb = L[name]
        a, b = put(x, sa), put(y, sb)
        return (fn or rt.matmul)(a, b)

    progs = {name: (lambda name=name, x=x, y=y: {"c": mm(name, d[x], d[y])})
             for name, x, y in (("dd", "A", "B"), ("rows", "A", "B"),
                                ("cols_rows", "A", "B"),
                                ("rows_cols", "A", "B"),
                                ("rows_rep", "A", "B"),
                                ("cols_cols", "A", "B"), ("mv", "A", "v"),
                                ("vm", "w", "A"), ("truncated", "A", "B"),
                                ("conflict", "Bt", "At"),
                                ("batched", "A3", "B3"))}
    dd = L["dd"]
    progs["dd_even"] = lambda: {"c": put(d["Ae"], dd[0]) @ put(d["Be"], dd[1])}
    progs["einsum"] = lambda: {
        "ik": rt.einsum("ij,jk->ik", put(d["A"], dd[0]), put(d["B"], dd[1])),
        "ki": rt.einsum("ij,jk->ki", put(d["A"], dd[0]), put(d["B"], dd[1]))}
    progs["tensordot"] = lambda: {
        "axes1": rt.tensordot(put(d["A"], dd[0]), put(d["B"], dd[1]), axes=1),
        "at_b": rt.tensordot(put(d["At"], dd[0]), put(d["B"], dd[1]),
                             axes=((0,), (0,)))}
    progs["inner"] = lambda: {
        "mat": rt.inner(put(d["A"], dd[0]), put(d["Bt"], dd[1])),
        "vec": rt.inner(put(d["v"], ("d0",)), put(d["u"], ("d0",)))}
    progs["dot"] = lambda: {
        "mat": rt.dot(put(d["A"], dd[0]), put(d["B"], dd[1])),
        "vv": rt.dot(put(d["v"], ("d0",)), put(d["u"], ("d1",)))}
    # what lies above a product is shard-local; a computed operand runs
    # first; a product of a product
    progs["epilogue"] = lambda: {"sum": rt.sum(
        2.0 * (put(d["A"], dd[0]) @ put(d["B"], dd[1]))
        + put(d["D"], dd[0]))}
    progs["computed"] = lambda: {"c": (2.0 * put(d["A"], dd[0]) + 1.0)
                                 @ put(d["B"], dd[1])}
    progs["chain"] = lambda: {"c": (put(d["A"], dd[0]) @ put(d["B"], dd[1]))
                              @ put(d["E"], dd[1])}
    for dt in DOT_DTYPES:
        progs[f"dd_{dt}"] = (lambda dt=dt: {"c": put(d[f"A_{dt}"], dd[0])
                                            @ put(d[f"B_{dt}"], dd[1])})
    cr = L["cols_rows"]
    progs["cols_rows_int64"] = lambda: {
        "c": put(d["A_int64"], cr[0]) @ put(d["B_int64"], cr[1])}
    progs["mv_bool"] = lambda: {
        "c": put(d["A_bool"], ("d0", "d1")) @ put(d["A_bool"][0], ("d0",))}
    return progs


# what still takes the gathered lowering: per program, its operands
DOT_GATHERED = ("einsum3", "outer", "batch_split")


def dot_gathered(rt, put):
    d = dot_inputs()
    return {
        "einsum3": lambda: rt.einsum("ij,jk,kl->il", put(d["A"], ("d0", "d1")),
                                     put(d["B"], ("d0", "d1")),
                                     put(d["E"], ("d0", "d1"))),
        "outer": lambda: rt.outer(put(d["v"], ("d0",)), put(d["w"], ("d0",))),
        "batch_split": lambda: rt.matmul(put(d["A3"], ("d0",)),
                                         put(d["B3"], (None, "d0")))}


def _dot(rt, rank, outdir):
    """The dot mode (``RAMBA_POSITIONS_RANKS``: the (2, 2) mesh's ranks);
    ``RAMBA_DOT_CASE``: ``main`` runs :func:`dot_programs`, recording
    each program's gathered flushes, result layouts and the counters of
    ``rankdot.stats``, then :func:`dot_gathered`; ``fail`` runs ``dd``
    under ``RAMBA_DOT_FAULT`` and records what it raised (or its
    result); ``stall`` stalls rank 1 before a round under the
    watchdog."""
    from ramba_tpu_torch.core import fuser, rankdot
    from ramba_tpu_torch.parallel import distributed
    from ramba_tpu_torch.parallel import mesh as pm
    from ramba_tpu_torch.resilience import faults

    ranks = [int(r) for r in os.environ["RAMBA_POSITIONS_RANKS"].split(",")]
    rt.set_mesh(pm.rank_mesh((2, 2), ranks=ranks))
    case = os.environ.get("RAMBA_DOT_CASE", "main")
    res, info = {}, {"gathered": {}, "spec": {}, "stats": {}}

    def put(x, spec):
        return rt.fromarray(x, distribution=pm.P(*spec))

    def record():
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **res)
        with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
            json.dump(info, f)

    if case in ("fail", "stall"):
        d = dot_inputs()
        a, b = put(d["A"], ("d0", "d1")), put(d["B"], ("d0", "d1"))
        rt.sync()
        spec = os.environ["RAMBA_DOT_FAULT"]
        g0 = fuser.stats["gathered"]
        t0 = time.monotonic()
        try:
            with faults.active(spec):
                res["c"] = np.asarray(a @ b)
            info["error"] = None
        except Exception as e:  # noqa: BLE001 - the class is the result
            info["error"] = type(e).__name__
        info["seconds"] = time.monotonic() - t0
        info["gathered"] = fuser.stats["gathered"] - g0
        info["products"] = rankdot.stats["products"]
        record()
        if case == "stall":
            os._exit(0)  # a helper thread may still wait in gloo
        return
    for table, progs in (("main", dot_programs(rt, put)),
                         ("gathered", dot_gathered(rt, put))):
        for name, fn in progs.items():
            rt.sync()
            g0 = fuser.stats["gathered"]
            s0 = dict(rankdot.stats)
            out = fn()
            rt.sync()
            for k, v in (out.items() if isinstance(out, dict)
                         else [("c", out)]):
                res[f"{name}/{k}"] = np.asarray(v)
                sh = getattr(v, "sharding", None)
                info["spec"][f"{name}/{k}"] = None if not v.shape else \
                    list(pm.canonical(sh.spec))
            info["gathered"][name] = fuser.stats["gathered"] - g0
            info["stats"][name] = {k: rankdot.stats[k] - s0[k]
                                   for k in ("contractions", "products",
                                             "terms", "flops",
                                             "bytes_received", "folds")}
        info[f"{table}_programs"] = list(progs)
    # a hint over a product's result reshards it
    d = dot_inputs()
    g0 = fuser.stats["gathered"]
    c = put(d["A"], ("d0", "d1")) @ put(d["B"], ("d0", "d1"))
    rt.add_constraint([c], 1)
    res["hinted/c"] = np.asarray(c)
    info["hinted"] = {"spec": list(pm.canonical(c.sharding.spec)),
                      "gathered": fuser.stats["gathered"] - g0}
    rt.clear_constraints()
    info["held"] = [list(p) for p in rt.get_mesh().local_positions()]
    record()


# movements across ranks (core/rankmove.py): the worlds of the positions
# mode; an uneven grid and vector, an even grid and vector for GSPMD's
# layouts, a square grid for the Jacobi sweeps
MOVE_GRID = (23, 19)
MOVE_N = 257
MOVE_EVEN = (16, 16)
MOVE_EVEN_N = 256
MOVE_SQUARE = 24
MOVE_SWEEPS = 3
MOVE_DTYPES = ("bool", "int8", "uint64", "float16", "float32", "float64",
               "complex128")
DD = ("d0", "d1")
FLAT = (("d0", "d1"),)


def move_inputs():
    rng = np.random.default_rng(24)
    m, n = MOVE_GRID
    d = {"A": rng.standard_normal((m, n)), "A2": rng.standard_normal((m, n)),
         "C": rng.standard_normal((6, m, n)),
         "a": rng.standard_normal(MOVE_N),
         "E": rng.standard_normal(MOVE_EVEN),
         "E2": rng.standard_normal(MOVE_EVEN),
         "e": rng.standard_normal(MOVE_EVEN_N),
         "F": rng.standard_normal((MOVE_SQUARE, MOVE_SQUARE)),
         "P": rng.standard_normal((64, 4)),
         "idx": np.array([1, 5, 7, 200])}
    for dt in MOVE_DTYPES:
        if dt == "bool":
            x = rng.random((m, n)) < 0.5
        elif dt in ("int8", "uint64"):
            info = np.iinfo(dt)
            x = rng.integers(info.max - 100, info.max, (m, n), dtype=dt,
                             endpoint=True)
            x[::3] = rng.integers(info.min, info.min + 100, (len(x[::3]), n),
                                  dtype=dt, endpoint=True)
        elif dt == "complex128":
            x = (rng.standard_normal((m, n)) * 1e300
                 + 1j * rng.standard_normal((m, n)) * 1e-300)
            x[2, 3] = complex(np.nan, -0.0)
        else:
            big = np.finfo(dt).max
            x = (rng.standard_normal((m, n)) * (big / 8)).astype(dt)
            x[1, ::2] = -0.0
            x[4, 5], x[6, 7], x[8, 9] = np.nan, np.inf, -np.inf
            x[10, 1] = np.finfo(dt).smallest_subnormal
        d[f"x_{dt}"] = x
    return d


def move_programs(rt, put):
    """Every movement program: ``put(x, spec)`` lays a host array out (a
    spec of the (2, 2) mesh's axes; in one process it is ignored).  Each
    returns ``{key: result}``."""
    d = move_inputs()
    A = lambda: put(d["A"], DD)  # noqa: E731
    a = lambda: put(d["a"], FLAT)  # noqa: E731
    progs = {}

    def three(x):
        return x[2:] - 2.0 * x[1:-1] + x[:-2]
    progs["slice"] = lambda: {
        "inner": A()[1:-1, 2:], "neg": A()[::-2, 3], "ell": A()[..., None, 1:5],
        "last": A()[-1], "rev": A()[3:4, ::-1], "none": A()[None, :, 5],
        "step": A()[1::3, ::-4], "vec2": a()[::3], "vrev": a()[::-1],
        "three": three(a())}
    progs["split"] = lambda: dict(
        [(f"s{i}", v) for i, v in enumerate(rt.split(a()[:256], 4))]
        + [(f"as{i}", v) for i, v in enumerate(rt.array_split(A(), 3,
                                                              axis=1))]
        + [("diff0", rt.diff(A(), axis=0)), ("diff", rt.diff(a()))])

    def setitem():
        x = A()
        x[1:-1, 1:-1] = 0.25 * (x[:-2, 1:-1] + x[2:, 1:-1] + x[1:-1, :-2]
                                + x[1:-1, 2:])
        y = A()
        y[::-2, 3] = 7.0
        y[5] = a()[:19]
        y[2:6, None, 1:4] = a()[:3]
        y[-3:] = put(d["A2"], DD)[:3]
        z = A()
        t = z.T
        t[2:5] = -1.0
        w = A()
        r = w.reshape(-1)
        r[3:40] = 1.5
        return {"sweep": x, "writes": y, "through_t": z, "through_r": w}
    progs["setitem"] = setitem
    C = lambda: put(d["C"], ("d0", None, "d1"))  # noqa: E731
    progs["permute"] = lambda: {
        "T": A().T, "swap": rt.swapaxes(C(), 0, 2),
        "move": rt.moveaxis(C(), 0, -1), "roll": rt.rollaxis(C(), 2),
        "T_sum": A().T + put(d["A2"].T.copy(), ("d1", "d0"))}
    progs["reshape"] = lambda: {
        "ravel": A().ravel(), "flatten": A().flatten(),
        "rows": put(d["E"], ("d0",)).reshape(8, 32),
        "split": A().reshape(23, 1, 19), "merge": C().reshape(6 * 23, 19),
        "odd": A().reshape(19, 23), "expand": rt.expand_dims(A(), 1),
        "squeeze": rt.squeeze(A()[:, None]), "vec": a()[:256].reshape(16, 16)}
    progs["broadcast"] = lambda: {
        "to": rt.broadcast_to(put(d["A"][0], ("d1",)), (23, 19)),
        "to3": rt.broadcast_to(A(), (2, 23, 19)),
        "bmap": put(d["A"][:, 0], ("d0",))[:, None] - 2.0 * A()
        + put(d["A"][0], ("d1",))[None, :],
        "moved": put(d["A"][0], ("d0",))[None, :] * A(),
        "keep": A() - A().mean(axis=1, keepdims=True)}
    progs["flip"] = lambda: {
        "all": rt.flip(A()), "lr": rt.fliplr(A()), "ud": rt.flipud(A()),
        "rot": rt.rot90(A()), "rot2": rt.rot90(A(), 2), "vec": rt.flip(a())}
    progs["join"] = lambda: {
        "cat0": rt.concatenate([A(), put(d["A2"], DD)]),
        "cat1": rt.concatenate([A(), put(d["A2"], DD)], axis=1),
        "stack0": rt.stack([A(), put(d["A2"], DD)]),
        "stack2": rt.stack([A(), put(d["A2"], DD)], axis=2),
        "hstack": rt.hstack([A(), put(d["A2"], DD)]),
        "vstack": rt.vstack([a(), a()]),
        "roll": rt.roll(a(), 1), "roll2": rt.roll(A(), (2, -3), axis=(0, 1)),
        "rollflat": rt.roll(A(), 5)}
    progs["pad"] = lambda: {
        mode: rt.pad(A(), ((2, 3), (1, 4)), mode=mode)
        for mode in ("constant", "empty", "edge", "wrap", "reflect",
                     "symmetric")} | {
        "value": rt.pad(A(), 1, constant_values=-2.5),
        "vec": rt.pad(a(), (3, 0), mode="reflect")}
    progs["tri"] = lambda: {"tril": rt.tril(A(), 1), "triu": rt.triu(A(), -2),
                            "tril3": rt.tril(C(), 0)}
    def folds(x):
        return {"three": rt.sum(three(x) ** 2), "flip": rt.sum(x * rt.flip(x))}
    progs["folds"] = lambda: folds(a())
    # the programs whose received bytes have closed forms: an even vector
    progs["bytes_three"] = lambda: {"c": rt.sum(three(put(d["e"], FLAT))
                                                 ** 2)}
    progs["bytes_flip"] = lambda: (lambda x: {"c": rt.sum(x * rt.flip(x))})(
        put(d["e"], FLAT))

    def sweeps():
        f = put(d["F"], DD)
        u = put(np.zeros((MOVE_SQUARE, MOVE_SQUARE)), DD)
        for _ in range(MOVE_SWEEPS):
            u[1:-1, 1:-1] = 0.25 * (u[:-2, 1:-1] + u[2:, 1:-1]
                                    + u[1:-1, :-2] + u[1:-1, 2:]
                                    - f[1:-1, 1:-1])
        return {"u": u}
    progs["sweeps"] = sweeps

    def dtypes():
        out = {}
        for dt in MOVE_DTYPES:
            x = put(d[f"x_{dt}"], DD)
            out[f"{dt}_chain"] = rt.pad(x[::-1, 2:].T, 1)
            out[f"{dt}_cat"] = rt.concatenate([x[:, 3:], x[:, :3]], axis=1)
            out[f"{dt}_ravel"] = x.ravel()[5:300]
        # a join in NumPy's common dtype
        out["mixed_cat"] = rt.concatenate([put(d["x_bool"], DD),
                                           put(d["x_int8"], DD),
                                           put(d["x_float16"], DD)], axis=1)
        return out
    progs["dtypes"] = dtypes
    return progs


# the even programs whose layouts are held against GSPMD's: per key, the
# port's call on operands laid out by their specs (tests/test_torch_
# rankmove.py holds the same calls through jax.numpy)
MOVE_EVEN_PROGRAMS = {
    "slice4": (("E", DD),), "sliceoff": (("E", DD),),
    "stride": (("E", DD),), "stride_whole": (("E", DD),),
    "int": (("E", DD),), "newaxis": (("e", FLAT),), "revslice": (("E", DD),),
    "vec_three": (("e", FLAT),), "vec_step": (("e", FLAT),),
    "T": (("E", DD),), "ravel": (("E", DD),), "rows": (("E", ("d0",)),),
    "cols": (("E", (None, "d0")),), "vec_reshape": (("e", FLAT),),
    "vec_split2": (("e", FLAT),), "expand": (("E", DD),),
    "bcast": (("E", DD),), "bcast_vec": (("e16", ("d1",)),),
    "flip": (("E", DD),), "cat0": (("E", DD), ("E2", DD)),
    "cat1": (("E", DD), ("E2", DD)), "stack1": (("E", DD), ("E2", DD)),
    "pad": (("E", DD),), "pad_reflect": (("E", DD),), "roll": (("e", FLAT),),
    "tril": (("E", DD),), "jacobi": (("E", DD), ("E2", DD)),
    "bmap": (("e64", ("d0",)), ("C64", ("d0",))),
}


def move_even_call(np_or_rt, name, *x):
    """One even program through ``rt`` (the port, ``ramba_tpu``) or
    ``jax.numpy``: the same NumPy call."""
    m = np_or_rt
    if name == "slice4":
        return x[0][4:12]
    if name == "sliceoff":
        return x[0][1:-1, 2:-2]
    if name == "stride":
        return x[0][::2]
    if name == "stride_whole":
        return x[0][:, ::2]
    if name == "int":
        return x[0][3]
    if name == "newaxis":
        return x[0][:, None]
    if name == "revslice":
        return x[0][::-1, 2:14]
    if name == "vec_three":
        return x[0][4:] - 2.0 * x[0][2:-2] + x[0][:-4]
    if name == "vec_step":
        return x[0][1::2]
    if name == "T":
        return x[0].T
    if name in ("ravel", "cols"):
        return x[0].reshape(-1)
    if name == "rows":
        return x[0].reshape(8, 32)
    if name == "vec_reshape":
        return x[0].reshape(16, 16)
    if name == "vec_split2":
        return x[0].reshape(2, 128)
    if name == "expand":
        return x[0][None]
    if name == "bcast":
        return m.broadcast_to(x[0], (4, 16, 16))
    if name == "bcast_vec":
        return m.broadcast_to(x[0], (8, 16))
    if name == "flip":
        return m.flip(x[0])
    if name == "cat0":
        return m.concatenate([x[0], x[1]])
    if name == "cat1":
        return m.concatenate([x[0], x[1]], axis=1)
    if name == "stack1":
        return m.stack([x[0], x[1]], axis=1)
    if name == "pad":
        return m.pad(x[0], 1)
    if name == "pad_reflect":
        return m.pad(x[0], 2, mode="reflect")
    if name == "roll":
        return m.roll(x[0], 1)
    if name == "tril":
        return m.tril(x[0])
    if name == "jacobi":
        u, f = x
        return 0.25 * (u[:-2, 1:-1] + u[2:, 1:-1] + u[1:-1, :-2]
                       + u[1:-1, 2:] - f[1:-1, 1:-1])
    assert name == "bmap"
    return x[0][:, None] - 2.0 * x[1]


def move_even_inputs():
    d = move_inputs()
    rng = np.random.default_rng(25)
    return {"E": d["E"], "E2": d["E2"], "e": d["e"],
            "e16": rng.standard_normal(16), "e64": rng.standard_normal(64),
            "C64": rng.standard_normal((64, 8))}


# what still takes the gathered lowering, one program each
MOVE_GATHERED = ("adv", "scatter", "take", "repeat", "tile", "diag",
                 "cat_layouts", "pad_wide", "a_plus_at")


def move_gathered(rt, put):
    d = move_inputs()
    E = lambda: put(d["E"], DD)  # noqa: E731

    def scatter():
        x = E()
        x[[1, 2], 3] = 5.0
        return x
    return {
        "adv": lambda: E()[[1, 5, 7]],
        "scatter": scatter,
        "take": lambda: rt.take(put(d["a"], FLAT), d["idx"]),
        "repeat": lambda: rt.repeat(E(), 2, axis=0),
        "tile": lambda: rt.tile(E(), (2, 1)),
        "diag": lambda: rt.diag(E()),
        "cat_layouts": lambda: rt.concatenate([E(), put(d["E2"], ("d0",))]),
        "pad_wide": lambda: rt.pad(E(), 20),
        "a_plus_at": lambda: E() + E().T}


def move_models(rt, put):
    """The port's models across ranks: the Jacobi sweeps written with
    slices, their residual (``models/jacobi.residual``), one k-means
    iteration (``models/kmeans``)."""
    from ramba_tpu_torch.models import jacobi, kmeans

    d = move_inputs()
    f = put(d["F"], DD)
    u = np.asarray(move_programs(rt, put)["sweeps"]()["u"])
    res = jacobi.residual(put(u, DD), f)
    cent, labels = kmeans.kmeans(put(d["P"], DD), 3, iters=1, seed=0)
    return {"u": u, "residual": np.float64(res), "centroids": cent,
            "labels": labels}


def _move(rt, rank, outdir):
    """The move mode (``RAMBA_POSITIONS_RANKS``: the (2, 2) mesh's ranks);
    ``RAMBA_MOVE_CASE``: ``main`` runs :func:`move_programs`, the even
    programs, :func:`move_gathered` and :func:`move_models`, recording
    each program's gathered flushes, result layouts and the counters of
    ``rankmove.stats``; ``fail`` runs ``a[2:] + a[:-2]`` under
    ``RAMBA_MOVE_FAULT`` and records what it raised (or its result);
    ``stall`` stalls rank 1 before a round under the watchdog."""
    from ramba_tpu_torch.core import fuser, rankmove
    from ramba_tpu_torch.parallel import mesh as pm
    from ramba_tpu_torch.resilience import faults

    ranks = [int(r) for r in os.environ["RAMBA_POSITIONS_RANKS"].split(",")]
    rt.set_mesh(pm.rank_mesh((2, 2), ranks=ranks))
    case = os.environ.get("RAMBA_MOVE_CASE", "main")
    res, info = {}, {"gathered": {}, "spec": {}, "stats": {}}

    def put(x, spec):
        return rt.fromarray(x, distribution=pm.P(*spec))

    def record():
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **res)
        with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
            json.dump(info, f)

    if case in ("fail", "stall"):
        e = move_inputs()["e"]
        x = put(e, FLAT)
        rt.sync()
        g0 = fuser.stats["gathered"]
        t0 = time.monotonic()
        try:
            with faults.active(os.environ["RAMBA_MOVE_FAULT"]):
                res["c"] = np.asarray(x[2:] + x[:-2])
            info["error"] = None
        except Exception as err:  # noqa: BLE001 - the class is the result
            info["error"] = type(err).__name__
        info["seconds"] = time.monotonic() - t0
        info["gathered"] = fuser.stats["gathered"] - g0
        record()
        if case == "stall":
            os._exit(0)  # a helper thread may still wait in gloo
        return
    ev = move_even_inputs()
    even = {name: (lambda name=name, ops=ops: {"c": move_even_call(
        rt, name, *[put(ev[k], spec) for k, spec in ops])})
        for name, ops in MOVE_EVEN_PROGRAMS.items()}
    for table, progs in (("main", move_programs(rt, put)), ("even", even),
                         ("gathered", move_gathered(rt, put)),
                         ("models", {"models": lambda: move_models(rt,
                                                                   put)})):
        for name, fn in progs.items():
            rt.sync()
            g0 = fuser.stats["gathered"]
            s0 = dict(rankmove.stats)
            out = fn()
            rt.sync()
            key = name if table != "even" else f"even/{name}"
            for k, v in (out.items() if isinstance(out, dict)
                         else [("c", out)]):
                if getattr(v, "_base", None) is not None:
                    v = v.copy()  # a view's own layout: its value realized
                res[f"{key}/{k}"] = np.asarray(v)
                sh = getattr(v, "sharding", None)
                info["spec"][f"{key}/{k}"] = None if sh is None or \
                    not v.shape else list(pm.canonical(sh.spec))
            info["gathered"][key] = fuser.stats["gathered"] - g0
            info["stats"][key] = {k: rankmove.stats[k] - s0[k]
                                  for k in rankmove.stats}
        info[f"{table}_programs"] = list(progs)
    info["held"] = [list(p) for p in rt.get_mesh().local_positions()]
    record()


def card_grid():
    return np.random.default_rng(5).random(CARD_GRID).astype(np.float32)


def card_series():
    """A series and its hour-of-day labels (24 groups)."""
    return (np.random.default_rng(6).random(CARD_SERIES),
            np.arange(CARD_SERIES) % 24)


def _card(rt, rank, outdir):
    """On the card: star2 on this rank's block through the CUDA stencil
    kernel (3 chained sweeps and 5 iterated), the chain's sum on
    elemred, groupby sum/min/max/count on segred over the rank's block of
    a series, and the counters that show it."""
    from ramba_tpu_torch import parallel
    from ramba_tpu_torch.core import fuser
    from ramba_tpu_torch.ops import elemred, stencil_kernel
    from ramba_tpu_torch.parallel import distributed

    st = rt.stencil(star2_body)
    x = rt.fromarray(card_grid())
    s0, e0 = stencil_kernel.launches, elemred.launches
    y = x
    for _ in range(3):
        y = rt.sstencil(st, y)
    yi = rt.sstencil_iterate(st, x, 5)
    rt.sync()
    launches = stencil_kernel.launches - s0
    a = rt.arange(1 << 20) * 0.001
    rt.sync()  # materialised: elemred takes vector leaves
    total = float(rt.sum((a + 1.0) * (a + 0.5)))
    # groupby on each rank's block: one segred launch a rank per kind
    from ramba_tpu_torch.ops import segred

    data, labels = card_series()
    g = rt.fromarray(data).groupby(0, labels, 24)
    groups, seg = {}, {}
    for kind in SEG_KINDS:
        g0 = segred.launches
        groups[kind] = np.asarray(getattr(g, kind)())
        seg[kind] = segred.launches - g0
    info = {"stencil_launches": launches, "backend": distributed.backend(),
            "elemred_launches": elemred.launches - e0, "sum": total,
            "segred_launches": seg, "gathered": fuser.stats["gathered"],
            "comm": dict(parallel.comm_stats)}
    np.savez(os.path.join(outdir, f"rank{rank}.npz"),
             chained=np.asarray(y), iterate=np.asarray(yi),
             **{f"gb_{k}": v for k, v in groups.items()})
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)


def _nccl(rt, rank, outdir):
    """One rank over NCCL on the card: all-gather, all-reduce, barrier
    and the chain's sum through the mesh of that one rank."""
    from ramba_tpu_torch.core import fuser
    from ramba_tpu_torch.parallel import distributed

    import torch

    g = distributed.all_gather_small(torch.arange(4.0, device="cuda"))
    r = distributed.all_reduce_int(7, "max")
    distributed.barrier("nccl")
    a = rt.arange(1 << 20) * 0.001
    rt.sync()
    total = float(rt.sum((a + 1.0) * (a + 0.5)))
    info = {"backend": distributed.backend(), "gathered_ok":
            bool(torch.equal(g[0], torch.arange(4.0, device="cuda"))),
            "reduced": r, "sum": total, "gathered": fuser.stats["gathered"],
            "mesh": repr(rt.get_mesh())}
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)


def main(argv) -> int:
    rank, world, store, outdir = int(argv[0]), int(argv[1]), argv[2], argv[3]
    mode = argv[4] if len(argv) > 4 else "main"
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch

    torch.set_num_threads(1)
    import ramba_tpu_torch as rt
    from ramba_tpu_torch.parallel import distributed

    distributed.initialize("file://" + store, world, rank,
                           backend="nccl" if mode == "nccl" else None)
    if world == 1:  # one rank: a mesh of ranks all the same
        rt.set_mesh(distributed.global_mesh())
    {"main": _main, "fail": _fail, "card": _card, "nccl": _nccl,
     "compile": _compile, "analyze": _analyze,
     "ladder": _ladder, "elastic": _elastic,
     "observe": _observe, "serve": _serve,
     "positions": _positions, "select": _select,
     "dot": _dot, "move": _move}[mode](rt, rank, outdir)
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
