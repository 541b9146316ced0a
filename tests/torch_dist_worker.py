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
logs).  On the card (``tests/test_torch_cuda.py``), ``card`` runs star2
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
     "observe": _observe}[mode](rt, rank, outdir)
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
