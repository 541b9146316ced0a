"""Trace-replay warm pool: ready tomorrow's kernels from yesterday's traffic.

Counterpart of ``ramba_tpu/compile/warmpool.py``.  A ``RAMBA_TRACE``
capture records one ``program`` event per flush, with the program's
fingerprint and compile class.  This module ranks the (fingerprint,
compile class) pairs by how often they appeared, re-weighted by the live
ledger's execution counts, loads the matching program skeletons from the
persistent cache (``compile/persist.py``) and submits one warm thunk per
program through ``CompilePipeline.submit_warm``.  The pipeline applies the
overload policy: under a yellow or red brownout warm work is the first
load shed (``serve.warm_shed``), and warm thunks take round-robin turns
with real traffic.

A warm thunk rebuilds the program from its skeleton, puts it in the
fuser's compile cache (``fuser._get_compiled``) and launches it once on
examples of the recorded signature made on the process device
(zero-filled tensors, the recorded scalars): the kernel library is built
or loaded from the cache and the kernel's plan made, so the process's
first real flush of the program builds nothing and plans nothing.  The launch is the program's first
call, filed in the ledger as a warm compile.
``scripts/warm_pool_torch.py`` is the CLI.
"""

from __future__ import annotations

import json
import time
from typing import Optional

from ramba_tpu_torch.compile import persist as _persist
from ramba_tpu_torch.observe import registry as _registry


def rank_trace(trace_path: str) -> list:
    """(fingerprint, compile class, count) of a trace's ``program``
    events, most frequent first; events without a fingerprint are
    skipped."""
    counts: dict = {}
    with open(trace_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                continue
            if ev.get("type") != "program":
                continue
            fp = ev.get("fingerprint")
            if not fp:
                continue
            key = (fp, _token(ev.get("compile_class")))
            counts[key] = counts.get(key, 0) + 1
    ranked = sorted(counts.items(), key=lambda it: (-it[1], it[0]))
    return [(fp, cls, n) for (fp, cls), n in ranked]


def _token(cls):
    if isinstance(cls, list):
        return tuple(cls)
    return cls


def _ledger_weight(fp: str) -> int:
    try:
        from ramba_tpu_torch.observe import ledger as _ledger

        k = _ledger.snapshot().get("kernels", {}).get(fp)
        if k:
            return int(k.get("exec", {}).get("count", 0))
    except Exception:  # noqa: BLE001
        pass
    return 0


def _make_thunk(fp: str, rec: dict):
    """A warm thunk: the skeleton's program through the fuser's compile
    cache, then one launch on its examples, waited for.  Raises
    when the rebuilt program does not reproduce its fingerprint (the
    ticket fails; nothing is cached under another key)."""

    def thunk():
        import torch

        from ramba_tpu_torch.core import fuser as _fuser
        from ramba_tpu_torch.parallel import mesh as _mesh

        # the process mesh first: a new mesh epoch empties the compile
        # cache, and a fresh process makes its default mesh at its first
        # array
        _mesh.get_mesh()
        program = _fuser._Program(rec["instrs"], rec["n_leaves"],
                                  rec["leaf_kinds"], rec["out_slots"])
        vals = _persist._example_vals(rec["sig"], rec.get("scalars"))
        cls = rec.get("compile_class")
        key = _fuser._cache_key(program, vals, cls)
        got = _fuser._ledger.fingerprint(key)
        if got != fp:
            raise RuntimeError(f"warm pool: skeleton {fp} rebuilds as {got}")
        fn, is_new, _fp, backend, via = _fuser._get_compiled(
            program, vals, compile_class=cls, key=key, fp=fp)
        outs = _fuser._execute_compiled(fn, program, vals, is_new, None, fp,
                                        backend, via)
        dev = _fuser._device_of(list(vals) + list(outs))
        if dev is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)

    return thunk


def warm(trace_path: str, top_k: int = 8,
         budget_s: Optional[float] = None, pipeline=None,
         wait: bool = True, timeout: float = 120.0) -> dict:
    """Replay a trace's top-K programs through ``submit_warm``.

    Capped at ``top_k`` programs and, optionally, ``budget_s`` seconds of
    submission; brownout-gated by the pipeline.  Returns a report;
    never raises for one warm-up that fails (a lost opportunity, not an
    error)."""
    report = {
        "considered": 0, "submitted": 0, "warmed": 0, "failed": 0,
        "shed": 0, "unresolved": 0, "budget_stop": 0, "seconds": 0.0,
    }
    ranked = rank_trace(trace_path)
    # prefer what the live ledger has been executing
    ranked.sort(key=lambda it: (-(_ledger_weight(it[0]) + it[2]), it[0]))
    if pipeline is None:
        from ramba_tpu_torch.serve import pipeline as _pipeline

        pipeline = _pipeline.get_pipeline()
    t0 = time.monotonic()
    shed_before = _registry.get("serve.warm_shed")
    tickets = []
    for fp, _cls, _n in ranked[: max(0, int(top_k))]:
        report["considered"] += 1
        if budget_s is not None and time.monotonic() - t0 > budget_s:
            report["budget_stop"] += 1
            break
        rec = _persist.load_program(fp)
        if rec is None:
            report["unresolved"] += 1
            continue
        tickets.append(pipeline.submit_warm(
            _make_thunk(fp, rec), label=f"warmpool:{fp}"))
        report["submitted"] += 1
        _registry.inc("compile.warmpool_submit")
    if wait:
        for t in tickets:
            try:
                t.wait(timeout=timeout)
            except Exception:  # noqa: BLE001 — count, don't raise
                report["failed"] += 1
            else:
                report["warmed"] += 1
    report["shed"] = _registry.get("serve.warm_shed") - shed_before
    report["seconds"] = round(time.monotonic() - t0, 4)
    return report
