"""Backend selection for fused programs, by measurement.

Counterpart of ``ramba_tpu/core/autotune.py``.  ``core/fuser.py::
_get_compiled`` asks :func:`select` which lowering serves a program
fingerprint:

* ``"kernel"`` — the hand-written kernels (``ops/kernel_backend.py``);
* ``"torch"`` — the generic lowering (``fuser._build_callable``).

Modes (``RAMBA_AUTOTUNE``):

* unset/``off`` — every program the classifier accepts goes to the
  kernels, the rest to the generic lowering (via ``default``);
* ``race`` (or ``1``/``on``) — the first executions of a program the
  classifier accepts alternate between the two, each sample landing in
  that backend's slice of the cost ledger (``observe/ledger.py``).  Once
  both hold ``RAMBA_AUTOTUNE_K`` (default 3) samples, the lower p50 is
  latched for the fingerprint (``autotune.latched``);
* ``force:kernel`` / ``force:torch`` — pin every program the classifier
  accepts to one backend (A/B runs).

An unknown mode raises rather than quietly meaning something else.
Latched decisions persist to ``RAMBA_AUTOTUNE_CACHE`` (a JSON table,
written atomically), so a later process skips the race: its selections
come from the table (``autotune.race_skipped``, once per fingerprint),
where a fresh race counts ``autotune.race_started``.  Across ranks every
rank latches rank 0's winner (:func:`_agree_winner`).

The race pre-warm (:func:`maybe_prewarm`, the reference's): under
``race`` with a live serve pipeline, in one process, a flush whose
kernel libraries this process has not loaded yet is served on the
generic lowering while one warm ticket (``submit_warm``) builds or loads
the libraries and launches the kernel once on zero-filled examples.  The
route is named in the flush's span (``prewarm``: the fingerprint, beside
the call's ``torch`` backend) and counted (``autotune.prewarm_served``).
The first flush after the ticket ends launches the kernel; a ticket that
failed (a :class:`_build.KernelBuildError`) raises from that flush.  It
is the only route off a hand kernel the port has.

Two deliberate differences from ramba_tpu:

* race samples are device times: on the card the fuser times a racing
  call with CUDA events, since the wall of an asynchronous launch would
  pick whichever backend returns to the host first;
* there is no degrade after a failure: a kernel that fails to build or
  launch during a race raises, like any launch in the port.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Optional

from ramba_tpu_torch.observe import ledger as _ledger
from ramba_tpu_torch.observe import registry as _registry

KERNEL = "kernel"
TORCH = "torch"
BACKENDS = (KERNEL, TORCH)

_lock = threading.RLock()

# fingerprint -> {"backend": str, "via": str}; "via" in
# autotune|persisted (only latched decisions are stored)
_decisions: "dict[str, dict]" = {}
# fingerprints whose race started in this process
_started: "set[str]" = set()
# fingerprints served from the persisted table in this process
_skipped: "set[str]" = set()
# fingerprint -> the warm ticket building its kernel libraries
_prewarm: dict = {}

_mode = "off"        # off | race | force
_forced: Optional[str] = None
_k = 3
_cache_path: Optional[str] = None
_table_loaded = False
# bumped on every decision-table change: a cached verdict is only as
# fresh as the table it read
_generation = 0


def generation() -> int:
    """Decision-table generation: increments whenever a fingerprint's
    backend decision could have changed."""
    return _generation


def _bump_generation_locked() -> None:
    global _generation
    _generation += 1


def _clear_locked() -> None:
    global _table_loaded
    _decisions.clear()
    _started.clear()
    _skipped.clear()
    _prewarm.clear()
    _table_loaded = False
    _bump_generation_locked()


def reconfigure(*, mode: Optional[str] = None,
                cache_path: Optional[str] = None,
                k: Optional[int] = None) -> None:
    """Reload configuration from the environment (keyword overrides for
    tests) and clear the in-memory decisions; the persisted table is
    re-read lazily.  An unknown mode raises."""
    global _mode, _forced, _k, _cache_path
    raw = os.environ.get("RAMBA_AUTOTUNE", "") if mode is None else mode
    raw = (raw or "").strip().lower()
    if raw in ("", "0", "off", "false", "no"):
        new_mode, new_forced = "off", None
    elif raw in ("race", "1", "on", "true", "yes"):
        new_mode, new_forced = "race", None
    elif raw.startswith("force:") and raw.split(":", 1)[1] in BACKENDS:
        new_mode, new_forced = "force", raw.split(":", 1)[1]
    else:
        raise ValueError(
            f"RAMBA_AUTOTUNE={raw!r}: the port knows 'off', 'race' (or "
            "'1'/'on'), 'force:kernel' and 'force:torch'")
    with _lock:
        _mode, _forced = new_mode, new_forced
        try:
            _k = max(1, int(os.environ.get("RAMBA_AUTOTUNE_K", "3") or 3)
                     if k is None else int(k))
        except ValueError:
            _k = 3
        _cache_path = os.environ.get("RAMBA_AUTOTUNE_CACHE") \
            if cache_path is None else cache_path
        _clear_locked()


def reset() -> None:
    """Drop every decision and race state (tests); keeps configuration."""
    with _lock:
        _clear_locked()


def mode() -> str:
    return _mode


def active() -> bool:
    return _mode != "off"


# ---------------------------------------------------------------------------
# persisted decision table
# ---------------------------------------------------------------------------


def _load_table_locked() -> None:
    global _table_loaded
    if _table_loaded:
        return
    _table_loaded = True
    if not _cache_path:
        return
    try:
        with open(_cache_path) as f:
            table = json.load(f)
    except (OSError, ValueError):
        return
    if not isinstance(table, dict):
        return
    n = 0
    for fp, row in table.get("decisions", {}).items():
        b = row.get("backend") if isinstance(row, dict) else None
        if b in BACKENDS and fp not in _decisions:
            _decisions[fp] = {"backend": b, "via": "persisted"}
            n += 1
    if n:
        _registry.inc("autotune.table_loaded_decisions", n)
        _bump_generation_locked()


def _persist_table_locked() -> None:
    if not _cache_path:
        return
    table = {
        "version": 1,
        "decisions": {fp: {"backend": d["backend"], "via": d["via"]}
                      for fp, d in _decisions.items()},
    }
    try:
        d = os.path.dirname(os.path.abspath(_cache_path)) or "."
        fd, tmp = tempfile.mkstemp(prefix=".autotune-", dir=d)
        with os.fdopen(fd, "w") as f:
            json.dump(table, f, indent=0, sort_keys=True)
        os.replace(tmp, _cache_path)
    except OSError:
        pass


# ---------------------------------------------------------------------------
# selection
# ---------------------------------------------------------------------------


def _agree_winner(winner: str) -> str:
    """Every rank latches the same backend: rank 0's measured winner,
    through one coherence round (``reduce="bcast"``).  Race counts
    advance in lockstep, so all ranks reach the latch on the same
    dispatch."""
    from ramba_tpu_torch.resilience import coherence as _coherence

    if not _coherence.engaged():
        return winner
    v = _coherence.agree("autotune:winner",
                         1 if winner == KERNEL else 0, reduce="bcast")
    return KERNEL if v else TORCH


def _supports(program, leaf_vals) -> bool:
    from ramba_tpu_torch.ops import kernel_backend

    return kernel_backend.supports(program, leaf_vals)


def select(fp: str, program, leaf_vals) -> tuple:
    """Backend for this dispatch: ``(backend, via)``.

    ``via`` is ``default`` (autotune off, or a program the classifier
    turns away), ``forced``, ``racing`` (still alternating), ``autotune``
    (latched by a race in this process) or ``persisted`` (latched by the
    decision table)."""
    if _mode == "off":
        return (KERNEL if _supports(program, leaf_vals) else TORCH,
                "default")
    with _lock:
        _load_table_locked()
        d = _decisions.get(fp)
        if d is not None:
            if d["via"] == "persisted" and fp not in _skipped:
                _skipped.add(fp)
                _registry.inc("autotune.race_skipped")
            return d["backend"], d["via"]
    if not _supports(program, leaf_vals):
        return TORCH, "default"
    if _mode == "force":
        return _forced, "forced"

    # race: alternate until each backend holds K samples, then latch the
    # lower p50
    stats = _ledger.backend_stats(fp)
    counts = {b: (stats.get(b) or {}).get("count", 0) for b in BACKENDS}
    with _lock:
        d = _decisions.get(fp)  # latched concurrently?
        if d is not None:
            return d["backend"], d["via"]
        if fp not in _started:
            _started.add(fp)
            _registry.inc("autotune.race_started")
        if counts[TORCH] >= _k and counts[KERNEL] >= _k:
            p50 = {b: (stats.get(b) or {}).get("p50_s") for b in BACKENDS}
            winner = KERNEL if (p50[KERNEL] or float("inf")) < \
                (p50[TORCH] or float("inf")) else TORCH
            winner = _agree_winner(winner)
            _decisions[fp] = {"backend": winner, "via": "autotune"}
            _bump_generation_locked()
            _registry.inc("autotune.latched")
            _registry.gauge("autotune.decisions", float(len(_decisions)))
            _persist_table_locked()
            return winner, "autotune"
    # toward the backend with fewer samples, the kernel first
    return (KERNEL, "racing") if counts[KERNEL] <= counts[TORCH] \
        else (TORCH, "racing")


def maybe_prewarm(fp: str, program, leaf_vals) -> bool:
    """True when this flush of a racing kernel program is to be served on
    the generic lowering because its kernel libraries are still being
    built through the serve pipeline (submitted here on the first such
    flush).  False when the race is off, no pipeline is live, the job has
    several processes, the libraries are loaded, or the warm ticket has
    ended; a ticket that failed raises its error here, once."""
    if _mode != "race":
        return False
    try:
        from ramba_tpu_torch.serve import pipeline as _pipeline

        pipe = _pipeline.current_pipeline()
    except Exception:  # noqa: BLE001
        return False
    if pipe is None:
        return False
    from ramba_tpu_torch.observe import events as _events

    if _events.rank_info()[1] != 1:
        return False
    with _lock:
        ticket = _prewarm.get(fp)
    if ticket is not None:
        if not ticket.done:
            return True
        with _lock:
            _prewarm.pop(fp, None)
        if ticket.exception is not None:
            raise ticket.exception
        return False
    from ramba_tpu_torch import _build
    from ramba_tpu_torch.ops import kernel_backend

    libs = kernel_backend.libraries(program, leaf_vals)
    if all(_build.loaded(src) for _name, src in libs):
        return False
    from ramba_tpu_torch.compile import persist as _persist

    sig = _persist.aval_sig(leaf_vals)
    if sig is None:
        return False
    scalars = _persist.scalars_of(leaf_vals)

    def warm():
        import torch

        from ramba_tpu_torch.core import fuser as _fuser

        vals = _persist._example_vals(sig, scalars)
        fn, is_new, _fp, backend, via = _fuser._get_compiled(
            program, vals, backend=KERNEL)
        outs = _fuser._execute_compiled(fn, program, vals, is_new, None,
                                        _fp, backend, via)
        dev = _fuser._device_of(list(vals) + list(outs))
        if dev is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        _registry.inc("autotune.prewarm_done")

    ticket = pipe.submit_warm(warm, label=f"autotune:{fp}")
    with _lock:
        _prewarm[fp] = ticket
    _registry.inc("autotune.prewarm_submitted")
    return True


def decision(fp: str) -> Optional[dict]:
    with _lock:
        d = _decisions.get(fp)
        return dict(d) if d is not None else None


def report() -> dict:
    """Mode, per-fingerprint decisions and the measured race overhead
    (the loser's sample seconds plus its compile seconds, summed)."""
    with _lock:
        decisions = {fp: dict(d) for fp, d in _decisions.items()}
    overhead_s = 0.0
    races = 0
    for fp, d in decisions.items():
        if d["via"] != "autotune":
            continue
        races += 1
        stats = _ledger.backend_stats(fp)
        loser = TORCH if d["backend"] == KERNEL else KERNEL
        ls = stats.get(loser) or {}
        overhead_s += float(ls.get("total_s") or 0.0)
        overhead_s += float(ls.get("compile_s") or 0.0)
    return {
        "mode": _mode if _mode != "force" else f"force:{_forced}",
        "k": _k,
        "cache_path": _cache_path,
        "decisions": decisions,
        "races_latched": races,
        "race_overhead_s": round(overhead_s, 6),
    }


reconfigure()
