"""Elastic job lifecycle: rank health, hang detection, checkpointed resume.

Counterpart of ``ramba_tpu/resilience/elastic.py``: the layer that lets a
job of several ranks survive losing one.

* **Watchdog** — :func:`with_deadline` wraps each rung attempt of a flush
  (``core/fuser.py``, ``core/rankflush.py``), the cross-rank barrier
  (``parallel/distributed.barrier``) and each coherence round with a
  deadline (``RAMBA_WATCHDOG_S``).  A hang becomes a classified
  :class:`RankStallError` instead of an infinite block; the class
  (``retryable`` / ``degrade`` / ``fatal``, per-site table below,
  ``RAMBA_WATCHDOG_CLASS_<SITE>`` overrides it) routes through
  ``resilience.retry.classify``, so a stalled fused dispatch drops a
  ladder rung like any other degrade failure.
* **Heartbeat** — a beacon thread per rank (:func:`start_heartbeat`) that
  emits ``heartbeat`` events every ``RAMBA_HEARTBEAT_S`` seconds;
  ``scripts/trace_report.py`` rebuilds each rank's liveness from them.
* **CheckpointManager** — step-numbered checkpoints of registered trees
  under one root, in the port's own format (``checkpoint.py``: a tree
  manifest and one ``.npy`` a leaf), each step with a ``MANIFEST.json``
  (mesh shape, process count, ``x64``, each leaf's path, shape, dtype and
  layout, a self-digest), written after the state is published;
  retention-K GC that never deletes the newest valid step.
* **drain-to-checkpoint** — :func:`drain_to_checkpoint` flushes every
  stream and waits for the card (under its own deadline) before saving.
* **resume** — :func:`resume` restores the newest valid step into the
  current mesh even when the number of ranks changed (4→2, 2→1, 1→4):
  the target is rebuilt from the checkpoint's tree manifest, each leaf
  in the current mesh's default layout, and every rank reads only its
  block, under the governor's admission.
* **live_reshape** — :func:`live_reshape` moves every live array to
  another mesh without leaving the process (a census agreed across
  ranks, each array through ``parallel.reshard``, an atomic swap in the
  governor's ledger, then ``set_mesh``), falling back to a checkpoint
  round trip when a reshard fails or a rank votes no.

Watchdog classes by site:

========== ============ ==================================================
site       class        rationale
========== ============ ==================================================
dispatch   degrade      re-running the identical program would hang
                        again; the ladder's next rung changes the program
barrier    fatal        a missing rank cannot be degraded around: the
                        job drains and resumes with a new world
drain      fatal        a hang while quiescing means the state cannot be
                        trusted; surface it instead of checkpointing junk
heartbeat  retryable    a late beacon is jitter until proven otherwise
========== ============ ==================================================

What an abandoned attempt leaves behind.  A deadline cannot cancel work
already on the card: a CUDA launch is not cancellable, so an abandoned
attempt's launches stay queued on its stream and the next rung's queue
behind them (a hung kernel wedges the card; a slow one only delays the
next rung), and the tensors it allocated live until its thread drops
them.  Torch has no buffer donation, so there is no input buffer a zombie
could consume (the reference's danger, ``ramba_tpu/core/fuser.py``).
The danger in the port is the commits: :func:`cancelled` is checked
after the ``dispatch`` fault site and before every commit an attempt
makes (its launches, each in its kernel's wrapper right before the
launch itself, after the nvcc build a first plan pays; the ledger's
execute and cost records, the compile cache, the memo, plan
certificates, the flush span), and before every collective
(``parallel/distributed.py``), so an attempt that wakes after its
deadline, or whose deadline expired during a build, raises instead of
launching, committing or pairing with a round of its peers.

An abandoned collective poisons its group: a gloo or NCCL call left
running on a helper thread would pair with the next collective on the
same group.  So after a ``barrier`` or ``coherence`` stall (or a failed
barrier: a peer that exited), and whenever a deadline abandons a thread
inside a collective (a halo exchange in a rank's attempt), the group is
marked broken
(``distributed.mark_broken``) and every later collective on it raises at
once (:class:`GroupBrokenError`, fatal).  The runbook then restarts the
job and calls :func:`resume`.  The reference carries on with a local
proposal after a failed coherence round; the port returns that proposal
for the round and then refuses the group (a kept divergence).

Configuration: ``RAMBA_WATCHDOG_S`` (deadline seconds; unset or 0
disarms: no thread, one environment read a flush),
``RAMBA_WATCHDOG_CLASS_<SITE>`` (class override), ``RAMBA_HEARTBEAT_S``
(beacon interval, default 5), ``RAMBA_DRAIN_S`` (drain deadline, default
10x the watchdog's), ``RAMBA_CKPT_EVERY`` / ``RAMBA_CKPT_KEEP``
(CheckpointManager defaults), ``RAMBA_COHERENCE_TIMEOUT_S`` (one round's
deadline, else the watchdog's; ``resilience/coherence.py``).
"""

from __future__ import annotations

import contextvars
import hashlib
import json
import os
import shutil
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ramba_tpu_torch.observe import events as _events
from ramba_tpu_torch.observe import health as _health
from ramba_tpu_torch.observe import registry as _registry
from ramba_tpu_torch.resilience import coherence as _coherence
from ramba_tpu_torch.resilience import faults as _faults
from ramba_tpu_torch.resilience import memory as _memory


class RankStallError(RuntimeError):
    """A watchdog deadline expired: the wrapped call (a wedged
    collective, a hung dispatch) is still running past its deadline.

    ``stall_classification`` is how ``resilience.retry.classify`` routes
    the error (``"retryable"`` / ``"degrade"`` / ``"fatal"``); the
    attribute is duck-typed there to keep retry.py free of an elastic
    import."""

    def __init__(self, site: str, waited_s: float, classification: str,
                 rank: Optional[int] = None, message: Optional[str] = None):
        self.site = site
        self.waited_s = waited_s
        self.stall_classification = classification
        self.rank = rank
        where = f" on rank {rank}" if rank is not None else ""
        super().__init__(message or (
            f"rank stall at site {site!r}{where}: no completion within "
            f"{waited_s:.3f}s (RAMBA_WATCHDOG_S deadline); "
            f"classified {classification}"))


class GroupBrokenError(RankStallError):
    """A collective on a process group that a stalled or failed barrier
    or coherence round left broken: refused at once, classified fatal.
    Restart the job and :func:`resume` from the newest checkpoint."""

    def __init__(self, site: str, cause: str, rank: Optional[int] = None):
        where = f" on rank {rank}" if rank is not None else ""
        super().__init__(
            site, 0.0, "fatal", rank=rank,
            message=(f"collective at site {site!r}{where} refused: the "
                     f"process group is broken ({cause}); restart the job "
                     f"and resume from the newest checkpoint"))


class AbandonedAttempt(RuntimeError):
    """An attempt woke after the watchdog gave up on it: it stops before
    its next launch, commit or collective.  Raised on the abandoned
    thread only; its caller already moved on."""


# -- watchdog ---------------------------------------------------------------

_STALL_CLASSES = ("retryable", "degrade", "fatal")
_DEFAULT_STALL_CLASS: Dict[str, str] = {
    "dispatch": "degrade",
    "barrier": "fatal",
    "drain": "fatal",
    "heartbeat": "retryable",
}


def watchdog_seconds() -> Optional[float]:
    """The armed deadline, or None when the watchdog is off (default)."""
    raw = os.environ.get("RAMBA_WATCHDOG_S")
    if not raw:
        return None
    try:
        t = float(raw)
    except ValueError:
        return None
    return t if t > 0 else None


def armed() -> bool:
    return watchdog_seconds() is not None


def _site_env(site: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in site.upper())


def stall_class_for(site: str) -> str:
    raw = os.environ.get(f"RAMBA_WATCHDOG_CLASS_{_site_env(site)}", "")
    raw = raw.strip().lower()
    if raw in _STALL_CLASSES:
        return raw
    return _DEFAULT_STALL_CLASS.get(site, "degrade")


def _rank() -> Optional[int]:
    from ramba_tpu_torch.parallel import distributed as _distributed

    try:
        if _distributed.process_count() > 1:
            return int(_distributed.process_index())
    except Exception:
        pass
    return None


# Set (in the helper thread's context) by with_deadline, and set when the
# deadline expires.  A wrapped call that sleeps through its deadline and
# then wakes must not go on to do the real work: the caller already
# recovered (the ladder ran the next rung).
_cancel_var: contextvars.ContextVar = contextvars.ContextVar(
    "ramba_deadline_cancelled", default=None)


def cancelled() -> bool:
    """True when the current call runs under an expired deadline."""
    ev = _cancel_var.get()
    return ev is not None and ev.is_set()


def abandon_if_cancelled(what: str) -> None:
    """Raise :class:`AbandonedAttempt` on a thread whose deadline
    expired, before it does ``what`` (a launch, a commit, a
    collective)."""
    ev = _cancel_var.get()
    if ev is not None and ev.is_set():
        _registry.inc("elastic.abandoned_commits")
        raise AbandonedAttempt(
            f"abandoned attempt stopped before {what}: the watchdog gave "
            f"up on it")


def _thread_state():
    """The caller's per-thread state that ``contextvars`` do not carry:
    ``common.device_scope``'s device, ``mesh.local_scope``'s mesh and
    torch's current CUDA stream, as ``(device, mesh, stream)``."""
    from ramba_tpu_torch import common as _common
    from ramba_tpu_torch.parallel import mesh as _mesh

    stream = torch.cuda.current_stream() \
        if torch.cuda.is_available() and torch.cuda.is_initialized() \
        else None
    return (getattr(_common._scope, "device", None),
            getattr(_mesh._scope, "mesh", None), stream)


_abandoned_lock = threading.Lock()
_abandoned = [0]  # calls past their deadline still running


def wait_abandoned(timeout: float = 30.0) -> bool:
    """Wait until every call a deadline gave up on has ended; True when
    none is left."""
    end = time.monotonic() + timeout
    while _abandoned[0] and time.monotonic() < end:
        time.sleep(0.005)
    return not _abandoned[0]


def with_deadline(site: str, fn: Callable, *,
                  timeout_s: Optional[float] = None):
    """Run ``fn()`` under the watchdog deadline for ``site``.

    Unarmed (no ``RAMBA_WATCHDOG_S`` and no ``timeout_s``; a
    ``timeout_s`` of 0 is a deadline resolved to none and reads nothing)
    this is a plain call: no thread.  Armed, ``fn`` runs on a helper
    thread of its own with the caller's contextvars and per-thread state
    (device scope, local mesh scope, current CUDA stream) while the
    caller waits out the deadline; on expiry the caller gets a
    classified :class:`RankStallError` and the wedged call is left on its
    thread, flagged :func:`cancelled`."""
    t = timeout_s if timeout_s is not None else watchdog_seconds()
    if t is None or t <= 0:
        return fn()
    from ramba_tpu_torch import common as _common
    from ramba_tpu_torch.parallel import mesh as _mesh

    ctx = contextvars.copy_context()
    dev, msh, stream = _thread_state()
    cancel = threading.Event()
    box: dict = {}
    done = [False]

    def run():
        _common._scope.device = dev
        _mesh._scope.mesh = msh
        try:
            def with_flag():
                _cancel_var.set(cancel)
                if stream is None:
                    return fn()
                with torch.cuda.stream(stream):
                    return fn()

            box["value"] = ctx.run(with_flag)
        except BaseException as e:  # re-raised on the caller thread
            box["error"] = e
        finally:
            with _abandoned_lock:
                done[0] = True
                if cancel.is_set():
                    # no one reads an abandoned call's outcome: its
                    # tensors and frames go now
                    box.clear()
                    _abandoned[0] -= 1

    th = threading.Thread(target=run, name=f"ramba-deadline-{site}",
                          daemon=True)
    _registry.inc("elastic.deadline_calls")
    t0 = time.monotonic()
    th.start()
    th.join(t)
    with _abandoned_lock:
        if not done[0]:
            # the zombie must not do the real work when it wakes
            cancel.set()
            _abandoned[0] += 1
    if cancel.is_set():
        waited = time.monotonic() - t0
        cls = stall_class_for(site)
        from ramba_tpu_torch.parallel import distributed as _distributed

        inside = _distributed.inside_collective(th.ident)
        if inside is not None:
            # the zombie's collective would pair with the group's next one
            _distributed.mark_broken(
                f"a {site} call was abandoned inside the collective "
                f"{inside!r} after {waited:.3f}s")
        _registry.inc("elastic.stalls")
        _registry.inc(f"elastic.stalls.{site}")
        _events.emit({"type": "stall", "site": site,
                      "waited_s": round(waited, 4),
                      "deadline_s": t, "classification": cls})
        _health.record(outcome="error", source=f"watchdog:{site}",
                       error=f"stall after {waited:.3f}s")
        if site == "dispatch" and _coherence.engaged():
            # seed the ladder's next flush:rung round with the stall's
            # severity, so the ranks degrade (or abort) together
            _coherence.propose(
                "flush:rung",
                _coherence.P_FATAL if cls == "fatal" else _coherence.P_DROP)
        raise RankStallError(site, waited, cls, rank=_rank())
    if "error" in box:
        err = box.pop("error")
        raise err
    return box.pop("value", None)


# -- heartbeat --------------------------------------------------------------

def _heartbeat_interval() -> float:
    try:
        v = float(os.environ.get("RAMBA_HEARTBEAT_S", "") or 5.0)
    except ValueError:
        v = 5.0
    return v if v > 0 else 5.0


class _Heartbeat(threading.Thread):
    """Daemon beacon: one ``heartbeat`` event per interval.  The fault
    site ``heartbeat`` is checked before each beat, so a seeded
    ``heartbeat:hang:ms=...:after=N`` stalls exactly one beacon: the
    deterministic miss that :func:`check_heartbeat` and the trace
    report's gap flagging key on."""

    def __init__(self, interval_s: float):
        super().__init__(name="ramba-heartbeat", daemon=True)
        self.interval_s = interval_s
        self.beats = 0
        self.last_beat: Optional[float] = None  # monotonic
        self._halt = threading.Event()

    def run(self) -> None:
        while True:
            try:
                _faults.check("heartbeat")
            except Exception:
                pass  # a raising fault plan must not kill the beacon
            if self._halt.is_set():
                return
            self.beats += 1
            self.last_beat = time.monotonic()
            _registry.inc("elastic.heartbeats")
            _events.emit({"type": "heartbeat", "n": self.beats,
                          "interval_s": self.interval_s})
            if self._halt.wait(self.interval_s):
                return

    def halt(self) -> None:
        self._halt.set()


_hb_lock = threading.Lock()
_hb: Optional[_Heartbeat] = None


def start_heartbeat(interval_s: Optional[float] = None) -> None:
    """Start (or restart with a new interval) this rank's beacon."""
    global _hb
    with _hb_lock:
        if _hb is not None:
            _hb.halt()
        _hb = _Heartbeat(interval_s if interval_s and interval_s > 0
                         else _heartbeat_interval())
        _hb.start()


def stop_heartbeat() -> None:
    global _hb
    with _hb_lock:
        if _hb is not None:
            _hb.halt()
            _hb = None


def heartbeat_running() -> bool:
    hb = _hb
    return hb is not None and hb.is_alive()


def last_beat_age() -> Optional[float]:
    """Seconds since this rank's last beacon (None: not started, or no
    beat yet)."""
    hb = _hb
    if hb is None or hb.last_beat is None:
        return None
    return time.monotonic() - hb.last_beat


def check_heartbeat(max_age_s: Optional[float] = None) -> bool:
    """True when the local beacon is fresh.  Stale (age above
    ``max_age_s``, default twice the beat interval) emits a
    ``heartbeat_missed`` lifecycle event and returns False."""
    hb = _hb
    if hb is None:
        return True  # not started: nothing to miss
    age = last_beat_age()
    if age is None:
        age = time.monotonic() - (hb.last_beat or 0.0)
    limit = max_age_s if max_age_s and max_age_s > 0 else 2.0 * hb.interval_s
    if age <= limit:
        return True
    _registry.inc("elastic.heartbeat_missed")
    _events.emit({"type": "lifecycle", "phase": "heartbeat_missed",
                  "age_s": round(age, 4), "limit_s": round(limit, 4)})
    return False


# -- progress note (a cheap liveness signal from the flush path) ------------

_last_progress: Optional[tuple] = None  # (monotonic, what)


def note_progress(what: str) -> None:
    global _last_progress
    _last_progress = (time.monotonic(), what)


def last_progress_age() -> Optional[float]:
    lp = _last_progress
    return None if lp is None else time.monotonic() - lp[0]


# -- checkpoint manager -----------------------------------------------------

_STEP_PREFIX = "step_"
_STATE_DIR = "state"
_MANIFEST = "MANIFEST.json"
_MANIFEST_FORMAT = 1


def _manifest_digest(man: dict) -> str:
    """Content digest over the manifest body (every field but the digest
    itself, canonical JSON); a manifest without the field is accepted
    unverified."""
    body = {k: v for k, v in man.items() if k != "digest"}
    data = json.dumps(body, sort_keys=True).encode()
    return hashlib.sha256(data).hexdigest()


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _barrier(tag: str) -> None:
    from ramba_tpu_torch.parallel import distributed as _distributed

    _distributed.barrier(tag)


def _leaf_fingerprints(tree) -> list:
    """Each leaf of ``tree`` (the port's tree walk, ``checkpoint._flatten``)
    as ``{path, shape, dtype, sharding}``, the path in
    ``jax.tree_util.keystr``'s spelling.  Read from the arrays' metadata:
    nothing is gathered."""
    from ramba_tpu_torch import checkpoint as _checkpoint
    from ramba_tpu_torch.core.expr import to_np_dtype
    from ramba_tpu_torch.core.ndarray import ndarray

    out = []
    for path, v in _checkpoint._flatten(tree)[1]:
        spec = None
        if isinstance(v, ndarray):
            shape, dtype = v.shape, np.dtype(v.dtype)
            spec = v.sharding.spec
        elif isinstance(v, torch.Tensor):
            shape, dtype = tuple(v.shape), np.dtype(to_np_dtype(v.dtype))
        else:
            a = np.asarray(v)
            shape, dtype = a.shape, a.dtype
        out.append({
            "path": path,
            "shape": [int(s) for s in shape],
            "dtype": str(dtype),
            "sharding": str(spec) if spec is not None else None,
        })
    return out


def _mesh_meta(mesh) -> dict:
    """The mesh a manifest records: its axes, and its size (on a mesh of
    ranks the rank count, in one process the shard positions)."""
    return {"mesh_shape": {k: int(v) for k, v in mesh.shape.items()},
            "mesh_devices": int(mesh.size)}


class CheckpointManager:
    """Step-numbered checkpoints of registered trees under one root.

    Layout: ``<root>/step_<n>/state`` (the port's checkpoint format, via
    ``checkpoint.save``'s atomic stage and rename) plus
    ``<root>/step_<n>/MANIFEST.json`` written by rank 0 *after* the state
    is published: a step without a readable, matching manifest is torn
    debris and is never selected by :meth:`latest`.  Retention keeps the
    newest ``keep`` valid steps; GC deletes valid steps beyond that and
    invalid debris older than the newest valid step, and so can never
    delete the newest valid one."""

    def __init__(self, root: str, *, keep: Optional[int] = None,
                 every_steps: Optional[int] = None):
        self.root = os.path.abspath(root)
        self.keep = keep if keep is not None else _env_int("RAMBA_CKPT_KEEP", 3)
        if self.keep < 1:
            raise ValueError("CheckpointManager keep must be >= 1")
        self.every_steps = (every_steps if every_steps is not None
                            else _env_int("RAMBA_CKPT_EVERY", 0)) or None
        self._registered: Dict[str, Callable] = {}

    # -- registration ------------------------------------------------------

    def register(self, name: str, tree) -> None:
        """Register a tree (or a callable of no arguments returning one)
        to be captured by :meth:`save` / :meth:`maybe_save`."""
        self._registered[name] = tree if callable(tree) else (lambda: tree)

    def gather(self) -> dict:
        return {name: fn() for name, fn in self._registered.items()}

    # -- paths -------------------------------------------------------------

    def step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"{_STEP_PREFIX}{int(step):08d}")

    def state_path(self, step: int) -> str:
        return os.path.join(self.step_dir(step), _STATE_DIR)

    def manifest_path(self, step: int) -> str:
        return os.path.join(self.step_dir(step), _MANIFEST)

    def all_steps(self) -> list:
        """Every step directory on disk (valid or torn), ascending."""
        if not os.path.isdir(self.root):
            return []
        out = []
        for name in os.listdir(self.root):
            if not name.startswith(_STEP_PREFIX):
                continue
            try:
                out.append(int(name[len(_STEP_PREFIX):]))
            except ValueError:
                continue
        return sorted(out)

    def valid_steps(self) -> list:
        return [s for s in self.all_steps() if self._manifest_ok(s)]

    def latest(self) -> Optional[int]:
        """Newest step with a readable manifest, or None."""
        valid = self.valid_steps()
        return valid[-1] if valid else None

    # -- manifest ----------------------------------------------------------

    def _manifest_ok(self, step: int) -> bool:
        try:
            self.manifest(step)
            return True
        except Exception:
            return False

    def manifest(self, step: int) -> dict:
        """Parse and vet a step's manifest; raises CheckpointCorruptError
        for an absent, truncated or mismatched manifest."""
        from ramba_tpu_torch.checkpoint import CheckpointCorruptError
        from ramba_tpu_torch.resilience import integrity as _integrity

        mpath = self.manifest_path(step)
        if not os.path.exists(mpath):
            raise CheckpointCorruptError(
                f"checkpoint step {step} at {self.step_dir(step)!r} has no "
                f"manifest (torn or foreign write)")
        try:
            with open(mpath, "r", encoding="utf-8") as f:
                man = json.load(f)
        except (ValueError, OSError) as e:
            raise CheckpointCorruptError(
                f"checkpoint step {step} manifest at {mpath!r} is "
                f"unreadable ({type(e).__name__}: {e})") from e
        if not isinstance(man, dict) or man.get("step") != int(step):
            raise CheckpointCorruptError(
                f"checkpoint manifest at {mpath!r} does not describe "
                f"step {step}")
        for key in ("process_count", "mesh_devices", "x64", "leaves"):
            if key not in man:
                raise CheckpointCorruptError(
                    f"checkpoint manifest at {mpath!r} is missing {key!r}")
        want = man.get("digest")
        if want is not None and _integrity.enabled():
            # a flipped bit anywhere in the file refuses the step
            if _manifest_digest(man) != want:
                _integrity.failure("checkpoint:leaf", "digest",
                                   detail=f"manifest step {step}")
                raise CheckpointCorruptError(
                    f"checkpoint manifest at {mpath!r} failed its "
                    f"self-digest (silent corruption)")
        return man

    def _write_manifest(self, step: int, tree) -> dict:
        from ramba_tpu_torch.parallel import distributed as _distributed
        from ramba_tpu_torch.parallel import mesh as _mesh

        man = {
            "format": _MANIFEST_FORMAT,
            "step": int(step),
            "process_count": int(_distributed.process_count()),
            "process_index": int(_distributed.process_index()),
            **_mesh_meta(_mesh.get_mesh()),
            "x64": True,  # the port's regime is fixed
            "leaves": _leaf_fingerprints(tree),
        }
        man["digest"] = _manifest_digest(man)
        if _distributed.in_driver():
            mpath = self.manifest_path(step)
            tmp = mpath + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(man, f, indent=1, sort_keys=True)
            os.replace(tmp, mpath)
        _barrier("ramba_elastic_manifest")
        return man

    # -- save --------------------------------------------------------------

    def save(self, step: int, tree=None) -> str:
        """Checkpoint ``tree`` (default: the registered trees) as
        ``step``.  Collective: every rank calls it with the same step."""
        from ramba_tpu_torch import checkpoint as _checkpoint
        from ramba_tpu_torch.parallel import distributed as _distributed

        tree = tree if tree is not None else self.gather()
        if not _checkpoint._flatten(tree)[1]:
            raise ValueError(
                "CheckpointManager.save: nothing to checkpoint (no tree "
                "given and no registered trees)")
        d = self.step_dir(step)
        if _distributed.in_driver():
            os.makedirs(d, exist_ok=True)
        _barrier("ramba_elastic_stepdir")
        t0 = time.perf_counter()
        _checkpoint.save(self.state_path(step), tree, force=True)
        self._write_manifest(step, tree)
        _registry.inc("elastic.checkpoints")
        _events.emit({"type": "lifecycle", "phase": "checkpoint_saved",
                      "step": int(step), "path": d,
                      "wall_s": round(time.perf_counter() - t0, 4)})
        self.gc()
        return d

    def maybe_save(self, step: int, tree=None) -> Optional[str]:
        """Auto-checkpoint hook for loops: saves when ``step`` lands on
        the ``every_steps`` cadence, else nothing."""
        if not self.every_steps or int(step) % self.every_steps != 0:
            return None
        return self.save(step, tree)

    # -- retention ---------------------------------------------------------

    def gc(self) -> list:
        """Apply retention-K.  Returns the deleted step numbers.  Invalid
        (torn) steps newer than the newest valid one are left alone: a
        concurrent writer may still be publishing them."""
        from ramba_tpu_torch.parallel import distributed as _distributed

        valid = self.valid_steps()
        keep_set = set(valid[-self.keep:])
        # no valid step: nothing is deleted, but every rank still joins
        # the barrier below
        doomed = [s for s in self.all_steps()
                  if s not in keep_set and s < valid[-1]] if valid else []
        if _distributed.in_driver():
            for s in doomed:
                shutil.rmtree(self.step_dir(s), ignore_errors=True)
        _barrier("ramba_elastic_gc")
        if doomed:
            _registry.inc("elastic.checkpoints_gcd", len(doomed))
            _events.emit({"type": "lifecycle", "phase": "checkpoint_gc",
                          "deleted_steps": doomed,
                          "kept": sorted(keep_set)})
        return doomed

    # -- load (the strict path: the same world) -----------------------------

    def load(self, step: Optional[int] = None, target=None):
        """Restore a step strictly: without ``target`` the world must
        match the manifest (process count, mesh size, x64); a changed
        world raises CheckpointCorruptError pointing at :func:`resume`,
        which rebuilds the target for the current mesh."""
        from ramba_tpu_torch import checkpoint as _checkpoint
        from ramba_tpu_torch.checkpoint import CheckpointCorruptError
        from ramba_tpu_torch.parallel import distributed as _distributed
        from ramba_tpu_torch.parallel import mesh as _mesh

        if step is None:
            step = self.latest()
            if step is None:
                raise CheckpointCorruptError(
                    f"no valid checkpoint under {self.root!r}")
        man = self.manifest(step)
        _check_x64(man, self.manifest_path(step))
        if target is None:
            mesh = _mesh.get_mesh()
            nproc = _distributed.process_count()
            if (int(man["process_count"]) != nproc
                    or int(man["mesh_devices"]) != int(mesh.size)):
                raise CheckpointCorruptError(
                    f"checkpoint step {step} was saved on "
                    f"{man['process_count']} process(es) / "
                    f"{man['mesh_devices']} mesh position(s) but this run "
                    f"has {nproc} / {mesh.size}; restore without a target "
                    f"cannot re-shard — use elastic.resume() to restore "
                    f"into the current mesh")
        return _checkpoint.restore(self.state_path(step), target)


def _check_x64(man: dict, where: str) -> None:
    """The port's regime is always x64 (the reference's
    ``jax_enable_x64=True``): a manifest written without it describes
    other dtypes."""
    from ramba_tpu_torch.checkpoint import CheckpointCorruptError

    if not bool(man.get("x64")):
        raise CheckpointCorruptError(
            f"checkpoint manifest at {where!r} was written with x64 "
            f"(jax_enable_x64) False but the port always runs x64; the "
            f"numeric lattice differs — restoring would silently change "
            f"dtypes")


# -- drain-to-checkpoint ----------------------------------------------------

def _drain_deadline() -> Optional[float]:
    raw = os.environ.get("RAMBA_DRAIN_S")
    if raw:
        try:
            t = float(raw)
            return t if t > 0 else None
        except ValueError:
            pass
    wd = watchdog_seconds()
    return 10.0 * wd if wd is not None else None


def quiesce() -> int:
    """Flush every stream (serve sessions included), drain the serve
    pipeline's queue under the drain deadline, then wait for every
    stream's queued tickets and the card; returns the number of live
    streams quiesced."""
    from ramba_tpu_torch.core import fuser as _fuser
    from ramba_tpu_torch.serve import pipeline as _pipeline

    streams = _fuser.all_streams()
    for s in streams:
        s.flush()
    p = _pipeline.current_pipeline()
    if p is not None:
        p.quiesce(timeout=_drain_deadline())
    _fuser.sync()
    return len(streams)


def drain_to_checkpoint(manager, step: int, tree=None) -> str:
    """Quiesce the process (every pending flush, the card) under the
    drain deadline, then checkpoint.

    ``manager`` is a :class:`CheckpointManager` or a root path.  Returns
    the step directory.  A hang while draining raises a fatal
    :class:`RankStallError`: checkpointing un-quiesced state would
    publish junk."""
    mgr = manager if isinstance(manager, CheckpointManager) \
        else CheckpointManager(manager)
    _events.emit({"type": "lifecycle", "phase": "drain_begin",
                  "step": int(step)})
    t0 = time.perf_counter()
    n = with_deadline("drain", quiesce, timeout_s=_drain_deadline())
    _events.emit({"type": "lifecycle", "phase": "drain_complete",
                  "step": int(step), "streams": n,
                  "wall_s": round(time.perf_counter() - t0, 4)})
    _registry.inc("elastic.drains")
    return mgr.save(step, tree)


# -- resume into the current world -------------------------------------------

def _admit_restore(total_bytes: int) -> int:
    """The governor's admission for a restore: when the incoming bytes
    would push the ledger past the watermark, evict first.  Returns the
    bytes freed (0 when no budget is configured)."""
    budget = _memory.budget_bytes()
    if budget is None or total_bytes <= 0:
        return 0
    wm = _memory.watermark_bytes(budget) or budget
    need = _memory.ledger.live_bytes + total_bytes - wm
    if need <= 0:
        return 0
    freed = _memory.ledger.evict_until(int(need))
    _registry.inc("elastic.restore_spills")
    _events.emit({"type": "lifecycle", "phase": "restore_admit",
                  "incoming_bytes": int(total_bytes),
                  "need_bytes": int(need), "freed_bytes": int(freed)})
    return freed


class Resumed:
    """Result of :func:`resume`: the restored state plus provenance."""

    __slots__ = ("step", "state", "manifest")

    def __init__(self, step: int, state, manifest: dict):
        self.step = step
        self.state = state
        self.manifest = manifest

    def __repr__(self) -> str:
        return (f"Resumed(step={self.step}, "
                f"from_processes={self.manifest.get('process_count')})")


class _LeafSpec:
    """A restore target leaf: shape, dtype and the layout it lands in."""

    __slots__ = ("shape", "dtype", "sharding")

    def __init__(self, shape, dtype, sharding):
        self.shape, self.dtype, self.sharding = shape, dtype, sharding


def _local_bytes(shape, dtype, sharding) -> int:
    """The bytes this process holds of a leaf in ``sharding``: its blocks
    on a mesh of ranks (every one it holds), the whole leaf in one
    process."""
    if sharding.mesh.ranks is None:
        n = int(np.prod(shape, dtype=np.int64))
    else:
        from ramba_tpu_torch.parallel import distributed

        n = int(np.prod(sharding.held_shape(distributed.process_index(),
                                            shape), dtype=np.int64))
    return n * dtype.itemsize


def resume(path, *, step: Optional[int] = None, mesh=None) -> Resumed:
    """Restore the newest valid checkpoint under ``path`` (a
    :class:`CheckpointManager` or its root) into the CURRENT mesh.

    The target is rebuilt from the checkpoint's own tree manifest, each
    leaf in the current mesh's ``default_spec``, so the number of ranks
    may differ from the saving run's (4→2, 2→1, 1→4):
    ``checkpoint.restore(path, target)`` has each rank read only its
    block.  The port lays arrays out by the process mesh, so a ``mesh``
    other than the current one is installed first.  Runs under the
    governor's admission (:func:`_admit_restore`).  Raises
    ``CheckpointCorruptError`` when no valid step exists, the manifest is
    torn or disagrees with the state, or the x64 regime changed."""
    from ramba_tpu_torch import checkpoint as _checkpoint
    from ramba_tpu_torch.checkpoint import CheckpointCorruptError
    from ramba_tpu_torch.parallel import distributed as _distributed
    from ramba_tpu_torch.parallel import mesh as _mesh_mod

    mgr = path if isinstance(path, CheckpointManager) \
        else CheckpointManager(path)
    if step is None:
        step = mgr.latest()
        if step is None:
            raise CheckpointCorruptError(
                f"no valid checkpoint under {mgr.root!r}")
    man = mgr.manifest(step)
    _check_x64(man, mgr.manifest_path(step))
    state_path = mgr.state_path(step)
    tree_man = _checkpoint._read_manifest(state_path,
                                          os.path.abspath(state_path))
    if len(tree_man["leaves"]) != len(man["leaves"]):
        raise CheckpointCorruptError(
            f"checkpoint step {step}: manifest records "
            f"{len(man['leaves'])} leaves but the state holds "
            f"{len(tree_man['leaves'])}")
    if mesh is not None and mesh != _mesh_mod.get_mesh():
        _mesh_mod.set_mesh(mesh)
    mesh = _mesh_mod.get_mesh()
    total_bytes = 0
    specs = []
    for leaf in tree_man["leaves"]:
        shape = tuple(int(s) for s in leaf["shape"])
        dt = np.dtype(leaf["dtype"])
        sh = _mesh_mod.NamedSharding(mesh, _mesh_mod.default_spec(shape,
                                                                  mesh))
        total_bytes += _local_bytes(shape, dt, sh)
        specs.append(_LeafSpec(shape, dt, sh))
    target = _checkpoint._unflatten(tree_man["tree"], specs)
    _events.emit({"type": "lifecycle", "phase": "resume_begin",
                  "step": int(step),
                  "from_processes": int(man["process_count"]),
                  "to_processes": int(_distributed.process_count()),
                  "bytes": int(total_bytes)})
    _admit_restore(total_bytes)
    t0 = time.perf_counter()
    state = _checkpoint.restore(state_path, target)
    _registry.inc("elastic.resumes")
    _events.emit({"type": "lifecycle", "phase": "resume_complete",
                  "step": int(step), "bytes": int(total_bytes),
                  "wall_s": round(time.perf_counter() - t0, 4)})
    return Resumed(int(step), state, man)


# -- live mesh reshape -------------------------------------------------------

def _reshape_census():
    """Every ledger-tracked array as ``(entry, const, consts)``: the
    entry, one live Const owning it and all of them (spilled entries
    included).  Entries whose owners all died are skipped."""
    out = []
    led = _memory.ledger
    with led._lock:
        for e in list(led.entries.values()):
            consts = led._live_consts(e)
            if consts:
                out.append((e, consts[0], consts))
    return out


def _census_hash31(census) -> int:
    """A 31-bit hash of the census: each array's global shape and dtype
    (a block's global shape, so ranks of an uneven layout agree)."""
    lines = sorted(f"{tuple(c.shape)}:{np.dtype(c.dtype)}"
                   for _, c, _ in census)
    h = hashlib.sha1("\n".join(lines).encode()).digest()
    return int.from_bytes(h[:4], "big") & 0x7FFFFFFF


def _source(const, mesh):
    """``const`` as a leaf whose layout is explicit: a Const in the
    default layout (no sharding) is that of ``mesh`` (the mesh it was
    made on)."""
    from ramba_tpu_torch.core.expr import Const
    from ramba_tpu_torch.parallel import mesh as _mesh_mod

    if const.sharding is not None or _mesh_mod.is_rank_mesh(mesh):
        return const
    sh = _mesh_mod.NamedSharding(mesh, _mesh_mod.default_spec(const.shape,
                                                              mesh))
    return Const(const.value, sharding=sh)


def _adopt(consts, old, new_value, new_sharding) -> None:
    """Every Const owning ``old`` now holds ``new_value`` in
    ``new_sharding``: the governor's ledger entry follows the buffer.  In
    one process a Const in the default layout stays in it (None: the new
    mesh's default)."""
    _memory.ledger.swap_value(old, new_value)
    for c in consts:
        c.value = new_value
        if new_sharding is None or new_sharding.mesh.ranks is not None \
                or c.sharding is not None:
            c.sharding = new_sharding


def live_reshape(new_mesh, *, manager=None, step: int = 0,
                 max_stage_bytes: Optional[int] = None) -> dict:
    """Reshape the job onto ``new_mesh`` without leaving the process:
    quiesce → census → reshard every live array → commit.

    1. **Live**: every flush drains under the drain deadline; the result
       memo is dropped (its entries hold results of the old layout); a
       census of the governor's ledger (every realized array) is agreed
       across ranks (its hash broadcast from rank 0, then a go/no-go
       vote); spilled arrays are restored and each array goes to
       ``new_mesh``'s default layout through ``parallel.reshard`` (staged,
       governor-admitted).  Nothing commits until every array has its new
       buffer; then every entry swaps in the ledger and ``set_mesh``
       bumps the mesh epoch (the compile cache and plan certificates key
       on it).
    2. **Fallback**, when a reshard fails (``ReshardError``,
       ``CoherentAbort``) or a rank votes no: ``drain_to_checkpoint``
       and :func:`resume` through ``manager`` (when not given, a
       temporary directory that rank 0 makes and names to the others,
       deleted after the resume).

    Either way the source arrays stay intact until their replacement is
    ready.  In the port a reshape is between meshes of shards in one
    process, or between meshes of the same ranks (``mesh.rank_mesh``).
    Returns ``{"mode": "live" | "checkpoint", "arrays", "bytes",
    "wall_s"}``: live, ``bytes`` counts what this process copied (an
    array already in the new layout stays in place and counts 0); on the
    fallback, the bytes of every array checkpointed."""
    from ramba_tpu_torch.core import fuser as _fuser
    from ramba_tpu_torch.core import memo as _memo
    from ramba_tpu_torch.parallel import distributed as _distributed
    from ramba_tpu_torch.parallel import mesh as _mesh_mod
    from ramba_tpu_torch.parallel import reshard as _reshard

    t0 = time.perf_counter()
    old_mesh = _mesh_mod.get_mesh()
    if _mesh_mod.is_rank_mesh(old_mesh) != _mesh_mod.is_rank_mesh(new_mesh):
        raise ValueError("live_reshape between a mesh of ranks and a mesh "
                         "of one process")
    _events.emit({
        "type": "lifecycle", "phase": "reshape_begin",
        "from_mesh": dict(old_mesh.shape), "to_mesh": dict(new_mesh.shape),
    })
    with_deadline("drain", quiesce, timeout_s=_drain_deadline())
    _memo.cache.clear()
    census = _reshape_census()
    go = _coherence.P_OK
    if _coherence.engaged():
        mine = _census_hash31(census)
        agreed = _coherence.agree("elastic:reshape", mine, reduce="bcast")
        if agreed != mine:
            go = _coherence.P_DROP
        decision = _coherence.agree("elastic:reshape:go", go, reduce="max")
    else:
        decision = go
    err: Optional[str] = None
    moved = []
    total = 0
    if decision == _coherence.P_OK:
        try:
            for _e, const, consts in census:
                value = _fuser.leaf_value(const)  # a spilled one comes back
                spec = _mesh_mod.default_spec(const.shape, new_mesh)
                src = _source(const, old_mesh)
                out = _reshard.reshard_value(
                    src, spec, mesh=new_mesh,
                    max_stage_bytes=max_stage_bytes)
                moved.append((consts, value, out))
                if out is not src:  # a leaf already in place moves nothing
                    total += out.value.numel() * out.value.element_size()
        except (_reshard.ReshardError, _coherence.CoherentAbort) as exc:
            err = f"{type(exc).__name__}: {exc}"[:200]
            moved = []
    else:
        err = "a rank voted no-go (census hash mismatch on a peer rank)"
    if err is None:
        for consts, old, new in moved:
            _adopt(consts, old, new.value, new.sharding)
        _mesh_mod.set_mesh(new_mesh)
        _registry.inc("elastic.live_reshapes")
        wall = round(time.perf_counter() - t0, 4)
        _events.emit({
            "type": "lifecycle", "phase": "reshape_live_complete",
            "arrays": len(moved), "bytes": int(total), "wall_s": wall,
        })
        return {"mode": "live", "arrays": len(moved),
                "bytes": int(total), "wall_s": wall}

    # Fallback rung: nothing was swapped, so the checkpoint sees the
    # world as it was before the reshape.
    _registry.inc("elastic.reshape_fallbacks")
    _events.emit({
        "type": "lifecycle", "phase": "reshape_fallback", "error": err,
    })
    tmp = _shared_tempdir() if manager is None else None
    root = manager if manager is not None else tmp
    mgr = root if isinstance(root, CheckpointManager) \
        else CheckpointManager(root)
    # whole values (a block leaf gathered: every rank calls in one order)
    tree = {str(i): _fuser.gather_const(const)
            for i, (_, const, _) in enumerate(census)}
    drain_to_checkpoint(mgr, step, tree)
    del tree
    res = resume(mgr, step=step, mesh=new_mesh)
    fresh = []
    for i in range(len(census)):
        c = res.state[str(i)]._const()
        fresh.append((_fuser.leaf_value(c), c.sharding))
    del res, c  # the restored arrays let go: their ledger entries with them
    for (e, const, consts), (val, sh) in zip(census, fresh):
        _adopt(consts, _fuser.leaf_value(const), val, sh)
    if tmp is not None:
        _barrier("ramba_elastic_reshape_tmp")  # every rank has read it
        if _distributed.in_driver():
            shutil.rmtree(tmp, ignore_errors=True)
    wall = round(time.perf_counter() - t0, 4)
    _events.emit({
        "type": "lifecycle", "phase": "reshape_checkpoint_complete",
        "arrays": len(census), "wall_s": wall,
    })
    return {"mode": "checkpoint", "arrays": len(census),
            "bytes": int(sum(e.nbytes for e, _, _ in census)),
            "wall_s": wall}


def _shared_tempdir() -> str:
    """A new temporary directory that every rank names alike: made by
    rank 0, its path broadcast to the others (the ranks of a job share a
    host's file system)."""
    import tempfile

    from ramba_tpu_torch.parallel import distributed as _distributed

    if _distributed.process_count() <= 1:
        return tempfile.mkdtemp(prefix="ramba-reshape-")
    buf = torch.zeros(4096, dtype=torch.uint8)
    if _distributed.in_driver():
        path = tempfile.mkdtemp(prefix="ramba-reshape-").encode()
        if len(path) > buf.numel():
            raise ValueError(f"temporary directory path too long: {path!r}")
        buf[:len(path)] = torch.frombuffer(bytearray(path), dtype=torch.uint8)
    got = _distributed.all_gather_small(buf)[0]
    return bytes(got.tolist()).rstrip(b"\0").decode()


def report() -> dict:
    """The elastic section of a diagnostics report (the reference's
    ``diagnostics.elastic_report``, which comes with ROADMAP A.9)."""
    return {
        "watchdog_s": watchdog_seconds(),
        "heartbeat_running": heartbeat_running(),
        # the interval rides along, so a reader can judge
        # last_beat_age_s against the cadence this rank was given
        "heartbeat_interval_s": round(_heartbeat_interval(), 3),
        "heartbeats": int(_registry.get("elastic.heartbeats")),
        "last_beat_age_s": (round(last_beat_age(), 4)
                            if last_beat_age() is not None else None),
        "last_progress_age_s": (round(last_progress_age(), 4)
                                if last_progress_age() is not None else None),
        "stalls": int(_registry.get("elastic.stalls")),
        "checkpoints": int(_registry.get("elastic.checkpoints")),
        "resumes": int(_registry.get("elastic.resumes")),
        "drains": int(_registry.get("elastic.drains")),
        "live_reshapes": int(_registry.get("elastic.live_reshapes")),
        "reshape_fallbacks": int(_registry.get("elastic.reshape_fallbacks")),
    }
