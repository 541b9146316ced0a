"""Runtime configuration and device selection for ramba_tpu_torch.

The counterpart of ``ramba_tpu/common.py``: environment flags read once at
import, plus the one device every array of the process lives on.

Entry points run on ``cuda:<local rank mod card count>`` (``cuda:0`` for
one process).  The CPU is used only when the caller asks for it, through
:func:`set_device` or ``RAMBA_TORCH_DEVICE=cpu``; with no card and no
such request the first array creation raises, so a missing GPU never
turns silently into a CPU run.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import NamedTuple

import torch

_FALSY = ("0", "", "false", "False", "FALSE", "no", "NO", "off", "OFF")
_TRUTHY = ("1", "true", "True", "TRUE", "yes", "YES", "on", "ON")


def _env_flag(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() not in ("0", "", "false", "no", "off")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


_BYTE_SUFFIXES = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}


def parse_bytes(s) -> int:
    """Parse a byte count: a plain integer or an integer/float with a
    ``k``/``m``/``g``/``t`` suffix (binary multiples, case-insensitive,
    optional trailing ``b``/``ib``): ``"512k"`` → 524288, ``"1.5g"`` →
    1610612736.  The fault harness's ``bytes=`` payload uses it.  Raises
    ValueError on junk."""
    if isinstance(s, (int, float)):
        return int(s)
    text = str(s).strip().lower()
    if not text:
        raise ValueError("empty byte count")
    for tail in ("ib", "b"):
        if text.endswith(tail) and text[:-len(tail)][-1:] in _BYTE_SUFFIXES:
            text = text[:-len(tail)]
            break
    mult = 1
    if text[-1:] in _BYTE_SUFFIXES:
        mult = _BYTE_SUFFIXES[text[-1]]
        text = text[:-1]
    return int(float(text) * mult)


# Debug and timing levels, as in ramba_tpu (RAMBA_DEBUG, RAMBA_TIMING):
# RAMBA_TIMING > 0 prints ``utils.timing.timing_summary`` at exit and
# files per-program times; > 1 also names every launch in profiler traces.
debug_level = _env_int("RAMBA_DEBUG", 0)
timing_level = _env_int("RAMBA_TIMING", 0)

# Max pending lazy ops before a forced flush (bounds host-side graph memory).
max_pending_ops = _env_int("RAMBA_TPU_MAX_PENDING", 10_000)

# Max instructions per fused program.  A flush whose program is longer runs
# segment by segment inside the flush (``fuser._run_segmented``), each
# segment at most this many instructions, as in ramba_tpu; 0 turns
# segmentation off (RAMBA_TPU_MAX_PROGRAM_INSTRS).
max_program_instrs = _env_int("RAMBA_TPU_MAX_PROGRAM_INSTRS", 384)

# Pattern rewrites of the lazy graph at every flush (core/rewrite.py); on
# by default, as in ramba_tpu (RAMBA_TPU_REWRITE=0 turns them off).
rewrite_enabled = _env_flag("RAMBA_TPU_REWRITE", True)

# Arrays smaller than this stay whole on every shard (replicated), as in
# ramba_tpu (RAMBA_DIST_THRESHOLD).
dist_threshold = _env_int("RAMBA_DIST_THRESHOLD", 100)

# Caps the default mesh of a multi-process run at this many ranks, as
# ramba_tpu caps its device count (RAMBA_WORKERS; unset: every rank).
num_workers_env = os.environ.get("RAMBA_WORKERS")

# Dimensions of the default mesh (RAMBA_TPU_MESH_NDIM, 1 to 3), as in
# ramba_tpu: 4 ranks give a 2x2 mesh.
mesh_ndim = _env_int("RAMBA_TPU_MESH_NDIM", 2)

_device: "torch.device | None" = None
_device_asked = False  # set_device or RAMBA_TORCH_DEVICE chose it
_local_rank = 0


def set_local_rank(rank: int) -> None:
    """This process's rank on its host (``distributed.initialize``): the
    card it computes on unless a device was asked for."""
    global _local_rank, _device
    _local_rank = int(rank)
    if not _device_asked:
        _device = None


def set_device(dev) -> torch.device:
    """Pin the device every new array is created on (``"cpu"`` or a CUDA
    device).  Arrays that already exist stay where they are."""
    global _device, _device_asked
    _device_asked = True
    _device = torch.device(dev)
    if _device.type == "cuda" and _device.index is None:
        _device = torch.device("cuda", 0)
    return _device


_scope = threading.local()  # device_scope's device, per thread


@contextlib.contextmanager
def device_scope(dev):
    """Every new value this thread creates inside the block goes to
    ``dev`` (the degradation ladder's host rung runs a whole program on
    the CPU); other threads keep the process device."""
    prev = getattr(_scope, "device", None)
    _scope.device = torch.device(dev)
    try:
        yield _scope.device
    finally:
        _scope.device = prev


def device() -> torch.device:
    """The device new arrays are created on.  Raises when no card is present
    and the CPU was not asked for."""
    global _device
    scoped = getattr(_scope, "device", None)
    if scoped is not None:
        return scoped
    if _device is not None:
        return _device
    env = os.environ.get("RAMBA_TORCH_DEVICE", "").strip()
    if env:
        return set_device(env)
    if torch.cuda.is_available():
        _device = torch.device("cuda",
                               _local_rank % torch.cuda.device_count())
        return _device
    raise RuntimeError(
        "ramba_tpu_torch: no CUDA device is available. Run on a GPU, or ask "
        "for the CPU explicitly with ramba_tpu_torch.common.set_device('cpu') "
        "or RAMBA_TORCH_DEVICE=cpu."
    )


# ---------------------------------------------------------------------------
# the persistent kernel cache (RAMBA_CACHE)
# ---------------------------------------------------------------------------

# RAMBA_CACHE=1 for the default directory or RAMBA_CACHE=/some/dir: built
# kernel libraries survive into the next process
# (``compile/persist.py``), as ramba_tpu keeps its executables there.
cache_env = os.environ.get("RAMBA_CACHE")


class CacheStatus(NamedTuple):
    """Result of :func:`setup_persistent_cache`: a failed init is a state
    the caller can report, not a silent no-op."""

    path: "str | None"   # resolved cache directory (None: disabled)
    ok: bool             # every init step succeeded (True when disabled)
    error: "str | None"  # the first failure, when ok is False

    @property
    def enabled(self) -> bool:
        return self.path is not None


def persistent_cache_path() -> "str | None":
    """The RAMBA_CACHE directory (None when disabled), read from the live
    environment so a runtime toggle takes effect.  ``RAMBA_CACHE=1``
    means ``~/.ramba_tpu_torch_cache``, a directory of the port's own."""
    env = os.environ.get("RAMBA_CACHE", cache_env)
    if not env or env in _FALSY:
        return None
    if env in _TRUTHY:
        return os.path.expanduser("~/.ramba_tpu_torch_cache")
    return os.path.expanduser(env)


def setup_persistent_cache() -> CacheStatus:
    """Arm the persistent kernel cache if RAMBA_CACHE is set: kernel
    libraries build into ``<dir>/kernels/``
    (``compile.persist.reconfigure``).  Emits a ``compile.persist_init``
    event when the cache is enabled."""
    path = persistent_cache_path()
    if path is None:
        from ramba_tpu_torch.compile import persist

        persist.reconfigure()
        return CacheStatus(None, True, None)
    error = None
    try:
        os.makedirs(path, exist_ok=True)
        from ramba_tpu_torch.compile import persist

        persist.reconfigure()
        error = persist.snapshot()["init_error"]
    except Exception as e:  # noqa: BLE001 — a bad dir must not kill import
        error = f"{type(e).__name__}: {e}"
    status = CacheStatus(path, error is None, error)
    try:
        from ramba_tpu_torch.observe import events

        events.emit({"type": "compile.persist_init", "path": status.path,
                     "ok": status.ok, "error": status.error})
    except Exception:  # noqa: BLE001 — observability must not break init
        pass
    return status
