"""The persistent kernel cache (the ``RAMBA_CACHE`` directory).

Counterpart of ``ramba_tpu/compile/persist.py``.  ramba_tpu serializes XLA
executables so a second process deserializes instead of compiling.  This
port has no executable to serialize: what a program costs to get ready is
the ``nvcc`` build of its kernel source (seconds) and a plan over the
loaded library (milliseconds), and only the build is worth keeping.  The
lane therefore keeps the built libraries::

    <dir>/.ramba_cache            ownership marker (atomic init)
    <dir>/kernels/<lib>.so        built kernel libraries (``_build.py``
    <dir>/kernels/<lib>.so.sha    builds here while the lane is armed),
                                  each with its digest, checked before
                                  ``ctypes`` loads it

A library another process built is loaded without a build and counts as a
hit (``compile.persist_hit``).  Corruption is tolerated, never loaded: a
library that fails its digest is evicted and rebuilt, counted
``compile.persist_corrupt`` (fault site ``aot:blob`` flips bytes of a
library as read for its digest check, ``_build.verified``).

Program skeletons, ramba_tpu's other half of the lane, are not kept: a
skeleton would save the port no work until a warm pool preloads the
libraries and plans of saved programs (ROADMAP A.10).
"""

from __future__ import annotations

import os
import tempfile
import threading
from typing import Optional

from ramba_tpu_torch import _build, common
from ramba_tpu_torch.observe import registry as _registry

_MARKER = ".ramba_cache"

_lock = threading.Lock()
_state = {"dir": None, "armed": False, "init_error": None}

#: running counters: libraries loaded from the cache without a build, and
#: libraries evicted for failing their digest
stats = {"hits": 0, "corrupt": 0}


def reconfigure(directory: Optional[str] = None) -> None:
    """Arm the lane on the RAMBA_CACHE directory (or an explicit
    ``directory``).  A directory that cannot be made disarms the lane
    instead of raising; the kernel build directory follows the lane."""
    with _lock:
        _state["init_error"] = None
        if directory is None:
            directory = common.persistent_cache_path()
        _state["dir"] = directory or None
        _state["armed"] = bool(directory) and _init_dir(directory)
        _build.set_build_dir(os.path.join(directory, "kernels")
                             if _state["armed"] else None)


def _init_dir(path: str) -> bool:
    try:
        os.makedirs(os.path.join(path, "kernels"), exist_ok=True)
        marker = os.path.join(path, _MARKER)
        if not os.path.exists(marker):
            _atomic_write(marker, b"ramba_tpu_torch persistent cache\n")
        return True
    except OSError as e:
        _state["init_error"] = f"{type(e).__name__}: {e}"
        _registry.inc("compile.persist_init_error")
        return False


def _atomic_write(path: str, data: bytes) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), prefix=".tmp-")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def armed() -> bool:
    return bool(_state["armed"])


def cache_dir() -> Optional[str]:
    return _state["dir"]


def note_hit() -> None:
    """Count one library loaded from the armed cache without a build."""
    if not _state["armed"]:
        return
    with _lock:
        stats["hits"] += 1
    _registry.inc("compile.persist_hit")


def note_corrupt() -> None:
    """Count one library evicted for failing its digest."""
    with _lock:
        stats["corrupt"] += 1
    _registry.inc("compile.persist_corrupt")


def snapshot() -> dict:
    with _lock:
        d = dict(stats)
        d["dir"] = _state["dir"]
        d["armed"] = _state["armed"]
        d["init_error"] = _state["init_error"]
    return d


def reset() -> None:
    with _lock:
        for key in stats:
            stats[key] = 0
    reconfigure()


reconfigure()
