"""Build step for the hand-written kernels.

Kernels are built at first use, from the sources in this package only: every
generated CUDA C++ source (elemred, stencil, segred, the scan) goes through
``nvcc`` into a shared library with a plain C entry point, loaded with
``ctypes``.  No PyTorch headers are included, so a build takes seconds.
Each build is cached by the hash of its source, the headers of ``csrc/`` and
the flags, in ``ramba_tpu_torch/_build/`` (listed in ``.gitignore``), or in
``<RAMBA_CACHE>/kernels/`` when the persistent cache is armed
(``compile/persist.py``), where the next process finds it.

Every library gets a digest beside it (``<lib>.so.sha``, an integrity
envelope over the digest and the identity of the process that built it,
host and pid), checked before ``ctypes`` loads the library: a corrupt or
truncated library is evicted and rebuilt (counted
``compile.persist_corrupt``), never loaded.  The fault site ``aot:blob``
flips bytes of the library as read for that check.  Check, build, digest,
replace and load of one library happen under an exclusive lock on
``<lib>.so.lock``, so processes sharing a build directory never pair one
build's library with another's digest, nor evict a library another is
about to load.  ``nvcc_builds`` counts the builds this process ran
(``compile.nvcc_builds``), ``disk_loads`` the libraries it loaded that it
did not build (``compile.kernel_loads``; a persist hit when the cache is
armed, and a cross-writer hit, ``compile.persist_cross_hit``, when another
process built it).

A failed build raises with the compiler's output; nothing falls back.  Any
other failure to build or load a library (the compiler missing or not
started, a full disk, ``ctypes`` unable to open the library) raises as
:class:`KernelBuildError` too, which the retry engine and the degradation
ladder take as fatal.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import json
import os
import shutil
import socket
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
DIGEST_SCHEMA = "kernel.so"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # no fused multiply-add contraction: each kernel rounds every operation
    # exactly where its plain PyTorch version does
    "--fmad=false",
]

_libs: dict = {}
_lock = threading.Lock()
_build_dir = BUILD_DIR

# builds run and libraries loaded from disk by this process
nvcc_builds = 0
disk_loads = 0


def set_build_dir(path=None) -> str:
    """Where libraries are built and looked for: ``path`` (the persistent
    cache's ``kernels/``), or ``_build/`` for None.  Libraries already
    loaded stay loaded."""
    global _build_dir
    _build_dir = path or BUILD_DIR
    return _build_dir


def build_dir() -> str:
    return _build_dir


def _ensure_dir() -> str:
    d = _build_dir
    os.makedirs(d, exist_ok=True)
    return d


def _atomic_write(path: str, data: bytes) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
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


def write_source(name: str, text: str) -> str:
    """Write ``text`` to ``<build dir>/name`` atomically; returns the
    path."""
    path = os.path.join(_ensure_dir(), name)
    if os.path.exists(path):
        with open(path) as f:
            if f.read() == text:
                return path
    _atomic_write(path, text.encode())
    return path


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc")


def _headers_digest() -> str:
    h = hashlib.sha256()
    for name in sorted(os.listdir(CSRC_DIR)):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()


def so_path(name: str, source: str) -> str:
    key = hashlib.sha256(
        (source + _headers_digest() + " ".join(NVCC_FLAGS)).encode()
    ).hexdigest()[:16]
    return os.path.join(_ensure_dir(), f"{name}_{key}.so")


class KernelBuildError(RuntimeError):
    """A kernel source failed to build: fatal to the retry engine and the
    degradation ladder (a rebuild of the same source fails the same
    way)."""


@contextlib.contextmanager
def _as_build_error(name: str):
    """Re-raise whatever fails while ``name`` is built or loaded as a
    :class:`KernelBuildError`, chaining the original: an ``OSError`` here
    would otherwise read as retryable, and a rung below would hide the
    missing kernel."""
    try:
        yield
    except KernelBuildError:
        raise
    except Exception as e:
        raise KernelBuildError(
            f"could not build or load {name}: {type(e).__name__}: {e}") from e


def _run_nvcc(cmd: list) -> subprocess.CompletedProcess:
    """One compiler run (the seam the CPU tests replace)."""
    return subprocess.run(cmd, capture_output=True, text=True)


def _digest_path(so: str) -> str:
    return so + ".sha"


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _evict(so: str, name: str, reason: str) -> None:
    """Take a library that failed its digest check off the disk and count
    it; the caller rebuilds."""
    from ramba_tpu_torch.compile import persist
    from ramba_tpu_torch.resilience import integrity

    for path in (so, _digest_path(so)):
        try:
            os.unlink(path)
        except OSError:
            pass
    persist.note_corrupt()
    integrity.failure("aot:blob", reason, lib=name)


def writer_identity() -> dict:
    """The identity a build records beside its library."""
    return {"host": socket.gethostname(), "pid": os.getpid()}


def _parse_digest(payload: bytes) -> tuple:
    """``(digest, writer)`` of a digest envelope's payload: JSON with both,
    or a bare digest (writer None)."""
    text = payload.decode()
    if text.startswith("{"):
        doc = json.loads(text)
        return str(doc["digest"]), doc.get("writer")
    return text, None


def writer_of(so: str) -> Optional[dict]:
    """The identity of the process that built the library at ``so`` (None
    when its digest records none or cannot be read)."""
    from ramba_tpu_torch.resilience import integrity

    try:
        with open(_digest_path(so), "rb") as f:
            return _parse_digest(integrity.unwrap(
                f.read(), DIGEST_SCHEMA, site="aot:blob"))[1]
    except (OSError, ValueError, KeyError, integrity.IntegrityError):
        return None


def verified(so: str, name: str) -> bool:
    """True when the library at ``so`` matches its digest.  Reads the
    library through the ``aot:blob`` flip seam; a mismatch, a missing
    digest or an unreadable file evicts the library."""
    from ramba_tpu_torch.resilience import faults, integrity

    if not os.path.exists(so):
        return False
    try:
        with open(so, "rb") as f:
            raw = f.read()
        with open(_digest_path(so), "rb") as f:
            want = _parse_digest(integrity.unwrap(f.read(), DIGEST_SCHEMA,
                                                  site="aot:blob"))[0]
    except (OSError, integrity.IntegrityError, ValueError, KeyError):
        _evict(so, name, "digest")
        return False
    raw = faults.corrupt("aot:blob", raw, lib=name)
    if _sha256(raw) != want:
        _evict(so, name, "digest")
        return False
    return True


@contextlib.contextmanager
def _locked(so: str):
    """An exclusive lock on ``<so>.lock`` (between processes, and between
    threads: each holds its own open file)."""
    fd = os.open(so + ".lock", os.O_CREAT | os.O_RDWR, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)


def _build_locked(out: str, name: str, source: str) -> bool:
    """Make sure a verified library is at ``out`` (the caller holds its
    lock); True when this call built it."""
    global nvcc_builds
    if verified(out, name):
        return False
    cu = write_source(os.path.basename(out)[:-3] + ".cu", source)
    tmp = out + f".{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp, cu]
    proc = _run_nvcc(cmd)
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed for {name} ({proc.returncode}):\n{proc.stderr[-4000:]}")
    from ramba_tpu_torch.observe import registry
    from ramba_tpu_torch.resilience import integrity

    with open(tmp, "rb") as f:
        digest = _sha256(f.read())
    doc = json.dumps({"digest": digest, "writer": writer_identity()})
    _atomic_write(_digest_path(out),
                  integrity.wrap(doc.encode(), DIGEST_SCHEMA))
    os.replace(tmp, out)
    with _lock:
        nvcc_builds += 1
    registry.inc("compile.nvcc_builds")
    return True


def build_so(name: str, source: str) -> str:
    """Compile one CUDA source to a shared library (cached); returns its
    path.  A library already on disk is checked against its digest first
    and rebuilt when it fails.  Raises :class:`KernelBuildError`, with
    nvcc's output, when the build fails."""
    with _as_build_error(name):
        out = so_path(name, source)
        with _locked(out):
            _build_locked(out, name, source)
    return out


def build_many(named_sources) -> list:
    """Build several sources at once, one nvcc per source, all started
    together.  Returns the library paths in order."""
    items = list(named_sources)
    if not items:
        return []
    with ThreadPoolExecutor(max_workers=len(items)) as ex:
        return list(ex.map(lambda it: build_so(*it), items))


def load(name: str, source: str) -> ctypes.CDLL:
    """Build (if needed) and load one CUDA source; loaded once per
    process, after its digest check, under the library's lock."""
    global disk_loads
    with _lock:
        lib = _libs.get(source)
    if lib is not None:
        return lib
    with _as_build_error(name):
        out = so_path(name, source)
        with _locked(out):
            built = _build_locked(out, name, source)
            with _lock:
                lib = _libs.get(source)
                if lib is not None:
                    return lib
                lib = _libs[source] = ctypes.CDLL(out)
                if not built:
                    disk_loads += 1
    if not built:
        from ramba_tpu_torch.compile import persist
        from ramba_tpu_torch.observe import registry

        registry.inc("compile.kernel_loads")
        writer = writer_of(out)
        persist.note_hit(cross=writer is not None
                         and writer != writer_identity())
    return lib


def loaded(source: str) -> bool:
    """Whether this process has loaded the library of ``source``."""
    with _lock:
        return source in _libs


def counts() -> tuple:
    """``(nvcc_builds, disk_loads)`` so far: a caller takes the difference
    around a call to learn what it cost."""
    return nvcc_builds, disk_loads
