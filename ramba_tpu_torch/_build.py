"""Build step for the hand-written kernels.

Kernels are built at first use, from the sources in this package only, into
``ramba_tpu_torch/_build/`` (listed in ``.gitignore``): every generated CUDA
C++ source (elemred, stencil, segred) goes through ``nvcc`` into a shared
library with a plain C entry point, loaded with ``ctypes``.  No PyTorch
headers are included, so a build takes seconds.  Each build is cached by
the hash of its source, the headers of ``csrc/`` and the flags.

A failed build raises with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # no fused multiply-add contraction: each kernel rounds every operation
    # exactly where its plain PyTorch version does
    "--fmad=false",
]

_libs: dict = {}
_lock = threading.Lock()


def _ensure_dir() -> str:
    os.makedirs(BUILD_DIR, exist_ok=True)
    return BUILD_DIR


def write_source(name: str, text: str) -> str:
    """Write ``text`` to ``_build/name`` atomically; returns the path."""
    path = os.path.join(_ensure_dir(), name)
    if os.path.exists(path):
        with open(path) as f:
            if f.read() == text:
                return path
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        f.write(text)
    os.replace(tmp, path)
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


def build_so(name: str, source: str) -> str:
    """Compile one CUDA source to a shared library (cached); returns its
    path.  Raises with nvcc's output when the build fails."""
    out = so_path(name, source)
    if os.path.exists(out):
        return out
    cu = write_source(os.path.basename(out)[:-3] + ".cu", source)
    tmp = out + f".{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp, cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name} ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
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
    """Build (if needed) and load one CUDA source; loaded once per process."""
    with _lock:
        lib = _libs.get(source)
    if lib is None:
        path = build_so(name, source)
        with _lock:
            lib = _libs.get(source)
            if lib is None:
                lib = _libs[source] = ctypes.CDLL(path)
    return lib
