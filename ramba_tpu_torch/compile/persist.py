"""The persistent kernel cache and program skeletons (``RAMBA_CACHE``).

Counterpart of ``ramba_tpu/compile/persist.py``.  ramba_tpu serializes
XLA executables so a second process deserializes instead of compiling.
The port has no executable to serialize: what a program costs to get
ready is the ``nvcc`` build of its kernel source (seconds) and a plan over
the loaded library (milliseconds).  The cache therefore keeps the built
libraries, and beside them the program skeletons a warm pool rebuilds
programs from::

    <dir>/.ramba_cache            ownership marker (atomic init)
    <dir>/kernels/<lib>.so        built kernel libraries (``_build.py``
    <dir>/kernels/<lib>.so.sha    builds here while the cache is armed),
                                  each with its digest and the identity
                                  of the process that built it, checked
                                  before ``ctypes`` loads the library
    <dir>/programs/<fp>.pkl       program skeleton: instrs, leaf count
                                  and kinds, out slots, donation (none in
                                  the port), leaf signature, the scalar
                                  leaves' values, compile class
    <dir>/aot/<fp>-<sig>.aot      "AOT entry": the skeleton plus the
                                  kernel libraries (name and source) its
                                  program launches

A library loaded from the cache without a build counts a hit
(``compile.persist_hit``), and a cross-writer hit when another process
built it (``compile.persist_cross_hit``, ``stats["cross_hits"]``).  On a
compile-cache miss the fuser looks the program up (:func:`lookup`): an
entry loads its libraries, so the first launch builds nothing; no entry
counts a miss.  A fresh compile registers the program as a candidate and
saves its skeleton (:func:`note_compiled`); :func:`save_topk` writes the
entries of the most executed candidates.  A skeleton whose statics do
not pickle (a stencil's Python body) counts ``store_errors`` and is
skipped.  The warm pool (``compile/warmpool.py``) rebuilds a program from
its skeleton and launches it once on zero-filled examples, so the library
is loaded and the kernel planned before traffic arrives.

Corruption is tolerated, never raised: a library that fails its digest,
an entry or a skeleton that fails its envelope is evicted (counted
``compile.persist_corrupt``).  Fault sites: ``compile:persist`` clobbers
an entry before a lookup; ``aot:blob`` flips bytes of a library as read
for its digest check, and of an entry as read.

``RAMBA_AOT=0`` keeps the library cache and turns off skeletons and
entries.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import tempfile
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from ramba_tpu_torch import _build, common
from ramba_tpu_torch.observe import registry as _registry
from ramba_tpu_torch.resilience import faults as _faults
from ramba_tpu_torch.resilience import integrity as _integrity

_MARKER = ".ramba_cache"

#: integrity-envelope schema tags for the two persisted record kinds
AOT_SCHEMA = "aot.pkl"
PROGRAM_SCHEMA = "program.pkl"

_lock = threading.RLock()
_state = {"dir": None, "armed": False, "aot": False, "init_error": None}

#: running counters.  ``hits``: libraries loaded from the cache without a
#: build; ``cross_hits``: those another process built; ``entry_hits`` /
#: ``misses``: compile-cache misses that found an entry / none;
#: ``corrupt``: libraries, entries and skeletons evicted
stats = {
    "hits": 0,
    "cross_hits": 0,
    "entry_hits": 0,
    "misses": 0,
    "corrupt": 0,
    "stores": 0,
    "store_errors": 0,
    "bytes_read": 0,
    "bytes_written": 0,
    "programs_saved": 0,
}

# fingerprint -> candidate record for save_topk (bounded; no tensor refs)
_candidates: dict = {}
_CANDIDATE_MAX = 256


def reconfigure(directory: Optional[str] = None) -> None:
    """Arm the cache on the RAMBA_CACHE directory (or an explicit
    ``directory``).  A directory that cannot be made disarms the cache
    instead of raising; the kernel build directory follows it.
    ``RAMBA_AOT=0`` keeps the libraries and turns off the skeletons."""
    with _lock:
        _state["init_error"] = None
        if directory is None:
            directory = common.persistent_cache_path()
        _state["dir"] = directory or None
        _state["armed"] = bool(directory) and _init_dir(directory)
        _state["aot"] = _state["armed"] and (
            (os.environ.get("RAMBA_AOT") or "").strip().lower()
            not in ("0", "off", "false", "no"))
        _build.set_build_dir(os.path.join(directory, "kernels")
                             if _state["armed"] else None)


def _init_dir(path: str) -> bool:
    try:
        for sub in ("kernels", "aot", "programs"):
            os.makedirs(os.path.join(path, sub), exist_ok=True)
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


def aot_armed() -> bool:
    """Skeletons and entries on (the cache armed and ``RAMBA_AOT`` not
    0)."""
    return bool(_state["aot"])


def cache_dir() -> Optional[str]:
    return _state["dir"]


def note_hit(cross: bool = False) -> None:
    """Count one library loaded from the armed cache without a build;
    ``cross``: another process built it."""
    if not _state["armed"]:
        return
    with _lock:
        stats["hits"] += 1
        if cross:
            stats["cross_hits"] += 1
    _registry.inc("compile.persist_hit")
    if cross:
        _registry.inc("compile.persist_cross_hit")


def note_corrupt() -> None:
    """Count one library, entry or skeleton evicted for failing its
    check."""
    with _lock:
        stats["corrupt"] += 1
    _registry.inc("compile.persist_corrupt")


# -- leaf signatures ---------------------------------------------------------

def aval_sig(leaf_vals: Sequence) -> Optional[tuple]:
    """The per-leaf signature the fuser keys a compiled program on:
    ``("t", shape, dtype, device type)`` for a tensor, ``("s", module,
    type name)`` for a Python or NumPy scalar (the lowering reads the
    scalar's type, never its value).  None for any other leaf."""
    out = []
    for v in leaf_vals:
        if isinstance(v, torch.Tensor):
            out.append(("t", tuple(v.shape), str(v.dtype)[len("torch."):],
                        v.device.type))
        elif isinstance(v, (bool, int, float, complex, np.generic)):
            out.append(("s", type(v).__module__, type(v).__name__))
        else:
            return None
    return tuple(out)


def scalars_of(leaf_vals: Sequence) -> tuple:
    """The values of a program's scalar leaves (None for a tensor leaf):
    an ``arange`` step of 0 would not run, so a skeleton keeps them."""
    return tuple(None if isinstance(v, torch.Tensor)
                 else (v.item() if isinstance(v, np.generic) else v)
                 for v in leaf_vals)


def _example_vals(sig: tuple, scalars: Optional[Sequence] = None) -> list:
    """Arguments that reproduce a signature exactly: zero-filled tensors
    (a ``cuda`` leaf on the process device) and scalars of the recorded
    type, with the recorded values (``scalars``) or zero."""
    vals = []
    for i, rec in enumerate(sig):
        if rec[0] == "t":
            _t, shape, dtype, dev_type = rec
            dev = common.device() if dev_type != "cpu" else "cpu"
            vals.append(torch.zeros(shape, dtype=getattr(torch, dtype),
                                    device=dev))
        else:
            _s, module, name = rec
            typ = getattr(np, name) if module == "numpy" \
                else {"bool": bool, "int": int, "float": float,
                      "complex": complex}[name]
            v = scalars[i] if scalars is not None else None
            vals.append(typ(0 if v is None else v))
    return vals


def _sig_hash(sig: tuple) -> str:
    return hashlib.sha256(repr(sig).encode()).hexdigest()[:12]


def _entry_path(fp: str, sig: tuple) -> str:
    return os.path.join(_state["dir"], "aot", f"{fp}-{_sig_hash(sig)}.aot")


def _program_path(fp: str) -> str:
    return os.path.join(_state["dir"], "programs", f"{fp}.pkl")


def _libraries(program, leaf_vals) -> list:
    """``[(name, source)]`` of the kernel libraries the program launches
    (empty for the generic lowering)."""
    try:
        from ramba_tpu_torch.ops import kernel_backend

        return kernel_backend.libraries(program, leaf_vals)
    except Exception:  # noqa: BLE001 — an entry without libraries
        return []


# -- lookup / store ----------------------------------------------------------

def lookup(fp: str, leaf_vals: Sequence) -> bool:
    """The cache on a fuser compile-cache miss: an entry for ``fp`` and
    these leaves loads the kernel libraries it names from the cache (no
    ``nvcc``) and returns True; no entry counts a miss.  A corrupt entry,
    or an entry whose library is gone or fails its digest, is evicted,
    never raised."""
    if not _state["aot"]:
        return False
    sig = aval_sig(leaf_vals)
    if sig is None:
        return False
    path = _entry_path(fp, sig)
    try:
        _faults.check("compile:persist", fp=fp)
    except _faults.InjectedFault:
        # seeded corruption: clobber the entry so the tolerance path
        # (evict, then build as usual) runs instead of a clean hit
        try:
            with open(path, "wb") as f:
                f.write(b"corrupt")
        except OSError:
            pass
    if not os.path.exists(path):
        with _lock:
            stats["misses"] += 1
        _registry.inc("compile.persist_miss")
        return False
    try:
        with open(path, "rb") as f:
            raw = f.read()
        # flip seam (RAMBA_FAULTS='aot:blob:flip:...'): seeded silent
        # corruption of the entry just read, upstream of its digest
        raw = _faults.corrupt("aot:blob", raw, fp=fp)
        payload = pickle.loads(
            _integrity.unwrap(raw, AOT_SCHEMA, site="aot:blob"))
        if payload["fp"] != fp or payload["sig"] != sig:
            raise ValueError("entry key mismatch")
        libs = list(payload["libraries"])
        for name, source in libs:
            if not _build.verified(_build.so_path(name, source), name):
                raise ValueError(f"library {name} missing or corrupt")
    except Exception as e:  # noqa: BLE001 — tolerate any corruption shape
        note_corrupt()
        if not isinstance(e, _integrity.IntegrityError):
            _integrity.failure("aot:blob", "deserialize",
                               detail=repr(e)[:200], fp=fp)
        try:
            os.unlink(path)
        except OSError:
            pass
        return False
    for name, source in libs:
        _build.load(name, source)  # verified above: loads, never builds
    with _lock:
        stats["entry_hits"] += 1
        stats["bytes_read"] += len(raw)
    _registry.inc("compile.persist_entry_hit")
    return True


def note_compiled(fp: str, program, leaf_vals,
                  compile_class=None) -> None:
    """Register a fresh compile as a candidate for :func:`save_topk` and
    save its skeleton, so another process can warm it.  Compiles are
    rare, so the one small file write stays off the steady state."""
    if not _state["aot"]:
        return
    sig = aval_sig(leaf_vals)
    if sig is None:
        return
    with _lock:
        c = _candidates.get(fp)
        if c is not None:
            c["count"] += 1
            return
        if len(_candidates) >= _CANDIDATE_MAX:
            return
        scalars = scalars_of(leaf_vals)
        _candidates[fp] = {
            "program": program,
            "sig": sig,
            "scalars": scalars,
            "compile_class": compile_class,
            "libraries": _libraries(program, leaf_vals),
            "count": 1,
        }
    _save_program(fp, program, sig, scalars, compile_class)


def _skeleton(fp, program, sig, scalars, compile_class) -> dict:
    return {
        "fp": fp,
        "instrs": tuple(program.instrs),
        "n_leaves": program.n_leaves,
        "leaf_kinds": tuple(program.leaf_kinds),
        "out_slots": tuple(program.out_slots),
        "donate": (),  # torch has no buffer donation
        "sig": sig,
        "scalars": scalars,
        "compile_class": compile_class,
    }


def _save_program(fp, program, sig, scalars, compile_class) -> None:
    path = _program_path(fp)
    if os.path.exists(path):
        return
    try:
        _atomic_write(path, _integrity.wrap(
            pickle.dumps(_skeleton(fp, program, sig, scalars,
                                   compile_class)),
            PROGRAM_SCHEMA))
    except Exception:  # noqa: BLE001 — statics that do not pickle: count
        with _lock:
            stats["store_errors"] += 1
        _registry.inc("compile.persist_store_error")
        return
    with _lock:
        stats["programs_saved"] += 1


def load_program(fp: str) -> Optional[dict]:
    """A saved program skeleton (the warm pool, :func:`store_entry` in a
    fresh process).  A corrupt one is evicted, never raised."""
    if not _state["aot"]:
        return None
    path = _program_path(fp)
    if not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as f:
            raw = f.read()
        rec = pickle.loads(
            _integrity.unwrap(raw, PROGRAM_SCHEMA, site="aot:program"))
        if rec["fp"] != fp:
            raise ValueError("program key mismatch")
        return rec
    except Exception as e:  # noqa: BLE001
        note_corrupt()
        if not isinstance(e, _integrity.IntegrityError):
            _integrity.failure("aot:program", "deserialize",
                               detail=repr(e)[:200], fp=fp)
        try:
            os.unlink(path)
        except OSError:
            pass
        return None


def saved_fingerprints() -> list:
    """Fingerprints with a saved program skeleton."""
    if not _state["aot"]:
        return []
    try:
        names = os.listdir(os.path.join(_state["dir"], "programs"))
    except OSError:
        return []
    return sorted(n[:-4] for n in names if n.endswith(".pkl"))


def _rank_key(fp: str, count: int) -> tuple:
    """Rank candidates by the ledger's execution count, then by the
    in-process compile count."""
    try:
        from ramba_tpu_torch.observe import ledger as _ledger

        k = _ledger.snapshot().get("kernels", {}).get(fp)
        if k:
            return (int(k.get("exec", {}).get("count", 0)), count)
    except Exception:  # noqa: BLE001
        pass
    return (0, count)


def save_topk(k: int = 8) -> dict:
    """Write the entries of the top-K candidates (by executions)."""
    report = {"considered": 0, "stored": 0, "skipped": 0, "errors": 0}
    if not _state["aot"]:
        return report
    with _lock:
        cands = [(fp, dict(c)) for fp, c in _candidates.items()]
    cands.sort(key=lambda it: _rank_key(it[0], it[1]["count"]),
               reverse=True)
    for fp, c in cands[: max(0, int(k))]:
        report["considered"] += 1
        out = store_entry(fp, c)
        report[out] = report.get(out, 0) + 1
    return report


def store_entry(fp: str, candidate: dict) -> str:
    """Write one candidate's entry: its skeleton plus its kernel
    libraries, each built here first if it is not on disk (one ``nvcc``
    per missing source).  Returns ``stored``, ``skipped`` (already
    present) or ``errors``."""
    if not _state["aot"]:
        return "errors"
    sig = candidate["sig"]
    path = _entry_path(fp, sig)
    if os.path.exists(path):
        return "skipped"
    try:
        rec = _skeleton(fp, candidate["program"], sig,
                        candidate["scalars"], candidate["compile_class"])
        libs = list(candidate["libraries"])
        for name, source in libs:
            _build.build_so(name, source)
        data = _integrity.wrap(pickle.dumps(
            {"fp": fp, "sig": sig, "skeleton": rec, "libraries": libs}),
            AOT_SCHEMA)
        _atomic_write(path, data)
    except Exception:  # noqa: BLE001 — an entry is best-effort
        with _lock:
            stats["store_errors"] += 1
        _registry.inc("compile.persist_store_error")
        return "errors"
    with _lock:
        stats["stores"] += 1
        stats["bytes_written"] += len(data)
    _registry.inc("compile.persist_store")
    return "stored"


def snapshot() -> dict:
    with _lock:
        d = dict(stats)
        d["dir"] = _state["dir"]
        d["armed"] = _state["armed"]
        d["aot"] = _state["aot"]
        d["init_error"] = _state["init_error"]
        d["candidates"] = len(_candidates)
    return d


def reset() -> None:
    with _lock:
        for key in stats:
            stats[key] = 0
        _candidates.clear()
    reconfigure()


reconfigure()
