"""Deterministic fault-injection harness.

Counterpart of ``ramba_tpu/resilience/faults.py``, with its whole grammar,
so every recovery path of the port can be driven deterministically from
one env var (or :func:`configure`)::

    RAMBA_FAULTS="fileio:0.5,checkpoint_io:once,checkpoint:leaf:flip:bytes=2"

Grammar: a comma-separated list of ``site:mode[:kind][:bytes=N]``
specs.  Modes:

* ``once``      fire on the first check of that site, then disarm
* ``always``    fire on every check
* ``<int N>``   fire on the first N checks
* ``after=N``   fire on every check after the first N (checks 1..N pass)
* ``<float p>`` fire with probability p per check — via a PRNG seeded
  from ``RAMBA_FAULTS_SEED`` + site + call number
  (``random.Random(f"{seed}:{site}:{calls}")``, as in ``ramba_tpu``), so
  the fire pattern is a pure function of the seed and the same spec fires
  on the same calls in both packages.
* ``delay:ms=<n>`` sleep ``n`` milliseconds at every check of the site
  and then continue — no exception (slowness rather than failure).
* ``hang:ms=<n>`` like ``delay`` but semantically a *stall*.

``delay`` and ``hang`` accept an optional ``after=<k>`` *payload* (not
to be confused with the ``after=N`` raising *mode*): the first ``k``
checks pass untouched and the sleep fires exactly once, on check
``k+1``.  Without the payload they fire on every check.

* ``flip:bytes=<n>`` is the silent-data-corruption mode: it never
  raises and never fires from :func:`check` — instead the payload-
  carrying seams pass their bytes through :func:`corrupt` (or point
  :func:`corrupt_file` at an on-disk blob), and the harness XORs ``n``
  bytes (default 1) at deterministic offsets drawn from
  ``RAMBA_FAULTS_SEED`` + site + call number.  Like ``delay``/``hang``
  it takes an optional one-shot ``after=<k>`` payload.

Every spec additionally accepts a ``rank=<i>`` *payload*: the spec only
*fires* on rank ``i`` (``torch.distributed``'s rank, 0 without a process
group), while the per-site call counter still advances on every rank —
so schedules stay rank-aligned and only the injection itself is skewed.
Single-process, ``rank=0`` fires and any other rank disarms the spec.

The sites the port checks are ``fileio`` (every read and write of
``fileio.py``), ``checkpoint_io`` (every checkpoint save and restore
attempt), ``checkpoint:leaf`` (the flip seam of the checkpoint digest
verification), ``reshard:plan`` and ``reshard:stage`` (before a
reshard's first stage and before every stage, ``parallel/reshard.py``),
and the compile pipeline's: ``compile`` (before a fresh compile in the
fuser), ``execute`` (before every program call; ``delay:ms=`` here makes
a slow flush), ``compile:bucket`` (forges a compile-class plan that skips
its op-safety proof) and ``aot:blob`` (the flip seam of a kernel
library's digest check), and ``heartbeat`` (before each beat of the
elastic beacon, ``resilience/elastic.py``: ``heartbeat:hang:ms=...``
stalls one beat), and the serving plane's (``serve/overload.py``):
``serve:admit`` (every dispatch verdict; an injected fault becomes a
shed proposal, so ``serve:admit:3:rank=1`` makes every rank shed the
same three flushes through the ``serve:shed`` round) and ``serve:hedge``
(the primary attempt of a hedged dispatch:
``serve:hedge:delay:ms=200`` seeds a hedge race), and the fleet's
(``fleet/``, ``compile/persist.py``): ``fleet:admit`` (a replica's
admission of a step: a fault is a refusal the router redirects),
``compile:persist`` (clobbers a persistent-cache entry before its
lookup), and the flip seams ``memo:blob`` (a shared memo blob as read),
``migrate:payload`` (a migration's payload before its checks) and
``aot:blob`` (an entry as read, beside the libraries).  Site names may themselves contain colons: the site/mode
boundary in a spec is the FIRST ``:``-separated field that parses as a
mode token.  The ``oom`` site (or a trailing ``:oom`` kind) raises
:class:`InjectedResourceExhausted`, whose message carries the
``RESOURCE_EXHAUSTED`` marker the retry classifier keys on; a trailing
``:fatal`` kind raises a non-retryable fault.  An ``oom`` spec may carry a
byte-count payload (``bytes=<n>``, k/m/g suffixes).

``check(site)`` is a near-no-op (one dict lookup on an empty dict) when
no faults are configured, so call sites can stay unconditional.
"""

from __future__ import annotations

import os
import random
import threading
import warnings
from contextlib import contextmanager
from typing import Dict, Optional

from ramba_tpu_torch import common as _common
from ramba_tpu_torch.observe import events as _events
from ramba_tpu_torch.observe import registry as _registry


class InjectedFault(RuntimeError):
    """A fault raised by the injection harness (transient by default)."""

    retryable = True

    def __init__(self, site: str, call: int, detail: str = ""):
        self.site = site
        self.call = call
        msg = f"injected fault at site {site!r} (check #{call})"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


class InjectedResourceExhausted(InjectedFault):
    """Simulated device OOM; classified as the ``oom`` class, not
    retryable in place (retrying the identical allocation would just OOM
    again).  ``bytes`` carries the simulated allocation size when the
    spec supplied one (``oom:after=3:bytes=1g``), mirroring real
    out-of-memory messages that name the failed allocation."""

    retryable = False

    def __init__(self, site: str, call: int, nbytes: Optional[int] = None):
        self.bytes = nbytes
        detail = "RESOURCE_EXHAUSTED: simulated out of memory"
        if nbytes:
            detail += f" allocating {int(nbytes)} bytes"
        super().__init__(site, call, detail)


class InjectedFatalFault(InjectedFault):
    """Injected programming-error stand-in; must propagate unretried."""

    retryable = False


class _Spec:
    __slots__ = ("site", "mode", "kind", "n", "p", "nbytes", "delay_ms",
                 "after_n", "rank_i", "calls", "fired")

    def __init__(self, site: str, mode: str, kind: str,
                 n: Optional[int] = None, p: Optional[float] = None,
                 nbytes: Optional[int] = None,
                 delay_ms: Optional[float] = None,
                 after_n: Optional[int] = None,
                 rank_i: Optional[int] = None):
        self.site = site
        # "once" | "always" | "count" | "after" | "prob" | "delay" | "hang"
        self.mode = mode
        self.kind = kind      # "transient" | "oom" | "fatal" | "delay" | "hang"
        self.n = n
        self.p = p
        self.nbytes = nbytes  # simulated allocation size for oom kinds
        self.delay_ms = delay_ms  # sleep length for delay/hang modes
        self.after_n = after_n    # one-shot trigger for delay/hang modes
        self.rank_i = rank_i      # fire on this rank only (None = all)
        self.calls = 0
        self.fired = 0


_lock = threading.Lock()
_specs: Dict[str, _Spec] = {}
_seed = 0


def _is_mode_token(tok: str) -> bool:
    """True iff ``tok`` is a valid mode field — the site/mode boundary
    marker for colon-containing site names (``checkpoint:leaf``)."""
    tok = tok.strip().lower()
    if tok in ("once", "always", "delay", "hang", "flip"):
        return True
    if tok.startswith("after="):
        try:
            int(tok[len("after="):])
        except ValueError:
            return False
        return True
    try:
        float(tok)  # covers both integer counts and probabilities
    except ValueError:
        return False
    return True


def _parse_one(chunk: str) -> _Spec:
    parts = chunk.strip().split(":")
    if len(parts) < 2 or not parts[0]:
        raise ValueError(f"bad RAMBA_FAULTS spec {chunk!r}: want site:mode")
    # The site may itself contain colons ("checkpoint:leaf"): the mode is
    # the first field that parses as a mode token, everything before it
    # joins back into the site.  Legacy single-segment sites never look
    # like mode tokens, so old specs parse byte-identically.
    mi = next((i for i in range(1, len(parts))
               if _is_mode_token(parts[i])), None)
    if mi is None:
        raise ValueError(
            f"bad RAMBA_FAULTS spec {chunk!r}: no mode field "
            f"(once/always/delay/hang/after=N/<count>/<prob>)")
    site = ":".join(p.strip() for p in parts[:mi])
    mode = parts[mi].strip()
    kind = ""
    nbytes: Optional[int] = None
    delay_ms: Optional[float] = None
    after_n: Optional[int] = None
    rank_i: Optional[int] = None
    for extra in parts[mi + 1:]:
        extra = extra.strip().lower()
        if extra.startswith("rank="):
            if rank_i is not None:
                raise ValueError(
                    f"bad RAMBA_FAULTS spec {chunk!r}: duplicate rank=")
            try:
                rank_i = int(extra[len("rank="):])
            except ValueError:
                raise ValueError(
                    f"bad RAMBA_FAULTS rank= payload in {chunk!r}") from None
            if rank_i < 0:
                raise ValueError(
                    f"negative RAMBA_FAULTS rank= payload in {chunk!r}")
        elif extra.startswith("after="):
            if after_n is not None:
                raise ValueError(
                    f"bad RAMBA_FAULTS spec {chunk!r}: duplicate after=")
            try:
                after_n = int(extra[len("after="):])
            except ValueError:
                raise ValueError(
                    f"bad RAMBA_FAULTS after= payload in {chunk!r}") from None
            if after_n < 0:
                raise ValueError(
                    f"negative RAMBA_FAULTS after= payload in {chunk!r}")
        elif extra.startswith("ms="):
            if delay_ms is not None:
                raise ValueError(
                    f"bad RAMBA_FAULTS spec {chunk!r}: duplicate ms=")
            try:
                delay_ms = float(extra[len("ms="):])
            except ValueError:
                raise ValueError(
                    f"bad RAMBA_FAULTS ms= payload in {chunk!r}") from None
            if delay_ms < 0:
                raise ValueError(
                    f"negative RAMBA_FAULTS ms= payload in {chunk!r}")
        elif extra.startswith("bytes="):
            if nbytes is not None:
                raise ValueError(
                    f"bad RAMBA_FAULTS spec {chunk!r}: duplicate bytes=")
            try:
                nbytes = _common.parse_bytes(extra[len("bytes="):])
            except ValueError:
                raise ValueError(
                    f"bad RAMBA_FAULTS byte count in {chunk!r}") from None
        elif not kind:
            kind = extra
        else:
            raise ValueError(
                f"bad RAMBA_FAULTS spec {chunk!r}: too many fields")
    if kind not in ("", "oom", "fatal", "transient"):
        raise ValueError(f"bad RAMBA_FAULTS kind {kind!r} in {chunk!r}")
    if mode in ("delay", "hang"):
        # slowness/stall, not failure: sleeps, never raises.  With an
        # after=<k> payload the sleep fires exactly once (on check k+1);
        # without it, on every check.
        if kind:
            raise ValueError(
                f"bad RAMBA_FAULTS spec {chunk!r}: {mode} takes no kind")
        if delay_ms is None:
            raise ValueError(
                f"bad RAMBA_FAULTS spec {chunk!r}: {mode} needs ms=<n>")
        return _Spec(site, mode, mode, delay_ms=delay_ms, after_n=after_n,
                     rank_i=rank_i)
    if mode == "flip":
        # silent corruption, not failure: the site's corrupt()/
        # corrupt_file() seam XORs bytes, never raises.  Same one-shot
        # after=<k> payload shape as delay/hang.
        if kind:
            raise ValueError(
                f"bad RAMBA_FAULTS spec {chunk!r}: flip takes no kind")
        if delay_ms is not None:
            raise ValueError(
                f"bad RAMBA_FAULTS spec {chunk!r}: flip takes no ms=")
        return _Spec(site, "flip", "flip", nbytes=nbytes or 1,
                     after_n=after_n, rank_i=rank_i)
    if delay_ms is not None:
        raise ValueError(
            f"bad RAMBA_FAULTS spec {chunk!r}: ms= only valid with "
            f"delay/hang")
    if after_n is not None:
        raise ValueError(
            f"bad RAMBA_FAULTS spec {chunk!r}: after= payload only valid "
            f"with delay/hang/flip (use the after=N mode for raising "
            f"faults)")
    if not kind:
        kind = "oom" if site == "oom" else "transient"
    if mode == "once":
        return _Spec(site, "once", kind, nbytes=nbytes, rank_i=rank_i)
    if mode == "always":
        return _Spec(site, "always", kind, nbytes=nbytes, rank_i=rank_i)
    if mode.startswith("after="):
        return _Spec(site, "after", kind, n=int(mode[len("after="):]),
                     nbytes=nbytes, rank_i=rank_i)
    try:
        n = int(mode)
    except ValueError:
        pass
    else:
        if n < 0:
            raise ValueError(f"bad RAMBA_FAULTS count in {chunk!r}")
        return _Spec(site, "count", kind, n=n, nbytes=nbytes, rank_i=rank_i)
    try:
        p = float(mode)
    except ValueError:
        raise ValueError(f"bad RAMBA_FAULTS mode {mode!r} in {chunk!r}") from None
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"RAMBA_FAULTS probability out of [0,1] in {chunk!r}")
    return _Spec(site, "prob", kind, p=p, nbytes=nbytes, rank_i=rank_i)


def _parse(spec: Optional[str], strict: bool = True) -> Dict[str, _Spec]:
    out: Dict[str, _Spec] = {}
    if not spec:
        return out
    for chunk in spec.split(","):
        if not chunk.strip():
            continue
        try:
            sp = _parse_one(chunk)
        except ValueError:
            if strict:
                raise
            warnings.warn(f"ignoring malformed RAMBA_FAULTS chunk {chunk!r}")
            continue
        out[sp.site] = sp
    return out


def configure(spec: Optional[str], *, seed: Optional[int] = None,
              strict: bool = True) -> None:
    """Install a fault plan (replacing any previous one) and reset all
    per-site call counters.  ``configure(None)`` disarms everything."""
    global _specs, _seed
    with _lock:
        _specs = _parse(spec, strict=strict)
        if seed is not None:
            _seed = int(seed)
        else:
            try:
                _seed = int(os.environ.get("RAMBA_FAULTS_SEED", "0") or 0)
            except ValueError:
                _seed = 0


def reset() -> None:
    """Re-arm from the environment (``RAMBA_FAULTS``/``RAMBA_FAULTS_SEED``),
    dropping any programmatic configuration and all counters."""
    configure(os.environ.get("RAMBA_FAULTS"), strict=False)


def enabled() -> bool:
    return bool(_specs)


def configured(site: str) -> bool:
    """Whether a spec targets ``site``.  Rank-identical even for
    ``rank=``-skewed specs (the plan string is shared)."""
    return site in _specs


def stats() -> Dict[str, dict]:
    """Per-site ``{"calls": n, "fired": m}`` for the current plan."""
    with _lock:
        return {s.site: {"calls": s.calls, "fired": s.fired}
                for s in _specs.values()}


def _should_fire(sp: _Spec) -> bool:
    if sp.mode == "once":
        return sp.fired == 0
    if sp.mode in ("delay", "hang", "flip"):
        if sp.after_n is None:
            return True
        # one-shot: checks 1..k pass, check k+1 fires, later checks pass
        return sp.calls == sp.after_n + 1
    if sp.mode == "always":
        return True
    if sp.mode == "count":
        return sp.fired < (sp.n or 0)
    if sp.mode == "after":
        return sp.calls > (sp.n or 0)
    # "prob": deterministic in (seed, site, call number) — identical across
    # ranks, across reruns and across the two packages.
    rng = random.Random(f"{_seed}:{sp.site}:{sp.calls}")
    return rng.random() < (sp.p or 0.0)


def _process_index() -> int:
    return _events.rank_info()[0]


def check(site: str, **ctx) -> None:
    """Raise an injected fault if the plan says this check should fail.

    No-op (and allocation-free) when no plan is armed or the site is not
    named in it.
    """
    if not _specs:
        return
    with _lock:
        sp = _specs.get(site)
        if sp is None:
            return
        if sp.kind == "flip":
            # byte-flip specs fire only through corrupt()/corrupt_file(),
            # which own the call counter for that site
            return
        sp.calls += 1
        if sp.rank_i is not None and sp.rank_i != _process_index():
            # rank-skewed spec: the call counter advances on every rank
            # (schedules stay aligned) but only the target rank fires
            return
        if not _should_fire(sp):
            return
        sp.fired += 1
        call = sp.calls
        kind = sp.kind
        mode = sp.mode
        nbytes = sp.nbytes
        delay_ms = sp.delay_ms
    _registry.inc("resilience.fault_injected")
    _registry.inc(f"resilience.fault_injected.{site}")
    ev = {"type": "fault", "site": site, "call": call, "mode": mode,
          "kind": kind}
    if nbytes is not None:
        ev["bytes"] = nbytes
    if delay_ms is not None:
        ev["ms"] = delay_ms
    ev.update(ctx)
    _events.emit(ev)
    if kind in ("delay", "hang"):
        import time

        time.sleep((delay_ms or 0.0) / 1000.0)
        return
    if kind == "oom":
        raise InjectedResourceExhausted(site, call, nbytes)
    if kind == "fatal":
        raise InjectedFatalFault(site, call, "injected fatal")
    raise InjectedFault(site, call)


def corrupt(site: str, data: Optional[bytes], **ctx) -> Optional[bytes]:
    """Pass a payload through the byte-flip seam at ``site``.

    Identity (and allocation-free) when no ``flip`` spec targets the
    site; otherwise XORs ``bytes=<n>`` bytes at offsets drawn from a
    PRNG seeded by (seed, site, call number) — deterministic across
    reruns and across ranks, with ``rank=``/``after=`` composing the
    same way they do for ``delay``/``hang``.  ``None``/empty payloads
    pass through untouched (there is nothing to flip in them)."""
    if not _specs or not data:
        return data
    with _lock:
        sp = _specs.get(site)
        if sp is None or sp.kind != "flip":
            return data
        sp.calls += 1
        if sp.rank_i is not None and sp.rank_i != _process_index():
            return data
        if not _should_fire(sp):
            return data
        sp.fired += 1
        call = sp.calls
        n = max(1, int(sp.nbytes or 1))
    rng = random.Random(f"{_seed}:{site}:{call}:flip")
    buf = bytearray(data)
    offsets = sorted({rng.randrange(len(buf))
                      for _ in range(min(n, len(buf)))})
    for i in offsets:
        buf[i] ^= 0xFF
    _registry.inc("resilience.fault_injected")
    _registry.inc(f"resilience.fault_injected.{site}")
    ev = {"type": "fault", "site": site, "call": call, "mode": "flip",
          "kind": "flip", "bytes": len(offsets), "offsets": offsets}
    ev.update(ctx)
    _events.emit(ev)
    return bytes(buf)


def corrupt_file(site: str, path: str, **ctx) -> bool:
    """On-disk variant of :func:`corrupt`: flip bytes of the file at
    ``path`` in place (plain overwrite — this *is* the injected torn
    write).  Returns True iff the file was actually flipped.  Missing
    files and unarmed sites are no-ops."""
    if not _specs:
        return False
    with _lock:
        sp = _specs.get(site)
        if sp is None or sp.kind != "flip":
            return False
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return False
    flipped = corrupt(site, data, path=path, **ctx)
    if flipped == data or flipped is None:
        return False
    try:
        with open(path, "wb") as f:
            f.write(flipped)
    except OSError:
        return False
    return True


@contextmanager
def inject(site: str, mode: str = "once", *, kind: str = ""):
    """Temporarily arm one site (on top of whatever is configured)::

        with faults.inject("fileio", "once"):
            rt.load("x.npy")
    """
    sp = _parse_one(f"{site}:{mode}:{kind}" if kind else f"{site}:{mode}")
    with _lock:
        prev = _specs.get(site)
        _specs[site] = sp
    try:
        yield sp
    finally:
        with _lock:
            if prev is not None:
                _specs[site] = prev
            else:
                _specs.pop(site, None)


@contextmanager
def active(spec: str, *, seed: Optional[int] = None):
    """Temporarily install a full fault plan, restoring the old one after."""
    global _specs, _seed
    with _lock:
        prev_specs, prev_seed = _specs, _seed
    configure(spec, seed=seed)
    try:
        yield
    finally:
        with _lock:
            _specs, _seed = prev_specs, prev_seed


# Arm from the environment at import so `RAMBA_FAULTS=... python app.py`
# works with no code changes.  Malformed env chunks warn instead of
# raising: a typo in an env var must not take the import down.
reset()
