"""Effect & alias inference over the linearized post-rewrite program.

Counterpart of ``ramba_tpu/analyze/effects.py``.  :func:`static_token`
also folds what only the port's statics carry — a ``torch.dtype``, a
``torch.device``, a ``torch.Size`` (a tuple) and the mesh's
``NamedSharding`` — so the port's programs classify as the reference's
do (an unfolded ``torch.dtype`` would make every cast ``host`` and the
memo would never hit).

The fuser's compile cache keys *executables*; a result cache
(``core/memo.py``) must key *values* — which is only sound when a static
proof exists that re-running the program on the same inputs reproduces
the same bytes and that the cached result does not alias or consume a
caller-visible buffer.  This module is that proof.  Every instruction is
classified into one of three effect classes:

``pure``
    Deterministic function of its operand values and value-hashable
    statics.  The overwhelming majority of ops (elementwise maps,
    reductions, shape ops, matmul, iota-style constructors).
``rng``
    ``random``: deterministic *given its PRNG-key operand* — the key is
    an ordinary Const leaf, so an RNG program is memoizable exactly like
    a pure one (same key in, same sample out).
``host``
    Anything whose semantics escape the program text: an op carrying an
    identity-hashed Python callable in its statics (``fromfunction`` /
    ``apply`` / skeleton kernels with non-canonical fills, ``jnp_call``
    interop, a user's stencil or skeleton kernel), or a recorded static
    whose repr embeds a memory address.
    Host-effecting programs must never be memoized — two closures can
    repr identically and compute differently.

On top of the per-instruction classes, an alias/donation analysis:
an out slot below ``n_leaves`` *is* an input (the program returns a leaf
unchanged — caching it would alias a caller-visible buffer into the
cache), and a non-empty donate mask means executing the program consumes
an input buffer (replaying a cache hit would skip the donation the
caller's aliasing census already assumed).

``classify_program`` accepts both live ``fuser._Program`` objects and
the offline ``lint._RecordedProgram`` stand-ins (whose statics are
repr-truncated strings), so ``ramba-lint --memo-audit`` can run the same
certifier over a finished trace.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

#: Ops deterministic given their operands, one of which is a PRNG key.
RNG_OPS: Tuple[str, ...] = ("random",)

_VALUE_TYPES = (str, bytes, int, float, complex, bool, type(None))


def static_token(static: Any) -> Optional[Any]:
    """Canonical, value-hashed token for one instruction's ``static``
    tuple — or None when the static cannot be tokenized by value (it
    holds an identity-hashed object such as a closure).

    Folds environment-independent constants to stable forms: numpy and
    torch dtypes to their NumPy names (``torch.float32`` and
    ``np.dtype("float32")`` fold alike), numpy scalars to python values,
    devices and mesh shardings to their names, and objects with a
    value-based ``key`` to that key.
    A recorded repr-string static (offline trace replay) is accepted
    verbatim unless its repr embeds a memory address — ``<function f at
    0x...>`` hashes by identity, not value.
    """
    import numpy as np
    import torch

    if static is None:
        # the common bare-op case; wrapped so the return value None is
        # unambiguously "cannot tokenize", never a legal token
        return ("none",)
    if isinstance(static, str):
        if " at 0x" in static:
            return None
        return ("repr", static)
    if isinstance(static, _VALUE_TYPES):
        return static
    if isinstance(static, np.dtype):
        return ("dtype", str(static))
    if isinstance(static, torch.dtype):
        from ramba_tpu_torch.core.expr import to_np_dtype

        return ("dtype", str(to_np_dtype(static)))
    if isinstance(static, np.generic):
        return ("npval", str(static.dtype), static.item())
    if isinstance(static, torch.device):
        return ("device", str(static))
    if isinstance(static, (tuple, list)):
        parts = []
        for e in static:
            t = static_token(e)
            if t is None:
                return None
            parts.append(t)
        return ("seq", tuple(parts))
    if isinstance(static, frozenset):
        parts = []
        for e in static:
            t = static_token(e)
            if t is None:
                return None
            parts.append(t)
        return ("set", tuple(sorted(map(repr, parts))))
    sharding = _sharding_token(static)
    if sharding is not None:
        return sharding
    key = getattr(static, "key", None)
    if key is not None and type(static).__hash__ not in (
        None, object.__hash__
    ):
        inner = static_token(key)
        if inner is not None:
            return ("keyed", type(static).__name__, inner)
    return None


def _sharding_token(static: Any) -> Optional[Any]:
    """A mesh ``NamedSharding`` by value: its mesh's axis names, grid
    shape and ranks, and its canonical spec."""
    from ramba_tpu_torch.parallel.mesh import NamedSharding, canonical

    if not isinstance(static, NamedSharding):
        return None
    m = static.mesh
    ranks = None if m.ranks is None else tuple(int(r) for r in m.ranks.flat)
    return ("sharding", tuple(m.axis_names), tuple(m.devices.shape), ranks,
            static_token(canonical(static.spec)))


@dataclasses.dataclass(frozen=True)
class EffectReport:
    """The certifier's verdict on one linearized program.

    ``classes``       per-instruction effect class, ``instrs``-aligned.
    ``program_class`` ``"pure"`` / ``"rng"`` / ``"host"`` — the max over
                      all instructions.
    ``rng_instrs``    indices of RNG-keyed instructions.
    ``host_instrs``   ``(index, reason)`` for every host-effecting one.
    ``alias_outs``    out slots that are leaf slots: the program returns
                      an input unchanged (alias-escaping result).
    ``donating``      the donate mask names at least one leaf.
    ``memoizable``    the whole-program verdict ``core/memo.py`` keys on.
    ``reason``        why not memoizable ("" when it is).
    """

    classes: Tuple[str, ...]
    program_class: str
    rng_instrs: Tuple[int, ...]
    host_instrs: Tuple[Tuple[int, str], ...]
    alias_outs: Tuple[int, ...]
    donating: bool
    memoizable: bool
    reason: str


def classify_instr(op: str, static: Any) -> Tuple[str, str]:
    """Effect class of a single instruction: ``(class, reason)`` where
    ``reason`` is non-empty only for ``host``."""
    if op in RNG_OPS:
        # the PRNG key is an operand; statics (kind/shape/dtype/spec)
        # must still tokenize or the op degrades to host below
        if static_token(static) is not None:
            return "rng", ""
        return "host", f"{op} static is not value-hashable"
    if static_token(static) is None:
        return "host", f"{op} static holds an identity-hashed object"
    return "pure", ""


# (program.key, donate) -> EffectReport, bounded: the verdict is pure in
# both, and the memo certifies every repeated flush
_reports: dict = {}
_REPORTS_MAX = 1024


def classify_program(program: Any, donate: Tuple[int, ...] = ()) -> EffectReport:
    """Run the effect/alias certifier over one linearized program (live
    ``fuser._Program`` or a recorded stand-in).  Memoized on
    ``(program.key, donate)``."""
    key = getattr(program, "key", None)
    if key is not None:
        key = (key, tuple(donate))
        try:
            got = _reports.get(key)
        except TypeError:  # an unhashable static
            key = got = None
        if got is not None:
            return got
    rep = _classify(program, donate)
    if key is not None:
        if len(_reports) >= _REPORTS_MAX:
            _reports.clear()
        _reports[key] = rep
    return rep


def _classify(program: Any, donate: Tuple[int, ...]) -> EffectReport:
    classes = []
    rng: list = []
    host: list = []
    for i, (op, static, _args) in enumerate(program.instrs):
        cls, why = classify_instr(op, static)
        classes.append(cls)
        if cls == "rng":
            rng.append(i)
        elif cls == "host":
            host.append((i, why))
    if host:
        program_class = "host"
    elif rng:
        program_class = "rng"
    else:
        program_class = "pure"
    n = program.n_leaves
    alias_outs = tuple(s for s in program.out_slots if s < n)
    donating = bool(donate)
    reason = ""
    if host:
        i, why = host[0]
        reason = f"host-effecting instr {i}: {why}"
    elif alias_outs:
        reason = (
            f"output slot {alias_outs[0]} aliases a program input "
            "(alias-escaping result)"
        )
    elif donating:
        reason = "program donates input buffers; replay would skip donation"
    return EffectReport(
        classes=tuple(classes),
        program_class=program_class,
        rng_instrs=tuple(rng),
        host_instrs=tuple(host),
        alias_outs=alias_outs,
        donating=donating,
        memoizable=not reason,
        reason=reason,
    )
