"""Canonical subgraph hashing: a *semantic* program fingerprint.

Counterpart of ``ramba_tpu/analyze/canon.py``: the same normalizations, so
the same programs fall into the same equivalence classes in both packages.

``fuser._Program.key`` is structural — it changes when the same
computation is linearized with its leaves in a different order, and it
is identical for ``add(a, b)`` vs ``add(b, a)`` only by accident of slot
numbering.  The result cache (``core/memo.py``) and serving-batch CSE
need the opposite: a fingerprint that is *stable across sessions,
tenants and leaf orderings* and that identifies semantically equal
subgraphs.  Three normalizations get us there:

* **alpha renaming** — leaf slots are renumbered by their first visit in
  a canonical traversal from the outputs, so two programs that differ
  only in leaf collection order hash identically (``leaf_order`` maps
  the canonical numbering back to original slots, which is how the memo
  key binds input versions in canonical order);
* **commutative-operand normalization** — operands of commutative maps
  (``add``, ``multiply``, ``logical_and``, ...) are ordered by their
  subtree signature, so ``a + b`` and ``b + a`` are one subgraph;
* **static folding** — statics are folded to value tokens
  (:func:`~ramba_tpu_torch.analyze.effects.static_token`): numpy and
  torch dtypes to names, numpy scalars to python values, keyed wrappers
  to their value keys.  A static that only hashes by identity makes the
  program :class:`NotCanonical` — such programs are never memoized.

Dead instructions (feeding no output — the graph-hygiene rule flags
them) do not contribute: the hash is computed over the subgraph
reachable from ``out_slots`` only, and unreachable leaves get no
canonical id.

Works on live ``fuser._Program`` objects and on the offline
``lint._RecordedProgram`` stand-ins (repr-string statics), so
``ramba-lint --memo-audit`` groups trace events by the same hash the
live cache keys on.
"""

from __future__ import annotations

import dataclasses
import hashlib
import re
from typing import Any, Dict, List, Optional, Tuple

from ramba_tpu_torch.analyze.effects import static_token

#: Binary elementwise ops whose operand order is semantically irrelevant.
COMMUTATIVE: Tuple[str, ...] = (
    "add", "multiply", "maximum", "minimum", "fmax", "fmin",
    "logical_and", "logical_or", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_xor",
    "equal", "not_equal", "hypot", "logaddexp", "logaddexp2",
    "gcd", "lcm",
)

_MAP_NAME_RE = re.compile(r"^\(u?'([A-Za-z0-9_]+)',\)")


class NotCanonical(ValueError):
    """The program cannot be canonically hashed (an identity-hashed
    static); such a program is never admitted to the result cache."""


@dataclasses.dataclass(frozen=True)
class CanonForm:
    """Canonicalization result.

    ``chash``      the semantic fingerprint (sha256 prefix of ``form``).
    ``form``       full serialized canonical structure — collision
                   detection compares forms, not hashes.
    ``leaf_order`` original leaf slots in canonical (alpha) order; leaves
                   unreachable from the outputs are excluded.
    ``n_leaves``   leaf count of the source program.
    """

    chash: str
    form: str
    leaf_order: Tuple[int, ...]
    n_leaves: int


def _commutes(op: str, static: Any) -> bool:
    """Whether this instruction's operands may be reordered freely."""
    if op in COMMUTATIVE:
        return True  # synthetic programs use bare ufunc names as ops
    if op != "map":
        return False
    if isinstance(static, tuple) and len(static) == 1 \
            and isinstance(static[0], str):
        return static[0] in COMMUTATIVE
    if isinstance(static, str):  # recorded repr-string static
        m = _MAP_NAME_RE.match(static)
        return bool(m) and m.group(1) in COMMUTATIVE
    return False


def _h(parts: Any) -> str:
    return hashlib.sha256(repr(parts).encode()).hexdigest()[:24]


# program.key -> CanonForm: the form is pure in the program's structure,
# and a repeated flush (the memo's case) would rehash every node again.
# Bounded; the key holds its statics, so none dies and has its id reused.
_forms: Dict[Any, CanonForm] = {}
_FORMS_MAX = 1024


def canonicalize(program: Any) -> CanonForm:
    """Canonicalize one linearized program.  Raises :class:`NotCanonical`
    when any reachable instruction's static cannot be value-tokenized,
    or when the program is structurally malformed (out-of-range slots —
    the graph-hygiene rule's findings, surfaced here as uncanonical
    rather than a crash).  Memoized on ``program.key``."""
    key = getattr(program, "key", None)
    try:
        got = _forms.get(key) if key is not None else None
    except TypeError:  # an unhashable static
        key = None
        got = None
    if got is not None:
        return got
    form = _canonicalize(program)
    if key is not None:
        if len(_forms) >= _FORMS_MAX:
            _forms.clear()
        _forms[key] = form
    return form


def _canonicalize(program: Any) -> CanonForm:
    n = int(program.n_leaves)
    instrs = program.instrs
    kinds = program.leaf_kinds
    out_slots = tuple(program.out_slots)
    total = n + len(instrs)
    if any(not (0 <= s < total) for s in out_slots) or any(
        not (0 <= a < n + k)
        for k, (_op, _st, args) in enumerate(instrs) for a in args
    ):
        raise NotCanonical("malformed program: slot out of range")

    # the subgraph reachable from the outputs; dead instructions (the
    # graph-hygiene rule's business) never constrain canonicalization
    reachable = set(out_slots)
    for k in range(len(instrs) - 1, -1, -1):
        if n + k in reachable:
            reachable.update(instrs[k][2])

    # pass A: alpha-blind structural signatures, bottom-up.  Used only
    # to order commutative operands before leaf numbering, so the
    # numbering itself is ordering-invariant.
    sig_a: Dict[int, str] = {}
    tokens: Dict[int, Any] = {}
    for i in range(n):
        if i in reachable:
            sig_a[i] = _h(("leaf", kinds[i]))
    for k, (op, static, args) in enumerate(instrs):
        s = n + k
        if s not in reachable:
            continue
        tok = static_token(static)
        if tok is None:
            raise NotCanonical(
                f"instr {k} ({op}): static is not value-hashable"
            )
        tokens[s] = tok
        child = [sig_a[a] for a in args]
        if _commutes(op, static):
            child = sorted(child)
        sig_a[s] = _h((op, tok, tuple(child)))

    # pass B: canonical preorder traversal from the outputs assigns
    # alpha ids to leaves by first visit
    alpha: Dict[int, int] = {}
    visited: set = set()
    for root in out_slots:
        stack: List[int] = [root]
        while stack:
            s = stack.pop()
            if s in visited:
                continue
            visited.add(s)
            if s < n:
                alpha[s] = len(alpha)
                continue
            op, static, args = instrs[s - n]
            order = list(args)
            if _commutes(op, static):
                order = [a for _sig, _i, a in sorted(
                    (sig_a[a], i, a) for i, a in enumerate(args)
                )]
            stack.extend(reversed(order))

    # pass C: final signatures with canonical leaf ids folded in
    sig_c: Dict[int, str] = {}
    for i, a in alpha.items():
        sig_c[i] = _h(("leaf", kinds[i], a))
    for k, (op, static, args) in enumerate(instrs):
        s = n + k
        if s not in visited:
            continue  # dead instruction: no semantic contribution
        child = [sig_c[a] for a in args]
        if _commutes(op, static):
            child = sorted(child)
        sig_c[s] = _h((op, tokens[s], tuple(child)))

    leaf_order = tuple(sorted(alpha, key=lambda i: alpha[i]))
    form = repr((
        tuple(sig_c[s] for s in out_slots),
        tuple(kinds[i] for i in leaf_order),
    ))
    chash = hashlib.sha256(form.encode()).hexdigest()[:16]
    return CanonForm(chash=chash, form=form, leaf_order=leaf_order,
                     n_leaves=n)


def try_canonicalize(program: Any) -> Optional[CanonForm]:
    """:func:`canonicalize`, returning None instead of raising."""
    try:
        return canonicalize(program)
    except NotCanonical:
        return None
