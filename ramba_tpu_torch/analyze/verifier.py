"""Flush-time program verifier (the ``RAMBA_VERIFY`` entry point).

Counterpart of ``ramba_tpu/analyze/verifier.py``: the same modes and rule
selection.

Modes (read from the environment on every flush, so tests can toggle):

* unset / ``0`` / ``off``      — verifier disabled (one environment read
  a flush).
* ``1`` / ``strict``           — error findings raise
  :class:`~ramba_tpu_torch.analyze.findings.ProgramVerificationError`
  before the program is lowered: nothing builds, nothing launches.
* any other value (``warn``)   — findings are emitted but nothing raises;
  error findings start the flush's degradation ladder at the split rung
  instead (``fuser._run_segmented`` at half the instruction cap, exact
  shapes, no result memo and no certificate), counted in
  ``fuser.stats["verify_routed"]``.

Rule selection: ``RAMBA_VERIFY_RULES`` (comma whitelist) and
``RAMBA_VERIFY_SKIP`` (comma blacklist) filter :data:`rules.RULES`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, List, MutableMapping, Optional, Sequence, Tuple

from ramba_tpu_torch.analyze import rules as _rules
from ramba_tpu_torch.analyze.findings import Finding
from ramba_tpu_torch.observe import events as _events
from ramba_tpu_torch.observe import registry as _registry

_OFF = ("", "0", "off", "false", "no")
_STRICT = ("1", "strict", "error", "errors")


def mode() -> str:
    """Current verifier mode: ``"off"``, ``"warn"``, or ``"strict"``."""
    v = (os.environ.get("RAMBA_VERIFY") or "").strip().lower()
    if v in _OFF:
        return "off"
    if v in _STRICT:
        return "strict"
    return "warn"


def enabled_rules() -> List[str]:
    """Rule names to run, after RAMBA_VERIFY_RULES/_SKIP filtering."""
    names = list(_rules.RULES)
    only = os.environ.get("RAMBA_VERIFY_RULES")
    if only:
        want = {s.strip() for s in only.split(",") if s.strip()}
        names = [n for n in names if n in want]
    skip = os.environ.get("RAMBA_VERIFY_SKIP")
    if skip:
        drop = {s.strip() for s in skip.split(",")}
        names = [n for n in names if n not in drop]
    return names


@dataclasses.dataclass
class ProgramView:
    """Everything a rule may inspect about one program.

    Offline lint supplies only ``program``/``donate``/``owners`` (rules
    requiring the live expression graph see empty ``exprs`` and no-op);
    the flush-time verifier supplies all fields.  The ``key_fn`` /
    ``fingerprint`` / ``key_registry`` overrides parameterize the
    cache-collision check for tests and recorded traces; None means
    "use the live fuser's".  ``cache_key`` is the key the flush computed
    once (``fuser._cache_key``), shared with the cache-key check.
    """

    program: Any = None
    leaves: Sequence[Any] = ()
    exprs: Sequence[Any] = ()
    donate: Tuple[int, ...] = ()
    owners: Sequence[int] = ()
    seg_size: int = 0
    key_fn: Optional[Callable[[Any, tuple], Any]] = None
    fingerprint: Optional[Any] = None
    key_registry: Optional[MutableMapping[Any, Any]] = None
    # result-memoization audit surface: the flush's core/memo.py plan
    # (memo-safety rule input) and the canonical-hash collision registry
    # override (None means the process-wide one in rules.py)
    memo_plan: Any = None
    canon_registry: Optional[MutableMapping[str, str]] = None
    # compile-class audit surface: the flush's compile/classes.py bucket
    # plan (compile-class rule input); None = exact-shape compile
    class_plan: Any = None
    # the flush's compile-cache key, computed once a flush
    cache_key: Any = None


def verify_program(
    view: ProgramView, rule_names: Optional[Sequence[str]] = None
) -> List[Finding]:
    """Run the selected rules over ``view``.  A crashing rule yields an
    ``internal-error`` warning finding rather than taking the flush down —
    the verifier must never be less reliable than the code it checks."""
    names = enabled_rules() if rule_names is None else list(rule_names)
    out: List[Finding] = []
    for name in names:
        fn = _rules.RULES.get(name)
        if fn is None:
            continue
        try:
            out.extend(fn(view))
        except Exception as e:  # pragma: no cover - defensive
            out.append(Finding(
                "internal-error", "warning", name,
                f"rule crashed: {type(e).__name__}: {e}",
            ))
    return out


def verify_flush(
    program: Any,
    leaves: Sequence[Any],
    exprs: Sequence[Any],
    donate: Sequence[int],
    label: Optional[str] = None,
    memo_plan: Any = None,
    class_plan: Any = None,
    cache_key: Any = None,
) -> List[Finding]:
    """Verify the program a flush is about to execute, emitting each
    finding through ``observe/events.py`` (so ``trace_report.py`` renders
    them) and counting per-severity registry metrics.  ``memo_plan`` is
    the flush's result-memoization plan, audited by the memo-safety
    rule; ``class_plan`` its compile-class bucket plan, audited by the
    compile-class rule; ``cache_key`` its compile-cache key."""
    from ramba_tpu_torch import common as _common
    from ramba_tpu_torch.core import fuser as _fuser

    view = ProgramView(
        program=program,
        leaves=leaves,
        exprs=exprs,
        donate=tuple(donate),
        owners=_fuser._leaf_owner_counts(leaves),
        seg_size=_common.max_program_instrs,
        memo_plan=memo_plan,
        class_plan=class_plan,
        cache_key=cache_key,
    )
    findings = verify_program(view)
    for f in findings:
        _registry.inc("analyze.findings")
        _registry.inc(f"analyze.findings.{f.severity}")
        _events.emit(f.as_event(label))
    return findings


def analyze_exprs(
    exprs: Sequence[Any],
    donate: Sequence[int] = (),
    rule_names: Optional[Sequence[str]] = None,
) -> List[Finding]:
    """Verify a list of expression roots exactly as the next flush would
    (rewrite + linearize + all rules), without executing anything.  The
    public hook for tests and interactive debugging."""
    from ramba_tpu_torch import common as _common
    from ramba_tpu_torch.core import fuser as _fuser

    program, leaves, rexprs = _fuser._prepare_program(list(exprs))
    view = ProgramView(
        program=program,
        leaves=leaves,
        exprs=rexprs,
        donate=tuple(donate),
        owners=_fuser._leaf_owner_counts(leaves),
        seg_size=_common.max_program_instrs,
    )
    return verify_program(view, rule_names)
