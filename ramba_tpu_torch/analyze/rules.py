"""Verifier rules over the deferred-op DAG and its linearized program.

Counterpart of ``ramba_tpu/analyze/rules.py``: the same six rules under
the same names, with the reference's messages word for word, so a
finding from either package compares equal (the lint parity tests hold
them so on one trace).  Where the port differs:

* torch has no buffer donation, so the fuser's donate mask is always
  empty and ``donation-hazard`` fires only on a mask a view names by
  hand, on the segmented replay, and on recorded traces (the
  reference's included);
* ``shape-dtype`` re-derives through the port's ``expr.AVAL_RULES``;
* ``sharding-legality`` reads the port's ``Mesh`` and ``NamedSharding``
  (a ``shard_hint`` carries a sharding, not a bare spec) and the sharded
  stencil's own eligibility arithmetic;
* the cache-key check defaults to the key the flush computed once
  (``ProgramView.cache_key``), and its semantic fingerprint is the fixed
  x64 regime: a collision can only show on recorded traces;
* ``compile-class`` re-derives through ``compile/classes.py``'s
  ``shape_plan`` and ``bucket_for``.

Each rule is an independent, individually-toggleable function registered in
:data:`RULES` (toggle with ``RAMBA_VERIFY_RULES`` / ``RAMBA_VERIFY_SKIP``,
see ``verifier.enabled_rules``).  A rule takes a
:class:`~ramba_tpu_torch.analyze.verifier.ProgramView` and returns a list of
:class:`~ramba_tpu_torch.analyze.findings.Finding`; it must never mutate the view
and must be safe to run on partial views (offline lint supplies only the
linearized program, not the live expression graph).

Rules
-----
``donation-hazard``    a leaf slated for buffer donation while a live
                       ndarray/view still aliases its buffer (silent memory
                       corruption if executed), a donated program output,
                       or a segmented-run mid-chain donation of a slot a
                       later segment still reads.
``shape-dtype``        recorded node metadata disagrees with re-inferred
                       shapes/promoted dtypes — catches ``core/rewrite.py``
                       bugs before a kernel runs on the wrong aval.
``sharding-legality``  non-associative reductions/scans over a sharded
                       axis, stencil halos exceeding the shard width
                       (``ops/stencil_sharded.eligible`` would refuse), and
                       sharding hints naming axes the live mesh lacks.
``graph-hygiene``      dangling slot references, cycles (manifest as
                       forward references in a linearization), dead
                       subgraphs — including dead RNG draws (an entropy
                       consumption no output observes, the
                       ``dead-entropy`` finding) — and cache key
                       collisions, both compile-cache (two trace-time
                       semantic contexts mapping to one structural key)
                       and canonical-hash (two canonical *forms* mapping
                       to one truncated semantic hash).
``memo-safety``        a result-cache plan (``core/memo.py``) claiming
                       memoizability for a program whose re-derived
                       effect class is not pure/RNG-keyed, that donates
                       an input, or whose result alias-escapes an input
                       — the seeded violation of the ``memo:insert`` /
                       ``memo:hit`` fault sites.
``compile-class``      a shape-bucket plan (``compile/classes.py``)
                       claiming pad/slice safety for a program with a
                       shape-sensitive instruction, or whose bucket
                       arithmetic disagrees with an independent
                       re-derivation from the leaf avals — the seeded
                       violation of the ``compile:bucket`` fault site.
"""

from __future__ import annotations

import math
from typing import (
    TYPE_CHECKING, Any, Callable, Dict, Iterator, List, MutableMapping,
    Optional, Sequence, Tuple,
)

from ramba_tpu_torch.analyze.findings import Finding

if TYPE_CHECKING:  # pragma: no cover - typing only, avoids an import cycle
    from ramba_tpu_torch.analyze.verifier import ProgramView

RULES: Dict[str, Callable[["ProgramView"], List[Finding]]] = {}


def rule(name: str) -> Callable[[Callable], Callable]:
    """Register a verifier rule under ``name``."""

    def deco(fn: Callable[["ProgramView"], List[Finding]]) -> Callable:
        RULES[name] = fn
        return fn

    return deco


def _walk_nodes(exprs: Sequence[Any]) -> Iterator[Any]:
    """Deterministic postorder walk over every distinct Node reachable from
    ``exprs`` (same traversal order as ``fuser._linearize``)."""
    from ramba_tpu_torch.core.expr import Node

    seen: set = set()
    stack = [(r, False) for r in reversed(list(exprs))]
    while stack:
        node, done = stack.pop()
        if done:
            yield node
            continue
        nid = id(node)
        if nid in seen or not isinstance(node, Node):
            continue
        seen.add(nid)
        stack.append((node, True))
        for a in reversed(node.args):
            stack.append((a, False))


# ---------------------------------------------------------------------------
# donation hazards
# ---------------------------------------------------------------------------


@rule("donation-hazard")
def check_donation(view: "ProgramView") -> List[Finding]:
    """A donated buffer a live array still aliases is not an exception —
    it is silent memory corruption.  Re-derive the alias census and diff
    it against the donate mask, including the segmented-run path whose
    mid-chain donation rules differ (``fuser._run_segmented``)."""
    fs: List[Finding] = []
    prog = view.program
    # the port replays a segmented run even with an empty donate mask:
    # its mid-chain frees of intermediates (``fuser._run_segmented``) are
    # the liveness the replay checks
    if prog is None or not (view.donate or (
            view.seg_size and len(prog.instrs) > view.seg_size)):
        return fs
    owners = list(view.owners or ())
    out_set = set(prog.out_slots)
    for i in view.donate:
        anchor = f"leaf{i}"
        if not (0 <= i < prog.n_leaves):
            fs.append(Finding(
                "donation-hazard", "error", anchor,
                f"donate mask names slot {i}, but the program has only "
                f"{prog.n_leaves} leaves",
            ))
            continue
        if prog.leaf_kinds[i] != "C":
            fs.append(Finding(
                "donation-hazard", "error", anchor,
                "donated leaf is a python scalar, not a device buffer",
            ))
            continue
        n_own = owners[i] if i < len(owners) else 0
        if n_own > 0:
            fs.append(Finding(
                "donation-hazard", "error", anchor,
                f"leaf donated to XLA while {n_own} live ndarray(s) still "
                "alias its buffer — executing would corrupt observable "
                "memory",
            ))
        if i in out_set:
            fs.append(Finding(
                "donation-hazard", "error", anchor,
                "donated leaf is also a program output; XLA would return "
                "a deleted buffer",
            ))
    # Segmented-run path: replay fuser's segment donation decisions and
    # check no donated slot is read by a later segment or escapes as a
    # program output.
    seg = view.seg_size
    if seg and len(prog.instrs) > seg:
        from ramba_tpu_torch.core import fuser as _fuser

        last_use = _fuser._last_use_map(prog)
        donate_set = set(view.donate)
        donated_at: Dict[int, int] = {}
        for k, (_sp, in_slots, _out, top) in enumerate(
            _fuser._iter_segments(prog, last_use, seg)
        ):
            for s in in_slots:
                if s in donated_at:
                    fs.append(Finding(
                        "donation-hazard", "error", f"slot{s}",
                        f"segment {k} reads slot {s}, already donated by "
                        f"segment {donated_at[s]} (segmented mid-chain "
                        "donation)",
                    ))
                    continue
                if last_use.get(s, 0) >= top:
                    continue  # live past this segment: not donated here
                if s < prog.n_leaves and s not in donate_set:
                    continue  # caller-visible leaf not cleared for donation
                donated_at[s] = k
        for s in prog.out_slots:
            if s in donated_at:
                fs.append(Finding(
                    "donation-hazard", "error", f"slot{s}",
                    f"program output slot {s} donated mid-chain by segment "
                    f"{donated_at[s]}",
                ))
    return fs


# ---------------------------------------------------------------------------
# analytic memory footprint (used by resilience.memory admission control)
# ---------------------------------------------------------------------------


def _aval_nbytes(aval: Any) -> int:
    try:
        from ramba_tpu_torch.compile.classes import _itemsize

        return int(math.prod(aval.shape)) * _itemsize(aval.dtype)
    except Exception:
        return 0


def slot_nbytes(program: Any, leaf_avals: Sequence[Any]) -> Dict[int, int]:
    """Estimated byte size of every value slot (leaves + instruction
    outputs) of a linearized program, from the same abstract eval
    (``expr.infer_aval``) the shape-dtype rule re-infers with.
    Slots whose abstract eval needs live context map to 0 (unknown)."""
    from ramba_tpu_torch.core.expr import infer_aval

    avals: Dict[int, Any] = {}
    sizes: Dict[int, int] = {}
    for i, a in enumerate(leaf_avals):
        avals[i] = a
        sizes[i] = _aval_nbytes(a)
    n = program.n_leaves
    for k, (op, static, args) in enumerate(program.instrs):
        slot = n + k
        arg_avals = [avals.get(s) for s in args]
        if any(a is None for a in arg_avals):
            avals[slot] = None
            sizes[slot] = 0
            continue
        try:
            av = infer_aval(op, static, arg_avals)
        except Exception:
            avals[slot] = None
            sizes[slot] = 0
            continue
        avals[slot] = av
        sizes[slot] = _aval_nbytes(av)
    return sizes


def estimate_peak_bytes(program: Any, leaf_avals: Sequence[Any],
                        donate: Sequence[int] = ()) -> int:
    """Analytic peak-live-bytes estimate: simulate the program's live set
    instruction by instruction.  Non-donated leaves stay resident to the
    end (the caller holds them); donated leaves and intermediates free
    after their last use; program outputs never free.  Mirrors the
    lifetime rules ``fuser.run_instructions`` and ``fuser._run_segmented``
    execute with (the port has no compiler to ask, so this is its one
    estimate: ``resilience.memory.estimate_program_bytes``)."""
    from ramba_tpu_torch.core import fuser as _fuser

    sizes = slot_nbytes(program, leaf_avals)
    last_use = _fuser._last_use_map(program)
    donate_set = set(donate)
    n = program.n_leaves
    end = n + len(program.instrs)
    drops: Dict[int, List[int]] = {}
    for s, lu in last_use.items():
        if lu >= end:
            continue  # program output (pinned) — never freed
        if s < n and s not in donate_set:
            continue  # caller-visible leaf: resident for the whole run
        drops.setdefault(lu, []).append(s)
    live = sum(sizes.get(i, 0) for i in range(n))
    peak = live
    for k in range(len(program.instrs)):
        slot = n + k
        live += sizes.get(slot, 0)
        if live > peak:
            peak = live
        for s in drops.get(slot, ()):
            live -= sizes.get(s, 0)
    return peak


# ---------------------------------------------------------------------------
# shape/dtype re-inference
# ---------------------------------------------------------------------------


# (op, static, arg avals) -> aval: a chain repeats a few structures, and
# the reference's abstract eval is memoized likewise.  The key holds the
# static itself, so an identity-hashed one cannot die and be reused.
_aval_memo: Dict[Tuple[Any, ...], Any] = {}
_AVAL_MEMO_MAX = 4096


def _infer(op: str, static: Any, arg_avals: List[Any]) -> Any:
    from ramba_tpu_torch.core.expr import infer_aval

    key = (op, static, tuple(arg_avals))
    try:
        got = _aval_memo.get(key)
    except TypeError:  # an unhashable static
        return infer_aval(op, static, arg_avals)
    if got is None:
        got = infer_aval(op, static, arg_avals)
        if len(_aval_memo) >= _AVAL_MEMO_MAX:
            _aval_memo.clear()
        _aval_memo[key] = got
    return got


@rule("shape-dtype")
def check_shape_dtype(view: "ProgramView") -> List[Finding]:
    """Walk the (post-rewrite) expression graph and re-derive every node's
    aval from its children via ``expr.infer_aval`` — the recorded metadata
    a rewrite preserved (``Node(..., aval=e.aval)``) must still hold, or
    the rewrite changed semantics.  Memoized abstract eval keeps this
    cheap on repeated structures."""
    fs: List[Finding] = []
    if not view.exprs:
        return fs
    for idx, node in enumerate(_walk_nodes(view.exprs)):
        try:
            want = _infer(node.op, node.static, [a.aval for a in node.args])
        except Exception:
            continue  # ops whose abstract eval needs live context
        got = node.aval
        anchor = f"node{idx}:{node.op}"
        if tuple(got.shape) != tuple(want.shape):
            fs.append(Finding(
                "shape-dtype", "error", anchor,
                f"recorded shape {tuple(got.shape)} != re-inferred "
                f"{tuple(want.shape)}",
            ))
        # dtypes compare as objects first: str() of a dtype is slow
        if got.dtype != want.dtype and str(got.dtype) != str(want.dtype):
            fs.append(Finding(
                "shape-dtype", "error", anchor,
                f"recorded dtype {got.dtype} != re-inferred {want.dtype}",
            ))
    return fs


# ---------------------------------------------------------------------------
# sharding legality
# ---------------------------------------------------------------------------

# (id(local_fn), id(global_fn)) -> probe verdict; the host-side probe is
# cheap but not free, and kernels repeat across flushes.
_assoc_memo: Dict[Tuple[int, int], bool] = {}


def _spec_axis_names(entry: Any) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def _halo_exceeds(
    lo: Sequence[int], hi: Sequence[int], avals: Sequence[Any], mesh: Any
) -> Optional[Tuple[int, int, int]]:
    """(dim, halo, shard_width) when a stencil halo cannot fit inside one
    neighbor shard — the condition ``ops/stencil_sharded.eligible``
    refuses; None when the sharded halo-exchange path is fine (or moot)."""
    from ramba_tpu_torch import common as _common
    from ramba_tpu_torch.ops.stencil_sharded import _axis_entries, _counts

    shapes = {tuple(a.shape) for a in avals}
    if len(shapes) != 1 or mesh.devices.size <= 1:
        return None
    (shape,) = shapes
    if len(shape) != len(lo) or math.prod(shape) < _common.dist_threshold:
        return None  # small arrays replicate: no halo exchange at all
    ents = _axis_entries(mesh, shape)
    if not any(ents):
        return None
    for d, nd in enumerate(_counts(mesh, ents)):
        ld = -(-shape[d] // nd)
        halo = max(-lo[d], hi[d])
        if halo > ld:
            return (d, halo, ld)
    return None


@rule("sharding-legality")
def check_sharding(view: "ProgramView") -> List[Finding]:
    fs: List[Finding] = []
    if not view.exprs:
        return fs
    from ramba_tpu_torch.parallel import mesh as _mesh

    try:
        mesh = _mesh.get_mesh()
    except Exception:
        return fs
    names = set(mesh.axis_names)
    nsh = int(mesh.devices.size)
    for idx, node in enumerate(_walk_nodes(view.exprs)):
        anchor = f"node{idx}:{node.op}"
        if node.op == "shard_hint":
            # the port's hint carries a NamedSharding (the reference's a
            # bare spec): its axis names must be the live mesh's
            (sharding,) = node.static
            spec = getattr(sharding, "spec", sharding)
            for entry in spec:
                for nm in _spec_axis_names(entry):
                    if nm not in names:
                        fs.append(Finding(
                            "sharding-legality", "error", anchor,
                            f"sharding constraint names mesh axis {nm!r}, "
                            f"but the live mesh has axes {sorted(names)}",
                        ))
        elif node.op == "scumulative":
            _lf, _ff, associative, _axis, distribute = node.static
            if distribute and not associative and nsh > 1:
                fs.append(Finding(
                    "sharding-legality", "warning", anchor,
                    "non-associative cumulative kernel over a sharded scan "
                    "axis: per-block carry semantics, exact only per shard",
                ))
        elif node.op == "sreduce":
            local_fn, global_fn, _ident, use_shard_split = node.static
            if use_shard_split and nsh > 1:
                key = (id(local_fn), id(global_fn))
                ok = _assoc_memo.get(key)
                if ok is None:
                    try:
                        from ramba_tpu_torch.skeletons import _probe_associative

                        ok = bool(_probe_associative(local_fn, global_fn))
                    except Exception:
                        ok = True  # probe inapplicable: do not accuse
                    _assoc_memo[key] = ok
                if not ok:
                    fs.append(Finding(
                        "sharding-legality", "warning", anchor,
                        "reduction kernel failed the associativity probe "
                        "but combines per-shard partials; the result may "
                        "depend on the shard split",
                    ))
        elif node.op in ("stencil", "stencil_iter"):
            lo, hi = node.static[1], node.static[2]
            bad = _halo_exceeds(lo, hi, [a.aval for a in node.args], mesh)
            if bad is not None:
                d, halo, width = bad
                fs.append(Finding(
                    "sharding-legality", "warning", anchor,
                    f"stencil halo {halo} along dim {d} exceeds the shard "
                    f"width {width}: the sharded halo-exchange path is "
                    "disabled and the stencil runs on the whole array",
                ))
    return fs


# ---------------------------------------------------------------------------
# graph hygiene
# ---------------------------------------------------------------------------

# compile-cache key -> semantic fingerprint under which it was first seen.
_cache_key_registry: Dict[Any, Any] = {}
_CACHE_KEY_REGISTRY_MAX = 4096


def check_cache_key(
    program: Any,
    donate: Sequence[int],
    *,
    key_fn: Optional[Callable[[Any, tuple], Any]] = None,
    fingerprint: Optional[Any] = None,
    registry: Optional[MutableMapping[Any, Any]] = None,
    key: Optional[Any] = None,
) -> List[Finding]:
    """Detect compile-cache key collisions: the same cache key observed
    under two different trace-time semantic fingerprints means two
    structurally-"identical" programs with different numerics would share
    one compiled program — a latent wrong-answer bug.  ``key`` is the
    flush's own cache key (``fuser._cache_key``, computed once a flush);
    without it the structural key and donate mask stand in.  The keyword
    overrides let tests (and offline lint) check a recorded or
    deliberately-deficient keying function."""
    from ramba_tpu_torch.core import fuser as _fuser

    if fingerprint is None:
        fingerprint = _fuser._semantic_fingerprint()
    if registry is None:
        registry = _cache_key_registry
    if key_fn is not None:
        key = key_fn(program, tuple(donate))
    elif key is None:
        key = (program.key, tuple(donate))
    try:
        hash(key)
    except TypeError:
        return [Finding(
            "graph-hygiene", "warning", "program",
            "compile-cache key is unhashable (a static holds an unhashable "
            "object); every flush of this structure recompiles",
        )]
    prev = registry.get(key)
    if prev is not None and prev != fingerprint:
        return [Finding(
            "graph-hygiene", "error", "program",
            "compile-cache key collision: identical key observed under "
            f"different trace-time semantics ({prev!r} -> {fingerprint!r}); "
            "the key is missing a structural field",
        )]
    if len(registry) > _CACHE_KEY_REGISTRY_MAX:
        registry.clear()
    registry[key] = fingerprint
    return []


@rule("graph-hygiene")
def check_hygiene(view: "ProgramView") -> List[Finding]:
    fs: List[Finding] = []
    prog = view.program
    if prog is None:
        return fs
    n = prog.n_leaves
    total = n + len(prog.instrs)
    topo_ok = True
    for i, (op, _st, args) in enumerate(prog.instrs):
        slot = n + i
        for s in args:
            if not (0 <= s < slot):
                topo_ok = False
                what = (
                    "forward/self reference — a cycle or corrupt "
                    "linearization" if s >= slot else "negative slot"
                )
                fs.append(Finding(
                    "graph-hygiene", "error", f"instr{i}:{op}",
                    f"argument slot {s} is a {what}; valid range is "
                    f"[0, {slot})",
                ))
    for s in prog.out_slots:
        if not (0 <= s < total):
            fs.append(Finding(
                "graph-hygiene", "error", f"slot{s}",
                f"output slot {s} dangles outside the program "
                f"(size {total})",
            ))
    if topo_ok:
        live = set(prog.out_slots)
        for i in range(len(prog.instrs) - 1, -1, -1):
            if n + i in live:
                live.update(prog.instrs[i][2])
        dead = [i for i in range(len(prog.instrs)) if n + i not in live]
        if dead:
            ops = ", ".join(prog.instrs[i][0] for i in dead[:8])
            fs.append(Finding(
                "graph-hygiene", "warning", f"instr{dead[0]}",
                f"{len(dead)} instruction(s) feed no program output "
                f"(dead subgraph): {ops}",
            ))
        from ramba_tpu_torch.analyze.effects import RNG_OPS

        for i in dead:
            if prog.instrs[i][0] in RNG_OPS:
                fs.append(Finding(
                    "graph-hygiene", "warning",
                    f"instr{i}:{prog.instrs[i][0]}",
                    "dead-entropy: RNG draw whose output no program "
                    "output consumes — the PRNG key was advanced for a "
                    "sample nothing observes (usually a dropped array "
                    "or an over-split key)",
                ))
    fs.extend(check_cache_key(
        prog, view.donate,
        key_fn=view.key_fn, fingerprint=view.fingerprint,
        registry=view.key_registry, key=view.cache_key,
    ))
    fs.extend(check_canon_collision(
        prog, view.memo_plan, registry=view.canon_registry,
    ))
    return fs


# ---------------------------------------------------------------------------
# canonical-hash collision + result-memoization safety
# ---------------------------------------------------------------------------

# canonical hash -> canonical form under which it was first seen.  The
# canonical-hash analog of _cache_key_registry: the hash is a truncated
# digest of the form, so two different forms under one hash is a real
# (if astronomically unlikely) collision — and a result-cache keyed on
# that hash would serve one program's bytes for the other.
_canon_registry: Dict[str, str] = {}
_CANON_REGISTRY_MAX = 4096


def check_canon_collision(
    program: Any,
    memo_plan: Any = None,
    *,
    registry: Optional[MutableMapping[str, str]] = None,
) -> List[Finding]:
    """Detect canonical-hash collisions: the same semantic hash observed
    for two different canonical *forms*.  Cheap when a memo plan already
    carries the canonicalization (the flush path); programs without a
    plan are only canonicalized when they are canonicalizable at all."""
    if registry is None:
        registry = _canon_registry
    chash = getattr(memo_plan, "chash", None)
    form = getattr(memo_plan, "form", None)
    if chash is None or form is None:
        from ramba_tpu_torch.analyze import canon as _canon

        cf = _canon.try_canonicalize(program)
        if cf is None:
            return []
        chash, form = cf.chash, cf.form
    prev = registry.get(chash)
    if prev is not None and prev != form:
        return [Finding(
            "graph-hygiene", "error", "program",
            f"canonical-hash collision: hash {chash} maps to two "
            "different canonical forms — a result cache keyed on it "
            "would serve one program's bytes for the other",
        )]
    if len(registry) > _CANON_REGISTRY_MAX:
        registry.clear()
    registry[chash] = form
    return []


@rule("memo-safety")
def check_memo_safety(view: "ProgramView") -> List[Finding]:
    """Audit a flush's result-memoization plan: re-derive the effect and
    alias analysis *independently* of the plan (the certifier that
    produced the plan may have been corrupted — that is exactly what the
    ``memo:insert``/``memo:hit`` fault sites do) and flag any claim of
    memoizability the re-derivation rejects.  No plan, or a plan that
    already declined to memoize, is vacuously safe."""
    fs: List[Finding] = []
    plan = view.memo_plan
    prog = view.program
    if plan is None or prog is None or not getattr(plan, "memoizable",
                                                   False):
        return fs
    from ramba_tpu_torch.analyze.effects import classify_program

    rep = classify_program(prog, tuple(view.donate))
    for i, why in rep.host_instrs:
        op = prog.instrs[i][0]
        fs.append(Finding(
            "memo-safety", "error", f"instr{i}:{op}",
            f"result cache admitted a host-effecting subgraph ({why}); "
            "replaying its cached bytes could diverge from re-execution",
        ))
    for s in rep.alias_outs:
        fs.append(Finding(
            "memo-safety", "error", f"slot{s}",
            "memoized result aliases a program input: caching it would "
            "hand later flushes a caller-visible buffer",
        ))
    if rep.donating:
        fs.append(Finding(
            "memo-safety", "error", "program",
            "memoized program donates input buffers; a replayed hit "
            "would skip the donation the alias census already assumed",
        ))
    return fs


@rule("compile-class")
def check_compile_class(view: "ProgramView") -> List[Finding]:
    """Audit a flush's shape-bucket plan (``compile/classes.py``):
    re-prove the pad/slice safety claim *independently* of the planner
    (the ``compile:bucket`` fault site forges a plan that skips the
    op-safety proof — exactly the corruption this rule catches).  Two
    halves: every instruction must be leading-dim independent
    (``classes.check_program``), and the bucket arithmetic must agree
    with a fresh re-derivation from the leaf avals.  No plan is
    vacuously safe (exact-shape compiles never pad)."""
    fs: List[Finding] = []
    plan = view.class_plan
    prog = view.program
    if plan is None or prog is None:
        return fs
    from ramba_tpu_torch.compile import classes as _classes

    reason = _classes.check_program(prog)
    if reason is not None:
        fs.append(Finding(
            "compile-class", "error", "program",
            f"bucket plan claims pad/slice safety but {reason}: padded "
            "rows would change the program's semantics, and slicing the "
            "output could not undo it",
        ))
        return fs
    try:
        token = plan.token
        policy = (("linear", int(token[0].split(":", 1)[1]))
                  if str(token[0]).startswith("linear") else ("pow2",))
        lavals = [leaf.aval for leaf in view.leaves]
        if len(lavals) != prog.n_leaves:
            raise ValueError("leaf count")
    except Exception:
        fs.append(Finding(
            "compile-class", "error", "program",
            "bucket plan is malformed (unreadable token or leaf avals); "
            "refusing to execute a padded program on an unverifiable "
            "claim",
        ))
        return fs
    rederived = _classes.shape_plan(prog, lavals, policy)
    if rederived is None:
        fs.append(Finding(
            "compile-class", "error", "program",
            "bucket plan's shape claim does not re-derive: the program's "
            "leaf/output extents do not admit a single shared leading "
            "dim to bucket",
        ))
        return fs
    if (rederived.n != plan.n or rederived.bucket != plan.bucket
            or rederived.bucket != _classes.bucket_for(plan.n, policy)
            or tuple(rederived.pad_slots) != tuple(plan.pad_slots)):
        fs.append(Finding(
            "compile-class", "error", "program",
            f"bucket arithmetic disagrees with re-derivation: plan "
            f"(n={plan.n}, bucket={plan.bucket}, "
            f"pads={list(plan.pad_slots)}) vs re-derived "
            f"(n={rederived.n}, bucket={rederived.bucket}, "
            f"pads={list(rederived.pad_slots)})",
        ))
    return fs
