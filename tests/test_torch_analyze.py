"""The port's static analyzer (``ramba_tpu_torch/analyze``, RAMBA_VERIFY)
against ramba_tpu's, x64 regime, on the CPU.

The cases of ``tests/test_analyze.py``, one seeded violation per rule
with the exact ``Finding`` the rule must emit, ported to the port's
flush (torch has no buffer donation: ``donation-hazard`` is exercised
on hand-built views, on the segmented replay and on recorded traces;
the x64 regime is fixed, so the cross-regime key collision is shown on
a trace ramba_tpu recorded with x64 off and on).  Held against
ramba_tpu on the same NumPy-level programs (a chain, axpy, a stencil, a
groupby, scumulative on a mesh, a seeded draw, a closure smap):

* the same rule names and severities from ``analyze_exprs``;
* the same ``program_class``, ``memoizable`` and ``reason`` from
  ``classify_program``;
* the same canonical-hash equivalence classes.

Lint schema parity: a trace either package records lints to the same
findings under both packages' ``lint_events``.  The strict sweep runs
thirty programs of the port's parity tests under ``RAMBA_VERIFY=strict``:
no error finding, values equal to verify off.
"""

import json
import types

import numpy as np
import pytest
import torch

import jax
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from ramba_tpu import analyze as janalyze
from ramba_tpu.analyze import lint as jlint
from ramba_tpu.core import fuser as jfuser
from ramba_tpu.core import memo as jmemo
from ramba_tpu.observe import events as jevents
from ramba_tpu.resilience import faults as jfaults
from ramba_tpu_torch import analyze, common
from ramba_tpu_torch.analyze import lint as alint
from ramba_tpu_torch.analyze import rules as arules
from ramba_tpu_torch.analyze import verifier as averifier
from ramba_tpu_torch.analyze.findings import Finding, ProgramVerificationError
from ramba_tpu_torch.compile import classes
from ramba_tpu_torch.core import fuser, memo
from ramba_tpu_torch.core.expr import Aval, Node, as_expr
from ramba_tpu_torch.observe import events, registry
from ramba_tpu_torch.parallel import mesh as pmesh
from ramba_tpu_torch.resilience import faults

ENV = ("RAMBA_VERIFY", "RAMBA_VERIFY_RULES", "RAMBA_VERIFY_SKIP",
       "RAMBA_MEMO", "RAMBA_MEMO_BUDGET", "RAMBA_PLANCERT",
       "RAMBA_COMPILE_CLASSES")


@pytest.fixture(autouse=True)
def _isolate(monkeypatch):
    """The port on the CPU, empty pending sets, no fault plan, the
    analysis switches unset in both packages."""
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    torch.set_num_threads(1)
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    fuser.flush()
    rtj.sync()
    faults.configure(None)
    jfaults.configure(None)
    memo.reset()
    jmemo.reset()
    yield
    faults.reset()
    jfaults.reset()
    memo.reset()
    jmemo.reset()


def _findings(fs, rule, severity=None):
    return [f for f in fs if f.rule == rule
            and (severity is None or f.severity == severity)]


@pytest.fixture
def mesh4():
    """Both packages on a mesh of four shards."""
    from jax.sharding import Mesh as JMesh

    from ramba_tpu.parallel import mesh as rmesh

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    old_r, old_p = rmesh.get_mesh(), pmesh.get_mesh()
    rmesh.set_mesh(JMesh(np.array(jax.devices()[:4]), ("d0",)))
    pmesh.set_mesh(pmesh.Mesh(
        np.array([torch.device("cpu")] * 4, dtype=object), ("d0",)))
    try:
        yield pmesh.get_mesh()
    finally:
        rmesh.set_mesh(old_r)
        pmesh.set_mesh(old_p)


# ---------------------------------------------------------------------------
# donation-hazard (views built by hand, the segmented replay)
# ---------------------------------------------------------------------------


class TestDonationHazard:
    def test_live_owner_of_a_donated_leaf(self):
        prog = fuser._Program((("negative", None, (0,)),), 1, ("C",), (1,))
        view = averifier.ProgramView(program=prog, donate=(0,), owners=(2,))
        fs = arules.RULES["donation-hazard"](view)
        assert Finding(
            "donation-hazard", "error", "leaf0",
            "leaf donated to XLA while 2 live ndarray(s) still alias its "
            "buffer — executing would corrupt observable memory",
        ) in fs

    def test_scalar_and_out_of_range_slots(self):
        prog = fuser._Program((("negative", None, (0,)),), 2, ("C", "S"),
                              (2,))
        view = averifier.ProgramView(program=prog, donate=(1, 7))
        fs = arules.RULES["donation-hazard"](view)
        assert Finding(
            "donation-hazard", "error", "leaf1",
            "donated leaf is a python scalar, not a device buffer",
        ) in fs
        assert any(f.node == "leaf7" and "only 2 leaves" in f.message
                   for f in fs)

    def test_donated_program_output(self):
        prog = fuser._Program((("negative", None, (0,)),), 1, ("C",), (0, 1))
        view = averifier.ProgramView(program=prog, donate=(0,))
        fs = arules.RULES["donation-hazard"](view)
        assert Finding(
            "donation-hazard", "error", "leaf0",
            "donated leaf is also a program output; XLA would return "
            "a deleted buffer",
        ) in fs

    def test_segmented_replay_catches_bad_liveness(self, monkeypatch):
        instrs = (
            ("negative", None, (0,)),
            ("negative", None, (1,)),
            ("add", None, (0, 2)),
            ("negative", None, (3,)),
        )
        prog = fuser._Program(instrs, 1, ("C",), (4,))
        bad = dict(fuser._last_use_map(prog))
        bad[0] = 1
        monkeypatch.setattr(fuser, "_last_use_map", lambda p: bad)
        view = averifier.ProgramView(program=prog, donate=(0,), seg_size=2)
        fs = arules.RULES["donation-hazard"](view)
        seg = [f for f in fs if f.node == "slot0" and "segment" in f.message]
        assert seg and seg[0].severity == "error"
        assert "already donated by segment 0" in seg[0].message

    def test_segmented_real_flush_clean_under_strict(self, monkeypatch):
        monkeypatch.setenv("RAMBA_VERIFY", "1")
        monkeypatch.setattr(common, "max_program_instrs", 3)
        a = rt.fromarray(np.ones((64, 64)))
        b = a
        for _ in range(8):
            b = b + 1.0
        del a
        s0 = fuser.stats["segments"]
        np.testing.assert_array_equal(np.asarray(b), 9.0)
        assert fuser.stats["segments"] > s0
        assert "findings" not in events.last(1, type="flush")[-1]

    def test_segmented_flush_unset_keys_only_its_segments(self, monkeypatch):
        # with the switches unset and no trace, a segmented program is
        # keyed segment by segment, as before the analysis layer: its
        # whole key and fingerprint are never derived
        monkeypatch.setattr(common, "max_program_instrs", 3)
        keyed = []
        real = fuser._ledger.fingerprint
        monkeypatch.setattr(fuser._ledger, "fingerprint",
                            lambda key: keyed.append(key) or real(key))
        b = rt.fromarray(np.ones((64, 64)))
        for _ in range(8):
            b = b + 1.0
        np.testing.assert_array_equal(np.asarray(b), 9.0)
        span = events.last(1, type="flush")[-1]
        assert span["segments"] > 0 and "fingerprint" not in span
        assert keyed and all(len(k[0][0]) <= 3 for k in keyed)

    def test_the_port_donates_nothing_and_counts_owners(self, tmp_path):
        # the census the rule reads comes from the governor's ledger
        path = str(tmp_path / "t.jsonl")
        events.configure(path)
        try:
            a = rt.fromarray(np.ones(64))
            b = a + 1.0
            fuser.flush()
        finally:
            events.configure(None)
        [ev] = [e for e in alint.load_events(path)
                if e.get("type") == "program"]
        assert ev["donate"] == [] and ev["x64"] is True
        assert ev["owners"] == [1, 0] and ev["leaf_kinds"] == "CS"
        assert fuser._leaf_owner_counts([a._expr]) == [1]
        np.testing.assert_array_equal(np.asarray(b), 2.0)


# ---------------------------------------------------------------------------
# shape-dtype
# ---------------------------------------------------------------------------


class TestShapeDtype:
    def test_corrupt_recorded_aval(self):
        a = rt.fromarray(np.ones((3, 3), np.float32))
        b = a + a
        node = b._expr
        bad = Node(node.op, node.static, node.args,
                   aval=Aval((5, 5), np.dtype(np.int32)))
        fs = arules.RULES["shape-dtype"](averifier.ProgramView(exprs=[bad]))
        anchor = f"node0:{node.op}"
        assert Finding(
            "shape-dtype", "error", anchor,
            f"recorded shape (5, 5) != re-inferred {tuple(node.aval.shape)}",
        ) in fs
        assert Finding(
            "shape-dtype", "error", anchor,
            f"recorded dtype int32 != re-inferred {node.aval.dtype}",
        ) in fs
        fuser.flush()

    def test_faithful_graph_is_clean(self):
        a = rt.fromarray(np.arange(12.0).reshape(3, 4))
        b = (a * 2.0).T + 1.0
        assert analyze.analyze_exprs([b._expr],
                                     rule_names=["shape-dtype"]) == []
        fuser.flush()


# ---------------------------------------------------------------------------
# sharding-legality
# ---------------------------------------------------------------------------


class TestShardingLegality:
    def test_hint_names_unknown_mesh_axis(self):
        x = as_expr(np.ones((8, 8), np.float32))
        other = pmesh.Mesh([torch.device("cpu")], ("bogus_axis",))
        sh = pmesh.NamedSharding(other, pmesh.P("bogus_axis"))
        hint = Node("shard_hint", (sh,), [x], aval=x.aval)
        fs = analyze.analyze_exprs([hint], rule_names=["sharding-legality"])
        errs = _findings(fs, "sharding-legality", "error")
        assert errs and "'bogus_axis'" in errs[0].message
        assert errs[0].node.endswith(":shard_hint")

    def test_nonassociative_distributed_scan_warns(self, mesh4):
        x = as_expr(np.ones((4096,), np.float32))
        node = Node("scumulative", (None, None, False, 0, True), [x],
                    aval=x.aval)
        fs = arules.RULES["sharding-legality"](
            averifier.ProgramView(exprs=[node]))
        assert [(f.severity, f.node) for f in fs] == [
            ("warning", "node0:scumulative")]
        assert "non-associative" in fs[0].message

    def test_associative_distributed_scan_is_clean(self):
        x = as_expr(np.ones((4096,), np.float32))
        node = Node("scumulative", (None, None, True, 0, True), [x],
                    aval=x.aval)
        assert arules.RULES["sharding-legality"](
            averifier.ProgramView(exprs=[node])) == []

    def test_stencil_halo_wider_than_shard(self, mesh4):
        n = 4096
        x = as_expr(np.ones((n,), np.float32))
        halo = n // 2 + 1
        node = Node("stencil", (None, (-halo,), (halo,), (0,), ()), [x],
                    aval=x.aval)
        fs = arules.RULES["sharding-legality"](
            averifier.ProgramView(exprs=[node]))
        warns = _findings(fs, "sharding-legality", "warning")
        assert warns and "shard width" in warns[0].message

    def test_small_stencil_halo_is_clean(self, mesh4):
        x = as_expr(np.ones((4096,), np.float32))
        node = Node("stencil", (None, (-1,), (1,), (0,), ()), [x],
                    aval=x.aval)
        assert arules.RULES["sharding-legality"](
            averifier.ProgramView(exprs=[node])) == []


# ---------------------------------------------------------------------------
# graph-hygiene and the cache key
# ---------------------------------------------------------------------------


class TestGraphHygiene:
    def test_forward_reference_is_a_cycle(self):
        prog = fuser._Program((("add", None, (0, 2)),), 1, ("C",), (1,))
        fs = arules.RULES["graph-hygiene"](
            averifier.ProgramView(program=prog, key_registry={}))
        errs = _findings(fs, "graph-hygiene", "error")
        assert errs and errs[0].node == "instr0:add"
        assert "forward/self reference" in errs[0].message

    def test_dangling_output_slot(self):
        prog = fuser._Program((), 1, ("C",), (5,))
        fs = arules.RULES["graph-hygiene"](
            averifier.ProgramView(program=prog, key_registry={}))
        assert any(f.severity == "error" and f.node == "slot5"
                   and "dangles" in f.message for f in fs)

    def test_dead_subgraph_and_dead_entropy_warn(self):
        prog = fuser._Program(
            (("random", ("uniform", (4,), "float32", None), (0,)),
             ("exp", None, (0,))), 1, ("C",), (2,))
        fs = arules.RULES["graph-hygiene"](averifier.ProgramView(
            program=prog, key_registry={}, canon_registry={}))
        warns = _findings(fs, "graph-hygiene", "warning")
        assert warns[0].node == "instr0" and "dead subgraph" in \
            warns[0].message
        assert any(f.node == "instr0:random" and "dead-entropy" in f.message
                   for f in warns)

    def test_real_program_is_clean(self):
        a = rt.fromarray(np.ones((4, 4)))
        b = (a + 1.0) * a
        prog, _leaves, _ = fuser._prepare_program([b._expr])
        assert arules.RULES["graph-hygiene"](
            averifier.ProgramView(program=prog, key_registry={})) == []
        fuser.flush()

    def test_detector_flags_fingerprintless_keying(self):
        a = rt.fromarray(np.ones((4, 4), np.float32))
        prog, _l, _ = fuser._prepare_program([(a * 2.0)._expr])
        fuser.flush()
        reg = {}
        deficient = lambda p, d: (p.key, d)  # noqa: E731
        assert arules.check_cache_key(prog, (), key_fn=deficient,
                                      fingerprint=("x64", False),
                                      registry=reg) == []
        fs = arules.check_cache_key(prog, (), key_fn=deficient,
                                    fingerprint=("x64", True), registry=reg)
        assert [(f.rule, f.severity) for f in fs] == [
            ("graph-hygiene", "error")]
        assert "collision" in fs[0].message
        # the live keying: the flush's own key, the fixed regime
        assert fuser._semantic_fingerprint() == (True,)
        assert arules.check_cache_key(prog, (), registry={}) == []
        assert arules.check_cache_key(
            prog, (), key_fn=lambda p, d: [p.key], registry={}
        )[0].severity == "warning"

    def test_canon_collision(self):
        a = rt.fromarray(np.ones((4, 4), np.float32))
        prog, _l, _ = fuser._prepare_program([(a * 2.0)._expr])
        fuser.flush()
        form = analyze.canonicalize(prog)
        fs = arules.check_canon_collision(
            prog, registry={form.chash: "another form"})
        assert len(fs) == 1 and "collision" in fs[0].message
        reg = {}
        assert arules.check_canon_collision(prog, registry=reg) == []
        assert arules.check_canon_collision(prog, registry=reg) == []
        unc = fuser._Program((("apply", (lambda x: x,), (0,)),), 1, ("C",),
                             (1,))
        assert arules.check_canon_collision(unc, registry={}) == []


# ---------------------------------------------------------------------------
# verifier plumbing
# ---------------------------------------------------------------------------


class TestVerifierPlumbing:
    def test_mode_parsing(self, monkeypatch):
        for v, want in [("", "off"), ("0", "off"), ("off", "off"),
                        ("1", "strict"), ("strict", "strict"),
                        ("errors", "strict"), ("warn", "warn"),
                        ("yes-please", "warn")]:
            monkeypatch.setenv("RAMBA_VERIFY", v)
            assert averifier.mode() == want, v
        monkeypatch.delenv("RAMBA_VERIFY")
        assert averifier.mode() == "off"

    def test_rule_selection(self, monkeypatch):
        from ramba_tpu.analyze import rules as jrules

        assert list(arules.RULES) == list(jrules.RULES)
        assert set(averifier.enabled_rules()) == set(arules.RULES)
        monkeypatch.setenv("RAMBA_VERIFY_RULES", "graph-hygiene,shape-dtype")
        assert averifier.enabled_rules() == ["shape-dtype", "graph-hygiene"]
        monkeypatch.setenv("RAMBA_VERIFY_SKIP", "shape-dtype")
        assert averifier.enabled_rules() == ["graph-hygiene"]

    def test_exports_match_the_reference(self):
        assert analyze.__all__ == janalyze.__all__
        assert analyze.SEVERITIES == janalyze.SEVERITIES
        assert analyze.COMMUTATIVE == janalyze.COMMUTATIVE

    def test_finding_record(self):
        with pytest.raises(ValueError):
            Finding("r", "catastrophic", "n", "m")
        f = Finding("shape-dtype", "error", "node0:add", "boom")
        assert f.as_event("lbl") == {
            "type": "finding", "rule": "shape-dtype", "severity": "error",
            "node": "node0:add", "message": "boom", "label": "lbl",
        }


# ---------------------------------------------------------------------------
# compile-class: the forged bucket plan, strict and warn
# ---------------------------------------------------------------------------


@pytest.fixture
def pow2(monkeypatch):
    monkeypatch.setenv("RAMBA_COMPILE_CLASSES", "pow2")
    classes.reset()
    yield
    monkeypatch.delenv("RAMBA_COMPILE_CLASSES")
    classes.reset()


def _sorted_program(n=1000):
    # shape-sensitive (a sort) and not the kernels': the generic lowering
    x = rt.fromarray(np.random.RandomState(1).rand(n))
    return x, rt.sort(x) * 2.0


class TestCompileClass:
    def test_strict_raises_before_anything_runs(self, monkeypatch, pow2):
        monkeypatch.setenv("RAMBA_VERIFY", "strict")
        x, y = _sorted_program()
        c0, q0 = fuser.stats["compiles"], fuser.stats["quarantined"]
        with faults.active("compile:bucket:always"):
            with pytest.raises(ProgramVerificationError) as ei:
                fuser.flush()
        errs = _findings(ei.value.findings, "compile-class", "error")
        assert errs and "shape-sensitive instr 'sort'" in errs[0].message
        assert fuser.stats["compiles"] == c0  # nothing lowered
        assert fuser.stats["quarantined"] == q0 + 1
        monkeypatch.delenv("RAMBA_VERIFY")
        np.testing.assert_array_equal(np.asarray(y),
                                      np.sort(np.asarray(x)) * 2.0)

    def test_warn_routes_to_the_split_rung(self, monkeypatch, pow2):
        monkeypatch.setenv("RAMBA_VERIFY", "warn")
        x, y = _sorted_program()
        r0 = fuser.stats["verify_routed"]
        with faults.active("compile:bucket:always"):
            fuser.flush()
        span = events.last(1, type="flush")[-1]
        assert span.get("verify_routed") is True
        assert span.get("degraded") == "split"
        assert "compile_class" not in span  # the flagged plan never ran
        assert fuser.stats["verify_routed"] == r0 + 1
        np.testing.assert_array_equal(np.asarray(y),
                                      np.sort(np.asarray(x)) * 2.0)

    def test_skip_disables_the_rule(self, monkeypatch, pow2):
        monkeypatch.setenv("RAMBA_VERIFY", "1")
        monkeypatch.setenv("RAMBA_VERIFY_SKIP", "compile-class")
        _x, y = _sorted_program(8)
        with faults.active("compile:bucket:always"):
            fuser.flush()  # forged, rule disabled: no raise
        assert events.last(1, type="flush")[-1]["compile_class"]
        del y

    def test_honest_plan_is_clean(self, monkeypatch, pow2):
        monkeypatch.setenv("RAMBA_VERIFY", "strict")
        x = rt.fromarray(np.arange(6.0).reshape(3, 2))
        y = x * 2.0 + 1.0
        fuser.flush()
        span = events.last(1, type="flush")[-1]
        assert span["compile_class"] == ["pow2", 4]
        assert "findings" not in span
        np.testing.assert_array_equal(np.asarray(y),
                                      np.arange(6.0).reshape(3, 2) * 2 + 1)


# ---------------------------------------------------------------------------
# effects and canonical hashing
# ---------------------------------------------------------------------------


class TestEffects:
    def test_pure_rng_host_alias(self):
        a = rt.fromarray(np.ones((4, 4)))
        prog, _l, _ = fuser._prepare_program([((a + 1.0) * a)._expr])
        rep = analyze.classify_program(prog)
        assert (rep.program_class, rep.memoizable, rep.reason) == (
            "pure", True, "")
        rt.random.seed(0)
        r = rt.random.random((4,)) + 1.0
        prog, _l, _ = fuser._prepare_program([r._expr])
        rep = analyze.classify_program(prog)
        assert rep.program_class == "rng" and rep.rng_instrs \
            and rep.memoizable
        ff = rt.fromfunction(lambda i, j: i + j, (3, 3))
        prog, _l, _ = fuser._prepare_program([(ff + 1.0)._expr])
        rep = analyze.classify_program(prog)
        assert rep.program_class == "host" and not rep.memoizable
        assert "host-effecting" in rep.reason
        alias = fuser._Program((("negative", None, (0,)),), 1, ("C",),
                               (0, 1))
        rep = analyze.classify_program(alias)
        assert rep.alias_outs == (0,) and "aliases a program input" in \
            rep.reason
        rep = analyze.classify_program(
            fuser._Program((("negative", None, (0,)),), 1, ("C",), (1,)),
            donate=(0,))
        assert rep.donating and "donates" in rep.reason
        fuser.flush()

    def test_static_token_folds_torch_statics(self):
        assert analyze.static_token(torch.float32) == \
            analyze.static_token(np.dtype("float32")) == ("dtype", "float32")
        assert analyze.static_token(torch.bfloat16) is not None
        assert analyze.static_token(torch.Size([2, 3])) == \
            analyze.static_token((2, 3))
        assert analyze.static_token(torch.device("cpu")) == \
            ("device", "cpu")
        sh = pmesh.NamedSharding(pmesh.get_mesh(), pmesh.P("d0"))
        assert analyze.static_token((sh,)) is not None
        assert analyze.static_token(np.float32(2.0)) is not None
        assert analyze.static_token(repr(lambda x: x)) is None
        assert analyze.static_token((lambda x: x,)) is None

    def test_casts_are_pure_in_both_packages(self):
        # an unfolded torch.dtype would make every cast host: never memoized
        for m, f in ((rt, fuser), (rtj, jfuser)):
            x = m.fromarray(np.arange(8.0))
            prog, _l, _ = f._prepare_program(
                [(x.astype(np.float32) * 2).astype(np.int32)._expr])
            assert analyze.classify_program(prog).program_class == "pure"
        fuser.flush()
        rtj.sync()


class TestCanon:
    def test_equivalence_classes_match_the_reference(self):
        def hashes(m, f, ana):
            a = m.fromarray(np.arange(6.0))
            b = m.fromarray(np.ones(6))
            c = m.fromarray(np.arange(6.0) * 3)

            def h(e):
                return ana.canonicalize(f._prepare_program([e._expr])[0]).chash

            out = [h((a + b) * 2.0), h((b + a) * 2.0), h((c + b) * 2.0),
                   h((a - b) * 2.0), h(m.maximum(a, b)), h(m.maximum(b, a)),
                   h(a * b + c), h(c + b * a)]
            return out

        port = hashes(rt, fuser, analyze)
        ref = hashes(rtj, jfuser, janalyze)

        def classes_of(hs):
            first = {}
            return [first.setdefault(h, i) for i, h in enumerate(hs)]

        assert classes_of(port) == classes_of(ref)
        assert classes_of(port) == [0, 0, 0, 3, 4, 4, 6, 6]
        fuser.flush()
        rtj.sync()

    @pytest.mark.parametrize("pkg", ["port", "reference"])
    def test_dead_instructions_do_not_constrain(self, pkg):
        f, ana = (fuser, analyze) if pkg == "port" else (jfuser, janalyze)
        prog = f._Program(
            (("apply", (lambda x: x,), (0,)), ("negative", None, (0,))),
            1, ("C",), (2,))
        live = f._Program((("negative", None, (0,)),), 1, ("C",), (1,))
        other = f._Program((("exp", None, (0,)),), 1, ("C",), (1,))
        assert ana.try_canonicalize(prog).chash == ana.canonicalize(
            live).chash != ana.canonicalize(other).chash
        unc = f._Program((("apply", (lambda x: x,), (0,)),), 1, ("C",), (1,))
        with pytest.raises(ana.NotCanonical):
            ana.canonicalize(unc)


# ---------------------------------------------------------------------------
# memo-safety: the seeded certifier corruption
# ---------------------------------------------------------------------------


class TestMemoSafety:
    def test_rule_flags_donating_alias_and_host(self):
        plan = types.SimpleNamespace(memoizable=True, chash="x", form="y")
        prog = fuser._Program((("negative", None, (0,)),), 1, ("C",), (1,))
        fs = arules.RULES["memo-safety"](averifier.ProgramView(
            program=prog, donate=(0,), memo_plan=plan))
        assert any(f.severity == "error" and "donates" in f.message
                   for f in fs)
        prog = fuser._Program((("apply", (lambda x: x,), (0,)),), 1, ("C",),
                              (0, 1))
        fs = arules.RULES["memo-safety"](
            averifier.ProgramView(program=prog, memo_plan=plan))
        assert any("host-effecting" in f.message for f in fs)
        assert any("aliases a program input" in f.message for f in fs)
        assert arules.RULES["memo-safety"](
            averifier.ProgramView(program=prog)) == []

    def _alias_flush(self):
        """A flush whose one output is its input unchanged (a layout hint
        over a realized leaf): canonical, but not memoizable."""
        x = rt.fromarray(np.arange(-4.0, 4.0))
        sh = pmesh.NamedSharding(pmesh.get_mesh(), pmesh.P())
        return x, Node("shard_hint", (sh,), [x._expr])

    def test_strict_raises(self, monkeypatch):
        monkeypatch.setenv("RAMBA_MEMO", "1")
        monkeypatch.setenv("RAMBA_VERIFY", "strict")
        x, hint = self._alias_flush()
        with faults.active("memo:insert:always"):
            with pytest.raises(ProgramVerificationError) as ei:
                fuser.flush(extra=[hint])
        errs = _findings(ei.value.findings, "memo-safety", "error")
        assert errs and "aliases a program input" in errs[0].message
        assert len(memo.cache) == 0
        np.testing.assert_array_equal(np.asarray(x), np.arange(-4.0, 4.0))

    def test_warn_routes_and_never_caches(self, monkeypatch):
        monkeypatch.setenv("RAMBA_MEMO", "1")
        monkeypatch.setenv("RAMBA_VERIFY", "warn")
        monkeypatch.setenv("RAMBA_VERIFY_RULES", "memo-safety")
        _x, hint = self._alias_flush()
        with faults.active("memo:insert:always"):
            [out] = fuser.flush(extra=[hint])
        assert any(e["rule"] == "memo-safety"
                   for e in events.last(5, type="finding"))
        assert events.last(1, type="flush")[-1].get("verify_routed") is True
        assert len(memo.cache) == 0
        np.testing.assert_array_equal(out.numpy(), np.arange(-4.0, 4.0))

    def test_strict_insert_backstop_without_the_rule(self, monkeypatch):
        monkeypatch.setenv("RAMBA_MEMO", "1")
        monkeypatch.setenv("RAMBA_VERIFY", "strict")
        monkeypatch.setenv("RAMBA_VERIFY_SKIP", "memo-safety")
        rejected0 = registry.get("memo.insert_rejected")
        _x, hint = self._alias_flush()
        with faults.active("memo:insert:always"):
            fuser.flush(extra=[hint])
        assert registry.get("memo.insert_rejected") == rejected0 + 1
        assert len(memo.cache) == 0


# ---------------------------------------------------------------------------
# parity with ramba_tpu on NumPy-level programs
# ---------------------------------------------------------------------------


def _star2(a):
    return a[0, 1] + a[1, 0] + a[0, -1] + a[-1, 0] - 4 * a[0, 0]


_V = np.random.RandomState(0).rand(4096)
_X = np.random.RandomState(1).rand(64, 64)


def _parity_programs(m, name):
    if name == "chain":
        b = m.fromarray(_V)
        return m.sum(m.sin(b) ** 2 + m.cos(b) ** 2)
    if name == "axpy":
        return m.sum(2.5 * m.fromarray(_V) + m.fromarray(_V[::-1].copy()))
    if name == "stencil":
        return m.sstencil(m.stencil(_star2), m.fromarray(_X))
    if name == "groupby":
        return m.fromarray(_V).groupby(0, np.arange(4096) % 24, 24).sum()
    if name == "scumulative":
        return m.scumulative(lambda v, c: v + c, lambda c, b: b + c,
                             m.fromarray(_V))
    if name == "draw":
        m.random.seed(7)
        return m.random.normal(size=(64,)) + 1.0
    k = 3.0
    return m.smap(lambda v: v * k if v > 0 else -v, m.fromarray(_V - 0.5))


PARITY = ("chain", "axpy", "stencil", "groupby", "scumulative", "draw",
          "closure_smap")


@pytest.mark.parametrize("name", PARITY)
def test_verdicts_match_the_reference(name, mesh4):
    p = _parity_programs(rt, name)
    j = _parity_programs(rtj, name)
    pp, _l, _ = fuser._prepare_program([p._expr])
    jp, _l, _ = jfuser._prepare_program([j._expr])
    pr, jr = analyze.classify_program(pp), janalyze.classify_program(jp)
    assert (pr.program_class, pr.memoizable, pr.reason) == \
        (jr.program_class, jr.memoizable, jr.reason)
    want = {"chain": "pure", "axpy": "pure", "groupby": "pure",
            "draw": "rng"}.get(name, "host")
    assert pr.program_class == want
    pf = sorted((f.rule, f.severity) for f in analyze.analyze_exprs(
        [p._expr]))
    jf = sorted((f.rule, f.severity) for f in janalyze.analyze_exprs(
        [j._expr]))
    assert pf == jf
    assert (analyze.try_canonicalize(pp) is None) == \
        (janalyze.try_canonicalize(jp) is None)
    fuser.flush()
    rtj.sync()


# ---------------------------------------------------------------------------
# offline lint, and the schema shared with the reference
# ---------------------------------------------------------------------------


def _program_event(**over):
    ev = {"type": "program", "label": "prog_test",
          "instrs": [["negative", "None", [0]]], "n_leaves": 1,
          "leaf_kinds": "C", "out_slots": [1], "donate": [],
          "owners": [1], "x64": False}
    ev.update(over)
    return ev


class TestOfflineLint:
    def test_recheck_flags_recorded_hazard(self, tmp_path, capsys):
        p = tmp_path / "t.jsonl"
        p.write_text(json.dumps(_program_event(donate=[0], owners=[2]))
                     + "\n")
        assert alint.main([str(p)]) == 0
        out = capsys.readouterr().out
        assert "[donation-hazard]" in out and "prog_test" in out
        assert alint.main(["--strict", str(p)]) == 1

    def test_cross_regime_key_collision(self, tmp_path):
        p = tmp_path / "t.jsonl"
        p.write_text(json.dumps(_program_event(x64=False)) + "\n"
                     + json.dumps(_program_event(x64=True)) + "\n")
        pairs = alint.lint_events(alint.load_events(str(p)))
        assert any(f.severity == "error" and "collision" in f.message
                   for _lbl, f in pairs)

    def test_clean_json_and_missing(self, tmp_path, capsys):
        p = tmp_path / "t.jsonl"
        p.write_text(json.dumps(_program_event()) + "\n")
        assert alint.main(["--strict", str(p)]) == 0
        assert "clean" in capsys.readouterr().out
        p.write_text(json.dumps(_program_event(donate=[0], owners=[3]))
                     + "\n")
        assert alint.main(["--json", str(p)]) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[0])
        assert line["rule"] == "donation-hazard" and line["type"] == "finding"
        assert alint.main([str(tmp_path / "absent.jsonl")]) == 2

    def test_memo_audit(self, tmp_path, capsys):
        flush = {"type": "flush", "label": "prog_test", "out_bytes": 128}
        p = tmp_path / "t.jsonl"
        p.write_text("\n".join([json.dumps(_program_event())] * 3
                               + [json.dumps(flush)] * 3) + "\n")
        assert alint.main(["--memo-audit", str(p)]) == 0
        out = capsys.readouterr().out
        assert "would-be hits: 2" in out and "memoizable" in out
        p.write_text((json.dumps(_program_event(donate=[0])) + "\n") * 2)
        assert alint.main(["--memo-audit", "--json", str(p)]) == 0
        rec = json.loads(capsys.readouterr().out.strip())
        assert rec["would_hits"] == 0 and not rec["top"][0]["memoizable"]


def _pairs(pairs):
    return sorted((lbl, f.rule, f.severity, f.node, f.message)
                  for lbl, f in pairs)


def test_a_reference_trace_lints_alike(tmp_path, monkeypatch):
    """ramba_tpu records a trace with a donate_census-seeded hazard and
    one structure under both x64 regimes; both linters find the same."""
    path = str(tmp_path / "ref.jsonl")
    jevents.configure(path)
    try:
        a = rtj.asarray(np.ones((512, 512)))  # a live owner of its buffer
        b = a + 1.0
        with jfaults.inject("donate_census", "once"):
            rtj.sync()
        del b
        for x64 in (False, True):
            jax.config.update("jax_enable_x64", x64)
            c = rtj.asarray(np.ones(64, np.float32)) * 2
            rtj.sync()
            del c
    finally:
        jax.config.update("jax_enable_x64", True)
        jevents.configure(None)
    evs = alint.load_events(path)
    port = alint.lint_events(evs)
    ref = jlint.lint_events(evs)
    assert _pairs(port) == _pairs(ref)
    rules = {(f.rule, f.severity) for _l, f in port}
    assert ("donation-hazard", "error") in rules
    assert any("collision" in f.message for _l, f in port)
    del a


def test_a_port_trace_lints_alike(tmp_path, monkeypatch):
    path = str(tmp_path / "port.jsonl")
    monkeypatch.setenv("RAMBA_VERIFY", "warn")
    events.configure(path)
    try:
        for name in ("chain", "axpy", "groupby", "draw", "closure_smap"):
            np.asarray(_parity_programs(rt, name))
        x = rt.fromarray(np.ones(16))
        np.asarray(x.astype(np.float32) + 1)
    finally:
        events.configure(None)
    evs = alint.load_events(path)
    assert sum(e.get("type") == "program" for e in evs) >= 6
    port = alint.lint_events(evs)
    assert _pairs(port) == _pairs(jlint.lint_events(evs))
    assert not [f for _l, f in port if f.severity == "error"]
    assert alint.main(["--strict", path]) == 0


# ---------------------------------------------------------------------------
# the strict sweep: thirty of the port's parity programs
# ---------------------------------------------------------------------------


def _sweep_inputs():
    r = np.random.RandomState(11)
    return {"v": r.rand(257) - 0.5, "m": r.rand(17, 13), "i": r.randint(
        -50, 50, 101).astype(np.int64), "s": r.rand(24, 24).astype(np.float32)}


SWEEP = {
    "chain": lambda d: rt.sin(rt.fromarray(d["v"])) * 2 + rt.cos(
        rt.fromarray(d["v"])),
    "axpy_sum": lambda d: rt.sum(2.5 * rt.fromarray(d["v"]) + 1.0),
    "mean_axis": lambda d: rt.mean(rt.fromarray(d["m"]), axis=0),
    "var": lambda d: rt.var(rt.fromarray(d["m"]), axis=1),
    "argmax": lambda d: rt.argmax(rt.fromarray(d["m"]), axis=1),
    "minmax": lambda d: rt.max(rt.fromarray(d["v"])) - rt.min(
        rt.fromarray(d["v"])),
    "int_floordiv": lambda d: rt.fromarray(d["i"]) // 7,
    "int_mod": lambda d: rt.fromarray(d["i"]) % -5,
    "where": lambda d: rt.where(rt.fromarray(d["v"]) > 0,
                                rt.fromarray(d["v"]), 0.0),
    "cast_chain": lambda d: (rt.fromarray(d["v"]) * 100).astype(
        np.int32).astype(np.float64),
    "round": lambda d: rt.round(rt.fromarray(d["v"]) * 10, 1),
    "transpose": lambda d: rt.fromarray(d["m"]).T + 1.0,
    "reshape": lambda d: rt.fromarray(d["m"]).reshape(13, 17) * 2,
    "slice": lambda d: rt.fromarray(d["v"])[3:200:2] * 3,
    "gather": lambda d: rt.fromarray(d["v"])[np.array([5, 1, 99, 7])],
    "mask": lambda d: rt.fromarray(d["v"])[rt.fromarray(d["v"]) > 0.2],
    "concat": lambda d: rt.concatenate([rt.fromarray(d["v"]),
                                        rt.fromarray(d["v"]) * 2]),
    "stack": lambda d: rt.stack([rt.fromarray(d["v"]),
                                 rt.fromarray(d["v"]) + 1]),
    "sort": lambda d: rt.sort(rt.fromarray(d["v"])),
    "cumsum": lambda d: rt.cumsum(rt.fromarray(d["v"])),
    "matmul": lambda d: rt.fromarray(d["m"]).T @ rt.fromarray(d["m"]),
    "dot": lambda d: rt.dot(rt.fromarray(d["v"]), rt.fromarray(d["v"])),
    "arange_linspace": lambda d: rt.arange(50.0) * rt.linspace(0, 1, 50),
    "full_like": lambda d: rt.zeros((4, 5)) + rt.ones((4, 5)) * 3,
    "groupby_mean": lambda d: rt.fromarray(d["v"]).groupby(
        0, np.arange(257) % 5, 5).mean(),
    "stencil": lambda d: rt.sstencil(rt.stencil(_star2), rt.fromarray(
        d["s"])),
    "smap": lambda d: rt.smap(lambda v: v * v, rt.fromarray(d["v"])),
    "sreduce": lambda d: rt.sreduce(lambda v: v, lambda a, b: a + b, 0.0,
                                    rt.fromarray(d["v"])),
    "draw": lambda d: (rt.random.seed(3), rt.random.uniform(
        size=(40,)) * 2)[1],
    "complex": lambda d: rt.abs(rt.fromarray(d["v"]) + 1j * rt.fromarray(
        d["v"][::-1].copy())),
}


@pytest.mark.parametrize("name", sorted(SWEEP))
def test_strict_sweep(name, monkeypatch):
    build = SWEEP[name]
    d = _sweep_inputs()
    off = np.asarray(build(d))
    monkeypatch.setenv("RAMBA_VERIFY", "strict")
    n0 = registry.get("analyze.findings.error")
    on = np.asarray(build(d))
    assert registry.get("analyze.findings.error") == n0
    np.testing.assert_array_equal(on, off)
