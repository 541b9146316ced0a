"""Chain segmentation in the port's fuser, against ramba_tpu.

The iterator (``_last_use_map``, ``_iter_segments``, ``_byte_segment_end``)
is held against ramba_tpu's on the same programs, exactly; segmented
flushes (``tests/test_fusion.py:125-200``'s cases) against ramba_tpu and
NumPy: segment counts exactly, float32 chains of exact additions exactly,
the shared-subexpression chain within ramba_tpu's own tolerance of NumPy
(rtol 2e-5 on ``b``, 2e-4 on ``c``) and within 1e-6 of ramba_tpu.
"""

import math

import numpy as np
import pytest
import torch

import jax
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from ramba_tpu import common as jcommon
from ramba_tpu.core import fuser as jfuser
from ramba_tpu_torch import common
from ramba_tpu_torch.core import fuser
from ramba_tpu_torch.observe import events, registry


@pytest.fixture(autouse=True)
def _port_on_cpu():
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    torch.set_num_threads(1)
    rt.sync()
    rtj.sync()


@pytest.fixture
def seg_size():
    """Both packages' segment size, restored after the test."""
    old, jold = common.max_program_instrs, jcommon.max_program_instrs

    def set_(n):
        common.max_program_instrs = n
        jcommon.max_program_instrs = n

    yield set_
    common.max_program_instrs, jcommon.max_program_instrs = old, jold


def _program(exprs):
    program, _vals = fuser.prepare_program(exprs)
    return program


def _chain_program(n_ops, shared=False):
    x = rt.arange(16.0)
    b = x
    for i in range(n_ops):
        if shared:
            s = b * 0.5 + i
            b = s + rt.sin(s) * 0.1
        else:
            b = b * 1.5 + 0.25
    roots = [b, b - x] if shared else [b]
    return _program([r._expr for r in roots])


def _as_ref(program):
    return jfuser._Program(program.instrs, program.n_leaves,
                           program.leaf_kinds, program.out_slots)


PROGRAMS = {"chain40": (40, False), "chain401": (401, False),
            "shared12": (12, True), "shared50": (50, True)}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_last_use_map_is_slot_indexed_as_ramba_tpus(name):
    """The one convention: slot -> the highest slot that reads it, outputs
    pinned at n_leaves + len(instrs) + 1."""
    p = _chain_program(*PROGRAMS[name])
    lu = fuser._last_use_map(p)
    assert lu == jfuser._last_use_map(_as_ref(p))
    inf = p.n_leaves + len(p.instrs) + 1
    assert all(lu[s] == inf for s in p.out_slots)
    for i, (_op, _st, args) in enumerate(p.instrs):
        for s in args:
            assert lu[s] >= p.n_leaves + i


def test_last_use_map_pins_a_hand_built_program():
    # leaves 0, 1; instr 0 -> slot 2 reads (0, 1); instr 1 -> slot 3 reads
    # (2, 0); instr 2 -> slot 4 reads (3,); outputs (4, 2)
    p = fuser._Program((("map", ("add",), (0, 1)), ("map", ("multiply",), (2, 0)),
                        ("map", ("negative",), (3,))), 2, ("C", "C"), (4, 2))
    assert fuser._last_use_map(p) == {0: 3, 1: 2, 2: 6, 3: 4, 4: 6}


@pytest.mark.parametrize("size", [1, 7, 8, 64, 384])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_iter_segments_matches_ramba_tpu(name, size):
    p = _chain_program(*PROGRAMS[name])
    mine = list(fuser._iter_segments(p, fuser._last_use_map(p), size))
    ref = list(jfuser._iter_segments(_as_ref(p),
                                     jfuser._last_use_map(_as_ref(p)), size))
    assert len(mine) == len(ref) == math.ceil(len(p.instrs) / size)
    for (sp, ins, outs, top), (jp, jins, jouts, jtop) in zip(mine, ref):
        assert (sp.instrs, sp.n_leaves, sp.leaf_kinds, sp.out_slots) == \
            (jp.instrs, jp.n_leaves, jp.leaf_kinds, jp.out_slots)
        assert (ins, outs, top) == (jins, jouts, jtop)


@pytest.mark.parametrize("seed", range(6))
def test_byte_segment_end_matches_ramba_tpu(seed):
    rng = np.random.default_rng(seed)
    p = _chain_program(int(rng.integers(5, 60)), bool(seed % 2))
    slots = p.n_leaves + len(p.instrs)
    slot_bytes = {s: int(rng.integers(0, 4096)) for s in range(slots)}
    cap = int(rng.integers(1, 16384))
    seg_cap = int(rng.integers(0, 9))
    for start in range(len(p.instrs)):
        got = fuser._byte_segment_end(p.instrs, p.n_leaves, start,
                                      slot_bytes, cap, seg_cap)
        want = jfuser._byte_segment_end(p.instrs, p.n_leaves, start,
                                        slot_bytes, cap, seg_cap)
        assert got == want and got > start


def test_byte_bounded_segments_match_ramba_tpu():
    p = _chain_program(30, True)
    slot_bytes = {s: 800 for s in range(p.n_leaves + len(p.instrs))}
    kw = dict(slot_bytes=slot_bytes, max_seg_bytes=5000)
    mine = list(fuser._iter_segments(p, fuser._last_use_map(p), 0, **kw))
    ref = list(jfuser._iter_segments(_as_ref(p), jfuser._last_use_map(
        _as_ref(p)), 0, **kw))
    assert [(s.instrs, i, o, t) for s, i, o, t in mine] == \
        [(s.instrs, i, o, t) for s, i, o, t in ref]
    assert len(mine) > 1


def _segments_of(m, f):
    fz = fuser if m is rt else jfuser
    m.sync()
    before = fz.stats["segments"]
    out = f(m)
    m.sync()
    return fz.stats["segments"] - before, out


@pytest.mark.parametrize("n_ops", [1000, 385])
def test_long_chain_is_segmented_and_exact(n_ops):
    def f(m):
        x = m.zeros(2_000, dtype="float32")
        for _ in range(n_ops):
            x = x + 1
        return x

    f0 = fuser.stats["flushes"]
    segs, x = _segments_of(rt, f)
    jsegs, jx = _segments_of(rtj, f)
    assert fuser.stats["flushes"] - f0 == 1
    assert segs == jsegs == math.ceil(n_ops / common.max_program_instrs)
    np.testing.assert_array_equal(x.asarray(), np.full(2000, n_ops, "f4"))
    np.testing.assert_array_equal(x.asarray(), np.asarray(jx))
    assert x.dtype == np.float32


def test_segment_count_scales_with_chain_length():
    counts = []
    for n_ops in (500, 1500):
        def f(m, n_ops=n_ops):
            x = m.zeros(512, dtype="float32")
            for _ in range(n_ops):
                x = m.sqrt(x * x + 1.0) - m.sqrt(x * x) + x
            return x

        segs, _x = _segments_of(rt, f)
        jsegs, _jx = _segments_of(rtj, f)
        assert segs == jsegs
        counts.append(segs)
    assert counts[1] > counts[0] >= 1, counts


def test_segmented_dag_with_shared_subexprs_matches_numpy(seg_size):
    seg_size(8)
    rng = np.random.default_rng(0)
    an = rng.standard_normal(3_000).astype(np.float32)
    ref = an.copy()
    for i in range(40):
        sr = ref * 0.5 + i
        ref = sr + np.sin(sr) * 0.1
    res = {}
    for m in (rt, rtj):
        a = m.array(an)
        b = a
        for i in range(40):
            s = b * 0.5 + i
            b = s + m.sin(s) * 0.1
        c = b - a  # the original leaf read again in the last segment
        m.sync()
        res[m] = (np.asarray(b.asarray()), np.asarray(c.asarray()))
    for m in (rt, rtj):
        np.testing.assert_allclose(res[m][0], ref, rtol=2e-5)
        np.testing.assert_allclose(res[m][1], ref - an, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(res[rt][0], res[rtj][0], rtol=1e-6)
    assert res[rt][0].dtype == np.float32


def test_segmentation_disabled_by_zero(seg_size):
    seg_size(0)

    def f(m):
        x = m.zeros(256, dtype="float32")
        for _ in range(600):
            x = x + 1
        return x

    segs, x = _segments_of(rt, f)
    jsegs, _jx = _segments_of(rtj, f)
    assert segs == jsegs == 0
    np.testing.assert_array_equal(x.asarray(), np.full(256, 600, "f4"))


def test_segments_count_in_the_registry_and_the_span():
    r0 = registry.get("fuser.segments")
    x = rt.zeros(64)
    for _ in range(500):  # 1000 instructions and the zeros: 3 segments
        x = x * 1.0000001 + 1e-9
    rt.sync()
    assert registry.get("fuser.segments") - r0 == 3
    span = events.last(1, type="flush")[-1]
    assert len(span["calls"]) == 3 and span["segments"] == 2


def test_segments_the_kernels_accept_take_the_kernel_backend(seg_size):
    """At a segment size within elemred's 64-instruction limit every
    segment of an elementwise chain is one kernel program (on the CPU its
    plain version runs); at 384 none is."""
    base = rt.fromarray(np.arange(1000.0))  # a materialised leaf

    def chain():
        y = base
        for i in range(100):
            y = y * (1.0 + i * 1e-7) + 3e-9 * i
        return y

    outs = {}
    for size in (0, 384, 64):
        seg_size(size)
        y = chain()
        rt.sync()
        span = events.last(1, type="flush")[-1]
        outs[size] = np.asarray(y.asarray())
        backends = [c["backend"] for c in span["calls"]]
        if size == 64:
            assert backends == ["kernel"] * 4
        else:
            assert backends == ["torch"]
    # arithmetic only: every segmentation gives the same bytes
    assert outs[0].tobytes() == outs[384].tobytes() == outs[64].tobytes()


@pytest.mark.parametrize("size", [0, 64, 384])
def test_analyze_pending_counts_segments_as_ramba_tpu(seg_size, size):
    seg_size(size)
    res = {}
    for m, fz in ((rt, fuser), (rtj, jfuser)):
        x = m.arange(300.0)
        for _ in range(300):
            x = x * 2.0 - 1.0
        res[m] = fz.analyze_pending()
        m.sync()
    mine, ref = res[rt], res[rtj]
    assert mine["instructions"] == ref["instructions"]
    assert mine["n_leaves"] == ref["n_leaves"]
    assert mine.get("segments") == ref.get("segments")
    if size:
        assert mine["segments"] == math.ceil(mine["instructions"] / size)


def test_analyze_pending_none_when_empty_and_leaves_work_pending():
    rt.sync()
    assert fuser.analyze_pending() is None
    a = rt.arange(1000.0) + 1
    out = fuser.analyze_pending()
    assert out["instructions"] >= 1
    assert out["output_size_in_bytes"] == 8000
    np.testing.assert_array_equal(a.asarray(), np.arange(1000.0) + 1)


def test_a_segmented_chain_drops_values_at_their_last_use(monkeypatch):
    """Each segment sees only the values it reads; nothing from an
    earlier segment stays alive past its last use."""
    seen = []
    real = fuser._execute

    def spy(program, leaf_vals, span=None, **kw):
        seen.append(sum(isinstance(v, torch.Tensor) for v in leaf_vals))
        return real(program, leaf_vals, span, **kw)

    monkeypatch.setattr(fuser, "_execute", spy)
    x = rt.arange(64.0)
    for _ in range(900):
        x = x + 1.0
    rt.sync()
    assert len(seen) == 3 and max(seen) == 1
    np.testing.assert_array_equal(x.asarray(), np.arange(64.0) + 900)
