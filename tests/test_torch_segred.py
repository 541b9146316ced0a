"""The segred kernel module (``ramba_tpu_torch/ops/segred.py``,
``csrc/segred.cuh`` and the classifier's segred branch in
``ops/kernel_backend.py``) against ramba_tpu.

On the CPU the wrapper runs the kernel's plain version; the CUDA kernel
runs only on the card (``chip_smoke.py`` and ``tests/test_torch_cuda.py``).

* the plain version against ramba_tpu's segred Pallas kernel
  (``pallas_backend._build_segred``), run in interpret mode off the TPU with
  ``autotune`` forced to ``pallas`` (as ``tests/test_autotune.py`` runs it),
  at n = 128 * 16;
* ``classify`` agrees with ramba_tpu's on the programs that reach segred,
  apart from the documented GPU rules: no 128-lane rule (the kernel masks
  its ragged tail), data in float32/float64/int32/int64/bool only, labels
  int32/int64 only, no min/max over bool;
* what pure Python can check of the kernel: its launch geometry and the
  generated sources.

Tolerances: integers, min, max and count exactly; against ramba_tpu, float
sums within n_g * eps * sum|x_g| and products within n_g * eps relative,
per group of n_g elements (at n = 2048 the orders are a few dozen roundings
deep); the kernel's own float sums within 2 * depth(n) * eps * sum|x_g|
(:func:`segred.depth`), shown against its emulated order and its faults.
"""

import numpy as np
import pytest
import torch

import jax
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from ramba_tpu.core import autotune as jautotune
from ramba_tpu.core import fuser as jfuser
from ramba_tpu.ops import pallas_backend
from ramba_tpu_torch import _build, common, convert
from ramba_tpu_torch.core import fuser
from ramba_tpu_torch.ops import kernel_backend as kb
from ramba_tpu_torch.ops import segred

N = 128 * 16
EPS = {"float32": 2.0 ** -23, "float64": 2.0 ** -52}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    torch.set_num_threads(1)


@pytest.fixture
def jax_segred_interpreted():
    """ramba_tpu's segred Pallas kernel, interpreted off the TPU; counts the
    programs it lowered so a silent fall-back to XLA fails the test."""
    lowered = []
    real = pallas_backend._build_segred

    def counting(program):
        lowered.append(program)
        return real(program)

    jautotune.reconfigure(mode="force:pallas")
    jfuser._compile_cache.clear()
    pallas_backend._build_segred = counting
    try:
        yield lowered
    finally:
        pallas_backend._build_segred = real
        jautotune.reconfigure()


def _data(dtype, n, seed):
    rs = np.random.RandomState(seed)
    if dtype == "bool":
        return rs.rand(n) > 0.5
    if dtype.startswith("int"):
        return rs.randint(-9, 10, n).astype(dtype)
    x = rs.uniform(0.5, 1.5, n).astype(dtype)
    return x


def _labels(n, G, seed, dtype="int32"):
    lab = np.random.RandomState(seed).randint(-1, G + 1, n)  # -1 and G drop
    return lab.astype(dtype)


def _program(x, labels, G, kind):
    g = x.groupby(0, labels, G)
    return fuser.prepare_program([getattr(g, kind)().read_expr()])


def _close(got, want, kind, dtype, data, labels):
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype)
    if w.dtype.kind != "f" or kind in ("min", "max"):
        np.testing.assert_array_equal(g, w)
        return
    data = np.asarray(data, np.float64)
    for k in range(len(w)):
        in_g = labels == k
        n_g = max(int(in_g.sum()), 1)
        if kind == "sum":
            bound = n_g * EPS[w.dtype.name] * float(np.abs(data[in_g]).sum())
        else:  # a product of ~n/G factors in [0.5, 1.5): relative error
            bound = n_g * EPS[w.dtype.name] * abs(float(w[k]))
        assert abs(float(g[k]) - float(w[k])) <= bound, (k, g, w)


SEG_CASES = [(k, d) for d in ("float32", "float64", "int32", "int64", "bool")
             for k in ("sum", "prod", "min", "max", "count")
             if not (d == "bool" and k in ("min", "max"))]


@pytest.mark.parametrize("kind,dtype", SEG_CASES,
                         ids=[f"{k}-{d}" for k, d in SEG_CASES])
def test_plain_version_against_jax_pallas(jax_segred_interpreted, kind, dtype):
    G = 8
    x = _data(dtype, N, 1)
    labels = _labels(N, G, 2)
    ref = rtj.fromarray(x)
    want = np.asarray(getattr(ref.groupby(0, labels, G), kind)())
    assert jax_segred_interpreted, "ramba_tpu did not run its Pallas kernel"
    (port,) = convert.state_from_reference({"x": x}).values()
    p, vals = _program(port, labels, G, kind)
    assert kb.classify(p, vals) == "segred"
    (got,) = segred.run(p, vals)
    _close(got, want, kind, dtype, x, labels)
    _close(segred.segred_reference(p, vals)[0], want, kind, dtype, x, labels)
    # the user path gives the same
    _close(getattr(port.groupby(0, labels, G), kind)(), want, kind, dtype, x,
           labels)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_min_max_propagate_nan(dtype):
    """As jnp.min/jnp.max and NumPy do.  (ramba_tpu itself loses the NaN
    when the data is sharded, as on the tests' 8-device CPU mesh at this n,
    so the plain version is held against NumPy here.)"""
    G = 8
    x = _data(dtype, N, 10)
    x[[17, 300]] = np.nan
    labels = _labels(N, G, 11)
    (port,) = convert.state_from_reference({"x": x}).values()
    for kind, fn in (("min", np.min), ("max", np.max)):
        p, vals = _program(port, labels, G, kind)
        assert kb.classify(p, vals) == "segred"
        (got,) = segred.run(p, vals)
        want = np.array([fn(x[labels == g]) for g in range(G)], dtype)
        np.testing.assert_array_equal(np.asarray(got), want)
        assert np.isnan(np.asarray(got)).sum() == len({labels[17], labels[300]}
                                                       - {-1, G})


CLASSIFY = {
    # name: (data, labels dtype, G, kind, jax's answer, the port's answer)
    "sum_f32": (lambda: _data("float32", N, 0), "int32", 8, "sum", "segred", "segred"),
    "count_i64": (lambda: _data("int64", N, 0), "int32", 64, "count", "segred", "segred"),
    "max_i32_labels64": (lambda: _data("int32", N, 0), "int64", 24, "max", "segred",
                         "segred"),
    "one_group": (lambda: _data("float64", N, 0), "int32", 1, "prod", "segred", "segred"),
    "mean": (lambda: _data("float64", N, 0), "int32", 8, "mean", None, None),
    "too_many_groups": (lambda: _data("float64", N, 0), "int32", 65, "sum", None, None),
    "two_dim": (lambda: _data("float64", N, 0).reshape(16, 128), "int32", 8, "sum",
                None, None),
    # the GPU rules
    "ragged_n": (lambda: _data("float64", N - 3, 0), "int32", 8, "sum", None, "segred"),
    "uint8_data": (lambda: _data("int32", N, 0).astype(np.uint8), "int32", 8, "sum",
                   "segred", None),
    "int16_labels": (lambda: _data("float32", N, 0), "int16", 8, "sum", "segred", None),
    "bool_min": (lambda: _data("bool", N, 0), "int32", 8, "min", "segred", None),
}


def _segment_program(mod, x, labels, G, kind):
    """The one-instruction program of ``g.<kind>()``, labels in their own
    dtype (RambaGroupby always casts them to int32)."""
    from ramba_tpu.core.expr import Node as JNode
    from ramba_tpu_torch.core.expr import Node

    args = [x.read_expr(), mod.fromarray(labels).read_expr()]
    if mod is rt:
        return fuser.prepare_program([Node("segment_reduce", (kind, G, 0), args)])
    jp, leaves = jfuser._linearize([JNode("segment_reduce", (kind, G, 0), args)])
    return jp, [leaf.value for leaf in leaves]


@pytest.mark.parametrize("name", sorted(CLASSIFY))
def test_classify_agrees_with_ramba_tpu(name):
    data, ldt, G, kind, want_jax, want_port = CLASSIFY[name]
    x = data()
    labels = _labels(x.shape[0], G, 3, ldt)
    ref, port = rtj.fromarray(x), convert.state_from_reference({"x": x})["x"]
    jp, jvals = _segment_program(rtj, ref, labels, G, kind)
    pp, pvals = _segment_program(rt, port, labels, G, kind)
    assert pallas_backend.classify(jp, jvals) == want_jax
    assert kb.classify(pp, pvals) == want_port


def test_two_reductions_in_one_flush_take_the_generic_lowering():
    """As in ramba_tpu, segred takes a program of one segment_reduce; two
    pending reductions flush together on the generic lowering."""
    (x,) = convert.state_from_reference({"x": _data("float64", N, 4)}).values()
    g = x.groupby(0, _labels(N, 8, 5), 8)
    p, vals = fuser.prepare_program([g.sum().read_expr(), g.max().read_expr()])
    assert kb.classify(p, vals) is None


def test_launch_geometry():
    for n in (1, 255, 256, 257, N, 10 ** 6, 1 << 28):
        nb = segred.num_blocks(n)
        # one element per thread until the grid is full
        assert nb == min(-(-n // segred.THREADS), segred.MAX_BLOCKS)
        rows = -(-n // (nb * segred.THREADS))
        assert segred.depth(n) == rows + -(-nb // segred.THREADS) + 16
    assert segred.num_blocks(1 << 28) == 1056 and segred.depth(1 << 28) == 1014
    # the float32 sum bound the card's checks use, 2 * depth * eps * sum|x_g|,
    # stays below half of one CTA's share of a group at the main path's n
    assert 2 * segred.depth(1 << 28) * EPS["float32"] * segred.MAX_BLOCKS < 0.5


def _kernel_order_sum(x, labels, G, narrow=None, skip_cta=None):
    """The segred kernel's float sum of each group, in the kernel's order:
    grid thread t folds elements t, t + stride, ... in turn, each CTA's
    tree over its THREADS partials gives its row, each fold thread passes
    over rows tid, tid + THREADS, ... and the fold's tree gives the group.
    ``narrow`` rounds every partial to that dtype and ``skip_cta`` leaves
    one CTA's row out: faults the sum bound must catch."""
    n, T = x.numel(), segred.THREADS
    nb = segred.num_blocks(n)
    rows = -(-n // (nb * T))

    def rnd(a):
        return a if narrow is None else a.to(narrow).to(x.dtype)

    def tree(a):
        while a.shape[-1] > 1:
            h = a.shape[-1] // 2
            a = rnd(a[..., :h] + a[..., h:])
        return a[..., 0]

    out = []
    for g in range(G):
        v = torch.zeros(rows * nb * T, dtype=x.dtype)
        v[:n] = torch.where(labels == g, x, torch.zeros((), dtype=x.dtype))
        acc = torch.zeros(nb * T, dtype=x.dtype)
        for r in v.view(rows, nb * T):
            acc = rnd(acc + r)
        row = tree(acc.view(nb, T))
        if skip_cta is not None:
            row[skip_cta] = 0
        fold = torch.zeros(-(-nb // T) * T, dtype=x.dtype)
        fold[:nb] = row
        acc = torch.zeros(T, dtype=x.dtype)
        for r in fold.view(-1, T):
            acc = rnd(acc + r)
        out.append(tree(acc))
    return torch.stack(out)


SUM_FAULTS = [None, "skip_cta", "bf16_partials", "drop_third"]


@pytest.mark.parametrize("fault", SUM_FAULTS, ids=[str(f) for f in SUM_FAULTS])
def test_sum_bound_holds_the_kernel_order_and_catches_faults(fault):
    """The kernel's order, emulated, stays within ``2 * depth(n) * eps *
    sum|x_g|`` of the plain version (the bound of ``chip_smoke.py`` and
    ``tests/test_torch_cuda.py``); a kernel that skips a CTA, keeps bf16
    partials or drops a third of its elements does not."""
    n, G = (1 << 20) + 37, 24
    rs = np.random.RandomState(12)
    x_np = rs.uniform(0.5, 1.5, n).astype(np.float32)
    labels = _labels(n, G, 13)
    x = torch.from_numpy(x_np)
    lab = torch.from_numpy(labels)
    (port,) = convert.state_from_reference({"x": x_np}).values()
    (want,) = segred.segred_reference(*_program(port, labels, G, "sum"))
    used = x.clone()
    if fault == "drop_third":
        used[::3] = 0
    got = _kernel_order_sum(used, lab, G,
                            narrow=torch.bfloat16 if fault == "bf16_partials" else None,
                            skip_cta=5 if fault == "skip_cta" else None)
    xd = x.double()
    exact = torch.stack([xd[lab == g].sum() for g in range(G)])
    sum_abs = torch.stack([xd[lab == g].abs().sum() for g in range(G)])
    D = segred.depth(n)
    within = (got.double() - want.double()).abs() <= 2 * D * EPS["float32"] * sum_abs
    if fault is None:
        assert bool(within.all())
        # each order alone: the kernel's within D * u * S_g, the plain
        # version's within the 3D the bound leaves it (u = eps / 2)
        u = EPS["float32"] / 2
        assert bool(((got.double() - exact).abs() <= D * u * sum_abs).all())
        assert bool(((want.double() - exact).abs() <= 3 * D * u * sum_abs).all())
    else:
        assert not bool(within.all())


def test_generated_sources():
    x = convert.state_from_reference({"x": _data("int32", N, 6)})["x"]
    labels = _labels(N, 24, 7)
    srcs = {}
    for kind in ("sum", "prod", "min", "max", "count"):
        p, vals = _program(x, labels, 24, kind)
        srcs[kind] = segred.program_spec(p, vals)
    assert "launch<int, long long, int, ramba::segred::OpSum, false>" \
        in srcs["sum"].source  # int32 sums accumulate in int64
    assert "launch<int, int, int, ramba::segred::OpMin, false>" \
        in srcs["min"].source
    assert "OpSum, true>" in srcs["count"].source
    assert len({s.name for s in srcs.values()}) == 5
    for s in srcs.values():
        assert '#include "segred.cuh"' in s.source
        assert 'extern "C" int ramba_segred_launch' in s.source
    # count reads only the labels: one source whatever the data dtype
    y = convert.state_from_reference({"y": _data("float64", N, 6)})["y"]
    assert segred.program_spec(*_program(y, labels, 24, "count")) \
        == srcs["count"]
    header = (_build.CSRC_DIR + "/segred.cuh")
    with open(header) as f:
        text = f.read()
    assert "atomicAdd" not in text and "atomicCAS" not in text
    assert segred.THREADS == 256 and "THREADS = 256" in text
    assert segred.launches == 0  # nothing launched on the CPU


def test_wrapper_never_reaches_plain_version_off_cpu(monkeypatch):
    """On tensors that are not on the CPU the wrapper launches or raises;
    it never runs the plain version."""
    x = convert.state_from_reference({"x": _data("float64", N, 8)})["x"]
    p, vals = _program(x, _labels(N, 8, 9), 8, "sum")
    meta = [v.to("meta") if isinstance(v, torch.Tensor) else v for v in vals]
    called = []
    monkeypatch.setattr(segred, "segred_reference", lambda *a: called.append(a))
    with pytest.raises(RuntimeError, match="expected cuda"):
        segred.run(p, meta)
    assert not called
