"""The stencil kernel module (``ramba_tpu_torch/ops/stencil_kernel.py``,
``csrc/stencil_tile.cuh``) and the stencil skeleton against ramba_tpu.

ramba_tpu runs its Pallas stencil kernel in interpret mode here (as
``tests/test_pallas_stencil.py`` does) wherever it takes the dtype
(float32, bfloat16), and its XLA shifted-slice path elsewhere.  The port's
wrapper runs the kernel's plain version on CPU tensors; the CUDA kernel runs
only on the card (``chip_smoke.py`` and ``tests/test_torch_cuda.py``).
What the CPU can check of the kernel is checked here: the tracer's tap
expression (evaluated with torch the way the kernel computes it), the code
it generates and the eligibility rules.

Tolerances: float64 rtol=atol=1e-12; float32 rtol=atol=1e-6 (both compute
the same operations in the same order); bfloat16 against ramba_tpu rtol=1e-2
with atol=1e-2 times the largest |value| (XLA may keep intermediates in
float32 where torch rounds each op, and a sum of rounded terms that cancels
keeps the terms' absolute error); the port's bfloat16 tap expression against
its plain version exactly (both round every op to bfloat16).
"""

import numpy as np
import pytest
import torch

import jax
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from ramba_tpu.ops import stencil_pallas, stencil_sharded
from ramba_tpu_torch import common, convert
from ramba_tpu_torch.core.expr import BF16
from ramba_tpu_torch.models import jacobi
from ramba_tpu_torch.ops import stencil_kernel as sk

TOL = {"float64": 1e-12, "float32": 1e-6, "bfloat16": 1e-2}


@pytest.fixture(autouse=True)
def _both(monkeypatch):
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    # one thread: the tier-1 run shares the CPU among its workers, and
    # timing-sensitive tests of other files run beside these
    torch.set_num_threads(1)
    monkeypatch.setattr(stencil_pallas, "_INTERPRET", True)
    monkeypatch.setattr(stencil_pallas, "_ENABLED", True)
    monkeypatch.setattr(stencil_sharded, "eligible", lambda *a, **k: False)


def _pair(**arrays):
    ref = {k: rtj.fromarray(v) for k, v in arrays.items()}
    port = convert.state_from_reference({k: a.asarray() for k, a in ref.items()})
    return ref, port


def _close(got, want, what="", bf16=False):
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype, f"{what}: {g.dtype} vs {w.dtype}"
    tol = TOL["bfloat16" if bf16 else str(w.dtype)]
    g, w = g.astype(np.float64), w.astype(np.float64)
    atol = tol * max(1.0, np.abs(w).max()) if tol == TOL["bfloat16"] else tol
    np.testing.assert_allclose(g, w, rtol=tol, atol=atol, err_msg=what)


def star2(a):
    return (
        0.25 * (a[0, 1] + a[0, -1] + a[1, 0] + a[-1, 0])
        + 0.125 * (a[0, 2] + a[0, -2] + a[2, 0] + a[-2, 0])
    )


def pick(a):
    v = a[0, 1]
    if v > 0:
        return v
    return a[0, -1]


def npk(a):
    return np.maximum(a[0, -1], a[0, 1]) + np.where(a[1, 0] > a[-1, 0],
                                                    np.sqrt(np.abs(a[0, 0])), 0.5)


def mix(a, b):
    return a[0, 0] + 0.5 * (b[-1, 0] + b[1, 0])


def shifted(a):
    return a[-3, 0] + a[0, 5]


def scaled(a, c):
    return c * (a[0, 1] - a[0, -1])


def _data(shape, dtype, seed):
    x = np.random.RandomState(seed).randn(*shape)
    return x.astype(BF16 if dtype == "bfloat16" else dtype)


def _run(body, arrays, *literals, iters=None):
    ref, port = _pair(**arrays)
    outs = []
    for m, a in ((rtj, ref), (rt, port)):
        st = m.stencil(body)
        args = list(a.values()) + list(literals)
        if iters is None:
            outs.append(np.asarray(m.sstencil(st, *args)))
        else:
            outs.append(np.asarray(m.sstencil_iterate(st, args[0], iters,
                                                      *args[1:])))
    return outs


CASES = [
    ("star2_fast_64x256_f32", star2, [(64, 256)], "float32", ()),
    ("star2_odd_37x131_f32", star2, [(37, 131)], "float32", ()),
    ("star2_f64", star2, [(40, 72)], "float64", ()),
    ("star2_bf16", star2, [(48, 128)], "bfloat16", ()),
    ("two_slots", mix, [(24, 40), (24, 40)], "float32", ()),
    ("asymmetric", shifted, [(40, 128)], "float32", ()),
    ("branching_f64", pick, [(16, 16)], "float64", ()),
    ("branching_f32", pick, [(16, 16)], "float32", ()),
    ("numpy_body", npk, [(20, 24)], "float64", ()),
    ("literal_arg", scaled, [(12, 20)], "float64", (0.75,)),
]


@pytest.mark.parametrize("name,body,shapes,dtype,lits", CASES,
                         ids=[c[0] for c in CASES])
def test_sstencil_matches_ramba_tpu(name, body, shapes, dtype, lits):
    arrays = {f"a{k}": _data(s, dtype, k) for k, s in enumerate(shapes)}
    want, got = _run(body, arrays, *lits)
    _close(got, want, name)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_jacobi_kernels_match_ramba_tpu(dtype):
    from ramba_tpu.models import jacobi as jjacobi

    u, f = _data((40, 128), dtype, 1), _data((40, 128), dtype, 2)
    ref, port = _pair(u=u, f=f)
    for name in ("sweep", "lap"):
        jst, pst = jjacobi._kernels()[name], jacobi._kernels()[name]
        args_j = [ref["u"], ref["f"]][:1 + (name == "sweep")]
        args_p = [port["u"], port["f"]][:1 + (name == "sweep")]
        _close(rt.sstencil(pst, *args_p), rtj.sstencil(jst, *args_j), name)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sstencil_iterate_matches_chained_and_ramba_tpu(dtype):
    x = _data((32, 40), dtype, 3)
    want, got = _run(star2, {"x": x}, iters=5)
    _close(got, want, "iterate vs ramba_tpu")
    (port,) = convert.state_from_reference({"x": x}).values()
    y = port
    for _ in range(5):
        y = rt.sstencil(rt.stencil(star2), y)
    _close(got, y, "iterate vs 5 chained sstencil")


def test_sstencil_iterate_mixed_dtype_carry():
    # an f64 carry beside an f32 right-hand side: the kernel does not take
    # mixed slots, the shifted path does, and the dtypes still match
    u, f = np.zeros((16, 16)), _data((16, 16), "float32", 4)
    ref, port = _pair(u=u, f=f)
    sw = jacobi._kernels()["sweep"]
    from ramba_tpu.models import jacobi as jjacobi

    _close(rt.sstencil_iterate(sw, port["u"], 4, port["f"]),
           rtj.sstencil_iterate(jjacobi._kernels()["sweep"], ref["u"], 4,
                                ref["f"]), "mixed carry")


TRACE_BODIES = [("star2", star2, 1), ("pick", pick, 1), ("npk", npk, 1),
                ("mix", mix, 2), ("shifted", shifted, 1),
                ("sweep", jacobi._kernels()["sweep"].func, 2),
                ("lap", jacobi._kernels()["lap"].func, 1)]


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("name,body,n_slots", TRACE_BODIES,
                         ids=[b[0] for b in TRACE_BODIES])
def test_tap_expression_matches_plain_version(name, body, n_slots, dtype):
    slots = tuple(("arr", k) for k in range(n_slots))
    tr = sk.trace(body, slots)
    assert tr.expr is not None, f"{name} did not trace"
    arrs = [torch.from_numpy(_data((24, 33), "float32", k)).to(
        torch.bfloat16 if dtype == "bfloat16" else getattr(torch, dtype))
        for k in range(n_slots)]
    got = sk.eval_taps(tr.expr, tr.lo, tr.hi, arrs)
    want = sk.stencil_reference(body, tr.lo, tr.hi, slots, arrs)
    assert got.dtype == want.dtype
    _close(got.double().numpy(), want.double().numpy(), name,
           bf16=dtype == "bfloat16")
    spec = sk.spec_for(tr.expr, tr.lo, tr.hi, n_slots, arrs[0].dtype)
    assert spec is not None and "ramba_stencil_launch" in spec.source


@pytest.mark.parametrize("name,body,n_slots", TRACE_BODIES,
                         ids=[b[0] for b in TRACE_BODIES])
def test_bf16_body_rounds_every_operation(name, body, n_slots):
    """The kernel rounds each bfloat16 operation to bfloat16, as torch and
    ramba_tpu do: the tap expression, evaluated the way the kernel computes,
    equals the plain version exactly, and the generated body rounds every
    arithmetic result."""
    slots = tuple(("arr", k) for k in range(n_slots))
    tr = sk.trace(body, slots)
    arrs = [torch.from_numpy(_data((24, 33), "float32", k)).to(torch.bfloat16)
            for k in range(n_slots)]
    got = sk.eval_taps(tr.expr, tr.lo, tr.hi, arrs)
    want = sk.stencil_reference(body, tr.lo, tr.hi, slots, arrs)
    assert torch.equal(got, want), name
    src = sk.spec_for(tr.expr, tr.lo, tr.hi, n_slots, torch.bfloat16).source
    n_arith = sum(1 for n in _nodes(tr.expr) if n.kind == "op"
                  and n.arg in ("add", "subtract", "multiply", "true_divide"))
    assert src.count("__float2bfloat16_rn(") >= n_arith, name


def _nodes(e):
    stack, seen = [e], set()
    while stack:
        n = stack.pop()
        if id(n) not in seen:
            seen.add(id(n))
            yield n
            stack.extend(n.args)


def test_neighborhood_and_generated_source():
    tr = sk.trace(star2, (("arr", 0),))
    assert (tr.lo, tr.hi, tr.taps) == ((-2, -2), (2, 2), 8)
    spec = sk.spec_for(tr.expr, tr.lo, tr.hi, 1, torch.float32)
    assert "launch_stencil<float, 1, 2, 2, 2, 2, 128, 32, 4, 2, Body>" \
        in spec.source
    assert "s.template tap<0, -2, 0>()" in spec.source
    bf = sk.spec_for(tr.expr, tr.lo, tr.hi, 1, torch.bfloat16)
    assert "launch_stencil<__nv_bfloat16" in bf.source
    # a constant never depends on the array: same body, same source
    assert sk.spec_for(tr.expr, tr.lo, tr.hi, 1, torch.float32) is spec
    tr2 = sk.trace(pick, (("arr", 0),))
    assert (tr2.lo, tr2.hi) == ((0, -1), (0, 1))
    assert "?" in sk.spec_for(tr2.expr, tr2.lo, tr2.hi, 1, torch.float64).source


def opaque_body(a):
    return np.sinc(a[0, 1]) + a[0, 0]


def wide_body(a):
    return a[0, 20] - a[0, -20]


def widening_body(a):
    return a[0, 1] * np.float64(2.0)


@pytest.mark.parametrize("body,dtype", [(opaque_body, "float64"),
                                        (wide_body, "float64"),
                                        (widening_body, "float32")])
def test_ineligible_bodies_take_the_shifted_path(body, dtype, monkeypatch):
    # ramba_tpu's Pallas kernel casts the result to the input dtype where
    # its XLA path keeps NumPy's (f32 * np.float64 is f64): the port keeps
    # NumPy's, so it is held against the XLA path
    monkeypatch.setattr(stencil_pallas, "_ENABLED", False)
    x = _data((24, 48), dtype, 5)
    slots = (("arr", 0),)
    tr = sk.trace(body, slots)
    arrs = [torch.from_numpy(x)]
    before = sk.ineligible
    assert not sk.available(body, tr.lo, tr.hi, slots, arrs)
    assert sk.ineligible == before + 1
    want, got = _run(body, {"x": x})
    _close(got, want, body.__name__)


def test_direct_call_on_host_arrays():
    x = _data((20, 24), "float64", 6)
    _close(rt.stencil(star2)(x), rtj.stencil(star2)(x), "direct call")


def test_kernel_eligibility_rules():
    f32 = torch.zeros(8, 8)
    assert sk.available_local([f32])
    assert sk.available_local([f32.double(), f32.double()])
    assert sk.available_local([f32.to(torch.bfloat16)])
    assert not sk.available_local([f32, f32.double()])  # mixed slots
    assert not sk.available_local([f32.to(torch.int32)])
    assert not sk.available_local([torch.zeros(8)])  # 1-D
    assert not sk.available_local([f32, torch.zeros(8, 9)])


def test_wrapper_never_reaches_plain_version_off_cpu(monkeypatch):
    x = torch.zeros(16, 16, device="meta")
    tr = sk.trace(star2, (("arr", 0),))
    called = []
    monkeypatch.setattr(sk, "stencil_reference", lambda *a: called.append(a))
    with pytest.raises(RuntimeError, match="expected cuda"):
        sk.run(star2, tr.lo, tr.hi, (("arr", 0),), [x])
    assert not called and sk.launches == 0
