"""The port's hand kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and skips without one.  This file
imports neither JAX nor ramba_tpu, so it runs where only the port is
installed; on the card, from the repo root (``--noconftest`` skips
``tests/conftest.py``, which sets up JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: integers and bools exact; float64 rtol=atol=1e-12 and float32
rtol=atol=1e-6 (CUDA's math library as the kernels call it and torch's
may differ by ulps);
bfloat16 rtol=1e-2 with atol=1e-2 times the largest |value| (both round
every op to bf16, but CUDA's and torch's transcendental functions may
round to neighbouring bf16 values); float sums within n * eps * sum|x|
(another reduction order); segred's float sums within 2 * depth(n) * eps *
sum|x_g| per group (``segred.depth``: the kernel's rounding depth) and its
products within 10 * sqrt(n_g) * eps relative (a probabilistic bound: a
product's worst case grows with n_g in any order), its min, max, count and
integer results exactly.
"""

import numpy as np
import pytest
import torch

import ramba_tpu_torch as rt
from ramba_tpu_torch import common
from ramba_tpu_torch.core import fuser
from ramba_tpu_torch.models import jacobi
from ramba_tpu_torch.ops import elemred
from ramba_tpu_torch.ops import kernel_backend as kb
from ramba_tpu_torch.ops import segred
from ramba_tpu_torch.ops import stencil_kernel as sk

pytestmark = pytest.mark.cuda

TOL = {torch.float64: 1e-12, torch.float32: 1e-6, torch.bfloat16: 1e-2}
EPS = {torch.float64: 2.0 ** -52, torch.float32: 2.0 ** -23}
N = (1 << 16) + 37  # a ragged tail


@pytest.fixture(autouse=True)
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels run only there")
    common.set_device("cuda:0")


def _close(got, want, what):
    assert got.dtype == want.dtype, f"{what}: {got.dtype} vs {want.dtype}"
    if not got.is_floating_point():
        assert torch.equal(got, want), what
        return
    tol = TOL[got.dtype]
    g, w = got.double(), want.double()
    atol = tol * max(1.0, w.abs().max().item()) if got.dtype == torch.bfloat16 \
        else tol
    torch.testing.assert_close(g, w, rtol=tol, atol=atol, equal_nan=True,
                               msg=what)


def _kernel_vs_plain(outs, what):
    """Launch the elemred kernel on the program of ``outs`` and hold every
    output against the plain version on the same leaves."""
    p, vals = fuser.prepare_program([o.read_expr() for o in outs])
    assert kb.classify(p, vals) == "elemred", what
    before = elemred.launches
    got = elemred.run(p, vals)
    assert elemred.launches == before + 1
    want = elemred.elemred_reference(p, vals)
    # a float reduction of values built from the vector leaves: bound its
    # rounding by n * eps * (sum of |leaf| + n) * 2
    sum_abs = sum(v.double().abs().sum().item() for v in vals
                  if isinstance(v, torch.Tensor) and v.ndim == 1) + N
    for k, (g, w) in enumerate(zip(got, want)):
        if g.ndim == 0 and g.dtype in EPS and not torch.equal(g, w):
            bound = N * EPS[g.dtype] * sum_abs * 2
            assert g.dtype == w.dtype and abs(g.item() - w.item()) <= bound, \
                f"{what} out{k}: {g.item()} vs {w.item()}"
        else:
            _close(g, w, f"{what} out{k}")


def _leaf(lo, hi, dtype, seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    x = torch.rand(N, generator=g, device="cuda", dtype=torch.float64)
    return rt.fromarray((lo + (hi - lo) * x).to(dtype))


UNARY_DOMAIN = {"arccosh": (1.0, 4.0), "arcsin": (-0.95, 0.95),
                "arccos": (-0.95, 0.95), "arctanh": (-0.95, 0.95),
                "log": (0.05, 4.0), "log2": (0.05, 4.0), "log10": (0.05, 4.0),
                "log1p": (-0.5, 4.0), "sqrt": (0.0, 4.0),
                "reciprocal": (0.25, 4.0)}


def _ufuncs(nin):
    return sorted(f for f in kb.ELEM_OK if f in rt.__dict__
                  and isinstance(getattr(np, f, None), np.ufunc)
                  and getattr(np, f).nin == nin)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_every_unary_elem_ok_op(dtype):
    names = _ufuncs(1)
    leaves = {}
    outs = []
    for f in names:
        dom = UNARY_DOMAIN.get(f, (-4.0, 4.0))
        if dom not in leaves:
            leaves[dom] = _leaf(*dom, dtype, len(leaves))
        outs.append(getattr(rt, f)(leaves[dom]))
    _kernel_vs_plain(outs, f"unary ops {names} in {dtype}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_every_binary_elem_ok_op(dtype):
    x = _leaf(-4.0, 4.0, dtype, 1)
    y = _leaf(0.25, 3.0, dtype, 2)
    px = _leaf(0.1, 3.0, dtype, 3)
    outs = [getattr(rt, f)(px if f == "power" else x, y) for f in _ufuncs(2)]
    outs += [rt.where(x > 0.5, x, y), rt.maximum(x, 1.5) * 2 + 1]
    _kernel_vs_plain(outs, f"binary ops in {dtype}")


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_integer_ops_with_zero_divisors(dtype):
    a = rt.fromarray(torch.arange(N, device="cuda", dtype=dtype) % 201 - 100)
    b = rt.fromarray(torch.arange(N, device="cuda", dtype=dtype) % 13 - 6)
    c = a // b + (a % b) * 3 + rt.maximum(a, b) - rt.absolute(b) * rt.sign(a)
    _kernel_vs_plain([c, rt.sum(c), rt.min(c), rt.max(c)], f"ints {dtype}")


# min/max over bool stay on the generic lowering
REDUCTIONS = [(r, d) for d in (torch.float32, torch.float64, torch.int32,
                               torch.int64, torch.bool)
              for r in ("sum", "prod", "min", "max", "mean")
              if not (d == torch.bool and r in ("min", "max"))]


@pytest.mark.parametrize("red,dtype", REDUCTIONS)
def test_reductions(red, dtype):
    src = torch.arange(N, device="cuda") % 7
    x = rt.fromarray((src > 2) if dtype == torch.bool else
                     (src.to(dtype) * 0.5 + 0.75 if dtype.is_floating_point
                      else src.to(dtype) - 3))
    v = x * 1 if dtype == torch.bool else x + 1
    _kernel_vs_plain([getattr(rt, red)(v)], f"{red} {dtype}")


def _elemred_paths():
    return (elemred.launches_bulk, elemred.launches_plain)


def _bytes_equal(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8),
                            b.reshape(-1).view(torch.uint8)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("view", [False, True], ids=["aligned", "view-x[1:]"])
def test_elemred_load_paths(dtype, view):
    """Aligned leaves take the bulk-copy ring, an ``x[1:]`` view (its base
    one element past 16 bytes) plain loads; both against the plain version,
    and each rerun byte-equal."""
    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    xt = torch.rand(N + 1, generator=g, device="cuda", dtype=dtype)
    yt = torch.rand(N + 1, generator=g, device="cuda", dtype=dtype)
    x = rt.fromarray(xt[1:] if view else xt[:N].clone())
    y = rt.fromarray(yt[1:] if view else yt[:N].clone())
    D = rt.sin(x) * rt.cos(y) + x / (y + 0.5)
    p, vals = fuser.prepare_program([D.read_expr(), rt.sum(D).read_expr(),
                                     rt.max(x - y).read_expr()])
    path = "plain" if view else "bulk"
    assert elemred.geometry(p, vals)[0] == path
    before = _elemred_paths()
    got = elemred.run(p, vals)
    again = elemred.run(p, vals)
    moved = [b - a for a, b in zip(before, _elemred_paths())]
    assert moved == [2 * (q == path) for q in elemred.PATHS], moved
    assert all(_bytes_equal(a, b) for a, b in zip(got, again))
    want = elemred.elemred_reference(p, vals)
    _close(got[0], want[0], f"{path} D")
    path_, grid, ept = elemred.geometry(p, vals)
    bound = 2 * elemred.depth(N, grid, ept) * EPS[dtype] * \
        want[0].double().abs().sum().item()
    assert abs(got[1].item() - want[1].item()) <= bound
    assert torch.equal(got[2], want[2])


def test_elemred_bool_int_programs():
    """bool, int32 and int64 leaves in one program, with integer and
    float reductions, against the plain version: integers exactly."""
    g = torch.Generator(device="cuda")
    g.manual_seed(12)
    m = rt.fromarray(torch.rand(N, generator=g, device="cuda") > 0.3)
    i = rt.fromarray(torch.randint(-1000, 1000, (N,), generator=g, device="cuda",
                                   dtype=torch.int32))
    k = rt.fromarray(torch.randint(-(1 << 40), 1 << 40, (N,), generator=g,
                                   device="cuda", dtype=torch.int64))
    c = rt.where(m, i * 3 - 7, k // 5) + (i % 13)
    _kernel_vs_plain([c, rt.sum(c), rt.min(c), rt.max(k), rt.prod(i % 3 + 1),
                      rt.sum(m), rt.mean(i), rt.logical_and(m, i > 0)],
                     "bool/int32/int64")


def test_elemred_device_scalar_leaf():
    """A reduction's result on the card as a scalar operand of the next
    program (a 0-d CUDA tensor leaf, read by the kernel through its
    pointer): x - mean(x)."""
    x = _leaf(-2.0, 3.0, torch.float64, 15)
    m = rt.mean(x)
    m_val = m._value()
    assert m_val.ndim == 0 and m_val.is_cuda
    p, vals = fuser.prepare_program([(x - m).read_expr(), rt.max(x * m).read_expr()])
    plan = elemred.plan_for(p, vals)
    assert "dev" in plan.kinds
    _kernel_vs_plain([x - m, rt.max(x * m)], "x - mean(x)")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_elemred_sincos_equals_sin_and_cos(dtype):
    """One sincos per operand gives the bytes of separate sin and cos,
    over 2^24 values and +-0, +-inf, NaN and |x| >= 2^31 (the slow path)."""
    n = 1 << 24
    g = torch.Generator(device="cuda")
    g.manual_seed(13)
    xt = (torch.rand(n, generator=g, device="cuda", dtype=torch.float64) - 0.5) \
        * 2e4
    special = [0.0, -0.0, float("inf"), -float("inf"), float("nan"), 2.0 ** 31,
               -2.0 ** 31, 3 * 2.0 ** 40, 1e30, -1e30, 1e6, 0.5]
    xt[:len(special)] = torch.tensor(special, dtype=torch.float64)
    x = rt.fromarray(xt.to(dtype))
    B, C = rt.sin(x), rt.cos(x)
    p, vals = fuser.prepare_program([B.read_expr(), C.read_expr(),
                                     (B * B + C * C).read_expr()])
    fused = elemred.plan_for(p, vals)
    apart = elemred.plan_for(p, vals, elemred.CONFIG._replace(sincos=False))
    assert "sincos" in fused.source and "sincos" not in apart.source
    one = elemred.launch(p, vals)
    two = elemred.launch(p, vals, elemred.CONFIG._replace(sincos=False))
    assert all(_bytes_equal(a, b) for a, b in zip(one, two))
    want = elemred.elemred_reference(p, vals)
    for a, w in zip(one, want):
        _close(a, w, "sin/cos vs torch")


def test_elemred_64bit_indexing():
    """A bool sum over n = 2^31 + 17 elements: indices past 2^31."""
    n = (1 << 31) + 17
    t = torch.zeros(n, dtype=torch.bool, device="cuda")
    t[::3] = True
    t[-5:] = True
    x = rt.fromarray(t)
    s = rt.sum(x)
    p, vals = fuser.prepare_program([s.read_expr()])
    assert kb.classify(p, vals) == "elemred"
    before = elemred.launches
    (got,) = elemred.run(p, vals)
    assert elemred.launches == before + 1
    want = int(t.sum().item())
    assert got.dtype == torch.int64 and int(got.item()) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_floor_divide_signed_zeros_on_the_kernels(dtype):
    """-0.0 // 2.0 is 0.0 and -0.0 // -2.0 is -0.0 (ramba_tpu's signs) in
    elemred and in the stencil kernel: sign bits against the plain version
    and against the rule."""
    a = torch.tensor([-0.0, 0.0, 1.5, -1.5, 3.0, -3.0, 0.25, -7.0] * 2,
                     dtype=dtype, device="cuda").repeat(512)
    b = torch.tensor([2.0] * 8 + [-2.0] * 8, dtype=dtype,
                     device="cuda").repeat(512)
    q = rt.fromarray(a) // rt.fromarray(b)
    p, vals = fuser.prepare_program([q.read_expr()])
    (got,) = elemred.run(p, vals)
    (want,) = elemred.elemred_reference(p, vals)
    assert _bytes_equal(got, want)
    zero = got == 0
    assert torch.equal(torch.signbit(got[zero]), torch.signbit(b[zero]))
    assert not torch.signbit(got[1]) and torch.signbit(got[9])  # 0 // -2 is -0

    def zdiv(s):
        return (s[0, 0] * 0.0) // s[0, 1]

    slots = (("arr", 0),)
    tr = sk.trace(zdiv, slots)
    g = torch.Generator(device="cuda")
    g.manual_seed(14)
    arr = torch.randn(64, 96, generator=g, device="cuda").to(dtype)
    assert sk.available(zdiv, tr.lo, tr.hi, slots, [arr])
    out = sk.run(zdiv, tr.lo, tr.hi, slots, [arr])
    ref = sk.stencil_reference(zdiv, tr.lo, tr.hi, slots, [arr])
    assert _bytes_equal(out, ref)
    inner = out[:, :-1]
    assert torch.equal(torch.signbit(inner), torch.signbit(arr[:, 1:]))


def star2(a):
    return (0.25 * (a[0, 1] + a[0, -1] + a[1, 0] + a[-1, 0])
            + 0.125 * (a[0, 2] + a[0, -2] + a[2, 0] + a[-2, 0]))


def pick(a):
    v = a[0, 1]
    if v > 0:
        return v
    return a[0, -1]


def npk(a):
    return (np.maximum(a[0, -1], a[0, 1])
            + np.where(a[1, 0] > a[-1, 0], np.sqrt(np.abs(a[0, 0])), 0.5)
            + np.floor_divide(a[0, 0], 0.3) + np.mod(a[1, 1], 0.7))


def ints(a):
    k = ((a[0, 1] > 0) + 2) // 3 + ((a[0, -1] < 0) * 5) % 4
    return np.where(k > 1, a[0, 0], 0.5 * a[0, 1]) + np.sign(a[1, 1])


def mix(a, b):
    return a[0, 0] + 0.5 * (b[-1, 0] + b[1, 0])


def shifted(a):
    return a[-3, 0] + a[0, 5]


BODIES = [("star2", star2, 1), ("pick", pick, 1), ("npk", npk, 1),
          ("ints", ints, 1), ("mix", mix, 2), ("shifted", shifted, 1),
          ("sweep", jacobi._kernels()["sweep"].func, 2),
          ("lap", jacobi._kernels()["lap"].func, 1)]


# floor_divide of bf16-rounded values jumps where the float32 ones do not
STENCIL_CASES = [(*b, d) for b in BODIES
                 for d in (torch.float32, torch.float64, torch.bfloat16)
                 if not (b[0] == "npk" and d == torch.bfloat16)]


@pytest.mark.parametrize("name,body,n_slots,dtype", STENCIL_CASES,
                         ids=[f"{c[0]}-{c[3]}" for c in STENCIL_CASES])
def test_stencil_bodies(name, body, n_slots, dtype):
    slots = tuple(("arr", k) for k in range(n_slots))
    tr = sk.trace(body, slots)
    g = torch.Generator(device="cuda")
    g.manual_seed(n_slots)
    arrs = [torch.randn(257, 300, generator=g, device="cuda").to(dtype)
            for _ in range(n_slots)]
    assert sk.available(body, tr.lo, tr.hi, slots, arrs), name
    before = sk.launches
    got = sk.run(body, tr.lo, tr.hi, slots, arrs)
    assert sk.launches == before + 1
    _close(got, sk.stencil_reference(body, tr.lo, tr.hi, slots, arrs), name)


def _cells(shape, dtype, seed, offset=0):
    """Random cells of ``shape``; with ``offset`` > 0, a contiguous view
    that many elements into its storage."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    n = shape[0] * shape[1]
    flat = torch.rand(n + offset, generator=g, device="cuda").to(dtype)
    return flat[offset:].view(*shape)


_SWEEP = jacobi._kernels()["sweep"].func

# (id, body, slots, shape, dtype, offset in elements, the load path it takes)
PATH_CASES = [
    ("aligned-8192x256-f32", star2, 1, (8192, 256), torch.float32, 0, "tma"),
    ("odd-width-4099x4133-f32", star2, 1, (4099, 4133), torch.float32, 0,
     "cpasync"),
    ("view-at-4-bytes-f32", star2, 1, (512, 256), torch.float32, 1, "cpasync"),
    ("aligned-bf16", star2, 1, (512, 256), torch.bfloat16, 0, "tma"),
    ("even-width-bf16", star2, 1, (256, 300), torch.bfloat16, 0, "cpasync"),
    ("odd-width-bf16", star2, 1, (257, 301), torch.bfloat16, 0, "ldst"),
    ("view-at-2-bytes-bf16", star2, 1, (512, 256), torch.bfloat16, 1, "ldst"),
    ("f64-2-slots", _SWEEP, 2, (1024, 1024), torch.float64, 0, "tma"),
    ("f64-2-slots-odd-width", _SWEEP, 2, (513, 517), torch.float64, 0,
     "cpasync"),
    ("smaller-than-the-halo-f32", star2, 1, (3, 3), torch.float32, 0,
     "cpasync"),
]


def _paths():
    return (sk.launches_tma, sk.launches_cpasync, sk.launches_ldst)


@pytest.mark.parametrize("name,body,n_slots,shape,dtype,offset,path",
                         PATH_CASES, ids=[c[0] for c in PATH_CASES])
def test_stencil_load_paths(name, body, n_slots, shape, dtype, offset, path):
    """Each load path against the plain version, byte for byte (the bodies
    add and multiply in the same order in both), and its counter."""
    slots = tuple(("arr", k) for k in range(n_slots))
    tr = sk.trace(body, slots)
    arrs = [_cells(shape, dtype, k, offset) for k in range(n_slots)]
    assert all(a.is_contiguous() for a in arrs)
    assert sk.available(body, tr.lo, tr.hi, slots, arrs), name
    before = _paths()
    got = sk.run(body, tr.lo, tr.hi, slots, arrs)
    moved = [b - a for a, b in zip(before, _paths())]
    assert moved == [int(p == path) for p in sk.PATHS], (name, moved)
    if min(shape) > tr.hi[0] - tr.lo[0] and min(shape) > tr.hi[1] - tr.lo[1]:
        want = sk.stencil_reference(body, tr.lo, tr.hi, slots, arrs)
    else:
        want = torch.zeros_like(arrs[0])  # every cell is a border cell
    assert got.dtype == want.dtype
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8)), name
    assert sk.ctas_per_sm(body, tr.lo, tr.hi, slots, arrs, path) >= 1


def test_sstencil_iterate_matches_chained():
    x = rt.fromarray(torch.rand(300, 257, device="cuda"))
    st = rt.stencil(star2)
    before, cpasync = sk.launches, sk.launches_cpasync
    it = rt.sstencil_iterate(st, x, 7)._value()
    # a row of 257 float32 is not a multiple of 16 bytes: cp.async
    assert sk.launches == before + 7 and sk.launches_cpasync == cpasync + 7
    y = x
    for _ in range(7):
        y = rt.sstencil(st, y)
    _close(it, y._value(), "iterate vs chained")


def test_main_path_launches_the_kernels():
    n = 1 << 20
    base = rt.arange(n) / 1000.0
    rt.sync()
    e0, s0 = elemred.launches, sk.launches
    D = rt.sin(base) * rt.sin(base) + rt.cos(base) * rt.cos(base)
    assert abs(float(rt.sum(D)) - n) <= n * EPS[torch.float64] * n
    assert elemred.launches == e0 + 1
    u = jacobi.jacobi2d(np.random.RandomState(0).rand(64, 64), 10)
    rt.sync()
    assert sk.launches == s0 + 10 and u.dtype == np.float64


SEG_CASES = [(k, d) for d in (torch.float32, torch.float64, torch.int32,
                              torch.int64, torch.bool)
             for k in ("sum", "prod", "min", "max", "count")
             if not (d == torch.bool and k in ("min", "max"))]


@pytest.mark.parametrize("kind,dtype", SEG_CASES,
                         ids=[f"{k}-{d}" for k, d in SEG_CASES])
def test_segred_kernel(kind, dtype):
    G = 24
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    labels = torch.randint(-1, G + 1, (N,), generator=g, device="cuda",
                           dtype=torch.int32)
    if dtype == torch.bool:
        x = torch.rand(N, generator=g, device="cuda") > 0.5
    elif dtype.is_floating_point:
        x = torch.rand(N, generator=g, device="cuda", dtype=dtype) + 0.5
        if kind == "prod":
            x = 1.0 + (x - 1.0) * 1e-3
        if kind in ("min", "max"):
            x[::4099] = float("nan")
    else:
        x = torch.randint(-50, 50, (N,), generator=g, device="cuda", dtype=dtype)
    grp = rt.fromarray(x).groupby(0, labels.cpu().numpy(), G)
    p, vals = fuser.prepare_program([getattr(grp, kind)().read_expr()])
    assert kb.classify(p, vals) == "segred"
    before = segred.launches
    (got,) = segred.run(p, vals)
    (again,) = segred.run(p, vals)
    assert segred.launches == before + 2
    assert torch.equal(got.view(torch.uint8), again.view(torch.uint8))
    (want,) = segred.segred_reference(p, vals)
    assert got.dtype == want.dtype
    if got.is_floating_point() and kind in ("sum", "prod"):
        err = (got.double() - want.double()).abs()
        if kind == "sum":
            # the kernel's rounding depth D bounds its order's error by
            # D * eps/2 * sum|x_g|; 2 * D * eps leaves the plain order 3D
            scale = torch.stack([x.double().abs()[labels == k].sum()
                                 for k in range(G)])
            bound = 2 * segred.depth(N) * EPS[got.dtype] * scale
        else:
            # each order within 10 * sqrt(n_g) * eps/2 relative, but with
            # probability below 1e-21 (Higham and Mary 2019, Thm. 2.4)
            n_g = torch.stack([(labels == k).sum() for k in range(G)])
            bound = 10 * n_g.double().sqrt() * EPS[got.dtype] * want.double().abs()
        assert (err <= bound).all(), kind
    else:
        same = got == want
        if got.is_floating_point():
            same |= got.isnan() & want.isnan()  # a NaN wins in min and max
        assert bool(same.all()), kind


def test_groupby_user_path_launches_segred():
    n = (1 << 20) + 5
    x = rt.fromarray(torch.rand(n, device="cuda", dtype=torch.float64))
    g = x.groupby(0, np.arange(n) % 24, 24)
    before = segred.launches
    s = g.sum().asarray()
    assert segred.launches == before + 1
    m = g.mean().asarray()  # the generic lowering
    assert segred.launches == before + 1
    np.testing.assert_allclose(m, s / np.bincount(np.arange(n) % 24), rtol=1e-12)


@pytest.mark.parametrize("dtype", ["uint16", "uint32", "uint64"])
def test_unsigned_chain_on_card(dtype):
    """The generic lowering's int64 carrier, on CUDA tensors, against
    NumPy's unsigned arithmetic."""
    rs = np.random.RandomState(3)
    mx = np.iinfo(dtype).max
    a_np = rs.randint(0, mx, 4096, dtype=np.uint64).astype(dtype)
    b_np = rs.randint(0, 40, 4096).astype(dtype)
    a, b = rt.fromarray(a_np), rt.fromarray(b_np)
    outs = [a * 3 + b, a - b, a // b, a % b, a >> (b % 8), rt.maximum(a, b),
            a < b, rt.sum(a), rt.max(a)]
    with np.errstate(all="ignore"):
        q = np.where(b_np == 0, mx, a_np // np.where(b_np == 0, 1, b_np))
        want = [a_np * np.array(3, dtype) + b_np, a_np - b_np, q.astype(dtype),
                np.where(b_np == 0, 0, a_np % np.where(b_np == 0, 1, b_np)).astype(dtype),
                a_np >> (b_np % np.array(8, dtype)), np.maximum(a_np, b_np),
                a_np < b_np, a_np.sum(dtype=np.uint64), a_np.max()]
    for k, (o, w) in enumerate(zip(outs, want)):
        got = np.asarray(o)
        assert got.dtype == np.asarray(w).dtype, (k, got.dtype)
        np.testing.assert_array_equal(got, w, err_msg=str(k))


# --- skeletons and the new reductions: the card against the CPU ---------------
# The same call on CUDA tensors and on CPU tensors.  Exact where both run
# the same ops in the same order (the sreduce tree, the scans, the spmd
# update, integer and arg results); float64 rtol=atol=1e-12 and float32
# rtol=atol=1e-6 where CUDA's and the CPU's math or reduction order differ
# (transcendentals, torch.sum inside var/mean).


def _f1(a, b, c, d):
    return a * d + b - c[5]


SKELETON_CASES = {
    "smap_f1": lambda m, x, y: m.smap(_f1, x, y, np.arange(20), 7),
    "smap_branch": lambda m, x, y: m.smap(
        lambda v: v * v if v > 0 else -v, x),
    "smap_np_sin": lambda m, x, y: m.smap(lambda v: np.sin(v), x),
    "smap_index_2d": lambda m, x, y: m.smap_index(
        lambda i, v: v + i[0] * 10 + i[1], x.reshape(64, -1)),
    "fromfunction": lambda m, x, y: m.fromfunction(
        lambda i, j: i * 3 - j if i > j else j * 0.5, (37, 41)),
    "sreduce_docs": lambda m, x, y: m.sreduce(
        lambda v: v / 100, lambda p, q: p + q, 0, abs(x)),
    "sreduce_max": lambda m, x, y: m.sreduce(
        lambda v: v, lambda p, q: np.maximum(p, q), -np.inf, x),
    "sreduce_split": lambda m, x, y: m.sreduce(
        lambda v: v, m.SreduceReducer(lambda p, q: p + q, lambda p, q: p + q),
        0.0, x),
    "scan_assoc": lambda m, x, y: m.scumulative(
        lambda v, c: v + c, lambda c, b: b + c, x),
    "scan_int64": lambda m, x, y: m.scumulative(
        lambda v, c: v + c, lambda c, b: b + c, (x * 8).astype(np.int64)),
    "scan_ema_2d": lambda m, x, y: m.scumulative(
        lambda v, c: 0.1 * v + 0.9 * c, lambda c, b: b,
        y.reshape(64, -1), 0),
    "var_std": lambda m, x, y: m.std(x.reshape(64, -1), axis=1, ddof=1),
    "argmax_nanargmin": lambda m, x, y: m.argmax(x) * 1000 + m.nanargmin(y),
    "median": lambda m, x, y: m.median(x.reshape(64, -1), axis=0),
    "cumsum": lambda m, x, y: m.cumsum(x),
}


def _on(dev, case, x_np, y_np):
    common.set_device(dev)
    try:
        r = SKELETON_CASES[case](rt, rt.fromarray(x_np), rt.fromarray(y_np))
        return r._value()
    finally:
        common.set_device("cuda:0")


@pytest.mark.parametrize("case", sorted(SKELETON_CASES))
def test_skeleton_card_vs_cpu(case):
    from ramba_tpu_torch import skeletons as skl

    rs = np.random.RandomState(8)
    x_np = rs.randn(64 * 48)
    y_np = rs.rand(64 * 48).astype(np.float32)
    fb = skl.counters["skeletons.host_fallback"]
    got = _on("cuda:0", case, x_np, y_np)
    want = _on("cpu", case, x_np, y_np)
    assert got.device.type == "cuda" and want.device.type == "cpu"
    assert skl.counters["skeletons.host_fallback"] == fb
    _close(got.cpu(), want, case)


def test_spmd_halo_card_vs_cpu():
    x_np = np.random.RandomState(9).rand(96, 80).astype(np.float32)

    def five_point(lv):
        h = lv.halo(1)
        lv.set_local(h[:-2, 1:-1] + h[2:, 1:-1] + h[1:-1, :-2] + h[1:-1, 2:]
                     - 4.0 * h[1:-1, 1:-1])

    outs = []
    for dev in ("cuda:0", "cpu"):
        common.set_device(dev)
        try:
            a = rt.fromarray(x_np)
            rt.spmd(five_point, a)
            rt.barrier()
            outs.append(a._value())
        finally:
            common.set_device("cuda:0")
    assert torch.equal(outs[0].cpu(), outs[1])


def test_smap_sum_takes_one_elemred_launch():
    x = rt.fromarray(torch.rand(1 << 20, device="cuda", dtype=torch.float64))
    r = rt.smap(lambda v: np.sin(v) * 2.0, x)
    before = elemred.launches
    rt.sync()
    assert elemred.launches == before  # the smap itself: generic lowering
    s = rt.sum(r)
    v = float(s)
    assert elemred.launches == before + 1
    t = r._value()
    assert abs(v - float(t.sum())) <= 2 * (1 << 20) * EPS[torch.float64] * \
        float(t.abs().sum())


def test_host_fallback_on_card():
    import warnings

    from ramba_tpu_torch import skeletons as skl

    n0 = skl.counters["skeletons.host_fallback"]
    x = rt.fromarray(torch.arange(1024, device="cuda", dtype=torch.float64))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = rt.smap(lambda v: float(v) * 0.5, x)._value()
    assert skl.counters["skeletons.host_fallback"] == n0 + 1
    assert got.device.type == "cuda"
    assert torch.equal(got, torch.arange(1024, device="cuda",
                                         dtype=torch.float64) * 0.5)


# -- indexing, casts, sign, sort, matmul and the scan on the card ------------


def test_gather_out_of_range_clamps_without_a_device_assert():
    x_t = torch.arange(1000, dtype=torch.float64, device="cuda")
    idx = torch.tensor([1, 1000, -1001, -1, 5000, -3, -10 ** 12],
                       device="cuda")
    got = rt.fromarray(x_t)[rt.fromarray(idx)]._value()
    torch.cuda.synchronize()  # a device assert would surface here
    want = torch.tensor([1, 999, 0, 999, 999, 997, 0], dtype=torch.float64,
                        device="cuda")
    assert torch.equal(got, want)
    X = rt.fromarray(torch.arange(20.0, device="cuda").reshape(4, 5))
    got = X[[1, -9, 7], 1:4]._value()
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), torch.arange(20.0).reshape(4, 5)[[1, 0, 3], 1:4])


def test_scatter_out_of_range_is_dropped_without_a_device_assert():
    b = rt.fromarray(torch.zeros(10, dtype=torch.float64, device="cuda"))
    b[rt.fromarray(torch.tensor([1, 12, -1, -11], device="cuda"))] = \
        rt.fromarray(torch.tensor([5.0, 6.0, 7.0, 8.0], device="cuda",
                                  dtype=torch.float64))
    got = b._value()
    torch.cuda.synchronize()
    want = torch.zeros(10, dtype=torch.float64)
    want[1], want[9] = 5.0, 7.0
    assert torch.equal(got.cpu(), want)


def test_duplicate_scatter_holds_one_written_value():
    """torch's CUDA index_put_ and XLA's scatter both leave the winner of
    a duplicated index unspecified: each slot holds one written value."""
    n = 1 << 16
    idx = torch.arange(n, device="cuda") % 97
    vals = torch.arange(n, device="cuda", dtype=torch.float64)
    x = rt.fromarray(torch.full((128,), -1.0, device="cuda",
                                dtype=torch.float64))
    x[rt.fromarray(idx)] = rt.fromarray(vals)
    got = x._value().cpu()
    for k in range(97):
        assert int(got[k]) % 97 == k  # a value written to slot k
    assert bool((got[97:] == -1.0).all())


def test_masked_writes_on_the_card():
    a_t = torch.randn(N, device="cuda", dtype=torch.float64)
    a = rt.fromarray(a_t.clone())
    a[a > 0] += 1.0
    a[a < 0] = 0
    want = torch.where(a_t > 0, a_t + 1.0, a_t).clamp_min(0)
    assert torch.equal(a._value(), want)
    m = a[a > 1.5]
    assert float(m.count()) == float((want > 1.5).sum())
    torch.testing.assert_close(m.sum()._value(), want[want > 1.5].sum(),
                               rtol=1e-12, atol=1e-12)


CAST_VALUES = [128.5, -129.5, float("nan"), float("inf"), float("-inf"), 1e30,
               -1e30, 2.0 ** 63, -2.0 ** 63, 2.0 ** 31, -1.7, -0.5, 3e9]


@pytest.mark.parametrize("src", [torch.float32, torch.float64])
def test_saturating_casts_elemred_and_generic(src):
    from ramba_tpu_torch.core import expr as E

    vals = torch.tensor(CAST_VALUES, dtype=torch.float64).to(src)
    xc = vals.repeat(4096).cuda()
    x = rt.fromarray(xc)
    for dst in ("int32", "int64"):
        p, lv = fuser.prepare_program([x.astype(dst).read_expr()])
        assert kb.classify(p, lv) == "elemred"
        (got,) = elemred.run(p, lv)
        want = E.convert(xc.cpu(), getattr(torch, dst))
        assert torch.equal(got.cpu(), want), dst
    for dst in (torch.int8, torch.uint8, torch.int16, torch.int32,
                torch.int64, torch.uint16, torch.uint32, torch.uint64):
        assert torch.equal(E.convert(xc, dst).cpu(),
                           E.convert(xc.cpu(), dst)), dst
    assert int(E.convert(torch.tensor([128.5], device="cuda"),
                         torch.int8).item()) == 127


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sign_keeps_signed_zeros_on_elemred(dtype):
    v = torch.tensor([-0.0, 0.0, -2.5, 3.0, float("nan"), float("-inf")],
                     dtype=dtype, device="cuda").repeat(2048)
    p, lv = fuser.prepare_program([rt.sign(rt.fromarray(v)).read_expr()])
    (got,) = elemred.run(p, lv)
    (want,) = elemred.elemred_reference(p, lv)
    assert _bytes_equal(got, want)
    zero = v == 0
    assert torch.equal(torch.signbit(got[zero]), torch.signbit(v[zero]))


def test_sort_on_the_card_nans_last_zeros_in_order():
    x = torch.tensor([3.0, float("nan"), -0.0, 0.0, 1.0, -float("nan"), -0.0,
                      float("-inf"), 0.0, -2.0], dtype=torch.float64)
    big = x.repeat(5000)
    got = rt.sort(rt.fromarray(big.cuda()))._value().cpu()
    order = rt.argsort(rt.fromarray(big.cuda()))._value().cpu()
    common.set_device("cpu")
    try:
        want = rt.sort(rt.fromarray(big))._value()
    finally:
        common.set_device("cuda:0")
    assert torch.equal(got.view(torch.int64)[~torch.isnan(got)],
                       want.view(torch.int64)[~torch.isnan(want)])
    k = int(torch.isnan(big).sum())
    assert bool(torch.isnan(got[-k:]).all())
    zeros = got[got == 0]
    assert torch.equal(torch.signbit(zeros), torch.signbit(big[big == 0]))
    assert torch.equal(order, torch.sort(torch.where(torch.isnan(big),
                                                     float("nan"), big),
                                         stable=True).indices)
    # uint64 values 2**63 + 5, 3, 2**64 - 1, 0 by their bit patterns
    u = torch.tensor([-2 ** 63 + 5, 3, -1, 0]).view(torch.uint64)
    got = rt.sort(rt.fromarray(u.cuda()))._value().cpu()
    assert got.view(torch.int64).tolist() == [0, 3, -2 ** 63 + 5, -1]


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32, torch.int8,
                                   torch.bool])
def test_integer_matmul_exact_on_the_card(dtype):
    g = torch.Generator().manual_seed(8)
    if dtype == torch.bool:
        a, b = torch.rand(70, 90, generator=g) > 0.5, torch.rand(90, 30, generator=g) > 0.5
    else:
        hi = 100 if dtype == torch.int8 else 1 << 30
        a = torch.randint(-hi, hi, (70, 90), generator=g).to(dtype)
        b = torch.randint(-hi, hi, (90, 30), generator=g).to(dtype)
    got = (rt.fromarray(a.cuda()) @ rt.fromarray(b.cuda()))._value().cpu()
    common.set_device("cpu")
    try:
        want = (rt.fromarray(a) @ rt.fromarray(b))._value()
    finally:
        common.set_device("cuda:0")
    assert torch.equal(got, want)


def test_float32_matmul_keeps_tf32_off():
    g = torch.Generator(device="cuda")
    g.manual_seed(9)
    a = torch.randn(512, 1024, generator=g, device="cuda")
    b = torch.randn(1024, 256, generator=g, device="cuda")
    got = (rt.fromarray(a) @ rt.fromarray(b))._value()
    ref = a.double() @ b.double()
    bound = 1024 * 2.0 ** -23 * (a.double().abs() @ b.double().abs())
    assert bool(((got.double() - ref).abs() <= bound).all())
    assert torch.backends.cuda.matmul.allow_tf32 is False


SCAN_DTYPES = [torch.float16, torch.bfloat16, torch.float32, torch.float64]


def _scan_on_every_grid(scan, x, name, axis):
    """The kernel on one CTA, on 7, and twice on the default grid: each a
    launch, all the same bytes (the order does not depend on the grid and
    a tile only waits on tiles taken before it); returns the last."""
    before = scan.launches
    outs = [scan.run(x, name, axis)] + [scan.launch(x, name, axis, ctas)
                                        for ctas in (1, 7, None)]
    assert scan.launches == before + 4
    torch.cuda.synchronize()
    for o in outs[:-1]:
        assert _bytes_equal(o, outs[-1]), (name, x.dtype, axis)
    return outs[-1]


@pytest.mark.parametrize("dtype", SCAN_DTYPES)
@pytest.mark.parametrize("name", ["cumsum", "cumprod"])
def test_scan_kernel_equals_its_plain_version(name, dtype):
    """The kernel and its plain version run the same order: the same
    bytes; and launches on grids 1, 7 and the default give the same
    bytes."""
    from ramba_tpu_torch.ops import scan

    g = torch.Generator(device="cuda")
    g.manual_seed(10)
    x = (1 + 0.01 * torch.randn(5, 3 * scan.TILE + 37, generator=g,
                                device="cuda", dtype=torch.float64)).to(dtype)
    for axis in (0, 1):
        got = _scan_on_every_grid(scan, x, name, axis)
        want = scan.scan_reference(x, name, axis)
        torch.cuda.synchronize()
        assert _bytes_equal(got, want), (name, dtype, axis)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scan_kernel_across_checkpoints(dtype):
    """Two rows of (2K + 3) tiles and a ragged tail: each row's checkpoint
    chain, on every grid, gives the plain version's bytes, within
    2 * depth * eps * cumsum|x| of the float64 scan."""
    from ramba_tpu_torch.ops import scan

    g = torch.Generator(device="cuda")
    g.manual_seed(12)
    n = (2 * scan.K + 3) * scan.TILE + 11
    x = torch.randn(2, n, generator=g, device="cuda", dtype=dtype)
    got = _scan_on_every_grid(scan, x, "cumsum", 1)
    assert _bytes_equal(got, scan.scan_reference(x, "cumsum", 1))
    bound = 2 * scan.depth(n) * EPS[dtype] * torch.cumsum(x.double().abs(), 1)
    assert bool(((got.double() - torch.cumsum(x.double(), 1)).abs()
                 <= bound).all())


def test_rt_cumsum_runs_the_scan_kernel_reproducibly():
    from ramba_tpu_torch.ops import scan

    n = (1 << 22) + 13
    x_t = torch.randn(n, device="cuda", dtype=torch.float64)
    x = rt.fromarray(x_t)
    before = scan.launches
    a = rt.cumsum(x)._value()
    b = x.cumsum()._value()
    assert scan.launches == before + 2
    assert _bytes_equal(a, b)
    assert _bytes_equal(a, scan.scan_reference(x_t, "cumsum", 0))


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16, torch.uint32,
                                   torch.uint64, torch.int8, torch.bool,
                                   torch.float16])
def test_data_movement_of_small_and_unsigned_dtypes(dtype):
    """The indexing, masked, join, pad, triangle, sort and take ops on the
    card against the same program on the CPU, bit for bit (torch has no
    select, flip or index_put of uint16/32/64 on the card: the ops move
    their bits through a signed view)."""
    g = torch.Generator().manual_seed(11)
    if dtype == torch.bool:
        x = torch.rand(6, 7, generator=g) > 0.5
    elif dtype.is_floating_point:
        x = (torch.randn(6, 7, generator=g) * 10).to(dtype)
    else:
        x = torch.randint(0, 120, (6, 7), generator=g).to(dtype)
    mask = torch.rand(6, 7, generator=g) > 0.5

    def program(dev):
        a = rt.fromarray(x.to(dev))
        b = rt.fromarray(x.to(dev))
        b[[1, -1, 9]] = a[[0, 2, 3]]
        b[rt.fromarray(mask.to(dev))] = a[0, 0]
        outs = [a[[2, -1, 40], 1:], a.take(np.array([1, 50, -2]), mode="fill"),
                rt.concatenate([a, b]), rt.flip(a, 0), rt.pad(a, 1),
                rt.tril(a), rt.sort(a, axis=None), rt.argsort(a, axis=1),
                rt.stack([a, b]), b]
        return [o._value().cpu() for o in outs]

    common.set_device("cpu")
    try:
        want = program("cpu")
    finally:
        common.set_device("cuda:0")
    got = program("cuda")
    for k, (g_, w) in enumerate(zip(got, want)):
        assert g_.dtype == w.dtype and g_.shape == w.shape, k
        assert _bytes_equal(g_, w), (dtype, k)
