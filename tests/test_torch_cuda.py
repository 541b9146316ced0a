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


# -- the complex repairs, bincount, convolve and the rewrite into segred ----


def _complex_grid(dtype):
    parts = [0.0, -0.0, 1.5, -2.25, float("inf"), float("-inf"),
             float("nan")]
    re = torch.tensor(parts, dtype=torch.float64).repeat_interleave(7)
    im = torch.tensor(parts, dtype=torch.float64).repeat(7)
    return torch.complex(re, im).to(dtype)


def _on_device(dev, fn):
    common.set_device(dev)
    try:
        return fn(dev)
    finally:
        common.set_device("cuda:0")


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_complex_repairs_on_the_card(dtype):
    """The complex ops the port repaired, on the card against the same
    program on the CPU (torch's CUDA kernels refuse complex ordering as the
    CPU ones do): ordering, sort, min/max and nan-reductions bit for bit,
    the formulas (sign, angle, var) within float tolerance."""
    z = _complex_grid(dtype)
    w = z[torch.randperm(z.numel(), generator=torch.Generator()
                         .manual_seed(3))]
    c = torch.randn(64, dtype=dtype, generator=torch.Generator().manual_seed(4))

    def program(dev):
        a, b = rt.fromarray(z.to(dev)), rt.fromarray(w.to(dev))
        exact = [rt.imag(a), rt.real(a), rt.less(a, b), rt.greater_equal(a, b),
                 rt.maximum(a, b), rt.fmin(a, b), rt.sort(a), rt.argsort(b),
                 rt.max(a.reshape(7, 7), axis=1), rt.min(b.reshape(7, 7),
                                                         axis=0),
                 rt.rint(a), rt.nansum(b), rt.ptp(b.reshape(7, 7), axis=1)]
        approx = [rt.sign(a), rt.angle(a), rt.var(rt.fromarray(c.to(dev))),
                  rt.std(rt.fromarray(c.to(dev)).reshape(8, 8), axis=0),
                  rt.power(a, b)]
        return ([o._value().cpu() for o in exact],
                [o._value().cpu() for o in approx])

    want_e, want_a = _on_device("cpu", program)
    got_e, got_a = program("cuda")
    for k, (g, w_) in enumerate(zip(got_e, want_e)):
        assert g.dtype == w_.dtype and g.shape == w_.shape, k
        if g.is_complex():
            g, w_ = torch.view_as_real(g), torch.view_as_real(w_)
        # the same values, NaN where NaN (payloads may differ), signed zeros
        torch.testing.assert_close(g, w_, rtol=0, atol=0, equal_nan=True,
                                   msg=f"exact {k}")
        if g.is_floating_point():
            z_ = (g == 0) & (w_ == 0)
            assert torch.equal(torch.signbit(g[z_]), torch.signbit(w_[z_])), k
    tol = 1e-12 if dtype == torch.complex128 else 1e-5
    for k, (g, w_) in enumerate(zip(got_a, want_a)):
        torch.testing.assert_close(g, w_, rtol=tol, atol=tol, equal_nan=True,
                                   msg=f"approx {k}")


def test_weighted_bincount_reruns_byte_equal():
    """The weighted bincount sums in a fixed order (a stable sort by label,
    then one sum per label): two runs give the same bytes, and they lie
    within n * eps * sum|w| of the float64 sums."""
    g = torch.Generator(device="cuda").manual_seed(5)
    n = 1 << 20
    x = torch.randint(0, 4096, (n,), generator=g, device="cuda")
    w = torch.rand(n, generator=g, device="cuda", dtype=torch.float64)
    a = rt.bincount(rt.fromarray(x), weights=rt.fromarray(w))._value()
    b = rt.bincount(rt.fromarray(x), weights=rt.fromarray(w))._value()
    assert _bytes_equal(a, b)
    want = torch.zeros(4096, dtype=torch.float64, device="cuda")
    want.index_add_(0, x, w)
    assert (a - want).abs().max().item() <= n * EPS[torch.float64] * \
        w.abs().sum().item()


def test_convolve_float32_keeps_tf32_off():
    """convolve of float32 on conv1d with cuDNN's TF32 off: within float32
    rounding of the float64 result (TF32's 10-bit mantissa would be
    ~1e-3 off), and the global flag is restored."""
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(1 << 16, generator=g, device="cuda")
    v = torch.randn(255, generator=g, device="cuda")
    torch.backends.cudnn.allow_tf32 = True
    got = rt.convolve(rt.fromarray(x), rt.fromarray(v))._value()
    assert torch.backends.cudnn.allow_tf32 is True
    want = rt.convolve(rt.fromarray(x.double()), rt.fromarray(v.double()))
    want = want._value()
    bound = 255 * EPS[torch.float32] * (x.abs().max() * v.abs().sum()).item()
    assert got.dtype == torch.float32
    assert (got.double() - want).abs().max().item() <= bound


def test_stack_of_group_sums_reaches_segred():
    """The xarray idiom stack([x[idx_g].sum() ...]) over 1-D data: the
    rewrite turns it into one segment_reduce, and segred launches it."""
    from ramba_tpu_torch.core import rewrite

    n, G = 1 << 20, 24
    x_t = torch.rand(n, dtype=torch.float64, device="cuda")
    x = rt.fromarray(x_t)
    hour = np.arange(n) % G
    idx = [np.where(hour == k)[0] for k in range(G)]
    before, fires = segred.launches, \
        rewrite.stats["rewrite_stack_reduce_advindex"]
    s = rt.stack([x[i].sum() for i in idx])._value()
    assert segred.launches == before + 1
    assert rewrite.stats["rewrite_stack_reduce_advindex"] == fires + 1
    assert rewrite.stats["errors"] == 0
    want = torch.stack([x_t[torch.from_numpy(i).cuda()].sum() for i in idx])
    bound = 2 * segred.depth(n) * EPS[torch.float64] * x_t.abs().sum().item()
    assert (s - want).abs().max().item() <= bound


@pytest.mark.parametrize("dtype", [np.float16, np.float32, np.float64])
def test_spacing_on_the_card_equals_the_cpu(dtype):
    """``spacing`` stays on the generic lowering: NaN where the plain
    version on the CPU gives NaN (inf - inf gives each device's own NaN
    pattern), its bits elsewhere, signed zeros included."""
    vals = np.array([0.0, -0.0, 1.0, -1.0, 1e-40, -1e-40, 6e-8, 3.0e38,
                     np.inf, -np.inf, np.nan, 65504.0, 2.5]).astype(dtype)
    from ramba_tpu_torch.core.expr import UNARY

    got = rt.spacing(rt.fromarray(vals)).asarray()
    ref = UNARY["spacing"](torch.from_numpy(vals)).numpy()
    assert got.dtype == ref.dtype
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan)
    ibits = {2: np.int16, 4: np.int32, 8: np.int64}[ref.itemsize]
    np.testing.assert_array_equal(got.view(ibits)[~nan], ref.view(ibits)[~nan])


def test_draws_land_on_the_card_and_rerun_byte_equal():
    from ramba_tpu_torch.core import fuser

    rt.random.seed(3)
    draws = [rt.random.random(1 << 20), rt.random.normal(size=(512, 256)),
             rt.random.randint(0, 7, size=4096),
             rt.random.exponential(size=999), rt.random.poisson(2.0, 500),
             rt.random.permutation(1 << 16), rt.random.gamma(2.0, size=77),
             rt.random.beta(2.0, 3.0, size=77),
             rt.random.binomial(9, 0.4, size=77),
             rt.random.choice(100, size=50, replace=False),
             rt.random.choice(4, size=500, p=[0.1, 0.2, 0.3, 0.4])]
    for x in draws:
        expr = x.read_expr()
        v1, v2 = fuser.evaluate(expr), fuser.evaluate(expr)
        assert v1.device.type == "cuda"
        assert torch.equal(v1.reshape(-1).view(torch.uint8),
                           v2.reshape(-1).view(torch.uint8))
    perm = draws[5]._value()
    assert torch.equal(torch.sort(perm).values,
                       torch.arange(1 << 16, device="cuda"))
    c0 = rt.fuser_stats["compiles"]
    for s in range(10):
        rt.random.seed(s)
        rt.random.random(1 << 20)._value()
    assert rt.fuser_stats["compiles"] - c0 <= 1


@pytest.mark.parametrize("ext", ["npy", "rtd"])
def test_io_round_trip_from_the_card_keeps_the_chunk_bound(tmp_path, ext,
                                                           monkeypatch):
    from ramba_tpu_torch import fileio
    from ramba_tpu_torch.core import staging

    monkeypatch.setattr(staging, "CHUNK_BYTES", 1 << 20)
    x = rt.random.random((1000, 700))  # 5.6 MB: six chunks
    p = str(tmp_path / f"a.{ext}")
    fileio.io_stats.update(chunks=0, max_chunk_bytes=0, whole_array_reads=0)
    rt.save(p, x)
    back = rt.load(p)
    assert back._value().device.type == "cuda"
    assert torch.equal(back._value(), x._value())
    assert 0 < fileio.io_stats["max_chunk_bytes"] <= 1 << 20
    assert fileio.io_stats["chunks"] == 2 * 6
    assert fileio.io_stats["whole_array_reads"] == 0


def test_checkpoint_round_trip_on_the_card(tmp_path):
    from ramba_tpu_torch import checkpoint
    from ramba_tpu_torch.resilience import faults

    g = rt.random.random((300, 200)).astype(np.float32)
    p = str(tmp_path / "ck")
    checkpoint.save(p, {"grid": g, "step": 7})
    back = checkpoint.restore(p)
    assert back["grid"]._value().device.type == "cuda"
    assert torch.equal(back["grid"]._value(), g._value())
    assert int(back["step"]) == 7
    faults.configure("checkpoint:leaf:flip:bytes=1")
    try:
        with pytest.raises(checkpoint.CheckpointCorruptError):
            checkpoint.restore(p)
    finally:
        faults.configure(None)


# -- the mesh of shards and the queue C repairs on the card -------------------


@pytest.fixture
def mesh_2x2():
    from ramba_tpu_torch.parallel import mesh as pmesh

    old = pmesh.get_mesh()
    pmesh.set_mesh(pmesh.Mesh(np.array([torch.device("cuda", 0)] * 4,
                                       dtype=object).reshape(2, 2),
                              ("d0", "d1")))
    try:
        yield
    finally:
        pmesh.set_mesh(old)


@pytest.mark.parametrize("shape,path", [((512, 512), "tma"),
                                        ((259, 333), "cpasync")])
def test_sharded_stencil_launches_the_kernel_per_shard(mesh_2x2, shape,
                                                       path):
    from ramba_tpu_torch.parallel import mesh as pmesh

    x = torch.rand(*shape, device="cuda")
    st = rt.stencil(star2)
    old = pmesh.get_mesh()
    pmesh.set_mesh(pmesh.Mesh(np.array([torch.device("cuda", 0)],
                                       dtype=object), ("d0",)))
    one = rt.sstencil_iterate(st, rt.fromarray(x), 3)._value()
    pmesh.set_mesh(old)
    n0 = sk.launches
    paths0 = (sk.launches_tma, sk.launches_cpasync)
    got = rt.sstencil_iterate(st, rt.fromarray(x), 3)._value()
    assert sk.launches == n0 + 3 * 4  # one per shard per sweep
    taken = (sk.launches_tma - paths0[0], sk.launches_cpasync - paths0[1])
    assert taken == ((12, 0) if path == "tma" else (0, 12))
    assert torch.equal(got.view(torch.int32), one.view(torch.int32))


def test_out_of_range_python_ints_through_elemred():
    a = torch.arange(N, device="cuda", dtype=torch.int32) % 201 - 100
    x = rt.fromarray(a)
    host = a.cpu().numpy()
    for make, want in [
            (lambda: x + 2 ** 40, host),  # 2**40 wraps to 0 in int32
            (lambda: x * (2 ** 33 + 3), host * 3),
            (lambda: rt.maximum(x, 2 ** 32 + 5), np.maximum(host, 5)),
    ]:
        expr = make()  # built here: reading one expression flushes all
        p, vals = fuser.prepare_program([expr.read_expr()])
        assert kb.classify(p, vals) == "elemred"
        before = elemred.launches
        got = expr.asarray()
        assert elemred.launches == before + 1
        np.testing.assert_array_equal(got, want.astype(np.int32))
    # comparisons are exact: one constant, on every path
    np.testing.assert_array_equal((x < 2 ** 40).asarray(), np.ones(N, bool))
    np.testing.assert_array_equal((x == 2 ** 32).asarray(), np.zeros(N, bool))


def test_integer_reciprocal_of_zero_on_the_card():
    for dt, top in [(torch.int8, 127), (torch.int32, 2 ** 31 - 1),
                    (torch.uint8, 255), (torch.int64, 2 ** 63 - 1)]:
        x = torch.tensor([0, 1, 2, 1 if dt == torch.uint8 else -1], dtype=dt,
                         device="cuda")
        got = rt.reciprocal(rt.fromarray(x)).asarray()
        want = [top, 1, 0, 1 if dt == torch.uint8 else -1]
        np.testing.assert_array_equal(got, np.array(want).astype(got.dtype))


# -- several ranks on the card -------------------------------------------------


def _launch_card(world, tmp_path, mode):
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    here = Path(__file__).resolve().parent
    out = tmp_path / "out"
    out.mkdir()
    env = dict(os.environ, RAMBA_INIT_TIMEOUT_S="120")
    env.pop("RAMBA_TORCH_DEVICE", None)
    procs = [subprocess.Popen(
        [sys.executable, str(here / "torch_dist_worker.py"), str(r),
         str(world), str(tmp_path / "store"), str(out), mode], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0] * world, "\n".join(logs)
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(world)], out


def test_two_ranks_on_one_card_run_the_stencil_kernel(tmp_path):
    # two ranks on cuda:0: gloo through pinned host buffers, each rank's
    # block through the CUDA stencil kernel, the result byte-equal to
    # one process's
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch_dist_worker as worker

    infos, out = _launch_card(2, tmp_path, "card")
    st = rt.stencil(worker.star2_body)
    x = rt.fromarray(worker.card_grid())
    y = x
    for _ in range(3):
        y = rt.sstencil(st, y)
    want = {"chained": y.asarray(),
            "iterate": rt.sstencil_iterate(st, x, 5).asarray()}
    a = rt.arange(1 << 20) * 0.001
    rt.sync()
    one_sum = float(rt.sum((a + 1.0) * (a + 0.5)))
    for r, info in enumerate(infos):
        assert info["backend"] == "gloo"
        assert info["stencil_launches"] == 3 + 5  # one per sweep per rank
        assert info["elemred_launches"] >= 1
        assert info["comm"]["host_staged_bytes"] > 0
        assert info["gathered"] == 0
        got = np.load(out / f"rank{r}.npz")
        for k in want:
            assert got[k].tobytes() == want[k].tobytes(), k
        # two partials folded in rank order: within 2 roundings of the
        # one-process elemred sum's n * eps * sum bound
        assert abs(info["sum"] - one_sum) <= (1 << 20) * 2.0 ** -52 * one_sum
    assert infos[0]["sum"] == infos[1]["sum"]
    # groupby on each rank's block: segred once a rank per kind, the G
    # partials folded in rank order; min, max and count equal the plain
    # version on the whole series, the sum within the two launches'
    # rounding depths and the fold of two partials
    data, labels = worker.card_series()
    eps = 2.0 ** -52
    for kind in worker.SEG_KINDS:
        g = rt.fromarray(data).groupby(0, labels, 24)
        program, leaf_vals = fuser.prepare_program(
            [g._reduce(kind).read_expr()])
        (plain,) = segred.segred_reference(program, leaf_vals)
        for r, info in enumerate(infos):
            assert info["segred_launches"][kind] == 1, (kind, info)
            got = np.load(out / f"rank{r}.npz")[f"gb_{kind}"]
            if kind == "sum":
                sum_abs = np.array([np.abs(data[labels == gi]).sum()
                                    for gi in range(24)])
                n = len(data)
                bound = (segred.depth(n) + segred.depth(n // 2 + 1) + 2) \
                    * eps * sum_abs
                assert (np.abs(got - plain.cpu().numpy()) <= bound).all()
            else:
                assert got.tobytes() == plain.cpu().numpy().tobytes(), kind


def test_governor_spills_and_restores_byte_equal(monkeypatch):
    # a budget that cannot hold two 64 MiB arrays: placing the second
    # spills the colder first one to pinned host memory; touching it
    # restores it on the card, byte for byte, and every move is counted
    from ramba_tpu_torch.observe import registry
    from ramba_tpu_torch.resilience import memory, spill

    fuser.flush()
    torch.cuda.synchronize()
    live0 = memory.ledger.live_bytes
    n = 1 << 23
    a = rt.fromarray(np.random.default_rng(7).random(n))
    before = a._value().clone()
    monkeypatch.setenv("RAMBA_HBM_BUDGET", str(int((live0 + (96 << 20))
                                                   / 0.9)))
    ev0, rs0 = registry.get("memory.evictions"), registry.get(
        "memory.restores")
    d2h0 = registry.comm["device_to_host_bytes"]
    b = rt.fromarray(np.ones(n))
    assert registry.get("memory.evictions") == ev0 + 1
    assert isinstance(a._expr.value, spill.SpilledArray)
    assert a._expr.value.host.is_pinned()
    assert registry.comm["device_to_host_bytes"] - d2h0 == n * 8
    assert memory.ledger.spilled_bytes >= n * 8
    after = a._value()
    assert after.is_cuda and torch.equal(after, before)
    assert registry.get("memory.restores") == rs0 + 1
    del a, b, after
    assert memory.ledger.live_bytes == live0


def test_one_rank_nccl_group(tmp_path):
    (info,), _out = _launch_card(1, tmp_path, "nccl")
    assert info["backend"] == "nccl"
    assert info["gathered_ok"] and info["reduced"] == 7
    assert info["gathered"] == 0 and "ranks=[0]" in info["mesh"]
    a = rt.arange(1 << 20) * 0.001
    rt.sync()  # materialised, as on the rank: both sums on elemred
    assert info["sum"] == float(rt.sum((a + 1.0) * (a + 0.5)))


def test_a_bucketed_elemred_launch_equals_the_exact_one(monkeypatch):
    """Under pow2 a 1-D elementwise program runs elemred at its own
    length (the kernels' programs are not bucketed); made to bucket
    (``fuser._kernel_takes`` patched), it launches once at the bucket
    length, its leaf zero-padded, and the stripped result is the exact
    launch's bytes."""
    from ramba_tpu_torch.compile import classes
    from ramba_tpu_torch.core import fuser

    xn = np.random.default_rng(21).standard_normal(N).astype(np.float32)
    outs = {}
    for policy, bucket in (("off", False), ("pow2", False), ("pow2", True)):
        monkeypatch.setenv("RAMBA_COMPILE_CLASSES", policy)
        classes.reset()
        if bucket:
            monkeypatch.setattr(fuser, "_kernel_takes", lambda *a: False)
        x = rt.fromarray(xn)
        p0, e0 = classes.snapshot()["padded"], elemred.launches
        y = (x * 2.0 + 1.0)._value()
        assert elemred.launches == e0 + 1
        assert classes.snapshot()["padded"] == p0 + bucket
        outs[policy, bucket] = y
    monkeypatch.delenv("RAMBA_COMPILE_CLASSES")
    classes.reset()
    for key in (("pow2", False), ("pow2", True)):
        assert outs[key].shape == (N,) and outs[key].is_cuda
        assert torch.equal(outs[key].view(torch.int32),
                           outs["off", False].view(torch.int32))


def test_a_library_loaded_from_the_cache_needs_no_nvcc(tmp_path):
    """A library built into ``<RAMBA_CACHE>/kernels/`` by one process
    loads in the next without a build (digest checked first); a library
    with a flipped byte is evicted and built again, never loaded."""
    import json
    import os
    import subprocess
    import sys

    code = (
        "import sys, json, numpy as np, ramba_tpu_torch as rt;"
        "from ramba_tpu_torch import _build;"
        "from ramba_tpu_torch.compile import persist;"
        "rt.set_device('cuda:0');"
        "x = rt.fromarray(np.arange(70000.0) / 3.0);"
        "v = float(rt.sum(x * 1.25 - 0.5));"
        "print(json.dumps({'builds': _build.nvcc_builds,"
        " 'loads': _build.disk_loads, 'v': v,"
        " 'corrupt': persist.snapshot()['corrupt'],"
        " 'hits': persist.snapshot()['hits'],"
        " 'dir': _build.build_dir()}))")
    env = dict(os.environ, RAMBA_CACHE=str(tmp_path / "c"))
    runs = []
    for _ in range(2):
        r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, timeout=600, env=env)
        assert r.returncode == 0, r.stderr[-2000:]
        runs.append(json.loads(r.stdout.strip().splitlines()[-1]))
    assert runs[0]["dir"] == str(tmp_path / "c" / "kernels")
    assert runs[0]["builds"] >= 1
    assert runs[1]["builds"] == 0 and runs[1]["loads"] >= 1
    assert runs[1]["hits"] == runs[1]["loads"] and runs[0]["hits"] == 0
    assert runs[1]["v"] == runs[0]["v"]
    so = [f for f in (tmp_path / "c" / "kernels").iterdir()
          if f.name.endswith(".so")]
    raw = bytearray(so[0].read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    so[0].write_bytes(bytes(raw))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    third = json.loads(r.stdout.strip().splitlines()[-1])
    assert third["corrupt"] >= 1 and third["builds"] >= 1
    assert third["v"] == runs[0]["v"]


# ---------------------------------------------------------------------------
# the analyzer, the result memo (ROADMAP A.7 part two)
# ---------------------------------------------------------------------------


@pytest.fixture
def analysis_env(monkeypatch):
    from ramba_tpu_torch.core import memo

    for k in ("RAMBA_VERIFY", "RAMBA_MEMO", "RAMBA_PLANCERT",
              "RAMBA_MEMO_BUDGET"):
        monkeypatch.delenv(k, raising=False)
    memo.reset()
    yield monkeypatch
    memo.reset()


def test_strict_flush_of_an_elemred_program_launches_as_unset(analysis_env):
    x = rt.fromarray(torch.rand(N, device="cuda", dtype=torch.float64))
    y = rt.fromarray(torch.rand(N, device="cuda", dtype=torch.float64))

    def run():
        elemred.launches = 0
        v = rt.sum(2.5 * x + y)._value()
        return v, elemred.launches

    plain, n0 = run()
    analysis_env.setenv("RAMBA_VERIFY", "strict")
    got, n1 = run()
    assert n0 == n1 == 1
    assert torch.equal(got, plain)


@pytest.mark.parametrize("how", ["tensor", "view"])
def test_memo_misses_after_an_in_place_write_on_the_card(analysis_env, how):
    from ramba_tpu_torch.core import memo

    analysis_env.setenv("RAMBA_MEMO", "1")
    t = torch.arange(N, device="cuda", dtype=torch.float64)
    x = rt.fromarray(t)
    assert x._expr.value is t
    elemred.launches = 0
    h0 = memo.cache.hits
    first = rt.sum(x * x)._value()
    again = rt.sum(x * x)._value()
    assert elemred.launches == 1 and memo.cache.hits == h0 + 1  # no launch
    assert torch.equal(first, again)
    if how == "tensor":
        t.add_(1)
    else:
        t[:1024].mul_(2)
    got = rt.sum(x * x)._value()
    assert elemred.launches == 2 and memo.cache.hits == h0 + 1
    want = (t * t).sum()
    assert abs(got.item() - want.item()) <= N * EPS[torch.float64] * \
        want.item()


# ---------------------------------------------------------------------------
# the observability plane on the card (ROADMAP A.9)
# ---------------------------------------------------------------------------


def test_the_fence_times_the_card():
    """A steady flush is fenced by its CUDA event pair: the span carries a
    ``device_execute`` stage and reconciles with its wall; the roofline
    row's device time is the fence's, under the card's peak row."""
    from ramba_tpu_torch.observe import attrib
    from ramba_tpu_torch.observe import events

    attrib.reset()
    attrib.reconfigure()
    x = rt.fromarray(torch.rand(1 << 22, dtype=torch.float64,
                                device="cuda"))
    for _ in range(4):
        float(rt.sum(2.0 * x + 1.0))
    span = events.last(1, type="flush")[-1]
    st = span["stages"]
    assert "device_execute" in st and "dispatch" in st
    assert abs(sum(st.values()) + span["unattributed_s"] - span["wall_s"]) \
        <= 2e-5 * (len(st) + 2)
    row = attrib.roofline_report()[span["fingerprint"]]
    assert row["device_time_source"] == "fence" and row["bound"] == "bandwidth"
    kind = torch.cuda.get_device_name(0)
    assert attrib.device_kind() == kind
    if "H100" in kind:
        assert attrib.peak_table()["peak_gbps"] == 3350.0
    attrib.reset()


def test_profiler_trace_holds_the_kernels(tmp_path):
    import json

    x = rt.fromarray(torch.rand(1 << 20, dtype=torch.float64, device="cuda"))
    float(rt.sum(x * 2.0))  # built and planned before the trace
    with rt.profiler_trace(str(tmp_path)):
        float(rt.sum(x * 2.0))
    (path,) = tmp_path.glob("trace_*.json")
    doc = json.loads(path.read_text())
    evs = doc["traceEvents"] if isinstance(doc, dict) else doc
    names = [e.get("name", "") for e in evs if e.get("cat") == "kernel"]
    assert any("elemred_kernel" in n for n in names), names[:20]


def test_drain_effect_errors_on_a_healthy_card():
    assert rt.debug.drain_effect_errors() is None


# -- serving on the card: the worker thread and the hedge streams --------------


def test_the_pipeline_worker_launches_on_the_submitters_stream():
    """A session flush submitted from a side CUDA stream launches elemred
    on the worker thread on that stream; a read on the default stream is
    ordered after the worker's write-back by the ticket's event, and the
    bytes are the default stream's flush's."""
    from ramba_tpu_torch import serve

    x = rt.fromarray(torch.rand(1 << 20, dtype=torch.float64,
                                generator=torch.Generator("cuda").manual_seed(1),
                                device="cuda"))
    y = rt.fromarray(torch.rand(1 << 20, dtype=torch.float64,
                                generator=torch.Generator("cuda").manual_seed(2),
                                device="cuda"))
    rt.sync()
    want = (2.5 * x + y)._value().clone()
    side = torch.cuda.Stream()
    seen = []
    real = elemred.launch

    def spy(*a, **kw):
        seen.append((__import__("threading").current_thread().name,
                     torch.cuda.current_stream()))
        return real(*a, **kw)

    elemred.launch = spy
    try:
        with torch.cuda.stream(side):
            with serve.Session(tenant="card") as s:
                z = 2.5 * x + y
                t = s.flush()
        got = t.wait(60)
        assert got == []
        assert t.event is not None
        assert torch.equal(z._value(), want)
    finally:
        elemred.launch = real
        serve.shutdown()
    assert seen and seen[0][0] == "ramba-serve-dispatch"
    assert seen[0][1] == side


def test_a_hedge_runs_on_its_own_stream_and_wins_byte_equal(monkeypatch):
    """Under ``serve:hedge:delay:ms=200`` the hedge attempt launches on a
    CUDA stream of its own, wins, and its bytes equal the unhedged
    flush's; the loser's cancel flag stops it."""
    from ramba_tpu_torch import serve
    from ramba_tpu_torch.observe import ledger, registry
    from ramba_tpu_torch.resilience import elastic, faults

    x = rt.fromarray(torch.rand(1 << 22, dtype=torch.float64,
                                generator=torch.Generator("cuda").manual_seed(3),
                                device="cuda"))
    rt.sync()
    ledger.reset()
    ledger.reconfigure(min_samples=3)
    outs = []
    for _ in range(5):
        with serve.Session(tenant="hedge") as s:
            a = rt.sum(x * 2.0 + 1.0)
            s.flush(wait=True)
        outs.append(float(a))
    streams = []
    real = elemred.launch

    def spy(*a, **kw):
        streams.append(torch.cuda.current_stream())
        return real(*a, **kw)

    monkeypatch.setenv("RAMBA_HEDGE_FACTOR", "0.5")
    faults.configure("serve:hedge:delay:ms=200")
    elemred.launch = spy
    fired = registry.get("serve.hedge.fired")
    try:
        with serve.Session(tenant="hedge") as s:
            b = rt.sum(x * 2.0 + 1.0)
            s.flush(wait=True)
        got = float(b)
    finally:
        elemred.launch = real
        faults.configure(None)
        serve.shutdown()
        ledger.reconfigure()
    assert registry.get("serve.hedge.fired") == fired + 1
    assert registry.get("serve.hedge.won_hedge") >= 1
    assert got == outs[0] and len(set(outs)) == 1
    assert streams and streams[0] != torch.cuda.default_stream()
    assert elastic.wait_abandoned(10)

