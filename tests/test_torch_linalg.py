"""``ops/linalg.py`` and the matmul ops: the port against ramba_tpu, x64
regime.

Each product runs through both packages on inputs made with numpy from a
seed (carried across with ``convert.state_from_reference``).  Dtypes must
be equal exactly (both follow jnp's promotion lattice, which
``expr.jnp_promote`` is held to against ``jnp.promote_types`` here).
Integer and bool results are exact (both wrap modulo 2**64, then to the
result's width).  Float results may differ by the summation order of each
dot product: every element is held within ``K * eps * (|A| @ |B|)``
(Higham's bound for a K-term dot product, each order within half of it),
``eps`` of the result dtype, ``|A| @ |B|`` computed in float64.
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from ramba_tpu_torch import common, convert
from ramba_tpu_torch.core import expr as E


@pytest.fixture(autouse=True)
def _port_on_cpu():
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    torch.set_num_threads(1)


def _values(dtype, shape, seed):
    rs = np.random.RandomState(seed)
    if dtype == "bool":
        return rs.rand(*shape) > 0.5
    kind = np.dtype(dtype).kind
    if kind == "u":
        return rs.randint(0, 100, shape).astype(dtype)
    if kind == "i":
        return rs.randint(-50, 50, shape).astype(dtype)
    return np.asarray(rs.randn(*shape)).astype(dtype)


def _pair(**arrays):
    ref = {k: rtj.fromarray(v) for k, v in arrays.items()}
    port = convert.state_from_reference({k: a.asarray()
                                         for k, a in ref.items()})
    return ref, port


def _check(got, want, bound_of, what):
    g = np.asarray(got.asarray())
    w = np.asarray(want.asarray())
    assert g.dtype == w.dtype, f"{what}: port {g.dtype} vs ramba_tpu {w.dtype}"
    assert g.shape == w.shape, f"{what}: port {g.shape} vs ramba_tpu {w.shape}"
    if w.dtype.kind in "biu":
        np.testing.assert_array_equal(g, w, err_msg=what)
        return
    k, absprod = bound_of()
    bound = k * np.finfo(w.dtype).eps * np.asarray(absprod, np.float64)
    err = np.abs(g.astype(np.float64) - w.astype(np.float64))
    assert (err <= bound + np.finfo(w.dtype).tiny).all(), \
        f"{what}: largest err/bound {np.max(err / np.maximum(bound, 1e-300))}"


def _abs(a):
    return np.abs(np.asarray(a, np.float64))


MATMULS = [((4, 6), (6, 3)), ((6,), (6, 3)), ((4, 6), (6,)), ((6,), (6,)),
           ((2, 4, 6), (6, 3)), ((2, 1, 4, 6), (3, 6, 5))]


@pytest.mark.parametrize("dtype", ["float32", "float64", "float16", "int8",
                                   "int32", "int64", "uint8", "bool"])
@pytest.mark.parametrize("shapes", MATMULS, ids=[f"{a}@{b}" for a, b in MATMULS])
def test_matmul(shapes, dtype):
    sa, sb = shapes
    a, b = _values(dtype, sa, 1), _values(dtype, sb, 2)
    ref, port = _pair(a=a, b=b)
    bound = lambda: (sa[-1], np.matmul(_abs(a), _abs(b)))  # noqa: E731
    _check(rt.matmul(port["a"], port["b"]), rtj.matmul(ref["a"], ref["b"]),
           bound, f"matmul {sa}@{sb} {dtype}")
    _check(port["a"] @ port["b"], ref["a"] @ ref["b"], bound, "@")


@pytest.mark.parametrize("pair", [("int32", "float32"), ("uint8", "int8"),
                                  ("bool", "int16"), ("int64", "uint64"),
                                  ("float16", "float32"), ("int8", "float16")])
def test_mixed_dtypes_follow_jnp(pair):
    a, b = _values(pair[0], (3, 5), 3), _values(pair[1], (5, 4), 4)
    ref, port = _pair(a=a, b=b)
    bound = lambda: (5, np.matmul(_abs(a), _abs(b)))  # noqa: E731
    for name in ("matmul", "dot"):
        _check(getattr(rt, name)(port["a"], port["b"]),
               getattr(rtj, name)(ref["a"], ref["b"]), bound, f"{name} {pair}")
    _check(rt.outer(port["a"], port["b"]), rtj.outer(ref["a"], ref["b"]),
           lambda: (1, np.outer(_abs(a), _abs(b))), f"outer {pair}")


def test_int64_matmul_wraps_exactly():
    """Products past 2**63 wrap modulo 2**64, as NumPy's int64 does (a
    float64 route would be inexact above 2**53)."""
    rs = np.random.RandomState(5)
    a = rs.randint(-2 ** 40, 2 ** 40, (7, 9), dtype=np.int64)
    b = rs.randint(-2 ** 40, 2 ** 40, (9, 4), dtype=np.int64)
    got = (rt.fromarray(a) @ rt.fromarray(b)).asarray()
    with np.errstate(over="ignore"):
        np.testing.assert_array_equal(got, a @ b)


DOTS = [((), (3,)), ((5,), (5,)), ((3, 5), (5,)), ((2, 3, 5), (4, 5, 2)),
        ((3, 5), (5, 2))]


@pytest.mark.parametrize("dtype", ["float64", "int32"])
@pytest.mark.parametrize("shapes", DOTS, ids=[f"{a}.{b}" for a, b in DOTS])
def test_dot(shapes, dtype):
    sa, sb = shapes
    a, b = _values(dtype, sa, 6), _values(dtype, sb, 7)
    ref, port = _pair(a=a, b=b)
    k = sa[-1] if sa else 1
    bound = lambda: (k, np.dot(_abs(a), _abs(b)))  # noqa: E731
    _check(rt.dot(port["a"], port["b"]), rtj.dot(ref["a"], ref["b"]), bound,
           f"dot {sa}.{sb}")
    _check(port["a"].dot(port["b"]), ref["a"].dot(ref["b"]), bound, "method")


TENSORDOTS = [((3, 4, 5), (4, 5, 2), 2), ((3, 4, 5), (5, 2), 1),
              ((3, 4, 5), (4, 3, 2), ([0, 1], [1, 0])), ((3, 4), (4, 3), 0),
              ((3, 4, 5), (5, 4), ((2, 1), (0, 1)))]


@pytest.mark.parametrize("dtype", ["float32", "int64"])
@pytest.mark.parametrize("case", TENSORDOTS, ids=[str(c[2]) for c in TENSORDOTS])
def test_tensordot(case, dtype):
    sa, sb, axes = case
    a, b = _values(dtype, sa, 8), _values(dtype, sb, 9)
    ref, port = _pair(a=a, b=b)
    xa = range(len(sa) - axes, len(sa)) if isinstance(axes, int) else axes[0]
    k = int(np.prod([sa[i] for i in xa]))  # the terms of each dot product
    bound = lambda: (k, np.tensordot(_abs(a), _abs(b), axes))  # noqa: E731
    _check(rt.tensordot(port["a"], port["b"], axes),
           rtj.tensordot(ref["a"], ref["b"], axes), bound, f"tensordot {axes}")


EINSUMS = [("ij,jk->ik", [(3, 4), (4, 5)]), ("ij,jk", [(3, 4), (4, 5)]),
           ("ii->i", [(4, 4)]), ("ii", [(4, 4)]), ("ij->ji", [(3, 4)]),
           ("bij,bjk->bik", [(2, 3, 4), (2, 4, 5)]), ("i,i->", [(6,), (6,)]),
           ("i,j->ij", [(3,), (4,)]), ("...ij,...jk->...ik", [(2, 3, 4), (4, 2)]),
           ("ij,kj->ik", [(3, 4), (5, 4)]), ("ijk->k", [(2, 3, 4)])]


@pytest.mark.parametrize("dtype", ["float64", "int32", "bool"])
@pytest.mark.parametrize("case", EINSUMS, ids=[c[0] for c in EINSUMS])
def test_einsum(case, dtype):
    sub, shapes = case
    arrs = {f"o{i}": _values(dtype, s, 10 + i) for i, s in enumerate(shapes)}
    ref, port = _pair(**arrs)
    ops_r = [ref[f"o{i}"] for i in range(len(shapes))]
    ops_p = [port[f"o{i}"] for i in range(len(shapes))]
    k = int(np.prod([max(s) for s in shapes]))
    bound = lambda: (k, np.einsum(sub, *[_abs(arrs[f"o{i}"])  # noqa: E731
                                        for i in range(len(shapes))]))
    _check(rt.einsum(sub, *ops_p), rtj.einsum(sub, *ops_r), bound, f"einsum {sub}")


def test_einsum_path_matches_numpy():
    a, b, c = np.ones((3, 4)), np.ones((4, 5)), np.ones((5, 6))
    want = np.einsum_path("ij,jk,kl->il", a, b, c, optimize="greedy")
    got = rt.einsum_path("ij,jk,kl->il", rt.fromarray(a), rt.fromarray(b),
                         rt.fromarray(c))
    assert got[0] == want[0]


@pytest.mark.parametrize("dtype", ["float64", "int8", "bool", "uint16"])
def test_vdot_inner_outer_trace(dtype):
    a, b = _values(dtype, (3, 4), 20), _values(dtype, (3, 4), 21)
    y = _values(dtype, (2, 3, 4), 22)
    ref, port = _pair(a=a, b=b, y=y)
    cases = [
        ("vdot", lambda m, r: m.vdot(r["a"], r["b"]),
         lambda: (12, np.vdot(_abs(a), _abs(b)))),
        ("inner", lambda m, r: m.inner(r["a"], r["b"]),
         lambda: (4, np.inner(_abs(a), _abs(b)))),
        ("outer", lambda m, r: m.outer(r["a"], r["b"]),
         lambda: (1, np.outer(_abs(a), _abs(b)))),
        ("trace", lambda m, r: m.trace(r["a"]), lambda: (3, np.trace(_abs(a)))),
        ("trace offset", lambda m, r: m.trace(r["a"], 1),
         lambda: (3, np.trace(_abs(a), 1))),
        ("trace 3-D", lambda m, r: m.trace(r["y"], -1, 1, 2),
         lambda: (3, np.trace(_abs(y), -1, 1, 2))),
    ]
    for what, fn, bound in cases:
        _check(fn(rt, port), fn(rtj, ref), bound, f"{what} {dtype}")


LATTICE = ["bool", "int8", "int16", "int32", "int64", "uint8", "uint16",
           "uint32", "uint64", "float16", "float32", "float64", "complex64",
           "complex128"]


def test_jnp_promote_equals_jnp():
    """The port's copy of jnp's lattice against jnp itself, every pair, and
    against weakly typed python scalars."""
    import ml_dtypes

    names = LATTICE + ["bfloat16"]

    def dt(n):
        return np.dtype(ml_dtypes.bfloat16) if n == "bfloat16" else np.dtype(n)

    for x, y in itertools.product(names, names):
        want = jnp.promote_types(dt(x), dt(y))
        got = E.jnp_promote([E.Aval((), dt(x)), E.Aval((), dt(y))])
        assert np.dtype(got) == np.dtype(want), (x, y, got, want)
    for x in names:
        for s in (2, 2.5, 1j):
            want = (jnp.zeros((), dt(x)) * s).dtype
            got = E.jnp_promote([E.Aval((), dt(x)), E.aval_of(s)])
            assert np.dtype(got) == np.dtype(want), (x, s, got, want)


def test_precision_switch_is_per_call():
    assert not E.tf32_allowed(None) and not E.tf32_allowed("highest")
    assert E.tf32_allowed("tensorfloat32") and E.tf32_allowed("high")
    try:
        rt.set_matmul_precision("highest")
        a = rt.fromarray(np.eye(3))
        np.testing.assert_array_equal((a @ a).asarray(), np.eye(3))
    finally:
        rt.set_matmul_precision(None)
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_numpy_left_operand_and_dispatch():
    a = np.arange(6.0).reshape(2, 3)
    b = rt.fromarray(np.arange(12.0).reshape(3, 4))
    for got in (a @ b, np.matmul(a, b), np.dot(a, b), np.tensordot(a, b, 1)):
        assert isinstance(got, rt.ndarray)
        np.testing.assert_array_equal(got.asarray(), a @ np.arange(12.0)
                                      .reshape(3, 4))
