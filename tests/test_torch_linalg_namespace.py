"""``ramba_tpu_torch.linalg``: the port against ramba_tpu, x64 regime.

Every name of ``ramba_tpu/linalg.py`` runs through both packages on the same
seeded, well-conditioned inputs (``convert.state_from_reference``) over the
dtype sweep, bool to complex128; where ramba_tpu refuses a dtype the port
must refuse it with the same exception class.  Dtypes and shapes are
compared exactly.  Values: factorizations by their reconstruction and
orthogonality residuals (``|A - QR| / |A| <= c * n * eps`` and the like,
c = 8, never the raw factors, whose signs differ between LAPACK
implementations); invariant values (norms, determinants, singular and
eigenvalues, inverses, solutions) within ``c * n * eps * cond`` of
ramba_tpu's relative to their largest magnitude; integer results
(``matrix_rank``, integer ``matrix_power``) exactly.  The host boundaries
(eig, eigvals, lstsq, tensorsolve, tensorinv) return NumPy's results,
compared exactly.  The cases follow ``tests/test_linalg_namespace.py``.
"""

import numpy as np
import pytest
import torch

import jax
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from ramba_tpu_torch import common, convert

SWEEP = ["bool", "int8", "int16", "int32", "int64", "uint8", "uint16",
         "uint32", "uint64", "float16", "float32", "float64", "complex64",
         "complex128"]
C = 8
N = 6


@pytest.fixture(autouse=True)
def _port_on_cpu():
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    torch.set_num_threads(1)


def _eps(dt):
    dt = np.dtype(dt)
    if dt.kind == "c":
        return np.finfo(np.float64 if dt.itemsize == 16 else np.float32).eps
    if dt.kind == "f":
        return np.finfo(dt).eps
    return 0.0


def _spd(dtype, seed=0):
    """A Hermitian positive definite matrix (diagonally dominant), or for
    integers and bools one with a dominant diagonal."""
    rs = np.random.RandomState(seed)
    kind = np.dtype(dtype).kind
    if kind == "b":  # unit upper triangular: nonsingular
        return np.triu(rs.rand(N, N) > 0.5, 1) | np.eye(N, dtype=bool)
    if kind in "iu":
        m = rs.randint(0, 3, (N, N))
        m = m + m.T + 12 * np.eye(N, dtype=int)
        return m.astype(dtype)
    m = rs.rand(N, N)
    if kind == "c":
        m = m + 1j * rs.rand(N, N)
    m = m @ m.conj().T + N * np.eye(N)
    return m.astype(dtype)


def _rect(dtype, seed=1, shape=(8, 5)):
    rs = np.random.RandomState(seed)
    kind = np.dtype(dtype).kind
    if kind == "b":
        return rs.rand(*shape) > 0.5
    if kind in "iu":
        return rs.randint(0, 9, shape).astype(dtype)
    m = rs.rand(*shape)
    if kind == "c":
        m = m + 1j * rs.rand(*shape)
    return m.astype(dtype)


def _pair(**arrays):
    ref = {k: rtj.fromarray(v) for k, v in arrays.items()}
    port = convert.state_from_reference({k: a.asarray()
                                         for k, a in ref.items()})
    return ref, port


def _host(x):
    return np.asarray(x.asarray() if hasattr(x, "asarray") else x)


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [y for x in out for y in _flat(x)]
    return [out]


def _run(case, arrays):
    """(port outputs, ramba_tpu outputs) as host arrays, or (None, None)
    where both refuse."""
    ref, port = _pair(**arrays)
    try:
        want = [_host(w) for w in _flat(case(rtj, **ref))]
    except Exception as e:
        with pytest.raises(type(e)):
            [_host(g) for g in _flat(case(rt, **port))]
        return None, None
    got = [_host(g) for g in _flat(case(rt, **port))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype, f"port {g.dtype} vs ramba_tpu {w.dtype}"
        assert g.shape == w.shape, f"port {g.shape} vs ramba_tpu {w.shape}"
    return got, want


def _near(g, w, what, cond=10.0):
    g, w = np.asarray(g), np.asarray(w)
    if g.dtype.kind not in "fc":
        np.testing.assert_array_equal(g, w, err_msg=what)
        return
    scale = max(float(np.abs(w).max()) if w.size else 0.0, 1e-300)
    bound = C * N * _eps(g.dtype) * cond * scale
    err = float(np.abs(g.astype(np.complex128) - w.astype(np.complex128))
                .max()) if g.size else 0.0
    assert err <= bound, f"{what}: error {err} beyond {bound}"


def _resid(a, b, what, dt):
    a, b = np.asarray(a, np.complex128), np.asarray(b, np.complex128)
    r = np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)
    assert r <= C * N * _eps(dt) * 10, f"{what}: residual {r}"


VALUES = {
    "norm": lambda m, a, s: [m.linalg.norm(a), m.linalg.norm(a, axis=1),
                             m.linalg.norm(a, ord=1),
                             m.linalg.norm(a, ord=np.inf),
                             m.linalg.norm(a, ord="fro"),
                             m.linalg.norm(a, axis=(0, 1), keepdims=True),
                             m.linalg.norm(a[:, 0], ord=np.inf),
                             m.linalg.norm(a[:, 0], ord=3),
                             m.linalg.norm(a, axis=np.int64(0), ord=1)],
    "det": lambda m, a, s: m.linalg.det(s),
    "slogdet": lambda m, a, s: m.linalg.slogdet(s),
    "inv": lambda m, a, s: m.linalg.inv(s),
    "solve": lambda m, a, s: [m.linalg.solve(s, s[:, 0]),
                              m.linalg.solve(s, s[:, :2])],
    "cholesky": lambda m, a, s: m.linalg.cholesky(s),
    "eigvalsh": lambda m, a, s: m.linalg.eigvalsh(s),
    "svdvals": lambda m, a, s: [m.linalg.svdvals(a),
                                m.linalg.svd(a, compute_uv=False)],
    "pinv": lambda m, a, s: [m.linalg.pinv(a), m.linalg.pinv(a, rtol=0.3),
                             m.linalg.pinv(a, rcond=0.3)],
    "cond": lambda m, a, s: [m.linalg.cond(s), m.linalg.cond(s, 2),
                             m.linalg.cond(s, -2), m.linalg.cond(s, 1),
                             m.linalg.cond(s, np.inf),
                             m.linalg.cond(s, "fro")],
    "matrix_transpose": lambda m, a, s: m.linalg.matrix_transpose(a),
    "multi_dot": lambda m, a, s: [m.linalg.multi_dot([a.T, a, s[:5, :5]]),
                                  m.linalg.multi_dot([a[:, 0], a, s[:5, 0]])],
    "matrix_power": lambda m, a, s: [m.linalg.matrix_power(s, 3),
                                     m.linalg.matrix_power(s, 0)],
    "matrix_power_inv": lambda m, a, s: m.linalg.matrix_power(s, -2),
    "matrix_rank": lambda m, a, s: [m.linalg.matrix_rank(a),
                                    m.linalg.matrix_rank(s, 0.5),
                                    m.linalg.matrix_rank(s, rtol=100.0),
                                    m.linalg.matrix_rank(a[:, 0]),
                                    m.linalg.matrix_rank(a[:, 0], tol=1e9)],
}


@pytest.mark.parametrize("dtype", SWEEP)
@pytest.mark.parametrize("name", sorted(VALUES))
def test_values(name, dtype):
    got, want = _run(VALUES[name], {"a": _rect(dtype), "s": _spd(dtype)})
    if got is None:
        return
    # cond(s) is at most a few tens; the products' chains grow it
    cond = {"matrix_power": 1e4, "matrix_power_inv": 1e3,
            "multi_dot": 1e2}.get(name, 1e2)
    for i, (g, w) in enumerate(zip(got, want)):
        _near(g, w, f"{name}[{i}] {dtype}", cond)


@pytest.mark.parametrize("dtype", SWEEP)
@pytest.mark.parametrize("mode", ["reduced", "complete", "r"])
def test_qr_by_residuals(mode, dtype):
    a = _rect(dtype)
    got, want = _run(lambda m, a: m.linalg.qr(a, mode=mode), {"a": a})
    if got is None:
        return
    if mode == "r":
        r = got[0]
        assert np.allclose(np.tril(r, -1), 0)
        return
    q, r = got
    dt = q.dtype
    _resid(q @ r, a.astype(dt), f"qr {mode} A = QR", dt)
    _resid(q.conj().T @ q, np.eye(q.shape[1]), f"qr {mode} Q^H Q = I", dt)
    assert np.allclose(np.tril(r, -1), 0)


@pytest.mark.parametrize("dtype", SWEEP)
@pytest.mark.parametrize("full", [True, False])
def test_svd_by_residuals(full, dtype):
    a = _rect(dtype)
    got, want = _run(lambda m, a: m.linalg.svd(a, full_matrices=full),
                     {"a": a})
    if got is None:
        return
    u, s, vh = got
    dt = u.dtype
    k = s.shape[-1]
    _resid((u[:, :k] * s) @ vh[:k], a.astype(dt), "svd A = U S Vh", dt)
    _resid(u.conj().T @ u, np.eye(u.shape[1]), "svd U^H U = I", dt)
    _near(s, want[1], f"svd S {dtype}")


@pytest.mark.parametrize("dtype", SWEEP)
def test_eigh_by_residuals(dtype):
    s = _spd(dtype)
    got, want = _run(lambda m, s: [m.linalg.eigh(s), m.linalg.eigh(s, "U")],
                     {"s": s})
    if got is None:
        return
    for w_vals, v, ref_vals in ((got[0], got[1], want[0]),
                                (got[2], got[3], want[2])):
        dt = v.dtype
        sym = (s.astype(dt) + s.astype(dt).conj().T) / 2  # jnp symmetrizes
        _resid((v * w_vals) @ v.conj().T, sym, "eigh A = V W V^H", dt)
        _near(w_vals, ref_vals, f"eigh eigenvalues {dtype}")


def test_result_types_and_error_class():
    a = rt.fromarray(_rect("float64"))
    s = rt.fromarray(_spd("float64"))
    assert type(rt.linalg.svd(a)).__name__ == "SVDResult"
    assert rt.linalg.svd(a).S.shape == (5,)
    assert type(rt.linalg.qr(a)).__name__ == "QRResult"
    assert type(rt.linalg.slogdet(s)).__name__ == "SlogdetResult"
    assert type(rt.linalg.eigh(s)).__name__ == "EighResult"
    assert rt.linalg.LinAlgError is rtj.linalg.LinAlgError


def test_one_factorization_per_flush():
    """The three outputs of svd share one factorization in one flush."""
    calls = []
    orig = torch.linalg.svd

    def counting(*args, **kw):
        calls.append(1)
        return orig(*args, **kw)

    torch.linalg.svd = counting
    try:
        a = rt.fromarray(_rect("float64"))
        u, s, vh = rt.linalg.svd(a)
        rt.sync()
    finally:
        torch.linalg.svd = orig
    assert len(calls) == 1
    assert u.shape == (8, 8) and s.shape == (5,) and vh.shape == (5, 5)


HOST = {
    "eig": lambda m, s: m.linalg.eig(s),
    "eigvals": lambda m, s: m.linalg.eigvals(s),
    "lstsq": lambda m, s: m.linalg.lstsq(s, s[:, 0]),
    "tensorsolve": lambda m, s: m.linalg.tensorsolve(s, s[:, 0]),
    "tensorinv": lambda m, s: m.linalg.tensorinv(s, ind=1),
}


@pytest.mark.parametrize("dtype", ["int64", "float32", "float64",
                                   "complex128"])
@pytest.mark.parametrize("name", sorted(HOST))
def test_host_boundaries(name, dtype):
    got, want = _run(HOST[name], {"s": _spd(dtype)})
    if got is None:
        return
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_numpy_linalg_routes_here():
    from ramba_tpu_torch.core.interop import HANDLED_FUNCTIONS

    a = rt.fromarray(_spd("float64"))
    got = np.linalg.det(a)
    assert isinstance(got, rt.ndarray)
    assert float(got) == float(rt.linalg.det(a))
    names = [n for n in dir(rtj.linalg) if not n.startswith("_") and
             getattr(np.linalg, n, None) in rtj.core.interop.HANDLED_FUNCTIONS]
    assert len(names) > 15
    for n in names:
        assert HANDLED_FUNCTIONS[getattr(np.linalg, n)] is getattr(rt.linalg,
                                                                   n), n
