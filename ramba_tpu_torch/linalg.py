"""``ramba_tpu_torch.linalg`` — the numpy.linalg namespace.

Counterpart of ``ramba_tpu/linalg.py``.  The static-shape functions are
``call`` nodes (``ops/extras.py``) on ``torch.linalg`` (cuSOLVER/cuBLAS
on the card, TF32 off), their dtypes by jnp's rules: integers compute in
their inexact dtype (float32 up to 32 bits, float64 above), norms, singular
values, ``eigh``'s eigenvalues and ``slogdet``'s log are real.  A
multi-output factorization (qr, svd, eigh, slogdet) gives one node per
output; the nodes a flush runs together share one factorization
(``extras.SharedResult``).  ``eig``, ``eigvals``, ``lstsq``,
``tensorsolve`` and ``tensorinv`` are host boundaries, as in the reference.

The tolerances read as ``ramba_tpu``'s: ``matrix_rank``'s ``tol`` (and its
``rtol``, which jnp also compares with the singular values directly) is an
absolute cutoff, by default ``S.max * max(M, N) * eps``; ``pinv`` zeroes
singular values at or below ``rtol * S.max`` (``rcond`` when no ``rtol``),
by default ``rtol = 10 * max(M, N) * eps``; ``cond`` is ``S[0] / S[-1]``
for p None or 2 and ``norm(x, p) * norm(inv(x), p)`` otherwise, a NaN
where ``x`` has none becoming inf.
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np
import torch

from ramba_tpu_torch.core import expr as E
from ramba_tpu_torch.core.expr import Aval
from ramba_tpu_torch.ops.creation import asarray
from ramba_tpu_torch.ops.extras import (
    SharedResult, _axis_arg, _host, inexact, lazy, register_call,
)

SVDResult = namedtuple("SVDResult", ["U", "S", "Vh"])
QRResult = namedtuple("QRResult", ["Q", "R"])
SlogdetResult = namedtuple("SlogdetResult", ["sign", "logabsdet"])
EighResult = namedtuple("EighResult", ["eigenvalues", "eigenvectors"])

LinAlgError = np.linalg.LinAlgError


def _real(dt) -> np.dtype:
    dt = inexact(dt)
    if dt.kind == "c":
        return np.dtype(np.float64 if dt.itemsize == 16 else np.float32)
    return dt


def _work(t, half=False):
    """``t`` in its inexact dtype.  The factorizations refuse float16, as
    XLA's do in ramba_tpu; where ``half`` (the norms) it computes in
    float32."""
    dt = inexact(E.to_np_dtype(t.dtype))
    if dt == np.float16 or E.is_bf16(dt):
        if not half:
            raise NotImplementedError(f"Unsupported dtype {dt}.")
        dt = np.dtype(np.float32)
    return E.convert(t, E.to_torch_dtype(dt))


def _refuse_half(a):
    if inexact(a.dtype) == np.float16:
        raise NotImplementedError("Unsupported dtype float16.")


def _hermitian(x):
    """jnp's eigh and cholesky symmetrize their input: (A + A^H) / 2."""
    return (x + x.mH) / 2


class _NoTF32:
    def __enter__(self):
        self.flags = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.flags


def _square(name, a):
    if len(a.shape) < 2 or a.shape[-1] != a.shape[-2]:
        raise LinAlgError(f"{name}: last 2 dimensions of the array must be "
                          "square")


# -- norm ----------------------------------------------------------------------


def _aval_norm(kw, x):
    axis, keepdims = kw.get("axis"), kw["keepdims"]
    nd = len(x.shape)
    if axis is None:
        shape = (1,) * nd if keepdims else ()
    else:
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        axes = tuple(a % nd for a in axes)
        shape = E._reduced_shape(x.shape, axes, keepdims)
    return Aval(tuple(shape), _real(x.dtype))


@register_call("linalg.norm", _aval_norm)
def _norm(x, ord=None, axis=None, keepdims=False):
    x = _work(x, half=True)
    with _NoTF32():
        if axis is None and ord is not None and x.ndim == 2:
            return torch.linalg.matrix_norm(x, ord=ord, keepdim=keepdims)
        if axis is None:
            r = torch.linalg.vector_norm(x.reshape(-1), ord=2 if ord is None
                                         else ord)
            return r.reshape((1,) * x.ndim) if keepdims else r
        if isinstance(axis, tuple) and len(axis) == 2:
            return torch.linalg.matrix_norm(
                x, ord="fro" if ord is None else ord, dim=axis,
                keepdim=keepdims)
        return torch.linalg.vector_norm(x, ord=2 if ord is None else ord,
                                        dim=axis, keepdim=keepdims)


def norm(x, ord=None, axis=None, keepdims=False):
    kw = {"keepdims": bool(keepdims)}
    if ord is not None:
        kw["ord"] = ord
    if axis is not None:
        kw["axis"] = _axis_arg(axis)
    return lazy("linalg.norm", x, **kw)


# -- det, slogdet, inv, solve, cholesky -------------------------------------------


def _aval_det(kw, a):
    _refuse_half(a)
    _square("det", a)
    return Aval(a.shape[:-2], inexact(a.dtype))


@register_call("linalg.det", _aval_det)
def _det(a):
    with _NoTF32():
        return torch.linalg.det(_work(a))


def det(a):
    return lazy("linalg.det", a)


def _aval_slogdet(kw, a):
    _refuse_half(a)
    _square("slogdet", a)
    dt = inexact(a.dtype)
    return Aval(a.shape[:-2], dt if kw["part"] == 0 else _real(dt))


@register_call("linalg.slogdet", _aval_slogdet)
def _slogdet(a, part=0):
    def compute():
        with _NoTF32():
            return torch.linalg.slogdet(_work(a))
    return SharedResult.get("slogdet", [a], compute)[part]


def slogdet(a):
    return SlogdetResult(lazy("linalg.slogdet", a, part=0),
                         lazy("linalg.slogdet", a, part=1))


def _aval_inv(kw, a):
    _refuse_half(a)
    _square("inv", a)
    return Aval(a.shape, inexact(a.dtype))


@register_call("linalg.inv", _aval_inv)
def _inv(a):
    with _NoTF32():
        return torch.linalg.inv_ex(_work(a)).inverse


def inv(a):
    return lazy("linalg.inv", a)


def _aval_solve(kw, a, b):
    _refuse_half(a)
    _refuse_half(b)
    _square("solve", a)
    dt = inexact(E.jnp_promote([a, b]))
    if len(b.shape) == 1:
        return Aval(a.shape[:-1], dt)
    return Aval(tuple(np.broadcast_shapes(a.shape[:-2], b.shape[:-2]))
                + b.shape[-2:], dt)


@register_call("linalg.solve", _aval_solve)
def _solve(a, b):
    dt = E.to_torch_dtype(inexact(E.jnp_promote([E.aval_of(a),
                                                  E.aval_of(b)])))
    a, b = _work(E.convert(a, dt)), _work(E.convert(b, dt))
    with _NoTF32():
        if b.ndim == 1:
            return torch.linalg.solve_ex(a, b[:, None]).result[..., 0]
        return torch.linalg.solve_ex(a, b).result


def solve(a, b):
    return lazy("linalg.solve", a, b)


@register_call("linalg.cholesky", _aval_inv)
def _cholesky(a, upper=False):
    with _NoTF32():
        return torch.linalg.cholesky_ex(_hermitian(_work(a)), upper=upper).L


def cholesky(a, *, upper=False):
    return lazy("linalg.cholesky", a, upper=bool(upper))


# -- qr, svd, eigh -----------------------------------------------------------------


def _aval_qr(kw, a):
    _refuse_half(a)
    m, n = a.shape[-2:]
    k = min(m, n)
    dt = inexact(a.dtype)
    mode, part = kw["mode"], kw["part"]
    batch = a.shape[:-2]
    if mode == "complete":
        q, r = (m, m), (m, n)
    else:
        q, r = (m, k), (k, n)
    if mode == "r" or part == 1:
        return Aval(batch + r, dt)
    return Aval(batch + q, dt)


@register_call("linalg.qr", _aval_qr)
def _qr(a, mode="reduced", part=0):
    def compute():
        with _NoTF32():
            return torch.linalg.qr(_work(a), mode="complete"
                                   if mode == "complete" else "reduced")
    return SharedResult.get(("qr", mode), [a], compute)[1 if mode == "r"
                                                         else part]


def qr(a, mode="reduced"):
    if mode not in ("reduced", "complete", "r"):
        raise ValueError(f"Unsupported QR decomposition mode '{mode}'")
    if mode == "r":
        return lazy("linalg.qr", a, mode="r", part=1)
    return QRResult(lazy("linalg.qr", a, mode=mode, part=0),
                    lazy("linalg.qr", a, mode=mode, part=1))


def _aval_svd(kw, a):
    _refuse_half(a)
    m, n = a.shape[-2:]
    k = min(m, n)
    dt = inexact(a.dtype)
    batch = a.shape[:-2]
    part, full = kw["part"], kw["full_matrices"]
    if part == 1:
        return Aval(batch + (k,), _real(dt))
    if part == 0:
        return Aval(batch + ((m, m) if full else (m, k)), dt)
    return Aval(batch + ((n, n) if full else (k, n)), dt)


@register_call("linalg.svd", _aval_svd)
def _svd(a, full_matrices=True, hermitian=False, part=1, uv=False):
    if not uv:
        with _NoTF32():
            return torch.linalg.svdvals(_work(a))

    def compute():
        with _NoTF32():
            return torch.linalg.svd(_work(a), full_matrices=full_matrices)
    return SharedResult.get(("svd", full_matrices), [a], compute)[part]


def svd(a, full_matrices=True, compute_uv=True, hermitian=False):
    kw = {"full_matrices": bool(full_matrices), "hermitian": bool(hermitian)}
    if not compute_uv:
        return lazy("linalg.svd", a, part=1, **kw)
    return SVDResult(*(lazy("linalg.svd", a, part=i, uv=True, **kw)
                       for i in range(3)))


def svdvals(a):
    return svd(a, compute_uv=False)


def _aval_eigh(kw, a):
    _refuse_half(a)
    _square("eigh", a)
    dt = inexact(a.dtype)
    if kw["part"] == 0:
        return Aval(a.shape[:-1], _real(dt))
    return Aval(a.shape, dt)


@register_call("linalg.eigh", _aval_eigh)
def _eigh(a, UPLO="L", part=0):
    def compute():
        with _NoTF32():
            return torch.linalg.eigh(_hermitian(_work(a)), UPLO=UPLO)
    return SharedResult.get(("eigh", UPLO), [a], compute)[part]


def eigh(a, UPLO=None):
    kw = {"UPLO": "L" if UPLO is None else UPLO}
    return EighResult(lazy("linalg.eigh", a, part=0, **kw),
                      lazy("linalg.eigh", a, part=1, **kw))


@register_call("linalg.eigvalsh", lambda kw, a: _aval_eigh({"part": 0}, a))
def _eigvalsh(a, UPLO="L"):
    with _NoTF32():
        return torch.linalg.eigvalsh(_hermitian(_work(a)), UPLO=UPLO)


def eigvalsh(a, UPLO="L"):
    return lazy("linalg.eigvalsh", a, UPLO=UPLO)


# -- matrix_power, matrix_rank, pinv, cond, matrix_transpose -------------------


def matrix_power(a, n):
    """Repeated squaring through the port's matmul (integers stay exact);
    ``n < 0`` inverts first."""
    from ramba_tpu_torch.ops.linalg import matmul

    a = asarray(a)
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise LinAlgError("matrix_power: the array must be square")
    n = int(n)
    if n == 0:
        import ramba_tpu_torch as rt

        eye = rt.eye(a.shape[-1], dtype=a.dtype)
        return rt.broadcast_to(eye, a.shape).copy()
    if n < 0:
        a, n = inv(a), -n
    result, base = None, a
    while n:
        if n & 1:
            result = base if result is None else matmul(result, base)
        n >>= 1
        if n:
            base = matmul(base, base)
    return result


def _aval_rank(kw, a):
    _refuse_half(a)
    if len(a.shape) < 2:
        return Aval((), np.dtype(np.int32))
    return Aval(a.shape[:-2], np.dtype(np.int64))


@register_call("linalg.matrix_rank", _aval_rank)
def _matrix_rank(a, tol=None):
    x = _work(a)
    if x.ndim < 2:
        return (x != 0).any()
    with _NoTF32():
        s = torch.linalg.svdvals(x)
    if tol is None:
        cut = s.amax(-1, keepdim=True) * max(x.shape[-2:]) * \
            torch.finfo(s.dtype).eps
    else:
        cut = torch.full((), tol, dtype=s.dtype, device=s.device)
    return (s > cut).sum(-1)


def matrix_rank(a, tol=None, *, rtol=None):
    a = asarray(a)
    if tol is not None and a.ndim < 2:
        # numpy: a 1-D input has rank 1 iff any |x| exceeds tol
        return (abs(a) > float(tol)).any().astype(np.int64)
    cut = tol if tol is not None else rtol
    return lazy("linalg.matrix_rank", a,
                **({} if cut is None else {"tol": float(cut)}))


def _aval_pinv(kw, a):
    _refuse_half(a)
    return Aval(a.shape[:-2] + (a.shape[-1], a.shape[-2]), inexact(a.dtype))


@register_call("linalg.pinv", _aval_pinv)
def _pinv(a, rtol=None, hermitian=False):
    x = _work(a)
    m, n = x.shape[-2:]
    if rtol is None:
        rtol = 10.0 * max(m, n) * float(torch.finfo(x.real.dtype
                                                    if x.is_complex()
                                                    else x.dtype).eps)
    with _NoTF32():
        u, s, vh = torch.linalg.svd(x, full_matrices=False)
        cut = rtol * s[..., :1]
        s_inv = torch.where(s > cut, 1 / s, torch.zeros_like(s)).to(x.dtype)
        return torch.matmul(vh.mH * s_inv[..., None, :], u.mH)


def pinv(a, rcond=None, hermitian=False, *, rtol=None):
    kw = {"hermitian": bool(hermitian)}
    if rtol is not None:
        kw["rtol"] = float(rtol)
    elif rcond is not None:
        kw["rtol"] = float(rcond)
    return lazy("linalg.pinv", a, **kw)


def _aval_cond(kw, x):
    _refuse_half(x)
    if len(x.shape) < 2:
        raise ValueError("cond: input array must be at least 2D")
    return Aval(x.shape[:-2], _real(x.dtype))


@register_call("linalg.cond", _aval_cond)
def _cond(x, p=None):
    y = _work(x)
    with _NoTF32():
        if p is None or p == 2:
            s = torch.linalg.svdvals(y)
            r = s[..., 0] / s[..., -1]
        elif p == -2:
            s = torch.linalg.svdvals(y)
            r = s[..., -1] / s[..., 0]
        else:
            r = torch.linalg.matrix_norm(y, ord=p) * \
                torch.linalg.matrix_norm(torch.linalg.inv_ex(y).inverse,
                                         ord=p)
    bad = torch.isnan(r) & ~torch.isnan(y).any(-1).any(-1)
    return torch.where(bad, torch.full_like(r, float("inf")), r)


def cond(x, p=None):
    return lazy("linalg.cond", x, **({} if p is None else {"p": p}))


def matrix_transpose(x):
    x = asarray(x)
    if x.ndim < 2:
        raise ValueError("matrix_transpose: the array must be at least 2-D")
    return x.swapaxes(-1, -2)


# -- multi_dot -----------------------------------------------------------------------


def multi_dot(arrays, *, out=None):
    """numpy.linalg.multi_dot: the chain of matmuls in the order of least
    cost (numpy's matrix-chain program over the static shapes); 1-D end
    operands gain and lose a unit dim."""
    from ramba_tpu_torch.ops.linalg import matmul

    arrs = [asarray(a) for a in arrays]
    if len(arrs) < 2:
        raise ValueError("Expecting at least two arrays.")
    if arrs[0].ndim not in (1, 2) or arrs[-1].ndim not in (1, 2) or any(
            a.ndim != 2 for a in arrs[1:-1]):
        raise ValueError(
            "multi_dot only supports 2d arrays (1d at the start/end)")
    front, back = arrs[0].ndim == 1, arrs[-1].ndim == 1
    if front:
        arrs[0] = arrs[0].reshape((1, arrs[0].shape[0]))
    if back:
        arrs[-1] = arrs[-1].reshape((arrs[-1].shape[0], 1))
    n = len(arrs)
    if n == 2:
        res = matmul(arrs[0], arrs[1])
    else:
        dims = [a.shape[0] for a in arrs] + [arrs[-1].shape[1]]
        cost = [[0] * n for _ in range(n)]
        split = [[0] * n for _ in range(n)]
        for ln in range(2, n + 1):
            for i in range(n - ln + 1):
                j = i + ln - 1
                cost[i][j] = float("inf")
                for k in range(i, j):
                    c = (cost[i][k] + cost[k + 1][j]
                         + dims[i] * dims[k + 1] * dims[j + 1])
                    if c < cost[i][j]:
                        cost[i][j] = c
                        split[i][j] = k

        def build(i, j):
            if i == j:
                return arrs[i]
            k = split[i][j]
            return matmul(build(i, k), build(k + 1, j))

        res = build(0, n - 1)
    if front or back:
        res = res.reshape(tuple(
            s for d, s in enumerate(res.shape)
            if not ((d == 0 and front) or (d == res.ndim - 1 and back))) or ())
    if out is not None:
        out.write_expr(res.read_expr())
        return out
    return res


# -- host boundaries (as in the reference) ------------------------------------------


def eig(a):
    return np.linalg.eig(_host(a))


def eigvals(a):
    return np.linalg.eigvals(_host(a))


def lstsq(a, b, rcond=None):
    # numpy's residuals (empty for rank-deficient systems) and Python-int
    # rank depend on the data
    return np.linalg.lstsq(_host(a), _host(b), rcond=rcond)


def tensorsolve(a, b, axes=None):
    return np.linalg.tensorsolve(_host(a), _host(b), axes=axes)


def tensorinv(a, ind=2):
    return np.linalg.tensorinv(_host(a), ind=ind)
