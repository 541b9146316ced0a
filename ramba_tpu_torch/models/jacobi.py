"""2-D Jacobi/Poisson relaxation on the stencil path.

Counterpart of ``ramba_tpu/models/jacobi.py``.  Each sweep is one
``sstencil``, which on the card is one launch of the CUDA stencil kernel
when every slot has one dtype (pass an f64 right-hand side: ``zeros`` is
f64, as NumPy's is).

``sstencil`` zeroes the one-cell border (cells without a full
neighborhood), which doubles as the problem's zero Dirichlet boundary —
interior updates read the boundary values before they are re-zeroed.
"""

from __future__ import annotations

_KERNELS = {}


def _kernels():
    """Module-cached stencil kernels: stable function objects let every
    jacobi2d call reuse the traced body and the built kernel."""
    if not _KERNELS:
        import ramba_tpu_torch as rt

        @rt.stencil
        def sweep(u, rhs):
            return 0.25 * (
                u[-1, 0] + u[1, 0] + u[0, -1] + u[0, 1] + rhs[0, 0]
            )

        @rt.stencil
        def lap(v):
            return (
                v[-1, 0] + v[1, 0] + v[0, -1] + v[0, 1] - 4.0 * v[0, 0]
            )

        _KERNELS["sweep"] = sweep
        _KERNELS["lap"] = lap
    return _KERNELS


def jacobi2d(f, iters: int = 100, h: float = 1.0, flush_every: int = 25,
             fused_loop: bool = False):
    """Run ``iters`` Jacobi sweeps for  -lap(u) = f  with zero boundary.

    ``f`` is the (n, n) right-hand side (array-like or port array); returns
    the port array holding the iterate.

    The default chains individual ``sstencil`` sweeps, flushing every
    ``flush_every`` sweeps so each flushed program has the same structure.
    ``fused_loop=True`` runs all sweeps as one ``sstencil_iterate`` node:
    one launch per sweep over two ping-pong buffers.
    """
    import ramba_tpu_torch as rt

    f = rt.asarray(f)
    sweep = _kernels()["sweep"]
    u = rt.zeros(f.shape)
    scaled = f * (h * h)
    rt.sync()
    if fused_loop:
        return rt.sstencil_iterate(sweep, u, iters, scaled)
    for i in range(iters):
        u = rt.sstencil(sweep, u, scaled)
        if flush_every and (i + 1) % flush_every == 0:
            rt.flush()
    return u


def residual(u, f, h: float = 1.0) -> float:
    """Max-norm interior residual  | f + lap(u) |."""
    import ramba_tpu_torch as rt

    u = rt.asarray(u)
    f = rt.asarray(f)
    r = rt.sstencil(_kernels()["lap"], u) / (h * h) + f
    # exclude the boundary ring (sstencil already zeroes it for lap, but
    # f is nonzero there)
    return float(rt.max(rt.abs(r[1:-1, 1:-1])))
