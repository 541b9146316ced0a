"""NumPy protocol interop: the ``__array_function__`` dispatch registry.

Counterpart of ``ramba_tpu/core/interop.py``.  ``numpy.<fn>`` of a port
array runs the port's function registered for it here; a NumPy function
with no registration returns ``NotImplemented`` from
``ndarray.__array_function__``, so NumPy raises ``TypeError`` instead of
copying the data to the host.
"""

from __future__ import annotations

import numpy as np

HANDLED_FUNCTIONS: dict = {}


def implements(np_function):
    """Register an implementation for a NumPy function (the public
    extension point)."""

    def decorator(func):
        HANDLED_FUNCTIONS[np_function] = func
        return func

    return decorator


def isscalar(x) -> bool:
    """0-d port arrays count as scalars."""
    from ramba_tpu_torch.core.ndarray import ndarray

    if isinstance(x, ndarray):
        return x.ndim == 0
    return np.isscalar(x)


def result_type(*args):
    """NumPy's promotion, with port arrays contributing their dtype."""
    from ramba_tpu_torch.core.ndarray import ndarray

    return np.result_type(
        *[a.dtype if isinstance(a, ndarray) else a for a in args]
    )
