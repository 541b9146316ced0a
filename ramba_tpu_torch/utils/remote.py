"""``jit`` and ``remote``: the reference's Ray-integration extras.

Counterpart of ``ramba_tpu/utils/remote.py``:

* :func:`jit` adapts a function to port arrays: ``ndarray`` arguments
  (in lists, tuples and dicts too) are flushed and passed as their
  tensors, ``fn`` runs on them as it is, and tensor results come back as
  ``ndarray``s.  The reference wraps ``jax.jit`` here; the port compiles
  nothing, since a compiler would put generated kernels on the card's
  path beside the hand-written ones and the generic lowering.  It takes
  no keyword: ``jax.jit``'s options have nothing to act on, and an
  unknown keyword raises ``TypeError``.
* :func:`remote` gives a function or class the Ray-remote call surface
  (``.remote(...)`` returns a future, :func:`get` resolves one) over a
  host thread pool.  Work a thread launches on the card still goes to
  the card in stream order; the pool overlaps the host portions.
"""

from __future__ import annotations

import concurrent.futures
import functools
import weakref
from typing import Any

import torch

from ramba_tpu_torch.core.expr import Const
from ramba_tpu_torch.core.ndarray import ndarray


def _tree_map(fn, x):
    if isinstance(x, (list, tuple)) and not isinstance(x, ndarray):
        out = [_tree_map(fn, v) for v in x]
        return type(x)(*out) if hasattr(x, "_fields") else type(x)(out)
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    return fn(x)


def _lower_arg(a):
    return a._value() if isinstance(a, ndarray) else a


def _lift_result(r):
    if isinstance(r, torch.Tensor) and r.ndim > 0:
        return ndarray(Const(r))
    return r


def jit(fn=None, **jit_kwargs):
    """``fn`` over port arrays: ndarray arguments in, their tensors to
    ``fn``, tensor results back out as ndarrays (0-d results stay
    tensors).  Keywords raise ``TypeError``: there is no compiler to
    pass them to."""
    if jit_kwargs:
        raise TypeError(
            f"jit() got unexpected keyword argument(s) "
            f"{sorted(jit_kwargs)}: the port's jit compiles nothing")
    if fn is None:
        return jit

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        args = _tree_map(_lower_arg, args)
        kwargs = _tree_map(_lower_arg, kwargs)
        return _tree_map(_lift_result, fn(*args, **kwargs))

    wrapper._jitted = fn
    return wrapper


_pool: "concurrent.futures.ThreadPoolExecutor | None" = None


def _get_pool() -> concurrent.futures.ThreadPoolExecutor:
    global _pool
    if _pool is None:
        _pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="ramba_tpu_torch_remote")
    return _pool


class _RemoteFunction:
    """A callable with the Ray-remote call surface."""

    def __init__(self, fn):
        self._fn = fn
        functools.update_wrapper(self, fn)

    def remote(self, *args, **kwargs) -> concurrent.futures.Future:
        return _get_pool().submit(self._fn, *args, **kwargs)

    def __call__(self, *args, **kwargs):
        return self._fn(*args, **kwargs)


class _RemoteActorHandle:
    def __init__(self, cls, args, kwargs):
        self._obj = cls(*args, **kwargs)
        # an actor runs one method at a time, in submission order: one
        # worker of its own
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ramba_tpu_torch_actor")
        weakref.finalize(self, self._executor.shutdown, wait=False)

    def __getattr__(self, name):
        method = getattr(self._obj, name)
        executor = self._executor

        class _M:
            def remote(_self, *a, **kw):
                return executor.submit(method, *a, **kw)

        return _M()


class _RemoteClass:
    def __init__(self, cls):
        self._cls = cls

    def remote(self, *args, **kwargs) -> _RemoteActorHandle:
        return _RemoteActorHandle(self._cls, args, kwargs)


def remote(obj):
    """A function's or a class's Ray-remote call surface."""
    if isinstance(obj, type):
        return _RemoteClass(obj)
    return _RemoteFunction(obj)


def get(future_or_list: Any):
    """Resolve futures from :func:`remote` (the ``ray.get`` analog)."""
    if isinstance(future_or_list, (list, tuple)):
        return type(future_or_list)(get(f) for f in future_or_list)
    if isinstance(future_or_list, concurrent.futures.Future):
        return future_or_list.result()
    return future_or_list
