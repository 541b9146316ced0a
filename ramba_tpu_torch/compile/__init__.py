"""Compilation as a managed resource: shape-bucketed compile classes and
the persistent kernel cache.

Counterpart of ``ramba_tpu/compile/``:

* ``classes`` — the ``RAMBA_COMPILE_CLASSES`` bucket policy: leading
  dimensions of elementwise programs are zero-padded up to a small set of
  bucket sizes at flush time, so many request shapes share a handful of
  compiled programs;
* ``persist`` — the ``RAMBA_CACHE`` directory: built kernel libraries,
  checked against their digests before they load, so a second process
  pays no ``nvcc`` build for what the first one built.

The warm pool (``warmpool``) comes with the serving queue.  Submodules
load lazily: ``core/fuser.py`` imports ``classes`` directly, and an
eager package import here would be a cycle.
"""

__all__ = ["classes", "persist"]


def __getattr__(name):
    if name in __all__:
        import importlib

        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(name)
