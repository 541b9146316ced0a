"""Compilation as a managed resource: shape-bucketed compile classes and
the persistent kernel cache.

Counterpart of ``ramba_tpu/compile/``:

* ``classes`` — the ``RAMBA_COMPILE_CLASSES`` bucket policy: leading
  dimensions of elementwise programs are zero-padded up to a small set of
  bucket sizes at flush time, so many request shapes share a handful of
  compiled programs;
* ``persist`` — the ``RAMBA_CACHE`` directory: built kernel libraries,
  checked against their digests before they load, so a second process
  pays no ``nvcc`` build for what the first one built, and the program
  skeletons another process rebuilds programs from;
* ``warmpool`` — replays ``RAMBA_TRACE`` program events through
  ``CompilePipeline.submit_warm``: each of the top-K programs is rebuilt
  from its skeleton and launched once before traffic arrives.

Submodules load lazily: ``core/fuser.py`` imports ``classes`` and
``persist`` directly, and ``warmpool`` imports the fuser, so an eager
package import here would be a cycle.
"""

__all__ = ["classes", "persist", "warmpool"]


def __getattr__(name):
    if name in __all__:
        import importlib

        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(name)
