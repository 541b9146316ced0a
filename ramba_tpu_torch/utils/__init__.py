"""Utilities of the port: timers (``timing``), graph debug dumps
(``debug``) and the ``jit``/``remote``/``get`` call surface (``remote``).

Counterpart of ``ramba_tpu/utils/`` (its ``compat.py`` holds jax shims and
has nothing to port).
"""
