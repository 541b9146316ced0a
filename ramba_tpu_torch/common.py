"""Runtime configuration and device selection for ramba_tpu_torch.

The counterpart of ``ramba_tpu/common.py``: environment flags read once at
import, plus the one device every array of the process lives on.

Entry points run on ``cuda:0``.  The CPU is used only when the caller asks
for it, through :func:`set_device` or ``RAMBA_TORCH_DEVICE=cpu``; with no
card and no such request the first array creation raises, so a missing GPU
never turns silently into a CPU run.
"""

from __future__ import annotations

import os

import torch


def _env_flag(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() not in ("0", "", "false", "no", "off")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


_BYTE_SUFFIXES = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}


def parse_bytes(s) -> int:
    """Parse a byte count: a plain integer or an integer/float with a
    ``k``/``m``/``g``/``t`` suffix (binary multiples, case-insensitive,
    optional trailing ``b``/``ib``): ``"512k"`` → 524288, ``"1.5g"`` →
    1610612736.  The fault harness's ``bytes=`` payload uses it.  Raises
    ValueError on junk."""
    if isinstance(s, (int, float)):
        return int(s)
    text = str(s).strip().lower()
    if not text:
        raise ValueError("empty byte count")
    for tail in ("ib", "b"):
        if text.endswith(tail) and text[:-len(tail)][-1:] in _BYTE_SUFFIXES:
            text = text[:-len(tail)]
            break
    mult = 1
    if text[-1:] in _BYTE_SUFFIXES:
        mult = _BYTE_SUFFIXES[text[-1]]
        text = text[:-1]
    return int(float(text) * mult)


# Max pending lazy ops before a forced flush (bounds host-side graph memory).
max_pending_ops = _env_int("RAMBA_TPU_MAX_PENDING", 10_000)

# Pattern rewrites of the lazy graph at every flush (core/rewrite.py); on
# by default, as in ramba_tpu (RAMBA_TPU_REWRITE=0 turns them off).
rewrite_enabled = _env_flag("RAMBA_TPU_REWRITE", True)

# Arrays smaller than this stay whole on every shard (replicated), as in
# ramba_tpu (RAMBA_DIST_THRESHOLD).
dist_threshold = _env_int("RAMBA_DIST_THRESHOLD", 100)

_device: "torch.device | None" = None


def set_device(dev) -> torch.device:
    """Pin the device every new array is created on (``"cpu"`` or a CUDA
    device).  Arrays that already exist stay where they are."""
    global _device
    _device = torch.device(dev)
    if _device.type == "cuda" and _device.index is None:
        _device = torch.device("cuda", 0)
    return _device


def device() -> torch.device:
    """The device new arrays are created on.  Raises when no card is present
    and the CPU was not asked for."""
    if _device is not None:
        return _device
    env = os.environ.get("RAMBA_TORCH_DEVICE", "").strip()
    if env:
        return set_device(env)
    if torch.cuda.is_available():
        return set_device("cuda:0")
    raise RuntimeError(
        "ramba_tpu_torch: no CUDA device is available. Run on a GPU, or ask "
        "for the CPU explicitly with ramba_tpu_torch.common.set_device('cpu') "
        "or RAMBA_TORCH_DEVICE=cpu."
    )
