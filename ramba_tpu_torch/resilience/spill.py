"""Host-spill primitives: move a cold device tensor to host memory and back.

Counterpart of ``ramba_tpu/resilience/spill.py``.  The memory governor
(``resilience.memory``) decides *when* to spill; this module owns *how*.
A spilled value is a :class:`SpilledArray`: the host copy (pinned memory
when the tensor came from a card, so the copies run at the link's full
rate) and the device it came from.  The governor swaps it into the owning
``Const`` leaves, and the flush puts it back on that device on its next
touch (``fuser.leaf_value``).  The wrapper quacks enough like an array
(``shape``/``dtype``/``nbytes``/``device``/``__array__``) that host-side
readers (a rewrite reading an index leaf, diagnostics) can use it without
a device round trip.

Every copy is counted under the reference's names:
``observe.registry.comm["device_to_host_bytes"]`` when spilling,
``["host_to_device_bytes"]`` when restoring.
"""

from __future__ import annotations

import torch

from ramba_tpu_torch.core.expr import tensor_to_numpy, to_np_dtype
from ramba_tpu_torch.observe import registry as _registry


def note_transfer(direction: str, nbytes: int) -> None:
    """Count one host-boundary copy (``direction``: ``device_to_host`` or
    ``host_to_device``) in ``observe.registry.comm``."""
    with _registry.lock:
        _registry.comm[f"{direction}_bytes"] += int(nbytes)
        _registry.comm[f"{direction}_count"] += 1


class SpilledArray:
    """Host-resident stand-in for a device tensor evicted from memory.

    Sits in a ``Const.value`` slot in place of the tensor it replaced; the
    flush restores it (``resilience.memory.restore``) before the value is
    read again."""

    __slots__ = ("host", "device", "device_nbytes", "__weakref__")

    def __init__(self, host: torch.Tensor, device, device_nbytes: int):
        self.host = host
        self.device = torch.device(device)
        # the bytes the device buffer held (what eviction freed)
        self.device_nbytes = int(device_nbytes) or host_nbytes(host)

    @property
    def shape(self):
        return tuple(self.host.shape)

    @property
    def dtype(self):
        return to_np_dtype(self.host.dtype)

    @property
    def nbytes(self):
        return self.device_nbytes

    @property
    def ndim(self):
        return self.host.ndim

    def __array__(self, dtype=None, copy=None):
        a = tensor_to_numpy(self.host)
        return a.astype(dtype) if dtype is not None else a

    def __repr__(self):
        return (f"SpilledArray(shape={self.shape}, dtype={self.dtype}, "
                f"nbytes={self.device_nbytes}, device={self.device})")


def host_nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def spill_to_host(value: torch.Tensor) -> SpilledArray:
    """Device -> host: copy ``value`` out and wrap it.  The device buffer
    is freed once every reference to ``value`` is dropped (the governor
    rewrites the owning Const leaves)."""
    pin = value.device.type == "cuda"
    host = torch.empty(tuple(value.shape), dtype=value.dtype,
                       pin_memory=pin)
    host.copy_(value)
    n = host_nbytes(host)
    note_transfer("device_to_host", n)
    return SpilledArray(host, value.device,
                        value.untyped_storage().nbytes())


def restore_to_device(sp: SpilledArray) -> torch.Tensor:
    """Host -> device: a new tensor on the device the value came from."""
    out = sp.host.to(sp.device, copy=True)
    note_transfer("host_to_device", host_nbytes(sp.host))
    return out

