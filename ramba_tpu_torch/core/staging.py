"""Bounded host staging between files and the device.

The JAX package reads and writes one shard at a time, so its host memory
is bounded by the largest shard (``ramba_tpu/fileio.py:50-100``,
``:212-240``).  The port has one shard per card, so it bounds host memory
by chunks instead: an array is cut into C-order boxes of at most
:data:`CHUNK_BYTES` each, and every box passes through one of two pinned
host buffers (a CUDA device) or straight into its place (the CPU).  The
two buffers alternate, so the copy of one chunk overlaps the host work on
the other.  No array stands whole in host memory on either path.

A box leaves every axis after its split axis whole and takes a run of
indices on the split axis (one index on each axis before it), so each box
is one contiguous run of the C-order array.
"""

from __future__ import annotations

import math
from typing import Callable, Iterator

import numpy as np
import torch

from ramba_tpu_torch.core.expr import tensor_to_numpy, to_torch_dtype

# The host window of one chunk; the tests lower it to exercise chunking.
CHUNK_BYTES = 64 << 20


def chunk_boxes(shape, itemsize: int, bound: int = None) -> list:
    """C-order boxes (tuples of slices) covering ``shape``, each at most
    ``bound`` bytes and one contiguous run of the C-order array."""
    bound = CHUNK_BYTES if bound is None else int(bound)
    shape = tuple(int(s) for s in shape)
    if not shape:
        return [()]
    if 0 in shape:
        return []
    # the split axis: the first one whose trailing block fits the bound
    k = 0
    while k < len(shape) - 1 and \
            math.prod(shape[k + 1:]) * itemsize > bound:
        k += 1
    row = math.prod(shape[k + 1:]) * itemsize
    step = max(1, bound // row)
    boxes = []
    for lead in np.ndindex(*shape[:k]):
        for lo in range(0, shape[k], step):
            hi = min(shape[k], lo + step)
            boxes.append(tuple(slice(i, i + 1) for i in lead)
                         + (slice(lo, hi),)
                         + tuple(slice(0, d) for d in shape[k + 1:]))
    return boxes


def box_shape(box) -> tuple:
    return tuple(s.stop - s.start for s in box)


class _Staging:
    """Two pinned host buffers of ``nbytes`` each, used in turn; an event
    per buffer says when the copy that last used it has finished."""

    def __init__(self, nbytes: int, device: torch.device):
        self.bufs = [torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
                     for _ in range(2)]
        self.events = [None, None]
        self.device = device

    def view(self, i: int, tdt: torch.dtype, shape) -> torch.Tensor:
        """Buffer ``i`` as a tensor of ``shape``, once its last copy ended."""
        if self.events[i] is not None:
            self.events[i].synchronize()
            self.events[i] = None
        n = math.prod(shape) * torch.empty((), dtype=tdt).element_size()
        return self.bufs[i][:n].view(tdt).view(shape)

    def mark(self, i: int) -> None:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self.events[i] = ev


def _staging_bytes(boxes, itemsize: int) -> int:
    return max(math.prod(box_shape(b)) for b in boxes) * itemsize


def to_host_chunks(t: torch.Tensor, bound: int = None) -> Iterator:
    """Yield ``(box, np.ndarray)`` over ``t`` in C order, each chunk at most
    ``bound`` bytes.  A chunk of a card tensor is a view of a pinned
    buffer, valid until the generator resumes; the copy of the next chunk
    runs while the caller works on this one."""
    boxes = chunk_boxes(t.shape, t.element_size(), bound)
    if t.device.type != "cuda":
        for box in boxes:
            yield box, tensor_to_numpy(t[box].contiguous())
        return
    st = _Staging(_staging_bytes(boxes, t.element_size()) if boxes else 1,
                  t.device)

    def start_copy(j):
        box = boxes[j]
        dst = st.view(j % 2, t.dtype, box_shape(box))
        dst.copy_(t[box], non_blocking=True)
        st.mark(j % 2)
        return dst

    pending = start_copy(0) if boxes else None
    for j, box in enumerate(boxes):
        cur = pending
        st.events[j % 2].synchronize()
        if j + 1 < len(boxes):
            pending = start_copy(j + 1)
        yield box, tensor_to_numpy(cur)


def from_host_chunks(shape, dtype, read_into: Callable, device,
                     bound: int = None) -> torch.Tensor:
    """A tensor of ``shape``/``dtype`` on ``device`` whose every chunk
    ``read_into(box, dst)`` writes into the NumPy array ``dst`` (the box's
    shape and dtype).  On a card ``dst`` is a pinned buffer whose copy to
    the device runs while the next chunk is read."""
    np_dt = np.dtype(dtype)
    tdt = to_torch_dtype(np_dt)
    out = torch.empty(tuple(shape), dtype=tdt, device=device)
    boxes = chunk_boxes(shape, np_dt.itemsize, bound)
    if out.device.type != "cuda":
        host = tensor_to_numpy(out)
        for box in boxes:
            # a 0-d array's only box is (): index it and NumPy returns a
            # scalar, not a view
            read_into(box, host[box] if box else host)
        return out
    st = _Staging(_staging_bytes(boxes, np_dt.itemsize) if boxes else 1,
                  out.device)
    for j, box in enumerate(boxes):
        src = st.view(j % 2, tdt, box_shape(box))
        read_into(box, tensor_to_numpy(src))
        out[box].copy_(src, non_blocking=True)
        st.mark(j % 2)
    for ev in st.events:
        if ev is not None:
            ev.synchronize()
    return out
