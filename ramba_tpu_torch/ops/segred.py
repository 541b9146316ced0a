"""segred: groupby's segment reductions through a hand-written CUDA C++ kernel.

Replaces ``ramba_tpu/ops/pallas_backend.py::_build_segred`` (its
``pl.pallas_call`` at line 532).

What it computes: a program of one ``segment_reduce`` of kind sum, prod,
min, max or count over 1-D data of length n with 1-D integer labels (the
classifier's ``segred`` branch in ``ops/kernel_backend.py``):
``out[g] = reduce_{i : labels[i] == g} data[i]`` for g < G <= 64, in the
output aval's dtype (int32 data sums in int64).  An empty group gets the
reduction's identity, labels outside ``[0, G)`` are ignored and count reads
only the labels.

Design (``csrc/segred.cuh``): one source per (kind, data dtype, accumulator
dtype, label dtype) instantiates the header's two kernels and a plain C
entry point; ``nvcc`` builds it for ``sm_90a`` into a shared library loaded
with ``ctypes`` (``_build.py``, cached by source hash).  The first kernel
keeps per-thread partials in shared memory and writes one ``(G,)`` row per
CTA, the second folds the rows in a fixed order: no atomics, so a rerun
gives the same bytes.  The grid depends only on n (:func:`num_blocks`).

Bound on the H100: HBM bandwidth, ``n * (data itemsize + label itemsize)``
bytes (labels only for count) at 3.35 TB/s.

Beside it: :func:`segred_reference`, the plain PyTorch version (group by
group, in the kernel's dtypes), and ``launches``, counted once per launch.
:func:`run` takes the plain version only for CPU tensors; on CUDA tensors
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import threading
from typing import NamedTuple

import torch

from ramba_tpu_torch import _build
from ramba_tpu_torch.core.expr import to_np_dtype, to_torch_dtype
from ramba_tpu_torch.ops import kernel_backend as kb
from ramba_tpu_torch.resilience import elastic as _elastic

launches = 0

# must match csrc/segred.cuh
THREADS = 256
MAX_BLOCKS = 132 * 8  # 8 CTAs per SM at most on the H100's 132 SMs

_CTYPE = {"float32": "float", "float64": "double", "int32": "int",
          "int64": "long long", "bool": "bool"}
_OP = {"sum": "OpSum", "prod": "OpProd", "min": "OpMin", "max": "OpMax",
       "count": "OpSum"}


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _parts(program, leaf_vals):
    """(kind, G, data, labels, accumulator torch dtype) of a segred
    program."""
    _op, (kind, num_groups, _dim), (s_data, s_labels) = program.instrs[0]
    avals = kb.all_slot_avals(program, leaf_vals)
    acc = to_torch_dtype(avals[program.n_leaves].dtype)
    return kind, int(num_groups), leaf_vals[s_data], leaf_vals[s_labels], acc


def _outputs(program, leaf_vals, out):
    return tuple(leaf_vals[s] if s < program.n_leaves else out
                 for s in program.out_slots)


def segred_reference(program, leaf_vals) -> tuple:
    """Plain PyTorch version: group by group, a masked reduce in the
    accumulator dtype (count reduces ones)."""
    kind, G, data, labels, acc = _parts(program, leaf_vals)
    red = "sum" if kind == "count" else kind
    x = (torch.ones((), dtype=acc, device=labels.device).expand(labels.shape)
         if kind == "count" else data.to(acc))
    ident = torch.full((), kb.reduce_identity_np(red, to_np_dtype(acc)).item(),
                       dtype=acc, device=x.device)
    fn = {"sum": torch.sum, "prod": torch.prod, "min": torch.amin,
          "max": torch.amax}[red]
    out = torch.stack([fn(torch.where(labels == g, x, ident))
                       for g in range(G)])
    return _outputs(program, leaf_vals, out)


# ---------------------------------------------------------------------------
# geometry and code generation
# ---------------------------------------------------------------------------


def num_blocks(n: int) -> int:
    """CTAs of the partials kernel: enough to cover n once (each thread at
    least one element), at most ``MAX_BLOCKS``.  It depends on n only."""
    return max(1, min(-(-n // THREADS), MAX_BLOCKS))


def depth(n: int) -> int:
    """The longest chain of roundings in the kernel's float sum of n
    elements: a thread's sequential fold of its elements (one per grid
    stride), the CTA's tree over THREADS partials, a fold thread's
    sequential pass over the rows and the fold's tree.  Each group's sum
    is within ``depth(n) * eps/2 * sum|x_g|`` of the exact one (first
    order).  (A product's error does not depend on the order: every one
    of its n_g - 1 roundings scales the whole product.)"""
    nb = num_blocks(n)
    levels = THREADS.bit_length() - 1
    return -(-n // (nb * THREADS)) + levels + -(-nb // THREADS) + levels


class Spec(NamedTuple):
    name: str
    source: str


def spec_for(kind: str, data_dtype, acc_dtype, label_dtype) -> Spec:
    """Generated CUDA source of one instantiation of the header's
    kernels."""
    d = _CTYPE[to_np_dtype(data_dtype).name]
    a = _CTYPE[to_np_dtype(acc_dtype).name]
    lab = _CTYPE[to_np_dtype(label_dtype).name]
    count = "true" if kind == "count" else "false"
    source = f"""// generated by ramba_tpu_torch/ops/segred.py
#include "segred.cuh"

extern "C" int ramba_segred_launch(const void* data, const void* labels,
                                   void* partials, void* out, long long n,
                                   int G, int num_blocks, void* stream) {{
  return ramba::segred::launch<{d}, {a}, {lab}, ramba::segred::{_OP[kind]}, {count}>(
      data, labels, partials, out, n, G, num_blocks, stream);
}}
"""
    digest = hashlib.sha256(source.encode()).hexdigest()[:12]
    return Spec(f"segred_{digest}", source)


def _spec(kind, data, labels, acc) -> Spec:
    # count never reads its data: one source per label dtype serves it
    return spec_for(kind, labels.dtype if kind == "count" else data.dtype,
                    acc, labels.dtype)


def program_spec(program, leaf_vals) -> Spec:
    """The source a segred program launches."""
    kind, _G, data, labels, acc = _parts(program, leaf_vals)
    return _spec(kind, data, labels, acc)


# ---------------------------------------------------------------------------
# launch
# ---------------------------------------------------------------------------

_entries: dict = {}
_lock = threading.Lock()


def _entry(spec: Spec):
    """The built kernel's C entry point (built and bound once)."""
    with _lock:
        fn = _entries.get(spec.name)
    if fn is None:
        fn = _build.load(spec.name, spec.source).ramba_segred_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        with _lock:
            _entries[spec.name] = fn
    return fn


def launch(program, leaf_vals) -> tuple:
    """Launch the kernel on CUDA leaves; returns the program's outputs."""
    global launches
    if kb.classify(program, leaf_vals) != "segred":
        raise ValueError("segred kernel: not a program the kernel takes")
    kind, G, data, labels, acc = _parts(program, leaf_vals)
    dev = labels.device
    if dev.type != "cuda" or data.device != dev:
        raise RuntimeError(f"segred kernel: operands on {dev}, expected cuda")
    if data.ndim != 1 or labels.ndim != 1 or data.shape != labels.shape \
            or not data.is_contiguous() or not labels.is_contiguous():
        raise ValueError("segred kernel: data and labels must be contiguous "
                         "1-D tensors of one length")
    n = labels.shape[0]
    nb = num_blocks(n)
    out = torch.empty(G, dtype=acc, device=dev)
    partials = torch.empty(nb * G, dtype=acc, device=dev)
    fn = _entry(_spec(kind, data, labels, acc))  # a first spec builds it
    src = labels if kind == "count" else data
    _elastic.abandon_if_cancelled("a launch")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(src.data_ptr(), labels.data_ptr(), partials.data_ptr(),
                out.data_ptr(), n, G, nb, stream)
    if rc != 0:
        raise RuntimeError(f"segred kernel launch failed: CUDA error {rc}")
    launches += 1
    return _outputs(program, leaf_vals, out)


def run(program, leaf_vals) -> tuple:
    """The wrapper.  CPU operands take the plain version; CUDA operands
    launch the kernel (or raise)."""
    dev = leaf_vals[program.instrs[0][2][1]].device  # the labels'
    if dev.type == "cpu":
        return segred_reference(program, leaf_vals)
    if dev.type != "cuda":
        raise RuntimeError(f"segred: operands on {dev}, expected cuda")
    return launch(program, leaf_vals)


kb.register_family("segred", available=kb.supports, run=run)
