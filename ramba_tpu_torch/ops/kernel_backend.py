"""Hand-kernel lowering backend for fused programs.

Counterpart of ``ramba_tpu/ops/pallas_backend.py``: a registry of named
kernel families and the classifier that decides which fused programs the
hand-written kernels take.  Families:

* **elemred** — fused elementwise(+cast/round) chains over 1-D operands,
  optionally ending in whole-array ``sum/prod/min/max/mean`` reductions
  (``ops/elemred.py``, a CUDA C++ kernel generated per program);
* **segred** — masked segment reductions (groupby) over 1-D data with
  integer labels (``ops/segred.py``, CUDA C++);
* **stencil** — the 2-D stencil kernel (``ops/stencil_kernel.py``, CUDA
  C++), reached from ``skeletons._eval_stencil``.

The classifier keeps the JAX package's rules (1-D operands of one length,
at most 64 instructions, reduce results feed nothing, scalar compute
outputs stay on the generic lowering) with GPU-specific dtype rules: every
slot must be float32, float64, int32, int64 or bool.  There is no 128-lane
rule: the kernel masks its ragged tail.  Integer ``power``, integer
``reciprocal``, integer ``round`` to negative decimals and min/max over bool
stay on the generic lowering (the kernel has no exact form for them yet).
A segred program is one ``segment_reduce`` of a kind in ``SEG_OK`` over a
1-D leaf along dim 0, with 1-D int32/int64 labels and 1 <= G <= 64 groups,
its data in the same GPU dtypes (no min/max over bool); the ragged tail is
masked in the kernel.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

import numpy as np
import torch

from ramba_tpu_torch.core.expr import MAPFN, aval_of, infer_aval, map_dtypes
from ramba_tpu_torch.resilience import faults as _faults

# ---------------------------------------------------------------------------
# kernel-family registry
# ---------------------------------------------------------------------------


class KernelFamily:
    """One named kernel family: an ``available(...)`` eligibility predicate
    and a ``run(...)`` entry point (family-specific signature)."""

    __slots__ = ("name", "available", "run")

    def __init__(self, name: str, available: Callable, run: Callable):
        self.name = name
        self.available = available
        self.run = run


_families: "dict[str, KernelFamily]" = {}
_families_lock = threading.Lock()
_builtins_loaded = False


def register_family(name: str, *, available: Callable, run: Callable) -> None:
    with _families_lock:
        _families[name] = KernelFamily(name, available, run)


def _ensure_builtins() -> None:
    global _builtins_loaded
    if _builtins_loaded:
        return
    _builtins_loaded = True
    from ramba_tpu_torch.ops import elemred, segred, stencil_kernel  # noqa: F401


def family(name: str) -> Optional[KernelFamily]:
    _ensure_builtins()
    with _families_lock:
        return _families.get(name)


# ---------------------------------------------------------------------------
# program classification
# ---------------------------------------------------------------------------

# Homogeneous-dtype ufuncs the elemred kernel evaluates per block (the JAX
# package's set).
ELEM_OK = frozenset({
    "add", "subtract", "multiply", "true_divide", "divide", "floor_divide",
    "mod", "remainder", "power", "maximum", "minimum", "fmax", "fmin",
    "arctan2", "hypot", "copysign", "logaddexp", "logaddexp2",
    "equal", "not_equal", "less", "less_equal", "greater", "greater_equal",
    "logical_and", "logical_or", "logical_xor",
    "negative", "positive", "absolute", "abs", "fabs", "sqrt", "square",
    "reciprocal", "sign", "exp", "exp2", "expm1", "log", "log2", "log10",
    "log1p", "sin", "cos", "tan", "sinh", "cosh", "tanh",
    "arcsin", "arccos", "arctan", "arcsinh", "arccosh", "arctanh",
    "floor", "ceil", "trunc", "rint",
    "isnan", "isinf", "isfinite", "logical_not", "where",
})

RED_OK = frozenset({"sum", "prod", "min", "max", "mean"})
SEG_OK = frozenset({"sum", "prod", "min", "max", "count"})

GPU_DTYPES = frozenset({"float32", "float64", "int32", "int64", "bool"})

MAX_ELEM_INSTRS = 64
MAX_SEG_GROUPS = 64
SEG_LABEL_DTYPES = frozenset({"int32", "int64"})

_INT_ONLY_GENERIC = frozenset({"power", "reciprocal"})


def _leaf_shape(v) -> tuple:
    return tuple(getattr(v, "shape", ()) or ())


def vector_length(leaf_vals) -> Optional[int]:
    """Common 1-D length of the array leaves, or None when the leaf set
    doesn't fit the blocked 1-D kernel."""
    n = None
    for v in leaf_vals:
        shp = _leaf_shape(v)
        if shp == ():
            continue
        if len(shp) != 1:
            return None
        if n is None:
            n = int(shp[0])
        elif int(shp[0]) != n:
            return None
    if not n:
        return None
    return n


def all_slot_avals(program, leaf_vals) -> list:
    """Aval of every leaf and every intermediate, from the port's rule
    table — the cast plan the kernel is generated from."""
    avals = [aval_of(v) for v in leaf_vals]
    for op, static, argslots in program.instrs:
        avals.append(infer_aval(op, static, [avals[s] for s in argslots]))
    return avals


def map_cast_plan(fname, arg_avals):
    """(per-arg cast dtypes | None, output dtype) of one ``map``: NumPy's
    NEP-50 loop dtypes, as ``expr.apply_map`` computes with."""
    casts, out = map_dtypes(fname, arg_avals)
    return tuple(None if d is None else np.dtype(d) for d in casts), np.dtype(out)


def reduce_identity_np(op: str, dtype):
    """Identity element of a reduction as a numpy scalar."""
    dt = np.dtype(dtype)
    if op in ("sum", "mean"):
        return np.zeros((), dt)[()]
    if op == "prod":
        return np.ones((), dt)[()]
    if dt == np.dtype(bool):
        return np.asarray(op == "min", dt)[()]
    if np.issubdtype(dt, np.inexact):
        return np.asarray(np.inf if op == "min" else -np.inf, dt)[()]
    info = np.iinfo(dt)
    return np.asarray(info.max if op == "min" else info.min, dt)[()]


def _classify_segred(program, leaf_vals) -> Optional[str]:
    _op, (kind, num_groups, dim), (s_data, s_labels) = program.instrs[0]
    if (kind not in SEG_OK or dim != 0
            or not 1 <= int(num_groups) <= MAX_SEG_GROUPS
            or s_data >= program.n_leaves or s_labels >= program.n_leaves):
        return None
    data, labels = leaf_vals[s_data], leaf_vals[s_labels]
    if len(_leaf_shape(data)) != 1 or len(_leaf_shape(labels)) != 1:
        return None
    dt, lt = aval_of(data).dtype, aval_of(labels).dtype
    if dt.name not in GPU_DTYPES or lt.name not in SEG_LABEL_DTYPES:
        return None
    if kind in ("min", "max") and dt.kind == "b":
        return None
    return "segred"


def classify(program, leaf_vals) -> Optional[str]:
    """Kernel family this fused program lowers to (``"elemred"`` or
    ``"segred"``), or None when only the generic lowering applies."""
    instrs = program.instrs
    if not instrs or len(leaf_vals) != program.n_leaves:
        return None
    if vector_length(leaf_vals) is None:
        return None
    if len(instrs) == 1 and instrs[0][0] == "segment_reduce":
        return _classify_segred(program, leaf_vals)
    if len(instrs) > MAX_ELEM_INSTRS:
        return None
    n_leaves = program.n_leaves
    is_vec = [len(_leaf_shape(v)) == 1 for v in leaf_vals]
    reduce_slots = set()
    any_vec_instr = False
    for i, (op, static, argslots) in enumerate(instrs):
        slot = n_leaves + i
        if any(s in reduce_slots for s in argslots):
            return None  # reduce results must not feed later instructions
        if op == "map":
            (fname,) = static
            if fname not in ELEM_OK or fname not in MAPFN:
                return None
            is_vec.append(any(is_vec[s] for s in argslots))
        elif op in ("cast", "round"):
            is_vec.append(is_vec[argslots[0]])
        elif op == "reduce":
            fname, axis, keepdims, _ddof = static
            if fname not in RED_OK or axis is not None or keepdims:
                return None
            if not is_vec[argslots[0]]:
                return None
            reduce_slots.add(slot)
            is_vec.append(False)
            any_vec_instr = True
        else:
            return None
        if op in ("map", "cast", "round") and is_vec[-1]:
            any_vec_instr = True
    if not any_vec_instr:
        return None
    for s in program.out_slots:
        if s >= n_leaves and not is_vec[s] and s not in reduce_slots:
            return None  # scalar compute outputs stay on the generic lowering
    avals = all_slot_avals(program, leaf_vals)
    if any(a.dtype.name not in GPU_DTYPES for a in avals):
        return None
    for op, static, argslots in instrs:
        arg_avals = [avals[s] for s in argslots]
        if op == "map":
            casts, _out = map_cast_plan(static[0], arg_avals)
            if any(d is not None and d.name not in GPU_DTYPES for d in casts):
                return None
            if static[0] in _INT_ONLY_GENERIC and any(
                    d is not None and d.kind in "biu" for d in casts):
                return None
        elif op == "round" and arg_avals[0].dtype.kind != "f" \
                and int(static[0]) < 0:
            return None
        elif op == "reduce" and static[0] in ("min", "max") \
                and arg_avals[0].dtype.kind == "b":
            return None
    return "elemred"


def supports(program, leaf_vals) -> bool:
    return classify(program, leaf_vals) is not None


def libraries(program, leaf_vals) -> list:
    """``[(name, source)]`` of the kernel libraries a launch of this
    program on these leaves loads (the persistent cache's entries,
    ``compile/persist.py``).  Empty for a program only the generic
    lowering takes, and on the CPU, where the plain versions run."""
    name = classify(program, leaf_vals)
    if name is None or not any(isinstance(v, torch.Tensor)
                               and v.device.type == "cuda"
                               for v in leaf_vals):
        return []
    if name == "elemred":
        from ramba_tpu_torch.ops import elemred

        plan = elemred.plan_for(program, leaf_vals)
        return [(plan.name, plan.source)]
    from ramba_tpu_torch.ops import segred

    spec = segred.program_spec(program, leaf_vals)
    return [(spec.name, spec.source)]


_KERNEL_OPS = frozenset({"stencil", "stencil_iter", "cumulative"})


def program_cost(program, leaf_vals) -> Optional[tuple]:
    """``(flops, bytes)`` of one run of a program as the kernel families
    count them from their own plans (each family's ``cost``), or None
    when no hand-written kernel runs any of its instructions: the
    generic lowering records bytes only.  A program elemred or segred
    takes is that family's count.  Otherwise each instruction the
    stencil kernel or the scan takes adds its family's count, and every
    other instruction of such a program adds the bytes of its operands
    and its result (no flops)."""
    name = classify(program, leaf_vals)
    if name == "elemred":
        from ramba_tpu_torch.ops import elemred

        return elemred.cost(program, leaf_vals)
    if name == "segred":
        from ramba_tpu_torch.ops import segred

        return segred.cost(program, leaf_vals)
    if not any(op in _KERNEL_OPS for op, _s, _a in program.instrs):
        return None
    from ramba_tpu_torch.compile.classes import slot_avals
    from ramba_tpu_torch.ops import scan, stencil_kernel

    avals = slot_avals(program, [aval_of(v) for v in leaf_vals])
    if avals is None:
        return None
    flops = nbytes = 0.0
    counted = False
    for i, (op, static, args) in enumerate(program.instrs):
        out = avals[program.n_leaves + i]
        ins = [avals[s] for s in args]
        got = None
        if op in ("stencil", "stencil_iter"):
            func, lo, hi, slots = static[:4]
            sweeps = static[5] if op == "stencil_iter" else 1
            if op == "stencil_iter":  # the carry runs in the result dtype
                ins = [out] + ins[1:]
            if sweeps > 0:
                got = stencil_kernel.cost(func, lo, hi, slots, ins, sweeps)
        elif op == "cumulative" and out.dtype.kind == "f" \
                and out.dtype.itemsize >= 2:
            got = scan.cost(out.shape, out.dtype.itemsize)
        if got is not None:
            counted = True
            flops += got[0]
            nbytes += got[1]
        else:
            nbytes += sum(_nbytes(a) for a in ins) + _nbytes(out)
    return (flops, nbytes) if counted else None


def _nbytes(aval) -> int:
    n = 1
    for d in aval.shape:
        n *= int(d)
    return n * np.dtype(aval.dtype).itemsize


# ---------------------------------------------------------------------------
# entry point: program -> kernel-backed callable
# ---------------------------------------------------------------------------


def lower_program(program, leaf_vals) -> Optional[Callable]:
    """Kernel lowering of a fused program, or None when no kernel family
    matches.  The callable has the signature and outputs of
    ``fuser._build_callable(program)``."""
    name = classify(program, leaf_vals)
    if name is None:
        return None
    # the fused rung's kernel fault site (the reference's ``pallas``): an
    # injected fault fails the rung like any other; nothing swaps to the
    # generic lowering
    _faults.check("kernel", family=name, instrs=len(program.instrs))
    fam = family(name)

    def run(*vals):
        return fam.run(program, vals)

    return run

