"""stencil: 2-D stencils through a hand-written CUDA C++ kernel.

Replaces ``ramba_tpu/ops/stencil_pallas.py::_run_fast`` (its
``pl.pallas_call`` at line 261) and ``::_run_padded`` (line 370) with one
kernel, ``csrc/stencil_tile.cuh``, that takes every shape both took: the
TPU's (8, 128) tiling rule that split them does not exist on Hopper, and
the kernel zero-fills its edge loads instead.

The Pallas kernel traced the user's Python body inside the kernel.  A CUDA
kernel cannot call Python, so the body is first traced here with symbolic
taps (:func:`trace`, the offset probe extended to record arithmetic) into a
tap expression: taps ``(slot, di, dj)``, literals, ``+ - * / **``, unary
minus, the NumPy ufuncs a body may call, and the comparisons and ``where``
that the two-sided branch trace produces.  Each operation is typed by the
port's NumPy rule table and emitted as C++ with explicit casts into the
body of the kernel template (``ops/cuda_expr.py``, the emitter elemred
shares); ``nvcc`` builds it for ``sm_90a`` into a
shared library with a plain C entry point, loaded with ``ctypes`` and
cached by the hash of its source.

Bound on the H100: HBM bandwidth, ``(slots + 1) * H * W * itemsize`` bytes
at 3.35 TB/s.  The kernel is built to stream at that rate: a persistent
grid (as many CTAs as the card holds at once) walks down column strips of
``TW`` outputs in row blocks of ``BH``, and each CTA keeps a ring of
``stages`` shared-memory stages, each holding one tile plus its halo for
every slot, so the loads of the next tiles are in flight while it computes
the current one (the TPU kernel's double-buffered slab DMA, deeper).  The
header says how.  Everything about the launch except the occupancy is
decided here, in Python, where the CPU tests reach it:

* :func:`geometry` picks ``(TW, BH, stages)`` per (itemsize, slots, halo)
  within :data:`SMEM_LIMIT`, with two CTAs per SM where that fits;
* :func:`schedule`, :func:`tile_range` and :func:`tile_rect` mirror the
  kernel's schedule (each strip cut into the same number of runs of row
  blocks, CTA ``b`` on run ``b // strips`` of strip ``b % strips``);
* :func:`load_path` picks the stage's load path before the launch: ``tma``
  (one ``cp.async.bulk.tensor`` box per slot and stage; row stride a
  multiple of 16 bytes, 16-byte aligned bases), else ``cpasync``
  (4- or 8-byte ``cp.async`` copies that zero-fill cells outside the
  array), else, for bfloat16 rows that are not 4-byte aligned, ``ldst``
  (plain loads: ``cp.async`` has no 2-byte copy).  Each is counted in
  ``launches_tma``, ``launches_cpasync``, ``launches_ldst`` beside
  ``launches``.  A failed encode or launch raises; no path gives way to
  another or to the plain version.

Eligibility (:func:`available`) is decided before anything launches: a 2-D
array with sides below 2^31 (the TMA's coordinates are 32-bit), one dtype
for every slot from {float32, float64, bfloat16}, a halo of at most
``MAX_HALO`` cells on each side, a body the tracer expresses whose result
has the slots' dtype.  Anything else runs on the shifted-slice path of
``skeletons.py``; bodies and halos turned away are counted in
``ineligible``.

Beside it: :func:`stencil_reference`, the plain PyTorch version (the
shifted-slice evaluation plus the zeroed border), and ``launches``, counted
once per kernel launch.  :func:`run` takes the plain version only for CPU
tensors; on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from ramba_tpu_torch import _build
from ramba_tpu_torch.core import expr as E
from ramba_tpu_torch.ops import cuda_expr as cx
from ramba_tpu_torch.ops import kernel_backend as kb
from ramba_tpu_torch.resilience import elastic as _elastic
from ramba_tpu_torch.skeletons import (
    KernelTraceError, _combine_branches, _explore_branches, decide,
    shifted_slice_stencil,
)

launches = 0
launches_tma = 0
launches_cpasync = 0
launches_ldst = 0
ineligible = 0

MAX_HALO = 16
MAX_SIDE = 2 ** 31  # the TMA's coordinates are 32-bit
SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
SM_SMEM = 233472  # bytes of shared memory on one H100 SM (228 KB)
CTA_RESERVED = 1024  # of which the runtime keeps this much per CTA
NT = 256  # threads per CTA (csrc/stencil_tile.cuh)
MAX_BOX = 256  # the longest side of one TMA box
# the kernel's PATH_* codes, in order
PATHS = ("tma", "cpasync", "ldst")
# the widest strip: 128 output columns (a row of 512 bytes of f32, 1 KB of
# f64); wider strips were no faster once the CTAs walk the same rows
# together, and narrower ones are slower (scripts/stencil_sweep.py; PERF.md)
TW_MAX = 128

_KERNEL_DTYPES = ("float32", "float64", "bfloat16")


# ---------------------------------------------------------------------------
# tracer: stencil body -> tap expression
# ---------------------------------------------------------------------------

# ufuncs the code generator emits (everything else makes a body opaque)
_OTHER = frozenset({
    "add", "subtract", "multiply", "true_divide", "floor_divide", "mod",
    "remainder", "maximum", "minimum", "logical_and", "logical_or",
    "logical_xor", "logical_not", "negative", "positive", "absolute", "abs",
    "fabs", "square", "sign", "isnan", "isinf", "isfinite", "where",
    "bitwise_and", "bitwise_or", "bitwise_xor", "invert",
})
SUPPORTED = (frozenset(cx.UNARY_C) | frozenset(cx.BINARY_C) | frozenset(cx.CMP)
             | _OTHER)


class Sym:
    """A symbolic value of a stencil body: a tap ``(slot, di, dj)``, a
    literal, an operation over other values, or ``opaque`` (something the
    code generator cannot express; it absorbs everything it touches, so the
    probe still records the offsets)."""

    __slots__ = ("kind", "arg", "args")

    def __init__(self, kind, arg=None, args=()):
        self.kind = kind
        self.arg = arg
        self.args = tuple(args)

    def __bool__(self):
        return decide(self)

    def __float__(self):
        raise KernelTraceError(
            "stencil body converts a per-point value to a Python float")

    def __int__(self):
        raise KernelTraceError(
            "stencil body converts a per-point value to a Python int")

    __index__ = __int__
    __hash__ = object.__hash__

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        name = {"divide": "true_divide"}.get(ufunc.__name__, ufunc.__name__)
        if method != "__call__" or kwargs:
            return _OPAQUE
        return sym_map(name, *inputs)

    def __array_function__(self, func, types, args, kwargs):
        if func is np.where and len(args) == 3 and not kwargs:
            return sym_map("where", *args)
        if func is np.clip and not kwargs:
            x, lo, hi = (list(args) + [None, None])[:3]
            if lo is not None:
                x = sym_map("maximum", x, lo)
            if hi is not None:
                x = sym_map("minimum", x, hi)
            return x
        return _OPAQUE

    def __getitem__(self, idx):
        return _OPAQUE

    def __repr__(self):
        if self.kind == "tap":
            return f"tap{self.arg}"
        if self.kind == "lit":
            return repr(self.arg)
        if self.kind == "op":
            return f"{self.arg}({', '.join(map(repr, self.args))})"
        return "opaque"


_OPAQUE = Sym("opaque")


def _lift(x) -> Sym:
    if isinstance(x, Sym):
        return x
    if isinstance(x, (bool, int, float, np.bool_, np.integer, np.floating)):
        return Sym("lit", x)
    return _OPAQUE


def sym_map(fname, *operands) -> Sym:
    args = [_lift(o) for o in operands]
    if fname not in SUPPORTED or any(a.kind == "opaque" for a in args):
        return _OPAQUE
    if fname == "power" and args[1].kind == "lit":
        e = args[1].arg
        if (isinstance(e, (int, np.integer))
                and not isinstance(e, (bool, np.bool_)) and 1 <= int(e) <= 4):
            # a multiply chain, as the shifted-slice path and jnp compute it
            out = args[0]
            for _ in range(int(e) - 1):
                out = Sym("op", "multiply", (out, args[0]))
            return out
    return Sym("op", fname, args)


def _install_sym_ops():
    binops = {
        "add": "add", "sub": "subtract", "mul": "multiply",
        "truediv": "true_divide", "floordiv": "floor_divide", "mod": "mod",
        "pow": "power", "and": "bitwise_and", "or": "bitwise_or",
        "xor": "bitwise_xor", "lt": "less", "le": "less_equal",
        "gt": "greater", "ge": "greater_equal", "eq": "equal",
        "ne": "not_equal",
    }
    for name, fname in binops.items():
        def fwd(self, other, _f=fname):
            return sym_map(_f, self, other)

        def rev(self, other, _f=fname):
            return sym_map(_f, other, self)

        setattr(Sym, f"__{name}__", fwd)
        if name not in ("lt", "le", "gt", "ge", "eq", "ne"):
            setattr(Sym, f"__r{name}__", rev)
    for name, fname in {"neg": "negative", "pos": "positive",
                        "abs": "absolute", "invert": "invert"}.items():
        def un(self, _f=fname):
            return sym_map(_f, self)

        setattr(Sym, f"__{name}__", un)


_install_sym_ops()


class _TapProxy:
    def __init__(self, slot):
        self.slot = slot
        self.offsets = []

    def __getitem__(self, off):
        if not isinstance(off, tuple):
            off = (off,)
        off = tuple(int(o) for o in off)
        self.offsets.append(off)
        return Sym("tap", (self.slot,) + off)


class Trace(NamedTuple):
    lo: tuple
    hi: tuple
    taps: int
    expr: Optional[Sym]  # None when the body is not expressible


_trace_cache: dict = {}
_TRACE_CACHE_MAX = 64
_lock = threading.Lock()


def trace(func, slots) -> Trace:
    """Run the body once per branch path over symbolic taps: its
    neighbourhood ``(lo, hi)``, its tap count and its tap expression."""
    key = (func, tuple(slots))
    with _lock:
        hit = _trace_cache.get(key)
    if hit is not None:
        return hit
    proxies, call_args = [], []
    for kind, payload in slots:
        if kind == "arr":
            p = _TapProxy(payload)
            proxies.append(p)
            call_args.append(p)
        else:
            call_args.append(payload.v)
    leaves = _explore_branches(lambda: func(*call_args))
    offs = [o for p in proxies for o in p.offsets]
    nd = len(offs[0]) if offs else 1
    lo = tuple(min(0, *(o[d] for o in offs)) if offs else 0 for d in range(nd))
    hi = tuple(max(0, *(o[d] for o in offs)) if offs else 0 for d in range(nd))
    expr = _lift(_combine_branches(
        leaves, lambda c, t, f: sym_map("where", c, t, f)))
    tr = Trace(lo, hi, len(offs), None if _is_opaque(expr) else expr)
    with _lock:
        if len(_trace_cache) >= _TRACE_CACHE_MAX:
            _trace_cache.pop(next(iter(_trace_cache)))
        _trace_cache[key] = tr
    return tr


def _is_opaque(e: Sym) -> bool:
    stack, seen = [e], set()
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        if n.kind == "opaque":
            return True
        stack.extend(n.args)
    return False


def eval_taps(expr: Sym, lo, hi, arrs) -> torch.Tensor:
    """Evaluate a tap expression over the interior with torch, the way the
    kernel computes it (each bfloat16 operation in float, rounded to
    bfloat16), and place it into a zero border.  Checks the tracer against
    the plain version without a card."""
    dt = arrs[0].dtype
    work = arrs
    shape = tuple(arrs[0].shape)
    interior = tuple(s - (h - l) for s, l, h in zip(shape, lo, hi))
    memo: dict = {}

    def ev(n):
        if id(n) in memo:
            return memo[id(n)]
        if n.kind == "tap":
            slot, *off = n.arg
            v = work[slot][tuple(slice(o - l, o - l + k)
                                 for o, l, k in zip(off, lo, interior))]
        elif n.kind == "lit":
            v = n.arg
        else:
            v = E.apply_map(n.arg, [ev(a) for a in n.args])
        memo[id(n)] = v
        return v

    val = E.as_tensor(ev(expr), dev=arrs[0].device).expand(interior).to(dt)
    out = torch.zeros(shape, dtype=dt, device=arrs[0].device)
    out[tuple(slice(-l, -l + k) for l, k in zip(lo, interior))] = val
    return out


# ---------------------------------------------------------------------------
# geometry, schedule and load path (mirrors csrc/stencil_tile.cuh)
# ---------------------------------------------------------------------------


class Geometry(NamedTuple):
    """One kernel's tiling: output tiles ``bh`` x ``tw``, ``stages`` ring
    stages of ``sh`` x ``sw`` cells per slot (the TMA box), ``smem`` bytes
    of shared memory per CTA, built for ``min_ctas`` CTAs per SM."""
    tw: int
    bh: int
    stages: int
    sw: int
    sh: int
    smem: int
    min_ctas: int


def ring(itemsize, n_slots, top, bottom, left, right, tw, bh, stages,
         min_ctas=1) -> Geometry:
    """The stage layout ``Ring<>`` computes: a staged row is the tile's
    width plus the halo, widened so that it starts and ends on 16-byte
    boundaries (the TMA faults on a box whose rows start elsewhere); each
    slot's buffer starts on 128 bytes; one 8-byte mbarrier per stage."""
    align = 16 // itemsize
    lpad = -(-left // align) * align
    sw = -(-(tw + lpad + right) // align) * align
    sh = bh + top + bottom
    slot = -(-(sh * sw * itemsize) // 128) * 128
    smem = stages * n_slots * slot + 8 * stages
    return Geometry(tw, bh, stages, sw, sh, smem, min_ctas)


def geometry(itemsize, n_slots, top, bottom, left, right) -> Optional[Geometry]:
    """``(TW, BH, stages)`` for this (itemsize, slots, halo): the widest
    strip up to :data:`TW_MAX`, then the tallest block, then the deepest
    ring (4 to 2 stages) whose shared memory lets two CTAs share an SM;
    failing that, one CTA per SM within :data:`SMEM_LIMIT`.  None when
    nothing fits."""
    for min_ctas in (2, 1):
        cap = min(SMEM_LIMIT, SM_SMEM // min_ctas - CTA_RESERVED)
        tw = TW_MAX
        while tw >= 8:
            for bh in (32, 16, 8, 4, 2, 1):
                for stages in (4, 3, 2):
                    g = ring(itemsize, n_slots, top, bottom, left, right, tw,
                             bh, stages, min_ctas)
                    if g.smem <= cap and g.sw <= MAX_BOX and g.sh <= MAX_BOX:
                        return g
            tw //= 2
    return None


def n_tiles(H, W, geo: Geometry) -> int:
    """Output tiles of an H x W array: row blocks times column strips."""
    return -(-H // geo.bh) * -(-W // geo.tw)


def schedule(H, W, geo: Geometry, resident: int) -> tuple:
    """``(grid, runs)`` for ``resident`` CTAs on the card at once: every
    strip cut into ``runs`` runs of row blocks, one CTA per run, so that
    the CTAs on the card together walk the same rows of neighbouring
    strips; with more strips than CTAs, ``runs`` is 0 and the grid takes
    equal runs of the strip-major order (:func:`tile_range`)."""
    n_rb, n_strips = -(-H // geo.bh), -(-W // geo.tw)
    if n_strips <= resident:
        runs = min(resident // n_strips, n_rb)
        return n_strips * runs, runs
    return min(resident, n_rb * n_strips), 0


def tile_range(b: int, grid: int, runs: int, H, W, geo: Geometry) -> tuple:
    """The tiles CTA ``b`` computes, ``[t0, t1)`` in the strip-major
    numbering of :func:`tile_rect`: run ``b // strips`` of strip
    ``b % strips``, or with ``runs`` 0 its equal share of the order."""
    n_rb, n_strips = -(-H // geo.bh), -(-W // geo.tw)
    if runs:
        strip, run = b % n_strips, b // n_strips
        rb0, rb1 = run * n_rb // runs, (run + 1) * n_rb // runs
        return strip * n_rb + rb0, strip * n_rb + rb1
    tiles = n_rb * n_strips
    return b * tiles // grid, (b + 1) * tiles // grid


def tile_rect(t: int, H, W, geo: Geometry) -> tuple:
    """Output rows ``[r0, r1)`` and columns ``[c0, c1)`` of tile ``t``;
    tiles are numbered down each column strip, strip after strip."""
    n_rb = -(-H // geo.bh)
    r0, c0 = (t % n_rb) * geo.bh, (t // n_rb) * geo.tw
    return r0, min(r0 + geo.bh, H), c0, min(c0 + geo.tw, W)


def load_path(geo: Geometry, H, W, itemsize, ptrs) -> str:
    """How the stages are filled, decided before the launch.  ``tma``: a
    box the TMA can describe (sides at most 256, inner extent a multiple
    of 16 bytes), a row stride that is a multiple of 16 bytes and 16-byte
    aligned base pointers.  Otherwise ``cpasync``, except for bfloat16
    rows whose cells are not 4-byte aligned (odd width or base), which
    take ``ldst``."""
    box_ok = (geo.sw <= MAX_BOX and geo.sh <= MAX_BOX
              and (geo.sw * itemsize) % 16 == 0)
    if box_ok and (W * itemsize) % 16 == 0 and all(p % 16 == 0 for p in ptrs):
        return "tma"
    if itemsize == 2 and (W % 2 or any(p % 4 for p in ptrs)):
        return "ldst"
    return "cpasync"


# ---------------------------------------------------------------------------
# code generation: tap expression -> CUDA C++ body
# ---------------------------------------------------------------------------

_STORAGE = {"float32": "float", "float64": "double",
            "bfloat16": "__nv_bfloat16"}


class Spec(NamedTuple):
    name: str
    source: str
    n_slots: int
    geometry: Geometry


_spec_cache: dict = {}
_SPEC_CACHE_MAX = 256


def spec_for(expr: Sym, lo, hi, n_slots: int, dtype) -> Optional[Spec]:
    """Generated CUDA source for this body on ``n_slots`` slots of
    ``dtype``, or None when the kernel cannot take it."""
    dtype = E.to_np_dtype(dtype)
    key = (id(expr), tuple(lo), tuple(hi), n_slots, str(dtype))
    hit = _spec_cache.get(key)
    if hit is not None and hit[0] is expr:
        return hit[1]
    spec = _make_spec(expr, lo, hi, n_slots, dtype)
    with _lock:
        if len(_spec_cache) >= _SPEC_CACHE_MAX:
            _spec_cache.pop(next(iter(_spec_cache)))
        _spec_cache[key] = (expr, spec)
    return spec


def _make_spec(expr, lo, hi, n_slots, dtype) -> Optional[Spec]:
    name = cx.dtype_name(dtype)
    if expr is None or name not in _KERNEL_DTYPES or len(lo) != 2:
        return None
    top, left = -lo[0], -lo[1]
    bottom, right = hi[0], hi[1]
    if max(top, bottom, left, right) > MAX_HALO:
        return None
    itemsize = 2 if name == "bfloat16" else np.dtype(dtype).itemsize
    geo = geometry(itemsize, n_slots, top, bottom, left, right)
    if geo is None:
        return None
    try:
        code, av, lit = cx.Gen(dtype).node(expr)
    except cx.Unsupported:
        return None
    if code is None or cx.dtype_name(av.dtype) != name:
        return None  # a literal body, or a result in another dtype
    ct, st = cx.CTYPE[name], _STORAGE[name]
    args = (f"{st}, {n_slots}, {top}, {bottom}, {left}, {right}, "
            f"{geo.tw}, {geo.bh}, {geo.stages}, {geo.min_ctas}, Body")
    source = f"""// generated by ramba_tpu_torch/ops/stencil_kernel.py
#include "stencil_tile.cuh"

struct Body {{
  template <class S>
  __device__ __forceinline__ static {ct} eval(const S& s) {{
    return {code};
  }}
}};

// ring: {geo.bh} x {geo.tw} output tiles, {geo.stages} stages of
// {geo.sh} x {geo.sw} cells per slot, {geo.smem} bytes of shared memory
extern "C" int ramba_stencil_launch(int path, const void* const* ins,
                                    void* out, long long H, long long W,
                                    void* stream) {{
  return ramba::launch_stencil<{args}>(path, ins, out, H, W, stream);
}}

extern "C" int ramba_stencil_ctas_per_sm(int path) {{
  return ramba::stencil_ctas_per_sm<{args}>(path);
}}
"""
    digest = hashlib.sha256(source.encode()).hexdigest()[:12]
    return Spec(f"stencil_{digest}", source, n_slots, geo)


# ---------------------------------------------------------------------------
# eligibility
# ---------------------------------------------------------------------------


def available_local(arrs) -> bool:
    """Array-level eligibility: one 2-D shape with sides below
    :data:`MAX_SIDE`, one dtype for every slot from {float32, float64,
    bfloat16}."""
    shapes = {tuple(a.shape) for a in arrs}
    if len(shapes) != 1:
        return False
    (shape,) = shapes
    if len(shape) != 2 or max(shape) >= MAX_SIDE:
        return False
    dtypes = {a.dtype for a in arrs}
    return len(dtypes) == 1 and \
        cx.dtype_name(E.to_np_dtype(arrs[0].dtype)) in _KERNEL_DTYPES


def _spec(func, lo, hi, slots, arrs) -> Optional[Spec]:
    tr = trace(func, slots)
    return spec_for(tr.expr, lo, hi, len(arrs), arrs[0].dtype)


def available(func, lo, hi, slots, arrs) -> bool:
    """Kernel eligibility for this stencil instance, decided before any
    launch.  Eligible arrays with a body or halo the kernel cannot take
    count in ``ineligible``."""
    global ineligible
    if not available_local(arrs):
        return False
    if _spec(func, lo, hi, slots, arrs) is None:
        ineligible += 1
        return False
    return True


# ---------------------------------------------------------------------------
# plain version, build, launch
# ---------------------------------------------------------------------------


def body_ops(expr: Sym) -> int:
    """Operations of a traced body per cell: each operation node of its
    tap expression once (star2: 8 taps, 9 operations)."""
    stack, seen, ops = [expr], set(), 0
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        ops += n.kind == "op"
        stack.extend(n.args)
    return ops


def cost(func, lo, hi, slots, avals, sweeps: int = 1) -> Optional[tuple]:
    """``(flops, bytes)`` of ``sweeps`` launches over operands of these
    avals as the kernel counts them (None when it does not take them):
    :func:`body_ops` per interior cell; each slot read once and the
    output written once a sweep.  Decided like :func:`available`, but
    counts nothing in ``ineligible``."""
    shapes = {tuple(a.shape) for a in avals}
    dtypes = {np.dtype(a.dtype) for a in avals}
    if len(shapes) != 1 or len(dtypes) != 1:
        return None
    (shape,), (dtype,) = shapes, dtypes
    if len(shape) != 2 or max(shape) >= MAX_SIDE \
            or cx.dtype_name(dtype) not in _KERNEL_DTYPES:
        return None
    tr = trace(func, slots)
    if spec_for(tr.expr, lo, hi, len(avals), dtype) is None:
        return None
    H, W = int(shape[0]), int(shape[1])
    cells = max(0, H - (hi[0] - lo[0])) * max(0, W - (hi[1] - lo[1]))
    itemsize = 2 if cx.dtype_name(dtype) == "bfloat16" else dtype.itemsize
    return (float(sweeps * body_ops(tr.expr) * cells),
            float(sweeps * (len(avals) + 1) * H * W * itemsize))


def stencil_reference(func, lo, hi, slots, arrs) -> torch.Tensor:
    """Plain PyTorch version: the body over shifted static slices of the
    interior, the border zeroed."""
    return shifted_slice_stencil(func, lo, hi, slots, arrs)


def build(specs) -> None:
    """Compile the given sources, one ``nvcc`` per source, all at once."""
    _build.build_many([(s.name, s.source) for s in specs])


_entries: dict = {}

# error codes of csrc/stencil_tile.cuh besides CUDA's own
_ERRORS = {900: "cuTensorMapEncodeTiled not found in the driver",
           901: "the kernel does not fit on an SM (occupancy 0)"}


def _entry(spec: Spec):
    """The built kernel's C entry points (built and bound once)."""
    fns = _entries.get(spec.name)
    if fns is None:
        lib = _build.load(spec.name, spec.source)
        fn = lib.ramba_stencil_launch
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        occ = lib.ramba_stencil_ctas_per_sm
        occ.argtypes = [ctypes.c_int]
        occ.restype = ctypes.c_int
        fns = _entries[spec.name] = (fn, occ)
    return fns


def ctas_per_sm(func, lo, hi, slots, arrs, path: str) -> int:
    """CTAs of this stencil's kernel one SM of the current card holds at
    once along ``path`` (its occupancy; the grid is that times the SMs)."""
    spec = _spec(func, lo, hi, slots, arrs)
    with torch.cuda.device(arrs[0].device):
        return _entry(spec)[1](PATHS.index(path))


def _error(rc: int) -> str:
    if rc >= 1000:
        return f"cuTensorMapEncodeTiled failed with CUresult {rc - 1000}"
    return _ERRORS.get(rc, f"CUDA error {rc}")


def launch(func, lo, hi, slots, arrs, out) -> torch.Tensor:
    """Launch the kernel once: ``out`` (a CUDA tensor of the input's shape
    and dtype) receives the stencil of ``arrs``."""
    global launches, launches_tma, launches_cpasync, launches_ldst
    spec = _spec(func, lo, hi, slots, arrs)
    if spec is None:
        raise RuntimeError("stencil kernel launched on a body or arrays it "
                           "does not take (available() said no)")
    dev = arrs[0].device
    if dev.type != "cuda" or any(a.device != dev for a in [*arrs, out]):
        raise RuntimeError(f"stencil kernel: operands on {dev}, expected cuda")
    if out.shape != arrs[0].shape or out.dtype != arrs[0].dtype \
            or not out.is_contiguous():
        raise ValueError("stencil kernel: out must be a contiguous tensor of "
                         "the input's shape and dtype")
    ins = [a if a.is_contiguous() else a.contiguous() for a in arrs]
    H, W = arrs[0].shape
    if H == 0 or W == 0:
        return out
    fn = _entry(spec)[0]
    addrs = [a.data_ptr() for a in ins]
    path = load_path(spec.geometry, H, W, ins[0].element_size(), addrs)
    ptrs = (ctypes.c_void_p * len(ins))(*addrs)
    _elastic.abandon_if_cancelled("a launch")  # after a first spec's build
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(PATHS.index(path), ptrs, out.data_ptr(), H, W, stream)
    if rc != 0:
        raise RuntimeError(f"stencil kernel launch ({path}) failed: "
                           f"{_error(rc)}")
    launches += 1
    if path == "tma":
        launches_tma += 1
    elif path == "cpasync":
        launches_cpasync += 1
    else:
        launches_ldst += 1
    return out


def run(func, lo, hi, slots, arrs) -> torch.Tensor:
    """The wrapper.  CPU operands take the plain version; CUDA operands
    launch the kernel (or raise)."""
    if arrs[0].device.type == "cpu":
        return stencil_reference(func, lo, hi, slots, arrs)
    return launch(func, lo, hi, slots, arrs, torch.empty_like(arrs[0]))


def run_iterate(func, lo, hi, slots, a0, rest, iters) -> torch.Tensor:
    """``iters`` sweeps with ``a0`` as the carry (slot 0) and ``rest``
    loop-invariant: one launch per sweep over two ping-pong buffers."""
    if a0.device.type == "cpu":
        a = a0
        for _ in range(iters):
            a = stencil_reference(func, lo, hi, slots, [a] + list(rest))
        return a
    bufs = (torch.empty_like(a0), torch.empty_like(a0))
    src = a0
    for i in range(iters):
        src = launch(func, lo, hi, slots, [src] + list(rest), bufs[i % 2])
    return src


kb.register_family("stencil", available=available, run=run)
