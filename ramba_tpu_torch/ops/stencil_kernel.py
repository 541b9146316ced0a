"""stencil: 2-D stencils through a hand-written CUDA C++ tile kernel.

Replaces ``ramba_tpu/ops/stencil_pallas.py::_run_fast`` (its
``pl.pallas_call`` at line 261) and ``::_run_padded`` (line 370) with one
kernel, ``csrc/stencil_tile.cuh``, that takes every shape both took: the
TPU's (8, 128) tiling rule that split them does not exist on Hopper, and
the kernel masks its edge loads instead.

The Pallas kernel traced the user's Python body inside the kernel.  A CUDA
kernel cannot call Python, so the body is first traced here with symbolic
taps (:func:`trace`, the offset probe extended to record arithmetic) into a
tap expression: taps ``(slot, di, dj)``, literals, ``+ - * / **``, unary
minus, the NumPy ufuncs a body may call, and the comparisons and ``where``
that the two-sided branch trace produces.  Each operation is typed by the
port's NumPy rule table and emitted as C++ with explicit casts into the
body of the tile template; ``nvcc`` builds it for ``sm_90a`` into a shared
library with a plain C entry point, loaded with ``ctypes`` and cached by
the hash of its source.

Eligibility (:func:`available`) is decided before anything launches: a 2-D
array, one dtype for every slot from {float32, float64, bfloat16}, a halo
of at most ``MAX_HALO`` cells on each side, a body the tracer expresses
whose result has the slots' dtype.  Anything else runs on the shifted-slice
path of ``skeletons.py``; bodies and halos turned away are counted in
``ineligible``.

Bound on the H100: HBM bandwidth, ``(slots + 1) * H * W * itemsize`` bytes
at 3.35 TB/s (see the header for what the tile design does about it).

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
from ramba_tpu_torch.core.expr import Aval
from ramba_tpu_torch.ops import kernel_backend as kb
from ramba_tpu_torch.skeletons import (
    KernelTraceError, _combine_branches, _explore_branches, decide,
    shifted_slice_stencil,
)

launches = 0
ineligible = 0

# must match csrc/stencil_tile.cuh
TILE_H, TILE_W = 32, 64
MAX_HALO = 16
SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
MAX_GRID_Y = 65535

_KERNEL_DTYPES = ("float32", "float64", "bfloat16")


def _dtype_name(dt) -> str:
    return "bfloat16" if E.is_bf16(dt) else np.dtype(dt).name


# ---------------------------------------------------------------------------
# tracer: stencil body -> tap expression
# ---------------------------------------------------------------------------

# ufuncs the code generator emits (everything else makes a body opaque)
_UNARY_C = {
    "exp": "exp", "exp2": "exp2", "expm1": "expm1", "log": "log",
    "log2": "log2", "log10": "log10", "log1p": "log1p", "sin": "sin",
    "cos": "cos", "tan": "tan", "sinh": "sinh", "cosh": "cosh",
    "tanh": "tanh", "arcsin": "asin", "arccos": "acos", "arctan": "atan",
    "arcsinh": "asinh", "arccosh": "acosh", "arctanh": "atanh",
    "floor": "floor", "ceil": "ceil", "trunc": "trunc", "rint": "rint",
    "sqrt": "sqrt",
}
_BINARY_C = {"arctan2": "atan2", "hypot": "hypot", "power": "pow",
             "fmax": "fmax", "fmin": "fmin"}
_CMP = {"equal": "==", "not_equal": "!=", "less": "<", "less_equal": "<=",
        "greater": ">", "greater_equal": ">="}
_OTHER = frozenset({
    "add", "subtract", "multiply", "true_divide", "floor_divide", "mod",
    "remainder", "maximum", "minimum", "logical_and", "logical_or",
    "logical_xor", "logical_not", "negative", "positive", "absolute", "abs",
    "fabs", "square", "sign", "isnan", "isinf", "isfinite", "where",
    "bitwise_and", "bitwise_or", "bitwise_xor", "invert",
})
SUPPORTED = frozenset(_UNARY_C) | frozenset(_BINARY_C) | frozenset(_CMP) | _OTHER


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
# code generation: tap expression -> CUDA C++ body
# ---------------------------------------------------------------------------

_CTYPE = {"bool": "bool", "int32": "int", "int64": "long long",
          "float32": "float", "float64": "double", "bfloat16": "float"}
_STORAGE = {"float32": "float", "float64": "double",
            "bfloat16": "__nv_bfloat16"}


class _Unsupported(Exception):
    pass


def _ctype(dt) -> str:
    name = _dtype_name(dt)
    if name not in _CTYPE:
        raise _Unsupported(f"dtype {name}")
    return _CTYPE[name]


def _float_lit(v: float, ct: str) -> str:
    if np.isnan(v):
        return f"(({ct})NAN)"
    if np.isinf(v):
        return f"(({ct})({'-' if v < 0 else ''}INFINITY))"
    return f"(({ct}){float(v)!r})"


def _lit_code(v, dt) -> str:
    """A literal in dtype ``dt``, rounded to it exactly as a cast would."""
    name = _dtype_name(dt)
    if name == "bool":
        return "true" if bool(v) else "false"
    if name in ("int32", "int64"):
        return f"(({_CTYPE[name]}){int(v)}LL)"
    if name == "bfloat16":
        v = float(np.asarray(v, np.float32).astype(E.BF16).astype(np.float32))
    elif name == "float32":
        v = float(np.float32(v))
    return _float_lit(float(v), _CTYPE[name])


def _round_bf16(code: str) -> str:
    return f"__bfloat162float(__float2bfloat16_rn({code}))"


class _Gen:
    """Types every node with the rule table and emits its C++."""

    def __init__(self, slot_dt):
        self.slot_dt = np.dtype(slot_dt)

    def node(self, n: Sym):
        """(code | None for a literal, aval, literal value)."""
        if n.kind == "tap":
            slot, di, dj = n.arg
            return f"s.template tap<{slot}, {di}, {dj}>()", \
                Aval((), self.slot_dt, False), None
        if n.kind == "lit":
            return None, E.aval_of(n.arg), n.arg
        parts = [self.node(a) for a in n.args]
        avals = [p[1] for p in parts]
        try:
            casts, out_dt = E.map_dtypes(n.arg, avals)
        except TypeError as e:
            raise _Unsupported(str(e)) from e
        for d in list(casts) + [out_dt]:
            if d is not None:
                _ctype(d)
        args = [self.cast(p, np.dtype(bool) if d is None else d)
                for p, d in zip(parts, casts)]
        loop_dt = casts[-1] if casts[-1] is not None else out_dt
        code, res_dt = self.op(n.arg, args, np.dtype(loop_dt))
        if E.is_bf16(res_dt):
            # a bfloat16 op computes in float and rounds its result, as
            # torch and the JAX package do
            code = _round_bf16(code)
        code = self.cast((code, Aval((), res_dt), None), out_dt)
        return code, Aval((), np.dtype(out_dt), False), None

    def cast(self, part, dst) -> str:
        code, av, lit = part
        dst = np.dtype(dst)
        if code is None:
            return _lit_code(lit, dst)
        src = av.dtype
        if src == dst or (_ctype(src) == _ctype(dst)
                          and not (E.is_bf16(dst) and not E.is_bf16(src))):
            return code
        if dst == np.dtype(bool):
            return f"(({code}) != 0)"
        if E.is_bf16(dst):
            return _round_bf16(f"(float)({code})")
        return f"(({_ctype(dst)})({code}))"

    @staticmethod
    def op(fname, a, dt):
        ct = _ctype(dt)
        fl = ct in ("float", "double")
        sfx = "f" if ct == "float" else ""
        boolean = ct == "bool"
        if fname in _CMP:
            return f"({a[0]} {_CMP[fname]} {a[1]})", np.dtype(bool)
        if fname in ("logical_and", "logical_or", "logical_xor"):
            op = {"logical_and": "&&", "logical_or": "||",
                  "logical_xor": "!="}[fname]
            return (f"((({a[0]}) != 0) {op} (({a[1]}) != 0))",
                    np.dtype(bool))
        if fname == "logical_not":
            return f"(({a[0]}) == 0)", np.dtype(bool)
        if fname in ("bitwise_and", "bitwise_or", "bitwise_xor"):
            if fl:
                raise _Unsupported(f"{fname} on {ct}")
            op = {"bitwise_and": "&", "bitwise_or": "|", "bitwise_xor": "^"}
            bop = {"bitwise_and": "&&", "bitwise_or": "||",
                   "bitwise_xor": "!="}
            return (f"({a[0]} {(bop if boolean else op)[fname]} {a[1]})",
                    dt)
        if fname == "invert":
            if fl:
                raise _Unsupported(f"invert on {ct}")
            return (f"(!{a[0]})" if boolean else f"(~{a[0]})"), dt
        if fname in ("isnan", "isinf", "isfinite"):
            if not fl:
                return ("false" if fname != "isfinite" else "true"), \
                    np.dtype(bool)
            return f"{fname}({a[0]})", np.dtype(bool)
        if fname == "where":
            return f"(({a[0]}) ? ({a[1]}) : ({a[2]}))", dt
        if fname == "add":
            return (f"({a[0]} || {a[1]})" if boolean
                    else f"({a[0]} + {a[1]})"), dt
        if fname == "multiply":
            return (f"({a[0]} && {a[1]})" if boolean
                    else f"({a[0]} * {a[1]})"), dt
        if boolean:
            raise _Unsupported(f"{fname} on bool")
        if fname == "subtract":
            return f"({a[0]} - {a[1]})", dt
        if fname == "true_divide":
            if not fl:
                raise _Unsupported("integer true_divide")
            return f"({a[0]} / {a[1]})", dt
        if fname in ("floor_divide", "mod", "remainder"):
            fn = "floor_div" if fname == "floor_divide" else "floor_mod"
            if fl:
                return f"ramba::{fn}({a[0]}, {a[1]})", dt
            # the header's integer overloads take long long
            return (f"(({ct})ramba::{fn}((long long)({a[0]}), "
                    f"(long long)({a[1]})))"), dt
        if fname == "maximum":
            return f"ramba::nan_max<{ct}>({a[0]}, {a[1]})", dt
        if fname == "minimum":
            return f"ramba::nan_min<{ct}>({a[0]}, {a[1]})", dt
        if fname == "negative":
            return f"(-{a[0]})", dt
        if fname == "positive":
            return f"({a[0]})", dt
        if fname in ("absolute", "abs", "fabs"):
            return (f"fabs{sfx}({a[0]})" if fl else f"llabs({a[0]})"), dt
        if fname == "square":
            return f"({a[0]} * {a[0]})", dt
        if fname == "sign":
            return f"ramba::sign<{ct}>({a[0]})", dt
        if not fl:
            raise _Unsupported(f"{fname} on {ct}")
        if fname in _UNARY_C:
            return f"{_UNARY_C[fname]}{sfx}({a[0]})", dt
        if fname in _BINARY_C:
            return f"{_BINARY_C[fname]}{sfx}({a[0]}, {a[1]})", dt
        raise _Unsupported(fname)


class Spec(NamedTuple):
    name: str
    source: str
    n_slots: int


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
    name = _dtype_name(dtype)
    if expr is None or name not in _KERNEL_DTYPES or len(lo) != 2:
        return None
    top, left = -lo[0], -lo[1]
    bottom, right = hi[0], hi[1]
    if max(top, bottom, left, right) > MAX_HALO:
        return None
    smem = (n_slots * (TILE_H + top + bottom) * (TILE_W + left + right)
            * (2 if name == "bfloat16" else np.dtype(dtype).itemsize))
    if smem > SMEM_LIMIT:
        return None
    try:
        code, av, lit = _Gen(dtype).node(expr)
    except _Unsupported:
        return None
    if code is None or _dtype_name(av.dtype) != name:
        return None  # a literal body, or a result in another dtype
    ct, st = _CTYPE[name], _STORAGE[name]
    source = f"""// generated by ramba_tpu_torch/ops/stencil_kernel.py
#include "stencil_tile.cuh"

struct Body {{
  template <class S>
  __device__ __forceinline__ static {ct} eval(const S& s) {{
    return {code};
  }}
}};

extern "C" int ramba_stencil_launch(const void* const* ins, void* out,
                                    long long H, long long W, void* stream) {{
  return ramba::launch_stencil<{st}, {n_slots}, {top}, {bottom}, {left}, {right}, Body>(
      ins, out, H, W, stream);
}}
"""
    digest = hashlib.sha256(source.encode()).hexdigest()[:12]
    return Spec(f"stencil_{digest}", source, n_slots)


# ---------------------------------------------------------------------------
# eligibility
# ---------------------------------------------------------------------------


def available_local(arrs) -> bool:
    """Array-level eligibility: one 2-D shape, one dtype for every slot
    from {float32, float64, bfloat16}, a grid the card can launch."""
    shapes = {tuple(a.shape) for a in arrs}
    if len(shapes) != 1:
        return False
    (shape,) = shapes
    if len(shape) != 2 or -(-shape[0] // TILE_H) > MAX_GRID_Y:
        return False
    dtypes = {a.dtype for a in arrs}
    return len(dtypes) == 1 and \
        _dtype_name(E.to_np_dtype(arrs[0].dtype)) in _KERNEL_DTYPES


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


def stencil_reference(func, lo, hi, slots, arrs) -> torch.Tensor:
    """Plain PyTorch version: the body over shifted static slices of the
    interior, the border zeroed."""
    return shifted_slice_stencil(func, lo, hi, slots, arrs)


def build(specs) -> None:
    """Compile the given sources, one ``nvcc`` per source, all at once."""
    _build.build_many([(s.name, s.source) for s in specs])


_entries: dict = {}


def _entry(spec: Spec):
    """The built kernel's C entry point (built and bound once)."""
    fn = _entries.get(spec.name)
    if fn is None:
        fn = _build.load(spec.name, spec.source).ramba_stencil_launch
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entries[spec.name] = fn
    return fn


def launch(func, lo, hi, slots, arrs, out) -> torch.Tensor:
    """Launch the kernel once: ``out`` (a CUDA tensor of the input's shape
    and dtype) receives the stencil of ``arrs``."""
    global launches
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
    fn = _entry(spec)
    ptrs = (ctypes.c_void_p * len(ins))(*[a.data_ptr() for a in ins])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(ptrs, out.data_ptr(), H, W, stream)
    if rc != 0:
        raise RuntimeError(f"stencil kernel launch failed: CUDA error {rc}")
    launches += 1
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
