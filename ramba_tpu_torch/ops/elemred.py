"""elemred: fused elementwise(+reduce) chains as one generated Triton kernel.

Replaces ``ramba_tpu/ops/pallas_backend.py::_build_elemred`` (its
``pl.pallas_call`` at line 447).

What it computes: a fused program of ``map`` (over ``kernel_backend.
ELEM_OK``), ``cast`` and ``round`` instructions over 1-D operands of one
length n, optionally ending in whole-array ``sum/prod/min/max/mean``
reductions.  Every map follows its NumPy (NEP 50) cast plan; vector outputs
stream out; mean is divided by n outside the kernel.

Design.  One ``@triton.jit`` kernel is generated per program and leaf
signature from ``program.instrs`` and the cast plan, written into the build
directory (Triton needs a real source file) and imported from there.  Each
program instance loads its masked block of every vector leaf, runs the
instructions with explicit casts, stores the vector outputs and writes one
partial per reduction into a ``[n_programs]`` buffer.  The TPU kernel's
sequential-grid accumulator is not legal on a GPU, whose blocks run in no
order; a second generated kernel combines the partials in a fixed order, so
a re-run gives the same bytes (no float atomics).  Scalar leaves are runtime
arguments (one-element device tensors), so a new constant never rebuilds
the kernel.  float32 division and square root are computed in float64 and
rounded once, which is correctly rounded (53 >= 2*24 + 2 bits) without
depending on the libdevice names of a Triton version; transcendental
functions come from libdevice.  Kernels launch with
``enable_fp_fusion=False``: no multiply and add contract into an FMA, so
every elementwise operation rounds where its plain version rounds.

Bound on the H100: HBM bandwidth.  The kernel reads each vector leaf once
and writes each vector output once (plus n/BLOCK partials per reduction),
so its floor is (bytes read + bytes written) / 3.35 TB/s; every
intermediate stays in registers, which is the whole point of fusing.

Beside it: :func:`elemred_reference`, the plain PyTorch version (the same
instructions through the port's ``OPS`` table), and ``launches``, counted
once per launch of the generated kernel.
"""

from __future__ import annotations

import hashlib
import importlib
import importlib.util
import os
import threading

import numpy as np
import torch

from ramba_tpu_torch import _build
from ramba_tpu_torch.core.expr import as_tensor, to_torch_dtype
from ramba_tpu_torch.core.fuser import run_instructions
from ramba_tpu_torch.ops import kernel_backend as kb

launches = 0

BLOCK = 1024
COMBINE_BLOCK = 1024
NUM_WARPS = 4


def depth(n: int) -> int:
    """The longest chain of roundings in the kernel's float sum of n
    elements: a program's ``tl.sum`` over BLOCK (each of its 32 * NUM_WARPS
    threads folds BLOCK / (32 * NUM_WARPS) elements in turn, then a tree
    across the threads), the combine kernel's pass over the partials in
    chunks of COMBINE_BLOCK, and its own ``tl.sum``.  The sum is within
    ``depth(n) * eps/2 * sum|x|`` of the exact one (first order)."""
    threads = 32 * NUM_WARPS
    levels = threads.bit_length() - 1
    partials = -(-n // BLOCK)
    return (BLOCK // threads + levels + -(-partials // COMBINE_BLOCK)
            + COMBINE_BLOCK // threads + levels)


_TL = {"float32": "tl.float32", "float64": "tl.float64", "int32": "tl.int32",
       "int64": "tl.int64", "bool": "tl.int1"}

_LIBDEVICE_UNARY = {
    "exp": "exp", "exp2": "exp2", "expm1": "expm1", "log": "log",
    "log2": "log2", "log10": "log10", "log1p": "log1p", "sin": "sin",
    "cos": "cos", "tan": "tan", "sinh": "sinh", "cosh": "cosh",
    "tanh": "tanh", "arcsin": "asin", "arccos": "acos", "arctan": "atan",
    "arcsinh": "asinh", "arccosh": "acosh", "arctanh": "atanh",
    "floor": "floor", "ceil": "ceil", "trunc": "trunc", "rint": "rint",
}

_LIBDEVICE_BINARY = {"arctan2": "atan2", "hypot": "hypot",
                     "copysign": "copysign", "power": "pow"}

_CMP = {"equal": "==", "not_equal": "!=", "less": "<", "less_equal": "<=",
        "greater": ">", "greater_equal": ">="}


def elemred_reference(program, leaf_vals) -> tuple:
    """Plain PyTorch version: the program's instructions through the port's
    ``OPS`` table, with the generic lowering's NumPy dtype rules."""
    return run_instructions(program, leaf_vals)


# ---------------------------------------------------------------------------
# plan: everything the generated source depends on
# ---------------------------------------------------------------------------


class _Plan:
    """Cast plan, slot roles and generated source of one program on one
    leaf signature."""

    def __init__(self, program, leaf_vals):
        self.program = program
        n_leaves = program.n_leaves
        self.avals = kb.all_slot_avals(program, leaf_vals)
        self.is_vec = [len(kb._leaf_shape(v)) == 1 for v in leaf_vals]
        self.consts: list = []  # float constants not exact in float32
        self.reduce_meta: dict = {}
        for i, (op, static, argslots) in enumerate(program.instrs):
            if op == "reduce":
                slot = n_leaves + i
                self.reduce_meta[slot] = (static[0], self.avals[slot].dtype)
                self.is_vec.append(False)
            elif op == "map":
                self.is_vec.append(any(self.is_vec[s] for s in argslots))
            else:
                self.is_vec.append(self.is_vec[argslots[0]])
        self.vec_leaves = [s for s in range(n_leaves) if self.is_vec[s]]
        self.scalar_leaves = [s for s in range(n_leaves) if not self.is_vec[s]]
        self.vec_out = []
        for s in program.out_slots:
            if s >= n_leaves and self.is_vec[s] and s not in self.vec_out:
                self.vec_out.append(s)
        self.red_out = sorted(self.reduce_meta)
        self.source = self._generate()
        self.key = hashlib.sha256(self.source.encode()).hexdigest()[:16]
        self._consts_dev: dict = {}

    def consts_on(self, dev) -> torch.Tensor:
        """The float64 constants buffer on ``dev``, uploaded once."""
        t = self._consts_dev.get(dev)
        if t is None:
            t = self._consts_dev[dev] = torch.tensor(
                self.consts or [0.0], dtype=torch.float64, device=dev)
        return t

    # -- codegen helpers ----------------------------------------------------

    def _const(self, value: float, dt: np.dtype) -> str:
        """A float constant in dtype ``dt``: a literal where float32 holds it
        exactly (Triton types python floats as float32), else a load from
        the constants buffer."""
        if float(np.float32(value)) == value or dt.name == "float32":
            if dt.name == "float32":
                value = float(np.float32(value))
            return f"{value!r}"
        if value not in self.consts:
            self.consts.append(value)
        return f"tl.load(cst + {self.consts.index(value)})"

    @staticmethod
    def _cast(code: str, src: np.dtype, dst: np.dtype) -> str:
        if src == dst:
            return code
        if dst.name == "bool":
            return f"(({code}) != 0)"
        return f"({code}).to({_TL[dst.name]})"

    def _map(self, fname: str, a: list, dts: list, out: np.dtype) -> str:
        """Triton expression for one ufunc on operands already cast to their
        loop dtypes ``dts``."""
        dt = dts[-1]
        fl = dt.kind == "f"
        f64 = "tl.float64"
        if fname == "where":
            return f"tl.where({a[0]}, {a[1]}, {a[2]})"
        if fname == "add":
            return f"({a[0]} | {a[1]})" if dt.kind == "b" else f"({a[0]} + {a[1]})"
        if fname == "subtract":
            return f"({a[0]} - {a[1]})"
        if fname == "multiply":
            return f"({a[0]} & {a[1]})" if dt.kind == "b" else f"({a[0]} * {a[1]})"
        if fname in ("true_divide", "divide"):
            if dt.name == "float32":
                return f"(({a[0]}).to({f64}) / ({a[1]}).to({f64})).to(tl.float32)"
            return f"({a[0]} / {a[1]})"
        if fname == "reciprocal":
            if dt.name == "float32":
                return f"(1.0 / ({a[0]}).to({f64})).to(tl.float32)"
            return f"(1.0 / {a[0]})"
        if fname == "sqrt":
            if dt.name == "float32":
                return f"tl.sqrt(({a[0]}).to({f64})).to(tl.float32)"
            return f"tl.sqrt({a[0]})"
        if fname in ("mod", "remainder"):
            # numpy's sign convention: the result takes the divisor's sign
            return f"_floor_mod_f({a[0]}, {a[1]})" if fl else \
                f"_floor_mod_i({a[0]}, {a[1]})"
        if fname == "floor_divide":
            return f"_floor_div_f({a[0]}, {a[1]})" if fl else \
                f"_floor_div_i({a[0]}, {a[1]})"
        if fname in ("maximum", "minimum"):
            op = ">" if fname == "maximum" else "<"
            if fl:  # NaN propagates
                return (f"_nan_pick({a[0]}, {a[1]}, "
                        f"tl.where({a[0]} {op} {a[1]}, {a[0]}, {a[1]}))")
            return f"tl.where({a[0]} {op} {a[1]}, {a[0]}, {a[1]})"
        if fname in ("fmax", "fmin"):
            op = ">" if fname == "fmax" else "<"
            return (f"tl.where({a[1]} != {a[1]}, {a[0]}, tl.where({a[0]} != "
                    f"{a[0]}, {a[1]}, tl.where({a[0]} {op} {a[1]}, {a[0]}, "
                    f"{a[1]})))")
        if fname in _LIBDEVICE_BINARY:
            return f"ld.{_LIBDEVICE_BINARY[fname]}({a[0]}, {a[1]})"
        if fname == "logaddexp":
            return f"_logaddexp({a[0]}, {a[1]})"
        if fname == "logaddexp2":
            ln2 = self._const(float(np.log(2)), dt)
            return f"_logaddexp2({a[0]}, {a[1]}, {ln2})"
        if fname in _CMP:
            return f"({a[0]} {_CMP[fname]} {a[1]})"
        if fname == "logical_and":
            return f"(({a[0]} != 0) & ({a[1]} != 0))"
        if fname == "logical_or":
            return f"(({a[0]} != 0) | ({a[1]} != 0))"
        if fname == "logical_xor":
            return f"(({a[0]} != 0) ^ ({a[1]} != 0))"
        if fname == "logical_not":
            return f"({a[0]} == 0)"
        if fname == "negative":
            return f"(-{a[0]})"
        if fname == "positive":
            return a[0]
        if fname in ("absolute", "abs", "fabs"):
            return a[0] if dt.kind == "b" else f"tl.abs({a[0]})"
        if fname == "square":
            return f"({a[0]} * {a[0]})"
        if fname == "sign":
            s = f"tl.where({a[0]} > 0, 1, tl.where({a[0]} < 0, -1, 0)).to({_TL[dt.name]})"
            return f"tl.where({a[0]} != {a[0]}, {a[0]}, {s})" if fl else s
        if fname == "isnan":
            return f"({a[0]} != {a[0]})"
        if fname == "isinf":
            if not fl:
                return f"({a[0]} != {a[0]})"
            return f"(tl.abs({a[0]}) == float('inf'))"
        if fname == "isfinite":
            if not fl:
                return f"({a[0]} == {a[0]})"
            return f"(({a[0]} == {a[0]}) & (tl.abs({a[0]}) != float('inf')))"
        if fname in _LIBDEVICE_UNARY:
            return f"ld.{_LIBDEVICE_UNARY[fname]}({a[0]})"
        raise NotImplementedError(f"elemred codegen has no rule for {fname!r}")

    def _round(self, code: str, dt: np.dtype, decimals: int) -> str:
        if dt.kind != "f":
            return code  # integers with decimals >= 0 (classifier) unchanged
        if decimals == 0:
            return f"ld.rint({code})"
        f = self._const(10.0 ** decimals, dt)
        prod = f"ld.rint({code} * {f})"
        return self._map("true_divide", [prod, f], [dt, dt, dt], dt)

    # -- source ---------------------------------------------------------------

    def _generate(self) -> str:
        prog = self.program
        n_leaves = prog.n_leaves
        av = self.avals
        body = [
            "    pid = tl.program_id(0)",
            "    offs = pid.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)",
            "    mask = offs < n",
        ]
        for s in self.vec_leaves:
            body.append(f"    x{s} = tl.load(in{s} + offs, mask=mask)")
        for s in self.scalar_leaves:
            body.append(f"    x{s} = tl.load(in{s})")
        red_code = []
        for i, (op, static, argslots) in enumerate(prog.instrs):
            slot = n_leaves + i
            if op == "map":
                fname = static[0]
                casts, out_dt = kb.map_cast_plan(
                    fname, [av[s] for s in argslots])
                args = []
                for s, d in zip(argslots, casts):
                    src = av[s].dtype
                    if d is None:  # where's condition
                        args.append(self._cast(f"x{s}", src, np.dtype(bool)))
                    else:
                        args.append(self._cast(f"x{s}", src, d))
                dts = [d if d is not None else np.dtype(bool) for d in casts]
                loop_dt = casts[-1] if casts[-1] is not None else out_dt
                expr = self._map(fname, args, dts[:-1] + [loop_dt], out_dt)
                res_dt = _result_dtype(fname, loop_dt)
                expr = self._cast(expr, res_dt, out_dt)
            elif op == "cast":
                expr = self._cast(f"x{argslots[0]}", av[argslots[0]].dtype,
                                  av[slot].dtype)
            elif op == "round":
                expr = self._round(f"x{argslots[0]}", av[slot].dtype,
                                   int(static[0]))
            else:  # reduce: one partial per program instance
                fname, acc_dt = self.reduce_meta[slot]
                x = self._cast(f"x{argslots[0]}", av[argslots[0]].dtype, acc_dt)
                ident = _ident_literal(fname, acc_dt)
                red_code.append(
                    f"    r{slot} = tl.where(mask, {x}, {ident})\n"
                    f"    tl.store(part{slot} + pid, "
                    f"{_block_reduce(fname, f'r{slot}')})")
                continue
            body.append(f"    x{slot} = {expr}")
        for s in self.vec_out:
            body.append(f"    tl.store(out{s} + offs, x{s}, mask=mask)")
        body.extend(red_code)
        params = ([f"in{s}" for s in self.vec_leaves]
                  + [f"in{s}" for s in self.scalar_leaves]
                  + [f"out{s}" for s in self.vec_out]
                  + [f"part{s}" for s in self.red_out]
                  + ["cst", "n", "BLOCK: tl.constexpr"])
        lines = [
            "# generated by ramba_tpu_torch/ops/elemred.py: one fused program",
            "import triton",
            "import triton.language as tl",
            f"import {_libdevice_module()} as ld",
            "",
            _HELPERS,
            "@triton.jit",
            f"def elemred_kernel({', '.join(params)}):",
            *body,
            "",
        ]
        for s in self.red_out:
            fname, acc_dt = self.reduce_meta[s]
            lines.append(_combine_source(f"combine{s}", fname, acc_dt))
        return "\n".join(lines) + "\n"


def _result_dtype(fname: str, loop_dt: np.dtype) -> np.dtype:
    """Dtype of the generated expression before the final cast."""
    if fname in _CMP or fname in ("logical_and", "logical_or", "logical_xor",
                                  "logical_not", "isnan", "isinf", "isfinite"):
        return np.dtype(bool)
    return loop_dt


def _ident_literal(fname: str, dt: np.dtype) -> str:
    v = kb.reduce_identity_np(fname, dt)
    if dt.kind == "f":
        return repr(float(v)).replace("inf", "float('inf')")
    return repr(int(v))


def _block_reduce(fname: str, x: str) -> str:
    if fname in ("sum", "mean"):
        return f"tl.sum({x}, axis=0)"
    return f"tl.reduce({x}, 0, {_COMBINE_FN[fname]})"


_COMBINE_FN = {"sum": "_add", "mean": "_add", "prod": "_mul",
               "min": "_min_nan", "max": "_max_nan"}


def _combine_source(name: str, fname: str, dt: np.dtype) -> str:
    """Second pass: fold the partials in a fixed order (deterministic)."""
    ident = _ident_literal(fname, dt)
    comb = _COMBINE_FN[fname]
    return (
        "@triton.jit\n"
        f"def {name}(part, out, m, BLOCK: tl.constexpr):\n"
        "    idx = tl.arange(0, BLOCK)\n"
        f"    acc = tl.load(part + idx, mask=idx < m, other={ident})\n"
        "    for start in range(BLOCK, m, BLOCK):\n"
        "        offs = start + idx\n"
        f"        nxt = tl.load(part + offs, mask=offs < m, other={ident})\n"
        f"        acc = {comb}(acc, nxt)\n"
        f"    tl.store(out, {_block_reduce(fname, 'acc')})\n"
    )


_HELPERS = '''
@triton.jit
def _add(a, b):
    return a + b


@triton.jit
def _mul(a, b):
    return a * b


@triton.jit
def _nan_pick(a, b, picked):
    # NaN-propagating max/min: a NaN operand wins
    return tl.where(a != a, a, tl.where(b != b, b, picked))


@triton.jit
def _min_nan(a, b):
    return _nan_pick(a, b, tl.where(a < b, a, b))


@triton.jit
def _max_nan(a, b):
    return _nan_pick(a, b, tl.where(a > b, a, b))


@triton.jit
def _floor_mod_f(a, b):
    # libdevice's fmod is exact; Triton's float % is not
    m = ld.fmod(a, b)
    return tl.where((m != 0) & ((m < 0) != (b < 0)), m + b, m)


@triton.jit
def _floor_mod_i(a, b):
    # integer x % 0 is 0, as in ramba_tpu
    zero = b == 0
    bs = tl.where(zero, 1, b)
    m = a % bs
    m = tl.where((m != 0) & ((m < 0) != (bs < 0)), m + bs, m)
    return tl.where(zero, 0, m)


@triton.jit
def _floor_div_i(a, b):
    # signed integer x // 0, as ramba_tpu gives it: -1 for x == 0, else -2
    zero = b == 0
    bs = tl.where(zero, 1, b)
    q = a // bs
    r = a % bs
    q = tl.where((r != 0) & ((r < 0) != (bs < 0)), q - 1, q)
    return tl.where(zero, tl.where(a == 0, -1, -2).to(q.dtype), q)


@triton.jit
def _floor_div_f(a, b):
    # jnp's float divmod: (a - fmod(a, b)) / b, corrected, rounded
    m = ld.fmod(a, b)
    d = ((a - m).to(tl.float64) / b.to(tl.float64)).to(a.dtype)
    d = tl.where((m != 0) & ((m < 0) != (b < 0)), d - 1, d)
    return tl.where(b == 0, a / b, ld.round(d))


@triton.jit
def _logaddexp(a, b):
    d = a - b
    m = tl.where(a > b, a, b)
    return tl.where(d != d, a + b, m + ld.log1p(ld.exp(-tl.abs(d))))


@triton.jit
def _logaddexp2(a, b, ln2):
    d = a - b
    m = tl.where(a > b, a, b)
    return tl.where(d != d, a + b, m + ld.log1p(ld.exp2(-tl.abs(d))) / ln2)

'''


def _triton_env() -> None:
    """Keep Triton's compile cache inside the build directory."""
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(_build.BUILD_DIR, "triton_cache"))


def _libdevice_module() -> str:
    """Where this Triton keeps libdevice (it moved between versions).  On a
    host without Triton the source is only generated, never compiled."""
    _triton_env()
    try:
        import triton  # noqa: F401
    except ImportError:
        return "triton.language.extra.libdevice"
    for mod in ("triton.language.extra.libdevice",
                "triton.language.extra.cuda.libdevice",
                "triton.language.math"):
        try:
            importlib.import_module(mod)
            return mod
        except ImportError:
            continue
    raise RuntimeError("this Triton has no libdevice module")


# ---------------------------------------------------------------------------
# build + launch
# ---------------------------------------------------------------------------

_plans: dict = {}
_PLANS_MAX = 512
_modules: dict = {}
_lock = threading.Lock()


def plan_for(program, leaf_vals) -> _Plan:
    key = (program.key, tuple((tuple(getattr(v, "shape", ())),
                               kb.aval_of(v).dtype, kb.aval_of(v).weak)
                              for v in leaf_vals))
    with _lock:
        p = _plans.get(key)
        if p is None:
            if len(_plans) >= _PLANS_MAX:
                _plans.pop(next(iter(_plans)))
            p = _plans[key] = _Plan(program, leaf_vals)
        return p


def _module(plan: _Plan):
    with _lock:
        mod = _modules.get(plan.key)
        if mod is None:
            _triton_env()
            path = _build.write_source(f"elemred_{plan.key}.py", plan.source)
            spec = importlib.util.spec_from_file_location(
                f"ramba_elemred_{plan.key}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _modules[plan.key] = mod
        return mod


def run(program, leaf_vals) -> tuple:
    """The wrapper.  CPU operands take the plain version; CUDA operands
    launch the kernel (or raise)."""
    vecs = [v for v in leaf_vals if isinstance(v, torch.Tensor) and v.ndim == 1]
    dev = vecs[0].device
    if dev.type == "cpu":
        return elemred_reference(program, leaf_vals)
    if dev.type != "cuda":
        raise RuntimeError(f"elemred: operands on {dev}, expected cuda")
    return launch(program, leaf_vals)


def launch(program, leaf_vals) -> tuple:
    """Launch the generated kernel (and one combine pass per reduction) on
    CUDA leaves; returns the program's outputs."""
    global launches
    plan = plan_for(program, leaf_vals)
    mod = _module(plan)
    n = kb.vector_length(leaf_vals)
    dev = next(v.device for v in leaf_vals
               if isinstance(v, torch.Tensor) and v.ndim == 1)
    av = plan.avals
    args = []
    for s in plan.vec_leaves:
        v = leaf_vals[s]
        if v.device != dev or not v.is_contiguous():
            raise ValueError("elemred: vector operands must be contiguous on "
                             f"{dev}")
        args.append(v)
    for s in plan.scalar_leaves:
        args.append(as_tensor(leaf_vals[s], av[s].dtype, dev).reshape(1))
    outs = {s: torch.empty(n, dtype=to_torch_dtype(av[s].dtype), device=dev)
            for s in plan.vec_out}
    args.extend(outs[s] for s in plan.vec_out)
    n_prog = -(-n // BLOCK)
    parts = {s: torch.empty(n_prog, dtype=to_torch_dtype(plan.reduce_meta[s][1]),
                            device=dev) for s in plan.red_out}
    args.extend(parts[s] for s in plan.red_out)
    cst = plan.consts_on(dev)
    mod.elemred_kernel[(n_prog,)](*args, cst, n, BLOCK=BLOCK,
                                  num_warps=NUM_WARPS, enable_fp_fusion=False)
    launches += 1
    by_slot = dict(outs)
    for s in plan.red_out:
        fname, acc_dt = plan.reduce_meta[s]
        r = torch.empty(1, dtype=to_torch_dtype(acc_dt), device=dev)
        getattr(mod, f"combine{s}")[(1,)](parts[s], r, n_prog,
                                          BLOCK=COMBINE_BLOCK,
                                          num_warps=NUM_WARPS,
                                          enable_fp_fusion=False)
        r = r.reshape(())
        if fname == "mean":
            r = r / n
        want = to_torch_dtype(av[s].dtype)
        by_slot[s] = r if r.dtype == want else r.to(want)
    return tuple(leaf_vals[s] if s < program.n_leaves else by_slot[s]
                 for s in program.out_slots)


kb.register_family("elemred", available=kb.supports, run=run)
