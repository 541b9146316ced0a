"""Typed C++ for NumPy ufuncs: the emitter both CUDA kernels share.

The stencil kernel (``ops/stencil_kernel.py``) emits a traced tap
expression and elemred (``ops/elemred.py``) a fused program's
instructions; both type every operation by the port's NumPy rule table
(``core/expr.map_dtypes``), cast each operand explicitly to its loop dtype
and emit the operation as C++ over ``float``, ``double``, ``int``,
``long long`` or ``bool``.  Where C spells a ufunc differently from NumPy
(NaN-propagating ``maximum``, floored ``//`` and ``%``, ``sign``,
``logaddexp``) the code calls the helpers of ``csrc/ufunc.cuh``, which
both kernels' headers include.  Kernels are built with ``--fmad=false``
and nvcc's default correctly rounded division and square root, so every
operation rounds where its plain PyTorch version does.
"""

from __future__ import annotations

import numpy as np

from ramba_tpu_torch.core import expr as E
from ramba_tpu_torch.core.expr import Aval

UNARY_C = {
    "exp": "exp", "exp2": "exp2", "expm1": "expm1", "log": "log",
    "log2": "log2", "log10": "log10", "log1p": "log1p", "sin": "sin",
    "cos": "cos", "tan": "tan", "sinh": "sinh", "cosh": "cosh",
    "tanh": "tanh", "arcsin": "asin", "arccos": "acos", "arctan": "atan",
    "arcsinh": "asinh", "arccosh": "acosh", "arctanh": "atanh",
    "floor": "floor", "ceil": "ceil", "trunc": "trunc", "rint": "rint",
    "sqrt": "sqrt",
}
BINARY_C = {"arctan2": "atan2", "hypot": "hypot", "power": "pow",
            "fmax": "fmax", "fmin": "fmin"}
CMP = {"equal": "==", "not_equal": "!=", "less": "<", "less_equal": "<=",
       "greater": ">", "greater_equal": ">="}

CTYPE = {"bool": "bool", "int32": "int", "int64": "long long",
         "float32": "float", "float64": "double", "bfloat16": "float"}


class Unsupported(Exception):
    """An operation or dtype the emitter has no C++ for."""


def dtype_name(dt) -> str:
    return "bfloat16" if E.is_bf16(dt) else np.dtype(dt).name


def ctype(dt) -> str:
    name = dtype_name(dt)
    if name not in CTYPE:
        raise Unsupported(f"dtype {name}")
    return CTYPE[name]


def _float_lit(v: float, ct: str) -> str:
    if np.isnan(v):
        return f"(({ct})NAN)"
    if np.isinf(v):
        return f"(({ct})({'-' if v < 0 else ''}INFINITY))"
    return f"(({ct}){float(v)!r})"


def lit_code(v, dt) -> str:
    """A literal in dtype ``dt``, rounded to it exactly as a cast would."""
    name = dtype_name(dt)
    if name == "bool":
        return "true" if bool(v) else "false"
    if name in ("int32", "int64"):
        if int(v) == -2 ** 63:  # its magnitude is no long long literal
            return f"(({CTYPE[name]})(-9223372036854775807LL - 1))"
        return f"(({CTYPE[name]}){int(v)}LL)"
    if name == "bfloat16":
        v = float(np.asarray(v, np.float32).astype(E.BF16).astype(np.float32))
    elif name == "float32":
        v = float(np.float32(v))
    return _float_lit(float(v), CTYPE[name])


def sat_cast(code: str, src_ct: str, dst) -> str:
    """A float to an integer, saturating as ``core/expr.convert`` does
    (``ramba::sat_cast`` of ``csrc/ufunc.cuh``)."""
    info = np.iinfo(dst)
    ct = CTYPE[np.dtype(dst).name]
    lo = _float_lit(float(info.min), src_ct)
    hi = _float_lit(float(info.max + 1), src_ct)
    return (f"ramba::sat_cast<{ct}, {src_ct}>(({src_ct})({code}), {lo}, {hi}, "
            f"{lit_code(info.min, dst)}, {lit_code(info.max, dst)})")


def round_bf16(code: str) -> str:
    return f"__bfloat162float(__float2bfloat16_rn({code}))"


class Gen:
    """Types every node with the rule table and emits its C++."""

    def __init__(self, slot_dt=np.float32):
        self.slot_dt = np.dtype(slot_dt)

    def node(self, n):
        """(code | None for a literal, aval, literal value) of a stencil tap
        expression node (``kind`` tap, lit or op)."""
        if n.kind == "tap":
            slot, di, dj = n.arg
            return f"s.template tap<{slot}, {di}, {dj}>()", \
                Aval((), self.slot_dt, False), None
        if n.kind == "lit":
            return None, E.aval_of(n.arg), n.arg
        parts = [self.node(a) for a in n.args]
        return self.map(n.arg, parts)

    def map(self, fname, parts):
        """One ufunc over ``parts`` ((code | None, aval, literal) each):
        the operands cast to their loop dtypes, the operation, the result
        cast to the output dtype.  Returns the result's part."""
        avals = [p[1] for p in parts]
        try:
            casts, out_dt = E.map_dtypes(fname, avals)
        except TypeError as e:
            raise Unsupported(str(e)) from e
        for d in list(casts) + [out_dt]:
            if d is not None:
                ctype(d)
        args = [self.cast(p, np.dtype(bool) if d is None else d)
                for p, d in zip(parts, casts)]
        loop_dt = casts[-1] if casts[-1] is not None else out_dt
        code, res_dt = self.op(fname, args, np.dtype(loop_dt))
        if E.is_bf16(res_dt):
            # a bfloat16 op computes in float and rounds its result, as
            # torch and the JAX package do
            code = round_bf16(code)
        code = self.cast((code, Aval((), res_dt), None), out_dt)
        return code, Aval((), np.dtype(out_dt), False), None

    def cast(self, part, dst) -> str:
        code, av, lit = part
        dst = np.dtype(dst)
        if code is None:
            return lit_code(lit, dst)
        src = av.dtype
        if src == dst or (ctype(src) == ctype(dst)
                          and not (E.is_bf16(dst) and not E.is_bf16(src))):
            return code
        if dst == np.dtype(bool):
            return f"(({code}) != 0)"
        if E.is_bf16(dst):
            return round_bf16(f"(float)({code})")
        if dst.kind in "iu" and (E.is_bf16(src) or src.kind == "f"):
            return sat_cast(code, ctype(src), dst)
        return f"(({ctype(dst)})({code}))"

    @staticmethod
    def op(fname, a, dt):
        ct = ctype(dt)
        fl = ct in ("float", "double")
        sfx = "f" if ct == "float" else ""
        boolean = ct == "bool"
        if fname in CMP:
            return f"({a[0]} {CMP[fname]} {a[1]})", np.dtype(bool)
        if fname in ("logical_and", "logical_or", "logical_xor"):
            op = {"logical_and": "&&", "logical_or": "||",
                  "logical_xor": "!="}[fname]
            return (f"((({a[0]}) != 0) {op} (({a[1]}) != 0))",
                    np.dtype(bool))
        if fname == "logical_not":
            return f"(({a[0]}) == 0)", np.dtype(bool)
        if fname in ("bitwise_and", "bitwise_or", "bitwise_xor"):
            if fl:
                raise Unsupported(f"{fname} on {ct}")
            op = {"bitwise_and": "&", "bitwise_or": "|", "bitwise_xor": "^"}
            bop = {"bitwise_and": "&&", "bitwise_or": "||",
                   "bitwise_xor": "!="}
            return (f"({a[0]} {(bop if boolean else op)[fname]} {a[1]})",
                    dt)
        if fname == "invert":
            if fl:
                raise Unsupported(f"invert on {ct}")
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
            raise Unsupported(f"{fname} on bool")
        if fname == "subtract":
            return f"({a[0]} - {a[1]})", dt
        if fname in ("true_divide", "divide"):
            if not fl:
                raise Unsupported("integer true_divide")
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
            raise Unsupported(f"{fname} on {ct}")
        if fname in UNARY_C:
            return f"{UNARY_C[fname]}{sfx}({a[0]})", dt
        if fname in BINARY_C:
            return f"{BINARY_C[fname]}{sfx}({a[0]}, {a[1]})", dt
        if fname == "reciprocal":
            return f"(({ct})1 / {a[0]})", dt
        if fname == "copysign":
            return f"copysign{sfx}({a[0]}, {a[1]})", dt
        if fname in ("logaddexp", "logaddexp2"):
            return f"ramba::{fname}<{ct}>({a[0]}, {a[1]})", dt
        raise Unsupported(fname)
