"""elemred: fused elementwise(+reduce) chains through a hand-written CUDA
C++ kernel.

Replaces ``ramba_tpu/ops/pallas_backend.py::_build_elemred`` (its
``pl.pallas_call`` at line 447).

What it computes: a fused program of ``map`` (over ``kernel_backend.
ELEM_OK``), ``cast`` and ``round`` instructions over 1-D operands of one
length n, optionally ending in whole-array ``sum/prod/min/max/mean``
reductions.  Every map follows its NumPy (NEP 50) cast plan; vector outputs
stream out; mean is divided by n outside the kernel.

Bound on the H100: HBM bandwidth for most programs: each vector leaf read
once and each vector output written once, at 3.35 TB/s (the main path's
sin/cos chain at n = 1e9 in float64: 16 GB, 4.78 ms).  Its FP64 arithmetic
stays below that, but its issue time comes close, so the kernel has to
overlap its loads with its arithmetic inside every SM and spend no issue
slots on loading.

Design (``csrc/elemred.cuh`` says more).  One CUDA source per program and
leaf signature is generated here from ``program.instrs`` and the cast plan:
a struct that the header's kernels are instantiated with, every operation
typed and cast explicitly by the emitter the stencil kernel shares
(``ops/cuda_expr.py``), ``sin`` and ``cos`` of one operand as one
``sincos``.  ``nvcc`` builds it for ``sm_90a`` with ``--fmad=false`` (each
operation rounds where its plain version rounds; division and square root
correctly rounded) into a shared library loaded with ``ctypes``
(``_build.py``).  A persistent grid (the kernel's occupancy times the SMs)
walks tiles of ``NT * ept`` elements grid-stride; on the ``bulk`` path each
CTA keeps a ring of shared-memory stages filled by one-thread 1-D bulk
copies completing on mbarriers, so the next tiles' bytes are in flight
while it computes; reductions keep independent per-position accumulators
in every thread, fold them by fixed-order trees into one partial per CTA,
and a second launch folds the partials in a fixed order (no float atomics:
reruns give the same bytes).  Scalar leaves are kernel arguments passed by
value (a 0-d CUDA tensor by pointer), so a new constant reuses the library
and nothing is uploaded per launch.

Everything about the launch except the occupancy is decided here, where
the CPU tests reach it: :func:`config_for` (elements per thread, ring
stages), :func:`schedule`, :func:`tile_range` and :func:`tile_elements`
(the kernel's order), :func:`load_path` (``bulk`` when every vector leaf is
16-byte aligned and the ring fits, else ``plain``), :func:`depth` (its
rounding depth).  Launches count in ``launches`` and, by path, in
``launches_bulk`` and ``launches_plain``.  A failed build or launch
raises; no path gives way to the other or to the plain version.

Beside it: :func:`elemred_reference`, the plain PyTorch version (the same
instructions through the port's ``OPS`` table).  :func:`run` takes the
plain version only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import threading
from typing import NamedTuple

import numpy as np
import torch

from ramba_tpu_torch import _build
from ramba_tpu_torch.core.expr import Aval, to_torch_dtype, wrap_int
from ramba_tpu_torch.core.fuser import run_instructions
from ramba_tpu_torch.ops import cuda_expr as cx
from ramba_tpu_torch.ops import kernel_backend as kb
from ramba_tpu_torch.resilience import elastic as _elastic

launches = 0
launches_bulk = 0
launches_plain = 0

NT = 256  # threads per CTA in both kernels (csrc/elemred.cuh)
PATHS = ("bulk", "plain")  # the kernel's PATH_* codes, in order
H100_SMS = 132
SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
SM_SMEM = 233472  # bytes of shared memory on one H100 SM (228 KB)
CTA_RESERVED = 1024  # of which the runtime keeps this much per CTA


class Config(NamedTuple):
    """The tunables of one generated kernel: ``ept`` elements per thread
    per tile, ``stages`` ring stages, ``min_ctas`` CTAs per SM the launch
    bounds ask registers for, ``sincos`` fusing sin and cos of one
    operand."""
    ept: int = 8
    stages: int = 4
    min_ctas: int = 2
    sincos: bool = True


CONFIG = Config()


def depth(n: int, grid: int = None, ept: int = None) -> int:
    """The longest chain of roundings in the kernel's float sum of n
    elements on ``grid`` CTAs (default: the fewest an H100 runs,
    ``H100_SMS * CONFIG.min_ctas``) with ``ept`` elements per thread: an
    accumulator adds one element of each tile its CTA takes (identities
    past n included), then the tree over the thread's ept accumulators,
    the warp's (5 levels) and the CTA's (log2 of NT / 32) trees, the fold
    thread's pass over its partials and the fold's tree.  The sum is
    within ``depth * eps/2 * sum|x|`` of the exact one (first order)."""
    ept = CONFIG.ept if ept is None else ept
    tiles = n_tiles(n, ept)
    grid = schedule(n, ept, H100_SMS * CONFIG.min_ctas if grid is None
                    else grid)
    tree = _log2(ept) + 5 + _log2(NT // 32)
    return -(-tiles // grid) + tree + -(-grid // NT) + 5 + _log2(NT // 32)


def _log2(k: int) -> int:
    return k.bit_length() - 1


# ---------------------------------------------------------------------------
# geometry, schedule and load path (mirror csrc/elemred.cuh)
# ---------------------------------------------------------------------------


def vec_width(itemsizes) -> int:
    """Elements in one group: 16 bytes of the widest vector operand, so a
    group of any operand is one aligned access of at most 16 bytes."""
    return 16 // max(itemsizes)


def stage_bytes(itemsizes, ept: int) -> int:
    """One ring stage: a tile of every vector leaf, each on 128 bytes."""
    return sum(-(-(NT * ept * es) // 128) * 128 for es in itemsizes)


def smem_bytes(itemsizes, ept: int, stages: int) -> int:
    return stages * stage_bytes(itemsizes, ept) + 8 * stages


def config_for(leaf_sizes, out_sizes, base: Config = CONFIG) -> tuple:
    """``(config, vec)`` for a program whose vector leaves and outputs have
    these itemsizes: ept at least one group; the ring cut to fewer stages
    (down to two) until ``base.min_ctas`` rings fit an SM, then to fewer
    elements per thread until one fits a block's shared memory
    (:func:`load_path` sends a ring that still does not fit to plain
    loads); no more CTAs per SM asked for than their rings fit."""
    vec = vec_width(list(leaf_sizes) + list(out_sizes))
    ept = max(base.ept, vec)
    stages = base.stages
    cap = min(SMEM_LIMIT, SM_SMEM // base.min_ctas - CTA_RESERVED)
    while smem_bytes(leaf_sizes, ept, stages) > cap and stages > 2:
        stages -= 1
    while smem_bytes(leaf_sizes, ept, stages) > SMEM_LIMIT and ept > vec:
        ept //= 2
    smem = smem_bytes(leaf_sizes, ept, stages)
    min_ctas = max(1, min(base.min_ctas, SM_SMEM // (smem + CTA_RESERVED)))
    return base._replace(ept=ept, stages=stages, min_ctas=min_ctas), vec


def n_tiles(n: int, ept: int) -> int:
    return -(-n // (NT * ept))


def schedule(n: int, ept: int, resident: int) -> int:
    """The grid for ``resident`` CTAs on the card at once: never more CTAs
    than tiles."""
    return max(1, min(resident, n_tiles(n, ept)))


def tile_range(b: int, grid: int, tiles: int) -> range:
    """The tiles CTA ``b`` computes, in order: b, b + grid, ... (the CTAs
    on the card at once read one contiguous stretch)."""
    return range(b, tiles, grid)


def tile_elements(tile: int, ept: int, vec: int) -> np.ndarray:
    """Element index of every (thread, position) of a tile, shape
    ``(NT, ept)``: thread t's group j holds elements tile * NT * ept +
    j * NT * vec + t * vec + (0 .. vec - 1), at positions j * vec + v (its
    accumulators)."""
    t = np.arange(NT)[:, None]
    pos = np.arange(ept)[None, :]
    j, v = pos // vec, pos % vec
    return tile * NT * ept + j * NT * vec + t * vec + v


def bulk_elements(count: int, ept: int, itemsize: int) -> int:
    """Elements of a tile with ``count`` elements below n that its leaf's
    bulk copy moves (a multiple of 16 bytes); the rest of the tile below n
    is read with plain loads."""
    c = min(count, NT * ept)
    return (c * itemsize) // 16 * 16 // itemsize


def load_path(ptrs, ring_fits: bool = True) -> str:
    """``bulk`` when every vector leaf's base is 16-byte aligned (a bulk
    copy's source must be) and the ring fits, else ``plain``.  Decided
    before the launch; both are counted."""
    return "bulk" if ring_fits and all(p % 16 == 0 for p in ptrs) else "plain"


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def elemred_reference(program, leaf_vals) -> tuple:
    """Plain PyTorch version: the program's instructions through the port's
    ``OPS`` table, with the generic lowering's NumPy dtype rules."""
    return run_instructions(program, leaf_vals)


# ---------------------------------------------------------------------------
# plan: everything the generated source depends on
# ---------------------------------------------------------------------------

_OP = {"sum": "OpSum", "mean": "OpSum", "prod": "OpProd", "min": "OpMin",
       "max": "OpMax"}


def _leaf_kind(v) -> str:
    """``vec`` (a 1-D tensor), ``dev`` (a 0-d CUDA tensor, passed by
    pointer) or ``host`` (a value passed by value)."""
    if isinstance(v, torch.Tensor):
        if v.ndim == 1:
            return "vec"
        if v.device.type == "cuda":
            return "dev"
    return "host"


class _Plan:
    """Cast plan, slot roles, geometry and generated source of one program
    on one leaf signature."""

    def __init__(self, program, leaf_vals, base: Config = CONFIG):
        self.program = program
        n_leaves = program.n_leaves
        self.avals = kb.all_slot_avals(program, leaf_vals)
        self.kinds = [_leaf_kind(v) for v in leaf_vals]
        self.is_vec = [k == "vec" for k in self.kinds]
        self.reduce_meta: dict = {}
        for i, (op, static, argslots) in enumerate(program.instrs):
            slot = n_leaves + i
            if op == "reduce":
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
        leaf_sizes = [self.avals[s].dtype.itemsize for s in self.vec_leaves]
        out_sizes = [self.avals[s].dtype.itemsize for s in self.vec_out]
        self.config, self.vec = config_for(leaf_sizes, out_sizes, base)
        self.ept = self.config.ept
        self.smem = smem_bytes(leaf_sizes, self.ept, self.config.stages)
        self.ring_fits = self.smem <= SMEM_LIMIT
        self.source = self._generate()
        self.name = "elemred_" + hashlib.sha256(
            self.source.encode()).hexdigest()[:12]

    # -- per-element code ------------------------------------------------------

    def _part(self, s):
        return f"x{s}", self.avals[s], None

    def _ct(self, s) -> str:
        return cx.ctype(self.avals[s].dtype)

    def _sincos_pairs(self) -> dict:
        """slot -> (pair id, 'sn' or 'cs') for every sin matched with a cos
        of the same operand in the same loop dtype (k-th with k-th)."""
        if not self.config.sincos:
            return {}
        seen: dict = {}
        for i, (op, static, argslots) in enumerate(self.program.instrs):
            if op == "map" and static[0] in ("sin", "cos"):
                casts, _out = kb.map_cast_plan(
                    static[0], [self.avals[s] for s in argslots])
                key = (argslots[0], casts[0].name)
                seen.setdefault(key, {"sin": [], "cos": []})[static[0]].append(
                    self.program.n_leaves + i)
        pairs: dict = {}
        for slots in seen.values():
            for s, c in zip(slots["sin"], slots["cos"]):
                pid = len(pairs) // 2
                pairs[s], pairs[c] = (pid, "sn"), (pid, "cs")
        return pairs

    def _element_code(self) -> list:
        """C++ statements computing every instruction for element v of
        group j (``ok``: the element lies below n)."""
        prog, av = self.program, self.avals
        n_leaves = prog.n_leaves
        lines = []
        for s in self.vec_leaves:
            lines.append(f"const {self._ct(s)} x{s} = r.x{s}[j].v[v];")
        for s in self.scalar_leaves:
            ct = self._ct(s)
            if self.kinds[s] == "dev":
                lines.append(f"const {ct} x{s} = *static_cast<const {ct}*>(p.s{s});")
            elif ct == "bool":
                lines.append(f"const bool x{s} = p.s{s} != 0;")
            else:
                lines.append(f"const {ct} x{s} = ({ct})p.s{s};")
        gen = cx.Gen()
        pairs = self._sincos_pairs()
        done = set()
        for i, (op, static, argslots) in enumerate(prog.instrs):
            slot = n_leaves + i
            ct = self._ct(slot)
            if op == "map" and slot in pairs:
                pid, which = pairs[slot]
                casts, _out = kb.map_cast_plan(static[0],
                                               [av[s] for s in argslots])
                lt = cx.ctype(casts[0])
                if pid not in done:
                    arg = gen.cast(self._part(argslots[0]), casts[0])
                    sfx = "f" if lt == "float" else ""
                    lines.append(f"{lt} sn{pid}, cs{pid};")
                    lines.append(f"sincos{sfx}({arg}, &sn{pid}, &cs{pid});")
                    done.add(pid)
                code = gen.cast((f"{which}{pid}", Aval((), casts[0]), None),
                                av[slot].dtype)
            elif op == "map":
                code, out_av, _lit = gen.map(static[0],
                                             [self._part(s) for s in argslots])
                if out_av.dtype != av[slot].dtype:
                    raise cx.Unsupported(f"{static[0]}: {out_av.dtype} vs "
                                         f"{av[slot].dtype}")
            elif op == "cast":
                code = gen.cast(self._part(argslots[0]), av[slot].dtype)
            elif op == "round":
                code = self._round(f"x{argslots[0]}", av[slot].dtype,
                                   int(static[0]))
            else:  # reduce: into this position's accumulator
                fname, acc_dt = self.reduce_meta[slot]
                x = gen.cast(self._part(argslots[0]), acc_dt)
                ident = cx.lit_code(kb.reduce_identity_np(fname, acc_dt), acc_dt)
                acc = f"a.r{slot}[j * V + v]"
                lines.append(f"{acc} = {_OP[fname]}::comb({acc}, ok ? "
                             f"({x}) : {ident});")
                continue
            lines.append(f"const {ct} x{slot} = {code};")
        for s in self.vec_out:
            lines.append(f"o{s}.v[v] = x{s};")
        return lines

    @staticmethod
    def _round(code: str, dt: np.dtype, decimals: int) -> str:
        """``round`` as the plain version computes it: integers unchanged
        (decimals >= 0: the classifier), floats ``rint(x * f) / f`` with
        ``f = 10**decimals`` in their dtype."""
        if dt.kind != "f":
            return code
        sfx = "f" if dt.name == "float32" else ""
        if decimals == 0:
            return f"rint{sfx}({code})"
        f = cx.lit_code(10.0 ** decimals, dt)
        return f"(rint{sfx}({code} * {f}) / {f})"

    # -- source ---------------------------------------------------------------

    def _generate(self) -> str:
        av = self.avals
        cfg = self.config
        nv, no, nr = len(self.vec_leaves), len(self.vec_out), len(self.red_out)
        offs, off = {}, 0
        for s in self.vec_leaves:
            offs[s] = off
            off += -(-(NT * self.ept * av[s].dtype.itemsize) // 128) * 128
        stage = off
        ind = "      "
        params = [f"const void* in[{max(nv, 1)}];", f"void* out[{max(no, 1)}];",
                  f"void* part[{max(nr, 1)}];", f"void* red[{max(nr, 1)}];",
                  "long long n;"]
        scal_args = []
        for s in self.scalar_leaves:
            if self.kinds[s] == "dev":
                params.append(f"const void* s{s};")
                scal_args.append(f"const void* s{s}")
            elif av[s].dtype.kind == "f":
                params.append(f"double s{s};")
                scal_args.append(f"double s{s}")
            else:
                params.append(f"long long s{s};")
                scal_args.append(f"long long s{s}")
        regs = [f"Vec<{self._ct(s)}, V> x{s}[G];" for s in self.vec_leaves]
        accs = [f"{cx.ctype(self.reduce_meta[s][1])} r{s}[EPT];"
                for s in self.red_out]
        init, finish, fold = [], [], []
        for k, s in enumerate(self.red_out):
            fname, acc_dt = self.reduce_meta[s]
            ct = cx.ctype(acc_dt)
            ident = cx.lit_code(kb.reduce_identity_np(fname, acc_dt), acc_dt)
            init.append(f"for (int k = 0; k < EPT; ++k) a.r{s}[k] = {ident};")
            finish.append(f"write_partial<{_OP[fname]}, {ct}, EPT>(a.r{s}, "
                          f"{ident}, p.part[{k}]);")
            fold.append(f"case {k}: ramba::elemred::fold<{_OP[fname]}, {ct}>("
                        f"p.part[{k}], p.red[{k}], grid, {ident}); break;")
        issue = ["const long long c = count < TILE ? count : TILE;"]
        total = []
        for k, s in enumerate(self.vec_leaves):
            es = av[s].dtype.itemsize
            issue.append(f"const uint32_t b{k} = bulk_bytes(c, {es});")
            total.append(f"b{k}")
        issue.append(f"ramba::mbar_expect_tx(bar, {' + '.join(total) or '0'});")
        tail, load_s, load_g = [], [], []
        for k, s in enumerate(self.vec_leaves):
            ct, es = self._ct(s), av[s].dtype.itemsize
            issue.append(
                f"if (b{k}) bulk_load(stage + {offs[s]}, static_cast<const "
                f"unsigned char*>(p.in[{k}]) + t0 * {es}, b{k}, bar);")
            tail.append(f"ramba::elemred::fill_tail<{ct}>(stage + {offs[s]}, "
                        f"p.in[{k}], t0, count);")
            load_s.append(f"r.x{s}[j] = reinterpret_cast<const Vec<{ct}, V>*>("
                          f"stage + {offs[s]})[j * NT + t];")
            load_g.append(f"r.x{s}[j].v[v] = e + v < count ? static_cast<const "
                          f"{ct}*>(p.in[{k}])[t0 + e + v] : ({ct})0;")
        outs_decl = [f"Vec<{self._ct(s)}, V> o{s};" for s in self.vec_out]
        stores = []
        for k, s in enumerate(self.vec_out):
            ct = self._ct(s)
            stores += [
                f"{ct}* out{s} = static_cast<{ct}*>(p.out[{k}]) + t0 + e;",
                f"if (e + V <= count) {{",
                f"  *reinterpret_cast<Vec<{ct}, V>*>(out{s}) = o{s};",
                "} else {",
                f"  for (int v = 0; v < V; ++v) if (e + v < count) out{s}[v] = o{s}.v[v];",
                "}",
            ]
        body = self._element_code()

        def block(lines, pad):
            return "\n".join(pad + ln for ln in lines)

        pack = [f"for (int k = 0; k < {nv}; ++k) p.in[k] = in[k];",
                f"for (int k = 0; k < {no}; ++k) p.out[k] = out[k];",
                f"for (int k = 0; k < {nr}; ++k) p.part[k] = part[k];",
                f"for (int k = 0; k < {nr}; ++k) p.red[k] = red[k];",
                "p.n = n;"] + [f"p.s{s} = s{s};" for s in self.scalar_leaves]
        entry_args = ", ".join(["int path", "int grid", "const void* const* in",
                                "void* const* out", "void* const* part",
                                "void* const* red", "long long n", "void* stream"]
                               + scal_args)
        return f"""// generated by ramba_tpu_torch/ops/elemred.py: one fused program
#include "elemred.cuh"

using namespace ramba::elemred;

// the program; at file scope (the kernels' parameter types must not live
// in an unnamed namespace: nvcc's host stubs cannot name them)
struct P {{
  static constexpr int EPT = {self.ept}, V = {self.vec}, G = EPT / V;
  static constexpr int STAGES = {cfg.stages}, MIN_CTAS = {cfg.min_ctas}, NR = {nr};
  static constexpr long long TILE = (long long)NT * EPT;
  // a stage: one tile of each vector leaf, each on 128 bytes
  static constexpr int STAGE_BYTES = {stage};
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 8 * STAGES;

  struct Params {{
{block(params, "    ")}
  }};
  struct Regs {{
{block(regs, "    ")}
  }};
  struct Acc {{
{block(accs or ["char unused;"], "    ")}
  }};

  __device__ static void init(Acc& a) {{
{block(init, "    ")}
  }}
  __device__ static void issue(const Params& p, unsigned char* stage,
                               uint64_t* bar, long long t0, long long count) {{
{block(issue, "    ")}
  }}
  __device__ static void fill_tail(const Params& p, unsigned char* stage,
                                   long long t0, long long count) {{
{block(tail, "    ")}
  }}
  __device__ static void load_stage(Regs& r, const unsigned char* stage) {{
    const int t = threadIdx.x;
#pragma unroll
    for (int j = 0; j < G; ++j) {{
{block(load_s, ind)}
    }}
  }}
  __device__ static void load_global(Regs& r, const Params& p, long long t0,
                                     long long count) {{
    const int t = threadIdx.x;
#pragma unroll
    for (int j = 0; j < G; ++j) {{
      const long long e = (long long)j * NT * V + t * V;
#pragma unroll
      for (int v = 0; v < V; ++v) {{
{block(load_g, ind + "  ")}
      }}
    }}
  }}
  __device__ static void compute(const Params& p, const Regs& r, long long t0,
                                 long long count, Acc& a) {{
    const int t = threadIdx.x;
#pragma unroll
    for (int j = 0; j < G; ++j) {{
      const long long e = (long long)j * NT * V + t * V;
{block(outs_decl, ind)}
#pragma unroll
      for (int v = 0; v < V; ++v) {{
        const bool ok = e + v < count;
{block(body, ind + "  ")}
      }}
{block(stores, ind)}
    }}
  }}
  __device__ static void finish(const Params& p, Acc& a) {{
{block(finish, "    ")}
  }}
  __device__ static void fold(const Params& p, int grid) {{
    switch (blockIdx.x) {{
{block(fold, "      ")}
    }}
  }}
}};

// ring: {cfg.stages} stages of {stage} bytes, {self.smem} bytes of shared memory
extern "C" int ramba_elemred_launch({entry_args}) {{
  P::Params p;
{block(pack, "  ")}
  return ramba::elemred::launch<P>(path, grid, p, stream);
}}

extern "C" int ramba_elemred_ctas_per_sm(int path) {{
  return ramba::elemred::ctas_per_sm<P>(path);
}}
"""

    def argtypes(self) -> list:
        """ctypes argument types of the generated entry point."""
        types = [ctypes.c_int, ctypes.c_int] + [ctypes.POINTER(ctypes.c_void_p)] * 4
        types += [ctypes.c_longlong, ctypes.c_void_p]
        for s in self.scalar_leaves:
            if self.kinds[s] == "dev":
                types.append(ctypes.c_void_p)
            elif self.avals[s].dtype.kind == "f":
                types.append(ctypes.c_double)
            else:
                types.append(ctypes.c_longlong)
        return types


# ---------------------------------------------------------------------------
# build + launch
# ---------------------------------------------------------------------------

_plans: dict = {}
_PLANS_MAX = 512
_entries: dict = {}
_occupancy: dict = {}
_sms: dict = {}
_lock = threading.Lock()


def plan_for(program, leaf_vals, config: Config = CONFIG) -> _Plan:
    key = (program.key, config,
           tuple((tuple(getattr(v, "shape", ())), kb.aval_of(v).dtype,
                  kb.aval_of(v).weak, _leaf_kind(v)) for v in leaf_vals))
    with _lock:
        p = _plans.get(key)
        if p is None:
            if len(_plans) >= _PLANS_MAX:
                _plans.pop(next(iter(_plans)))
            p = _plans[key] = _Plan(program, leaf_vals, config)
        return p


def build(plans) -> None:
    """Compile the given plans' sources, one ``nvcc`` per source, all at
    once."""
    _build.build_many([(p.name, p.source) for p in plans])


def _entry(plan: _Plan):
    """The built kernel's C entry points (built and bound once)."""
    with _lock:
        fns = _entries.get(plan.name)
    if fns is None:
        lib = _build.load(plan.name, plan.source)
        fn = lib.ramba_elemred_launch
        fn.argtypes = plan.argtypes()
        fn.restype = ctypes.c_int
        occ = lib.ramba_elemred_ctas_per_sm
        occ.argtypes = [ctypes.c_int]
        occ.restype = ctypes.c_int
        fns = (fn, occ)
        with _lock:
            _entries[plan.name] = fns
    return fns


def ctas_per_sm(plan: _Plan, path: str, dev) -> int:
    """CTAs of the plan's kernel one SM of ``dev`` holds at once along
    ``path`` (its occupancy; the grid is that times the SMs)."""
    key = (plan.name, path, dev.index)
    occ = _occupancy.get(key)
    if occ is None:
        with torch.cuda.device(dev):
            occ = _entry(plan)[1](PATHS.index(path))
        if occ <= 0:
            raise RuntimeError(f"elemred kernel ({path}) does not fit on an SM")
        _occupancy[key] = occ
    return occ


def _sm_count(dev) -> int:
    n = _sms.get(dev.index)
    if n is None:
        n = _sms[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return n


def geometry(program, leaf_vals, config: Config = CONFIG) -> tuple:
    """``(path, grid, ept)`` a launch of this program on these CUDA leaves
    takes."""
    plan = plan_for(program, leaf_vals, config)
    n = kb.vector_length(leaf_vals)
    dev = leaf_vals[plan.vec_leaves[0]].device
    path = load_path([leaf_vals[s].data_ptr() for s in plan.vec_leaves],
                     plan.ring_fits)
    grid = schedule(n, plan.ept, ctas_per_sm(plan, path, dev) * _sm_count(dev))
    return path, grid, plan.ept


def _ptrs(values):
    return (ctypes.c_void_p * max(len(values), 1))(*values)


def launch(program, leaf_vals, config: Config = CONFIG) -> tuple:
    """Launch the generated kernel (and its fold, for reductions) on CUDA
    leaves along the load path :func:`load_path` picks; returns the
    program's outputs.  ``config`` other than the default serves the
    sweep and the sincos check."""
    global launches, launches_bulk, launches_plain
    plan = plan_for(program, leaf_vals, config)
    n = kb.vector_length(leaf_vals)
    av = plan.avals
    vecs = [leaf_vals[s] for s in plan.vec_leaves]
    dev = vecs[0].device
    if dev.type != "cuda" or any(v.device != dev for v in vecs):
        raise RuntimeError(f"elemred kernel: operands on {dev}, expected cuda")
    vecs = [v if v.is_contiguous() else v.contiguous() for v in vecs]
    ptrs = [v.data_ptr() for v in vecs]
    path = load_path(ptrs, plan.ring_fits)
    grid = schedule(n, plan.ept, ctas_per_sm(plan, path, dev) * _sm_count(dev))
    outs = {s: torch.empty(n, dtype=to_torch_dtype(av[s].dtype), device=dev)
            for s in plan.vec_out}
    parts, reds = [], []
    for s in plan.red_out:
        acc = to_torch_dtype(plan.reduce_meta[s][1])
        parts.append(torch.empty(grid, dtype=acc, device=dev))
        reds.append(torch.empty(1, dtype=acc, device=dev))
    scalars = []
    for s in plan.scalar_leaves:
        v = leaf_vals[s]
        if plan.kinds[s] == "dev":
            if v.device != dev:
                raise RuntimeError("elemred kernel: a 0-d operand on "
                                   f"{v.device}, expected {dev}")
            scalars.append(v.data_ptr())
        else:
            v = v.item() if isinstance(v, (torch.Tensor, np.generic)) else v
            # an int travels as long long; the kernel's C casts wrap it to
            # the width it is used at, as the generic lowering does
            scalars.append(float(v) if av[s].dtype.kind == "f"
                           else wrap_int(int(v), torch.int64))
    fn = _entry(plan)[0]  # a first plan builds it: seconds of nvcc
    _elastic.abandon_if_cancelled("a launch")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(PATHS.index(path), grid, _ptrs(ptrs),
                _ptrs([outs[s].data_ptr() for s in plan.vec_out]),
                _ptrs([t.data_ptr() for t in parts]),
                _ptrs([t.data_ptr() for t in reds]), n, stream, *scalars)
    if rc != 0:
        raise RuntimeError(f"elemred kernel launch ({path}) failed: "
                           f"{'occupancy 0' if rc == 901 else f'CUDA error {rc}'}")
    launches += 1
    if path == "bulk":
        launches_bulk += 1
    else:
        launches_plain += 1
    by_slot = dict(outs)
    for s, r in zip(plan.red_out, reds):
        fname, _acc = plan.reduce_meta[s]
        r = r.reshape(())
        if fname == "mean":
            r = r / n
        want = to_torch_dtype(av[s].dtype)
        by_slot[s] = r if r.dtype == want else r.to(want)
    return tuple(leaf_vals[s] if s < program.n_leaves else by_slot[s]
                 for s in program.out_slots)


def cost(program, leaf_vals) -> tuple:
    """``(flops, bytes)`` of one run as the plan counts them, the counts
    behind the bound of ``PERF.md``'s kernel table: one operation per
    element for every ``map``, ``round`` and reduction of the chain
    (casts count none; ``sin`` counts one, whatever its instructions);
    each vector leaf read once and each output written once (a vector
    output n elements, a reduction one value)."""
    n = kb.vector_length(leaf_vals)
    avals = kb.all_slot_avals(program, leaf_vals)
    n_leaves = program.n_leaves
    is_vec = [_leaf_kind(v) == "vec" for v in leaf_vals]
    ops = 0
    for op, _static, argslots in program.instrs:
        is_vec.append(op != "reduce" and any(is_vec[s] for s in argslots))
        ops += op in ("map", "round", "reduce")
    nbytes = sum(n * avals[s].dtype.itemsize
                 for s in range(n_leaves) if is_vec[s])
    nbytes += sum((n if is_vec[s] else 1) * avals[s].dtype.itemsize
                  for s in program.out_slots)
    return float(ops * n), float(nbytes)


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


kb.register_family("elemred", available=kb.supports, run=run)
