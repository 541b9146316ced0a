"""scan: cumsum/cumprod of floats through a hand-written fixed-order CUDA C++
kernel.

No Pallas kernel of ``ramba_tpu`` corresponds to it.  XLA's scan gives the
same bytes on every run, while ``torch.cumsum`` of floats on the card does
not (two calls on the same 2^28 float64 values differed by up to 1.3e-10).
The ``cumulative`` op (``core/expr.py``) sends float16, bfloat16, float32
and float64 scans here, so a rerun gives the same bytes.

What it computes: the inclusive sum or product along ``axis``.  float16 and
bfloat16 accumulate in float32 and round each output once, as torch does.

Design (``csrc/scan.cuh``): the scanned axis is moved last and the data
cut into contiguous rows (a strided axis is copied into rows first).  A row
is cut into tiles of ``TILE`` elements, and the order of every operation is
fixed by the tile index alone.  One launch: persistent CTAs take tiles in
increasing order from a global counter; each tile scans itself once (a
thread's ``ITEMS`` elements folded left to right, a Kogge-Stone scan over
the ``THREADS`` thread sums), publishes its total, and takes its carry
from the totals of the tiles before it back to the last checkpoint (every
``K``-th tile, which publishes its inclusive prefix instead; see
:func:`_carries`).  Only the checkpoints form a serial chain.  One source
holds the eight entry points (four dtypes, sum and product); ``nvcc``
builds it for ``sm_90a`` into a shared library loaded with ``ctypes``
(``_build.py``).

Bound on the H100: HBM bandwidth, the data read once and the result
written once (``2 * numel * itemsize`` bytes at 3.35 TB/s).  The kernel
moves that, plus one value and one flag per tile.

Beside it: :func:`scan_reference`, the plain PyTorch version, which
computes the same tiles in the same order with torch ops (so it gives the
kernel's bytes), and ``launches``, counted once per launch.  :func:`run`
takes the plain version only for CPU tensors; on CUDA tensors it launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ramba_tpu_torch import _build

launches = 0

# must match csrc/scan.cuh
THREADS = 256
ITEMS = 16
TILE = THREADS * ITEMS
K = 128  # tiles per checkpoint
LEVELS = THREADS.bit_length() - 1  # Kogge-Stone levels over THREADS values

DTYPES = (torch.float16, torch.bfloat16, torch.float32, torch.float64)
_CTYPE = {torch.float16: "__half", torch.bfloat16: "__nv_bfloat16",
          torch.float32: "float", torch.float64: "double"}
_TAG = {torch.float16: "f16", torch.bfloat16: "bf16", torch.float32: "f32",
        torch.float64: "f64"}
_OPS = {"cumsum": ("sum", "OpSum"), "cumprod": ("prod", "OpProd")}


def acc_dtype(tdt: torch.dtype) -> torch.dtype:
    """What the scan accumulates in: float32 for the 16-bit floats."""
    return torch.float32 if tdt in (torch.float16, torch.bfloat16) else tdt


def tiles(n: int) -> int:
    return -(-n // TILE)


def carry_depth(t: int) -> int:
    """The longest chain of roundings inside the carry of a row of t tiles.
    Before the first checkpoint a carry is a left fold of up to t - 1
    totals (t - 2 roundings).  Past it, a total goes through up to K - 1
    folds into its checkpoint's window and one combine into that
    checkpoint's prefix (none for the first), then one combine per later
    checkpoint (one hop each) and one into the carry: K - 1 + (t - 1) // K
    in all, which also covers a total in the carry's own window (up to
    K - 2 folds and the combine with the prefix)."""
    if t <= K:
        return max(t - 2, 0)
    return K - 1 + (t - 1) // K


def depth(n: int) -> int:
    """The longest chain of roundings behind one output of a row of n:
    where the row has more than one tile, a tile total (ITEMS - 1 folds,
    LEVELS levels) and the carry (:func:`carry_depth`); then the output's
    own fold, its thread's exclusive value and the two combines in front.
    A sum is within ``depth(n) * eps/2 * sum|x|`` of the exact prefix
    (first order)."""
    t = tiles(n)
    carry = ITEMS - 1 + LEVELS + carry_depth(t) if t > 1 else 0
    return carry + ITEMS - 1 + LEVELS + LEVELS + 2


def _as_rows(x: torch.Tensor, axis: int):
    """(contiguous (rows, n) tensor, the shape it came from with the axis
    moved last)."""
    moved = x.movedim(axis, -1)
    shape = tuple(moved.shape)
    return moved.contiguous().reshape(-1, shape[-1]), shape


def _from_rows(r: torch.Tensor, shape, axis: int) -> torch.Tensor:
    return r.reshape(shape).movedim(-1, axis).contiguous()


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _kogge_stone(v: torch.Tensor, op) -> torch.Tensor:
    """Inclusive Kogge-Stone scan along the last dim, as the kernel's."""
    d = 1
    while d < v.shape[-1]:
        nv = v.clone()
        nv[..., d:] = op(v[..., :-d], v[..., d:])
        v, d = nv, d * 2
    return v


def _carries(tot: torch.Tensor, op, ident) -> torch.Tensor:
    """Each tile's exclusive carry from the (rows, T) tile totals A, as the
    kernel defines it (column 0, which no tile reads, holds the identity).

    Tile j's window starts at s = (j // K) * K, after the last checkpoint
    c = s - 1 (tiles with j % K == K - 1).  With L_j = A_s op ... op A_{j-1}
    folded left to right, E_j = P_c op L_j (P_c when j == s, L_j when
    s == 0), and a checkpoint's prefix is P_j = P_c op (L_j op A_j)
    ((L_j op A_j) when s == 0).  The window folds run over the K slots for
    every window at once, the prefixes over the T / K checkpoints."""
    R, T = tot.shape
    G = -(-T // K)
    pad = torch.full((R, G * K), ident, dtype=tot.dtype, device=tot.device)
    pad[:, :T] = tot
    a = pad.reshape(R, G, K)
    m = a.clone()  # m[:, w, q] = A_{wK} op ... op A_{wK+q}
    for q in range(1, K):
        m[..., q] = op(m[..., q - 1], a[..., q])
    p = m[..., K - 1].clone()  # p[:, w] = P at the w-th checkpoint
    for w in range(1, G):
        p[:, w] = op(p[:, w - 1], m[:, w, K - 1])
    carry = torch.full_like(a, ident)
    carry[:, 0, 1:] = m[:, 0, :-1]
    if G > 1:
        carry[:, 1:, 0] = p[:, :-1]
        carry[:, 1:, 1:] = op(p[:, :-1, None], m[:, 1:, :-1])
    return carry.reshape(R, G * K)[:, :T]


def _reference_rows(x: torch.Tensor, fname: str) -> torch.Tensor:
    R, n = x.shape
    op = torch.add if fname == "cumsum" else torch.mul
    ident = 0.0 if fname == "cumsum" else 1.0
    T = tiles(n)
    v = torch.full((R, T * TILE), ident, dtype=acc_dtype(x.dtype),
                   device=x.device)
    v[:, :n] = x
    v = v.reshape(R, T, THREADS, ITEMS)
    loc = torch.empty_like(v)
    loc[..., 0] = v[..., 0]
    for k in range(1, ITEMS):
        loc[..., k] = op(loc[..., k - 1], v[..., k])
    ks = _kogge_stone(loc[..., ITEMS - 1], op)  # (R, T, THREADS)
    w = loc.clone()
    w[:, :, 1:, :] = op(ks[:, :, :-1, None], loc[:, :, 1:, :])
    if T > 1:
        carry = _carries(ks[..., -1], op, ident)
        w[:, 1:] = op(carry[:, 1:, None, None], w[:, 1:])
    return w.reshape(R, T * TILE)[:, :n].to(x.dtype)


def scan_reference(x: torch.Tensor, fname: str, axis: int) -> torch.Tensor:
    """Plain PyTorch version: the kernel's tiles, folds and Kogge-Stone
    levels in its order, one torch op per step."""
    if x.numel() == 0:
        return x.clone()
    rows, shape = _as_rows(x, axis)
    return _from_rows(_reference_rows(rows, fname), shape, axis)


# ---------------------------------------------------------------------------
# code generation and launch
# ---------------------------------------------------------------------------


def entry_name(tdt: torch.dtype, fname: str) -> str:
    return f"ramba_scan_{_TAG[tdt]}_{_OPS[fname][0]}"


def _source() -> str:
    entries = []
    for tdt in DTYPES:
        for fname, (_k, op) in _OPS.items():
            entries.append(f"""
extern "C" int {entry_name(tdt, fname)}(const void* x, void* out, void* val,
                                  void* status, long long rows, long long n,
                                  int grid, void* stream) {{
  return ramba::scan::launch<{_CTYPE[tdt]}, ramba::scan::{op}>(
      x, out, val, status, rows, n, grid, stream);
}}""")
    return "// generated by ramba_tpu_torch/ops/scan.py\n#include \"scan.cuh\"\n" \
        + "".join(entries) + "\n"


SOURCE = _source()
NAME = "scan"

_entries: dict = {}
_lock = threading.Lock()


def _entry(tdt: torch.dtype, fname: str):
    """The built kernel's C entry point (built and bound once)."""
    key = (tdt, fname)
    with _lock:
        fn = _entries.get(key)
    if fn is None:
        fn = getattr(_build.load(NAME, SOURCE), entry_name(tdt, fname))
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + \
            [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        with _lock:
            _entries[key] = fn
    return fn


def grid(dev: torch.device) -> int:
    """CTAs per launch: six per SM, 792 on an H100 (four fit an SM at a
    time; the rest start as CTAs finish and claim what is left), more than
    the K tiles between checkpoints.  The result does not depend on it."""
    return torch.cuda.get_device_properties(dev).multi_processor_count * 6


def status_bytes(num_tiles: int) -> int:
    """The tile counter (8 bytes), then one 4-byte flag per tile."""
    return 8 + 4 * num_tiles


def launch(x: torch.Tensor, fname: str, axis: int, ctas: int | None = None
           ) -> torch.Tensor:
    """Launch the kernel on a CUDA tensor, on ``ctas`` CTAs (default
    :func:`grid`); returns the scan along ``axis``."""
    global launches
    if x.device.type != "cuda":
        raise RuntimeError(f"scan kernel: operand on {x.device}, expected cuda")
    if x.dtype not in DTYPES or fname not in _OPS:
        raise ValueError(f"scan kernel: no {fname} of {x.dtype}")
    if x.numel() == 0:
        return x.clone()
    rows, shape = _as_rows(x, axis)
    R, n = rows.shape
    out = torch.empty_like(rows)
    num = R * tiles(n)
    val = torch.empty(num, dtype=acc_dtype(x.dtype), device=x.device)
    status = torch.empty(status_bytes(num), dtype=torch.uint8, device=x.device)
    fn = _entry(x.dtype, fname)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(rows.data_ptr(), out.data_ptr(), val.data_ptr(),
                status.data_ptr(), R, n, max(1, ctas or grid(x.device)),
                stream)
    if rc != 0:
        raise RuntimeError(f"scan kernel launch failed: CUDA error {rc}")
    launches += 1
    return _from_rows(out, shape, axis)


def run(x: torch.Tensor, fname: str, axis: int) -> torch.Tensor:
    """The wrapper.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (or raises)."""
    if x.device.type == "cpu":
        return scan_reference(x, fname, axis)
    if x.device.type != "cuda":
        raise RuntimeError(f"scan: operand on {x.device}, expected cuda")
    return launch(x, fname, axis)
