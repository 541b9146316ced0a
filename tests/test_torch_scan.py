"""The fixed-order scan (``ops/scan.py``): its plain version against
ramba_tpu's cumsum/cumprod, x64 regime, and its tiling.

On the CPU the ``cumulative`` op runs the scan's plain version, which
computes the kernel's tiles, folds and Kogge-Stone levels in the kernel's
order.  Against ramba_tpu (XLA's scan, another order) a float sum is held
within the rounding-depth bound ``2 * depth * eps * cumsum|x|`` per output
(``scan.depth``: the longest chain of roundings behind an output; twice
covers an order up to three times as deep), float16 and bfloat16 within
one rounding of their output more; a product within
``10 * sqrt(n) * eps * |prefix product|`` (Higham and Mary's probabilistic
bound, as ``chip_smoke.py`` holds products).  Values k/2^20, whose every
prefix sum is exact, must agree exactly.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import ramba_tpu as rtj
import ramba_tpu_torch as rt
from ramba_tpu_torch import common, convert
from ramba_tpu_torch.ops import scan

EPS = {"float16": 2.0 ** -10, "float32": 2.0 ** -23, "float64": 2.0 ** -52}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    if not jax.config.jax_enable_x64:
        pytest.skip("the port follows NumPy's dtypes: the x64 leg only")
    common.set_device("cpu")
    torch.set_num_threads(1)


def _pair(**arrays):
    ref = {k: rtj.fromarray(v) for k, v in arrays.items()}
    port = convert.state_from_reference({k: a.asarray()
                                         for k, a in ref.items()})
    return ref, port


def _cum_abs(x, axis):
    return np.cumsum(np.abs(x.astype(np.float64)), axis=axis)


# lengths around the tile and the checkpoints: one tile, a ragged second
# tile, several tiles, a checkpoint's window less or more one element,
# more than two checkpoints
LENGTHS = [1, 7, scan.TILE, scan.TILE + 1, 5 * scan.TILE - 3,
           scan.K * scan.TILE - 1, scan.K * scan.TILE + 1,
           scan.THREADS * scan.TILE + 2 * scan.TILE + 11]


@pytest.mark.parametrize("dtype", ["float16", "float32", "float64"])
@pytest.mark.parametrize("n", LENGTHS)
def test_cumsum_against_ramba_tpu(n, dtype):
    x = np.random.RandomState(n % 97).randn(n).astype(dtype)
    ref, port = _pair(x=x)
    got = rt.cumsum(port["x"]).asarray()
    want = rtj.cumsum(ref["x"]).asarray()
    assert got.dtype == want.dtype == np.dtype(dtype)
    bound = 2 * scan.depth(n) * EPS[dtype] * _cum_abs(x, 0)
    if dtype == "float16":  # each output rounds once to float16
        bound += 2 * EPS[dtype] * np.abs(want.astype(np.float64))
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert (err <= bound).all(), np.max(err / bound)


@pytest.mark.parametrize("axis", [0, 1, 2, -1])
@pytest.mark.parametrize("name", ["cumsum", "cumprod"])
def test_axes_against_ramba_tpu(name, axis):
    x = 1 + 0.01 * np.random.RandomState(3).randn(3, 2 * scan.TILE + 5, 4)
    ref, port = _pair(x=x)
    got = getattr(rt, name)(port["x"], axis).asarray()
    want = getattr(rtj, name)(ref["x"], axis).asarray()
    assert got.dtype == want.dtype and got.shape == want.shape
    n = x.shape[axis]
    if name == "cumsum":
        bound = 2 * scan.depth(n) * EPS["float64"] * _cum_abs(x, axis)
    else:
        bound = 10 * np.sqrt(n) * EPS["float64"] * np.abs(want)
    assert (np.abs(got - want) <= bound).all()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_two_rows_across_checkpoints_against_ramba_tpu(dtype):
    """Two rows of (2K + 3) tiles and a ragged tail along axis 1: each row
    its own checkpoint chain."""
    n = (2 * scan.K + 3) * scan.TILE + 11
    x = np.random.RandomState(14).randn(2, n).astype(dtype)
    ref, port = _pair(x=x)
    got = rt.cumsum(port["x"], 1).asarray()
    want = rtj.cumsum(ref["x"], 1).asarray()
    assert got.dtype == want.dtype == np.dtype(dtype)
    bound = 2 * scan.depth(n) * EPS[dtype] * _cum_abs(x, 1)
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert (err <= bound).all(), np.max(err / bound)
    rows = scan.scan_reference(torch.from_numpy(x), "cumsum", 1)
    assert torch.equal(rows[1], scan.scan_reference(torch.from_numpy(x[1]),
                                                    "cumsum", 0))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_exact_prefixes_are_equal(dtype):
    """k/2^20 values: every prefix sum is exact in any order."""
    rs = np.random.RandomState(4)
    x = (rs.randint(-(1 << 10), 1 << 10, 3 * scan.TILE + 9)
         * 2.0 ** -20).astype(dtype)
    ref, port = _pair(x=x)
    np.testing.assert_array_equal(rt.cumsum(port["x"]).asarray(),
                                  rtj.cumsum(ref["x"]).asarray())
    np.testing.assert_array_equal(port["x"].cumsum().asarray(),
                                  np.cumsum(x.astype(np.float64)).astype(dtype))


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float32,
                                   torch.float64])
@pytest.mark.parametrize("name", ["cumsum", "cumprod"])
def test_plain_version_is_the_kernel_order(name, dtype):
    """The plain version spelled out by hand for a two-tile row: each
    thread's left fold, the Kogge-Stone combine of the thread sums in
    front, the first tile's total in front of the second."""
    op = torch.add if name == "cumsum" else torch.mul
    n = scan.TILE + 3 * scan.ITEMS + 2
    x = (1 + 0.1 * torch.randn(n, generator=torch.Generator().manual_seed(5),
                               dtype=torch.float64)).to(dtype)
    got = scan.scan_reference(x, name, 0)
    acc = scan.acc_dtype(dtype)
    xa = x.to(acc)
    want = torch.empty(n, dtype=acc)
    carry = None
    for t0 in range(0, n, scan.TILE):
        tile = xa[t0:t0 + scan.TILE]
        sums, locs = [], []
        for s0 in range(0, len(tile), scan.ITEMS):
            loc = [tile[s0]]
            for v in tile[s0 + 1:s0 + scan.ITEMS]:
                loc.append(op(loc[-1], v))
            locs.append(loc)
            sums.append(loc[-1])
        # pad the thread sums with the identity, as a ragged tile does
        ident = torch.tensor(0.0 if name == "cumsum" else 1.0, dtype=acc)
        ks = torch.stack(sums + [ident] * (scan.THREADS - len(sums)))
        ks = scan._kogge_stone(ks, op)
        out = []
        for t, loc in enumerate(locs):
            for v in loc:
                w = v if t == 0 else op(ks[t - 1], v)
                out.append(w if carry is None else op(carry, w))
        want[t0:t0 + len(tile)] = torch.stack(out)
        total = ks[-1]
        carry = total if carry is None else op(carry, total)
    assert torch.equal(got.view(torch.uint8), want.to(dtype).view(torch.uint8))


def test_rerun_gives_the_same_bytes_and_signed_zeros_stay():
    x = torch.randn(3 * scan.TILE + 1, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(6))
    a = scan.scan_reference(x, "cumsum", 0)
    b = scan.scan_reference(x, "cumsum", 0)
    assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    z = scan.scan_reference(torch.tensor([-0.0, -0.0, 1.0]), "cumsum", 0)
    assert torch.signbit(z[:2]).all()


def test_integer_scans_stay_on_torch_cumsum():
    """Integer scans are exact modulo 2**64 in any order: they keep
    ``torch.cumsum`` and never reach the scan."""
    x = rt.fromarray(np.arange(-50, 50, dtype=np.int32))
    assert rt.cumsum(x).asarray().dtype == np.int64
    assert torch.int64 not in scan.DTYPES and torch.int32 not in scan.DTYPES


def test_tiling_and_depth():
    assert scan.TILE == scan.THREADS * scan.ITEMS
    assert scan.tiles(1) == 1 and scan.tiles(scan.TILE + 1) == 2
    # no carry in one tile; a left fold before the first checkpoint; then
    # a window's folds and one combine per checkpoint
    assert scan.carry_depth(1) == scan.carry_depth(2) == 0
    assert scan.carry_depth(scan.K) == scan.K - 2
    assert scan.carry_depth(scan.K + 1) == scan.K
    # one tile has no tile total or carry in its chain
    assert scan.depth(scan.TILE) == scan.ITEMS - 1 + 2 * scan.LEVELS + 2
    assert scan.depth(scan.TILE) < scan.depth(scan.TILE + 1)
    t = (1 << 28) // scan.TILE
    assert scan.depth(1 << 28) == 2 * (scan.ITEMS - 1 + scan.LEVELS) + \
        scan.K - 1 + (t - 1) // scan.K + scan.LEVELS + 2


def test_header_constants_match_the_module():
    """THREADS, ITEMS and K of ``csrc/scan.cuh`` are the plain version's."""
    path = os.path.join(os.path.dirname(scan.__file__), "..", "csrc",
                        "scan.cuh")
    with open(path) as f:
        consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", f.read()))
    assert (int(consts["THREADS"]), int(consts["ITEMS"]), int(consts["K"])) \
        == (scan.THREADS, scan.ITEMS, scan.K)


def _carries_by_definition(tot, op, K):
    """E_j = P_c op (A_s op ... op A_{j-1}), s = (j // K) * K, c = s - 1;
    a checkpoint's P_j = P_c op (A_s op ... op A_j); one Python step each."""
    R, T = tot.shape
    out = torch.zeros_like(tot)
    for r in range(R):
        pre = {}
        for j in range(T):
            s = j // K * K
            fold = None
            for i in range(s, j):
                fold = tot[r, i] if fold is None else op(fold, tot[r, i])
            if s > 0:
                out[r, j] = pre[s - 1] if fold is None else op(pre[s - 1], fold)
            elif fold is not None:
                out[r, j] = fold
            if j % K == K - 1:
                m = tot[r, j] if fold is None else op(fold, tot[r, j])
                pre[j] = m if s == 0 else op(pre[s - 1], m)
    return out


@pytest.mark.parametrize("k", [2, 3])
def test_checkpoint_recursion_with_a_small_k(monkeypatch, k):
    """With K patched to 2 and 3 (many checkpoints in a short row), the
    carries equal the defining formula bit for bit, and exact inputs
    (k/2^20) give NumPy's cumsum exactly."""
    monkeypatch.setattr(scan, "K", k)
    g = torch.Generator().manual_seed(12)
    for name, op in (("cumsum", torch.add), ("cumprod", torch.mul)):
        for dtype in (torch.float32, torch.float64):
            tot = (1 + 0.1 * torch.randn(2, 23, generator=g,
                                         dtype=torch.float64)).to(dtype)
            ident = 0.0 if name == "cumsum" else 1.0
            got = scan._carries(tot, op, ident)[:, 1:]
            want = _carries_by_definition(tot, op, k)[:, 1:]
            assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    rs = np.random.RandomState(13)
    x = rs.randint(-(1 << 10), 1 << 10, (2, 11 * scan.TILE + 5)) * 2.0 ** -20
    got = scan.scan_reference(torch.from_numpy(x), "cumsum", 1).numpy()
    np.testing.assert_array_equal(got, np.cumsum(x, axis=1))
    assert scan.depth(11 * scan.TILE + 5) == 2 * (scan.ITEMS - 1 + scan.LEVELS)\
        + k - 1 + 11 // k + scan.LEVELS + 2


def test_last_axis_rows_are_views():
    """A contiguous operand scanned along its last axis is neither copied
    into rows nor out of them."""
    x = torch.arange(24.0).reshape(2, 3, 4)
    rows, shape = scan._as_rows(x, -1)
    assert rows.data_ptr() == x.data_ptr() and rows.shape == (6, 4)
    assert scan._from_rows(rows, shape, -1).data_ptr() == x.data_ptr()


def test_source_has_every_entry_point():
    for tdt in scan.DTYPES:
        for name in ("cumsum", "cumprod"):
            assert f"int {scan.entry_name(tdt, name)}(" in scan.SOURCE
    assert '#include "scan.cuh"' in scan.SOURCE


def test_wrapper_takes_the_plain_version_only_on_the_cpu():
    x = torch.arange(10.0)
    before = scan.launches
    torch.testing.assert_close(scan.run(x, "cumsum", 0), torch.cumsum(x, 0))
    assert scan.launches == before
    with pytest.raises(RuntimeError, match="expected cuda"):
        scan.launch(x, "cumsum", 0)
