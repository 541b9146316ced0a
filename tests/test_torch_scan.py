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


# lengths around the tile and the carry chunk: one tile, a ragged second
# tile, several tiles, more tiles than the carry scan's threads
LENGTHS = [1, 7, scan.TILE, scan.TILE + 1, 5 * scan.TILE - 3,
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
    assert scan.chunk(scan.THREADS * scan.TILE) == 1
    assert scan.chunk(scan.THREADS * scan.TILE + 1) == 2
    # one tile skips the carry scan
    assert scan.depth(scan.TILE) < scan.depth(scan.TILE + 1)
    assert scan.depth(1 << 28) == 2 * (scan.ITEMS - 1 + scan.LEVELS) + \
        2 * ((1 << 28) // scan.TILE // scan.THREADS) + scan.LEVELS + 2


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
