"""The stencil kernel's launch geometry, schedule and load-path rule
(``ramba_tpu_torch/ops/stencil_kernel.py``, mirroring
``csrc/stencil_tile.cuh``).

Everything the kernel's launch depends on except the card's occupancy is
decided in Python, so it is checked here without a card: the schedule
covers every output cell exactly once, the geometry fits the shared memory
and accepts every (dtype, slots, halo) the earlier fixed-tile rule
accepted, the TMA/cp.async rule reads the stride, the base alignment and
the box limits, and the generated source carries the ring's constants.
The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from ramba_tpu_torch.ops import stencil_kernel as sk

ITEMSIZE = {"float32": 4, "float64": 8, "bfloat16": 2}
TORCH_DT = {"float32": torch.float32, "float64": torch.float64,
            "bfloat16": torch.bfloat16}

SHAPES = [(257, 300), (300, 257), (4099, 4133), (8192, 8192), (1, 1000),
          (1000, 1), (3, 3), (2 ** 16 + 1, 64)]


def old_rule(itemsize, n_slots, top, bottom, left, right):
    """What the fixed 32 x 64 tile kernel took: its whole staged tile,
    every slot, in one block's shared memory."""
    return (n_slots * (32 + top + bottom) * (64 + left + right) * itemsize
            <= sk.SMEM_LIMIT)


def _check_partition(H, W, geo):
    """The tiles' rectangles cut the H x W array into strips that chain
    from column 0 to W, each cut into row blocks that chain from row 0 to
    H: every cell lies in exactly one tile."""
    T = sk.n_tiles(H, W, geo)
    strips = {}
    for t in range(T):
        r0, r1, c0, c1 = sk.tile_rect(t, H, W, geo)
        assert 0 <= r0 < r1 <= H and 0 <= c0 < c1 <= W, (t, r0, r1, c0, c1)
        strips.setdefault((c0, c1), []).append((r0, r1))
    edge = 0
    for c0, c1 in sorted(strips):
        assert c0 == edge
        edge = c1
        rows = sorted(strips[(c0, c1)])
        assert rows[0][0] == 0 and rows[-1][1] == H
        assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    assert edge == W
    if H * W <= 1 << 20:  # and cell by cell where that is cheap
        seen = np.zeros((H, W), np.int32)
        for t in range(T):
            r0, r1, c0, c1 = sk.tile_rect(t, H, W, geo)
            seen[r0:r1, c0:c1] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("halo", range(sk.MAX_HALO + 1))
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_schedule_covers_every_output_once(shape, halo):
    H, W = shape
    for dname, itemsize in ITEMSIZE.items():
        geo = sk.geometry(itemsize, 1, halo, halo, halo, halo)
        _check_partition(H, W, geo)
        T = sk.n_tiles(H, W, geo)
        n_strips = -(-W // geo.tw)
        for resident in sorted({1, 7, 132, 264, 396, T}):
            grid, runs = sk.schedule(H, W, geo, resident)
            assert 1 <= grid <= min(resident, T)
            ranges = [sk.tile_range(b, grid, runs, H, W, geo)
                      for b in range(grid)]
            # the CTAs' runs partition the tiles, in near-equal shares
            ordered = sorted(ranges)
            assert ordered[0][0] == 0 and ordered[-1][1] == T
            assert all(a[1] == b[0] for a, b in zip(ordered, ordered[1:]))
            lens = [t1 - t0 for t0, t1 in ranges]
            assert min(lens) >= 1 and max(lens) - min(lens) <= 1, dname
            if runs:
                assert grid == n_strips * runs
                # neighbouring CTAs walk the same rows of neighbouring
                # strips, and each stays inside its strip
                for b in range(min(grid, 600)):
                    r0, _, c0, _ = sk.tile_rect(ranges[b][0], H, W, geo)
                    _, _, c1, _ = sk.tile_rect(ranges[b][1] - 1, H, W, geo)
                    assert c0 == c1 == (b % n_strips) * geo.tw
                    if b % n_strips:
                        assert r0 == sk.tile_rect(ranges[b - 1][0], H, W,
                                                  geo)[0]
            else:
                assert n_strips > resident and grid == resident


@pytest.mark.parametrize("n_slots", range(1, 9))
@pytest.mark.parametrize("dname", list(ITEMSIZE))
def test_geometry_accepts_what_the_fixed_tile_rule_accepted(dname, n_slots):
    itemsize = ITEMSIZE[dname]
    halos = [(h, h, h, h) for h in range(sk.MAX_HALO + 1)]
    halos += [(h, 0, 0, h) for h in range(1, sk.MAX_HALO + 1)]
    halos += [(0, h, h, 0) for h in range(1, sk.MAX_HALO + 1)]
    for top, bottom, left, right in halos:
        geo = sk.geometry(itemsize, n_slots, top, bottom, left, right)
        if old_rule(itemsize, n_slots, top, bottom, left, right):
            assert geo is not None, (top, bottom, left, right)
        if geo is None:
            continue
        again = sk.ring(itemsize, n_slots, top, bottom, left, right, geo.tw,
                        geo.bh, geo.stages, geo.min_ctas)
        assert again == geo
        assert geo.stages >= 2 and geo.smem <= sk.SMEM_LIMIT
        assert sk.NT % geo.tw == 0 and geo.tw >= 8
        # the TMA box: sides at most 256, inner extent a multiple of 16
        # bytes, wide enough for the tile, its halo and the aligned start
        assert geo.sw <= sk.MAX_BOX and geo.sh <= sk.MAX_BOX
        assert (geo.sw * itemsize) % 16 == 0
        lpad = -(-left * itemsize // 16) * 16 // itemsize
        assert geo.sw >= geo.tw + lpad + right
        assert geo.sh == geo.bh + top + bottom
        if geo.min_ctas == 2:
            assert 2 * (geo.smem + sk.CTA_RESERVED) <= sk.SM_SMEM
        # two CTAs per SM whenever the smallest ring allows it
        small = sk.ring(itemsize, n_slots, top, bottom, left, right, 8, 1, 2)
        if 2 * (small.smem + sk.CTA_RESERVED) <= sk.SM_SMEM:
            assert geo.min_ctas == 2


def _body(n_slots, top, bottom, left, right):
    def body(*a):
        v = a[0][0, 0]
        for s in a:
            v = v + s[-top, 0] + s[bottom, 0] + s[0, -left] + s[0, right]
        return v
    return body


@pytest.mark.parametrize("dname", list(ITEMSIZE))
def test_spec_takes_every_body_the_fixed_tile_rule_took(dname):
    itemsize = ITEMSIZE[dname]
    for n_slots in range(1, 9):
        for h in range(sk.MAX_HALO + 1):
            if not old_rule(itemsize, n_slots, h, h, h, h):
                continue
            slots = tuple(("arr", k) for k in range(n_slots))
            tr = sk.trace(_body(n_slots, h, h, h, h), slots)
            spec = sk.spec_for(tr.expr, tr.lo, tr.hi, n_slots, TORCH_DT[dname])
            assert spec is not None, (n_slots, h)
            assert spec.geometry == sk.geometry(itemsize, n_slots, h, h, h, h)


def _ptrs(t):
    return [t.data_ptr()]


def test_load_path_rule():
    geo4 = sk.geometry(4, 1, 2, 2, 2, 2)
    geo8 = sk.geometry(8, 2, 1, 1, 1, 1)
    geo2 = sk.geometry(2, 1, 2, 2, 2, 2)

    def path(t, geo):
        return sk.load_path(geo, *t.shape, t.element_size(), _ptrs(t))

    f32 = torch.zeros(64, 256)
    assert path(f32, geo4) == "tma"
    assert path(torch.zeros(64, 4133), geo4) == "cpasync"  # stride % 16
    # a t[1:] view of a 2-D tensor: its base moves by one row
    assert path(torch.zeros(65, 257)[1:], geo4) == "cpasync"
    assert path(torch.zeros(65, 256)[1:], geo4) == "tma"
    # a contiguous view at a 4-byte offset: the stride alone is fine
    view = torch.zeros(64 * 256 + 1)[1:].view(64, 256)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    assert path(view, geo4) == "cpasync"
    assert path(torch.zeros(64, 4096, dtype=torch.float64), geo8) == "tma"
    assert path(torch.zeros(64, 4099, dtype=torch.float64), geo8) == "cpasync"
    bf = torch.zeros(64, 256, dtype=torch.bfloat16)
    assert path(bf, geo2) == "tma"
    # bf16: pairs of cells by cp.async where they are 4-byte aligned,
    # plain loads where they are not
    assert path(torch.zeros(64, 4130, dtype=torch.bfloat16), geo2) == "cpasync"
    assert path(torch.zeros(64, 4133, dtype=torch.bfloat16), geo2) == "ldst"
    flat = torch.zeros(64 * 256 + 2, dtype=torch.bfloat16)
    assert path(flat[1:-1].view(64, 256), geo2) == "ldst"
    assert path(flat[2:].view(64, 256), geo2) == "cpasync"
    # a box the TMA cannot describe never takes the TMA
    wide = geo4._replace(sw=264)
    assert path(f32, wide) == "cpasync"
    tall = geo4._replace(sh=257)
    assert path(f32, tall) == "cpasync"
    ragged = geo2._replace(sw=133)  # 266 bytes: not a multiple of 16
    assert path(bf, ragged) == "cpasync"


@pytest.mark.parametrize("left", range(0, 10))
@pytest.mark.parametrize("dname", list(ITEMSIZE))
def test_box_rows_start_and_end_on_16_bytes(dname, left):
    """A stage starts ``lpad`` >= ``left`` columns before its strip, on a
    16-byte boundary (bf16 rounds to 8 cells), and its width is rounded up
    to 16 bytes."""
    itemsize = ITEMSIZE[dname]
    align = 16 // itemsize
    geo = sk.geometry(itemsize, 1, 1, 1, left, 1)
    lpad = -(-left // align) * align
    assert lpad % align == 0 and left <= lpad < left + align
    assert geo.tw % align == 0  # so every strip's first column is aligned
    need = geo.tw + lpad + 1
    assert (geo.sw * itemsize) % 16 == 0 and need <= geo.sw < need + align


def test_emitted_source_carries_the_ring():
    def star2(a):
        return (0.25 * (a[0, 1] + a[0, -1] + a[1, 0] + a[-1, 0])
                + 0.125 * (a[0, 2] + a[0, -2] + a[2, 0] + a[-2, 0]))

    tr = sk.trace(star2, (("arr", 0),))
    want = {torch.float32: ("float", 4), torch.float64: ("double", 8),
            torch.bfloat16: ("__nv_bfloat16", 2)}
    for dt, (st, itemsize) in want.items():
        geo = sk.geometry(itemsize, 1, 2, 2, 2, 2)
        spec = sk.spec_for(tr.expr, tr.lo, tr.hi, 1, dt)
        assert spec.geometry == geo
        args = (f"{st}, 1, 2, 2, 2, 2, {geo.tw}, {geo.bh}, {geo.stages}, "
                f"{geo.min_ctas}, Body")
        assert f"launch_stencil<{args}>(path, ins, out, H, W, stream)" \
            in spec.source
        assert f"stencil_ctas_per_sm<{args}>(path)" in spec.source
        assert f"{geo.stages} stages of\n// {geo.sh} x {geo.sw} cells" \
            in spec.source
    f32 = sk.spec_for(tr.expr, tr.lo, tr.hi, 1, torch.float32).geometry
    assert (f32.tw, f32.bh, f32.stages, f32.min_ctas) == (128, 32, 4, 2)


def test_sides_past_the_tma_coordinates_are_not_eligible():
    assert sk.available_local([torch.empty(2 ** 16 + 1, 8, device="meta")])
    assert not sk.available_local([torch.empty(2 ** 31, 1, device="meta")])
    assert not sk.available_local([torch.empty(1, 2 ** 31, device="meta")])
