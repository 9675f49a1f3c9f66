"""The design of K1's Moore tiles on one board (``packed_stripe_kernel`` and
``moore_tile`` in ``tpu_life_torch/csrc/packed_stripe.cu``), modelled in
numpy thread by thread and held to ``bitlife.make_masked_packed_step`` and
``packed_stripe.packed_multi_step_plain``.

The model follows the kernel.  Strip ``s`` of a row holds word columns
``30 s .. 30 s + 31``, one a lane (``packed_stripe.moore_strips``); lanes
1..30 are its output words, and so are lane 0 of the first strip (word 0)
and a lane 31 that holds the row's last word.  Warp ``w`` of a block keeps
``warp_rows`` rows, board rows ``t0 - k + w * warp_rows`` onwards.  A
substep takes each row's horizontal sum once: the words beside a lane's come
from whole-warp shuffles (a lane past the warp's edge reads its own word),
two funnel shifts give the left and right neighbour planes L and R, and
``hs = L ^ C ^ R``, ``hc = maj(L, C, R)``.  The warps trade their first and
last rows' ``(hs, hc)`` through shared memory; three rows' pairs add
vertically in two carry-save adds to ``T = a0 + 2 (a1 + c0) + 4 c1``, and
the rule reads those planes and the cell: Conway fused as ``a0 ? (a1 ^ c0)
& ~c1 : x & (a1 c0 ~c1 | ~a1 ~c0 c1)``, every other rule as the SOP table
over ``b0 = a0, b1 = a1 ^ c0, b2 = c1 ^ (a1 & c0), b3 = c1 & a1 & c0`` (the
kernel takes two rows at a time through the term loop of a rule of more than
two terms; each row's terms are the same).

A block whose tile and halo rows are all on the board, not in the first
strip and with every lane short of the row's last word is interior: it loads
and stores with no bound and keeps every bit each substep.  Every other block
is an edge block: the board's first word takes zero from the left and its
last word zero from the right, loads past the board read zero, and each
substep keeps a row's bits only where the row is on the board and the column
mask allows.  Every output word is written exactly once."""

import itertools

import numpy as np
import pytest
import torch

from tpu_life_torch.kernels import packed_stripe as ps
from tpu_life_torch.models.rules import get_rule
from tpu_life_torch.ops import bitlife

WARP = 32
STRIP = 30  # kInterior
ONES = np.uint32(0xFFFFFFFF)
H100_SMS = 132


# -- the kernel's arithmetic, on uint32 words -------------------------------

def fsl(lo, hi):
    """``__funnelshift_l(lo, hi, 1)``."""
    return (hi << np.uint32(1)) | (lo >> np.uint32(31))


def fsr(lo, hi):
    """``__funnelshift_r(lo, hi, 1)``."""
    return (lo >> np.uint32(1)) | (hi << np.uint32(31))


def shfl_up(v):
    """``__shfl_up_sync(v, 1)`` over the last axis (whole warps)."""
    return np.concatenate([v[..., :1], v[..., :-1]], axis=-1)


def shfl_down(v):
    return np.concatenate([v[..., 1:], v[..., -1:]], axis=-1)


def csa(a, b, c):
    ab = a ^ b
    return ab ^ c, (a & b) | (ab & c)


def hsum(v, first, last):
    """``hsum``: the row's horizontal 3-sum as (hs, hc); ``first``/``last``
    (booleans over the lanes, or None) take zero from beyond."""
    left, right = shfl_up(v), shfl_down(v)
    if first is not None:
        left = np.where(first, np.uint32(0), left)
        right = np.where(last, np.uint32(0), right)
    lw, rw = fsl(left, v), fsr(v, right)
    return lw ^ v ^ rw, (lw & v) | (lw & rw) | (v & rw)


def conway_planes(a0, a1, c0, c1, x):
    """``PlaneRule<ConwayRule>``."""
    three = (a1 ^ c0) & ~c1
    four = x & ((a1 & c0 & ~c1) | (~a1 & ~c0 & c1))
    return (a0 & three) | (~a0 & four)


def planes_to_b(a0, a1, c0, c1):
    """The total's planes b0..b3 from the carry-save planes (``PlaneRule``)."""
    return a0, a1 ^ c0, c1 ^ (a1 & c0), c1 & a1 & c0


def conway_rule(b0, b1, b2, b3, x):
    """``ConwayRule``: b0 b1 ~b2 | x ~b0 ~b1 b2."""
    return (b0 & b1 & ~b2) | (x & b2 & ~(b0 | b1))


def plane_rule(rule):
    """The kernel's rule on (a0, a1, c0, c1, x)."""
    if ps.compiled_rule(rule):
        return conway_planes
    table = ps.sop_table(rule)
    terms = [([np.uint32(table.flip[t][i]) for i in range(5)],
              [np.uint32(table.loose[t][i]) for i in range(5)])
             for t in range(max(table.n_terms, 2))]

    def data_rule(a0, a1, c0, c1, x):
        out = np.uint32(0)
        for flip, loose in terms:
            term = ONES
            for lit, f, lo in zip((*planes_to_b(a0, a1, c0, c1), x), flip, loose):
                term = term & ((lit ^ f) | lo)
            out = out | term
        return out

    return data_rule


def column_mask(gw, nwords: int, rem_bits: int):
    out = np.where(gw < nwords, ONES, np.uint32(0))
    if rem_bits:
        out = np.where(gw == nwords - 1, np.uint32((1 << rem_bits) - 1), out)
    return out


# -- a launch, thread by thread ---------------------------------------------

def model_launch(x, rule, shape, k: int, tile_rows: int, warp_rows: int, written=None):
    """One launch of K1's Moore mode on the uint32 words ``x`` (H, nwords),
    as the kernel's blocks compute it.  Returns the output words and the
    number of blocks that took the interior body."""
    height, nwords = x.shape
    rem_bits = shape[1] % 32
    R = warp_rows
    warps = -(-(tile_rows + 2 * k) // R)
    assert warps <= ps.moore_max_warps(R)
    strips = ps.moore_strips(nwords)
    tiles = -(-height // tile_rows)
    lane = np.arange(WARP)
    out = np.zeros_like(x)
    interior_blocks = 0
    fn = plane_rule(rule)
    for b in range(strips * tiles):
        strip, t0 = b % strips, b // strips * tile_rows
        gw = strip * STRIP + lane  # [lanes]
        rows = t0 - k + np.arange(warps)[:, None] * R + np.arange(R)[None, :]  # [warps, R]
        interior = (t0 - k >= 0 and t0 - k + warps * R <= height and strip >= 1
                    and strip * STRIP + WARP < nwords)
        interior_blocks += interior
        if interior:
            assert rows.min() >= 0 and rows.max() < height and gw.max() < nwords - 1
            v = x[rows[:, :, None], gw[None, None, :]]
            first = last = None
            keep = ONES
        else:
            on = (rows >= 0) & (rows < height)
            v = np.where(on[:, :, None] & (gw < nwords)[None, None, :],
                         x[np.clip(rows, 0, height - 1)[:, :, None],
                           np.clip(gw, 0, nwords - 1)[None, None, :]], np.uint32(0))
            first, last = gw == 0, gw == nwords - 1
            keep = np.where(on[:, :, None], column_mask(gw, nwords, rem_bits)[None, None, :],
                            np.uint32(0))
        zeros = np.zeros((1, 1, WARP), np.uint32)
        for _ in range(k):
            hs, hc = hsum(v, first, last)  # every row once: [warps, R, lanes]
            # the first and last rows' pairs from the warps above and below
            above_s = np.concatenate([zeros, hs[:-1, -1:, :]], axis=0)
            above_c = np.concatenate([zeros, hc[:-1, -1:, :]], axis=0)
            below_s = np.concatenate([hs[1:, :1, :], zeros], axis=0)
            below_c = np.concatenate([hc[1:, :1, :], zeros], axis=0)
            us = np.concatenate([above_s, hs[:, :-1, :]], axis=1)
            uc = np.concatenate([above_c, hc[:, :-1, :]], axis=1)
            ds = np.concatenate([hs[:, 1:, :], below_s], axis=1)
            dc = np.concatenate([hc[:, 1:, :], below_c], axis=1)
            a0, c0 = csa(us, hs, ds)
            a1, c1 = csa(uc, hc, dc)
            v = fn(a0, a1, c0, c1, v) & keep
        if interior:
            out_lane = (lane >= 1) & (lane <= STRIP)
            store_row = (rows >= t0) & (rows < t0 + tile_rows)
        else:
            out_lane = (gw < nwords) & ((lane != 0) | (gw == 0)) & ((lane != WARP - 1) | (gw == nwords - 1))
            store_row = (rows >= t0) & (rows < t0 + tile_rows) & (rows < height)
        w_i, r_i, l_i = np.nonzero(store_row[:, :, None] & out_lane[None, None, :])
        out[rows[w_i, r_i], gw[l_i]] = v[w_i, r_i, l_i]
        if written is not None:
            np.add.at(written, (rows[w_i, r_i], gw[l_i]), 1)
    return out, interior_blocks


# -- cases -----------------------------------------------------------------

def make_board(shape, seed: int) -> np.ndarray:
    """A random board with every edge row and column live."""
    board = (np.random.default_rng(seed).random(shape) < 0.4).astype(np.int8)
    board[0, :] = board[-1, :] = 1
    board[:, 0] = board[:, -1] = 1
    return board


def run_model(board, spec, k, steps, tiles=None):
    """``steps`` masked steps through the model in launches of ``k`` (and
    the remainder), each launch at ``tiles`` or the wrapper's pick, each
    word written once; held to the plain version and to ``steps``
    applications of ``bitlife.make_masked_packed_step``.  Returns the
    interior blocks of the launches."""
    rule = get_rule(spec)
    shape = board.shape
    x0 = bitlife.pack_np(board).astype(np.uint32)
    x = x0
    interior = 0
    done = 0
    while done < steps:
        d = min(k, steps - done)
        t = tiles or ps.moore_tile_shape(d, shape[0], x.shape[1], H100_SMS)
        written = np.zeros(x.shape, np.int64)
        x, inner = model_launch(x, rule, shape, d, *t, written)
        assert (written == 1).all(), "a word written other than once"
        assert inner == ps.moore_blocks(d, shape[0], x.shape[1], *t)[1]
        interior += inner
        done += d
    xt = torch.from_numpy(x0.view(np.int32))
    want = ps.packed_multi_step_plain(xt, rule, shape, steps).numpy().view(np.uint32)
    np.testing.assert_array_equal(x, want)
    masked = bitlife.make_masked_packed_step(rule, shape)
    ref = xt
    for _ in range(steps):
        ref = masked(ref)
    np.testing.assert_array_equal(x, ref.numpy().view(np.uint32))
    return interior


@pytest.mark.parametrize("spec", ["conway", "highlife"])
@pytest.mark.parametrize("k", [1, 8, 32])
@pytest.mark.parametrize("shape,tiles", [
    ((100, 2100), (20, 8)),    # a partial last word; interior blocks
    ((97, 2048), (30, 4)),     # a height that is not a multiple of the tile
    ((75, 500), None),         # one strip, the wrapper's pick
    ((40, 992), (40, 16)),     # one tile touching the top and the bottom
    ((130, 1056), (24, 16)),   # the last word at lane 31 of the last strip
    ((61, 1985), (17, 8)),     # a one-bit last word at lane 2
])
def test_model_matches_plain_and_masked_step(shape, tiles, k, spec):
    if tiles is not None and tiles[0] + 2 * k > tiles[1] * ps.moore_max_warps(tiles[1]):
        tiles = (tiles[1] * ps.moore_max_warps(tiles[1]) - 2 * k, tiles[1])
    steps = k + 3 if k < 32 else k
    run_model(make_board(shape, shape[1] + k), spec, k, steps, tiles)


def test_model_reaches_interior_blocks():
    # the cases above run the interior body, not only the edge one
    assert run_model(make_board((100, 2100), 5), "conway", 8, 8, (20, 8)) > 0
    assert run_model(make_board((100, 2100), 6), "highlife", 1, 1, (20, 8)) > 0


def test_model_on_the_reference_board():
    # 1500x500 at the wrapper's pick: one strip of 16 words, four rows a warp
    board = make_board((1500, 500), 9)
    assert ps.moore_tile_shape(8, 1500, 16, H100_SMS)[1] == ps.SMALL_WARP_ROWS
    assert run_model(board, "conway", 8, 11) == 0


@pytest.mark.parametrize("a0,a1,c0,c1,x", list(itertools.product((0, 1), repeat=5)))
def test_fused_conway_is_conway_on_every_total(a0, a1, c0, c1, x):
    # T = a0 + 2 (a1 + c0) + 4 c1 takes every total 0..9; the fused form
    # equals ConwayRule on the total's planes, and both equal B3/S23
    total = a0 + 2 * (a1 + c0) + 4 * c1
    planes = [np.uint32(ONES if p else 0) for p in (a0, a1, c0, c1, x)]
    b = planes_to_b(*planes[:4])
    assert sum(int(p & np.uint32(1)) << i for i, p in enumerate(b)) == total
    fused = int(conway_planes(*planes) & np.uint32(1))
    assert fused == int(conway_rule(*b, planes[4]) & np.uint32(1))
    assert fused == int(total == 3 or (x and total == 4))


def test_every_total_is_reached():
    totals = {a0 + 2 * (a1 + c0) + 4 * c1 for a0, a1, c0, c1 in itertools.product((0, 1), repeat=4)}
    assert totals == set(range(10))


# -- the strips, the tile pick and the counters -----------------------------

@pytest.mark.parametrize("nwords,strips", [(1, 1), (2, 1), (16, 1), (31, 1), (32, 1), (33, 2),
                                           (62, 2), (63, 3), (512, 17), (513, 18)])
def test_moore_strips_cover_the_row_once(nwords, strips):
    assert ps.moore_strips(nwords) == strips
    covered = []
    for s in range(strips):
        for lane in range(WARP):
            gw = s * STRIP + lane
            if gw < nwords and (lane != 0 or gw == 0) and (lane != WARP - 1 or gw == nwords - 1):
                covered.append(gw)
    assert sorted(covered) == list(range(nwords))


@pytest.mark.parametrize("k,tiles", [
    # 16384^2 (17 strips) on 132 SMs: the fastest block at each depth,
    # measured (PERF.md): 8 warps of 8 rows at depths 1-2, 4 of 16 to 5,
    # 8 of 16 to 12, then 32 of 8
    (1, (62, 8)), (2, (60, 8)), (3, (58, 16)), (5, (54, 16)), (8, (112, 16)),
    (12, (104, 16)), (13, (230, 8)), (16, (224, 8)), (32, (192, 8)),
])
def test_moore_tile_shape_at_16384(k, tiles):
    assert ps.moore_tile_shape(k, 16384, 512, H100_SMS) == tiles


@pytest.mark.parametrize("k,tiles", [
    # 1500x500 (one strip of 16 words): too few warps to fill the card, so
    # four rows a warp and the fewest warps a scheduler
    (1, (14, 4)), (2, (12, 4)), (4, (8, 4)), (8, (12, 4)), (16, (12, 4)), (32, (12, 4)),
])
def test_moore_tile_shape_on_the_reference_board(k, tiles):
    assert ps.moore_tile_shape(k, 1500, 16, H100_SMS) == tiles


@pytest.mark.parametrize("k", range(1, ps.MAX_BLOCK_STEPS + 1))
def test_moore_tile_shape_holds_every_depth(k):
    for height, nwords in ((1, 1), (1500, 16), (4096, 128), (16384, 512), (300, 200000)):
        rows, warp_rows = ps.moore_tile_shape(k, height, nwords, H100_SMS)
        assert 1 <= rows <= height and warp_rows in ps.MOORE_WARP_ROWS
        assert -(-(rows + 2 * k) // warp_rows) <= ps.moore_max_warps(warp_rows)


@pytest.mark.parametrize("shape,k,blocks,unmasked", [
    # 17 strips x 147 tiles; strips 1..15 and tiles 1..145 touch no edge:
    # 87% of the blocks run with no mask
    ((16384, 16384), 8, 2499, 15 * 145),
    ((16384, 16384), 32, 17 * 86, 15 * 84),
    # one strip: every block touches the board's first and last words
    ((1500, 500), 8, 125, 0),
    ((1500, 500), 4, 188, 0),
])
def test_moore_block_counters(shape, k, blocks, unmasked):
    nwords = bitlife.packed_width(shape[1])
    tiles = ps.moore_tile_shape(k, shape[0], nwords, H100_SMS)
    assert ps.moore_blocks(k, shape[0], nwords, *tiles) == (blocks, unmasked)


def test_moore_counters_start_at_zero_and_the_cpu_launches_nothing():
    before = (ps.packed_multi_step.blocks, ps.packed_multi_step.unmasked_blocks)
    x = torch.from_numpy(bitlife.pack_np(make_board((40, 100), 1)).view(np.int32).copy())
    ps.packed_multi_step(x, get_rule("conway"), (40, 100), 9, block_steps=8)
    assert (ps.packed_multi_step.blocks, ps.packed_multi_step.unmasked_blocks) == before


def count_blocks(k, height, nwords, tile_rows, warp_rows):
    """The model's count of a launch's blocks and of those the kernel runs
    unmasked, block by block (``model_launch``'s test)."""
    strips, tiles = ps.moore_strips(nwords), -(-height // tile_rows)
    rows = -(-(tile_rows + 2 * k) // warp_rows) * warp_rows
    inner = sum(1 for b in range(strips * tiles)
                if b // strips * tile_rows - k >= 0 and b // strips * tile_rows - k + rows <= height
                and b % strips >= 1 and b % strips * STRIP + WARP < nwords)
    return strips * tiles, inner


@pytest.mark.parametrize("seed", range(4))
def test_moore_blocks_closed_form_counts_the_blocks(seed):
    rng = np.random.default_rng(seed)
    for _ in range(300):
        warp_rows = int(rng.choice(ps.MOORE_WARP_ROWS))
        k = int(rng.integers(1, 33))
        height = int(rng.integers(1, 2000))
        nwords = int(rng.integers(1, 200))
        top = warp_rows * ps.moore_max_warps(warp_rows) - 2 * k
        if top < 1:
            continue
        tile_rows = int(rng.integers(1, min(top, height) + 1))
        assert ps.moore_blocks(k, height, nwords, tile_rows, warp_rows) == \
            count_blocks(k, height, nwords, tile_rows, warp_rows)
