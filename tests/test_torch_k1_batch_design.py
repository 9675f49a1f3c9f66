"""The design of K1's batch mode (``packed_batch_kernel`` and
``packed_batch_segment_kernel`` in ``tpu_life_torch/csrc/packed_stripe.cu``),
modelled in numpy word by word and held to its plain version and to the JAX
package.

The model follows the kernels thread by thread.  On a narrow board (at most
32 words a row) a row takes a segment of ``seg`` lanes (8, 16 or 32,
``packed_batch.segment_width``), word ``c`` on the segment's lane ``c``;
the neighbour words come from whole-warp shuffles (a lane past the warp's
edge reads its own word) and the segment's first lane takes zero from the
left, its last lane zero from the right; lanes past the row's last word
load zeros and the column mask keeps them so.  Segment ``g`` of a block
keeps ``warp_rows`` rows, board rows ``t0 - r*k + g*warp_rows`` onwards, a
register each, and takes the ``r`` rows beside them from segments ``g - 1``
and ``g + 1`` (threads ``t -+ seg``); a tile's first and last ``r*k`` rows
are its halo.  On a wide board the model runs K1's strips: a warp of 32
word columns, lanes 1..30 its output words, lanes 0 and 31 absorbing the
wrong bits a shuffle past the warp's edge brings, the rows beside a warp's
from the warps above and below.  Each launch of ``packed_batch.chunk_plan``
runs at the plan's tiles, and at forced tiles that put seams in small
boards; slot ``s`` takes ``min(k, max(budget - offset, 0))`` substeps.
Every output word is written exactly once.  The rule is the kernels':
Conway's formula compiled in, else the SOP table ``packed_stripe.sop_table``
gives term by term.

Each chunk is held bit-equal to ``packed_batch.packed_batch_multi_step_plain``
launch by launch, to ``tpu_life.ops.reference.run_np`` slot by slot, and
(some cases) to one chunk of the JAX package's ``VmapEngine``, at widths 1
to 1025 (every segment width and both sides of each boundary), for Conway,
``highlife`` (three SOP terms), ``R1,C0,S1..2,B1,NN`` and
``R2,C2,S2..4,B2..3,NN``, chunks of 1, 7, 8, 9, 16 and 32 steps and budgets
0, 1, k - 1, k, k + 1 and past the chunk at each launch boundary, with live
edge rows and columns.  Boards come from ``np.random.default_rng``; every
comparison is exact."""

import numpy as np
import pytest
import torch

from tpu_life.models.rules import get_rule as jget_rule
from tpu_life.ops.reference import run_np as jrun_np
from tpu_life.serve import engine as jengine
from tpu_life_torch.kernels import packed_batch, packed_stripe
from tpu_life_torch.models.rules import get_rule
from tpu_life_torch.ops import bitlife
from tpu_life_torch.serve import engine

WARP = 32
STRIP = 30  # output words of a warp's strip (kInterior)
ONES = np.uint32(0xFFFFFFFF)
WIDTHS = [1, 31, 32, 33, 255, 256, 257, 500, 511, 512, 513, 1023, 1024, 1025]
RULES = ["conway", "highlife", "R1,C0,S1..2,B1,NN", "R2,C2,S2..4,B2..3,NN"]
CHUNKS = [1, 7, 8, 9, 16, 32]
SLOTS = 8
HEIGHT = 21


# -- the kernels' arithmetic, on uint32 words -------------------------------

def csa(a, b, c):
    ab = a ^ b
    return ab ^ c, (a & b) | (ab & c)


def fsl(lo, hi, n: int):
    """``__funnelshift_l(lo, hi, n)``: the top word of (hi:lo) << n."""
    return (hi << np.uint32(n)) | (lo >> np.uint32(32 - n))


def fsr(lo, hi, n: int):
    """``__funnelshift_r(lo, hi, n)``: the low word of (hi:lo) >> n."""
    return (lo >> np.uint32(n)) | (hi << np.uint32(32 - n))


class Lanes:
    """The lanes policy over the last axis (the block's threads, whole warps
    of 32): ``StripLanes`` (``first``, ``last`` None) or ``SegmentLanes``
    (``first``, ``last``: the threads that take zero from the left and from
    the right)."""

    def __init__(self, first=None, last=None):
        self.first, self.last = first, last

    @staticmethod
    def _warps(v):
        return v.reshape(*v.shape[:-1], -1, WARP)

    def left(self, v):
        w = self._warps(v)
        u = np.concatenate([w[..., :1], w[..., :-1]], axis=-1).reshape(v.shape)  # __shfl_up_sync
        return u if self.first is None else np.where(self.first, np.uint32(0), u)

    def right(self, v):
        w = self._warps(v)
        u = np.concatenate([w[..., 1:], w[..., -1:]], axis=-1).reshape(v.shape)  # __shfl_down_sync
        return u if self.last is None else np.where(self.last, np.uint32(0), u)


def rule_fn(rule):
    """The kernel's rule over (b0, b1, b2, b3, x): ``ConwayRule`` where the
    Moore kernels compile it in, else ``DataRule`` over the SOP table
    (terms 0 and 1 always, the rest where the SOP has them)."""
    if packed_stripe.compiled_rule(rule):
        return lambda b0, b1, b2, b3, x: (b0 & b1 & ~b2) | (x & b2 & ~(b0 | b1))
    table = packed_stripe.sop_table(rule)
    terms = [([np.uint32(table.flip[t][i]) for i in range(5)],
              [np.uint32(table.loose[t][i]) for i in range(5)])
             for t in range(max(table.n_terms, 2))]

    def data_rule(*lits):
        out = np.uint32(0)
        for flip, loose in terms:
            term = ONES
            for lit, f, lo in zip(lits, flip, loose):
                term = term & ((lit ^ f) | lo)
            out = out | term
        return out

    return data_rule


def moore_rows(x, R, rule, lanes, center):
    """``MooreSubstep::rows``: rows 0..R-1 from x's rows -1..R (axis -2)."""
    up, mid, down = x[..., 0:R, :], x[..., 1:R + 1, :], x[..., 2:R + 2, :]
    ones, twos = csa(up, mid, down)
    ones_l, twos_l = lanes.left(ones), lanes.left(twos)
    ones_r, twos_r = lanes.right(ones), lanes.right(twos)
    b0, c1 = csa(fsl(ones_l, ones, 1), ones, fsr(ones, ones_r, 1))
    s1, c2 = csa(fsl(twos_l, twos, 1), twos, fsr(twos, twos_r, 1))
    return rule(b0, c1 ^ s1, c2 ^ (c1 & s1), c2 & c1 & s1, mid)


def diamond1_rows(x, R, rule, lanes, center):
    """``Diamond1Substep::rows``."""
    up, mid, down = x[..., 0:R, :], x[..., 1:R + 1, :], x[..., 2:R + 2, :]
    l1 = fsl(lanes.left(mid), mid, 1)
    r1 = fsr(mid, lanes.right(mid), 1)
    s0, c0 = csa(up, down, l1)
    b0, c1 = csa(s0, r1, mid & center)
    return rule(b0, c0 ^ c1, c0 & c1, np.uint32(0), mid)


def diamond2_rows(x, R, rule, lanes, center):
    """``Diamond2Substep::rows``: row i from rows i-2 and i+2, the 3-wide
    boxes of rows i-1 and i+1 and row i's arms."""
    v = x[..., 1:R + 3, :]  # the rows whose boxes are read: i-1 for i = 0 .. i+1 for R-1
    box_s, box_c = csa(fsl(lanes.left(v), v, 1), v, fsr(v, lanes.right(v), 1))
    above_s, above_c = box_s[..., 0:R, :], box_c[..., 0:R, :]
    below_s, below_c = box_s[..., 2:R + 2, :], box_c[..., 2:R + 2, :]
    a, c, e = x[..., 0:R, :], x[..., 2:R + 2, :], x[..., 4:R + 4, :]
    cl, cr = lanes.left(c), lanes.right(c)
    l1, r1 = fsl(cl, c, 1), fsr(c, cr, 1)
    l2, r2 = fsl(cl, c, 2), fsr(c, cr, 2)
    s_a, c_a = csa(a, e, l1)
    s_b, c_b = csa(r1, l2, r2)
    s_c, c_c = csa(c & center, above_s, below_s)
    b0, c_d = csa(s_a, s_b, s_c)
    t_a, d_a = csa(c_a, c_b, c_c)
    t_b, d_b = csa(c_d, above_c, below_c)
    b2, b3 = csa(d_a, d_b, t_a & t_b)
    return rule(b0, t_a ^ t_b, b2, b3, c)


def substep_of(rule):
    if not bitlife.supports_diamond(rule):
        return moore_rows
    return diamond1_rows if rule.radius == 1 else diamond2_rows


def column_mask(gw, nwords: int, rem_bits: int):
    """The in-board bits of word columns ``gw``."""
    out = np.where((gw >= 0) & (gw < nwords), ONES, np.uint32(0))
    if rem_bits:
        out = np.where(gw == nwords - 1, np.uint32((1 << rem_bits) - 1), out)
    return out


# -- a launch, thread by thread ---------------------------------------------

def model_launch(x, budgets, rule, shape, k: int, offset: int, tiles, written=None):
    """One launch of K1's batch mode on the uint32 words ``x`` (slots, H,
    nwords), as the kernel's blocks compute it; returns the output batch.
    ``written`` (optional, like x) counts the writes of each word."""
    slots, height, nwords = x.shape
    rem_bits = shape[1] % 32
    r = rule.radius
    R, tile_rows = tiles.warp_rows, tiles.tile_rows
    seg = tiles.seg or WARP  # K1's strips: a warp is one row
    segs_needed = -(-(tile_rows + 2 * r * k) // R)
    warps = -(-segs_needed * seg // WARP) if tiles.seg else segs_needed
    threads = warps * WARP
    t = np.arange(threads)
    g = t // seg
    ntiles = -(-height // tile_rows)
    if tiles.seg:
        assert nwords <= tiles.seg and tiles.seg in packed_batch.SEGMENT_WIDTHS
        strips = 1
        col = (t % seg)[None, :]  # [blocks, threads]
        lanes = Lanes(first=(t % seg) == 0, last=(t % seg) == seg - 1)
        out_lane = col < nwords
    else:
        strips = -(-nwords // STRIP)
        col = (np.arange(strips)[:, None] * STRIP - 1 + (t % WARP)[None, :])
        lanes = Lanes()
        out_lane = ((t % WARP) >= 1) & ((t % WARP) <= STRIP) & (col < nwords)
    assert warps <= packed_stripe.TILE_WARPS
    blocks = ntiles * strips
    t0 = (np.arange(blocks) // strips) * tile_rows  # [blocks]
    colb = np.broadcast_to(col, (strips, threads))[np.arange(blocks) % strips]  # [blocks, threads]
    outb = np.broadcast_to(out_lane, (strips, threads))[np.arange(blocks) % strips]
    rows = (t0[:, None, None] - r * k + g[None, None, :] * R
            + np.arange(R)[None, :, None])  # [blocks, R, threads]
    live = (rows >= 0) & (rows < height)
    inb = live & (colb[:, None, :] >= 0) & (colb[:, None, :] < nwords)
    v = np.where(inb[None], x[:, np.clip(rows, 0, height - 1), np.clip(colb[:, None, :], 0, nwords - 1)],
                 np.uint32(0))  # [slots, blocks, R, threads]
    keep = np.where(live, column_mask(colb, nwords, rem_bits)[:, None, :], np.uint32(0))
    n = np.minimum(k, np.maximum(np.asarray(budgets) - offset, 0))
    fn, center = rule_fn(rule), ONES if rule.include_center else np.uint32(0)
    substep = substep_of(rule)
    zeros = np.zeros((*v.shape[:2], r, threads), np.uint32)
    for s in range(k):
        top, bot = v[:, :, :r, :], v[:, :, R - r:, :]
        above, below = zeros.copy(), zeros.copy()
        above[..., seg:] = bot[..., :-seg]  # segment g - 1's last rows
        below[..., :-seg] = top[..., seg:]  # segment g + 1's first rows
        xs = np.concatenate([above, v, below], axis=2)
        new = substep(xs, R, fn, lanes, center) & keep[None]
        v = np.where((s < n)[:, None, None, None], new, v)
    out = np.zeros_like(x)
    store = outb[:, None, :] & (rows >= t0[:, None, None]) & (rows < t0[:, None, None] + tile_rows) \
        & (rows < height)
    b_i, r_i, t_i = np.nonzero(store)
    out[:, rows[b_i, r_i, t_i], colb[b_i, t_i]] = v[:, b_i, r_i, t_i]
    if written is not None:
        np.add.at(written, (slice(None), rows[b_i, r_i, t_i], colb[b_i, t_i]), 1)
    return out


# -- cases -----------------------------------------------------------------

def make_batch(shape, seed: int, slots: int = SLOTS) -> np.ndarray:
    """``slots`` boards with every edge row and column live in some slot."""
    boards = (np.random.default_rng(seed).random((slots, *shape)) < 0.35).astype(np.int8)
    boards[0, 0, :] = boards[1, :, 0] = boards[2, -1, :] = boards[3, :, -1] = 1
    return boards


def words_of(boards: np.ndarray) -> np.ndarray:
    return np.stack([bitlife.pack_np(b) for b in boards]).astype(np.uint32)


def budgets_for(plan, chunk: int) -> list[int]:
    """0, 1, k - 1, k, k + 1 and past the chunk at each launch's boundary,
    at least SLOTS of them (a slot each)."""
    want = {0, 1, chunk + 5}
    for launch in plan:
        want |= {launch.offset + launch.k - 1, launch.offset + launch.k, launch.offset + launch.k + 1}
    out = sorted(want)
    while len(out) < SLOTS:
        out.append(chunk + len(out))
    return out


def run_chunk(boards, budgets, spec, shape, chunk, tiles=None):
    """The chunk through the model (the plan's launches, or launches of the
    plan's depths at ``tiles``), each launch held to the plain version and
    each word written once; returns the model's words."""
    rule = get_rule(spec)
    plan = packed_batch.chunk_plan(rule, shape, chunk, len(budgets), packed_batch.H100_SMS)
    x = words_of(boards)
    steps = torch.tensor(budgets, dtype=torch.int32)
    for launch in plan:
        written = np.zeros_like(x, dtype=np.int64)
        got = model_launch(x, budgets, rule, shape, launch.k, launch.offset,
                           tiles or launch.tiles, written)
        assert (written == 1).all(), "a word written other than once"
        want = packed_batch.packed_batch_multi_step_plain(
            torch.from_numpy(x.view(np.int32)), steps, rule, shape, launch.k,
            out=torch.empty(x.shape, dtype=torch.int32), offset=launch.offset)
        np.testing.assert_array_equal(got, want.numpy().view(np.uint32))
        x = got
    return x


def check_run_np(words, boards, budgets, spec, shape, chunk):
    rule = jget_rule(spec)
    for s, budget in enumerate(budgets):
        got = bitlife.unpack_np(words[s], shape[1])
        np.testing.assert_array_equal(got, jrun_np(boards[s], rule, min(budget, chunk)))


@pytest.mark.parametrize("spec", RULES)
@pytest.mark.parametrize("width", WIDTHS)
def test_model_chunk_matches_plain_and_run_np(width, spec):
    shape = (HEIGHT, width)
    plan = packed_batch.chunk_plan(get_rule(spec), shape, 16, SLOTS, packed_batch.H100_SMS)
    budgets = budgets_for(plan, 16)
    boards = make_batch(shape, width, len(budgets))
    words = run_chunk(boards, budgets, spec, shape, 16)
    check_run_np(words, boards, budgets, spec, shape, 16)


@pytest.mark.parametrize("spec", RULES)
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("width", [500, 1025])
def test_model_chunks_and_budgets(width, chunk, spec):
    shape = (HEIGHT - 4, width)
    plan = packed_batch.chunk_plan(get_rule(spec), shape, chunk, SLOTS, packed_batch.H100_SMS)
    budgets = budgets_for(plan, chunk)
    boards = make_batch(shape, chunk + width, len(budgets))
    words = run_chunk(boards, budgets, spec, shape, chunk)
    check_run_np(words, boards, budgets, spec, shape, chunk)


@pytest.mark.parametrize("spec", ["conway", "R2,C2,S2..4,B2..3,NN"])
@pytest.mark.parametrize("width,tile_rows,warp_rows", [
    (31, 1, 4), (100, 3, 8), (257, 5, 4), (500, 7, 8), (1024, 2, 8), (1025, 3, 4), (2000, 6, 8)])
def test_model_tile_seams(width, tile_rows, warp_rows, spec):
    # short tiles put seams (and halos across them) inside a small board
    shape = (HEIGHT + 6, width)
    nwords = bitlife.packed_width(width)
    tiles = packed_batch.Tiles(tile_rows, warp_rows, packed_batch.segment_width(nwords) or 0)
    k = 8 if spec == "conway" else 4
    boards = make_batch(shape, width + tile_rows)
    budgets = [0, 1, k - 1, k, k + 1, 40, 3, 2]
    words = run_chunk(boards, budgets, spec, shape, k, tiles=tiles)
    check_run_np(words, boards, budgets, spec, shape, k)


@pytest.mark.parametrize("spec", RULES)
@pytest.mark.parametrize("width", [33, 512])
def test_model_chunk_matches_vmap_engine(width, spec):
    shape = (HEIGHT, width)
    boards = make_batch(shape, 7 * width)
    budgets = [0, 1, 15, 16, 17, 40, 3, 9]
    words = run_chunk(boards, budgets, spec, shape, 16)
    board = np.zeros(shape, np.int8)
    jkey = jengine.compile_key_for(jget_rule(spec), board, "jax", "roll")
    vmap = jengine.VmapEngine(jkey, SLOTS, 16)
    for s in range(SLOTS):
        assert vmap.acquire() == s
        vmap.load(s, boards[s], budgets[s])
    vmap.dispatch_chunk()
    vmap.collect_chunk()
    for s in range(SLOTS):
        want, lag = vmap.peek_slot(s)
        assert lag == 0
        np.testing.assert_array_equal(bitlife.unpack_np(words[s], width), np.asarray(want))


# -- the plan ---------------------------------------------------------------

@pytest.mark.parametrize("spec", RULES)
@pytest.mark.parametrize("chunk", [1, 7, 8, 9, 16, 17, 31, 32, 33, 100])
@pytest.mark.parametrize("width", [1, 33, 500, 512, 1024, 1025, 4096])
def test_chunk_plan_covers_the_chunk(width, chunk, spec):
    rule = get_rule(spec)
    shape = (512, width)
    nwords = bitlife.packed_width(width)
    plan = packed_batch.chunk_plan(rule, shape, chunk, SLOTS, packed_batch.H100_SMS)
    assert [launch.offset for launch in plan] == list(np.cumsum([0] + [lc.k for lc in plan])[:-1])
    assert sum(launch.k for launch in plan) == chunk
    cap = packed_stripe.MAX_BLOCK_STEPS // rule.radius
    narrow = nwords <= 32
    for launch in plan:
        assert 1 <= launch.k <= (cap if narrow else min(8, cap))
        tiles = launch.tiles
        assert tiles.seg == (packed_batch.segment_width(nwords) if narrow else 0)
        assert 1 <= tiles.tile_rows <= shape[0] and tiles.warp_rows in (4, 8)
        halo = 2 * rule.radius * launch.k
        lanes = -(-(tiles.tile_rows + halo) // tiles.warp_rows) * (tiles.seg or WARP)
        assert lanes <= packed_stripe.TILE_WARPS * WARP
    # a chunk is as few launches as the depth allows
    assert len(plan) == -(-chunk // (cap if narrow else min(8, cap)))


def test_serving_chunks_are_one_launch_on_narrow_boards():
    conway = get_rule("conway")
    # the serve mix: 512^2, capacity 8, chunk 16 -> 1 launch a chunk (was 2)
    (launch,) = packed_batch.chunk_plan(conway, (512, 512), 16, 8, packed_batch.H100_SMS)
    assert launch.k == 16 and launch.tiles.seg == 16
    # the reference workload served (1500x500, 100 steps): 7 chunks of 16,
    # one launch each (was 14)
    assert len(packed_batch.chunk_plan(conway, (1500, 500), 16, 8, packed_batch.H100_SMS)) == 1
    # wide boards keep K1's strips at depth 8
    plan = packed_batch.chunk_plan(conway, (4096, 4096), 16, 8, packed_batch.H100_SMS)
    assert [(lc.k, lc.offset, lc.tiles.seg) for lc in plan] == [(8, 0, 0), (8, 8, 0)]
    assert plan[0].tiles[:2] == packed_stripe.tile_shape(8, 8 * 4096, 128, packed_batch.H100_SMS)


@pytest.mark.parametrize("nwords,seg", [(1, 8), (8, 8), (9, 16), (16, 16), (17, 32), (32, 32),
                                        (33, None)])
def test_segment_width(nwords, seg):
    assert packed_batch.segment_width(nwords) == seg


def test_k1_batch_engine_on_the_cpu_follows_the_plan_and_launches_nothing():
    key = engine.compile_key_for(get_rule("conway"), np.zeros((40, 500), np.int8), "cuda", "roll")
    port = engine.BatchEngine(key, 3, 16, route="k1_batch", device=torch.device("cpu"))
    rng = np.random.default_rng(3)
    boards = [(rng.random((40, 500)) < 0.4).astype(np.int8) for _ in range(3)]
    for s, (board, budget) in enumerate(zip(boards, [5, 16, 30])):
        assert port.acquire() == s
        port.load(s, board, budget)
    before = packed_batch.packed_batch_multi_step.launches
    port.dispatch_chunk()
    port.collect_chunk()
    assert packed_batch.packed_batch_multi_step.launches == before == 0
    rule = jget_rule("conway")
    for s, budget in enumerate([5, 16, 30]):
        np.testing.assert_array_equal(port.peek_slot(s)[0], jrun_np(boards[s], rule, min(budget, 16)))
