"""The design of kernel K6 (``tpu_life_torch/csrc/mc_threefry.cu``), modelled
in numpy word by word and held to its plain version and to the JAX package.

The model follows the kernel's steps: a word's decided masks ``d3 =
needs3 & active`` and ``d4 = needs4 & active`` (``active``: the parity
mask and the column mask; ``d = d3 | d4``); each warp's exclusive prefix
sums of ``popc(d3)`` and ``popc(d4)`` and its list of entries (owner lane,
bit), the cells held against the table's entry 3 first and those held
against entry 4 after them, so that an entry's place selects its
threshold; lane ``l`` hashing entries ``l, l + 32, ...`` (``ceil(total /
32)`` draws a lane at most); one unsigned compare an entry; and the
write-back ``x ^ ((active & ~d) | accepted)``.  Its draws
come from the narrow instance's hash (a 32-bit index, round 1 hoisted, the
key injections folded) where ``mc_threefry.narrow_launch`` holds and from
the wide two-word index elsewhere.  Each half-sweep is held bit-equal to
``mc.packed.half_sweep_torch`` and each sweep to the JAX package's
``make_sweep(np, ...)``, on all-up, Neel (no decided cell), half-and-half
and random boards, at widths 30, 34, 66 and 500 (ragged last words, warps
that span rows), T = 0, 2.27 and 10, both parities, and origins 0,
2^32 - 40 and 2^33 + 6.  Draws of the cells no draw decides are shown not
to matter, and the narrow predicate is pinned at its edges.  Boards come
from ``np.random.default_rng``; every comparison is exact."""

import numpy as np
import pytest
import torch

from tpu_life.mc import packed as jpacked
from tpu_life.mc import prng as jprng
from tpu_life.models.rules import get_rule as jget_rule
from tpu_life_torch.kernels import mc_threefry
from tpu_life_torch.mc import ising, packed, prng

JRULE = jget_rule("ising")
WARP = 32
U1 = np.uint32(1)
TEMPS = [0.0, 2.27, 10.0]
WIDTHS = [30, 34, 66, 500]
ORIGINS = [0, 2**32 - 40, 2**33 + 6]
BOARDS = ["all-up", "Neel", "half-and-half", "random"]
HEIGHT = 12
KEY = (0x2F1A77C3, 0x9E3779B9)


def make_board(kind: str, h: int, w: int) -> np.ndarray:
    if kind == "all-up":
        return np.ones((h, w), np.int8)
    if kind == "Neel":
        return ((np.arange(h)[:, None] + np.arange(w)[None, :]) & 1).astype(np.int8)
    if kind == "half-and-half":
        board = np.zeros((h, w), np.int8)
        board[:, : w // 2] = 1
        return board
    return np.random.default_rng(w).integers(0, 2, size=(h, w), dtype=np.int8)


def rotl(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def narrow_hash(k0: int, k1: int, c1: int):
    """The kernel's ``NarrowHash``: word 0's terms that do not depend on the
    index, built once a launch."""
    k0, k1, c1 = np.uint32(k0), np.uint32(k1), np.uint32(c1)
    with np.errstate(over="ignore"):
        keys = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
        x1 = c1 + k1
        return (k0 + x1, rotl(x1, 13), [keys[(g + 1) % 3] for g in range(5)],
                [keys[(g + 2) % 3] + np.uint32(g + 1) for g in range(4)])


def word0_narrow(consts, lo: np.ndarray) -> np.ndarray:
    """The kernel's ``threefry2x32_word0_narrow``: round 1 is one add and one
    xor of a constant, then 19 rounds and the folded injections."""
    x0c, x1c, inj0, inj1 = consts
    with np.errstate(over="ignore"):
        x0 = lo.astype(np.uint32) + x0c
        x1 = x1c ^ x0
        for g in range(5):
            rots = jprng._ROT_A if g % 2 == 0 else jprng._ROT_B
            for i in range(1 if g == 0 else 0, 4):
                x0 = x0 + x1
                x1 = rotl(x1, rots[i]) ^ x0
            x0 = x0 + inj0[g]
            if g < 4:
                x1 = x1 + inj1[g]
    return x0


def planes(x: np.ndarray, width: int, parity: int):
    """(needs3, needs4, active) of every word, as the kernel's word step
    forms them; ``active`` is the parity mask and the column mask."""
    h, wp = x.shape
    top = np.uint32((width % 32 or 32) - 1)
    up, down = np.roll(x, -1, 0), np.roll(x, 1, 0)
    carry_l = np.roll(x, 1, 1) >> np.uint32(31)
    carry_l[:, 0] = (x[:, -1] >> top) & U1
    left = (x << U1) | carry_l
    right = (x >> U1) | (np.roll(x, -1, 1) << np.uint32(31))
    right[:, -1] = (x[:, -1] >> U1) | ((x[:, 0] & U1) << top)
    s1 = up ^ down ^ left
    cs1 = (up & down) | ((up ^ down) & left)
    b0 = s1 ^ right
    cs2 = s1 & right
    b1 = cs1 ^ cs2
    b2 = cs1 & cs2
    n3 = b0 & b1 & ~b2
    n1 = b0 & ~b1 & ~b2
    n0 = ~(b0 | b1 | b2)
    needs3 = (x & n3) | (~x & n1)
    needs4 = (x & b2) | (~x & n0)
    a = (np.arange(h)[:, None] + parity) & 1
    pmask = np.where(a == 1, np.uint32(0xAAAAAAAA), np.uint32(0x55555555))
    active = (pmask & packed.column_mask(width)[None, :]).astype(np.uint32)
    return needs3, needs4, active


def k6_model(x: np.ndarray, width: int, parity: int, k0: int, k1: int, step: int, thr3: int,
             thr4: int, origin: int, stats: dict | None = None) -> np.ndarray:
    """One half-sweep of the packed words ``x`` (uint32[h, wp]) the way K6
    computes it; ``stats`` (if given) receives the draws it hashed."""
    h, wp = x.shape
    substream = prng.SUB_ODD if parity else prng.SUB_EVEN
    needs3, needs4, active = planes(x, width, parity)
    assert not (needs3 & needs4).any()  # one table entry decides a cell
    n = h * wp
    lanes = -(-n // WARP) * WARP  # lanes past the board's end take part with d = 0
    r, j = np.divmod(np.arange(lanes, dtype=np.int64), wp)
    first_cell = int(origin) + r * width + 32 * j  # each lane's bit 0, from its own word
    # the warp's exclusive prefix sums of popc(d3) and popc(d4), and its
    # list: the cells held against entry 3, then those held against entry
    # 4, each part by lane, then by bit
    parts, below, totals = [], [], []
    for plane in (needs3 & active, needs4 & active):
        flat = np.zeros(lanes, np.uint32)
        flat[:n] = plane.ravel()
        bits = ((flat[:, None] >> np.arange(32, dtype=np.uint32)) & U1).astype(bool)
        count = bits.sum(1).reshape(-1, WARP)
        below.append((np.cumsum(count, 1) - count).ravel())
        totals.append(count.sum(1))
        parts.append(np.nonzero(bits))
    total3, total = totals[0], totals[0] + totals[1]
    word = np.concatenate([parts[0][0], parts[1][0]])
    bit = np.concatenate([parts[0][1], parts[1][1]])
    against4 = np.repeat([False, True], [parts[0][0].size, parts[1][0].size])
    rank = np.concatenate([np.arange(p[0].size) - np.searchsorted(p[0], p[0]) for p in parts])
    warp = word // WARP
    slot = np.where(against4, total3[warp] + below[1][word], below[0][word]) + rank
    # each warp's list holds its entries at 0 .. total - 1, once each
    order = np.lexsort((slot, warp))
    starts = np.concatenate([[0], np.cumsum(total)[:-1]])
    assert np.array_equal(slot[order], np.arange(word.size) - starts[warp[order]])
    assert (word % WARP).max(initial=0) < WARP and bit.max(initial=0) < 32
    # lane l hashes entries l, l + 32, ...: at most ceil(total / 32) each
    per_lane = np.zeros((total.size, WARP), np.int64)
    np.add.at(per_lane, (warp, slot % WARP), 1)
    assert np.array_equal(per_lane.max(1), -(-total // WARP))
    assert (per_lane.max(1) - per_lane.min(1) <= 1).all()
    idx = first_cell[word] + bit  # the owner's word names the cell, not the hashing lane's
    if mc_threefry.narrow_launch(h, width, origin):
        assert int(idx.max(initial=0)) < 2**32
        u = word0_narrow(narrow_hash(k0, k1, prng.counter_word(step, substream)),
                         idx.astype(np.uint32))
    else:
        lo, hi = jprng.split_cell_index(idx)
        u = jprng.cell_uniforms_at(np, lo, hi, np.uint32(k0), np.uint32(k1), np.uint32(step),
                                   substream)
    # one compare: the part of the list names the table's entry
    accept = u < np.where(slot >= total3[warp], np.uint32(thr4), np.uint32(thr3))
    accepted = np.zeros(lanes, np.uint32)
    np.bitwise_or.at(accepted, word[accept], U1 << bit[accept].astype(np.uint32))
    if stats is not None:
        stats["draws"] = stats.get("draws", 0) + int(word.size)
    d = (needs3 | needs4) & active
    return x ^ ((active & ~d) | accepted[:n].reshape(h, wp))


def as_words(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.view(np.int32).copy())


@pytest.mark.parametrize("origin", ORIGINS)
@pytest.mark.parametrize("temperature", TEMPS)
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("kind", BOARDS)
def test_model_equals_plain_and_jax(kind, width, temperature, origin):
    board = make_board(kind, HEIGHT, width)
    thr = ising.acceptance_thresholds(temperature)
    thr3, thr4 = int(thr[3]), int(thr[4])
    jsweep = jpacked.make_sweep(np, JRULE, board.shape, origin=origin)
    x = want = jpacked.pack_board(board)
    for step in range(2):
        for parity in (0, 1):
            got = k6_model(x, width, parity, *KEY, step, thr3, thr4, origin)
            plain = mc_threefry.packed_metropolis_half_plain(
                as_words(x), parity, *KEY, step, thr3, thr4, width=width, origin=origin)
            np.testing.assert_array_equal(got, plain.numpy().view(np.uint32))
            x = got
        want = jsweep(want, np.uint32(KEY[0]), np.uint32(KEY[1]), np.uint32(step), thr)
        np.testing.assert_array_equal(x, want)


@pytest.mark.parametrize("kind", BOARDS)
def test_the_draws_hashed_are_the_decided_cells(kind):
    # a Neel board decides no cell, an all-up one every active cell
    board = make_board(kind, HEIGHT, 66)
    thr = ising.acceptance_thresholds(2.27)
    stats = {}
    k6_model(jpacked.pack_board(board), 66, 0, *KEY, 0, int(thr[3]), int(thr[4]), 0, stats)
    s = board.astype(np.int32) * 2 - 1
    nsum = sum(np.roll(s, o, ax) for o in (1, -1) for ax in (0, 1))
    on = ((np.arange(HEIGHT)[:, None] + np.arange(66)[None, :]) & 1) == 0
    decided = int(((((s * nsum + 4) >> 1) >= 3) & on).sum())
    assert stats["draws"] == decided
    assert decided == {"all-up": on.sum(), "Neel": 0}.get(kind, decided)


def every_cell_half(x: np.ndarray, width: int, parity: int, u: np.ndarray, thr3: int,
                    thr4: int) -> np.ndarray:
    """The half-sweep from the draws ``u`` (uint32[h, width]) of every cell,
    as the kernel before the compaction compared them."""
    needs3, needs4, active = planes(x, width, parity)
    cmp3 = packed.pack_board((u < np.uint32(thr3)).astype(np.int8))
    cmp4 = packed.pack_board((u < np.uint32(thr4)).astype(np.int8))
    accept = ~(needs3 | needs4) | (needs3 & cmp3) | (needs4 & cmp4)
    return x ^ (accept & active)


@pytest.mark.parametrize("origin", [0, 2**33 + 6])
@pytest.mark.parametrize("temperature", [2.27, 10.0])
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("kind", ["half-and-half", "random"])
def test_draws_of_undecided_cells_never_matter(kind, width, temperature, origin):
    board = make_board(kind, HEIGHT, width)
    x = jpacked.pack_board(board)
    thr = ising.acceptance_thresholds(temperature)
    thr3, thr4 = int(thr[3]), int(thr[4])
    for parity in (0, 1):
        substream = prng.SUB_ODD if parity else prng.SUB_EVEN
        u = jprng.cell_uniforms(np, board.shape, np.uint32(KEY[0]), np.uint32(KEY[1]),
                                np.uint32(3), substream, origin=origin)
        needs3, needs4, active = planes(x, width, parity)
        decided = packed.unpack_board((needs3 | needs4) & active, width) == 1
        want = every_cell_half(x, width, parity, u, thr3, thr4)
        for fill in (0, 0xFFFFFFFF):
            other = np.where(decided, u, np.uint32(fill))
            np.testing.assert_array_equal(every_cell_half(x, width, parity, other, thr3, thr4), want)
        np.testing.assert_array_equal(k6_model(x, width, parity, *KEY, 3, thr3, thr4, origin), want)


@pytest.mark.parametrize("c1", [0, 1, 0xFFFFFFFE, 0x85A308D3])
@pytest.mark.parametrize("key", [(0, 0), (0xFFFFFFFF, 0xFFFFFFFF), KEY])
def test_narrow_hash_is_word_0_of_threefry(key, c1):
    lo = np.random.default_rng(c1 & 0xFFFF).integers(0, 2**32, size=4096, dtype=np.uint64)
    lo = np.concatenate([lo, [0, 1, 2**32 - 1]]).astype(np.uint32)
    want, _ = jprng.threefry2x32(np, np.uint32(key[0]), np.uint32(key[1]), lo, np.uint32(c1))
    np.testing.assert_array_equal(word0_narrow(narrow_hash(*key, c1), lo), want)


@pytest.mark.parametrize("shape", [(2, 2), (8, 30), (12, 500)])
@pytest.mark.parametrize("past", [-1, 0, 1])
def test_narrow_predicate_at_its_edges(shape, past):
    h, w = shape
    origin = 2**32 - h * w + past  # origin + h*w = 2^32 - 1, 2^32, 2^32 + 1
    narrow = mc_threefry.narrow_launch(h, w, origin)
    assert narrow == (past <= 0)
    if narrow:
        # the kernel's 32-bit index (bit 0 of each word plus the bit, mod
        # 2^32) equals the 64-bit one for every cell
        r, c = np.meshgrid(np.arange(h, dtype=np.uint64), np.arange(w, dtype=np.uint64),
                           indexing="ij")
        wide = origin + r * w + c
        with np.errstate(over="ignore"):
            first = (np.uint32(origin & 0xFFFFFFFF) + r.astype(np.uint32) * np.uint32(w)
                     + np.uint32(32) * (c // 32).astype(np.uint32))
            lo = first + (c % 32).astype(np.uint32)
        assert int(wide.max()) == 2**32 - 1 + past
        np.testing.assert_array_equal(lo.astype(np.uint64), wide)
