"""The design of the batch modes of kernels K6 and K7
(``tpu_life_torch/csrc/mc_threefry.cu``: ``packed_metropolis_batch_kernel``
and ``cell_uniforms_batch_kernel``), modelled in numpy thread by thread and
held to their plain versions and to the JAX package.

K6's batch mode, one slot's half-sweep as the kernel computes it:

- a thread takes a group of 4 consecutive words of one row (``per_row =
  ceil(wp / 4)`` groups a row; the row's last group may hold fewer words,
  and no group spans rows, while a warp of 32 groups spans rows wherever
  a row holds fewer than 32 groups); lanes past the board's end take part
  with nothing decided;
- a word's decided masks ``d3`` and ``d4`` (its neighbours from the
  group's own words, the group's outer neighbours ``before`` and
  ``after``); a pair of words ``2p, 2p + 1`` interleaves into one 32-bit
  mask ``y = (d_2p >> a) | (d_2p+1 >> a) << 1``;
- the warp's exclusive prefix sums of ``popc(y3)`` and ``popc(y4)``, and
  its list, built one entry a set bit: each lane walks ``y3`` of each of
  its pairs, the highest bit first, then ``y4``, and writes ``pair << 5 |
  bit`` at its slices of the two parts (entry 3's cells first);
- lane ``l`` hashing entries ``l, l + 32, ...``, the cell ``base[pair] +
  entry + 31 * (entry & 1)`` (``base`` holds the pair's first active cell
  less ``32 * pair``), one compare against the threshold of its part;
- the write-back ``keep ^ ((accepted >> (g & 1)) & 0x55555555) << a``, and
  a frozen slot's words copied through.

The slot's uniforms (its counter word ``(counter + offset) * NSUB +
substream`` and the narrow hash) are formed from the slot's state alone,
the same in every thread.  K7's batch mode takes 8 consecutive draws a
thread, stored 16 bytes at a time where the slot's draws are 16-byte
aligned (``n % 4 == 0``) and one at a time in a tail or elsewhere.

Each model is held bit-equal to the plain versions
(``packed_metropolis_half_batch_plain``, ``cell_uniforms_batch_plain``),
to the JAX package's ``make_sweep`` and ``cell_uniforms`` slot by slot
under the freeze mask, and to their ``jax.vmap``: widths 30, 34, 66, 190
and 500 (rows of 1, 2, 3, 6 and 16 words), frozen slots among live ones,
counters past 2^31, origins 0, 2^32 - 40 and 2^33 + 6, T = 0, 2.27 and
10, all-up, Neel and random boards, and K7 boards whose cells are not a
multiple of the draws a thread.  Inputs come from
``np.random.default_rng``; every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_life.mc import packed as jpacked
from tpu_life.mc import prng as jprng
from tpu_life.models.rules import get_rule as jget_rule
from tpu_life_torch.kernels import mc_threefry
from tpu_life_torch.mc import ising, packed, prng

JRULE = jget_rule("ising")
WARP, GROUP, PAIRS, DRAWS = 32, 4, 2, 8
U32 = 0xFFFFFFFF
EVEN = 0x55555555
TEMPS = [0.0, 2.27, 10.0]
WIDTHS = [30, 34, 66, 190, 500]
ORIGINS = [0, 2**32 - 40, 2**33 + 6]
BOARDS = ["all-up", "Neel", "random"]
HEIGHT = 12


def make_board(kind: str, h: int, w: int, seed: int) -> np.ndarray:
    if kind == "all-up":
        return np.ones((h, w), np.int8)
    if kind == "Neel":
        return ((np.arange(h)[:, None] + np.arange(w)[None, :]) & 1).astype(np.int8)
    return np.random.default_rng(seed).integers(0, 2, size=(h, w), dtype=np.int8)


def rotl(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def narrow_hash(k0: int, k1: int, c1: int):
    """The kernel's ``NarrowHash`` of a slot: word 0's terms that do not
    depend on the index."""
    k0, k1, c1 = np.uint32(k0), np.uint32(k1), np.uint32(c1)
    with np.errstate(over="ignore"):
        keys = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
        x1 = c1 + k1
        return (k0 + x1, rotl(x1, 13), [keys[(g + 1) % 3] for g in range(5)],
                [keys[(g + 2) % 3] + np.uint32(g + 1) for g in range(4)])


def word0_narrow(consts, lo: np.ndarray) -> np.ndarray:
    """The kernel's ``threefry2x32_word0_narrow``."""
    x0c, x1c, inj0, inj1 = consts
    with np.errstate(over="ignore"):
        x0 = np.asarray(lo, np.uint32) + x0c
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


def slot_uniforms(k0: int, k1: int, counter: int, offset: int, substream: int):
    """The uniforms every thread of a slot forms from the slot's state
    (``SlotDraws``): the counter word and the narrow hash."""
    c1 = ((counter + offset) * prng.NSUB + substream) & U32
    return c1, narrow_hash(k0, k1, c1)


def popc(v: int) -> int:
    return bin(v).count("1")


def set_bits_high_first(v: int) -> list[int]:
    """The bits ``append_bits`` walks: each set bit, the highest first."""
    out = []
    while v:
        q = v.bit_length() - 1  # bfind
        out.append(q)
        v ^= 1 << q
    return out


def group_of(gi: int, wp: int) -> tuple[int, int, int]:
    """Thread gi's group: its row, first word and words."""
    per_row = -(-wp // GROUP)
    r, k = divmod(gi, per_row)
    j0 = k * GROUP
    return r, j0, min(GROUP, wp - j0)


def thread_words(x: np.ndarray, width: int, parity: int, gi: int):
    """One in-range thread's word step as the kernel takes it: its row,
    first word, words, parity ``a``, ``keep`` a word, and ``y3``, ``y4`` a
    pair."""
    h, wp = x.shape
    r, j0, nv = group_of(gi, wp)
    rem = width & 31
    top = (rem or 32) - 1
    row, above, below = (x[r], x[(r + 1) % h], x[(r - 1) % h])
    c = [int(row[min(j0 + g, wp - 1)]) for g in range(GROUP)]
    up = [int(above[min(j0 + g, wp - 1)]) for g in range(GROUP)]
    down = [int(below[min(j0 + g, wp - 1)]) for g in range(GROUP)]
    left_word = int(row[j0 - 1 if j0 > 0 else wp - 1])
    before = left_word if j0 > 0 else (left_word << (31 - top)) & U32
    right_word = int(row[j0 + nv if j0 + nv < wp else 0])
    after = (right_word << 31) & U32 if j0 + nv < wp else (right_word & 1) << top
    a = (r + parity) & 1
    parity_mask = 0xAAAAAAAA if a else EVEN
    last_mask = parity_mask & ((1 << rem) - 1 if rem else U32)
    last = wp - 1 - j0
    keep, d3, d4 = [], [], []
    for g in range(GROUP):
        left = ((c[g] << 1) | ((c[g - 1] if g else before) >> 31)) & U32
        right = (c[g] >> 1) | ((c[g + 1] << 31) & U32 if g + 1 < nv else after)
        s1 = up[g] ^ down[g] ^ left
        cs1 = (up[g] & down[g]) | ((up[g] ^ down[g]) & left)
        b0, cs2 = s1 ^ right, s1 & right
        b1, b2 = cs1 ^ cs2, cs1 & cs2
        n3 = b0 & b1 & ~b2 & U32
        n1 = b0 & ~b1 & ~b2 & U32
        n0 = ~(b0 | b1 | b2) & U32
        active = parity_mask if g < last else last_mask if g == last else 0
        d3.append(((c[g] & n3) | (~c[g] & n1)) & active)
        d4.append(((c[g] & b2) | (~c[g] & n0)) & active)
        keep.append(c[g] ^ (active & ~(d3[g] | d4[g]) & U32))
    y3 = [((d3[2 * p] >> a) | (d3[2 * p + 1] >> a) << 1) & U32 for p in range(PAIRS)]
    y4 = [((d4[2 * p] >> a) | (d4[2 * p + 1] >> a) << 1) & U32 for p in range(PAIRS)]
    return r, j0, nv, a, keep, y3, y4


def k6_batch_slot_model(x: np.ndarray, width: int, parity: int, k0: int, k1: int, counter: int,
                        offset: int, thr3: int, thr4: int, origin: int,
                        stats: dict | None = None) -> np.ndarray:
    """One live slot's half-sweep (packed words uint32[h, wp]) the way K6's
    batch mode computes it; ``stats`` (if given) receives the cells hashed
    and each warp's list."""
    h, wp = x.shape
    substream = prng.SUB_ODD if parity else prng.SUB_EVEN
    c1, consts = slot_uniforms(k0, k1, counter, offset, substream)
    step = (counter + offset) & U32
    narrow = mc_threefry.narrow_launch(h, width, origin)
    n_groups = h * -(-wp // GROUP)
    y = x.copy()
    for w0 in range(0, n_groups, WARP):
        lanes = []
        for lane in range(WARP):
            gi = w0 + lane
            if gi < n_groups:
                r, j0, nv, a, keep, y3, y4 = thread_words(x, width, parity, gi)
                # the pair's first active cell, less 32 x the pair's place
                base = [origin + r * width + 32 * (j0 + 2 * p) + a - 32 * (lane * PAIRS + p)
                        for p in range(PAIRS)]
            else:  # past the board's end: nothing decided
                r = j0 = nv = a = 0
                keep, y3, y4, base = [0] * GROUP, [0] * PAIRS, [0] * PAIRS, [0] * PAIRS
            lanes.append((r, j0, nv, a, keep, y3, y4, base))
        count3 = np.array([sum(map(popc, t[5])) for t in lanes])
        count4 = np.array([sum(map(popc, t[6])) for t in lanes])
        below3, below4 = np.cumsum(count3) - count3, np.cumsum(count4) - count4
        total3, total = int(count3.sum()), int(count3.sum() + count4.sum())
        # the list: each lane's slices of the two parts, the pairs in turn,
        # each pair's set bits the highest first
        entries = [None] * total
        for lane, t in enumerate(lanes):
            for part, at in ((5, int(below3[lane])), (6, total3 + int(below4[lane]))):
                for p in range(PAIRS):
                    for q in set_bits_high_first(t[part][p]):
                        assert entries[at] is None
                        entries[at] = (lane * PAIRS + p) << 5 | q
                        at += 1
        assert None not in entries
        entries = np.array(entries, np.int64)
        # lane l hashes entries l, l + 32, ...: ceil(total / 32) at most
        per_lane = np.bincount(np.arange(total) % WARP, minlength=WARP)
        assert per_lane.max(initial=0) == -(-total // WARP)
        pair, q = entries >> 5, entries & 31
        owner, p = pair // PAIRS, pair % PAIRS
        idx = np.array([lanes[o][7][pp] for o, pp in zip(owner, p)], np.int64) \
            + entries + 31 * (entries & 1)
        # the cell each entry names: word 2p + (q & 1) of its owner's group,
        # column (q & 30) + a
        r_o = np.array([lanes[o][0] for o in owner], np.int64)
        j_o = np.array([lanes[o][1] for o in owner], np.int64)
        a_o = np.array([lanes[o][3] for o in owner], np.int64)
        cell = origin + r_o * width + 32 * (j_o + 2 * p + (q & 1)) + (q & 30) + a_o
        assert np.array_equal(idx, cell)
        if narrow:
            assert int(idx.max(initial=0)) < 2**32
            u = word0_narrow(consts, idx.astype(np.uint32))
        else:
            lo, hi = jprng.split_cell_index(idx)
            u = jprng.cell_uniforms_at(np, lo, hi, np.uint32(k0), np.uint32(k1),
                                       np.uint32(step), substream)
        thr = np.where(np.arange(total) >= total3, np.uint32(thr4), np.uint32(thr3))
        accepted = [0] * (WARP * PAIRS)
        for pr, bit in zip(pair[u < thr], q[u < thr]):
            accepted[pr] |= 1 << int(bit)
        if stats is not None:
            stats.setdefault("cells", []).extend(cell.tolist())
            stats.setdefault("lists", []).append(entries.tolist())
        for lane, (r, j0, nv, a, keep, *_) in enumerate(lanes):
            for g in range(nv):
                acc = accepted[lane * PAIRS + g // 2] >> (g & 1)
                y[r, j0 + g] = keep[g] ^ ((acc & EVEN) << a)
    return y


def k6_batch_model(x: np.ndarray, width: int, parity: int, slots: list[dict], offset: int,
                   origin: int) -> np.ndarray:
    """K6's batch mode on the batch ``x`` (uint32[S, h, wp]): each live slot
    stepped, each frozen one (budget at most ``offset``) copied through."""
    out = x.copy()
    for s, slot in enumerate(slots):
        if slot["budget"] > offset:
            thr = ising.acceptance_thresholds(slot["temp"])
            out[s] = k6_batch_slot_model(x[s], width, parity, *prng.key_halves(slot["seed"]),
                                         slot["counter"], offset, int(thr[3]), int(thr[4]),
                                         origin)
    return out


def k7_batch_model(n: int, slots: list[dict], substream: int, offset: int,
                   stats: dict | None = None) -> np.ndarray:
    """K7's batch mode: DRAWS consecutive draws a thread of each slot's n
    cells, zeros for a frozen slot; ``stats`` receives each thread's
    stores (``"vector"`` where it stores 16 bytes at a time)."""
    out = np.zeros((len(slots), n), np.uint32)
    threads = -(-n // DRAWS)
    for s, slot in enumerate(slots):
        _, consts = slot_uniforms(*prng.key_halves(slot["seed"]), slot["counter"], offset,
                                  substream)
        for t in range(threads):
            i0 = t * DRAWS
            u = word0_narrow(consts, np.arange(i0, i0 + DRAWS, dtype=np.uint64).astype(np.uint32))
            if slot["budget"] <= offset:
                u[:] = 0
            vector = n % 4 == 0 and i0 + DRAWS <= n
            stored = DRAWS if vector else min(DRAWS, n - i0)
            out[s, i0:i0 + stored] = u[:stored]
            if stats is not None:
                stats.setdefault("stores", []).append((t, vector, stored))
    return out


def slot_list(n: int, seed: int, offset: int, temps=TEMPS) -> list[dict]:
    """``n`` slots: distinct seeds, the temperatures in turn, counters past
    2^31 on odd slots (one near 2^32, so that the word wraps), budgets past,
    at and below ``offset`` (frozen slots among live ones)."""
    rng = np.random.default_rng(seed)
    return [dict(seed=int(rng.integers(-2**40, 2**40)), temp=temps[i % len(temps)],
                 counter=(2**32 - 1 if i == 3 else 2**31 + int(rng.integers(0, 2**30)))
                 if i % 2 else int(rng.integers(0, 1000)),
                 budget=(offset + 1, offset, 100, offset + 2, 0)[i % 5])
            for i in range(n)]


def state_of(slots: list[dict]) -> prng.SlotState:
    def i32(values):
        return torch.tensor([prng.as_i32(v) for v in values], dtype=torch.int32)

    keys = [prng.key_halves(s["seed"]) for s in slots]
    thr = np.stack([ising.acceptance_thresholds(s["temp"]) for s in slots])
    return prng.SlotState(i32([k[0] for k in keys]), i32([k[1] for k in keys]),
                          i32([s["counter"] for s in slots]),
                          torch.from_numpy(thr.view(np.int32).copy()),
                          i32([s["budget"] for s in slots]))


def as_words(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.view(np.int32).copy())


# -- K6's batch mode ----------------------------------------------------------


@pytest.mark.parametrize("origin", ORIGINS)
@pytest.mark.parametrize("temperature", TEMPS)
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("kind", BOARDS)
def test_k6_batch_model_equals_plain_and_jax(kind, width, temperature, origin):
    # 4 slots (live, frozen at the second sweep, live past 2^31, live at
    # 2^32 - 1, which wraps), two sweeps of a chunk, both halves each
    slots = slot_list(4, seed=width, offset=1, temps=[temperature, 2.27, 10.0, 0.0])
    boards = [make_board(kind, HEIGHT, width, seed=width + s) for s in range(len(slots))]
    x = np.stack([jpacked.pack_board(b) for b in boards])
    want = x.copy()
    state = state_of(slots)
    jsweep = jpacked.make_sweep(np, JRULE, (HEIGHT, width), origin=origin)
    for offset in range(2):
        for parity in (0, 1):
            got = k6_batch_model(x, width, parity, slots, offset, origin)
            plain = mc_threefry.packed_metropolis_half_batch_plain(
                as_words(x), parity, state, width=width, offset=offset, origin=origin)
            np.testing.assert_array_equal(got, plain.numpy().view(np.uint32))
            x = got
        for s, slot in enumerate(slots):  # the JAX sweep under the freeze mask
            if slot["budget"] > offset:
                k0, k1 = prng.key_halves(slot["seed"])
                want[s] = jsweep(want[s], np.uint32(k0), np.uint32(k1),
                                 np.uint32((slot["counter"] + offset) & U32),
                                 ising.acceptance_thresholds(slot["temp"]))
        np.testing.assert_array_equal(x, want)


@pytest.mark.parametrize("width", WIDTHS)
def test_k6_batch_model_equals_jax_vmapped_sweep(width):
    # the JAX engine's form: jax.vmap of make_sweep over the slots, frozen
    # slots kept by the mask
    offset = 1
    slots = slot_list(5, seed=3 * width, offset=offset)
    boards = [make_board("random", HEIGHT, width, seed=s) for s in range(len(slots))]
    x = np.stack([jpacked.pack_board(b) for b in boards])
    got = x
    for parity in (0, 1):
        got = k6_batch_model(got, width, parity, slots, offset, 0)
    vsweep = jax.vmap(jpacked.make_sweep(jnp, JRULE, (HEIGHT, width)))
    keys = [prng.key_halves(s["seed"]) for s in slots]
    stepped = np.asarray(vsweep(
        jnp.asarray(x), jnp.asarray([k[0] for k in keys], jnp.uint32),
        jnp.asarray([k[1] for k in keys], jnp.uint32),
        jnp.asarray([(s["counter"] + offset) & U32 for s in slots], jnp.uint32),
        jnp.asarray(np.stack([ising.acceptance_thresholds(s["temp"]) for s in slots]))))
    live = np.array([s["budget"] > offset for s in slots])[:, None, None]
    np.testing.assert_array_equal(got, np.where(live, stepped, x))


@pytest.mark.parametrize("origin", [0, 2**33 + 6])
@pytest.mark.parametrize("kind", BOARDS)
def test_k6_batch_model_hashes_exactly_the_decided_cells(kind, origin):
    # each active cell whose move the table decides (dE > 0), once; a Neel
    # board decides none, an all-up one every active cell
    width, parity = 190, 1
    board = make_board(kind, HEIGHT, width, seed=11)
    thr = ising.acceptance_thresholds(2.27)
    stats = {}
    k6_batch_slot_model(jpacked.pack_board(board), width, parity, 5, 6, 2**31 + 9, 3,
                        int(thr[3]), int(thr[4]), origin, stats)
    s = board.astype(np.int32) * 2 - 1
    nsum = sum(np.roll(s, o, ax) for o in (1, -1) for ax in (0, 1))
    rows, cols = np.indices(board.shape)
    active = ((rows + cols + parity) & 1) == 0
    decided = (((s * nsum + 4) >> 1) >= 3) & active
    want = sorted((origin + rows * width + cols)[decided].tolist())
    assert sorted(stats["cells"]) == want
    assert len(want) == {"all-up": int(active.sum()), "Neel": 0}.get(kind, len(want))


@pytest.mark.parametrize("width", WIDTHS)
def test_groups_stay_in_their_rows_and_warps_span_rows(width):
    # a row's groups cover its words once; only its last may hold fewer
    # than 4; a warp of 32 groups spans rows where a row holds fewer
    wp = packed.packed_width(width)
    per_row = -(-wp // GROUP)
    words = []
    for gi in range(HEIGHT * per_row):
        r, j0, nv = group_of(gi, wp)
        assert 1 <= nv <= GROUP and (nv == GROUP or j0 + nv == wp)
        words += [(r, j0 + g) for g in range(nv)]
    assert words == [(r, j) for r in range(HEIGHT) for j in range(wp)]
    rows_of_warp0 = {group_of(gi, wp)[0] for gi in range(min(WARP, HEIGHT * per_row))}
    assert len(rows_of_warp0) == min(HEIGHT, -(-WARP // per_row))


def test_the_list_is_built_by_part_then_lane_then_pair_then_falling_bit():
    # rows of 6 words (a group of 4 and one of 2): entry 3's cells first,
    # then entry 4's; each lane's in turn, its pairs in turn, each pair's
    # bits the highest first
    width = 190
    board = np.random.default_rng(4).integers(0, 2, size=(4, width), dtype=np.int8)
    x = jpacked.pack_board(board)
    stats = {}
    k6_batch_slot_model(x, width, 0, 1, 2, 0, 0, 0, 0, 0, stats)
    (got,) = stats["lists"]
    want = []
    for part in (5, 6):
        for lane in range(8):
            ys = thread_words(x, width, 0, lane)[part]
            want += [(lane * PAIRS + p) << 5 | q
                     for p in range(PAIRS) for q in range(31, -1, -1) if ys[p] >> q & 1]
    assert len(want) > 32 and got == want


def test_slot_uniforms_wrap_as_the_counter_word():
    # the counter word a slot's threads form: (counter + offset) mod 2^32,
    # times NSUB, plus the substream, mod 2^32
    for counter, offset in ((2**32 - 1, 0), (2**32 - 1, 1), (2**31, 15), (7, 3)):
        for substream in (prng.SUB_EVEN, prng.SUB_ODD, prng.SUB_NOISE):
            c1, consts = slot_uniforms(5, 9, counter, offset, substream)
            assert c1 == prng.counter_word((counter + offset) & U32, substream)
            lo = np.arange(0, 2**32, 2**27 + 1, dtype=np.uint64).astype(np.uint32)
            want, _ = jprng.threefry2x32(np, np.uint32(5), np.uint32(9), lo, np.uint32(c1))
            np.testing.assert_array_equal(word0_narrow(consts, lo), want)


# -- K7's batch mode ----------------------------------------------------------


# (h, w): n of 1 (one thread, a tail of 1), 21 and 1023 (not 16-byte
# aligned: every store one at a time; tails of 5 and 7), 126 (n % 4 = 2),
# 660 (aligned, a tail of 4), 256 (no tail)
K7_SHAPES = [(1, 1), (3, 7), (33, 31), (9, 14), (10, 66), (16, 16)]


@pytest.mark.parametrize("substream", [prng.SUB_EVEN, prng.SUB_ODD, prng.SUB_NOISE])
@pytest.mark.parametrize("shape", K7_SHAPES)
def test_k7_batch_model_equals_plain_and_jax(shape, substream):
    h, w = shape
    n, offset = h * w, 2
    slots = slot_list(5, seed=n + substream, offset=offset)
    stats = {}
    got = k7_batch_model(n, slots, substream, offset, stats)
    plain = mc_threefry.cell_uniforms_batch_plain(shape, state_of(slots), substream,
                                                  offset=offset)
    np.testing.assert_array_equal(got, plain.numpy().view(np.uint32).reshape(len(slots), n))
    for s, slot in enumerate(slots):
        if slot["budget"] > offset:
            k0, k1 = prng.key_halves(slot["seed"])
            want = jprng.cell_uniforms(np, shape, np.uint32(k0), np.uint32(k1),
                                       np.uint32((slot["counter"] + offset) & U32), substream)
            np.testing.assert_array_equal(got[s], want.ravel())
        else:
            assert not got[s].any()
    # every cell stored once; 16-byte stores only where the slot's draws are aligned
    threads = stats["stores"][: -(-n // DRAWS)]
    assert sum(stored for _, _, stored in threads) == n
    assert all(vector == (n % 4 == 0 and stored == DRAWS) for _, vector, stored in threads)
    assert threads[-1][2] == n - DRAWS * (len(threads) - 1)


def test_k7_batch_model_equals_jax_vmapped_cell_uniforms():
    shape, offset, substream = (33, 31), 0, prng.SUB_NOISE
    slots = slot_list(6, seed=8, offset=offset)
    got = k7_batch_model(shape[0] * shape[1], slots, substream, offset)
    keys = [prng.key_halves(s["seed"]) for s in slots]
    vdraw = jax.vmap(lambda k0, k1, step: jprng.cell_uniforms(jnp, shape, k0, k1, step, substream))
    drawn = np.asarray(vdraw(jnp.asarray([k[0] for k in keys], jnp.uint32),
                             jnp.asarray([k[1] for k in keys], jnp.uint32),
                             jnp.asarray([(s["counter"] + offset) & U32 for s in slots],
                                         jnp.uint32)))
    live = np.array([s["budget"] > offset for s in slots])[:, None]
    np.testing.assert_array_equal(got, np.where(live, drawn.reshape(len(slots), -1), 0))
