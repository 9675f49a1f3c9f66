"""Kernel K2 (``kernels/int8_tiled.py``) and the ``cuda`` backend's int8
route on the CPU: the plain version against the JAX Pallas kernel it
replaces, run in interpret mode as ``tests/test_pallas.py`` runs it, and
against the numpy oracle; the wrapper's checks; the tile geometry and
counts the launch uses; the dispatch between K1 and K2; the int8 board
layout of ``interop``.  The CUDA kernel itself is held to the plain
version on the card by ``chip_smoke.py``."""

import functools

import numpy as np
import pytest
import torch

from tpu_life.backends.pallas_backend import PallasBackend
from tpu_life.models.rules import get_rule as jget_rule
from tpu_life.ops import bitlife as jbitlife
from tpu_life_torch import interop
from tpu_life_torch.backends import cuda_backend
from tpu_life_torch.backends.base import make_runner
from tpu_life_torch.backends.cuda_backend import CudaBackend
from tpu_life_torch.kernels import int8_tiled as kt
from tpu_life_torch.models.rules import RULE_REGISTRY, get_rule
from tpu_life_torch.ops.reference import run_np

# (rule, shape, steps, block_steps) at tests/test_pallas.py's shapes: ragged
# rows and columns, several column tiles, r = 5 with its depth clamped,
# Generations; block depths that leave a remainder launch
CASES = [
    ("conway", (70, 150), 9, 4),  # uneven rows + uneven cols, remainder 1
    ("conway", (64, 300), 8, 3),  # three column tiles, remainder 2
    ("highlife", (64, 128), 8, 8),  # exactly one column tile
    ("brians_brain", (40, 133), 7, 4),  # Generations decay states
    ("bugs", (64, 140), 5, 4),  # LtL r=5: deep halo, depth clamped to 1
    ("day_and_night", (33, 200), 6, 5),
    ("star_wars", (48, 130), 6, 4),  # 4 states, remainder 2
    ("bugs_decay", (40, 131), 3, 2),  # LtL r=5 with a dying state
    ("R2,C2,M1,S5..10,B5..8", (36, 144), 5, 2),  # centre counted, r=2
]


def _board(shape, rule, seed):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, rule.states, size=shape, dtype=np.int8)
        * rng.integers(0, 2, size=shape, dtype=np.int8)
    )


@functools.cache
def _pallas(spec, shape, steps, block_steps):
    """The JAX int8 Pallas kernel (interpret mode) on a seeded board."""
    b = _board(shape, get_rule(spec), seed=sum(shape))
    be = PallasBackend(
        bitpack=False, interpret=True, block_rows=16, block_cols=128,
        block_steps=block_steps,
    )
    return b, be.run(b, jget_rule(spec), steps)


@pytest.mark.parametrize("spec,shape,steps,k", CASES)
def test_plain_matches_pallas_interpret(spec, shape, steps, k):
    b, want = _pallas(spec, shape, steps, k)
    rule = get_rule(spec)
    np.testing.assert_array_equal(want, run_np(b, rule, steps))
    x = interop.board_from_reference(b, shape, layout="cells")
    got = kt.int8_multi_step(x, rule, shape, steps, block_steps=kt.clamp_block_steps(rule, k))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(interop.board_to_reference(got, shape), want)


@pytest.mark.parametrize("spec,shape,steps,k", CASES)
def test_cuda_backend_int8_route_matches_pallas(spec, shape, steps, k):
    b, want = _pallas(spec, shape, steps, k)
    got = CudaBackend(device="cpu", bitpack=False, block_steps=k).run(b, get_rule(spec), steps)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("spec", ["bugs", "bugs_decay", "brians_brain", "R2,C2,M1,S5..10,B5..8"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_births_past_the_edges(spec, k):
    # live cells touching all four edges: Larger-than-Life B34..45 gives
    # birth to dead cells just past a full edge, which must stay dead
    rule = get_rule(spec)
    b = np.zeros((26, 30), np.int8)
    b[:6], b[-6:], b[:, :6], b[:, -6:] = 1, 1, 1, 1
    b[10:14, 12:18] = rule.states - 1
    want = run_np(b, rule, 4)
    x = interop.board_from_reference(b, b.shape, layout="cells")
    np.testing.assert_array_equal(
        kt.int8_multi_step(x, rule, b.shape, 4, block_steps=k).numpy(), want
    )
    np.testing.assert_array_equal(
        CudaBackend(device="cpu", bitpack=False, block_steps=k).run(b, rule, 4), want
    )


def test_bugs_edges_match_pallas_interpret():
    b = np.zeros((48, 140), np.int8)
    b[:7], b[-7:], b[:, :7], b[:, -7:] = 1, 1, 1, 1
    want = PallasBackend(
        bitpack=False, interpret=True, block_rows=16, block_cols=128, block_steps=2
    ).run(b, jget_rule("bugs"), 3)
    got = kt.int8_multi_step(
        interop.board_from_reference(b, b.shape, layout="cells"), get_rule("bugs"), b.shape, 3,
        block_steps=1,
    )
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, run_np(b, get_rule("bugs"), 3))


def test_wrapper_rejects_bad_inputs():
    rule = get_rule("brians_brain")
    x = torch.zeros((4, 40), dtype=torch.int8)
    with pytest.raises(TypeError):
        kt.int8_multi_step(x.to(torch.int32), rule, (4, 40), 1, block_steps=8)
    with pytest.raises(ValueError, match="shape"):
        kt.int8_multi_step(x, rule, (4, 41), 1, block_steps=8)
    with pytest.raises(ValueError, match="contiguous"):
        kt.int8_multi_step(torch.zeros((40, 4), dtype=torch.int8).t(), rule, (4, 40), 1, block_steps=8)
    with pytest.raises(ValueError, match="block_steps"):
        kt.int8_multi_step(x, rule, (4, 40), 1, block_steps=33)
    with pytest.raises(ValueError, match="block_steps"):
        kt.int8_multi_step(x, rule, (4, 40), 1, block_steps=0)
    with pytest.raises(ValueError, match="steps"):
        kt.int8_multi_step(x, rule, (4, 40), -1, block_steps=8)
    for spec in ("conway:T", "R1,C2,S1,B1,NN"):
        with pytest.raises(ValueError, match="clamped Moore"):
            kt.int8_multi_step(x, get_rule(spec), (4, 40), 1, block_steps=8)
    with pytest.raises(ValueError, match="cuda or cpu"):
        kt.int8_multi_step(x.to("meta"), rule, (4, 40), 1, block_steps=8)


def test_cpu_tensor_takes_the_plain_version_without_launching():
    rule = get_rule("star_wars")
    b = _board((20, 50), rule, seed=0)
    x = interop.board_from_reference(b, b.shape, layout="cells")
    before = kt.int8_multi_step.launches
    got = kt.int8_multi_step(x, rule, b.shape, 10, block_steps=4)
    assert kt.int8_multi_step.launches == before
    assert torch.equal(got, kt.int8_multi_step_plain(x, rule, b.shape, 10))
    np.testing.assert_array_equal(x.numpy(), b)  # the input is not written


@pytest.mark.parametrize(
    "spec,k,want",
    [("conway", 8, 8), ("conway", 32, 8), ("conway", 1, 1), ("R2,C2,S2..4,B3", 8, 4),
     ("R3,C2,S2..4,B3", 8, 2), ("bugs", 8, 1), ("R20,C2,S2..4,B3", 8, 1)],
)
def test_clamp_block_steps(spec, k, want):
    assert kt.clamp_block_steps(get_rule(spec), k) == want


# the depth before the kernel's tile grew, at depth 8 and more: a 32 x
# 128 base of 4 halos, 8 // r
_CLAMP_DEPTH = {1: 8, 2: 4, 3: 2, 4: 2}


@pytest.mark.parametrize("radius", range(1, 41))
@pytest.mark.parametrize("k", [1, 2, 3, 4, 8, 16, 32])
def test_clamp_block_steps_keeps_the_depth_of_the_32x128_base(radius, k):
    # the depth (and so the launch count and the work of a launch) is what
    # it was before the kernel's tile grew: 8, 4, 2, 2 at r = 1-4, then 1
    rule = get_rule(f"R{radius},C2,S2..4,B3")
    assert kt.clamp_block_steps(rule, k) == min(k, _CLAMP_DEPTH.get(radius, 1))


def test_tile_shape_fills_the_card_and_fits_shared_memory():
    conway, bugs, brain = get_rule("conway"), get_rule("bugs"), get_rule("brians_brain")
    # full-size boards keep the base tile
    assert kt.tile_shape(conway, 8, 16384, 16384, 132) == (64, 256)
    assert kt.tile_shape(brain, 8, 16384, 16384, 132) == (64, 256)
    assert kt.tile_shape(bugs, 1, 8192, 8192, 132) == (64, 256)
    assert kt.tile_shape(brain, 8, 8192, 8192, 132) == (64, 256)  # a 2x2 shard
    assert kt.tile_shape(bugs, 1, 2048, 8192, 132) == (64, 256)  # a row shard
    # small boards halve the tile height, down to 8 rows, to give every SM
    # a block: the reference board takes 2 x 94
    assert kt.tile_shape(conway, 8, 1500, 500, 132) == (16, 256)
    assert kt.tile_shape(conway, 8, 257, 1000, 132) == (8, 256)
    assert kt.tile_shape(conway, 8, 11, 11, 132) == (8, 256)
    # a deep halo grows the tile to four halos
    big = get_rule("R20,C2,S2..4,B3")
    assert kt.tile_shape(big, 1, 4096, 4096, 132) == (80, 256)
    assert kt.shared_bytes(big, 1, 80, 256) <= kt.MAX_SHARED_BYTES
    # wider still, the tile shrinks to fit shared memory, its columns a
    # multiple of 16
    huge = get_rule("R60,C2,S2..4,B3")
    assert kt.tile_shape(huge, 1, 4096, 4096, 132) == (240, 128)
    assert kt.shared_bytes(huge, 1, 240, 128) <= kt.MAX_SHARED_BYTES
    assert kt.tile_shape(huge, 1, 1024, 1024, 132) == (30, 256)
    with pytest.raises(ValueError, match="shared memory"):
        kt.tile_shape(get_rule("R124,C10,S2..4,B3"), 1, 4096, 4096, 132)


@pytest.mark.parametrize("states", [2, 10])
@pytest.mark.parametrize("side", [512, 1000, 1024, 4096, 16384])
def test_tile_columns_stay_a_multiple_of_16(states, side):
    # every radius that fits gets 16-byte aligned tile columns, so a board
    # whose width is a multiple of 16 may take 16-byte copies; the largest
    # radius is 127 with 2 states (the byte lanes' limit) and 123 with 10
    # (shared memory's)
    last = 0
    for r in range(1, 200):
        rule = get_rule(f"R{r},C{states},S2..4,B3")
        k = kt.clamp_block_steps(rule, 8)
        try:
            rows, cols = kt.tile_shape(rule, k, side, side, 132)
        except ValueError:
            break
        assert cols % 16 == 0 and cols >= 16 and rows >= 8
        assert kt.shared_bytes(rule, k, rows, cols) <= kt.MAX_SHARED_BYTES
        last = r
    assert last == {2: 127, 10: 123}[states]


@pytest.mark.parametrize(
    "spec,ok",
    [("R92,C2,S3000..20000,B8000..8600", True), ("R61,C10,S300..3000,B700..780", True),
     ("R127,C2,S3000..20000,B8000..8600", True), ("R123,C10,S300..3000,B700..780", True),
     ("R128,C2,S3000..20000,B8000..8600", False), ("R200,C2,S2..4,B3", False)],
)
def test_radius_limit_of_the_byte_lanes(spec, ok):
    # a vertical sum of 2r + 1 cells lives in a byte: 2r + 1 > 255 raises,
    # and every radius the kernel ran before still runs
    rule = get_rule(spec)
    if ok:
        kt.check_radius(rule)
        rows, cols = kt.tile_shape(rule, 1, 512, 512, 132)
        assert kt.shared_bytes(rule, 1, rows, cols) <= kt.MAX_SHARED_BYTES
    else:
        with pytest.raises(ValueError, match="radius"):
            kt.check_radius(rule)
        with pytest.raises(ValueError, match="radius"):
            kt.tile_shape(rule, 1, 512, 512, 132)


def test_io16_needs_aligned_rows_tiles_and_buffers():
    # 16-byte copies where every row and buffer starts on a 16-byte
    # boundary; narrower copies where only 8 or 4 bytes align (tiles are
    # always a multiple of 16 columns now, so they need no check)
    assert kt.io_bytes(1024, 0, 4096) == 16
    assert kt.io_bytes(1000, 0, 4096) == 8  # rows start off 16-byte boundaries
    assert kt.io_bytes(500, 0, 4096) == 4
    assert kt.io_bytes(1024, 0, 4104) == 8  # a buffer does


@pytest.mark.parametrize(
    "n,ptrs,want",
    [(1024, (0, 4096), 16), (1000, (0, 4096), 8), (500, (0, 4096), 4), (517, (0, 4096), 1),
     (1024, (0, 4104), 8), (1024, (0, 4100), 4), (1024, (0, 4097), 1), (16, (), 16)],
)
def test_io_bytes_divide_the_rows_and_the_buffers(n, ptrs, want):
    # the widest copy (16, 8 or 4 bytes) that lies wholly inside or wholly
    # outside every row of every buffer; single bytes otherwise
    assert kt.io_bytes(n, *ptrs) == want


def test_shared_bytes_counts_the_window():
    # brians_brain, k = 8, 64 x 256 tile: 80 rows; margins of 16 columns,
    # 288 window columns at a pitch of 304 (19 units of 16), the sums'
    # pitch 336 (21 units, 32 bytes past the window); at r = 1 a state
    # plane and two alternating planes of alive bits with three 16-byte
    # guards, no sums, the rule's bits in a register
    brain = get_rule("brians_brain")
    assert kt.window(brain, 8, 256) == (16, 288, 304, 336)
    assert kt.shared_bytes(brain, 8, 64, 256) == 3 * 80 * 304 + 48
    # conway: the states are the alive bits, two planes
    assert kt.shared_bytes(get_rule("conway"), 8, 64, 256) == 2 * 80 * 304 + 48
    # bugs, k = 1: 74 rows, the rule's 242 bits in 8 words of shared memory,
    # one plane of states (the alive bits) and the sums between two guards
    bugs = get_rule("bugs")
    assert kt.window(bugs, 1, 256) == (16, 288, 304, 336)
    assert kt.shared_bytes(bugs, 1, 64, 256) == 32 + 74 * 304 + 74 * 336 + 64
    # bugs_decay: a state and an alive plane
    assert kt.shared_bytes(get_rule("bugs_decay"), 1, 64, 256) == 32 + 2 * 74 * 304 + 74 * 336 + 64
    # a window of 15 units of 16 keeps its pitch; the sums take 17; r = 2
    # keeps the rule's 50 bits in shared memory
    r2 = get_rule("R2,C2,S2..4,B3")
    assert kt.window(r2, 4, 208) == (16, 240, 240, 272)
    assert kt.shared_bytes(r2, 4, 8, 208) == 16 + 24 * 240 + 24 * 272 + 64


@pytest.mark.parametrize(
    "spec,ops",
    [("conway", 7), ("brians_brain", 7), ("bugs", 7), ("R2,C2,M1,S5..10,B5..8", 6),
     ("star_wars", 7)],
)
def test_int_ops_per_cell_step(spec, ops):
    # the function's count for its bound, unchanged by the kernel's design:
    # alive test 1, running windows 2, centre 1 (0 with M1), rule 2, mask 1
    assert kt.int_ops_per_cell_step(get_rule(spec)) == ops


@pytest.mark.parametrize(
    "spec,ops",
    [("conway", 15 / 32), ("R1,C2,M1,S3..4,B3", 15 / 32), ("seeds", 14 / 32),
     ("brians_brain", 16 / 32), ("star_wars", 19 / 32), ("bugs", 7), ("bugs_decay", 7),
     ("R2,C2,M1,S5..10,B5..8", 6)],
)
def test_ops_per_cell_step_counts_the_function(spec, ops):
    # the bound's count: at r = 1 the bit-sliced step over 32 cells, as K1
    # counts it (conway 15 a word; centre-counted conway the same; a
    # Generations rule 2 more a word), at r >= 2 the per-cell count
    assert kt.ops_per_cell_step(get_rule(spec)) == ops


def _random_ltl(seed):
    rng = np.random.default_rng(seed)
    r = int(rng.integers(1, 8))
    states = int(rng.integers(2, 11))
    center = bool(rng.integers(0, 2))
    top = (2 * r + 1) ** 2 - (0 if center else 1)
    lo_s, lo_b = sorted(rng.integers(0, top + 1, size=2))
    hi_s, hi_b = int(rng.integers(lo_s, top + 1)), int(rng.integers(lo_b, top + 1))
    return f"R{r},C{states},{'M1,' if center else ''}S{lo_s}..{hi_s},B{lo_b}..{hi_b}"


_MOORE = sorted(
    name for name, r in RULE_REGISTRY.items()
    if r.neighborhood == "moore" and r.boundary == "clamped"
)
_SPECS = _MOORE + ["bugs_decay", "R2,C2,M1,S5..10,B5..8"] + [_random_ltl(s) for s in range(12)]


def _table_from_bits(rule, words):
    """The transition table int8[states, max_count + 1] that the kernel
    computes from rule_bits's words and its state arithmetic: a state-1
    cell whose bit is clear becomes 2 when the rule has more than 2 states
    (else 0), a state s >= 2 becomes (s + 1) % states."""
    n = rule.max_count + 1
    table = np.zeros((rule.states, n), dtype=np.int8)
    for s in range(rule.states):
        for count in range(n):
            if s >= 2:
                table[s, count] = (s + 1) % rule.states
                continue
            idx = count + s * n
            if int(words[idx >> 5]) >> (idx & 31) & 1:
                table[s, count] = 1
            elif s == 1 and rule.states > 2:
                table[s, count] = 2
    return table


@pytest.mark.parametrize("spec", _SPECS)
def test_rule_bits_rebuild_the_transition_table(spec):
    # the birth and survive words and the kernel's state arithmetic give
    # back Rule.transition_table, here and in the JAX package
    rule = get_rule(spec)
    words = kt.rule_bits(rule)
    assert words.dtype == np.uint32 and len(words) == kt.n_words(rule)
    assert (len(words) == 1) == (rule.radius == 1)  # r = 1: the kernel's register
    n = rule.max_count + 1
    assert not any(int(words[i >> 5]) >> (i & 31) & 1 for i in range(2 * n, 32 * len(words)))
    got = _table_from_bits(rule, words)
    np.testing.assert_array_equal(got, rule.transition_table)
    np.testing.assert_array_equal(got, jget_rule(spec).transition_table)


@pytest.mark.parametrize(
    "spec,bitpack,route",
    [("conway", True, "packed"), ("conway", False, "int8"), ("brians_brain", True, "int8"),
     ("bugs", True, "int8"), ("star_wars", False, "int8"), ("highlife", True, "packed")],
)
def test_backend_routes_each_rule_to_one_kernel(spec, bitpack, route, monkeypatch):
    calls = {"packed": [], "int8": []}
    real = {"packed": cuda_backend.packed_multi_step, "int8": cuda_backend.int8_multi_step}

    def counting(kind):
        def fn(*args, **kw):
            calls[kind].append((args[3], kw["block_steps"]))
            return real[kind](*args, **kw)
        return fn

    monkeypatch.setattr(cuda_backend, "packed_multi_step", counting("packed"))
    monkeypatch.setattr(cuda_backend, "int8_multi_step", counting("int8"))
    rule = get_rule(spec)
    b = _board((24, 40), rule, seed=2)
    runner = make_runner(CudaBackend(device="cpu", bitpack=bitpack), b, rule)
    runner.advance(5)
    runner.advance(3)
    k = kt.clamp_block_steps(rule, 8) if route == "int8" else 8
    assert calls[route] == [(5, k), (3, k)]
    assert calls["int8" if route == "packed" else "packed"] == []
    want = run_np(b, rule, 8)
    np.testing.assert_array_equal(runner.fetch(), want)
    assert runner.live_count() == int((want == 1).sum())


@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (5, 40)])
def test_tiny_board_stays_on_the_int8_kernel_path(shape, monkeypatch):
    # no small-board fallback: every advance goes through the K2 wrapper
    calls = []
    real = cuda_backend.int8_multi_step

    def counting(*args, **kw):
        calls.append(args[3])
        return real(*args, **kw)

    monkeypatch.setattr(cuda_backend, "int8_multi_step", counting)
    rule = get_rule("brians_brain")
    b = _board(shape, rule, seed=1)
    runner = make_runner(CudaBackend(device="cpu"), b, rule)
    runner.advance(5)
    runner.advance(4)
    assert calls == [5, 4]
    np.testing.assert_array_equal(runner.fetch(), run_np(b, rule, 9))


def test_int8_snapshot_survives_later_advances():
    rule = get_rule("star_wars")
    b = _board((12, 40), rule, seed=8)
    runner = make_runner(CudaBackend(device="cpu"), b, rule)
    runner.advance(2)
    snap = runner.snapshot()
    runner.advance(3)
    np.testing.assert_array_equal(snap(), run_np(b, rule, 2))
    np.testing.assert_array_equal(runner.fetch(), run_np(b, rule, 5))
    np.testing.assert_array_equal(b, _board((12, 40), rule, seed=8))  # caller's board untouched


def test_interop_generations_board_round_trip():
    # a Generations board keeps its dying states in the int8 layout, and
    # refuses to be packed into words, which hold state 1 only
    rule = get_rule("star_wars")
    b = _board((9, 70), rule, seed=1)
    assert b.max() == 3
    cells = interop.board_from_reference(b, b.shape, layout="cells")
    assert cells.dtype == torch.int8 and tuple(cells.shape) == b.shape
    np.testing.assert_array_equal(interop.board_to_reference(cells, b.shape), b)
    with pytest.raises(ValueError, match="states other than 0 and 1"):
        interop.board_from_reference(b, b.shape)
    # packed words in, cells out: the 2-state board
    alive = (b == 1).astype(np.int8)
    from_words = interop.board_from_reference(jbitlife.pack_np(alive), b.shape, layout="cells")
    np.testing.assert_array_equal(from_words.numpy(), alive)
    with pytest.raises(ValueError, match="layout"):
        interop.board_from_reference(b, b.shape, layout="bytes")
    with pytest.raises(ValueError, match="shape"):
        interop.board_to_reference(cells, (9, 71))

