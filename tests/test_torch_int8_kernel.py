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
from tpu_life_torch.models.rules import get_rule
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


def test_tile_shape_fills_the_card_and_fits_shared_memory():
    conway, bugs = get_rule("conway"), get_rule("bugs")
    # full-size boards keep the base tile
    assert kt.tile_shape(conway, 8, 16384, 16384, 132) == (32, 128)
    assert kt.tile_shape(bugs, 1, 8192, 8192, 132) == (32, 128)
    # the reference board already gives 4 x 47 blocks
    assert kt.tile_shape(conway, 8, 1500, 500, 132) == (32, 128)
    # small boards halve the tile height, down to 8 rows
    assert kt.tile_shape(conway, 8, 257, 1000, 132) == (16, 128)
    assert kt.tile_shape(conway, 8, 11, 11, 132) == (8, 128)
    # a deep halo grows the tile to four halos
    big = get_rule("R20,C2,S2..4,B3")
    rows, cols = kt.tile_shape(big, 1, 4096, 4096, 132)
    assert rows >= 80 and cols >= 128
    assert kt.shared_bytes(big, 1, rows, cols) <= kt.MAX_SHARED_BYTES
    # wider still, the tile shrinks to fit shared memory, its columns a
    # multiple of 16 (240 -> 128 at 1024^2, not 120)
    huge = get_rule("R60,C2,S2..4,B3")
    rows, cols = kt.tile_shape(huge, 1, 4096, 4096, 132)
    assert cols % 16 == 0
    assert kt.shared_bytes(huge, 1, rows, cols) <= kt.MAX_SHARED_BYTES
    assert kt.tile_shape(huge, 1, 1024, 1024, 132) == (30, 128)
    with pytest.raises(ValueError, match="shared memory"):
        kt.tile_shape(get_rule("R120,C2,S2..4,B3"), 1, 4096, 4096, 132)


@pytest.mark.parametrize("states", [2, 10])
@pytest.mark.parametrize("side", [512, 1000, 1024, 4096, 16384])
def test_tile_columns_stay_a_multiple_of_16(states, side):
    # every radius that fits gets 16-byte aligned tile columns, so a board
    # whose width is a multiple of 16 may take 16-byte stores; the largest
    # radius is 92 with 2 states and 61 with 10
    last = 0
    for r in range(1, 100):
        rule = get_rule(f"R{r},C{states},S2..4,B3")
        k = kt.clamp_block_steps(rule, 8)
        try:
            rows, cols = kt.tile_shape(rule, k, side, side, 132)
        except ValueError:
            break
        assert cols % 16 == 0 and cols >= 16 and rows >= 8
        assert kt.shared_bytes(rule, k, rows, cols) <= kt.MAX_SHARED_BYTES
        last = r
    assert last == {2: 92, 10: 61}[states]


def test_io16_needs_aligned_rows_tiles_and_buffers():
    assert kt.io16(1024, 128, 0, 4096)
    assert not kt.io16(1000, 128, 0, 4096)  # rows start off 16-byte boundaries
    assert not kt.io16(1024, 120, 0, 4096)  # odd tiles start off them
    assert not kt.io16(1024, 128, 0, 4104)  # a buffer does


def test_shared_bytes_counts_the_window():
    # conway, k = 8, 32 x 128 tile: 48 rows x 148 window columns (37 words,
    # odd), int16 sums at 150 (75 words, odd), a 2 x 9 table
    assert kt.shared_bytes(get_rule("conway"), 8, 32, 128) == 2 * 48 * 148 + 2 * 48 * 150 + 18
    # bugs, k = 1: 42 rows x 144 columns -> 148 (37 words), sums at 146
    assert kt.shared_bytes(get_rule("bugs"), 1, 32, 128) == 2 * 42 * 148 + 2 * 42 * 146 + 2 * 121
    assert kt.window(get_rule("conway"), 8, 128) == (148, 148, 150)
    assert kt.window(get_rule("bugs"), 1, 128) == (144, 148, 146)


@pytest.mark.parametrize(
    "spec,ops", [("conway", 7), ("brians_brain", 7), ("bugs", 7), ("R2,C2,M1,S5..10,B5..8", 6)]
)
def test_int_ops_per_cell_step(spec, ops):
    # alive test 1, running windows 2, centre 1 (0 with M1), table 2, mask 1
    assert kt.int_ops_per_cell_step(get_rule(spec)) == ops


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
