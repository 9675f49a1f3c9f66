"""The plain references and the roofline counts, on the CPU at small sizes:
each reference agrees with the program's numpy oracle and its torch
backend, each control breaks the guarantee it names, and the counts give
the bounds that PERF.md's table of kernels states."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import rooflines
from perfbench.reference import ising, life, mismatches, threefry

SEEDS = (0, 7, 2**31 + 11, 2**33 + 5)


def _board(seed: int, h: int, w: int, density: float = 0.5) -> np.ndarray:
    return (np.random.default_rng(seed).random((h, w)) < density).astype(np.int8)


# -- Conway ------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (33, 65), (64, 96)])
@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_life_matches_the_program(shape, backend):
    from tpu_life_torch.backends.base import get_backend
    from tpu_life_torch.models.rules import get_rule

    board = _board(sum(shape), *shape)
    kwargs = {} if backend == "numpy" else {"device": "cpu"}
    want = get_backend(backend, **kwargs).run(board, get_rule("conway"), 13)
    got = life.advance(torch.from_numpy(board), 13).numpy()
    assert mismatches(got, want) == 0


def test_life_batch_is_each_board_alone():
    boards = np.stack([_board(s, 24, 40) for s in range(3)])
    batch = life.advance(torch.from_numpy(boards), 9).numpy()
    for b, out in zip(boards, batch):
        assert mismatches(life.advance(torch.from_numpy(b), 9).numpy(), out) == 0


def test_life_control_breaks_the_clamped_edge():
    board = _board(3, 32, 64)
    clamped = life.advance(torch.from_numpy(board), 4).numpy()
    torus = life.control_advance(torch.from_numpy(board), 4).numpy()
    # the interior far from the edges agrees; the edges do not
    assert mismatches(clamped[6:-6, 6:-6], torus[6:-6, 6:-6]) == 0
    assert mismatches(clamped, torus) > 0


def test_mismatches_counts_cells_and_shapes():
    a = np.zeros((4, 4), np.int8)
    b = a.copy()
    b[1, 2] = 1
    assert mismatches(a, a) == 0
    assert mismatches(a, b) == 1
    assert mismatches(a, np.zeros((4, 5), np.int8)) == 20


# -- Threefry and Ising --------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_matches_the_program(seed):
    from tpu_life_torch.utils.threefry import key_halves, threefry2x32 as program

    k0, k1 = key_halves(seed)
    counters = np.random.default_rng(seed % 1000).integers(0, 2**32, 4096, dtype=np.uint64)
    c0 = counters.astype(np.uint32)
    for c1 in (0, 5, 2**32 - 1):
        want, _ = program(k0, k1, c0, np.uint32(c1))
        got = threefry.threefry2x32(k0, k1, torch.from_numpy(c0.view(np.int32)), c1)
        assert np.array_equal(got.numpy().view(np.uint32), want)


def test_threefry_below_is_unsigned():
    u = torch.tensor([threefry.i32(v) for v in (0, 1, 2**31 - 1, 2**31, 2**32 - 1)])
    assert threefry.below(u, 2**31).tolist() == [True, True, True, False, False]
    assert threefry.below(u, 2**32 - 1).tolist() == [True, True, True, True, False]


def test_ising_thresholds_match_the_program():
    from tpu_life_torch.mc.ising import acceptance_thresholds

    for t in (0.0, 1.0, 2.27, 3.0, 100.0):
        table = acceptance_thresholds(t)
        assert ising.thresholds(t) == (int(table[3]), int(table[4]))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("start", [0, 3, 2**30 + 1])
def test_ising_matches_the_numpy_oracle(seed, start):
    from tpu_life_torch.mc.engine import MCHostRunner
    from tpu_life_torch.models.rules import get_rule

    board = _board(seed % 97, 16, 32)
    oracle = MCHostRunner(board, get_rule("ising"), seed=seed, temperature=2.27, start_step=start)
    oracle.advance(3)
    got = ising.advance(torch.from_numpy(board), 3, seed=seed, start=start, temperature=2.27)
    assert mismatches(got.numpy(), oracle.fetch()) == 0


@pytest.mark.parametrize("shape", [(32, 64), (18, 46)])
def test_ising_matches_the_torch_backend(shape):
    from tpu_life_torch.backends.base import get_backend, make_runner
    from tpu_life_torch.models.rules import get_rule

    seed = 2**31 + 123
    board = _board(5, *shape)
    runner = make_runner(get_backend("torch", device="cpu"), board, get_rule("ising"),
                         seed=seed, temperature=2.27)
    runner.advance(5)
    got = ising.advance(torch.from_numpy(board), 5, seed=seed, start=0, temperature=2.27)
    assert mismatches(got.numpy(), runner.fetch()) == 0


def test_ising_chunks_compose():
    board = torch.from_numpy(_board(9, 16, 16))
    whole = ising.advance(board, 6, seed=3, start=0, temperature=2.27)
    parts = ising.advance(ising.advance(board, 2, seed=3, start=0, temperature=2.27),
                          4, seed=3, start=2, temperature=2.27)
    assert torch.equal(whole, parts)


def test_ising_control_breaks_the_stream():
    board = torch.from_numpy(_board(4, 32, 32))
    kwargs = dict(seed=11, start=0, temperature=2.27)
    assert mismatches(ising.advance(board, 2, **kwargs).numpy(),
                      ising.control_advance(board, 2, **kwargs).numpy()) > 0


def test_decided_cells_counts_positive_energy_moves():
    board = _board(12, 16, 24)
    spins = board.astype(np.int64) * 2 - 1
    nsum = sum(np.roll(spins, s, a) for s in (1, -1) for a in (0, 1))
    rows, cols = np.indices(board.shape)
    for half in (0, 1):
        colour = ((rows + cols) & 1) == half
        want = int(np.count_nonzero((2 * spins * nsum > 0) & colour))
        assert ising.decided_cells(torch.from_numpy(board), half) == want


# -- roofline counts, pinned to PERF.md's table of kernels --------------------------

def _bound_ms(ops, nbytes):
    return 1e3 * rooflines.bound_s(ops, nbytes)


def test_k1_bound_at_16384_squared():
    n = rooflines.words(16384, 16384)
    assert n == 8_388_608
    assert _bound_ms(rooflines.k1_ops(n, 8), rooflines.k1_bytes(n, 1)) == pytest.approx(0.0602, abs=5e-5)


def test_k1_batch_bound_at_8_boards_of_4096_squared():
    # a 16-step chunk: two launches of 8 steps over the batch's words
    n = 8 * rooflines.words(4096, 4096)
    assert _bound_ms(rooflines.k1_ops(n, 16), rooflines.k1_bytes(n, 2)) == pytest.approx(0.0602, abs=5e-5)


def test_k6_bound_at_16384_squared():
    n = rooflines.words(16384, 16384)
    ms = _bound_ms(rooflines.k6_ops(113_833_493, n), rooflines.k6_bytes(n))
    assert ms == pytest.approx(0.2744, abs=5e-5)


def test_bound_takes_the_larger_side():
    peak = rooflines.peak_ops_per_s()
    assert rooflines.bound_s(peak, 0) == pytest.approx(1.0)
    assert rooflines.bound_s(0, rooflines.HBM_BYTES_PER_S) == pytest.approx(1.0)
    assert rooflines.words(3, 33) == 6
