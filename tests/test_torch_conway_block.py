"""Kernel K5's plain version against the JAX package's Conway block kernel
(``experiments/pallas_bench.py``: ``make_kernel`` with ``conway_pallas``'s
specs, in Pallas interpret mode on the CPU) and the numpy oracle, on
boards from ``np.random.default_rng``; every comparison is exact.  Also
the wrapper's domain, its CPU path, and the port's experiment
(``tpu_life_torch.experiments.block_bench``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from experiments.pallas_bench import make_kernel
from tpu_life.models.rules import get_rule as jget_rule
from tpu_life.ops.reference import run_np as jrun_np
from tpu_life_torch.experiments import block_bench
from tpu_life_torch.kernels import conway_block as k5

# (n, bh, k): k < bh, k == bh (the edge blocks' halos reach the whole
# neighbouring block), a block and its halos filling the board (32, 16, 8)
CASES = [(32, 16, 8), (48, 16, 3), (64, 16, 4), (64, 16, 16), (96, 32, 8)]


def _jax_conway_block(n, bh, k):
    """``conway_pallas(n, bh, k)`` in interpret mode: its kernel, grid and
    specs, with the backend-neutral ``ANY`` memory space."""
    kernel, nb, ext = make_kernel(n, bh, k)
    return pl.pallas_call(
        kernel,
        grid=(nb,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((bh, n), lambda i: (i, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((n, n), jnp.int8),
        scratch_shapes=[pltpu.VMEM((ext, n), jnp.int8), pltpu.SemaphoreType.DMA(())],
        interpret=True,
    )


def _board(n, seed):
    return np.random.default_rng(seed).integers(0, 2, size=(n, n), dtype=np.int8)


def _plain(board, k):
    return k5.conway_block_plain(torch.from_numpy(board), k).numpy()


@pytest.mark.parametrize("n,bh,k", CASES)
def test_plain_equals_the_jax_kernel(n, bh, k):
    board = _board(n, seed=n * 31 + k)
    want = np.asarray(_jax_conway_block(n, bh, k)(board))
    np.testing.assert_array_equal(_plain(board, k), want)


@pytest.mark.parametrize("n,bh,k", CASES)
def test_plain_equals_run_np(n, bh, k):
    board = _board(n, seed=n * 17 + k)
    board[[0, -1], :] = 1  # live cells on all four edges
    board[:, [0, -1]] = 1
    np.testing.assert_array_equal(_plain(board, k), jrun_np(board, jget_rule("conway"), k))


@pytest.mark.parametrize(
    "shape,bh,k,match",
    [
        ((32, 16), 8, 4, "square"),
        ((48, 48), 20, 4, "divide"),
        ((48, 48), 0, 1, "divide"),
        ((48, 48), 16, 0, r"\[1, bh=16\]"),
        ((64, 64), 16, 17, r"\[1, bh=16\]"),  # the JAX kernel's wrong board
        ((32, 32), 16, 9, "exceed"),  # the JAX kernel does not trace
        ((16, 16), 16, 2, "exceed"),
    ],
)
def test_out_of_domain_raises(shape, bh, k, match):
    with pytest.raises(ValueError, match=match):
        k5.conway_block(torch.zeros(shape, dtype=torch.int8), bh, k)


def test_wrong_dtype_and_layout_raise():
    with pytest.raises(TypeError, match="int8"):
        k5.conway_block(torch.zeros((32, 32), dtype=torch.int32), 16, 4)
    with pytest.raises(ValueError, match="contiguous"):
        k5.conway_block(torch.zeros((32, 32), dtype=torch.int8).t()[:, :], 16, 4)
    with pytest.raises(ValueError, match="cuda or cpu"):
        k5.conway_block(torch.zeros((32, 32), dtype=torch.int8, device="meta"), 16, 4)


def test_cpu_wrapper_runs_the_plain_version_and_launches_nothing():
    board = torch.from_numpy(_board(64, seed=5))
    before = k5.conway_block.launches
    got = k5.conway_block(board, 16, 16)
    assert k5.conway_block.launches == before
    assert torch.equal(got, k5.conway_block_plain(board, 16))
    assert torch.equal(board, torch.from_numpy(_board(64, seed=5)))  # x left as it was


@pytest.mark.parametrize("k", [1, 2, 3, 4, 8, 31, k5.MAX_DEPTH])
def test_tile_columns_leave_a_halo_of_k_in_whole_words(k):
    # the window's columns beside the tile are a whole number of 4-cell
    # words and at least k on each side: a launch's k substeps keep the
    # tile exact
    cols = k5.tile_cols(k)
    assert cols > 0 and cols % 4 == 0
    halo = (k5.WINDOW_COLS - cols) // 2
    assert halo >= k and halo % 4 == 0 and halo < k + 4


def test_block_bench_on_the_cpu(capsys):
    assert block_bench.run(n=64, bh=16, k=4, outer=2, device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "correct after 8 steps: True"
    assert out[1].startswith("n=64 bh=16 k=4: ") and out[1].endswith(" cells/s")


def test_block_bench_main_parses_key_value_arguments(capsys):
    assert block_bench.main(["n=48", "bh=16", "k=3", "outer=1", "device=cpu"]) == 0
    assert capsys.readouterr().out.startswith("correct after 6 steps: True")
    with pytest.raises(ValueError):
        block_bench.main(["n=64", "bh=16", "k=20", "device=cpu"])


def test_block_bench_exits_non_zero_on_a_wrong_board(monkeypatch, capsys):
    monkeypatch.setattr(block_bench, "conway_block", lambda x, bh, k, out=None: torch.zeros_like(x))
    assert block_bench.main(["n=32", "bh=16", "k=2", "device=cpu"]) == 1
    assert capsys.readouterr().out.startswith("correct after 4 steps: False")
