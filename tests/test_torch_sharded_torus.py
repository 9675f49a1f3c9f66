"""The torus on the port's ``sharded`` backend (CPU shards): ``conway:T``
through K3's torus route on a two-shard ring at every width from 1 to 70 —
the column seam is not word-aligned unless 32 divides the width — against
the numpy oracle and the JAX package's sharded XLA scan at every width,
and its Pallas torus kernel (interpret mode) at the widths around word
boundaries; and the ring on 1, 2, 4 and 8 shards.  Mirrors the sharded
cases of ``tests/test_torus.py``."""

import numpy as np
import pytest

from tpu_life.backends.sharded_backend import ShardedBackend as JaxShardedBackend
from tpu_life.models.patterns import GLIDER
from tpu_life.models.rules import get_rule as jget_rule
from tpu_life_torch.backends.sharded_backend import ShardedBackend
from tpu_life_torch.models.rules import get_rule
from tpu_life_torch.ops.reference import run_np

SPEC = "conway:T"
STEPS = 13  # one block of 8 and a remainder of 5


def _board(shape, seed):
    return np.random.default_rng(seed).integers(0, 2, size=shape, dtype=np.int8)


def _port(board, n, steps=STEPS, **kw):
    runner = ShardedBackend(device="cpu", num_devices=n, **kw).prepare(board, get_rule(SPEC))
    assert runner.route == "k3_torus"
    runner.advance(steps)
    return runner.fetch()


@pytest.mark.parametrize("width", range(1, 71))
def test_every_width_on_a_two_shard_ring(width):
    board = _board((16, width), seed=width)
    got = _port(board, 2)
    np.testing.assert_array_equal(got, run_np(board, get_rule(SPEC), STEPS))
    want = JaxShardedBackend(num_devices=2, local_kernel="xla").run(board, jget_rule(SPEC), STEPS)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("width", [1, 31, 32, 33, 63, 64, 65, 70])
@pytest.mark.requires_tpu_interpret
def test_word_boundary_widths_against_the_tpu_torus_kernel(width):
    board = _board((16, width), seed=100 + width)
    want = JaxShardedBackend(num_devices=2, local_kernel="pallas", pallas_interpret=True).run(
        board, jget_rule(SPEC), STEPS)
    np.testing.assert_array_equal(_port(board, 2), want)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_ring_of_n_shards(n):
    board = _board((32, 45), seed=n)
    np.testing.assert_array_equal(_port(board, n, steps=19, block_steps=3),
                                  run_np(board, get_rule(SPEC), 19))


def test_glider_wraps_across_both_seams():
    # 64 steps on a 16x16 torus on 4 shards bring a glider back where it
    # started, having crossed every row seam and the column seam
    board = np.zeros((16, 16), np.int8)
    board[1:4, 1:4] = GLIDER
    np.testing.assert_array_equal(_port(board, 4, steps=64), board)
