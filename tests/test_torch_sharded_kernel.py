"""Kernel K3's plain version — one block of k packed steps on one shard,
``kernels.sharded_stripe.sharded_stripe_block`` on CPU tensors — against
the TPU kernel it replaces, ``make_pallas_sharded_stripe_block``, run in
interpret mode as the JAX package's own tests run it, on the same shard of
the same board: Moore clamped, the von Neumann diamond (r = 1, 2, with and
without the centre) and the Moore torus; a shard above the board's first
row (row0 negative), inside it and past its last row; depths 1, 2 and 8.

The JAX kernel takes halos of ``ceil8(r*k)`` rows and a lane-padded word
width; both kernels get the board's true rows for those halos, and the
results are compared over the logical words.  Equality is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_life.backends.pallas_backend import (
    make_pallas_sharded_stripe_block,
    sharded_pallas_halo_rows,
)
from tpu_life.models.rules import get_rule as jget_rule
from tpu_life.ops import bitlife as jbitlife
from tpu_life_torch.kernels import packed_stripe, sharded_stripe
from tpu_life_torch.models.rules import get_rule
from tpu_life_torch.parallel import halo

LANE = 128  # the JAX kernel's word axis is padded to whole 128-word lanes

MOORE = "conway"
DIAMONDS = ["R1,C2,S2..3,B3,NN", "R1,C2,M1,S2..4,B3..4,NN", "R2,C2,S2..4,B2..3,NN",
            "R2,C2,M1,S3..6,B3..5,NN"]
TORUS = "conway:T"


def _rows(words: np.ndarray, a: int, b: int, torus: bool) -> np.ndarray:
    """Rows [a, b) of a packed board: wrapped on a torus, dead outside it
    on a clamped board."""
    lh = words.shape[0]
    idx = np.arange(a, b)
    if torus:
        return words[idx % lh]
    out = np.zeros((b - a, words.shape[1]), np.uint32)
    ok = (idx >= 0) & (idx < lh)
    out[ok] = words[idx[ok]]
    return out


def _compare(spec, shape, hl, i, k, seed, block_rows=None):
    """Shard i (rows [i*hl, (i+1)*hl)) of a random board through both."""
    rule, jrule = get_rule(spec), jget_rule(spec)
    torus = rule.boundary == "torus"
    board = np.random.default_rng(seed).integers(0, 2, size=shape, dtype=np.int8)
    words = jbitlife.pack_np(board)
    nw = words.shape[1]
    lo, hi = i * hl, (i + 1) * hl

    fr = halo.halo_depth(rule, k)
    got = sharded_stripe.sharded_stripe_block(
        *(torch.from_numpy(_rows(words, a, b, torus).view(np.int32))
          for a, b in ((lo - fr, lo), (lo, hi), (hi, hi + fr))),
        lo - fr, rule, shape, k,
    )

    fj = sharded_pallas_halo_rows(jrule, k)
    wp = -(-nw // LANE) * LANE

    def padded(a, b):
        return jnp.asarray(np.pad(_rows(words, a, b, torus), ((0, 0), (0, wp - nw))))

    block = make_pallas_sharded_stripe_block(
        jrule, (hl + 2 * fj, wp), shape, fj, block_rows=block_rows or hl,
        block_steps=k, interpret=True, torus=torus,
    )
    want = block(padded(lo - fj, lo), padded(lo, hi), padded(hi, hi + fj), jnp.int32(lo - fj))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want)[:, :nw])
    return got


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("i", [0, 1, 3], ids=["row0-negative", "interior", "row0-past-lh"])
def test_moore_clamped_matches_the_tpu_kernel(i, k):
    # 40 rows in shards of 16: shard 3 (rows 48..63) lies wholly past the
    # board, its row0 past lh; shard 2 would hold the last 8 rows and padding
    got = _compare(MOORE, (40, 70), 16, i, k, seed=10 * i + k)
    if i == 3:
        assert not got.any()  # padding rows stay dead


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("spec", DIAMONDS)
def test_diamond_matches_the_tpu_kernel(spec, k):
    k = packed_stripe.clamp_block_steps(get_rule(spec), k)
    _compare(spec, (40, 70), 16, 1, k, seed=k)


@pytest.mark.parametrize("i", [0, 2])
@pytest.mark.parametrize("spec", [DIAMONDS[0], DIAMONDS[3]])
def test_diamond_at_the_board_edges(spec, i):
    # shard 0 sits on the top edge, shard 2 holds the last rows and padding
    _compare(spec, (40, 33), 16, i, 2, seed=i)


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("i", [0, 2])
def test_torus_matches_the_tpu_kernel(i, k):
    # the seam in rows (halos wrap around the ring) and in columns (70 is
    # no multiple of 32)
    _compare(TORUS, (48, 70), 16, i, k, seed=i + k)


@pytest.mark.parametrize("width", [1, 5, 31, 32, 33, 64, 65])
def test_torus_seam_widths_match_the_tpu_kernel(width):
    _compare(TORUS, (32, width), 16, 1, 2, seed=width)


def test_several_tiles_of_the_tpu_kernel():
    # the JAX kernel stitching its windows over three row tiles
    _compare(MOORE, (80, 45), 24, 1, 2, seed=3, block_rows=8)


def test_modes():
    assert sharded_stripe.mode_of(get_rule("conway")) == sharded_stripe.MOORE
    assert sharded_stripe.mode_of(get_rule("highlife:T")) == sharded_stripe.TORUS
    assert sharded_stripe.mode_of(get_rule(DIAMONDS[2])) == sharded_stripe.DIAMOND
    for spec in ("brians_brain", "bugs", "R3,C2,S6..10,B6..8,NN", "brians_brain:T"):
        with pytest.raises(ValueError, match="sharded stripe kernel runs"):
            sharded_stripe.mode_of(get_rule(spec))


def _inputs(fr=2, hl=5, nw=3):
    return (torch.zeros((fr, nw), dtype=torch.int32), torch.zeros((hl, nw), dtype=torch.int32),
            torch.zeros((fr, nw), dtype=torch.int32))


@pytest.mark.parametrize(
    "change,match",
    [
        (lambda t, c, b: (t, c.to(torch.int8), b), "int32"),
        (lambda t, c, b: (t[:1], c, b), "top has shape"),
        (lambda t, c, b: (t, c, b[:, :2]), "bot has shape"),
        (lambda t, c, b: (t, c.t().contiguous().t(), b), "contiguous"),
        (lambda t, c, b: (t, c[:, :2].contiguous(), b), "words a row"),
        (lambda t, c, b: (t.to("meta"), c.to("meta"), b.to("meta")), "cuda or cpu"),
    ],
)
def test_wrapper_refuses_what_the_kernel_does_not_take(change, match):
    top, chunk, bot = change(*_inputs())
    with pytest.raises((TypeError, ValueError), match=match):
        sharded_stripe.sharded_stripe_block(top, chunk, bot, -2, get_rule(MOORE), (10, 70), 2)


def test_wrapper_refuses_a_depth_past_the_clamp():
    top, chunk, bot = _inputs(fr=34)
    with pytest.raises(ValueError, match=r"block_steps must be in \[1, 16\]"):
        sharded_stripe.sharded_stripe_block(top, chunk, bot, 0, get_rule(DIAMONDS[2]), (10, 70), 17)


def test_plain_version_runs_on_cpu_tensors_and_counts_no_launch():
    before = sharded_stripe.sharded_stripe_block.launches
    top, chunk, bot = _inputs()
    out = sharded_stripe.sharded_stripe_block(top, chunk, bot, -2, get_rule(MOORE), (10, 70), 2)
    assert out.shape == chunk.shape and out.dtype == torch.int32
    assert sharded_stripe.sharded_stripe_block.launches == before
