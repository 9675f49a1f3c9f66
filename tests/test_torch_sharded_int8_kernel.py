"""Kernel K4's plain version — one block of k masked int8 steps on one
shard, ``kernels.sharded_int8.sharded_int8_block`` on CPU tensors — against
the TPU kernel it replaces, ``make_pallas_sharded_int8_block``, run in
interpret mode as ``tests/test_sharded_pallas.py`` runs it, on the same
shard of the same board: a corner, an edge and an interior shard of a 3x3
split and one past the board's last row and column (padding); shards of a
1-D row mesh (no column halos); Generations, Larger-than-Life with and
without the centre, and unpacked Conway; depths 1, 2 and 3.

The JAX kernel takes one extended chunk with ``ceil8(r*k)`` halo rows and
``ceil128(r*k)`` halo columns; the port takes the chunk and four halo
buffers of ``r*k`` rows and columns.  Both get the board's true cells
(zeros past it), and the results are compared over the chunk.  Equality
is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_life.backends.pallas_backend import (
    make_pallas_sharded_int8_block,
    sharded_pallas_int8_frame,
)
from tpu_life.models.rules import get_rule as jget_rule
from tpu_life_torch.kernels import sharded_int8
from tpu_life_torch.models.rules import get_rule
from tpu_life_torch.parallel import halo

RULES = ["bugs", "brians_brain", "star_wars", "R2,C2,M1,S5..10,B5..8", "conway"]
SHAPE = (40, 70)  # a 3x3 split into 16 x 28 shards leaves padding rows and columns
BLOCK = (16, 28)
SHARDS = {"corner": (0, 0), "edge": (0, 1), "interior": (1, 1), "padding": (2, 2)}


def _board(rule, seed):
    rng = np.random.default_rng(seed)
    b = rng.integers(0, rule.states, size=SHAPE, dtype=np.int8)
    return b * rng.integers(0, 2, size=SHAPE, dtype=np.int8) if rule.states > 2 else b


def _cells(board, r0, r1, c0, c1):
    """Board cells [r0, r1) x [c0, c1), zero past the board."""
    out = np.zeros((r1 - r0, c1 - c0), np.int8)
    h, w = board.shape
    a, b, c, d = max(r0, 0), min(r1, h), max(c0, 0), min(c1, w)
    if a < b and c < d:
        out[a - r0: b - r0, c - c0: d - c0] = board[a:b, c:d]
    return out


def _compare(spec, i, j, k, seed, block=BLOCK, cols=True):
    """Shard (i, j) of a random board through both kernels; ``cols`` False
    is a shard of a 1-D row mesh: the board's full width, no column halos."""
    rule, jrule = get_rule(spec), jget_rule(spec)
    board = _board(rule, seed)
    hl, wl = block if cols else (block[0], SHAPE[1])
    r0, c0 = i * hl, j * wl if cols else 0
    fr = halo.halo_depth(rule, k)
    fc = fr if cols else 0
    t = lambda *a: torch.from_numpy(_cells(board, *a))  # noqa: E731
    kw = {}
    if cols:
        kw = dict(left=t(r0 - fr, r0 + hl + fr, c0 - fc, c0),
                  right=t(r0 - fr, r0 + hl + fr, c0 + wl, c0 + wl + fc), col0=c0 - fc)
    before = sharded_int8.sharded_int8_block.launches
    got = sharded_int8.sharded_int8_block(
        t(r0 - fr, r0, c0, c0 + wl), t(r0, r0 + hl, c0, c0 + wl), t(r0 + hl, r0 + hl + fr, c0, c0 + wl),
        r0 - fr, rule, SHAPE, k, **kw,
    )
    assert sharded_int8.sharded_int8_block.launches == before  # the CPU runs the plain version

    fj, fcj = sharded_pallas_int8_frame(jrule, k)
    ext = _cells(board, r0 - fj, r0 + hl + fj, c0 - fcj, c0 + wl + fcj)
    if not cols:
        # a 1-D mesh: the column frame is dead padding, as the epoch loop
        # concatenates it
        ext[:, :fcj] = ext[:, fcj + wl:] = 0
    block_fn = make_pallas_sharded_int8_block(
        jrule, ext.shape, SHAPE, (fj, fcj), block_rows=hl, block_cols=wl,
        block_steps=k, interpret=True,
    )
    want = block_fn(jnp.asarray(ext), r0 - fj, c0 - fcj)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    return got


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("spec", RULES)
@pytest.mark.parametrize("where", list(SHARDS))
def test_2d_shard_matches_the_tpu_kernel(where, spec, k):
    i, j = SHARDS[where]
    got = _compare(spec, i, j, k, seed=10 * i + j + k)
    if where == "padding":
        assert not got[SHAPE[0] - 2 * BLOCK[0]:].any()  # padding rows stay dead
        assert not got[:, SHAPE[1] - 2 * BLOCK[1]:].any()  # and padding columns


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("spec", ["bugs", "brians_brain"])
@pytest.mark.parametrize("i", [0, 1, 2])
def test_row_shard_matches_the_tpu_kernel(i, spec, k):
    _compare(spec, i, 0, k, seed=i + k, cols=False)


def test_live_cells_on_every_edge_stay_inside_the_board():
    # a full edge gives births just past it under a wide birth range; the
    # mask after every substep keeps them dead, in both kernels
    _compare("R2,C2,M1,S5..10,B5..8", 2, 2, 3, seed=5)


def _inputs(fr=2, hl=6, wl=9, fc=0):
    z = lambda *s: torch.zeros(s, dtype=torch.int8)  # noqa: E731
    halos = dict(left=z(hl + 2 * fr, fc), right=z(hl + 2 * fr, fc)) if fc else {}
    return z(fr, wl), z(hl, wl), z(fr, wl), halos


@pytest.mark.parametrize(
    "change,match",
    [
        (lambda t, c, b, h: (t, c.to(torch.int32), b, h), "int8"),
        (lambda t, c, b, h: (t[:1], c, b, h), "top has shape"),
        (lambda t, c, b, h: (t, c, b[:, :2], h), "bot has shape"),
        (lambda t, c, b, h: (t, c.t().contiguous().t(), b, h), "contiguous"),
        (lambda t, c, b, h: (t, c, b, dict(left=h["left"])), "both column halos"),
        (lambda t, c, b, h: (t, c, b, dict(h, right=h["right"][:, :1])), "right has shape"),
        (lambda t, c, b, h: (t, c, b, dict(h, left=h["left"][1:])), "left has shape"),
        (lambda t, c, b, h: (t.to("meta"), c.to("meta"), b.to("meta"),
                             {n: x.to("meta") for n, x in h.items()}), "cuda or cpu"),
    ],
)
def test_wrapper_refuses_what_the_kernel_does_not_take(change, match):
    top, chunk, bot, halos = change(*_inputs(fc=2))
    with pytest.raises((TypeError, ValueError), match=match):
        sharded_int8.sharded_int8_block(top, chunk, bot, -2, get_rule("brians_brain"), (10, 70), 2,
                                        **halos)


@pytest.mark.parametrize(
    "spec,k,match",
    [("brians_brain", 33, r"block_steps must be in \[1, 32\]"),
     ("brians_brain", 0, r"block_steps must be in \[1, 32\]"),
     ("R2,C2,S2..4,B2..3,NN", 1, "clamped Moore rules only"),
     ("brians_brain:T", 1, "clamped Moore rules only")],
)
def test_wrapper_refuses_rules_and_depths_it_does_not_run(spec, k, match):
    top, chunk, bot, _ = _inputs(fr=max(k, 1))
    with pytest.raises(ValueError, match=match):
        sharded_int8.sharded_int8_block(top, chunk, bot, 0, get_rule(spec), (10, 70), k)


def test_plain_version_is_the_shard_ops_block():
    # the wrapper's plain version and the sharded backend's shard_ops block
    # are one function: halo.make_shard_block(packed=False) with columns
    rule = get_rule("star_wars")
    rng = np.random.default_rng(3)
    top, chunk, bot = (torch.from_numpy(rng.integers(0, 4, size=s, dtype=np.int8))
                       for s in ((2, 9), (6, 9), (2, 9)))
    left, right = (torch.from_numpy(rng.integers(0, 4, size=(10, 2), dtype=np.int8)) for _ in range(2))
    got = sharded_int8.sharded_int8_block(top, chunk, bot, 4, rule, (30, 40), 2,
                                          left=left, right=right, col0=7)
    want = halo.make_shard_block(rule, (30, 40), 2, packed=False, split_cols=True)(
        top, chunk, bot, 4, left, right, 7)
    assert torch.equal(got, want) and got.is_contiguous()


@pytest.mark.parametrize(
    "cols,fc,mid,side,want",
    [(8192, 8, [0, 4096, 8192], [0, 4096, 8192], (16, 8)),  # brians_brain on 2x2
     (4096, 5, [0, 4096, 8192], [0, 4096, 8192], (16, 1)),  # bugs on 2x2
     (8192, 0, [0, 4096, 8192], [], (16, 16)),  # bugs on a row mesh
     (250, 8, [0, 512], [0, 512], (1, 1)),  # the reference board on 2x2: 250 % 4
     (1000, 16, [0, 512], [0, 512, 520], (8, 8)),
     (1024, 16, [0, 516], [0, 512], (4, 16))],
)
def test_copy_sizes_follow_the_rows_and_the_halos(cols, fc, mid, side, want):
    # the chunk's rows take 16-byte copies where its width and the buffers
    # allow, whatever the column halos' width; r*k-wide halos take what r*k
    # allows
    assert sharded_int8.copy_sizes(cols, fc, mid, side) == want


@pytest.mark.parametrize("k", [1, 2, 3, 8])
@pytest.mark.parametrize("spec", RULES)
def test_the_window_covers_the_halos_on_16_byte_boundaries(spec, k):
    # K4 runs K2's layout: a margin of r*k rounded up to 16 columns on each
    # side of a tile whose columns are a multiple of 16, so the chunk's
    # column 0 falls on a 16-byte boundary of the window, and the rows
    # above and below are the r*k halo rows themselves
    from tpu_life_torch.kernels import int8_tiled

    rule = get_rule(spec)
    fr = halo.halo_depth(rule, k)
    rows, cols = int8_tiled.tile_shape(rule, k, 4096, 4096, 132)
    margin, ext_c, pitch, vpitch = int8_tiled.window(rule, k, cols)
    assert fr == rule.radius * k <= margin and margin % 16 == 0 and margin - fr < 16
    assert cols % 16 == 0 and ext_c == cols + 2 * margin
    assert pitch % 16 == 0 and (pitch // 16) % 2 == 1 and pitch >= ext_c
    assert vpitch % 16 == 0 and (vpitch // 16) % 2 == 1 and vpitch >= ext_c + int8_tiled.GUARD
    args = int8_tiled.launch_args(rule, k, 4096, 4096, 132)
    assert args == (int8_tiled.n_words(rule), rule.radius, k, int(rule.include_center),
                    rule.states, rule.max_count, rows, cols, margin, ext_c, pitch, vpitch,
                    int8_tiled.shared_bytes(rule, k, rows, cols))
