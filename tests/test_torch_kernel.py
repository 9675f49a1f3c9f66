"""Kernel K1 (``kernels/packed_stripe.py``): its plain version against the
JAX Pallas kernel it replaces, run in interpret mode on the CPU as
``tests/test_pallas.py`` runs it; the wrapper's checks; the rule table
the CUDA source evaluates.  The CUDA kernel itself is held to the plain
version on the card by ``chip_smoke.py`` (this suite's conftest needs jax,
which the card's machine does not have)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_life.backends.pallas_backend import make_pallas_packed_multi_step
from tpu_life.models.rules import get_rule as jget_rule
from tpu_life.ops import bitlife as jbitlife
from tpu_life_torch import interop
from tpu_life_torch.kernels import packed_stripe as ps
from tpu_life_torch.models.rules import get_rule
from tpu_life_torch.ops.boolmin import rule_sop
from tpu_life_torch.ops.reference import run_np


def _ceil_to(x, m):
    return -(-x // m) * m


def pallas_reference(board, name, steps, k, block_rows):
    """``steps`` steps of the JAX Pallas stripe kernel (interpret mode) on
    a board framed as ``PallasBackend._prepare_packed`` frames it: ``fr``
    zero rows above and below, words padded to 128 lanes, height padded
    to whole stripes.  Returns the unframed uint32 words."""
    h, w = board.shape
    fr = _ceil_to(k, 8)
    packed = jbitlife.pack_np(board)
    wp = _ceil_to(packed.shape[1], 128)
    hp = fr + _ceil_to(h, block_rows) + fr
    host = np.zeros((hp, wp), dtype=np.uint32)
    host[fr : fr + h, : packed.shape[1]] = packed
    x = jnp.asarray(host)
    rule = jget_rule(name)
    blocks, rem = divmod(steps, k)
    for depth in [k] * blocks + ([rem] if rem else []):
        x = make_pallas_packed_multi_step(
            rule, (hp, wp), (h, w), fr, block_rows=block_rows, block_steps=depth,
            interpret=True,
        )(x)
    return np.asarray(x)[fr : fr + h, : packed.shape[1]]


@pytest.mark.parametrize(
    "name,shape,steps,k,block_rows",
    [
        ("conway", (70, 150), 9, 4, 16),  # 5 stripes, partial last word, remainder
        ("conway", (64, 64), 7, 3, 16),  # exact word multiple, remainder 1
        ("highlife", (40, 257), 3, 1, 16),  # one bit into a new word, k = 1
        ("day_and_night", (33, 96), 6, 4, 32),  # dense rule, all 32 bits of the last word
        ("seeds", (17, 260), 5, 4, 8),  # 3 stripes, a partial one
    ],
)
def test_plain_matches_pallas_interpret(name, shape, steps, k, block_rows):
    b = np.random.default_rng(sum(shape)).integers(0, 2, size=shape, dtype=np.int8)
    want = pallas_reference(b, name, steps, k, block_rows)
    x = interop.board_from_reference(b, shape)
    got = ps.packed_multi_step(x, get_rule(name), shape, steps, block_steps=k)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        interop.board_to_reference(got, shape), run_np(b, get_rule(name), steps)
    )


@pytest.mark.parametrize("name", ["conway", "highlife", "daynight", "seeds", "replicator", "reference_bug_compat"])
def test_sop_table_is_the_rule(name):
    # the kernel's data-driven rule, evaluated here on every input
    # (b0..b3 total planes, x centre) as single bits, equals rule_sop
    rule = get_rule(name)
    table = ps.sop_table(rule)
    sop = rule_sop(rule.birth, rule.survive)
    assert table.n_terms == len(sop)
    for i in range(32):
        lits = [((i >> b) & 1) * 0xFFFFFFFF for b in range(5)]
        out = 0
        for t in range(table.n_terms):
            term = 0xFFFFFFFF
            for b in range(5):
                term &= (lits[b] ^ table.flip[t][b]) | table.loose[t][b]
            out |= term
        want = any((i & mask) == value for mask, value in sop)
        assert out == (0xFFFFFFFF if want else 0), i


def test_wrapper_rejects_bad_inputs():
    rule = get_rule("conway")
    x = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(TypeError):
        ps.packed_multi_step(x.to(torch.int64), rule, (4, 40), 1, block_steps=8)
    with pytest.raises(ValueError, match="shape"):
        ps.packed_multi_step(x, rule, (4, 70), 1, block_steps=8)
    with pytest.raises(ValueError, match="contiguous"):
        ps.packed_multi_step(
            torch.zeros((2, 4), dtype=torch.int32).t(), rule, (4, 40), 1, block_steps=8
        )
    with pytest.raises(ValueError, match="block_steps"):
        ps.packed_multi_step(x, rule, (4, 40), 1, block_steps=33)
    with pytest.raises(ValueError, match="block_steps"):
        ps.packed_multi_step(x, rule, (4, 40), 1, block_steps=0)
    with pytest.raises(ValueError, match="steps"):
        ps.packed_multi_step(x, rule, (4, 40), -1, block_steps=8)
    with pytest.raises(ValueError, match="life-like"):
        ps.packed_multi_step(x, get_rule("brians_brain"), (4, 40), 1, block_steps=8)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ps.packed_multi_step(x.to("meta"), rule, (4, 40), 1, block_steps=8)


def test_cpu_tensor_takes_the_plain_version_without_launching():
    b = np.random.default_rng(0).integers(0, 2, size=(20, 50), dtype=np.int8)
    x = interop.board_from_reference(b, b.shape)
    before = ps.packed_multi_step.launches
    got = ps.packed_multi_step(x, get_rule("conway"), b.shape, 10, block_steps=4)
    assert ps.packed_multi_step.launches == before
    assert torch.equal(got, ps.packed_multi_step_plain(x, get_rule("conway"), b.shape, 10))


def test_tile_rows_cover_the_halo():
    # a full-size board keeps tiles of at least four halos; a small one
    # halves its tiles (down to 8 rows) until the grid fills 132 SMs
    for k in range(1, ps.MAX_BLOCK_STEPS + 1):
        assert ps.tile_rows(k, 16384, 512, 132) >= 4 * k
        for h, nwords in [(1, 1), (1500, 16), (257, 32), (5000, 63)]:
            rows = ps.tile_rows(k, h, nwords, 132)
            blocks = -(-nwords // ps.TILE_WORDS) * -(-h // rows)
            assert rows >= 8 and (rows == 8 or blocks >= 132)
            if rows < 4 * max(16, k):
                assert -(-nwords // ps.TILE_WORDS) * -(-h // (2 * rows)) < 132
    assert ps.tile_rows(8, 1500, 16, 132) == 8


@pytest.mark.parametrize(
    "name,ops", [("conway", 15), ("highlife", 17), ("day_and_night", 19), ("seeds", 14)]
)
def test_logic_ops_per_word_step(name, ops):
    # conway: carry-save adds 2 + 4, shifts 4, planes b1 and b2, and its
    # 7-literal SOP (b0 b1 ~b2 | x ~b0 ~b1 b2) in 3 three-input instructions
    assert ps.logic_ops_per_word_step(get_rule(name)) == ops
