"""The port's plain bit-sliced ops (torch, CPU) against the JAX package's
``bitlife`` (JAX, CPU) and the numpy oracle — bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_life.models.rules import get_rule as jget_rule
from tpu_life.ops import bitlife as jbitlife
from tpu_life_torch import interop
from tpu_life_torch.models.rules import RULE_REGISTRY, get_rule
from tpu_life_torch.ops import bitlife
from tpu_life_torch.ops.reference import run_np, step_np

LIFELIKE = sorted(k for k, r in RULE_REGISTRY.items() if bitlife.supports(r))


def _board(shape, seed):
    return np.random.default_rng(seed).integers(0, 2, size=shape, dtype=np.int8)


def _words_np(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


def test_lifelike_rules_found():
    assert {"conway", "highlife", "daynight", "seeds", "reference_bug_compat"} <= set(LIFELIKE)


@pytest.mark.parametrize("name", LIFELIKE)
def test_multi_step_matches_jax_and_numpy(name):
    shape, steps = (40, 70), 5
    b = _board(shape, seed=len(name))
    x = interop.board_from_reference(b, shape)
    got = bitlife.multi_step_packed(x, rule=get_rule(name), steps=steps, logical_shape=shape)
    want = jbitlife.multi_step_packed(
        jnp.asarray(jbitlife.pack_np(b)), rule=jget_rule(name), steps=steps, logical_shape=shape
    )
    np.testing.assert_array_equal(_words_np(got), np.asarray(want))
    np.testing.assert_array_equal(
        interop.board_to_reference(got, shape), run_np(b, get_rule(name), steps)
    )


@pytest.mark.parametrize("width", range(1, 41))
def test_masked_step_width_sweep(width):
    # every width 1..40: partial last words, the exact word, one bit over
    shape = (6, width)
    b = _board(shape, seed=width)
    rule = get_rule("conway")
    got = interop.board_from_reference(b, shape)
    want = jnp.asarray(jbitlife.pack_np(b))
    step = bitlife.make_masked_packed_step(rule, shape)
    jstep = jbitlife.make_masked_packed_step(jget_rule("conway"), shape)
    for _ in range(3):
        got, want = step(got), jstep(want)
    np.testing.assert_array_equal(_words_np(got), np.asarray(want))
    np.testing.assert_array_equal(interop.board_to_reference(got, shape), run_np(b, rule, 3))


@pytest.mark.parametrize("name", ["conway", "daynight", "seeds"])
def test_unmasked_step_matches_numpy(name):
    # a word-aligned width needs no mask: the raw step is already exact
    b = _board((48, 96), seed=42)
    x = interop.board_from_reference(b, b.shape)
    got = bitlife.make_packed_step(get_rule(name))(x)
    np.testing.assert_array_equal(
        interop.board_to_reference(got, b.shape), step_np(b, get_rule(name))
    )


def test_padding_bits_stay_dead():
    b = _board((30, 45), seed=43)
    x = bitlife.multi_step_packed(
        interop.board_from_reference(b, b.shape), rule=get_rule("seeds"), steps=4,
        logical_shape=b.shape,
    )
    pad = bitlife.unpack_np(_words_np(x), 64)[:, 45:]
    assert not pad.any()


def test_word_mask_rows_and_partial_word():
    m = bitlife.word_mask((5, 3), (4, 40), "cpu").numpy().view(np.uint32)
    np.testing.assert_array_equal(m[:4], [[0xFFFFFFFF, 0xFF, 0]] * 4)
    assert not m[4].any()


def test_unsupported_rules_rejected():
    for spec in ("brians_brain", "bugs", "conway:T", "R1,C2,S1,B1,NN"):
        assert not bitlife.supports(get_rule(spec))
        with pytest.raises(ValueError, match="life-like"):
            bitlife.make_packed_step(get_rule(spec))


@pytest.mark.parametrize("shape", [(1, 1), (13, 37), (64, 64), (100, 257)])
def test_live_count_matches_jax(shape):
    b = _board(shape, seed=shape[1])
    got = int(bitlife.live_count_packed(interop.board_from_reference(b, shape)))
    want = jbitlife.combine_live_count(jbitlife.live_count_packed(jnp.asarray(jbitlife.pack_np(b))))
    assert got == want == int(b.sum())


def test_interop_round_trip_packed_and_int8():
    b = _board((9, 70), seed=1)
    from_int8 = interop.board_from_reference(b, b.shape)
    from_words = interop.board_from_reference(jbitlife.pack_np(b), b.shape)
    assert from_int8.dtype == torch.int32 and torch.equal(from_int8, from_words)
    np.testing.assert_array_equal(interop.board_to_reference(from_int8, b.shape), b)
    with pytest.raises(ValueError):
        interop.board_from_reference(b, (9, 71))
    with pytest.raises(TypeError):
        interop.board_from_reference(b.astype(np.int32), b.shape)
