"""The port's int8 stencil (``tpu_life_torch/ops/stencil.py``, torch on the
CPU) against ``tpu_life.ops.stencil`` (JAX on the CPU) and the numpy oracle,
bit for bit, on the same inputs made from a numpy seed."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_life.models.rules import get_rule as jget_rule
from tpu_life.ops import bitlife as jbitlife
from tpu_life.ops import stencil as jstencil
from tpu_life_torch.models.rules import get_rule
from tpu_life_torch.ops import stencil
from tpu_life_torch.ops.reference import run_np

RULES = ["conway", "brians_brain", "star_wars", "bugs", "bugs_decay", "R2,C2,M1,S5..10,B5..8"]


def _board(shape, rule, seed):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, rule.states, size=shape, dtype=np.int8)
        * rng.integers(0, 2, size=shape, dtype=np.int8)
    )


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("spec", RULES)
def test_neighbor_counts_match_jax(spec):
    rule = get_rule(spec)
    b = _board((23, 37), rule, seed=len(spec))
    args = (rule.radius, rule.include_center, rule.neighborhood, rule.boundary)
    got = stencil.neighbor_counts(_t(b), *args)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jstencil.neighbor_counts(jnp.asarray(b), *args))
    )


@pytest.mark.parametrize("radius", [1, 2, 3])
@pytest.mark.parametrize("row_wrap,col_wrap", [(False, False), (False, True), (True, False), (True, True)])
@pytest.mark.parametrize("neighborhood", ["moore", "von_neumann"])
@pytest.mark.parametrize("include_center", [False, True])
def test_counts_all_pad_modes(radius, row_wrap, col_wrap, neighborhood, include_center):
    alive = np.random.default_rng(radius).integers(0, 2, size=(9, 14)).astype(np.int32)
    args = (radius, include_center, neighborhood, row_wrap, col_wrap)
    got = stencil._counts(_t(alive), *args)
    want = jstencil._counts(jnp.asarray(alive), *args)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrap_pad_wider_than_the_board():
    # np.pad's wrap repeats the board when the pad is wider than it
    alive = np.array([[1, 0], [0, 1]], np.int32)
    got = stencil._counts(_t(alive), 3, False, "moore", True, True)
    want = jstencil._counts(jnp.asarray(alive), 3, False, "moore", True, True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("spec", RULES)
def test_apply_rule_matches_jax(spec):
    # every (state, count) pair the board can hold
    rule = get_rule(spec)
    rng = np.random.default_rng(5)
    b = rng.integers(0, rule.states, size=(30, 41), dtype=np.int8)
    counts = rng.integers(0, rule.max_count + 1, size=b.shape).astype(np.int32)
    got = stencil.apply_rule(_t(b), _t(counts), rule)
    want = jstencil.apply_rule(jnp.asarray(b), jnp.asarray(counts), jget_rule(spec))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), rule.transition_table[b.astype(np.int64), counts])


@pytest.mark.parametrize(
    "shape,logical,row_offset,col_offset",
    [((8, 16), (5, 11), 0, 0), ((8, 16), (20, 20), 15, 6), ((4, 4), (4, 4), -2, 3)],
)
def test_validity_mask_matches_jax(shape, logical, row_offset, col_offset):
    got = stencil.validity_mask(shape, logical, row_offset, col_offset)
    want = jstencil.validity_mask(shape, logical, row_offset, col_offset)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("spec", RULES)
@pytest.mark.parametrize("masked", [False, True])
def test_multi_step_matches_jax_and_numpy(spec, masked):
    rule = get_rule(spec)
    logical = (24, 29)
    b = _board(logical, rule, seed=7)
    shape = (32, 40) if masked else logical
    x = np.zeros(shape, np.int8)
    x[: logical[0], : logical[1]] = b
    got = stencil.multi_step(_t(x), rule=rule, steps=4, logical_shape=logical)
    want = jstencil.multi_step(
        jnp.asarray(x), rule=jget_rule(spec), steps=4, logical_shape=logical
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[: logical[0], : logical[1]], run_np(b, rule, 4))
    assert not got.numpy()[logical[0] :].any() and not got.numpy()[:, logical[1] :].any()


@pytest.mark.parametrize("spec", ["conway:T", "R2,C2,S2..4,B3,NN", "brians_brain:T"])
def test_torus_and_diamond_steps_match_jax(spec):
    rule = get_rule(spec)
    b = _board((15, 18), rule, seed=3)
    got = stencil.multi_step(_t(b), rule=rule, steps=5)
    want = jstencil.multi_step(jnp.asarray(b), rule=jget_rule(spec), steps=5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), run_np(b, rule, 5))


def test_make_step_runs_the_roll_stencil_only():
    # the matmul stencil, once refused here, is ported (ops.conv): it now
    # gives the roll step's board bit for bit, and only the two stencils
    # of the JAX package are taken
    rule = get_rule("bugs")
    b = _board((23, 25), rule, seed=4)
    np.testing.assert_array_equal(
        stencil.make_step(rule, stencil="matmul")(_t(b)).numpy(), stencil.make_step(rule)(_t(b)).numpy()
    )
    with pytest.raises(ValueError, match="stencil must be one of"):
        stencil.make_step(rule, stencil="fft")
    with pytest.raises(ValueError, match="torus"):
        stencil.make_masked_step(get_rule("conway:T"), (8, 8))


@pytest.mark.parametrize("shape", [(1, 1), (13, 37), (64, 130)])
def test_live_count_cells_matches_jax(shape):
    b = _board(shape, get_rule("star_wars"), seed=shape[1])
    got = stencil.live_count_cells(_t(b))
    assert got.dtype == torch.int64 and got.dim() == 0
    want = jbitlife.combine_live_count(jbitlife.live_count_cells(jnp.asarray(b)))
    assert int(got) == want == int((b == 1).sum())


def test_board_is_not_written():
    rule = get_rule("brians_brain")
    b = _board((10, 12), rule, seed=1)
    x = _t(b.copy())
    stencil.multi_step(x, rule=rule, steps=3)
    np.testing.assert_array_equal(x.numpy(), b)
