"""The batch modes of kernels K6 and K7 and the batched stochastic step of
the port, held to the JAX package on the CPU.

A wrapper on CPU tensors runs its kernel's plain version, so these hold
the plain versions of K6's batch mode (``packed_metropolis_half_batch``)
and K7's batch mode (``cell_uniforms_batch``), and ``mc.make_batch_step_fn``
(the port's form of the JAX serving engines' vmapped step under its freeze
mask), against the JAX package's vmapped ``mc.packed.make_sweep`` and
``mc.make_step_fn`` and its ``prng.cell_uniforms``: per-slot keys,
counters (past 2^31 too) and tables (T = 0 among them), budgets below, at
and past the sweep's offset (frozen slots among live ones), and origins
across and past 2^32.  Inputs come from ``np.random.default_rng`` and
seeds; every comparison is exact (integers, tolerance none).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_life import mc as jmc
from tpu_life.mc import packed as jpacked
from tpu_life.mc import prng as jprng
from tpu_life.models.rules import get_rule as jget_rule
from tpu_life_torch import mc
from tpu_life_torch.kernels import mc_threefry
from tpu_life_torch.mc import ising, packed, prng
from tpu_life_torch.models.rules import get_rule

TEMPS = [0.0, 2.27, 10.0, 1.5, 3.0, 2.0, 0.5, 4.0]
# W % 32 of 2, 30 and 0; one word a row; a warp spanning rows
SHAPES = [(2, 2), (4, 30), (6, 32), (10, 66), (12, 98)]


def slots(n: int, seed: int = 0, *, offset: int = 3, temps=TEMPS):
    """``n`` slots' numpy state: distinct seeds, temperatures (T = 0 among
    them), start counters past 2^31 on odd slots, and budgets below, at and
    past ``offset``."""
    rng = np.random.default_rng(seed)
    seeds = [int(s) for s in rng.integers(-2**40, 2**40, n)]
    counters = [2**31 + int(rng.integers(0, 2**30)) if i % 2 else int(rng.integers(0, 1000))
                for i in range(n)]
    budgets = [(0, offset, offset + 1, 1, 100, offset - 1)[i % 6] for i in range(n)]
    return dict(seeds=seeds, counters=counters, budgets=budgets, temps=list(temps[:n]))


def state_of(s: dict, rule=None) -> prng.SlotState:
    keys = [prng.key_halves(v) for v in s["seeds"]]

    def i32(values):
        return torch.tensor([prng.as_i32(v) for v in values], dtype=torch.int32)

    if rule is None or isinstance(rule, mc.IsingRule):
        thr = np.stack([ising.acceptance_thresholds(t) for t in s["temps"]])
    else:
        thr = np.zeros((len(s["seeds"]), 5), np.uint32)
    return prng.SlotState(i32([k[0] for k in keys]), i32([k[1] for k in keys]),
                          i32(s["counters"]), torch.from_numpy(thr.view(np.int32).copy()),
                          torch.tensor(s["budgets"], dtype=torch.int32))


def jax_keys(s: dict):
    keys = [prng.key_halves(v) for v in s["seeds"]]
    return (jnp.asarray([k[0] for k in keys], jnp.uint32), jnp.asarray([k[1] for k in keys], jnp.uint32))


def packed_batch(boards: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.stack([packed.pack_board(b).view(np.int32) for b in boards]))


# -- K7's batch mode -------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("substream", [prng.SUB_EVEN, prng.SUB_ODD, prng.SUB_NOISE])
@pytest.mark.parametrize("offset", [0, 3])
def test_k7_batch_plain_equals_jax_cell_uniforms(n, substream, offset):
    s = slots(n, seed=n + 10 * substream, offset=offset)
    state = state_of(s)
    got = mc_threefry.cell_uniforms_batch((9, 14), state, substream, offset=offset)
    assert got.shape == (n, 9, 14) and got.dtype == torch.int32
    for i in range(n):
        k0, k1 = prng.key_halves(s["seeds"][i])
        if s["budgets"][i] > offset:
            step = (s["counters"][i] + offset) & 0xFFFFFFFF
            want = jprng.cell_uniforms(np, (9, 14), k0, k1, np.uint32(step), substream)
            np.testing.assert_array_equal(got[i].numpy().view(np.uint32), want)
        else:  # a frozen slot's draws are zeros
            assert not got[i].any()


def test_k7_batch_counter_word_wraps_as_counter_word():
    # counters near 2^32 and offsets past the wrap: the word of
    # (counter + offset) mod 2^32, as prng.counter_word takes a step
    s = dict(seeds=[3, 4], counters=[2**32 - 2, 2**31 - 1], budgets=[10, 10], temps=[2.0, 2.0])
    state = state_of(s)
    for offset in (0, 1, 2, 5):
        got = mc_threefry.cell_uniforms_batch((4, 6), state, prng.SUB_NOISE, offset=offset)
        for i, c in enumerate(s["counters"]):
            want = prng.cell_uniforms_torch((4, 6), *prng.key_halves(s["seeds"][i]), c + offset,
                                            prng.SUB_NOISE)
            assert torch.equal(got[i], want)


# -- K6's batch mode ---------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n", [1, 3, 8])
def test_k6_batch_plain_equals_jax_vmapped_sweep(shape, n):
    # both halves at one offset == the JAX engine's vmapped make_sweep on
    # the live slots; a frozen slot's words pass through unchanged
    offset = 2
    s = slots(n, seed=shape[1] * n, offset=offset)
    rng = np.random.default_rng(n)
    boards = rng.integers(0, 2, (n, *shape), dtype=np.int8)
    state = state_of(s)
    x = packed_batch(boards)
    for parity in (0, 1):
        x = mc_threefry.packed_metropolis_half_batch(x, parity, state, width=shape[1],
                                                     offset=offset)
    vsweep = jax.vmap(jpacked.make_sweep(jnp, jget_rule("ising"), shape))
    k0, k1 = jax_keys(s)
    counters = jnp.asarray([(c + offset) & 0xFFFFFFFF for c in s["counters"]], jnp.uint32)
    thr = jnp.asarray(np.stack([ising.acceptance_thresholds(t) for t in s["temps"]]))
    stepped = np.asarray(vsweep(jnp.asarray(np.stack([packed.pack_board(b) for b in boards])),
                                k0, k1, counters, thr))
    for i in range(n):
        want = stepped[i] if s["budgets"][i] > offset else packed.pack_board(boards[i])
        np.testing.assert_array_equal(x[i].numpy().view(np.uint32), want)


@pytest.mark.parametrize("origin", [2**32 - 50, 2**32, 2**33 + 5])
@pytest.mark.parametrize("shape", [(4, 30), (10, 66)])
def test_k6_batch_plain_at_origins_past_2_32_equals_jax(origin, shape):
    # the wide schedule: each live slot's sweep == JAX make_sweep(np, origin=)
    n, offset = 4, 1
    s = slots(n, seed=7, offset=offset)
    boards = np.random.default_rng(origin % 97).integers(0, 2, (n, *shape), dtype=np.int8)
    state = state_of(s)
    x = packed_batch(boards)
    for parity in (0, 1):
        x = mc_threefry.packed_metropolis_half_batch(x, parity, state, width=shape[1],
                                                     offset=offset, origin=origin)
    sweep = jpacked.make_sweep(np, jget_rule("ising"), shape, origin=origin)
    for i in range(n):
        k0, k1 = prng.key_halves(s["seeds"][i])
        want = packed.pack_board(boards[i])
        if s["budgets"][i] > offset:
            want = sweep(want, np.uint32(k0), np.uint32(k1),
                         np.uint32((s["counters"][i] + offset) & 0xFFFFFFFF),
                         ising.acceptance_thresholds(s["temps"][i]))
        np.testing.assert_array_equal(x[i].numpy().view(np.uint32), want)


@pytest.mark.parametrize("parity", [0, 1])
def test_k6_batch_slot_equals_the_single_board_half_sweep(parity):
    # slot by slot, K6's batch mode is K6 at the slot's key, step and table
    shape, offset = (8, 34), 4
    s = slots(6, seed=parity, offset=offset)
    boards = np.random.default_rng(3).integers(0, 2, (6, *shape), dtype=np.int8)
    x = packed_batch(boards)
    got = mc_threefry.packed_metropolis_half_batch(x, parity, state_of(s), width=shape[1],
                                                   offset=offset)
    for i in range(6):
        thr = ising.acceptance_thresholds(s["temps"][i])
        want = x[i]
        if s["budgets"][i] > offset:
            want = mc_threefry.packed_metropolis_half(
                x[i].contiguous(), parity, *prng.key_halves(s["seeds"][i]),
                s["counters"][i] + offset, int(thr[3]), int(thr[4]), width=shape[1])
        assert torch.equal(got[i], want)


# -- the batched step functions -----------------------------------------------------


@pytest.mark.parametrize("spec", ["ising", "noisy:0.05/conway", "noisy:0.3/highlife",
                                  "noisy:0.2/day_and_night", "noisy:0/conway", "noisy:1/conway"])
@pytest.mark.parametrize("n", [1, 3, 8])
def test_batch_step_equals_jax_vmapped_step_under_the_freeze_mask(spec, n):
    rule, jrule = get_rule(spec), jget_rule(spec)
    shape, offset = (10, 12), 3
    s = slots(n, seed=len(spec) + n, offset=offset)
    boards = np.random.default_rng(n).integers(0, 2, (n, *shape), dtype=np.int8)
    state = state_of(s, rule)
    step = mc.make_batch_step_fn(rule, uniforms=mc_threefry.cell_uniforms_batch)
    got = step(torch.from_numpy(boards), state, offset)
    vstep = jax.vmap(jmc.make_step_fn(jnp, jrule))
    k0, k1 = jax_keys(s)
    counters = jnp.asarray([(c + offset) & 0xFFFFFFFF for c in s["counters"]], jnp.uint32)
    thr = jnp.asarray(state.thr.numpy().view(np.uint32))
    stepped = np.asarray(vstep(jnp.asarray(boards), k0, k1, counters, thr))
    for i in range(n):
        want = stepped[i] if s["budgets"][i] > offset else boards[i]
        np.testing.assert_array_equal(got[i].numpy(), want)


@pytest.mark.parametrize("spec", ["ising", "noisy:0.1/conway"])
def test_a_chunk_of_batch_steps_equals_run_np_per_slot(spec):
    # a chunk of 6 sweeps: each slot advances min(6, budget) steps from its
    # own counter, the counter advancing only while the slot is live
    rule, jrule = get_rule(spec), jget_rule(spec)
    shape, chunk = (8, 10), 6
    s = slots(5, seed=11, offset=chunk)
    boards = np.random.default_rng(2).integers(0, 2, (5, *shape), dtype=np.int8)
    state = state_of(s, rule)
    step = mc.make_batch_step_fn(rule)
    x = torch.from_numpy(boards)
    for t in range(chunk):
        x = step(x, state, t)
    for i in range(5):
        temp = s["temps"][i] if isinstance(rule, mc.IsingRule) else None
        want = jmc.run_np(jrule, boards[i], s["seeds"][i], min(chunk, s["budgets"][i]),
                          temperature=temp, start_step=s["counters"][i])
        np.testing.assert_array_equal(x[i].numpy(), want)


def test_packed_and_roll_batches_agree():
    # the packed batch (K6's batch mode) == the roll batch (K7's) bit for bit
    shape, n = (12, 40), 4
    s = slots(n, seed=5, offset=0)
    s["budgets"] = [3, 0, 2, 9]
    boards = np.random.default_rng(9).integers(0, 2, (n, *shape), dtype=np.int8)
    state = state_of(s)
    step = mc.make_batch_step_fn(get_rule("ising"))
    roll, words = torch.from_numpy(boards), packed_batch(boards)
    for t in range(3):
        roll = step(roll, state, t)
        for parity in (0, 1):
            words = mc_threefry.packed_metropolis_half_batch(words, parity, state,
                                                             width=shape[1], offset=t)
    for i in range(n):
        np.testing.assert_array_equal(
            packed.unpack_board(words[i].numpy().view(np.uint32), shape[1]), roll[i].numpy())


# -- the wrappers' contract -----------------------------------------------------------


def test_cpu_tensors_run_the_plain_versions_and_count_no_launch():
    before = (mc_threefry.packed_metropolis_half_batch.launches,
              mc_threefry.cell_uniforms_batch.launches)
    state = state_of(slots(2))
    x = packed_batch(np.zeros((2, 4, 6), np.int8))
    mc_threefry.packed_metropolis_half_batch(x, 0, state, width=6)
    mc_threefry.cell_uniforms_batch((4, 6), state, 0)
    assert (mc_threefry.packed_metropolis_half_batch.launches,
            mc_threefry.cell_uniforms_batch.launches) == before


def test_other_devices_raise():
    state = prng.SlotState(*(t.to("meta") for t in state_of(slots(2))))
    x = torch.zeros((2, 4, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        mc_threefry.packed_metropolis_half_batch(x, 0, state, width=6)
    with pytest.raises(ValueError, match="cuda or cpu"):
        mc_threefry.cell_uniforms_batch((4, 6), state, 0)


@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "thr"])
def test_the_state_is_checked(bad):
    state = state_of(slots(3))
    x = packed_batch(np.zeros((3, 4, 6), np.int8))
    if bad == "dtype":
        state = state._replace(k0=state.k0.to(torch.int64))
    elif bad == "shape":
        state = state._replace(rem=state.rem[:2])
    elif bad == "device":
        state = state._replace(counter=state.counter.to("meta"))
    else:
        state = state._replace(thr=state.thr[:, :4].contiguous())
    with pytest.raises(ValueError):
        mc_threefry.packed_metropolis_half_batch(x, 0, state, width=6)
    with pytest.raises(ValueError):
        mc_threefry.cell_uniforms_batch((4, 6), state, 0)


@pytest.mark.parametrize("kwargs,match", [({"parity": 2}, "parity"), ({"offset": -1}, ">= 0"),
                                          ({"width": 7}, "even"), ({"origin": -1}, ">= 0")])
def test_k6_batch_arguments_are_checked(kwargs, match):
    args = dict(parity=0, width=6, offset=0, origin=0) | kwargs
    x = packed_batch(np.zeros((2, 4, 6), np.int8))
    with pytest.raises(ValueError, match=match):
        mc_threefry.packed_metropolis_half_batch(x, args.pop("parity"), state_of(slots(2)), **args)


@pytest.mark.parametrize("kwargs,match", [({"substream": 4}, "substream"),
                                          ({"offset": -2}, ">= 0")])
def test_k7_batch_arguments_are_checked(kwargs, match):
    args = dict(substream=0, offset=0) | kwargs
    with pytest.raises(ValueError, match=match):
        mc_threefry.cell_uniforms_batch((4, 6), state_of(slots(2)), args.pop("substream"), **args)
