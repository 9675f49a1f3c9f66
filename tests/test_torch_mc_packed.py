"""The bitplane-packed Metropolis sweep of the port held to the JAX
package's ``tpu_life.mc.packed``: the torch half-sweep (kernel K6's plain
version, reached through K6's wrapper on CPU tensors) equal to
``run_packed_np``, to the roll path and to the JAX ``MCPackedDeviceRunner``
on the CPU at T = 0, 2.27 and 10, at widths with W % 32 of 0, 2 and 30 and
one word a row; at origins across and past 2^32 equal to JAX's
``make_sweep(np, ..., origin=)``; chunking, resume and the runner factory.
Boards come from the seeded stream or ``np.random.default_rng``; every
comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_life import mc as jmc
from tpu_life.backends.base import get_backend as jget_backend
from tpu_life.backends.base import make_runner as jmake_runner
from tpu_life.mc import packed as jpacked
from tpu_life.models.rules import get_rule as jget_rule
from tpu_life_torch import mc
from tpu_life_torch.backends.base import get_backend, make_runner
from tpu_life_torch.kernels import mc_threefry
from tpu_life_torch.mc import engine, ising, packed, prng
from tpu_life_torch.models.rules import get_rule

RULE, JRULE = get_rule("ising"), jget_rule("ising")
TEMPS = [0.0, 2.27, 10.0]
# W % 32 of 2, 0 and 30; one word a row (W <= 32); several words
SHAPES = [(2, 2), (4, 30), (6, 32), (8, 34), (10, 62), (12, 64), (20, 98)]


def words(board: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(packed.pack_board(board).view(np.int32).copy())


def unwords(x: torch.Tensor, width: int) -> np.ndarray:
    return packed.unpack_board(x.numpy().view(np.uint32), width)


def packed_runner(backend, board, seed, temperature, start_step=0):
    return make_runner(get_backend(backend, device="cpu"), board, RULE, seed=seed,
                       temperature=temperature, start_step=start_step)


@pytest.mark.parametrize("temperature", TEMPS)
@pytest.mark.parametrize("shape", SHAPES)
def test_torch_packed_sweep_equals_jax(shape, temperature):
    board = np.random.default_rng(shape[1]).integers(0, 2, size=shape, dtype=np.int8)
    want = jpacked.run_packed_np(JRULE, board, 21, 5, temperature=temperature)
    # the packed path is bit-identical to the roll oracle
    np.testing.assert_array_equal(want, jmc.run_np(JRULE, board, 21, 5, temperature=temperature))
    thr = ising.acceptance_thresholds(temperature)
    sweep = packed.make_sweep(torch, RULE, shape)
    x = words(board)
    for step in range(5):
        x = sweep(x, *prng.key_halves(21), step, thr)
    np.testing.assert_array_equal(unwords(x, shape[1]), want)
    np.testing.assert_array_equal(
        packed.run_packed_np(RULE, board, 21, 5, temperature=temperature), want)


@pytest.mark.parametrize("origin", [2**32 - 40, 2**32 - 1, 2**32, 2**33 + 6])
@pytest.mark.parametrize("shape", [(8, 30), (10, 66)])
def test_half_sweeps_at_wide_origins_equal_jax(shape, origin):
    h, w = shape
    board = prng.seeded_board(h, w, seed=13)
    thr = ising.acceptance_thresholds(2.27)
    k0, k1 = prng.key_halves(13)
    jsweep = jpacked.make_sweep(np, JRULE, shape, origin=origin)
    xn = jpacked.pack_board(board)
    x = words(board)
    for step in range(3):
        xn = jsweep(xn, np.uint32(k0), np.uint32(k1), np.uint32(step), thr)
        for parity in (0, 1):
            # K6's wrapper on a CPU tensor: the plain half-sweep
            x = mc_threefry.packed_metropolis_half(x, parity, k0, k1, step, int(thr[3]),
                                                  int(thr[4]), width=w, origin=origin)
        np.testing.assert_array_equal(x.numpy().view(np.uint32), xn)


def test_wide_origin_reproduces_narrow_draws_below_the_boundary():
    # a board placed at an origin below 2^32 - h*w takes the narrow schedule
    b0 = prng.seeded_board(8, 8, seed=11)
    thr = ising.acceptance_thresholds(2.27)
    for origin in (0, 1000):
        jsweep = jpacked.make_sweep(jnp, JRULE, (8, 8), origin=origin)
        sweep = packed.make_sweep(torch, RULE, (8, 8), origin=origin)
        xj, x = jnp.asarray(jpacked.pack_board(b0)), words(b0)
        for step in range(4):
            xj = jsweep(xj, jnp.uint32(11), jnp.uint32(0), jnp.uint32(step), jnp.asarray(thr))
            x = sweep(x, 11, 0, step, thr)
        np.testing.assert_array_equal(x.numpy().view(np.uint32), np.asarray(xj))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("temperature", TEMPS)
def test_packed_runner_equals_jax_device_runner(backend, temperature):
    board = prng.seeded_board(16, 34, seed=8)
    jr = jmake_runner(jget_backend("jax"), board, JRULE, seed=8, temperature=temperature)
    assert jr.packed
    jr.advance(7)
    r = packed_runner(backend, board, 8, temperature)
    assert (r.route, r.packed, r.lanes) == ("mc_packed", True, 32)
    r.advance(7)
    r.sync()
    np.testing.assert_array_equal(r.fetch(), np.asarray(jr.fetch()))
    assert r.live_count() == jr.live_count()


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_packed_runner_chunking_and_resume(backend):
    b0 = prng.seeded_board(20, 36, seed=5)
    oracle = jmc.run_np(JRULE, b0, 5, 12, temperature=2.4)
    for chunks in ([12], [1] * 12, [5, 7], [2, 3, 7]):
        r = packed_runner(backend, b0, 5, 2.4)
        for n in chunks:
            r.advance(n)
        np.testing.assert_array_equal(r.fetch(), oracle)
        assert r.step == 12
    half = jmc.run_np(JRULE, b0, 5, 4, temperature=2.4)
    r = packed_runner(backend, half, 5, 2.4, start_step=4)
    r.advance(8)
    np.testing.assert_array_equal(r.fetch(), oracle)


def test_packed_host_runner_is_the_jax_one():
    b0 = prng.seeded_board(12, 40, seed=6)
    r = make_runner(get_backend("numpy"), b0, RULE, seed=6, temperature=2.0, packed=True)
    jr = jmake_runner(jget_backend("numpy"), b0, JRULE, seed=6, temperature=2.0, packed=True)
    assert isinstance(r, engine.MCPackedHostRunner) and (r.packed, r.lanes) == (True, 32)
    r.advance(4)
    jr.advance(4)
    np.testing.assert_array_equal(r.fetch(), jr.fetch())
    assert r.live_count() == jr.live_count()
    np.testing.assert_array_equal(r.snapshot()(), jr.snapshot()())


def test_runner_factory_dispatch():
    b0 = prng.seeded_board(8, 8, seed=0)
    for name, bitpack, cls in (("cuda", True, engine.MCPackedDeviceRunner),
                               ("cuda", False, engine.MCDeviceRunner),
                               ("torch", True, engine.MCPackedDeviceRunner),
                               ("torch", False, engine.MCDeviceRunner),
                               ("numpy", True, engine.MCHostRunner)):
        r = make_runner(get_backend(name, device="cpu", bitpack=bitpack), b0, RULE, temperature=2.0)
        assert type(r) is cls, name
    # packed pinned on or off overrides the backend's knob
    r = make_runner(get_backend("cuda", device="cpu"), b0, RULE, temperature=2.0, packed=False)
    assert r.route == "mc_roll"
    with pytest.raises(ValueError, match="ising rule family only"):
        make_runner(get_backend("cuda", device="cpu"), b0, get_rule("noisy:0.1/conway"),
                    packed=True)
    with pytest.raises(ValueError, match="ising rule family only"):
        jmake_runner(jget_backend("numpy"), b0, jget_rule("noisy:0.1/conway"), packed=True)


def test_k6_wrapper_checks_its_arguments():
    x = words(prng.seeded_board(4, 30, seed=1))
    with pytest.raises(ValueError, match="even dimensions"):
        mc_threefry.packed_metropolis_half(x, 0, 0, 0, 0, 0, 0, width=29)
    with pytest.raises(ValueError, match="parity"):
        mc_threefry.packed_metropolis_half(x, 2, 0, 0, 0, 0, 0, width=30)
    with pytest.raises(ValueError, match="words a row"):
        mc_threefry.packed_metropolis_half(x, 0, 0, 0, 0, 0, 0, width=40)
    with pytest.raises(TypeError, match="int32"):
        mc_threefry.packed_metropolis_half(x.to(torch.int64), 0, 0, 0, 0, 0, 0, width=30)
    with pytest.raises(ValueError, match="cuda or cpu"):
        mc_threefry.packed_metropolis_half(x.to("meta"), 0, 0, 0, 0, 0, 0, width=30)
    before = mc_threefry.packed_metropolis_half.launches
    mc_threefry.packed_metropolis_half(x, 1, 0, 0, 0, 0, 0, width=30)
    assert mc_threefry.packed_metropolis_half.launches == before  # plain, no launch


def test_padding_bits_stay_dead():
    # columns past W in the last word never flip, whatever their draws
    board = np.ones((6, 34), np.int8)
    x = words(board)
    thr = ising.acceptance_thresholds(10.0)
    sweep = packed.make_sweep(torch, RULE, board.shape)
    for step in range(4):
        x = sweep(x, 3, 3, step, thr)
    pad = packed.column_mask(34)[-1]
    assert not (x.numpy().view(np.uint32)[:, -1] & ~pad).any()


def test_make_sweep_refuses_what_jax_refuses():
    for bad, match in (((8, 9), "even lattice"),):
        with pytest.raises(ValueError, match=match):
            packed.make_sweep(torch, RULE, bad)
        with pytest.raises(ValueError, match=match):
            jpacked.make_sweep(np, JRULE, bad)
    with pytest.raises(ValueError, match="ising rule family only"):
        packed.make_sweep(torch, get_rule("conway"), (8, 8))
    assert packed.supports(RULE) and not packed.supports(get_rule("noisy:0.1/conway"))
    assert mc.packed_supports(RULE) == jmc.packed_supports(JRULE)
