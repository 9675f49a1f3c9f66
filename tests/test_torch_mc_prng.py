"""The torch twin of the counter-based PRNG and kernel K7's plain path,
held to the JAX package's ``tpu_life.mc.prng``.

The Random123 known-answer vectors pin the hash (int32 wrapping included:
keys and counters of 0xFFFFFFFF); draws at narrow and wide origins equal
``cell_uniforms(jnp, ...)`` bit for bit; seeded boards drawn through the
torch path equal the numpy ones.  Inputs come from ``np.random.default_rng``;
every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_life.mc import prng as jprng
from tpu_life_torch.kernels import mc_threefry
from tpu_life_torch.mc import prng

# Random123's published KAT vectors for threefry2x32, 20 rounds (the JAX
# package's tests/test_mc_prng.py::_KAT): (key, counter) -> (out0, out1)
KAT = [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
]
ORIGINS = [0, 5, 2**32 - 1000, 2**32, 2**33 + 7]


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("key,ctr,want", KAT)
def test_threefry_known_answer_torch(key, ctr, want):
    c0 = torch.tensor([prng.as_i32(ctr[0])], dtype=torch.int32)
    x0, x1 = prng.threefry2x32_torch(key[0], key[1], c0, ctr[1])
    assert (prng.as_u32(x0.item()), prng.as_u32(x1.item())) == want


@pytest.mark.parametrize("key,ctr,want", KAT)
def test_threefry_known_answer_through_k7s_wrapper(key, ctr, want):
    # K7's counter: c0 is the cell's index (the origin of a 1x1 block), c1
    # is step * NSUB + substream
    got = [
        prng.as_u32(mc_threefry.cell_uniforms(
            (1, 1), key[0], key[1], ctr[1] >> 2, ctr[1] & 3, origin=ctr[0], device="cpu",
            word=word).item())
        for word in (0, 1)
    ]
    assert tuple(got) == want


def test_threefry_torch_equals_numpy_on_random_words():
    rng = np.random.default_rng(0)
    c0 = rng.integers(0, 2**32, size=(17, 23), dtype=np.uint32)
    k0, k1 = (int(v) for v in rng.integers(0, 2**32, size=2))
    want = jprng.threefry2x32(np, k0, k1, c0, np.uint32(0xDEADBEEF))
    got = prng.threefry2x32_torch(k0, k1, torch.from_numpy(c0.view(np.int32)), 0xDEADBEEF)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(u32(g), w)


@pytest.mark.parametrize("origin", ORIGINS)
@pytest.mark.parametrize("shape", [(7, 9), (40, 50)])
def test_cell_uniforms_equal_jax(shape, origin):
    k0, k1 = prng.key_halves(-12345)
    want = np.asarray(jprng.cell_uniforms(jnp, shape, k0, k1, jnp.uint32(11), jprng.SUB_NOISE,
                                          origin=origin))
    got = prng.cell_uniforms_torch(shape, k0, k1, 11, prng.SUB_NOISE, origin=origin)
    np.testing.assert_array_equal(u32(got), want)
    # K7's wrapper on a CPU tensor is the plain version
    np.testing.assert_array_equal(
        u32(mc_threefry.cell_uniforms(shape, k0, k1, 11, prng.SUB_NOISE, origin=origin,
                                      device="cpu")), want)
    # and the port's numpy copy draws the same words
    np.testing.assert_array_equal(
        prng.cell_uniforms(shape, k0, k1, np.uint32(11), prng.SUB_NOISE, origin=origin), want)


@pytest.mark.parametrize("origin", [0, 2**32 - 100, 2**34])
def test_word_one_is_the_hashs_second_word(origin):
    k0, k1 = 99, 7
    n = 12 * 13
    idx = np.arange(n, dtype=np.int64) + origin
    lo, hi = jprng.split_cell_index(idx)
    wk0, wk1 = jprng.derive_wide_keys(np, k0, k1, hi)
    _, want = jprng.threefry2x32(np, wk0, wk1, lo, np.uint32(3 * prng.NSUB + 1))
    got = mc_threefry.cell_uniforms((12, 13), k0, k1, 3, 1, origin=origin, device="cpu", word=1)
    np.testing.assert_array_equal(u32(got).ravel(), want)


def test_derive_wide_keys_and_split_equal_jax():
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 2**40, size=200, dtype=np.int64)
    idx[:20] = rng.integers(0, 2**32, size=20)  # block 0 keeps the run key
    lo, hi = prng.split_cell_index_torch(torch.from_numpy(idx))
    jlo, jhi = jprng.split_cell_index(idx)
    np.testing.assert_array_equal(u32(lo), jlo)
    np.testing.assert_array_equal(u32(hi), jhi)
    got = prng.derive_wide_keys_torch(0xCAFEF00D, 17, hi)
    want = jprng.derive_wide_keys(np, 0xCAFEF00D, 17, jhi)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(u32(g), w)
    with pytest.raises(ValueError, match=">= 0"):
        prng.split_cell_index_torch(torch.tensor([-1]))


def test_unsigned_compare_of_bit_patterns():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 2**32, size=500, dtype=np.uint32)
    for b in (0, 1, 2**31 - 1, 2**31, 2**32 - 1, int(a[7])):
        got = prng.ult(torch.from_numpy(a.view(np.int32)), prng.as_i32(b)).numpy()
        np.testing.assert_array_equal(got, a < np.uint32(b))


@pytest.mark.parametrize("seed", [0, 1, -1, 2**40])
@pytest.mark.parametrize("states", [2, 3, 10])
@pytest.mark.parametrize("density", [0.0, 0.3, 0.5, 1.0])
def test_seeded_board_on_a_device_equals_jax(seed, states, density):
    want = jprng.seeded_board(23, 37, density, states=states, seed=seed)
    got = prng.seeded_board(23, 37, density, states=states, seed=seed, device="cpu")
    assert isinstance(got, torch.Tensor) and got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def test_seeded_board_on_a_device_rejects_alike():
    for bad in (dict(density=1.5), dict(states=1)):
        with pytest.raises(ValueError):
            prng.seeded_board(4, 4, device="cpu", **bad)
        with pytest.raises(ValueError):
            jprng.seeded_board(4, 4, **bad)


def test_block_limits_raise_alike():
    with pytest.raises(ValueError, match="origin must be >= 0"):
        prng.cell_uniforms_torch((2, 2), 0, 0, 0, 0, origin=-1)
    with pytest.raises(ValueError, match="origin must be >= 0"):
        jprng.cell_uniforms(np, (2, 2), 0, 0, np.uint32(0), 0, origin=-1)
    # past 2^32 cells in one block: refused before anything is allocated
    with pytest.raises(ValueError, match="shard-wise"):
        prng.cell_uniforms_torch((2**16, 2**16 + 1), 0, 0, 0, 0)
    with pytest.raises(ValueError, match="shard-wise"):
        mc_threefry.cell_uniforms((2**16, 2**16 + 1), 0, 0, 0, 0, device="cpu")


def test_k7s_wrapper_refuses_other_devices_and_words():
    with pytest.raises(ValueError, match="cuda or cpu"):
        mc_threefry.cell_uniforms((2, 2), 0, 0, 0, 0, device="meta")
    with pytest.raises(ValueError, match="word must be 0 or 1"):
        mc_threefry.cell_uniforms((2, 2), 0, 0, 0, 0, device="cpu", word=2)


def test_k7_counts_no_launch_on_the_cpu():
    before = mc_threefry.cell_uniforms.launches
    mc_threefry.cell_uniforms((4, 4), 1, 2, 3, 0, device="cpu")
    assert mc_threefry.cell_uniforms.launches == before


def test_counter_word_wraps_like_uint32():
    for step in (0, 5, 2**30, 2**32 + 3):
        with np.errstate(over="ignore"):  # the JAX package's c1, wrapping
            want = int(np.uint32(step & 0xFFFFFFFF) * np.uint32(prng.NSUB) + np.uint32(2))
        assert prng.counter_word(step, 2) == want
