"""The checkerboard Metropolis sweep of the port (``tpu_life_torch.mc``)
held to the JAX package's ``tpu_life.mc`` on the same numpy inputs: the
torch roll path (``mc_roll``: the ``torch`` backend's plain ops and the
``cuda`` backend's dispatch through kernel K7's plain version on the CPU)
equal to ``tpu_life.mc.run_np`` and to the JAX ``MCDeviceRunner`` at T = 0,
2.27 and 10, across chunkings and resumed mid-stream, and the typed
refusals alike.  Boards come from the seeded stream or
``np.random.default_rng``; every comparison is exact."""

import numpy as np
import pytest
import torch

from tpu_life import mc as jmc
from tpu_life.backends.base import get_backend as jget_backend
from tpu_life.backends.base import make_runner as jmake_runner
from tpu_life.mc import ising as jising
from tpu_life.models.rules import get_rule as jget_rule
from tpu_life_torch import mc
from tpu_life_torch.backends.base import get_backend, make_runner
from tpu_life_torch.config import RunConfig
from tpu_life_torch.mc import engine, ising, prng
from tpu_life_torch.models.rules import get_rule
from tpu_life_torch.runtime import driver

RULE, JRULE = get_rule("ising"), jget_rule("ising")
TEMPS = [0.0, 2.27, 10.0]
# the torch-device runners of the two backends, on the CPU
BACKENDS = ["torch", "cuda"]


def roll_runner(backend, board, seed, temperature, start_step=0):
    return make_runner(get_backend(backend, device="cpu", bitpack=False), board, RULE,
                       seed=seed, temperature=temperature, start_step=start_step)


@pytest.mark.parametrize("temperature", TEMPS)
@pytest.mark.parametrize("shape", [(2, 2), (8, 8), (16, 34), (64, 64)])
def test_torch_roll_sweep_equals_jax_numpy(shape, temperature):
    board = prng.seeded_board(*shape, seed=11)
    want = jmc.run_np(JRULE, board, 11, 6, temperature=temperature)
    thr = ising.acceptance_thresholds(temperature)
    x = torch.from_numpy(board.copy())
    fn = mc.make_step_fn(torch, RULE)
    for step in range(6):
        x = fn(x, *prng.key_halves(11), step, thr)
    np.testing.assert_array_equal(x.numpy(), want)
    # the port's numpy copy is the same oracle
    np.testing.assert_array_equal(mc.run_np(RULE, board, 11, 6, temperature=temperature), want)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("temperature", TEMPS)
def test_roll_runner_equals_jax_device_runner(backend, temperature):
    board = np.random.default_rng(5).integers(0, 2, size=(18, 14), dtype=np.int8)
    jr = jmake_runner(jget_backend("jax", bitpack=False), board, JRULE, seed=77,
                      temperature=temperature)
    assert not jr.packed
    jr.advance(9)
    r = roll_runner(backend, board, 77, temperature)
    assert (r.route, r.packed, r.lanes) == ("mc_roll", False, None)
    r.advance(9)
    r.sync()
    np.testing.assert_array_equal(r.fetch(), np.asarray(jr.fetch()))


@pytest.mark.parametrize("backend", BACKENDS)
def test_roll_runner_is_invariant_to_chunking(backend):
    b0 = prng.seeded_board(20, 16, seed=5)
    oracle = jmc.run_np(JRULE, b0, 5, 12, temperature=2.2)
    for chunks in ([12], [1] * 12, [5, 7], [2, 3, 7]):
        r = roll_runner(backend, b0, 5, 2.2)
        for n in chunks:
            r.advance(n)
        np.testing.assert_array_equal(r.fetch(), oracle)
        assert r.step == 12


@pytest.mark.parametrize("backend", [*BACKENDS, "numpy"])
def test_runner_resume_mid_stream(backend):
    b0 = prng.seeded_board(12, 12, seed=3)
    oracle = jmc.run_np(JRULE, b0, 3, 10, temperature=1.9)
    half = jmc.run_np(JRULE, b0, 3, 4, temperature=1.9)
    kind = get_backend(backend, device="cpu", bitpack=False)
    r = make_runner(kind, half, RULE, seed=3, temperature=1.9, start_step=4)
    r.advance(6)
    r.sync()
    np.testing.assert_array_equal(r.fetch(), oracle)


def test_host_runner_is_the_jax_host_runner():
    b0 = prng.seeded_board(10, 12, seed=9)
    r = make_runner(get_backend("numpy"), b0, RULE, seed=9, temperature=2.5)
    assert isinstance(r, engine.MCHostRunner) and not r.packed
    r.advance(5)
    jr = jmake_runner(jget_backend("numpy"), b0, JRULE, seed=9, temperature=2.5)
    jr.advance(5)
    np.testing.assert_array_equal(r.fetch(), jr.fetch())
    assert r.live_count() == jr.live_count()


def test_snapshot_thunk_survives_later_advances():
    b0 = prng.seeded_board(8, 8, seed=1)
    r = roll_runner("cuda", b0, 1, 2.27)
    r.advance(2)
    get = r.snapshot()
    want = r.fetch().copy()
    r.advance(3)
    np.testing.assert_array_equal(get(), want)
    assert r.live_count() == int(np.count_nonzero(r.fetch() == 1))


def test_acceptance_table_and_constants_equal_jax():
    for t in (0.0, 0.5, 1.0, 2.27, 10.0, 1e9):
        np.testing.assert_array_equal(ising.acceptance_thresholds(t), jising.acceptance_thresholds(t))
    assert ising.T_CRITICAL == jising.T_CRITICAL
    for bad in (-1.0, float("nan"), float("inf")):
        with pytest.raises(ValueError, match="finite"):
            ising.acceptance_thresholds(bad)
        with pytest.raises(ValueError, match="finite"):
            jising.acceptance_thresholds(bad)


def test_magnetization_helper_equals_jax():
    board = np.random.default_rng(2).integers(0, 2, size=(16, 16), dtype=np.int8)
    assert ising.magnetization(board) == jising.magnetization(board)
    assert ising.magnetization(np.ones((4, 4), np.int8)) == 1.0


def test_low_and_high_temperature_order_alike():
    # T = 0 from an all-up lattice never moves; T = 10 scrambles it
    up = np.ones((16, 16), np.int8)
    r = roll_runner("cuda", up, 4, 0.0)
    r.advance(5)
    np.testing.assert_array_equal(r.fetch(), up)
    r = roll_runner("torch", up, 4, 10.0)
    r.advance(5)
    assert ising.magnetization(r.fetch()) < 0.9


def _cfg(tmp_path, **kw):
    base = dict(height=8, width=8, steps=2, input_file=str(tmp_path / "absent.txt"),
                config_file=str(tmp_path / "absent_cfg.txt"), output_file=str(tmp_path / "out.txt"))
    return {**base, **kw}


def _message(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_temperature_refusals_equal_jax(tmp_path):
    from tpu_life.config import RunConfig as JRunConfig
    from tpu_life.runtime.driver import run as jrun

    for kw in (dict(rule="ising"), dict(rule="conway", temperature=2.0),
               dict(rule="noisy:0.1/conway", temperature=2.0), dict(rule="ising", temperature=-1.0)):
        want = _message(lambda: jrun(JRunConfig(backend="numpy", **_cfg(tmp_path, **kw))))
        got = _message(lambda: driver.run(RunConfig(backend="numpy", **_cfg(tmp_path, **kw))))
        assert got == want
        got = _message(lambda: driver.run(RunConfig(device="cpu", **_cfg(tmp_path, **kw))))
        assert got == want


def test_odd_lattice_refusals_equal_jax(tmp_path):
    odd = prng.seeded_board(9, 8, seed=0)
    want = _message(lambda: jmake_runner(jget_backend("numpy"), odd, JRULE, temperature=2.0))
    assert "even lattice" in want
    for backend in ("numpy", "torch", "cuda"):
        for bitpack in (True, False):
            kind = get_backend(backend, device="cpu", bitpack=bitpack)
            assert _message(lambda: make_runner(kind, odd, RULE, temperature=2.0)) == want
    got = _message(lambda: driver.run(RunConfig(
        rule="ising", temperature=2.0, device="cpu", **_cfg(tmp_path, width=63))))
    assert "even lattice" in got and "8x63" in got
    # noisy rules have no parity constraint: odd boards run
    np.testing.assert_array_equal(
        mc.run_np(get_rule("noisy:0.1/conway"), odd, 0, 1),
        jmc.run_np(jget_rule("noisy:0.1/conway"), odd, 0, 1),
    )


def test_backends_without_the_key_schedule_refuse_alike(tmp_path):
    for backend in ("sharded",):
        with pytest.raises(mc.StochasticBackendError, match="key schedule") as e:
            driver.run(RunConfig(rule="ising", temperature=2.0, backend=backend, device="cpu",
                                 **_cfg(tmp_path)))
        assert f"is not implemented for {backend!r}" in str(e.value)
        with pytest.raises(ValueError, match="key schedule") as je:
            jmc.require_key_schedule(JRULE, backend)
        assert f"is not implemented for {backend!r}" in str(je.value)
    with pytest.raises(ValueError, match="key schedule"):
        make_runner(get_backend("sharded", device="cpu", num_devices=2),
                    np.zeros((8, 8), np.int8), RULE, temperature=2.0)


def test_auto_resolves_stochastic_rules_to_cuda():
    # a stated departure: the JAX package's auto picks its fused XLA path
    # (jax); the port's accelerated path is the cuda backend
    assert get_backend("auto", rule=RULE, device="cpu").name == "cuda"
    assert jget_backend("auto", rule=JRULE).name == "jax"
    assert mc.SUPPORTED_BACKENDS == ("numpy", "torch", "cuda")


def test_board_area_past_the_narrow_counter_is_refused_on_roll_only():
    big = (2**16, 2**16 + 2)
    for name in ("numpy", "torch", "cuda"):
        with pytest.raises(ValueError, match="one-word PRNG cell index"):
            mc.validate_board_shape(RULE, big, wide_counter=mc.wide_counter_capable(
                RULE, name, bitpack=False))
    for name in ("auto", "torch", "cuda"):
        assert mc.wide_counter_capable(RULE, name)
        mc.validate_board_shape(RULE, big, wide_counter=True)
    assert not mc.wide_counter_capable(RULE, "numpy")
    assert not mc.wide_counter_capable(get_rule("noisy:0.1/conway"), "cuda")
