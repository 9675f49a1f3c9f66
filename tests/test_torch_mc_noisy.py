"""Noisy Life of the port held to the JAX package's ``tpu_life.mc.noisy``:
p = 0 (the bare base step), p = 1 (an exact inversion that takes no draw)
and interior p, on clamped Moore, torus and von Neumann bases, through the
numpy copy, the ``torch`` backend's plain ops and the ``cuda`` backend's
dispatch (kernel K2's plain version for clamped Moore bases and kernel
K7's for the flips, on CPU tensors), and against the JAX
``MCDeviceRunner``.  Boards come from ``np.random.default_rng``; every
comparison is exact."""

import numpy as np
import pytest
import torch

from tpu_life import mc as jmc
from tpu_life.backends.base import get_backend as jget_backend
from tpu_life.backends.base import make_runner as jmake_runner
from tpu_life.models.rules import get_rule as jget_rule
from tpu_life.ops.reference import run_np as jref_run_np
from tpu_life_torch import mc
from tpu_life_torch.backends.base import get_backend, make_runner
from tpu_life_torch.kernels import int8_tiled
from tpu_life_torch.mc import noisy
from tpu_life_torch.models.rules import get_rule

SPECS = ["noisy:0/conway", "noisy:1/conway", "noisy:0.01/conway", "noisy:0.3/conway",
         "noisy:0.05/conway:T", "noisy:0.2/B36/S23:T", "noisy:0.1/R2,C2,S2..4,B2..3,NN",
         "noisy:0.1/bugs"]


def board_for(spec: str, shape=(24, 30)) -> np.ndarray:
    return np.random.default_rng(len(spec)).integers(0, 2, size=shape, dtype=np.int8)


@pytest.mark.parametrize("spec", SPECS)
def test_numpy_copy_equals_jax(spec):
    board = board_for(spec)
    np.testing.assert_array_equal(
        mc.run_np(get_rule(spec), board, 7, 12), jmc.run_np(jget_rule(spec), board, 7, 12))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("spec", SPECS)
def test_device_runner_equals_jax_numpy(spec, backend):
    board = board_for(spec)
    want = jmc.run_np(jget_rule(spec), board, 7, 12)
    r = make_runner(get_backend(backend, device="cpu"), board, get_rule(spec), seed=7)
    assert (r.route, r.packed) == ("mc_noisy", False)
    for n in (5, 7):  # chunked, and the counter runs on
        r.advance(n)
    np.testing.assert_array_equal(r.fetch(), want)
    assert r.step == 12


def test_p0_is_the_bare_base_and_p1_an_exact_inversion():
    board = board_for("x", (16, 16))
    conway = jget_rule("conway")
    np.testing.assert_array_equal(
        mc.run_np(get_rule("noisy:0/conway"), board, 3, 5), jref_run_np(board, conway, 5))
    inverted = board
    for _ in range(3):
        inverted = 1 - jref_run_np(inverted, conway, 1)
    np.testing.assert_array_equal(mc.run_np(get_rule("noisy:1/conway"), board, 3, 3), inverted)

    def no_draw(*a, **k):
        raise AssertionError("an endpoint probability drew from the stream")

    for spec in ("noisy:0/conway", "noisy:1/conway"):
        step = noisy.make_noisy_step(torch, get_rule(spec), uniforms=no_draw)
        out = step(torch.from_numpy(board.copy()), 0, 0, 0)
        np.testing.assert_array_equal(out.numpy(), mc.run_np(get_rule(spec), board, 0, 1))


def test_cuda_backend_steps_clamped_moore_bases_through_k2(monkeypatch):
    # the cuda dispatch hands clamped Moore bases to K2's wrapper (its plain
    # version on the CPU) at one step a launch; torus and von Neumann bases
    # take the plain stencil
    calls = []
    real = int8_tiled.int8_multi_step

    def spy(x, rule, shape, steps, *, block_steps, scratch=None):
        calls.append((rule.name, steps, block_steps))
        return real(x, rule, shape, steps, block_steps=block_steps, scratch=scratch)

    monkeypatch.setattr(int8_tiled, "int8_multi_step", spy)
    board = board_for("noisy:0.01/conway")
    for spec, want in (("noisy:0.01/conway", 3), ("noisy:0.05/conway:T", 0),
                       ("noisy:0.1/R2,C2,S2..4,B2..3,NN", 0)):
        calls.clear()
        r = make_runner(get_backend("cuda", device="cpu"), board, get_rule(spec), seed=1)
        r.advance(3)
        assert len(calls) == want and all(c[1:] == (1, 1) for c in calls)
        np.testing.assert_array_equal(r.fetch(), jmc.run_np(jget_rule(spec), board, 1, 3))
    calls.clear()
    make_runner(get_backend("torch", device="cpu"), board, get_rule("noisy:0.01/conway"),
                seed=1).advance(2)
    assert calls == []  # the torch backend is plain ops throughout


def test_runner_equals_jax_device_runner():
    spec = "noisy:0.05/conway"
    board = board_for(spec, (20, 20))
    jr = jmake_runner(jget_backend("jax"), board, jget_rule(spec), seed=5)
    jr.advance(10)
    r = make_runner(get_backend("cuda", device="cpu"), board, get_rule(spec), seed=5)
    r.advance(10)
    np.testing.assert_array_equal(r.fetch(), np.asarray(jr.fetch()))


def test_resume_mid_stream():
    spec = "noisy:0.02/highlife"
    board = board_for(spec)
    oracle = jmc.run_np(jget_rule(spec), board, 9, 10)
    half = jmc.run_np(jget_rule(spec), board, 9, 4)
    for backend in ("numpy", "torch", "cuda"):
        r = make_runner(get_backend(backend, device="cpu"), half, get_rule(spec), seed=9,
                        start_step=4)
        r.advance(6)
        np.testing.assert_array_equal(r.fetch(), oracle)


@pytest.mark.parametrize(
    "spec", ["noisy:0.1", "noisy:x/conway", "noisy:1.5/conway", "noisy:0.1/", "noisy:0.1/ising",
             "noisy:0.1/brians_brain", "noisy:0.1/lenia", "noisy:nan/conway"])
def test_bad_noisy_specs_fail_alike(spec):
    with pytest.raises(ValueError) as want:
        jget_rule(spec)
    with pytest.raises(ValueError) as got:
        get_rule(spec)
    assert str(got.value) == str(want.value)
