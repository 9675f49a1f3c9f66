"""The ``cuda`` backend on the CPU (``device="cpu"``: the same dispatch,
k-blocking and remainder logic over the plain version) and the ``torch``
backend, against the JAX ``PallasBackend(interpret=True)`` and the numpy
oracle.  Mirrors ``tests/test_pallas.py``'s packed cases."""

import numpy as np
import pytest
import torch

from tpu_life.backends.pallas_backend import PallasBackend
from tpu_life.models.rules import get_rule as jget_rule
from tpu_life_torch.backends import cuda_backend
from tpu_life_torch.backends.base import get_backend, make_runner
from tpu_life_torch.backends.cuda_backend import CudaBackend
from tpu_life_torch.backends.torch_backend import (
    DeviceRunner,
    TorchBackend,
    from_words,
    to_words,
)
from tpu_life_torch.models.rules import get_rule
from tpu_life_torch.ops import bitlife
from tpu_life_torch.ops.reference import run_np


def _jax_backend(**kw):
    kw.setdefault("block_rows", 16)
    kw.setdefault("block_cols", 128)
    kw.setdefault("block_steps", 4)
    kw.setdefault("interpret", True)
    return PallasBackend(**kw)


def _board(shape, seed):
    return np.random.default_rng(seed).integers(0, 2, size=shape, dtype=np.int8)


@pytest.mark.parametrize(
    "rule_name,shape,steps",
    [
        ("conway", (70, 150), 9),  # uneven rows + partial last word
        ("conway", (64, 64), 8),  # width an exact word multiple
        ("highlife", (40, 257), 7),  # one bit into a new word
        ("day_and_night", (33, 96), 6),  # dense rule, all 32 bits of last word
    ],
)
def test_packed_matches_reference(rule_name, shape, steps):
    b = _board(shape, seed=7)
    want = run_np(b, get_rule(rule_name), steps)
    np.testing.assert_array_equal(
        _jax_backend(block_rows=16, block_steps=4).run(b, jget_rule(rule_name), steps), want
    )
    rule = get_rule(rule_name)
    np.testing.assert_array_equal(CudaBackend(device="cpu", block_steps=4).run(b, rule, steps), want)
    np.testing.assert_array_equal(TorchBackend(device="cpu").run(b, rule, steps), want)


@pytest.mark.parametrize("block_steps", [1, 3, 4, 8, 32])
def test_remainder_steps_split(block_steps):
    # 7 steps: every depth but 1 leaves a remainder launch
    b = _board((48, 256), seed=3)
    want = run_np(b, get_rule("conway"), 7)
    np.testing.assert_array_equal(_jax_backend().run(b, jget_rule("conway"), 7), want)
    got = CudaBackend(device="cpu", block_steps=block_steps).run(b, get_rule("conway"), 7)
    np.testing.assert_array_equal(got, want)


def test_single_tile_grid():
    b = _board((32, 128), seed=5)
    want = run_np(b, get_rule("conway"), 6)
    np.testing.assert_array_equal(
        _jax_backend(block_rows=32, block_steps=2).run(b, jget_rule("conway"), 6), want
    )
    np.testing.assert_array_equal(
        CudaBackend(device="cpu", block_steps=2).run(b, get_rule("conway"), 6), want
    )


@pytest.mark.parametrize("backend", ["cuda", "torch", "numpy"])
def test_multi_chunk_run_with_callback(backend):
    b = _board((48, 256), seed=6)
    seen = []
    out = get_backend(backend, device="cpu").run(
        b, get_rule("conway"), 8, chunk_steps=3,
        callback=lambda s, g: seen.append((s, int(g().sum()))),
    )
    np.testing.assert_array_equal(out, run_np(b, get_rule("conway"), 8))
    assert [s for s, _ in seen] == [3, 6, 8]
    assert [n for _, n in seen] == [
        int(run_np(b, get_rule("conway"), s).sum()) for s in (3, 6, 8)
    ]
    jseen = []
    _jax_backend().run(b, jget_rule("conway"), 8, chunk_steps=3,
                       callback=lambda s, g: jseen.append(s))
    assert jseen == [3, 6, 8]


@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (5, 40)])
def test_tiny_board_stays_on_the_kernel_path(shape, monkeypatch):
    # no small-board fallback: every advance goes through the kernel wrapper
    calls = []
    real = cuda_backend.packed_multi_step

    def counting(*args, **kw):
        calls.append(args[3])
        return real(*args, **kw)

    monkeypatch.setattr(cuda_backend, "packed_multi_step", counting)
    b = _board(shape, seed=1)
    runner = make_runner(CudaBackend(device="cpu"), b, get_rule("conway"))
    runner.advance(5)
    runner.advance(4)
    assert calls == [5, 4]
    np.testing.assert_array_equal(runner.fetch(), run_np(b, get_rule("conway"), 9))
    assert runner.live_count() == int(run_np(b, get_rule("conway"), 9).sum())


def test_snapshot_survives_later_advances():
    # an advance that writes over its input buffer, as the cuda backend's
    # ping-pong does on the card: a kept snapshot must not follow it
    b = _board((12, 40), seed=8)
    rule = get_rule("conway")

    def in_place(x, n):
        x.copy_(bitlife.multi_step_packed(x, rule=rule, steps=n, logical_shape=b.shape))
        return x

    runner = DeviceRunner(
        to_words(b, torch.device("cpu")), in_place, lambda x: from_words(x, b.shape[1]),
        bitlife.live_count_packed,
    )
    runner.advance(2)
    snap = runner.snapshot()
    runner.advance(3)
    runner.advance(1)
    np.testing.assert_array_equal(snap(), run_np(b, rule, 2))
    np.testing.assert_array_equal(runner.fetch(), run_np(b, rule, 6))


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize(
    "spec,match",
    [("brians_brain", "K2"), ("bugs", "K2"), ("conway:T", "torus"), ("R1,C2,S1,B1,NN", "diamond")],
)
def test_other_rules_raise_not_implemented(backend, spec, match):
    # these rules once raised a typed "not yet ported" error (``match`` was
    # the word it carried: the kernel, or the mode still to come).  Every
    # deterministic rule now runs on both backends: each case holds the
    # result to the oracle and names the route it takes.
    routes = {
        ("cuda", "K2"): "k2", ("cuda", "torus"): "packed_torus", ("cuda", "diamond"): "k1_diamond",
        ("torch", "K2"): "stencil", ("torch", "torus"): "packed_torus",
        ("torch", "diamond"): "packed_diamond",
    }
    b = _board((16, 16), seed=2)
    rule = get_rule(spec)
    runner = make_runner(get_backend(backend, device="cpu"), b, rule)
    assert runner.route == routes[backend, match]
    runner.advance(3)
    np.testing.assert_array_equal(runner.fetch(), run_np(b, rule, 3))
    np.testing.assert_array_equal(get_backend(backend, device="cpu").run(b, rule, 3), run_np(b, rule, 3))


@pytest.mark.parametrize("spec", ["brians_brain", "conway:T", "R1,C2,S1,B1,NN"])
def test_numpy_backend_runs_every_deterministic_rule(spec):
    rng = np.random.default_rng(4)
    rule = get_rule(spec)
    b = rng.integers(0, rule.states, size=(20, 24), dtype=np.int8)
    np.testing.assert_array_equal(
        get_backend("numpy").run(b, rule, 5), run_np(b, rule, 5)
    )


@pytest.mark.parametrize("k", [0, 33, -1])
def test_block_steps_out_of_range(k):
    # clamped to what the kernels take, as the TPU backend clamps it
    backend = CudaBackend(device="cpu", block_steps=k)
    assert backend.block_steps == min(max(1, k), 32)
    b = np.random.default_rng(20 + k).integers(0, 2, size=(30, 40), dtype=np.int8)
    for spec, bitpack in (("conway", True), ("conway", False), ("bugs", True)):
        got = CudaBackend(device="cpu", block_steps=k, bitpack=bitpack).run(b, get_rule(spec), 7)
        np.testing.assert_array_equal(got, run_np(b, get_rule(spec), 7))


def test_unknown_backend():
    with pytest.raises(ValueError, match="unknown backend"):
        get_backend("pallas")
