"""Torus (``:T``) rules in the port, on the CPU: the packed torus step in
plain torch (the seam at every width), the int8 torus on the unpadded
board, the routes and the CLI — each against the JAX package
(``tpu_life``) and the numpy oracle, bit for bit.  Mirrors
``tests/test_torus.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_life import cli as jcli
from tpu_life.backends.jax_backend import JaxBackend
from tpu_life.models.rules import get_rule as jget_rule
from tpu_life.ops import bitlife as jbitlife
from tpu_life_torch import cli, interop
from tpu_life_torch.backends.base import get_backend, make_runner
from tpu_life_torch.io.codec import write_board, write_config
from tpu_life_torch.models.rules import get_rule
from tpu_life_torch.ops import bitlife, stencil
from tpu_life_torch.ops.reference import neighbor_counts_np, run_np

GLIDER = np.array([[0, 1, 0], [0, 0, 1], [1, 1, 1]], np.int8)


def _board(shape, seed, states=2):
    return np.random.default_rng(seed).integers(0, states, size=shape, dtype=np.int8)


def _words_np(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


def _glider_board():
    b = np.zeros((16, 16), np.int8)
    b[6:9, 6:9] = GLIDER
    return b


@pytest.mark.parametrize("width", [1, 31, 32, 33, 64, 65, 500])
def test_column_mask_matches_jax(width):
    np.testing.assert_array_equal(bitlife.column_mask(width), jbitlife.column_mask(width))


@pytest.mark.parametrize(
    "shape",
    [(16, 32), (20, 20), (33, 65), (17, 31), (12, 500), (9, 128)],
    ids=lambda s: f"{s[0]}x{s[1]}",
)
def test_packed_torus_step_bit_identical(shape):
    # word-aligned, one partial word, several words and a remainder, the
    # reference's 500
    h, w = shape
    b = _board(shape, seed=h * 100 + w)
    x = interop.board_from_reference(b, shape)
    before = x.clone()
    got = bitlife.multi_step_packed_torus(x, rule=get_rule("conway:T"), steps=12, width=w)
    want = jbitlife.multi_step_packed_torus(
        jnp.asarray(jbitlife.pack_np(b)), rule=jget_rule("conway:T"), steps=12, width=w
    )
    np.testing.assert_array_equal(_words_np(got), np.asarray(want))
    np.testing.assert_array_equal(
        interop.board_to_reference(got, shape), run_np(b, get_rule("conway:T"), 12)
    )
    assert torch.equal(x, before)  # the seam words are built beside the input


@pytest.mark.parametrize("width", range(1, 41))
def test_packed_torus_every_width_1_to_40(width):
    # the seam carries special-case rem == 0 against rem > 0 and one word
    # against several: an off-by-one in any branch shows at some width here
    shape = (12, width)
    b = _board(shape, seed=width)
    rule = get_rule("highlife:T")
    got = interop.board_from_reference(b, shape)
    want = jnp.asarray(jbitlife.pack_np(b))
    step = bitlife.make_packed_torus_step(rule, width)
    jstep = jbitlife.make_packed_torus_step(jget_rule("highlife:T"), width)
    for _ in range(3):
        got, want = step(got), jstep(want)
    np.testing.assert_array_equal(_words_np(got), np.asarray(want))
    np.testing.assert_array_equal(interop.board_to_reference(got, shape), run_np(b, rule, 3))


@pytest.mark.parametrize("width", [7, 32, 45, 96])
def test_packed_torus_clamped_rows_match_jax(width):
    # wrap_rows=False: columns wrap in place, rows stay clamped
    b = _board((10, width), seed=width)
    got = interop.board_from_reference(b, b.shape)
    want = jnp.asarray(jbitlife.pack_np(b))
    step = bitlife.make_packed_torus_step(get_rule("conway:T"), width, wrap_rows=False)
    jstep = jbitlife.make_packed_torus_step(jget_rule("conway:T"), width, wrap_rows=False)
    for _ in range(4):
        got, want = step(got), jstep(want)
    np.testing.assert_array_equal(_words_np(got), np.asarray(want))
    cols_only = stencil._counts(
        torch.from_numpy(b.astype(np.int32)), 1, False, "moore", False, True
    )
    one = stencil.apply_rule(torch.from_numpy(b), cols_only, get_rule("conway:T"))
    np.testing.assert_array_equal(
        interop.board_to_reference(step(interop.board_from_reference(b, b.shape)), b.shape),
        one.numpy(),
    )


@pytest.mark.parametrize("backend,bitpack", [("cuda", True), ("torch", True), ("cuda", False), ("numpy", True)])
def test_glider_circumnavigates_the_torus(backend, bitpack):
    # a glider moves (+1, +1) every 4 steps: 64 steps on a 16x16 torus wrap
    # it exactly back onto itself; on the clamped board it dies at the wall
    b = _glider_board()
    be = get_backend(backend, device="cpu", bitpack=bitpack)
    np.testing.assert_array_equal(be.run(b, get_rule("conway:T"), 64), b)
    assert not np.array_equal(be.run(b, get_rule("conway:T"), 32), b)
    assert not np.array_equal(be.run(b, get_rule("conway"), 64), b)


@pytest.mark.parametrize("bitpack", [True, False])
def test_blinker_across_the_seam(bitpack):
    # columns w-1 and 0 are true neighbours; period 2, checked by hand
    b = np.zeros((8, 16), np.int8)
    b[3, 15] = b[3, 0] = b[3, 1] = 1
    expect = np.zeros((8, 16), np.int8)
    expect[2, 0] = expect[3, 0] = expect[4, 0] = 1
    be = get_backend("cuda", device="cpu", bitpack=bitpack)
    np.testing.assert_array_equal(be.run(b, get_rule("conway:T"), 1), expect)
    np.testing.assert_array_equal(be.run(b, get_rule("conway:T"), 2), b)


def test_clamped_packed_step_refuses_torus_rules():
    rule = get_rule("conway:T")
    assert not bitlife.supports(rule) and bitlife.supports_torus(rule)
    with pytest.raises(ValueError, match="total_planes"):
        bitlife.make_packed_step(rule)
    with pytest.raises(ValueError, match="life-like torus rules only"):
        bitlife.make_packed_torus_step(get_rule("conway"), 20)
    with pytest.raises(ValueError, match="life-like torus rules only"):
        bitlife.make_packed_torus_step(get_rule("brians_brain:T"), 20)


@pytest.mark.parametrize(
    "spec,bitpack",
    [("conway:T", False), ("R2,C2,S2..4,B2..3,NN:T", True), ("brians_brain:T", True),
     ("B2/S/C3:T", True), ("bugs:T", True)],
)
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_int8_torus_route_matches_jax_and_oracle(backend, spec, bitpack):
    # an odd width: a padded board would wrap at the wrong column
    rule = get_rule(spec)
    b = _board((37, 41), seed=21, states=rule.states)
    want = run_np(b, rule, 6)
    np.testing.assert_array_equal(JaxBackend(bitpack=bitpack).run(b, jget_rule(spec), 6), want)
    runner = make_runner(get_backend(backend, device="cpu", bitpack=bitpack), b, rule)
    assert runner.route == "stencil" and tuple(runner.x.shape) == b.shape
    runner.advance(4)
    runner.advance(2)
    np.testing.assert_array_equal(runner.fetch(), want)
    assert runner.live_count() == int((want == 1).sum())


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_packed_torus_route_matches_jax_and_oracle(backend):
    b = _board((33, 29), seed=22)
    rule = get_rule("conway:T")
    want = run_np(b, rule, 5)
    np.testing.assert_array_equal(JaxBackend().run(b, jget_rule("conway:T"), 5), want)
    runner = make_runner(get_backend(backend, device="cpu"), b, rule)
    assert runner.route == "packed_torus" and runner.x.dtype == torch.int32
    snap = runner.snapshot()
    runner.advance(5)
    np.testing.assert_array_equal(runner.fetch(), want)
    np.testing.assert_array_equal(snap(), b)
    assert runner.live_count() == int(want.sum())


@pytest.mark.parametrize(
    "spec,shape", [("R2,C2,S2..4,B2..3:T", (3, 3)), ("R2,C2,S2..4,B2..3,NN:T", (4, 3)), ("bugs:T", (7, 9))]
)
def test_radius_exceeding_the_board_wraps_multiply(spec, shape):
    # offsets alias through several wraps; each offset still counts once
    rule = get_rule(spec)
    b = _board(shape, seed=5)
    counts = stencil.neighbor_counts(
        torch.from_numpy(b), rule.radius, rule.include_center, rule.neighborhood, "torus"
    )
    np.testing.assert_array_equal(
        counts.numpy(),
        neighbor_counts_np(b, radius=rule.radius, neighborhood=rule.neighborhood, boundary="torus"),
    )
    want = run_np(b, rule, 3)
    np.testing.assert_array_equal(JaxBackend().run(b, jget_rule(spec), 3), want)
    for backend in ("cuda", "torch"):
        np.testing.assert_array_equal(get_backend(backend, device="cpu").run(b, rule, 3), want)


@pytest.mark.parametrize(
    "rule,extra",
    [
        ("conway:T", []),
        ("conway:T", ["--no-bitpack"]),
        ("highlife:T", ["--backend", "torch"]),
        ("R2,C2,S2..4,B2..3,NN:T", []),
        ("brians_brain:T", ["--block-steps", "3"]),
    ],
)
def test_cli_bytes_equal_jax_numpy_backend(tmp_path, rule, extra):
    states = get_rule(rule).states
    write_board(tmp_path / "data.txt", _board((41, 53), seed=13, states=states))
    write_config(tmp_path / "grid_size_data.txt", 41, 53, 19)
    files = ["--config-file", str(tmp_path / "grid_size_data.txt"),
             "--input-file", str(tmp_path / "data.txt"), "--rule", rule]
    assert jcli.main(["run", *files, "--backend", "numpy",
                      "--output-file", str(tmp_path / "jax.txt")]) == 0
    assert cli.main(["run", *files, "--device", "cpu", *extra, "--sync-every", "7",
                     "--output-file", str(tmp_path / "port.txt")]) == 0
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()


def test_cli_glider_returns_on_the_torus(tmp_path):
    b = _glider_board()
    write_board(tmp_path / "data.txt", b)
    write_config(tmp_path / "grid_size_data.txt", 16, 16, 64)
    assert cli.main(["run", "--config-file", str(tmp_path / "grid_size_data.txt"),
                     "--input-file", str(tmp_path / "data.txt"), "--rule", "conway:T",
                     "--device", "cpu", "--output-file", str(tmp_path / "out.txt")]) == 0
    assert (tmp_path / "out.txt").read_bytes() == (tmp_path / "data.txt").read_bytes()
