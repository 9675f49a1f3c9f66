"""Seeded boards and ``--bug-compat`` against the JAX package.

The port's Threefry copy (``tpu_life_torch.mc.prng``) draws the boards of
``tpu_life.mc.prng`` bit for bit; ``python -m tpu_life_torch run --size N
--steps S --seed X`` (no input file) writes the bytes of ``python -m
tpu_life run … --backend numpy``, through every backend on the CPU; and
``--bug-compat`` runs the reference binary's effective rule as the JAX
CLI does.  Inputs come from ``np.random.default_rng``; every comparison is
exact."""

import numpy as np
import pytest

from tpu_life import cli as jcli
from tpu_life.mc import prng as jprng
from tpu_life.models.rules import get_rule as jget_rule
from tpu_life.ops.reference import run_np as jrun_np
from tpu_life_torch import cli
from tpu_life_torch.config import RunConfig
from tpu_life_torch.io.codec import read_board, write_board, write_config
from tpu_life_torch.mc import prng
from tpu_life_torch.runtime import driver

SEEDS = [0, 1, -1, 2**40]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("states", [2, 3, 10])
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_seeded_board_equals_jax(seed, states, density):
    got = prng.seeded_board(23, 37, density, states=states, seed=seed)
    want = jprng.seeded_board(23, 37, density, states=states, seed=seed)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_seeded_board_default_density_equals_jax(seed):
    np.testing.assert_array_equal(
        prng.seeded_board(64, 65, seed=seed), jprng.seeded_board(64, 65, seed=seed)
    )


def test_seeded_board_states_come_from_the_second_word():
    # a multistate board's live cells take the state of Threefry's word 1:
    # states 3 and 10 share the live mask of the 2-state board
    two = prng.seeded_board(40, 40, states=2, seed=9)
    for states in (3, 10):
        board = prng.seeded_board(40, 40, states=states, seed=9)
        np.testing.assert_array_equal(board > 0, two == 1)
        assert set(np.unique(board[board > 0])) == set(range(1, states))


@pytest.mark.parametrize("bad", [dict(density=-0.1), dict(density=1.5), dict(states=1)])
def test_seeded_board_rejects_alike(bad):
    with pytest.raises(ValueError):
        prng.seeded_board(4, 4, **bad)
    with pytest.raises(ValueError):
        jprng.seeded_board(4, 4, **bad)


def test_threefry_equals_jax_on_random_words():
    rng = np.random.default_rng(3)
    c0, c1 = (rng.integers(0, 2**32, size=257, dtype=np.uint32) for _ in range(2))
    for k0, k1 in [(0, 0), (0x13198A2E, 0x03707344), (2**32 - 1, 7)]:
        got = prng.threefry2x32(k0, k1, c0, c1)
        want = jprng.threefry2x32(np, k0, k1, c0, c1)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_cell_uniforms_at_equals_jax_with_a_nonzero_hi_word():
    rng = np.random.default_rng(4)
    lo = rng.integers(0, 2**32, size=(5, 7), dtype=np.uint32)
    hi = rng.integers(1, 4, size=(5, 7), dtype=np.uint32)
    for step, sub in [(0, prng.SUB_BOARD), (11, prng.SUB_NOISE)]:
        np.testing.assert_array_equal(
            prng.cell_uniforms_at(lo, hi, 5, 6, step, sub),
            jprng.cell_uniforms_at(np, lo, hi, 5, 6, step, sub),
        )
    # an all-zero hi word draws the narrow stream
    np.testing.assert_array_equal(
        prng.cell_uniforms_at(lo, np.zeros_like(hi), 5, 6, 1, 0),
        prng.cell_uniforms_at(lo, None, 5, 6, 1, 0),
    )


@pytest.mark.parametrize("origin", [0, 12345, 2**32 - 10, 2**40 + 3])
def test_cell_uniforms_equals_jax_at_an_origin(origin):
    np.testing.assert_array_equal(
        prng.cell_uniforms((4, 6), 1, 2, 3, prng.SUB_ODD, origin=origin),
        jprng.cell_uniforms(np, (4, 6), 1, 2, 3, prng.SUB_ODD, origin=origin),
    )


def test_key_and_index_helpers_equal_jax():
    for seed in [*SEEDS, 2**64 - 1, -(2**63)]:
        assert prng.key_halves(seed) == jprng.key_halves(seed)
    idx = np.array([0, 1, 2**32 - 1, 2**32, 2**40 + 5], np.int64)
    for g, w in zip(prng.split_cell_index(idx), jprng.split_cell_index(idx)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        prng.split_cell_index([-1])
    for p in [0.0, -1.0, 1e-9, 0.3, 0.5, 1.0, 2.0]:
        assert prng.threshold_u32(p) == jprng.threshold_u32(p)


def _seeded_args(tmp_path, *extra):
    # no input file and no config file: geometry and steps from flags
    return ["run", "--config-file", str(tmp_path / "none_grid.txt"),
            "--input-file", str(tmp_path / "none_data.txt"), *extra]


@pytest.mark.parametrize(
    "shared,port_only",
    [
        ([], []),
        (["--rule", "brians_brain"], []),
        (["--rule", "bugs_decay", "--size", "41"], []),
        ([], ["--backend", "sharded", "--num-devices", "4"]),
        (["--rule", "brians_brain"], ["--backend", "sharded", "--num-devices", "4"]),
        (["--seed", "-1"], ["--backend", "torch"]),
        (["--seed", str(2**40)], ["--no-bitpack"]),
    ],
    ids=["conway", "brians_brain", "bugs_decay", "sharded", "sharded_brians_brain",
         "torch_seed_-1", "int8_seed_2**40"],
)
def test_seeded_run_bytes_equal_jax_numpy(tmp_path, shared, port_only):
    base = ["--size", "40", "--steps", "5", "--seed", "7", *shared]
    assert jcli.main([*_seeded_args(tmp_path, *base), "--backend", "numpy",
                      "--output-file", str(tmp_path / "jax.txt")]) == 0
    assert cli.main([*_seeded_args(tmp_path, *base, *port_only), "--device", "cpu",
                     "--output-file", str(tmp_path / "port.txt")]) == 0
    assert not (tmp_path / "none_data.txt").exists()
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()


@pytest.mark.parametrize("flags", [["--height", "30"], ["--width", "25"]])
def test_explicit_height_and_width_win_over_size(tmp_path, flags):
    base = ["--size", "40", "--steps", "3", "--seed", "2", *flags]
    assert jcli.main([*_seeded_args(tmp_path, *base), "--backend", "numpy",
                      "--output-file", str(tmp_path / "jax.txt")]) == 0
    assert cli.main([*_seeded_args(tmp_path, *base), "--device", "cpu",
                     "--output-file", str(tmp_path / "port.txt")]) == 0
    raw = (tmp_path / "port.txt").read_bytes()
    assert raw == (tmp_path / "jax.txt").read_bytes()
    h, w = (30, 40) if flags[0] == "--height" else (40, 25)
    assert len(raw) == h * (w + 1)


def test_size_with_an_input_file_reads_the_file(tmp_path):
    # a seeded board only where the input file is missing
    board = np.random.default_rng(8).integers(0, 2, size=(12, 12), dtype=np.int8)
    write_board(tmp_path / "data.txt", board)
    cfg = RunConfig(height=12, width=12, steps=0, input_file=str(tmp_path / "data.txt"),
                    output_file="", device="cpu", seed=7)
    res = driver.run(cfg)
    np.testing.assert_array_equal(res.board, board)
    assert res.seed is None


def test_contract_mode_still_needs_its_input_file(tmp_path):
    write_config(tmp_path / "grid_size_data.txt", 10, 10, 4)
    args = ["run", "--config-file", str(tmp_path / "grid_size_data.txt"),
            "--input-file", str(tmp_path / "data.txt"), "--device", "cpu"]
    with pytest.raises(FileNotFoundError):
        cli.main(args)
    with pytest.raises(FileNotFoundError):
        cli.main([*args, "--seed", "3", "--steps", "4"])  # geometry still from the file


def test_run_result_stamps_the_seed(tmp_path):
    cfg = RunConfig(height=16, width=20, steps=2, input_file=str(tmp_path / "absent.txt"),
                    output_file="", device="cpu", seed=2**40)
    res = driver.run(cfg)
    assert res.seed == 2**40
    want = jrun_np(jprng.seeded_board(16, 20, seed=2**40), jget_rule("conway"), 2)
    np.testing.assert_array_equal(res.board, want)


def test_seeded_board_is_the_staged_board(tmp_path):
    # zero steps: the output is the staged board itself
    cfg = RunConfig(height=9, width=33, steps=0, rule="brians_brain",
                    input_file=str(tmp_path / "absent.txt"), output_file="", device="cpu", seed=5)
    np.testing.assert_array_equal(
        driver.run(cfg).board, jprng.seeded_board(9, 33, states=3, seed=5)
    )


@pytest.mark.parametrize("backend", ["auto", "torch", "numpy", "sharded"])
def test_bug_compat_bytes_equal_jax(tmp_path, backend):
    board = np.random.default_rng(6).integers(0, 2, size=(33, 47), dtype=np.int8)
    write_board(tmp_path / "data.txt", board)
    write_config(tmp_path / "grid_size_data.txt", 33, 47, 9)
    files = ["--config-file", str(tmp_path / "grid_size_data.txt"),
             "--input-file", str(tmp_path / "data.txt"), "--bug-compat"]
    assert jcli.main(["run", *files, "--backend", "numpy",
                      "--output-file", str(tmp_path / "jax.txt")]) == 0
    assert cli.main(["run", *files, "--backend", backend, "--device", "cpu",
                     "--output-file", str(tmp_path / "port.txt")]) == 0
    port = (tmp_path / "port.txt").read_bytes()
    assert port == (tmp_path / "jax.txt").read_bytes()
    # B/S2 is not Conway: the flag changed the rule
    conway = tmp_path / "conway.txt"
    assert cli.main(["run", *files[:-1], "--device", "cpu", "--output-file", str(conway)]) == 0
    assert conway.read_bytes() != port


def test_bug_compat_names_the_effective_rule(tmp_path):
    cfg = RunConfig(height=8, width=8, steps=1, input_file=str(tmp_path / "absent.txt"),
                    output_file=str(tmp_path / "o.txt"), device="cpu", bug_compat=True,
                    rule="highlife")
    assert cfg.effective_rule() == "reference_bug_compat"
    res = driver.run(cfg)
    assert res.rule == "B/S2"
    np.testing.assert_array_equal(read_board(tmp_path / "o.txt", 8, 8), res.board)
