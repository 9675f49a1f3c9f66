"""The port's ``sharded`` backend on the CPU (meshes of CPU shards) against
the JAX package's ``ShardedBackend`` — its Pallas stripe kernel in
interpret mode (``local_kernel='pallas'``) and its XLA scan — and the
numpy oracle, byte for byte: shard-count invariance (SURVEY.md §6a item
4), uneven heights that leave padding rows, a glider across shard seams,
remainder blocks, the von Neumann diamond, the torus routes, the
``torch`` local kernel against ``auto``, the runner contract, the refusals,
and ``python -m tpu_life_torch run --backend sharded`` at the reference
contract's golden sha256.  Mirrors ``tests/test_sharded.py`` and
``tests/test_sharded_pallas.py`` (1-D, packed parts)."""

import gzip
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_life.backends.sharded_backend import ShardedBackend as JaxShardedBackend
from tpu_life.models.patterns import GLIDER, place
from tpu_life.models.rules import get_rule as jget_rule
from tpu_life_torch import cli
from tpu_life_torch.backends.base import get_backend, make_runner
from tpu_life_torch.backends.sharded_backend import ShardedBackend
from tpu_life_torch.kernels import sharded_stripe
from tpu_life_torch.models.rules import NotPortedError, get_rule
from tpu_life_torch.ops.reference import run_np
from tpu_life_torch.parallel.mesh import make_mesh

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures"
GOLDEN_SHA = "ea69597f6ada6271b4b182c592f36395652fee9cf2d28a2e17c80fb5eca79215"

stripe = pytest.mark.requires_tpu_interpret  # the JAX Pallas path, as its own tests gate it


def _board(shape, seed, states=2):
    rng = np.random.default_rng(seed)
    b = rng.integers(0, states, size=shape, dtype=np.int8)
    return b * rng.integers(0, 2, size=shape, dtype=np.int8) if states > 2 else b


def port(n, **kw):
    return ShardedBackend(device="cpu", num_devices=n, **kw)


def jax_pallas(n, **kw):
    return JaxShardedBackend(num_devices=n, local_kernel="pallas", pallas_interpret=True, **kw)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("shape", [(35, 40), (67, 129)])
@stripe
def test_shard_count_invariance_against_the_tpu_kernel(n, shape):
    # 35 rows over 3, 4 or 8 shards and 67 over any leave padding rows
    board = _board(shape, seed=n + shape[0])
    rule = get_rule("conway")
    got = port(n, block_steps=2).run(board, rule, 5)
    want = jax_pallas(n, block_steps=2).run(board, jget_rule("conway"), 5)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, run_np(board, rule, 5))


@pytest.mark.parametrize("n", [3, 8])
def test_shard_count_invariance_against_the_xla_scan(n):
    board = _board((53, 70), seed=n)
    rule = get_rule("highlife")
    got = port(n, block_steps=3).run(board, rule, 11)
    want = JaxShardedBackend(num_devices=n, block_steps=3, local_kernel="xla").run(
        board, jget_rule("highlife"), 11)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, run_np(board, rule, 11))


@pytest.mark.parametrize("name", ["conway", "highlife", "daynight", "seeds"])
def test_rule_family_on_four_shards(name):
    board = _board((48, 96), seed=5)
    runner = port(4, block_steps=3).prepare(board, get_rule(name))
    assert runner.route == "k3"
    runner.advance(7)
    np.testing.assert_array_equal(runner.fetch(), run_np(board, get_rule(name), 7))


@pytest.mark.parametrize("block_steps", [None, 1, 4])
@stripe
def test_block_steps_and_remainders(block_steps):
    board = _board((40, 70), seed=11)
    rule = get_rule("conway")
    got = port(8, block_steps=block_steps).run(board, rule, 9)
    want = jax_pallas(8, block_steps=block_steps).run(board, jget_rule("conway"), 9)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, run_np(board, rule, 9))


def test_remainders_across_chunked_advances():
    board = _board((45, 33), seed=12)
    rule = get_rule("conway")
    runner = port(4, block_steps=4).prepare(board, rule)
    for n in (3, 1, 9, 0, 5):
        runner.advance(n)
    np.testing.assert_array_equal(runner.fetch(), run_np(board, rule, 18))


@stripe
def test_glider_crosses_shard_seams():
    board = place(np.zeros((64, 32), dtype=np.int8), GLIDER, 26, 14)
    rule = get_rule("conway")
    got = port(8, block_steps=2).run(board, rule, 24)
    np.testing.assert_array_equal(got, run_np(board, rule, 24))
    np.testing.assert_array_equal(got, jax_pallas(8, block_steps=2).run(board, jget_rule("conway"), 24))
    assert got.sum() == 5  # still a glider, having crossed shard seams


@pytest.mark.parametrize("spec", ["R2,C2,S2..4,B2..3,NN", "R1,C2,M1,S2..4,B3..4,NN"])
@stripe
def test_von_neumann_diamond_on_k3(spec):
    board = _board((40, 70), seed=13)
    rule = get_rule(spec)
    backend = port(4, block_steps=3)
    assert backend.prepare(board, rule).route == "k3_diamond"
    got = backend.run(board, rule, 7)
    np.testing.assert_array_equal(got, jax_pallas(4, block_steps=3).run(board, jget_rule(spec), 7))
    np.testing.assert_array_equal(got, run_np(board, rule, 7))


def test_diamond_depth_clamps_to_the_shard_and_the_reach():
    board = _board((64, 40), seed=14)
    rule = get_rule("R2,C2,S2..4,B2..3,NN")
    runner = port(2, block_steps=32).prepare(board, rule)
    before = sharded_stripe.sharded_stripe_block.launches
    runner.advance(35)  # k clamps to 32 // 2 = 16: two blocks and a remainder
    np.testing.assert_array_equal(runner.fetch(), run_np(board, rule, 35))
    assert sharded_stripe.sharded_stripe_block.launches == before  # the CPU runs the plain version


@pytest.mark.parametrize("local_kernel", ["torch", "auto"])
@pytest.mark.parametrize("shape,spec", [((9, 30), "bugs"), ((4, 20), "R2,C2,S2..4,B2..3,NN")])
def test_shards_shallower_than_the_radius_run(shape, spec, local_kernel):
    # ROADMAP C1: clamped shards are at least a radius deep (the padding
    # rows are dead), so these boards run on 4 shards as in the JAX package
    board = _board(shape, seed=21)
    rule = get_rule(spec)
    runner = port(4, local_kernel=local_kernel).prepare(board, rule)
    assert all(c.shape[0] == rule.radius for c in runner.chunks)
    runner.advance(5)
    got = runner.fetch()
    np.testing.assert_array_equal(got, run_np(board, rule, 5))
    want = JaxShardedBackend(num_devices=4, local_kernel="xla").run(board, jget_rule(spec), 5)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("spec", ["brians_brain:T", "R2,C2,S2..4,B2..3,NN:T"])
def test_int8_torus_rules_on_shard_ops(spec):
    board = _board((24, 30), seed=15, states=get_rule(spec).states)
    rule = get_rule(spec)
    runner = port(4, block_steps=2).prepare(board, rule)
    assert runner.route == "shard_ops"
    runner.advance(7)
    got = runner.fetch()
    np.testing.assert_array_equal(got, run_np(board, rule, 7))
    want = JaxShardedBackend(num_devices=4, block_steps=2).run(board, jget_rule(spec), 7)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "spec,off_k4",
    [("conway", True), ("highlife:T", True), ("R2,C2,S2..4,B2..3,NN", True),
     ("R3,C2,S6..10,B6..8,NN", True), ("R1,C3,S1..2,B2,NN", True),
     ("brians_brain", False), ("bugs", False)],  # the last two take K4 under auto
)
def test_torch_local_kernel_equals_auto_and_the_oracle(spec, off_k4):
    rule = get_rule(spec)
    board = _board((36, 50), seed=16, states=rule.states)
    torch_runner = port(3, block_steps=2, local_kernel="torch").prepare(board, rule)
    assert torch_runner.route == "shard_ops"
    torch_runner.advance(5)
    got = torch_runner.fetch()
    np.testing.assert_array_equal(got, run_np(board, rule, 5))
    auto_runner = port(3, block_steps=2).prepare(board, rule)
    assert (auto_runner.route == "k4") != off_k4
    auto_runner.advance(5)
    np.testing.assert_array_equal(got, auto_runner.fetch())


@pytest.mark.parametrize(
    "spec,bitpack,route",
    [("conway", True, "k3"), ("conway:T", True, "k3_torus"), ("R2,C2,S2..4,B2..3,NN", True, "k3_diamond"),
     ("brians_brain:T", True, "shard_ops"), ("conway:T", False, "shard_ops"),
     ("R3,C2,S6..10,B6..8,NN", True, "shard_ops"), ("R2,C2,S2..4,B2..3,NN", False, "shard_ops")],
)
def test_routes(spec, bitpack, route):
    assert port(2, bitpack=bitpack).route(get_rule(spec)) == route
    assert port(2, bitpack=bitpack, local_kernel="torch").route(get_rule(spec)) == "shard_ops"


@pytest.mark.parametrize("spec,bitpack", [("brians_brain", True), ("bugs", True), ("bugs_decay", True),
                                          ("conway", False), ("R2,C3,M1,S8..12,B7..8", True)])
@pytest.mark.parametrize("local_kernel", ["auto", "cuda"])
def test_rules_of_the_int8_kernel_name_roadmap_b4(spec, bitpack, local_kernel):
    # the rules of ROADMAP B4's kernel, which the sharded backend refused
    # until K4 was ported: under auto and cuda they take route k4
    rule = get_rule(spec)
    board = _board((16, 40), seed=19, states=rule.states)
    runner = port(2, bitpack=bitpack, local_kernel=local_kernel).prepare(board, rule)
    assert runner.route == "k4"
    runner.advance(3)
    np.testing.assert_array_equal(runner.fetch(), run_np(board, rule, 3))


@pytest.mark.parametrize(
    "kwargs,match",
    [(dict(mesh_shape=(2, 2), partition_mode="gspmd"), "ROADMAP A6"),
     (dict(partition_mode="gspmd"), "ROADMAP A6")],
)
def test_options_not_ported_name_their_item(kwargs, match):
    with pytest.raises(NotPortedError, match=match):
        ShardedBackend(device="cpu", **kwargs)


@pytest.mark.parametrize(
    "make,match",
    [
        (lambda: port(2, local_kernel="pallas"), "local_kernel must be one of"),
        # the backend clamps any depth; K3's wrapper takes 1..32 // r
        (lambda: sharded_stripe.sharded_stripe_block(
            *(torch.zeros(s, dtype=torch.int32) for s in ((33, 3), (40, 3), (33, 3))),
            -33, get_rule("conway"), (40, 70), 33), r"block_steps must be in \[1, 32\]"),
        (lambda: port(3).prepare(np.zeros((16, 16), np.int8), get_rule("conway:T")), "divisible by the mesh size"),
        (lambda: port(2, local_kernel="cuda").prepare(np.zeros((16, 16), np.int8), get_rule("brians_brain:T")),
         "needs the packed bitboard"),
        (lambda: port(2, local_kernel="cuda").prepare(np.zeros((16, 16), np.int8), get_rule("R3,C2,S6..10,B6..8,NN")),
         "Moore boxes only"),
        # clamped shards are at least a radius deep; torus shards are exact
        (lambda: port(8).prepare(np.zeros((8, 16), np.int8), get_rule("R2,C2,S2..4,B2..3,NN:T")),
         "fewer devices"),
        (lambda: ShardedBackend(device="cpu", mesh=make_mesh(devices=["cpu"] * 2), num_devices=3), "contradicts"),
    ],
)
def test_refusals(make, match):
    with pytest.raises(ValueError, match=match):
        make()


def test_mesh_shape_of_one_column_is_the_row_mesh():
    assert ShardedBackend(device="cpu", mesh_shape=(3, 1)).n == 3


def test_default_mesh_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        get_backend("sharded", num_devices=2)


def test_runner_contract():
    board = _board((30, 40), seed=17)
    rule = get_rule("conway")
    runner = make_runner(get_backend("sharded", device="cpu", num_devices=4, block_steps=3), board, rule)
    assert [c.shape for c in runner.chunks] == [(8, 2)] * 4  # ceil(30 / 4) rows, 2 words
    snap = runner.snapshot()
    runner.advance(4)
    runner.sync()
    np.testing.assert_array_equal(snap(), board)  # the snapshot kept its state
    want = run_np(board, rule, 4)
    np.testing.assert_array_equal(runner.fetch(), want)
    assert runner.live_count() == int((want == 1).sum())
    assert runner.gather().shape == (30, 2)


def test_chunked_run_with_callback():
    board = _board((30, 40), seed=18)
    rule = get_rule("conway")
    seen = []
    out = port(4, block_steps=2).run(
        board, rule, 9, chunk_steps=4, callback=lambda s, get: seen.append((s, get())))
    assert [s for s, _ in seen] == [4, 8, 9]
    for s, b in seen:
        np.testing.assert_array_equal(b, run_np(board, rule, s))
    np.testing.assert_array_equal(out, run_np(board, rule, 9))


@pytest.fixture
def reference_dir(tmp_path):
    with gzip.open(FIXTURES / "reference_data.txt.gz", "rb") as f:
        (tmp_path / "data.txt").write_bytes(f.read())
    shutil.copy(FIXTURES / "reference_grid_size_data.txt", tmp_path / "grid_size_data.txt")
    return tmp_path


@pytest.mark.parametrize("n", [1, 3, 4, 7])
def test_cli_reference_contract_golden_on_n_cpu_shards(reference_dir, n):
    out = reference_dir / f"out_{n}.txt"
    rc = cli.main(["run", "--config-file", str(reference_dir / "grid_size_data.txt"),
                   "--input-file", str(reference_dir / "data.txt"), "--backend", "sharded",
                   "--device", "cpu", "--num-devices", str(n), "--output-file", str(out)])
    assert rc == 0
    assert hashlib.sha256(out.read_bytes()).hexdigest() == GOLDEN_SHA


def test_cli_sharded_subprocess_golden(reference_dir):
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_life_torch", "run", "--backend", "sharded", "--device", "cpu",
         "--num-devices", "4", "--local-kernel", "torch"],
        cwd=reference_dir, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("Total time = ")
    raw = (reference_dir / "output.txt").read_bytes()
    assert len(raw) == 751_500 and hashlib.sha256(raw).hexdigest() == GOLDEN_SHA


def test_cli_sharded_not_ported_is_a_tidy_error(tmp_path, monkeypatch, capsys):
    from tpu_life_torch.io.codec import write_board, write_config

    write_board(tmp_path / "data.txt", np.zeros((8, 8), np.int8))
    write_config(tmp_path / "grid_size_data.txt", 8, 8, 2)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["tpu_life_torch", "run", "--backend", "sharded", "--device",
                                      "cpu", "--mesh-shape", "2,2", "--rule", "ising"])
    assert cli.console_main() == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and "not yet ported" in err[0] and "ROADMAP" in err[0]
