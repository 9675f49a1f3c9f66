"""Streamed per-shard I/O of the port's sharded backend (``--stream-io``),
held to the numpy oracle and to the JAX package's streamed runs of the
same boards (``tests/test_streaming.py`` on the port).

The port's shards live on the CPU (``device="cpu"``), so K3's and K4's
plain versions step them; the JAX package runs as its own tests run it,
on the 8 fake CPU devices of ``tests/conftest.py``.  Boards come from
``np.random.default_rng`` or the JAX package's ``random_board``; every
comparison is of exact bytes.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from tpu_life import cli as jcli
from tpu_life.backends.sharded_backend import ShardedBackend as JaxShardedBackend
from tpu_life.models.patterns import random_board
from tpu_life.models.rules import get_rule as jget_rule
from tpu_life_torch import cli
from tpu_life_torch.backends import torch_backend
from tpu_life_torch.backends.sharded_backend import ShardedBackend
from tpu_life_torch.config import RunConfig
from tpu_life_torch.io import sharded as io_sharded
from tpu_life_torch.io.codec import encode_board, write_board, write_config
from tpu_life_torch.models.rules import get_rule
from tpu_life_torch.ops.reference import run_np
from tpu_life_torch.runtime import driver

H, W, STEPS = 100, 67, 10
# (mesh flags of the port's backend, of the JAX one), 1-D and 2-D
MESHES = {"rows4": (dict(num_devices=4), dict(num_devices=4)),
          "2x2": (dict(mesh_shape=(2, 2)), dict(mesh_shape=(2, 2)))}
CPU4 = ["--backend", "sharded", "--device", "cpu", "--num-devices", "4"]


@pytest.fixture
def workload(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    board = random_board(H, W, seed=31)
    write_board(tmp_path / "data.txt", board)
    write_config(tmp_path / "grid_size_data.txt", H, W, STEPS)
    return tmp_path, board


def _truth(board, rule="conway", steps=STEPS) -> bytes:
    return encode_board(run_np(board, get_rule(rule), steps))


def _jax_streamed(path, out, rule, bitpack, **mesh):
    be = JaxShardedBackend(bitpack=bitpack, **mesh)
    jrule = jget_rule(rule)
    runner = be.prepare_from_file(path, H, W, jrule)
    runner.advance(STEPS)
    be.write_runner_to_file(runner, out, H, W, jrule)
    return out.read_bytes()


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("bitpack", [True, False])
@pytest.mark.parametrize("rule", ["conway", "brians_brain"])
def test_streamed_run_matches_truth_and_jax(workload, mesh, bitpack, rule):
    tmp, board = workload
    if get_rule(rule).states > 2:
        board = (board * np.random.default_rng(3).integers(1, 3, board.shape)).astype(np.int8)
        write_board(tmp / "data.txt", board)
    port_mesh, jax_mesh = MESHES[mesh]
    be = ShardedBackend(device="cpu", bitpack=bitpack, **port_mesh)
    runner = be.prepare_from_file(tmp / "data.txt", H, W, get_rule(rule))
    runner.advance(STEPS)
    be.write_runner_to_file(runner, tmp / "streamed.txt", H, W, get_rule(rule))
    got = (tmp / "streamed.txt").read_bytes()
    assert len(got) == H * (W + 1)
    assert got == _truth(board, rule, STEPS)
    assert got == _jax_streamed(tmp / "data.txt", tmp / "jax.txt", rule, bitpack, **jax_mesh)
    # the kernels' plain versions stepped the shards
    want = "k4" if (not bitpack or rule != "conway") else ("k3" if mesh == "rows4" else "shard_ops")
    assert runner.route == want


@pytest.mark.parametrize("flags", [CPU4, CPU4[:4] + ["--mesh-shape", "2,2", "--no-bitpack"],
                                   CPU4[:4] + ["--mesh-shape", "2,2"]],
                         ids=["rows4", "2x2-int8", "2x2-packed"])
def test_cli_stream_io_flag(workload, flags):
    tmp, board = workload
    assert cli.main(["run", *flags, "--stream-io", "--output-file", "out_stream.txt"]) == 0
    assert (tmp / "out_stream.txt").read_bytes() == _truth(board)


def test_streamed_result_has_no_board_and_a_streamed_output_span(workload):
    tmp, board = workload
    res = driver.run(RunConfig(backend="sharded", device="cpu", num_devices=4, stream_io=True,
                               output_file="out.txt", trace_events="t.json"))
    assert res.board is None and res.route == "k3" and res.steps_run == STEPS
    assert (tmp / "out.txt").read_bytes() == _truth(board)
    spans = [e for e in json.loads((tmp / "t.json").read_text())["traceEvents"] if e.get("ph") == "B"]
    names = [e["name"] for e in spans]
    assert "gather" not in names and "stage" in names
    assert [e["args"]["streamed"] for e in spans if e["name"] == "output-write"] == [True]


def test_cli_stream_io_resume(workload):
    tmp, board = workload
    assert cli.main(["run", *CPU4, "--stream-io", "--snapshot-every", "4",
                     "--output-file", "out_a.txt"]) == 0
    assert sorted(p.name for p in (tmp / "snapshots").glob("*.txt")) == [
        "board_000000004.txt", "board_000000008.txt"]
    assert cli.main(["run", *CPU4, "--stream-io", "--resume", "snapshots",
                     "--output-file", "out_b.txt"]) == 0
    assert (tmp / "out_b.txt").read_bytes() == (tmp / "out_a.txt").read_bytes() == _truth(board)


@pytest.mark.parametrize("backend", ["numpy", "torch", "cuda"])
def test_stream_io_rejects_non_sharded(workload, backend):
    with pytest.raises(ValueError, match="stream-io"):
        cli.main(["run", "--backend", backend, "--device", "cpu", "--stream-io"])


def test_stream_io_without_output_rejected(workload):
    with pytest.raises(ValueError, match="stream_io"):
        driver.run(RunConfig(backend="sharded", device="cpu", stream_io=True, output_file=""))


def test_stream_io_of_a_seeded_board_rejected(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="input file to stream from"):
        driver.run(RunConfig(backend="sharded", device="cpu", stream_io=True, height=16,
                             width=16, steps=2, input_file="absent.txt"))


@pytest.mark.parametrize("mesh", [(2, 2), (3, 2), (1, 3)])
@pytest.mark.parametrize("bitpack", [True, False])
def test_2d_stream_loader_reads_each_cell_once(workload, mesh, bitpack, monkeypatch):
    # the loader asks for exactly its own cells: no full-width re-reads per
    # column shard, and the padding shards read nothing
    tmp, board = workload
    read_cells = [0]
    orig = io_sharded.read_block

    def counting_read_block(path, r0, nr, c0, nc, width):
        read_cells[0] += nr * nc
        return orig(path, r0, nr, c0, nc, width)

    monkeypatch.setattr(io_sharded, "read_block", counting_read_block)
    be = ShardedBackend(device="cpu", mesh_shape=mesh, bitpack=bitpack)
    runner = be.prepare_from_file(tmp / "data.txt", H, W, get_rule("conway"))
    assert read_cells[0] == H * W
    np.testing.assert_array_equal(runner.fetch(), board)


@pytest.mark.parametrize("mesh", [dict(num_devices=1), dict(num_devices=4), dict(mesh_shape=(2, 2))])
def test_state_validation_inside_stripe_loader(tmp_path, mesh):
    bad = np.zeros((16, 40), dtype=np.int8)
    bad[13, 37] = 3  # state 3 under a 2-state rule, in the last shard
    write_board(tmp_path / "bad.txt", bad)
    be = ShardedBackend(device="cpu", **mesh)
    with pytest.raises(ValueError, match="state 3"):
        be.prepare_from_file(tmp_path / "bad.txt", 16, 40, get_rule("conway"))


def test_prepare_and_the_block_loader_build_the_same_chunks(workload):
    # prepare(board) is the in-memory loader over the same code as the file
    # loader, so the two staging paths cannot drift
    tmp, board = workload
    for kwargs in (dict(num_devices=3), dict(mesh_shape=(2, 3)), dict(mesh_shape=(2, 2), bitpack=False)):
        be = ShardedBackend(device="cpu", **kwargs)
        rule = get_rule("conway")
        a = be.prepare(board, rule)
        b = be.prepare_from_file(tmp / "data.txt", H, W, rule)
        c = be.prepare_from_blocks(lambda r0, r1, c0, c1: board[r0:r1, c0:c1], H, W, rule)
        for x, y, z in zip(a.chunks, b.chunks, c.chunks):
            assert x.dtype == y.dtype and bool((x == y).all()) and bool((x == z).all())


@pytest.mark.parametrize("cells,streamed", [(H * W, True), (H * W + 1, False)])
def test_auto_stream_decision_at_the_threshold(workload, monkeypatch, cells, streamed):
    tmp, board = workload
    monkeypatch.setattr(driver, "_STREAM_AUTO_CELLS", cells)
    res = driver.run(RunConfig(backend="sharded", device="cpu", num_devices=4, output_file="out.txt"))
    assert (res.board is None) == streamed
    assert (tmp / "out.txt").read_bytes() == _truth(board)


@pytest.mark.parametrize("case", ["no_output", "numpy", "no_stream_flag", "seeded"])
def test_auto_stream_only_where_it_can(workload, monkeypatch, case):
    # auto never streams without an output file, off the sharded backend,
    # against --no-stream-io, or for a seeded board
    tmp, board = workload
    monkeypatch.setattr(driver, "_STREAM_AUTO_CELLS", 1)
    cfg = dict(backend="sharded", device="cpu", num_devices=4, output_file="out.txt")
    if case == "no_output":
        cfg["output_file"] = ""
    elif case == "numpy":
        cfg = dict(backend="numpy", output_file="out.txt")
    elif case == "no_stream_flag":
        cfg["stream_io"] = False
    else:
        cfg.update(height=H, width=W, steps=STEPS, input_file="absent.txt")
    res = driver.run(RunConfig(**cfg))
    assert res.board is not None


def test_streamed_run_never_gathers(workload, monkeypatch):
    tmp, board = workload

    def no_gather(self, chunks=None):
        raise AssertionError("a streamed run gathered its board")

    monkeypatch.setattr(torch_backend.ShardedRunner, "gather", no_gather)
    res = driver.run(RunConfig(backend="sharded", device="cpu", mesh_shape=(2, 2), stream_io=True,
                               output_file="out.txt", snapshot_every=4, sync_every=2,
                               metrics=True))
    assert (tmp / "out.txt").read_bytes() == _truth(board)
    # the live counts come from the per-shard reduction
    b, want = board, []
    for step in range(2, STEPS + 1, 2):
        b = run_np(b, get_rule("conway"), 2)
        want.append((step, int(np.count_nonzero(b == 1))))
    assert [(r["step"], r["live_cells"]) for r in res.metrics] == want


@pytest.mark.parametrize("mesh", [["--num-devices", "4"], ["--mesh-shape", "2,2"]], ids=["rows4", "2x2"])
def test_streamed_snapshots_equal_jax_and_resume_across_packages(workload, mesh):
    tmp, board = workload
    flags = ["--backend", "sharded", *mesh, "--stream-io", "--snapshot-every", "4"]
    assert jcli.main(["run", *flags, "--snapshot-dir", "jsnaps", "--output-file", "jout.txt"]) == 0
    assert cli.main(["run", *flags, "--device", "cpu", "--snapshot-dir", "psnaps",
                     "--output-file", "pout.txt"]) == 0
    files = {p.name: p.read_bytes() for p in sorted((tmp / "psnaps").iterdir())}
    assert sorted(files) == [f"board_00000000{s}.{x}" for s in (4, 8) for x in ("json", "txt")]
    assert files == {p.name: p.read_bytes() for p in sorted((tmp / "jsnaps").iterdir())}
    assert (tmp / "pout.txt").read_bytes() == (tmp / "jout.txt").read_bytes() == _truth(board)
    # each package resumes the other's step-4 snapshot, streamed
    assert cli.main(["run", *flags, "--device", "cpu", "--resume", "jsnaps/board_000000004.txt",
                     "--snapshot-dir", "p2", "--output-file", "p_from_j.txt"]) == 0
    assert jcli.main(["run", *flags, "--resume", "psnaps/board_000000004.txt",
                      "--snapshot-dir", "j2", "--output-file", "j_from_p.txt"]) == 0
    assert (tmp / "p_from_j.txt").read_bytes() == (tmp / "j_from_p.txt").read_bytes() == _truth(board)


def test_streamed_recovery_drill_equals_a_clean_run(workload):
    tmp, board = workload
    assert cli.main(["run", *CPU4, "--stream-io", "--steps", "40", "--snapshot-every", "10",
                     "--sync-every", "10", "--fault-at", "25", "--fault-count", "2",
                     "--max-restarts", "2", "--output-file", "drill.txt"]) == 0
    assert (tmp / "drill.txt").read_bytes() == _truth(board, steps=40)


@pytest.mark.parametrize("rule,flags", [("conway:T", ["--num-devices", "4"]),
                                        ("conway:T", ["--mesh-shape", "2,2"]),
                                        ("brians_brain:T", ["--num-devices", "4"])])
def test_streamed_torus_matches_truth(tmp_path, monkeypatch, rule, flags):
    monkeypatch.chdir(tmp_path)
    board = np.random.default_rng(8).integers(0, 2, (64, 128)).astype(np.int8)
    write_board(tmp_path / "data.txt", board)
    write_config(tmp_path / "grid_size_data.txt", 64, 128, 12)
    assert cli.main(["run", "--backend", "sharded", "--device", "cpu", *flags, "--rule", rule,
                     "--stream-io", "--output-file", "out.txt"]) == 0
    assert (tmp_path / "out.txt").read_bytes() == _truth(board, rule, 12)


def test_streamed_continuous_rule_refused_and_never_auto_streamed(tmp_path, monkeypatch):
    # the JAX streamed path reads and writes digit boards only (a float32
    # file fails its row decoding); the port refuses by name, and auto keeps
    # a continuous rule's board whole
    monkeypatch.chdir(tmp_path)
    args = ["run", "--backend", "sharded", "--device", "cpu", "--num-devices", "2", "--rule",
            "lenia:mini", "--size", "64", "--steps", "2", "--seed", "1"]
    assert cli.main([*args, "--input-file", "absent.txt", "--output-file", "f.txt"]) == 0
    with pytest.raises(ValueError, match="digit boards only"):
        cli.main([*args, "--input-file", "f.txt", "--stream-io", "--output-file", "g.txt"])
    monkeypatch.setattr(driver, "_STREAM_AUTO_CELLS", 1)
    res = driver.run(RunConfig(backend="sharded", device="cpu", num_devices=2, rule="lenia:mini",
                               height=64, width=64, steps=2, input_file="f.txt",
                               output_file="h.txt"))
    assert res.board is not None and res.board.dtype == np.float32


def test_streamed_output_is_published_atomically(workload, monkeypatch):
    # a failed streamed write leaves no partial output.txt behind
    tmp, board = workload
    calls = []

    def failing_write_block(path, *a, **k):
        calls.append(Path(path).name)
        raise OSError("disk full")

    monkeypatch.setattr(io_sharded, "write_block", failing_write_block)
    with pytest.raises(OSError, match="disk full"):
        driver.run(RunConfig(backend="sharded", device="cpu", num_devices=4, stream_io=True,
                             output_file="out.txt"))
    assert calls and "out.txt" not in calls and not (tmp / "out.txt").exists()
