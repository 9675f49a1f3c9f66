"""``python -m tpu_life_torch run`` end to end on the CPU: the reference
workload at its golden sha256, byte equality with ``python -m tpu_life run
--backend numpy``, and the tidy error lines."""

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

from tpu_life import cli as jcli
from tpu_life_torch import cli
from tpu_life_torch.backends import base as backends_base
from tpu_life_torch.io.codec import write_board, write_config
from tpu_life_torch.models.rules import get_rule
from tpu_life_torch.runtime import driver

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures"
# the reference workload's output.txt after 100 Conway steps (tests/test_golden.py)
GOLDEN_SHA = "ea69597f6ada6271b4b182c592f36395652fee9cf2d28a2e17c80fb5eca79215"


def port(*args, cwd, cuda_visible=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    if cuda_visible is not None:
        env["CUDA_VISIBLE_DEVICES"] = cuda_visible
    return subprocess.run(
        [sys.executable, "-m", "tpu_life_torch", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300,
    )


@pytest.fixture
def reference_dir(tmp_path):
    with gzip.open(FIXTURES / "reference_data.txt.gz", "rb") as f:
        (tmp_path / "data.txt").write_bytes(f.read())
    shutil.copy(FIXTURES / "reference_grid_size_data.txt", tmp_path / "grid_size_data.txt")
    return tmp_path


def test_reference_workload_golden_on_cpu(reference_dir):
    proc = port("run", "--device", "cpu", cwd=reference_dir)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("Total time = ")
    raw = (reference_dir / "output.txt").read_bytes()
    assert len(raw) == 751_500
    assert hashlib.sha256(raw).hexdigest() == GOLDEN_SHA


@pytest.mark.parametrize(
    "rule,backend",
    [("conway", "auto"), ("highlife", "torch"), ("brians_brain", "numpy"), ("R2,C2,S2..4,B3,NN", "numpy")],
)
def test_bytes_equal_jax_numpy_backend(tmp_path, rule, backend):
    rng = np.random.default_rng(11)
    states = 3 if rule == "brians_brain" else 2
    write_board(tmp_path / "data.txt", rng.integers(0, states, size=(37, 45), dtype=np.int8))
    write_config(tmp_path / "grid_size_data.txt", 37, 45, 23)
    files = ["--config-file", str(tmp_path / "grid_size_data.txt"),
             "--input-file", str(tmp_path / "data.txt")]
    assert jcli.main(["run", *files, "--rule", rule, "--backend", "numpy",
                      "--output-file", str(tmp_path / "jax.txt")]) == 0
    assert cli.main(["run", *files, "--rule", rule, "--backend", backend, "--device", "cpu",
                     "--block-steps", "5", "--sync-every", "10",
                     "--output-file", str(tmp_path / "port.txt")]) == 0
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()


def test_no_bitpack_reference_run_is_golden_and_equals_jax_numpy(reference_dir):
    # the reference contract through the int8 path (kernel K2's plain
    # version on the CPU): the same bytes as the bit-sliced path
    files = ["--config-file", str(reference_dir / "grid_size_data.txt"),
             "--input-file", str(reference_dir / "data.txt")]
    assert cli.main(["run", *files, "--device", "cpu", "--no-bitpack",
                     "--output-file", str(reference_dir / "port.txt")]) == 0
    assert jcli.main(["run", *files, "--backend", "numpy",
                      "--output-file", str(reference_dir / "jax.txt")]) == 0
    raw = (reference_dir / "port.txt").read_bytes()
    assert hashlib.sha256(raw).hexdigest() == GOLDEN_SHA
    assert raw == (reference_dir / "jax.txt").read_bytes()


@pytest.mark.parametrize(
    "rule,extra",
    [("bugs_decay", []), ("star_wars", ["--block-steps", "3"]), ("R2,C2,M1,S5..10,B5..8", []),
     ("highlife", ["--no-bitpack"])],
)
def test_int8_rules_bytes_equal_jax_numpy_backend(tmp_path, rule, extra):
    # a multi-state board through `run --device cpu` (the cuda backend's
    # int8 route) against `python -m tpu_life run --backend numpy`
    states = get_rule(rule).states
    rng = np.random.default_rng(12)
    board = rng.integers(0, states, size=(41, 53), dtype=np.int8) * rng.integers(
        0, 2, size=(41, 53), dtype=np.int8
    )
    write_board(tmp_path / "data.txt", board)
    write_config(tmp_path / "grid_size_data.txt", 41, 53, 9)
    files = ["--config-file", str(tmp_path / "grid_size_data.txt"),
             "--input-file", str(tmp_path / "data.txt"), "--rule", rule]
    assert jcli.main(["run", *files, "--backend", "numpy",
                      "--output-file", str(tmp_path / "jax.txt")]) == 0
    assert cli.main(["run", *files, "--device", "cpu", *extra, "--sync-every", "4",
                     "--output-file", str(tmp_path / "port.txt")]) == 0
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()


def test_no_bitpack_flag_reaches_the_backend(tmp_path, monkeypatch):
    seen = []
    real = backends_base.get_backend

    def recording(name, **kw):
        seen.append(kw.get("bitpack"))
        return real(name, **kw)

    monkeypatch.setattr(driver, "get_backend", recording)
    write_board(tmp_path / "data.txt", np.zeros((8, 8), np.int8))
    write_config(tmp_path / "grid_size_data.txt", 8, 8, 2)
    files = ["--config-file", str(tmp_path / "grid_size_data.txt"),
             "--input-file", str(tmp_path / "data.txt"), "--device", "cpu",
             "--output-file", str(tmp_path / "o.txt")]
    assert cli.main(["run", *files]) == 0
    assert cli.main(["run", *files, "--no-bitpack"]) == 0
    assert seen == [True, False]


def test_jax_output_is_a_valid_port_input(tmp_path, reference_dir):
    # chain: 40 steps in the JAX package, then 60 in the port == 100 steps
    assert jcli.main(["run", "--config-file", str(reference_dir / "grid_size_data.txt"),
                      "--input-file", str(reference_dir / "data.txt"), "--steps", "40",
                      "--backend", "numpy", "--output-file", str(tmp_path / "mid.txt")]) == 0
    rc = cli.main(["run", "--config-file", str(reference_dir / "grid_size_data.txt"),
                   "--input-file", str(tmp_path / "mid.txt"), "--steps", "60",
                   "--device", "cpu", "--output-file", str(tmp_path / "out.txt")])
    assert rc == 0
    assert hashlib.sha256((tmp_path / "out.txt").read_bytes()).hexdigest() == GOLDEN_SHA


@pytest.mark.parametrize(
    "args,match",
    [
        (["--rule", "B9x/S"], "unrecognized rule spec"),
        (["--rule", "ising"], "needs a temperature"),
        (["--config-file", "missing.txt"], "config file 'missing.txt' not found"),
        (["--rule", "noisy:0.1/conway:T", "--device", "cpu", "--temperature", "2"],
         "temperature only applies to the 'ising' rule"),
        ([], "pass --device cpu"),
    ],
)
def test_tidy_error_lines(tmp_path, monkeypatch, capsys, args, match):
    write_board(tmp_path / "data.txt", np.zeros((8, 8), np.int8))
    write_config(tmp_path / "grid_size_data.txt", 8, 8, 2)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["tpu_life_torch", "run", *args])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.console_main() == 1
    lines = capsys.readouterr().err.strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith("tpu_life_torch: error: "), lines
    assert match in lines[0]
    assert not (tmp_path / "output.txt").exists()


@pytest.mark.parametrize("backend", ["cuda", "sharded"])
@pytest.mark.parametrize("rule", ["conway", "conway:T"])
def test_block_steps_past_the_kernels_clamp_writes_the_numpy_bytes(tmp_path, backend, rule):
    # --block-steps 40 is clamped to what the kernels take, as the JAX
    # package clamps it, and the run writes the numpy backend's bytes
    write_board(tmp_path / "data.txt", np.random.default_rng(13).integers(0, 2, size=(40, 50), dtype=np.int8))
    write_config(tmp_path / "grid_size_data.txt", 40, 50, 20)
    files = ["--config-file", str(tmp_path / "grid_size_data.txt"),
             "--input-file", str(tmp_path / "data.txt"), "--rule", rule]
    assert jcli.main(["run", *files, "--backend", "numpy",
                      "--output-file", str(tmp_path / "jax.txt")]) == 0
    assert cli.main(["run", *files, "--backend", backend, "--device", "cpu", "--block-steps", "40",
                     "--output-file", str(tmp_path / "port.txt")]) == 0
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()


@pytest.mark.parametrize("bitpack", [[], ["--no-bitpack"]])
def test_mesh_shape_reference_run_is_golden(reference_dir, bitpack):
    # 2x2 CPU shards: route k4 (K4's plain version) with --no-bitpack, the
    # packed shard_ops without
    out = reference_dir / "out.txt"
    assert cli.main(["run", "--config-file", str(reference_dir / "grid_size_data.txt"),
                     "--input-file", str(reference_dir / "data.txt"), "--backend", "sharded",
                     "--device", "cpu", "--mesh-shape", "2,2", *bitpack,
                     "--output-file", str(out)]) == 0
    raw = out.read_bytes()
    assert len(raw) == 751_500 and hashlib.sha256(raw).hexdigest() == GOLDEN_SHA


def test_mesh_shape_reaches_the_backend(tmp_path, monkeypatch):
    seen = []
    real = driver.run

    def recording(cfg):
        seen.append(real(cfg).route)
        return seen[-1]

    monkeypatch.setattr(driver, "run", recording)
    write_board(tmp_path / "data.txt", np.zeros((8, 8), np.int8))
    write_config(tmp_path / "grid_size_data.txt", 8, 8, 2)
    files = ["--config-file", str(tmp_path / "grid_size_data.txt"),
             "--input-file", str(tmp_path / "data.txt"), "--device", "cpu", "--backend",
             "sharded", "--output-file", str(tmp_path / "o.txt")]
    assert cli.main(["run", *files, "--mesh-shape", "2,2", "--rule", "brians_brain"]) == 0
    assert cli.main(["run", *files, "--mesh-shape", "1,2"]) == 0
    assert cli.main(["run", *files, "--mesh-shape", "2,1"]) == 0
    assert seen == ["k4", "shard_ops", "k3"]


@pytest.mark.parametrize(
    "args,match",
    [
        (["--mesh-shape", "2,2", "--num-devices", "3"], "mesh_shape (2, 2) (4 devices) contradicts num_devices=3"),
        (["--mesh-shape", "2,2", "--local-kernel", "cuda", "--rule", "conway:T"], "full-width stripes only"),
        (["--mesh-shape", "2,2", "--rule", "conway:T"], "divisible by 32"),
    ],
)
def test_mesh_shape_errors_are_tidy_lines(tmp_path, monkeypatch, capsys, args, match):
    write_board(tmp_path / "data.txt", np.zeros((8, 8), np.int8))
    write_config(tmp_path / "grid_size_data.txt", 8, 8, 2)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["tpu_life_torch", "run", "--backend", "sharded", "--device", "cpu",
                                      *args])
    assert cli.console_main() == 1
    lines = capsys.readouterr().err.strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith("tpu_life_torch: error: "), lines
    assert match in lines[0]
    assert not (tmp_path / "output.txt").exists()


@pytest.mark.parametrize("spec", ["2", "2,x", "0,2", "1,2,3"])
def test_malformed_mesh_shape_is_a_usage_error(spec, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["run", "--mesh-shape", spec])
    assert e.value.code == 2
    assert "--mesh-shape must be two positive ints 'R,C'" in capsys.readouterr().err


def test_no_card_error_from_the_module_entry_point(tmp_path):
    write_board(tmp_path / "data.txt", np.zeros((8, 8), np.int8))
    write_config(tmp_path / "grid_size_data.txt", 8, 8, 2)
    proc = port("run", cwd=tmp_path, cuda_visible="")
    assert proc.returncode == 1
    assert proc.stderr.strip() == (
        "tpu_life_torch: error: no CUDA device is available; pass --device cpu "
        "to run the plain PyTorch version on the CPU, or --backend numpy"
    )
    assert proc.stdout == ""


def test_geometry_error_exits_2(tmp_path, capsys):
    write_board(tmp_path / "data.txt", np.zeros((5, 5), np.int8))
    rc = cli.main(["run", "--input-file", str(tmp_path / "data.txt"), "--height", "5",
                   "--width", "5", "--steps", "1", "--rule", "bugs", "--backend", "numpy",
                   "--output-file", str(tmp_path / "o.txt")])
    assert rc == 2
    assert "kernel diameter" in capsys.readouterr().err


def test_info_lists_backends_and_rules(capsys):
    assert cli.main(["info"]) == 0
    out = capsys.readouterr().out
    # the host backends are listed too, whatever was imported before
    assert "backends: cuda, mpi, native, numpy, sharded, stripes, torch" in out
    assert "conway" in out and "torch " in out
    assert "route k4 (K4 per shard)" in out and "--mesh-shape R,C" in out
