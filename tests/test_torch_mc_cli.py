"""The stochastic tier through ``python -m tpu_life_torch`` on the CPU,
byte for byte against ``python -m tpu_life run ... --backend numpy``:
``run --rule ising --temperature`` on the reference workload (packed and
``--no-bitpack``, chunked by ``--sync-every``, resumed from a snapshot of
either package), ``run --rule noisy:`` on a seeded board, the run record's
seed and temperature, the typed refusals, ``info`` and the keys of ``bench
--mc``'s record against ``bench.py --mc``'s."""

import argparse
import gzip
import importlib.util
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from tpu_life import cli as jcli
from tpu_life_torch import cli, interop
from tpu_life_torch.config import RunConfig
from tpu_life_torch.mc import ising, packed
from tpu_life_torch.runtime import driver

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures"
HOT = ["--rule", "ising", "--temperature", "2.27"]


@pytest.fixture
def reference_dir(tmp_path):
    with gzip.open(FIXTURES / "reference_data.txt.gz", "rb") as f:
        (tmp_path / "data.txt").write_bytes(f.read())
    shutil.copy(FIXTURES / "reference_grid_size_data.txt", tmp_path / "grid_size_data.txt")
    return tmp_path


def files(d: Path) -> list[str]:
    return ["--config-file", str(d / "grid_size_data.txt"), "--input-file", str(d / "data.txt")]


@pytest.fixture
def jax_reference_ising(reference_dir):
    """The JAX package's numpy run of 5 sweeps on the reference workload."""
    assert jcli.main(["run", *files(reference_dir), *HOT, "--steps", "5", "--seed", "4",
                      "--backend", "numpy", "--output-file", str(reference_dir / "jax.txt")]) == 0
    return (reference_dir / "jax.txt").read_bytes()


@pytest.mark.parametrize("sync_every", ["0", "2"])
@pytest.mark.parametrize("flags", [[], ["--no-bitpack"], ["--backend", "torch"], ["--backend", "numpy"]])
def test_run_ising_reference_workload_equals_jax(reference_dir, jax_reference_ising, flags,
                                                 sync_every):
    out = reference_dir / "port.txt"
    assert cli.main(["run", *files(reference_dir), *HOT, "--steps", "5", "--seed", "4",
                     "--device", "cpu", *flags, "--sync-every", sync_every,
                     "--output-file", str(out)]) == 0
    assert out.read_bytes() == jax_reference_ising


def test_run_ising_resumed_from_a_snapshot_equals_jax(reference_dir, jax_reference_ising):
    snaps = reference_dir / "snaps"
    base = ["run", *files(reference_dir), *HOT, "--steps", "5", "--seed", "4", "--device", "cpu"]
    assert cli.main([*base, "--snapshot-every", "2", "--snapshot-dir", str(snaps),
                     "--output-file", str(reference_dir / "a.txt")]) == 0
    assert cli.main([*base, "--resume", str(snaps / "board_000000002.txt"),
                     "--output-file", str(reference_dir / "b.txt")]) == 0
    assert (reference_dir / "a.txt").read_bytes() == jax_reference_ising
    assert (reference_dir / "b.txt").read_bytes() == jax_reference_ising


@pytest.mark.parametrize("bitpack", [True, False])
def test_a_jax_snapshot_resumed_by_the_port(tmp_path, bitpack):
    args = [*HOT, "--size", "40", "--steps", "9", "--seed", "12",
            "--input-file", str(tmp_path / "absent.txt"), "--config-file", str(tmp_path / "absent_cfg.txt")]
    assert jcli.main(["run", *args, "--backend", "numpy", "--snapshot-every", "4",
                      "--snapshot-dir", str(tmp_path / "jsnaps"),
                      "--output-file", str(tmp_path / "jax.txt")]) == 0
    res = driver.run(RunConfig(
        height=40, width=40, steps=9, rule="ising", temperature=2.27, seed=12, device="cpu",
        bitpack=bitpack, resume=str(tmp_path / "jsnaps" / "board_000000004.txt"),
        input_file=str(tmp_path / "absent.txt"), config_file=str(tmp_path / "absent_cfg.txt"),
        output_file=str(tmp_path / "port.txt")))
    assert res.route == ("mc_packed" if bitpack else "mc_roll") and res.steps_run == 5
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()


@pytest.mark.parametrize("flags", [["--device", "cpu"], ["--backend", "torch", "--device", "cpu"],
                                   ["--backend", "numpy"]])
@pytest.mark.parametrize("sync_every", ["0", "7"])
def test_run_noisy_seeded_equals_jax(tmp_path, flags, sync_every):
    args = ["--rule", "noisy:0.01/conway", "--size", "64", "--steps", "20", "--seed", "3",
            "--input-file", str(tmp_path / "absent.txt"), "--config-file", str(tmp_path / "absent_cfg.txt")]
    assert jcli.main(["run", *args, "--backend", "numpy", "--output-file", str(tmp_path / "jax.txt")]) == 0
    assert cli.main(["run", *args, *flags, "--sync-every", sync_every,
                     "--output-file", str(tmp_path / "port.txt")]) == 0
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()


def test_run_result_stamps_seed_and_temperature(tmp_path):
    base = dict(height=10, width=10, steps=3, device="cpu", input_file=str(tmp_path / "absent.txt"),
                config_file=str(tmp_path / "absent_cfg.txt"), output_file=str(tmp_path / "out.txt"))
    res = driver.run(RunConfig(rule="ising", temperature=2.0, seed=8, **base))
    assert (res.seed, res.temperature, res.route, res.backend) == (8, 2.0, "mc_packed", "cuda")
    res = driver.run(RunConfig(rule="noisy:0.1/conway", seed=5, **base))
    assert (res.seed, res.temperature, res.route) == (5, None, "mc_noisy")
    # a stochastic rule from a file still consumed its seed: stamped
    from tpu_life_torch.io.codec import write_board, write_config

    write_board(tmp_path / "data.txt", np.zeros((10, 10), np.int8))
    write_config(tmp_path / "cfg.txt", 10, 10, 3)
    files_ = dict(input_file=str(tmp_path / "data.txt"), config_file=str(tmp_path / "cfg.txt"),
                  output_file=str(tmp_path / "o.txt"))
    assert driver.run(RunConfig(rule="ising", temperature=1.0, seed=4, device="cpu", **files_)).seed == 4
    assert driver.run(RunConfig(rule="conway", seed=4, device="cpu", **files_)).seed is None


@pytest.mark.parametrize(
    "args,match",
    [
        (["--rule", "ising"], "needs a temperature"),
        (["--rule", "conway", "--temperature", "2"], "only applies to the 'ising' rule"),
        (["--rule", "ising", "--temperature", "-1"], "finite number >= 0"),
        (["--rule", "ising", "--temperature", "2", "--width", "63"], "even lattice"),
    ],
)
def test_refusals_equal_jax(tmp_path, capsys, args, match):
    geometry = ["--height", "8", "--width", "8", "--steps", "2", "--input-file",
                str(tmp_path / "absent.txt"), "--config-file", str(tmp_path / "absent_cfg.txt")]
    with pytest.raises(ValueError, match=match) as want:
        jcli.main(["run", *geometry, *args, "--backend", "numpy"])
    with pytest.raises(ValueError, match=match) as got:
        cli.main(["run", *geometry, *args, "--device", "cpu"])
    assert str(got.value) == str(want.value)
    assert not (tmp_path / "output.txt").exists()


def test_sharded_refusal_exits_2(tmp_path, capsys):
    rc = cli.main(["run", *HOT, "--size", "8", "--steps", "2", "--input-file",
                   str(tmp_path / "absent.txt"), "--backend", "sharded", "--device", "cpu",
                   "--output-file", str(tmp_path / "o.txt")])
    err = capsys.readouterr().err
    assert rc == 2 and "key schedule is not implemented for 'sharded'" in err
    assert not (tmp_path / "o.txt").exists()


def test_info_lists_the_stochastic_rules(capsys):
    assert cli.main(["info"]) == 0
    out = capsys.readouterr().out
    rules_line = next(line for line in out.splitlines() if line.startswith("rules:"))
    assert "ising" in rules_line.split(", ") or " ising," in rules_line
    assert "noisy:<p>/<base>" in out and "not ported" not in out


def _jax_mc_record() -> dict:
    spec = importlib.util.spec_from_file_location("jax_bench", ROOT / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    args = argparse.Namespace(platform="cpu", mc_rule="ising", mc_temperature=2.27, mc_size=32,
                              mc_seed=0, backend="numpy", no_bitpack=False, mc_steps=6,
                              mc_base_steps=2, repeats=1, mc_sizes="16,32")
    return bench.run_mc_bench(args, "cpu", False)


def test_bench_mc_record_shape(capsys):
    # the keys of bench.py --mc's record (tests/test_mc_cli.py::
    # test_bench_mc_record_shape), with the run_id its emitter stamps and
    # the runner's route
    want = _jax_mc_record()
    capsys.readouterr()
    assert cli.main(["bench", "--mc", "--device", "cpu", "--mc-size", "32", "--mc-steps", "6",
                     "--mc-base-steps", "2", "--repeats", "1", "--mc-sizes", "16,32"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rec) == set(want) | {"run_id", "route"}
    assert rec["metric"] == "mc_sweeps_per_sec" and rec["unit"] == "sweeps/s"
    assert rec["value"] > 0 and rec["spin_updates_per_sec"] > 0
    assert rec["seed"] == 0 and rec["temperature"] == 2.27 and rec["rule"] == "ising"
    assert rec["run_id"] and (rec["packed"], rec["lanes"], rec["route"]) == (True, 32, "mc_packed")
    assert (rec["backend"], rec["platform"], rec["platform_pinned"]) == ("cuda", "cpu", "cpu")
    assert [(leg["size"], leg["packed"]) for leg in rec["legs"]] == [
        (leg["size"], leg["packed"]) for leg in want["legs"]]
    assert set(rec["legs"][0]) == set(want["legs"][0])
    assert set(rec["packed_speedup"]) == {"16", "32"}


def test_bench_mc_roll_and_noisy(capsys):
    assert cli.main(["bench", "--mc", "--device", "cpu", "--no-bitpack", "--mc-size", "16",
                     "--mc-steps", "4", "--mc-base-steps", "1", "--repeats", "1",
                     "--mc-sizes", "16"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (rec["packed"], rec["route"]) == (False, "mc_roll")
    assert cli.main(["bench", "--mc", "--device", "cpu", "--mc-rule", "noisy:0.1/conway",
                     "--mc-size", "16", "--mc-steps", "4", "--mc-base-steps", "1",
                     "--repeats", "1"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (rec["temperature"], rec["legs"], rec["route"]) == (None, [], "mc_noisy")
    with pytest.raises(SystemExit):
        cli.main(["bench", "--mc", "--device", "cpu", "--mc-rule", "conway"])


def test_mc_state_from_reference():
    board = np.random.default_rng(1).integers(0, 2, size=(6, 40), dtype=np.int8)
    for layout, src in (("cells", packed.pack_board(board)), ("words", board)):
        st = interop.mc_state_from_reference(src, 17, -1, 2.27, layout, width=40)
        assert st["step"] == 17 and st["keys"] == (0xFFFFFFFF, 0xFFFFFFFF)
        np.testing.assert_array_equal(st["thresholds"].numpy().view(np.uint32),
                                      ising.acceptance_thresholds(2.27))
        got = st["board"].numpy()
        want = board if layout == "cells" else packed.pack_board(board).view(np.int32)
        np.testing.assert_array_equal(got, want)
    st = interop.mc_state_from_reference(board, 0, 3, None, "cells")
    assert not st["thresholds"].any() and st["keys"] == (3, 0)
