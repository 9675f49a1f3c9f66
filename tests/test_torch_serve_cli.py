"""``python -m tpu_life_torch submit`` / ``serve`` against the JAX package's.

``submit`` must write the JAX package's spool lines; ``serve`` on one
spool must write the same result files as ``python -m tpu_life serve
--serve-backend numpy`` (Lenia boards ``allclose`` at ``FLOAT_ATOL``), and
print a summary line with the same keys and the same values apart from
the timings and the backend's name.  Exit codes: 0 when every request is
done, 1 when one failed, 2 for what the port does not serve (a stochastic
request on ``sharded``, the queued backends).  Both CLIs run in process on
the CPU; boards come from ``np.random.default_rng``.
"""

import json

import numpy as np
import pytest

from tpu_life import cli as jcli
from tpu_life.io.codec import read_board, write_board, write_config
from tpu_life_torch import cli
from tpu_life_torch.models import lenia

#: summary keys whose values are timings (or name the backend)
TIMED = {"run_id", "backend", "device_idle_s", "elapsed_s", "sessions_per_sec", "queue_wait_p50",
         "queue_wait_p95", "completion_p50"}


@pytest.fixture
def spool(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    write_config(tmp_path / "grid_size_data.txt", 20, 45, 8)
    rng = np.random.default_rng(5)
    write_board(tmp_path / "a.txt", (rng.random((20, 45)) < 0.4).astype(np.int8))
    write_board(tmp_path / "b.txt", rng.integers(0, 3, (20, 45)).astype(np.int8))
    return tmp_path


def summary(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


SUBMITS = [
    ["--input-file", "a.txt"],
    ["--input-file", "a.txt", "--steps", "13", "--rule", "highlife", "--output-file", "h.txt"],
    ["--input-file", "b.txt", "--rule", "brians_brain", "--steps", "11", "--id", "bb"],
    ["--input-file", "a.txt", "--rule", "conway:T", "--steps", "9", "--timeout", "60"],
    ["--input-file", "a.txt", "--rule", "R2,C2,S2..4,B2..3,NN", "--steps", "14"],
    ["--size", "33", "--steps", "17", "--seed", "5", "--input-file", "absent.txt"],
    ["--height", "24", "--width", "40", "--steps", "9", "--seed", "2", "--rule", "lenia:mini",
     "--input-file", "absent.txt"],
]


def test_submit_writes_the_jax_spool_lines(spool, capsys):
    for args in SUBMITS:
        assert cli.main(["submit", "--requests", "port.jsonl", *args]) == 0
        port = capsys.readouterr().out
        assert jcli.main(["submit", "--requests", "jax.jsonl", *args]) == 0
        assert port.replace("port.jsonl", "jax.jsonl") == capsys.readouterr().out
    assert (spool / "port.jsonl").read_text() == (spool / "jax.jsonl").read_text()


@pytest.mark.parametrize("backend", ["cuda", "numpy", "sharded"])
@pytest.mark.parametrize("pump", [[], ["--sync-pump"]], ids=["pipelined", "sync"])
def test_serve_writes_the_jax_numpy_result_files(spool, capsys, backend, pump):
    for args in SUBMITS:
        cli.main(["submit", *args])
    capsys.readouterr()
    common = ["--capacity", "2", "--chunk-steps", "5", *pump]
    assert jcli.main(["serve", "--serve-backend", "numpy", "--output-dir", "jax", *common]) == 0
    want = summary(capsys)
    assert cli.main(["serve", "--serve-backend", backend, "--device", "cpu", "--output-dir",
                     "port", *common]) == 0
    got = summary(capsys)
    assert list(got) == list(want)
    assert {k: v for k, v in got.items() if k not in TIMED} == {
        k: v for k, v in want.items() if k not in TIMED}
    assert got["backend"] == backend
    files = sorted(p.name for p in (spool / "jax").iterdir())
    assert files == sorted(p.name for p in (spool / "port").iterdir()) and len(files) == 6
    for name in files:
        if name == "s000006.txt":  # lenia:mini: float32 boards
            a = read_board(spool / "port" / name, 24, 40)
            b = read_board(spool / "jax" / name, 24, 40)
            assert a.dtype == b.dtype == np.float32
            assert np.allclose(a, b, atol=lenia.FLOAT_ATOL, rtol=0)
        else:
            assert (spool / "port" / name).read_bytes() == (spool / "jax" / name).read_bytes()
    assert (spool / "h.txt").exists()


def test_serve_exits_1_when_a_request_fails(spool, capsys):
    cli.main(["submit", "--input-file", "a.txt"])
    cli.main(["submit", "--input-file", "a.txt", "--steps", "5000", "--timeout", "0.000001",
              "--id", "late"])
    capsys.readouterr()
    assert cli.main(["serve", "--device", "cpu", "--capacity", "1", "--chunk-steps", "2"]) == 1
    got = summary(capsys)
    assert got["done"] == 1 and got["failed"] == 1
    (failure,) = got["failures"]
    assert failure["id"] == "late" and "SessionTimeout" in failure["error"]


@pytest.mark.parametrize("extra", [["--rule", "ising", "--temperature", "2.0"],
                                   ["--rule", "noisy:0.01/conway"]])
def test_serve_exits_2_on_a_stochastic_request(spool, capsys, extra):
    # on sharded, which has no counter-based key schedule; cuda serves it
    # (K6's or K7's batch mode's plain version on the CPU) and writes the
    # JAX numpy serve's bytes
    cli.main(["submit", "--input-file", "a.txt"])
    cli.main(["submit", "--size", "16", "--steps", "9", "--seed", "3", "--input-file",
              "absent.txt", *extra])
    capsys.readouterr()
    assert cli.main(["serve", "--serve-backend", "sharded", "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "key schedule" in err and "'sharded'" in err
    assert not (spool / "serve_out").exists()
    common = ["--capacity", "2", "--chunk-steps", "4"]
    assert jcli.main(["serve", "--serve-backend", "numpy", "--output-dir", "jax", *common]) == 0
    want = summary(capsys)
    assert cli.main(["serve", "--device", "cpu", "--output-dir", "port", *common]) == 0
    got = summary(capsys)
    assert {k: v for k, v in got.items() if k not in TIMED} == {
        k: v for k, v in want.items() if k not in TIMED}
    for name in ("s000000.txt", "s000001.txt"):
        assert (spool / "port" / name).read_bytes() == (spool / "jax" / name).read_bytes()


@pytest.mark.parametrize("backend,item", [("tuned", "A10"), ("stripes", "A11"), ("native", "A11")])
def test_serve_exits_2_on_a_queued_backend(spool, capsys, backend, item, tmp_path, monkeypatch):
    # every one of these is ported now (the autotuner, A10; the host
    # backends, A11): each serves the spool with the numpy oracle's bytes
    cli.main(["submit", "--input-file", "a.txt"])
    capsys.readouterr()
    monkeypatch.setenv("TPU_LIFE_TORCH_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    assert jcli.main(["serve", "--serve-backend", "numpy", "--output-dir", "jax"]) == 0
    capsys.readouterr()
    assert cli.main(["serve", "--serve-backend", backend, "--device", "cpu",
                     "--output-dir", "port"]) == 0
    assert "ROADMAP" not in capsys.readouterr().err
    assert (spool / "port" / "s000000.txt").read_bytes() == (
        spool / "jax" / "s000000.txt").read_bytes()


def test_serve_without_a_spool_is_a_tidy_error(spool, capsys, monkeypatch):
    monkeypatch.setattr("sys.argv", ["tpu_life_torch", "serve", "--requests", "none.jsonl"])
    assert cli.console_main() == 1
    assert "not found" in capsys.readouterr().err


def test_serve_mesh_tier_through_the_cli(spool, capsys):
    # a board the budget's batch overflows runs on mesh:2x2 of the CPU
    cli.main(["submit", "--size", "48", "--steps", "12", "--seed", "3", "--input-file",
              "absent.txt", "--output-file", "mega.txt"])
    jcli.main(["submit", "--requests", "jax.jsonl", "--size", "48", "--steps", "12", "--seed",
               "3", "--input-file", "absent.txt", "--output-file", "jmega.txt"])
    capsys.readouterr()
    budget = ["--mesh-devices", "4", "--memory-budget-bytes", "20000"]
    assert cli.main(["serve", "--device", "cpu", *budget]) == 0
    assert jcli.main(["serve", "--requests", "jax.jsonl", "--serve-backend", "numpy",
                      *budget]) == 0
    assert (spool / "mega.txt").read_bytes() == (spool / "jmega.txt").read_bytes()
