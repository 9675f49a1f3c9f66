"""``python -m tpu_life_torch sweep`` against ``python -m tpu_life sweep``.

Both CLIs run in process on the CPU (the port's ``cuda`` engines on
``--device cpu``, packed and ``--no-bitpack``, against the JAX ``jax``
engines; ``numpy`` against ``numpy``): the JSON record must hold the same
keys and the same values apart from the timings and the backend's name
(sessions, temperatures, magnetizations, states, ``compile_counts`` a
single 1 on the device engines), and ``--output-dir`` the same bytes.  The
exit codes agree: 2 for a malformed ``--temps``, a lattice the rule cannot
run and a grid the memory budget cannot hold (``InsufficientMemory``).
"""

import json

import pytest

from tpu_life import cli as jcli
from tpu_life_torch import cli

#: record keys whose values are timings (or name the backend)
TIMED = {"run_id", "backend", "elapsed_s", "compile_counts"}


def record(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture
def here(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.mark.parametrize("backend,jbackend", [("cuda", "jax"), ("numpy", "numpy")])
@pytest.mark.parametrize("flags", [[], ["--no-bitpack"], ["--sync-pump"],
                                   ["--capacity", "3", "--chunk-steps", "5"]],
                         ids=["packed", "roll", "sync", "capacity3"])
@pytest.mark.parametrize("temps", ["1.5:3.0:8", "2.27", "0,1.0,2.269,10"])
def test_sweep_record_and_files_equal_jax(here, capsys, backend, jbackend, flags, temps):
    common = ["sweep", "--size", "12", "--steps", "9", "--temps", temps, "--seed", "7", *flags]
    assert jcli.main([*common, "--serve-backend", jbackend, "--output-dir", "jax"]) == 0
    want = record(capsys)
    assert cli.main([*common, "--serve-backend", backend, "--device", "cpu",
                     "--output-dir", "port"]) == 0
    got = record(capsys)
    assert list(got) == list(want)
    assert {k: v for k, v in got.items() if k not in TIMED} == {
        k: v for k, v in want.items() if k not in TIMED}
    assert got["backend"] == backend and got["mode"] == "sweep"
    assert len(got["compile_counts"]) == 1
    if backend == "cuda":
        assert list(got["compile_counts"].values()) == [1] == list(want["compile_counts"].values())
    files = sorted(p.name for p in (here / "jax").iterdir())
    assert files == sorted(p.name for p in (here / "port").iterdir())
    assert len(files) == len(got["sessions"])
    for name in files:
        assert (here / "port" / name).read_bytes() == (here / "jax" / name).read_bytes()


@pytest.mark.parametrize("args", [
    ["--temps", "1:2"], ["--temps", "1:2:0"], ["--temps", "a,b"], ["--temps", ","],
    ["--temps", "1:2:x"], ["--size", "11"], ["--height", "12", "--width", "13"], [],
], ids=["two-fields", "zero-points", "words", "empty", "bad-count", "odd", "odd-width",
        "no-size"])
def test_sweep_refusals_exit_2_as_jax_does(here, capsys, args):
    base = [] if any(a in args for a in ("--size", "--height")) or not args else ["--size", "8"]
    common = ["sweep", *base, "--steps", "3", *args]
    codes = []
    for main, extra in ((jcli.main, ["--serve-backend", "numpy"]),
                        (cli.main, ["--serve-backend", "numpy"])):
        with pytest.raises(SystemExit) as e:
            main([*common, *extra])
        codes.append(e.value.code)
    assert codes == [2, 2]
    err = capsys.readouterr().err
    assert err.count("error:") == 2


@pytest.mark.parametrize("backend,jbackend", [("cuda", "jax"), ("numpy", "numpy")])
def test_sweep_exits_2_when_the_grid_overflows_the_memory_budget(here, capsys, backend, jbackend):
    common = ["sweep", "--size", "64", "--steps", "3", "--memory-budget-bytes", "100"]
    assert jcli.main([*common, "--serve-backend", jbackend]) == 2
    jerr = capsys.readouterr().err
    assert cli.main([*common, "--serve-backend", backend, "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert err.startswith("sweep: ") and "InsufficientMemory" not in err
    assert err.split(":")[0] == jerr.split(":")[0]


def test_a_non_ising_rule_with_temperatures_raises_as_jax_does(here):
    common = ["sweep", "--size", "8", "--steps", "3", "--rule", "noisy:0.1/conway"]
    errors = []
    for main, backend in ((jcli.main, "numpy"), (cli.main, "numpy")):
        with pytest.raises(ValueError, match="temperature only applies") as e:
            main([*common, "--serve-backend", backend])
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_parse_temps_is_a_copy():
    import inspect

    assert inspect.getsource(cli._parse_temps) == inspect.getsource(jcli._parse_temps)
