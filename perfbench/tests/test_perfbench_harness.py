"""The harness without a card: what it may import, that it is driven by
data, that BENCHMARK.json keeps to its format, and that a run on the CPU
at small sizes gives a well-formed result."""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")

#: small sizes of each traffic kind, for runs on the CPU
SMALL = {
    "board_steady": {"height": 32, "width": 64, "chunk_steps": 4, "setup_steps": 8},
}


def small(cell: str) -> dict:
    return SMALL[harness.load_cell(cell).traffic["kind"]]


def _imports(path: Path) -> set[str]:
    """The top-level names of the modules a source file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(folder: Path) -> list[Path]:
    return sorted(p for p in folder.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", _sources(BENCH), ids=lambda p: str(p.relative_to(BENCH)))
def test_nothing_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & set(harness.FORBIDDEN_MODULES)


@pytest.mark.parametrize("path", _sources(BENCH / "reference"),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_the_reference_imports_nothing_of_the_program(path):
    assert not _imports(path) & {"tpu_life_torch", "tpu_life"}
    assert _imports(path) <= {"__future__", "math", "numpy", "torch", "perfbench"}


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpu_life_torch_x", sys)
    monkeypatch.delitem(sys.modules, "tpu_life", raising=False)
    assert "tpu_life" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tpu_life.models", sys)
    assert "tpu_life" in harness.forbidden_modules()


def test_a_run_loads_no_forbidden_module():
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "from perfbench.harness import run_cell, forbidden_modules; "
            "r = run_cell('life.board-16k', 5, 0.2, False, device='cpu', overrides=json.loads(sys.argv[2])); "
            "print(json.dumps([r['correct'], forbidden_modules()]))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, str(ROOT), json.dumps(small("life.board-16k"))],
                         capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, []]


# -- the format of BENCHMARK.json ---------------------------------------------------

def test_benchmark_json_has_exactly_its_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_names_and_units_use_the_allowed_characters():
    named = SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] + SPEC["per_layer"]
    for entry in named:
        assert NAME.match(entry["name"]), entry["name"]
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
    for text in [w["why"] for w in SPEC["workloads"]] + [m["layer"] for m in SPEC["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_layer():
    for w in SPEC["workloads"]:
        cell = harness.load_cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer


def test_each_per_layer_metric_moves_an_end_to_end_metric_of_its_cells():
    for m in SPEC["per_layer"]:
        cells = m.get("workloads", [w["name"] for w in SPEC["workloads"]])
        for name in cells:
            reported = {e["name"] for e in harness.load_cell(name).end_to_end}
            assert m["moves"] in reported, (m["name"], name)


def test_every_name_finds_its_file():
    for c in SPEC["configs"]:
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["name"] == c["name"]
        assert (BENCH / "reference" / f"{config['reference']['module']}.py").exists()
    for w in SPEC["workloads"]:
        cell = harness.load_cell(w["name"])
        assert (BENCH / "traffic" / f"{cell.traffic['kind']}.py").exists()
    for m in SPEC["per_layer"]:
        assert callable(harness.metric_reader(m["name"]).read)


def test_a_configurations_stated_scale_and_cuts_hold_in_its_cells():
    for c in SPEC["configs"]:
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["reduced"] == c["reduced"]
        assert all(key in config for key in c["reduced"])
        for w in SPEC["workloads"]:
            if w["config"] == c["name"] and "lattice_edge" in config:
                mix = harness.load_cell(w["name"]).traffic
                assert mix["height"] == mix["width"] == config["lattice_edge"]


def test_the_command_names_only_files_under_paths():
    assert SPEC["command"] == ["python3", "perfbench/run.py"]
    assert SPEC["paths"] == ["perfbench"]
    assert (ROOT / SPEC["command"][1]).exists()


# -- driven by data ----------------------------------------------------------------

def test_a_cell_and_a_metric_added_as_files_are_found_by_name(tmp_path):
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "life.board-tiny", "config": "life-b3s23",
                              "traffic": "board-tiny", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "cell_updates_per_s":
            m["workloads"].append("life.board-tiny")
    spec["per_layer"].append({"name": "harness.chunks", "unit": "chunks", "better": "higher",
                              "source": "program_counter", "layer": "harness",
                              "moves": "cell_updates_per_s", "workloads": ["life.board-tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    (tmp_path / "perfbench" / "traffic" / "board-tiny.json").write_text(json.dumps(
        {"kind": "board_steady", "density": 0.3, **SMALL["board_steady"]}))
    (tmp_path / "perfbench" / "metrics" / "harness.chunks.py").write_text(
        "def read(r):\n    return r.work['chunks']\n")
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); sys.path.insert(1, sys.argv[2]); "
            "from perfbench.harness import run_cell; "
            "r = run_cell('life.board-tiny', 3, 0.2, True, device='cpu'); "
            "print(json.dumps(r))")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path), str(ROOT)],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["metrics"]["harness.chunks"]["value"] == result["attempted"] > 0


# -- runs on the CPU -------------------------------------------------------------------

@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_a_small_run_is_correct_and_well_formed(cell, trace):
    r = harness.run_cell(cell, 2**31 + 17, 0.3, trace, device="cpu", overrides=small(cell))
    assert r["correct"] is True
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["failed"] == 0 and r["attempted"] > 0
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())
    spec_cell = harness.load_cell(cell)
    if trace:
        assert set(r["metrics"]) <= {m["name"] for m in spec_cell.per_layer}
        assert r["device"]["window_s"] > 0
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(r["metrics"]) == {m["name"] for m in spec_cell.end_to_end}
        assert all(v["value"] > 0 for v in r["metrics"].values())


def test_the_same_seed_gives_the_same_inputs():
    import torch

    from perfbench import inputs

    a = inputs.boards(2**31 + 5, 3, 16, 24, 0.5, torch.device("cpu"))
    b = inputs.boards(2**31 + 5, 3, 16, 24, 0.5, torch.device("cpu"))
    c = inputs.boards(2**31 + 6, 3, 16, 24, 0.5, torch.device("cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert 0.3 < float(a.float().mean()) < 0.7


def test_without_a_card_the_command_exits_nonzero_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", "life.board-16k", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_the_command_exits_nonzero(tmp_path):
    shutil.copytree(BENCH, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "life.board-16k", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path, env=env,
    )
    assert out.returncode != 0 and out.stdout.strip() == ""
