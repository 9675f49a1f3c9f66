"""The port's ``stats``: a copy of ``tpu_life/obs/stats.py`` and the
``stats`` entry point, held to the JAX package's.

The port's ``summarize`` and ``render`` equal the JAX package's on the
fixture sink, on a torn final line and on several sinks merged by
``run_id``; on sinks the port itself writes (``run --metrics-file``,
``serve --metrics-file``) the JAX ``summarize`` of the port's sink equals
the port's; ``python -m tpu_life_torch stats --json`` prints what
``python -m tpu_life stats --json`` prints on the same files.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tpu_life.obs import stats as jstats
from tpu_life_torch.cli import main
from tpu_life_torch.io.codec import write_board, write_config
from tpu_life_torch.obs import stats

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "metrics_run.jsonl"


def _both(paths):
    """(port summary, JAX summary, port render, JAX render) of the sinks,
    each record stamped with its sink index as the CLI does."""
    out = []
    for mod in (stats, jstats):
        records = []
        for i, p in enumerate(paths):
            for rec in mod.load_records(str(p)):
                rec.setdefault("_sink", i)
                records.append(rec)
        s = mod.summarize(records)
        out.append((s, mod.render(s)))
    (ps, pr), (js, jr) = out
    return ps, js, pr, jr


def test_fixture_sink_summarizes_alike():
    ps, js, pr, jr = _both([FIXTURE])
    assert ps == js and pr == jr
    assert ps["records"] > 0


def _serve_rows(rid, done, sps, occ, rejected, rng):
    rows = []
    for r in range(int(rng.integers(1, 4))):
        rows.append({"kind": "serve", "run_id": rid, "elapsed_s": float(r + 1),
                     "queue_depth": int(rng.integers(0, 5)), "batch_occupancy": occ,
                     "admitted": done, "completed": done, "failed": int(rng.integers(0, 2)),
                     "steps_advanced": 8 * done, "sessions_done": done,
                     "sessions_per_sec": sps, "pump": "pipelined", "pipeline_depth": 1,
                     "device_idle_s": float(rng.random())})
    rows += [
        {"kind": "metric", "run_id": rid, "labels": {},
         "metric": "serve_sessions_submitted_total", "type": "counter", "value": float(done)},
        {"kind": "metric", "run_id": rid, "labels": {},
         "metric": "serve_admission_rejections_total", "type": "counter",
         "value": float(rejected)},
        {"kind": "metric", "run_id": rid, "labels": {}, "metric": "serve_devices",
         "type": "gauge", "value": 1.0},
    ]
    return rows


@pytest.mark.parametrize("seed", range(4))
def test_several_sinks_merge_by_run_id_alike(tmp_path, seed):
    rng = np.random.default_rng(seed)
    paths = []
    for w in range(int(rng.integers(1, 4))):
        p = tmp_path / f"w{w}.jsonl"
        rows = _serve_rows(f"run{w}", int(rng.integers(1, 9)), float(rng.random() * 4),
                           float(rng.random()), int(rng.integers(0, 3)), rng)
        p.write_text("".join(json.dumps(r) + "\n" for r in rows))
        paths.append(p)
    ps, js, pr, jr = _both(paths)
    assert ps == js and pr == jr


def test_torn_final_line_alike(tmp_path):
    sink = tmp_path / "m.jsonl"
    sink.write_text(json.dumps({"step": 2, "elapsed_s": 1.0, "steps_per_sec": 2.0}) + "\n"
                    + '{"step": 4, "elapsed')
    ps, js, pr, jr = _both([sink])
    assert ps == js and pr == jr and ps["run"]["final_step"] == 2
    sink.write_text('{"bad\n' + json.dumps({"step": 2}) + "\n")
    for mod in (stats, jstats):
        with pytest.raises(ValueError, match="bad metrics line"):
            mod.load_records(str(sink))


def _workload(tmp_path, h=40, w=37, steps=30, seed=3):
    rng = np.random.default_rng(seed)
    board = (rng.random((h, w)) < 0.4).astype(np.int8)
    write_board(tmp_path / "data.txt", board)
    write_config(tmp_path / "grid_size_data.txt", h, w, steps)
    return board


def test_the_ports_run_sink_summarizes_alike_under_jax(tmp_path, monkeypatch):
    _workload(tmp_path)
    monkeypatch.chdir(tmp_path)
    assert main(["run", "--device", "cpu", "--sync-every", "7",
                 "--metrics-file", "run.jsonl"]) == 0
    ps, js, pr, jr = _both([tmp_path / "run.jsonl"])
    assert ps == js and pr == jr
    assert ps["run"]["final_step"] == 30


@pytest.mark.parametrize("backend", ["cuda", "numpy"])
def test_the_ports_serve_sink_summarizes_alike_under_jax(tmp_path, monkeypatch, backend):
    _workload(tmp_path)
    monkeypatch.chdir(tmp_path)
    for steps in (5, 17, 30):
        assert main(["submit", "--steps", str(steps)]) == 0
    assert main(["serve", "--serve-backend", backend, "--device", "cpu", "--chunk-steps", "4",
                 "--metrics-file", "serve.jsonl"]) == 0
    ps, js, pr, jr = _both([tmp_path / "serve.jsonl"])
    assert ps == js and pr == jr
    assert ps["serve"]["sessions_done"] == 3


def _cli(module, *args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module, *args], capture_output=True,
                          text=True, cwd=cwd, env=env, timeout=120)


def test_stats_json_prints_what_the_jax_stats_prints(tmp_path):
    a = tmp_path / "a.jsonl"
    rng = np.random.default_rng(9)
    a.write_text("".join(json.dumps(r) + "\n" for r in _serve_rows("ra", 3, 1.5, 0.5, 1, rng)))
    for args in (["stats", str(FIXTURE), str(a), "--json"], ["stats", str(FIXTURE)]):
        port, jax = _cli("tpu_life_torch", *args, cwd=tmp_path), _cli("tpu_life", *args,
                                                                    cwd=tmp_path)
        assert (port.returncode, port.stdout) == (jax.returncode, jax.stdout) == (0, jax.stdout)
        assert port.stdout.strip()


def test_stats_watch_renders_twice_under_an_injected_clock(tmp_path, monkeypatch, capsys):
    # --watch re-reads the append-only sink on top's refresh loop: two
    # frames, each the single-shot output of the sink as it stood; the
    # injected sleep grows the sink between them, then ends the loop as
    # ^C does
    from tpu_life_torch.obs import console

    sink = tmp_path / "m.jsonl"
    rows = FIXTURE.read_text().splitlines(keepends=True)
    sink.write_text("".join(rows[: len(rows) // 2]))
    assert main(["stats", str(sink), "--json"]) == 0
    first = capsys.readouterr().out
    sleeps = []

    def sleep(seconds):
        sleeps.append(seconds)
        if len(sleeps) == 2:
            raise KeyboardInterrupt
        sink.write_text("".join(rows))

    monkeypatch.setattr(console.time, "sleep", sleep)
    assert main(["stats", str(sink), "--json", "--watch", "5"]) == 0
    watched = capsys.readouterr().out
    monkeypatch.undo()
    assert main(["stats", str(sink), "--json"]) == 0
    second = capsys.readouterr().out
    assert first != second and sleeps == [5.0, 5.0]
    assert watched == console._ANSI_CLEAR + first + console._ANSI_CLEAR + second
