"""The run driver's instruments, held against the JAX package's driver:
snapshots and ``--resume`` (across the two packages), elastic recovery,
the metrics JSONL, the ``--trace-events`` spans and ``--profile``.

The JAX package runs as its own tests run it (on the CPU, ``--backend
numpy``); the port runs with ``--device cpu``, so its kernels' plain
versions run.  Boards come from ``np.random.default_rng``; every
comparison is exact."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_life import cli as jcli
from tpu_life.config import RunConfig as JRunConfig
from tpu_life.runtime import driver as jdriver
from tpu_life.runtime.recovery import InjectedFault as JInjectedFault
from tpu_life_torch import cli, obs
from tpu_life_torch.backends import base as backends_base
from tpu_life_torch.backends.base import CudaUnavailableError
from tpu_life_torch.config import RunConfig
from tpu_life_torch.io.codec import read_board, write_board, write_config
from tpu_life_torch.kernels import _build
from tpu_life_torch.kernels import packed_stripe as ps
from tpu_life_torch.models.rules import get_rule
from tpu_life_torch.ops.reference import run_np
from tpu_life_torch.runtime import checkpoint as ckpt
from tpu_life_torch.runtime import driver, recovery
from tpu_life_torch.runtime.recovery import InjectedFault

RULES = ["conway", "brians_brain", "R2,C2,S2..4,B2..3,NN"]
PORT_BACKENDS = {
    "cuda": ["--device", "cpu"],
    "torch": ["--backend", "torch", "--device", "cpu"],
    "sharded": ["--backend", "sharded", "--device", "cpu", "--num-devices", "3"],
}
SNAP_FLAGS = ["--snapshot-every", "7", "--keep-snapshots", "3"]


def _board(h, w, rule, seed):
    rng = np.random.default_rng(seed)
    states = get_rule(rule).states
    board = rng.integers(0, 2, size=(h, w), dtype=np.int8)
    if states > 2:
        board *= rng.integers(1, states, size=(h, w), dtype=np.int8)
    return board


def _workload(d: Path, rule="conway", h=64, w=48, steps=40, seed=5):
    """A contract workload in ``d``; returns its board and file flags."""
    d.mkdir(parents=True, exist_ok=True)
    board = _board(h, w, rule, seed)
    write_board(d / "data.txt", board)
    write_config(d / "grid_size_data.txt", h, w, steps)
    return board, ["--config-file", str(d / "grid_size_data.txt"),
                   "--input-file", str(d / "data.txt"), "--rule", rule]


def _files(d: Path) -> dict[str, bytes]:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


# -- snapshots -----------------------------------------------------------


@pytest.mark.parametrize("backend", sorted(PORT_BACKENDS))
@pytest.mark.parametrize("rule", RULES)
def test_snapshots_equal_jax(tmp_path, rule, backend):
    # the same snapshot names, board bytes, sidecars and output.txt
    _, files = _workload(tmp_path, rule)
    j, p = tmp_path / "jax", tmp_path / "port"
    assert jcli.main(["run", *files, "--backend", "numpy", *SNAP_FLAGS,
                      "--snapshot-dir", str(j / "snaps"), "--output-file", str(j / "out.txt")]) == 0
    assert cli.main(["run", *files, *PORT_BACKENDS[backend], *SNAP_FLAGS,
                     "--snapshot-dir", str(p / "snaps"), "--output-file", str(p / "out.txt")]) == 0
    snaps = _files(p / "snaps")
    assert sorted(snaps) == [f"board_0000000{s}.{x}" for s in (21, 28, 35) for x in ("crc", "json", "txt")]
    assert snaps == _files(j / "snaps")
    assert (p / "out.txt").read_bytes() == (j / "out.txt").read_bytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("rule", ["conway", "brians_brain"])
def test_a_snapshot_resumes_in_the_other_package(tmp_path, rule, writer):
    board, files = _workload(tmp_path, rule)
    snaps = tmp_path / "snaps"
    write_snaps = jcli.main if writer == "jax" else cli.main
    backend = ["--backend", "numpy"] if writer == "jax" else ["--device", "cpu"]
    # snapshots at 7, 14 and 21; then the other package resumes the newest
    assert write_snaps(["run", *files, *backend, "--steps", "21", "--snapshot-every", "7",
                        "--snapshot-dir", str(snaps), "--output-file", str(tmp_path / "mid.txt")]) == 0
    resume = cli.main if writer == "jax" else jcli.main
    other = ["--device", "cpu"] if writer == "jax" else ["--backend", "numpy"]
    for target in (snaps, snaps / "board_000000014.txt"):
        out = tmp_path / f"out_{target.name}.txt"
        assert resume(["run", *files, *other, "--resume", str(target), "--output-file", str(out)]) == 0
        np.testing.assert_array_equal(read_board(out, 64, 48), run_np(board, get_rule(rule), 40))


def test_port_snapshot_helpers_equal_jax_on_disk(tmp_path):
    from tpu_life.runtime import checkpoint as jckpt

    board = _board(12, 9, "brians_brain", 3)
    for mod, d in ((ckpt, tmp_path / "p"), (jckpt, tmp_path / "j")):
        for step in (3, 10, 20):
            mod.save_snapshot(d, step, board, rule="brians_brain")
        assert mod.prune_snapshots(d, 2, [3, 10, 20]) == [10, 20]
    assert _files(tmp_path / "p") == _files(tmp_path / "j")
    assert ckpt.resolve_resume(tmp_path / "j", 12, 9)[1:] == jckpt.resolve_resume(tmp_path / "p", 12, 9)[1:]


# -- recovery (mirrors tests/test_recovery.py for one process) ---------------


def _setup(tmp_path, h=40, w=33, steps=20, seed=71):
    board = _board(h, w, "conway", seed)
    write_board(tmp_path / "data.txt", board)
    write_config(tmp_path / "cfg.txt", h, w, steps)
    return board, dict(
        config_file=str(tmp_path / "cfg.txt"),
        input_file=str(tmp_path / "data.txt"),
        output_file=str(tmp_path / "out.txt"),
        snapshot_dir=str(tmp_path / "snaps"),
    )


def _both(tmp_path, **cfg):
    """The port (``cuda`` backend's plain version) and the JAX driver
    (numpy) on one workload, each with its own snapshot and output files;
    returns (port result, JAX result)."""
    setup = {k: cfg.pop(k) for k in ("h", "w", "steps", "seed") if k in cfg}
    board, base = _setup(tmp_path, **setup)
    results = []
    for name, mod, config, backend in (("port", driver, RunConfig, dict(device="cpu")),
                                       ("jax", jdriver, JRunConfig, dict(backend="numpy"))):
        files = dict(base, output_file=str(tmp_path / f"{name}.txt"),
                     snapshot_dir=str(tmp_path / f"snaps_{name}"))
        results.append(mod.run(config(**backend, **files, **cfg)))
    port, jax = results
    np.testing.assert_array_equal(port.board, jax.board)
    np.testing.assert_array_equal(port.board, run_np(board, get_rule("conway"), setup.get("steps", 20)))
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    assert port.restarts == jax.restarts
    return port, jax


def _snapshot_steps(d: Path) -> list[int]:
    return sorted(int(f.name.split("_")[1].split(".")[0]) for f in d.glob("*.txt"))


def test_failure_without_restarts_fails_fast(tmp_path):
    _, base = _setup(tmp_path)
    with pytest.raises(InjectedFault):
        driver.run(RunConfig(device="cpu", fault_at=7, **base))
    with pytest.raises(JInjectedFault):
        jdriver.run(JRunConfig(backend="numpy", fault_at=7, **base))
    assert not (tmp_path / "out.txt").exists()


def test_recovers_from_latest_snapshot(tmp_path):
    port, jax = _both(tmp_path, snapshot_every=5, sync_every=5, fault_at=12, max_restarts=1,
                      metrics=True)
    assert port.restarts == 1
    # the rewind trimmed re-earned metric records: steps strictly increase
    steps_seen = [m["step"] for m in port.metrics]
    assert steps_seen == sorted(set(steps_seen)) == [m["step"] for m in jax.metrics]
    assert steps_seen[-1] == 20
    assert _snapshot_steps(tmp_path / "snaps_port") == _snapshot_steps(tmp_path / "snaps_jax")


def test_recovers_from_origin_when_no_snapshot_yet(tmp_path):
    port, _ = _both(tmp_path, snapshot_every=10, sync_every=10, fault_at=3, max_restarts=1)
    assert port.restarts == 1


def test_single_failure_consumes_one_restart(tmp_path):
    port, _ = _both(tmp_path, snapshot_every=5, sync_every=5, fault_at=12, max_restarts=3)
    assert port.restarts == 1


def test_repeated_failures_within_budget_recover(tmp_path):
    # recovery rewinds below fault_at, so a fault_count=2 drill fires again
    # on the re-driven tail: two restarts, then success
    port, _ = _both(tmp_path, snapshot_every=5, sync_every=5, fault_at=12, fault_count=2,
                    max_restarts=2)
    assert port.restarts == 2


def test_restart_budget_exhausted_reraises(tmp_path):
    _, base = _setup(tmp_path)
    flags = dict(snapshot_every=5, sync_every=5, fault_at=12, fault_count=2, max_restarts=1)
    with pytest.raises(InjectedFault):
        driver.run(RunConfig(device="cpu", **flags, **base))
    with pytest.raises(JInjectedFault):
        jdriver.run(JRunConfig(backend="numpy", **flags, **base))


def test_run_resumed_past_fault_step_does_not_fire(tmp_path):
    # a run that STARTS at or past fault_at already crossed it
    board, base = _setup(tmp_path)
    driver.run(RunConfig(device="cpu", snapshot_every=5, sync_every=5, **base))
    res = driver.run(RunConfig(device="cpu", resume=str(tmp_path / "snaps" / "board_000000015.txt"),
                               fault_at=9, max_restarts=0, **base))
    assert res.restarts == 0 and res.steps_run == 5
    np.testing.assert_array_equal(res.board, run_np(board, get_rule("conway"), 20))


def test_snapshot_cadence_stays_anchored_across_restarts(tmp_path):
    # sync_every=7, snapshot_every=10: a restart resuming from the step-14
    # snapshot snapshots next at 21 (past the global multiple 20), not 28
    _both(tmp_path, steps=30, snapshot_every=10, sync_every=7, fault_at=16, max_restarts=1)
    assert _snapshot_steps(tmp_path / "snaps_port") == [14, 21, 30]
    assert _snapshot_steps(tmp_path / "snaps_jax") == [14, 21, 30]


def test_stale_snapshots_cannot_hijack_recovery(tmp_path):
    # a stale snapshot of another board at step 950 must not be resumed:
    # recovery from a failure before this run's first snapshot goes back
    # to the original input
    stale = _board(40, 33, "conway", 99)
    for name in ("port", "jax"):
        ckpt.save_snapshot(tmp_path / f"snaps_{name}", 950, stale, rule="B3/S23")
    port, _ = _both(tmp_path, snapshot_every=10, sync_every=10, fault_at=3, max_restarts=1)
    assert port.restarts == 1


def test_bit_flipped_snapshot_demotes_to_previous(tmp_path):
    from tpu_life.runtime import checkpoint as jckpt

    board = _board(12, 9, "conway", 5)
    ckpt.save_snapshot(tmp_path / "snaps", 10, board, rule="B3/S23")
    ckpt.save_snapshot(tmp_path / "snaps", 20, board.copy(), rule="B3/S23")
    bad = tmp_path / "snaps" / "board_000000020.txt"
    raw = bytearray(bad.read_bytes())
    raw[5] ^= 0x01  # same size: only the CRC sidecar catches it
    bad.write_bytes(raw)
    assert not ckpt.snapshot_intact(bad, 12, 9)
    assert not jckpt.snapshot_intact(bad, 12, 9)
    p, step, h, w = ckpt.resolve_resume(tmp_path / "snaps", 12, 9)
    assert step == 10 and p.name == "board_000000010.txt"
    np.testing.assert_array_equal(read_board(p, h, w), board)


def test_failure_during_initial_staging_is_retried(tmp_path, monkeypatch):
    # the first staging sits inside the recovery scope too
    calls = {"n": 0}
    real = driver.make_runner

    def flaky(backend, board, rule):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("device detaching during staging")
        return real(backend, board, rule)

    monkeypatch.setattr(driver, "make_runner", flaky)
    board, base = _setup(tmp_path)
    res = driver.run(RunConfig(device="cpu", max_restarts=1, **base))
    assert res.restarts == 1 and calls["n"] == 2
    np.testing.assert_array_equal(res.board, run_np(board, get_rule("conway"), 20))


def test_config_errors_are_not_retried(tmp_path):
    board = np.zeros((8, 8), np.int8)
    board[3, 3] = 2
    write_board(tmp_path / "data.txt", board)
    write_config(tmp_path / "cfg.txt", 8, 8, 3)
    with pytest.raises(ValueError, match="state 2"):
        driver.run(RunConfig(config_file=str(tmp_path / "cfg.txt"), input_file=str(tmp_path / "data.txt"),
                             output_file=str(tmp_path / "out.txt"), device="cpu", max_restarts=5))


def test_a_kernel_that_does_not_build_is_not_retried(tmp_path, monkeypatch):
    # kernels build at their first launch, inside the recovery loop: a
    # failed nvcc run is raised on the first attempt, never rebuilt
    nvcc_runs = []

    def failing_nvcc():
        nvcc_runs.append(1)
        return "false"  # exits 1 like a failed compile

    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc", failing_nvcc)
    ps._library.cache_clear()
    launched = []

    def launching(x, *args, **kwargs):
        # what K1's wrapper does first on a CUDA tensor
        launched.append(1)
        ps._library()

    monkeypatch.setattr("tpu_life_torch.backends.cuda_backend.packed_multi_step", launching)
    _, base = _setup(tmp_path)
    with pytest.raises(_build.KernelBuildError, match="nvcc failed on packed_stripe.cu"):
        driver.run(RunConfig(device="cpu", snapshot_every=5, max_restarts=3, **base))
    assert nvcc_runs == [1] and launched == [1]
    assert not (tmp_path / "out.txt").exists()


def test_a_missing_card_is_not_retried(tmp_path, monkeypatch):
    # the card can vanish under a rebuild: CudaUnavailableError is raised
    # on the first attempt, not spent against the budget
    calls = []

    def no_card(backend, board, rule):
        calls.append(1)
        raise CudaUnavailableError("no CUDA device is available")

    monkeypatch.setattr(driver, "make_runner", no_card)
    _, base = _setup(tmp_path)
    with pytest.raises(CudaUnavailableError):
        driver.run(RunConfig(device="cpu", max_restarts=3, **base))
    assert calls == [1]


def test_the_cli_without_a_card_is_not_retried(tmp_path, monkeypatch, capsys):
    _, base = _setup(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    builds = []
    real = backends_base.get_backend

    def counting(name, **kw):
        builds.append(name)
        return real(name, **kw)

    monkeypatch.setattr(driver, "get_backend", counting)
    with pytest.raises(CudaUnavailableError, match="pass --device cpu"):
        cli.main(["run", "--config-file", base["config_file"], "--input-file", base["input_file"],
                  "--output-file", base["output_file"], "--max-restarts", "3"])
    assert builds == ["auto"]


def test_recoverable_set_and_oom_markers():
    assert issubclass(InjectedFault, recovery.RECOVERABLE)
    assert issubclass(torch.cuda.OutOfMemoryError, recovery.RECOVERABLE)
    assert recovery.is_oom(torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"))
    assert not recovery.is_oom(RuntimeError("CUDA error: an illegal memory access was encountered"))
    for fatal in (CudaUnavailableError("x"), _build.KernelBuildError("x")):
        assert isinstance(fatal, recovery.RECOVERABLE) and isinstance(fatal, recovery.FATAL)
    assert not issubclass(ValueError, recovery.RECOVERABLE)


# -- metrics ----------------------------------------------------------------


@pytest.mark.parametrize("backend", sorted(PORT_BACKENDS))
@pytest.mark.parametrize("rule", RULES)
def test_metrics_file_steps_and_live_counts_equal_jax(tmp_path, rule, backend):
    _, files = _workload(tmp_path, rule, steps=23)
    sinks = {}
    for name, main, flags in (("jax", jcli.main, ["--backend", "numpy"]),
                              ("port", cli.main, PORT_BACKENDS[backend])):
        sinks[name] = tmp_path / f"{name}.jsonl"
        assert main(["run", *files, *flags, "--sync-every", "5", "--metrics-file", str(sinks[name]),
                     "--output-file", str(tmp_path / f"{name}.txt")]) == 0
    recs = {k: [json.loads(line) for line in v.read_text().splitlines()] for k, v in sinks.items()}
    chunks = {k: [r for r in v if "kind" not in r] for k, v in recs.items()}
    assert [(r["step"], r["live_cells"]) for r in chunks["port"]] == [
        (r["step"], r["live_cells"]) for r in chunks["jax"]]
    assert [r["step"] for r in chunks["port"]] == [5, 10, 15, 20, 23]
    assert [sorted(r) for r in chunks["port"]] == [sorted(r) for r in chunks["jax"]]
    metric = {k: sorted((r["metric"], sorted(r)) for r in v if r.get("kind") == "metric")
              for k, v in recs.items()}
    assert metric["port"] == metric["jax"]
    assert len({r["run_id"] for r in recs["port"]}) == 1


def test_record_chunk_zero_elapsed_reports_zero_rates(tmp_path):
    from tpu_life_torch.runtime.metrics import MetricsRecorder

    sink = tmp_path / "metrics.jsonl"
    rec = MetricsRecorder(100, True, sink=str(sink))
    rec.record_chunk(5, 0.0, 42)
    assert rec.records[0]["steps_per_sec"] == 0.0
    parsed = json.loads(sink.read_text().strip(), parse_constant=lambda c: 1 / 0)
    assert parsed["cell_updates_per_sec"] == 0.0
    rec.close()


def test_sink_flushes_each_record_and_reopens_after_close(tmp_path):
    from tpu_life_torch.runtime.metrics import MetricsRecorder

    sink = tmp_path / "deep" / "metrics.jsonl"  # parents made at construction
    rec = MetricsRecorder(10, True, sink=str(sink))
    assert sink.exists()
    rec.record_chunk(1, 0.5, 3)
    assert len(sink.read_text().splitlines()) == 1  # visible before close
    rec.close()
    before = len(sink.read_text().splitlines())
    rec.record({"kind": "note", "x": 0})
    assert len(sink.read_text().splitlines()) == before + 1
    rec.close()


def test_sink_open_failure_is_fail_fast(tmp_path):
    from tpu_life_torch.runtime.metrics import MetricsRecorder

    blocker = tmp_path / "file.txt"
    blocker.write_text("a file, not a directory")
    with pytest.raises(OSError):
        MetricsRecorder(10, True, sink=str(blocker / "sub" / "m.jsonl"))


def test_recorder_records_equal_jax(tmp_path):
    # the same calls give the same records, times and run ids aside
    from tpu_life.runtime.metrics import MetricsRecorder as JRecorder
    from tpu_life_torch.runtime.metrics import MetricsRecorder

    out = []
    for cls in (MetricsRecorder, JRecorder):
        rec = cls(10, True, start_step=2, run_id="runid0000001", labels={"backend": "b", "rule": "r"})
        for step, elapsed, live in ((4, 1.0, 3), (8, 3.0, 5), (9, 3.0, 6)):
            rec.record_chunk(step, elapsed, live)
        out.append(([{k: v for k, v in r.items() if k != "ts"} for r in rec.records],
                    rec.registry.snapshot(run_id="runid0000001")))
    assert out[0] == out[1]


def test_configure_logging_does_not_duplicate_to_root(caplog):
    from tpu_life_torch.runtime.metrics import configure_logging, log

    configure_logging(verbose=False)
    configure_logging(verbose=False)
    assert log.propagate is False and len(log.handlers) == 1
    with caplog.at_level("INFO"):
        log.info("port-propagation-probe")
    assert "port-propagation-probe" not in caplog.text


# -- trace and profile ----------------------------------------------------------


def _assert_nested(events):
    stacks = {}
    for e in events:
        key = (e["pid"], e["tid"])
        if e["ph"] == "B":
            stacks.setdefault(key, []).append(e["name"])
        elif e["ph"] == "E":
            assert stacks.get(key), f"E {e['name']!r} without an open B"
            assert stacks[key].pop() == e["name"], f"mis-nested E {e['name']!r}"
    assert not any(stacks.values()), f"unclosed spans: {stacks}"


def _structure(events):
    """Span names in order with their nesting, and the chunk events' steps."""
    spans = [(e["ph"], e["name"]) for e in events if e["ph"] in "BE"]
    return spans, [e["args"]["step"] for e in events if e["name"] == "chunk"]


TRACE_CASES = {
    "plain": dict(sync_every=2),
    "snapshots and recovery": dict(sync_every=2, snapshot_every=3, fault_at=5, max_restarts=1),
    "one chunk": dict(),
}


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_trace_spans_equal_jax(tmp_path, monkeypatch, case):
    monkeypatch.chdir(tmp_path)
    flags = dict(height=16, width=24, steps=8, trace_events="t.json", **TRACE_CASES[case])
    jres = jdriver.run(JRunConfig(backend="numpy", output_file="j.txt", snapshot_dir="js", **flags))
    jdoc = json.loads(Path("t.json").read_text())
    res = driver.run(RunConfig(device="cpu", output_file="p.txt", snapshot_dir="ps", **flags))
    doc = json.loads(Path("t.json").read_text())
    assert doc["otherData"]["run_id"] == res.run_id != jres.run_id
    assert doc["otherData"]["telemetry_schema"] == jdoc["otherData"]["telemetry_schema"]
    _assert_nested(doc["traceEvents"])
    assert _structure(doc["traceEvents"]) == _structure(jdoc["traceEvents"])
    assert [(e["ph"], e["name"]) for e in doc["traceEvents"] if e["ph"] in "BE"][:2] == [
        ("B", "run"), ("B", "config-resolve")]


def test_run_trace_and_metrics_share_run_id(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    res = driver.run(RunConfig(height=24, width=24, steps=8, sync_every=2, device="cpu",
                               output_file=None, metrics_file="m.jsonl", trace_events="t.json"))
    doc = json.loads(Path("t.json").read_text())
    assert doc["otherData"]["run_id"] == res.run_id
    events = doc["traceEvents"]
    _assert_nested(events)
    assert {"run", "config-resolve", "backend-build", "stage", "drive", "chunk", "gather"} <= {
        e["name"] for e in events}
    chunks = [e for e in events if e["name"] == "chunk"]
    assert all(e["ph"] == "X" for e in chunks) and [e["args"]["step"] for e in chunks] == [2, 4, 6, 8]
    recs = [json.loads(line) for line in open("m.jsonl")]
    assert recs and all(r["run_id"] == res.run_id and "ts" in r for r in recs)
    snap = {r["metric"]: r for r in recs if r.get("kind") == "metric"}
    assert snap["run_backend_builds_total"]["value"] == 1.0
    assert snap["run_chunk_seconds"]["count"] == 4
    assert snap["run_steps_total"]["value"] == 8.0
    assert [m["step"] for m in res.metrics] == [2, 4, 6, 8]


def test_snapshot_and_recovery_spans_appear(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    res = driver.run(RunConfig(height=16, width=16, steps=8, sync_every=2, snapshot_every=2,
                               device="cpu", output_file=None, trace_events="t.json",
                               fault_at=5, max_restarts=1))
    assert res.restarts == 1
    doc = json.loads(Path("t.json").read_text())
    _assert_nested(doc["traceEvents"])
    names = [e["name"] for e in doc["traceEvents"]]
    assert "snapshot-write" in names and "recovery-rewind" in names


def test_disabled_telemetry_has_zero_overhead(tmp_path, monkeypatch, capsys):
    # no new flag: no records, no span entered, no tracer, and the one
    # stdout line of the contract
    monkeypatch.chdir(tmp_path)
    obs.reset_span_count()
    res = driver.run(RunConfig(height=16, width=16, steps=4, device="cpu", output_file=None))
    assert res.metrics == [] and res.restarts == 0 and res.run_id
    assert obs.span_count() == 0
    assert obs.active_tracer() is None
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 and out[0].startswith("Total time = ")


def test_profile_writes_a_torch_trace_inside_a_span(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    _, files = _workload(tmp_path, steps=6)
    assert cli.main(["run", *files, "--device", "cpu", "--profile", "prof", "--trace-events",
                     "t.json", "--output-file", "o.txt"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 and out[0].startswith("Total time = ")
    traces = list(Path("prof").glob("*.pt.trace.json"))
    assert len(traces) == 1
    assert json.loads(traces[0].read_text())["traceEvents"]
    events = json.loads(Path("t.json").read_text())["traceEvents"]
    _assert_nested(events)
    profile = [e for e in events if e["name"] == "torch-profile"]
    assert [e["ph"] for e in profile] == ["B", "E"] and profile[0]["args"] == {"trace_dir": "prof"}


def test_verbose_dumps_small_boards(tmp_path, monkeypatch):
    # --verbose: per-chunk records and the board dump of a small board,
    # the same records as --metrics
    monkeypatch.chdir(tmp_path)
    dumps = []
    monkeypatch.setattr(driver, "dump_board", lambda b: dumps.append(b.copy()) or "")
    res = driver.run(RunConfig(height=12, width=10, steps=6, sync_every=3, device="cpu",
                               output_file=None, verbose=True))
    assert [m["step"] for m in res.metrics] == [3, 6]
    assert len(dumps) == 2
    np.testing.assert_array_equal(dumps[-1], res.board)
