"""The Runners' spans on ``torch.profiler``'s clock (``obs.profiler_span``):
a ``cuda``-backend Conway Runner and a packed Ising Runner, on CPU tensors,
record ``tpu_life_torch.runner.*`` once a call and properly nested while
the profiler records; with it off every site takes the shared
``nullcontext`` and the obs ring sees nothing; ``tpu_life_torch.obs``
loads no torch.  The boards stay the numpy oracle's, exactly."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpu_life_torch import mc, obs
from tpu_life_torch.backends.base import get_backend, make_runner
from tpu_life_torch.mc import prng
from tpu_life_torch.models.rules import get_rule
from tpu_life_torch.obs import profiler, trace
from tpu_life_torch.ops import reference

ROOT = Path(__file__).resolve().parents[1]
PREFIX = "tpu_life_torch."
RUNNER_SPANS = ["runner.advance", "runner.sync", "runner.sync.wait", "runner.sync.readback",
                "runner.snapshot"]
STEPS = 5


def conway():
    board = (np.random.default_rng(3).random((24, 70)) < 0.4).astype(np.int8)
    runner = make_runner(get_backend("cuda", device="cpu"), board, get_rule("conway"))
    assert runner.route == "k1"
    return runner, board, lambda b, n: reference.run_np(b, get_rule("conway"), n)


def ising():
    board = prng.seeded_board(20, 36, seed=5)
    runner = make_runner(get_backend("cuda", device="cpu"), board, get_rule("ising"), seed=5,
                         temperature=2.27)
    assert runner.route == "mc_packed"
    return runner, board, lambda b, n: mc.run_np(get_rule("ising"), b, 5, n, temperature=2.27)


RUNNERS = {"conway": conway, "ising": ising}


def drive(runner):
    """One snapshot, advance and sync, as the benchmark's window does a
    chunk; returns the snapshot's thunk."""
    before = runner.snapshot()
    runner.advance(STEPS)
    runner.sync()
    return before


def program_records(prof) -> list[tuple[str, int, int]]:
    """(name without the prefix, start ns, end ns) of the program's spans."""
    return sorted(
        (e.name()[len(PREFIX):], e.start_ns(), e.start_ns() + e.duration_ns())
        for e in prof.profiler.kineto_results.events()
        if e.name().startswith(PREFIX) and e.device_type() == torch.autograd.DeviceType.CPU
    )


@pytest.mark.parametrize("kind", sorted(RUNNERS))
def test_a_profiled_runner_records_each_span_once_a_call(kind):
    runner, board, oracle = RUNNERS[kind]()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        before = drive(runner)
    records = program_records(prof)
    assert sorted(name for name, _, _ in records) == sorted(RUNNER_SPANS)
    # K1's spans are the card's: its plain version on the CPU records none
    assert not any(name.startswith("k1.") for name, _, _ in records)
    np.testing.assert_array_equal(before(), board)
    np.testing.assert_array_equal(runner.fetch(), oracle(board, STEPS))


@pytest.mark.parametrize("kind", sorted(RUNNERS))
def test_the_runner_spans_nest_as_the_calls_do(kind):
    runner, _, _ = RUNNERS[kind]()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        drive(runner)
        drive(runner)
    spans: dict = {}
    for name, a, b in program_records(prof):
        spans.setdefault(name, []).append((a, b))
    assert {name: len(v) for name, v in spans.items()} == {name: 2 for name in RUNNER_SPANS}
    for i in range(2):
        snap, adv, sync = spans["runner.snapshot"][i], spans["runner.advance"][i], spans["runner.sync"][i]
        wait, readback = spans["runner.sync.wait"][i], spans["runner.sync.readback"][i]
        # the calls follow one another; the sync's two parts lie inside it, in order
        assert snap[1] <= adv[0] and adv[1] <= sync[0]
        assert sync[0] <= wait[0] <= wait[1] <= readback[0] <= readback[1] <= sync[1]
    assert spans["runner.sync"][0][1] <= spans["runner.snapshot"][1][0]


@pytest.mark.parametrize("kind", sorted(RUNNERS))
def test_without_a_profiler_every_site_is_the_shared_nullcontext(kind, monkeypatch):
    runner, board, oracle = RUNNERS[kind]()
    taken = []

    def spy(name):
        span = profiler.profiler_span(name)
        taken.append(span)
        return span

    for module in ("tpu_life_torch.backends.torch_backend", "tpu_life_torch.kernels.packed_stripe"):
        monkeypatch.setattr(sys.modules[module], "profiler_span", spy)
    obs.reset_span_count()
    before = drive(runner)
    assert len(taken) == len(RUNNER_SPANS)
    assert all(span is trace._NULL for span in taken)
    assert obs.span_count() == 0 and obs.active_tracer() is None
    np.testing.assert_array_equal(before(), board)
    np.testing.assert_array_equal(runner.fetch(), oracle(board, STEPS))


def test_profiler_span_names_its_record_only_while_the_profiler_records():
    assert obs.profiler_span("x") is trace._NULL
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.profiler_span("x"):
            pass
    assert obs.profiler_span("x") is trace._NULL
    assert [name for name, _, _ in program_records(prof)] == ["x"]


def test_profiler_spans_never_enter_the_obs_ring(tmp_path):
    tracer = obs.start_tracing(str(tmp_path / "t.json"))
    try:
        obs.reset_span_count()
        runner, _, _ = conway()
        with profile(activities=[ProfilerActivity.CPU]):
            drive(runner)
        assert obs.span_count() == 0 and tracer.drain() == []
    finally:
        obs.stop_tracing(tracer)


def test_importing_obs_loads_no_torch_and_its_spans_stay_null():
    code = (
        "import sys\n"
        "from tpu_life_torch import obs\n"
        "from tpu_life_torch.obs import trace\n"
        "print('torch' in sys.modules, obs.profiler_span('x') is trace._NULL)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "True"]


def test_the_runner_spans_are_on_the_profile_timeline(tmp_path):
    import json

    from tpu_life_torch.runtime.profiling import maybe_profile

    runner, _, _ = conway()
    with maybe_profile(str(tmp_path)):
        drive(runner)
    (trace_file,) = tmp_path.glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(trace_file.read_text())["traceEvents"]}
    assert {PREFIX + name for name in RUNNER_SPANS} <= names
