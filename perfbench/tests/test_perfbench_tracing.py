"""The program's own spans (``tpu_life_torch.*``) in the traced window
(``perfbench/program_spans.py``): on synthetic records, the harness's
reduction wrapped gives the harness's fields as before, and each span's
idle seconds are the exact intersection with the device's gaps; the
runner readers read nothing without a device or without the spans; on the
card a traced run of each cell reports them."""

from __future__ import annotations

import random

import pytest
import torch

from perfbench import harness, program_spans, tracing

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
SMALL = {"height": 32, "width": 64, "chunk_steps": 4, "setup_steps": 8}
CELL_OF = {"cells": "life.board-16k", "spins": "ising.lattice-16k"}
RUNNER_METRICS = [f"runner.{m}.{k}" for m in ("host_us_per_launch", "idle_pct") for k in CELL_OF]
program_spans.install()
#: the harness's own reduction, without the program's spans
HARNESS_REDUCE = tracing.reduce_events.__wrapped__


class Event:
    """A profiler record as ``reduce_events`` reads it."""

    def __init__(self, name, start, end, device=CPU, annotation=False):
        self._name, self._start, self._dur = name, start, end - start
        self._device, self._annotation = device, annotation

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return self._device

    def is_user_annotation(self):
        return self._annotation


def harness_events():
    """A 1000-ns window: three kernels (two overlapping), the gaps [0, 100],
    [300, 500] and [900, 1000]; the harness's spans and two host calls."""
    return [
        Event("perfbench.window", 0, 1000),
        Event("perfbench.advance", 0, 400),
        Event("perfbench.sync", 400, 1000),
        Event("cudaLaunchKernel", 90, 95),
        Event("cudaDeviceSynchronize", 700, 950),
        Event("k", 100, 300, CUDA),
        Event("k", 500, 700, CUDA),
        Event("k", 650, 900, CUDA),
    ]


PROGRAM = [
    Event("tpu_life_torch.runner.snapshot", -50, 10),  # opened before the window
    Event("tpu_life_torch.runner.advance", 20, 350),
    Event("tpu_life_torch.runner.sync", 420, 980),
    Event("tpu_life_torch.runner.sync.wait", 430, 960),
    # the span's record on the device's timeline is no device work
    Event("tpu_life_torch.runner.advance", 20, 350, CUDA, annotation=True),
]


FIELDS = ("window_s", "busy_s", "device_ops", "idle", "spans")


def test_the_wrapped_reduction_leaves_the_harness_fields_as_they_were():
    events = harness_events() + PROGRAM
    wrapped, harness_only = tracing.reduce_events(events), HARNESS_REDUCE(events)
    assert not hasattr(harness_only, "program")
    assert all(getattr(wrapped, f) == getattr(harness_only, f) for f in FIELDS)
    assert wrapped.program == program_spans.reduce(events)
    program_spans.install()  # a second install wraps nothing more
    assert tracing.reduce_events.__wrapped__ is HARNESS_REDUCE


def test_the_harness_fields_are_as_without_the_program_spans():
    bare = tracing.reduce_events(harness_events())
    full = tracing.reduce_events(harness_events() + PROGRAM)
    assert (full.window_s, full.busy_s) == (bare.window_s, bare.busy_s)
    assert (full.window_s, full.busy_s) == pytest.approx((1e-6, 0.6e-6), abs=1e-18)
    assert full.device_ops == bare.device_ops and full.spans == bare.spans
    assert full.host_spans() == bare.host_spans()
    assert full.breakdown()["device_ops"] == bare.breakdown()["device_ops"]
    assert full.idle_pct() == bare.idle_pct()
    # the same gaps, some named more finely by the program's span under them
    assert sum(n for n, _ in full.idle.values()) == sum(n for n, _ in bare.idle.values()) == 3
    assert sum(s for _, s in full.idle.values()) == pytest.approx(0.4e-6, abs=1e-18)
    refined = "perfbench.advance / tpu_life_torch.runner.advance"
    assert full.idle.pop(refined) == bare.idle.pop("perfbench.advance")
    assert full.idle == bare.idle
    assert bare.program == {}


def test_a_program_spans_idle_is_the_exact_intersection_with_the_gaps():
    program = program_spans.reduce(harness_events() + PROGRAM)
    want = {
        "tpu_life_torch.runner.snapshot": [1, 10, 10],  # clipped to [0, 10]
        "tpu_life_torch.runner.advance": [1, 330, 80 + 50],  # [20, 100] and [300, 350]
        "tpu_life_torch.runner.sync": [1, 560, 80 + 80],  # [420, 500] and [900, 980]
        "tpu_life_torch.runner.sync.wait": [1, 530, 70 + 60],
    }
    assert set(program) == set(want)
    for name, (n, s, idle) in want.items():
        assert program[name][0] == n
        assert program[name][1] == pytest.approx(s * 1e-9, abs=1e-18)
        assert program[name][2] == pytest.approx(idle * 1e-9, abs=1e-18)


@pytest.mark.parametrize("seed", range(4))
def test_the_intersection_equals_a_count_of_idle_nanoseconds(seed):
    rng = random.Random(seed)
    events = [Event("perfbench.window", 0, 400)]
    for _ in range(12):
        a = rng.randrange(-20, 400)
        events.append(Event("k", a, a + rng.randrange(1, 60), CUDA))
    spans = []
    for i in range(8):
        a = rng.randrange(-30, 420)
        spans.append((a, a + rng.randrange(0, 80)))
        events.append(Event(f"tpu_life_torch.s{i}", *spans[-1]))
    busy = {t for e in events if e.device_type() == CUDA
            for t in range(e.start_ns(), e.start_ns() + e.duration_ns())}
    program = program_spans.reduce(events)
    for i, (a, b) in enumerate(spans):
        inside = range(max(a, 0), min(b, 400))
        if not inside:
            assert f"tpu_life_torch.s{i}" not in program
            continue
        idle_ns = sum(t not in busy for t in inside)
        assert program[f"tpu_life_torch.s{i}"][2] == pytest.approx(idle_ns * 1e-9, abs=1e-18)


def _readings(cell, trace, counters):
    return harness.Readings(harness.load_cell(cell), trace, counters, {}, {}, torch.device("cpu"))


def _counters(kind, launches):
    module = harness.metric_reader(f"runner.host_us_per_launch.{kind}")
    return {module.COUNTERS[0]: launches}


@pytest.mark.parametrize("kind", sorted(CELL_OF))
def test_the_runner_readers_read_the_program_spans(kind):
    trace = tracing.reduce_events(harness_events() + PROGRAM)
    r = _readings(CELL_OF[kind], trace, _counters(kind, 3))
    host_us = harness.metric_reader(f"runner.host_us_per_launch.{kind}").read(r)
    idle = harness.metric_reader(f"runner.idle_pct.{kind}").read(r)
    assert host_us == pytest.approx(330e-9 * 1e6 / 3)
    assert idle == pytest.approx(100.0 * (130 + 160) / 1000)
    assert idle <= trace.idle_pct()


@pytest.mark.parametrize("name", RUNNER_METRICS)
def test_a_runner_reader_reads_nothing_without_the_spans_or_a_device(name):
    kind = name.rsplit(".", 1)[1]
    reader = harness.metric_reader(name)
    without_spans = tracing.reduce_events(harness_events())
    no_device = tracing.reduce_events([e for e in harness_events() + PROGRAM
                                       if e.device_type() == CPU])
    for trace in (None, without_spans, no_device):
        assert reader.read(_readings(CELL_OF[kind], trace, _counters(kind, 3))) is None


@pytest.mark.parametrize("kind", sorted(CELL_OF))
def test_a_cpu_run_reports_no_runner_metric(kind):
    r = harness.run_cell(CELL_OF[kind], 2**33 + 7, 0.3, True, device="cpu", overrides=SMALL)
    assert r["correct"] is True
    assert not set(r["metrics"]) & set(RUNNER_METRICS)


@pytest.mark.card
@pytest.mark.parametrize("kind", sorted(CELL_OF))
def test_a_traced_run_on_the_card_reports_the_runner_metrics(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    r = harness.run_cell(CELL_OF[kind], 2**32 + 91, 2.0, True)
    assert r["correct"] is True
    m = {name: v["value"] for name, v in r["metrics"].items()}
    assert m[f"runner.host_us_per_launch.{kind}"] > 0
    assert 0 < m[f"runner.idle_pct.{kind}"] <= m[f"device_idle_pct.{kind}"]
    if kind == "cells":
        assert any("tpu_life_torch." in label for label, _ in r["breakdown"]["idle_gaps"])
