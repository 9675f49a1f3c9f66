"""One run of one cell: from its entry in ``BENCHMARK.json`` to the result
line.

A cell names a configuration and a traffic mix.  The harness finds each by
name: the configuration's file (``configs/<name>.json``) says which rule,
backend and reference it runs; the mix (``traffic/<name>.json``) holds the
parameters that its kind's generator (``traffic/<kind>.py``) reads; each
per-layer metric is read by ``metrics/<metric>.py``.  A kind's ``run``
makes the inputs from the seed, builds the system under test, warms it,
measures the window through :meth:`Context.window`, and checks the window's
output against the configuration's reference.  Nothing here names a cell.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from perfbench import tracing

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level modules that may not be loaded in a run: the JAX package and
#: the JAX stack, compared by whole top-level name
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "tpu_life")


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT, overrides: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration and
    traffic mix; ``overrides`` replaces parameters of the mix (the tests'
    small sizes)."""
    spec = load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    cfg_entry = next(c for c in spec["configs"] if c["name"] == w["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    traffic.update(overrides or {})
    return Cell(name=name, config=config, traffic=traffic, chips=w["chips"],
                end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in spec["per_layer"] if _applies(m, name)])


def _load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def traffic_kind(cell: Cell):
    return importlib.import_module(f"perfbench.traffic.{cell.traffic['kind']}")


def reference(cell: Cell):
    return importlib.import_module(f"perfbench.reference.{cell.config['reference']['module']}")


def metric_reader(name: str):
    return _load_file(HERE / "metrics" / f"{name}.py", f"perfbench_metric_{name}")


def read_counter(path: str) -> float:
    """A counter of the program named ``module:attribute.path``."""
    module, attrs = path.split(":")
    obj = importlib.import_module(module)
    for a in attrs.split("."):
        obj = getattr(obj, a)
    return float(obj)


@dataclass
class Check:
    """One number compared with its limit: correct while ``value <= limit``."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Outcome:
    """What a kind's run hands back to the harness."""

    end_to_end: dict
    checks: list
    attempted: int
    failed: int
    #: what the per-layer readers read besides the trace and the counters
    work: dict = field(default_factory=dict)


class Context:
    """What a kind's run gets: the cell, the seed and the window's length,
    the device, and the window's timer and tracer."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: torch.device, started: float, control: bool = False):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device = device
        #: the control run: the reference with a broken guarantee stands in
        #: for the program's output
        self.control = control
        self.started = started
        self.setup_s: float | None = None
        self.memory_peak_bytes = 0
        self.trace_window: tracing.TraceWindow | None = None
        self.counters: dict = {}
        self.closed: float | None = None  # when the window closed
        self._counter_paths = sorted({
            p for m in cell.per_layer for p in getattr(metric_reader(m["name"]), "COUNTERS", ())
        })

    def span(self, name: str):
        """A host span of the harness around a call into the program."""
        return tracing.span(name, self.trace)

    def window(self):
        """The measured window: marks the end of set-up, starts the
        device's memory peak afresh, reads the counters on both sides, and
        traces the window in a traced run.  The kind times the window's
        work itself (its clock starts inside)."""
        return _Window(self)


class _Window:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self._stack = contextlib.ExitStack()
        self._traced: list = []

    def __enter__(self):
        ctx = self.ctx
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
            # the peak of what the window holds: the program's state, not
            # the scratch of set-up (the inputs' draws, staging)
            torch.cuda.reset_peak_memory_stats(ctx.device)
        ctx.setup_s = time.perf_counter() - ctx.started
        self._before = {p: read_counter(p) for p in ctx._counter_paths}
        if ctx.trace:
            self._stack.enter_context(tracing.profiled(self._traced))
        self._stack.enter_context(ctx.span("window"))
        return self

    def __exit__(self, *exc):
        ctx = self.ctx
        self._stack.__exit__(*exc)
        ctx.closed = time.perf_counter()
        if self._traced:
            ctx.trace_window = self._traced[0]
        ctx.counters = {p: read_counter(p) - v for p, v in self._before.items()}
        if ctx.device.type == "cuda":
            ctx.memory_peak_bytes = torch.cuda.max_memory_allocated(ctx.device)
        return False


@dataclass
class Readings:
    """What a per-layer metric's reader reads."""

    cell: Cell
    trace: tracing.TraceWindow | None
    counters: dict
    work: dict
    card: dict
    device: torch.device


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", overrides: dict | None = None,
             started: float | None = None, root: Path = ROOT, control: bool = False) -> dict:
    """Run the cell once and return the result object (without the look for
    a card, which :func:`main` makes).  ``control`` runs the control in the
    program's place."""
    started = time.perf_counter() if started is None else started
    cell = load_cell(name, root, overrides)
    dev = torch.device(device)
    ctx = Context(cell, seed, seconds, trace, dev, started, control)
    outcome = traffic_kind(cell).run(ctx)
    after_s = time.perf_counter() - ctx.closed
    card = _card(dev)
    result = {"correct": all(c.ok for c in outcome.checks),
              "attempted": outcome.attempted, "failed": outcome.failed}
    if trace:
        readings = Readings(cell, ctx.trace_window, ctx.counters, outcome.work, card, dev)
        metrics = {}
        for m in cell.per_layer:
            value = metric_reader(m["name"]).read(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**outcome.end_to_end, "setup_s": ctx.setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result["metrics"] = metrics
    result["device"] = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                        "kind": card["name"], "count": cell.chips,
                        "memory_peak_bytes": ctx.memory_peak_bytes,
                        "power_limit_w": card["power_limit_w"],
                        "max_sm_clock_hz": card["max_sm_clock_hz"]}
    if trace and ctx.trace_window is not None:
        result["device"]["busy_s"] = ctx.trace_window.busy_s
        result["device"]["window_s"] = ctx.trace_window.window_s
        result["breakdown"] = ctx.trace_window.breakdown()
        result["host_spans"] = ctx.trace_window.host_spans()
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}
    print(f"perfbench: set-up {ctx.setup_s:.3f} s; after the window (the trace's reduction, "
          f"the teardown and the check) {after_s:.3f} s", file=sys.stderr)
    return result


def _card(dev: torch.device) -> dict:
    if dev.type == "cuda":
        from perfbench import rooflines

        return rooflines.card()
    return {"name": "cpu", "power_limit_w": None, "max_sm_clock_hz": None, "n_sm": None}


def forbidden_modules() -> list[str]:
    """The forbidden top-level modules that this process has loaded."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def main(argv=None, started: float | None = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    chips = load_cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: the cell needs {chips} CUDA device(s), found {found}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), started=started)
    loaded = forbidden_modules()
    if loaded:
        print(f"perfbench: the run loaded forbidden modules: {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
