"""``python -m tpu_life_torch bench`` and its measurement helpers, held
against the JAX package's: the record's keys and board, the chip count
of a mesh, and delta timing under a scripted clock (exact)."""

import json

import numpy as np
import pytest

from tpu_life import cli as jcli
from tpu_life.autotune.space import tuned_record as jtuned_record
from tpu_life.backends import base as jbase
from tpu_life.models.rules import get_rule as jget_rule
from tpu_life.utils import timing as jtiming
from tpu_life_torch import cli
from tpu_life_torch.autotune import tuned_record
from tpu_life_torch.backends import base
from tpu_life_torch.backends.base import get_backend
from tpu_life_torch.models.rules import get_rule
from tpu_life_torch.utils import timing

SMALL = ["--size", "128", "--steps", "20", "--base-steps", "2", "--repeats", "1"]


def _record(main, args, capsys) -> dict:
    assert main(["bench", *SMALL, *args]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


@pytest.fixture(scope="module")
def jax_record():
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert jcli.main(["bench", "--backend", "jax", *SMALL]) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize(
    "args,backend,local_kernel",
    [
        (["--device", "cpu"], "cuda", None),
        (["--backend", "torch", "--device", "cpu"], "torch", None),
        (["--backend", "numpy"], "numpy", None),
        (["--backend", "sharded", "--device", "cpu", "--num-devices", "4"], "sharded", "auto"),
        (["--backend", "sharded", "--device", "cpu", "--mesh-shape", "2,2", "--rule", "brians_brain"],
         "sharded", "auto"),
        (["--device", "cpu", "--rule", "brians_brain", "--block-steps", "4"], "cuda", None),
    ],
)
def test_record_has_the_jax_keys(capsys, jax_record, args, backend, local_kernel):
    rec = _record(cli.main, args, capsys)
    assert set(rec) == set(jax_record)
    assert rec["metric"] == "cell_updates_per_sec_per_chip" and rec["unit"] == "cells/s/chip"
    assert rec["platform"] == "cpu" and rec["value"] > 0
    assert rec["vs_baseline"] == rec["value"] / 1e11
    assert rec["backend"] == backend and rec["local_kernel"] == local_kernel
    assert rec["n_chips"] == 1  # one device holds every shard of a CPU mesh
    assert (rec["size"], rec["steps"], rec["tuned_source"]) == (128, 20, "flags")
    assert set(rec["tuned"]) == set(jax_record["tuned"])


def test_tuned_record_equals_jax_for_the_flags(capsys):
    rec = _record(cli.main, ["--backend", "sharded", "--device", "cpu", "--num-devices", "2",
                             "--block-steps", "4", "--local-kernel", "torch"], capsys)
    assert rec["local_kernel"] == "torch"
    assert rec["tuned"] == jtuned_record("sharded", {"block_steps": 4, "local_kernel": "torch"})


@pytest.mark.parametrize("rule", ["conway", "brians_brain", "star_wars"])
def test_bench_board_equals_jax(monkeypatch, capsys, rule):
    # both commands measure the same board: default_rng(0), times a states mask
    seen = {}

    def capture(name):
        def measure(backend, board, rule, steps, base_steps, repeats=3):
            seen[name] = board.copy()
            return 1.0, 1
        return measure

    monkeypatch.setattr(base, "measure_throughput", capture("port"))
    monkeypatch.setattr(jbase, "measure_throughput", capture("jax"))
    assert cli.main(["bench", "--backend", "numpy", "--size", "40", "--rule", rule]) == 0
    assert jcli.main(["bench", "--backend", "numpy", "--size", "40", "--rule", rule]) == 0
    capsys.readouterr()
    np.testing.assert_array_equal(seen["port"], seen["jax"])
    assert seen["port"].max() == get_rule(rule).states - 1


def test_tuned_backend_is_not_ported(capsys):
    assert cli.main(["bench", "--backend", "tuned"]) == 2
    err = capsys.readouterr().err
    assert "not yet ported" in err and "A10" in err


# -- the measurement helpers under a scripted clock ------------------------------


class _Clock:
    """A fake ``time`` module: the clock moves only when a runner works."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t


class _Runner:
    """Advancing k steps costs ``latency`` plus k times a per-step time
    that wobbles from call to call, on the scripted clock."""

    def __init__(self, clock, per_step, latency=1e-3):
        self.clock, self.per_step, self.latency, self.calls = clock, per_step, latency, 0

    def advance(self, k):
        self.calls += 1
        wobble = (0.9, 1.3, 1.0, 0.7, 1.1)[self.calls % 5]
        self.clock.t += self.latency + k * self.per_step * wobble

    def sync(self):
        self.clock.t += 2e-5


class _Backend:
    def __init__(self, clock, per_step, mesh=None):
        self.clock, self.per_step = clock, per_step
        if mesh is not None:
            self.mesh = mesh

    def prepare(self, board, rule):
        return _Runner(self.clock, self.per_step)


class _Mesh:
    def __init__(self, devices):
        self.devices = np.array(devices)


def _scripted(monkeypatch):
    """One scripted clock for each package's timing module."""
    clocks = {"port": _Clock(), "jax": _Clock()}
    monkeypatch.setattr(timing, "time", clocks["port"])
    monkeypatch.setattr(jtiming, "time", clocks["jax"])
    return clocks


@pytest.mark.parametrize("steps,base_steps,repeats", [(20, 2, 1), (100, 10, 3), (64, 63, 5)])
def test_delta_timings_equal_jax(monkeypatch, steps, base_steps, repeats):
    clocks = _scripted(monkeypatch)
    got = [mod.delta_seconds_per_step(_Runner(clocks[k], 2e-4), steps, base_steps, repeats)
           for k, mod in (("port", timing), ("jax", jtiming))]
    assert got[0] == got[1] > 0
    pairs = [mod.paired_delta_seconds_per_step(_Runner(clocks[k], 2e-4), _Runner(clocks[k], 5e-4),
                                               steps, base_steps, repeats)
             for k, mod in (("port", timing), ("jax", jtiming))]
    assert pairs[0] == pairs[1] and 0 < len(pairs[0]) <= repeats


def test_paired_delta_refuses_steps_not_past_base_steps():
    with pytest.raises(ValueError, match="must exceed base_steps"):
        timing.paired_delta_seconds_per_step(None, None, 10, 10)


@pytest.mark.parametrize(
    "devices,chips", [(None, 1), (["cuda:0"] * 4, 1), (["cuda:0", "cuda:1"] * 2, 2), (["a", "b", "c", "d"], 4)]
)
def test_measure_throughput_equals_jax_and_counts_distinct_devices(monkeypatch, devices, chips):
    clocks = _scripted(monkeypatch)
    board = np.zeros((48, 40), np.int8)
    mesh = None if devices is None else _Mesh(devices)
    got = base.measure_throughput(_Backend(clocks["port"], 3e-4, mesh), board, get_rule("conway"),
                                  30, 5, 2)
    assert got[1] == chips == base.n_chips(_Backend(None, 0, mesh))
    if devices is None or len(set(devices)) == len(devices):
        # every device distinct: the JAX count (mesh.devices.size) agrees
        want = jbase.measure_throughput(_Backend(clocks["jax"], 3e-4, mesh), board,
                                        jget_rule("conway"), 30, 5, 2)
        assert got == want


@pytest.mark.parametrize("devices", [None, ["a", "b", "c", "d"]])
@pytest.mark.parametrize("repeats", [1, 6])
def test_measure_parity_interleaved_equals_jax(monkeypatch, devices, repeats):
    clocks = _scripted(monkeypatch)
    board = np.zeros((32, 32), np.int8)
    mesh = None if devices is None else _Mesh(devices)
    got = base.measure_parity_interleaved(
        _Backend(clocks["port"], 1e-4, mesh), _Backend(clocks["port"], 3e-4), board,
        get_rule("conway"), 40, 8, repeats)
    want = jbase.measure_parity_interleaved(
        _Backend(clocks["jax"], 1e-4, mesh), _Backend(clocks["jax"], 3e-4), board,
        jget_rule("conway"), 40, 8, repeats)
    assert got == want and got["parity_pairs"] >= 1


def test_n_chips_of_real_meshes():
    assert base.n_chips(get_backend("sharded", device="cpu", num_devices=4)) == 1
    assert base.n_chips(get_backend("sharded", device="cpu", mesh_shape=(2, 2))) == 1
    assert base.n_chips(get_backend("cuda", device="cpu")) == 1


def test_tuned_record_copy_equals_jax():
    for kwargs in ({}, {"block_steps": 4}, {"local_kernel": "cuda", "bitpack": False},
                   {"local_kernel": None, "sync_every": 5, "stencil": "roll"}):
        assert tuned_record("sharded", kwargs) == jtuned_record("sharded", kwargs)
