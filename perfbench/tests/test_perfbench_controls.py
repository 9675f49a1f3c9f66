"""The check that decides ``correct`` has to fail: the control (the
reference with a broken guarantee in the program's place) and each fault a
cell can have, planted underneath an otherwise whole run on the CPU at a
small size, each make ``correct`` come out false."""

from __future__ import annotations

import functools

import pytest
import torch

from perfbench import harness
from perfbench.tests.test_perfbench_harness import SPEC, small

CELLS = [w["name"] for w in SPEC["workloads"]]
BOARD_CELLS = [c for c in CELLS if harness.load_cell(c).traffic["kind"] == "board_steady"]
SEEDS = (2**31 + 101, 2**32 + 7, 12345)


def _run(cell: str, seed: int = SEEDS[0], **kwargs) -> dict:
    return harness.run_cell(cell, seed, 0.3, False, device="cpu", overrides=small(cell),
                            **kwargs)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell, seed):
    r = _run(cell, seed, control=True)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


# -- faults planted in the program ----------------------------------------------------

def _altered(fn):
    """``fn`` with one cell of its output flipped where it is produced."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        out.view(-1)[0] ^= 1
        return out

    return wrapper


#: the function that produces each configuration's board, by the rule's name
PRODUCERS = {
    "conway": "tpu_life_torch.backends.cuda_backend.packed_multi_step",
    "ising": "tpu_life_torch.kernels.mc_threefry.packed_metropolis_half",
}


def _patch(monkeypatch, dotted: str, make):
    module, name = dotted.rsplit(".", 1)
    target = __import__(module, fromlist=[name])
    monkeypatch.setattr(target, name, make(getattr(target, name)))


@pytest.mark.parametrize("cell", BOARD_CELLS)
def test_a_step_that_leaves_the_state_unchanged_is_caught(cell, monkeypatch):
    from tpu_life_torch.backends.torch_backend import DeviceRunner

    monkeypatch.setattr(DeviceRunner, "advance", lambda self, steps: None)
    assert _run(cell)["correct"] is False


@pytest.mark.parametrize("cell", BOARD_CELLS)
def test_a_cell_altered_where_it_is_produced_is_caught(cell, monkeypatch):
    rule = harness.load_cell(cell).config["rule"]
    _patch(monkeypatch, PRODUCERS[rule], _altered)
    assert _run(cell)["correct"] is False


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    r = harness.run_cell(cell, SEEDS[0], 1.0, False, control=True)
    assert r["correct"] is False
