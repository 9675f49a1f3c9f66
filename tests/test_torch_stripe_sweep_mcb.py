"""The ``mcb`` mode of ``tpu_life_torch/experiments/stripe_sweep.py`` on the
CPU, at a small size: the batch modes of K6 and K7 (their plain versions,
which the wrappers take on CPU tensors) held to their plain versions, the
decided cells and the bounds counted, the single-board controls and the
sweep read, with the profiler's device times and the card's clock stood in
for (the mode times the kernels on the card only)."""

import pytest
import torch

from tpu_life_torch.experiments import stripe_sweep


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(stripe_sweep, "_device_ms", lambda launch, reps, names=(): (launch(), 1.0)[1])
    monkeypatch.setattr(stripe_sweep, "_chunk_device_ms",
                        lambda launch, reps, names: (launch(), (2.0, 8))[1])
    monkeypatch.setattr(stripe_sweep, "_clock_and_sms", lambda device: (1.98e9, 132))
    for name, value in (("MCB_SIDE", 64), ("MCB_ROLL_SIDE", 32), ("MCB_STEPS", 4),
                        ("K6_SIDES", (32, 64)), ("K6_SWEEPS", 2)):
        monkeypatch.setattr(stripe_sweep, name, value)


def test_mcb_reads_both_batch_modes_the_controls_and_the_sweep(small):
    recs = stripe_sweep.mcb_cases(torch.device("cpu"))
    k6b, k7b, k6_full, k6_seeded, k7, sweep = recs
    assert k6b["kernel"] == "K6 batch" and k6b["shape"] == [8, 64, 64]
    assert 0 < k6b["decided"] <= 8 * 64 * 64 // 2
    # the bound: 39 integer-pipe ops a decided cell and 18 a word at 64 a
    # clock an SM, 132 SMs at 1980 MHz
    want = (k6b["decided"] * 39 + 18 * 8 * 64 * 2) / 64 / (132 * 1.98e9) * 1e3
    assert k6b["bound_ms"] == pytest.approx(want, rel=1e-12)
    assert k7b["shape"] == [8, 32, 32]
    assert k7b["bound_ms"] == pytest.approx(8 * 32 * 32 * 37 / 64 / (132 * 1.98e9) * 1e3,
                                            rel=1e-12)
    assert (k6_full["kernel"], k6_full["shape"], k6_seeded["shape"]) == ("K6", [64, 64], [32, 32])
    assert k7["kernel"] == "K7" and k7["shape"] == [64, 64]
    assert sweep["elapsed_s"] > 0 and sweep["rounds"] >= 1
    # the CPU runs the plain versions: no kernel launched
    assert set(sweep["launches"].values()) == {0}
