"""The yardstick of the kernels: the card's peaks and each kernel's
operations and bytes, counted from shapes.

The peaks are those of one NVIDIA H100 SXM: 64 logic or integer operations
a clock on each SM (the integer pipe issues ``LOP3``, ``SHF`` and ``IADD3``
at that rate), and 3.35 TB/s of HBM3.  The clock and the SM count are read
from the card in each run (:func:`card`); the published maximum, 1980 MHz
on 132 SMs, is the default.

A kernel's bound is the larger of its operations over the operation peak
and its bytes over the bandwidth; its roofline share is that bound over the
device time it took.  Each input byte is counted read once and each output
byte written once, whatever the kernel reads again, and the operations are
what the inputs need, not the most a kernel could do:

- K1 (``packed_stripe_kernel``) and its batch mode (``packed_batch_kernel``,
  ``packed_batch_segment_kernel``): 15 logic operations a 32-cell word a
  step, the carry-save adder tree and the rule with ``LOP3``; a launch
  reads and writes the board's words once.
- K6 (``packed_metropolis_half_kernel``): a half-sweep hashes only the
  cells whose move a draw decides (dE > 0), 39 integer-pipe operations
  each (word 0 of Threefry-2x32: 18 ``SHF`` and 19 ``LOP3``, the select of
  the table's entry and one compare), and 18 logic operations a word for
  the neighbour count and the masks; a launch reads and writes the
  lattice's words once.
"""

from __future__ import annotations

import subprocess

OPS_PER_CLOCK_SM = 64
HBM_BYTES_PER_S = 3.35e12
H100_SMS = 132
H100_MAX_SM_CLOCK_HZ = 1.98e9
WORD_BYTES = 4

K1_OPS_PER_WORD_STEP = 15
K6_OPS_PER_DECIDED_CELL = 39
K6_OPS_PER_WORD = 18


def words(height: int, width: int) -> int:
    """The 32-cell words of a packed ``height x width`` board."""
    return height * -(-width // 32)


def peak_ops_per_s(n_sm: int = H100_SMS, clock_hz: float = H100_MAX_SM_CLOCK_HZ) -> float:
    return OPS_PER_CLOCK_SM * n_sm * clock_hz


def bound_s(ops: float, nbytes: float, n_sm: int = H100_SMS,
            clock_hz: float = H100_MAX_SM_CLOCK_HZ) -> float:
    """The least time the card could take: operations or bytes, whichever
    binds."""
    return max(ops / peak_ops_per_s(n_sm, clock_hz), nbytes / HBM_BYTES_PER_S)


def k1_ops(n_words: int, steps: int) -> float:
    """K1 (either mode): ``steps`` substeps of ``n_words`` words."""
    return K1_OPS_PER_WORD_STEP * n_words * steps


def k1_bytes(n_words: int, launches: int) -> float:
    """K1 (either mode): each launch reads and writes the words once."""
    return 2 * WORD_BYTES * n_words * launches


def k6_ops(decided: int, n_words: int) -> float:
    """K6: one half-sweep of ``n_words`` words with ``decided`` cells whose
    move a draw decides."""
    return K6_OPS_PER_DECIDED_CELL * decided + K6_OPS_PER_WORD * n_words


def k6_bytes(n_words: int) -> float:
    """K6: one half-sweep reads and writes the lattice's words once."""
    return 2 * WORD_BYTES * n_words


def card() -> dict:
    """The card's name, power limit (W) and maximum SM clock (Hz) from
    ``nvidia-smi``, and its SM count; the published H100 numbers where a
    field cannot be read."""
    import torch

    out = {"name": torch.cuda.get_device_name(0), "power_limit_w": None,
           "max_sm_clock_hz": H100_MAX_SM_CLOCK_HZ,
           "n_sm": torch.cuda.get_device_properties(0).multi_processor_count}
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=power.limit,clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30,
        )
        limit, clock = (f.strip() for f in proc.stdout.strip().splitlines()[0].split(","))
        out["power_limit_w"] = float(limit)
        out["max_sm_clock_hz"] = float(clock) * 1e6
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        pass
    return out
