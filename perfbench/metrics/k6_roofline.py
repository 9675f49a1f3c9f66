"""K6's share of its roofline (``packed_metropolis_half_kernel``): the
bound of the window's half-sweeps over their device time in the trace.
The cells whose move a draw decides are counted by the reference's plain
code on the lattice before the window's last chunk, for each colour, and
taken for every sweep of the window: in the settled critical regime the
count moves by well under a percent from sweep to sweep."""

import torch

from perfbench import rooflines
from perfbench.reference.ising import decided_cells

KERNELS = ("packed_metropolis_half_kernel",)


def read(r):
    if r.trace is None:
        return None
    launches, seconds = r.trace.kernels(*KERNELS)
    if not launches or not seconds:
        return None
    lattice = torch.from_numpy(r.work["board"]).to(r.device)
    n = rooflines.words(r.work["height"], r.work["width"])
    ops = r.work["steps"] * sum(rooflines.k6_ops(decided_cells(lattice, half), n)
                                for half in (0, 1))
    bound = rooflines.bound_s(ops, launches * rooflines.k6_bytes(n),
                              r.card["n_sm"], r.card["max_sm_clock_hz"])
    return 100.0 * bound / seconds
