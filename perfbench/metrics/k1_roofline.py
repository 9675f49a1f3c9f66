"""K1's share of its roofline (``packed_stripe_kernel``): the bound of the
steps the window's launches did, over their device time in the trace."""

from perfbench import rooflines

KERNELS = ("packed_stripe_kernel",)


def read(r):
    if r.trace is None:
        return None
    launches, seconds = r.trace.kernels(*KERNELS)
    if not launches or not seconds:
        return None
    n = rooflines.words(r.work["height"], r.work["width"])
    bound = rooflines.bound_s(rooflines.k1_ops(n, r.work["steps"]),
                              rooflines.k1_bytes(n, launches),
                              r.card["n_sm"], r.card["max_sm_clock_hz"])
    return 100.0 * bound / seconds
