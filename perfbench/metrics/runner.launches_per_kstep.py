"""K1 launches the Runner issued a thousand steps in the window
(``packed_stripe.packed_multi_step.launches``)."""

COUNTERS = ("tpu_life_torch.kernels.packed_stripe:packed_multi_step.launches",)


def read(r):
    launches = r.counters.get(COUNTERS[0])
    if not launches or not r.work.get("steps"):
        return None
    return launches / (r.work["steps"] / 1000.0)
