"""K6 launches the Runner issued a thousand sweeps in the window
(``mc_threefry.packed_metropolis_half.launches``): two a sweep, one a
colour, until a sweep is one launch."""

COUNTERS = ("tpu_life_torch.kernels.mc_threefry:packed_metropolis_half.launches",)


def read(r):
    launches = r.counters.get(COUNTERS[0])
    if not launches or not r.work.get("steps"):
        return None
    return launches / (r.work["steps"] / 1000.0)
