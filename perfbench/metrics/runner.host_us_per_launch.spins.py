"""The Runner's host time a K6 launch: the seconds of the program's span
``runner.advance`` (``DeviceRunner.advance`` over
``MCPackedDeviceRunner``'s sweep loop) in the traced window, in
microseconds, over the window's K6 launches
(``mc_threefry.packed_metropolis_half.launches``).  Nothing where the
trace holds no such span or saw no device."""

from perfbench import program_spans

program_spans.install()

SPAN = "tpu_life_torch.runner.advance"
COUNTERS = ("tpu_life_torch.kernels.mc_threefry:packed_metropolis_half.launches",)


def read(r):
    if r.trace is None or not r.trace.busy_s:
        return None
    span = r.trace.program.get(SPAN)
    launches = r.counters.get(COUNTERS[0])
    if not span or not launches:
        return None
    return span[1] * 1e6 / launches
