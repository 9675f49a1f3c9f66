"""The share of the traced window in which the device ran nothing while
the Runner advanced or synced: 100 x the device's idle seconds inside the
program's spans ``runner.advance`` and ``runner.sync`` (``DeviceRunner``)
over the window.  The idle under ``runner.snapshot``, the harness's copy
for its end check, is left out.  Nothing where the trace holds neither
span or saw no device."""

from perfbench import program_spans

program_spans.install()

SPANS = ("tpu_life_torch.runner.advance", "tpu_life_torch.runner.sync")


def read(r):
    if r.trace is None or not r.trace.busy_s:
        return None
    found = [r.trace.program[s] for s in SPANS if s in r.trace.program]
    if not found:
        return None
    return 100.0 * sum(idle for _, _, idle in found) / r.trace.window_s
