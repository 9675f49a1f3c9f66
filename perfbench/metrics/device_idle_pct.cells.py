"""The share of the traced window in which the device ran no kernel, copy
or set: 100 x (1 - busy_s / window_s).  Nothing where the trace saw no
device."""


def read(r):
    if r.trace is None or not r.trace.busy_s:
        return None
    return r.trace.idle_pct()
