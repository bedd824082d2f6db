"""The share of the traced window in which no kernel or copy ran on a
device, in %, the mean over the devices."""


def read(r):
    if r.trace is None or not r.trace.window_s:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
