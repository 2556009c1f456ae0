"""device.idle: the share of the traced window in which no operation ran
on the device, in percent: 1 - (the union of the profiler's device
operations) / (the window's length on the host clock)."""

from pbench.trace import busy_s


def read(run):
    lo, hi = run.window
    if not run.ops or hi <= lo:
        return None
    return 100.0 * (1.0 - busy_s(run.ops, lo, hi) / (hi - lo))
