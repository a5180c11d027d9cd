"""The device's idle share of the measured window, %: 1 minus the device's
busy time a step (the union of the device events' spans in the traced
steps) over the mean step interval of the measured window.  The traced
window itself runs slower than the measured one (the profiler's cost on
the host), so its own idle share reads high where the host paces the
step; ``device.busy_s`` and ``window_s`` give that one."""


def read(run):
    tr = run.trace
    if not tr or not run.intervals_ms:
        return None
    step_us = 1e3 * sum(run.intervals_ms) / len(run.intervals_ms)
    return 100.0 * (1.0 - tr["busy_us"] / tr["steps"] / step_us)
