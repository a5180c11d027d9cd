"""The controller's share of the device timeline, %: the intervals between
CUDA events recorded before and after each ``act`` of the measured window,
over the window's step intervals."""


def read(run):
    return 100.0 * run.act_ms / run.device_ms if run.act_ms is not None and run.device_ms else None
