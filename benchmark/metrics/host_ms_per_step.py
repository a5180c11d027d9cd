"""The benchmark's host-clock span around each step call of the measured
window (the action's draw or ``act``, and the env step), with no
synchronize: the host's enqueue time a step, mean over the window."""


def read(run):
    return 1e3 * sum(run.host_s) / len(run.host_s) if run.host_s else None
