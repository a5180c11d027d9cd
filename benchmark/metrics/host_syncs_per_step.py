"""CUDA runtime synchronize calls among the profiler's host events of the
traced window, a step (a device-to-host read such as ``bool(t.any())``
synchronizes once)."""


def read(run):
    tr = run.trace
    return tr["syncs"] / tr["steps"] if tr else None
