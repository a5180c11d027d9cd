"""K2's device time (``chord_kernel``, ``chord_wide_kernel``) in the traced
window, microseconds a step."""


def read(run):
    tr = run.trace
    return tr["kernel_us"]["k2"] / tr["steps"] if tr and tr["kernel_us"]["k2"] else None
