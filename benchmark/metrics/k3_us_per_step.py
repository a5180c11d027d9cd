"""K3's device time (``newton_kernel``, ``newton_wide_kernel``,
``newton_cluster_kernel``: the Newton fallback's one cooperative launch a
step) in the traced window, microseconds a step."""


def read(run):
    tr = run.trace
    return tr["kernel_us"]["k3"] / tr["steps"] if tr and tr["kernel_us"]["k3"] else None
