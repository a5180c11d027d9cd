"""K2's share of its roofline, %: the least time of the traced window's chord
calls at their lane-iterations (``info["n_iter"]`` summed over the traced
steps) over K2's device time there."""

from harness import roofline_k2


def read(run):
    tr = run.trace
    if not tr or not tr["kernel_us"]["k2"]:
        return None
    n_ns = run.env_n[1] - 1
    least = roofline_k2.bound_seconds(n_ns, run.batch, tr["steps"], tr["lane_iterations"])
    return 100.0 * least / (tr["kernel_us"]["k2"] / 1e6)
