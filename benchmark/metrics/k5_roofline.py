"""K5's share of its roofline, %: the least time of the traced window's ADMM
calls at their shapes and the sweeps that ``DCOPFSolution.iterations``
reports, over K5's device time there."""

from harness import roofline_k5


def read(run):
    tr = run.trace
    if not tr or not tr["kernel_us"]["k5"] or not tr["admm"]:
        return None
    least = sum(roofline_k5.bound_seconds(spec.n, spec.m, spec.check_every, run.batch, sweeps)
                for spec, sweeps in tr["admm"])
    return 100.0 * least / (tr["kernel_us"]["k5"] / 1e6)
