"""Device busy time outside K2, K3 and K5 (the union of the other device
events' spans) in the traced window, ms a step: the transition's and the
controller's elementwise work."""


def read(run):
    tr = run.trace
    return tr["other_busy_us"] / 1e3 / tr["steps"] if tr and tr["other_busy_us"] else None
