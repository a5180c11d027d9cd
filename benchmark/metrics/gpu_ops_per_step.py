"""Device kernels, copies and sets in the traced window, a step."""


def read(run):
    tr = run.trace
    return tr["n_ops"] / tr["steps"] if tr else None
