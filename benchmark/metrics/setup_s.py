"""From the start of the benchmark's process to the opening of the window:
imports, the kernels' build or load, the tables, the reset and the warm-up."""


def read(run):
    return run.setup_s
