"""ADMM sweeps a lane of the MPC's DC-OPF solves in the traced window: the
``admm.sweeps`` counter (``DCOPFSolution.iterations``) over ``admm.lanes``."""

from harness import program_record


def read(run):
    return program_record.counter_ratio(run, "admm.sweeps", "admm.lanes")
