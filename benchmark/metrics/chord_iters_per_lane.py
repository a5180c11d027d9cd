"""The chord solve's iterations a lane in the traced window: the
``chord.lane_iterations`` counter (each lane's ``n_iter`` from the chord)
over ``chord.lanes``."""

from harness import program_record


def read(run):
    return program_record.counter_ratio(run, "chord.lane_iterations", "chord.lanes")
