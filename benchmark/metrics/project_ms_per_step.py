"""Device time of the ``transition.project`` span in the traced window, ms
a step: the generators' and the storage units' polygon projections (a child
of ``transition.devices``)."""

from harness import program_record


def read(run):
    return program_record.span_ms_per_step(run, "transition.project")
