"""Device time of the ``transition.flows`` span in the traced window, ms a
step: currents, slack injection, branch flows and reward, everything of the
transition after the load flow."""

from harness import program_record


def read(run):
    return program_record.span_ms_per_step(run, "transition.flows")
