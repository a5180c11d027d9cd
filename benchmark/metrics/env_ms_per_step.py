"""The env step's own device time in the traced window, ms a step: the
``env.step`` span's device interval less its ``transition`` child's (the
exogenous draw, reward, state update and observation)."""

from harness import program_record


def read(run):
    return program_record.span_ms_per_step(run, "env.step", "self_device_ms")
