"""Device time of the ``transition.devices`` span in the traced window, ms a
step: loads, projections, storage, capacitors, OLTC, bus totals and the
chord's ΔY terms, everything of the transition before the chord solve."""

from harness import program_record


def read(run):
    return program_record.span_ms_per_step(run, "transition.devices")
