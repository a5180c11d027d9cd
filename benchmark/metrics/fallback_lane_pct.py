"""The share of the chord's lanes that the Newton fallback iterated in the
traced window, %: ``newton.lanes`` (lanes whose ``n_iter`` the fallback
raised) over ``chord.lanes``."""

from harness import program_record


def read(run):
    return program_record.counter_ratio(run, "newton.lanes", "chord.lanes", 100.0)
