"""The program's own record of the traced window: the spans and counters of
``gym_anm_torch.utils.profiling``, which record while the profiler session of
``cell.traced`` is open.  A reader finds nothing (None) in a run without a
traced window, or where the program has no tracer or the record lacks what
it reads."""


def record(run):
    """``profiling.report()`` after a traced window, else None."""
    if not run.trace:
        return None
    from gym_anm_torch.utils import profiling

    report = getattr(profiling, "report", None)
    return report() if report is not None else None


def span_ms_per_step(run, name, key="device_ms"):
    """A span's device ms (``key``) over the traced steps, a step."""
    rec = record(run)
    entry = rec["spans"].get(name) if rec else None
    value = entry.get(key) if entry else None
    return value / run.trace["steps"] if value is not None else None


def counter_ratio(run, numerator, denominator, scale=1.0):
    """``scale`` times one counter's total over another's."""
    rec = record(run)
    counters = rec["counters"] if rec else {}
    if not counters.get(denominator) or numerator not in counters:
        return None
    return scale * counters[numerator] / counters[denominator]
