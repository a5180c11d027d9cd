"""The device's idle after the program's host reads in the traced window, ms
a step: the mean idle from a read's mark on the stream to the record's next
mark, over the reads that have one, times the reads (``host_reads.*``) a
step."""

from harness import program_record


def read(run):
    rec = program_record.record(run)
    if not rec:
        return None
    idle = rec["read_idle"].values()
    measured = sum(e["measured"] for e in idle)
    if not measured:
        return None
    reads = sum(v for k, v in rec["counters"].items() if k.startswith("host_reads."))
    return sum(e["idle_ms"] for e in idle) / measured * reads / run.trace["steps"]
