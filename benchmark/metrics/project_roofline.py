"""The polygon projections' share of their roofline, %: the least time of
the traced window's ``project.points`` and projector calls (the
``transition.project`` span's count) at the HBM rate, with the bytes of
``harness/roofline_project.py`` for the configuration's generators and
storage units, over the span's device time there.  The network is read
from the ``reference/`` beside this file, so a copy of the benchmark reads
its own."""

from pathlib import Path

from harness import program_record, roofline_project
from reference import grid

REFERENCE = Path(__file__).resolve().parent.parent / "reference"

ELEM = {"float32": 4, "float64": 8}


def read(run):
    rec = program_record.record(run)
    span = rec["spans"].get("transition.project") if rec else None
    points = rec["counters"].get("project.points") if rec else None
    if not span or not span.get("device_ms") or not points:
        return None
    net, _ = grid.load(run.config["reference"]["network"], REFERENCE)
    least = roofline_project.bound_seconds(points, span["count"], len(net.gens), len(net.des),
                                           ELEM[run.config["dtype"]])
    return 100.0 * least / (span["device_ms"] / 1e3)
