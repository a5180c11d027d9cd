"""The transition's flows' share of their roofline, %: the least time of the
traced window's ``flows.lanes`` (the lanes of the CUDA kernel's launches) and
``transition.flows`` calls at the HBM rate, with the bytes of
``harness/roofline_flows.py`` for the configuration's network, over the
span's device time there.  A program without the counter reads None.  The
network is read from the ``reference/`` beside this file, so a copy of the
benchmark reads its own."""

from pathlib import Path

from harness import program_record, roofline_flows
from reference import grid

REFERENCE = Path(__file__).resolve().parent.parent / "reference"

ELEM = {"float32": 4, "float64": 8}


def read(run):
    rec = program_record.record(run)
    span = rec["spans"].get("transition.flows") if rec else None
    lanes = rec["counters"].get("flows.lanes") if rec else None
    if not span or not span.get("device_ms") or not lanes:
        return None
    net, _ = grid.load(run.config["reference"]["network"], REFERENCE)
    least = roofline_flows.bound_seconds(lanes, span["count"], net, ELEM[run.config["dtype"]])
    return 100.0 * least / (span["device_ms"] / 1e3)
