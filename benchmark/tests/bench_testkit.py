"""Small runs of the benchmark's cells on the CPU for its tests."""

import copy
import time

from harness import cell, check
from harness.spec import Spec


def steps_of(workload, batch, n_steps=3, dtype=None, traffic=None, seed=20240601, spec=None, chained=1):
    """(Reference, checked steps): a cell's loop on the CPU at ``batch`` lanes,
    every step of ``n_steps`` checked, the first ``chained`` of them with the
    reference's own controller state; ``dtype`` and ``traffic`` replace the
    configuration's precision and parts of its traffic."""
    spec = spec or Spec()
    w = spec.workload(workload)
    config, tr = copy.deepcopy(spec.config(w["config"])), copy.deepcopy(spec.traffic(w["traffic"]))
    if dtype:
        config["dtype"] = dtype
    tr.update(traffic or {})
    loop = cell.Loop(*cell.make_cell(config, tr, seed, "cpu", batch))
    for k in range(n_steps):
        loop.step(capture=True)
    steps = [check.observe(c, i < chained, "cpu") for i, c in enumerate(loop.captures)]
    return check.Reference(config, tr), steps


def measure(monkeypatch, workload, batch, trace=0, seed=987654321987, check_at=(0, 1, 2)):
    """The result of a whole run of ``workload`` on the CPU (the harness's
    look for a card skipped), its window short and its checked steps the
    first few."""
    from harness import cli

    monkeypatch.setattr(cell, "check_steps", lambda traffic, seed: set(check_at))
    return cli.measure(Spec(), workload, seed, 0.3, trace, time.perf_counter(), device="cpu", batch=batch)


WORKLOADS = [w["name"] for w in Spec().doc["workloads"]]
