"""``python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>``

Runs one cell once on the card it is started on and prints, as the last
line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer metrics), ``device``, ``breakdown`` (traced runs),
``checked`` (the steps and lanes the check read, and how many of those
lanes the program reset) and, last, ``compared`` (each number the
correctness check compared, beside its limit).  Exits non-zero, printing no result, without CUDA, with fewer cards
than the cell asks for, or when a forbidden module is loaded.
"""

import argparse
import json
import subprocess
import sys
import time

import torch

from . import cell, check, guard
from .spec import Spec


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def power_limit():
    """``nvidia-smi``'s name and power limit of the card, for the log."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def measure(spec, workload, seed, seconds, trace, t0, device="cuda", batch=None):
    """One run of a cell and its check; returns the result line's object."""
    w = spec.workload(workload)
    run, loop = cell.run_cell(spec, workload, seed, seconds, trace, t0, device, batch)
    found = guard.loaded()
    if found:
        raise ImportError(f"forbidden modules loaded after the window: {found}")
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.metrics(workload, kind):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    log(f"{workload} seed {seed}: {run.steps} steps of {run.batch} lanes in {run.window_s:.4f} s; "
        f"{cell.summary(run)}; set-up {run.setup_s:.4f} s")
    # Free the program's state before the reference runs: only the checked steps stay.
    steps = [check.observe(c, i < run.chained, device) for i, c in enumerate(loop.captures)]
    del loop
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    limits = spec.limits(workload)
    ref = check.Reference(run.config, run.traffic, spec.bench_dir)
    t_check = time.perf_counter()
    readings, failed = check.judge(ref, steps, limits)
    log(f"check: {len(steps)} steps of {run.batch} lanes ({run.chained} chained from the reset), "
        f"{readings['reset_lanes']} lanes reset, against the reference in {time.perf_counter() - t_check:.2f} s")
    correct = check.verdict(readings, limits)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": w["chips"],
           "memory_peak_bytes": run.peak_bytes} if device == "cuda" else {"platform": "cpu", "kind": "cpu",
                                                                         "count": 1, "memory_peak_bytes": 0}
    result = {"correct": correct, "attempted": run.steps * run.batch, "failed": failed, "metrics": metrics,
              "device": dev}
    if trace:
        tr = run.trace
        dev.update(busy_s=tr["busy_us"] / 1e6, window_s=tr["window_us"] / 1e6)
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    result["checked"] = {"steps": len(steps), "chained": run.chained, "lanes": len(steps) * run.batch,
                         "reset_lanes": readings["reset_lanes"]}
    result["compared"] = check.lines(readings, limits)
    return result


def main(argv, t0):
    a = _args(argv)
    spec = Spec()
    chips = spec.workload(a.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(power_limit())
    result = measure(spec, a.workload, a.seed, a.seconds, a.trace, t0)
    found = guard.loaded()
    if found:
        log(f"forbidden modules loaded: {found}")
        return 3
    for k, v in result["compared"].items():
        log(f"compared {k}: {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0
