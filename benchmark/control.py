"""Readings that a cell's correctness limits are set from.

    python3 benchmark/control.py --workload <name> --seconds <s> --seeds <n> [<n> ...] [--out <file>]

For each seed, in one process: the cell's set-up and a window of
``--seconds`` at its own load, then the numbers the check compares, once for
the program (its lower readings) and once for the control, the reference at
the precision below the configuration's (float32 with TF32 products) put in
the program's place on the same inputs (its upper readings).  One JSON line
a seed on standard output, and in ``--out`` when given.  The benchmark's own
runs do not run this.
"""

import argparse
import json
import sys
import time

import run  # noqa: F401  (run.py's cache directories and import paths)


def readings(spec, workload, seed, seconds, device="cuda", batch=None):
    """(program readings, control readings, the run's readings) of one seed."""
    import torch

    from harness import cell, check

    measured, loop = cell.run_cell(spec, workload, seed, seconds, 0, time.perf_counter(), device, batch)
    steps = [check.observe(c, i < measured.chained, device) for i, c in enumerate(loop.captures)]
    del loop
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ref = check.Reference(measured.config, measured.traffic, spec.bench_dir)
    prog, _ = check.judge(ref, steps, {})
    ctrl, _ = check.judge(ref, check.control_steps(ref, steps), {})
    return prog, ctrl, measured


def main(argv):
    from harness.spec import Spec

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out")
    a = p.parse_args(argv)
    spec = Spec()
    out = open(a.out, "a") if a.out else None
    try:
        for seed in a.seeds:
            prog, ctrl, measured = readings(spec, a.workload, seed, a.seconds)
            line = json.dumps({"workload": a.workload, "seed": seed, "steps": measured.steps, "program": prog,
                               "control": ctrl})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
