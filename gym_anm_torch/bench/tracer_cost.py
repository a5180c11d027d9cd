"""The tracer's cost while it records, on the card.

Two closed loops: IEEE33 at 262144 lanes under uniform random actions
(``VecEnv.step``) and ANM6Easy at 16384 lanes under the 8-stage perfect-
forecast MPC (``act``, then ``step_autoreset_batch``).  Each loop is timed
with ``profiling.recording()`` closed and open, in turns (closed, open, open,
closed, closed, open), outside any profiler: host clock from a synchronize
to a synchronize over ``--steps-ieee33`` or ``--steps-mpc`` steps.  Prints
one JSON line: the card, its power limit, and per loop each run's ms a
step, the medians, the cost of recording as a share of the closed median,
and the open runs' ``report()`` time, its spans' device ms a step and the
card's lag behind the host at each span's entry.

    python -m gym_anm_torch.bench.tracer_cost [--steps-ieee33 200] [--steps-mpc 60]
"""

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time

import torch

from ..utils import profiling
from ..vec import VecEnv, make_anm6easy_task, make_ieee33_task
from ..vec.mpc import make_vec_mpc_perfect

ORDER = (False, True, True, False, False, True)


def ieee33_loop(seed, B=262144, device="cuda"):
    env = VecEnv(make_ieee33_task(), dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    state, _ = env.reset(B, gen)
    lo, hi = env.action_low, env.action_high

    def step(state):
        u = torch.rand(B, env.n_action, generator=gen, device=device)
        return env.step(state, lo + u * (hi - lo), gen)[0]

    return state, step


def mpc_loop(seed, B=16384, device="cuda"):
    env = VecEnv(make_anm6easy_task(), dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    ctrl = make_vec_mpc_perfect(env, gamma=0.995, safety_margin=0.96, planning_steps=8, max_iter=48)
    state, obs = env.reset(B, gen)
    carry = [ctrl.init_carry(B), obs]

    def step(state):
        action, carry[0] = ctrl.act(None, state, carry[1], carry[0])
        action = torch.clamp(action, env.action_low, env.action_high)
        state, carry[1], _, _, _ = env.step_autoreset_batch(state, action, gen)
        return state

    return state, step


def timed(state, step, n, record):
    """(ms a step, state, report or None, report's seconds)."""
    torch.cuda.synchronize()
    with profiling.recording() if record else contextlib.nullcontext():
        t0 = time.perf_counter()
        for _ in range(n):
            state = step(state)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / n
    if not record:
        return ms, state, None, None
    t1 = time.perf_counter()
    rep = profiling.report()
    return ms, state, rep, time.perf_counter() - t1


def lag_at_entry(raw):
    """Each span's mean lag of the card behind the host at its entry, ms:
    the device mark's time less the host's, both on the host clock."""
    lags = {}
    for r in raw:
        if r["device_ns"] is not None:
            lags.setdefault(r["name"], []).append((r["device_ns"][0] - r["host_ns"][0]) / 1e6)
    return {k: statistics.mean(v) for k, v in lags.items()}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps-ieee33", type=int, default=200)
    p.add_argument("--steps-mpc", type=int, default=60)
    p.add_argument("--seed", type=int, default=2147483659)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    out = {"card": card}
    for name, make, n in (("ieee33-b262144", ieee33_loop, a.steps_ieee33), ("anm6easy-mpc8-b16384", mpc_loop,
                                                                              a.steps_mpc)):
        state, step = make(a.seed)
        for _ in range(4):  # warm-up: every shape, the kernels' load
            state = step(state)
        runs = {"closed": [], "open": []}
        reports = []
        for record in ORDER:
            ms, state, rep, rep_s = timed(state, step, n, record)
            runs["open" if record else "closed"].append(ms)
            if rep is not None:
                reports.append({"report_s": rep_s, "spans_device_ms_per_step": {
                    k: (v["device_ms"] / n if v["device_ms"] is not None else None) for k, v in rep["spans"].items()},
                    "lag_ms_at_entry": lag_at_entry(rep["raw"]), "counters": rep["counters"],
                    "read_idle": rep["read_idle"], "launches": rep["launches"]})
        med = {k: statistics.median(v) for k, v in runs.items()}
        out[name] = {"steps": n, "ms_per_step": runs, "median": med,
                     "cost_pct": 100.0 * (med["open"] / med["closed"] - 1.0), "reports": reports}
        del state, step
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
