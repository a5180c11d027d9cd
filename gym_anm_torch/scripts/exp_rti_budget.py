"""RTI budget sweep: throughput AND closed-loop quality against ``max_iter``.

    python -m gym_anm_torch.scripts.exp_rti_budget [--budgets 48,96,200] [--cpu]

Port of ``scripts/exp_rti_budget.py``.  The MPC farm's cost is set by the
real-time-iteration budget (``make_vec_mpc(max_iter=)``).  For each budget,
on ANM6Easy at float32 under ``make_vec_mpc(planning_steps=1)``:

* full-day closed-loop quality: the mean reward per step over QUALITY =
  (256 lanes, 96 steps, one complete profile day), the same seed across
  budgets;
* throughput: env-steps/s of the farm (``act`` then
  ``step_autoreset_batch``) at THROUGHPUT = (8192 lanes, 64 steps, 3 reps)
  after a warm-up run; each rep timed with CUDA events after
  ``torch.cuda.synchronize()`` (the host clock on the CPU), the median of
  the reps.

Runs on the CUDA card, or on the CPU with ``--cpu``; without a card and
without ``--cpu`` it raises.  ``main(argv)`` returns {budget: (env-steps/s,
mean reward per step)}.
"""

import argparse
import statistics
import time

import torch

from ..vec import VecEnv, make_anm6easy_task, make_vec_mpc
from .train_ppo_online import device_for, device_name, on_card

QUALITY = (256, 96)  # lanes, steps
THROUGHPUT = (8192, 64, 3)  # lanes, steps, reps


def build_rollout(env, ctrl, batch, seed=0):
    """A reset of ``batch`` lanes and ``run(state, obs, carry, n_steps)``,
    which steps them ``n_steps`` times under ``ctrl`` and returns the new
    (state, obs, carry) and the per-step lane means of the reward [n_steps]."""
    g = torch.Generator(device=env.device).manual_seed(seed)
    state, obs = env.reset(batch, g)
    carry = ctrl.init_carry(batch)

    def run(state, obs, carry, n_steps):
        rs = []
        for _ in range(n_steps):
            a, carry = ctrl.act(None, state, obs, carry)
            state, obs, r, d, _ = env.step_autoreset_batch(state, a, g)
            rs.append(r.mean())
        return state, obs, carry, torch.stack(rs)

    return run, state, obs, carry


def _elapsed_s(device, fn):
    """Seconds of ``fn()``: CUDA events around it after a synchronisation on
    the card, the host clock on the CPU."""
    if not on_card(device):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def throughput(env, ctrl, batch, n_steps, n_reps):
    """Median env-steps/s over ``n_reps`` timed runs of ``n_steps`` steps."""
    run, *carry = build_rollout(env, ctrl, batch)
    carry = run(*carry, n_steps)[:3]  # warm-up
    rates = []
    for _ in range(n_reps):
        def rep():
            nonlocal carry
            carry = run(*carry, n_steps)[:3]

        rates.append(batch * n_steps / _elapsed_s(env.device, rep))
    return statistics.median(rates)


def quality(env, ctrl, batch, n_steps):
    run, state, obs, carry = build_rollout(env, ctrl, batch)
    return float(run(state, obs, carry, n_steps)[3].mean())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--budgets", default="48,96,200", help="comma-separated max_iter values")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    device = device_for(args.cpu)
    budgets = [int(x) for x in args.budgets.split(",")]
    env = VecEnv(make_anm6easy_task(), dtype=torch.float32, device=device)
    print(f"ANM6Easy MPC farm on {device} ({device_name(device)}); quality {QUALITY[0]} lanes x {QUALITY[1]} steps, "
          f"throughput {THROUGHPUT[0]} lanes x {THROUGHPUT[1]} steps, median of {THROUGHPUT[2]}")
    print(f"{'budget':>8} {'steps/s':>12} {'reward/step (full day)':>24}")
    out = {}
    for b in budgets:
        ctrl = make_vec_mpc(env, gamma=0.995, safety_margin=0.96, planning_steps=1, max_iter=b)
        q = quality(env, ctrl, *QUALITY)
        tp = throughput(env, ctrl, *THROUGHPUT)
        out[b] = (tp, q)
        print(f"{b:>8} {tp:>12.0f} {q:>24.4f}", flush=True)
    return out


if __name__ == "__main__":
    main()
