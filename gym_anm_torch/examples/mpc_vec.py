"""Batched MPC-in-the-loop rollouts on the vec tier.

    python -m gym_anm_torch.examples.mpc_vec [--cpu]

Port of ``examples/mpc_vec.py``.  The host agents (:mod:`.mpc_constant` /
:mod:`.mpc_perfect`) solve one LP per step on the host; here the SAME
DC-OPF runs as a batched ADMM on the env's device (``gym_anm_torch.vec.
mpc``, one launch of the CUDA kernel ``csrc/admm_dcopf.cu`` per step on the
card), so a whole farm of ANM6Easy lanes rolls out under MPC control with
no host round-trip inside the controller: the regime used for MPC-expert
offline dataset generation.

Sweeps the planning horizon to show what foresight buys: the
constant-forecast policy (reference ``MPCAgentConstant``) vs the
perfect-forecast policy (``MPCAgentPerfect``) at several N.  Every policy
starts from the same reset states, drawn by a host generator seeded with
``seed``: the same states on every device.
"""

import sys
import time

import torch

from ..offline_vec import evaluate_controller_vec
from ..scripts.train_ppo_online import device_for
from ..vec import VecEnv, make_anm6easy_task, make_vec_mpc, make_vec_mpc_perfect


def run(batch=16, steps=96, horizons=(2, 4, 8), seed=0, device="cuda"):
    """Mean reward per step of each policy over ``batch`` lanes x ``steps``
    steps; returns {policy name: mean reward}."""
    # Horizons up to N=8: the float32 ADMM tier is validated there.  At N=16
    # the JAX package measured the f32 iterate drifting slightly infeasible
    # (flagged and replaced by the idle fallback): use dtype=float64 there.
    env = VecEnv(make_anm6easy_task(), dtype=torch.float32, device=device)
    out = {}

    def show(name, ctrl):
        t0 = time.perf_counter()
        g = torch.Generator().manual_seed(seed)
        m = evaluate_controller_vec(env, ctrl, g, batch=batch, steps=steps)
        print(f"{name:>18}: mean reward/step {m:+.4f} ({time.perf_counter() - t0:.1f}s)")
        out[name] = m

    print(f"ANM6Easy farm, B={batch}, {steps} steps (one day), seed {seed}, on {env.device}")
    show("constant N=1", make_vec_mpc(env, gamma=0.995, safety_margin=0.96, planning_steps=1))
    for n in horizons:
        show(f"perfect N={n}", make_vec_mpc_perfect(env, gamma=0.995, safety_margin=0.96, planning_steps=n))
    return out


if __name__ == "__main__":
    run(device=device_for("--cpu" in sys.argv[1:]))
