"""Run the constant-forecast MPC policy on ANM6Easy-v0.

    python -m gym_anm_torch.examples.mpc_constant [--cpu]

Port of ``examples/mpc_constant.py``: the DC-OPF MPC agent
:class:`~gym_anm_torch.agents.MPCAgentConstant` assumes demand and
generation stay at their current values over the optimization horizon.
The agent solves its LP on the host (scipy's HiGHS); the environment's
float64 transition runs on ``device``.
"""

import sys

import gymnasium as gym

from .. import compat  # noqa: F401  (registers gym_anm_torch/ANM6Easy-v0)
from ..agents import MPCAgentConstant
from ..scripts.train_ppo_online import device_for


def run(steps=100, planning_steps=10, device="cuda", seed=None):
    """``steps`` steps under the agent; returns the rewards."""
    env = gym.make("gym_anm_torch/ANM6Easy-v0", device=device)
    env.reset(seed=seed)

    raw = env.unwrapped
    agent = MPCAgentConstant(raw.simulator, env.action_space, raw.gamma,
                     safety_margin=0.96, planning_steps=planning_steps)

    rewards = []
    for t in range(steps):
        a = agent.act(raw)
        obs, r, terminated, _, _ = env.step(a)
        print(f"t={t}, r_t={r:.3}")
        rewards.append(r)
    return rewards


if __name__ == "__main__":
    run(device=device_for("--cpu" in sys.argv[1:]))
