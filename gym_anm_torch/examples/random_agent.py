"""Interact with a gym-anm-torch environment using random actions.

    python -m gym_anm_torch.examples.random_agent [--cpu]

Port of ``examples/random_agent.py``: sample random actions on
``gym_anm_torch/ANM6Easy-v0``, rendering each step in the browser dashboard
(:mod:`gym_anm_torch.render`), and reset whenever a terminal state is
reached.
"""

import sys
import time

import gymnasium as gym

from .. import compat  # noqa: F401  (registers gym_anm_torch/ANM6Easy-v0)
from ..scripts.train_ppo_online import device_for


def run(steps=10, render=True, sleep=0.5, device="cuda", seed=None):
    """``steps`` random actions; returns the rewards."""
    env = gym.make("gym_anm_torch/ANM6Easy-v0", device=device)
    env.reset(seed=seed)
    env.action_space.seed(seed)
    rewards = []
    try:
        for _ in range(steps):
            o, r, terminated, _, _ = env.step(env.action_space.sample())
            rewards.append(r)
            if render:
                env.render()
                time.sleep(sleep)  # otherwise the rendering is too fast to watch
            if terminated:
                env.reset()
    finally:
        env.close()
    return rewards


if __name__ == "__main__":
    run(device=device_for("--cpu" in sys.argv[1:]))
