"""A minimal custom environment on a 2-bus grid.

    python -m gym_anm_torch.examples.simple_env [--cpu]

Port of ``examples/simple_env.py``: slack generator (bus 0) --- load (bus
1), random initial states, random load demand in [-10, 0] and a (useless)
auxiliary variable.  The initial state and the load draw from the global
``np.random``, as in the JAX example.
"""

import sys

import numpy as np

from ..compat import ANMEnv
from ..networks import two_bus_network
from ..scripts.train_ppo_online import device_for


class SimpleEnvironment(ANMEnv):
    """An example of a simple 2-bus custom environment."""

    def __init__(self, device="cuda"):
        observation = "state"
        K = 1
        delta_t = 0.25
        gamma = 0.9
        lamb = 100
        aux_bounds = np.array([[0, 10]])
        costs_clipping = (1, 100)
        seed = 1
        super().__init__(two_bus_network, observation, K, delta_t, gamma, lamb,
                         aux_bounds, costs_clipping, seed, device=device)

    def init_state(self):
        n_dev = self.simulator.N_device
        n_des = self.simulator.N_des
        n_gen = self.simulator.N_non_slack_gen
        return np.random.rand(2 * n_dev + n_des + n_gen + self.K)

    def next_vars(self, s_t):
        P_load = -10 * np.random.rand(1)[0]
        aux = np.random.randint(0, 10)
        return np.array([P_load, aux])


def run(steps=10, device="cuda", seed=None):
    """``steps`` random actions (the JAX example's ``__main__``); returns the
    rewards."""
    env = SimpleEnvironment(device=device)
    env.reset(seed=seed)
    env.action_space.seed(seed)
    rewards = []
    for t in range(steps):
        a = env.action_space.sample()
        o, r, terminated, _, _ = env.step(a)
        print(f"t={t}, r_t={r:.3}")
        rewards.append(r)
    return rewards


if __name__ == "__main__":
    run(device=device_for("--cpu" in sys.argv[1:]))
