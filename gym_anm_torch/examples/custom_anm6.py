"""A custom task on the renderable ANM6 grid.

    python -m gym_anm_torch.examples.custom_anm6 [--cpu]

Port of ``examples/custom_anm6.py``: the same 6-bus 7-device network as
ANM6Easy-v0, but with fully random dynamics: random initial state, load
demands and maximum generations drawn uniformly inside their physical
limits each step (from the global ``np.random``), and the ANM6Easy
time-of-day auxiliary variable.  Because the class inherits
:class:`~gym_anm_torch.compat.ANM6`, browser rendering is available via
``env.render()``.
"""

import sys

import numpy as np

from ..compat import ANM6
from ..scripts.train_ppo_online import device_for


class CustomANM6Environment(ANM6):
    """A gym-anm task built on top of the ANM6 grid."""

    def __init__(self, device="cuda"):
        super().__init__(
            observation="state",       # fully observable
            K=1,                       # one auxiliary variable (time of day)
            delta_t=0.25,              # 15-minute intervals
            gamma=0.9,
            lamb=100,
            aux_bounds=np.array([[0, 10]]),
            costs_clipping=(1, 100),
            seed=1,
            device=device,
        )

    def init_state(self):
        """A uniformly random state vector; the day starts at 00:00."""
        sim = self.simulator
        n = 2 * sim.N_device + sim.N_des + sim.N_non_slack_gen
        return np.hstack((np.random.rand(n), 0))

    def next_vars(self, s_t):
        """Random demands/potentials inside each device's physical range:
        residential [-10, 0] MW, PV [0, 30] MW, industry [-30, 0] MW,
        wind [0, 50] MW, EV station [-30, 0] MW, then the time index."""
        draws = np.random.rand(5) * np.array([-10.0, 30.0, -30.0, 50.0, -30.0])
        aux = int((s_t[-1] + 1) % (24 / self.delta_t))
        return np.hstack((draws, aux))


def run(steps=10, device="cuda", seed=None):
    """``steps`` random actions, resetting on a terminal state; returns the
    rewards."""
    env = CustomANM6Environment(device=device)
    env.reset(seed=seed)
    env.action_space.seed(seed)
    rewards = []
    for t in range(steps):
        o, r, terminated, _, _ = env.step(env.action_space.sample())
        print(f"t={t}, r_t={r:.3}")
        rewards.append(r)
        if terminated:
            env.reset()
    return rewards


if __name__ == "__main__":
    run(device=device_for("--cpu" in sys.argv[1:]))
