"""The base IEEE 33-bus voltage-control environment.

Port of ``gym_anm_tpu/compat/ieee33.py``.  Drop-in equivalent of ``gym_anm/envs/ieee33_env/ieee33.py:6-41``: fully
observable, K=0, Δt=1h, γ=0.99, λ=100, 3-dim action [Q_cap8, Q_cap25, tap].

The ``init_state`` keeps the reference's units quirk: loads are initialized
with their per-unit ``p_min`` written into the MW slot of the state vector,
so initial loads come out at 1/baseMVA of nominal (SURVEY.md §2.2(6)).
"""

import numpy as np

from ..networks.ieee33 import network
from .anm_env import ANMEnv


class IEEE33Env(ANMEnv):
    """ANM environment on the (meshed) IEEE 33-bus system."""

    metadata = {"render_modes": []}

    def __init__(self, device="cuda"):
        observation = "state"
        K = 0
        delta_t = 1.0
        gamma = 0.99
        lamb = 100
        super().__init__(network, observation, K, delta_t, gamma, lamb, device=device)

    def init_state(self):
        n_dev = self.simulator.N_device
        n_des = self.simulator.N_des
        n_gen = self.simulator.N_non_slack_gen
        state = np.zeros(2 * n_dev + n_des + n_gen + self.K)

        # Loads at their "nominal" demand — p.u. value in a MW slot,
        # reproducing the reference exactly (ieee33.py:25-37).
        for dev_id, dev in self.simulator.devices.items():
            if dev.is_slack:
                continue
            p = dev.p_min
            q = p * dev.qp_ratio if dev.qp_ratio is not None else 0.0
            state[dev_id] = p
            state[n_dev + dev_id] = q
        return state

    def next_vars(self, s_t):
        return np.zeros(self.simulator.N_load + self.simulator.N_non_slack_gen + self.K)
