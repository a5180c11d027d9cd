"""IEEE33 with 6 capacitors of very unequal sizes + switching costs.

Port of ``gym_anm_tpu/compat/ieee33_unequal_capacitors.py``.  Equivalent of ``gym_anm/envs/ieee33_env/ieee33_unequal_capacitors.py``,
with one deliberate fix: the reference never actually installs its
unequal-capacitor network (its ``__init__`` calls the renewable parent with
the stock 2-capacitor grid), so ``step()`` crashes upstream with a broadcast
error when it tries to read six capacitor actions from a 13-dim action
vector (verified against the reference on 2026-08-16).  Here the
6-capacitor network IS installed, giving the documented 17-dim action
space [5 renewable P, 5 renewable Q, 6 cap Q, 1 tap] and functional
per-step switching-cost accounting.
"""

import numpy as np

from ..networks.ieee33 import create_unequal_capacitor_network
from ..specs.constants import DEV_TYPE_CAPACITOR, DEV_TYPE_LOAD
from .ieee33 import IEEE33Env
from .ieee33_renewable import IEEE33RenewableEnv


class IEEE33UnequalCapacitorsEnv(IEEE33RenewableEnv):
    """Unequal capacitors: sizes [3.0, 1.5, 1.2, 0.5, 0.3, 0.1] (nominal
    MVAr labels; stored in p.u. of the 10 MVA base like the reference)."""

    def __init__(self, switching_cost_multiplier=1.0, device="cuda", **kwargs):
        self.switching_cost_multiplier = switching_cost_multiplier

        IEEE33Env.__init__(self, device=device)
        self.load_scale = kwargs.get("load_scale", 1.0)
        self.scenario = kwargs.get("scenario", "default")

        network = create_unequal_capacitor_network()
        from ..env.simulator import Simulator

        self.simulator = Simulator(network, delta_t=self.delta_t, lamb=self.lamb, device=device)

        # Unlike the renewable/multi-cap variants (which keep the base
        # network's 72-entry state for reference parity), this env removes
        # devices 8/9, so the state plan must be rebuilt for the new grid.
        self.state_values = self._expand_all_ids(
            [
                ("dev_p", "all", "MW"),
                ("dev_q", "all", "MVAr"),
                ("des_soc", "all", "MWh"),
                ("gen_p_max", "all", "MW"),
                ("aux", "all", None),
            ]
        )
        self.state_N = sum(len(s[1]) for s in self.state_values)

        self.action_space = self._build_action_space()
        self.obs_values = self._build_observation_space("state")
        self.observation_space = self.observation_bounds()
        if self.observation_space is not None:
            self.observation_N = self.observation_space.shape[0]

        self.state = self.init_state()
        self.terminated = False
        self.timestep = 0
        self.hour_of_day = np.random.uniform(0, 24)
        self._load_scale_override = None

        self._load_ids = [
            dev_id for dev_id, dev in self.simulator.devices.items() if dev.type == DEV_TYPE_LOAD
        ]
        self.total_nominal_load = (
            sum(abs(self.simulator.devices[i].p_min) for i in self._load_ids)
            * self.simulator.baseMVA
        )

        self.capacitor_ids = []
        self.capacitor_buses = []
        self.capacitor_ratings = []
        for dev_id, dev in self.simulator.devices.items():
            if dev.type == DEV_TYPE_CAPACITOR:
                self.capacitor_ids.append(dev_id)
                self.capacitor_buses.append(dev.bus_id)
                self.capacitor_ratings.append(dev.q_max * self.simulator.baseMVA)

        # Sort by rating, largest first (ieee33_unequal_capacitors.py:118-122).
        order = sorted(
            range(len(self.capacitor_ratings)),
            key=lambda i: self.capacitor_ratings[i],
            reverse=True,
        )
        self.capacitor_ids = [self.capacitor_ids[i] for i in order]
        self.capacitor_buses = [self.capacitor_buses[i] for i in order]
        self.capacitor_ratings = [self.capacitor_ratings[i] for i in order]

        self.prev_capacitor_states = np.zeros(len(self.capacitor_ids))
        self.total_switches = 0
        self.switching_costs = 0.0
        self.base_switching_costs = [
            0.01 * rating * self.switching_cost_multiplier for rating in self.capacitor_ratings
        ]

    def step(self, action):
        """Track switching costs for capacitor actions (indices 10:16)."""
        cap_actions = action[10:16]
        switches = np.abs(cap_actions - self.prev_capacitor_states) > 0.01
        step_switching_cost = np.sum(switches * self.base_switching_costs)
        self.total_switches += np.sum(switches)
        self.switching_costs += step_switching_cost
        self.prev_capacitor_states = cap_actions.copy()

        obs, reward, terminated, truncated, info = super().step(action)
        reward -= step_switching_cost
        info["switching_cost"] = step_switching_cost
        info["total_switches"] = self.total_switches
        info["cumulative_switching_cost"] = self.switching_costs
        return obs, reward, terminated, truncated, info

    def get_capacitor_info(self):
        return {
            "num_capacitors": len(self.capacitor_ids),
            "capacitor_buses": self.capacitor_buses,
            "capacitor_ratings": self.capacitor_ratings,
            "switching_costs": self.base_switching_costs,
        }
