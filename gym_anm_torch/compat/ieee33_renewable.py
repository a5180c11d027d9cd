"""IEEE33 with renewable generators and time-varying loads.

Port of ``gym_anm_tpu/compat/ieee33_renewable.py``.  Drop-in equivalent of
``gym_anm/envs/ieee33_env/ieee33_renewable_complete.py:91-262``, preserving
its behavioral quirks, which downstream controllers depend on:

* the parent is constructed on the BASE network first, so the state /
  observation vectors keep the base network's 72 entries even after the
  simulator is swapped for the 41-device renewable network;
* ``next_vars`` returns negative-MW loads (the "Expert 2 fix") but ZERO
  renewable potentials, so inside the transition every renewable's p_pot is
  clipped to 0 — the externally-set ``device.p_pot`` values only influence
  what controllers read between steps;
* global ``np.random`` drives all stochasticity (reset(seed=) reseeds the
  global RNG);
* branch rates are overwritten with tiered values on every reset
  (the base network ships rate=0 on every branch).
"""

import numpy as np

from ..networks.ieee33 import create_renewable_network
from ..specs.constants import DEV_TYPE_LOAD, DEV_TYPE_RENEWABLE_GEN
from .ieee33 import IEEE33Env


class IEEE33RenewableEnv(IEEE33Env):
    """IEEE33 + 5 renewables (3 solar, 2 wind), 13-dim actions."""

    def __init__(self, load_scale=1.0, scenario="default", device="cuda", **kwargs):
        self.load_scale = load_scale
        self.scenario = scenario

        super().__init__(device=device)

        # Swap in the renewable network and rebuild the spaces
        # (ieee33_renewable_complete.py:110-120).
        network = create_renewable_network()
        from ..env.simulator import Simulator

        self.simulator = Simulator(network, delta_t=self.delta_t, lamb=self.lamb, device=device)

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

    def init_state(self):
        n_dev = self.simulator.N_device
        n_des = self.simulator.N_des
        n_gen = self.simulator.N_non_slack_gen
        state = np.zeros(2 * n_dev + n_des + n_gen + self.K)
        # Small random perturbation for stability (uses the global RNG).
        state += np.random.normal(0, 0.001, size=state.shape)
        return state

    def reset(self, seed=None, options=None):
        if seed is not None:
            np.random.seed(seed)

        self.timestep = 0
        self.hour_of_day = np.random.uniform(0, 24)

        obs, info = super().reset(seed=seed, options=options)

        self._fix_branch_rates()
        self._update_renewable_potential()
        return obs, info

    def step(self, action):
        self.timestep += 1
        # NB: delta_t/3600 — the reference advances the clock by 1 second of
        # simulated time per 1-hour step; kept as-is for parity.
        self.hour_of_day = (self.hour_of_day + self.delta_t / 3600) % 24
        self._update_renewable_potential()
        return super().step(action)

    def next_vars(self, s_t):
        """Loads in negative MW with time-of-day + noise factors; renewable
        potentials left at zero (ieee33_renewable_complete.py:188-214)."""
        n_vars = self.simulator.N_load + self.simulator.N_non_slack_gen + self.K
        vars = np.zeros(n_vars)

        hour = self.hour_of_day
        time_factor = 0.8 + 0.3 * np.sin((hour - 3) * np.pi / 12)
        scale = (
            self._load_scale_override
            if self._load_scale_override is not None
            else self.load_scale
        )

        for idx, dev_id in enumerate(self._load_ids):
            if idx < self.simulator.N_load:
                dev = self.simulator.devices[dev_id]
                nominal_mw = abs(dev.p_min) * self.simulator.baseMVA
                noise = 1.0 + np.random.normal(0, 0.02)
                vars[idx] = -nominal_mw * scale * time_factor * noise
        return vars

    def _update_renewable_potential(self):
        """Diurnal solar/wind potential written onto the device views
        (ieee33_renewable_complete.py:216-243)."""
        hour = self.hour_of_day
        solar_factor = np.sin((hour - 6) * np.pi / 12) if 6 <= hour <= 18 else 0
        wind_factor = 0.6 + 0.4 * np.cos((hour - 6) * np.pi / 12)

        if self.scenario == "high_renewable":
            solar_factor *= 1.2
            wind_factor *= 1.2
        elif self.scenario == "low_renewable":
            solar_factor *= 0.5
            wind_factor *= 0.5

        for dev_id, device in self.simulator.devices.items():
            if device.type == DEV_TYPE_RENEWABLE_GEN:
                if dev_id in (36, 37, 38):  # solar
                    device.p_pot = device.p_max * solar_factor
                else:  # wind (39, 40)
                    device.p_pot = device.p_max * wind_factor

    def _fix_branch_rates(self):
        """Replace the all-zero stock rates with tiered limits
        (ieee33_renewable_complete.py:245-262); called on every reset."""
        for i, branch in enumerate(self.simulator.branches.values()):
            if i < 5:
                branch.rate = 1.2
            elif i < 15:
                branch.rate = 0.5
            elif i < 25:
                branch.rate = 0.3
            else:
                branch.rate = 0.2
