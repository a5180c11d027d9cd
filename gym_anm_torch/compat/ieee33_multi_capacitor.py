"""IEEE33 with 6 distributed capacitors (17-dim actions).

Port of ``gym_anm_tpu/compat/ieee33_multi_capacitor.py``.  Drop-in equivalent of ``gym_anm/envs/ieee33_env/ieee33_multi_capacitor.py``:
action layout [5 renewable P, 5 renewable Q, 6 cap Q, 1 OLTC tap].
"""

import numpy as np

from ..networks.ieee33 import create_multi_capacitor_network
from ..specs.constants import DEV_TYPE_CAPACITOR, DEV_TYPE_LOAD
from .ieee33 import IEEE33Env
from .ieee33_renewable import IEEE33RenewableEnv


class IEEE33MultiCapacitorEnv(IEEE33RenewableEnv):
    """Six capacitors instead of two — harder coordination problem."""

    def __init__(self, device="cuda", **kwargs):
        # Skip IEEE33RenewableEnv.__init__; start from the plain IEEE33 env
        # (ieee33_multi_capacitor.py:90-92).
        IEEE33Env.__init__(self, device=device)

        self.load_scale = kwargs.get("load_scale", 1.0)
        self.scenario = kwargs.get("scenario", "default")

        network = create_multi_capacitor_network()
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

        self.capacitor_ids = []
        self.capacitor_buses = []
        self.capacitor_ratings = []
        for dev_id, dev in self.simulator.devices.items():
            if dev.type == DEV_TYPE_CAPACITOR:
                self.capacitor_ids.append(dev_id)
                self.capacitor_buses.append(dev.bus_id)
                self.capacitor_ratings.append(dev.q_max * self.simulator.baseMVA)

    def get_capacitor_info(self):
        return {
            "num_capacitors": len(self.capacitor_ids),
            "capacitor_buses": self.capacitor_buses,
            "capacitor_ratings": self.capacitor_ratings,
        }
