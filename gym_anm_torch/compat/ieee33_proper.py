"""Port of ``gym_anm_tpu/compat/ieee33_proper.py``.

The "proper" IEEE33 environment the reference's root scripts standardize
on: multi-capacitor grid + true nominal loads + non-zero branch rates.

Drop-in equivalent of ``ready_to_use_l5_implementation.py:18-72``
(``IEEE33ProperEnvironment``): fixes the base env's two units quirks by
(a) returning loads as true negative MW scaled by ``load_scale`` from
``next_vars`` and (b) overwriting the all-zero branch rates with the tiered
1.2/0.5/0.3/0.2 p.u. limits on every reset.
"""

import numpy as np

from .ieee33_multi_capacitor import IEEE33MultiCapacitorEnv

# Tiered p.u. flow limits by branch position (ready_to_use:63-71).
_RATE_TIERS = ((5, 1.2), (15, 0.5), (25, 0.3), (10 ** 9, 0.2))


class IEEE33ProperEnvironment(IEEE33MultiCapacitorEnv):
    """Multi-capacitor IEEE33 with scaled nominal loads and fixed rates."""

    def __init__(self, load_scale=1.0, **kwargs):
        super().__init__(**kwargs)
        self.load_scale = load_scale
        self._load_ids = sorted(
            dev_id for dev_id, dev in self.simulator.devices.items() if dev.type == -1
        )

    def next_vars(self, s_t):
        """Loads at −nominal·load_scale MW; renewables/aux zero
        (ready_to_use:43-54)."""
        sim = self.simulator
        n_vars = sim.N_load + sim.N_non_slack_gen + self.K
        out = np.zeros(n_vars)
        for idx, dev_id in enumerate(self._load_ids[: sim.N_load]):
            dev = sim.devices[dev_id]
            out[idx] = -abs(dev.p_min) * sim.baseMVA * self.load_scale
        return out

    def reset(self, **kwargs):
        obs, info = super().reset(**kwargs)
        for i, branch in enumerate(self.simulator.branches.values()):
            for upto, rate in _RATE_TIERS:
                if i < upto:
                    branch.rate = rate
                    break
        return obs, info
