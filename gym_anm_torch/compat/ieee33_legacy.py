"""Legacy/alternative IEEE33 env: ``FinalCorrectEnv``.

Port of ``gym_anm_tpu/compat/ieee33_legacy.py``.  Equivalent of the reference's non-exported
``gym_anm/envs/ieee33_env/ieee33_renewable.py:6-80``: the base IEEE33 env
with nominal-MW loads (fixing the base env's p.u.-in-MW-slot quirk),
scaled by ``load_scale`` × an hour-of-day time factor × 1% Gaussian noise.
Kept for script compatibility; prefer :class:`IEEE33ProperEnvironment`.
"""

import numpy as np

from .ieee33 import IEEE33Env


class FinalCorrectEnv(IEEE33Env):
    """IEEE33 with properly-scaled time-varying loads (legacy variant)."""

    def __init__(self, load_scale=1.0, device="cuda"):
        super().__init__(device=device)
        self.load_scale = load_scale
        self.hour_of_day = 12.0
        self._load_ids = sorted(
            i for i, dev in self.simulator.devices.items()
            if getattr(dev, "type", None) == -1
        )

    def next_vars(self, s_t):
        """Loads as negative MW = nominal · load_scale · time_factor · noise
        (ieee33_renewable.py:38-64; uses the global numpy RNG like the
        reference's fork-era envs, SURVEY §2.2(7))."""
        sim = self.simulator
        out = np.zeros(sim.N_load + sim.N_non_slack_gen + self.K)
        tf = self._get_time_factor()
        for idx, dev_id in enumerate(self._load_ids[: sim.N_load]):
            nominal_mw = abs(sim.devices[dev_id].p_min) * sim.baseMVA
            noise = 1.0 + np.random.normal(0, 0.01)
            out[idx] = -nominal_mw * self.load_scale * tf * noise
        return out

    def _get_time_factor(self):
        """Documented daily load shape (ieee33_renewable.py:66-80)."""
        hour = getattr(self, "hour_of_day", 12.0)
        if 0 <= hour < 6:
            return 0.7
        if 6 <= hour < 9:
            return 0.7 + 0.3 * (hour - 6) / 3
        if 9 <= hour < 17:
            return 1.0
        if 17 <= hour < 20:
            return 1.1
        return 0.8
