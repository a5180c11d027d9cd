"""The L0-L5 controller hierarchy for the IEEE33 renewable environments.

Port of ``gym_anm_tpu/agents/ieee33_controllers.py``, with the same
decisions: the controllers are host numpy and read the port's compat
:class:`~gym_anm_torch.env.Simulator` through its host views
(``buses[*].v``, ``devices[*].p_pot``), so an ``act`` runs no device op
whichever device the environment steps on.

Drop-in equivalents of the canonical exported controller set
(``gym_anm/agents/ieee33_controllers/discrete_hierarchy.py:6-593``): six
increasingly sophisticated voltage controllers producing 13-dim actions
[5 renewable P, 5 renewable Q, 2 cap Q, 1 OLTC tap].  Decision rules,
thresholds, lockout timers and the hand-fitted linear voltage-prediction
model are kept identical so the reward hierarchy reproduces; the code is
restructured around shared helpers.

All controllers read the live simulator through ``env.unwrapped.simulator``
(the duck-typed agent protocol: ``agent.act(env) -> np.ndarray``).
"""

import numpy as np

TAP_POSITIONS = [0.9, 0.95, 1.0, 1.05, 1.1]
_RENEWABLE_IDS = range(36, 41)  # device IDs of the 5 renewables


def _voltages(sim):
    return np.array([np.abs(bus.v) for bus in sim.buses.values()])


def _set_renewables(action, sim, fraction, per_device_factor=None):
    """action[0:5] = p_pot · fraction (· local factor), in p.u. like the
    reference (its actions are never scaled by baseMVA here)."""
    for i, gen_id in enumerate(_RENEWABLE_IDS):
        if gen_id in sim.devices:
            gen = sim.devices[gen_id]
            f = fraction if per_device_factor is None else fraction * per_device_factor[i]
            a = gen.p_pot * f
            action[i] = min(a, gen.p_pot)
    return action


class CorrectedL0_Random:
    """L0: uniformly random actions."""

    def __init__(self, env):
        self.env = env

    def act(self, env):
        return env.action_space.sample()


class CorrectedL1_Basic:
    """L1: fixed pattern — 20% renewables, capacitors off, nominal tap."""

    def __init__(self, env):
        self.env = env
        self.cap_on_value = 0.5
        self.cap_off_value = 0.0
        self.tap_positions = TAP_POSITIONS

    def act(self, env):
        sim = env.unwrapped.simulator
        action = np.zeros(13)
        for i, gen_id in enumerate(_RENEWABLE_IDS):
            if gen_id in sim.devices:
                action[i] = sim.devices[gen_id].p_pot * 0.2
        # q-injections stay 0; caps off; nominal tap
        action[10] = self.cap_off_value
        action[11] = self.cap_off_value
        action[12] = self.tap_positions[2]
        return action


class CorrectedL2_VoltageThreshold:
    """L2: voltage-threshold switching with per-capacitor hysteresis."""

    def __init__(self, env):
        self.env = env
        self.cap_on_value = 0.2
        self.cap_off_value = 0.0
        self.tap_positions = TAP_POSITIONS
        self.last_cap_state = [False, False]

    def act(self, env):
        sim = env.unwrapped.simulator
        action = np.zeros(13)
        v = _voltages(sim)
        v_min, v_max = v.min(), v.max()

        if v_max > 1.04:
            frac = 0.15
        elif v_min < 0.96:
            frac = 0.25
        else:
            frac = 0.22
        for i, gen_id in enumerate(_RENEWABLE_IDS):
            if gen_id in sim.devices:
                action[i] = sim.devices[gen_id].p_pot * frac

        if v_min < 0.97:
            action[5:10] = 0.01
        elif v_max > 1.03:
            action[5:10] = -0.01

        # Capacitor 1: hysteresis band.
        if not self.last_cap_state[0]:
            if v_min < 0.96 and v_max < 1.02:
                action[10] = self.cap_on_value
                self.last_cap_state[0] = True
            else:
                action[10] = self.cap_off_value
        else:
            if v_min > 0.98 or v_max > 1.04:
                action[10] = self.cap_off_value
                self.last_cap_state[0] = False
            else:
                action[10] = self.cap_on_value

        # Capacitor 2: more conservative, half value.
        if not self.last_cap_state[1]:
            if v_min < 0.955 and v_max < 1.01:
                action[11] = self.cap_on_value * 0.5
                self.last_cap_state[1] = True
            else:
                action[11] = self.cap_off_value
        else:
            if v_min > 0.975 or v_max > 1.03:
                action[11] = self.cap_off_value
                self.last_cap_state[1] = False
            else:
                action[11] = self.cap_on_value * 0.5

        caps_active = self.last_cap_state[0] or self.last_cap_state[1]
        if caps_active:
            if v_min < 0.94:
                tap_idx = 1
            elif v_max > 1.06:
                tap_idx = 3
            else:
                tap_idx = 2
        else:
            if v_min < 0.93:
                tap_idx = 0
            elif v_min < 0.96:
                tap_idx = 1
            elif v_max > 1.07:
                tap_idx = 4
            elif v_max > 1.04:
                tap_idx = 3
            else:
                tap_idx = 2
        action[12] = self.tap_positions[tap_idx]
        return action


class CorrectedL3_Coordinated:
    """L3: coordinated control with margin-adaptive renewables and lockout
    timers (5 steps for capacitors, 10 for the OLTC)."""

    def __init__(self, env):
        self.env = env
        self.cap_on_value = 0.15
        self.cap_off_value = 0.0
        self.tap_positions = TAP_POSITIONS
        self.cap_state = [False, False]
        self.last_tap_idx = 2
        self.action_timer = 0

    def act(self, env):
        sim = env.unwrapped.simulator
        action = np.zeros(13)
        v = _voltages(sim)
        v_mean, v_min, v_max = v.mean(), v.min(), v.max()

        margin = min(v_min - 0.95, 1.05 - v_max)
        if margin < 0.01:
            base_frac = 0.15
        elif margin < 0.02:
            base_frac = 0.20
        else:
            base_frac = 0.24

        for i, gen_id in enumerate(_RENEWABLE_IDS):
            if gen_id in sim.devices:
                gen = sim.devices[gen_id]
                v_local = np.abs(sim.buses[gen.bus_id].v)
                if v_local > 1.035:
                    local = 0.7
                elif v_local < 0.965:
                    local = 1.2
                else:
                    local = 1.0
                action[i] = min(gen.p_pot * base_frac * local, gen.p_pot)

        q_limits = [0.02, 0.02, 0.02, 0.04, 0.04]
        for i, gen_id in enumerate(_RENEWABLE_IDS):
            if gen_id in sim.devices:
                v_local = np.abs(sim.buses[sim.devices[gen_id].bus_id].v)
                if v_local < 0.97:
                    action[5 + i] = q_limits[i] * 0.5
                elif v_local > 1.03:
                    action[5 + i] = -q_limits[i] * 0.5

        self.action_timer = max(0, self.action_timer - 1)

        if self.action_timer == 0:
            if v_min < 0.95 and v_max < 1.01:
                desired = [True, True]
            elif v_min < 0.96 and v_max < 1.02:
                desired = [True, False]
            elif v_max > 1.04 or (v_max > 1.03 and v_mean > 1.01):
                desired = [False, False]
            else:
                desired = self.cap_state
            if desired != self.cap_state:
                self.cap_state = desired
                self.action_timer = 5

        action[10] = self.cap_on_value if self.cap_state[0] else self.cap_off_value
        action[11] = self.cap_on_value * 0.5 if self.cap_state[1] else self.cap_off_value

        if self.action_timer == 0:
            if v_min < 0.94:
                desired_tap = 0
            elif v_min < 0.95 and not any(self.cap_state):
                desired_tap = 1
            elif v_max > 1.06:
                desired_tap = 4
            elif v_max > 1.05 and not any(self.cap_state):
                desired_tap = 3
            else:
                desired_tap = 2
            if desired_tap != self.last_tap_idx:
                self.last_tap_idx = desired_tap
                self.action_timer = 10

        action[12] = self.tap_positions[self.last_tap_idx]
        return action


class CorrectedL4_Predictive:
    """L4: trend-based prediction over a 5-step voltage history with
    switching-rate limits."""

    def __init__(self, env):
        self.env = env
        self.cap_on_value = 0.4
        self.cap_off_value = 0.0
        self.tap_positions = TAP_POSITIONS
        self.voltage_history = []
        self.last_caps = [self.cap_off_value, self.cap_off_value]
        self.last_tap_idx = 2
        self.cap_switch_timer = [0, 0]
        self.tap_change_timer = 0

    def act(self, env):
        sim = env.unwrapped.simulator
        action = np.zeros(13)
        v = _voltages(sim)
        self.voltage_history.append(v)
        if len(self.voltage_history) > 5:
            self.voltage_history.pop(0)
        v_min, v_max = v.min(), v.max()

        if len(self.voltage_history) >= 2:
            v_trend = np.mean(self.voltage_history[-1]) - np.mean(self.voltage_history[-2])
        else:
            v_trend = 0

        if v_trend > 0.005 and v_max > 1.02:
            base_frac = 0.16
        elif v_trend < -0.005 and v_min < 0.98:
            base_frac = 0.24
        else:
            base_frac = 0.20

        for i, gen_id in enumerate(_RENEWABLE_IDS):
            if gen_id in sim.devices:
                gen = sim.devices[gen_id]
                v_local = np.abs(sim.buses[gen.bus_id].v)
                v_pred = v_local + v_trend * 3
                if v_pred > 1.04:
                    local = 0.6
                elif v_pred < 0.96:
                    local = 1.3
                else:
                    local = 1.0
                action[i] = min(gen.p_pot * base_frac * local, gen.p_pot)

        q_limits = [0.02, 0.02, 0.02, 0.04, 0.04]
        for i, gen_id in enumerate(_RENEWABLE_IDS):
            if gen_id in sim.devices:
                v_local = np.abs(sim.buses[sim.devices[gen_id].bus_id].v)
                v_pred = v_local + v_trend * 3
                if v_pred < 0.96 or v_local < 0.965:
                    action[5 + i] = q_limits[i] * 0.6
                elif v_pred > 1.04 or v_local > 1.035:
                    action[5 + i] = -q_limits[i] * 0.6

        self.cap_switch_timer = [max(0, t - 1) for t in self.cap_switch_timer]
        self.tap_change_timer = max(0, self.tap_change_timer - 1)

        # Capacitor 1.
        if self.cap_switch_timer[0] == 0:
            if v_min < 0.96 and self.last_caps[0] == self.cap_off_value:
                action[10] = self.cap_on_value
                self.cap_switch_timer[0] = 5
            elif v_min > 0.975 and self.last_caps[0] == self.cap_on_value:
                action[10] = self.cap_off_value
                self.cap_switch_timer[0] = 5
            else:
                action[10] = self.last_caps[0]
        else:
            action[10] = self.last_caps[0]

        # Capacitor 2.
        if self.cap_switch_timer[1] == 0:
            if v_min < 0.955 and self.last_caps[1] == self.cap_off_value:
                action[11] = self.cap_on_value
                self.cap_switch_timer[1] = 5
            elif v_min > 0.97 and self.last_caps[1] == self.cap_on_value:
                action[11] = self.cap_off_value
                self.cap_switch_timer[1] = 5
            else:
                action[11] = self.last_caps[1]
        else:
            action[11] = self.last_caps[1]

        self.last_caps = [action[10], action[11]]

        if self.tap_change_timer == 0:
            if v_min < 0.94 or (v_min < 0.95 and v_trend < -0.01):
                desired = 0
            elif v_min < 0.96:
                desired = 1
            elif v_max > 1.06 or (v_max > 1.05 and v_trend > 0.01):
                desired = 4
            elif v_max > 1.04:
                desired = 3
            else:
                desired = 2
            if abs(desired - self.last_tap_idx) > 1 or v_min < 0.93 or v_max > 1.07:
                action[12] = self.tap_positions[desired]
                self.last_tap_idx = desired
                self.tap_change_timer = 10
            else:
                action[12] = self.tap_positions[self.last_tap_idx]
        else:
            action[12] = self.tap_positions[self.last_tap_idx]
        return action


class CorrectedL5_Optimal:
    """L5: exhaustive one-step search over discrete {renewable level ×
    capacitor values² × tap positions} against a hand-fitted linear voltage
    model, with violation / margin / switching / effort costs."""

    def __init__(self, env):
        self.env = env
        self.prediction_horizon = 3
        self.control_horizon = 1
        self.cap_values = [0.0, 0.2, 0.3]
        self.tap_positions = TAP_POSITIONS
        self.renewable_levels = [0.15, 0.20, 0.25]
        self.voltage_history = []
        self.action_history = []
        self.last_cap1 = 0.0
        self.last_cap2 = 0.0
        self.last_tap_idx = 2
        self.cap_switch_penalty = 0.001
        self.tap_change_penalty = 0.005

    def _predict_voltage(self, v_min, v_max, ren_level, cap1, cap2, tap):
        """Hand-fitted linear response model (discrete_hierarchy.py:553-593):
        caps give ~0.005 p.u. per unit of Q, the OLTC responds INVERSELY
        (tap < 1 raises downstream voltage), renewables are negligible."""
        if v_min > 0.99 and v_max < 1.01:
            base_min, base_max = -0.046, 0.0
        else:
            base_min, base_max = 0.0, 0.0

        cap_boost = (cap1 + cap2) * 0.005

        if tap < 1.0:
            oltc = 0.046 if tap <= 0.95 else (1.0 - tap) * 0.92
        else:
            oltc = -0.050 if tap >= 1.05 else (1.0 - tap) * 1.0

        pred_min = v_min + base_min + cap_boost + oltc
        pred_max = v_max + base_max + cap_boost * 0.9 + oltc * 0.95
        pred_min = max(0.85, min(1.15, pred_min))
        pred_max = max(pred_min, min(1.15, pred_max))
        return pred_min, pred_max

    def _config_cost(self, v_min, v_max, ren, cap1, cap2, tap_idx):
        pv_min, pv_max = self._predict_voltage(
            v_min, v_max, ren, cap1, cap2, self.tap_positions[tap_idx]
        )
        cost = 0.0
        if pv_min < 0.95:
            cost += 100 * (0.95 - pv_min) ** 2
        if pv_max > 1.05:
            cost += 100 * (pv_max - 1.05) ** 2
        if pv_min < 0.96:
            cost += 1.0 * (0.96 - pv_min) ** 2
        if pv_max > 1.04:
            cost += 1.0 * (pv_max - 1.04) ** 2
        cost += 0.05 * ((pv_min + pv_max) / 2 - 1.0) ** 2
        if cap1 != self.last_cap1:
            cost += self.cap_switch_penalty
        if cap2 != self.last_cap2:
            cost += self.cap_switch_penalty
        if tap_idx != self.last_tap_idx:
            cost += self.tap_change_penalty
        cost += 0.01 * (cap1 + cap2)
        cost += 0.001 * abs(ren - 0.2)
        return cost

    def act(self, env):
        sim = env.unwrapped.simulator
        action = np.zeros(13)
        v = _voltages(sim)
        v_min, v_max, v_mean = v.min(), v.max(), v.mean()

        self.voltage_history.append({"min": v_min, "max": v_max, "mean": v_mean})
        if len(self.voltage_history) > 10:
            self.voltage_history.pop(0)

        best, best_cost = None, float("inf")
        for ren in self.renewable_levels:
            for cap1 in self.cap_values:
                for cap2 in self.cap_values:
                    if cap1 + cap2 > 0.5:
                        continue
                    for tap_idx in range(len(self.tap_positions)):
                        cost = self._config_cost(v_min, v_max, ren, cap1, cap2, tap_idx)
                        if cost < best_cost:
                            best_cost = cost
                            best = (ren, cap1, cap2, tap_idx)

        if best is not None:
            ren, cap1, cap2, tap_idx = best
            for i, gen_id in enumerate(_RENEWABLE_IDS):
                if gen_id in sim.devices:
                    gen = sim.devices[gen_id]
                    action[i] = gen.p_pot * ren if gen.p_pot > 0 else 0.0
            if v_min < 0.94:
                action[5:10] = 0.01
            elif v_max > 1.06:
                action[5:10] = -0.01
            action[10] = cap1
            action[11] = cap2
            action[12] = self.tap_positions[tap_idx]
            self.last_cap1, self.last_cap2 = cap1, cap2
            self.last_tap_idx = tap_idx
        else:
            for i, gen_id in enumerate(_RENEWABLE_IDS):
                if gen_id in sim.devices:
                    action[i] = sim.devices[gen_id].p_pot * 0.2
            action[12] = 1.0
        return action


__all__ = [
    "CorrectedL0_Random",
    "CorrectedL1_Basic",
    "CorrectedL2_VoltageThreshold",
    "CorrectedL3_Coordinated",
    "CorrectedL4_Predictive",
    "CorrectedL5_Optimal",
]
