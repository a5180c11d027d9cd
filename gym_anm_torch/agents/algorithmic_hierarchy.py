"""The 13-dim "algorithmic" L0-L5 hierarchy for the renewable IEEE33 env.

Port of ``gym_anm_tpu/agents/algorithmic_hierarchy.py``, with the same
decisions: the controllers are host numpy and read the port's compat
:class:`~gym_anm_torch.env.Simulator` through its host views
(``buses[*].v``, ``devices[*].p_pot``), so an ``act`` runs no device op
whichever device the environment steps on.

Equivalents of ``gym_anm/agents/ieee33_controllers/algorithmic_hierarchy.py``
(:16-549): six controllers graded by control-theoretic complexity — random,
bang-bang, P, PI with filtering, numpy-only lookahead MPC, and a
two-timescale hierarchical MPC with emergency-mode hysteresis and load
forecasting.  Decision rules, thresholds and gains preserved; code
restructured around shared helpers.

Action layout (13-dim): [5 renewable P, 5 renewable Q, 2 cap Q, 1 OLTC tap]
(the ``IEEE33RenewableEnv`` action space).
"""

from collections import deque

import numpy as np

from .ieee33_controllers import TAP_POSITIONS, _voltages

_Q_LIMITS = np.array([0.02, 0.02, 0.02, 0.04, 0.04])
_RENEWABLE_IDS = range(36, 41)


def _pots(sim):
    return np.array([sim.devices[g].p_pot if g in sim.devices else 0.0
                     for g in _RENEWABLE_IDS])


class L0_RandomControl:
    """L0: random actions (algorithmic_hierarchy.py:16-25)."""

    def __init__(self, env):
        self.env = env
        self.rng = np.random.RandomState(42)

    def act(self, env):
        return env.action_space.sample()


class L1_BangBangControl:
    """L1: fixed-threshold on/off switching (:28-77)."""

    def __init__(self, env):
        self.env = env
        self.v_low_thresh, self.v_high_thresh = 0.97, 1.03

    def act(self, env):
        sim = env.unwrapped.simulator
        v = _voltages(sim)
        v_min, v_max = v.min(), v.max()
        a = np.zeros(13)
        a[0:5] = _pots(sim)  # all available renewable
        if v_min < self.v_low_thresh:
            a[10], a[11], a[12] = 0.3, 0.3, 0.95
        elif v_max > self.v_high_thresh:
            a[12] = 1.05
        else:
            a[12] = 1.0
        return a


class L2_ProportionalControl:
    """L2: P-controller on the worst-case voltage error (:79-157)."""

    def __init__(self, env):
        self.env = env
        self.kp_renewable, self.kp_reactive = 5.0, 2.0
        self.kp_cap, self.kp_oltc = 3.0, 5.0
        self.v_ref = 1.0

    def act(self, env):
        sim = env.unwrapped.simulator
        v = _voltages(sim)
        v_min, v_max = v.min(), v.max()
        a = np.zeros(13)

        pots = _pots(sim)
        if v_max > 1.045:
            a[0:5] = pots * (1 - min(0.7, self.kp_renewable * (v_max - 1.045)))
        else:
            a[0:5] = pots

        if v_min < 0.98:
            a[5:10] = _Q_LIMITS * min(1.0, self.kp_reactive * (0.98 - v_min))
        elif v_max > 1.02:
            a[5:10] = -_Q_LIMITS * min(1.0, self.kp_reactive * (v_max - 1.02))

        if v_min < 0.97:
            sig = self.kp_cap * (0.97 - v_min)
            a[10], a[11] = min(0.3, sig), min(0.2, sig * 0.7)

        if v_min < 0.96:
            a[12] = max(0.9, 1.0 - self.kp_oltc * (0.96 - v_min))
        elif v_max > 1.04:
            a[12] = min(1.1, 1.0 + self.kp_oltc * (v_max - 1.04))
        else:
            a[12] = 1.0
        return a


class L3_PIControl:
    """L3: PI on a 5-step-filtered average voltage, integral-staged
    capacitors, deadbanded OLTC (:160-236)."""

    def __init__(self, env):
        self.env = env
        self.kp, self.ki = 5.0, 0.1
        self.integral_error, self.integral_limit = 0.0, 2.0
        self.v_ref = 1.0
        self.v_history = deque(maxlen=5)

    def act(self, env):
        sim = env.unwrapped.simulator
        v = _voltages(sim)
        a = np.zeros(13)

        self.v_history.append(v.mean())
        v_filtered = np.mean(self.v_history)
        error = self.v_ref - v_filtered
        self.integral_error = np.clip(self.integral_error + error * 0.1,
                                      -self.integral_limit, self.integral_limit)
        control = self.kp * error + self.ki * self.integral_error

        pots = _pots(sim)
        if control < -0.02:  # voltage too high
            a[0:5] = pots * (1 - min(1.0, abs(control) * 2))
        else:
            a[0:5] = pots
        a[5:10] = np.clip(control * 2, -_Q_LIMITS, _Q_LIMITS)

        if self.integral_error < -0.5:
            a[10], a[11] = 0.3, 0.2
        elif self.integral_error > 0.5:
            pass  # caps off
        else:
            sig = max(0.0, -control * 5)
            a[10], a[11] = min(0.3, sig), min(0.2, sig * 0.7)

        a[12] = np.clip(1.0 - control * 10, 0.9, 1.1) if abs(error) > 0.02 else 1.0
        return a


class L4_MPCControl:
    """L4: numpy-only lookahead MPC — trend-extrapolated 3-step voltage
    forecast drives preemptive curtailment, anticipatory Q, staged caps,
    and rate-limited OLTC (:239-320)."""

    def __init__(self, env):
        self.env = env
        self.horizon = 3
        self.v_ref = 1.0
        self.prev_action = None

    def act(self, env):
        sim = env.unwrapped.simulator
        v = _voltages(sim)
        v_avg, v_min, v_max = v.mean(), v.min(), v.max()
        a = np.zeros(13)

        trend = v_avg - self.v_prev if hasattr(self, "v_prev") else 0.0
        self.v_prev = v_avg
        v_future = [v_avg + trend * (i + 1) * 0.5 for i in range(self.horizon)]

        pots = _pots(sim)
        if any(vf > 1.045 for vf in v_future) or v_max > 1.04:
            severity = max(0.0, max(v_future) - 1.04)
            a[0:5] = pots * max(0.3, 1 - severity * 10)
        else:
            a[0:5] = pots

        future_error = np.mean([self.v_ref - vf for vf in v_future])
        a[5:10] = np.clip(future_error * 10, -_Q_LIMITS, _Q_LIMITS)

        if v_min < 0.96 or any(vf < 0.965 for vf in v_future):
            a[10], a[11] = 0.25, 0.15
        elif v_max > 1.04 or any(vf > 1.045 for vf in v_future):
            a[10] = a[11] = 0.0
        else:
            a[10], a[11] = 0.1, 0.05

        desired = 1.0 - future_error * 15
        if self.prev_action is not None:
            prev = self.prev_action[12]
            desired = np.clip(desired, prev - 0.05, prev + 0.05)
        a[12] = np.clip(desired, 0.9, 1.1)

        self.prev_action = a.copy()
        return a


class L5_HierarchicalMPCControl:
    """L5: two-timescale hierarchical MPC — slow OLTC/cap scheduling on a
    2/5-step cadence with emergency-mode hysteresis and moving-average load
    forecasting; fast renewable P/Q dispatch with local+global limits and
    per-bus voltage targets; OLTC smoothed over a 3-tap history and snapped
    to the discrete positions (:321-549)."""

    def __init__(self, env):
        self.env = env
        self.fast_horizon, self.slow_horizon = 2, 5
        self.v_ref = 1.0
        self.state_buffer = deque(maxlen=10)
        self.load_forecast = 1.0
        self.cap_schedule = [0.1, 0.05]
        self.tap_schedule = 1.0
        self.update_counter = 0
        self.emergency_mode = False
        self.last_v_avg = 1.0
        self.tap_history = deque([1.0, 1.0, 1.0], maxlen=3)

    def act(self, env):
        sim = env.unwrapped.simulator
        v = _voltages(sim)
        st = {
            "v_avg": v.mean(), "v_min": v.min(), "v_max": v.max(),
            "v_std": v.std(),
            "p_total": float(np.sum([b.p for b in sim.buses.values()])),
            "voltages": v,
        }
        self.state_buffer.append(st)

        v_change = abs(st["v_avg"] - self.last_v_avg)
        self.last_v_avg = st["v_avg"]
        if not self.emergency_mode:
            if v_change > 0.03 or st["v_min"] < 0.93 or st["v_max"] > 1.07:
                self.emergency_mode = True
                self.update_counter = 0
        elif v_change < 0.01 and 0.95 <= st["v_min"] <= st["v_max"] <= 1.05:
            self.emergency_mode = False

        if len(self.state_buffer) >= 3:
            recent = [s["p_total"] for s in list(self.state_buffer)[-3:]]
            self.load_forecast = np.mean(recent) * 1.1

        self.update_counter += 1
        freq = 2 if self.emergency_mode else 5
        if self.update_counter < 3 or self.update_counter % freq == 0 or self.emergency_mode:
            self._update_slow_controls(st)

        a = np.zeros(13)
        # Fast timescale: renewable P with local/global limits.
        for i, g in enumerate(_RENEWABLE_IDS):
            if g not in sim.devices:
                continue
            gen = sim.devices[g]
            local_v = v[gen.bus_id] if gen.bus_id < len(v) else st["v_avg"]
            if self.emergency_mode:
                if st["v_max"] > 1.05:
                    a[i] = gen.p_pot * (1 - min(0.8, 10 * (st["v_max"] - 1.05)))
                elif st["v_min"] < 0.95:
                    a[i] = gen.p_pot
                else:
                    a[i] = gen.p_pot * 0.9
            else:
                local = (gen.p_pot * max(0.0, 2 - 20 * (local_v - 1.048))
                         if local_v > 1.048 else gen.p_pot)
                glob = gen.p_pot * 0.7 if st["v_max"] > 1.045 else gen.p_pot
                a[i] = min(local, glob)

        # Fast timescale: reactive dispatch.
        if self.emergency_mode:
            for i in range(5):
                if st["v_min"] < 0.95:
                    a[5 + i] = _Q_LIMITS[i]
                elif st["v_max"] > 1.05:
                    a[5 + i] = -_Q_LIMITS[i]
                else:
                    a[5 + i] = np.clip((1.0 - st["v_avg"]) * 20,
                                       -_Q_LIMITS[i], _Q_LIMITS[i])
        else:
            for i, g in enumerate(_RENEWABLE_IDS):
                if g in sim.devices:
                    b = sim.devices[g].bus_id
                    local_v = v[b] if b < len(v) else st["v_avg"]
                    # all per-bus targets are 1.0 (:536-549)
                    a[5 + i] = np.clip((1.0 - local_v) * 15,
                                       -_Q_LIMITS[i], _Q_LIMITS[i])

        a[10], a[11] = self.cap_schedule
        self.tap_history.append(self.tap_schedule)
        smoothed = np.mean(self.tap_history)
        a[12] = min(TAP_POSITIONS, key=lambda x: abs(x - smoothed))
        return a

    def _update_slow_controls(self, st):
        if self.emergency_mode:
            v_min, v_max, v_avg = st["v_min"], st["v_max"], st["v_avg"]
            if v_min < 0.94 and v_max < 1.02:
                self.tap_schedule, self.cap_schedule = 0.95, [0.25, 0.2]
            elif v_max > 1.06 and v_min > 0.98:
                self.tap_schedule, self.cap_schedule = 1.05, [0.0, 0.0]
            elif v_avg < 0.98:
                self.tap_schedule, self.cap_schedule = 0.98, [0.15, 0.1]
            elif v_avg > 1.02:
                self.tap_schedule, self.cap_schedule = 1.02, [0.0, 0.0]
            else:
                self.tap_schedule, self.cap_schedule = 1.0, [0.05, 0.0]
        else:
            if st["v_min"] < 0.965:
                self.tap_schedule = 0.95
            elif st["v_max"] > 1.04:
                self.tap_schedule = 1.05
            elif st["v_avg"] < 0.985:
                self.tap_schedule = 0.98
            elif st["v_avg"] > 1.015:
                self.tap_schedule = 1.02
            else:
                self.tap_schedule = 1.0

            if st["v_min"] < 0.97:
                self.cap_schedule = [0.25, 0.15]
            elif st["v_max"] > 1.04:
                self.cap_schedule = [0.0, 0.0]
            elif st["v_min"] < 0.98:
                self.cap_schedule = [0.15, 0.1]
            elif st["v_avg"] < 0.995:
                self.cap_schedule = [0.1, 0.05]
            else:
                self.cap_schedule = [0.05, 0.0]
