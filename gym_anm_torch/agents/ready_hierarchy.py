"""The "ready-to-use" L0-L5 controller hierarchy (17-dim actions).

Port of ``gym_anm_tpu/agents/ready_hierarchy.py``, with the same decisions:
the controllers are host numpy and read the port's compat
:class:`~gym_anm_torch.env.Simulator` through its host views
(``buses[*].v``, ``devices[*].p_pot``), so an ``act`` runs no device op
whichever device the environment steps on.

Equivalents of the reference's repo-root
``ready_to_use_l5_implementation.py`` controller classes (:76-433): the
hierarchy built around a fixed 85% renewable baseline with bang-bang /
proportional / PI-coordinated / trend-predictive capacitor staging, topped
by an SLSQP MPC (L5) whose objective prices curtailment, switching, and
predicted voltage deviation through a hand-fitted sensitivity model.
Thresholds and gains preserved; code restructured.

Pair these with :class:`gym_anm_torch.compat.IEEE33ProperEnvironment`.
"""

from collections import deque

import numpy as np
from scipy.optimize import minimize

from .ieee33_controllers import _voltages

_CAP_RATINGS = np.array([1.0, 1.0, 0.15, 0.1, 0.2, 0.15])
_RENEW_MAX = np.array([0.05, 0.05, 0.05, 0.10, 0.10])


class L0_Random:
    """Random renewables at 60-90% of maximum, coin-flip capacitors
    (ready_to_use_l5_implementation.py:76-101)."""

    def __init__(self, env):
        self.env = env

    def act(self, env):
        a = np.zeros(17)
        a[0:3] = np.random.uniform(0.03, 0.045, 3)
        a[3:5] = np.random.uniform(0.06, 0.09, 2)
        flips = np.random.random(6) > 0.5
        a[10:16] = np.where(flips, _CAP_RATINGS / 10.0, 0.0)
        a[16] = 1.0
        return a


class L1_BangBang:
    """Three-state renewable dispatch + hysteresis bang-bang capacitors
    (:103-149)."""

    def __init__(self, env):
        self.env = env
        self.v_low, self.v_high = 0.97, 1.03
        self.caps_on = False

    def act(self, env):
        v = _voltages(env.unwrapped.simulator)
        v_min, v_max = v.min(), v.max()
        a = np.zeros(17)
        if v_max > 1.035:
            a[0:3], a[3:5] = 0.03, 0.06
        elif v_min < 0.965:
            a[0:3], a[3:5] = 0.05, 0.10
        else:
            a[0:3], a[3:5] = 0.04, 0.08
        if v_min < self.v_low:
            self.caps_on = True
        elif v_max > self.v_high:
            self.caps_on = False
        if self.caps_on:
            a[10:16] = _CAP_RATINGS / 10.0
        a[16] = 1.0
        return a


class L2_Proportional:
    """Smooth proportional renewable factor (80% ± 20%) with the same
    hysteresis capacitor rule (:152-194)."""

    def __init__(self, env):
        self.env = env
        self.v_low, self.v_high = 0.97, 1.03
        self.caps_on = False

    def act(self, env):
        v = _voltages(env.unwrapped.simulator)
        v_min, v_max, v_avg = v.min(), v.max(), v.mean()
        a = np.zeros(17)
        factor = np.clip(0.8 - (v_avg - 1.0) * 4.0, 0.6, 1.0)
        a[0:3], a[3:5] = 0.05 * factor, 0.10 * factor
        if v_min < self.v_low:
            self.caps_on = True
        elif v_max > self.v_high:
            self.caps_on = False
        if self.caps_on:
            a[10:16] = _CAP_RATINGS / 10.0
        a[16] = 1.0
        return a


class L3_Coordinated:
    """PI renewable coordination + progressive severity-staged capacitor
    activation (:197-238)."""

    def __init__(self, env):
        self.env = env
        self.integral = 0.0

    def act(self, env):
        v = _voltages(env.unwrapped.simulator)
        v_min, v_avg = v.min(), v.mean()
        a = np.zeros(17)

        error = 1.0 - v_avg
        self.integral = np.clip(self.integral + error * 0.01, -0.1, 0.1)
        control = 5 * error + 0.5 * self.integral
        factor = np.clip(0.8 + control * 0.2, 0.6, 1.0)
        a[0:3], a[3:5] = 0.05 * factor, 0.10 * factor

        if v_min < 0.98:
            n = min(6, int((0.98 - v_min) * 20))
            a[10:10 + n] = _CAP_RATINGS[:n] / 10.0
        a[16] = 1.0
        return a


class L4_Predictive:
    """Trend extrapolation (3-step lookahead) drives both renewable factor
    and capacitor staging (:241-295)."""

    def __init__(self, env):
        self.env = env
        self.v_history = deque(maxlen=10)

    def act(self, env):
        v = _voltages(env.unwrapped.simulator)
        v_min, v_avg = v.min(), v.mean()
        a = np.zeros(17)

        self.v_history.append(v_avg)
        if len(self.v_history) >= 3:
            recent = list(self.v_history)[-3:]
            trend = (recent[-1] - recent[0]) / 2
        else:
            trend = 0.0
        v_pred = v_avg + trend * 3

        factor = 0.7 if v_pred > 1.02 else (0.9 if v_pred < 0.98 else 0.8)
        a[0:3], a[3:5] = 0.05 * factor, 0.10 * factor

        if v_pred < 0.97 or v_min < 0.96:
            severity = max(0.97 - v_pred, 0.96 - v_min)
            n = min(6, int(severity * 30))
            a[10:10 + n] = _CAP_RATINGS[:n] / 10.0
        a[16] = 1.0
        return a


class L5_MathematicalOptimization:
    """SLSQP MPC: 11-dim decision (5 renewable P in a 60-100% band, 6 binary
    cap relaxations), objective = voltage tracking + violation penalty +
    curtailment + switching costs through a sensitivity model, with staged
    fallbacks on solver failure (:297-433)."""

    def __init__(self, env):
        self.env = env
        self.cap_ratings = _CAP_RATINGS.copy()
        self.renewable_max = _RENEW_MAX.copy()
        self.prev_caps = np.zeros(6)
        self.prev_renewable = self.renewable_max * 0.85
        self.switching_cost, self.curtailment_cost = 10.0, 100.0
        self.voltage_penalty = 1000.0
        self.dv_dp, self.dv_dq = -0.02, 0.05

    def _predict(self, x, v_current):
        dp = np.sum(x[:5]) - np.sum(self.prev_renewable)
        dq = np.sum(x[5:11] * self.cap_ratings / 10.0) - np.sum(self.prev_caps)
        return v_current + self.dv_dp * dp + self.dv_dq * dq

    def _objective(self, x, v_current, v_target=1.0):
        v_pred = self._predict(x, v_current)
        cost = 100 * (v_pred - v_target) ** 2
        if v_pred < 0.95 or v_pred > 1.05:
            cost += self.voltage_penalty * max(0.95 - v_pred, v_pred - 1.05) ** 2
        cost += self.curtailment_cost * np.sum(self.renewable_max - x[:5])
        renewable_switches = np.sum(np.abs(x[:5] - self.prev_renewable) > 0.01)
        cap_switches = np.sum(np.abs(x[5:11] - (self.prev_caps > 0).astype(float)) > 0.5)
        cost += self.switching_cost * (renewable_switches + cap_switches)
        return cost

    def act(self, env):
        v_current = _voltages(env.unwrapped.simulator).min()
        x0 = np.concatenate([self.prev_renewable, (self.prev_caps > 0).astype(float)])
        bounds = [(0.6 * m, m) for m in self.renewable_max] + [(0, 1)] * 6

        def v_constraint(x):
            v_pred = self._predict(x, v_current)
            return [v_pred - 0.94, 1.06 - v_pred]

        try:
            res = minimize(
                self._objective, x0, args=(v_current,), method="SLSQP",
                bounds=bounds, constraints={"type": "ineq", "fun": v_constraint},
                options={"maxiter": 100},
            )
            if res.success:
                a = np.zeros(17)
                a[0:5] = res.x[:5]
                on = res.x[5:11] > 0.5
                a[10:16] = np.where(on, self.cap_ratings / 10.0, 0.0)
                a[16] = 1.0
                self.prev_renewable = res.x[:5].copy()
                self.prev_caps = a[10:16].copy()
                return a
            # Heuristic fallback: 85% baseline + 3 caps if voltage is low.
            a = np.zeros(17)
            a[0:5] = self.renewable_max * 0.85
            if v_current < 0.97:
                a[10:13] = self.cap_ratings[:3] / 10.0
            a[16] = 1.0
            return a
        except Exception:
            a = np.zeros(17)
            a[0:5] = self.renewable_max * 0.85
            a[16] = 1.0
            return a
