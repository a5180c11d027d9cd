"""The "algorithmically diverse" L0-L5 controller set (17-dim actions).

Port of ``gym_anm_tpu/agents/diversity_hierarchy.py``, with the same
decisions: the controllers are host numpy and read the port's compat
:class:`~gym_anm_torch.env.Simulator` through its host views
(``buses[*].v``, ``devices[*].p_pot``), so an ``act`` runs no device op
whichever device the environment steps on.

Equivalents of the reference's repo-root ``create_algorithmic_diversity.py``
(classes at :9-491): six controllers chosen so each level uses a genuinely
different control algorithm — random, bang-bang, P, PI with anti-windup,
rule-based expert, and SLSQP optimization with an emergency bypass and
warm-start blending — producing the large reward gaps used to grade offline
RL datasets.  Thresholds, gains, and the hand-fitted linear voltage model
are preserved; the code is restructured (vectorized slices, shared
helpers).

Intended for the multi-capacitor IEEE33 environments (caps rated
[1.0, 1.0, 0.15, 0.1, 0.2, 0.15] p.u.-scale as in the scripts).
"""

from collections import deque

import numpy as np
from scipy.optimize import minimize

from .ieee33_controllers import _voltages

# Cap "on" values the scripts use per unit (action units).
_CAP_ON = np.array([1.0, 1.0, 0.015, 0.01, 0.02, 0.015])
_RENEW_MAX = np.array([0.05, 0.05, 0.05, 0.10, 0.10])


class L0_Random:
    """L0: pure random control (create_algorithmic_diversity.py:9-30)."""

    def __init__(self, env):
        self.env = env

    def act(self, env):
        a = np.zeros(17)
        a[0:5] = np.random.rand(5) * _RENEW_MAX
        for i in range(6):
            if np.random.rand() > 0.5:
                if i < 2:
                    a[10 + i] = np.random.choice([0.0, 1.0])
                else:
                    vals = [0, 0.015, 0.01, 0.02, 0.015]
                    a[10 + i] = np.random.choice([0.0, vals[min(i - 1, len(vals) - 1)]])
        a[16] = 0.9 + np.random.rand() * 0.2
        return a


class L1_BangBang:
    """L1: all-or-nothing threshold switching (:33-65)."""

    def __init__(self, env):
        self.env = env
        self.v_threshold = 0.96

    def act(self, env):
        v_min = _voltages(env.unwrapped.simulator).min()
        a = np.zeros(17)
        if v_min < self.v_threshold:
            a[0:3], a[3:5] = 0.05, 0.10
            a[10:16] = _CAP_ON
            a[16] = 0.95
        else:
            a[0:3], a[3:5] = 0.01, 0.02
            a[16] = 1.0
        return a


class L2_Proportional:
    """L2: P-controller — renewables on average error, capacitors staged by
    min-voltage error (:68-115)."""

    def __init__(self, env):
        self.env = env
        self.kp_renewable, self.kp_caps = 10.0, 50.0
        self.v_ref = 0.98

    def act(self, env):
        v = _voltages(env.unwrapped.simulator)
        v_min, v_avg = v.min(), v.mean()
        a = np.zeros(17)

        factor = np.clip(self.kp_renewable * (1.0 - v_avg), 0, 1)
        a[0:3], a[3:5] = 0.05 * factor, 0.10 * factor

        error = self.v_ref - v_min
        if error > 0:
            n_caps = int(np.clip(self.kp_caps * error, 0, 6))
            a[10:10 + n_caps] = _CAP_ON[:n_caps]
        a[16] = 1.0 - np.clip(error * 0.5, -0.05, 0.05)
        return a


class L3_PI_Controller:
    """L3: PI with anti-windup — integral state staged into capacitor count
    and OLTC trim (:118-168)."""

    def __init__(self, env):
        self.env = env
        self.kp, self.ki = 8.0, 2.0
        self.integral, self.integral_limit = 0.0, 0.5
        self.v_ref = 0.985

    def act(self, env):
        v = _voltages(env.unwrapped.simulator)
        v_min = v.min()
        a = np.zeros(17)

        error = self.v_ref - v_min
        self.integral = np.clip(self.integral + error * 0.1, -self.integral_limit, self.integral_limit)
        control = np.clip(self.kp * error + self.ki * self.integral, 0, 1)

        a[0:3], a[3:5] = 0.05 * control, 0.10 * control
        n_caps = int(np.clip(error * 20 + self.integral * 10, 0, 4))
        a[10:10 + n_caps] = _CAP_ON[:n_caps]
        a[16] = 1.0 - np.clip(error * 0.3 + self.integral * 0.1, -0.05, 0.05)
        return a


class L4_RuleBasedExpert:
    """L4: rule-based expert — emergency rule, voltage-trend rules,
    spread-management rule, graded normal operation (:171-258)."""

    def __init__(self, env):
        self.env = env
        self.voltage_history = deque(maxlen=10)

    def act(self, env):
        v = _voltages(env.unwrapped.simulator)
        v_min, v_std = v.min(), v.std()
        self.voltage_history.append(v_min)
        a = np.zeros(17)

        if v_min < 0.94:  # emergency
            a[0:5] = _RENEW_MAX
            a[10:14] = _CAP_ON[:4]
            a[16] = 0.95
        elif len(self.voltage_history) >= 3:  # trend rules
            h = list(self.voltage_history)
            trend = np.mean(h[-3:]) - np.mean(h[:3])
            if trend < -0.005:  # dropping
                a[0:3], a[3:5] = 0.04, 0.08
                a[10:12] = _CAP_ON[:2]
                a[16] = 0.98
            elif trend > 0.005:  # rising
                a[0:3], a[3:5] = 0.02, 0.04
                a[10] = _CAP_ON[0] if v_min < 0.97 else 0.0
                a[16] = 1.0
            else:  # stable
                if v_min < 0.97:
                    a[0:3], a[3:5] = 0.03, 0.06
                    a[10:12] = _CAP_ON[:2]
                else:
                    a[0:3], a[3:5] = 0.025, 0.05
                    a[10] = _CAP_ON[0]
                a[16] = 1.0
        elif v_std > 0.01:  # high spread
            a[0:5] = [0.03, 0.03, 0.03, 0.06, 0.06]
            a[10:13] = _CAP_ON[:3]
            a[16] = 0.99
        else:  # graded normal operation
            error = 0.98 - v_min
            if error > 0.02:
                a[0:3], a[3:5] = 0.04, 0.08
                a[10:12] = _CAP_ON[:2]
            elif error > 0.01:
                a[0:3], a[3:5] = 0.03, 0.06
                a[10] = _CAP_ON[0]
            else:
                a[0:3], a[3:5] = 0.02, 0.04
            a[16] = np.clip(1.0 - error * 2, 0.95, 1.05)

        # (The reference keeps an action_history deque whose append is
        # guarded by its own emptiness — unreachable dead state; dropped.)
        return a


class L5_ScipyOptimal:
    """L5: SLSQP over a 12-dim continuous relaxation (5 renewable P, 6 cap
    on-fractions, 1 tap) against a measured linear voltage model, with an
    emergency bypass, voltage-aware warm starts blended 70/30 with the
    previous action, binary cap rounding, and an initialization fallback on
    solver failure (:259-491)."""

    def __init__(self, env):
        self.env = env
        self.cap_ratings = np.array([1.0, 1.0, 0.15, 0.1, 0.2, 0.15])
        self.renewable_max = _RENEW_MAX.copy()
        # Hand-fitted sensitivities (measured on the reference env).
        self.dv_dp, self.dv_dq, self.dv_oltc = 0.015, 0.001, 0.01
        self.prev_action = None
        self.action_history = deque(maxlen=10)
        self.voltage_history = deque(maxlen=10)

    # -- model --------------------------------------------------------
    def _predict_dv(self, x):
        renewable_mw = np.sum(x[:5])
        cap_mvar = float(np.sum(self.cap_ratings * 10 * x[5:11]))
        return (renewable_mw * self.dv_dp + cap_mvar * self.dv_dq
                + (x[11] - 1.0) * self.dv_oltc), renewable_mw, cap_mvar

    def _objective(self, x, v_min, v_avg, v_max, prev_x):
        dv, renewable_mw, cap_mvar = self._predict_dv(x)
        v_min_new = v_min + dv
        v_max_new = v_max + dv * 0.5  # head-end buses move less
        cost = 0.0
        if v_min_new < 0.95:
            cost += 100 * (0.95 - v_min_new) ** 2
        if v_max_new > 1.05:
            cost += 100 * (v_max_new - 1.05) ** 2
        if v_min_new >= 0.95:
            cost += 0.1 * ((1.0 - v_min_new) ** 2 + (1.0 - v_avg) ** 2)
        cost += 0.0001 * (renewable_mw + 0.01 * cap_mvar)
        if prev_x is not None:
            cost += 0.001 * np.sum(np.abs(x - prev_x))
        if v_min < 0.96 and renewable_mw < 0.05 and cap_mvar < 10:
            cost += 1.0  # doing nothing under low voltage is penalized
        return cost

    def _warm_start(self, v_min):
        x0 = np.zeros(12)
        if v_min < 0.95:
            x0[:5], x0[5:11], x0[11] = self.renewable_max * 0.8, [1, 1, 1, 1, 0, 0], 0.97
        elif v_min < 0.96:
            x0[:5], x0[5:11], x0[11] = self.renewable_max * 0.5, [1, 1, 0, 0, 0, 0], 0.99
        elif v_min < 0.97:
            x0[:5], x0[5:11], x0[11] = self.renewable_max * 0.3, [1, 0, 0, 0, 0, 0], 1.0
        else:
            x0[:5], x0[11] = self.renewable_max * 0.2, 1.0
        return x0

    def _prev_x(self):
        if self.prev_action is None:
            return None
        pa = self.prev_action
        return np.concatenate([pa[0:5], (pa[10:16] > 0.5).astype(float), [pa[16]]])

    def _action_from_x(self, x):
        a = np.zeros(17)
        a[0:5] = x[:5]
        for i in range(6):
            if x[5 + i] > 0.5:
                a[10 + i] = 1.0 if self.cap_ratings[i] >= 1.0 else self.cap_ratings[i] / 10.0
        a[16] = x[11]
        return a

    def act(self, env):
        v = _voltages(env.unwrapped.simulator)
        v_min, v_max, v_avg = v.min(), v.max(), v.mean()
        self.voltage_history.append(v_min)

        # Emergency bypass: no optimization under critical undervoltage.
        if v_min < 0.94:
            a = np.zeros(17)
            a[0:5] = self.renewable_max
            a[10:14] = [1.0, 1.0, 0.015, 0.01]
            a[16] = 0.95
            return a

        x0 = self._warm_start(v_min)
        prev_x = self._prev_x()
        if prev_x is not None:
            x0 = 0.7 * x0 + 0.3 * prev_x

        bounds = [(0, m) for m in self.renewable_max] + [(0, 1)] * 6 + [(0.95, 1.05)]

        def v_constraint(x):
            dv, _, _ = self._predict_dv(x)
            return [v_min + dv - 0.948, 1.052 - (v_max + dv * 0.5)]

        def act_constraint(x):
            if v_min < 0.96:
                return [np.sum(x[:5]) - 0.05, np.sum(x[5:11]) - 1]
            return [1.0, 1.0]

        try:
            res = minimize(
                self._objective, x0, args=(v_min, v_avg, v_max, prev_x),
                method="SLSQP", bounds=bounds,
                constraints=[{"type": "ineq", "fun": v_constraint},
                             {"type": "ineq", "fun": act_constraint}],
                options={"maxiter": 100, "ftol": 1e-6},
            )
            if res.success:
                a = self._action_from_x(res.x)
                self.prev_action = a.copy()
                self.action_history.append(a)
                return a
        except Exception:
            pass

        a = self._action_from_x(x0)  # fallback: the warm start itself
        self.prev_action = a.copy()
        self.action_history.append(a)
        return a
