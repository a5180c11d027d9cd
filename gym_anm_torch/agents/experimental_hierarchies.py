"""The three experimental 13-dim L0-L5 sets from the reference's iteration
history.

Port of ``gym_anm_tpu/agents/experimental_hierarchies.py``, with the same
decisions: the controllers are host numpy and read the port's compat
:class:`~gym_anm_torch.env.Simulator` through its host views
(``buses[*].v``, ``devices[*].p_pot``), so an ``act`` runs no device op
whichever device the environment steps on.

Equivalents of the non-exported controller files (behavior preserved):

* ``Improved*`` — ``agents/ieee33_controllers/improved_hierarchy.py:6-403``:
  capability ladder by DEVICE CLASS (reactive-only → +OLTC → +caps →
  strategy-table MPC), all at conservative renewable levels (10-25%).
* ``Final*`` — ``final_hierarchy.py:6-292``: capability ladder by
  RENEWABLE UTILIZATION (50% → 70% → 85% → 95% → 100%) with progressively
  richer device use and loss-aware L5.
* ``Modified*`` — ``modified_hierarchy.py:6-270``: intentionally flawed
  behaviors for offline-RL data diversity — ultra-conservative,
  Q-wasteful, OLTC-thrashing, uncoordinated-oscillating — topped by the
  one sound controller (``ModifiedL5_Smart``).

Action layout (13-dim): [5 renewable P, 5 renewable Q, 2 cap Q, 1 tap].
"""

import numpy as np

from .ieee33_controllers import TAP_POSITIONS, _voltages

_Q_LIMITS = np.array([0.02, 0.02, 0.02, 0.04, 0.04])
_RENEWABLE_IDS = range(36, 41)


def _pots(sim):
    return np.array([sim.devices[g].p_pot if g in sim.devices else 0.0
                     for g in _RENEWABLE_IDS])


def _local_v(sim, v):
    """Voltage at each renewable's bus (system mean when absent)."""
    out = np.full(5, v.mean())
    for i, g in enumerate(_RENEWABLE_IDS):
        if g in sim.devices:
            b = sim.devices[g].bus_id
            if b < len(v):
                out[i] = v[b]
    return out


class _Base:
    def __init__(self, env):
        self.env = env


# ---------------------------------------------------------------------------
# Improved* — device-class capability ladder (improved_hierarchy.py)
# ---------------------------------------------------------------------------
class ImprovedL0_Random(_Base):
    def act(self, env):
        return env.action_space.sample()


class ImprovedL1_Basic(_Base):
    """10% renewables, nothing else (:16-43)."""

    def act(self, env):
        sim = env.unwrapped.simulator
        a = np.zeros(13)
        a[0:5] = _pots(sim) * 0.10
        a[12] = 1.0
        return a


class ImprovedL2_VoltageReactive(_Base):
    """15% renewables + threshold reactive (:47-84)."""

    def act(self, env):
        sim = env.unwrapped.simulator
        v = _voltages(sim)
        a = np.zeros(13)
        a[0:5] = _pots(sim) * 0.15
        if v.min() < 0.96:
            a[5:10] = 0.02
        elif v.max() > 1.04:
            a[5:10] = -0.02
        a[12] = 1.0
        return a


class ImprovedL3_SingleDevice(_Base):
    """+OLTC with a 5-step lockout timer (:86-148)."""

    def __init__(self, env):
        super().__init__(env)
        self.last_tap_idx = 2
        self.tap_timer = 0

    def act(self, env):
        sim = env.unwrapped.simulator
        v = _voltages(sim)
        v_min, v_max = v.min(), v.max()
        a = np.zeros(13)
        a[0:5] = _pots(sim) * 0.18
        if v_min < 0.965:
            a[5:10] = 0.015
        elif v_max > 1.035:
            a[5:10] = -0.015

        self.tap_timer = max(0, self.tap_timer - 1)
        if self.tap_timer == 0:
            if v_min < 0.94:
                idx = 0
            elif v_min < 0.96:
                idx = 1
            elif v_max > 1.06:
                idx = 4
            elif v_max > 1.04:
                idx = 3
            else:
                idx = 2
            if idx != self.last_tap_idx:
                self.last_tap_idx = idx
                self.tap_timer = 5
        a[12] = TAP_POSITIONS[self.last_tap_idx]
        return a


class ImprovedL4_MultiDevice(_Base):
    """+capacitors: need-classified coordinated dispatch with a shared
    device timer (:150-262)."""

    CAP_VALUES = [0.0, 0.15, 0.25]
    # need -> (cap1_idx, cap2_idx, tap_idx)
    _PLAN = {
        "boost_high": (2, 1, 1),
        "boost_low": (1, 0, 2),
        "reduce_high": (0, 0, 3),
        "reduce_low": (0, 0, 2),
    }

    def __init__(self, env):
        super().__init__(env)
        self.last_tap_idx = 2
        self.last_cap1_idx = 0
        self.last_cap2_idx = 0
        self.device_timer = 0

    def act(self, env):
        sim = env.unwrapped.simulator
        v = _voltages(sim)
        v_min, v_max = v.min(), v.max()
        a = np.zeros(13)

        ren = 0.15 if v_max > 1.03 else (0.22 if v_min < 0.97 else 0.20)
        a[0:5] = _pots(sim) * ren
        lv = _local_v(sim, v)
        a[5:10] = np.where(lv < 0.96, 0.02, np.where(lv > 1.04, -0.02, 0.0))

        self.device_timer = max(0, self.device_timer - 1)
        if self.device_timer == 0:
            if v_min < 0.95:
                need = "boost_high"
            elif v_min < 0.97:
                need = "boost_low"
            elif v_max > 1.05:
                need = "reduce_high"
            elif v_max > 1.03:
                need = "reduce_low"
            else:
                need = None
            if need is not None:
                c1, c2, t = self._PLAN[need]
                if (c1, c2, t) != (self.last_cap1_idx, self.last_cap2_idx, self.last_tap_idx):
                    self.last_cap1_idx, self.last_cap2_idx, self.last_tap_idx = c1, c2, t
                    self.device_timer = 5

        a[10] = self.CAP_VALUES[self.last_cap1_idx]
        a[11] = self.CAP_VALUES[self.last_cap2_idx]
        a[12] = TAP_POSITIONS[self.last_tap_idx]
        return a


class ImprovedL5_Optimal(_Base):
    """Strategy-table MPC: emergency/boost/reduce/optimize regimes from
    min/max voltage + trend, with local renewable/Q adjustments
    (:264-403)."""

    # strategy -> (ren_level, cap1, cap2, tap_idx, q_factor)
    _STRATEGY = {
        "emergency_boost": (0.25, 0.3, 0.2, 0, 1.0),
        "emergency_reduce": (0.10, 0.0, 0.0, 4, -1.0),
        "boost": (0.22, 0.2, 0.1, 1, 0.5),
        "reduce": (0.15, 0.0, 0.0, 3, -0.5),
    }

    def __init__(self, env):
        super().__init__(env)
        self.voltage_history = []

    def act(self, env):
        sim = env.unwrapped.simulator
        v = _voltages(sim)
        v_min, v_max, v_mean = v.min(), v.max(), v.mean()
        self.voltage_history = (self.voltage_history + [v_min])[-5:]
        trend = (self.voltage_history[-1] - self.voltage_history[-2]
                 if len(self.voltage_history) >= 2 else 0.0)

        if v_min < 0.93 or (v_min < 0.95 and trend < -0.01):
            strategy = "emergency_boost"
        elif v_max > 1.07 or (v_max > 1.05 and trend > 0.01):
            strategy = "emergency_reduce"
        elif v_min < 0.96:
            strategy = "boost"
        elif v_max > 1.04:
            strategy = "reduce"
        else:
            strategy = "optimize"

        if strategy == "optimize":
            ren, cap1, cap2, tap_idx, qf = 0.20, (0.1 if v_mean < 0.99 else 0.0), 0.0, 2, 0.0
        else:
            ren, cap1, cap2, tap_idx, qf = self._STRATEGY[strategy]

        a = np.zeros(13)
        pots = _pots(sim)
        lv = _local_v(sim, v)
        local_adj = np.where(lv > 1.04, 0.8, np.where(lv < 0.96, 1.2, 1.0))
        a[0:5] = np.minimum(pots, pots * ren * local_adj)

        if qf != 0:
            a[5:10] = _Q_LIMITS * qf * 0.5
        else:
            a[5:10] = np.where(lv < 0.97, _Q_LIMITS * 0.5,
                               np.where(lv > 1.03, -_Q_LIMITS * 0.5, 0.0))
        a[10], a[11], a[12] = cap1, cap2, TAP_POSITIONS[tap_idx]
        return a


# ---------------------------------------------------------------------------
# Final* — renewable-utilization ladder (final_hierarchy.py)
# ---------------------------------------------------------------------------
class FinalL0_Random(_Base):
    def act(self, env):
        return env.action_space.sample()


class FinalL1_Minimal(_Base):
    """50% renewables only (:16-41)."""

    def act(self, env):
        a = np.zeros(13)
        a[0:5] = _pots(env.unwrapped.simulator) * 0.5
        a[12] = 1.0
        return a


class FinalL2_Reactive(_Base):
    """70% renewables + threshold Q (:45-82)."""

    def act(self, env):
        sim = env.unwrapped.simulator
        v = _voltages(sim)
        a = np.zeros(13)
        a[0:5] = _pots(sim) * 0.7
        if v.min() < 0.96:
            a[5:10] = 0.015
        elif v.max() > 1.04:
            a[5:10] = -0.015
        a[12] = 1.0
        return a


class FinalL3_SingleDevice(_Base):
    """85% renewables + Q + lockout OLTC (:84-138)."""

    def __init__(self, env):
        super().__init__(env)
        self.last_tap = 1.0
        self.tap_timer = 0

    def act(self, env):
        sim = env.unwrapped.simulator
        v = _voltages(sim)
        v_min, v_max = v.min(), v.max()
        a = np.zeros(13)
        a[0:5] = _pots(sim) * 0.85
        if v_min < 0.965:
            a[5:10] = 0.01
        elif v_max > 1.035:
            a[5:10] = -0.01
        self.tap_timer = max(0, self.tap_timer - 1)
        if self.tap_timer == 0:
            new_tap = 0.95 if v_min < 0.95 else (1.05 if v_max > 1.05 else 1.0)
            if new_tap != self.last_tap:
                self.last_tap = new_tap
                self.tap_timer = 5
        a[12] = self.last_tap
        return a


class FinalL4_MultiDevice(_Base):
    """95% renewables + all devices on simple staged logic (:140-198)."""

    def __init__(self, env):
        super().__init__(env)
        self.cap_state = [0.0, 0.0]
        self.last_tap = 1.0
        self.device_timer = 0

    def act(self, env):
        sim = env.unwrapped.simulator
        v = _voltages(sim)
        v_min, v_max = v.min(), v.max()
        a = np.zeros(13)
        a[0:5] = _pots(sim) * 0.95
        if v_min < 0.97:
            a[5:10] = 0.01
        elif v_max > 1.03:
            a[5:10] = -0.01
        self.device_timer = max(0, self.device_timer - 1)
        if self.device_timer == 0:
            if v_min < 0.95:
                self.cap_state, self.last_tap = [0.15, 0.1], 0.95
            elif v_min < 0.97:
                self.cap_state, self.last_tap = [0.1, 0.0], 1.0
            elif v_max > 1.05:
                self.cap_state, self.last_tap = [0.0, 0.0], 1.05
            else:
                self.cap_state, self.last_tap = [0.0, 0.0], 1.0
            self.device_timer = 5
        a[10], a[11] = self.cap_state
        a[12] = self.last_tap
        return a


class FinalL5_Optimal(_Base):
    """100% renewables + loss-minimizing voltage hold near 1.0
    (:200-292)."""

    def __init__(self, env):
        super().__init__(env)
        self.voltage_history = []

    def act(self, env):
        sim = env.unwrapped.simulator
        v = _voltages(sim)
        v_min, v_max, v_mean = v.min(), v.max(), v.mean()
        self.voltage_history = (self.voltage_history
                                + [{"min": v_min, "max": v_max, "mean": v_mean}])[-5:]

        a = np.zeros(13)
        pots = _pots(sim)
        factor = 0.95 if v_max > 1.045 else 1.0
        a[0:5] = pots * factor
        total_renewable = a[0:5].sum()

        if v_min < 0.94:  # emergency-only Q (Q increases losses)
            a[5:10] = 0.01

        if total_renewable > 0.1:  # day
            if v_min < 0.97:
                cap1, cap2, tap = 0.1, 0.0, 1.0
            elif v_max > 1.04:
                cap1, cap2, tap = 0.0, 0.0, 1.05
            else:
                cap1, cap2, tap = 0.0, 0.0, 1.0
        else:  # night: firmer voltage support
            if v_min < 0.95:
                cap1, cap2, tap = 0.15, 0.1, 0.95
            elif v_min < 0.97:
                cap1, cap2, tap = 0.1, 0.05, 1.0
            elif v_min < 0.98:
                cap1, cap2, tap = 0.05, 0.0, 1.0
            else:
                cap1, cap2, tap = 0.0, 0.0, 1.0
        if v_max - v_min > 0.08 and v_mean < 0.99:
            tap = 0.95

        a[10], a[11], a[12] = cap1, cap2, tap
        return a


# ---------------------------------------------------------------------------
# Modified* — intentionally flawed behaviors (modified_hierarchy.py)
# ---------------------------------------------------------------------------
class ModifiedL0_Random(_Base):
    def act(self, env):
        return env.action_space.sample()


class ModifiedL1_Conservative(_Base):
    """Ultra-conservative: 20% renewables, nothing else (:16-39)."""

    def act(self, env):
        a = np.zeros(13)
        a[0:5] = _pots(env.unwrapped.simulator) * 0.2
        a[12] = 1.0
        return a


class ModifiedL2_Wasteful(_Base):
    """Q always at maximum — deliberately loss-increasing (:43-71)."""

    def act(self, env):
        a = np.zeros(13)
        a[0:5] = _pots(env.unwrapped.simulator) * 0.6
        a[5:10] = _Q_LIMITS
        a[12] = 1.0
        return a


class ModifiedL3_Aggressive(_Base):
    """OLTC thrashes every other step — equipment-hostile (:73-117)."""

    def __init__(self, env):
        super().__init__(env)
        self.step_count = 0

    def act(self, env):
        sim = env.unwrapped.simulator
        v_min = _voltages(sim).min()
        a = np.zeros(13)
        a[0:5] = _pots(sim) * 0.8
        if v_min < 0.97:
            a[5:10] = _Q_LIMITS * 0.5
        self.step_count += 1
        if self.step_count % 2 == 0:
            a[12] = 0.95 if v_min < 0.98 else 1.05
        else:
            a[12] = 1.0
        return a


class ModifiedL4_Uncoordinated(_Base):
    """Oscillating capacitors, tap fighting them (:119-164)."""

    def __init__(self, env):
        super().__init__(env)
        self.cap_on = True

    def act(self, env):
        sim = env.unwrapped.simulator
        v_min = _voltages(sim).min()
        a = np.zeros(13)
        a[0:5] = _pots(sim) * 0.9
        a[5:10] = _Q_LIMITS * 0.75 if v_min < 0.96 else -_Q_LIMITS * 0.25
        self.cap_on = not self.cap_on
        if self.cap_on:
            a[10], a[11], a[12] = 0.3, 0.2, 1.05  # tap fights the caps
        else:
            a[12] = 0.95
        return a


class ModifiedL5_Smart(_Base):
    """The one sound controller: full renewables, minimal Q, hysteresis
    device coordination with day/night regimes (:166-270)."""

    def __init__(self, env):
        super().__init__(env)
        self.voltage_history = []
        self.last_caps = [0.0, 0.0]
        self.last_tap = 1.0

    def act(self, env):
        sim = env.unwrapped.simulator
        v = _voltages(sim)
        v_min, v_max = v.min(), v.max()
        self.voltage_history = (self.voltage_history + [v_min])[-3:]
        trend = (self.voltage_history[-1] - self.voltage_history[0]
                 if len(self.voltage_history) >= 3 else 0.0)

        a = np.zeros(13)
        pots = _pots(sim)
        a[0:5] = pots * (0.98 if v_max > 1.045 else 1.0)
        total_renewable = a[0:5].sum()

        if v_min < 0.94:
            a[5:10] = _Q_LIMITS * 0.5
        elif v_max > 1.06:
            a[5:10] = -_Q_LIMITS * 0.5

        cap1, cap2, tap = self.last_caps[0], self.last_caps[1], self.last_tap
        if total_renewable > 0.1:  # day: conservative with hysteresis
            if v_min < 0.96 and self.last_caps[0] == 0:
                cap1 = 0.1
            elif v_min > 0.98 and self.last_caps[0] > 0:
                cap1 = 0.0
            if v_min < 0.95 and cap1 > 0:
                tap = 0.95
            elif v_max > 1.05:
                tap, cap1 = 1.05, 0.0
            else:
                tap = 1.0
        else:  # night: staged support
            if v_min < 0.94:
                cap1, cap2, tap = 0.2, 0.15, 0.95
            elif v_min < 0.96:
                cap1, cap2 = 0.15, 0.1
                tap = 0.95 if trend < 0 else 1.0
            elif v_min < 0.98:
                cap1, cap2, tap = 0.1, 0.0, 1.0
            else:  # gradual shutdown
                if self.last_caps[1] > 0:
                    cap2 = 0.0
                elif self.last_caps[0] > 0:
                    cap1 = 0.0
                tap = 1.0

        a[10], a[11], a[12] = cap1, cap2, tap
        self.last_caps = [cap1, cap2]
        self.last_tap = tap
        return a
