"""Controllers for the 17-dim multi-capacitor IEEE33 environments.

Port of ``gym_anm_tpu/agents/multicap_controllers.py``, with the same
decisions: the controllers are host numpy and read the port's compat
:class:`~gym_anm_torch.env.Simulator` through its host views
(``buses[*].v``, ``devices[*].p_pot``), so an ``act`` runs no device op
whichever device the environment steps on.

Equivalents of the reference's capacitor-fleet controller files (behavior,
thresholds and gains preserved; code restructured around shared helpers):

* ``L2_ProportionalControl_MultiCap`` / ``L5_HierarchicalMPC_MultiCap`` —
  ``agents/ieee33_controllers/multi_capacitor_hierarchy.py:14-350``
* ``L5_SwitchingAwareMPC`` — ``switching_aware_mpc.py:8-170``
* ``L2_DiscreteDroop`` — ``discrete_droop_l2.py:6-70``
* ``L5_TrueMPC`` — ``true_mpc_l5.py:8-258``
* ``L5_EnhancedSwitchingAware`` — ``enhanced_switching_aware_l5.py:6-271``

Action layout (17-dim): [5 renewable P, 5 renewable Q, 6 cap Q, 1 OLTC tap]
(``ieee33_multi_capacitor.py:75-88``).  All controllers follow the
duck-typed protocol ``agent.act(env) -> np.ndarray`` and read the live grid
through ``env.unwrapped.simulator``.
"""

from collections import deque

import numpy as np

from .ieee33_controllers import _voltages, TAP_POSITIONS

_Q_LIMITS = np.array([0.02, 0.02, 0.02, 0.04, 0.04])
_RENEWABLE_IDS = range(36, 41)


def _cap_info(env, default_ratings=(1.0, 1.0, 0.15, 0.1, 0.2, 0.15)):
    """(num, buses, ratings MVAr, switching costs) from the env, with the
    multi-capacitor defaults when the hook is absent."""
    if hasattr(env, "get_capacitor_info"):
        info = env.get_capacitor_info()
    else:
        info = {}
    ratings = np.asarray(info.get("capacitor_ratings", default_ratings), float)
    return (
        info.get("num_capacitors", len(ratings)),
        list(info.get("capacitor_buses", [8, 25, 6, 12, 17, 32])),
        ratings,
        np.asarray(info.get("switching_costs", 0.01 * ratings), float),
    )


def _renewable_pots(sim):
    """p_pot per renewable device id 36..40 (0 when the device is absent)."""
    return np.array(
        [sim.devices[g].p_pot if g in sim.devices else 0.0 for g in _RENEWABLE_IDS]
    )


class L2_ProportionalControl_MultiCap:
    """L2 proportional control, all six capacitors driven by the same rule
    (deliberately location-blind — the suboptimal baseline the L5 variants
    beat; multi_capacitor_hierarchy.py:14-89)."""

    def __init__(self, env):
        self.env = env
        self.kp_renewable, self.kp_reactive = 5.0, 2.0
        self.kp_cap, self.kp_oltc = 3.0, 5.0
        n, buses, ratings, _ = _cap_info(env)
        self.num_caps, self.cap_buses = n, buses
        self.cap_ratings = ratings / env.unwrapped.simulator.baseMVA

    def act(self, env):
        sim = env.unwrapped.simulator
        v = _voltages(sim)
        v_min, v_max = v.min(), v.max()
        a = np.zeros(17)

        pots = _renewable_pots(sim)
        if v_max > 1.045:
            curt = min(0.7, self.kp_renewable * (v_max - 1.045))
            a[0:5] = pots * (1 - curt)
        else:
            a[0:5] = pots

        if v_min < 0.98:
            a[5:10] = _Q_LIMITS * min(1.0, self.kp_reactive * (0.98 - v_min))
        elif v_max > 1.02:
            a[5:10] = -_Q_LIMITS * min(1.0, self.kp_reactive * (v_max - 1.02))

        if v_min < 0.97:
            sig = self.kp_cap * (0.97 - v_min)
            a[10:10 + self.num_caps] = np.minimum(
                self.cap_ratings, sig * self.cap_ratings)[: self.num_caps]

        if v_min < 0.96:
            a[16] = max(0.9, 1.0 - self.kp_oltc * (0.96 - v_min))
        elif v_max > 1.04:
            a[16] = min(1.1, 1.0 + self.kp_oltc * (v_max - 1.04))
        else:
            a[16] = 1.0
        return a


class L2_DiscreteDroop:
    """L2 droop with discrete all-or-nothing capacitor switching and
    hysteresis (discrete_droop_l2.py:6-70)."""

    def __init__(self, env):
        self.env = env
        self.v_low, self.v_high = 0.97, 1.03
        n, _, ratings, _ = _cap_info(env)
        self.num_caps, self.cap_ratings = n, ratings
        self.caps_on = False

    def act(self, env):
        v = _voltages(env.unwrapped.simulator)
        v_min, v_max, v_avg = v.min(), v.max(), v.mean()
        if v_min < self.v_low:
            self.caps_on = True
        elif v_max > self.v_high:
            self.caps_on = False

        a = np.zeros(17)
        a[0:5] = 0.03
        if self.caps_on:
            a[10:10 + self.num_caps] = self.cap_ratings[: self.num_caps] / 10.0
        a[16] = 1.05 if v_avg < 0.98 else (0.95 if v_avg > 1.02 else 1.0)
        return a


class L5_HierarchicalMPC_MultiCap:
    """L5 hierarchical MPC with location-aware capacitor scheduling:
    two-timescale updates, emergency-mode hysteresis, load forecasting,
    per-capacitor local-voltage dispatch and upstream-first loss
    redistribution (multi_capacitor_hierarchy.py:92-350)."""

    def __init__(self, env):
        self.env = env
        self.fast_horizon, self.slow_horizon = 2, 5
        self.v_ref = 1.0
        self.state_buffer = deque(maxlen=10)
        self.load_forecast = 1.0
        n, buses, ratings, _ = _cap_info(env)
        self.num_caps, self.cap_buses = n, buses
        self.cap_ratings = ratings / env.unwrapped.simulator.baseMVA
        self.cap_schedule = np.zeros(n)
        self.tap_schedule = 1.0
        self.update_counter = 0
        self.emergency_mode = False
        self.last_v_avg = 1.0
        self.tap_history = deque([1.0, 1.0, 1.0], maxlen=3)
        self.cap_usage_history = deque(maxlen=20)

    # -- per-step state estimation ------------------------------------
    def _estimate(self, sim):
        v = _voltages(sim)
        p = np.array([bus.p for bus in sim.buses.values()])
        return {
            "v_avg": v.mean(), "v_min": v.min(), "v_max": v.max(),
            "v_std": v.std(), "p_total": p.sum(), "voltages": v,
        }

    def act(self, env):
        sim = env.unwrapped.simulator
        st = self._estimate(sim)
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
            self._schedule_slow(st)

        a = np.zeros(17)
        a[0:5] = self._renewable_p(sim, st)
        a[5:10] = self._renewable_q(sim, st)
        a[10:10 + self.num_caps] = self.cap_schedule[: self.num_caps]
        self.tap_history.append(self.tap_schedule)
        smoothed = np.mean(self.tap_history)
        a[16] = min(TAP_POSITIONS, key=lambda x: abs(x - smoothed))
        return a

    def _renewable_p(self, sim, st):
        out = np.zeros(5)
        v = st["voltages"]
        for i, g in enumerate(_RENEWABLE_IDS):
            if g not in sim.devices:
                continue
            gen = sim.devices[g]
            local_v = v[gen.bus_id] if gen.bus_id < len(v) else st["v_avg"]
            if self.emergency_mode:
                if st["v_max"] > 1.05:
                    out[i] = gen.p_pot * (1 - min(0.8, 10 * (st["v_max"] - 1.05)))
                elif st["v_min"] < 0.95:
                    out[i] = gen.p_pot
                else:
                    out[i] = gen.p_pot * 0.9
            else:
                local = gen.p_pot * max(0.0, 2 - 20 * (local_v - 1.048)) if local_v > 1.048 else gen.p_pot
                glob = gen.p_pot * 0.7 if st["v_max"] > 1.045 else gen.p_pot
                out[i] = min(local, glob)
        return out

    def _renewable_q(self, sim, st):
        out = np.zeros(5)
        v = st["voltages"]
        if self.emergency_mode:
            for i in range(5):
                if st["v_min"] < 0.95:
                    out[i] = _Q_LIMITS[i]
                elif st["v_max"] > 1.05:
                    out[i] = -_Q_LIMITS[i]
                else:
                    out[i] = np.clip((1.0 - st["v_avg"]) * 20, -_Q_LIMITS[i], _Q_LIMITS[i])
        else:
            targets = self._voltage_targets(st)
            for i, g in enumerate(_RENEWABLE_IDS):
                if g in sim.devices:
                    b = sim.devices[g].bus_id
                    local_v = v[b] if b < len(v) else st["v_avg"]
                    out[i] = np.clip((targets.get(b, 1.0) - local_v) * 15, -_Q_LIMITS[i], _Q_LIMITS[i])
        return out

    def _voltage_targets(self, st):
        # Buses hosting an energized capacitor aim slightly high; the rest 1.0.
        return {b: (1.01 if self.cap_schedule[i] > 0 else 1.0)
                for i, b in enumerate(self.cap_buses)}

    def _schedule_slow(self, st):
        v = st["voltages"]
        if self.emergency_mode:
            v_min, v_max = st["v_min"], st["v_max"]
            if v_min < 0.94 and v_max < 1.02:
                self.tap_schedule = 0.95
            elif v_max > 1.06 and v_min > 0.98:
                self.tap_schedule = 1.05
            elif st["v_avg"] < 0.98:
                self.tap_schedule = 0.98
            elif st["v_avg"] > 1.02:
                self.tap_schedule = 1.02
            else:
                self.tap_schedule = 1.0
            self.cap_schedule = (
                self.cap_ratings * 0.9 if v_min < 0.95 else np.zeros(self.num_caps)
            )
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

            sched = np.zeros(self.num_caps)
            for i, b in enumerate(self.cap_buses):
                local_v = v[b] if b < len(v) else st["v_avg"]
                if local_v < 0.96:
                    sched[i] = self.cap_ratings[i] * 0.8
                elif local_v < 0.97:
                    sched[i] = self.cap_ratings[i] * 0.5
                elif local_v < 0.98:
                    sched[i] = self.cap_ratings[i] * 0.3
                if st["v_max"] > 1.045:
                    sched[i] = 0.0
                elif st["v_max"] > 1.04:
                    sched[i] *= 0.5
            # Loss minimization: when many caps are needed, repack the same
            # total MVAr into the most-upstream units.
            if np.sum(sched > 0) > 3:
                total = sched.sum()
                repacked = np.zeros(self.num_caps)
                allocated = 0.0
                for idx in np.argsort(self.cap_buses):
                    if allocated >= total:
                        break
                    take = min(self.cap_ratings[idx], total - allocated)
                    repacked[idx] = take
                    allocated += take
                sched = repacked * 0.8
            self.cap_schedule = sched
        self.cap_usage_history.append(self.cap_schedule.copy())


class L5_SwitchingAwareMPC(L5_HierarchicalMPC_MultiCap):
    """Hierarchical MPC that prices capacitor switching: hysteresis bands,
    a minimum interval between switches, benefit-vs-cost tests, and a cap
    of two simultaneous switches (switching_aware_mpc.py:8-170)."""

    def __init__(self, env, switching_cost=0.005):
        super().__init__(env)
        self.switching_cost = switching_cost
        self.min_switch_interval = 10
        self.prev_cap_states = np.zeros(self.num_caps)
        self.time_since_switch = np.zeros(self.num_caps)
        self.cap_on_threshold = 0.965
        self.cap_off_threshold = 0.985
        self.switch_history = deque(maxlen=100)

    def _schedule_slow(self, st):
        self.time_since_switch += 1
        v = st["voltages"]
        if self.emergency_mode:
            v_min, v_max = st["v_min"], st["v_max"]
            if v_min < 0.94 and v_max < 1.02:
                self.tap_schedule = 0.95
            elif v_max > 1.06 and v_min > 0.98:
                self.tap_schedule = 1.05
            elif st["v_avg"] < 0.98:
                self.tap_schedule = 0.98
            elif st["v_avg"] > 1.02:
                self.tap_schedule = 1.02
            else:
                self.tap_schedule = 1.0

            if v_min < 0.93:
                self.cap_schedule = self.cap_ratings * 0.9
            else:
                sched = np.zeros(self.num_caps)
                for i in range(self.num_caps):
                    cur = self.cap_schedule[i]
                    if cur < 0.1:
                        if v_min < 0.95 and self.time_since_switch[i] >= self.min_switch_interval:
                            sched[i] = self.cap_ratings[i] * 0.8
                    else:
                        sched[i] = 0.0 if v_max > 1.05 else cur
                self.cap_schedule = sched
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

            sched = self.cap_schedule.copy()
            for i, b in enumerate(self.cap_buses):
                local_v = v[b] if b < len(v) else st["v_avg"]
                cur = self.cap_schedule[i]
                if cur < 0.1:  # OFF — switch on only if the benefit pays
                    if local_v < self.cap_on_threshold:
                        benefit = self.cap_ratings[i] * 0.02 * self.slow_horizon
                        if (benefit > self.switching_cost * self.cap_ratings[i]
                                and self.time_since_switch[i] >= self.min_switch_interval):
                            sched[i] = self.cap_ratings[i] * 0.7
                            self.time_since_switch[i] = 0
                            self._record(i, "ON", local_v)
                else:  # ON — switch off only when clearly high or long-held
                    if local_v > self.cap_off_threshold or st["v_max"] > 1.04:
                        if st["v_max"] > 1.045 or self.time_since_switch[i] > 50:
                            sched[i] = 0.0
                            self.time_since_switch[i] = 0
                            self._record(i, "OFF", local_v)

            # At most 2 simultaneous switches: keep the worst-voltage ones.
            changing = np.abs(sched - self.cap_schedule) > 0.05
            if changing.sum() > 2:
                errs = [(i, abs(1.0 - v[self.cap_buses[i]])) for i in np.where(changing)[0]]
                errs.sort(key=lambda t: t[1], reverse=True)
                allowed = {i for i, _ in errs[:2]}
                for i in np.where(changing)[0]:
                    if i not in allowed:
                        sched[i] = self.cap_schedule[i]
            self.cap_schedule = sched

        self.prev_cap_states = self.cap_schedule.copy()
        self.cap_usage_history.append(self.cap_schedule.copy())

    def _record(self, i, what, voltage):
        self.switch_history.append({
            "timestep": self.update_counter, "capacitor": i,
            "bus": self.cap_buses[i], "action": what,
            "voltage": voltage, "emergency": self.emergency_mode,
        })

    def get_switching_stats(self):
        total = len(self.switch_history)
        emergency = sum(1 for s in self.switch_history if s["emergency"])
        return {
            "total_switches": total,
            "emergency_switches": emergency,
            "normal_switches": total - emergency,
            "avg_time_between_switches": float(np.mean(self.time_since_switch)) if total else 0,
        }


class L5_TrueMPC:
    """L5 MPC with discrete ON/OFF capacitors: linear voltage-trend
    prediction over a horizon, greedy single- and pairwise-flip search over
    configurations against a discounted violation+switching+loss cost, and
    min-on/min-off dwell-time constraints (true_mpc_l5.py:8-258)."""

    def __init__(self, env, prediction_horizon=10):
        self.env = env
        self.prediction_horizon = prediction_horizon
        n, buses, ratings, _ = _cap_info(env)
        self.num_caps, self.cap_buses, self.cap_ratings = n, buses, ratings
        self.cap_states = np.zeros(n, dtype=int)
        self.voltage_history = deque(maxlen=20)
        self.min_on_time = self.min_off_time = 5
        self.time_since_switch = np.zeros(n)
        self.w_voltage, self.w_switching, self.w_losses = 100.0, 1.0, 0.1
        self.v_lo, self.v_hi = 0.95, 1.05

    def act(self, env):
        v = _voltages(env.unwrapped.simulator)
        self.voltage_history.append(v)

        future = self._predict()
        config = self._search(v, future)
        # Enforce dwell times, then commit.
        for i in range(self.num_caps):
            if config[i] != self.cap_states[i] and not self._can_switch(i):
                config[i] = self.cap_states[i]
        for i in range(self.num_caps):
            self.time_since_switch[i] = 0 if config[i] != self.cap_states[i] else self.time_since_switch[i] + 1
        self.cap_states = config

        a = np.zeros(17)
        a[0:5] = 0.03
        for i in range(self.num_caps):
            a[10 + i] = self.cap_ratings[i] / 10.0 if self.cap_states[i] else 0.0
        v_min, v_max = v.min(), v.max()
        a[16] = 1.05 if v_min < 0.94 else (0.95 if v_max > 1.06 else 1.0)
        return a

    def _predict(self):
        if len(self.voltage_history) < 3:
            last = self.voltage_history[-1] if self.voltage_history else np.ones(33)
            return [last] * self.prediction_horizon
        avgs = [np.mean(v) for v in list(self.voltage_history)[-5:]]
        trend = avgs[-1] - avgs[-2] if len(avgs) >= 2 else 0.0
        last = self.voltage_history[-1]
        return [np.clip(last + trend * (t + 1), 0.9, 1.1) for t in range(self.prediction_horizon)]

    def _can_switch(self, i):
        need = self.min_on_time if self.cap_states[i] else self.min_off_time
        return self.time_since_switch[i] >= need

    def _cost(self, config, v_now, future):
        def vio(volts):
            est = volts + sum(0.01 * self.cap_ratings[i] for i in range(self.num_caps) if config[i]) * (2 - volts)
            return np.sum(np.maximum(0, est - self.v_hi) ** 2 + np.maximum(0, self.v_lo - est) ** 2)

        cost = self.w_voltage * vio(v_now)
        for t, fv in enumerate(future):
            cost += (0.9 ** (t + 1)) * self.w_voltage * vio(fv)
        cost += self.w_switching * np.sum(config != self.cap_states)
        if np.mean(v_now) > 0.98:  # light load: energized caps add losses
            cost += self.w_losses * np.sum(config) * 10
        return cost

    def _search(self, v_now, future):
        best = self.cap_states.copy()
        best_cost = self._cost(best, v_now, future)
        # Single flips.
        for i in range(self.num_caps):
            if not self._can_switch(i):
                continue
            trial = self.cap_states.copy()
            trial[i] = 1 - trial[i]
            c = self._cost(trial, v_now, future)
            if c < best_cost:
                best, best_cost = trial, c
        # Pairwise joint settings.
        for i in range(self.num_caps - 1):
            for j in range(i + 1, self.num_caps):
                if not (self._can_switch(i) and self._can_switch(j)):
                    continue
                for si in (0, 1):
                    for sj in (0, 1):
                        trial = self.cap_states.copy()
                        trial[i], trial[j] = si, sj
                        c = self._cost(trial, v_now, future)
                        if c < best_cost:
                            best, best_cost = trial.copy(), c
        return best.copy()


class L5_EnhancedSwitchingAware:
    """L5 for the unequal-capacitor fleet: size-tiered selection (large caps
    for emergencies, tiny caps for trim), per-size dwell intervals,
    locality-aware dispatch near problem buses, and efficiency-ranked
    allocation under distributed deficits
    (enhanced_switching_aware_l5.py:6-271)."""

    def __init__(self, env):
        self.env = env
        n, buses, ratings, costs = _cap_info(env, default_ratings=(3.0, 1.5, 1.2, 0.5, 0.3, 0.1))
        self.num_caps, self.cap_buses = n, buses
        self.cap_ratings, self.switching_costs = ratings, costs
        self.large = [i for i, r in enumerate(ratings) if r >= 2.0]
        self.medium = [i for i, r in enumerate(ratings) if 1.0 <= r < 2.0]
        self.small = [i for i, r in enumerate(ratings) if 0.4 <= r < 1.0]
        self.tiny = [i for i, r in enumerate(ratings) if r < 0.4]
        self.v_ref, self.v_deadband = 1.0, 0.005
        self.prediction_horizon = 10
        self.voltage_history, self.load_history = [], []
        self.cap_switch_state = [0] * n
        self.time_since_switch = [0] * n
        self.emergency_mode = False
        self.oltc_position = 1.0
        rmax = ratings.max() if len(ratings) else 1.0
        self.min_switch_intervals = [max(5, int(20 * r / rmax)) for r in ratings]

    def act(self, env):
        v = _voltages(env.unwrapped.simulator)
        v_min, v_max, v_avg = v.min(), v.max(), v.mean()
        problem = [i for i, vi in enumerate(v) if vi < 0.97 or vi > 1.03]

        self.voltage_history.append(v)
        self.voltage_history = self.voltage_history[-self.prediction_horizon:]
        self.load_history.append(max(0.0, (1.02 - v_avg) * 20))
        self.load_history = self.load_history[-self.prediction_horizon:]
        self.time_since_switch = [t + 1 for t in self.time_since_switch]

        a = np.zeros(17)
        # Renewable Q for local voltage support.
        for i in range(5):
            bus_v = v[min(i * 6, len(v) - 1)]
            a[5 + i] = 0.3 if bus_v < 0.98 else (-0.3 if bus_v > 1.02 else 0.0)
        caps = self._caps(v, v_min, v_max, v_avg, problem)
        # Switch bookkeeping for EVERY control path (emergency/support/trim/
        # all-off), so the per-size dwell intervals actually bind.
        for i in range(self.num_caps):
            on = caps[i] > 0
            if on != bool(self.cap_switch_state[i]):
                self.time_since_switch[i] = 0
                self.cap_switch_state[i] = int(on)
        a[10:10 + self.num_caps] = caps[: self.num_caps]
        a[16] = self._oltc(v_min, v_max)
        # Envs assert containment rather than clipping (anm_env.py:356-357);
        # agents clip themselves (the convention set by mpc.py:341).
        return np.clip(a, env.action_space.low, env.action_space.high)

    def _caps(self, v, v_min, v_max, v_avg, problem):
        if v_min < 0.95 or v_max > 1.05:
            self.emergency_mode = True
        elif v_min > 0.97 and v_max < 1.03:
            self.emergency_mode = False
        trend = (np.mean(self.voltage_history[-1]) - np.mean(self.voltage_history[-3])
                 if len(self.voltage_history) >= 3 else 0.0)

        if self.emergency_mode:
            return self._emergency(v_min)
        if v_avg < 0.98 or (v_avg < 0.99 and trend < -0.005):
            return self._support(v_avg, problem)
        if v_avg > 1.02 or (v_avg > 1.01 and trend > 0.005):
            return np.zeros(self.num_caps)
        return self._trim(v_avg)

    def _ready(self, i):
        return self.time_since_switch[i] >= self.min_switch_intervals[i]

    def _emergency(self, v_min):
        out = np.zeros(self.num_caps)
        if v_min < 0.95:
            for i in self.large:
                if self._ready(i):
                    out[i] = 0.7 * self.cap_ratings[i] / 10
            if v_min < 0.93:
                for i in self.medium:
                    if self._ready(i):
                        out[i] = 0.7 * self.cap_ratings[i] / 10
        return out

    def _support(self, v_avg, problem):
        out = np.zeros(self.num_caps)
        deficit = (1.0 - v_avg) * 50
        if problem and len(problem) < 5:
            # Localized: dispatch the two nearest units per problem bus.
            for bus in problem:
                order = sorted(range(self.num_caps), key=lambda i: abs(bus - self.cap_buses[i]))
                for i in order[:2]:
                    if self._ready(i) and out[i] == 0:
                        frac = 0.7 if i in self.large else (0.6 if i in self.medium else 0.5)
                        out[i] = frac * self.cap_ratings[i] / 10
        else:
            # Distributed: fill the deficit in MVAr-per-switching-cost order.
            order = sorted(range(self.num_caps),
                           key=lambda i: self.cap_ratings[i] / self.switching_costs[i],
                           reverse=True)
            remaining = deficit
            for i in order:
                if remaining <= 0:
                    break
                if not self._ready(i):
                    continue
                if i in self.large and remaining > 2.0:
                    out[i] = 0.7 * self.cap_ratings[i] / 10
                    remaining -= 0.7 * self.cap_ratings[i]
                elif i in self.medium and remaining > 0.8:
                    out[i] = 0.6 * self.cap_ratings[i] / 10
                    remaining -= 0.6 * self.cap_ratings[i]
                elif i in self.small and remaining > 0.2:
                    out[i] = 0.5 * self.cap_ratings[i] / 10
                    remaining -= 0.5 * self.cap_ratings[i]
        return out

    def _trim(self, v_avg):
        out = np.zeros(self.num_caps)
        err = self.v_ref - v_avg
        if err > self.v_deadband:
            for i in self.tiny:
                if self.time_since_switch[i] >= 10:
                    out[i] = 0.5 * self.cap_ratings[i] / 10
                    break
            if err > 0.01:
                for i in self.small:
                    if self._ready(i):
                        out[i] = 0.4 * self.cap_ratings[i] / 10
                        break
        return out

    def _oltc(self, v_min, v_max):
        if self.emergency_mode and v_min < 0.93:
            self.oltc_position = min(1.1, self.oltc_position + 0.025)
        elif v_max > 1.07:
            self.oltc_position = max(0.9, self.oltc_position - 0.025)
        elif not self.emergency_mode:
            if self.oltc_position > 1.0:
                self.oltc_position = max(1.0, self.oltc_position - 0.0125)
            elif self.oltc_position < 1.0:
                self.oltc_position = min(1.0, self.oltc_position + 0.0125)
        return self.oltc_position
