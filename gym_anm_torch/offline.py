"""Offline-RL utilities and the heuristic expert zoo.

Port of ``gym_anm_tpu/offline.py``, with the same decisions and the same
draws: the tools and the heuristics are host numpy (and scipy's ``linprog``
in :class:`OptimizationBasedExpert`) over the port's compat environments,
whose ``Simulator`` steps on the card by default; they read its host views
only.  The noisy heuristics and the mixture's choice of agent draw from
the global ``np.random``, as the JAX package's do.

Drop-in equivalent of the reference ``gym_anm/offline.py:1-989``: dataset
generation (single-agent and mixed), linear behavior cloning, policy
evaluation, and ~25 heuristic expert policies (capacitor-bank, OLTC and
renewable-curtailment families with noisy/delayed/lagging/hysteresis
variants), plus optimization-, sensitivity- and MPC-based experts.  The
optimization-based expert solves its linearized OPF with
``scipy.optimize.linprog`` instead of cvxpy/ECOS.

For batched dataset generation on the device, see
:mod:`gym_anm_torch.offline_vec`.
"""

from typing import Callable, Optional, Sequence

import numpy as np

from .specs.constants import (
    DEV_TYPE_CAPACITOR,
    DEV_TYPE_OLTC,
    DEV_TYPE_RENEWABLE_GEN,
    DEV_TYPE_STORAGE,
)


# ---------------------------------------------------------------------------
# Dataset utilities (same API surface as the reference's offline.py:7-103;
# shared auto-resetting collection core, per-step agent selection factored
# out as a callable)
# ---------------------------------------------------------------------------
def _collect_pairs(env, steps: int, select_agent: Callable[[int], Optional[Callable]]):
    """Auto-resetting (state, action) collection loop shared by the dataset
    generators.  ``select_agent(t)`` names the acting agent for step ``t``;
    ``None`` means uniform-random actions from the action space."""
    pairs = []
    obs, _ = env.reset()
    for t in range(steps):
        agent = select_agent(t)
        action = env.action_space.sample() if agent is None else agent.act(env)
        next_obs, _, terminated, truncated, _ = env.step(action)
        pairs.append((obs, action))
        obs = env.reset()[0] if (terminated or truncated) else next_obs
    if not pairs:  # steps == 0: empty arrays with the right trailing shapes
        return (np.empty((0,) + np.shape(obs)),
                np.empty((0, len(env.action_space.low))))
    states, actions = zip(*pairs)
    return np.stack(states), np.stack(actions)


def generate_dataset(env, agent: Optional[Callable], steps: int):
    """Collect (state, action) pairs; ``agent=None`` samples random actions."""
    return _collect_pairs(env, steps, lambda t: agent)


def generate_mixed_dataset(
    env, agents: Sequence[Optional[Callable]], steps: int,
    weights: Optional[Sequence[float]] = None,
):
    """Collect a dataset from a per-step random mixture of agents.

    Selection draws from the GLOBAL numpy RNG (the reference's second RNG
    regime, SURVEY §2.2(7)) — seed ``np.random`` for reproducibility.
    """
    if weights is None:
        select = lambda t: agents[np.random.randint(len(agents))]  # noqa: E731
    else:
        probs = np.asarray(weights, dtype=float)
        if len(probs) != len(agents):
            raise ValueError("Length of weights must match number of agents")
        probs = probs / probs.sum()
        select = lambda t: agents[int(np.random.choice(len(agents), p=probs))]  # noqa: E731
    return _collect_pairs(env, steps, select)


def behavior_cloning(states: np.ndarray, actions: np.ndarray, action_space):
    """Fit a linear-with-bias policy by least squares; outputs are clipped
    to the action box.  (The vectorized on-device variant is
    :func:`gym_anm_torch.offline_vec.behavior_cloning_vec`.)"""
    design = np.pad(states, ((0, 0), (0, 1)), constant_values=1.0)
    coef = np.linalg.lstsq(design, actions, rcond=None)[0]
    W, b = coef[:-1], coef[-1]
    lo, hi = action_space.low, action_space.high

    def policy(state):
        return np.clip(state @ W + b, lo, hi)

    return policy


def evaluate_policy(env, policy, episodes: int = 1, max_steps: int = 10):
    """Mean undiscounted return of ``policy(obs) -> action`` over fresh
    episodes, each capped at ``max_steps`` (truncation is not treated as
    termination, matching the reference)."""
    total = 0.0
    for _ in range(episodes):
        obs, _ = env.reset()
        for _ in range(max_steps):
            obs, reward, terminated, _, _ = env.step(policy(obs))
            total += reward
            if terminated:
                break
    return total / episodes


# ---------------------------------------------------------------------------
# Heuristic expert zoo (offline.py:106-694)
# ---------------------------------------------------------------------------
class BaseHeuristic:
    """Shared device discovery + base action for all heuristics.

    The base action (offline.py:124-157): generators at their potential,
    zero reactive power, idle storage, capacitors off, taps at 1.0.
    """

    def __init__(self, env, v_min: float = 0.99, v_max: float = 1.01):
        self.env = env
        self.v_min = v_min
        self.v_max = v_max
        sim = env.unwrapped.simulator
        devs = sim.devices.items()
        self.cap_ids = [i for i, d in devs if d.type == DEV_TYPE_CAPACITOR]
        self.oltc_ids = [i for i, d in sim.devices.items() if d.type == DEV_TYPE_OLTC]
        self.ren_gen_ids = [
            i for i, d in sim.devices.items() if d.type == DEV_TYPE_RENEWABLE_GEN
        ]
        self.gen_non_slack_ids = [
            i for i, d in sim.devices.items() if d.type in (1, 2)
        ]
        self.des_ids = [i for i, d in sim.devices.items() if d.type == DEV_TYPE_STORAGE]

    # Offsets into the action vector [P_gen, Q_gen, P_des, Q_des, Q_cap, tap].
    @property
    def _cap_base(self):
        return 2 * len(self.gen_non_slack_ids) + 2 * len(self.des_ids)

    @property
    def _oltc_base(self):
        return self._cap_base + len(self.cap_ids)

    def get_base_action(self, env):
        sim = env.unwrapped.simulator
        action = np.zeros(env.action_space.shape[0])
        for idx, dev_id in enumerate(self.gen_non_slack_ids):
            action[idx] = sim.devices[dev_id].p_pot * sim.baseMVA
        for idx in range(len(self.oltc_ids)):
            action[self._oltc_base + idx] = 1.0
        return action

    def _bus_v(self, sim, dev_id):
        return np.abs(sim.buses[sim.devices[dev_id].bus_id].v)


class CapBankHeuristic(BaseHeuristic):
    """Switch each capacitor by the voltage at its own bus."""

    def _cap_q(self, sim, dev_id, bus_v):
        dev = sim.devices[dev_id]
        if bus_v < self.v_min:
            return dev.q_max * sim.baseMVA
        if bus_v > self.v_max:
            return dev.q_min * sim.baseMVA
        return 0.0

    def act(self, env):
        sim = env.unwrapped.simulator
        action = self.get_base_action(env)
        for idx, dev_id in enumerate(self.cap_ids):
            action[self._cap_base + idx] = self._cap_q(sim, dev_id, self._bus_v(sim, dev_id))
        return action


class SimpleCapBankHeuristic(CapBankHeuristic):
    def __init__(self, env):
        super().__init__(env, v_min=0.99, v_max=1.01)


class ConservativeCapBankHeuristic(CapBankHeuristic):
    def __init__(self, env):
        super().__init__(env, v_min=0.98, v_max=1.02)


class AggressiveCapBankHeuristic(CapBankHeuristic):
    def __init__(self, env):
        super().__init__(env, v_min=0.995, v_max=1.005)


class NoisyCapBankHeuristic(CapBankHeuristic):
    """Senses voltages with Gaussian noise."""

    def __init__(self, env, noise_std: float = 0.005):
        super().__init__(env)
        self.noise_std = noise_std

    def act(self, env):
        sim = env.unwrapped.simulator
        action = self.get_base_action(env)
        for idx, dev_id in enumerate(self.cap_ids):
            v = self._bus_v(sim, dev_id) + np.random.normal(0.0, self.noise_std)
            action[self._cap_base + idx] = self._cap_q(sim, dev_id, v)
        return action


class DelayedCapBankHeuristic(CapBankHeuristic):
    """Only recomputes its action every ``delay`` steps."""

    def __init__(self, env, delay: int = 2):
        super().__init__(env)
        self.delay = max(1, delay)
        self._counter = 0
        self._last_action = None

    def act(self, env):
        if self._counter % self.delay == 0:
            self._last_action = super().act(env)
        self._counter += 1
        if self._last_action is None:
            return self.get_base_action(env)
        return self._last_action


class LaggingCapBankHeuristic(CapBankHeuristic):
    """Acts on voltage measurements from ``lag`` steps ago."""

    def __init__(self, env, lag: int = 1):
        super().__init__(env)
        self.lag = max(1, lag)
        self._history = []

    def act(self, env):
        sim = env.unwrapped.simulator
        current = [self._bus_v(sim, i) for i in self.cap_ids]
        self._history.append(current)
        if len(self._history) <= self.lag:
            used = current
        else:
            used = self._history[-self.lag - 1]
            self._history = self._history[-self.lag - 1 :]
        action = self.get_base_action(env)
        for idx, dev_id in enumerate(self.cap_ids):
            action[self._cap_base + idx] = self._cap_q(sim, dev_id, used[idx])
        return action


class HysteresisCapBankHeuristic(CapBankHeuristic):
    """Changes state only when the voltage exits a wider band."""

    def __init__(self, env, v_on: float = 0.985, v_off: float = 1.015):
        super().__init__(env)
        self.v_on = v_on
        self.v_off = v_off
        self._current_q = {}

    def act(self, env):
        sim = env.unwrapped.simulator
        action = self.get_base_action(env)
        for idx, dev_id in enumerate(self.cap_ids):
            dev = sim.devices[dev_id]
            v = self._bus_v(sim, dev_id)
            q = self._current_q.get(dev_id, 0.0)
            if v < self.v_on:
                q = dev.q_max * sim.baseMVA
            elif v > self.v_off:
                q = dev.q_min * sim.baseMVA
            action[self._cap_base + idx] = q
            self._current_q[dev_id] = q
        return action


class OLTCHeuristic(BaseHeuristic):
    """Move the tap by the voltage at the regulated bus."""

    def _tap_for(self, sim, dev_id, v):
        dev = sim.devices[dev_id]
        if v < self.v_min:
            return dev.tap_max
        if v > self.v_max:
            return dev.tap_min
        return dev.tap

    def act(self, env):
        sim = env.unwrapped.simulator
        action = self.get_base_action(env)
        for idx, dev_id in enumerate(self.oltc_ids):
            v = np.abs(sim.buses[sim.devices[dev_id].t_bus].v)
            action[self._oltc_base + idx] = self._tap_for(sim, dev_id, v)
        return action


class SimpleOLTCHeuristic(OLTCHeuristic):
    def __init__(self, env):
        super().__init__(env, v_min=0.99, v_max=1.01)


class ConservativeOLTCHeuristic(OLTCHeuristic):
    def __init__(self, env):
        super().__init__(env, v_min=0.98, v_max=1.02)


class AggressiveOLTCHeuristic(OLTCHeuristic):
    def __init__(self, env):
        super().__init__(env, v_min=0.995, v_max=1.005)


class NoisyOLTCHeuristic(OLTCHeuristic):
    def __init__(self, env, noise_std: float = 0.005):
        super().__init__(env)
        self.noise_std = noise_std

    def act(self, env):
        sim = env.unwrapped.simulator
        action = self.get_base_action(env)
        for idx, dev_id in enumerate(self.oltc_ids):
            v = np.abs(sim.buses[sim.devices[dev_id].t_bus].v)
            v += np.random.normal(0.0, self.noise_std)
            action[self._oltc_base + idx] = self._tap_for(sim, dev_id, v)
        return action


class DelayedOLTCHeuristic(OLTCHeuristic):
    def __init__(self, env, delay: int = 5):
        super().__init__(env)
        self.delay = max(1, delay)
        self._counter = 0
        self._last_taps = {}

    def act(self, env):
        sim = env.unwrapped.simulator
        action = self.get_base_action(env)
        if self._counter % self.delay == 0:
            for dev_id in self.oltc_ids:
                v = np.abs(sim.buses[sim.devices[dev_id].t_bus].v)
                self._last_taps[dev_id] = self._tap_for(sim, dev_id, v)
        for idx, dev_id in enumerate(self.oltc_ids):
            action[self._oltc_base + idx] = self._last_taps.get(dev_id, sim.devices[dev_id].tap)
        self._counter += 1
        return action


class HysteresisOLTCHeuristic(OLTCHeuristic):
    def __init__(self, env, v_low: float = 0.985, v_high: float = 1.015):
        super().__init__(env)
        self.v_low = v_low
        self.v_high = v_high
        self._current_taps = {}

    def act(self, env):
        sim = env.unwrapped.simulator
        action = self.get_base_action(env)
        for idx, dev_id in enumerate(self.oltc_ids):
            dev = sim.devices[dev_id]
            v = np.abs(sim.buses[dev.t_bus].v)
            tap = self._current_taps.get(dev_id, dev.tap)
            if v < self.v_low:
                tap = dev.tap_max
            elif v > self.v_high:
                tap = dev.tap_min
            action[self._oltc_base + idx] = tap
            self._current_taps[dev_id] = tap
        return action


class DeadbandOLTCHeuristic(OLTCHeuristic):
    """Only moves when the voltage exits the thresholds ± deadband."""

    def __init__(self, env, deadband: float = 0.005):
        super().__init__(env)
        self.deadband = deadband

    def act(self, env):
        sim = env.unwrapped.simulator
        action = self.get_base_action(env)
        for idx, dev_id in enumerate(self.oltc_ids):
            dev = sim.devices[dev_id]
            v = np.abs(sim.buses[dev.t_bus].v)
            if v < self.v_min - self.deadband:
                tap = dev.tap_max
            elif v > self.v_max + self.deadband:
                tap = dev.tap_min
            else:
                tap = dev.tap
            action[self._oltc_base + idx] = tap
        return action


class RenewableGenHeuristic(BaseHeuristic):
    """Curtail renewables on local overvoltage."""

    def act(self, env):
        sim = env.unwrapped.simulator
        action = self.get_base_action(env)
        for idx, dev_id in enumerate(self.gen_non_slack_ids):
            if dev_id in self.ren_gen_ids:
                gen = sim.devices[dev_id]
                v = self._bus_v(sim, dev_id)
                p = max(gen.p_min, 0.9 * gen.p_pot) if v > self.v_max else gen.p_pot
                action[idx] = p * sim.baseMVA
        return action


class SimpleRenewableHeuristic(RenewableGenHeuristic):
    def __init__(self, env):
        super().__init__(env, v_min=0.99, v_max=1.01)


class ConservativeRenewableHeuristic(RenewableGenHeuristic):
    def __init__(self, env):
        super().__init__(env, v_min=0.98, v_max=1.02)


class AggressiveRenewableHeuristic(RenewableGenHeuristic):
    def __init__(self, env):
        super().__init__(env, v_min=0.995, v_max=1.005)


class ProportionalRenewableHeuristic(RenewableGenHeuristic):
    """Curtailment proportional to the overvoltage magnitude."""

    def act(self, env):
        sim = env.unwrapped.simulator
        action = self.get_base_action(env)
        for idx, dev_id in enumerate(self.gen_non_slack_ids):
            if dev_id in self.ren_gen_ids:
                gen = sim.devices[dev_id]
                v = self._bus_v(sim, dev_id)
                if v > self.v_max:
                    curtail = min(1.0, (v - self.v_max) / 0.02)
                    p = max(gen.p_min, gen.p_pot * (1 - 0.5 * curtail))
                else:
                    p = gen.p_pot
                action[idx] = p * sim.baseMVA
        return action


class SteppedRenewableHeuristic(RenewableGenHeuristic):
    """Stepped curtailment levels at 1.01/1.015/1.02 p.u."""

    def act(self, env):
        sim = env.unwrapped.simulator
        action = self.get_base_action(env)
        for idx, dev_id in enumerate(self.gen_non_slack_ids):
            if dev_id in self.ren_gen_ids:
                gen = sim.devices[dev_id]
                v = self._bus_v(sim, dev_id)
                if v > 1.02:
                    p = gen.p_pot * 0.5
                elif v > 1.015:
                    p = gen.p_pot * 0.7
                elif v > 1.01:
                    p = gen.p_pot * 0.9
                else:
                    p = gen.p_pot
                action[idx] = max(gen.p_min, p) * sim.baseMVA
        return action


class NoisyRenewableHeuristic(RenewableGenHeuristic):
    def __init__(self, env, noise_std: float = 0.005):
        super().__init__(env)
        self.noise_std = noise_std

    def act(self, env):
        sim = env.unwrapped.simulator
        action = self.get_base_action(env)
        for idx, dev_id in enumerate(self.gen_non_slack_ids):
            if dev_id in self.ren_gen_ids:
                gen = sim.devices[dev_id]
                v = self._bus_v(sim, dev_id) + np.random.normal(0.0, self.noise_std)
                p = max(gen.p_min, 0.9 * gen.p_pot) if v > self.v_max else gen.p_pot
                action[idx] = p * sim.baseMVA
        return action


class DelayedRenewableHeuristic(RenewableGenHeuristic):
    def __init__(self, env, delay: int = 3):
        super().__init__(env)
        self.delay = max(1, delay)
        self._counter = 0
        self._last_power = {}

    def act(self, env):
        sim = env.unwrapped.simulator
        action = self.get_base_action(env)
        if self._counter % self.delay == 0:
            for dev_id in self.gen_non_slack_ids:
                if dev_id in self.ren_gen_ids:
                    gen = sim.devices[dev_id]
                    v = self._bus_v(sim, dev_id)
                    p = max(gen.p_min, 0.9 * gen.p_pot) if v > self.v_max else gen.p_pot
                    self._last_power[dev_id] = p * sim.baseMVA
        for idx, dev_id in enumerate(self.gen_non_slack_ids):
            if dev_id in self.ren_gen_ids and dev_id in self._last_power:
                action[idx] = self._last_power[dev_id]
        self._counter += 1
        return action


class CombinedHeuristic(BaseHeuristic):
    """Renewable curtailment + capacitor switching + OLTC control."""

    def __init__(self, env):
        super().__init__(env)
        self.cap_heuristic = CapBankHeuristic(env)
        self.oltc_heuristic = OLTCHeuristic(env)
        self.ren_heuristic = RenewableGenHeuristic(env)

    def act(self, env):
        action = self.get_base_action(env)
        cap_action = self.cap_heuristic.act(env)
        oltc_action = self.oltc_heuristic.act(env)
        ren_action = self.ren_heuristic.act(env)

        n_gen = len(self.gen_non_slack_ids)
        n_cap = len(self.cap_ids)
        action[:n_gen] = ren_action[:n_gen]
        action[self._cap_base : self._cap_base + n_cap] = cap_action[
            self._cap_base : self._cap_base + n_cap
        ]
        action[self._oltc_base :] = oltc_action[self._oltc_base :]
        return action


class RandomHeuristic(BaseHeuristic):
    def act(self, env):
        return env.action_space.sample()


class DoNothingHeuristic(BaseHeuristic):
    def act(self, env):
        return self.get_base_action(env)


class OptimizationBasedExpert(BaseHeuristic):
    """Sensitivity-linearized OPF expert.

    Same formulation as the reference (offline.py:698-820): minimize total
    renewable generation subject to box constraints and linearized voltage
    constraints built from fixed sensitivities; solved with scipy's LP
    solver instead of cvxpy/ECOS, falling back to :class:`CombinedHeuristic`
    on failure.
    """

    V_SENS_P = 0.1
    V_SENS_Q = 0.2

    def __init__(self, env, horizon: int = 1):
        super().__init__(env)
        self.horizon = horizon

    def act(self, env):
        from scipy.optimize import linprog

        sim = env.unwrapped.simulator
        n_gen = len(self.gen_non_slack_ids)
        n_cap = len(self.cap_ids)
        n_oltc = len(self.oltc_ids)
        n = n_gen + n_cap + n_oltc

        # Objective: minimize sum of generator P (caps/taps free).
        c = np.concatenate([np.ones(n_gen), np.zeros(n_cap + n_oltc)])

        lb, ub = np.zeros(n), np.zeros(n)
        for i, dev_id in enumerate(self.gen_non_slack_ids):
            g = sim.devices[dev_id]
            lb[i] = g.p_min * sim.baseMVA
            ub[i] = g.p_pot * sim.baseMVA
        for i, dev_id in enumerate(self.cap_ids):
            cp_ = sim.devices[dev_id]
            lb[n_gen + i] = cp_.q_min * sim.baseMVA
            ub[n_gen + i] = cp_.q_max * sim.baseMVA
        for i, dev_id in enumerate(self.oltc_ids):
            o = sim.devices[dev_id]
            lb[n_gen + n_cap + i] = o.tap_min
            ub[n_gen + n_cap + i] = o.tap_max

        # Linearized voltage constraints 0.95 <= v + dv <= 1.05 per bus.
        A_ub, b_ub = [], []
        for bus_id, bus in sim.buses.items():
            if bus.is_slack:
                continue
            v = np.abs(bus.v)
            row = np.zeros(n)
            for j, gen_id in enumerate(self.gen_non_slack_ids):
                if sim.devices[gen_id].bus_id == bus_id:
                    row[j] = self.V_SENS_P
            for j, cap_id in enumerate(self.cap_ids):
                if sim.devices[cap_id].bus_id == bus_id:
                    row[n_gen + j] = self.V_SENS_Q
            if not row.any():
                continue
            offset = self.V_SENS_P * sum(
                sim.devices[g].p * sim.baseMVA
                for g in self.gen_non_slack_ids
                if sim.devices[g].bus_id == bus_id
            )
            # v + row@x - offset >= 0.95  and  <= 1.05
            A_ub.append(-row)
            b_ub.append(v - offset - 0.95)
            A_ub.append(row)
            b_ub.append(1.05 - v + offset)

        try:
            res = linprog(
                c,
                A_ub=np.array(A_ub) if A_ub else None,
                b_ub=np.array(b_ub) if b_ub else None,
                bounds=list(zip(lb, ub)),
                method="highs",
            )
            if not res.success:
                return CombinedHeuristic(env).act(env)
            x = res.x
            action = self.get_base_action(env)
            action[:n_gen] = x[:n_gen]
            action[self._cap_base : self._cap_base + n_cap] = x[n_gen : n_gen + n_cap]
            action[self._oltc_base : self._oltc_base + n_oltc] = x[n_gen + n_cap :]
            return action
        except Exception:
            return CombinedHeuristic(env).act(env)


class SensitivityBasedExpert(BaseHeuristic):
    """Coordinated control via fixed voltage sensitivities
    (offline.py:823-913)."""

    def __init__(self, env):
        super().__init__(env)
        self.dv_dp = 0.001
        self.dv_dq = 0.002
        self.dv_dtap = 0.05

    @staticmethod
    def _is_nearby(bus1, bus2, distance=2):
        return abs(bus1 - bus2) <= distance

    def act(self, env):
        sim = env.unwrapped.simulator
        action = self.get_base_action(env)

        errors = []
        for bus_id, bus in sim.buses.items():
            v = np.abs(bus.v)
            if v < self.v_min:
                errors.append((bus_id, v - self.v_min, "low"))
            elif v > self.v_max:
                errors.append((bus_id, v - self.v_max, "high"))
        errors.sort(key=lambda x: abs(x[1]), reverse=True)

        n_cap = len(self.cap_ids)
        for bus_id, error, direction in errors:
            if direction == "high":
                for idx, dev_id in enumerate(self.gen_non_slack_ids):
                    if dev_id in self.ren_gen_ids:
                        gen = sim.devices[dev_id]
                        if gen.bus_id == bus_id or self._is_nearby(gen.bus_id, bus_id):
                            curtail = min(0.5, abs(error) * 10)
                            p = gen.p_pot * (1 - curtail)
                            action[idx] = max(gen.p_min, p) * sim.baseMVA
            else:
                for idx, dev_id in enumerate(self.cap_ids):
                    cap = sim.devices[dev_id]
                    if cap.bus_id == bus_id or self._is_nearby(cap.bus_id, bus_id):
                        action[self._cap_base + idx] = cap.q_max * sim.baseMVA

            for idx, dev_id in enumerate(self.oltc_ids):
                oltc = sim.devices[dev_id]
                if oltc.t_bus == bus_id or self._is_nearby(oltc.t_bus, bus_id):
                    if direction == "low":
                        new_tap = min(oltc.tap_max, oltc.tap + 0.01)
                    else:
                        new_tap = max(oltc.tap_min, oltc.tap - 0.01)
                    action[self._oltc_base + idx] = new_tap
        return action


class MPCBasedExpert(BaseHeuristic):
    """Trend-based preemptive control (offline.py:916-976)."""

    def __init__(self, env, horizon: int = 5):
        super().__init__(env)
        self.horizon = horizon
        self.past_actions = []
        self.last_min_v = None
        self.last_max_v = None

    def act(self, env):
        sim = env.unwrapped.simulator
        voltages = [np.abs(bus.v) for bus in sim.buses.values()]
        min_v, max_v = min(voltages), max(voltages)
        action = self.get_base_action(env)

        if self.past_actions:
            if max_v > 1.005 and max_v > self.last_max_v:
                for idx, dev_id in enumerate(self.gen_non_slack_ids):
                    if dev_id in self.ren_gen_ids:
                        gen = sim.devices[dev_id]
                        action[idx] = gen.p_pot * 0.8 * sim.baseMVA
            elif min_v < 0.995 and min_v < self.last_min_v:
                for idx, dev_id in enumerate(self.cap_ids):
                    cap = sim.devices[dev_id]
                    action[self._cap_base + idx] = cap.q_max * sim.baseMVA

        self.last_min_v = min_v
        self.last_max_v = max_v
        self.past_actions.append(action.copy())
        if len(self.past_actions) > self.horizon:
            self.past_actions.pop(0)
        return action


# Backward-compat aliases (offline.py:979-989).
CapBankExpert = CapBankHeuristic
SimpleCapBankExpert = SimpleCapBankHeuristic
ConservativeCapBankExpert = ConservativeCapBankHeuristic
AggressiveCapBankExpert = AggressiveCapBankHeuristic
NoisyCapBankExpert = NoisyCapBankHeuristic
DelayedCapBankExpert = DelayedCapBankHeuristic
LaggingCapBankExpert = LaggingCapBankHeuristic
HysteresisCapBankExpert = HysteresisCapBankHeuristic
OLTCExpert = OLTCHeuristic
RenewableGenExpert = RenewableGenHeuristic
