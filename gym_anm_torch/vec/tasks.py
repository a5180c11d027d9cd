"""Vectorized task definitions (batched init_state / next_vars hooks).

Port of ``gym_anm_tpu/vec/tasks.py``.  Each factory returns a
:class:`~gym_anm_torch.vec.core.VecTask`.  Randomness comes from the
``torch.Generator`` the hooks are given (drawn on its device, or on the
state's device when it is None); the JAX package draws from ``jax.random``,
so parity tests hand both packages the same numbers.
"""

import dataclasses
import math

import numpy as np
import torch

from ..networks import (
    anm6_network,
    create_multi_capacitor_network,
    create_renewable_network,
    create_unequal_capacitor_network,
    ieee33_network,
    two_bus_network,
)
from ..networks.anm6 import anm6easy_gen_time_series, anm6easy_load_time_series
from ..physics.power_flow import numpy_nr_solve
from ..specs.network import load_network
from .core import VecTask

__all__ = [
    "make_two_bus_task",
    "make_ieee33_task",
    "make_ieee33_renewable_task",
    "make_ieee33_multicap_task",
    "make_ieee33_unequal_task",
    "make_anm6easy_task",
]


def _draw_device(generator, device):
    return device if generator is None else generator.device


def make_two_bus_task():
    """The 2-bus example env (examples/simple_env.py): random s0 in [0,1],
    random load in [-10, 0], one useless aux variable in [0, 10)."""
    spec = load_network(two_bus_network)
    K = 1
    n_s0 = spec.n_state + K

    def init_state_fn(generator, n, carry):
        return torch.rand(n, n_s0, generator=generator, device=_draw_device(generator, "cpu"))

    def next_vars_fn(generator, s_t, carry, t):
        B, dev = s_t.shape[0], _draw_device(generator, s_t.device)
        p_load = -10.0 * torch.rand(B, generator=generator, device=dev, dtype=s_t.dtype)
        aux = torch.randint(0, 10, (B,), generator=generator, device=dev).to(s_t.dtype)
        return torch.stack([p_load, aux], dim=1).to(s_t.device), carry

    return VecTask(
        network=two_bus_network, K=K, delta_t=0.25, gamma=0.9, lamb=100,
        costs_clipping=(1, 100), init_state_fn=init_state_fn,
        next_vars_fn=next_vars_fn, name="two_bus",
    )


def _ieee33_quirk_s0(spec, K):
    """The base IEEE33 init state: per-unit p_min written into MW slots
    (the reference quirk, ieee33.py:25-37)."""
    n_dev = spec.n_dev
    s0 = np.zeros(spec.n_state + K)
    for k in range(n_dev):
        if spec.dev_type[k] == 0:
            continue
        p = spec.p_min[k]
        qp = spec.qp_ratio[k]
        q = p * qp if not np.isnan(qp) else 0.0
        s0[int(spec.dev_ids[k])] = p
        s0[n_dev + int(spec.dev_ids[k])] = q
    return s0


def make_ieee33_task():
    """Base IEEE33 voltage control: static grid, 3-dim action
    [Q_cap8, Q_cap25, tap].  Deterministic: s0 is the constant quirk table
    and the exogenous variables are zeros."""
    spec = load_network(ieee33_network)
    K = 0
    s0 = _ieee33_quirk_s0(spec, K)
    n_vars = spec.n_load + spec.n_gen + K

    def init_state_fn(generator, n, carry):
        return np.broadcast_to(s0, (n, s0.size))

    def next_vars_fn(generator, s_t, carry, t):
        return torch.zeros(s_t.shape[0], n_vars, dtype=s_t.dtype, device=s_t.device), carry

    return VecTask(
        network=ieee33_network, K=K, delta_t=1.0, gamma=0.99, lamb=100,
        costs_clipping=None, init_state_fn=init_state_fn,
        next_vars_fn=next_vars_fn, name="ieee33",
    )


def _tiered_rates(n_branch):
    """The per-reset branch-rate fix of the renewable envs
    (ieee33_renewable_complete.py:245-262): a static table."""
    idx = np.arange(n_branch)
    return np.select([idx < 5, idx < 15, idx < 25], [1.2, 0.5, 0.3], default=0.2).astype(np.float64)


def _nominal_x_star(spec, load_factor):
    """Chord linearization point for near-nominal-load tasks: the solved
    float64 operating state at ``load_factor`` × nominal loads (renewable
    potentials at the family's value of zero, caps off, nominal taps),
    computed on the host with :func:`numpy_nr_solve`; the flat start if the
    nominal case diverges."""
    N = spec.n_bus
    series = 1.0 / (spec.br_r + 1j * spec.br_x)
    tap = spec.br_tap0 * np.exp(1j * spec.br_shift)
    sh = 1j * spec.br_b / 2.0
    Y = np.zeros((N, N), complex)
    for k in range(spec.n_branch):
        fb, tb = int(spec.br_f[k]), int(spec.br_t[k])
        Y[fb, tb] += -series[k] / np.conj(tap[k])
        Y[tb, fb] += -series[k] / tap[k]
        Y[fb, fb] += (series[k] + sh[k]) / np.abs(tap[k]) ** 2
        Y[tb, tb] += series[k] + sh[k]

    p_bus = np.zeros(N)
    q_bus = np.zeros(N)
    for d in spec.load_pos:
        bus = int(spec.dev_bus[d])
        p = spec.p_min[d] * load_factor          # p.u., negative
        p_bus[bus] += p
        q_bus[bus] += p * spec.qp_ratio[d]
    return numpy_nr_solve(Y, p_bus[1:], q_bus[1:])


class DiurnalLoads:
    """``next_vars_fn`` of the renewable family: the clock advances by
    Δt/3600 h, the loads follow 0.8 + 0.3·sin((hour − 3)·π/12) of nominal
    with 2% Gaussian noise, and the renewable potentials stay at zero (the
    reference quirk the controller hierarchy was tuned against).

    The hour carry is float32, as in the JAX package, whatever the env dtype.
    :meth:`from_noise` is the formula as a plain function of (hour, standard
    normal draw), so a test can feed it the JAX package's draw.
    """

    def __init__(self, nominal_mw, n_vars, load_scale, delta_t):
        self.nominal_mw = np.asarray(nominal_mw, np.float64)
        self.n_vars = int(n_vars)
        self.load_scale = float(load_scale)
        self.delta_t = float(delta_t)
        self._nominal = {}  # (dtype, device) -> tensor: no host copy per step

    def __call__(self, generator, s_t, hour, t):
        z = torch.randn(s_t.shape[0], len(self.nominal_mw), generator=generator, dtype=s_t.dtype,
                        device=_draw_device(generator, s_t.device))
        return self.from_noise(hour, z.to(s_t.device))

    def from_noise(self, hour, z):
        """(vars [B, n_vars], new hour) from the hour carry [B] and a
        standard normal draw z [B, n_load] of the env dtype."""
        key = (z.dtype, z.device)
        if key not in self._nominal:
            self._nominal[key] = torch.as_tensor(self.nominal_mw, dtype=z.dtype, device=z.device)
        hour = (hour + self.delta_t / 3600.0) % 24.0
        # (hour − 3)·π/12 with π/12 as one constant: what XLA compiles the
        # JAX package's expression to.
        time_factor = (0.8 + 0.3 * torch.sin((hour - 3.0) * (math.pi / 12.0))).to(z.dtype)
        noise = 1.0 + 0.02 * z
        loads = -self._nominal[key] * (self.load_scale * time_factor.unsqueeze(1) * noise)
        tail = torch.zeros(z.shape[0], self.n_vars - z.shape[1], dtype=z.dtype, device=z.device)
        return torch.cat([loads, tail], dim=1), hour


def _make_renewable_family_task(network, name, load_scale=1.0, scenario="default"):
    # ``scenario`` is accepted and changes nothing, as in the JAX package,
    # whose renewable potentials stay at zero whatever the scenario.
    spec = load_network(network)
    K = 0
    n_s0 = spec.n_state + K
    delta_t = 1.0
    # The diurnal load factor averages 0.8: linearize the chord solver there.
    x_star = _nominal_x_star(spec, 0.8 * load_scale)

    def init_task_fn(generator, n):
        # task carry = hour of day, float32
        return torch.rand(n, generator=generator, dtype=torch.float32,
                          device=_draw_device(generator, "cpu")) * 24.0

    def init_state_fn(generator, n, carry):
        return torch.randn(n, n_s0, generator=generator, dtype=torch.float32,
                           device=_draw_device(generator, "cpu")) * 0.001

    return VecTask(
        network=network, K=K, delta_t=delta_t, gamma=0.99, lamb=100,
        costs_clipping=None, init_state_fn=init_state_fn,
        next_vars_fn=DiurnalLoads(np.abs(spec.p_min[spec.load_pos]) * spec.baseMVA,
                                  spec.n_load + spec.n_gen + K, load_scale, delta_t),
        init_task_fn=init_task_fn, rates=_tiered_rates(spec.n_branch), chord_x_star=x_star, name=name,
    )


def make_ieee33_renewable_task(load_scale=1.0, scenario="default"):
    """IEEE33 + 5 renewables, 13-dim actions, diurnal loads."""
    return _make_renewable_family_task(create_renewable_network(), "ieee33_renewable", load_scale, scenario)


def make_ieee33_multicap_task(load_scale=1.0, scenario="default"):
    """IEEE33 + renewables + 6 capacitors, 17-dim actions."""
    return _make_renewable_family_task(create_multi_capacitor_network(), "ieee33_multicap", load_scale, scenario)


def make_ieee33_unequal_task(load_scale=1.0, scenario="default", switching_cost_multiplier=1.0):
    """IEEE33 + renewables + 6 unequal capacitors, 17-dim actions, with the
    per-step capacitor switching-cost accounting of the compat env
    (ieee33_unequal_capacitors.py:144-169) as a reward-shaping hook.

    The reference's pairing quirk is kept: the per-capacitor base costs are
    sorted by rating largest-first while the switch detections are in action
    order, and the two are multiplied index-wise.  The previous-set-point
    tracker persists across resets."""
    task = _make_renewable_family_task(create_unequal_capacitor_network(), "ieee33_unequal", load_scale, scenario)
    spec = load_network(task.network)
    ratings = np.sort(spec.q_max[spec.cap_pos] * spec.baseMVA)[::-1]
    base_costs = 0.01 * ratings * switching_cost_multiplier
    n_cap = spec.n_cap
    cap_lo = 2 * spec.n_gen + 2 * spec.n_des  # caps in [P_gen, Q_gen, P_des, Q_des, Q_cap, tap]

    def init_shape_fn(n, dtype, device):
        return (
            torch.zeros(n, n_cap, dtype=dtype, device=device),   # previous cap set-points (MVAr)
            torch.zeros(n, dtype=torch.int32, device=device),    # total switches
            torch.zeros(n, dtype=dtype, device=device),          # cumulative switching cost
        )

    def shape_reward_fn(carry, action, reward):
        prev, n_switches, cum_cost = carry
        cap_a = action[:, cap_lo: cap_lo + n_cap].to(prev.dtype)
        switches = torch.abs(cap_a - prev) > 0.01
        costs = torch.as_tensor(base_costs, dtype=reward.dtype).to(reward.device)
        step_cost = torch.sum(torch.where(switches, costs, torch.zeros_like(costs)), dim=1)
        n_switches = n_switches + switches.sum(dim=1).to(torch.int32)
        cum_cost = cum_cost + step_cost.to(cum_cost.dtype)
        extras = {
            "switching_cost": step_cost,
            "total_switches": n_switches,
            "cumulative_switching_cost": cum_cost,
        }
        return (cap_a, n_switches, cum_cost), reward - step_cost, extras

    return dataclasses.replace(task, shape_reward_fn=shape_reward_fn, init_shape_fn=init_shape_fn)


class ANM6EasyHooks:
    """``init_state_fn`` and ``next_vars_fn`` of ANM6Easy.

    Reset: a random time index t0 in [0, 96), the loads and generation
    maxima of the daily tables at t0 (load Q at 0.2·P), random generator Q
    and storage SoC within their bounds, aux = t0; built in float32, as in
    the JAX package.  Step: the time index advances by one (mod 96) from the
    state vector's last entry, and the exogenous variables are the tables at
    that index.  :meth:`s0_from_draws` is the reset as a plain function of
    the draws, so a test can feed it the JAX package's.
    """

    N_STEPS_DAY = 96

    def __init__(self, spec):
        self.spec = spec
        self.P_loads = anm6easy_load_time_series()  # [3, 96] MW
        self.P_maxs = anm6easy_gen_time_series()    # [2, 96] MW
        base = spec.baseMVA
        gp, dp = spec.gen_nonslack_pos, spec.des_pos
        self._bounds = [spec.q_min[gp] * base, spec.q_max[gp] * base, spec.soc_min[dp] * base,
                        spec.soc_max[dp] * base]
        self._cache = {}  # (dtype, device) -> tables: no host copy per step

    def _tables(self, dtype, device):
        key = (dtype, device)
        if key not in self._cache:
            t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device).to(dtype)  # noqa: E731
            self._cache[key] = [t(self.P_loads), t(self.P_maxs)] + [t(b) for b in self._bounds]
        return self._cache[key]

    def init_state_fn(self, generator, n, carry):
        spec = self.spec
        dev = _draw_device(generator, "cpu")
        t0 = torch.randint(0, self.N_STEPS_DAY, (n,), generator=generator, device=dev)
        u_q = torch.rand(n, spec.n_gen, generator=generator, dtype=torch.float32, device=dev)
        u_soc = torch.rand(n, spec.n_des, generator=generator, dtype=torch.float32, device=dev)
        return self.s0_from_draws(t0, u_q, u_soc)

    def s0_from_draws(self, t0, u_q, u_soc):
        """s0 [n, n_state + 1] (float32) from the time index t0 [n] and
        uniform draws u_q [n, n_gen], u_soc [n, n_des]."""
        spec = self.spec
        n_dev, n_des, n_gen = spec.n_dev, spec.n_des, spec.n_gen
        P_loads, P_maxs, q_min, q_max, soc_min, soc_max = self._tables(torch.float32, t0.device)
        s = torch.zeros(t0.shape[0], 2 * n_dev + n_des + n_gen + 1, dtype=torch.float32, device=t0.device)
        # loads at devices 1, 3, 5; generators at 2, 4; storage at 6 (ANM6 layout)
        loads = P_loads[:, t0].T
        gens = P_maxs[:, t0].T
        s[:, 1:6:2] = loads
        s[:, 1 + n_dev: 6 + n_dev: 2] = loads * 0.2
        s[:, 2:5:2] = gens
        s[:, 2 + n_dev: 5 + n_dev: 2] = q_min + u_q * (q_max - q_min)
        s[:, 2 * n_dev: 2 * n_dev + n_des] = soc_min + u_soc * (soc_max - soc_min)
        s[:, 2 * n_dev + n_des: 2 * n_dev + n_des + n_gen] = gens
        s[:, -1] = t0.to(torch.float32)
        return s

    def next_vars_fn(self, generator, s_t, carry, t):
        P_loads, P_maxs = self._tables(s_t.dtype, s_t.device)[:2]
        aux = torch.remainder(s_t[:, -1] + 1, self.N_STEPS_DAY).to(torch.int32)
        idx = aux.long()
        return torch.cat([P_loads[:, idx].T, P_maxs[:, idx].T, aux.unsqueeze(1).to(s_t.dtype)], dim=1), carry


def make_anm6easy_task():
    """The ANM6Easy task: fixed 96-step daily profiles, K=1 time-of-day aux,
    Δt = 15 min (anm6_easy.py:11-65).  Lanes collapse under aggressive
    actions, so its resets (and their retries) are frequent."""
    hooks = ANM6EasyHooks(load_network(anm6_network))
    return VecTask(
        network=anm6_network, K=1, delta_t=0.25, gamma=0.995, lamb=100,
        costs_clipping=(1, 100), init_state_fn=hooks.init_state_fn,
        next_vars_fn=hooks.next_vars_fn, name="anm6easy",
    )
