"""Batched L0-L5 controllers.

Port of ``gym_anm_tpu/vec/controllers.py``.  Each controller is an
``(init_carry, act)`` pair over a batch of lanes:

    init_carry(n) -> carry of n lanes (lane on the first axis of every tensor)
    act(noise, state, obs, carry) -> (action [B, n_action], carry')

``noise`` is a uniform [0, 1) draw [B, n_action] of the env dtype; only L0
reads it, so a collector draws it once per step for the whole batch and every
controller sees its own lanes' slice.  Decision rules, thresholds, lockout
timers and carries are those of the JAX package: ``torch.where`` and
reductions along the bus axis, no host round trip (no ``.item()``, no
``nonzero``, no Python branch on a tensor value).  Every constant is built at
the env dtype and device when the controller is made, so a float64 env
computes in float64 throughout.

The controllers target the 13-dim renewable IEEE33 action layout
[5 renewable P, 5 renewable Q, 2 cap Q, 1 tap]; on the 17-dim variants the
extra capacitors stay at 0.  The renewable set-points are ``p_pot·fraction``
(p.u.) written into the MW slots, as the host classes and the JAX package do.
"""

from typing import Callable, NamedTuple

import numpy as np
import torch

TAP_POSITIONS = np.array([0.9, 0.95, 1.0, 1.05, 1.1])

__all__ = ["TAP_POSITIONS", "Controller", "l5_grid", "make_l0", "make_l1", "make_l2", "make_l3", "make_l4",
           "make_l5", "make_suite"]


class Controller(NamedTuple):
    name: str
    init_carry: Callable
    act: Callable


def _consts(env, *values):
    """0-dim tensors of ``values`` at the env dtype on the env device."""
    return [torch.tensor(v, dtype=env.dtype, device=env.device) for v in values]


def _ints(env, *values):
    return [torch.tensor(v, dtype=torch.int32, device=env.device) for v in values]


def _lane_mean(x):
    """Mean over the last axis, summed in the order of the JAX package's
    compiled CPU reduction: for n > 32 entries, windows of 32 with the first
    one padded in front (33 buses: entries 0-16 and 17-32), each window summed
    left to right, the window sums added, and the total multiplied by 1/n.
    A float64 carry of the mean then equals JAX's bit for bit.  The windows
    are summed side by side, one add per position (16 adds for 33 buses)."""
    n = x.shape[-1]
    k = -(-n // 32)
    left = (k * 32 - n) // 2
    bounds = [0] + [32 * j - left for j in range(1, k)] + [n]
    width = max(b - a for a, b in zip(bounds[:-1], bounds[1:]))
    # Zeros after a window's last entry leave its left-to-right sum unchanged.
    wins = torch.stack([torch.nn.functional.pad(x[..., a:b], (0, width - (b - a)))
                        for a, b in zip(bounds[:-1], bounds[1:])], dim=-2)  # [..., k, width]
    s = wins[..., 0]
    for j in range(1, width):
        s = s + wins[..., j]
    total = s[..., 0]
    for j in range(1, k):
        total = total + s[..., j]
    return total * (1.0 / n)


def _blank(env, state):
    return torch.zeros(state.p_pot.shape[0], env.n_action, dtype=env.dtype, device=env.device)


def _gen_q_slice(env):
    n_gen = env.spec.n_gen
    return slice(n_gen, 2 * n_gen)


def _taps(env):
    return torch.tensor(TAP_POSITIONS, dtype=env.dtype, device=env.device)


def _gen_bus(env):
    return torch.tensor(env.spec.dev_bus[env.spec.gen_nonslack_pos], dtype=torch.int64, device=env.device)


def _q_limits(env):
    return torch.tensor(np.resize(np.array([0.02, 0.02, 0.02, 0.04, 0.04]), env.spec.n_gen), dtype=env.dtype,
                        device=env.device)


def make_l0(env):
    """L0: uniform random actions, ``low + u·(high − low)`` from the noise."""
    lo, hi = env.action_low, env.action_high

    def init_carry(n):
        return ()

    def act(noise, state, obs, carry):
        return lo + noise * (hi - lo), carry

    return Controller("L0_random", init_carry, act)


def make_l1(env):
    """L1: 20% renewables, caps off, nominal tap."""
    tap_sl = env._action_slices["tap"]
    n_gen = env.spec.n_gen

    def init_carry(n):
        return ()

    def act(noise, state, obs, carry):
        a = _blank(env, state)
        a[:, :n_gen] = state.p_pot * 0.2
        a[:, tap_sl] = 1.0
        return a, carry

    return Controller("L1_basic", init_carry, act)


def make_l2(env):
    """L2: voltage-threshold switching with per-capacitor hysteresis."""
    cap_sl = env._action_slices["Q_cap"]
    tap_sl = env._action_slices["tap"]
    n_gen = env.spec.n_gen
    taps = _taps(env)
    c015, c025, c022, c001, cm001, c0, cap1, cap2 = _consts(env, 0.15, 0.25, 0.22, 0.01, -0.01, 0.0, 0.2, 0.2 * 0.5)
    i0, i1, i2, i3, i4 = _ints(env, 0, 1, 2, 3, 4)

    def init_carry(n):
        return torch.zeros(n, 2, dtype=torch.bool, device=env.device)  # [cap1_on, cap2_on]

    def act(noise, state, obs, carry):
        v_min = torch.amin(state.bus_vm, dim=1)
        v_max = torch.amax(state.bus_vm, dim=1)

        frac = torch.where(v_max > 1.04, c015, torch.where(v_min < 0.96, c025, c022))
        a = _blank(env, state)
        a[:, :n_gen] = state.p_pot * frac.unsqueeze(1)
        q_support = torch.where(v_min < 0.97, c001, torch.where(v_max > 1.03, cm001, c0))
        a[:, _gen_q_slice(env)] = q_support.unsqueeze(1)

        on1, on2 = carry[:, 0], carry[:, 1]
        new_on1 = torch.where(on1, ~((v_min > 0.98) | (v_max > 1.04)), (v_min < 0.96) & (v_max < 1.02))
        new_on2 = torch.where(on2, ~((v_min > 0.975) | (v_max > 1.03)), (v_min < 0.955) & (v_max < 1.01))
        a[:, cap_sl.start] = torch.where(new_on1, cap1, c0)
        a[:, cap_sl.start + 1] = torch.where(new_on2, cap2, c0)

        caps_active = new_on1 | new_on2
        tap_idx_active = torch.where(v_min < 0.94, i1, torch.where(v_max > 1.06, i3, i2))
        tap_idx_idle = torch.where(
            v_min < 0.93, i0,
            torch.where(v_min < 0.96, i1, torch.where(v_max > 1.07, i4, torch.where(v_max > 1.04, i3, i2))))
        tap_idx = torch.where(caps_active, tap_idx_active, tap_idx_idle)
        a[:, tap_sl] = taps[tap_idx].unsqueeze(1)
        return a, torch.stack([new_on1, new_on2], dim=1)

    return Controller("L2_threshold", init_carry, act)


class _L3Carry(NamedTuple):
    cap_state: torch.Tensor     # [B, 2] bool
    last_tap_idx: torch.Tensor  # [B] int32
    timer: torch.Tensor         # [B] int32


def make_l3(env):
    """L3: coordinated control with 5/10-step lockout timers."""
    cap_sl = env._action_slices["Q_cap"]
    tap_sl = env._action_slices["tap"]
    n_gen = env.spec.n_gen
    gen_bus = _gen_bus(env)
    taps = _taps(env)
    q_half = _q_limits(env) * 0.5
    c015, c020, c024, c07, c12, c10, c0, cap1, cap2 = _consts(env, 0.15, 0.20, 0.24, 0.7, 1.2, 1.0, 0.0, 0.15,
                                                              0.15 * 0.5)
    i0, i1, i2, i3, i4, i5, i10 = _ints(env, 0, 1, 2, 3, 4, 5, 10)
    both = torch.tensor([True, True], device=env.device)
    one = torch.tensor([True, False], device=env.device)
    none = torch.tensor([False, False], device=env.device)

    def init_carry(n):
        return _L3Carry(torch.zeros(n, 2, dtype=torch.bool, device=env.device),
                        torch.full((n,), 2, dtype=torch.int32, device=env.device),
                        torch.zeros(n, dtype=torch.int32, device=env.device))

    def act(noise, state, obs, carry):
        vm = state.bus_vm
        v_min, v_max, v_mean = torch.amin(vm, dim=1), torch.amax(vm, dim=1), _lane_mean(vm)

        margin = torch.minimum(v_min - 0.95, 1.05 - v_max)
        base = torch.where(margin < 0.01, c015, torch.where(margin < 0.02, c020, c024))
        v_local = vm[:, gen_bus]
        local = torch.where(v_local > 1.035, c07, torch.where(v_local < 0.965, c12, c10))
        a = _blank(env, state)
        a[:, :n_gen] = torch.minimum(state.p_pot * base.unsqueeze(1) * local, state.p_pot)
        a[:, _gen_q_slice(env)] = torch.where(v_local < 0.97, q_half, torch.where(v_local > 1.03, -q_half, c0))

        timer = torch.clamp(carry.timer - 1, min=0)
        free = timer == 0
        want_both = ((v_min < 0.95) & (v_max < 1.01)).unsqueeze(1)
        want_one = ((v_min < 0.96) & (v_max < 1.02)).unsqueeze(1)
        want_off = ((v_max > 1.04) | ((v_max > 1.03) & (v_mean > 1.01))).unsqueeze(1)
        desired = torch.where(want_both, both, torch.where(want_one, one, torch.where(want_off, none,
                                                                                     carry.cap_state)))
        switch = free & torch.any(desired != carry.cap_state, dim=1)
        cap_state = torch.where(switch.unsqueeze(1), desired, carry.cap_state)
        timer = torch.where(switch, i5, timer)
        a[:, cap_sl.start] = torch.where(cap_state[:, 0], cap1, c0)
        a[:, cap_sl.start + 1] = torch.where(cap_state[:, 1], cap2, c0)

        no_cap = ~torch.any(cap_state, dim=1)
        desired_tap = torch.where(
            v_min < 0.94, i0,
            torch.where((v_min < 0.95) & no_cap, i1,
                        torch.where(v_max > 1.06, i4, torch.where((v_max > 1.05) & no_cap, i3, i2))))
        move = (timer == 0) & (desired_tap != carry.last_tap_idx)
        last_tap = torch.where(move, desired_tap, carry.last_tap_idx)
        timer = torch.where(move, i10, timer)
        a[:, tap_sl] = taps[last_tap].unsqueeze(1)
        return a, _L3Carry(cap_state, last_tap, timer)

    return Controller("L3_coordinated", init_carry, act)


class _L4Carry(NamedTuple):
    prev_mean: torch.Tensor     # [B] env dtype
    have_prev: torch.Tensor     # [B] bool
    last_caps: torch.Tensor     # [B, 2] env dtype
    last_tap_idx: torch.Tensor  # [B] int32
    cap_timers: torch.Tensor    # [B, 2] int32
    tap_timer: torch.Tensor     # [B] int32


def make_l4(env):
    """L4: trend-predictive control with switching-rate limits."""
    cap_sl = env._action_slices["Q_cap"]
    tap_sl = env._action_slices["tap"]
    n_gen = env.spec.n_gen
    gen_bus = _gen_bus(env)
    taps = _taps(env)
    q_lim = _q_limits(env) * 0.6
    c016, c024, c020, c06, c13, c10, c0, cap_on = _consts(env, 0.16, 0.24, 0.20, 0.6, 1.3, 1.0, 0.0, 0.4)
    i0, i1, i2, i3, i4, i5, i10 = _ints(env, 0, 1, 2, 3, 4, 5, 10)
    thresholds_on = torch.tensor([0.96, 0.955], dtype=env.dtype, device=env.device)
    thresholds_off = torch.tensor([0.975, 0.97], dtype=env.dtype, device=env.device)

    def init_carry(n):
        z = lambda *shape, dtype=env.dtype: torch.zeros(n, *shape, dtype=dtype, device=env.device)  # noqa: E731
        return _L4Carry(z(), z(dtype=torch.bool), z(2), torch.full((n,), 2, dtype=torch.int32, device=env.device),
                        z(2, dtype=torch.int32), z(dtype=torch.int32))

    def act(noise, state, obs, carry):
        vm = state.bus_vm
        v_min, v_max, v_mean = torch.amin(vm, dim=1), torch.amax(vm, dim=1), _lane_mean(vm)
        trend = torch.where(carry.have_prev, v_mean - carry.prev_mean, c0)

        base = torch.where((trend > 0.005) & (v_max > 1.02), c016,
                           torch.where((trend < -0.005) & (v_min < 0.98), c024, c020))
        v_local = vm[:, gen_bus]
        v_pred = v_local + (trend * 3).unsqueeze(1)
        local = torch.where(v_pred > 1.04, c06, torch.where(v_pred < 0.96, c13, c10))
        a = _blank(env, state)
        a[:, :n_gen] = torch.minimum(state.p_pot * base.unsqueeze(1) * local, state.p_pot)
        a[:, _gen_q_slice(env)] = torch.where((v_pred < 0.96) | (v_local < 0.965), q_lim,
                                              torch.where((v_pred > 1.04) | (v_local > 1.035), -q_lim, c0))

        cap_timers = torch.clamp(carry.cap_timers - 1, min=0)
        is_off = carry.last_caps == 0.0
        turn_on = (v_min.unsqueeze(1) < thresholds_on) & is_off
        turn_off = (v_min.unsqueeze(1) > thresholds_off) & ~is_off
        can_act = cap_timers == 0
        new_caps = torch.where(can_act & turn_on, cap_on, torch.where(can_act & turn_off, c0, carry.last_caps))
        cap_timers = torch.where(can_act & (turn_on | turn_off), i5, cap_timers)
        a[:, cap_sl.start: cap_sl.start + 2] = new_caps

        tap_timer = torch.clamp(carry.tap_timer - 1, min=0)
        desired = torch.where(
            (v_min < 0.94) | ((v_min < 0.95) & (trend < -0.01)), i0,
            torch.where(v_min < 0.96, i1,
                        torch.where((v_max > 1.06) | ((v_max > 1.05) & (trend > 0.01)), i4,
                                    torch.where(v_max > 1.04, i3, i2))))
        significant = (torch.abs(desired - carry.last_tap_idx) > 1) | (v_min < 0.93) | (v_max > 1.07)
        do_change = (tap_timer == 0) & significant
        last_tap = torch.where(do_change, desired, carry.last_tap_idx)
        tap_timer = torch.where(do_change, i10, tap_timer)
        a[:, tap_sl] = taps[last_tap].unsqueeze(1)
        return a, _L4Carry(v_mean, torch.ones_like(carry.have_prev), new_caps, last_tap, cap_timers, tap_timer)

    return Controller("L4_predictive", init_carry, act)


class _L5Carry(NamedTuple):
    last_cap1: torch.Tensor     # [B] env dtype
    last_cap2: torch.Tensor     # [B] env dtype
    last_tap_idx: torch.Tensor  # [B] int32


def l5_grid():
    """The static 135-point configuration grid of the L5 search, rows
    (renewable fraction, cap 1, cap 2, tap index)."""
    cfgs = []
    for ren in (0.15, 0.20, 0.25):
        for c1 in (0.0, 0.2, 0.3):
            for c2 in (0.0, 0.2, 0.3):
                if c1 + c2 > 0.5:
                    continue
                for ti in range(5):
                    cfgs.append((ren, c1, c2, ti))
    return np.array(cfgs)  # [M, 4]


def make_l5(env):
    """L5: argmin over the discrete configuration grid against the
    hand-fitted linear voltage model (discrete_hierarchy.py:407-593), one
    [B, 135] cost per step.  The cost is summed term by term in the JAX
    package's order, and ``argmin`` takes the first minimum, as JAX's does."""
    cap_sl = env._action_slices["Q_cap"]
    tap_sl = env._action_slices["tap"]
    n_gen = env.spec.n_gen
    grid = torch.tensor(l5_grid(), dtype=env.dtype, device=env.device)  # [M, 4]
    grid_idx = grid[:, 3].to(torch.int32)
    taps = _taps(env)
    tap = taps[grid_idx]
    ren, c1, c2 = grid[:, 0], grid[:, 1], grid[:, 2]
    c0, cm046, c001, cm001 = _consts(env, 0.0, -0.046, 0.01, -0.01)
    # The lane-independent parts of the voltage model, at the env dtype.
    cap_boost = (c1 + c2) * 0.005
    oltc = torch.where(tap < 1.0, torch.where(tap <= 0.95, _consts(env, 0.046)[0], (1.0 - tap) * 0.92),
                       torch.where(tap >= 1.05, _consts(env, -0.050)[0], (1.0 - tap) * 1.0))
    boost_max = cap_boost * 0.9
    oltc_max = oltc * 0.95
    hi = _consts(env, 1.15)[0]
    caps_cost = 0.01 * (c1 + c2)
    ren_cost = 0.001 * torch.abs(ren - 0.2)

    def init_carry(n):
        z = torch.zeros(n, dtype=env.dtype, device=env.device)
        return _L5Carry(z, z.clone(), torch.full((n,), 2, dtype=torch.int32, device=env.device))

    def act(noise, state, obs, carry):
        vm = state.bus_vm
        v_min, v_max = torch.amin(vm, dim=1), torch.amax(vm, dim=1)
        base_min = torch.where((v_min > 0.99) & (v_max < 1.01), cm046, c0)

        pv_min = torch.clamp((v_min + base_min).unsqueeze(1) + cap_boost + oltc, 0.85, 1.15)
        pv_max = torch.minimum(torch.maximum(v_max.unsqueeze(1) + boost_max + oltc_max, pv_min), hi)
        cost = (
            100.0 * torch.clamp(0.95 - pv_min, min=0.0) ** 2
            + 100.0 * torch.clamp(pv_max - 1.05, min=0.0) ** 2
            + 1.0 * torch.clamp(0.96 - pv_min, min=0.0) ** 2
            + 1.0 * torch.clamp(pv_max - 1.04, min=0.0) ** 2
            + 0.05 * ((pv_min + pv_max) / 2 - 1.0) ** 2
            + 0.001 * (c1 != carry.last_cap1.unsqueeze(1)).to(env.dtype)
            + 0.001 * (c2 != carry.last_cap2.unsqueeze(1)).to(env.dtype)
            + 0.005 * (grid_idx != carry.last_tap_idx.unsqueeze(1)).to(env.dtype)
            + caps_cost
            + ren_cost
        )
        best = torch.argmin(cost, dim=1)
        b_c1, b_c2, b_tap_idx = c1[best], c2[best], grid_idx[best]

        a = _blank(env, state)
        a[:, :n_gen] = torch.where(state.p_pot > 0, state.p_pot * ren[best].unsqueeze(1), c0)
        a[:, _gen_q_slice(env)] = torch.where(v_min < 0.94, c001, torch.where(v_max > 1.06, cm001, c0)).unsqueeze(1)
        a[:, cap_sl.start] = b_c1
        a[:, cap_sl.start + 1] = b_c2
        a[:, tap_sl] = taps[b_tap_idx].unsqueeze(1)
        return a, _L5Carry(b_c1, b_c2, b_tap_idx)

    return Controller("L5_optimal", init_carry, act)


def make_suite(env):
    """The full L0-L5 suite for an environment."""
    return [make_l0(env), make_l1(env), make_l2(env), make_l3(env), make_l4(env), make_l5(env)]
