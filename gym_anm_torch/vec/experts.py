"""Batched heuristic experts: the expert zoo as controllers.

Port of ``gym_anm_tpu/vec/experts.py`` (the equivalent of
``gym_anm/offline.py:106-694``).  Same decision rules and thresholds as the
host classes, as :class:`~gym_anm_torch.vec.controllers.Controller` pairs, so
mixed expert datasets are collected with
:func:`gym_anm_torch.offline_vec.generate_mixed_dataset_vec` on whole lane
batches.

Covered families (the zoo's behaviourally distinct members):

* capacitor banks: threshold (simple/conservative/aggressive), hysteresis;
* OLTC: threshold variants, deadband;
* renewables: threshold curtailment variants, proportional;
* combined, do-nothing, random (= ``controllers.make_l0``).

Actions follow the env layout [P_gen, Q_gen, P_des, Q_des, Q_cap, tap] in
the reference's MW/MVAr/ratio units.
"""

import numpy as np
import torch

from .controllers import Controller

__all__ = ["make_cap_bank_expert", "make_hysteresis_cap_expert", "make_oltc_expert", "make_renewable_expert",
           "make_combined_expert", "make_do_nothing_expert", "make_expert_zoo"]


class _Spec:
    """Per-env indices and bounds the experts need, as tensors of the env
    dtype on the env device (made once, when the expert is made)."""

    def __init__(self, env):
        spec, tb = env.spec, env.tables
        self.base = float(spec.baseMVA)
        sl = env._action_slices
        self.sl_pgen, self.sl_qcap, self.sl_tap = sl["P_gen"], sl["Q_cap"], sl["tap"]
        self.dtype, self.device = env.dtype, env.device
        flt = lambda a: torch.tensor(np.asarray(a, np.float64), dtype=env.dtype, device=env.device)  # noqa: E731
        idx = lambda a: torch.tensor(np.asarray(a, np.int64), device=env.device)  # noqa: E731
        gp = spec.gen_nonslack_pos
        self.gen_bus = idx(spec.dev_bus[gp])
        self.gen_is_rer = torch.tensor(np.isin(gp, spec.rer_pos), device=env.device)
        self.gen_p_min = flt(spec.p_min[gp])
        cp = spec.cap_pos
        self.cap_bus = idx(spec.dev_bus[cp])
        self.cap_q_max = flt(spec.q_max[cp] * self.base)
        self.cap_q_min = flt(spec.q_min[cp] * self.base)
        ob = np.asarray(spec.oltc_branch)
        self.oltc_t_bus = idx(np.asarray(spec.br_t)[ob] if len(ob) else np.zeros(0, np.int64))
        self.tap_min = tb.oltc_tap_min
        self.tap_max = tb.oltc_tap_max
        self.n_action = env.n_action
        self.zero = torch.zeros((), dtype=env.dtype, device=env.device)
        self.band = torch.tensor(0.02, dtype=env.dtype, device=env.device)


def _base_action(s: _Spec, state):
    """BaseHeuristic.get_base_action: gens at p_pot·baseMVA MW, DES idle,
    caps 0, taps 1.0 (offline.py:132-139)."""
    a = torch.zeros(state.p_pot.shape[0], s.n_action, dtype=s.dtype, device=s.device)
    a[:, s.sl_pgen] = state.p_pot * s.base
    if s.sl_tap.stop > s.sl_tap.start:
        a[:, s.sl_tap] = 1.0
    return a


def _stateless(name, fn):
    return Controller(name=name, init_carry=lambda n: (), act=lambda noise, state, obs, carry: (fn(state), carry))


def _cap_q_threshold(s, state, v_min, v_max):
    v = state.bus_vm[:, s.cap_bus]
    return torch.where(v < v_min, s.cap_q_max, torch.where(v > v_max, s.cap_q_min, s.zero))


def _oltc_tap(s, state, v_low, v_high):
    v = state.bus_vm[:, s.oltc_t_bus]
    return torch.where(v < v_low, s.tap_max, torch.where(v > v_high, s.tap_min, state.oltc_tap))


def make_cap_bank_expert(env, v_min=0.99, v_max=1.01, name="cap_bank"):
    """Per-capacitor local-voltage threshold switching
    (CapBankHeuristic, offline.py:145-161); default thresholds = Simple,
    pass 0.98/1.02 for Conservative, 0.995/1.005 for Aggressive."""
    s = _Spec(env)

    def fn(state):
        a = _base_action(s, state)
        a[:, s.sl_qcap] = _cap_q_threshold(s, state, v_min, v_max)
        return a

    return _stateless(name, fn)


def make_hysteresis_cap_expert(env, v_on=0.985, v_off=1.015):
    """State changes only when the local voltage exits the wider band
    (HysteresisCapBankHeuristic, offline.py:236-258); the carry is the
    capacitors' last set-points [B, n_cap] (MVAr)."""
    s = _Spec(env)
    n_cap = len(env.spec.cap_pos)

    def init_carry(n):
        return torch.zeros(n, n_cap, dtype=s.dtype, device=s.device)

    def act(noise, state, obs, carry):
        v = state.bus_vm[:, s.cap_bus]
        q = torch.where(v < v_on, s.cap_q_max, torch.where(v > v_off, s.cap_q_min, carry))
        a = _base_action(s, state)
        a[:, s.sl_qcap] = q
        return a, q

    return Controller(name="cap_hysteresis", init_carry=init_carry, act=act)


def make_oltc_expert(env, v_min=0.99, v_max=1.01, deadband=0.0, name="oltc"):
    """Tap to max under low regulated-bus voltage, to min under high,
    otherwise hold the current tap (OLTCHeuristic/DeadbandOLTCHeuristic,
    offline.py:261-278,354-374)."""
    s = _Spec(env)

    def init_carry(n):
        return ()

    def act(noise, state, obs, carry):
        a = _base_action(s, state)
        a[:, s.sl_tap] = _oltc_tap(s, state, v_min - deadband, v_max + deadband)
        return a, carry

    return Controller(name=name, init_carry=init_carry, act=act)


def _ren_p(s, state, v_max, proportional):
    v = state.bus_vm[:, s.gen_bus]
    if proportional:
        # A division by a tensor on the lanes' device: a Python divisor would
        # become a multiply by its reciprocal on the card.
        curtail = torch.clamp((v - v_max) / s.band, 0.0, 1.0)
        p = torch.maximum(s.gen_p_min, state.p_pot * (1 - 0.5 * curtail))
        p = torch.where(v > v_max, p, state.p_pot)
    else:
        p = torch.where(v > v_max, torch.maximum(s.gen_p_min, 0.9 * state.p_pot), state.p_pot)
    return torch.where(s.gen_is_rer, p, state.p_pot) * s.base


def make_renewable_expert(env, v_min=0.99, v_max=1.01, proportional=False, name="renewable"):
    """Local-overvoltage curtailment (RenewableGenHeuristic /
    ProportionalRenewableHeuristic, offline.py:377-424)."""
    s = _Spec(env)

    def fn(state):
        a = _base_action(s, state)
        a[:, s.sl_pgen] = _ren_p(s, state, v_max, proportional)
        return a

    return _stateless(name, fn)


def make_combined_expert(env, v_min=0.99, v_max=1.01):
    """Renewable curtailment + cap switching + OLTC together
    (CombinedHeuristic, offline.py:489-512)."""
    s = _Spec(env)

    def init_carry(n):
        return ()

    def act(noise, state, obs, carry):
        a = _base_action(s, state)
        a[:, s.sl_pgen] = _ren_p(s, state, v_max, False)
        a[:, s.sl_qcap] = _cap_q_threshold(s, state, v_min, v_max)
        a[:, s.sl_tap] = _oltc_tap(s, state, v_min, v_max)
        return a, carry

    return Controller(name="combined", init_carry=init_carry, act=act)


def make_do_nothing_expert(env):
    """The base action only (DoNothingHeuristic, offline.py:519-521)."""
    s = _Spec(env)
    return _stateless("do_nothing", lambda state: _base_action(s, state))


def make_expert_zoo(env):
    """A diverse expert set for mixed-dataset collection."""
    return [
        make_cap_bank_expert(env),                                  # simple
        make_cap_bank_expert(env, 0.98, 1.02, name="cap_conservative"),
        make_cap_bank_expert(env, 0.995, 1.005, name="cap_aggressive"),
        make_hysteresis_cap_expert(env),
        make_oltc_expert(env),
        make_oltc_expert(env, deadband=0.005, name="oltc_deadband"),
        make_renewable_expert(env),
        make_renewable_expert(env, proportional=True, name="renewable_prop"),
        make_combined_expert(env),
        make_do_nothing_expert(env),
    ]
