"""Observation plans: lists of ``(variable, ids[, unit])`` triples compiled
into gathers over the batched transition output.

Port of ``gym_anm_tpu/vec/obs.py``.  The compat tier's observation spec
(reference ``anm_env.py:516-611``) becomes, per triple, a static gather
(positions resolved from raw IDs when the plan is made) and a constant unit
scale; ``extract`` concatenates the segments to [B, n_obs].

Supported variables and units mirror the compat simulator's state dict
(``env/simulator.py:_gather_state``), with its reference quirks:
``bus_i_magn`` in kA is ``|i|·baseMVA/baseKV`` (no √3), ``branch_i_magn``
is ``sign(i).real·|i|`` = Re(i), and the ``gen_p_max`` MW upper bound uses
``q_max`` (SURVEY.md §2.2(2)).  A per-bus scale (kV, kA) multiplies in
float64, as the JAX package's float64 numpy scale does, and the segment is
then cast to the output's dtype.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..errors import ObsNotSupportedError, ObsSpaceError, UnitsNotSupportedError
from ..specs.constants import STATE_VARIABLES

__all__ = ["ObsPlan", "make_obs_plan"]


class ObsPlan(NamedTuple):
    """A compiled observation spec.

    ``extract(out, soc_pu, aux)`` maps a batch of transition outputs (a
    :class:`~gym_anm_torch.physics.transition.TransitionOut`), their SoC
    [B, n_des] (p.u.) and aux variables [B, K] to observations [B, n_obs].
    ``low``/``high`` are the observation-space bounds (compat
    ``observation_bounds`` semantics: observations are clipped to them).
    """

    extract: Callable
    low: np.ndarray
    high: np.ndarray
    values: tuple  # the expanded (var, ids, unit) triples, for introspection

    @property
    def n(self):
        return len(self.low)


def _expand(spec, K, values):
    """'all' → explicit ID lists; missing unit → the variable's default
    (reference anm_env.py:303-311 + 542-568)."""
    out = []
    for o in values:
        if len(o) == 2:
            var, ids = o
            unit = STATE_VARIABLES[var][0] if var in STATE_VARIABLES else None
        else:
            var, ids, unit = o
        if var not in STATE_VARIABLES:
            raise ObsNotSupportedError(var, list(STATE_VARIABLES.keys()))
        if isinstance(ids, str) and ids == "all":
            if "bus" in var:
                ids = [int(i) for i in spec.bus_ids]
            elif "dev" in var:
                ids = [int(i) for i in spec.dev_ids]
            elif "des" in var:
                ids = [int(spec.dev_ids[p]) for p in spec.des_pos]
            elif "gen" in var:
                ids = [int(spec.dev_ids[p]) for p in spec.gen_nonslack_pos]
            elif "branch" in var:
                ids = [(int(spec.bus_ids[f]), int(spec.bus_ids[t])) for f, t in zip(spec.br_f, spec.br_t)]
            else:  # aux
                ids = list(range(K))
        out.append((var, list(ids), unit))
    return out


def _check_unit(var, unit, allowed):
    if unit not in allowed:
        raise UnitsNotSupportedError(unit, allowed, var)


def _magn(re, im):
    return torch.sqrt(re ** 2 + im ** 2)


# var -> (allowed units, the unit that scales by baseMVA, the TransitionOut field(s) read).
_FLOWS = {
    "bus_p": (("MW", "pu"), "MW", "bus_p"),
    "bus_q": (("MVAr", "pu"), "MVAr", "bus_q"),
    "dev_p": (("MW", "pu"), "MW", "dev_p"),
    "dev_q": (("MVAr", "pu"), "MVAr", "dev_q"),
    "branch_p": (("MW", "pu"), "MW", "br_p_from"),
    "branch_q": (("MVAr", "pu"), "MVAr", "br_q_from"),
    "branch_s": (("MVA", "pu"), "MVA", "br_s_signed"),
}
_ANGLES = {
    "bus_v_ang": ("bus_v_im", "bus_v_re"),
    "bus_i_ang": ("bus_i_im", "bus_i_re"),
    "branch_i_ang": ("br_i_from_im", "br_i_from_re"),
}


def make_obs_plan(spec, K, values, device="cuda"):
    """Compile a list of ``(variable, ids[, unit])`` triples into an
    :class:`ObsPlan` for ``spec`` (a :class:`~gym_anm_torch.specs.network.
    NetworkSpec`) with ``K`` aux variables; the gathers' index tensors live
    on ``device``."""
    if not isinstance(values, list):
        raise ObsSpaceError(f"expected a list of (var, ids, unit) triples, got {values!r}")
    values = _expand(spec, K, values)
    base = spec.baseMVA
    device = torch.device(device)

    bus_pos = {int(i): k for k, i in enumerate(spec.bus_ids)}
    dev_pos = {int(i): k for k, i in enumerate(spec.dev_ids)}
    des_of_dev = {int(spec.dev_ids[p]): k for k, p in enumerate(spec.des_pos)}
    gen_of_dev = {int(spec.dev_ids[p]): k for k, p in enumerate(spec.gen_nonslack_pos)}
    br_pos = {(int(spec.bus_ids[f]), int(spec.bus_ids[t])): k for k, (f, t) in enumerate(zip(spec.br_f, spec.br_t))}

    seg_fns, lows, highs = [], [], []

    def _positions(var, ids, table):
        try:
            return np.array([table[i if not isinstance(i, list) else tuple(i)] for i in ids], dtype=np.int64)
        except KeyError as e:
            raise ObsSpaceError(f"unknown id {e.args[0]!r} for observation {var!r}") from e

    def f64(a):
        return torch.tensor(np.asarray(a, np.float64), device=device)

    for var, ids, unit in values:
        if var.startswith("bus"):
            idx = _positions(var, ids, bus_pos)
        elif var in ("dev_p", "dev_q"):
            idx = _positions(var, ids, dev_pos)
        elif var == "des_soc":
            idx = _positions(var, ids, des_of_dev)
        elif var == "gen_p_max":
            idx = _positions(var, ids, gen_of_dev)
        elif var.startswith("branch"):
            ids = [tuple(i) for i in ids]
            idx = _positions(var, ids, br_pos)
        else:  # aux
            idx = np.array(ids, dtype=np.int64)
            if (idx < 0).any() or (idx >= K).any():
                raise ObsSpaceError(f"aux ids {ids} out of range for K={K}")
        j = torch.tensor(idx, device=device)
        is_slack = np.array([bus_pos.get(i) == spec.slack_pos for i in ids]) if var.startswith("bus") else None
        unbounded = np.full(len(idx), np.inf)

        if var in _FLOWS:
            allowed, scaled, field = _FLOWS[var]
            _check_unit(var, unit, allowed)
            s = base if unit == scaled else 1.0
            seg_fns.append(lambda out, soc, aux, j=j, s=s, field=field: getattr(out, field)[:, j] * s)
            if var in ("bus_p", "bus_q"):
                lo_, hi_ = ((spec.bus_p_min, spec.bus_p_max) if var == "bus_p" else (spec.bus_q_min, spec.bus_q_max))
                lows.append(lo_[idx] * s)
                highs.append(hi_[idx] * s)
            elif var in ("dev_p", "dev_q"):
                lo_, hi_ = (spec.p_min, spec.p_max) if var == "dev_p" else (spec.q_min, spec.q_max)
                lows.append(lo_[idx] * s)
                highs.append(hi_[idx] * s)
            else:
                lows.append(-unbounded)
                highs.append(unbounded)
        elif var in _ANGLES:
            _check_unit(var, unit, ("degree", "rad"))
            s = 180.0 / np.pi if unit == "degree" else 1.0
            im, re = _ANGLES[var]
            seg_fns.append(lambda out, soc, aux, j=j, s=s, im=im, re=re:
                           torch.atan2(getattr(out, im)[:, j], getattr(out, re)[:, j]) * s)
            half = 180.0 if unit == "degree" else np.pi
            if var == "bus_v_ang":
                lows.append(np.where(is_slack, 0.0, -half))
                highs.append(np.where(is_slack, 0.0, half))
            else:
                lows.append(np.full(len(idx), -half))
                highs.append(np.full(len(idx), half))
        elif var == "bus_v_magn":
            _check_unit(var, unit, ("pu", "kV"))
            s = spec.base_kv[idx] if unit == "kV" else np.ones(len(idx))
            seg_fns.append(lambda out, soc, aux, j=j, s=f64(s): _magn(out.bus_v_re[:, j], out.bus_v_im[:, j]) * s)
            lows.append(np.where(is_slack, spec.v_slack * s, -np.inf))
            highs.append(np.where(is_slack, spec.v_slack * s, np.inf))
        elif var == "bus_i_magn":
            _check_unit(var, unit, ("pu", "kA"))
            # kA quirk: |i|·baseMVA/baseKV, no √3 (simulator.py:646).
            s = base / spec.base_kv[idx] if unit == "kA" else np.ones(len(idx))
            seg_fns.append(lambda out, soc, aux, j=j, s=f64(s): _magn(out.bus_i_re[:, j], out.bus_i_im[:, j]) * s)
            lows.append(-unbounded)
            highs.append(unbounded)
        elif var == "des_soc":
            _check_unit(var, unit, ("MWh", "pu"))
            s = base if unit == "MWh" else 1.0
            seg_fns.append(lambda out, soc, aux, j=j, s=s: soc[:, j] * s)
            lows.append(spec.soc_min[spec.des_pos][idx] * s)
            highs.append(spec.soc_max[spec.des_pos][idx] * s)
        elif var == "gen_p_max":
            _check_unit(var, unit, ("MW", "pu"))
            s = base if unit == "MW" else 1.0
            seg_fns.append(lambda out, soc, aux, j=j, s=s: out.gen_p_pot[:, j] * s)
            gpos = spec.gen_nonslack_pos[idx]
            lows.append(spec.p_min[gpos] * s)
            # The reference's MW upper bound uses q_max (simulator.py:470).
            highs.append((spec.q_max[gpos] * base) if unit == "MW" else spec.p_max[gpos])
        elif var == "branch_i_magn":
            _check_unit(var, unit, ("pu",))
            # sign(i).real·|i| == Re(i) (simulator.py:675 verbatim).
            seg_fns.append(lambda out, soc, aux, j=j: out.br_i_from_re[:, j])
            lows.append(-unbounded)
            highs.append(unbounded)
        else:  # aux
            seg_fns.append(lambda out, soc, aux, j=j: aux[:, j])
            lows.append(-unbounded)
            highs.append(unbounded)

    low = np.concatenate(lows) if lows else np.zeros(0)
    high = np.concatenate(highs) if highs else np.zeros(0)

    def extract(out, soc_pu, aux):
        dt = out.dev_p.dtype
        segs = [f(out, soc_pu, aux).to(dt) for f in seg_fns]
        return torch.cat(segs, dim=1) if segs else out.dev_p.new_zeros(out.dev_p.shape[0], 0)

    return ObsPlan(extract=extract, low=low, high=high, values=tuple((v, tuple(i), u) for v, i, u in values))
