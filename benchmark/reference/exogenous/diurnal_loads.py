"""Exogenous rule ``diurnal_loads``: the renewable family's loads (gym-anm's
IEEE33 renewable and multi-capacitor envs), a daily factor
``base + amplitude * sin((hour - phase_h) * pi / 12)`` of each load's
nominal ``|PMIN|`` times ``load_scale``, with ``noise * N(0, 1)`` drawn a load
and a step; the generation potentials held at 0; no aux; the hour of day
carried in the task carry as float32 and advanced by ``delta_t / 3600`` a
step.  The constants are the network file's ``diurnal`` table.

The step's inputs are the draw the program recorded.  The rule holds that
draw to the formula: from each load and the hour after the step it works
out the standard normal the load implies, and flags a lane whose value lies
beyond ``Z_MAX``, and every lane of a block whose values are not those of a
standard normal (mean beyond ``MEAN_SIGMAS`` standard errors of 0, standard
deviation outside ``STD_RANGE``).  At 524,288 lanes of 32 loads over four
checked steps, fewer than 2e-4 lanes are expected beyond ``Z_MAX`` by chance.
"""

import math

import torch

from reference import grid

Z_MAX = 7.0
STD_RANGE = (0.9, 1.1)
MEAN_SIGMAS = 6.0


def _split(ref, d):
    n_load, n_gen = len(ref.net.loads), len(ref.net.gens)
    draw = d["draw"]
    return draw[:, :n_load], draw[:, n_load:n_load + n_gen], draw[:, n_load + n_gen:]


def inputs(ref, d):
    """(P_load, P_pot MW, aux) of the checked step: its recorded draw."""
    return _split(ref, d)


def implied_normal(ref, load, hour):
    """The standard normal [B, n_load] that each load (MW, float64) implies
    at the hour after the step (float32 [B]); the daily factor in float64."""
    c = ref.raw["diurnal"]
    nominal = torch.as_tensor(-abs(ref.net.p_min[ref.net.loads]) * ref.net.baseMVA, device=load.device)
    factor = c["base"] + c["amplitude"] * torch.sin((hour.double() - c["phase_h"]) * (math.pi / 12.0))
    expected = nominal * (c["load_scale"] * factor).unsqueeze(1)
    return (load / expected - 1.0) / c["noise"]


def carry_flips(ref, d, aux):
    """The lanes whose hour did not advance by ``delta_t / 3600`` mod 24 in
    float32, whose aux is not empty, whose potentials are not exactly 0,
    whose loads are not all negative, or whose loads imply a normal beyond
    ``Z_MAX``; and every lane of the block where the implied normals are not
    standard."""
    (hour_in,), (hour_out,) = d["task_in"], d["task_out"]
    load, pot, _ = _split(ref, d)
    B = load.shape[0]
    bad = hour_out != (hour_in + ref.task["delta_t"] / 3600.0) % 24.0
    bad |= torch.full((B,), d["aux_out"].shape[1] > 0, dtype=torch.bool, device=load.device)
    bad |= (d["aux_out"] != aux).any(1)
    bad |= (pot != 0).any(1)
    bad |= ~(load < 0).all(1)
    z = implied_normal(ref, load, hour_out)
    bad |= ~(z.abs() <= Z_MAX).all(1)
    n = z.numel()
    if n > 1:
        mean, std = float(z.mean()), float(z.std())
        lo, hi = STD_RANGE
        if not (abs(mean) <= MEAN_SIGMAS / math.sqrt(n) and lo <= std <= hi):
            bad = torch.ones_like(bad)
    return bad


def fresh_start(ref, r, gaps):
    """The reset lanes ``r`` that are not a fresh start: at time 0, an hour
    in [0, 24), not terminated, and their load flow and observation those of
    the device set-points, loads, potentials and tap they report."""
    net = ref.net
    nd, n_des, n_gen = net.n_dev, len(net.des), len(net.gens)
    (hour,) = r["task_out"]
    bad = (r["t_out"] != 0) | r["terminated_out"] | (hour < 0) | (hour >= 24)
    obs = r["obs"]
    P, Q = obs[:, :nd], obs[:, nd:2 * nd]
    g, s = net.gens, net.des
    soc_lo = torch.as_tensor(net.soc_min[s], device=obs.device)
    soc_hi = torch.as_tensor(net.soc_max[s], device=obs.device)
    action = torch.cat([P[:, g], Q[:, g], P[:, s], Q[:, s], Q[:, net.caps], r["tap_out"]], 1)
    p_pot = obs[:, 2 * nd + n_des:2 * nd + n_des + n_gen]
    out = grid.step(net, ref.task, dict(soc=torch.where(P[:, s] <= 0, soc_lo, soc_hi),
                                        terminated=torch.zeros_like(bad)),
                    action, P[:, net.loads], p_pot, r["aux_out"])
    vm_gap = (r["vm"] - torch.complex(out["v_re"], out["v_im"]).abs()).abs().amax(1)
    cols = [k for k in range(obs.shape[1]) if not (2 * nd <= k < 2 * nd + n_des)]
    obs_gap = ((obs[:, cols] - out["obs"][:, cols]).abs() / (1.0 + out["obs"][:, cols].abs())).amax(1)
    gaps.take("vm_gap", vm_gap.max())
    gaps.take("obs_gap", obs_gap.max())
    lim = lambda k: gaps.limits.get(k, float("inf"))  # noqa: E731
    return bad | out["done"] | ~(vm_gap <= lim("vm_gap")) | ~(obs_gap <= lim("obs_gap"))
