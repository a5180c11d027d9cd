"""Exogenous rule ``anm6easy_profiles``: ANM6Easy's daily tables
(``load_profiles_mw``, ``gen_profiles_mw`` in the network file), read at the
time index that the aux carries and advances by one a step; a fresh start
draws its time index and reads the tables there."""

import torch

from reference import grid
from reference.exogenous import carry_moved


def inputs(ref, d):
    """(P_load, P_pot MW, aux) of the checked step from the carried aux [B, 1]."""
    aux_in = d["aux_in"]
    loads, gens = ref.profiles(aux_in.device)
    t = torch.remainder(aux_in[:, -1] + 1, loads.shape[1]).long()
    return loads[:, t].T, gens[:, t].T, t.double().unsqueeze(1)


def carry_flips(ref, d, aux):
    """The lanes whose aux is not the advanced time index, or whose task
    carry moved (the task carries none)."""
    return (d["aux_out"] != aux).any(1) | carry_moved(d)


def fresh_start(ref, r, gaps):
    """The reset lanes ``r`` (the checked step's fields at those lanes) that
    are not a fresh start at time 0 of the day's profile index they report,
    their SoC inside its bounds, and their load flow and observation those of
    the device set-points they report."""
    net = ref.net
    aux = r["aux_out"][:, -1]
    loads, gens = ref.profiles(aux.device)
    T = loads.shape[1]
    bad = (r["t_out"] != 0) | r["terminated_out"] | (aux != aux.round()) | (aux < 0) | (aux >= T)
    soc_lo = torch.as_tensor(net.soc_min[net.des], device=aux.device)
    soc_hi = torch.as_tensor(net.soc_max[net.des], device=aux.device)
    bad |= ((r["soc_out"] < soc_lo - 1e-6) | (r["soc_out"] > soc_hi + 1e-6)).any(1)
    t = aux.clamp(0, T - 1).long()
    nd = net.n_dev
    obs = r["obs"]
    P, Q = obs[:, :nd], obs[:, nd:2 * nd]
    g, s = net.gens, net.des
    action = torch.cat([P[:, g], Q[:, g], P[:, s], Q[:, s], Q[:, net.caps],
                        torch.ones(obs.shape[0], len(net.oltcs), dtype=torch.float64, device=aux.device)], 1)
    # The reset's projection reads the SoC seeded empty or full by the sign of the set-point.
    soc_seed = torch.where(P[:, s] <= 0, soc_lo, soc_hi)
    out = grid.step(net, ref.task, dict(soc=soc_seed, terminated=torch.zeros_like(bad)), action,
                    loads[:, t].T, gens[:, t].T, aux.unsqueeze(1))
    vm_ref = torch.complex(out["v_re"], out["v_im"]).abs()
    gaps.take("vm_gap", (r["vm"] - vm_ref).abs().amax())
    cols = [k for k in range(obs.shape[1]) if not (2 * nd <= k < 2 * nd + len(s))]  # the drawn SoC is not a flow result
    o_gap = ((obs[:, cols] - out["obs"][:, cols]).abs() / (1.0 + out["obs"][:, cols].abs())).amax(1)
    gaps.take("obs_gap", o_gap.max())
    return bad | out["done"]
