"""The transition's work after the load flow, as plain torch ops written out
step by step: the bus currents (from the solver's final mismatch on the
chord tier, or given), the measured slack injection, the branch flows and
the reward.  The reference the tests hold
``gym_anm_torch/physics/transition.py``'s flows to, bit for bit (its plain
route) and to within the stated bounds (the CUDA kernel).  Imports nothing
of the port: ``tb`` is any object with the tables' fields."""

import torch


def _matmul_full(a, b):
    """``a @ b`` formed in float64 and rounded back to float32 (float64
    inputs as they are)."""
    if a.dtype == torch.float64:
        return torch.matmul(a, b)
    return torch.matmul(a.double(), b.double()).to(a.dtype)


def branch_flows(tb, v_re, v_im, tap_magn):
    """Directed branch currents and power flows; v [B, N], tap_magn [B, Ne]."""
    vf_re, vf_im = v_re[:, tb.br_f], v_im[:, tb.br_f]
    vt_re, vt_im = v_re[:, tb.br_t], v_im[:, tb.br_t]

    tap_re = tap_magn * tb.shift_cos
    tap_im = tap_magn * tb.shift_sin
    a2 = tap_magn * tap_magn

    tot_re, tot_im = tb.series_re, tb.series_im + tb.shunt_im

    t1_re = (tot_re * vf_re - tot_im * vf_im) / a2
    t1_im = (tot_re * vf_im + tot_im * vf_re) / a2
    vt_ct_re = (vt_re * tap_re - vt_im * tap_im) / a2
    vt_ct_im = (vt_im * tap_re + vt_re * tap_im) / a2
    t2_re = tb.series_re * vt_ct_re - tb.series_im * vt_ct_im
    t2_im = tb.series_re * vt_ct_im + tb.series_im * vt_ct_re
    i_from_re, i_from_im = t1_re - t2_re, t1_im - t2_im

    t3_re = tot_re * vt_re - tot_im * vt_im
    t3_im = tot_re * vt_im + tot_im * vt_re
    vf_t_re = (vf_re * tap_re + vf_im * tap_im) / a2
    vf_t_im = (vf_im * tap_re - vf_re * tap_im) / a2
    t4_re = tb.series_re * vf_t_re - tb.series_im * vf_t_im
    t4_im = tb.series_re * vf_t_im + tb.series_im * vf_t_re
    i_to_re, i_to_im = t3_re - t4_re, t3_im - t4_im

    p_from = vf_re * i_from_re + vf_im * i_from_im
    q_from = vf_im * i_from_re - vf_re * i_from_im
    p_to = vt_re * i_to_re + vt_im * i_to_im
    q_to = vt_im * i_to_re - vt_re * i_to_im

    s_from = torch.sqrt(p_from * p_from + q_from * q_from)
    s_to = torch.sqrt(p_to * p_to + q_to * q_to)
    s_signed = torch.sign(p_from) * torch.maximum(s_from, s_to)

    return (
        i_from_re, i_from_im, i_to_re, i_to_im,
        p_from, q_from, p_to, q_to, s_signed,
    )


def chord_currents(tb, v_re, v_im, F, p_ns, q_ns, dy):
    """Bus currents of the chord tier: the non-slack rows from the final
    mismatch, the slack row from row 0 of the nominal Y-bus plus the lane's
    ΔY terms ``dy = (dff_re, dff_im, dft_re, dft_im)``."""
    dff_re, dff_im, dft_re, dft_im = dy
    t_bus = tb.chord.t_bus
    n_ns = tb.n_bus - 1
    S_re = p_ns + F[:, :n_ns]
    S_im = q_ns + F[:, n_ns:]
    v_ns_re, v_ns_im = v_re[:, 1:], v_im[:, 1:]
    vmag2 = v_ns_re * v_ns_re + v_ns_im * v_ns_im
    i_ns_re = (S_re * v_ns_re + S_im * v_ns_im) / vmag2
    i_ns_im = -(S_im * v_ns_re - S_re * v_ns_im) / vmag2
    y0r, y0i = tb.chord_t.Y0re[0], tb.chord_t.Y0im[0]
    i0_re = _matmul_full(v_re, y0r) - _matmul_full(v_im, y0i)
    i0_im = _matmul_full(v_re, y0i) + _matmul_full(v_im, y0r)
    vt_re, vt_im = v_re[:, t_bus], v_im[:, t_bus]
    i0_re = i0_re + dff_re + dft_re * vt_re - dft_im * vt_im
    i0_im = i0_im + dff_im + dft_re * vt_im + dft_im * vt_re
    i_re = torch.cat([i0_re.unsqueeze(1), i_ns_re], dim=1)
    i_im = torch.cat([i0_im.unsqueeze(1), i_ns_im], dim=1)
    return i_re, i_im


def finish(tb, v_re, v_im, i_re, i_im, tap_magn, bus_p, bus_q, dev_p, dev_q, p_pot, p_g, rates):
    """Slack injection (written into ``bus_p``, ``bus_q``, ``dev_p``,
    ``dev_q``), branch flows and reward from the bus currents.  Returns
    (i_re, i_im, the nine branch arrays, e_loss, penalty, reward)."""
    s_sl_re = v_re[:, 0] * i_re[:, 0] + v_im[:, 0] * i_im[:, 0]
    s_sl_im = v_im[:, 0] * i_re[:, 0] - v_re[:, 0] * i_im[:, 0]
    inf = torch.full_like(s_sl_re, float("inf"))
    s_sl_re = torch.where(torch.isnan(s_sl_re), inf, s_sl_re)
    s_sl_im = torch.where(torch.isnan(s_sl_im), inf, s_sl_im)
    bus_p[:, tb.slack_bus] = s_sl_re
    bus_q[:, tb.slack_bus] = s_sl_im
    dev_p[:, tb.slack_dev] = s_sl_re
    dev_q[:, tb.slack_dev] = s_sl_im

    branches = branch_flows(tb, v_re, v_im, tap_magn)
    s_signed = branches[-1]

    e_loss = torch.sum(dev_p[:, tb.genload_pos], dim=1)
    if tb.gen_project is not None:
        e_loss = e_loss + torch.sum(torch.clamp(p_pot - p_g, min=0.0) * tb.gen_rer_mask, dim=1)
    e_loss = e_loss * tb.delta_t

    v_magn = torch.sqrt(v_re * v_re + v_im * v_im)
    penalty = torch.sum(
        torch.clamp(v_magn - tb.bus_v_max, min=0.0) + torch.clamp(tb.bus_v_min - v_magn, min=0.0),
        dim=1,
    )
    penalty = penalty + torch.sum(torch.clamp(torch.abs(s_signed) - rates, min=0.0), dim=1)
    penalty = penalty * tb.delta_t * tb.lamb

    reward = -(e_loss + penalty)
    return (i_re, i_im) + tuple(branches) + (e_loss, penalty, reward)
