"""The box + sloped-line projector written line by line: each call cuts
every sloped line's p-interval by every other row in turn.  The reference
the tests hold ``gym_anm_torch/physics/projection.py``'s projector to, bit
for bit: the same arithmetic, which that projector folds at binding and
applies to all lines at once.  Imports nothing of the port."""

import torch


def _ival_ge(c, d, lo, hi, empty):
    """Intersect the p-interval [lo, hi] with {p : c·p >= d} (branchless).

    ``d = -inf`` encodes "no constraint" (inactive rows); NaN ``c`` (from
    inactive-row slope arithmetic) compares False everywhere and is a no-op.
    """
    safe = torch.where(c != 0, c, torch.ones_like(c))
    v = d / safe
    lo = torch.where(c > 0, torch.maximum(lo, v), lo)
    hi = torch.where(c < 0, torch.minimum(hi, v), hi)
    empty = empty | ((c == 0) & (d > 0))
    return lo, hi, empty


def _clip(x, lo, hi):
    """``jnp.clip``: minimum(maximum(x, lo), hi), NaN-propagating."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _edge_project(i, lines, px, py, p_lo, p_hi, q_lo, q_hi):
    """Project (px, py) onto the feasible segment of sloped line ``i``.

    ``lines`` = [(t, r, act, is_upper), ...]; returns (d2, p*, q*) with
    d2 = +inf where the edge is empty or the line inactive.
    """
    t, r, act, _ = lines[i]
    resid = py - (t * px + r)
    foot_p = px + t * resid / (1.0 + t * t)

    shape = torch.broadcast_shapes(px.shape, p_lo.shape, p_hi.shape)
    lo = p_lo.expand(shape)
    hi = p_hi.expand(shape)
    empty = torch.zeros(shape, dtype=torch.bool, device=px.device)
    neg_inf = torch.full_like(r, float("-inf"))
    # q-box along the line:  q_lo <= t·p + r <= q_hi.
    lo, hi, empty = _ival_ge(t, q_lo - r, lo, hi, empty)
    lo, hi, empty = _ival_ge(-t, r - q_hi, lo, hi, empty)
    for j, (tj, rj, actj, upper_j) in enumerate(lines):
        if j == i:
            continue
        if upper_j:  # this line's q must stay <= line j:  (tj - t)·p >= r - rj
            lo, hi, empty = _ival_ge(tj - t, torch.where(actj, r - rj, neg_inf), lo, hi, empty)
        else:        # ... and >= lower line j:  (t - tj)·p >= rj - r
            lo, hi, empty = _ival_ge(t - tj, torch.where(actj, rj - r, neg_inf), lo, hi, empty)

    p_star = _clip(foot_p, lo, hi)
    q_star = t * p_star + r
    valid = act & (lo <= hi) & ~empty
    d2 = torch.where(valid, (p_star - px) ** 2 + (q_star - py) ** 2, torch.full_like(p_star, float("inf")))
    return d2, p_star, q_star


def _box_slopes_core(px, py, p_lo, p_hi, q_lo, q_hi, lines):
    """Elementwise exact projection (see module docstring).  All arguments
    broadcast; ``lines`` entries are (t, r, act, is_upper)."""
    yx = _clip(px, p_lo, p_hi)
    yy = _clip(py, q_lo, q_hi)
    feas = ~((p_lo > p_hi) | (q_lo > q_hi))
    for t, r, act, is_upper in lines:
        tol = 1e-11 * (1.0 + torch.abs(r))
        viol = (yy - (t * yx + r)) if is_upper else ((t * yx + r) - yy)
        feas = feas & torch.where(act, viol <= tol, torch.ones_like(act))

    # Best edge projection (falls back to the unprojected point when every
    # edge is empty, i.e. the region itself is empty, as the general
    # enumeration does when every candidate is infeasible).
    shape = torch.broadcast_shapes(px.shape, p_lo.shape)
    best_d2 = torch.full(shape, float("inf"), dtype=px.dtype, device=px.device)
    bx, by = px.expand(shape), py.expand(shape)
    for i in range(len(lines)):
        d2, cx, cy = _edge_project(i, lines, px, py, p_lo, p_hi, q_lo, q_hi)
        take = d2 < best_d2
        best_d2 = torch.where(take, d2, best_d2)
        bx = torch.where(take, cx, bx)
        by = torch.where(take, cy, by)

    return torch.where(feas, yx, bx), torch.where(feas, yy, by)


def make_box_slopes_projector(q_lo, q_hi, uppers, lowers):
    """Bind a device family's static rows into a projector
    ``project(point [B, G, 2], p_lo, p_hi) -> [B, G, 2]``.

    ``q_lo``/``q_hi``: [G] static q bounds (±inf when the row is absent).
    ``uppers``/``lowers``: sequences of (t [G], r [G], active [G]) static
    sloped rows (q <= t·p + r resp. q >= t·p + r), as tensors of one dtype
    on one device.  The p bounds stay arguments ([G] or [B, G]) because the
    devices' p caps move at run time (generator potential, storage SoC-rate
    rows).
    """
    lines = [(t, r, a, True) for t, r, a in uppers] + [(t, r, a, False) for t, r, a in lowers]

    def project(point, p_lo, p_hi):
        ox, oy = _box_slopes_core(point[..., 0], point[..., 1], p_lo, p_hi, q_lo, q_hi, lines)
        return torch.stack([ox, oy], dim=-1)

    return project
