"""Exact Euclidean projection of device set-points onto their feasible
(P, Q) polygons.

Port of ``gym_anm_tpu/physics/projection.py:70-192`` (the box + sloped-line
projector, which replaces the reference's per-device cvxpy QPs,
``gym_anm/simulator/components/devices.py:282-306`` for generators and
``:474-524`` for storage).  Every device polygon is an axis-aligned box
intersected with a few sloped q-bound lines (upper: q <= t·p + r, lower:
q >= t·p + r).  With y = clip(x, box): if y satisfies every sloped row, y
is the projection; otherwise the projection lies on the feasible segment of
one sloped line, and the distance-argmin over the clamped perpendicular feet
of those segments is exact.

Written batch-leading: a point is ``[B, G, 2]`` and the static rows are
``[G]`` tensors that broadcast against it.  Everything that depends on the
static rows alone is computed once, when a family's rows are bound: the
cuts each other row makes in a sloped line's p-interval, folded into one
lower and one upper cut a line.  A call then treats every line of the family
at once (a trailing line axis), in a few dozen elementwise ops whatever the
number of lines, with each value rounded as in the line-by-line form.  The
general candidate enumeration (``project_polytope_2d``) stays in the JAX
package, as the oracle the tests hold this projector against.
"""

import torch


def _p_cuts(c, d):
    """The cut {p : c·p >= d} makes in a p-interval, as (lower, upper, empty):
    ``max(lo, lower)``, ``min(hi, upper)`` and ``empty`` (the row excludes
    every p) are the intersection, branchless.

    ``d = -inf`` encodes "no constraint" (inactive rows); NaN ``c`` compares
    False everywhere and cuts nothing.
    """
    v = d / torch.where(c != 0, c, torch.ones_like(c))
    lower = torch.where(c > 0, v, torch.full_like(v, float("-inf")))
    upper = torch.where(c < 0, v, torch.full_like(v, float("inf")))
    return lower, upper, (c == 0) & (d > 0)


def _line_cuts(i, lines, q_lo, q_hi):
    """Folded cuts of sloped line ``i``'s feasible p-interval: the q-box
    along the line (q_lo <= t·p + r <= q_hi) and every other active line.
    Returns (lower, upper, usable) [G]: ``usable`` is the line active with a
    segment not excluded outright.  Folding the cuts with max / min picks the
    same value as applying them one by one."""
    t, r, act, _ = lines[i]
    neg_inf = torch.full_like(r, float("-inf"))
    rows = [(t, q_lo - r), (-t, r - q_hi)]
    for j, (tj, rj, actj, upper_j) in enumerate(lines):
        if j == i:
            continue
        if upper_j:  # this line's q must stay <= line j:  (tj - t)·p >= r - rj
            rows.append((tj - t, torch.where(actj, r - rj, neg_inf)))
        else:        # ... and >= lower line j:  (t - tj)·p >= rj - r
            rows.append((t - tj, torch.where(actj, rj - r, neg_inf)))
    lower, upper, empty = neg_inf, torch.full_like(r, float("inf")), torch.zeros_like(act)
    for c, d in rows:
        lo_c, hi_c, empty_c = _p_cuts(c, d)
        lower, upper, empty = torch.maximum(lower, lo_c), torch.minimum(upper, hi_c), empty | empty_c
    return lower, upper, act & ~empty


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
    n_lines = len(lines)
    q_bad = q_lo > q_hi
    # [G, L] rows of the lines; an upper line's violation is q − (t·p + r), a
    # lower one's its negation (exact), so one sign a line.
    col = lambda xs: torch.stack(xs, dim=-1)  # noqa: E731
    T, R, ACT = col([ln[0] for ln in lines]), col([ln[1] for ln in lines]), col([ln[2] for ln in lines])
    SIGN = col([torch.full_like(ln[1], 1.0 if ln[3] else -1.0) for ln in lines])
    TOL, INACTIVE, TT1 = 1e-11 * (1.0 + torch.abs(R)), ~ACT, 1.0 + T * T
    cuts = [_line_cuts(i, lines, q_lo, q_hi) for i in range(n_lines)]
    LOWER, UPPER, USABLE = (col(list(x)) for x in zip(*cuts))

    def project(point, p_lo, p_hi):
        px, py = point[..., 0], point[..., 1]
        yx = torch.minimum(torch.maximum(px, p_lo), p_hi)
        yy = torch.minimum(torch.maximum(py, q_lo), q_hi)
        px3, py3 = px.unsqueeze(-1), py.unsqueeze(-1)

        # y satisfies every active sloped row.
        sat = ((yy.unsqueeze(-1) - (T * yx.unsqueeze(-1) + R)) * SIGN <= TOL) | INACTIVE
        feas = sat.all(dim=-1) & ~((p_lo > p_hi) | q_bad)

        # Every line's clamped perpendicular foot and its squared distance
        # (+inf where the segment is empty or the line inactive).
        resid = py3 - (T * px3 + R)
        foot_p = px3 + T * resid / TT1
        lo = torch.maximum(p_lo.unsqueeze(-1), LOWER)
        hi = torch.minimum(p_hi.unsqueeze(-1), UPPER)
        p_star = torch.minimum(torch.maximum(foot_p, lo), hi)
        q_star = T * p_star + R
        d2 = torch.where(USABLE & (lo <= hi), (p_star - px3) ** 2 + (q_star - py3) ** 2, float("inf"))

        # The first line of least distance (falls back to the unprojected
        # point when every edge is empty, i.e. the region itself is empty, as
        # the general enumeration does when every candidate is infeasible).
        best_d2, bx, by = float("inf"), px, py
        for i in range(n_lines):
            take = d2[..., i] < best_d2
            if i + 1 < n_lines:
                best_d2 = torch.where(take, d2[..., i], best_d2)
            bx = torch.where(take, p_star[..., i], bx)
            by = torch.where(take, q_star[..., i], by)
        return torch.stack([torch.where(feas, yx, bx), torch.where(feas, yy, by)], dim=-1)

    return project
