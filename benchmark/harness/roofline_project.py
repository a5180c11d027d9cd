"""The polygon projections (the ``transition.project`` span): bytes of a
run's projector calls.

A call projects every lane's set-points of one device family (G devices a
lane) onto their (P, Q) polygons: ``project(point [B, G, 2], p_lo, p_hi)``.
Each point reads its set-point (p, q) and its per-lane p bounds and writes
the projected (p, q), each value once:

* a generator point: the set-point (2 values), one per-lane bound (its cap,
  the smaller of the static p row and the potential; its lower p bound is
  a static row [G]) and the projected point (2): 5 values;
* a storage point: the set-point (2), two per-lane bounds (the SoC-rate
  rows fold into both) and the projected point (2): 6 values.

The static rows are read once a call: a generator family's p_lo, q_lo and
q_hi rows and two sloped rows (t and r, and a one-byte flag each), 7 values
and 2 flags a device; a storage family's q_lo and q_hi rows and four sloped
rows, 10 values and 4 flags a device.  The work is elementwise, so the bytes
bound it: the least time is the bytes at the HBM rate.  Every transition
projects both families over the same lanes, so of the points a run counts
the share n_gen / (n_gen + n_des) are generators', and of its calls each
family makes the same number.
"""

from .roofline import least_seconds

GEN_POINT, DES_POINT = 5, 6      # values a point
GEN_STATIC, DES_STATIC = 7, 10   # values a device, a call
GEN_FLAGS, DES_FLAGS = 2, 4      # one-byte flags a device, a call


def point_bytes(n_gen, n_des, elem):
    """Bytes of one lane's points of both families."""
    return elem * (GEN_POINT * n_gen + DES_POINT * n_des)


def static_bytes(n_gen, n_des, elem):
    """Bytes of the static rows of one call of each family present."""
    return (elem * GEN_STATIC + GEN_FLAGS) * n_gen + (elem * DES_STATIC + DES_FLAGS) * n_des


def call_bytes(points, calls, n_gen, n_des, elem):
    """Bytes of ``calls`` projector calls over ``points`` points in all."""
    families = (n_gen > 0) + (n_des > 0)
    lanes = points / (n_gen + n_des)
    return lanes * point_bytes(n_gen, n_des, elem) + calls / families * static_bytes(n_gen, n_des, elem)


def bound_seconds(points, calls, n_gen, n_des, elem):
    """Least time of ``calls`` calls over ``points`` points (``elem`` bytes a
    value)."""
    return least_seconds(0.0, call_bytes(points, calls, n_gen, n_des, elem))
