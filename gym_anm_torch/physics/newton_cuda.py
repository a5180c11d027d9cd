"""The exact-Newton fallback on the card: the wrapper of the CUDA kernel
``csrc/newton_fallback.cu``, which runs the whole Newton loop of every lane
that still iterates in one launch: a triage pass over every lane, then the
lanes that iterate taken from a device worklist.  K3 (n <= 64, networks of
up to 33 buses) spreads each lane's Gauss-Jordan sweeps over a group of
threads that holds the system in registers; K3 wide (n above 64) runs a
lane a block with its [J | F] in shared memory (route ``"smem"``), a lane a
thread-block cluster with [J | F]'s rows dealt over the blocks' shared
memory (``"cluster"``), or a lane a block with [J | F] in the block's slot
of device memory (``"blocked"``), by :func:`wide_route`.  It replaces the reference's
device loop ``gym_anm_tpu/physics/power_flow.py:nr_solve_lazy`` (and the
same loop in ``nr_solve``).

Its plain version is
:func:`~gym_anm_torch.physics.power_flow._newton_loop`;
:func:`~gym_anm_torch.physics.power_flow.nr_solve_lazy` and
:func:`~gym_anm_torch.physics.power_flow.nr_solve` pick between the two by
the tensors' device alone.
"""

import functools

import torch

from .linsolve_cuda import k1_route
from .ybus import LaneYbus

# Largest n = 2 (N_bus - 1) of K3's register bodies (networks of up to 33
# buses: IEEE33, n = 64); above it K3 wide.
REGS_MAX_N = 64
# Largest n of K3 wide: its float64 Y V tree keeps 12 levels a thread
# (networks of up to 4096 buses).  A card whose shared memory takes no
# panel of K1's blocked route at n is refused below it (k1_route).
MAX_N = 2 * (2 ** 12 - 1)


# K3 wide's cluster route (csrc/newton_fallback_wide.cuh): the cluster sizes
# tried in order (8 is the portable maximum), the panel widths tried at each
# by the element's bytes (the wider first: fewer panels, so fewer cluster
# barriers in a lane's chain; float64 has no body of 16, which spilled), and
# the blocks' maxima a block keeps (kClMax).
CLUSTER_SIZES = (2, 4, 8)
CLUSTER_PANELS = {4: (16, 8), 8: (8,)}
CLUSTER_MAX = 8


def wide_lane_bytes(n, itemsize):
    """Shared memory a block of K3 wide holds beside K1's panels and
    matrix: V, V / |V|, Y V (N each, real and imaginary parts), x, F, the
    injections (n each), the warps' maxima and the claim's cell
    (``csrc/newton_fallback_wide.cuh:wide_lane_bytes``)."""
    return itemsize * (6 * (n // 2 + 1) + 3 * n + 32) + 16


def cluster_rows(n, panel, cluster):
    """Rows of [J | F] a block of the cluster route holds at most: the
    panels of ``panel`` pivot rows dealt round the ``cluster`` blocks."""
    panels = -(-n // panel)
    return panel * -(-panels // cluster)


def cluster_smem_bytes(n, itemsize, panel, cluster):
    """Shared memory of a block of K3 wide's cluster route: its rows of
    [J | F], their column panel, the pivot rows and the diagonal block's
    factors and pivot rows (two of each, by the panel's parity), the
    blocks' maxima, then :func:`wide_lane_bytes`
    (``csrc/newton_fallback_wide.cuh:cluster_smem_bytes``)."""
    R, ld = cluster_rows(n, panel, cluster), n + 1
    return itemsize * (R * ld + panel * R + 2 * panel * ld + 4 * panel * panel + CLUSTER_MAX) + \
        wide_lane_bytes(n, itemsize)


def wide_route(n, dtype, smem_limit):
    """K3 wide's route at n unknowns of ``dtype`` on a card of
    ``smem_limit`` bytes of opt-in shared memory a block: ``(route, panel,
    cluster)``.  ``"smem"`` where :func:`~.linsolve_cuda.k1_route` (the
    lane's vectors counted) keeps the matrix resident, two blocks an SM;
    else ``"cluster"`` at the smallest cluster of :data:`CLUSTER_SIZES`, and
    the widest panel of :data:`CLUSTER_PANELS`, whose blocks hold their rows
    of [J | F]; else ``"blocked"`` at ``k1_route``'s panel (cluster 1).
    Raises where no panel of the blocked route fits.  On an H100: float32 n
    = 94, 126 and float64 n = 94 ``"smem"``; float32 n = 258 (panels of 16)
    and float64 n = 126 (panels of 8) on clusters of 2, float64 n = 258 on
    4; ``"blocked"`` from float32 n = 578 and float64 n = 386."""
    itemsize = dtype.itemsize
    route, panel = k1_route(n, dtype, smem_limit, wide_lane_bytes(n, itemsize))
    if route == "smem":
        return route, panel, 1
    for cluster in CLUSTER_SIZES:
        for bp in CLUSTER_PANELS[itemsize]:
            if cluster_smem_bytes(n, itemsize, bp, cluster) <= smem_limit:
                return "cluster", bp, cluster
    return route, panel, 1


def batch_route(route, lanes, cluster_grid, blocked_grid, blocked_slot_bytes, l2_bytes):
    """K3 wide's route for a batch of ``lanes`` at a size whose shape route
    is ``route`` (:func:`wide_route`).  Where it is ``"cluster"`` and more
    lanes come than the card's ``cluster_grid`` clusters hold at once, the
    lanes wait for clusters and the rate of lanes, not a lane's chain, sets
    the time: there ``"blocked"`` (a block a lane, ``blocked_grid`` blocks
    at once) where their slots, ``blocked_slot_bytes`` each, fit the card's
    ``l2_bytes`` of L2 together, so that [J | F] streams from L2 and not
    from device memory.  Else ``route``.  On an H100: float64 n = 126
    (64 buses) from 67 lanes; float32 n = 258 and float64 n = 258 stay on
    clusters (their slots take 70-213 MB)."""
    if route != "cluster" or lanes <= cluster_grid or blocked_grid * blocked_slot_bytes > l2_bytes:
        return route
    return "blocked"


@functools.cache
def wide_plans(lib, n, dtype, lane_y):
    """K3 wide's launch plans at n unknowns of ``dtype`` on the card of
    ``lib``: ``(route, plans, l2_bytes)``, the shape route by
    :func:`wide_route`, ``plans[r] = (panel, cluster, grid)`` of that route
    and, beside ``"cluster"``, of ``"blocked"`` at
    :func:`~.linsolve_cuda.k1_route`'s panel (:func:`batch_route` picks
    between them, by the card's L2): the largest cooperative grid of each
    kernel the card holds at once, in blocks (clusters on the cluster
    route)."""
    limit = lib.newton_wide_smem_limit()
    route, panel, cluster = wide_route(n, dtype, limit)
    f64 = int(dtype == torch.float64)
    plans = {}
    if route == "cluster":
        plans["cluster"] = (panel, cluster, lib.newton_cluster_grid(f64, n, panel, cluster, int(lane_y)))
        panel = k1_route(n, dtype, limit, wide_lane_bytes(n, dtype.itemsize))[1]
    r = "smem" if route == "smem" else "blocked"
    plans[r] = (panel, 1, lib.newton_wide_grid(f64, n, panel, int(r == "smem"), int(lane_y)))
    for r, (panel, cluster, grid) in plans.items():
        if grid <= 0:
            raise RuntimeError(f"K3 wide has no kernel for n = {n} ({dtype}, route {r}, panel {panel}, cluster "
                               f"{cluster}): CUDA error {-grid}")
    l2_bytes = lib.newton_l2_bytes()
    if l2_bytes <= 0:
        raise RuntimeError(f"K3 wide could not read the card's L2 size: CUDA error {-l2_bytes}")
    return route, plans, l2_bytes



def wide_launch(lib, n, dtype, B, lane_y):
    """K3 wide's launch for B lanes at n unknowns of ``dtype`` on the card of
    ``lib`` (``lane_y``: each lane's Y built in the kernel): ``(route,
    panel, cluster, grid)``, the route by :func:`wide_plans` and
    :func:`batch_route`, the grid the card's capacity or B (blocks, or
    clusters of ``cluster`` blocks: a lane each at once)."""
    route, plans, l2_bytes = wide_plans(lib, n, dtype, lane_y)
    if route == "cluster":
        y_slot = 2 * (n // 2 + 1) ** 2 if lane_y else 0
        route = batch_route(route, B, plans["cluster"][2], plans["blocked"][2],
                            (n * (n + 1) + y_slot) * dtype.itemsize, l2_bytes)
    panel, cluster, cap = plans[route]
    return route, panel, cluster, min(cap, B)

def _lane_vectors(x, F, diff, n_iter, accepted, p, q):
    B, nb = p.shape
    want = ((x, (B, 2 * nb)), (F, (B, 2 * nb)), (diff, (B,)), (n_iter, (B,)), (p, (B, nb)), (q, (B, nb)))
    if accepted is not None:
        want += ((accepted, (B,)),)
    for t, shape in want:
        if tuple(t.shape) != shape:
            raise ValueError(f"newton_fallback_cuda expected a tensor of shape {shape}, got {tuple(t.shape)}")
    if any(t.dtype != p.dtype for t in (x, F, diff, q)):
        raise ValueError("newton_fallback_cuda needs x, F, diff, p and q of one type")
    if n_iter.dtype != torch.int32 or (accepted is not None and accepted.dtype != torch.bool):
        raise ValueError("newton_fallback_cuda needs n_iter as int32 and accepted as bool")
    return [t for t, _ in want]


def k3_arguments(x, F, diff, n_iter, accepted, p, q, ybus):
    """Checks :func:`newton_fallback_cuda`'s arguments and allocates its
    outputs: ``(kind, args, outs)``, the Y source (``"lane_ybus"`` or
    ``"dense"``), the kernel's pointer arguments from ``x`` to ``n_branch``
    and the outputs ``(x, F, diff, n_iter, stall)``.  Raises on anything the
    kernel does not take."""
    device, dtype = p.device, p.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"newton_fallback_cuda takes float32 or float64, got {dtype}")
    if p.dim() != 2:
        raise ValueError(f"expected p [B, n/2], got {tuple(p.shape)}")
    B, nb = p.shape
    N = nb + 1
    lane_vecs = _lane_vectors(x, F, diff, n_iter, accepted, p, q)
    if isinstance(ybus, LaneYbus):
        kind = "lane_ybus"
        floats = (ybus.series_re, ybus.series_im, ybus.shunt_im, ybus.shift_cos, ybus.shift_sin, ybus.tap_magn)
        tables = (ybus.f, ybus.t) + floats
        Ne = ybus.f.shape[0]
        if ybus.n_bus != N or any(tuple(t.shape) != (Ne,) for t in tables[:-1]) or \
                tuple(ybus.tap_magn.shape) != (B, Ne):
            raise ValueError(f"LaneYbus does not match the lanes: {N} buses, taps [{B}, {Ne}]")
        if ybus.f.dtype != torch.int64 or ybus.t.dtype != torch.int64 or any(t.dtype != dtype for t in floats):
            raise ValueError("newton_fallback_cuda needs LaneYbus's f and t as int64 and its tables in the lanes' type")
        if Ne == 0:
            raise ValueError("newton_fallback_cuda needs a network with branches")
    else:
        kind = "dense"
        tables = tuple(ybus)
        if len(tables) != 2 or any(t.dtype != dtype for t in tables):
            raise ValueError("newton_fallback_cuda takes a LaneYbus or a pair (Yre, Yim) in the lanes' type")
        shape = tuple(tables[0].shape)
        if shape not in ((B, N, N), (N, N)) or tuple(tables[1].shape) != shape:
            raise ValueError(f"expected Yre, Yim [{B}, {N}, {N}] or [{N}, {N}], got {shape}")
    if B == 0 or not 1 <= nb <= MAX_N // 2:
        raise ValueError(f"newton_fallback_cuda needs a non-empty batch and 2 <= n <= {MAX_N} (networks of at "
                         f"most {MAX_N // 2 + 1} buses), got B={B}, n={2 * nb}")
    if not all(t.is_cuda and t.device == device for t in lane_vecs + list(tables)):
        raise ValueError("newton_fallback_cuda needs every tensor on one CUDA device")
    if not all(t.is_contiguous() for t in lane_vecs + list(tables)):
        raise ValueError("newton_fallback_cuda needs contiguous tensors")
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    if kind == "dense":
        y_args = (ptr(tables[0]), ptr(tables[1]), N * N if len(shape) == 3 else 0) + (None,) * 8 + (0,)
    else:
        y_args = (None, None, 0) + tuple(ptr(t) for t in tables) + (Ne,)
    args = (ptr(x), ptr(F), ptr(diff), ptr(n_iter), ptr(accepted), ptr(p), ptr(q)) + y_args
    outs = (torch.empty_like(x), torch.empty_like(F), torch.empty_like(diff), torch.empty_like(n_iter),
            torch.empty_like(n_iter))
    return kind, args, outs


def launch(lib, kind, args, outs, B, nb, dtype, device, xtol, lim_iter, stream):
    """One launch of K3 (n <= ``REGS_MAX_N``) or K3 wide on
    :func:`k3_arguments`' ``args`` and ``outs``: the worklist and its
    counters, and K3 wide's slots, allocated on ``device``; returns the
    route that ran (``"regs"``, ``"smem"``, ``"cluster"`` or ``"blocked"``),
    raises on a failed launch (a cluster launch the card refuses included)."""
    f64 = dtype == torch.float64
    # The worklist's length, its next item and the grid barrier's arrivals,
    # then the worklist: one allocation and one fill.
    scratch = torch.zeros(3 + B, dtype=torch.int32, device=device)
    ptrs = tuple(t.data_ptr() for t in outs) + (scratch.data_ptr(), scratch.data_ptr() + 3 * scratch.element_size())
    n = 2 * nb
    if n <= REGS_MAX_N:
        route, panel = "regs", 0
        fn = lib.newton_fallback_f64 if f64 else lib.newton_fallback_f32
        rc = fn(*args, float(xtol), int(lim_iter), *ptrs, B, nb, stream)
    else:
        lane_y = kind == "lane_ybus"
        route, panel, cluster, grid = wide_launch(lib, n, dtype, B, lane_y)
        y_slot = 2 * (nb + 1) ** 2 if lane_y else 0
        if route == "cluster":
            slots = torch.empty(max(grid * cluster * y_slot, 1), dtype=dtype, device=device)
            fn = lib.newton_fallback_cluster_f64 if f64 else lib.newton_fallback_cluster_f32
            rc = fn(*args, float(xtol), int(lim_iter), *ptrs, B, nb, panel, cluster, slots.data_ptr(), y_slot, grid,
                    stream)
        else:
            slot = (0 if route == "smem" else n * (n + 1)) + y_slot
            slots = torch.empty(max(grid * slot, 1), dtype=dtype, device=device)
            fn = lib.newton_fallback_wide_f64 if f64 else lib.newton_fallback_wide_f32
            rc = fn(*args, float(xtol), int(lim_iter), *ptrs, B, nb, panel, int(route == "smem"),
                    slots.data_ptr(), slot, grid, stream)
    if rc != 0:
        raise RuntimeError(f"newton_fallback kernel launch failed with CUDA error {rc} "
                           f"(B={B}, n={n}, {dtype}, {kind}, route {route}, panel {panel})")
    return route


def newton_fallback_cuda(x, F, diff, n_iter, accepted, p, q, ybus, xtol=1e-5, lim_iter=100):
    """The Newton loop of every lane in one launch of the CUDA kernel.

    Takes the loop's start ``x``, ``F`` [B, n], ``diff``, ``n_iter`` [B]
    (int32; the chord's, or zeros), ``accepted`` [B] (bool, or None where no
    lane is) and the injections ``p``, ``q`` [B, n/2], float32 or float64
    contiguous tensors on one CUDA device, and the Y-bus as a
    :class:`~gym_anm_torch.physics.ybus.LaneYbus` on that device (each lane's
    matrix built in the kernel from the branch tables and its taps) or a
    pair ``(Yre, Yim)`` of [B, N, N] or [N, N].  Returns ``(x, F, diff,
    n_iter, stall)`` as :func:`~gym_anm_torch.physics.power_flow._newton_loop`
    returns them, for :func:`~gym_anm_torch.physics.power_flow._nr_result`.
    Launches K3 up to n = ``REGS_MAX_N`` and K3 wide above, on the current
    stream; raises on anything else (n above ``MAX_N``, or a card whose
    shared memory takes no panel of K1's blocked route at n, included) or on
    a failed launch; no route stands in for another.  Adds one to ``newton_fallback_cuda.launch_count`` per
    launch, to ``newton_fallback_cuda.launches["lane_ybus"]`` or
    ``["dense"]`` for the Y source, and to
    ``newton_fallback_cuda.launches_by_route`` for the body that ran:
    ``"regs"`` (K3), ``"smem"``, ``"cluster"`` or ``"blocked"`` (K3 wide,
    [J | F] in a block's shared memory, in a cluster's, or in device
    memory).
    """
    kind, args, outs = k3_arguments(x, F, diff, n_iter, accepted, p, q, ybus)
    from .._build import load_library

    lib = load_library()
    B, nb = p.shape
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        route = launch(lib, kind, args, outs, B, nb, p.dtype, p.device, xtol, lim_iter, stream)
    newton_fallback_cuda.launch_count += 1
    newton_fallback_cuda.launches[kind] += 1
    newton_fallback_cuda.launches_by_route[route] += 1
    return outs


newton_fallback_cuda.launch_count = 0
newton_fallback_cuda.launches = {"lane_ybus": 0, "dense": 0}
newton_fallback_cuda.launches_by_route = {"regs": 0, "smem": 0, "cluster": 0, "blocked": 0}
