"""The exact-Newton fallback on the card: the wrapper of the CUDA kernel
``csrc/newton_fallback.cu``, which runs the whole Newton loop of every lane
that still iterates in one launch: a triage pass over every lane, then the
lanes that iterate taken from a device worklist.  K3 (n <= 64, networks of
up to 33 buses) spreads each lane's Gauss-Jordan sweeps over a group of
threads that holds the system in registers; K3 wide (n above 64) runs a
lane a block, its [J | F] in shared memory or in the block's slot of
device memory, eliminated by K1's panel body.  It replaces the reference's
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


def wide_lane_bytes(n, itemsize):
    """Shared memory a block of K3 wide holds beside K1's panels and
    matrix: V, V / |V|, Y V (N each, real and imaginary parts), x, F, the
    injections (n each), the warps' maxima and the claim's cell
    (``csrc/newton_fallback_wide.cuh:wide_lane_bytes``)."""
    return itemsize * (6 * (n // 2 + 1) + 3 * n + 32) + 16


@functools.cache
def wide_plan(lib, n, dtype, lane_y):
    """K3 wide's route at n unknowns of ``dtype`` on the card of ``lib``:
    ``(route, panel, blocks)``, route ``"smem"`` or ``"blocked"`` by
    :func:`~.linsolve_cuda.k1_route` with the lane's vectors counted, and
    the blocks of that kernel the card holds at once (the largest
    cooperative grid, one slot each)."""
    route, panel = k1_route(n, dtype, lib.newton_wide_smem_limit(), wide_lane_bytes(n, dtype.itemsize))
    blocks = lib.newton_wide_grid(int(dtype == torch.float64), n, panel, int(route == "smem"), int(lane_y))
    if blocks <= 0:
        raise RuntimeError(f"K3 wide has no kernel for n = {n} ({dtype}, route {route}, panel {panel}): "
                           f"CUDA error {-blocks}")
    return route, panel, blocks


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
    route that ran (``"regs"``, ``"smem"`` or ``"blocked"``), raises on a
    failed launch."""
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
        route, panel, blocks = wide_plan(lib, n, dtype, lane_y)
        grid = min(blocks, B)
        slot = (0 if route == "smem" else n * (n + 1)) + (2 * (nb + 1) ** 2 if lane_y else 0)
        slots = torch.empty(max(grid * slot, 1), dtype=dtype, device=device)
        fn = lib.newton_fallback_wide_f64 if f64 else lib.newton_fallback_wide_f32
        rc = fn(*args, float(xtol), int(lim_iter), *ptrs, B, nb, panel, int(route == "smem"), slots.data_ptr(),
                slot, grid, stream)
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
    a failed launch.  Adds one to ``newton_fallback_cuda.launch_count`` per
    launch, to ``newton_fallback_cuda.launches["lane_ybus"]`` or
    ``["dense"]`` for the Y source, and to
    ``newton_fallback_cuda.launches_by_route`` for the body that ran:
    ``"regs"`` (K3), ``"smem"`` or ``"blocked"`` (K3 wide, [J | F] in shared
    or device memory).
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
newton_fallback_cuda.launches_by_route = {"regs": 0, "smem": 0, "blocked": 0}
