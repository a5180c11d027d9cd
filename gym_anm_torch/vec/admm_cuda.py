"""The batched ADMM DC-OPF solve on the card: the wrapper of the CUDA kernel
``csrc/admm_dcopf.cu`` (K5), which replaces the JAX package's on-device solve
``gym_anm_tpu/vec/mpc.py:solve_dcopf`` (an XLA ``while_loop`` under
``vmap``).

Its plain version is :func:`~gym_anm_torch.vec.mpc.solve_dcopf_plain`;
:func:`~gym_anm_torch.vec.mpc.solve_dcopf` picks between the two by the
tensors' device alone.
"""

import torch

from .mpc import STREAM_CHUNKS, DCOPFSolution, VecDCOPF


def frag_count(n, m):
    """Entries (double pairs) of the fragment-ordered copies of Āᵀ [n, m] and
    P_pack [n+m, n]."""
    return 32 * (-(-n // 16) * -(-m // 4) + -(-(n + m) // 16) * -(-n // 4))


def _stream_chunks(kc):
    return -(-kc // STREAM_CHUNKS) * STREAM_CHUNKS


def stream_count(n, m):
    """Entries (double pairs) of the streamed route's copies of Āᵀ and
    P_pack (:func:`~gym_anm_torch.vec.mpc.stream_fragments`: the fragments,
    their k-chunks padded with zeros to whole ring stages)."""
    return 32 * (-(-n // 16) * _stream_chunks(-(-m // 4)) + -(-(n + m) // 16) * _stream_chunks(-(-n // 4)))


# The H100's SMs and opt-in shared memory a block: the defaults of the plan below.
H100_SMS, H100_SMEM = 132, 232448
STREAM_LANES = 16  # lanes a consumer warp of the streamed route (two 8-lane B operands)
_STREAM_HEAD, _STREAM_STAGE, _STREAM_MAX_WARPS = 128, 4 * STREAM_CHUNKS * 512, 4


def _staged_fits(n, m, smem_limit):
    """The staged route's test (``admm_dcopf.cu:plan_launch``): both
    fragment copies and two 8-lane warps' state beside the row constants."""
    consts = 4 * (2 * n + 3 * m) + 16
    warp = 32 * (n + 5 * m) + 256 * (-(-m // 4) + -(-n // 4))
    return 16 * frag_count(n, m) + consts + 2 * warp <= smem_limit


def _stream_shared_bytes(n, m, warps, stages):
    consts = -(-4 * (2 * n + 3 * m) // 16) * 16
    return _STREAM_HEAD + stages * _STREAM_STAGE + consts + warps * 256 * (_stream_chunks(-(-m // 4))
                                                                             + _stream_chunks(-(-n // 4)))


def _stream_warps(B, n, m, n_sm, smem_limit):
    """Consumer warps a block of K5's streamed route takes for B lanes of
    (n, m), as ``admm_dcopf.cu:stream_warps`` picks them: the fewest that
    hold B lanes in one wave of resident lanes (a block an SM, 16 lanes a
    warp), at most 4 (one a scheduler of the SM) and those whose B operands
    fit in shared memory with two ring stages.  0 where not even one warp
    fits."""
    fit = 0
    while fit < _STREAM_MAX_WARPS and _stream_shared_bytes(n, m, fit + 1, 2) <= smem_limit:
        fit += 1
    return min(-(-B // (n_sm * STREAM_LANES)), fit)


def stream_lanes(B, n, m, n_sm=H100_SMS, smem_limit=H100_SMEM):
    """The lanes one read of the matrices serves in K5's launch of B lanes of
    (n, m) (the C query ``admm_stream_lanes``): 0 where the fragments are
    staged in shared memory, else the streamed block's 16 W lanes; -1 where
    neither route takes the shape."""
    if _staged_fits(n, m, smem_limit):
        return 0
    W = _stream_warps(B, n, m, n_sm, smem_limit)
    return STREAM_LANES * W if W else -1


def l2_bytes_per_lane_sweep(n, m, block_lanes):
    """Matrix bytes one lane-sweep of K5 reads from L2: 0 where the kernel
    stages the fragments (once per block; ``block_lanes`` 0), else a
    streamed block's one read of both streamed copies a sweep (16 bytes a
    double pair, :func:`stream_count`) shared by its ``block_lanes`` lanes
    (:func:`stream_lanes`).  The tile design's L2 route read the fragments
    (:func:`frag_count`) for a warp's 8 lanes; the one-block-per-lane design
    read each lane's 4(mn + n(n+m)) bytes."""
    return 16 * stream_count(n, m) // block_lanes if block_lanes else 0


def solve_dcopf_cuda(spec: VecDCOPF, l, u, warm):
    """Every lane's whole ADMM solve in one launch of the CUDA kernel.

    Takes what :func:`~gym_anm_torch.vec.mpc.solve_dcopf_plain` takes, with
    ``warm`` given, as contiguous float32 tensors on one CUDA device with the
    spec's tensors on that device (its fragment copies float64, as
    :func:`~gym_anm_torch.vec.mpc.make_vec_dcopf` makes them), and returns
    the same :class:`~gym_anm_torch.vec.mpc.DCOPFSolution`.  Launches on the
    current stream without synchronizing and raises on anything else
    (another dtype, device or layout, a shape whose row constants and one
    warp's B operands do not fit in the card's shared memory per block) or on
    a failed launch.  Adds one to ``solve_dcopf_cuda.launch_count`` and to
    ``launches[route]`` per launch ("staged": the fragments in shared memory;
    "streamed": streamed through it by a producer warp).
    """
    x0, y0, z0, Ax0 = warm
    lane = (l, u, x0, y0, z0, Ax0)
    consts = (spec.q_bar, spec.rho, spec.inv_rho, spec.D, spec.D_inv, spec.E, spec.E_inv)
    copies = (spec.A_frag, spec.P_frag, spec.A_stream, spec.P_stream)
    device = l.device
    if any(f is None for f in copies):
        raise ValueError("solve_dcopf_cuda needs the spec's A_frag, P_frag, A_stream and P_stream "
                         "(make_vec_dcopf makes them)")
    if not all(t.is_cuda and t.device == device for t in lane + consts + copies):
        raise ValueError("solve_dcopf_cuda needs the bounds, the warm start and the spec on one CUDA device")
    if any(t.dtype != torch.float32 for t in lane + consts):
        raise ValueError("solve_dcopf_cuda takes float32 tensors (the farm runs on the f32 tier)")
    if any(f.dtype != torch.float64 for f in copies):
        raise ValueError("solve_dcopf_cuda needs the float64 fragment copies A_frag, P_frag, A_stream and P_stream")
    if not all(t.is_contiguous() for t in lane + consts + copies):
        raise ValueError("solve_dcopf_cuda needs contiguous tensors")
    n, m = spec.n, spec.m
    B = l.shape[0]
    if l.dim() != 2 or any(tuple(t.shape) != (B, m) for t in (l, u, y0, z0, Ax0)) or tuple(x0.shape) != (B, n):
        raise ValueError(f"expected l, u, y, z, Ax [B, {m}] and x [B, {n}], got {[tuple(t.shape) for t in lane]}")
    if (tuple(spec.A_bar.shape) != (m, n) or copies[0].numel() + copies[1].numel() != 2 * frag_count(n, m)
            or copies[2].numel() + copies[3].numel() != 2 * stream_count(n, m)):
        raise ValueError("the spec's matrices do not match its n and m")
    if B == 0 or B >= 2 ** 31:
        raise ValueError(f"solve_dcopf_cuda needs 1 <= B < 2**31 lanes, got {B}")
    from .._build import load_library

    lib = load_library()
    with torch.cuda.device(device):
        scratch_bytes = lib.admm_scratch_bytes(B, n, m)  # the kernel's layout: 0 where it stages all in shared memory
    if scratch_bytes < 0:
        raise ValueError(f"K5's row constants and one warp's operands of n={n}, m={m} do not fit in the card's "
                         "shared memory per block")
    route = "streamed" if scratch_bytes else "staged"
    frags = copies[2:] if scratch_bytes else copies[:2]
    empty = lambda *shape, dtype=torch.float32: torch.empty(*shape, dtype=dtype, device=device)  # noqa: E731
    x, xw = empty(B, n), empty(B, n)
    yw, zw, Axw = empty(B, m), empty(B, m), empty(B, m)
    iterations = empty(B, dtype=torch.int32)
    r_prim, r_dual = empty(B), empty(B)
    converged, bounds_ok, feasible = (empty(B, dtype=torch.bool) for _ in range(3))
    next_lane = torch.zeros(1, dtype=torch.int32, device=device)  # the kernel's work counter
    # the streamed route's lane state, one area per resident consumer warp
    scratch = torch.empty(scratch_bytes, dtype=torch.uint8, device=device) if scratch_bytes else None
    K = spec.check_every
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.admm_dcopf_f32(
            *(t.data_ptr() for t in frags + consts + lane),
            *(t.data_ptr() for t in (x, xw, yw, zw, Axw, iterations, r_prim, r_dual, converged, bounds_ok, feasible,
                                     next_lane)), None if scratch is None else scratch.data_ptr(),
            spec.sigma, spec.alpha, 1.0 - spec.alpha, spec.c_scale_value, spec.q_ref, spec.eps_abs, spec.eps_rel,
            1.0 - 1e-3 * K, spec.dual_plateau_cap, spec.feas_band_factor,
            spec.max_iter, K, -(-spec.dual_stall_limit // K), B, n, m, stream)
    if rc != 0:
        raise RuntimeError(f"admm_dcopf kernel launch failed with CUDA error {rc} (B={B}, n={n}, m={m})")
    solve_dcopf_cuda.launch_count += 1
    solve_dcopf_cuda.launches[route] += 1
    return DCOPFSolution(x=x, warm=(xw, yw, zw, Axw), iterations=iterations, r_prim=r_prim, r_dual=r_dual,
                         converged=converged, bounds_ok=bounds_ok, feasible=feasible)


solve_dcopf_cuda.launch_count = 0
solve_dcopf_cuda.launches = {"staged": 0, "streamed": 0}
