"""The batched ADMM DC-OPF solve on the card: the wrapper of the CUDA kernel
``csrc/admm_dcopf.cu`` (K5), which replaces the JAX package's on-device solve
``gym_anm_tpu/vec/mpc.py:solve_dcopf`` (an XLA ``while_loop`` under
``vmap``).

Its plain version is :func:`~gym_anm_torch.vec.mpc.solve_dcopf_plain`;
:func:`~gym_anm_torch.vec.mpc.solve_dcopf` picks between the two by the
tensors' device alone.
"""

import torch

from .mpc import DCOPFSolution, VecDCOPF


def frag_count(n, m):
    """Entries (double pairs) of the fragment-ordered copies of Āᵀ [n, m] and
    P_pack [n+m, n]."""
    return 32 * (-(-n // 16) * -(-m // 4) + -(-(n + m) // 16) * -(-n // 4))


def l2_bytes_per_lane_sweep(n, m, staged):
    """Matrix bytes one lane-sweep of K5 reads from L2: ~0 where the kernel
    stages the fragments (once per block; ``admm_scratch_bytes`` is 0), else
    a warp's fragment loads of a sweep (16 bytes a double pair) shared by its
    8 lanes.  PR 5's design read each lane's 4(mn + n(n+m)) bytes."""
    return 0 if staged else 16 * frag_count(n, m) // 8


def solve_dcopf_cuda(spec: VecDCOPF, l, u, warm):
    """Every lane's whole ADMM solve in one launch of the CUDA kernel.

    Takes what :func:`~gym_anm_torch.vec.mpc.solve_dcopf_plain` takes, with
    ``warm`` given, as contiguous float32 tensors on one CUDA device with the
    spec's tensors on that device (its ``A_frag``/``P_frag`` float64, as
    :func:`~gym_anm_torch.vec.mpc.make_vec_dcopf` makes them), and returns
    the same :class:`~gym_anm_torch.vec.mpc.DCOPFSolution`.  Launches on the
    current stream without synchronizing and raises on anything else
    (another dtype, device or layout, a shape whose row constants do not fit
    in the card's shared memory per block) or on a failed launch.  Adds one
    to ``solve_dcopf_cuda.launch_count`` per launch.
    """
    x0, y0, z0, Ax0 = warm
    lane = (l, u, x0, y0, z0, Ax0)
    consts = (spec.q_bar, spec.rho, spec.inv_rho, spec.D, spec.D_inv, spec.E, spec.E_inv)
    frags = (spec.A_frag, spec.P_frag)
    device = l.device
    if any(f is None for f in frags):
        raise ValueError("solve_dcopf_cuda needs the spec's A_frag and P_frag (make_vec_dcopf makes them)")
    if not all(t.is_cuda and t.device == device for t in lane + consts + frags):
        raise ValueError("solve_dcopf_cuda needs the bounds, the warm start and the spec on one CUDA device")
    if any(t.dtype != torch.float32 for t in lane + consts):
        raise ValueError("solve_dcopf_cuda takes float32 tensors (the farm runs on the f32 tier)")
    if any(f.dtype != torch.float64 for f in frags):
        raise ValueError("solve_dcopf_cuda needs the float64 fragment copies A_frag and P_frag")
    if not all(t.is_contiguous() for t in lane + consts + frags):
        raise ValueError("solve_dcopf_cuda needs contiguous tensors")
    n, m = spec.n, spec.m
    B = l.shape[0]
    if l.dim() != 2 or any(tuple(t.shape) != (B, m) for t in (l, u, y0, z0, Ax0)) or tuple(x0.shape) != (B, n):
        raise ValueError(f"expected l, u, y, z, Ax [B, {m}] and x [B, {n}], got {[tuple(t.shape) for t in lane]}")
    if tuple(spec.A_bar.shape) != (m, n) or sum(f.numel() for f in frags) != 2 * frag_count(n, m):
        raise ValueError("the spec's matrices do not match its n and m")
    if B == 0 or B >= 2 ** 31:
        raise ValueError(f"solve_dcopf_cuda needs 1 <= B < 2**31 lanes, got {B}")
    from .._build import load_library

    lib = load_library()
    with torch.cuda.device(device):
        scratch_bytes = lib.admm_scratch_bytes(B, n, m)  # the kernel's layout: 0 where it stages all in shared memory
    if scratch_bytes < 0:
        raise ValueError(f"K5's row constants of n={n}, m={m} do not fit in the card's shared memory per block")
    empty = lambda *shape, dtype=torch.float32: torch.empty(*shape, dtype=dtype, device=device)  # noqa: E731
    x, xw = empty(B, n), empty(B, n)
    yw, zw, Axw = empty(B, m), empty(B, m), empty(B, m)
    iterations = empty(B, dtype=torch.int32)
    r_prim, r_dual = empty(B), empty(B)
    converged, bounds_ok, feasible = (empty(B, dtype=torch.bool) for _ in range(3))
    next_lane = torch.zeros(1, dtype=torch.int32, device=device)  # the kernel's work counter
    # the tiles' state in device memory where the kernel does not stage it, one area per warp
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
    return DCOPFSolution(x=x, warm=(xw, yw, zw, Axw), iterations=iterations, r_prim=r_prim, r_dual=r_dual,
                         converged=converged, bounds_ok=bounds_ok, feasible=feasible)


solve_dcopf_cuda.launch_count = 0
