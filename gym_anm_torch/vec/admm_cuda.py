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

# Dynamic shared memory a block may take on an H100 (227 KB less the kernel's
# static reduction buffer, rounded down): the lane's 3n + 6m floats.
MAX_SHARED_BYTES = 227 * 1024 - 1024


def shared_bytes(n, m):
    """Dynamic shared memory of one lane's block: x, rhs [n], y, z, Ax, l̄, ū
    [m] and w [n + m], float32."""
    return 4 * (3 * n + 6 * m)


def solve_dcopf_cuda(spec: VecDCOPF, l, u, warm):
    """Every lane's whole ADMM solve in one launch of the CUDA kernel.

    Takes what :func:`~gym_anm_torch.vec.mpc.solve_dcopf_plain` takes, with
    ``warm`` given, as contiguous float32 tensors on one CUDA device with the
    spec's tensors on that device, and returns the same
    :class:`~gym_anm_torch.vec.mpc.DCOPFSolution`.  Launches on the current
    stream without synchronizing and raises on anything else (another dtype,
    device or layout, a shape whose lane does not fit in shared memory) or on
    a failed launch.  Adds one to ``solve_dcopf_cuda.launch_count`` per
    launch.
    """
    x0, y0, z0, Ax0 = warm
    lane = (l, u, x0, y0, z0, Ax0)
    consts = (spec.A_bar, spec.P_pack_T, spec.q_bar, spec.rho, spec.inv_rho, spec.D, spec.D_inv, spec.E, spec.E_inv)
    device = l.device
    if not all(t.is_cuda and t.device == device for t in lane + consts):
        raise ValueError("solve_dcopf_cuda needs the bounds, the warm start and the spec on one CUDA device")
    if any(t.dtype != torch.float32 for t in lane + consts):
        raise ValueError("solve_dcopf_cuda takes float32 tensors (the farm runs on the f32 tier)")
    if not all(t.is_contiguous() for t in lane + consts):
        raise ValueError("solve_dcopf_cuda needs contiguous tensors")
    n, m = spec.n, spec.m
    B = l.shape[0]
    if l.dim() != 2 or any(tuple(t.shape) != (B, m) for t in (l, u, y0, z0, Ax0)) or tuple(x0.shape) != (B, n):
        raise ValueError(f"expected l, u, y, z, Ax [B, {m}] and x [B, {n}], got {[tuple(t.shape) for t in lane]}")
    if tuple(spec.A_bar.shape) != (m, n) or tuple(spec.P_pack_T.shape) != (n, n + m):
        raise ValueError("the spec's matrices do not match its n and m")
    if B == 0 or B >= 2 ** 31:
        raise ValueError(f"solve_dcopf_cuda needs 1 <= B < 2**31 lanes, got {B}")
    if shared_bytes(n, m) > MAX_SHARED_BYTES:
        raise ValueError(f"a lane of n={n}, m={m} needs {shared_bytes(n, m)} bytes of shared memory; K5 holds at "
                         f"most {MAX_SHARED_BYTES} (3n + 6m <= {MAX_SHARED_BYTES // 4} floats)")
    from .._build import load_library

    lib = load_library()
    empty = lambda *shape, dtype=torch.float32: torch.empty(*shape, dtype=dtype, device=device)  # noqa: E731
    x, xw = empty(B, n), empty(B, n)
    yw, zw, Axw = empty(B, m), empty(B, m), empty(B, m)
    iterations = empty(B, dtype=torch.int32)
    r_prim, r_dual = empty(B), empty(B)
    converged, bounds_ok, feasible = (empty(B, dtype=torch.bool) for _ in range(3))
    K = spec.check_every
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.admm_dcopf_f32(
            *(t.data_ptr() for t in consts + lane),
            *(t.data_ptr() for t in (x, xw, yw, zw, Axw, iterations, r_prim, r_dual, converged, bounds_ok, feasible)),
            spec.sigma, spec.alpha, 1.0 - spec.alpha, spec.c_scale_value, spec.q_ref, spec.eps_abs, spec.eps_rel,
            1.0 - 1e-3 * K, spec.dual_plateau_cap, spec.feas_band_factor,
            spec.max_iter, K, -(-spec.dual_stall_limit // K), B, n, m, stream)
    if rc != 0:
        raise RuntimeError(f"admm_dcopf kernel launch failed with CUDA error {rc} (B={B}, n={n}, m={m})")
    solve_dcopf_cuda.launch_count += 1
    return DCOPFSolution(x=x, warm=(xw, yw, zw, Axw), iterations=iterations, r_prim=r_prim, r_dual=r_dual,
                         converged=converged, bounds_ok=bounds_ok, feasible=feasible)


solve_dcopf_cuda.launch_count = 0
