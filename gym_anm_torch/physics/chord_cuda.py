"""The fused chord-Newton solve on the card: the wrapper of the CUDA kernels
``csrc/chord_newton.cu`` (n <= 32) and ``csrc/chord_newton_wide.cu``
(33 <= n <= 512, the constants streamed through shared memory), both lane
tiles on the FP64 tensor cores, which
replace the TPU kernel ``scripts/chord_pallas_prototype.py:kernel``
(``chord_pallas``).

Its plain version is :func:`~gym_anm_torch.physics.power_flow.chord_solve_plain`;
:func:`~gym_anm_torch.physics.power_flow.chord_solve` picks between the two by
the tensors' device alone.
"""

import numpy as np
import torch

# Largest n = N_bus − 1 of the tile kernel (one warp thread per non-slack
# bus: IEEE33, n = 32, and ANM6, n = 5) and of the wide kernel (up to 16
# buses per thread of a lane's warp: networks up to 513 buses).
TILE_MAX_N = 32
MAX_N = 512


def chord_solve_cuda(p, q, w_a, w_b, dtf_re, dtf_im, ct, xtol=1e-5, lim_iter=48,
                     stall_tol_factor=10.0, x0=None):
    """The whole chord phase of every lane in one launch of the CUDA kernel.

    Takes what :func:`~gym_anm_torch.physics.power_flow.chord_solve_plain`
    takes, as contiguous float32 tensors on one CUDA device with ``ct`` a
    :class:`~gym_anm_torch.physics.power_flow.ChordTensors` on that device,
    and returns the same ``(x, F, diff, n_iter, accepted)``.  Picks the tile
    kernel at n <= ``TILE_MAX_N`` and the wide kernel above, by n alone.
    Launches on the current stream and raises on anything else (n above
    ``MAX_N`` included) or on a failed launch.  Adds one to
    ``chord_solve_cuda.launch_count`` per launch, and to
    ``chord_solve_cuda.launches["tile"]`` or ``["wide"]`` for the kernel that
    ran.
    """
    lane_vecs = (p, q, w_a, w_b, dtf_re, dtf_im) + (() if x0 is None else (x0,))
    consts = (ct.W_pack, ct.invJ0_T, ct.H_T, ct.g_col0, ct.g_col1, ct.c, ct.e_t, ct.rs_re, ct.rs_im)
    device = p.device
    if not all(t.is_cuda and t.device == device for t in lane_vecs + consts):
        raise ValueError("chord_solve_cuda needs every tensor and the chord constants on one CUDA device")
    if any(t.dtype != torch.float32 for t in lane_vecs + consts[3:]):
        raise ValueError("chord_solve_cuda takes float32 lane data and constants (the chord runs on the f32 tier)")
    if any(t.dtype != torch.float64 for t in consts[:3]):
        raise ValueError("chord_solve_cuda needs the float64 copies W_pack, invJ0_T and H_T of ChordTensors")
    if not all(t.is_contiguous() for t in lane_vecs + consts):
        raise ValueError("chord_solve_cuda needs contiguous tensors")
    n = ct.n
    B = p.shape[0]
    if p.dim() != 2 or tuple(p.shape) != (B, n) or tuple(q.shape) != (B, n):
        raise ValueError(f"expected p, q [B, {n}], got {tuple(p.shape)} and {tuple(q.shape)}")
    if any(tuple(t.shape) != (B,) for t in (w_a, w_b, dtf_re, dtf_im)):
        raise ValueError(f"expected w_a, w_b, dtf_re, dtf_im [{B}]")
    if x0 is not None and tuple(x0.shape) != (B, 2 * n):
        raise ValueError(f"expected x0 [{B}, {2 * n}], got {tuple(x0.shape)}")
    if tuple(ct.W_pack.shape) != (n + 1, 2 * n + 2) or tuple(ct.invJ0_T.shape) != (2 * n, 2 * n):
        raise ValueError("chord constants do not match n")
    if B == 0 or not 1 <= n <= MAX_N:
        raise ValueError(f"chord_solve_cuda needs a non-empty batch and 1 <= n <= {MAX_N} (networks of at most "
                         f"{MAX_N + 1} buses), got B={B}, n={n}")
    from .._build import load_library

    lib = load_library()
    x = torch.empty(B, 2 * n, dtype=torch.float32, device=device)
    F = torch.empty_like(x)
    diff = torch.empty(B, dtype=torch.float32, device=device)
    n_iter = torch.empty(B, dtype=torch.int32, device=device)
    accepted = torch.empty(B, dtype=torch.bool, device=device)
    va, vb = float(ct.vstar_re), float(ct.vstar_im)
    args = (p.data_ptr(), q.data_ptr(), w_a.data_ptr(), w_b.data_ptr(), dtf_re.data_ptr(), dtf_im.data_ptr(),
            None if x0 is None else x0.data_ptr(), *(t.data_ptr() for t in consts),
            va, vb, 1.0 / float(np.hypot(va, vb)), xtol, stall_tol_factor * xtol, 100.0 * xtol, int(lim_iter),
            x.data_ptr(), F.data_ptr(), diff.data_ptr(), n_iter.data_ptr(), accepted.data_ptr())
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        next_lane = torch.zeros(1, dtype=torch.int32, device=device)  # the kernels' work counter
        if n <= TILE_MAX_N:
            kind = "tile"
            rc = lib.chord_newton_f32(*args, next_lane.data_ptr(), B, n, stream)
        else:
            kind = "wide"
            W32, J32 = ct.W_pack_f32, ct.invJ0_T_f32  # the float32 copies it streams
            if not all(t is not None and t.is_cuda and t.device == device and t.dtype == torch.float32
                       and t.is_contiguous() for t in (W32, J32)):
                raise ValueError("the wide chord kernel needs ChordTensors.W_pack_f32 and invJ0_T_f32 on the device")
            wide_args = list(args)
            wide_args[7], wide_args[8] = W32.data_ptr(), J32.data_ptr()
            scratch = torch.empty(B, 4 * n, dtype=torch.float32, device=device)  # each lane's previous f and g
            rc = lib.chord_newton_wide_f32(*wide_args, next_lane.data_ptr(), scratch.data_ptr(), B, n,
                                           W32.shape[1], J32.shape[1], stream)
    if rc != 0:
        raise RuntimeError(f"chord_newton ({kind}) kernel launch failed with CUDA error {rc} (B={B}, n={n})")
    chord_solve_cuda.launch_count += 1
    chord_solve_cuda.launches[kind] += 1
    return x, F, diff, n_iter, accepted


chord_solve_cuda.launch_count = 0
chord_solve_cuda.launches = {"tile": 0, "wide": 0}
