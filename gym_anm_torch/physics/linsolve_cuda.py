"""Batched dense solve for many tiny systems: the CUDA kernel and its plain
version.

The Newton-Raphson fallback solves B independent n×n systems per iteration
(n = 2·(N_bus−1), 64 for IEEE33).  :func:`solve_gauss_jordan` is the plain
PyTorch version (the CPU path and the oracle); :func:`solve_gauss_jordan_cuda`
launches the hand-written kernel ``csrc/gauss_jordan.cu``, which replaces the
TPU kernel ``gym_anm_tpu/physics/linsolve_pallas.py:solve_gauss_jordan_pallas``.
:func:`batched_solve` picks between them by the tensor's device alone.
"""

import torch

# Largest n of the float32 path that keeps each system in one warp's
# registers; float64 and larger n take the shared-memory path, and a system
# whose matrix does not fit in a block's shared memory the path with the
# matrix in device memory.
REG_MAX_N = 64


def smem_bytes(n, itemsize):
    """Shared memory of the shared-memory path's block: the augmented [n, n+1]
    matrix, the pivot row and the factors."""
    return itemsize * (n * (n + 1) + 2 * n + 1)


def solve_gauss_jordan(A, b):
    """Solve A x = b by unpivoted Gauss-Jordan elimination, batched over
    leading axes (A [..., n, n], b [..., n]).

    Power-flow Jacobians near the NR iterates are strongly diagonally
    dominant, so unpivoted elimination is numerically safe here.  A zero
    pivot yields inf/NaN, which the Newton loop reads as divergence, matching
    scipy's behavior on singular systems.  The pivot row's factor is zeroed
    by a multiply, so a non-finite factor stays non-finite.
    """
    n = A.shape[-1]
    M = torch.cat([A, b.unsqueeze(-1)], dim=-1)  # [..., n, n+1]
    rows = torch.arange(n, device=A.device)
    for k in range(n):
        pivot_row = M[..., k, :]                        # [..., n+1]
        pivot = M[..., k, k]                            # [...]
        factor = M[..., :, k] / pivot.unsqueeze(-1)     # [..., n]
        mask = (rows != k).to(M.dtype)                  # zero own row
        update = (factor * mask).unsqueeze(-1) * pivot_row.unsqueeze(-2)
        M = M - update
    diag = torch.diagonal(M[..., :, :n], dim1=-2, dim2=-1)
    return M[..., -1] / diag


def solve_gauss_jordan_cuda(A, b):
    """Solve A x = b for A [B, n, n], b [B, n] with the CUDA kernel.

    Takes contiguous float32 or float64 tensors on one CUDA device, launches
    on the current stream, and raises on anything else or on a failed
    launch.  Float32 at n <= ``REG_MAX_N`` runs with each system in one
    warp's registers, float64 and larger n with each system in a block's
    shared memory, and a system too large for the card's shared memory per
    block (n > 239 in float32, n > 168 in float64 on an H100) in a scratch
    buffer [B, n, n+1] in device memory.  Adds one to
    ``solve_gauss_jordan_cuda.launch_count`` per launch, and to
    ``solve_gauss_jordan_cuda.launches[path]`` for the path that ran
    (``"regs"``, ``"smem"``, ``"gmem"``).
    """
    if not (A.is_cuda and b.is_cuda) or A.device != b.device:
        raise ValueError(f"solve_gauss_jordan_cuda needs both tensors on one CUDA device, "
                         f"got {A.device} and {b.device}")
    if A.dtype != b.dtype or A.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"solve_gauss_jordan_cuda takes float32 or float64, got {A.dtype} and {b.dtype}")
    if A.dim() != 3 or A.shape[1] != A.shape[2] or tuple(b.shape) != tuple(A.shape[:2]):
        raise ValueError(f"expected A [B, n, n] and b [B, n], got {tuple(A.shape)} and {tuple(b.shape)}")
    if not (A.is_contiguous() and b.is_contiguous()):
        raise ValueError("solve_gauss_jordan_cuda needs contiguous tensors")
    B, n = b.shape
    if B == 0 or n == 0:
        raise ValueError("solve_gauss_jordan_cuda needs a non-empty batch and system")
    from .._build import load_library

    lib = load_library()
    f64 = A.dtype == torch.float64
    x = torch.empty_like(b)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        if not f64 and n <= REG_MAX_N:
            path, rc = "regs", lib.gj_solve_f32_regs(A.data_ptr(), b.data_ptr(), x.data_ptr(), B, n, stream)
        elif smem_bytes(n, A.element_size()) <= lib.gj_smem_limit_bytes():
            fn = lib.gj_solve_f64 if f64 else lib.gj_solve_f32
            path, rc = "smem", fn(A.data_ptr(), b.data_ptr(), x.data_ptr(), B, n, stream)
        else:
            scratch = torch.empty(B, n, n + 1, dtype=A.dtype, device=A.device)
            fn = lib.gj_solve_f64_gmem if f64 else lib.gj_solve_f32_gmem
            path, rc = "gmem", fn(A.data_ptr(), b.data_ptr(), x.data_ptr(), scratch.data_ptr(), B, n, stream)
    if rc != 0:
        raise RuntimeError(f"gauss_jordan kernel launch failed with CUDA error {rc} (B={B}, n={n}, {A.dtype})")
    solve_gauss_jordan_cuda.launch_count += 1
    solve_gauss_jordan_cuda.launches[path] += 1
    return x


solve_gauss_jordan_cuda.launch_count = 0
solve_gauss_jordan_cuda.launches = {"regs": 0, "smem": 0, "gmem": 0}


def batched_solve(J, F):
    """The NR linear solve J·Δx = F over leading batch axes: the plain
    version for a CPU tensor, the CUDA kernel for a CUDA tensor (no
    fallback between them)."""
    if not J.is_cuda:
        return solve_gauss_jordan(J, F)
    n = J.shape[-1]
    lead = J.shape[:-2]
    x = solve_gauss_jordan_cuda(J.reshape(-1, n, n).contiguous(), F.reshape(-1, n).contiguous())
    return x.reshape(*lead, n)
