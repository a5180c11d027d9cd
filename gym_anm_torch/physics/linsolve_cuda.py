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

# The routes of the kernel (csrc/gauss_jordan.cu), chosen by k1_route:
# "regs", each row of a system in one thread's registers, up to REG_MAX_N;
# "smem", blocked Gauss-Jordan with the matrix resident in a block's shared
# memory, in panels of the width of RESIDENT_PANELS that fits the most
# blocks an SM (by shared memory, and by the registers the kernels are
# compiled for, RESIDENT_REG_BLOCKS; the wider on a tie), taken while two
# such blocks fit an SM; "blocked", the same with the matrix in a device
# scratch buffer, read and written once a panel, in panels of the first
# width of BLOCKED_PANELS that fits.  A resident block alone on an SM leaves
# it idle in each panel's serial steps, where the blocked route runs two or
# more blocks an SM from L2 (gym_anm_torch/bench/kernel_probes.py:
# probe_route_edges), hence the two blocks.
REG_MAX_N = 64
RESIDENT_PANELS = (16, 8)
RESIDENT_REG_BLOCKS = {4: 4, 8: 3}  # by the element's bytes: csrc/gauss_jordan.cuh:kPanMinBlocks
BLOCKED_PANELS = {4: (32, 16, 8), 8: (16, 8)}
H100_SMEM_OPTIN = 232448  # bytes of opt-in shared memory a block on an H100
BLOCK_RESERVED = 1024  # bytes an SM reserves for each resident block; it has the opt-in amount plus one of these


def panel_smem_bytes(n, itemsize, panel, resident):
    """Shared memory of a block of the panel routes: the column panel
    [panel, n rounded up to 4], the pivot-row panel [panel, n+1], the
    diagonal block's factors and pivot rows [panel, panel] each, and on the
    resident route the augmented matrix [n, n+1]."""
    ldn = (n + 3) // 4 * 4
    return itemsize * (panel * (ldn + n + 1) + 2 * panel * panel + (n * (n + 1) if resident else 0))


def blocks_per_sm(nbytes, smem_limit):
    """How many blocks of ``nbytes`` of shared memory fit one SM of a card
    whose opt-in limit a block is ``smem_limit``."""
    return (smem_limit + BLOCK_RESERVED) // (nbytes + BLOCK_RESERVED)


def k1_route(n, dtype, smem_limit, extra=0):
    """The route and panel width of an n×n system of ``dtype`` on a card with
    ``smem_limit`` bytes of opt-in shared memory a block: ``("regs", 0)``,
    ``("smem", panel)`` or ``("blocked", panel)``; raises where no panel of
    the blocked route fits.  ``extra``: bytes a block needs beside the
    panels and the matrix (the wide Newton kernel's lane vectors,
    ``newton_cuda.wide_lane_bytes``; 0 for K1).  On an H100 K1 runs both
    types in registers to n = 64; float32 resident to n = 161 and float64 to
    111, and blocked above."""
    itemsize = dtype.itemsize
    if n <= REG_MAX_N:
        return "regs", 0
    blocks, panel = max((min(blocks_per_sm(panel_smem_bytes(n, itemsize, bp, True) + extra, smem_limit),
                             RESIDENT_REG_BLOCKS[itemsize]), bp) for bp in RESIDENT_PANELS)
    if blocks >= 2:
        return "smem", panel
    for panel in BLOCKED_PANELS[itemsize]:
        if panel_smem_bytes(n, itemsize, panel, False) + extra <= smem_limit:
            return "blocked", panel
    raise ValueError(f"n = {n} ({dtype}) is too large for the blocked route's panels in {smem_limit} bytes")


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
    launch.  :func:`k1_route` picks the route by n, the type and the card's
    shared memory alone: each system in one or two warps' registers (n <=
    64), blocked Gauss-Jordan with the matrix resident in a block's shared
    memory (on an H100 to n = 161 in float32, 111 in float64), or blocked
    Gauss-Jordan on a scratch buffer [B, n, n+1] in device memory above.  No route stands in for another.  Adds one to
    ``solve_gauss_jordan_cuda.launch_count`` per launch, and to
    ``solve_gauss_jordan_cuda.launches[route]`` for the route that ran
    (``"regs"``, ``"smem"``, ``"blocked"``).
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
    route, panel = k1_route(n, A.dtype, lib.gj_smem_limit_bytes())
    x = torch.empty_like(b)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        if route == "regs":
            fn = lib.gj_solve_f64_regs if f64 else lib.gj_solve_f32_regs
            rc = fn(A.data_ptr(), b.data_ptr(), x.data_ptr(), B, n, stream)
        elif route == "smem":
            fn = lib.gj_solve_f64_resident if f64 else lib.gj_solve_f32_resident
            rc = fn(A.data_ptr(), b.data_ptr(), x.data_ptr(), B, n, panel, stream)
        else:
            scratch = torch.empty(B, n, n + 1, dtype=A.dtype, device=A.device)
            fn = lib.gj_solve_f64_blocked if f64 else lib.gj_solve_f32_blocked
            rc = fn(A.data_ptr(), b.data_ptr(), x.data_ptr(), scratch.data_ptr(), B, n, panel, stream)
    if rc != 0:
        raise RuntimeError(f"gauss_jordan kernel launch failed with CUDA error {rc} "
                           f"(B={B}, n={n}, {A.dtype}, route {route}, panel {panel})")
    solve_gauss_jordan_cuda.launch_count += 1
    solve_gauss_jordan_cuda.launches[route] += 1
    return x


solve_gauss_jordan_cuda.launch_count = 0
solve_gauss_jordan_cuda.launches = {"regs": 0, "smem": 0, "blocked": 0}


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
