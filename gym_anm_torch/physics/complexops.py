"""Split-complex helpers and the full-precision matmul.

The physics keeps complex quantities as (re, im) pairs of real tensors
instead of complex dtypes, so one code path runs in float32 (throughput)
or float64 (parity), on the CPU or on the card.
"""

import torch


def matmul_full(a, b):
    """``a @ b`` at full float32 precision or better, whatever the global
    TF32 settings are.

    Every product that feeds a convergence test (the load-flow mismatch,
    the bus-injection sums) or shapes a solver's iteration path goes
    through here.  A float32 product on the card may run in TF32 (about
    three decimal digits) when the user has allowed it, which floors the
    residual far above the solver tolerance.  Reading or switching the
    global flags is no way out: PyTorch refuses to read them once the
    legacy and the new precision APIs have both been used.  So a float32
    product is formed in float64 (every f32×f32 product is exact there) and
    rounded back to float32, which TF32 cannot reach.  Float64 inputs
    multiply as they are.
    """
    if a.dtype == torch.float64:
        return torch.matmul(a, b)
    return torch.matmul(a.double(), b.double()).to(a.dtype)


def cdiv(ar, ai, br, bi):
    """(ar+j·ai)/(br+j·bi)."""
    d = br * br + bi * bi
    return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d


def cmatvec(Mre, Mim, vr, vi):
    """Complex matrix-vector product with split storage.

    Shapes: M [..., N, N], v [..., N]; leading axes broadcast.  Runs
    through :func:`matmul_full`.
    """

    def dot(a, b):
        return matmul_full(a, b.unsqueeze(-1)).squeeze(-1)

    re = dot(Mre, vr) - dot(Mim, vi)
    im = dot(Mre, vi) + dot(Mim, vr)
    return re, im
