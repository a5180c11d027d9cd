"""K1's blocked route (``csrc/gauss_jordan.cu:gj_blocked``) in plain torch.

The kernel for systems above a block's shared memory eliminates a panel of
BP pivots on the column panel and the pivot-row panel alone, then updates
every entry of the matrix once with the panel's BP rank-1 updates in pivot
order.  ``blocked_gauss_jordan`` below does the same, op for op, on the CPU:
it is bitwise equal to the plain version ``solve_gauss_jordan`` at float32
and float64, so blocking keeps every entry's operations and their order, and
zero pivots and non-finite entries stay non-finite."""

import numpy as np
import pytest
import torch

from gym_anm_torch.physics.linsolve_cuda import solve_gauss_jordan

torch.set_num_threads(2)


def blocked_gauss_jordan(A, b, bp):
    """Blocked Gauss-Jordan in the kernel's order: for each panel of ``bp``
    pivots, the panel sweeps (the column panel's columns right of the pivot,
    the pivot-row panel's rows below it), then the trailing update of every
    entry, or of the diagonal and column n alone in the last panel."""
    B, n = b.shape
    M = torch.cat([A, b.unsqueeze(-1)], dim=-1).clone()
    rows = torch.arange(n)
    for k0 in range(0, n, bp):
        bw = min(bp, n - k0)
        fp = M[:, :, k0:k0 + bw].clone()   # column panel [B, n, bw]
        pr = M[:, k0:k0 + bw, :].clone()   # pivot-row panel [B, bw, n+1]
        for kk in range(bw):
            k = k0 + kk
            f = fp[:, :, kk] / pr[:, kk, k].unsqueeze(-1) * (rows != k).to(M.dtype)
            fp[:, :, kk] = f
            fp[:, :, kk + 1:] = fp[:, :, kk + 1:] - f.unsqueeze(-1) * pr[:, kk, k0 + kk + 1:k0 + bw].unsqueeze(-2)
            fr = f[:, k0 + kk + 1:k0 + bw]
            pr[:, kk + 1:, :] = pr[:, kk + 1:, :] - fr.unsqueeze(-1) * pr[:, kk, :].unsqueeze(-2)
        if k0 + bw < n:
            for kk in range(bw):
                M = M - fp[:, :, kk].unsqueeze(-1) * pr[:, kk, :].unsqueeze(-2)
        else:
            d = torch.diagonal(M[:, :, :n], dim1=-2, dim2=-1)
            r = M[:, :, n]
            for kk in range(bw):
                f = fp[:, :, kk]
                d = d - f * pr[:, kk, :n]
                r = r - f * pr[:, kk, n].unsqueeze(-1)
            return r / d


def _systems(n, dtype, seed):
    """Diagonally dominant systems; lane 1 has a zero first pivot, lane 2 an
    inf entry."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((5, n, n)) + n * np.eye(n)
    b = rng.standard_normal((5, n))
    A[1, 0, 0] = 0.0
    A[2, n // 2, 3] = np.inf
    return torch.as_tensor(A.astype(dtype)), torch.as_tensor(b.astype(dtype))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,bp", [(66, 32), (66, 16), (258, 32), (258, 16)])
def test_blocked_order_is_bitwise_the_plain_version(dtype, n, bp):
    """n = 66 and 258 leave a last panel of 2 pivots at BP = 32 and at BP =
    16: BP need not divide n."""
    A, b = _systems(n, dtype, seed=n + bp)
    xb = blocked_gauss_jordan(A, b, bp)
    xp = solve_gauss_jordan(A, b)
    assert not torch.isfinite(xb[1]).all() and not torch.isfinite(xb[2]).all()
    assert torch.equal(torch.isfinite(xb), torch.isfinite(xp))
    keep = torch.tensor([True, False, False, True, True])
    assert torch.isfinite(xp[keep]).all()
    assert torch.equal(xb[keep], xp[keep])
    # NaN where the plain version has NaN, the same inf where it has inf.
    assert torch.equal(torch.isnan(xb), torch.isnan(xp))
    assert torch.equal(xb[torch.isinf(xp)], xp[torch.isinf(xp)])
