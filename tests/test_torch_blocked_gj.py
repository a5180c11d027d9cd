"""K1's panel routes (``csrc/gauss_jordan.cu:gj_panels``) in plain torch.

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

from gym_anm_torch.physics.linsolve_cuda import (BLOCKED_PANELS, H100_SMEM_OPTIN, RESIDENT_PANELS, RESIDENT_REG_BLOCKS,
                                                 blocks_per_sm, k1_route, panel_smem_bytes, solve_gauss_jordan)

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


def panel_gauss_jordan(A, b, bp):
    """The order of the panel routes (``csrc/gauss_jordan.cu:gj_panels``,
    the matrix resident in shared memory or in device memory): for each
    panel of ``bp`` pivots, (1) the diagonal block's sweeps in the pivot-row
    panel's view, which give the factors F[k, r] of the block's rows and its
    pivot rows D[k] as they stand at their sweep; (2) every row of the column
    panel from D and every column of the pivot-row panel from F; (3) the
    trailing update of ``blocked_gauss_jordan``."""
    B, n = b.shape
    M = torch.cat([A, b.unsqueeze(-1)], dim=-1).clone()
    rows = torch.arange(n)
    one = torch.ones((), dtype=M.dtype)
    for k0 in range(0, n, bp):
        bw = min(bp, n - k0)
        fp = M[:, :, k0:k0 + bw].clone()   # column panel [B, n, bw]
        pr = M[:, k0:k0 + bw, :].clone()   # pivot-row panel [B, bw, n+1]
        d = pr[:, :, k0:k0 + bw].clone()   # the diagonal block, row view [B, bw, bw]
        F = torch.zeros(B, bw, bw, dtype=M.dtype)
        D = torch.zeros(B, bw, bw, dtype=M.dtype)
        for kk in range(bw):
            D[:, kk] = d[:, kk]
            f = d[:, kk + 1:, kk] / d[:, kk, kk].unsqueeze(-1) * one
            F[:, kk, kk + 1:] = f
            d[:, kk + 1:] = d[:, kk + 1:] - f.unsqueeze(-1) * d[:, kk].unsqueeze(-2)
        for kk in range(bw):
            f = fp[:, :, kk] / D[:, kk, kk].unsqueeze(-1) * (rows != k0 + kk).to(M.dtype)
            fp[:, :, kk] = f
            fp[:, :, kk + 1:] = fp[:, :, kk + 1:] - f.unsqueeze(-1) * D[:, kk, kk + 1:].unsqueeze(-2)
            pr[:, kk + 1:] = pr[:, kk + 1:] - F[:, kk, kk + 1:].unsqueeze(-1) * pr[:, kk].unsqueeze(-2)
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


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,bp", [(94, 32), (126, 32), (94, 16), (126, 16), (258, 32), (258, 8)])
def test_panel_order_is_bitwise_the_plain_version(dtype, n, bp):
    """The panel routes' order (the diagonal block factored on its own, the
    panels' rows and columns each from it) at the resident route's sizes
    (n = 94, 126) and the blocked route's (n = 258): bitwise the plain
    version, zero-pivot and inf lanes non-finite as it has them.  No n here
    is a multiple of its panel width."""
    A, b = _systems(n, dtype, seed=n + bp + 1)
    xb = panel_gauss_jordan(A, b, bp)
    xp = solve_gauss_jordan(A, b)
    assert not torch.isfinite(xb[1]).all() and not torch.isfinite(xb[2]).all()
    assert torch.equal(torch.isfinite(xb), torch.isfinite(xp))
    keep = torch.tensor([True, False, False, True, True])
    assert torch.isfinite(xp[keep]).all()
    assert torch.equal(xb[keep], xp[keep])
    assert torch.equal(torch.isnan(xb), torch.isnan(xp))
    assert torch.equal(xb[torch.isinf(xp)], xp[torch.isinf(xp)])


@pytest.mark.parametrize("dtype,n,route,panel", [
    (torch.float32, 64, "regs", 0), (torch.float32, 65, "smem", 16), (torch.float32, 94, "smem", 16),
    (torch.float32, 126, "smem", 8), (torch.float32, 161, "smem", 8), (torch.float32, 162, "blocked", 32),
    (torch.float32, 876, "blocked", 16),
    (torch.float64, 64, "regs", 0), (torch.float64, 65, "smem", 16), (torch.float64, 110, "smem", 8),
    (torch.float64, 111, "smem", 8), (torch.float64, 112, "blocked", 16), (torch.float64, 892, "blocked", 8)])
def test_route_by_size_and_type_on_an_h100(dtype, n, route, panel):
    """The route function at an H100's 232,448 bytes of shared memory a
    block: the register route to n = 64; the resident route while two of
    its blocks fit an SM, its panel the width that fits the most blocks (by
    shared memory and by the registers the kernels are built for; the wider
    on a tie); the blocked route above with the first width that fits."""
    assert k1_route(n, dtype, H100_SMEM_OPTIN) == (route, panel)
    itemsize = dtype.itemsize

    def blocks(bp):
        return min(blocks_per_sm(panel_smem_bytes(n, itemsize, bp, True), H100_SMEM_OPTIN),
                   RESIDENT_REG_BLOCKS[itemsize])

    if route == "smem":
        assert blocks(panel) >= 2 and all(blocks(bp) <= blocks(panel) for bp in RESIDENT_PANELS)
    if route == "blocked":
        assert max(blocks(bp) for bp in RESIDENT_PANELS) < 2
        assert panel_smem_bytes(n, itemsize, panel, False) <= H100_SMEM_OPTIN
        first = BLOCKED_PANELS[itemsize][0]
        assert panel == first or panel_smem_bytes(n, itemsize, 2 * panel, False) > H100_SMEM_OPTIN


def test_route_function_mirrors_the_kernels_launch_bounds():
    """``RESIDENT_REG_BLOCKS`` is the minimum blocks an SM that the resident
    panel kernels are compiled for (``gauss_jordan.cuh:kPanMinBlocks``)."""
    from gym_anm_torch import _build

    src = (_build.CSRC_DIR / "gauss_jordan.cuh").read_text()
    f32, f64 = RESIDENT_REG_BLOCKS[4], RESIDENT_REG_BLOCKS[8]
    assert f"constexpr int kPanMinBlocks = kResident ? (sizeof(T) == 4 ? {f32} : {f64}) : 2;" in src
