"""Batched Newton–Raphson AC load-flow solver.

Port of ``gym_anm_tpu/physics/power_flow.py``, which replaces
``gym_anm/simulator/solve_load_flow.py:7-226`` iterate for iterate:

* polar unknowns x = [θ₁..θ_{N-1}, |V|₁..|V|_{N-1}], flat start θ=0, |V|=1,
  slack anchored at V₀ = 1+0j;
* mismatch f(x) = (V ∘ (YV)*)[1:] − (p + jq), split into re/im;
* analytic Jacobian from the dS/dθ and dS/d|V| diagonal-matrix identities;
* undamped updates x ← x − J⁻¹F until ‖F‖∞ ≤ xtol or 100 iterations;
* converged = ¬isnan(diff); stable = converged ∧ diff ≤ xtol.

Every tensor is batch-leading: lane b of ``p [B, n]`` is one grid.  The
reference's vmapped ``while_loop`` runs the body on every lane and keeps the
new carry only where the lane's condition holds.  On the card the chord
phase is one CUDA kernel whose lanes iterate until their own exit
(:mod:`.chord_cuda`); its plain version :func:`chord_solve_plain` does what
the reference does with a per-lane mask, ending on a host-side ``any()`` of
the mask once per iteration.  The Newton loops gather the lanes that still
iterate, solve only those and scatter them back, which per lane is the same
program.

Host-side tables (:class:`ChordConst` and the functions building it) are
numpy float64, as in the reference.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from .chord_cuda import chord_solve_cuda
from .complexops import cmatvec, matmul_full
from .linsolve_cuda import batched_solve, solve_gauss_jordan  # noqa: F401  (re-export)


class NRResult(NamedTuple):
    v_re: torch.Tensor       # [B, N] full complex bus voltage (slack included)
    v_im: torch.Tensor
    n_iter: torch.Tensor     # [B] int32
    diff: torch.Tensor       # [B] final ‖F‖∞
    converged: torch.Tensor  # [B] bool: no NaN encountered
    stable: torch.Tensor     # [B] bool: converged and diff <= xtol
    # Final mismatch [B, 2(N−1)] = [Re(S)−p; Im(S)−q] at the returned
    # iterate: lets callers recover exact bus powers without another Y·V.
    F: torch.Tensor = None


def _assemble_v(theta, vm):
    """V = [1+0j, |V|·e^{jθ}] per lane."""
    lead = theta.shape[:-1]
    one = torch.ones(*lead, 1, dtype=theta.dtype, device=theta.device)
    zero = torch.zeros(*lead, 1, dtype=theta.dtype, device=theta.device)
    v_re = torch.cat([one, vm * torch.cos(theta)], dim=-1)
    v_im = torch.cat([zero, vm * torch.sin(theta)], dim=-1)
    return v_re, v_im


def _mismatch(x, p, q, Yre, Yim, n):
    """F(x) = [Re(S−s); Im(S−s)] with S = V ∘ conj(YV), rows 1..N−1.

    x [B, 2n], p/q [B, n], Y [B, N, N] or [N, N].  The matvec runs at full
    precision (:func:`matmul_full`): F is the convergence criterion.
    """
    theta, vm = x[..., :n], x[..., n:]
    v_re, v_im = _assemble_v(theta, vm)
    yv_re, yv_im = cmatvec(Yre, Yim, v_re, v_im)
    # V * conj(YV)
    s_re = v_re * yv_re + v_im * yv_im
    s_im = v_im * yv_re - v_re * yv_im
    F = torch.cat([s_re[..., 1:] - p, s_im[..., 1:] - q], dim=-1)
    return F, (v_re, v_im, yv_re, yv_im)


def _jacobian(v_re, v_im, yv_re, yv_im, Yre, Yim, n):
    """Analytic Jacobian of the mismatch w.r.t. [θ, |V|] (rows/cols 1..N−1),
    per lane: v/yv [B, N], Y [B, N, N] or [N, N] → J [B, 2n, 2n].

    dS/dθ  = j·diag(V)·conj(diag(YV) − Y·diag(V))
    dS/d|V| = diag(V/|V|)·conj(diag(YV)) + diag(V)·conj(Y·diag(V/|V|))
    """
    N = v_re.shape[-1]
    eye = torch.eye(N, dtype=v_re.dtype, device=v_re.device)

    def col(v):   # scales columns: [..., 1, N]
        return v.unsqueeze(-2)

    def row(v):   # scales rows: [..., N, 1]
        return v.unsqueeze(-1)

    # M = diag(YV) − Y·diag(V)
    M_re = col(yv_re) * eye - Yre * col(v_re) + Yim * col(v_im)
    M_im = col(yv_im) * eye - Yre * col(v_im) - Yim * col(v_re)
    # A = diag(V)·conj(M)  →  row k scaled by V_k, M conjugated
    A_re = row(v_re) * M_re + row(v_im) * M_im
    A_im = row(v_im) * M_re - row(v_re) * M_im
    # dS/dθ = j·A
    dSdA_re, dSdA_im = -A_im, A_re

    vabs = torch.sqrt(v_re * v_re + v_im * v_im)
    vn_re, vn_im = v_re / vabs, v_im / vabs
    # B = Y·diag(Vnorm); C = diag(V)·conj(B)
    B_re = Yre * col(vn_re) - Yim * col(vn_im)
    B_im = Yre * col(vn_im) + Yim * col(vn_re)
    C_re = row(v_re) * B_re + row(v_im) * B_im
    C_im = row(v_im) * B_re - row(v_re) * B_im
    # + diag(Vnorm · conj(YV))
    d_re = vn_re * yv_re + vn_im * yv_im
    d_im = vn_im * yv_re - vn_re * yv_im
    dSdM_re = C_re + col(d_re) * eye
    dSdM_im = C_im + col(d_im) * eye

    top = torch.cat([dSdA_re[..., 1:, 1:], dSdM_re[..., 1:, 1:]], dim=-1)
    bottom = torch.cat([dSdA_im[..., 1:, 1:], dSdM_im[..., 1:, 1:]], dim=-1)
    return torch.cat([top, bottom], dim=-2)


# ---------------------------------------------------------------------------
# Host side (numpy float64)
# ---------------------------------------------------------------------------
def numpy_nr_solve(Y, p, q, xtol=1e-10, lim_iter=50):
    """Host-side float64 Newton-Raphson (pure numpy).  Returns the polar
    state x* = [θ₁.., |V|₁..] of the solved operating point, or the flat
    start if the solve does not converge.  Used to pick a chord
    linearization point for tasks whose typical loading is far from the
    flat start."""
    Y = np.asarray(Y, complex)
    N = Y.shape[0]
    n = N - 1
    s = np.asarray(p, float) + 1j * np.asarray(q, float)
    x = np.concatenate([np.zeros(n), np.ones(n)])
    for _ in range(lim_iter):
        V = np.concatenate([[1.0 + 0.0j], x[n:] * np.exp(1j * x[:n])])
        YV = Y @ V
        F_c = (V * np.conj(YV))[1:] - s
        F = np.concatenate([F_c.real, F_c.imag])
        if np.max(np.abs(F)) <= xtol:
            return x
        J = _numpy_jacobian(Y, V, YV)
        try:
            x = x - np.linalg.solve(J, F)
        except np.linalg.LinAlgError:
            break
        if not np.all(np.isfinite(x)):
            break
    V = np.concatenate([[1.0 + 0.0j], x[n:] * np.exp(1j * x[:n])]) if np.all(np.isfinite(x)) else None
    if V is not None:
        YV = Y @ V
        F_c = (V * np.conj(YV))[1:] - s
        if np.max(np.abs(np.concatenate([F_c.real, F_c.imag]))) <= 1e-6:
            return x
    return np.concatenate([np.zeros(n), np.ones(n)])


def _numpy_jacobian(Y, V, YV):
    """J(x) in float64 numpy from the complex V and YV."""
    dSdA = 1j * np.diag(V) @ np.conj(np.diag(YV) - Y @ np.diag(V))
    Vn = V / np.abs(V)
    dSdM = np.diag(Vn) @ np.conj(np.diag(YV)) + np.diag(V) @ np.conj(Y @ np.diag(Vn))
    return np.block([[dSdA[1:, 1:].real, dSdM[1:, 1:].real],
                     [dSdA[1:, 1:].imag, dSdM[1:, 1:].imag]])


def _numpy_jacobian_inv(Y, x):
    """inv(J(x)) at an arbitrary polar state, float64 numpy."""
    Y = np.asarray(Y, complex)
    n = Y.shape[0] - 1
    V = np.concatenate([[1.0 + 0.0j], x[n:] * np.exp(1j * x[:n])])
    return np.linalg.inv(_numpy_jacobian(Y, V, Y @ V))


def flat_start_inv_jacobian(Yre, Yim):
    """inv(J(x0)) at the flat start x0 = (θ=0, |V|=1) for a fixed
    admittance matrix — the constant matrix of the chord-Newton fast path.
    Host-side float64; call once per network at table-build time."""
    Y = np.asarray(Yre, np.float64) + 1j * np.asarray(Yim, np.float64)
    n = Y.shape[0] - 1
    return _numpy_jacobian_inv(Y, np.concatenate([np.zeros(n), np.ones(n)]))


class ChordConst(NamedTuple):
    """Host constants of the chord-Newton fast path (shared across the
    environment batch; see :func:`make_chord_const`)."""

    Y0re: np.ndarray    # [N, N] nominal-tap admittance matrix
    Y0im: np.ndarray
    invJ0: np.ndarray   # [2n, 2n] inverse Jacobian at the linearization
    #                     point (flat start by default) and nominal tap
    G: np.ndarray       # [2n, 2] = invJ0 · U  (U = [e_{P_t}, e_{Q_t}])
    H: np.ndarray       # [2, 2n] = Eᵀ · invJ0 (E = [e_{θ_t}, e_{|V|_t}])
    C: np.ndarray       # [2, 2]  = Eᵀ · invJ0 · U
    t_bus: int          # regulated branch's to-bus (from-bus is the slack)
    # V at the regulated bus at the linearization point (enters W(a)).
    vstar_re: float = 1.0
    vstar_im: float = 0.0


def make_chord_const(Y0re, Y0im, t_bus, dtype=np.float32, x_star=None) -> ChordConst:
    """Build the shared constants of the tap-aware chord-Newton solver.

    The chord iteration is x ← x − J(x0, a)⁻¹ F(x), where J(x0, a) is the
    Jacobian at the linearization point and the lane's OLTC tap ``a``.  A
    tap change on a branch whose from-bus is the slack changes that
    Jacobian by a rank-2 term confined to rows (P_t, Q_t) and columns
    (θ_t, |V|_t):

        J(x0, a) = J0 + U · W(a) · Eᵀ,
        W(a) = [[Im δ, Re δ], [Re δ, −Im δ]],
        δ = ΔY[t,f] = −y·e^{−jθ_shift}·(1/a − 1/a₀),

    and Sherman–Morrison–Woodbury gives the per-lane solve from the shared
    invJ0 plus 2-dimensional per-lane corrections:

        J(x0,a)⁻¹ F = invJ0·F − G · [W(I + C·W)⁻¹] · (H·F).
    """
    n = np.asarray(Y0re).shape[-1] - 1
    if x_star is None:
        invJ0 = flat_start_inv_jacobian(Y0re, Y0im)
        vstar_re, vstar_im = 1.0, 0.0
    else:
        x_star = np.asarray(x_star, float)
        Yc = np.asarray(Y0re, float) + 1j * np.asarray(Y0im, float)
        invJ0 = _numpy_jacobian_inv(Yc, x_star)
        it_t = int(t_bus) - 1
        vm_t = x_star[n + it_t]
        th_t = x_star[it_t]
        vstar_re = float(vm_t * np.cos(th_t))
        vstar_im = float(vm_t * np.sin(th_t))
    it = int(t_bus) - 1
    rows = [it, n + it]
    return ChordConst(
        Y0re=np.asarray(Y0re, dtype),
        Y0im=np.asarray(Y0im, dtype),
        invJ0=invJ0.astype(dtype),
        G=invJ0[:, rows].astype(dtype),
        H=invJ0[rows, :].astype(dtype),
        C=invJ0[np.ix_(rows, rows)].astype(dtype),
        t_bus=int(t_bus),
        vstar_re=vstar_re,
        vstar_im=vstar_im,
    )


# ---------------------------------------------------------------------------
# Chord-Newton solve (tensor side).  The reference's _chord_lane_core
# (init, cond, body, epilogue) becomes chord_solve_plain's prologue, masked
# loop and epilogue, with the body in _chord_body.
# ---------------------------------------------------------------------------
class ChordTensors(NamedTuple):
    """A :class:`ChordConst` moved to one dtype and device, with the
    products the iteration needs formed once."""

    n: int
    t_bus: int
    Y0re: torch.Tensor       # [N, N] at dtype
    Y0im: torch.Tensor
    W_pack: torch.Tensor     # [N, 2N] = [Y0reᵀ | Y0imᵀ], float64 copy of the dtype values
    invJ0_T: torch.Tensor    # [2n, 2n] invJ0ᵀ, float64 copy of the dtype values
    H_T: torch.Tensor        # [2n, 2]  Hᵀ, float64 copy of the dtype values
    g_col0: torch.Tensor     # [2n] at dtype
    g_col1: torch.Tensor
    c: torch.Tensor          # [4] (c00, c01, c10, c11) at dtype
    e_t: torch.Tensor        # [N] one-hot of the regulated bus
    rs_re: torch.Tensor      # [N] row sums of Y0 (the flat-start S)
    rs_im: torch.Tensor
    flat: torch.Tensor       # [2n] flat start
    vstar_re: float
    vstar_im: float
    # float32 only: W_pack and invJ0ᵀ as float32 with padded rows (the wide
    # CUDA kernel's copies, laid out as its shared-memory chunks, so that a
    # chunk is one copy): W_pack_f32 [N, 2 LW] holds Y0reᵀ in columns 0..N-1
    # and Y0imᵀ from column LW, the least LW >= N with LW = 4 (mod 16);
    # invJ0_T_f32 [2n, LU], the least LU >= 2n with LU = 8 (mod 32).  The
    # padding is zeros.
    W_pack_f32: Optional[torch.Tensor] = None
    invJ0_T_f32: Optional[torch.Tensor] = None


def _pad_to(x, r, m):
    """The least x' >= x with x' = r (mod m)."""
    return x + (r - x) % m


def _padded_rows(M, width):
    """``M`` [R, C] in a zero [R, width] tensor (width >= C)."""
    out = torch.zeros(M.shape[0], width, dtype=M.dtype, device=M.device)
    out[:, :M.shape[1]] = M
    return out


def chord_tensors(const: ChordConst, dtype, device) -> ChordTensors:
    """Move a :class:`ChordConst` to ``dtype`` on ``device``."""
    npdt = np.float32 if dtype == torch.float32 else np.float64

    def t(a):
        return torch.tensor(np.asarray(a, npdt), device=device)

    Y0re, Y0im = t(const.Y0re), t(const.Y0im)
    invJ0, G, H, C = t(const.invJ0), t(const.G), t(const.H), t(const.C)
    n = Y0re.shape[-1] - 1
    e_t = torch.zeros(n + 1, dtype=dtype, device=device)
    e_t[const.t_bus] = 1.0
    return ChordTensors(
        n=n,
        t_bus=int(const.t_bus),
        Y0re=Y0re,
        Y0im=Y0im,
        W_pack=torch.cat([Y0re.T, Y0im.T], dim=1).double(),
        invJ0_T=invJ0.T.contiguous().double(),
        H_T=H.T.contiguous().double(),
        g_col0=G[:, 0].contiguous(),
        g_col1=G[:, 1].contiguous(),
        c=C.reshape(4).contiguous(),
        e_t=e_t,
        rs_re=Y0re.sum(-1),
        rs_im=Y0im.sum(-1),
        flat=torch.cat([torch.zeros(n, dtype=dtype, device=device),
                        torch.ones(n, dtype=dtype, device=device)]),
        vstar_re=float(const.vstar_re),
        vstar_im=float(const.vstar_im),
        W_pack_f32=None if dtype != torch.float32 else torch.cat(
            [_padded_rows(Y0re.T, _pad_to(n + 1, 4, 16)), _padded_rows(Y0im.T, _pad_to(n + 1, 4, 16))], dim=1),
        invJ0_T_f32=None if dtype != torch.float32 else _padded_rows(invJ0.T, _pad_to(2 * n, 8, 32)),
    )


_TRIG_RADIUS = 0.5
_STALL_LIMIT = 3


def _sincos(t, fast_trig):
    """7th-order Taylor sin/cos for the float32 iteration: for |θ| ≤ 0.5
    rad the truncation error (sin ≤ 5e-9, cos ≤ 1e-7) sits at the f32
    rounding floor.  Validity is enforced by the epilogue's guard, not
    assumed.  Float64 keeps native trig."""
    if not fast_trig:
        return torch.sin(t), torch.cos(t)
    t2 = t * t
    s = t * (1.0 + t2 * (-1.0 / 6.0 + t2 * (1.0 / 120.0 - t2 * (1.0 / 5040.0))))
    c = 1.0 + t2 * (-0.5 + t2 * (1.0 / 24.0 - t2 * (1.0 / 720.0)))
    return s, c


def _chord_mismatch(ct: ChordTensors, x, p, q, dtf_re, dtf_im, fast_trig):
    """True mismatch V∘conj(Y0·V + ΔY·V) with the packed [Y0ᵀ | Y0imᵀ]
    product (two [B, N]@[N, 2N] matmuls at full precision); (ΔY·V)_t = δ
    since the slack is pinned at 1+0j."""
    n = ct.n
    theta, vm = x[:, :n], x[:, n:]
    sn, cs = _sincos(theta, fast_trig)
    B = x.shape[0]
    one = torch.ones(B, 1, dtype=x.dtype, device=x.device)
    zero = torch.zeros(B, 1, dtype=x.dtype, device=x.device)
    v_re = torch.cat([one, vm * cs], dim=1)
    v_im = torch.cat([zero, vm * sn], dim=1)
    A = matmul_full(v_re, ct.W_pack)
    Bp = matmul_full(v_im, ct.W_pack)
    yv_re = A[:, : n + 1] - Bp[:, n + 1:] + ct.e_t * dtf_re.unsqueeze(1)
    yv_im = Bp[:, : n + 1] + A[:, n + 1:] + ct.e_t * dtf_im.unsqueeze(1)
    s_re = v_re * yv_re + v_im * yv_im
    s_im = v_im * yv_re - v_re * yv_im
    return torch.cat([s_re[:, 1:] - p, s_im[:, 1:] - q], dim=1)


def _butterfly_sum(a):
    """Sum of the 2n entries of ``a`` [B, 2n] in the CUDA kernel's order,
    so that the kernel and this version round alike: entries i and n + i
    added (one thread's pair), the n pair sums padded with zeros to a power
    of two ≥ 32 and summed by a butterfly (offsets 16, 8, 4, 2, 1 for 32), as
    the kernel's warp shuffles sum them."""
    n = a.shape[1] // 2
    width = max(32, 1 << (n - 1).bit_length())
    v = torch.nn.functional.pad(a[:, :n] + a[:, n:], (0, width - n))
    lanes = torch.arange(width, device=a.device)
    o = width // 2
    while o:
        v = v + v[:, lanes ^ o]
        o //= 2
    return v[:, 0]


def _chord_body(ct, data, carry, xtol, fast_trig):
    """One chord + Anderson(1) iteration on every lane."""
    p, q, dtf_re, dtf_im, k00, k01, k10, k11 = data
    x, F, diff, best, it, stall, g_prev, f_prev = carry
    # Chord direction f and map value g = x + f; the rank-2 Woodbury
    # correction G·K·(H·F) as scalar algebra per lane.
    u = matmul_full(F, ct.H_T)                       # [B, 2]
    u0, u1 = u[:, 0:1], u[:, 1:2]
    t0 = k00.unsqueeze(1) * u0 + k01.unsqueeze(1) * u1
    t1 = k10.unsqueeze(1) * u0 + k11.unsqueeze(1) * u1
    f = -matmul_full(F, ct.invJ0_T) + (t0 * ct.g_col0 + t1 * ct.g_col1)
    g = x + f
    # Anderson(1): extrapolate along the last two chord-map evaluations, γ
    # from elementwise sums, clipped to ±5 and off within 100·xtol (below
    # that plain chord contracts monotonically into the plateau rule).
    use_aa = (it > 0) & (diff > 100.0 * xtol)
    df = f - f_prev
    denom = _butterfly_sum(df * df)
    gamma = torch.where(denom > 1e-30, _butterfly_sum(f * df) / denom, torch.zeros_like(denom))
    gamma = torch.where(use_aa, torch.clamp(gamma, -5.0, 5.0), torch.zeros_like(gamma))
    x = g - gamma.unsqueeze(1) * (g - g_prev)
    F = _chord_mismatch(ct, x, p, q, dtf_re, dtf_im, fast_trig)
    new_diff = torch.amax(torch.abs(F), dim=1)
    # "Stalled" = no iteration beating the best residual so far by ≥20%.
    improving = new_diff < best * 0.8
    stall = torch.where(improving, torch.zeros_like(stall), stall + 1)
    best = torch.minimum(best, new_diff)
    return (x, F, new_diff, best, it + 1, stall, g, f)


def chord_solve(p, q, w_a, w_b, dtf_re, dtf_im, const,
                xtol=1e-5, lim_iter=48, stall_tol_factor=10.0, x0=None):
    """Chord-Newton phase of the load-flow solve, batched over lanes: the
    plain version :func:`chord_solve_plain` for CPU tensors, the CUDA kernel
    (:func:`~gym_anm_torch.physics.chord_cuda.chord_solve_cuda`, float32
    only) for CUDA tensors, with no fallback between them.  Arguments and
    result as :func:`chord_solve_plain`."""
    if not p.is_cuda:
        return chord_solve_plain(p, q, w_a, w_b, dtf_re, dtf_im, const, xtol, lim_iter,
                                 stall_tol_factor, x0)
    ct = const if isinstance(const, ChordTensors) else chord_tensors(const, p.dtype, p.device)
    c = lambda t: t.contiguous()  # noqa: E731
    return chord_solve_cuda(c(p), c(q), c(w_a), c(w_b), c(dtf_re), c(dtf_im), ct, xtol, lim_iter,
                            stall_tol_factor, None if x0 is None else c(x0.to(p.dtype)))


def chord_solve_plain(p, q, w_a, w_b, dtf_re, dtf_im, const,
                      xtol=1e-5, lim_iter=48, stall_tol_factor=10.0, x0=None):
    """Chord-Newton phase of the load-flow solve, batched over lanes, in
    plain torch ops (any device): the CPU path and the oracle of the CUDA
    kernel.

    Parameters
    ----------
    p, q : [B, N−1] — non-slack bus injections.
    w_a, w_b : [B] — W(a) entries Im δ and Re δ (0 when the lane's tap is
        nominal or the network has no OLTC).
    dtf_re, dtf_im : [B] — ΔY[t,f] = δ, the per-lane Y-bus correction.
    const : :class:`ChordConst` or :class:`ChordTensors`.
    x0 : optional [B, 2(N−1)] warm start; lanes whose guess contains
        non-finite entries start flat.

    Returns ``(x, F, diff, n_iter, accepted)``: ``accepted`` lanes satisfy
    the residual criterion (diff ≤ xtol, or ≤ ``stall_tol_factor·xtol``
    after the residual plateaus) and skip the Newton fallback.
    """
    dtype, device = p.dtype, p.device
    ct = const if isinstance(const, ChordTensors) else chord_tensors(const, dtype, device)
    n = ct.n
    B = p.shape[0]
    fast_trig = dtype == torch.float32

    # K = W (I + C W)⁻¹ per lane in closed form, with W(a) at the
    # linearization point V* = va + j·vb and δ = w_b + j·w_a.
    # 1/|V*| is a multiplier: dividing a tensor by a Python scalar multiplies
    # by its float reciprocal on the card but divides on the CPU, and the
    # kernel and both devices should round alike.
    va, vb = ct.vstar_re, ct.vstar_im
    inv_vmag = 1.0 / float(np.hypot(va, vb))
    c00, c01, c10, c11 = ct.c
    d_i, d_r = w_a, w_b
    w00 = va * d_i - vb * d_r
    w01 = (va * d_r + vb * d_i) * inv_vmag
    w10 = va * d_r + vb * d_i
    w11 = (vb * d_r - va * d_i) * inv_vmag
    m00 = 1.0 + c00 * w00 + c01 * w10
    m01 = c00 * w01 + c01 * w11
    m10 = c10 * w00 + c11 * w10
    m11 = 1.0 + c10 * w01 + c11 * w11
    det = m00 * m11 - m01 * m10
    k00 = (w00 * m11 - w01 * m10) / det
    k01 = (w01 * m00 - w00 * m01) / det
    k10 = (w10 * m11 - w11 * m10) / det
    k11 = (w11 * m00 - w10 * m01) / det

    flat = ct.flat.expand(B, -1)
    if x0 is None:
        x = flat.clone()
    else:
        x0 = x0.to(dtype)
        x = torch.where(torch.isfinite(x0).all(dim=1, keepdim=True), x0, flat)
    F = _chord_mismatch(ct, x, p, q, dtf_re, dtf_im, fast_trig)
    diff = torch.amax(torch.abs(F), dim=1)
    zeros_i = torch.zeros(B, dtype=torch.int32, device=device)
    data = (p, q, dtf_re, dtf_im, k00, k01, k10, k11)
    carry = (x, F, diff, diff, zeros_i, zeros_i, x, torch.zeros_like(F))

    band = stall_tol_factor * xtol
    while True:
        x, F, diff, best, it, stall = carry[:6]
        # Lanes inside the plateau-acceptance band exit after one
        # non-improving iteration; the others keep the full stall budget.
        limit = torch.where(diff <= band, _STALL_LIMIT - 2, _STALL_LIMIT)
        active = (diff > xtol) & (it < lim_iter) & (stall < limit)
        if not bool(active.any()):
            break
        new = _chord_body(ct, data, carry, xtol, fast_trig)
        carry = tuple(
            torch.where(active.view(-1, *([1] * (o.dim() - 1))), nw, o)
            for nw, o in zip(new, carry)
        )

    # Epilogue: accept, or sanitize the exit for the Newton fallback.  A
    # non-finite iterate, one outside the fast-trig radius, or one worse
    # than the flat start is reset to the flat start with its analytic
    # residual (S = conj(row sums of Y) at V ≡ 1).
    x, F, diff, _, n_iter, stall = carry[:6]
    finite = torch.isfinite(diff) & torch.isfinite(x).all(dim=1)
    if fast_trig:
        finite = finite & (torch.amax(torch.abs(x[:, :n]), dim=1) <= _TRIG_RADIUS)
    rs_re = ct.rs_re + ct.e_t * dtf_re.unsqueeze(1)
    rs_im = ct.rs_im + ct.e_t * dtf_im.unsqueeze(1)
    F_flat = torch.cat([rs_re[:, 1:] - p, -rs_im[:, 1:] - q], dim=1)
    diff_flat = torch.amax(torch.abs(F_flat), dim=1)
    eff_limit = torch.where(diff <= band, _STALL_LIMIT - 2, _STALL_LIMIT)
    plateaued = finite & (stall >= eff_limit)
    accepted = (finite & (diff <= xtol)) | (plateaued & (diff <= band))
    reset = ~accepted & (~finite | ~(diff <= diff_flat))
    x = torch.where(reset.unsqueeze(1), flat, x)
    F = torch.where(reset.unsqueeze(1), F_flat, F)
    diff = torch.where(reset, diff_flat, diff)
    n_iter = torch.where(reset, torch.zeros_like(n_iter), n_iter)
    return x, F, diff, n_iter, accepted


# ---------------------------------------------------------------------------
# Exact Newton-Raphson
# ---------------------------------------------------------------------------
def _newton_loop(x, F, diff, it, may_iterate, ybus_at, p, q, xtol, lim_iter, f32_mode, linsolve):
    """Run Newton iterations on the lanes that still iterate.

    Per lane this is the reference's while loop: continue while
    diff > xtol, it < lim_iter (and, in f32, stall < 3).  Only the lanes
    that continue are gathered, solved and scattered back; finished lanes
    never move.  ``ybus_at(idx)`` returns the lanes' (Yre, Yim)."""
    x, F, diff, it = x.clone(), F.clone(), diff.clone(), it.clone()
    stall = torch.zeros_like(it)
    n = p.shape[-1]
    idx = torch.nonzero(may_iterate).squeeze(1)
    while idx.numel() > 0:
        go = (diff[idx] > xtol) & (it[idx] < lim_iter)
        if f32_mode:
            go = go & (stall[idx] < _STALL_LIMIT)
        idx = idx[go]
        if idx.numel() == 0:
            break
        Yre, Yim = ybus_at(idx)
        xs, ps, qs = x[idx], p[idx], q[idx]
        _, (v_re, v_im, yv_re, yv_im) = _mismatch(xs, ps, qs, Yre, Yim, n)
        J = _jacobian(v_re, v_im, yv_re, yv_im, Yre, Yim, n)
        xs = xs - linsolve(J, F[idx])
        Fs, _ = _mismatch(xs, ps, qs, Yre, Yim, n)
        new_diff = torch.amax(torch.abs(Fs), dim=1)
        improving = new_diff < diff[idx] * 0.5
        stall[idx] = torch.where(improving, torch.zeros_like(new_diff, dtype=stall.dtype), stall[idx] + 1)
        x[idx], F[idx], diff[idx] = xs, Fs, new_diff
        it[idx] = it[idx] + 1
    return x, F, diff, it, stall


def _nr_result(x, F, diff, n_iter, stall, accepted, xtol, f32_mode):
    n = x.shape[-1] // 2
    v_re, v_im = _assemble_v(x[:, :n], x[:, n:])
    converged = ~torch.isnan(diff)
    ok = (diff <= xtol) | accepted
    if f32_mode:
        ok = ok | ((stall >= _STALL_LIMIT) & (diff <= 10.0 * xtol))
    return NRResult(v_re=v_re, v_im=v_im, n_iter=n_iter, diff=diff,
                    converged=converged, stable=converged & ok, F=F)


def nr_solve_lazy(ybus_fn, p, q, xtol=1e-5, lim_iter=100, init=None) -> NRResult:
    """Exact-NR fallback after the chord phase, on the unaccepted lanes only.

    ``init`` is the chord's ``(x, F, diff, n_iter, accepted)``: the
    iteration counter continues from the chord's ``n_iter`` (``lim_iter``
    counts both phases), the stall counter restarts at 0, and accepted
    lanes never enter.  ``ybus_fn(idx) -> (Yre, Yim)`` builds the
    admittance matrices [len(idx), N, N] of the lanes ``idx`` only when a
    Newton iteration runs.  The linear solve is :func:`batched_solve`.
    """
    if init is None:
        raise ValueError("nr_solve_lazy is the post-chord fallback; pass init")
    x, F, diff, it0, accepted = init
    f32_mode = p.dtype != torch.float64
    x, F, diff, n_iter, stall = _newton_loop(
        x, F, diff, it0.to(torch.int32), ~accepted, ybus_fn, p, q, xtol, lim_iter,
        f32_mode, batched_solve)
    return _nr_result(x, F, diff, n_iter, stall, accepted, xtol, f32_mode)


def nr_solve(Yre, Yim, p, q, xtol=1e-5, lim_iter=100, init=None) -> NRResult:
    """Solve the power-flow equations for a batch of networks.

    Parameters
    ----------
    Yre, Yim : [B, N, N] — split-complex admittance matrices.
    p, q : [B, N-1] — net injections at buses 1..N−1 (p.u.).
    xtol : ‖F‖∞ convergence tolerance.
    lim_iter : iteration cap.
    init : optional warm start ``(x, F, diff, n_iter, accepted)`` from
        :func:`chord_solve`; accepted lanes skip the Newton loop.

    In float32 a lane whose residual plateaus is accepted within 10·xtol
    after 3 non-halving iterations; float64 keeps the reference's exact
    loop.  The linear solve is LAPACK for float64 on the CPU (as the
    reference's ``jnp.linalg.solve``) and :func:`batched_solve` otherwise:
    the plain Gauss-Jordan on the CPU, the CUDA kernel on the card.
    """
    dtype, device = p.dtype, p.device
    B, n = p.shape
    f32_mode = dtype != torch.float64
    if init is not None:
        x, F, diff, it0, accepted = init
        it0 = it0.to(torch.int32)
    else:
        x = torch.cat([torch.zeros(B, n, dtype=dtype, device=device),
                       torch.ones(B, n, dtype=dtype, device=device)], dim=1)
        F, _ = _mismatch(x, p, q, Yre, Yim, n)
        diff = torch.amax(torch.abs(F), dim=1)
        it0 = torch.zeros(B, dtype=torch.int32, device=device)
        accepted = torch.zeros(B, dtype=torch.bool, device=device)
    linsolve = _lapack_solve if dtype == torch.float64 and device.type == "cpu" else batched_solve
    x, F, diff, n_iter, stall = _newton_loop(
        x, F, diff, it0, ~accepted, lambda idx: (Yre[idx], Yim[idx]), p, q, xtol, lim_iter,
        f32_mode, linsolve)
    return _nr_result(x, F, diff, n_iter, stall, accepted, xtol, f32_mode)


def _lapack_solve(J, F):
    """LU solve with partial pivoting (the reference's float64 CPU solve);
    a singular system gives non-finite values instead of an exception, as
    ``jnp.linalg.solve`` does."""
    x, info = torch.linalg.solve_ex(J, F)
    bad = info != 0
    if bool(bad.any()):
        x = torch.where(bad.unsqueeze(-1), torch.full_like(x, float("nan")), x)
    return x
