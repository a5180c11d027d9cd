"""On-device batched N-stage DC-OPF MPC.

Port of ``gym_anm_tpu/vec/mpc.py``, batch-leading: every per-lane tensor has
the lane on its first axis, and one call solves the whole batch.  The LP is
the one :func:`~gym_anm_torch.agents.mpc.build_dcopf_structure` assembles
from the network spec, so :func:`~gym_anm_torch.agents.mpc.solve_highs` is
the ground truth of the batched solver.

The solver is an OSQP-style ADMM.  Across a batch of grids only the bound
vector varies (pinned load forecasts, renewable potential caps, the stage-0
SoC), so the KKT system ``(σI + Āᵀdiag(ρ)Ā) x̃ = rhs`` is inverted once on
the host and every sweep is two shared-matrix products: ``t = (ρz − y)·Ā``
and ``w = P_pack·rhs``, which yields x̃ and Āx̃ together.  Scaling follows
OSQP: modified Ruiz equilibration of A plus cost normalization, on the host
in float64.  Convergence is checked every ``check_every`` sweeps on the
unscaled residuals; each lane exits on its own, and lanes whose bounds cross
exit at entry.  Warm starts carry the scaled iterate ``(x̄, ȳ, z̄, Āx̄)`` from
one env step to the next.

Precision: every product entry is the float64 sum of exact products of the
working-type operands, rounded once (:func:`~gym_anm_torch.physics.complexops.matmul_full`;
no TF32 reaches it), and the elementwise chain runs in the working type, as
the JAX package's ``precision=HIGHEST`` solve does.

:func:`solve_dcopf` runs :func:`solve_dcopf_plain` (plain torch ops) on CPU
tensors and the CUDA kernel K5 (:func:`~gym_anm_torch.vec.admm_cuda.solve_dcopf_cuda`,
float32) on CUDA tensors, with no fallback between them.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..agents.mpc import DCOPFStructure, build_dcopf_structure, dcopf_layout
from ..networks.anm6 import anm6easy_gen_time_series, anm6easy_load_time_series
from ..physics.complexops import matmul_full
from ..utils import profiling
from .controllers import Controller

__all__ = ["VecDCOPF", "DCOPFSolution", "make_vec_dcopf", "lane_bounds", "make_shift_warm", "init_warm",
           "solve_dcopf", "solve_dcopf_plain", "make_vec_mpc", "profile_forecast_fn", "make_vec_mpc_perfect"]

_BIG = 1e20


class VecDCOPF(NamedTuple):
    """The prefactorized batched DC-OPF: lane-invariant tensors at the
    working dtype on one device, the slot rows as int64 index tensors there,
    and the ADMM constants."""

    # Scaled problem data (OSQP form: min q̄ᵀx̄ s.t. l̄ ≤ Āx̄ ≤ ū).
    A_bar: torch.Tensor     # [m, n]
    # [n, n+m] = [M⁻¹; Ā·M⁻¹]ᵀ with M = σI + Āᵀdiag(ρ)Ā (float64 host
    # product), contiguous: K5 reads it row by row.  w = P_pack·rhs gives x̃
    # and Āx̃ in one product.
    P_pack_T: torch.Tensor
    q_bar: torch.Tensor     # [n]
    rho: torch.Tensor       # [m] per-row step size (equality rows ×rho_eq_factor)
    inv_rho: torch.Tensor   # [m]
    D: torch.Tensor         # [n] column scaling (x = D·x̄)
    D_inv: torch.Tensor     # [n]
    E: torch.Tensor         # [m] row scaling
    E_inv: torch.Tensor     # [m]
    c_scale: torch.Tensor   # 0-dim cost scaling (a tensor: a division by it divides on every device)
    c_scale_value: float    # its value at the working dtype
    q_ref: float            # max|D⁻¹·q̄| / c at the working dtype: the dual's floor of scale
    # Unscaled bound templates and the per-lane slot rows.
    l_tmpl: torch.Tensor    # [m]
    u_tmpl: torch.Tensor    # [m]
    load_rows: torch.Tensor  # [n_load, N] rows of l/u pinned to the load forecast
    gen_rows: torch.Tensor   # [n_gen_ns, N] rows of u capped by the potential
    soc_rows: torch.Tensor   # [n_des] equality rows carrying init_soc
    gen_pmax: torch.Tensor   # [n_gen_ns] static generator upper bounds
    act_idx: torch.Tensor    # stage-0 P variable indices (gens then DES)
    baseMVA: float
    # ADMM constants.
    sigma: float
    alpha: float
    max_iter: int
    eps_abs: float
    eps_rel: float
    n: int
    m: int
    dual_stall_limit: int = 100
    dual_plateau_cap: float = 1.0
    feas_band_factor: float = 10.0
    check_every: int = 8
    # K5's operands: Āᵀ [n, m] and P_pack [n+m, n] as float64 copies of the
    # working-dtype values in the FP64 mma's A-fragment order
    # (:func:`mma_a_fragments`), made once here; and the same fragments by
    # groups of STREAM_TILES row tiles (:func:`stream_fragments`), the order
    # in which K5's streamed route copies them into shared memory.
    A_frag: Optional[torch.Tensor] = None
    P_frag: Optional[torch.Tensor] = None
    A_stream: Optional[torch.Tensor] = None
    P_stream: Optional[torch.Tensor] = None


class DCOPFSolution(NamedTuple):
    x: torch.Tensor          # [B, n] unscaled primal solution
    warm: tuple              # (x̄, ȳ, z̄, Āx̄), [B, n], [B, m] ×3: pass back in to warm-start
    iterations: torch.Tensor  # [B] int32
    r_prim: torch.Tensor     # [B] unscaled ∞-norm primal residual
    r_dual: torch.Tensor     # [B] unscaled ∞-norm dual residual
    converged: torch.Tensor  # [B] bool: optimality confirmed (strict or plateau)
    # [B] bool: no crossed bound row, the LP data is solvable (the host tier's
    # HiGHS call fails exactly where it is not).  Unsolvable lanes run no sweep.
    bounds_ok: torch.Tensor
    # [B] bool: also inside the primal band feas_band_factor × the strict
    # tolerance.  Informative; the controller idles only on ~bounds_ok.
    feasible: torch.Tensor


def mma_a_fragments(M):
    """``M`` [R, K] as the A operand of FP64 ``mma.sync.m16n8k4`` tiles: a
    flat float64 tensor [ceil(R/16), ceil(K/4), 32, 2] (zero-padded), entry
    [rt, c, l, h] = M[16·rt + 8·h + l // 4, 4·c + l % 4], so thread l of a
    warp loads its (a0, a1) of tile (rt, c) as one 16-byte read."""
    R, K = M.shape
    RT, KC = -(-R // 16), -(-K // 4)
    Mp = torch.zeros(16 * RT, 4 * KC, dtype=torch.float64, device=M.device)
    Mp[:R, :K] = M.to(torch.float64)
    return Mp.reshape(RT, 2, 8, KC, 4).permute(0, 3, 2, 4, 1).contiguous().reshape(-1)


# Row tiles of a group and k-chunks of a ring stage in K5's streamed route
# (csrc/admm_dcopf.cu: streamed::kG, kKS).
STREAM_TILES, STREAM_CHUNKS = 4, 6


def stream_fragments(frag, R, K):
    """:func:`mma_a_fragments`' copy ``frag`` of an [R, K] matrix reordered by
    groups of STREAM_TILES row tiles, each group's k-chunks in k order and
    its tiles inside a chunk, the chunks padded with zero chunks to a
    multiple of STREAM_CHUNKS: [group][chunks][tiles][32, 2], so that K5's
    streamed route copies each ring stage (STREAM_CHUNKS chunks of a group)
    as one contiguous block."""
    RT, KC = -(-R // 16), -(-K // 4)
    KP = -(-KC // STREAM_CHUNKS) * STREAM_CHUNKS
    f = torch.zeros(RT, KP, 64, dtype=frag.dtype, device=frag.device)
    f[:, :KC] = frag.reshape(RT, KC, 64)
    return torch.cat([f[r0:r0 + STREAM_TILES].transpose(0, 1).reshape(-1) for r0 in range(0, RT, STREAM_TILES)])


def _ruiz_equilibrate(A, q, iters=15):
    """OSQP's modified Ruiz scaling (∞-norm), host float64.

    Returns (D, E, c) with Ā = diag(E)·A·diag(D), q̄ = c·D·q.
    """
    m, n = A.shape
    D = np.ones(n)
    E = np.ones(m)
    c = 1.0
    q = np.asarray(q, dtype=np.float64)
    for _ in range(iters):
        Ab = E[:, None] * A * D[None, :]
        col = np.max(np.abs(Ab), axis=0)
        row = np.max(np.abs(Ab), axis=1)
        col[col == 0] = 1.0
        row[row == 0] = 1.0
        D *= 1.0 / np.sqrt(col)
        E *= 1.0 / np.sqrt(row)
        # Cost normalization (P = 0, so only the linear term matters).
        qn = np.max(np.abs(c * D * q))
        if qn > 0:
            gamma = 1.0 / np.sqrt(qn)
            c *= gamma
    return D, E, c


def make_vec_dcopf(
    structure: DCOPFStructure,
    dtype=torch.float32,
    device="cuda",
    rho: float = 1.0,
    rho_eq_factor: float = 1e2,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    max_iter: int = 4000,
    eps_abs: float = 1e-5,
    eps_rel: float = 1e-5,
    dual_stall_limit: int = 100,
    dual_plateau_cap: float = 1.0,
    feas_band_factor: float = 10.0,
    check_every: int = 8,
) -> VecDCOPF:
    """Prefactorize a :class:`DCOPFStructure` into a batched solver spec on
    ``device``.  The host arrays are the JAX package's, by the same numpy
    operations in float64; ρ, the equality-row factor and the other defaults
    are its measured choices (``gym_anm_tpu/vec/mpc.py:205-225``)."""
    n = structure.n_var
    A_eq = structure.A_eq.toarray().astype(np.float64)
    n_eq = A_eq.shape[0]
    if structure.A_ub is not None:
        A_ub = structure.A_ub.toarray().astype(np.float64)
        b_ub = np.asarray(structure.b_ub, dtype=np.float64)
    else:
        A_ub = np.zeros((0, n))
        b_ub = np.zeros(0)
    n_ub = A_ub.shape[0]
    A = np.vstack([A_eq, A_ub, np.eye(n)])
    m = A.shape[0]

    l_tmpl = np.concatenate([structure.b_eq, np.full(n_ub, -np.inf), structure.lb])
    u_tmpl = np.concatenate([structure.b_eq, b_ub, structure.ub])
    l_tmpl = np.where(np.isfinite(l_tmpl), l_tmpl, -_BIG)
    u_tmpl = np.where(np.isfinite(u_tmpl), u_tmpl, _BIG)

    D, E, c_scale = _ruiz_equilibrate(A, structure.c)
    A_bar = E[:, None] * A * D[None, :]
    q_bar = c_scale * D * structure.c

    # Equality rows (template l == u; the load-pin rows are l == u at run
    # time too) take the stiffer rho_eq_factor·ρ, as OSQP does.
    is_eq = np.abs(u_tmpl - l_tmpl) < 1e-12
    rho_v = np.where(is_eq, rho_eq_factor * rho, rho)

    M = sigma * np.eye(n) + A_bar.T @ (rho_v[:, None] * A_bar)
    M_inv = np.linalg.inv(M)
    P_pack = np.concatenate([M_inv, A_bar @ M_inv], axis=0)

    device = torch.device(device)
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device).to(dtype)  # noqa: E731
    idx = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)  # noqa: E731
    # q_ref as the solve computes it, at the working dtype (numpy rounds each
    # operation as torch does).
    q_ref = np.max(np.abs((1.0 / D).astype(np_dt) * q_bar.astype(np_dt))) / np_dt(c_scale)
    bound0 = n_eq + n_ub  # first identity (variable-bound) row
    A_bar_t, P_pack_T = t(A_bar), t(P_pack.T).contiguous()
    A_frag, P_frag = mma_a_fragments(A_bar_t.T), mma_a_fragments(P_pack_T.T)
    return VecDCOPF(
        A_bar=A_bar_t, P_pack_T=P_pack_T,
        q_bar=t(q_bar), rho=t(rho_v), inv_rho=t(1.0 / rho_v), D=t(D), D_inv=t(1.0 / D), E=t(E),
        E_inv=t(1.0 / E), c_scale=t(c_scale), c_scale_value=float(np_dt(c_scale)), q_ref=float(q_ref),
        l_tmpl=t(l_tmpl), u_tmpl=t(u_tmpl),
        load_rows=idx(bound0 + structure.load_pin_idx), gen_rows=idx(bound0 + structure.gen_cap_idx),
        soc_rows=idx(structure.soc_rows), gen_pmax=t(structure.gen_pmax), act_idx=idx(structure.act_idx),
        baseMVA=float(structure.baseMVA), sigma=float(sigma), alpha=float(alpha), max_iter=int(max_iter),
        eps_abs=float(eps_abs), eps_rel=float(eps_rel), n=int(n), m=int(m),
        dual_stall_limit=int(dual_stall_limit), dual_plateau_cap=float(dual_plateau_cap),
        feas_band_factor=float(feas_band_factor), check_every=int(check_every),
        A_frag=A_frag, P_frag=P_frag, A_stream=stream_fragments(A_frag, n, m),
        P_stream=stream_fragments(P_frag, n + m, n),
    )


def lane_bounds(spec: VecDCOPF, P_load, P_pot, init_soc):
    """Per-lane UNSCALED (l, u) [B, m] from the grid state (all p.u.).

    ``P_load`` [B, n_load] or [B, n_load, N] (a constant forecast is
    broadcast over the stages when 2-D); likewise ``P_pot`` [B, n_gen_ns(,
    N)]; ``init_soc`` [B, n_des].
    """
    dt = spec.l_tmpl.dtype
    P_load, P_pot, init_soc = (torch.as_tensor(a).to(device=spec.l_tmpl.device, dtype=dt)
                               for a in (P_load, P_pot, init_soc))
    B = P_load.shape[0]
    if P_load.dim() == 2:
        P_load = P_load.unsqueeze(2).expand(B, *spec.load_rows.shape)
    if P_pot.dim() == 2:
        P_pot = P_pot.unsqueeze(2).expand(B, *spec.gen_rows.shape)
    gen_cap = torch.minimum(spec.gen_pmax[:, None], P_pot)
    load_rows, load = spec.load_rows.reshape(-1), P_load.reshape(B, -1)
    l = spec.l_tmpl.expand(B, spec.m).index_copy(1, load_rows, load)
    u = spec.u_tmpl.expand(B, spec.m).index_copy(1, load_rows, load)
    u = u.index_copy(1, spec.gen_rows.reshape(-1), gen_cap.reshape(B, -1))
    l = l.index_copy(1, spec.soc_rows, init_soc)
    u = u.index_copy(1, spec.soc_rows, init_soc)
    return l, u


def make_shift_warm(spec: VecDCOPF, structure: DCOPFStructure, planning_steps: int):
    """Receding-horizon warm-start shift: ``shift(warm) -> warm``.

    At env time t the N-stage plan's stage k targets t+k; at t+1 the new
    stage k targets what was stage k+1, so the previous solution shifted up
    one stage block (the last stage duplicated) is the aligned start.
    Variables and constraint rows are stage-blocked (eq rows n_bus + 2·n_des
    per stage, ub rows 2 per finite-rate branch per stage, identity rows the
    variable layout), so the shift is a static gather.  With x = D·x̄,
    z̄ = E·z and y = E·ȳ/c the shifted scaled iterates pick up the per-index
    scale ratios D[src]/D[dst], E[dst]/E[src] and E[src]/E[dst]; Āx̄ is
    recomputed with one product.  The identity at ``planning_steps == 1``.
    """
    if planning_steps == 1:
        return lambda warm: warm
    n = structure.n_var
    stage_n = n // planning_steps
    n_eq = structure.A_eq.shape[0]
    n_ub = 0 if structure.A_ub is None else structure.A_ub.shape[0]
    eq_ps = n_eq // planning_steps
    ub_ps = n_ub // planning_steps
    assert stage_n * planning_steps == n and eq_ps * planning_steps == n_eq
    assert ub_ps * planning_steps == n_ub

    def src_of(count, per_stage):
        i = np.arange(count)
        return np.where(i < count - per_stage, i + per_stage, i)

    var_src = src_of(n, stage_n)
    row_src = np.concatenate([src_of(n_eq, eq_ps), n_eq + src_of(n_ub, ub_ps), n_eq + n_ub + var_src])
    D = spec.D.cpu().numpy().astype(np.float64)
    E = spec.E.cpu().numpy().astype(np.float64)
    dt, dev = spec.l_tmpl.dtype, spec.l_tmpl.device
    x_ratio = torch.as_tensor(D[var_src] / D, device=dev).to(dt)
    z_ratio = torch.as_tensor(E / E[row_src], device=dev).to(dt)
    y_ratio = torch.as_tensor(E[row_src] / E, device=dev).to(dt)
    var_src = torch.as_tensor(var_src, device=dev)
    row_src = torch.as_tensor(row_src, device=dev)
    A_bar_T = spec.A_bar.T

    def shift(warm):
        x, y, z, _ = warm
        x2 = x[:, var_src] * x_ratio
        y2 = y[:, row_src] * y_ratio
        z2 = z[:, row_src] * z_ratio
        return (x2, y2, z2, matmul_full(x2, A_bar_T))

    return shift


def init_warm(spec: VecDCOPF, n_lanes: int):
    """Cold-start ADMM state of ``n_lanes`` lanes (scaled space): zeros."""
    dt, dev = spec.l_tmpl.dtype, spec.l_tmpl.device
    z = torch.zeros(n_lanes, spec.m, dtype=dt, device=dev)
    return (torch.zeros(n_lanes, spec.n, dtype=dt, device=dev), z, z.clone(), z.clone())


def solve_dcopf(spec: VecDCOPF, l, u, warm=None) -> DCOPFSolution:
    """Solve every lane's DC-OPF by ADMM: the plain version
    :func:`solve_dcopf_plain` for CPU tensors, the CUDA kernel K5
    (:func:`~gym_anm_torch.vec.admm_cuda.solve_dcopf_cuda`, float32 only)
    for CUDA tensors, with no fallback between them.  Arguments and result
    as :func:`solve_dcopf_plain`."""
    streamed = 0  # the lanes of a launch that took K5's streamed route
    with profiling.span("mpc.solve"):
        if not l.is_cuda:
            sol = solve_dcopf_plain(spec, l, u, warm)
        else:
            from .admm_cuda import solve_dcopf_cuda

            if warm is None:
                warm = init_warm(spec, l.shape[0])
            before = solve_dcopf_cuda.launches["streamed"]
            sol = solve_dcopf_cuda(spec, l.contiguous(), u.contiguous(), tuple(w.contiguous() for w in warm))
            streamed = l.shape[0] * (solve_dcopf_cuda.launches["streamed"] - before)
    profiling.count("admm.lanes", l.shape[0])
    profiling.count("admm.streamed_lanes", streamed)
    profiling.count("admm.sweeps", sol.iterations)
    return sol


def _sweep(spec, l_bar, u_bar, x, y, z, Ax):
    """One bare ADMM iteration: ``t = (ρz − y)·Ā`` (only Āᵀ(ρz − y) is needed,
    one product), ``w = P_pack·rhs`` (x̃ and Āx̃ together), the
    α-relaxation, the clip to [l̄, ū] and the dual update."""
    a, b = spec.alpha, 1.0 - spec.alpha
    t = matmul_full(spec.rho * z - y, spec.A_bar)
    rhs = spec.sigma * x - spec.q_bar + t
    w = matmul_full(rhs, spec.P_pack_T)
    xt, zt = w[:, :spec.n], w[:, spec.n:]
    x_new = a * xt + b * x
    Ax_new = a * zt + b * Ax
    z_pre = a * zt + b * z + spec.inv_rho * y
    z_new = torch.clamp(z_pre, l_bar, u_bar)
    y_new = spec.rho * (z_pre - z_new)
    return x_new, y_new, z_new, Ax_new


def _p_ref(spec, Ax, z):
    return torch.maximum(torch.amax(torch.abs(spec.E_inv * Ax), dim=1), torch.amax(torch.abs(spec.E_inv * z), dim=1))


def solve_dcopf_plain(spec: VecDCOPF, l, u, warm=None) -> DCOPFSolution:
    """Solve every lane's DC-OPF by ADMM in plain torch ops, on any device:
    the CPU path and the oracle of K5.

    ``l``/``u`` [B, m] are the unscaled per-lane bounds from
    :func:`lane_bounds`; ``warm`` is a previous solution's ``.warm`` (scaled
    space), zeros when None.  Every ``check_every`` sweeps the unscaled
    residuals of each lane are checked: a STRICT exit when both meet their
    tolerances, a PLATEAU exit when neither improved by 1e-3·K for
    ``ceil(dual_stall_limit / K)`` checks while the primal meets its strict
    tolerance and the dual is within ``dual_plateau_cap``·d_ref.  A lane that
    is done or has reached ``max_iter`` keeps its carry unchanged, bit for
    bit, as the JAX package's ``while_loop`` under ``vmap`` keeps it.  One
    host check per ``check_every`` sweeps ends the loop when no lane runs.
    """
    B = l.shape[0]
    x, y, z, Ax = init_warm(spec, B) if warm is None else warm
    dt, dev = l.dtype, l.device
    K = spec.check_every
    # Scale the bounds; infinities stay ±BIG so the clip passes them through.
    l_bar = torch.where(l <= -_BIG, -_BIG, spec.E * l)
    u_bar = torch.where(u >= _BIG, _BIG, spec.E * u)
    bounds_ok = torch.all(l <= u, dim=1)

    inf = torch.full((B,), float("inf"), dtype=dt, device=dev)
    it = torch.zeros(B, dtype=torch.int32, device=dev)
    r_prim, r_dual, best_rp, best_rd = inf, inf, inf, inf
    stall = torch.zeros(B, dtype=torch.int32, device=dev)
    done = ~bounds_ok
    stall_checks = -(-spec.dual_stall_limit // K)
    improve = 1.0 - 1e-3 * K
    active = ~done & (it < spec.max_iter)
    while bool(active.any()):
        s = (x, y, z, Ax)
        for _ in range(K):
            s = _sweep(spec, l_bar, u_bar, *s)
        x_n, y_n, z_n, Ax_n = s
        # Unscaled residuals of the new iterate; Āᵀy once per check.
        t_y = matmul_full(y_n, spec.A_bar)
        rp = torch.amax(torch.abs(spec.E_inv * (Ax_n - z_n)), dim=1)
        rd = torch.amax(torch.abs(spec.D_inv * (spec.q_bar + t_y)), dim=1) / spec.c_scale
        p_ref = _p_ref(spec, Ax_n, z_n)
        d_ref = torch.clamp(torch.amax(torch.abs(spec.D_inv * t_y), dim=1) / spec.c_scale, min=spec.q_ref)
        improved = (rd < best_rd * improve) | (rp < best_rp * improve)
        b_rp, b_rd = torch.minimum(best_rp, rp), torch.minimum(best_rd, rd)
        st = torch.where(improved, torch.zeros_like(stall), stall + 1)
        tol_p = spec.eps_abs + spec.eps_rel * p_ref
        strict = (rp <= tol_p) & (rd <= spec.eps_abs + spec.eps_rel * d_ref)
        plateau = (st >= stall_checks) & (rp <= tol_p) & (rd <= spec.dual_plateau_cap * d_ref)

        keep = lambda new, old: torch.where(active.unsqueeze(1) if old.dim() == 2 else active, new, old)  # noqa: E731
        x, y, z, Ax = keep(x_n, x), keep(y_n, y), keep(z_n, z), keep(Ax_n, Ax)
        it = keep(it + K, it)
        r_prim, r_dual, best_rp, best_rd = keep(rp, r_prim), keep(rd, r_dual), keep(b_rp, best_rp), keep(b_rd, best_rd)
        stall = keep(st, stall)
        done = keep(strict | plateau, done)
        active = ~done & (it < spec.max_iter)

    # The usable-dispatch band: primal within feas_band_factor × its strict
    # tolerance, p_ref from the exit iterate.
    p_ref_exit = _p_ref(spec, Ax, z)
    feasible = bounds_ok & (r_prim <= spec.feas_band_factor * (spec.eps_abs + spec.eps_rel * p_ref_exit))
    return DCOPFSolution(x=spec.D * x, warm=(x, y, z, Ax), iterations=it, r_prim=r_prim, r_dual=r_dual,
                         converged=done & bounds_ok, bounds_ok=bounds_ok, feasible=feasible)


# ----------------------------------------------------------------------
# The controller (vec/controllers.py protocol)
# ----------------------------------------------------------------------

def make_vec_mpc(
    env,
    gamma: float,
    safety_margin: float = 0.9,
    planning_steps: int = 1,
    rho: float = 1.0,
    rho_eq_factor: float = 1e2,
    max_iter: int = 48,
    eps_abs: float = 1e-5,
    eps_rel: float = 1e-5,
    dual_stall_limit: int = 100,
    check_every: int = 8,
    forecast_fn=None,
    receding_warm: Optional[bool] = None,
    name: Optional[str] = None,
):
    """An on-device π_MPC-N^constant for a :class:`~gym_anm_torch.vec.VecEnv`:
    ``Controller(name, init_carry, act)``, where ``act(noise, state, obs,
    carry)`` solves every lane's N-stage DC-OPF for its current loads,
    potentials and SoC (the reference ``MPCAgentConstant``'s constant
    forecast) and returns the stage-0 set-points in MW, Q = 0, taps at 1,
    clipped to the action box.  The carry is each lane's scaled ADMM state,
    so successive steps warm-start from the previous solution.  Lanes are
    idled (P = 0) only where the LP is unsolvable (``bounds_ok`` false), the
    host tier's HiGHS-failure branch; an unconverged iterate is applied.

    The default is a bounded real-time-iteration budget (``max_iter=48``,
    six checks of eight sweeps): the warm state keeps converging over the
    following steps while the plant acts (the JAX package measured
    closed-loop reward flat from budget 16 up on ANM6Easy).
    ``forecast_fn(state) -> (P_load [B, n_load(, N)], P_pot [B, n_gen_ns(,
    N)])`` in p.u. overrides the constant forecast (:func:`make_vec_mpc_perfect`).
    With ``receding_warm`` (the default for N > 1) the carry is shifted one
    stage before each solve (:func:`make_shift_warm`).
    """
    spec = env.spec
    structure = build_dcopf_structure(spec, env.task.delta_t, env.task.lamb, gamma, safety_margin, planning_steps)
    # The state's arrays are position-ordered: pin the assembly's ID-ordered
    # views to the same layout before wiring them together.
    lay = dcopf_layout(spec)
    dm = lay.dev_id_mapping
    assert np.array_equal([dm[i] for i in lay.load_ids], spec.load_pos)
    assert np.array_equal([dm[i] for i in lay.non_slack_gen_ids], spec.gen_nonslack_pos)
    assert np.array_equal([dm[i] for i in lay.des_ids], spec.des_pos)

    dc = make_vec_dcopf(structure, dtype=env.dtype, device=env.device, rho=rho, rho_eq_factor=rho_eq_factor,
                        max_iter=max_iter, eps_abs=eps_abs, eps_rel=eps_rel, dual_stall_limit=dual_stall_limit,
                        check_every=check_every)
    n_g = len(lay.non_slack_gen_ids)
    load_pos = torch.as_tensor(spec.load_pos, device=env.device)
    sl = env._action_slices
    if receding_warm is None:
        receding_warm = planning_steps > 1
    shift = make_shift_warm(dc, structure, planning_steps) if receding_warm else (lambda w: w)

    def init_carry(n):
        return init_warm(dc, n)

    def act(noise, state, obs, carry):
        with profiling.span("mpc.act"):
            if forecast_fn is None:
                P_load, P_pot = state.dev_p[:, load_pos], state.p_pot
            else:
                P_load, P_pot = forecast_fn(state)
            l, u = lane_bounds(dc, P_load, P_pot, state.soc)
            sol = solve_dcopf(dc, l, u, warm=shift(carry))
            P = torch.where(sol.bounds_ok.unsqueeze(1), sol.x[:, dc.act_idx], 0.0) * dc.baseMVA
            a = torch.zeros(l.shape[0], env.n_action, dtype=env.dtype, device=env.device)
            a[:, sl["P_gen"]] = P[:, :n_g].to(env.dtype)
            a[:, sl["P_des"]] = P[:, n_g:].to(env.dtype)
            a[:, sl["tap"]] = 1.0
            return torch.clamp(a, env.action_low, env.action_high), sol.warm

    return Controller(name or f"MPC{planning_steps}_constant", init_carry, act)


def profile_forecast_fn(env, planning_steps: int, tables_mw: Optional[tuple] = None):
    """``forecast_fn(state)`` gathering the next N stages of a task's periodic
    profile tables (p.u.), indexed by the ``aux`` time of day: stage k reads
    column ``(aux + k) mod T``, k = 1..N (the reference ``mpc_perfect.py``
    plans from ``t_start = state[-1] + 1`` and wraps by concatenating the
    tables).  ``tables_mw = (P_loads [n_load, T], P_maxs [n_gen_ns, T])`` in
    MW; the ANM6Easy daily profiles when the env runs ``anm6easy``."""
    if tables_mw is None:
        if env.task.name != "anm6easy":
            raise ValueError("profile_forecast_fn needs explicit tables_mw for task "
                             f"{env.task.name!r} (only anm6easy has built-in profiles)")
        tables_mw = (anm6easy_load_time_series(), anm6easy_gen_time_series())

    base = float(env.spec.baseMVA)
    loads_mw, maxs_mw = (np.asarray(t) for t in tables_mw)
    if loads_mw.shape[1] != maxs_mw.shape[1]:
        # A gather would wrap each table at its own period: refuse.
        raise ValueError(f"tables_mw periods differ: P_loads has {loads_mw.shape[1]} columns, "
                         f"P_maxs {maxs_mw.shape[1]}")
    loads_pu = torch.as_tensor(loads_mw / base, device=env.device).to(env.dtype).T.contiguous()  # [T, n_load]
    maxs_pu = torch.as_tensor(maxs_mw / base, device=env.device).to(env.dtype).T.contiguous()    # [T, n_gen_ns]
    T = loads_pu.shape[0]
    offs = torch.arange(1, planning_steps + 1, dtype=torch.int32, device=env.device)

    def forecast_fn(state):
        idx = torch.remainder(state.aux[:, -1].to(torch.int32).unsqueeze(1) + offs, T).long()  # [B, N]
        return loads_pu[idx].transpose(1, 2), maxs_pu[idx].transpose(1, 2)

    return forecast_fn


def make_vec_mpc_perfect(env, gamma: float, safety_margin: float = 0.9, planning_steps: int = 8,
                         tables_mw: Optional[tuple] = None, **kw):
    """π_MPC-N^perfect for a :class:`~gym_anm_torch.vec.VecEnv` over a task
    with known periodic profiles (the reference ``MPCAgentPerfect``, which is
    likewise ANM6-specific): :func:`make_vec_mpc` with
    :func:`profile_forecast_fn` as its forecast."""
    forecast_fn = profile_forecast_fn(env, planning_steps, tables_mw)
    return make_vec_mpc(env, gamma, safety_margin=safety_margin, planning_steps=planning_steps,
                        forecast_fn=forecast_fn, name=f"MPC{planning_steps}_perfect", **kw)
