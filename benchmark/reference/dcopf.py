"""Plain reference of the MPC controller's action: the N-stage DC-OPF of
gym-anm's π_MPC-N (Henry & Ernst 2021, §5) with perfect forecasts from the
task's daily profiles, solved by the fixed-budget ADMM iteration (OSQP's
scaled form, checked every ``check_every`` sweeps) that defines the
controller's action.

The LP is assembled from the frozen network tables by :mod:`.grid`'s
parse, the scaling and the KKT inverse are worked out here in float64, and
the iteration runs in float64 (or, for the control, float32 with TF32
products).  The iteration starts from a carried warm state: zeros at the
cold start, then the state that :func:`action` returns, shifted one stage;
or, at a step far from the cold start, the program's own carried state.
It imports no module of the measured program.
"""

import math

import numpy as np
import torch

from .grid import CLASSICAL, SLACK, Arith

BIG = 1e20


def _ruiz(A, c, iters=15):
    """OSQP's modified Ruiz equilibration (infinity norm) with cost scaling."""
    m, n = A.shape
    D, E, cs = np.ones(n), np.ones(m), 1.0
    for _ in range(iters):
        Ab = E[:, None] * A * D[None, :]
        col, row = np.abs(Ab).max(0), np.abs(Ab).max(1)
        col[col == 0], row[row == 0] = 1.0, 1.0
        D, E = D / np.sqrt(col), E / np.sqrt(row)
        qn = np.abs(cs * D * c).max()
        if qn > 0:
            cs /= np.sqrt(qn)
    return D, E, cs


class DCOPF:
    """The LP ``min cᵀx s.t. A_eq x = b_eq, A_ub x <= b_ub, lb <= x <= ub``
    of ``planning_steps`` stages, its per-lane slots, its OSQP scaling and
    the ADMM constants.  Variables a stage: [θ (buses), P (devices), p_ch,
    p_dis, SoC (storage), overflow slack (branches)]; rows a stage: the DC
    balance of each bus, P_des = p_dis - p_ch, the SoC recursion, then two
    overflow rows a branch; then one identity row a variable."""

    def __init__(self, net, delta_t, lamb, gamma, safety_margin, planning_steps, rho=1.0, rho_eq_factor=1e2,
                 sigma=1e-6, alpha=1.6, max_iter=48, eps_abs=1e-5, eps_rel=1e-5, check_every=8):
        N, nb, nd_, ndes, nbr = planning_steps, net.n_bus, net.n_dev, len(net.des), len(net.br_f)
        sn = nb + nd_ + 3 * ndes + nbr
        n = N * sn
        # Susceptances at the initial taps: off-diagonal entries assigned, as gym-anm's MPC agent reads them.
        Bm = np.zeros((nb, nb))
        tau = net.br_tap0 * np.exp(1j * net.br_shift)
        for k in range(nbr):
            f, t = net.br_f[k], net.br_t[k]
            Bm[f, t] = (-net.br_y[k] / np.conj(tau[k])).imag
            Bm[t, f] = (-net.br_y[k] / tau[k]).imag
            Bm[f, f] += ((net.br_y[k] + 1j * net.br_bsh[k]) / abs(tau[k]) ** 2).imag
            Bm[t, t] += (net.br_y[k] + 1j * net.br_bsh[k]).imag
        c = np.zeros(n)
        lb, ub = np.full(n, -np.inf), np.full(n, np.inf)
        A_eq, b_eq, A_ub, b_ub = [], [], [], []
        load_idx, gen_idx = np.zeros((len(net.loads), N), int), np.zeros((len(net.gens), N), int)
        soc_rows = np.zeros(ndes, int)
        for s in range(N):
            th, P = s * sn, s * sn + nb
            pch, pdis, soc, tb = P + nd_, P + nd_ + ndes, P + nd_ + 2 * ndes, P + nd_ + 3 * ndes
            disc = gamma ** s
            for k in np.where((net.dev_type == SLACK) | (net.dev_type == CLASSICAL))[0]:
                c[P + k] += disc  # the cost of non-renewable generation, the slack's included
            c[tb:tb + nbr] += disc * lamb
            lb[th:th + nb], ub[th:th + nb] = -np.pi, np.pi
            # gym-anm pins θ at the index of the slack's device position.
            lb[th + net.slack_dev], ub[th + net.slack_dev] = 0.0, 0.0
            for i, k in enumerate(net.loads):
                load_idx[i, s] = P + k
                lb[P + k], ub[P + k] = 0.0, 0.0
            for i, k in enumerate(net.gens):
                gen_idx[i, s] = P + k
                lb[P + k], ub[P + k] = net.p_min[k], net.p_max[k]
            for i, k in enumerate(net.des):
                lb[P + k], ub[P + k] = net.p_min[k], net.p_max[k]
                lb[pch + i], lb[pdis + i] = 0.0, 0.0
                lb[soc + i], ub[soc + i] = net.soc_min[k], net.soc_max[k]
            lb[tb:tb + nbr] = 0.0
            for bus in range(nb):
                row = np.zeros(n)
                for k in range(nbr):
                    f, t = net.br_f[k], net.br_t[k]
                    if f == bus:
                        row[th + f] += Bm[f, t]
                        row[th + t] -= Bm[f, t]
                    elif t == bus:
                        row[th + t] += Bm[t, f]
                        row[th + f] -= Bm[t, f]
                for k in range(nd_):
                    if net.dev_bus[k] == bus:
                        row[P + k] -= 1.0
                A_eq.append(row)
                b_eq.append(0.0)
            for i, k in enumerate(net.des):
                row = np.zeros(n)
                row[P + k], row[pdis + i], row[pch + i] = 1.0, -1.0, 1.0
                A_eq.append(row)
                b_eq.append(0.0)
            for i, k in enumerate(net.des):
                row = np.zeros(n)
                row[soc + i], row[pch + i], row[pdis + i] = 1.0, -delta_t * net.eff[k], delta_t / net.eff[k]
                if s == 0:
                    soc_rows[i] = len(A_eq)
                else:
                    row[(s - 1) * sn + nb + nd_ + 2 * ndes + i] = -1.0
                A_eq.append(row)
                b_eq.append(0.0)
            for k in range(nbr):
                if not np.isfinite(net.br_rate[k]):
                    continue
                f, t = net.br_f[k], net.br_t[k]
                for sign in (1.0, -1.0):
                    row = np.zeros(n)
                    row[th + f] += sign * Bm[f, t]
                    row[th + t] -= sign * Bm[f, t]
                    row[tb + k] = -1.0
                    A_ub.append(row)
                    b_ub.append(safety_margin * net.br_rate[k])
        A_eq, A_ub = np.array(A_eq), np.array(A_ub).reshape(-1, n)
        n_eq, n_ub = len(A_eq), len(A_ub)
        A = np.vstack([A_eq, A_ub, np.eye(n)])
        l = np.concatenate([b_eq, np.full(n_ub, -np.inf), lb])
        u = np.concatenate([b_eq, b_ub, ub])
        self.l_tmpl, self.u_tmpl = np.where(np.isfinite(l), l, -BIG), np.where(np.isfinite(u), u, BIG)
        D, E, cs = _ruiz(A, c)
        Ab = E[:, None] * A * D[None, :]
        is_eq = np.abs(self.u_tmpl - self.l_tmpl) < 1e-12
        self.rho = np.where(is_eq, rho_eq_factor * rho, rho)
        M = sigma * np.eye(n) + Ab.T @ (self.rho[:, None] * Ab)
        Minv = np.linalg.inv(M)
        self.A_bar, self.P_pack = Ab, np.concatenate([Minv, Ab @ Minv], 0)
        self.q_bar, self.D, self.E, self.c_scale = cs * D * c, D, E, cs
        self.q_ref = np.abs(self.q_bar / D).max() / cs
        bound0 = n_eq + n_ub
        self.load_rows, self.gen_rows = bound0 + load_idx, bound0 + gen_idx
        self.soc_rows = soc_rows
        self.gen_pmax = net.p_max[net.gens]
        self.act_idx = np.array([P0 for P0 in net.gens] + [P0 for P0 in net.des]) + nb
        self.n, self.m, self.N = n, A.shape[0], N
        self.n_eq, self.n_ub, self.stage_n = n_eq, n_ub, sn
        self.sigma, self.alpha, self.max_iter = sigma, alpha, max_iter
        self.eps_abs, self.eps_rel, self.K = eps_abs, eps_rel, check_every
        self.stall_checks = -(-100 // check_every)
        self.baseMVA = net.baseMVA

    def shift_maps(self):
        """(variable sources, row sources) of the receding-horizon shift: each
        stage block takes the next one's values, the last stage keeps its own."""
        N = self.N

        def src(count, per):
            i = np.arange(count)
            return np.where(i < count - per, i + per, i)

        var = src(self.n, self.stage_n)
        rows = np.concatenate([src(self.n_eq, self.n_eq // N), self.n_eq + src(self.n_ub, self.n_ub // N),
                               self.n_eq + self.n_ub + var])
        return var, rows


def perfect_forecast(profiles, aux, N, baseMVA):
    """Stage k = 1..N reads the profile column (t + k) mod T, t the lane's
    time index: [B, rows, N] in p.u."""
    T = profiles.shape[1]
    idx = torch.remainder(aux.long().unsqueeze(1) + torch.arange(1, N + 1, device=aux.device), T)
    return profiles[:, idx].permute(1, 0, 2) / baseMVA


def cold(lp, B, device, dtype=torch.float64):
    """The cold-start ADMM state of ``B`` lanes: zeros."""
    z = torch.zeros(B, lp.m, dtype=dtype, device=device)
    return torch.zeros(B, lp.n, dtype=dtype, device=device), z, z.clone(), z.clone()


def action(lp, net, warm, P_load, P_pot, soc, action_low, action_high, precision="f64", shift=True):
    """The controller's action [B, n_action] in MW for the forecasts
    ``P_load`` [B, n_load, N], ``P_pot`` [B, n_gen, N] (p.u.) and the SoC
    [B, n_des] (p.u.), from the carried scaled ADMM state ``warm`` =
    (x̄, ȳ, z̄, Āx̄); also the lanes' iterations and the state to carry to
    the next step (unshifted)."""
    ar = Arith(precision)
    dt, dev = ar.dtype, soc.device
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev).to(dt)  # noqa: E731
    B = soc.shape[0]
    x, y, z, _ = (w.to(dt) for w in warm)
    A_bar, P_pack, rho, q_bar = t(lp.A_bar), t(lp.P_pack), t(lp.rho), t(lp.q_bar)
    D, E = t(lp.D), t(lp.E)
    if shift and lp.N > 1:
        var, rows = lp.shift_maps()
        x = x[:, var] * t(lp.D[var] / lp.D)
        y = y[:, rows] * t(lp.E[rows] / lp.E)
        z = z[:, rows] * t(lp.E / lp.E[rows])
    Ax = ar.mm(x, A_bar.T)
    l = t(lp.l_tmpl).expand(B, -1).clone()
    u = t(lp.u_tmpl).expand(B, -1).clone()
    lr = torch.as_tensor(lp.load_rows.reshape(-1), device=dev)
    l[:, lr] = P_load.to(dt).reshape(B, -1)
    u[:, lr] = P_load.to(dt).reshape(B, -1)
    gr = torch.as_tensor(lp.gen_rows.reshape(-1), device=dev)
    u[:, gr] = torch.minimum(t(lp.gen_pmax)[:, None], P_pot.to(dt)).reshape(B, -1)
    sr = torch.as_tensor(lp.soc_rows, device=dev)
    l[:, sr], u[:, sr] = soc.to(dt), soc.to(dt)
    l_bar = torch.where(l <= -BIG, torch.full_like(l, -BIG), E * l)
    u_bar = torch.where(u >= BIG, torch.full_like(u, BIG), E * u)
    ok = (l <= u).all(1)
    a, b = lp.alpha, 1.0 - lp.alpha
    inf = torch.full((B,), math.inf, dtype=dt, device=dev)
    it = torch.zeros(B, dtype=torch.int64, device=dev)
    best_p, best_d, stall = inf, inf, torch.zeros_like(it)
    done = ~ok
    improve = 1.0 - 1e-3 * lp.K
    while True:
        active = ~done & (it < lp.max_iter)
        if not bool(active.any()):
            break
        s = (x, y, z, Ax)
        for _ in range(lp.K):
            xs, ys, zs, Axs = s
            rhs = lp.sigma * xs - q_bar + ar.mm(rho * zs - ys, A_bar)
            w = ar.mm(rhs, P_pack.T)
            zp = a * w[:, lp.n:] + b * zs + ys / rho
            zn = torch.minimum(torch.maximum(zp, l_bar), u_bar)
            s = (a * w[:, :lp.n] + b * xs, rho * (zp - zn), zn, a * w[:, lp.n:] + b * Axs)
        xn, yn, zn, Axn = s
        ty = ar.mm(yn, A_bar)
        rp = ((Axn - zn) / E).abs().amax(1)
        rd = ((q_bar + ty) / D).abs().amax(1) / lp.c_scale
        p_ref = torch.maximum((Axn / E).abs().amax(1), (zn / E).abs().amax(1))
        d_ref = torch.clamp((ty / D).abs().amax(1) / lp.c_scale, min=lp.q_ref)
        improved = (rd < best_d * improve) | (rp < best_p * improve)
        st = torch.where(improved, torch.zeros_like(stall), stall + 1)
        tol_p = lp.eps_abs + lp.eps_rel * p_ref
        strict = (rp <= tol_p) & (rd <= lp.eps_abs + lp.eps_rel * d_ref)
        plateau = (st >= lp.stall_checks) & (rp <= tol_p) & (rd <= d_ref)
        k1 = active.unsqueeze(1)
        x, y, z, Ax = (torch.where(k1, new, old) for new, old in ((xn, x), (yn, y), (zn, z), (Axn, Ax)))
        it = torch.where(active, it + lp.K, it)
        best_p = torch.where(active, torch.minimum(best_p, rp), best_p)
        best_d = torch.where(active, torch.minimum(best_d, rd), best_d)
        stall = torch.where(active, st, stall)
        done = torch.where(active, strict | plateau, done)
    P = torch.where(ok.unsqueeze(1), (D * x)[:, torch.as_tensor(lp.act_idx, device=dev)], 0.0) * lp.baseMVA
    ng, ndes = len(net.gens), len(net.des)
    act = torch.zeros(B, net.n_action, dtype=torch.float64, device=dev)
    act[:, :ng] = P[:, :ng].double()
    act[:, 2 * ng:2 * ng + ndes] = P[:, ng:].double()
    act[:, 2 * ng + 2 * ndes + len(net.caps):] = 1.0
    lo, hi = (torch.as_tensor(v, device=dev, dtype=torch.float64) for v in (action_low, action_high))
    return torch.minimum(torch.maximum(act, lo), hi), it, (x, y, z, Ax)


def action_box(net):
    """The action space's bounds in MW/MVAr and tap ratios, in the layout
    [P_gen, Q_gen, P_des, Q_des, Q_cap, tap]."""
    base, g, d, c = net.baseMVA, net.gens, net.des, net.caps
    lo = np.concatenate([net.p_min[g], net.q_min[g], net.p_min[d], net.q_min[d], net.q_min[c]]) * base
    hi = np.concatenate([net.p_max[g], net.q_max[g], net.p_max[d], net.q_max[d], net.q_max[c]]) * base
    taps = [net.tap_bounds[k] for k in net.oltcs]
    return (np.concatenate([lo, [t[1] for t in taps]]), np.concatenate([hi, [t[2] for t in taps]]))

