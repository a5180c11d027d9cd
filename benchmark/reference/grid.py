"""Plain reference of one environment step of the measured grid tasks.

A straightforward float64 implementation of gym-anm's step semantics, from
the network tables frozen beside this file: the device set-point rules
(clips, the exact Euclidean projection onto each generator's and storage
unit's (P, Q) polygon, the state-of-charge update), the OLTC tap, the AC load
flow (Newton-Raphson in polar form from the flat start, to 1e-10), branch
flows, reward, termination and the observation of the full MDP state.

It imports no module of the measured program.  It runs on any torch device,
lanes in blocks.  ``precision="tf32"`` computes the same step in float32
with every matrix product's operands rounded to TF32's 10-bit mantissa: the
control that a comparison at the benchmark's limits has to reject.
"""

import json
import math
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

LOAD, SLACK, CLASSICAL, RENEWABLE, STORAGE, CAPACITOR, OLTC = -1, 0, 1, 2, 3, 4, 5
DEV_COLS = ("DEV_ID", "BUS_ID", "DEV_TYPE", "Q/P", "PMAX", "PMIN", "QMAX", "QMIN", "P+", "P-", "Q+", "Q-",
            "SOC_MAX", "SOC_MIN", "EFF")
NR_TOL = 1e-10      # the reference's own load flow converges far below the program's 1e-5
NR_MAX_ITER = 100   # the task's iteration limit (gym-anm's simulator)


def _f(v, default=np.nan):
    return default if v is None else float(v)


class Network:
    """gym-anm's network tables parsed into per-unit float64 arrays (devices
    in ID order, buses in ID order, branches in table order).  Only the rules
    of the device types the measured tasks hold are written down."""

    def __init__(self, raw):
        base = float(raw["baseMVA"])
        self.baseMVA = base
        bus = sorted(raw["bus"], key=lambda r: r[0])
        self.n_bus = len(bus)
        bus_pos = {int(r[0]): k for k, r in enumerate(bus)}
        self.bus_vmax = np.array([r[3] for r in bus], float)
        self.bus_vmin = np.array([-np.inf if r[1] == 0 and r[4] is None else r[4] for r in bus], float)
        br = raw["branch"]
        self.br_f = np.array([bus_pos[int(r[0])] for r in br])
        self.br_t = np.array([bus_pos[int(r[1])] for r in br])
        self.br_y = 1.0 / (np.array([r[2] for r in br]) + 1j * np.array([r[3] for r in br]))
        self.br_bsh = np.array([_f(r[4], 0.0) for r in br]) / 2.0
        self.br_rate = np.array([np.inf if r[5] is None else r[5] / base for r in br])
        self.br_tap0 = np.array([_f(r[6], 1.0) for r in br])
        self.br_shift = np.array([_f(r[7], 0.0) for r in br]) * np.pi / 180.0

        devs = sorted(raw["device"], key=lambda r: r[0])
        self.n_dev = len(devs)
        col = {c: i for i, c in enumerate(DEV_COLS)}
        get = lambda r, c: r[col[c]]  # noqa: E731
        self.dev_type = np.array([int(get(r, "DEV_TYPE")) for r in devs])
        self.dev_bus = np.array([bus_pos[int(get(r, "BUS_ID"))] for r in devs])
        n = self.n_dev
        p_min, p_max, q_min, q_max = (np.zeros(n) for _ in range(4))
        self.qp = np.full(n, np.nan)
        self.soc_min, self.soc_max, self.eff = np.full(n, np.nan), np.full(n, np.nan), np.full(n, np.nan)
        self.polygon = {}   # device position -> (upper lines [(t, r)], lower lines [(t, r)])
        self.tap_bounds = {}
        for k, r in enumerate(devs):
            t = self.dev_type[k]
            if t == LOAD:
                self.qp[k] = get(r, "Q/P")
                p_max[k] = _f(get(r, "PMAX"), 0.0)          # gym-anm keeps a load's PMAX in MW (0 here)
                p_min[k] = get(r, "PMIN") / base
                q_max[k], q_min[k] = p_max[k] * self.qp[k], p_min[k] * self.qp[k]
            elif t in (SLACK, RENEWABLE, CLASSICAL, STORAGE):
                p_max[k], p_min[k] = get(r, "PMAX") / base, get(r, "PMIN") / base
                q_max[k], q_min[k] = get(r, "QMAX") / base, get(r, "QMIN") / base
                pp = p_max[k] if get(r, "P+") is None else get(r, "P+") / base
                qp_ = q_max[k] if get(r, "Q+") is None else get(r, "Q+") / base
                qm = q_min[k] if get(r, "Q-") is None else get(r, "Q-") / base
                # The right-hand corner cut: q <= t1 p + r1 and q >= t2 p + r2.
                t1 = 0.0 if p_max[k] == pp else (qp_ - q_max[k]) / (p_max[k] - pp)
                t2 = 0.0 if p_max[k] == pp else (qm - q_min[k]) / (p_max[k] - pp)
                upper, lower = [(t1, q_max[k] - t1 * pp)], [(t2, q_min[k] - t2 * pp)]
                if t == STORAGE:
                    pm = p_min[k] if get(r, "P-") is None else get(r, "P-") / base
                    # The left-hand corner cut: q >= t3 p + r3 and q <= t4 p + r4.
                    t3 = 0.0 if p_min[k] == pm else (q_min[k] - qm) / (pm - p_min[k])
                    t4 = 0.0 if p_min[k] == pm else (q_max[k] - qp_) / (pm - p_min[k])
                    lower.append((t3, q_min[k] - t3 * pm))
                    upper.append((t4, q_max[k] - t4 * pm))
                    self.soc_max[k] = get(r, "SOC_MAX") / base
                    self.soc_min[k] = _f(get(r, "SOC_MIN"), 0.0) / base
                    self.eff[k] = _f(get(r, "EFF"), 1.0)
                if t != SLACK:
                    self.polygon[k] = (upper, lower)
            elif t == CAPACITOR:
                q_max[k], q_min[k] = _f(get(r, "QMAX"), 0.0) / base, _f(get(r, "QMIN"), 0.0) / base
            elif t == OLTC:
                f_bus, t_bus = self.dev_bus[k], bus_pos[int(get(r, "Q/P"))]
                branch = [i for i in range(len(br)) if self.br_f[i] == f_bus and self.br_t[i] == t_bus][0]
                self.tap_bounds[k] = (branch, _f(get(r, "PMIN"), 1.0), _f(get(r, "PMAX"), 1.0))
            else:
                raise ValueError(f"device type {t} is not written down in the reference")
        self.p_min, self.p_max, self.q_min, self.q_max = p_min, p_max, q_min, q_max
        ty = self.dev_type
        self.loads = np.where(ty == LOAD)[0]
        self.gens = np.where((ty == RENEWABLE) | (ty == CLASSICAL))[0]
        self.renewables = np.where(ty == RENEWABLE)[0]
        self.des = np.where(ty == STORAGE)[0]
        self.caps = np.where(ty == CAPACITOR)[0]
        self.oltcs = np.where(ty == OLTC)[0]
        self.slack_dev = int(np.where(ty == SLACK)[0][0])
        self.genload = np.where(np.isin(ty, (LOAD, SLACK, CLASSICAL, RENEWABLE)))[0]
        self.n_action = 2 * len(self.gens) + 2 * len(self.des) + len(self.caps) + len(self.oltcs)
        # The observation's bounds: the MDP state [P, Q of every device, SoC, P_max of the
        # generators, aux], with gym-anm's Q_max in the generators' P_max slot.
        self.obs_low = np.concatenate([p_min * base, q_min * base, self.soc_min[self.des] * base,
                                       p_min[self.gens] * base])
        self.obs_high = np.concatenate([p_max * base, q_max * base, self.soc_max[self.des] * base,
                                        q_max[self.gens] * base])


def load(name, directory=HERE):
    """(Network, the file's other tables) of ``<name>_network.json`` in
    ``directory``."""
    raw = json.loads((Path(directory) / f"{name}_network.json").read_text())
    return Network(raw["network"]), raw


# ----------------------------------------------------------------------
# arithmetic at a precision
# ----------------------------------------------------------------------

class Arith:
    """float64, or float32 with TF32 products (the control)."""

    def __init__(self, precision):
        if precision not in ("f64", "tf32"):
            raise ValueError(precision)
        self.tf32 = precision == "tf32"
        self.dtype = torch.float32 if self.tf32 else torch.float64

    def mm(self, a, b):
        """a @ b; under TF32 both operands keep 10 bits of mantissa (rounded to
        nearest), and their products are summed in float64 and rounded once to
        float32: kinder than the tensor cores' float32 sums, so a comparison
        that rejects this control rejects theirs too."""
        if not self.tf32:
            return a @ b
        return (_tf32(a).double() @ _tf32(b).double()).float()


def _tf32(x):
    x = x.float().contiguous()
    bits = x.view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


# ----------------------------------------------------------------------
# the step
# ----------------------------------------------------------------------

def project_polygon(px, py, p_lo, p_hi, q_lo, q_hi, upper, lower):
    """Euclidean projection of (px, py) [B] onto {p_lo <= p <= p_hi, q_lo <= q
    <= q_hi, q <= t p + r for (t, r) in upper, q >= t p + r in lower}: the
    nearest of the point itself, each line's foot and each pair of lines'
    crossing, among those inside the polygon."""
    rows = [(-1.0, 0.0, -p_lo), (1.0, 0.0, p_hi), (0.0, -1.0, -q_lo), (0.0, 1.0, q_hi)]
    rows += [(-t, 1.0, r) for t, r in upper] + [(t, -1.0, -r) for t, r in lower]
    B = px.shape[0]
    full = lambda v: torch.as_tensor(v, dtype=px.dtype, device=px.device).expand(B)  # noqa: E731
    rows = [(a, b, full(c)) for a, b, c in rows]

    def inside(x, y):
        ok = torch.ones_like(x, dtype=torch.bool)
        for a, b, c in rows:
            ok &= a * x + b * y <= c + 1e-10 * (1.0 + c.abs())
        return ok

    cands = [(px, py)]
    for a, b, c in rows:  # foot of the perpendicular on a·x + b·y = c
        s = (a * px + b * py - c) / (a * a + b * b)
        cands.append((px - s * a, py - s * b))
    for i in range(len(rows)):
        for j in range(i + 1, len(rows)):
            a1, b1, c1 = rows[i]
            a2, b2, c2 = rows[j]
            det = a1 * b2 - a2 * b1
            if det == 0.0:
                continue
            cands.append(((c1 * b2 - c2 * b1) / det, (a1 * c2 - a2 * c1) / det))
    best = torch.full_like(px, math.inf)
    bx, by = px.clone(), py.clone()
    for cx, cy in cands:
        d2 = torch.where(inside(cx, cy), (cx - px) ** 2 + (cy - py) ** 2, torch.full_like(px, math.inf))
        take = d2 < best
        best, bx, by = torch.where(take, d2, best), torch.where(take, cx, bx), torch.where(take, cy, by)
    return bx, by


def ybus(net, tap, ar):
    """Per-lane bus admittance (Y_re, Y_im) [B, N, N] for the branch taps
    ``tap`` [B, n_branch] (the pi model with the tap on the from side)."""
    B, N, dt, dev = tap.shape[0], net.n_bus, ar.dtype, tap.device
    y = torch.as_tensor(net.br_y, device=dev)
    ysh = 1j * torch.as_tensor(net.br_bsh, device=dev)
    tau = tap.to(torch.complex128) * torch.exp(1j * torch.as_tensor(net.br_shift, device=dev))
    Y = torch.zeros(B, N, N, dtype=torch.complex128, device=dev)
    f, t = torch.as_tensor(net.br_f, device=dev), torch.as_tensor(net.br_t, device=dev)
    for k in range(len(net.br_f)):
        fk, tk = int(f[k]), int(t[k])
        Y[:, fk, fk] += (y[k] + ysh[k]) / tau[:, k].abs() ** 2
        Y[:, fk, tk] += -y[k] / tau[:, k].conj()
        Y[:, tk, fk] += -y[k] / tau[:, k]
        Y[:, tk, tk] += y[k] + ysh[k]
    return Y.real.to(dt), Y.imag.to(dt)


def _current(Yr, Yi, vr, vi, ar):
    """I = Y V for a batch: [B, N, N] x [B, N]."""
    mv = lambda A, x: ar.mm(A, x.unsqueeze(2)).squeeze(2)  # noqa: E731
    return mv(Yr, vr) - mv(Yi, vi), mv(Yr, vi) + mv(Yi, vr)


def load_flow(Yr, Yi, p, q, ar):
    """Newton-Raphson from the flat start with the slack bus (position 0) at
    1 + 0j.  ``p``, ``q`` [B, N-1] are the non-slack injections.  Returns
    (v_re, v_im [B, N], converged [B]): converged when the mismatch's
    infinity norm falls to NR_TOL within NR_MAX_ITER iterations."""
    B, N = p.shape[0], p.shape[1] + 1
    dt, dev = Yr.dtype, Yr.device
    tol = NR_TOL if dt == torch.float64 else 1e-5
    th = torch.zeros(B, N, dtype=dt, device=dev)
    vm = torch.ones(B, N, dtype=dt, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    Y = torch.complex(Yr, Yi)
    history = []
    for it in range(NR_MAX_ITER + 1):
        vr, vi = vm * torch.cos(th), vm * torch.sin(th)
        ir, ii = _current(Yr, Yi, vr, vi, ar)
        F = torch.cat([vr * ir + vi * ii - torch.cat([p.new_zeros(B, 1), p], 1),
                       vi * ir - vr * ii - torch.cat([q.new_zeros(B, 1), q], 1)], 1)
        F = torch.cat([F[:, 1:N], F[:, N + 1:]], 1)
        err = F.abs().amax(1)
        done = done | (err <= tol)
        # Stop where no lane still iterating has halved its mismatch in 10
        # iterations: those lanes are not converging (a float64 load flow that
        # converges does so in a few).
        history.append(err)
        stuck = it >= 10 and not bool((~done & (err < 0.5 * history[-11])).any())
        if bool(done.all()) or stuck:
            break
        V = torch.complex(vr, vi)
        I = torch.complex(ir, ii)
        # dS/dθ = j diag(V) conj(diag(I) - Y diag(V)), dS/d|V| = diag(V) conj(Y diag(V/|V|))
        # + conj(diag(I)) diag(V/|V|), entry by entry.
        VYV = V.unsqueeze(2) * torch.conj(Y) * torch.conj(V).unsqueeze(1)
        dS_dth = 1j * (torch.diag_embed(V * torch.conj(I)) - VYV)
        dS_dvm = VYV / vm.unsqueeze(1) + torch.diag_embed(torch.conj(I) * V / vm)
        J = torch.cat([torch.cat([dS_dth.real[:, 1:, 1:], dS_dvm.real[:, 1:, 1:]], 2),
                       torch.cat([dS_dth.imag[:, 1:, 1:], dS_dvm.imag[:, 1:, 1:]], 2)], 1)
        dx = torch.linalg.solve_ex(J, -F.unsqueeze(2))[0].squeeze(2)
        move = (~done).unsqueeze(1) & torch.isfinite(dx).all(1, keepdim=True)
        dx = torch.where(move, dx, torch.zeros_like(dx))
        th = th + torch.cat([dx.new_zeros(B, 1), dx[:, :N - 1]], 1)
        vm = vm + torch.cat([dx.new_zeros(B, 1), dx[:, N - 1:]], 1)
    converged = done & torch.isfinite(th).all(1) & torch.isfinite(vm).all(1)
    return vm * torch.cos(th), vm * torch.sin(th), converged


def transition(net, P_load, P_pot, action, soc, task, ar):
    """One grid transition of every lane, from gym-anm's rules.  MW/MVAr in,
    per unit out; returns a dict of the step's quantities."""
    base, dt = net.baseMVA, ar.dtype
    dev = action.device
    c = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev).to(dt)  # noqa: E731
    B = action.shape[0]
    action, soc = action.to(dt), soc.to(dt)
    ng, nd, nc = len(net.gens), len(net.des), len(net.caps)
    a_pg, a_qg = action[:, :ng], action[:, ng:2 * ng]
    a_pd, a_qd = action[:, 2 * ng:2 * ng + nd], action[:, 2 * ng + nd:2 * ng + 2 * nd]
    a_qc, a_tap = action[:, 2 * ng + 2 * nd:2 * ng + 2 * nd + nc], action[:, 2 * ng + 2 * nd + nc:]
    P = torch.zeros(B, net.n_dev, dtype=dt, device=dev)
    Q = torch.zeros_like(P)

    p_l = torch.minimum(torch.maximum(P_load.to(dt) / base, c(net.p_min[net.loads])), c(net.p_max[net.loads]))
    P[:, net.loads], Q[:, net.loads] = p_l, p_l * c(net.qp[net.loads])

    p_pot = torch.minimum(torch.maximum(P_pot.to(dt) / base, c(net.p_min[net.gens])), c(net.p_max[net.gens]))
    for i, k in enumerate(net.gens):
        up, lo = net.polygon[k]
        hi = torch.minimum(c(net.p_max[k]).expand(B), p_pot[:, i])
        P[:, k], Q[:, k] = project_polygon(a_pg[:, i] / base, a_qg[:, i] / base, c(net.p_min[k]).expand(B), hi,
                                           net.q_min[k], net.q_max[k], up, lo)

    soc_new = soc.clone()
    for i, k in enumerate(net.des):
        up, lo = net.polygon[k]
        eff, dts = net.eff[k], task["delta_t"]
        p_lo = torch.maximum(c(net.p_min[k]).expand(B), (soc[:, i] - net.soc_max[k]) / (dts * eff))
        p_hi = torch.minimum(c(net.p_max[k]).expand(B), eff * (soc[:, i] - net.soc_min[k]) / dts)
        p, q = project_polygon(a_pd[:, i] / base, a_qd[:, i] / base, p_lo, p_hi, net.q_min[k], net.q_max[k], up, lo)
        P[:, k], Q[:, k] = p, q
        delta = torch.where(p <= 0, dts * eff * p, dts * p / eff)
        soc_new[:, i] = torch.clamp(soc[:, i] - delta, net.soc_min[k], net.soc_max[k])

    Q[:, net.caps] = torch.minimum(torch.maximum(a_qc / base, c(net.q_min[net.caps])), c(net.q_max[net.caps]))
    tap = torch.as_tensor(net.br_tap0, device=dev).to(dt).expand(B, -1).clone()
    taps = torch.zeros(B, len(net.oltcs), dtype=dt, device=dev)
    for i, k in enumerate(net.oltcs):
        branch, t_min, t_max = net.tap_bounds[k]
        taps[:, i] = torch.clamp(a_tap[:, i], t_min, t_max)
        tap[:, branch] = taps[:, i]

    onehot = torch.zeros(net.n_dev, net.n_bus, dtype=torch.float64, device=dev)
    onehot[torch.arange(net.n_dev), torch.as_tensor(net.dev_bus)] = 1.0
    Sp = (P.double() @ onehot).to(dt)
    Sq = (Q.double() @ onehot).to(dt)
    Yr, Yi = ybus(net, tap, ar)
    v_re, v_im, stable = load_flow(Yr, Yi, Sp[:, 1:], Sq[:, 1:], ar)
    i_re, i_im = _current(Yr, Yi, v_re, v_im, ar)
    s0_re = v_re[:, 0] * i_re[:, 0] + v_im[:, 0] * i_im[:, 0]
    s0_im = v_im[:, 0] * i_re[:, 0] - v_re[:, 0] * i_im[:, 0]
    P[:, net.slack_dev] = torch.nan_to_num(s0_re, nan=math.inf)
    Q[:, net.slack_dev] = torch.nan_to_num(s0_im, nan=math.inf)

    # Branch flows: s = v conj(i) at both ends, the signed larger of |s_from| and |s_to|.
    V = torch.complex(v_re.double(), v_im.double())
    y = torch.as_tensor(net.br_y, device=dev)
    ysh = 1j * torch.as_tensor(net.br_bsh, device=dev)
    tau = tap.double() * torch.exp(1j * torch.as_tensor(net.br_shift, device=dev))
    vf, vt = V[:, net.br_f], V[:, net.br_t]
    i_f = (y + ysh) * vf / tau.abs() ** 2 - y * vt / tau.conj()
    i_t = (y + ysh) * vt - y * vf / tau
    s_f, s_t = vf * i_f.conj(), vt * i_t.conj()
    s_signed = torch.sign(s_f.real) * torch.maximum(s_f.abs(), s_t.abs())
    # A lane whose reward turns on the sign of a from-end active flow that
    # float32 cannot resolve: sign(0) = 0 drops that branch's |s| from the
    # penalty.  Within 16 float32 ulps of the products it is a difference of.
    terms = vf.abs() * ((y + ysh).abs() * vf.abs() / tau.abs() ** 2 + y.abs() * vt.abs() / tau.abs())
    sign_unresolved = (s_f.real.abs() <= 16 * 2.0 ** -24 * terms).any(1)

    e_loss = P[:, net.genload].double().sum(1)
    if len(net.gens):
        rer = torch.as_tensor(np.isin(net.gens, net.renewables), device=dev)
        e_loss = e_loss + torch.where(rer, torch.clamp(p_pot - P[:, net.gens], min=0.0), 0.0).double().sum(1)
    e_loss = e_loss * task["delta_t"]
    vmag = V.abs()
    pen = (torch.clamp(vmag - torch.as_tensor(net.bus_vmax, device=dev), min=0.0)
           + torch.clamp(torch.as_tensor(net.bus_vmin, device=dev) - vmag, min=0.0)).sum(1)
    pen = pen + torch.clamp(s_signed.abs() - torch.as_tensor(net.br_rate, device=dev), min=0.0).sum(1)
    pen = pen * task["delta_t"] * task["lamb"]
    return dict(P=P.double(), Q=Q.double(), soc=soc_new.double(), p_pot=p_pot.double(), tap=taps.double(),
                v_re=v_re.double(), v_im=v_im.double(), stable=stable, e_loss=e_loss, penalty=pen,
                sign_unresolved=sign_unresolved)


def step(net, task, state, action, P_load, P_pot, aux, precision="f64"):
    """One MDP step (gym-anm's ``ANMEnv.step``) of every lane from the carried
    ``state`` (a dict with ``soc`` [B, n_des] p.u. and ``terminated`` [B])
    under ``action`` [B, n_action], with the exogenous ``P_load``/``P_pot``
    (MW) and ``aux`` [B, K] of the step.  Returns the transition's dict plus
    ``reward``, ``done`` and ``obs``."""
    ar = Arith(precision)
    out = transition(net, P_load, P_pot, action, state["soc"], task, ar)
    terminated = ~out["stable"]
    c1, c2 = task["costs_clipping"]
    e = torch.sign(out["e_loss"]) * torch.clamp(out["e_loss"].abs(), max=c1)
    pen = torch.clamp(out["penalty"], max=c2)
    reward = torch.where(terminated, torch.full_like(e, -c2 / (1.0 - task["gamma"])), -(e + pen))
    was = state["terminated"].to(action.device)
    reward = torch.where(was, torch.zeros_like(reward), reward)
    done = was | terminated
    base = net.baseMVA
    obs = torch.cat([out["P"] * base, out["Q"] * base, out["soc"] * base, out["p_pot"] * base, aux.double()], 1)
    dev = action.device
    low = torch.as_tensor(np.concatenate([net.obs_low, np.full(aux.shape[1], -np.inf)]), device=dev)
    high = torch.as_tensor(np.concatenate([net.obs_high, np.full(aux.shape[1], np.inf)]), device=dev)
    obs = torch.minimum(torch.maximum(obs, low), high)
    obs = torch.where(done.unsqueeze(1), torch.zeros_like(obs), obs)
    out.update(reward=reward, done=done, obs=obs, terminated_now=terminated)
    return out
