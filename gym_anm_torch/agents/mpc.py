"""The N-stage DC Optimal Power Flow of the MPC policies.

Port of the problem assembly of ``gym_anm_tpu/agents/mpc.py``
(``DCOPFStructure``, ``MPCAgent.__init__`` and ``MPCAgent._build_structure``),
fed from a :class:`~gym_anm_torch.specs.NetworkSpec` instead of a compat
``Simulator``.  The formulation is the reference's (``gym_anm/agents/mpc.py``):
DC assumptions (lossless lines, small angles, |V| ≈ 1), stage variables
{bus angles, device P, storage charge and discharge, SoC, branch-overflow
slacks}, constraints {DC flow equations from B = Im(Y_bus), pinned load
forecasts, generator and storage bounds, potential caps, the SoC recursion with
its efficiency, |θ| ≤ π, θ_slack = 0}, objective Σᵢ γⁱ (Σ non-renewable
generator P + λ Σ max(0, |P_br| − β·rate)) in epigraph form: one LP.

The device, bus and branch orders are those the ``Simulator`` builds from the
spec (devices and buses sorted by ID, branches in input order), and B_bus is
the imaginary part of its Y-bus at the initial taps ``spec.br_tap0``.  The
reference quirk ``slack_theta_idx = dm[slack_dev_id]`` (a device position used
as a bus index) is kept, and so are the stage-blocked layouts of variables and
rows that the receding-horizon warm-start shift relies on
(:func:`gym_anm_torch.vec.mpc.make_shift_warm`).

:func:`solve_highs` solves the LP on the host with scipy's HiGHS, as
``MPCAgent._solve`` does: the ground truth of the batched ADMM solver.

:class:`MPCAgent` and its two forecasters (``MPCAgentConstant``,
``MPCAgentPerfect``; JAX ``agents/mpc.py:57-365``) are the host policies over
a compat :class:`~gym_anm_torch.env.Simulator`: they assemble the LP with
:func:`build_dcopf_structure` at the simulator's branch rates and Y-bus and
solve it with :func:`solve_highs`.
"""

from typing import NamedTuple, Optional

import numpy as np
from scipy.optimize import linprog
from scipy.sparse import coo_matrix

from ..specs.constants import DEV_TYPE_LOAD, DEV_TYPE_STORAGE

__all__ = ["DCOPFStructure", "DCOPFLayout", "dcopf_layout", "susceptance_matrix", "build_dcopf_structure",
           "solve_highs", "MPCAgent", "MPCAgentConstant", "MPCAgentPerfect"]


class DCOPFStructure(NamedTuple):
    """The N-stage DC-OPF LP with its per-call slots factored out.

    Everything here is host numpy, built once per (network, horizon).  The
    LP is ``min cᵀx  s.t.  A_eq x = b_eq, A_ub x ≤ b_ub, lb ≤ x ≤ ub`` where
    the only per-call (and, in the batched tier, per-lane) values are

    * ``lb/ub[load_pin_idx]``  — pinned load forecasts,
    * ``ub[gen_cap_idx]``      — ``min(p_max, potential forecast)``,
    * ``b_eq[soc_rows]``       — the stage-0 SoC recursion RHS.
    """

    c: np.ndarray            # [n_var]
    lb: np.ndarray           # [n_var] template (placeholders at slots)
    ub: np.ndarray           # [n_var]
    A_eq: object             # scipy CSR [n_eq, n_var]
    b_eq: np.ndarray         # [n_eq] template
    A_ub: Optional[object]   # scipy CSR [n_ub, n_var] or None
    b_ub: Optional[np.ndarray]
    load_pin_idx: np.ndarray  # [n_load, N] variable indices
    gen_cap_idx: np.ndarray   # [n_gen_ns, N] variable indices
    gen_pmax: np.ndarray      # [n_gen_ns] static upper bounds
    soc_rows: np.ndarray      # [n_des] A_eq rows carrying init_soc
    act_idx: np.ndarray       # stage-0 P indices (non-slack gens + DES)
    baseMVA: float
    n_var: int


class DCOPFLayout(NamedTuple):
    """The ID orders and maps of ``MPCAgent.__init__``, from a spec."""

    load_ids: list
    gen_ids: list            # types 0, 1, 2
    non_slack_gen_ids: list  # types 1, 2
    gen_rer_ids: list        # type 2
    des_ids: list
    branch_ids: list         # (from bus ID, to bus ID), input order
    device_ids: list
    bus_ids: list
    slack_dev_id: int
    dev_to_bus: dict
    bus_id_mapping: dict     # bus ID -> position
    dev_id_mapping: dict     # device ID -> position


def dcopf_layout(spec) -> DCOPFLayout:
    """The device, bus and branch orders a ``Simulator`` gives the agent."""
    dev_ids = [int(i) for i in spec.dev_ids]
    types = {int(i): int(t) for i, t in zip(spec.dev_ids, spec.dev_type)}
    load_ids = [i for i in dev_ids if types[i] == DEV_TYPE_LOAD]
    non_slack_gen_ids = [i for i in dev_ids if types[i] in (1, 2)]
    des_ids = [i for i in dev_ids if types[i] == DEV_TYPE_STORAGE]
    return DCOPFLayout(
        load_ids=load_ids,
        gen_ids=[i for i in dev_ids if types[i] in (0, 1, 2)],
        non_slack_gen_ids=non_slack_gen_ids,
        gen_rer_ids=[i for i in dev_ids if types[i] == 2],
        des_ids=des_ids,
        branch_ids=[(int(spec.bus_ids[f]), int(spec.bus_ids[t])) for f, t in zip(spec.br_f, spec.br_t)],
        device_ids=dev_ids,
        bus_ids=[int(b) for b in spec.bus_ids],
        # The first device that is neither storage, a non-slack generator nor a
        # load, as the reference picks it.
        slack_dev_id=[i for i in dev_ids if i not in des_ids and i not in non_slack_gen_ids
                      and i not in load_ids][0],
        dev_to_bus={int(i): int(spec.bus_ids[b]) for i, b in zip(spec.dev_ids, spec.dev_bus)},
        bus_id_mapping={int(b): k for k, b in enumerate(spec.bus_ids)},
        dev_id_mapping={int(i): k for k, i in enumerate(spec.dev_ids)},
    )


def susceptance_matrix(spec):
    """Im(Y_bus) [N_bus, N_bus] at the initial taps ``spec.br_tap0``, built
    entry by entry as the compat ``Simulator.Y_bus`` builds it (the series
    admittance over the conjugate tap off the diagonal, assigned; the
    diagonal accumulated)."""
    n = spec.n_bus
    Y = np.zeros((n, n), dtype=np.complex128)
    tap = spec.br_tap0 * np.exp(1j * spec.br_shift)
    series = 1.0 / (spec.br_r + 1j * spec.br_x)
    shunt = 1j * spec.br_b / 2.0
    for k in range(spec.n_branch):
        f, t = spec.br_f[k], spec.br_t[k]
        Y[f, t] = -series[k] / np.conjugate(tap[k])
        Y[t, f] = -series[k] / tap[k]
        Y[f, f] += (series[k] + shunt[k]) / (np.abs(tap[k]) ** 2)
        Y[t, t] += series[k] + shunt[k]
    return Y.imag.copy()


def build_dcopf_structure(spec, delta_t, lamb, gamma, safety_margin=0.9, planning_steps=1, branch_rate=None,
                          B_bus=None) -> DCOPFStructure:
    """Assemble the ``planning_steps``-stage DC-OPF of network ``spec`` once,
    recording the per-call slots (:class:`DCOPFStructure`).  ``delta_t`` and
    ``lamb`` are the task's; branch rates are the spec's and B_bus is
    :func:`susceptance_matrix`, as a fresh ``Simulator`` has them, unless
    ``branch_rate`` [n_branch] and ``B_bus`` [N_bus, N_bus] give a
    simulator's current ones."""
    lay = dcopf_layout(spec)
    N = planning_steps
    n_bus, n_dev, n_des, n_load = spec.n_bus, spec.n_dev, spec.n_des, spec.n_load
    n_branch = spec.n_branch
    pos = lay.dev_id_mapping
    P_gen_min = [float(spec.p_min[pos[i]]) for i in lay.non_slack_gen_ids]
    P_gen_max = [float(spec.p_max[pos[i]]) for i in lay.non_slack_gen_ids]
    P_des_min = [float(spec.p_min[pos[i]]) for i in lay.des_ids]
    P_des_max = [float(spec.p_max[pos[i]]) for i in lay.des_ids]
    soc_min = [float(spec.soc_min[pos[i]]) for i in lay.des_ids]
    soc_max = [float(spec.soc_max[pos[i]]) for i in lay.des_ids]
    des_eff = [float(spec.eff[pos[i]]) for i in lay.des_ids]
    branch_rate = [float(r) for r in (spec.br_rate if branch_rate is None else branch_rate)]
    B_bus = susceptance_matrix(spec) if B_bus is None else np.asarray(B_bus)

    # Variable layout per stage: [theta (n_bus), P_dev (n_dev), pch (n_des),
    # pdis (n_des), soc (n_des), t_br (n_branch)].
    stage_n = n_bus + n_dev + 3 * n_des + n_branch

    def offsets(stage):
        o = {"theta": stage * stage_n}
        o["P"] = o["theta"] + n_bus
        o["pch"] = o["P"] + n_dev
        o["pdis"] = o["pch"] + n_des
        o["soc"] = o["pdis"] + n_des
        o["t"] = o["soc"] + n_des
        return o

    n_var = N * stage_n
    c = np.zeros(n_var)
    lb = np.full(n_var, -np.inf)
    ub = np.full(n_var, np.inf)
    eq_rows, eq_cols, eq_vals, eq_rhs = [], [], [], []
    ub_rows, ub_cols, ub_vals, ub_rhs = [], [], [], []
    n_eq = n_ub = 0
    load_pin_idx = np.zeros((n_load, N), dtype=np.int64)
    gen_cap_idx = np.zeros((len(lay.non_slack_gen_ids), N), dtype=np.int64)
    soc_rows = np.zeros(n_des, dtype=np.int64)

    bm, dm = lay.bus_id_mapping, lay.dev_id_mapping
    slack_theta_idx = dm[lay.slack_dev_id]  # reference quirk (gym_anm agents/mpc.py:302)

    for s in range(N):
        o = offsets(s)
        disc = gamma ** s

        # Objective: non-renewable generator P + λ·branch-overflow slack.
        for g in lay.gen_ids:
            if g not in lay.gen_rer_ids:
                c[o["P"] + dm[g]] += disc
        for k in range(n_branch):
            c[o["t"] + k] += disc * lamb

        # Bounds: |theta| <= pi, theta_slack = 0 (via bounds).
        lb[o["theta"]: o["theta"] + n_bus] = -np.pi
        ub[o["theta"]: o["theta"] + n_bus] = np.pi
        lb[o["theta"] + slack_theta_idx] = 0.0
        ub[o["theta"] + slack_theta_idx] = 0.0

        # Load P pinned to the forecast (slot; placeholder 0).
        for li, ld in enumerate(lay.load_ids):
            load_pin_idx[li, s] = o["P"] + dm[ld]
            lb[o["P"] + dm[ld]] = 0.0
            ub[o["P"] + dm[ld]] = 0.0

        # Generator bounds + potential cap (ub slot; placeholder p_max).
        for gi, g in enumerate(lay.non_slack_gen_ids):
            gen_cap_idx[gi, s] = o["P"] + dm[g]
            lb[o["P"] + dm[g]] = P_gen_min[gi]
            ub[o["P"] + dm[g]] = P_gen_max[gi]

        # DES bounds; pch/pdis >= 0; soc bounds.
        for di, d in enumerate(lay.des_ids):
            lb[o["P"] + dm[d]] = P_des_min[di]
            ub[o["P"] + dm[d]] = P_des_max[di]
            lb[o["pch"] + di] = 0.0
            lb[o["pdis"] + di] = 0.0
            lb[o["soc"] + di] = soc_min[di]
            ub[o["soc"] + di] = soc_max[di]

        # t_br >= 0.
        lb[o["t"]: o["t"] + n_branch] = 0.0

        # DC power balance per bus: sum over incident branches of
        # B_ij (θ_i − θ_j) equals the bus's device-P total.
        for i in lay.bus_ids:
            row = n_eq
            n_eq += 1
            for (j, k) in lay.branch_ids:
                bl, bk = bm[j], bm[k]
                if j == i:
                    b = B_bus[bl, bk]
                    eq_rows += [row, row]
                    eq_cols += [o["theta"] + bl, o["theta"] + bk]
                    eq_vals += [b, -b]
                elif k == i:
                    b = B_bus[bk, bl]
                    eq_rows += [row, row]
                    eq_cols += [o["theta"] + bk, o["theta"] + bl]
                    eq_vals += [b, -b]
            for d in lay.device_ids:
                if lay.dev_to_bus[d] == i:
                    eq_rows.append(row)
                    eq_cols.append(o["P"] + dm[d])
                    eq_vals.append(-1.0)
            eq_rhs.append(0.0)

        # P_des = pdis − pch.
        for di, d in enumerate(lay.des_ids):
            row = n_eq
            n_eq += 1
            eq_rows += [row, row, row]
            eq_cols += [o["P"] + dm[d], o["pdis"] + di, o["pch"] + di]
            eq_vals += [1.0, -1.0, 1.0]
            eq_rhs.append(0.0)

        # SoC recursion: soc_s − soc_{s−1} − ηΔt·pch + Δt/η·pdis = 0.
        for di in range(n_des):
            row = n_eq
            n_eq += 1
            eq_rows += [row, row, row]
            eq_cols += [o["soc"] + di, o["pch"] + di, o["pdis"] + di]
            eq_vals += [1.0, -delta_t * des_eff[di], delta_t / des_eff[di]]
            if s == 0:
                soc_rows[di] = row  # RHS = init_soc (slot; placeholder 0)
            else:
                eq_rows.append(row)
                eq_cols.append(offsets(s - 1)["soc"] + di)
                eq_vals.append(-1.0)
            eq_rhs.append(0.0)

        # Branch-overflow epigraph: ±B_ij(θ_i − θ_j) − t ≤ β·rate.
        for k, (i, j) in enumerate(lay.branch_ids):
            rate = branch_rate[k]
            if not np.isfinite(rate):
                continue
            bi, bj = bm[i], bm[j]
            b = B_bus[bi, bj]
            for sign in (1.0, -1.0):
                row = n_ub
                n_ub += 1
                ub_rows += [row, row, row]
                ub_cols += [o["theta"] + bi, o["theta"] + bj, o["t"] + k]
                ub_vals += [sign * b, -sign * b, -1.0]
                ub_rhs.append(safety_margin * rate)

    A_eq = coo_matrix((eq_vals, (eq_rows, eq_cols)), shape=(n_eq, n_var)).tocsr()
    A_ub = coo_matrix((ub_vals, (ub_rows, ub_cols)), shape=(n_ub, n_var)).tocsr() if n_ub else None
    o0 = offsets(0)
    act_idx = np.array([o0["P"] + dm[d] for d in lay.non_slack_gen_ids] + [o0["P"] + dm[d] for d in lay.des_ids],
                       dtype=np.int64)
    return DCOPFStructure(
        c=c, lb=lb, ub=ub, A_eq=A_eq, b_eq=np.array(eq_rhs),
        A_ub=A_ub, b_ub=np.array(ub_rhs) if n_ub else None,
        load_pin_idx=load_pin_idx, gen_cap_idx=gen_cap_idx,
        gen_pmax=np.array(P_gen_max, dtype=float),
        soc_rows=soc_rows, act_idx=act_idx,
        baseMVA=float(spec.baseMVA), n_var=n_var,
    )


def solve_highs(structure: DCOPFStructure, P_load, P_gen, init_soc):
    """Solve the LP with scipy's HiGHS for one set of slot values, as
    ``MPCAgent._solve`` does: ``P_load`` [n_load, N] and ``P_gen`` [n_gen_ns,
    N] forecasts and the stage-0 ``init_soc`` [n_des], all p.u.

    Returns ``(action, res)``: the stage-0 action [P_gen, Q_gen = 0, P_des,
    Q_des = 0] in MW (zeros, the idle fallback, when HiGHS fails) and
    ``linprog``'s result."""
    st = structure
    lb, ub, b_eq = st.lb.copy(), st.ub.copy(), st.b_eq.copy()
    P_load = np.asarray(P_load, dtype=float)
    lb[st.load_pin_idx] = P_load
    ub[st.load_pin_idx] = P_load
    ub[st.gen_cap_idx] = np.minimum(st.gen_pmax[:, None], np.asarray(P_gen, dtype=float))
    b_eq[st.soc_rows] = np.asarray(init_soc, dtype=float)
    res = linprog(st.c, A_eq=st.A_eq, b_eq=b_eq, A_ub=st.A_ub, b_ub=st.b_ub, bounds=np.stack([lb, ub], axis=1),
                  method="highs")
    n_g, n_d = st.gen_cap_idx.shape[0], len(st.soc_rows)
    if not res.success:
        return np.zeros(2 * n_g + 2 * n_d), res
    P = res.x[st.act_idx] * st.baseMVA  # [gens..., des...]
    return np.concatenate((P[:n_g], np.zeros(n_g), P[n_g:], np.zeros(n_d))), res


class MPCAgent:
    """Base N-stage DC-OPF agent over a compat ``Simulator``; subclasses
    implement :meth:`forecast`.  The LP is built on the first call from the
    simulator's branch rates and Y-bus as they were at construction."""

    def __init__(self, simulator, action_space, gamma, safety_margin=0.9, planning_steps=1):
        self.safety_margin = safety_margin
        self.baseMVA = simulator.baseMVA
        self.lamb = simulator.lamb
        self.action_space = action_space
        self.planning_steps = planning_steps
        self.gamma = gamma

        self.spec = simulator.spec
        self.n_bus = simulator.N_bus
        self.n_dev = simulator.N_device
        self.n_branch = len(simulator.branches)
        self.delta_t = simulator.delta_t
        self.n_gen = simulator.N_non_slack_gen + 1
        self.n_des = simulator.N_des
        self.n_load = simulator.N_load

        # The ID orders and maps (devices and buses sorted by ID, branches in
        # input order), as the simulator's object maps have them.
        lay = dcopf_layout(self.spec)
        for name in DCOPFLayout._fields:
            setattr(self, name, getattr(lay, name))
        self.B_bus = simulator.Y_bus.imag.toarray()
        self.branch_rate = [br.rate for br in simulator.branches.values()]

        # Variables per stage: [theta (n_bus), P_dev (n_dev), pch (n_des),
        # pdis (n_des), soc (n_des), t_br (n_branch)].
        self._stage_n = self.n_bus + self.n_dev + 3 * self.n_des + self.n_branch
        self._structure = None
        # Solution cache for tests/inspection.
        self.last_solution = None

    @property
    def structure(self) -> DCOPFStructure:
        if self._structure is None:
            self._structure = build_dcopf_structure(
                self.spec, self.delta_t, self.lamb, self.gamma, self.safety_margin, self.planning_steps,
                branch_rate=self.branch_rate, B_bus=self.B_bus)
        return self._structure

    def act(self, env):
        """Solve the N-stage DC OPF and return the stage-0 action."""
        P_load_forecasts, P_gen_forecasts = self.forecast(env)
        a = self._solve(env.simulator, P_load_forecasts, P_gen_forecasts)
        return np.clip(a, self.action_space.low, self.action_space.high)

    def forecast(self, env):
        """Return (P_load [n_load, N], P_gen_max [n_gen-1, N]) in p.u."""
        raise NotImplementedError()

    def _solve(self, simulator, load_forecasts, gen_forecasts):
        init_soc = [simulator.state["des_soc"]["pu"][i] for i in self.des_ids]
        a, res = solve_highs(self.structure, load_forecasts, gen_forecasts, init_soc)
        if not res.success:
            print("OPF problem is " + res.message)
            return a  # the idle fallback
        x = res.x
        n = self._stage_n
        stage = lambda s, o, k: x[s * n + o: s * n + o + k]  # noqa: E731
        N = self.planning_steps
        self.last_solution = {
            "x": x,
            "theta": [stage(s, 0, self.n_bus) for s in range(N)],
            "P_dev": [stage(s, self.n_bus, self.n_dev) for s in range(N)],
            "soc": [stage(s, self.n_bus + self.n_dev + 2 * self.n_des, self.n_des) for s in range(N)],
        }
        return a


class MPCAgentConstant(MPCAgent):
    """pi_MPC-N^constant: current demand/generation held constant over the
    horizon (mpc_constant.py:7-35)."""

    def forecast(self, env):
        full_state = env.simulator.state
        P_load = [full_state["dev_p"]["pu"][i] for i in self.load_ids]
        P_gen = [full_state["gen_p_max"]["pu"][i] for i in self.non_slack_gen_ids]
        P_load = np.array([P_load for _ in range(self.planning_steps)]).T
        P_gen = np.array([P_gen for _ in range(self.planning_steps)]).T
        return P_load, P_gen


class MPCAgentPerfect(MPCAgent):
    """pi_MPC-N^perfect: exact knowledge of ANM6Easy's fixed daily profiles
    (mpc_perfect.py:7-40)."""

    def forecast(self, env):
        t_start = int(env.state[-1]) + 1
        t_end = t_start + self.planning_steps
        P_loads = env.P_loads
        P_gen_pot = env.P_maxs
        while t_end > P_loads.shape[1]:
            P_loads = np.concatenate((P_loads, env.P_loads), axis=-1)
            P_gen_pot = np.concatenate((P_gen_pot, env.P_maxs), axis=-1)
        return (
            P_loads[:, t_start:t_end] / self.baseMVA,
            P_gen_pot[:, t_start:t_end] / self.baseMVA,
        )
