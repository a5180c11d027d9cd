"""The port's MPC tier against the JAX package's: the DC-OPF assembly from the
network spec, the solver's host arrays, the batched ADMM solve at float64
(cold, warm, shifted-warm, an unsolvable lane) and float64 closed-loop
rollouts of both controllers, all from the same inputs; the float32 solve
against scipy's HiGHS with the bars of ``tests/test_vec_mpc.py``; and the
controllers' behaviour (idle only on unsolvable lanes, unconverged iterates
applied, rollout rewards, the RTI budget's quality floor, the dataset
collector, the profile forecast).

Tolerances: structure, host arrays and lane bounds bitwise (the same numpy
and elementwise operations); the float64 solve and rollouts at 1e-8 with
equal iteration counts and flags (only the products' summation order
differs); HiGHS at 5e-3 MW (f64) / 2e-2 MW (f32) on the stage-0 action and
1e-3 relative on the objective, the JAX package's bars.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_anm_torch.agents.mpc import build_dcopf_structure, solve_highs
from gym_anm_torch.convert import carry_from_jax, state_from_jax
from gym_anm_torch.offline_vec import evaluate_controller_vec, generate_dataset_vec
from gym_anm_torch.specs import load_network
from gym_anm_torch.vec import VecEnv, make_anm6easy_task, make_ieee33_multicap_task, make_ieee33_renewable_task
from gym_anm_torch.vec import mpc as tm
from gym_anm_torch.vec.admm_cuda import solve_dcopf_cuda
from gym_anm_tpu.agents.mpc import MPCAgent, MPCAgentConstant, MPCAgentPerfect
from gym_anm_tpu.compat import ANM6Easy
from gym_anm_tpu.compat.anm6_easy import _get_gen_time_series, _get_load_time_series
from gym_anm_tpu.env.simulator import Simulator
from gym_anm_tpu.vec import VecEnv as JVecEnv
from gym_anm_tpu.vec import make_anm6easy_task as j_make_anm6easy_task
from gym_anm_tpu.vec import mpc as jm

torch.set_num_threads(2)

TASKS = {"anm6easy": make_anm6easy_task, "ieee33_renewable": make_ieee33_renewable_task,
         "multicap17": make_ieee33_multicap_task}
DT = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}


def _structure(task, N, gamma=0.995, safety_margin=0.96):
    spec = load_network(task.network)
    return build_dcopf_structure(spec, task.delta_t, task.lamb, gamma, safety_margin, N)


def _jax_structure(task, N, gamma=0.995, safety_margin=0.96):
    sim = Simulator(task.network, task.delta_t, task.lamb)
    return MPCAgent(sim, None, gamma=gamma, safety_margin=safety_margin, planning_steps=N).structure


@pytest.fixture(scope="module")
def host_problem():
    """(port structure, P_load, P_gen, init_soc) of the live ANM6Easy DC-OPF
    of ``tests/test_vec_mpc.py``: the compat env after three mid-range
    actions, the constant forecast (``MPCAgentConstant``)."""
    rng_state = np.random.get_state()
    np.random.seed(0)
    env = ANM6Easy()
    env.reset(seed=0)
    a_mid = (env.action_space.low + env.action_space.high) / 2.0
    for _ in range(3):
        env.step(a_mid)
    np.random.set_state(rng_state)
    task = make_anm6easy_task()

    def build(N):
        agent = MPCAgentConstant(env.simulator, env.action_space, gamma=0.995, safety_margin=0.96, planning_steps=N)
        P_load, P_gen = agent.forecast(env)
        init_soc = np.array([env.simulator.state["des_soc"]["pu"][i] for i in agent.des_ids])
        return _structure(task, N), P_load, P_gen, init_soc

    return build


def _perfect_forecast(N, t0=17.0, base=100.0):
    """``MPCAgentPerfect.forecast`` at time index ``t0`` (it reads only
    planning_steps and baseMVA off the agent)."""
    pa = MPCAgentPerfect.__new__(MPCAgentPerfect)
    pa.planning_steps, pa.baseMVA = N, base
    fake = SimpleNamespace(state=np.array([t0]), P_loads=_get_load_time_series(), P_maxs=_get_gen_time_series())
    return pa.forecast(fake)


def _solve(st, P_load, P_gen, init_soc, dtype=torch.float32, **kw):
    dc = tm.make_vec_dcopf(st, dtype=dtype, device="cpu", **kw)
    t = lambda a: torch.as_tensor(np.asarray(a))[None]  # noqa: E731
    l, u = tm.lane_bounds(dc, t(P_load), t(P_gen), t(init_soc))
    return dc, tm.solve_dcopf(dc, l, u)


def _highs(st, P_load, P_gen, init_soc):
    _, res = solve_highs(st, P_load, P_gen, init_soc)
    assert res.success
    return res.x[st.act_idx] * st.baseMVA, res.fun


# ----------------------------------------------------------------------
# Parity with the JAX package
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name,N", [("anm6easy", 1), ("anm6easy", 2), ("anm6easy", 4), ("anm6easy", 8),
                                    ("anm6easy", 16), ("ieee33_renewable", 1), ("multicap17", 1)])
def test_structure_equals_jax(name, N):
    """``build_dcopf_structure`` from the spec equals ``MPCAgent(Simulator(...))
    .structure`` exactly: every array (sparse matrices densified), the index
    arrays, baseMVA and n_var, with the same dtypes."""
    task = TASKS[name]()
    port, ref = _structure(task, N), _jax_structure(task, N)
    for f in ref._fields:
        a, b = getattr(ref, f), getattr(port, f)
        if a is None:
            assert b is None, f
            continue
        if hasattr(a, "toarray"):
            a, b = a.toarray(), b.toarray()
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert port.n_var == ref.n_var and port.baseMVA == ref.baseMVA


@pytest.mark.parametrize("N,dt", [(1, "f64"), (4, "f64"), (1, "f32")])
def test_host_arrays_equal_jax(N, dt):
    """``make_vec_dcopf``'s arrays equal JAX's bit for bit (the same float64
    numpy operations, then one rounding to the working dtype), and so do the
    slot rows, the constants and the dual's scale floor q_ref."""
    jdt, tdt = DT[dt]
    st = _structure(make_anm6easy_task(), N)
    jdc = jm.make_vec_dcopf(st, dtype=jdt)
    tdc = tm.make_vec_dcopf(st, dtype=tdt, device="cpu")
    for f in ("A_bar", "q_bar", "rho", "inv_rho", "D", "D_inv", "E", "E_inv", "c_scale", "l_tmpl",
              "u_tmpl", "gen_pmax", "load_rows", "gen_rows", "soc_rows", "act_idx"):
        t, j = getattr(tdc, f), np.asarray(getattr(jdc, f))
        assert t.numpy().dtype == j.dtype or f.endswith(("rows", "idx")), f
        np.testing.assert_array_equal(t.numpy(), j, err_msg=f)
    np.testing.assert_array_equal(tdc.P_pack_T.numpy(), np.asarray(jdc.P_pack).T)
    assert tdc.P_pack_T.is_contiguous()
    for f in ("baseMVA", "sigma", "alpha", "max_iter", "eps_abs", "eps_rel", "n", "m", "dual_stall_limit",
              "dual_plateau_cap", "feas_band_factor", "check_every"):
        assert getattr(tdc, f) == getattr(jdc, f), f
    q_ref = jnp.max(jnp.abs(jdc.D_inv * jdc.q_bar)) / jdc.c_scale
    assert tdc.q_ref == float(q_ref) and tdc.c_scale_value == float(jdc.c_scale)


@pytest.fixture(scope="module")
def jax_lanes():
    """ANM6Easy reset states of JAX's float64 env, 6 lanes, in both packages."""
    jenv = JVecEnv(j_make_anm6easy_task(), dtype=jnp.float64)
    js, _ = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(0), 6))
    return js, state_from_jax(js, device="cpu"), np.asarray(load_network(j_make_anm6easy_task().network).load_pos)


def _check_solutions(ts, js, atol=1e-8):
    for f in ("iterations", "converged", "bounds_ok", "feasible"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), err_msg=f)
    assert ts.iterations.dtype == torch.int32
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=0, atol=atol, err_msg="x")
    for k, (t, j) in enumerate(zip(ts.warm, js.warm)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol, err_msg=f"warm[{k}]")
    for f in ("r_prim", "r_dual"):
        np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), rtol=1e-6, atol=1e-12,
                                   err_msg=f)


@pytest.mark.parametrize("N,mode", [(1, "cold"), (1, "warm"), (1, "unsolvable"), (4, "cold"), (4, "warm"),
                                    (4, "shifted")])
def test_f64_solve_matches_jax(jax_lanes, N, mode):
    """``solve_dcopf_plain`` against JAX's vmapped ``solve_dcopf`` at float64
    on the LPs of 6 reset states: from zeros, warm from the cold solution on
    loads 5% heavier, from the receding-horizon shift of the cold solution
    (N = 4), and with one lane's bound row crossed.  Equal iterations and
    flags; x and the warm tuple within 1e-8."""
    js, ts, load_pos = jax_lanes
    st = _structure(make_anm6easy_task(), N)
    jdc = jm.make_vec_dcopf(st, dtype=jnp.float64, max_iter=2000)
    tdc = tm.make_vec_dcopf(st, dtype=torch.float64, device="cpu", max_iter=2000)
    jsolve = jax.jit(jax.vmap(lambda l, u, w: jm.solve_dcopf(jdc, l, u, warm=w)))
    jl, ju = jax.vmap(lambda s: jm.lane_bounds(jdc, s.dev_p[load_pos], s.p_pot, s.soc))(js)
    tl, tu = tm.lane_bounds(tdc, ts.dev_p[:, load_pos], ts.p_pot, ts.soc)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    jw, tw = jax.vmap(lambda _: jm.init_warm(jdc))(jnp.arange(6)), tm.init_warm(tdc, 6)
    if mode == "unsolvable":
        row = tdc.m - tdc.n + 3
        jl = jl.at[2, row].set(ju[2, row] + 1.0)
        tl = tl.clone()
        tl[2, row] = tu[2, row] + 1.0
    if mode in ("warm", "shifted"):
        jc, tc = jsolve(jl, ju, jw), tm.solve_dcopf(tdc, tl, tu, tw)
        _check_solutions(tc, jc)
        jw, tw = jc.warm, tc.warm
        if mode == "warm":
            load_rows = tdc.load_rows.reshape(-1)
            jl, ju = (a.at[:, load_rows.numpy()].multiply(1.05) for a in (jl, ju))
            tl, tu = (a.index_copy(1, load_rows, a[:, load_rows] * 1.05) for a in (tl, tu))
        else:
            jw = jax.vmap(jm.make_shift_warm(jdc, st, N))(jw)
            tw = tm.make_shift_warm(tdc, st, N)(tw)
            for t, j in zip(tw, jw):
                np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-12)
    jsol, tsol = jsolve(jl, ju, jw), tm.solve_dcopf(tdc, tl, tu, tw)
    _check_solutions(tsol, jsol)
    if mode == "unsolvable":
        assert tsol.iterations[2] == 0 and not tsol.bounds_ok[2] and torch.isinf(tsol.r_prim[2])
        assert all(torch.equal(t[2], w[2]) for t, w in zip(tsol.warm, tw))
        assert bool(tsol.bounds_ok[[0, 1, 3, 4, 5]].all())


def test_carry_from_jax_keeps_the_warm_tuple():
    """A JAX controller's batched warm tuple (x̄, ȳ, z̄, Āx̄) comes across as a
    tuple of [B, ·] tensors at its dtype, which the port's act takes."""
    jenv = JVecEnv(j_make_anm6easy_task(), dtype=jnp.float64)
    keys = jax.random.split(jax.random.PRNGKey(1), 3)
    jcarry = jax.vmap(jm.make_vec_mpc(jenv, gamma=0.995).init_carry)(keys)
    tcarry = carry_from_jax(jcarry, device="cpu")
    assert type(tcarry) is tuple and len(tcarry) == 4
    assert [tuple(t.shape) for t in tcarry] == [(3, 21), (3, 39), (3, 39), (3, 39)]
    assert all(t.dtype == torch.float64 for t in tcarry)


@pytest.fixture(scope="module")
def jax_forecast():
    """JAX's float32 ANM6Easy lane and its jitted N = 5 profile forecast."""
    jenv = JVecEnv(j_make_anm6easy_task(), dtype=jnp.float32)
    js, _ = jax.jit(jenv.reset)(jax.random.PRNGKey(3))
    return js, jax.jit(jm.profile_forecast_fn(jenv, 5))


@pytest.mark.parametrize("t0", [0, 40, 93, 95])
def test_profile_forecast_matches_jax(jax_forecast, t0):
    """``profile_forecast_fn`` equals JAX's and ``MPCAgentPerfect.forecast``,
    across the day's wrap (93, 95 of 96 columns)."""
    N = 5
    js, jfc = jax_forecast
    tenv = VecEnv(make_anm6easy_task(), dtype=torch.float32, device="cpu")
    state, _ = tenv.reset(2, torch.Generator().manual_seed(3))
    state = state._replace(aux=torch.full_like(state.aux, float(t0)))
    ld, gn = tm.profile_forecast_fn(tenv, N)(state)
    assert tuple(ld.shape) == (2, 3, N) and tuple(gn.shape) == (2, 2, N)
    jld, jgn = jfc(js._replace(aux=jnp.array([float(t0)], jnp.float32)))
    ld_ref, gn_ref = _perfect_forecast(N, t0)
    for b in range(2):
        np.testing.assert_array_equal(ld[b].numpy(), np.asarray(jld))
        np.testing.assert_array_equal(gn[b].numpy(), np.asarray(jgn))
        np.testing.assert_allclose(ld[b].numpy(), ld_ref, atol=1e-6)
        np.testing.assert_allclose(gn[b].numpy(), gn_ref, atol=1e-6)


def test_profile_forecast_rejects_bad_tables():
    """Mismatched table periods raise (a gather would wrap each table at its
    own period), and so does a task without built-in profiles."""
    env = VecEnv(make_anm6easy_task(), dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="periods differ"):
        tm.profile_forecast_fn(env, 4, tables_mw=(np.zeros((3, 96)), np.zeros((2, 48))))
    with pytest.raises(ValueError, match="explicit tables_mw"):
        tm.profile_forecast_fn(VecEnv(make_ieee33_renewable_task(), device="cpu"), 4)


# ----------------------------------------------------------------------
# The solve against HiGHS (tests/test_vec_mpc.py's bars)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("N,dtype,tol_mw", [(1, torch.float64, 5e-3), (1, torch.float32, 2e-2),
                                            (4, torch.float32, 2e-2)])
def test_admm_matches_highs(host_problem, N, dtype, tol_mw):
    """Stage-0 action and objective parity with HiGHS on the live ANM6Easy
    DC-OPF (test_vec_mpc.py:73-92)."""
    st, P_load, P_gen, init_soc = host_problem(N)
    a_ref, obj_ref = _highs(st, P_load, P_gen, init_soc)
    _, sol = _solve(st, P_load, P_gen, init_soc, dtype, max_iter=10000)
    assert bool(sol.converged[0])
    x = sol.x[0].double().numpy()
    assert np.max(np.abs(x[st.act_idx] * st.baseMVA - a_ref)) <= tol_mw
    assert abs(float(st.c @ x) - obj_ref) <= 1e-3 * max(1.0, abs(obj_ref))


def test_batch_matches_per_lane_highs(host_problem):
    """Three lanes with different pinned loads, one batched solve; each lane
    matches its own HiGHS solution."""
    st, P_load, P_gen, init_soc = host_problem(1)
    dc = tm.make_vec_dcopf(st, dtype=torch.float32, device="cpu")
    scales = [0.8, 1.0, 1.2]
    t = lambda a: torch.as_tensor(np.stack(a))  # noqa: E731
    l, u = tm.lane_bounds(dc, t([P_load * s for s in scales]), t([P_gen] * 3), t([init_soc] * 3))
    sol = tm.solve_dcopf(dc, l, u)
    assert bool(sol.converged.all())
    for b, s in enumerate(scales):
        a_ref, _ = _highs(st, P_load * s, P_gen, init_soc)
        assert np.max(np.abs(sol.x[b].double().numpy()[st.act_idx] * st.baseMVA - a_ref)) <= 2e-2


def test_perfect_forecast_matches_highs(host_problem):
    """The N = 4 perfect-forecast LP (time-varying pins and caps) matches
    HiGHS's stage-0 action and objective."""
    st, _, _, init_soc = host_problem(4)
    P_load, P_gen = _perfect_forecast(4)
    a_ref, obj_ref = _highs(st, P_load, P_gen, init_soc)
    _, sol = _solve(st, P_load, P_gen, init_soc, max_iter=10000)
    assert bool(sol.converged[0])
    x = sol.x[0].double().numpy()
    assert np.max(np.abs(x[st.act_idx] * st.baseMVA - a_ref)) <= 2e-2
    assert abs(float(st.c @ x) - obj_ref) <= 1e-3 * max(1.0, abs(obj_ref))


def test_stiff_multistage_f32_is_feasible_at_optimum(host_problem):
    """N = 8, float32: the residuals floor above the strict tolerances while
    the iterate sits at the HiGHS objective; ``feasible`` must hold."""
    st, _, _, init_soc = host_problem(8)
    P_load, P_gen = _perfect_forecast(8)
    _, obj_ref = _highs(st, P_load, P_gen, init_soc)
    _, sol = _solve(st, P_load, P_gen, init_soc, max_iter=4000)
    assert bool(sol.feasible[0])
    assert abs(float(st.c @ sol.x[0].double().numpy()) - obj_ref) <= 1e-3 * max(1.0, abs(obj_ref))


def test_n16_f32_converges_feasibly(host_problem):
    """Cold N = 16, float32 converges, feasibly, at the HiGHS objective, with
    a true constraint violation <= 5e-5 against the float64 problem data."""
    st, _, _, init_soc = host_problem(16)
    P_load, P_gen = _perfect_forecast(16)
    _, obj_ref = _highs(st, P_load, P_gen, init_soc)
    _, sol = _solve(st, P_load, P_gen, init_soc, max_iter=40000)
    assert bool(sol.converged[0]) and bool(sol.feasible[0]), (int(sol.iterations[0]), float(sol.r_prim[0]))
    x = sol.x[0].double().numpy()
    assert abs(float(st.c @ x) - obj_ref) <= 1e-3 * max(1.0, abs(obj_ref))
    lb, ub, b_eq = st.lb.copy(), st.ub.copy(), st.b_eq.copy()
    lb[st.load_pin_idx] = P_load
    ub[st.load_pin_idx] = P_load
    ub[st.gen_cap_idx] = np.minimum(st.gen_pmax[:, None], P_gen)
    b_eq[st.soc_rows] = init_soc
    vio = max(float(np.max(np.abs(st.A_eq @ x - b_eq))), float(np.max(np.maximum(st.A_ub @ x - st.b_ub, 0.0))),
              float(np.max(np.maximum(lb - x, 0.0))), float(np.max(np.maximum(x - ub, 0.0))))
    assert vio <= 5e-5, vio


def test_warm_start_cuts_iterations(host_problem):
    """Re-solving a lane from its own warm tuple costs less than half the
    cold solve (N = 4)."""
    st, P_load, P_gen, init_soc = host_problem(4)
    dc, cold = _solve(st, P_load, P_gen, init_soc)
    warm = tm.solve_dcopf(dc, *tm.lane_bounds(dc, *(torch.as_tensor(np.asarray(a))[None]
                                                     for a in (P_load, P_gen, init_soc))), cold.warm)
    assert bool(warm.converged[0])
    assert int(warm.iterations[0]) < int(cold.iterations[0]) // 2


def test_infeasible_lane_skips_loop_and_reports_unconverged(host_problem):
    """A lane with a crossed bound row exits with converged = feasible = False
    after zero iterations and does not hold the other lane back."""
    st, P_load, P_gen, init_soc = host_problem(1)
    dc = tm.make_vec_dcopf(st, dtype=torch.float32, device="cpu")
    t = lambda a: torch.as_tensor(np.stack([a, a]))  # noqa: E731
    l, u = tm.lane_bounds(dc, t(P_load), t(P_gen), t(init_soc))
    row = dc.m - dc.n + 3
    l = l.clone()
    l[0, row] = u[0, row] + 1.0
    sol = tm.solve_dcopf(dc, l, u)
    assert not sol.converged[0] and not sol.feasible[0] and not sol.bounds_ok[0] and int(sol.iterations[0]) == 0
    assert sol.converged[1] and sol.feasible[1] and int(sol.iterations[1]) < dc.max_iter


# ----------------------------------------------------------------------
# Helpers
# ----------------------------------------------------------------------

def test_lane_bounds_slot_mapping(host_problem):
    """``lane_bounds`` writes exactly the host solve's slots (pinned loads
    l = u, capped generators u = min(p_max, potential), SoC equality rows)
    and leaves every other row at the template, for every lane."""
    st, P_load, P_gen, init_soc = host_problem(2)
    dc = tm.make_vec_dcopf(st, dtype=torch.float64, device="cpu")
    t = lambda a, s: torch.as_tensor(np.stack([a, a * s]))  # noqa: E731
    l, u = (x.numpy() for x in tm.lane_bounds(dc, t(P_load, 0.5), t(P_gen, 0.5), t(init_soc, 0.5)))
    bound0 = st.A_eq.shape[0] + st.A_ub.shape[0]
    for b, s in enumerate((1.0, 0.5)):
        np.testing.assert_allclose(l[b, bound0 + st.load_pin_idx], P_load * s, atol=1e-12)
        np.testing.assert_allclose(u[b, bound0 + st.load_pin_idx], P_load * s, atol=1e-12)
        np.testing.assert_allclose(u[b, bound0 + st.gen_cap_idx], np.minimum(st.gen_pmax[:, None], P_gen * s),
                                   atol=1e-12)
        np.testing.assert_allclose(l[b, st.soc_rows], init_soc * s, atol=1e-12)
        np.testing.assert_allclose(u[b, st.soc_rows], init_soc * s, atol=1e-12)
    touched = np.zeros(dc.m, dtype=bool)
    touched[bound0 + st.load_pin_idx.ravel()] = True
    touched[bound0 + st.gen_cap_idx.ravel()] = True
    touched[st.soc_rows] = True
    for b in range(2):
        np.testing.assert_array_equal(l[b, ~touched], dc.l_tmpl.numpy()[~touched])
        np.testing.assert_array_equal(u[b, ~touched], dc.u_tmpl.numpy()[~touched])


def test_shift_warm_is_exact_stage_shift(host_problem):
    """``make_shift_warm`` moves the UNSCALED iterates by exactly one stage
    block (variables and constraint rows, the last stage duplicated), Āx̄ is
    recomputed for the shifted x̄, and N = 1 is the identity."""
    N = 4
    st = host_problem(N)[0]
    dc = tm.make_vec_dcopf(st, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(0)
    warm = tuple(torch.as_tensor(rng.standard_normal((2, k))) for k in (dc.n, dc.m, dc.m, dc.m))
    x2, y2, z2, Ax2 = tm.make_shift_warm(dc, st, N)(warm)
    n_eq, n_ub = st.A_eq.shape[0], st.A_ub.shape[0]

    def src(count, ps):
        i = np.arange(count)
        return np.where(i < count - ps, i + ps, i)

    vsrc = src(dc.n, st.n_var // N)
    rsrc = np.concatenate([src(n_eq, n_eq // N), n_eq + src(n_ub, n_ub // N), n_eq + n_ub + vsrc])
    D, E = dc.D.numpy(), dc.E.numpy()
    x, y, z, _ = (w.numpy() for w in warm)
    np.testing.assert_allclose(D * x2.numpy(), (D * x)[:, vsrc], rtol=1e-12)
    np.testing.assert_allclose(z2.numpy() / E, (z / E)[:, rsrc], rtol=1e-12)
    np.testing.assert_allclose(E * y2.numpy(), (E * y)[:, rsrc], rtol=1e-12)
    np.testing.assert_allclose(Ax2.numpy(), x2.numpy() @ dc.A_bar.numpy().T, atol=1e-12)
    dc1 = tm.make_vec_dcopf(host_problem(1)[0], dtype=torch.float32, device="cpu")
    w = tm.init_warm(dc1, 3)
    assert tm.make_shift_warm(dc1, host_problem(1)[0], 1)(w) is w


@pytest.mark.parametrize("R,K", [(21, 39), (60, 21), (16, 4), (17, 5)])
def test_mma_fragments_layout(R, K):
    """Entry [rt, c, l, h] of the fragment copy is M[16 rt + 8 h + l // 4,
    4 c + l % 4] (zero beyond M), float64: the (a0, a1) of thread l in K5's
    m16n8k4 tile (rt, c)."""
    M = torch.arange(R * K, dtype=torch.float32).reshape(R, K) / 7
    RT, KC = -(-R // 16), -(-K // 4)
    f = tm.mma_a_fragments(M)
    assert f.dtype == torch.float64 and f.numel() == RT * KC * 64
    f = f.reshape(RT, KC, 32, 2)
    Mp = torch.zeros(16 * RT, 4 * KC, dtype=torch.float64)
    Mp[:R, :K] = M.double()
    for rt in range(RT):
        for c in range(KC):
            for lane in range(32):
                for h in range(2):
                    assert f[rt, c, lane, h] == Mp[16 * rt + 8 * h + lane // 4, 4 * c + lane % 4]


@pytest.mark.parametrize("N", [1, 4])
def test_vec_dcopf_carries_the_kernels_fragments(host_problem, N):
    """``make_vec_dcopf`` makes K5's fragment copies of Āᵀ and P_pack from the
    working-dtype values, in both orders (tiles for the staged route, groups
    of tiles for the streamed one), and their sizes are the kernel's
    (admm_cuda's frag_count); a lane-sweep reads them from L2 only where the
    kernel does not stage them, one read shared by the lanes it serves."""
    from gym_anm_torch.vec.admm_cuda import frag_count, l2_bytes_per_lane_sweep, stream_count

    dc = tm.make_vec_dcopf(host_problem(N)[0], dtype=torch.float32, device="cpu")
    assert torch.equal(dc.A_frag, tm.mma_a_fragments(dc.A_bar.T))
    assert torch.equal(dc.P_frag, tm.mma_a_fragments(dc.P_pack_T.T))
    assert torch.equal(dc.A_stream, tm.stream_fragments(dc.A_frag, dc.n, dc.m))
    assert torch.equal(dc.P_stream, tm.stream_fragments(dc.P_frag, dc.n + dc.m, dc.n))
    assert dc.A_frag.numel() + dc.P_frag.numel() == 2 * frag_count(dc.n, dc.m)
    assert dc.A_stream.numel() + dc.P_stream.numel() == 2 * stream_count(dc.n, dc.m) >= 2 * frag_count(dc.n, dc.m)
    assert l2_bytes_per_lane_sweep(dc.n, dc.m, 0) == 0
    assert l2_bytes_per_lane_sweep(dc.n, dc.m, 16) == stream_count(dc.n, dc.m)  # one warp's 16 lanes


def _unpack_stream(stream, R, K):
    """The padded [16 ceil(R/16), 4 chunks] float64 matrix that a stream of
    fragments holds (groups of STREAM_TILES row tiles, [k-chunk][tile][32,
    2], the chunks padded to a multiple of STREAM_CHUNKS), by the m16n8k4 A
    operand's map: entry [c, q, l, h] of a group from row tile r0 is
    M[16 (r0 + q) + 8 h + l // 4, 4 c + l % 4]."""
    RT, KC = -(-R // 16), -(-K // 4)
    KP = -(-KC // tm.STREAM_CHUNKS) * tm.STREAM_CHUNKS
    M = torch.full((16 * RT, 4 * KP), float("nan"), dtype=torch.float64)
    lane, h = torch.arange(32)[:, None], torch.arange(2)[None, :]
    pos = 0
    for r0 in range(0, RT, tm.STREAM_TILES):
        nq = min(tm.STREAM_TILES, RT - r0)
        blk = stream[pos:pos + KP * nq * 64].reshape(KP, nq, 32, 2)
        pos += KP * nq * 64
        for c in range(KP):
            for q in range(nq):
                M[16 * (r0 + q) + 8 * h + lane // 4, 4 * c + lane % 4] = blk[c, q]
    assert pos == stream.numel()
    return M


@pytest.mark.parametrize("N", [1, 8])
def test_stream_fragments_unpack_to_the_matrices(host_problem, N):
    """K5's streamed copies unpack to Āᵀ [n, m] and P_pack [n+m, n] bit for
    bit (the float32 values as float64), zeros in the padding (rows to
    whole tiles, k-chunks to whole stages), every entry written once; a
    group's k-chunks are consecutive, so a ring stage of them is one
    contiguous copy.  N = 8 is the MPC cell's shape, whose chunks (78, 42)
    fill whole stages."""
    dc = tm.make_vec_dcopf(host_problem(N)[0], dtype=torch.float32, device="cpu")
    n, m = dc.n, dc.m
    for stream, M in ((dc.A_stream, dc.A_bar.T), (dc.P_stream, dc.P_pack_T.T)):
        U = _unpack_stream(stream, *M.shape)
        assert not U.isnan().any()
        assert torch.equal(U[:M.shape[0], :M.shape[1]], M.double())
        pad = torch.ones_like(U, dtype=torch.bool)
        pad[:M.shape[0], :M.shape[1]] = False
        assert not U[pad].any()
    if N == 8:
        assert (n, m) == (168, 312) and dc.A_stream.numel() == dc.A_frag.numel()
        assert dc.P_stream.numel() == dc.P_frag.numel()


@pytest.mark.parametrize("N,B,warps,lanes", [(1, 8192, 0, 0), (1, 16384, 0, 0), (8, 16384, 4, 64), (8, 8192, 4, 64),
                                              (8, 1, 1, 16), (8, 129, 1, 16), (8, 2113, 2, 32), (16, 16384, 3, 48)])
def test_k5_route_and_l2_bytes(host_problem, N, B, warps, lanes):
    """K5's route and its L2 bytes on an H100 (132 SMs, 232,448 bytes of
    shared memory a block), from the pure mirror of the kernel's plan
    (the card tests hold it against the C query): ANM6Easy N = 1 stages its
    fragments (0 bytes from L2); the MPC cell's N = 8 streams them through 4
    consumer warps at B = 16384 (64 lanes a read: 16,944 bytes a lane-sweep
    against 135,552 for a warp's 8 on the tile design); a small batch takes fewer warps a
    block, so it spreads over the SMs; N = 16 fits 3 warps' operands."""
    from gym_anm_torch.vec.admm_cuda import frag_count, l2_bytes_per_lane_sweep, stream_count, stream_lanes

    dc = tm.make_vec_dcopf(host_problem(N)[0], dtype=torch.float32, device="cpu")
    n, m = dc.n, dc.m
    assert stream_lanes(B, n, m) == lanes == 16 * warps
    l2 = l2_bytes_per_lane_sweep(n, m, lanes)
    assert l2 == (16 * stream_count(n, m) // lanes if lanes else 0)
    if (N, B) == (8, 16384):
        assert l2 == 16944 and 16 * frag_count(n, m) // 8 == 135552  # the tile design: a warp's read for 8 lanes


def test_cold_warm_tuple_shapes(host_problem):
    dc = tm.make_vec_dcopf(host_problem(1)[0], dtype=torch.float32, device="cpu")
    x, y, z, Ax = tm.init_warm(dc, 5)
    assert x.shape == (5, dc.n) and y.shape == z.shape == Ax.shape == (5, dc.m)
    assert all(t.dtype == torch.float32 and not t.any() for t in (x, y, z, Ax))


def test_solve_dcopf_cuda_checks_before_building(monkeypatch, host_problem):
    """The wrapper of K5 raises ValueError on tensors off the card, float64
    or not contiguous, before it builds anything; ``solve_dcopf`` takes the
    plain version for CPU tensors and never the kernel."""
    from gym_anm_torch import _build

    def no_build():
        raise AssertionError("the kernel library was built")

    monkeypatch.setattr(_build, "load_library", no_build)
    st = host_problem(1)[0]
    dc32 = tm.make_vec_dcopf(st, dtype=torch.float32, device="cpu")
    dc64 = tm.make_vec_dcopf(st, dtype=torch.float64, device="cpu")
    for dc in (dc32, dc64):
        l, u = dc.l_tmpl.expand(2, dc.m).contiguous(), dc.u_tmpl.expand(2, dc.m).contiguous()
        with pytest.raises(ValueError, match="CUDA"):
            solve_dcopf_cuda(dc, l, u, tm.init_warm(dc, 2))
    l = dc32.l_tmpl.expand(2, dc32.m)
    assert not l.is_contiguous()
    with pytest.raises(ValueError):
        solve_dcopf_cuda(dc32, l, l, tm.init_warm(dc32, 2))
    before = solve_dcopf_cuda.launch_count
    sol = tm.solve_dcopf(dc32, dc32.l_tmpl.expand(2, dc32.m), dc32.u_tmpl.expand(2, dc32.m))
    assert solve_dcopf_cuda.launch_count == before and sol.x.shape == (2, dc32.n)


# ----------------------------------------------------------------------
# The controllers
# ----------------------------------------------------------------------

def test_vec_exports_the_mpc_controllers():
    import gym_anm_torch.vec as vec

    assert vec.make_vec_mpc is tm.make_vec_mpc and vec.make_vec_mpc_perfect is tm.make_vec_mpc_perfect
