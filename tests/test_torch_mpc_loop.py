"""The port's MPC controllers in the loop: float64 closed-loop golden
rollouts of ``make_vec_mpc`` and ``make_vec_mpc_perfect`` against the JAX
package's (actions, rewards and warm carries at 1e-8 with equal ADMM
iteration counts), and the controllers' behaviour on the float32 tier: idle
only on unsolvable lanes, the unconverged iterate applied, rollout rewards at
the JAX package's bars, the dataset collector, and the RTI budget's quality
floor over one profile day.  The solver itself is held against JAX and HiGHS
in ``tests/test_torch_mpc.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_anm_torch.convert import state_from_jax
from gym_anm_torch.offline_vec import evaluate_controller_vec, generate_dataset_vec
from gym_anm_torch.vec import VecEnv, make_anm6easy_task, make_ieee33_renewable_task
from gym_anm_torch.vec import mpc as tm
from gym_anm_tpu.agents.mpc import MPCAgent
from gym_anm_tpu.env.simulator import Simulator
from gym_anm_tpu.vec import VecEnv as JVecEnv
from gym_anm_tpu.vec import make_anm6easy_task as j_make_anm6easy_task
from gym_anm_tpu.vec import mpc as jm

torch.set_num_threads(2)


def _jax_structure(task, N, gamma=0.995, safety_margin=0.96):
    sim = Simulator(task.network, task.delta_t, task.lamb)
    return MPCAgent(sim, None, gamma=gamma, safety_margin=safety_margin, planning_steps=N).structure


@pytest.mark.parametrize("ctrl", ["constant_N1", "perfect_N4"])
def test_closed_loop_golden_rollout_f64(ctrl):
    """``make_vec_mpc`` (N = 1) and ``make_vec_mpc_perfect`` (N = 4, the
    receding-horizon shift on) in the loop of float64 ANM6Easy, 4 lanes x 8
    steps from JAX's reset states, each package stepping its own env:
    actions, rewards and warm carries within 1e-8, the same ADMM iteration
    counts (JAX's from the same solve outside its ``act``), equal done."""
    B, T, N = 4, 8, 1 if ctrl == "constant_N1" else 4
    jenv = JVecEnv(j_make_anm6easy_task(), dtype=jnp.float64)
    tenv = VecEnv(make_anm6easy_task(), dtype=torch.float64, device="cpu")
    kw = dict(gamma=0.995, safety_margin=0.96, planning_steps=N)
    if N == 1:
        jc, tc = jm.make_vec_mpc(jenv, **kw), tm.make_vec_mpc(tenv, **kw)
        load_pos = np.asarray(jenv.spec.load_pos)
        jfc = lambda s: (s.dev_p[load_pos], s.p_pot)  # noqa: E731
    else:
        jc, tc = jm.make_vec_mpc_perfect(jenv, **kw), tm.make_vec_mpc_perfect(tenv, **kw)
        jfc = jm.profile_forecast_fn(jenv, N)
    assert jc.name == tc.name
    st = _jax_structure(jenv.task, N)
    jdc = jm.make_vec_dcopf(st, dtype=jnp.float64, max_iter=48)
    shift = jm.make_shift_warm(jdc, st, N)
    jsolve = jax.jit(jax.vmap(lambda s, w: jm.solve_dcopf(jdc, *jm.lane_bounds(jdc, *jfc(s), s.soc), warm=shift(w))))
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    js, jobs = jax.jit(jax.vmap(jenv.reset))(keys)
    jcarry = jax.vmap(jc.init_carry)(keys)
    jact, jstep = jax.jit(jax.vmap(jc.act)), jax.jit(jax.vmap(jenv.step))
    ts, tcarry = state_from_jax(js, device="cpu"), tc.init_carry(B)
    real, its = tm.solve_dcopf, []

    def recording(*args, **kwargs):
        sol = real(*args, **kwargs)
        its.append(sol.iterations)
        return sol

    tm.solve_dcopf = recording
    try:
        for k in range(T):
            jsol = jsolve(js, jcarry)
            ja, jcarry = jact(keys, js, jobs, jcarry)
            ta, tcarry = tc.act(None, ts, None, tcarry)
            np.testing.assert_array_equal(its[-1].numpy(), np.asarray(jsol.iterations), err_msg=f"iterations {k}")
            np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=1e-8, err_msg=f"action {k}")
            for i, (t, j, s) in enumerate(zip(tcarry, jcarry, jsol.warm)):
                np.testing.assert_array_equal(np.asarray(j), np.asarray(s))
                np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-8, err_msg=f"carry[{i}] {k}")
            js, jobs, jr, jd, _ = jstep(js, ja)
            ts, _, tr, td, _ = tenv.step(ts, ta)
            np.testing.assert_array_equal(td.numpy(), np.asarray(jd), err_msg=f"done {k}")
            np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-8, err_msg=f"reward {k}")
    finally:
        tm.solve_dcopf = real
    assert float(np.asarray(jr).mean()) > -5.0



def test_structurally_unsolvable_lane_gets_idle_action():
    """Only the lanes whose LP is unsolvable (a negative potential folds into
    a generator cap below its box: crossed rows) idle; the others dispatch."""
    env = VecEnv(make_anm6easy_task(), dtype=torch.float32, device="cpu")
    ctrl = tm.make_vec_mpc(env, gamma=0.995, planning_steps=1)
    state, obs = env.reset(2, torch.Generator().manual_seed(0))
    p_pot = state.p_pot.clone()
    p_pot[0] = -1.0
    a, _ = ctrl.act(None, state._replace(p_pot=p_pot), obs, ctrl.init_carry(2))
    sl = env._action_slices
    assert (a[0, sl["P_gen"]] == 0).all() and (a[0, sl["P_des"]] == 0).all()
    assert (a[1, sl["P_gen"]] != 0).any()


def test_unconverged_iterate_is_still_applied(monkeypatch):
    """``max_iter=1`` runs one check of 8 sweeps, unconverged, and the action
    is that iterate, not idle."""
    env = VecEnv(make_anm6easy_task(), dtype=torch.float32, device="cpu")
    ctrl = tm.make_vec_mpc(env, gamma=0.995, planning_steps=1, max_iter=1)
    state, obs = env.reset(2, torch.Generator().manual_seed(0))
    real, sols = tm.solve_dcopf, []
    monkeypatch.setattr(tm, "solve_dcopf", lambda *a, **k: sols.append(real(*a, **k)) or sols[-1])
    a, _ = ctrl.act(None, state, obs, ctrl.init_carry(2))
    assert sols[0].iterations.tolist() == [8, 8] and not sols[0].converged.any()
    assert (a[:, env._action_slices["P_gen"]] != 0).any()


@pytest.mark.parametrize("name", ["constant_N1", "perfect_N4", "ieee33_renewable_N1"])
def test_controller_rollout_reward(name):
    """The controllers roll out at an informed controller's reward (random
    ANM6 actions collapse to ~-100s; the JAX bars: > -5 on ANM6Easy, > -0.5
    on IEEE33-renewable)."""
    if name == "ieee33_renewable_N1":
        env = VecEnv(make_ieee33_renewable_task(), dtype=torch.float32, device="cpu")
        ctrl, bar = tm.make_vec_mpc(env, gamma=0.99, safety_margin=0.9, planning_steps=1), -0.5
    else:
        env = VecEnv(make_anm6easy_task(), dtype=torch.float32, device="cpu")
        make = tm.make_vec_mpc if name == "constant_N1" else tm.make_vec_mpc_perfect
        ctrl, bar = make(env, gamma=0.995, safety_margin=0.96, planning_steps=1 if name == "constant_N1" else 4), -5.0
        assert ctrl.name == ("MPC1_constant" if name == "constant_N1" else "MPC4_perfect")
    m = evaluate_controller_vec(env, ctrl, torch.Generator().manual_seed(0), batch=4, steps=6)
    assert np.isfinite(m) and m > bar, m


def test_mpc_in_the_loop_dataset_generation():
    """The MPC controllers compose with the dataset collector (the warm tuple
    rides the collector's carry): finite transitions in the box at an
    informed controller's reward."""
    env = VecEnv(make_anm6easy_task(), dtype=torch.float32, device="cpu")
    ctrl = tm.make_vec_mpc_perfect(env, gamma=0.995, safety_margin=0.96, planning_steps=2)
    batch, steps = 3, 4
    obs, act, rew, obs2, done = generate_dataset_vec(env, ctrl, torch.Generator().manual_seed(0), batch, steps)
    assert obs.shape == (steps, batch, env.n_obs) and act.shape == (steps, batch, env.n_action)
    for x in (obs, act, rew, obs2):
        assert torch.isfinite(x).all()
    assert (act >= env.action_low - 1e-6).all() and (act <= env.action_high + 1e-6).all()
    assert float(rew.mean()) > -5.0


def test_rti_budget_default_quality_floor():
    """The default real-time-iteration budget (48) stays at the closed-loop
    quality of a budget of 800 over one full profile day (96 steps, B = 8),
    within the JAX package's 0.05 margin, at an informed controller's level."""
    env = VecEnv(make_anm6easy_task(), dtype=torch.float32, device="cpu")

    def rollout(ctrl):
        g = torch.Generator().manual_seed(0)
        state, obs = env.reset(8, g)
        carry, rewards = ctrl.init_carry(8), []
        for _ in range(96):
            a, carry = ctrl.act(None, state, obs, carry)
            state, obs, r, _, _ = env.step_autoreset_batch(state, a, g)
            rewards.append(r)
        return float(torch.stack(rewards).mean())

    kw = dict(gamma=0.995, safety_margin=0.96, planning_steps=1)
    r_default = rollout(tm.make_vec_mpc(env, **kw))
    r_converged = rollout(tm.make_vec_mpc(env, max_iter=800, **kw))
    assert r_default >= r_converged - 0.05, (r_default, r_converged)
    assert r_default > -1.0, r_default
