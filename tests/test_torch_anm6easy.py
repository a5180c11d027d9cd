"""The port's ANM6Easy task against the JAX package's: the daily tables, the
reset state as a function of the draws, the exogenous step, and a float64
golden rollout from JAX's reset states with random actions (storage and
generator projections active, lanes collapsing) at 1e-8 with equal Newton
counts.  Also the renewable family's ``scenario`` keyword, which both
packages accept and ignore."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_anm_torch.convert import state_from_jax
from gym_anm_torch.networks.anm6 import anm6easy_gen_time_series, anm6easy_load_time_series
from gym_anm_torch.vec import (
    VecEnv,
    make_anm6easy_task,
    make_ieee33_multicap_task,
    make_ieee33_renewable_task,
    make_ieee33_unequal_task,
)
from gym_anm_tpu.compat.anm6_easy import _get_gen_time_series, _get_load_time_series
from gym_anm_tpu.vec import VecEnv as JVecEnv
from gym_anm_tpu.vec import make_anm6easy_task as j_make_anm6easy_task
from gym_anm_tpu.vec import make_ieee33_multicap_task as j_make_ieee33_multicap_task
from gym_anm_tpu.vec import make_ieee33_renewable_task as j_make_ieee33_renewable_task
from gym_anm_tpu.vec import make_ieee33_unequal_task as j_make_ieee33_unequal_task

torch.set_num_threads(2)

B, T = 32, 24


@pytest.fixture(scope="module")
def janm6():
    env = JVecEnv(j_make_anm6easy_task(), dtype=jnp.float64)
    return env, jax.jit(jax.vmap(env.reset)), jax.jit(jax.vmap(env.step))


def test_daily_tables_equal_jax():
    for port, ref in ((anm6easy_load_time_series(), _get_load_time_series()),
                      (anm6easy_gen_time_series(), _get_gen_time_series())):
        assert port.dtype == ref.dtype and port.shape == ref.shape
        np.testing.assert_array_equal(port, ref)


def test_reset_state_from_jax_draws():
    """The port's s0 from JAX's draws (t0, generator Q and SoC uniforms)
    equals JAX's ``init_state_fn`` bit for bit (float32)."""
    jtask, task = j_make_anm6easy_task(), make_anm6easy_task()
    spec = VecEnv(task, device="cpu").spec
    keys = jax.random.split(jax.random.PRNGKey(0), 64)

    def draws(key):
        k_t, k_q, k_soc = jax.random.split(key, 3)
        return (jax.random.randint(k_t, (), 0, 96), jax.random.uniform(k_q, (spec.n_gen,), jnp.float32),
                jax.random.uniform(k_soc, (spec.n_des,), jnp.float32))

    t0, u_q, u_soc = jax.vmap(draws)(keys)
    js0 = np.asarray(jax.vmap(lambda k: jtask.init_state_fn(k, ()))(keys))
    ts0 = task.init_state_fn.__self__.s0_from_draws(*(torch.as_tensor(np.array(x)) for x in (t0, u_q, u_soc)))
    assert ts0.dtype == torch.float32 and len(set(np.asarray(t0).tolist())) > 20
    np.testing.assert_array_equal(ts0.numpy(), js0)


def test_next_vars_match_jax(janm6):
    """The exogenous variables of a step (the tables at the next time index,
    which wraps at 96) from the state vector's last entry."""
    jenv = janm6[0]
    s_t = np.zeros((96, jenv.n_state))
    s_t[:, -1] = np.arange(96)
    jv, _ = jax.vmap(lambda s: jenv.task.next_vars_fn(None, s, (), 0))(jnp.asarray(s_t))
    tv, carry = make_anm6easy_task().next_vars_fn(None, torch.as_tensor(s_t), (), None)
    assert carry == ()
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tv[-1, -1] == 0 and tv[0, -1] == 1


def test_golden_rollout_f64(janm6):
    """24 steps x 32 lanes from JAX's reset states with the same random
    actions (half the lanes over the whole action box, half over 30% of it):
    obs, reward, SoC, v_guess and aux within 1e-8, bus_vm too on the lanes
    that are not done (a collapsed lane's bus_vm is the diverged Newton
    iterate, ~1e15), equal done and Newton iteration counts."""
    jenv, jreset, jstep = janm6
    js, jobs = jreset(jax.random.split(jax.random.PRNGKey(9), B))
    tenv = VecEnv(make_anm6easy_task(), dtype=torch.float64, device="cpu")
    ts = state_from_jax(js, device="cpu")
    s_vec = tenv._state_vector(ts.dev_p, ts.dev_q, ts.soc, ts.p_pot, ts.aux)
    np.testing.assert_allclose(tenv.observation(s_vec).numpy(), np.asarray(jobs), rtol=0, atol=1e-12)
    rng = np.random.default_rng(9)
    lo, hi = np.asarray(jenv.action_low), np.asarray(jenv.action_high)
    scale = np.where(np.arange(B) < B // 2, 1.0, 0.3)[:, None]
    n_done, moved = 0, 0.0
    for k in range(T):
        a = rng.uniform(lo, hi, (B, len(lo))) * scale
        soc_before = ts.soc.clone()
        ts, tobs, tr, td, tinfo = tenv.step(ts, torch.as_tensor(a))
        js, jobs, jr, jd, jinfo = jstep(js, jnp.asarray(a))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd), err_msg=f"done {k}")
        np.testing.assert_array_equal(tinfo["n_iter"].numpy(), np.asarray(jinfo["n_iter"]), err_msg=f"n_iter {k}")
        live = ~td.numpy()
        for name, t, j in (("obs", tobs, jobs), ("reward", tr, jr), ("soc", ts.soc, js.soc),
                           ("bus_vm", ts.bus_vm[live], np.asarray(js.bus_vm)[live]),
                           ("v_guess", ts.v_guess, js.v_guess), ("aux", ts.aux, js.aux)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-8, err_msg=f"{name} {k}")
        n_done = int(td.sum())
        moved = max(moved, float((ts.soc - soc_before).abs().max()))
    assert 0 < n_done < B, n_done     # lanes collapse, and not all of them
    assert moved > 0                  # the storage unit charged or discharged


def test_reset_lanes_have_a_valid_time_index():
    """Reset (and autoreset) lanes come back with an integer time index in
    [0, 96), generator Q and SoC within their bounds, at t = 0."""
    env = VecEnv(make_anm6easy_task(), dtype=torch.float64, device="cpu")
    g = torch.Generator().manual_seed(3)
    state, obs = env.reset(64, g)
    spec = env.spec
    for k in range(4):
        aux = state.aux[:, -1]
        assert torch.equal(aux, aux.round()) and (aux >= 0).all() and (aux < 96).all()
        assert torch.isfinite(obs).all() and not state.terminated.any()
        soc = state.soc.numpy()
        assert (soc >= spec.soc_min[spec.des_pos] - 1e-12).all() and (soc <= spec.soc_max[spec.des_pos] + 1e-12).all()
        q_gen = state.dev_q[:, spec.gen_nonslack_pos].numpy()
        assert (q_gen >= spec.q_min[spec.gen_nonslack_pos] - 1e-12).all()
        assert (q_gen <= spec.q_max[spec.gen_nonslack_pos] + 1e-12).all()
        state, obs, _, d, _ = env.step_autoreset_batch(state, env.random_policy()(g, obs, k), g)
        assert (state.t[d] == 0).all()


@pytest.mark.parametrize("factory,j_factory", [
    (make_ieee33_renewable_task, j_make_ieee33_renewable_task),
    (make_ieee33_multicap_task, j_make_ieee33_multicap_task),
    (make_ieee33_unequal_task, j_make_ieee33_unequal_task),
], ids=["renewable", "multicap", "unequal"])
def test_scenario_keyword_is_accepted_and_changes_nothing(factory, j_factory):
    """``scenario`` is accepted by both packages' renewable-family factories
    and changes no table: the chord linearization point, the branch rates and
    the loads for the same hour and draw equal JAX's and the default's."""
    t, t0, j = factory(scenario="high_renewable"), factory(), j_factory(scenario="high_renewable")
    for a in (t0, j):
        np.testing.assert_array_equal(t.chord_x_star, a.chord_x_star)
        np.testing.assert_array_equal(t.rates, a.rates)
    hour = torch.full((4,), 13.5, dtype=torch.float32)
    z = torch.as_tensor(np.random.default_rng(0).standard_normal((4, 32)))
    v, h = t.next_vars_fn.from_noise(hour, z)
    v0, h0 = t0.next_vars_fn.from_noise(hour, z)
    assert torch.equal(v, v0) and torch.equal(h, h0)
    assert factory(1.0, "low_renewable").name == j.name
