"""The port's dataset collectors against the JAX package's: the block
collector equals the mixed one bit for bit, matches JAX's block collector on
the same reset states, exogenous loads and L0 draws (float64, 1e-8, equal
``done``), behaviour cloning gives JAX's least-squares weights on a
rank-deficient dataset, and the collectors' shapes, errors and the
informed-beats-random ordering of tests/test_vec_controllers.py hold."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_anm_torch import offline_vec
from gym_anm_torch.convert import state_from_jax
from gym_anm_torch.offline_vec import (
    behavior_cloning_vec,
    evaluate_controller_vec,
    generate_dataset_vec,
    generate_mixed_dataset_vec,
    make_block_collector,
    make_mixed_collector,
)
from gym_anm_torch.vec import VecEnv, make_ieee33_multicap_task, make_ieee33_renewable_task
from gym_anm_torch.vec.controllers import make_suite
from gym_anm_tpu import offline_vec as j_offline_vec
from gym_anm_tpu.vec import VecEnv as JVecEnv
from gym_anm_tpu.vec import make_ieee33_multicap_task as j_make_ieee33_multicap_task
from gym_anm_tpu.vec.controllers import make_suite as j_make_suite

torch.set_num_threads(2)

B, T = 24, 8


@pytest.fixture(scope="module")
def renv():
    return VecEnv(make_ieee33_renewable_task(), dtype=torch.float64, device="cpu")


def test_block_collector_matches_mixed_collector():
    """Port of tests/test_vec_controllers.py::test_block_collector_matches_mixed_collector:
    bit-identical trajectories under the block assignment, from generators
    of one seed."""
    env = VecEnv(make_ieee33_multicap_task(), dtype=torch.float32, device="cpu")
    suite = make_suite(env)
    block, assignment = make_block_collector(env, suite, B, 6)
    mixed = make_mixed_collector(env, suite, B, 6)
    np.testing.assert_array_equal(assignment.numpy(), np.repeat(np.arange(6), 4))
    traj_b = block(torch.Generator().manual_seed(3))
    traj_m = mixed(torch.Generator().manual_seed(3), assignment)
    for a, b in zip(traj_b, traj_m):
        assert torch.equal(a, b)
    assert traj_b[1].shape == (6, B, env.n_action)


def test_block_sizes_give_the_remainder_to_the_last_block():
    env = VecEnv(make_ieee33_multicap_task(), dtype=torch.float32, device="cpu")
    _, assignment = make_block_collector(env, make_suite(env), 20, 1)
    np.testing.assert_array_equal(np.bincount(assignment.numpy()), [3, 3, 3, 3, 3, 5])


def test_block_collector_matches_jax(monkeypatch):
    """JAX's block collector (L0-L5 on multicap17, float64) against the
    port's from JAX's reset states, with JAX's exogenous loads and JAX's L0
    draws fed to the port: obs, action, reward, next_obs within 1e-8, done
    equal.  JAX's per-step states come from its collector's loop run step by
    step, which is checked against the collector's own trajectory first."""
    jenv = JVecEnv(j_make_ieee33_multicap_task(), dtype=jnp.float64)
    jsuite = j_make_suite(jenv)
    jcollect, jassign = j_offline_vec.make_block_collector(jenv, jsuite, B, T)
    key = jax.random.PRNGKey(7)
    jtraj = jcollect(key)

    # The collector's loop, step by step (offline_vec.py:128-159).
    k_env, _ = jax.random.split(key)
    js, jobs = jax.jit(jax.vmap(jenv.reset))(jax.random.split(k_env, B))
    state0 = (js, jobs)
    starts = np.concatenate([[0], np.cumsum([B // 6] * 6)])
    carries = [jax.vmap(c.init_carry)(jax.random.split(key, starts[i + 1] - starts[i]))
               for i, c in enumerate(jsuite)]
    acts = [jax.jit(jax.vmap(c.act)) for c in jsuite]
    jstep = jax.jit(jenv.step_autoreset_batch)
    next_vars = jax.jit(jax.vmap(jenv.task.next_vars_fn))
    state_vec = jax.jit(jax.vmap(jenv._state_vector))
    fold = jax.jit(jax.vmap(lambda kk: jax.random.fold_in(kk, 11)))
    draw = jax.jit(jax.vmap(lambda kk: jax.random.uniform(kk, (jenv.n_action,), jnp.float64)))
    var_keys = jax.jit(jax.vmap(lambda kk: jax.random.split(kk)[1]))
    fed_vars, fed_noise, manual = [], [], []
    for _ in range(T):
        k = fold(js.key)
        fed_noise.append(np.array(draw(k)))
        k_vars = var_keys(js.key)
        s_t = state_vec(js.dev_p, js.dev_q, js.soc, js.p_pot, js.aux)
        fed_vars.append([np.array(x) for x in next_vars(k_vars, s_t, js.task, js.t)])
        blocks = []
        for i in range(6):
            sl = slice(starts[i], starts[i + 1])
            a_i, carries[i] = acts[i](k[sl], jax.tree_util.tree_map(lambda x: x[sl], js), jobs[sl], carries[i])
            blocks.append(a_i)
        a = jnp.clip(jnp.concatenate(blocks), jenv.action_low, jenv.action_high)
        js2, jobs2, r, d, _ = jstep(js, a)
        manual.append((jobs, a, r, jobs2, d))
        js, jobs = js2, jobs2
    for x, y in zip(jtraj, (jnp.stack(z) for z in zip(*manual))):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=0, atol=1e-8)

    task = make_ieee33_multicap_task()
    feed = iter(fed_vars)
    noise = iter(fed_noise)

    def next_vars_fn(generator, s_t, hour, t):
        v, h = next(feed)
        return torch.as_tensor(v), torch.as_tensor(h)

    monkeypatch.setattr(offline_vec, "action_noise", lambda env, n, generator: torch.as_tensor(next(noise)))
    tenv = VecEnv(dataclasses.replace(task, next_vars_fn=next_vars_fn), dtype=torch.float64, device="cpu")
    tcollect, tassign = make_block_collector(tenv, make_suite(tenv), B, T)
    np.testing.assert_array_equal(tassign.numpy(), np.asarray(jassign))
    ttraj = tcollect(None, start=(state_from_jax(state0[0], device="cpu"), torch.as_tensor(np.array(state0[1]))))
    for name, t, j in zip(("obs", "action", "reward", "next_obs", "done"), ttraj, jtraj):
        assert t.shape == j.shape, name
        if name == "done":
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        else:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-8, err_msg=name)
    assert not ttraj[4].any()


def test_behavior_cloning_matches_jax_lstsq():
    """A linear policy fitted to a collected multicap dataset, whose
    observation has all-zero columns (rank-deficient): the weights equal
    ``jnp.linalg.lstsq(rcond=None)``'s minimum-norm solution to 1e-8
    (relative to the largest weight), and the policy stays in the box."""
    env = VecEnv(make_ieee33_multicap_task(), dtype=torch.float64, device="cpu")
    (obs, act, _, _, _), _ = generate_mixed_dataset_vec(env, make_suite(env), torch.Generator().manual_seed(1),
                                                        B, T)
    X = obs.reshape(-1, env.n_obs)
    assert int(torch.linalg.matrix_rank(X)) < env.n_obs and (X == 0).all(0).any()
    policy, w = behavior_cloning_vec(obs, act, env.action_low, env.action_high)
    _, jw = j_offline_vec.behavior_cloning_vec(jnp.asarray(obs.numpy()), jnp.asarray(act.numpy()),
                                               jnp.asarray(env.action_low.numpy()),
                                               jnp.asarray(env.action_high.numpy()))
    jw = np.asarray(jw)
    assert w.shape == jw.shape == (env.n_obs + 1, env.n_action)
    np.testing.assert_allclose(w.numpy(), jw, rtol=0, atol=1e-8 * max(1.0, float(np.abs(jw).max())))
    a = policy(obs[0])
    assert a.shape == (B, env.n_action)
    assert (a >= env.action_low).all() and (a <= env.action_high).all()


def test_suite_runs_and_orders(renv):
    """Port of tests/test_vec_controllers.py::test_suite_runs_and_orders: all
    six controllers roll out; the best informed one beats random."""
    means = {}
    for ctrl in make_suite(renv):
        m = evaluate_controller_vec(renv, ctrl, torch.Generator().manual_seed(0), batch=16, steps=15)
        assert np.isfinite(m), ctrl.name
        means[ctrl.name] = m
    informed = [v for k, v in means.items() if "L0" not in k]
    assert max(informed) > means["L0_random"]


@pytest.mark.parametrize("autoreset", [True, False])
def test_dataset_shapes(renv, autoreset):
    obs, act, rew, nobs, done = generate_dataset_vec(renv, None, torch.Generator().manual_seed(1), batch=8,
                                                     steps=12, autoreset=autoreset)
    assert obs.shape == nobs.shape == (12, 8, renv.n_state)
    assert act.shape == (12, 8, renv.n_action)
    assert rew.shape == done.shape == (12, 8)
    assert torch.isfinite(rew).all()
    assert (act >= renv.action_low).all() and (act <= renv.action_high).all()
    # next_obs of step k is obs of step k + 1
    assert torch.equal(nobs[:-1], obs[1:])


def test_mixed_dataset_weights_and_errors(renv):
    suite = make_suite(renv)[:3]
    (obs, act, rew, nobs, done), assignment = generate_mixed_dataset_vec(
        renv, suite, torch.Generator().manual_seed(2), batch=8, steps=10, weights=[0.2, 0.4, 0.4])
    assert assignment.shape == (8,) and set(assignment.tolist()) <= {0, 1, 2}
    assert act.shape == (10, 8, renv.n_action)
    (_, act2, _, _, _), a2 = generate_mixed_dataset_vec(renv, suite, torch.Generator().manual_seed(2), batch=8,
                                                        steps=10, weights=[0.2, 0.4, 0.4])
    assert torch.equal(assignment, a2) and torch.equal(act, act2)
    fixed = torch.tensor([0, 1, 2, 0, 1, 2, 0, 1])
    _, a3 = generate_mixed_dataset_vec(renv, suite, None, batch=8, steps=2, assignment=fixed)
    assert torch.equal(a3, fixed)
    with pytest.raises(ValueError):
        generate_mixed_dataset_vec(renv, suite, None, 4, 2, weights=[1.0])
    with pytest.raises(ValueError):
        generate_mixed_dataset_vec(renv, suite, None, 4, 2, assignment=[0, 1, 2])
    # A weight of zero never assigns its controller.
    _, a4 = generate_mixed_dataset_vec(renv, suite, torch.Generator().manual_seed(5), batch=8, steps=1,
                                       weights=[0.0, 1.0, 0.0])
    assert (a4 == 1).all()
