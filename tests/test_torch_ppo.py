"""gym_anm_torch's PPO learner against the JAX package's, and its behaviour.

Parity at float64 (the JAX package runs under ``jax_enable_x64``): the
same numpy-made inputs, JAX's weights carried across with
``convert.ppo_state_from_jax``, JAX's noise and permutations injected.
``log_prob``, ``value_fn``, ``gae`` and ``make_io_norm`` agree within 1e-12
(norm-wise relative), the loss, its gradients and one Adam step within
1e-10, and one whole training step on base IEEE33 within 1e-8 (the golden-
rollout bar; the raw mean reward is a float32 mean in both, summed in
another order, so it is held at float32's resolution).  The behaviour
tests are ``tests/test_ppo.py``'s on the port.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_anm_torch import convert
from gym_anm_torch.parallel import ppo
from gym_anm_torch.vec import VecEnv, VecTask, make_ieee33_multicap_task
from gym_anm_tpu.parallel import ppo as jppo
from gym_anm_tpu.vec import VecEnv as JVecEnv
from gym_anm_tpu.vec import make_ieee33_multicap_task as j_make_ieee33_multicap_task

from .ppo_reference import params_rel_err, rel_err, run_both

torch.set_num_threads(2)

O, A, H, T, NB = 7, 3, 8, 4, 6  # obs dim, action dim, hidden, time steps, lanes


@pytest.fixture(scope="module")
def nets():
    """A JAX f64 TrainState (nonzero moments, step 3) and the port's copy."""
    jts = jppo.init_train_state(jax.random.PRNGKey(3), O, A, ppo.PPOConfig(hidden=H), dtype=jnp.float64)
    rng = np.random.default_rng(0)
    def rand(tree, scale):
        return jax.tree_util.tree_map(lambda x: jnp.asarray(scale * rng.random(x.shape)), tree)

    jts = jts._replace(params=rand(jts.params, 0.5), opt_m=rand(jts.params, 1e-2), opt_v=rand(jts.params, 1e-3),
                       step=jnp.asarray(3, jnp.int32))
    return jts, convert.ppo_state_from_jax(jts, "cpu")


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    return SimpleNamespace(obs=rng.normal(size=(T, NB, O)), act=rng.uniform(-1, 1, (T, NB, A)),
                           rew=rng.normal(size=(T, NB)).astype(np.float32), val=rng.normal(size=(T, NB)),
                           done=(rng.random((T, NB)) < 0.3).astype(np.float32), adv=rng.normal(size=(T, NB)),
                           ret=rng.normal(size=(T, NB)), logp=rng.normal(size=(T, NB)))


@pytest.mark.parametrize("fn", ["log_prob", "value_fn", "gae", "make_io_norm"])
def test_functions_match_jax_f64(nets, fn):
    jts, ts = nets
    x = _inputs()
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    if fn == "log_prob":
        pairs = [(ppo.log_prob(ts.params, t(x.obs), t(x.act)), jax.jit(jppo.log_prob)(jts.params, x.obs, x.act))]
    elif fn == "value_fn":
        pairs = [(ppo.value_fn(ts.params, t(x.obs)), jax.jit(jppo.value_fn)(jts.params, x.obs))]
    elif fn == "gae":
        got = ppo.gae(t(x.rew), t(x.val), t(x.done), 0.99, 0.95)
        pairs = [(got, jax.jit(jppo.gae, static_argnums=(3, 4))(x.rew, x.val, x.done, 0.99, 0.95))]
        assert got.dtype == torch.float64
    else:  # the multicap task: finite power bounds, non-finite aux bounds
        env = VecEnv(make_ieee33_multicap_task(), dtype=torch.float64, device="cpu")
        jenv = JVecEnv(j_make_ieee33_multicap_task(), dtype=jnp.float64)
        obs = np.random.default_rng(2).normal(size=(NB, env.n_obs)) * 10
        norm, mid, half = ppo.make_io_norm(env)
        jnorm, jmid, jhalf = jppo.make_io_norm(jenv)
        assert mid.dtype == half.dtype == torch.float32
        pairs = [(norm(t(obs)), jax.jit(jnorm)(obs)), (mid, jmid), (half, jhalf)]
    for got, want in pairs:
        assert got.shape == np.asarray(want).shape
        assert rel_err(got.detach().numpy(), want) <= 1e-12, fn


def _jax_loss(cfg, params, obs, act, adv, ret, logp_old):
    """The reference's minibatch loss, ``gym_anm_tpu/parallel/ppo.py:281-290``
    (a closure of its train step, so restated here term by term)."""
    logp = jppo.log_prob(params, obs, act)
    ratio = jnp.exp(logp - logp_old)
    unclipped = ratio * adv
    clipped = jnp.clip(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
    pg_loss = -jnp.mean(jnp.minimum(unclipped, clipped))
    v = jppo.value_fn(params, obs)
    v_loss = jnp.mean((v - ret) ** 2)
    ent = jnp.sum(params["log_std"] + 0.5 * jnp.log(2 * jnp.pi * jnp.e))
    return pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * ent, (pg_loss, v_loss)


def test_loss_gradients_and_adam_match_jax_f64(nets):
    """The loss, its gradients and one Adam step from step 3 (where the
    reference's float32 bias correction is 7e-6 off the float64 one)."""
    jts, ts = nets
    cfg = ppo.PPOConfig(hidden=H, ent_coef=0.01)
    x = _inputs(4)
    args = (x.obs, x.act, x.adv, x.ret, x.logp)
    (jloss, (jpg, jvl)), jgrads = jax.jit(jax.value_and_grad(lambda p: _jax_loss(cfg, p, *args), has_aux=True))(
        jts.params)
    loss, pg, vl = ppo.ppo_loss(ts.params, cfg, *(torch.as_tensor(a) for a in args))
    for got, want in ((loss, jloss), (pg, jpg), (vl, jvl)):
        assert rel_err(got.item(), want) <= 1e-10
    names = [n for n, _ in ts.params.named_parameters()]
    grads = torch.autograd.grad(loss, list(ts.params.parameters()))
    for n, g in zip(names, grads):
        assert rel_err(g.numpy(), convert.param_from_jax(jgrads, n)) <= 1e-10, n

    # Adam on the same gradients (JAX's, carried across).
    new = ppo.adam_update(ts.to(), {n: torch.as_tensor(convert.param_from_jax(jgrads, n)) for n in names}, cfg.lr)
    jnew = jax.jit(jppo.adam_update, static_argnums=2)(jts, jgrads, cfg.lr)
    assert new.step == int(jnew.step) == 4
    assert max(params_rel_err(new.params, jnew.params).values()) <= 1e-10
    for n in names:
        assert rel_err(new.opt_m[n].numpy(), convert.param_from_jax(jnew.opt_m, n)) <= 1e-10, n
        assert rel_err(new.opt_v[n].numpy(), convert.param_from_jax(jnew.opt_v, n)) <= 1e-10, n


def test_train_step_matches_jax_f64():
    """One whole train step on base IEEE33 at B = 16, rollout 4, hidden 16,
    2 epochs × 2 time × 2 lane minibatches, refresh every 4 lanes, from a
    state one step in: parameters, moments, metrics and the next obs within
    1e-8."""
    (jts, jstate, jobs, jm), (ts, state, obs, m) = run_both(jnp.float64, torch.float64)
    assert float(jm["done_rate"]) == float(m["done_rate"]) == 0.0  # the noise chain holds
    assert ts.step == int(jts.step)
    assert max(params_rel_err(ts.params, jts.params).values()) <= 1e-8
    for n, _ in ts.params.named_parameters():
        assert rel_err(ts.opt_m[n].numpy(), convert.param_from_jax(jts.opt_m, n)) <= 1e-8, n
        assert rel_err(ts.opt_v[n].numpy(), convert.param_from_jax(jts.opt_v, n)) <= 1e-8, n
    for k in ("loss", "pg_loss", "v_loss"):
        assert rel_err(float(m[k]), float(jm[k])) <= 1e-8, k
    assert m["mean_reward"].dtype == torch.float32
    np.testing.assert_allclose(float(m["mean_reward"]), float(jm["mean_reward"]), rtol=1e-6)
    assert rel_err(obs.numpy(), np.asarray(jobs)) <= 1e-8
    assert rel_err(state.bus_vm.numpy(), np.asarray(jstate.bus_vm)) <= 1e-8


# ---------------------------------------------------------------------------
# Behaviour (tests/test_ppo.py on the port).  A 2-bus grid with one
# controllable renewable next to the load: the reward is −(losses +
# curtailment), ~1 MW per MW of dispatched renewable power, so the optimum
# is full dispatch (P_gen = p_pot = 20 MW).

_TOY_NETWORK = {
    "baseMVA": 100,
    "bus": np.array([[0, 0, 132, 1.0, 1.0], [1, 1, 33, 1.1, 0.9]]),
    "device": np.array(
        [
            [0, 0, 0, None, 200, -200, 200, -200] + [None] * 7,
            [1, 1, -1, 0.2, 0, -10] + [None] * 9,
            [2, 1, 2, None, 25, 0, 25, -25] + [None] * 7,
        ],
        dtype=object,
    ),
    "branch": np.array([[0, 1, 0.01, 0.1, 0.0, 999, 1, 0]]),
}
_P_LOAD, _P_POT = -10.0, 20.0  # MW


def _toy_task():
    s0 = np.array([0.0, _P_LOAD, 0.0, 0.0, _P_LOAD * 0.2, 0.0, _P_POT])

    def init_state_fn(generator, n, carry):
        return np.broadcast_to(s0, (n, s0.size))

    def next_vars_fn(generator, s_t, carry, t):
        return torch.tensor([_P_LOAD, _P_POT], dtype=s_t.dtype).expand(s_t.shape[0], 2), carry

    return VecTask(network=_TOY_NETWORK, K=0, delta_t=1.0, gamma=0.9, lamb=100, costs_clipping=(None, 100),
                   init_state_fn=init_state_fn, next_vars_fn=next_vars_fn, name="toy_renewable")


@pytest.fixture(scope="module")
def toy_env():
    return VecEnv(_toy_task(), dtype=torch.float32, device="cpu")


def _run_training(env, cfg, n_updates, batch=32, seed=0):
    state, obs = env.reset(batch)
    ts = ppo.init_train_state(seed + 1, env.n_state, env.n_action, cfg, device="cpu")
    step = ppo.make_train_step(env, cfg, seed=seed)
    rewards = []
    for _ in range(n_updates):
        ts, state, obs, metrics = step(ts, state, obs)
        rewards.append(float(metrics["mean_reward"]))
    return ts, np.asarray(rewards)


def test_ppo_learns_toy_dispatch(toy_env):
    """Near-full dispatch from at least one of two inits, and no regression
    from the other.  Doing nothing: r ≈ −0.2 (20 MW curtailed); full
    dispatch: r ≈ −0.001 (losses).  PPO on this toy has seed variance (an
    init can collapse its exploration before full dispatch and hover near
    80%); a broken learner fails on every seed."""
    cfg = ppo.PPOConfig(hidden=32, lr=1e-2, rollout_len=8, gamma=0.9, reward_scale=0.1, n_epochs=4)
    results = {}
    for seed in (0, 1):
        _, rewards = _run_training(toy_env, cfg, n_updates=80, seed=seed)
        assert np.isfinite(rewards).all(), f"seed {seed} diverged"
        first, last = rewards[:5].mean(), rewards[-5:].mean()
        assert last > first - 0.05, (seed, first, last)
        results[seed] = last
    assert max(results.values()) > -0.01, results


def test_ppo_minibatching_epochs(toy_env):
    """n_epochs, n_minibatches and n_lane_minibatches > 1 run, stay finite,
    and still learn."""
    cfg = ppo.PPOConfig(hidden=32, lr=1e-2, rollout_len=8, gamma=0.9, reward_scale=0.1, n_epochs=2,
                        n_minibatches=2, n_lane_minibatches=2)
    _, rewards = _run_training(toy_env, cfg, n_updates=50)
    assert np.isfinite(rewards).all()
    assert rewards[-5:].mean() > rewards[:5].mean() * 0.5


def test_ppo_rejects_indivisible_minibatches(toy_env):
    with pytest.raises(ValueError, match="divisible"):
        ppo.make_train_step(toy_env, ppo.PPOConfig(rollout_len=8, n_minibatches=3))
    step = ppo.make_train_step(toy_env, ppo.PPOConfig(rollout_len=2, n_lane_minibatches=3))
    ts = ppo.init_train_state(0, toy_env.n_state, toy_env.n_action, step.cfg, device="cpu")
    state, obs = toy_env.reset(4)
    with pytest.raises(ValueError, match="divisible"):
        step(ts, state, obs)


def test_io_norm_handles_nonfinite_bounds(toy_env):
    """Finite dims map to ~[-1, 1]; non-finite or degenerate dims pass
    through with identity scaling (no inf/NaN in the nets)."""
    fake = SimpleNamespace(obs_low=torch.tensor([-10.0, -np.inf, 3.0]), obs_high=torch.tensor([30.0, np.inf, 3.0]),
                           action_low=torch.tensor([-2.0]), action_high=torch.tensor([6.0]))
    norm_obs, act_mid, act_half = ppo.make_io_norm(fake)
    o = norm_obs(torch.tensor([30.0, 123.0, 3.0]))
    np.testing.assert_allclose(o.numpy(), [1.0, 123.0, 3.0])
    assert float(act_mid[0]) == 2.0 and float(act_half[0]) == 4.0
    norm_obs2, am, ah = ppo.make_io_norm(toy_env)
    assert torch.isfinite(norm_obs2(toy_env.obs_low)).all()
    assert torch.isfinite(am).all() and torch.isfinite(ah).all()


def test_ppo_reward_scale_is_config(toy_env):
    """mean_reward reports the RAW env reward whatever reward_scale is."""
    _, ra = _run_training(toy_env, ppo.PPOConfig(hidden=16, rollout_len=4, reward_scale=1.0), 1, seed=3)
    _, rb = _run_training(toy_env, ppo.PPOConfig(hidden=16, rollout_len=4, reward_scale=0.001), 1, seed=3)
    np.testing.assert_allclose(ra, rb, rtol=1e-5)


def test_entry_point_needs_a_card_or_the_cpu_flag(monkeypatch, tmp_path):
    """``python -m gym_anm_torch.scripts.train_ppo_online`` raises without a
    card unless asked for the CPU; with ``--cpu`` it trains and its saved
    TrainState restores bit for bit."""
    from gym_anm_torch.scripts import train_ppo_online
    from gym_anm_torch.utils import restore_checkpoint

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--cpu"):
        train_ppo_online.main(["--lanes", "8", "--iters", "1"])
    run = train_ppo_online.main(["--cpu", "--lanes", "8", "--iters", "2", "--rollout", "2", "--lane-minibatches", "2",
                                 "--save", str(tmp_path)])
    assert run["device"] == "cpu" and len(run["metrics"]) == 2 and run["ts"].step == 4  # 2 minibatches each
    assert all(np.isfinite(list(m.values())).all() for m in run["metrics"])
    restored = restore_checkpoint(tmp_path, run["ts"], step=2)
    assert all(torch.equal(p, q) for p, q in zip(run["ts"].params.parameters(), restored.params.parameters()))
