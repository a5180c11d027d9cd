"""gym_anm_torch's CQL learner against the JAX package's, and its behaviour.

Parity at float64: JAX's weights and targets carried across with
``convert.cql_state_from_jax``, the same numpy-made minibatch, and the
normal and uniform draws JAX makes from the update's key passed to the port.
``sample_action``, ``deterministic_action``, ``q_value``, the loss terms and
their gradients (where ``.detach()`` stands decides them) and one update
with its Adam and Polyak steps agree within 1e-10 (norm-wise relative).  The
behaviour tests are three of ``tests/test_cql.py``'s on the port; its
sharded-update test is the two-rank test of ``test_torch_distributed.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_anm_torch import convert
from gym_anm_torch.parallel import cql
from gym_anm_tpu.parallel import cql as jcql

from .ppo_reference import params_rel_err, rel_err

torch.set_num_threads(2)

O, A, H, NB = 6, 3, 16, 32  # obs dim, action dim, hidden, batch
LO, HI = np.array([0.0, -2.0, 0.9]), np.array([1.0, 2.0, 1.1])
CFG = cql.CQLConfig(hidden=H, cql_weight=2.0)


@pytest.fixture(scope="module")
def case():
    """A JAX f64 CQLState two updates in (nonzero moments, targets apart from
    the critics), the port's copy, a minibatch and JAX's draws for one key."""
    rng = np.random.default_rng(0)
    state = jcql.init_cql_state(jax.random.PRNGKey(0), O, A, CFG, dtype=jnp.float64)
    def rand(tree, scale):  # tree + N(0, scale²)
        return jax.tree_util.tree_map(lambda x: x + jnp.asarray(scale * rng.standard_normal(x.shape)), tree)

    def pos(tree, scale):  # U(0, scale)
        return jax.tree_util.tree_map(lambda x: jnp.asarray(scale * rng.random(x.shape)), tree)

    train = state.train._replace(params=rand(state.train.params, 0.2), opt_m=rand(state.train.opt_m, 1e-2),
                                 opt_v=pos(state.train.opt_v, 1e-3), step=jnp.asarray(2, jnp.int32))
    state = jcql.CQLState(train=train, target_q=rand(state.target_q, 0.05))
    batch = {"obs": rng.normal(size=(NB, O)), "actions": LO + (HI - LO) * rng.random((NB, A)),
             "rewards": rng.normal(size=NB), "next_obs": rng.normal(size=(NB, O)),
             "dones": (rng.random(NB) < 0.3).astype(np.float64)}
    key = jax.random.PRNGKey(5)
    k_next, k_unif, k_pol, _, k_actor = jax.random.split(key, 5)
    n = CFG.n_cql_actions
    noise = {"next": jax.random.normal(k_next, (NB, A), jnp.float64),
             "unif": jax.random.uniform(k_unif, (n, NB, A), jnp.float64),
             "pol": jnp.stack([jax.random.normal(k, (NB, A), jnp.float64) for k in jax.random.split(k_pol, n)]),
             "actor": jax.random.normal(k_actor, (NB, A), jnp.float64)}
    t = lambda d: {k: torch.as_tensor(np.array(v)) for k, v in d.items()}  # noqa: E731
    return state, convert.cql_state_from_jax(state, "cpu"), batch, t(batch), key, noise, t(noise)


@pytest.mark.parametrize("fn", ["sample_action", "deterministic_action", "q_value"])
def test_functions_match_jax_f64(case, fn):
    jstate, state, batch, tbatch, _, noise, tnoise = case
    jp, net = jstate.train.params, state.train.params
    lo, hi = torch.as_tensor(LO), torch.as_tensor(HI)
    if fn == "sample_action":
        k = jax.random.PRNGKey(9)
        eps = jax.random.normal(k, (NB, A), jnp.float64)
        want = jax.jit(jcql.sample_action)(jp["pi"], k, batch["obs"], LO, HI)
        got = cql.sample_action(net.pi, torch.as_tensor(np.array(eps)), tbatch["obs"], lo, hi)
    elif fn == "deterministic_action":
        want = [jax.jit(jcql.deterministic_action)(jp["pi"], batch["obs"], LO, HI)]
        got = [cql.deterministic_action(net.pi, tbatch["obs"], lo, hi)]
    else:
        q_value = jax.jit(jcql.q_value)
        want = [q_value(jp["q1"], batch["obs"], batch["actions"]),
                q_value(jstate.target_q["q2"], batch["obs"], batch["actions"])]
        got = [cql.q_value(net.q1, tbatch["obs"], tbatch["actions"]),
               cql.q_value(state.target_q["q2"], tbatch["obs"], tbatch["actions"])]
    for g, w in zip(got, want):
        assert g.shape == np.asarray(w).shape
        assert rel_err(g.detach().numpy(), w) <= 1e-10, fn


def _jax_loss_fn(update):
    """The reference's loss, a closure of its update (``cql.py:130-189``)."""
    return update.__closure__[update.__code__.co_freevars.index("loss_fn")].cell_contents


def test_loss_terms_and_gradients_match_jax_f64(case):
    jstate, state, batch, tbatch, key, _, tnoise = case
    loss_fn = _jax_loss_fn(jcql.make_cql_update(CFG, LO, HI))
    jgrads, jm = jax.jit(jax.grad(lambda p: loss_fn(p, jstate.target_q, key, batch), has_aux=True))(
        jstate.train.params)
    update = cql.make_cql_update(CFG, torch.as_tensor(LO), torch.as_tensor(HI))
    net = state.train.params
    loss, m = update.loss(net, state.target_q, tnoise, tbatch)
    for k in jm:
        assert rel_err(m[k].item(), jm[k]) <= 1e-10, k
    # The gradients of every network: the critics see the Bellman and CQL
    # terms only, the policy the actor term only.
    for (name, p), g in zip(net.named_parameters(), torch.autograd.grad(loss, list(net.parameters()))):
        assert rel_err(g.numpy(), convert.param_from_jax(jgrads, name)) <= 1e-10, name


def test_update_matches_jax_f64(case):
    """One update: Adam on every network from step 2, then the Polyak step of
    the targets; the metrics too."""
    jstate, state, _, tbatch, key, _, tnoise = case
    jnew, jm = jax.jit(jcql.make_cql_update(CFG, LO, HI))(jstate, key, case[2])
    state = state.to()
    new, m = cql.make_cql_update(CFG, torch.as_tensor(LO), torch.as_tensor(HI))(state, None, tbatch, tnoise)
    assert new.train.step == int(jnew.train.step) == 3
    assert max(params_rel_err(new.train.params, jnew.train.params).values()) <= 1e-10
    assert max(params_rel_err(new.target_q, jnew.target_q).values()) <= 1e-10
    for n, _ in new.train.params.named_parameters():
        assert rel_err(new.train.opt_m[n].numpy(), convert.param_from_jax(jnew.train.opt_m, n)) <= 1e-10, n
        assert rel_err(new.train.opt_v[n].numpy(), convert.param_from_jax(jnew.train.opt_v, n)) <= 1e-10, n
    for k in jm:
        assert rel_err(m[k].item(), jm[k]) <= 1e-10, k


# ---------------------------------------------------------------------------
# Behaviour (tests/test_cql.py on the port).


def _toy_dataset(n=2048, obs_dim=6, act_dim=3, seed=0):
    """Bandit-like: reward = -||a - a*(s)||², a* a known map of the state, so
    a learner that improves steers actions toward a*."""
    rng = np.random.RandomState(seed)
    W = rng.randn(obs_dim, act_dim) * 0.3
    obs = rng.randn(n, obs_dim).astype(np.float32)
    a_star = np.tanh(obs @ W)
    acts = np.clip(a_star + 0.5 * rng.randn(n, act_dim), -1, 1).astype(np.float32)
    rew = -np.sum((acts - a_star) ** 2, axis=1).astype(np.float32)
    return {"states": obs, "actions": acts, "rewards": rew, "next_states": rng.randn(n, obs_dim).astype(np.float32),
            "dones": np.ones(n, np.float32)}, W


def test_cql_learns_toy_bandit():
    data, W = _toy_dataset()
    lo, hi = -np.ones(3, np.float32), np.ones(3, np.float32)
    cfg = cql.CQLConfig(hidden=64, lr=1e-3, cql_weight=1.0, gamma=0.0)
    _, metrics, policy = cql.train_cql(0, data, lo, hi, cfg, steps=400, batch_size=256, device="cpu")
    assert np.isfinite(float(metrics["loss"]))
    # The learned policy beats the noisy behaviour policy on the known reward.
    obs = data["states"][:512]
    a_star = np.tanh(obs @ W)
    r_pi = -np.sum((policy(obs).numpy() - a_star) ** 2, axis=1).mean()
    r_beh = -np.sum((data["actions"][:512] - a_star) ** 2, axis=1).mean()
    assert r_pi > r_beh + 0.2, (r_pi, r_beh)


def test_cql_penalty_is_conservative():
    """With a large CQL weight, Q on out-of-distribution actions ends up
    below Q on the dataset's actions."""
    data, _ = _toy_dataset(n=1024)
    lo, hi = -np.ones(3, np.float32), np.ones(3, np.float32)
    cfg = cql.CQLConfig(hidden=64, lr=1e-3, cql_weight=10.0, gamma=0.0)
    state, _, _ = cql.train_cql(1, data, lo, hi, cfg, steps=300, batch_size=256, device="cpu")
    q1 = state.train.params.q1
    obs, acts = torch.as_tensor(data["states"][:256]), torch.as_tensor(data["actions"][:256])
    ood = torch.rand(acts.shape, generator=torch.Generator().manual_seed(2)) * 2 - 1
    with torch.no_grad():
        assert float(cql.q_value(q1, obs, acts).mean()) > float(cql.q_value(q1, obs, ood).mean())


def test_policy_respects_action_box():
    data, _ = _toy_dataset(n=256)
    lo = np.array([0.0, -2.0, 0.9], np.float32)
    hi = np.array([1.0, 2.0, 1.1], np.float32)
    data["actions"] = (lo + hi) / 2 + data["actions"] * (hi - lo) / 2
    _, _, policy = cql.train_cql(0, data, lo, hi, cql.CQLConfig(hidden=32), steps=20, batch_size=128, device="cpu")
    a = policy(data["states"][:64]).numpy()
    assert np.all(a >= lo - 1e-5) and np.all(a <= hi + 1e-5)


def test_entry_point_needs_a_card_or_the_cpu_flag(monkeypatch):
    """``python -m gym_anm_torch.scripts.train_cql_offline`` raises without a
    card unless asked for the CPU; with ``--cpu`` it collects the L0-L5
    dataset, trains and evaluates CQL, random and L5."""
    from gym_anm_torch.scripts import train_cql_offline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--cpu"):
        train_cql_offline.main(["--lanes", "4", "--steps", "2", "--train-steps", "2"])
    run = train_cql_offline.main(["--cpu", "--lanes", "4", "--steps", "2", "--train-steps", "4"])
    assert run["device"] == "cpu" and run["transitions"] == 6 * 4 * 2 and run["state"].train.step == 4
    assert np.isfinite(list(run["metrics"].values())).all()
    assert set(run["eval"]) == {"cql", "random", "L5"} and np.isfinite(list(run["eval"].values())).all()
