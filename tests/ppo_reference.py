"""Shared by the port's PPO parity tests: one JAX ``make_train_step`` call on
the base IEEE33 task, and the same step through ``gym_anm_torch`` with the
JAX package's policy noise and epoch permutations injected.

JAX draws the policy noise from per-lane key chains; the port draws it from
a ``torch.Generator``.  So the JAX draws are recomputed here, following the
chain of ``gym_anm_tpu/parallel/ppo.py`` (the refresh's ``fold_in(key, 7)``
reset, then per step the action split, the step's split and the autoreset's
split; valid while no lane terminates, which the tests assert).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gym_anm_torch import convert
from gym_anm_torch.parallel import ppo
from gym_anm_torch.vec import VecEnv, make_ieee33_task
from gym_anm_tpu.parallel import PPOConfig as JPPOConfig
from gym_anm_tpu.parallel import init_train_state as j_init_train_state
from gym_anm_tpu.parallel import make_train_step as j_make_train_step
from gym_anm_tpu.vec import VecEnv as JVecEnv
from gym_anm_tpu.vec import make_ieee33_task as j_make_ieee33_task

B = 16
CONFIG = dict(hidden=16, rollout_len=4, n_epochs=2, n_minibatches=2, n_lane_minibatches=2, refresh_interval=4)


def jax_rollout_noise(jenv, reset, jstate, step, cfg):
    """The standard-normal draws [T, B, n_action] of JAX's rollout
    (``reset`` is the jitted, vmapped ``jenv.reset``)."""
    key = jstate.key
    n_lanes = key.shape[0]
    if cfg.refresh_interval:
        mask = (np.arange(n_lanes) + step) % cfg.refresh_interval == 0
        rstate, _ = reset(jax.vmap(lambda k: jax.random.fold_in(k, 7))(key))
        key = jnp.where(mask[:, None], rstate.key, key)

    @jax.jit
    def advance(key):
        keys = jax.vmap(jax.random.split)(key)
        k_act, key = keys[:, 0], keys[:, 1]
        draw = jax.vmap(lambda k: jax.random.normal(k, (jenv.n_action,), jenv.dtype))(k_act)
        key = jax.vmap(lambda k: jax.random.split(k)[0])(key)  # VecEnv.step
        return draw, jax.vmap(lambda k: jax.random.split(k)[1])(key)  # step_autoreset_batch

    draws = []
    for _ in range(cfg.rollout_len):
        draw, key = advance(key)
        draws.append(np.asarray(draw))
    return np.stack(draws)


def jax_permutations(step, cfg):
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(17), step), cfg.n_epochs)
    return [np.asarray(jax.random.permutation(k, cfg.rollout_len)).tolist() for k in keys]


def run_both(jdtype, tdtype):
    """One JAX PPO step after a first one (so the step count, the moments and
    the states are past their start), and the same step of the port from the
    JAX state.  Returns (JAX's (ts, state, obs, metrics), the port's)."""
    jcfg, cfg = JPPOConfig(**CONFIG), ppo.PPOConfig(**CONFIG)
    jenv = JVecEnv(j_make_ieee33_task(), dtype=jdtype)
    reset = jax.jit(jax.vmap(jenv.reset))
    jstate, jobs = reset(jax.random.split(jax.random.PRNGKey(0), B))
    jts = j_init_train_state(jax.random.PRNGKey(1), jenv.n_state, jenv.n_action, jcfg, dtype=jdtype)
    jstep = jax.jit(j_make_train_step(jenv, jcfg))
    jts, jstate, jobs, _ = jstep(jts, jstate, jobs)
    step = int(jts.step)
    noise, perms = jax_rollout_noise(jenv, reset, jstate, step, jcfg), jax_permutations(step, jcfg)

    env = VecEnv(make_ieee33_task(), dtype=tdtype, device="cpu")
    ts = convert.ppo_state_from_jax(jts, "cpu")
    state, obs = convert.state_from_jax(jstate, "cpu"), torch.as_tensor(np.array(jobs))
    port = ppo.make_train_step(env, cfg)
    state, obs = port.refresh(ts.step, state, obs)
    state, obs, traj = port.rollout(ts.params, state, obs, torch.as_tensor(noise))
    ts, metrics = port.update(ts, traj, perms)
    return jstep(jts, jstate, jobs), (ts, state, obs, metrics)


def rel_err(a, b):
    """max |a - b| over max |b| (over 1 where b is all zeros)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.max(np.abs(b), initial=0.0)
    return float(np.max(np.abs(a - b), initial=0.0) / (scale if scale > 0 else 1.0))


def params_rel_err(module, jparams):
    return {n: rel_err(p.detach().cpu().numpy(), convert.param_from_jax(jparams, n))
            for n, p in module.named_parameters()}
