"""The port's examples (``gym_anm_torch.examples``) run clean on the CPU (the
counterpart of ``test_examples.py``), and agree with the JAX package's
``examples/`` where both can be given the same inputs.

Parity: ``simple_env`` and ``custom_anm6`` draw from the global ``np.random``
(both environments are built, reset and stepped from the same state) and
step with the same actions; their observations and rewards agree within
1e-8.  ``offline_mixed``, ``mpc_constant`` and ``mpc_perfect`` run as
whole examples, the JAX one and the port's, under one ``gymnasium.make``
that resets the environment with seed 0, seeds its action space and records
each step's action and reward: datasets within 1e-8, the MPC agents'
actions and rewards within 1e-6 (the bar of the MPC agents in
``test_torch_compat.py``).  ``mpc_vec`` draws its resets from JAX keys on
one side and a torch generator on the other, so it is held to the JAX
test's own bar (it runs; finite results), as ``gym_vector_interop`` is.
"""

import importlib.util
import os

import gymnasium
import numpy as np
import numpy.testing as npt
import pytest
import torch

import gym_anm_torch.render.rendering as rmod
from gym_anm_torch.examples import (custom_anm6, gym_vector_interop, mpc_constant, mpc_perfect, mpc_vec,
                                    new_env_template, offline_mixed, random_agent, simple_env)

from .test_torch_compat import twin

torch.set_num_threads(2)

ATOL = 1e-8
MPC_ATOL = 1e-6
EXAMPLES_DIR = os.path.join(os.path.dirname(__file__), "..", "examples")


def jax_example(name):
    """The JAX package's ``examples/<name>.py``, loaded under its own name."""
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", os.path.join(EXAMPLES_DIR, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_simple_env_example():
    env = simple_env.SimpleEnvironment(device="cpu")
    env.reset()
    for _ in range(5):
        o, r, term, _, _ = env.step(env.action_space.sample())
        assert np.isfinite(r)
    assert all(np.isfinite(simple_env.run(steps=3, device="cpu")))


def test_custom_anm6_example():
    np.random.seed(0)
    env = custom_anm6.CustomANM6Environment(device="cpu")
    env.reset()
    for _ in range(5):
        o, r, term, _, _ = env.step(env.action_space.sample())
        assert np.isfinite(r)
        if term:
            env.reset()
    assert all(np.isfinite(custom_anm6.run(steps=3, device="cpu")))


def test_new_env_template_is_valid_skeleton():
    cls = new_env_template.CustomEnvironment
    for hook in ("init_state", "next_vars", "observation_bounds", "render", "close"):
        assert callable(getattr(cls, hook))


@pytest.mark.parametrize("mod", [mpc_constant, mpc_perfect], ids=["mpc_constant", "mpc_perfect"])
def test_mpc_examples(mod):
    assert all(np.isfinite(mod.run(steps=3, planning_steps=2, device="cpu")))


def test_mpc_vec_example():
    out = mpc_vec.run(batch=2, steps=3, horizons=(2,), device="cpu")
    assert set(out) == {"constant N=1", "perfect N=2"} and all(np.isfinite(list(out.values())))


@pytest.mark.parametrize("render", [False, True], ids=["no_render", "render"])
def test_random_agent_example(render):
    """With ``render``, every step publishes a frame to the dashboard's
    servers (the browser tab patched out), which ``close`` stops."""
    orig = rmod.webbrowser.open
    rmod.webbrowser.open = lambda *a, **k: None
    try:
        rewards = random_agent.run(steps=3, render=render, sleep=0, device="cpu", seed=0)
    finally:
        rmod.webbrowser.open = orig
    assert len(rewards) == 3 and all(np.isfinite(rewards))


def test_offline_mixed_example():
    states, actions = offline_mixed.run(steps=6, device="cpu")
    assert len(states) == 6 and len(actions) == 6


def test_gym_vector_interop_example():
    total, episodes = gym_vector_interop.run(num_envs=8, steps=10, device="cpu")
    assert np.isfinite(total)


# --- parity with the JAX examples ---------------------------------------------

@pytest.mark.parametrize("name,cls", [("simple_env", "SimpleEnvironment"), ("custom_anm6", "CustomANM6Environment")])
def test_custom_env_examples_equal_jax(name, cls):
    port = {"simple_env": simple_env, "custom_anm6": custom_anm6}[name]
    np.random.seed(0)
    ej, ep = twin(lambda: getattr(jax_example(name), cls)(), lambda: getattr(port, cls)(device="cpu"))
    oj, op = twin(lambda: ej.reset(seed=0)[0], lambda: ep.reset(seed=0)[0])
    npt.assert_allclose(op, oj, rtol=0, atol=ATOL)
    rng = np.random.default_rng(0)
    for t in range(8):
        a = rng.uniform(ej.action_space.low, ej.action_space.high)
        (oj, rj, tj, _, _), (op, rp, tp, _, _) = twin(lambda: ej.step(a), lambda: ep.step(a))
        assert tj == tp, t
        npt.assert_allclose(op, oj, rtol=0, atol=ATOL, err_msg=f"step {t}")
        assert abs(rp - rj) <= ATOL, (t, rj, rp)
        if tj:
            twin(lambda: ej.reset(seed=0), lambda: ep.reset(seed=0))


@pytest.fixture
def recorded_make(monkeypatch):
    """``gymnasium.make`` whose environments reset with seed 0, have their
    action space seeded with 0 and record every step's action and reward
    (``records``: one dict a made environment)."""
    records = []
    make = gymnasium.make

    def seeded(env_id, **kwargs):
        env = make(env_id, **kwargs)
        env.action_space.seed(0)
        rec = {"actions": [], "rewards": []}
        reset, step = env.reset, env.step

        def rec_step(a):
            out = step(a)
            rec["actions"].append(np.array(a, dtype=float))
            rec["rewards"].append(out[1])
            return out

        env.reset = lambda seed=None, options=None: reset(seed=0, options=options)
        env.step = rec_step
        records.append(rec)
        return env

    monkeypatch.setattr(gymnasium, "make", seeded)
    return records


def test_offline_mixed_equals_jax(recorded_make):
    mod = jax_example("offline_mixed")
    np.random.seed(0)
    sj, aj = mod.run(steps=10)
    np.random.seed(0)
    sp, ap = offline_mixed.run(steps=10, device="cpu")
    assert sj.shape == sp.shape and aj.shape == ap.shape
    npt.assert_allclose(sp, sj, rtol=0, atol=ATOL)
    npt.assert_allclose(ap, aj, rtol=0, atol=ATOL)


@pytest.mark.parametrize("mod", [mpc_constant, mpc_perfect], ids=["mpc_constant", "mpc_perfect"])
def test_mpc_examples_equal_jax(mod, recorded_make):
    jmod = jax_example(mod.__name__.rsplit(".", 1)[1])
    jmod.run(steps=4)
    rewards = mod.run(steps=4, device="cpu")
    rj, rp = recorded_make
    assert len(rj["rewards"]) == len(rp["rewards"]) == 4 and rp["rewards"] == rewards
    npt.assert_allclose(np.array(rp["actions"]), np.array(rj["actions"]), rtol=0, atol=MPC_ATOL)
    npt.assert_allclose(rp["rewards"], rj["rewards"], rtol=0, atol=MPC_ATOL)
