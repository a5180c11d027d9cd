"""The port's ``CorrectedL0``-``L5`` hierarchy and offline tools against the
JAX package's (the counterpart of ``test_agents_offline.py``).

The JAX classes and functions run on the JAX compat environments and the
port's on the port's (``device="cpu"``), from the same seed and global
``np.random`` state (``torch_twins``).  Actions, rewards, dataset states and
actions and evaluated returns agree within 1e-8.  ``behavior_cloning``'s
coefficients fitted on the same dataset are bitwise equal, and fitted on
each package's own dataset they agree within 1e-10 on ``IEEE33Env``.  On the
Corrected mixture of the renewable env they agree within 1e-8 (measured
1.878e-9 on the 24-step uniform mixture): that design has rank 6 of 73
columns with its least nonzero singular value at 5.6e-3 and coefficients up
to 23, so the datasets' 1e-12 differences (the load flow's last digits) come
back multiplied by ~4e3.  The port's MPC agent keeps the DC-OPF constraints
of the JAX file's two MPC cases.  And ``chip_smoke.py``'s stand-in for
gymnasium runs the port's compat tier as gymnasium does.
"""

import numpy as np
import numpy.testing as npt
import pytest
import torch

import gym_anm_torch
import gym_anm_torch.offline as toff
import gym_anm_tpu.offline as joff
from gym_anm_torch import agents as tagents
from gym_anm_tpu import agents as jagents

from .conftest import requires_reference
from .torch_twins import closed_loop, make_envs, start, twin

torch.set_num_threads(2)

ATOL = 1e-8
BC_ATOL = 1e-10
BC_MIXED_ATOL = 1e-8  # BC on each package's own Corrected mixture (see above)

NAMES = ["CorrectedL0_Random", "CorrectedL1_Basic", "CorrectedL2_VoltageThreshold", "CorrectedL3_Coordinated",
         "CorrectedL4_Predictive", "CorrectedL5_Optimal"]


@pytest.fixture(scope="module")
def renewable():
    return make_envs(lambda pkg, **kw: pkg.IEEE33RenewableEnv(**kw))


@pytest.fixture(scope="module")
def ieee33():
    return make_envs(lambda pkg, **kw: pkg.IEEE33Env(**kw))


def test_hierarchy_runs_and_returns(renewable):
    """Each Corrected controller's 15-step return from seed 1; the informed
    controllers beat random, and the port's returns equal JAX's."""
    ej, ep = renewable
    returns = {}
    for name in NAMES:
        _, _, rec = closed_loop(ej, ep, getattr(jagents, name), getattr(tagents, name), 15, seed=1)
        assert np.all(np.isfinite(rec["rewards_p"]))
        npt.assert_allclose(rec["rewards_p"], rec["rewards_j"], rtol=0, atol=ATOL, err_msg=name)
        returns[name] = rec["rewards_p"].sum()
    informed_best = max(v for k, v in returns.items() if "L0" not in k)
    assert informed_best > returns["CorrectedL0_Random"]


@pytest.mark.parametrize("idx", range(6), ids=NAMES)
def test_hierarchy_actions_equal_jax(renewable, idx):
    ej, ep = renewable
    _, _, rec = closed_loop(ej, ep, getattr(jagents, NAMES[idx]), getattr(tagents, NAMES[idx]), 10, seed=3)
    npt.assert_array_equal(rec["terminated_p"], rec["terminated_j"])
    for t in range(10):
        npt.assert_allclose(rec["actions_p"][t], rec["actions_j"][t], rtol=0, atol=ATOL, err_msg=f"step {t}")
    npt.assert_allclose(rec["rewards_p"], rec["rewards_j"], rtol=0, atol=ATOL)


@requires_reference
@pytest.mark.parametrize("idx", [1, 2, 3, 4, 5])
def test_hierarchy_matches_reference_actions(reference, idx):
    """The port's L1-L5 give the reference controllers' actions on the
    port's environment (both read the same simulator)."""
    import gym_anm.agents.ieee33_controllers.discrete_hierarchy as ref_dh

    import gym_anm_torch.compat as tc

    np.random.seed(3)
    env = tc.IEEE33RenewableEnv(device="cpu")
    env.reset(seed=3)
    mine = getattr(tagents, NAMES[idx])(env)
    theirs = getattr(ref_dh, NAMES[idx])(env)
    for _ in range(10):
        a_mine = mine.act(env)
        npt.assert_allclose(a_mine, theirs.act(env), atol=1e-12)
        env.step(np.clip(a_mine, env.action_space.low, env.action_space.high))


def _coef(policy):
    """``behavior_cloning``'s fitted ``W`` and ``b``, read from its closure."""
    cells = dict(zip(policy.__code__.co_freevars, (c.cell_contents for c in policy.__closure__)))
    return cells["W"], cells["b"]


def _assert_dataset_close(dj, dp):
    for xj, xp in zip(dj, dp):
        assert xj.shape == xp.shape
        npt.assert_allclose(xp, xj, rtol=0, atol=ATOL)


def test_generate_dataset_bc_and_evaluate_equal_jax(ieee33):
    ej, ep = ieee33
    start(ej, ep, 0)
    dj, dp = twin(lambda: joff.generate_dataset(ej, joff.SimpleCapBankExpert(ej), steps=12),
                  lambda: toff.generate_dataset(ep, toff.SimpleCapBankExpert(ep), steps=12))
    states, actions = dp
    assert states.shape == (12, ep.observation_space.shape[0])
    assert actions.shape == (12, ep.action_space.shape[0])
    _assert_dataset_close(dj, dp)

    pj, pp = joff.behavior_cloning(*dj, ej.action_space), toff.behavior_cloning(*dp, ep.action_space)
    for cj, cp in zip(_coef(pj), _coef(pp)):
        npt.assert_allclose(cp, cj, rtol=0, atol=BC_ATOL)
    for cj, cp in zip(_coef(pj), _coef(toff.behavior_cloning(*dj, ep.action_space))):
        npt.assert_array_equal(cp, cj)
    a = pp(states[0])
    assert a.shape == actions[0].shape
    assert np.all(a >= ep.action_space.low - 1e-12) and np.all(a <= ep.action_space.high + 1e-12)

    np.random.seed(5)
    rj, rp = twin(lambda: joff.evaluate_policy(ej, pj, episodes=2, max_steps=3),
                  lambda: toff.evaluate_policy(ep, pp, episodes=2, max_steps=3))
    assert np.isfinite(rp) and abs(rp - rj) <= ATOL, (rp, rj)


@pytest.mark.parametrize("weights", [None, [6.0, 1.0, 1.0, 2.0, 1.0, 3.0]], ids=["uniform", "weighted"])
def test_generate_mixed_dataset_equals_jax(renewable, weights):
    """The Corrected hierarchy mixed step by step on the renewable env, then
    BC on the result."""
    ej, ep = renewable
    start(ej, ep, 2)
    agents_j, agents_p = twin(lambda: [getattr(jagents, n)(ej) for n in NAMES],
                              lambda: [getattr(tagents, n)(ep) for n in NAMES])
    dj, dp = twin(lambda: joff.generate_mixed_dataset(ej, agents_j, 24, weights=weights),
                  lambda: toff.generate_mixed_dataset(ep, agents_p, 24, weights=weights))
    _assert_dataset_close(dj, dp)
    pj = joff.behavior_cloning(*dj, ej.action_space)
    for cj, cp in zip(_coef(pj), _coef(toff.behavior_cloning(*dj, ep.action_space))):
        npt.assert_array_equal(cp, cj)
    for cj, cp in zip(_coef(pj), _coef(toff.behavior_cloning(*dp, ep.action_space))):
        npt.assert_allclose(cp, cj, rtol=0, atol=BC_MIXED_ATOL)


def test_generate_mixed_dataset_weights(ieee33):
    """Weight 1 on one agent is that agent's dataset; a weight list of the
    wrong length raises."""
    _, env = ieee33
    a1, a2 = toff.DoNothingHeuristic(env), toff.HysteresisCapBankHeuristic(env)
    np.random.seed(0)
    s1, ac1 = toff.generate_mixed_dataset(env, [a1, a2], steps=8, weights=[1.0, 0.0])
    np.random.seed(0)
    s2, ac2 = toff.generate_dataset(env, a1, steps=8)
    npt.assert_allclose(ac1, ac2)
    with pytest.raises(ValueError):
        toff.generate_mixed_dataset(env, [a1, a2], steps=2, weights=[1.0])


def test_lazy_exports_resolve_to_offline():
    for name in ("generate_dataset", "generate_mixed_dataset", "behavior_cloning", "evaluate_policy"):
        assert getattr(gym_anm_torch, name) is getattr(toff, name)
    public = {k for k in vars(joff) if not k.startswith("_") and (isinstance(vars(joff)[k], type)
                                                                 or callable(vars(joff)[k]))}
    public -= {"Callable", "Optional", "Sequence"}
    assert public <= set(vars(toff)), public - set(vars(toff))


def test_mpc_constant_dc_opf_constraints():
    """After each ``act`` the port's DC-OPF solution satisfies its own
    constraints (ANM6Easy)."""
    import gym_anm_torch.compat as tc

    env = tc.ANM6Easy(device="cpu")
    env.reset(seed=4)
    agent = tagents.MPCAgentConstant(env.simulator, env.action_space, env.gamma, safety_margin=0.9,
                                     planning_steps=3)
    for _ in range(5):
        a = agent.act(env)
        assert env.action_space.contains(a.astype(np.float64))
        sol = agent.last_solution
        B = agent.B_bus
        for s in range(agent.planning_steps):
            theta, P_dev = sol["theta"][s], sol["P_dev"][s]
            for i in agent.bus_ids:
                flow = 0.0
                for (j, k) in agent.branch_ids:
                    l, m = agent.bus_id_mapping[j], agent.bus_id_mapping[k]
                    if j == i:
                        flow += B[l, m] * (theta[l] - theta[m])
                    elif k == i:
                        flow += B[m, l] * (theta[m] - theta[l])
                p_bus = sum(P_dev[agent.dev_id_mapping[d]] for d in agent.device_ids if agent.dev_to_bus[d] == i)
                assert abs(flow - p_bus) < 1e-7
            for d in agent.non_slack_gen_ids + agent.des_ids:
                dev, p = env.simulator.devices[d], P_dev[agent.dev_id_mapping[d]]
                assert dev.p_min - 1e-9 <= p <= dev.p_max + 1e-9
            soc = sol["soc"][s]
            for di, d in enumerate(agent.des_ids):
                dev = env.simulator.devices[d]
                assert dev.soc_min - 1e-9 <= soc[di] <= dev.soc_max + 1e-9
            assert np.all(np.abs(theta) <= np.pi + 1e-9)
            assert abs(theta[agent.dev_id_mapping[agent.slack_dev_id]]) < 1e-12
        env.step(a)


def test_mpc_reduces_losses_vs_max_dispatch():
    """The port's MPC keeps ANM6Easy running with sane rewards."""
    import gym_anm_torch.compat as tc

    env = tc.ANM6Easy(device="cpu")
    env.reset(seed=7)
    agent = tagents.MPCAgentConstant(env.simulator, env.action_space, env.gamma, safety_margin=0.9,
                                     planning_steps=1)
    total = 0.0
    for _ in range(10):
        _, r, term, _, _ = env.step(agent.act(env))
        total += r
        assert not term
    assert np.isfinite(total) and total > -50


_STAND_IN_RUN = """
import json, sys, types
import numpy as np
if sys.argv[1] == "stand-in":
    sys.modules["gymnasium"] = None
    smoke = types.ModuleType("chip_smoke")
    exec(compile(open("chip_smoke.py").read(), "chip_smoke.py", "exec"), smoke.__dict__)
    assert smoke.gymnasium_module() == "stand-in"
import gym_anm_torch.compat as tc
from gym_anm_torch import agents
out = []
for name in ("CorrectedL0_Random", "CorrectedL3_Coordinated"):
    np.random.seed(0)
    env = tc.IEEE33RenewableEnv(device="cpu")
    env.reset(seed=0)
    env.action_space.seed(0)
    agent = getattr(agents, name)(env)
    for _ in range(6):
        obs, r, term, trunc, _ = env.step(np.clip(agent.act(env), env.action_space.low, env.action_space.high))
        out.append([float(r), bool(term)] + obs.tolist())
import gymnasium as gym
for env_id in ("gym_anm_torch/ANM6Easy-v0", "gym_anm_torch/IEEE33-v0"):
    np.random.seed(0)
    env = gym.make(env_id, device="cpu")
    obs, _ = env.reset(seed=0)
    env.action_space.seed(0)
    for _ in range(4):
        obs, r, term, trunc, _ = env.step(env.action_space.sample())
        out.append([env_id, float(r), bool(term)] + np.asarray(obs).tolist())
print(json.dumps(out))
"""


def test_chip_smoke_gymnasium_stand_in_equals_gymnasium():
    """``chip_smoke.py``'s stand-in for gymnasium (phases 14 and 15 on a
    machine without it) runs the port's compat env and the Corrected
    controllers, random actions included, and ``make`` of both registered
    IDs, bit for bit as gymnasium does."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.join(os.path.dirname(__file__), "..")
    runs = [json.loads(subprocess.run([sys.executable, "-c", _STAND_IN_RUN, which], cwd=root, check=True,
                                      capture_output=True, text=True, timeout=120).stdout)
            for which in ("gymnasium", "stand-in")]
    assert runs[0] == runs[1]
