"""The port's single-env tier against the JAX package's: the ``Simulator``,
every compat environment, the Gymnasium registration and the host MPC agents.

Both packages run on the CPU at float64.  Every rollout gives both
environments the same ``reset(seed=)``, the same global ``np.random`` state
before construction, reset and each step (the IEEE33 family draws its load
noise and clock from it, as the reference does) and the same actions from a
numpy generator, and compares observations, rewards and the simulator's
state dict at 1e-8 with equal ``terminated`` flags.  A current's angle is
compared through the complex current it belongs to: at a bus without
injection the current is the load flow's residual, whose angle carries no
digits.  The MPC agents' actions agree within 1e-6 and their LP objectives
within 1e-8 relative.  Also the counterparts of ``test_custom_obs_space.py``,
the PFE oracle on the port's ``Simulator`` and the comparisons of
``test_vec_env.py`` between the port's ``VecEnv`` and the port's compat
envs."""

import dataclasses
import subprocess
import sys

import gymnasium as gym
import numpy as np
import numpy.testing as npt
import pytest
import torch

import gym_anm_torch.compat as tc
import gym_anm_tpu.compat as jc
from gym_anm_torch.agents import MPCAgent, MPCAgentConstant, MPCAgentPerfect
from gym_anm_torch.env import Simulator
from gym_anm_torch.errors import ArgsError
from gym_anm_torch.networks import anm6_network, ieee33_network, two_bus_network
from gym_anm_torch.specs.network import load_network
from gym_anm_torch.vec import (
    VecEnv,
    make_anm6easy_task,
    make_ieee33_multicap_task,
    make_ieee33_renewable_task,
    make_ieee33_task,
    make_ieee33_unequal_task,
)
from gym_anm_tpu import agents as jagents

from .oracle import check_pfe_solution
from .test_custom_obs_space import BASE_MVA, NETWORK

torch.set_num_threads(2)

ATOL = 1e-8  # float64 rollouts
MPC_ATOL = 1e-6  # MPC actions (MW)
N_STEPS = 20


def twin(fj, fp):
    """``fj()`` and ``fp()`` from the same global numpy RNG state; the state
    after them is the one they leave (both draw alike)."""
    st = np.random.get_state()
    a = fj()
    np.random.set_state(st)
    return a, fp()


def assert_state_close(sj, sp, atol=ATOL):
    """Two simulator state dicts agree: every entry within ``atol``, the
    current angles through their complex currents."""
    assert sj.keys() == sp.keys()
    for key in sj:
        assert sj[key].keys() == sp[key].keys(), key
        if key.endswith("_i_ang"):
            magn = key.replace("_ang", "_magn")
            for i in sj[key]["rad"]:
                ij = sj[magn]["pu"][i] * np.exp(1j * sj[key]["rad"][i])
                ip = sp[magn]["pu"][i] * np.exp(1j * sp[key]["rad"][i])
                assert abs(ij - ip) <= atol, (key, i, ij, ip)
                npt.assert_allclose(sp[key]["degree"][i], sp[key]["rad"][i] * 180 / np.pi, rtol=1e-15)
            continue
        for unit in sj[key]:
            assert sj[key][unit].keys() == sp[key][unit].keys(), (key, unit)
            for i, v in sj[key][unit].items():
                assert abs(v - sp[key][unit][i]) <= atol, (key, unit, i, v, sp[key][unit][i])


def _custom(pkg, device=None):
    kw = {} if device is None else {"device": device}
    env = pkg.ANMEnv(NETWORK, "state", 0, 1, 0.9, 100, None, None, None, **kw)
    env.init_state = lambda: np.zeros(10)
    env.next_vars = lambda s_t: np.array([-1.0, 5.0])
    return env


ENVS = {
    "ANMEnv": lambda pkg, **kw: _custom(pkg, **kw),
    "ANM6Easy": lambda pkg, **kw: pkg.ANM6Easy(**kw),
    "IEEE33Env": lambda pkg, **kw: pkg.IEEE33Env(**kw),
    "IEEE33RenewableEnv": lambda pkg, **kw: pkg.IEEE33RenewableEnv(**kw),
    "IEEE33MultiCapacitorEnv": lambda pkg, **kw: pkg.IEEE33MultiCapacitorEnv(**kw),
    "IEEE33UnequalCapacitorsEnv": lambda pkg, **kw: pkg.IEEE33UnequalCapacitorsEnv(**kw),
    "IEEE33ProperEnvironment": lambda pkg, **kw: pkg.IEEE33ProperEnvironment(**kw),
    "FinalCorrectEnv": lambda pkg, **kw: pkg.FinalCorrectEnv(**kw),
}


def make_pair(name, seed=0):
    np.random.seed(seed)
    return twin(lambda: ENVS[name](jc), lambda: ENVS[name](tc, device="cpu"))


@pytest.mark.parametrize("name", list(ENVS))
def test_seeded_rollout_equals_jax(name):
    ej, ep = make_pair(name)
    assert ep.simulator.device.type == "cpu"
    npt.assert_array_equal(ej.action_space.low, ep.action_space.low)
    npt.assert_array_equal(ej.action_space.high, ep.action_space.high)
    npt.assert_array_equal(ej.observation_space.low, ep.observation_space.low)
    npt.assert_array_equal(ej.observation_space.high, ep.observation_space.high)

    (oj, _), (op, _) = twin(lambda: ej.reset(seed=3), lambda: ep.reset(seed=3))
    npt.assert_allclose(op, oj, rtol=0, atol=ATOL)
    assert_state_close(ej.simulator.state, ep.simulator.state)

    rng = np.random.default_rng(7)
    lo, hi = ej.action_space.low, ej.action_space.high
    for t in range(N_STEPS):
        # NETWORK's devices dwarf its 10 MVA lines: set-points within 3 MW
        # keep its load flow solvable for the whole rollout.
        a = np.clip(rng.uniform(-3, 3, lo.shape), lo, hi) if name == "ANMEnv" else rng.uniform(lo, hi)
        (oj, rj, tj, _, ij), (op, rp, tp, _, ip) = twin(lambda: ej.step(a), lambda: ep.step(a))
        assert tj == tp, f"step {t}: terminated {tj} against {tp}"
        npt.assert_allclose(op, oj, rtol=0, atol=ATOL, err_msg=f"step {t} obs")
        npt.assert_allclose(rp, rj, rtol=0, atol=ATOL, err_msg=f"step {t} reward")
        assert ij.keys() == ip.keys()
        for k in ij:
            npt.assert_allclose(ip[k], ij[k], rtol=0, atol=ATOL)
        assert not tj, f"step {t}: the episode ended"
        assert_state_close(ej.simulator.state, ep.simulator.state)
        npt.assert_allclose(ep.state, ej.state, rtol=0, atol=ATOL)


def test_episode_terminates_like_jax():
    """Bang-bang actions collapse an ANM6Easy episode: both packages end it
    on the same step with the terminal state and reward -c2/(1-gamma), and
    stay there with reward 0."""
    ej, ep = make_pair("ANM6Easy")
    twin(lambda: ej.reset(seed=0), lambda: ep.reset(seed=0))
    rng = np.random.default_rng(1)
    lo, hi = ep.action_space.low, ep.action_space.high
    for t in range(200):
        a = np.where(rng.random(lo.shape) < 0.5, lo, hi)
        (oj, rj, tj, _, _), (op, rp, tp, _, _) = twin(lambda: ej.step(a), lambda: ep.step(a))
        assert tj == tp, t
        if tp:
            break
    assert tp, "no collapse in 200 bang-bang steps"
    c2 = ep.costs_clipping[1]
    assert rp == rj == -c2 / (1 - ep.gamma)
    npt.assert_array_equal(op, np.zeros(ep.observation_N))
    npt.assert_array_equal(ep.state, np.zeros(ep.state_N))
    assert (ep.e_loss, ep.penalty) == (ej.e_loss, ej.penalty) == ep.costs_clipping
    op, rp, tp, _, _ = ep.step(ep.action_space.sample())
    assert tp and rp == 0.0 and not op.any()


# --- the counterparts of tests/test_custom_obs_space.py --------------------
def _make_env(observation, K=0):
    env = tc.ANMEnv(NETWORK, observation, K, 1, 0.9, 100, None, None, None, device="cpu")
    env.init_state = lambda: np.zeros(10 + K)
    env.next_vars = lambda s_t: np.concatenate([[-1.0, 5.0], np.zeros(K)])
    return env


def test_list_obs_space_expansion_bounds_and_extraction():
    observation = [("bus_p", "all", "MW"), ("dev_q", [0, 2], "pu"), ("branch_s", "all", "pu")]
    env = _make_env(observation)
    env.reset(seed=0)
    assert env.obs_values == [
        ("bus_p", [0, 1, 2], "MW"),
        ("dev_q", [0, 2], "pu"),
        ("branch_s", [(0, 1), (1, 2)], "pu"),
    ]
    npt.assert_allclose(env.observation_space.high, [200, 0, 80, 20, 3, np.inf, np.inf])
    npt.assert_allclose(env.observation_space.low, [-200, -10, -50, -20, -3, -np.inf, -np.inf])

    ps = [100, -5, 60]
    for i, p in enumerate(ps):
        env.simulator.buses[i].p = p / BASE_MVA
    qs = [-150, -20]
    env.simulator.devices[0].q = qs[0] / BASE_MVA
    env.simulator.devices[2].q = qs[1] / BASE_MVA
    branch_ss = [15, 25]
    env.simulator.branches[(0, 1)].s_apparent_max = branch_ss[0] / BASE_MVA
    env.simulator.branches[(1, 2)].s_apparent_max = branch_ss[1] / BASE_MVA
    env.simulator.state = env.simulator._gather_state()

    obs = env.observation(None)
    npt.assert_allclose(obs[:3], ps)
    npt.assert_allclose(obs[3:5], np.array(qs) / BASE_MVA)
    npt.assert_allclose(obs[5:], np.array(branch_ss) / BASE_MVA)


def test_list_obs_default_units():
    env = _make_env([("dev_p", [1, 2])])
    assert env.obs_values == [("dev_p", [1, 2], "MW")]


def test_des_and_gen_all_expansion():
    env = _make_env([("des_soc", "all", "MWh"), ("gen_p_max", "all", "MW")])
    assert env.obs_values == [("des_soc", [3], "MWh"), ("gen_p_max", [2], "MW")]


def test_aux_observation_uses_aux_bounds():
    env = tc.ANMEnv(NETWORK, [("aux", "all")], 2, 1, 0.9, 100, np.array([[0, 96], [-5, 5]]), None, None,
                    device="cpu")
    env.init_state = lambda: np.zeros(12)
    npt.assert_allclose(env.observation_space.low, [0, -5])
    npt.assert_allclose(env.observation_space.high, [96, 5])


def test_callable_observation():
    def my_obs(s_t):
        return np.array([s_t[1], s_t[2]])

    env = _make_env(my_obs)
    obs, _ = env.reset(seed=0)
    assert obs.shape == (2,)
    assert env.observation_space.shape == (2,)
    assert np.all(np.isinf(env.observation_space.low))
    npt.assert_allclose(obs, [env.state[1], env.state[2]])
    obs2, r, term, _, _ = env.step(env.action_space.sample())
    assert obs2.shape == (2,)


def test_invalid_observation_spec_raises():
    with pytest.raises(ArgsError):
        tc.ANMEnv(NETWORK, 42, 0, 1, 0.9, 100, None, None, None, device="cpu")


# --- the Simulator ----------------------------------------------------------
@pytest.mark.parametrize("net", [two_bus_network, anm6_network, ieee33_network])
def test_transition_satisfies_pfe_invariants(net):
    """``test_physics.py``'s PFE-oracle check on the port's ``Simulator``."""
    sim = Simulator(net, delta_t=1.0, lamb=100, device="cpu")
    spec = sim.spec
    rng = np.random.default_rng(11)
    for _ in range(5):
        P_load = {int(spec.dev_ids[p]): rng.uniform(-3, 0) for p in spec.load_pos}
        gen_ids = [int(spec.dev_ids[p]) for p in spec.gen_nonslack_pos]
        P_pot = {i: rng.uniform(0, 20) for i in gen_ids}
        P_set = {i: rng.uniform(0, 20) for i in gen_ids}
        Q_set = {i: rng.uniform(-5, 5) for i in gen_ids}
        for p in spec.des_pos:
            i = int(spec.dev_ids[p])
            P_set[i] = rng.uniform(-10, 10)
            Q_set[i] = rng.uniform(-5, 5)
        for p in spec.cap_pos:
            Q_set[int(spec.dev_ids[p])] = rng.uniform(0, 0.5)
        _, _, _, _, conv = sim.transition(P_load, P_pot, P_set, Q_set)
        assert conv
        check_pfe_solution(sim)


def test_simulator_views_and_bounds_equal_jax():
    """Attributes, views, Y-bus and the spaces of the two simulators; a write
    through a view feeds the next transition."""
    from gym_anm_tpu.env.simulator import Simulator as JSimulator
    from gym_anm_tpu.networks.ieee33 import create_renewable_network

    net = create_renewable_network()
    sj, sp = JSimulator(net, 1.0, 100), Simulator(net, 1.0, 100, device="cpu")
    for attr in ("N_bus", "N_device", "N_load", "N_non_slack_gen", "N_des", "N_gen_rer", "baseMVA"):
        assert getattr(sj, attr) == getattr(sp, attr), attr
    assert list(sj.buses) == list(sp.buses) and list(sj.devices) == list(sp.devices)
    assert list(sj.branches) == list(sp.branches)
    assert sj.state_bounds == sp.state_bounds
    assert sj.get_action_space() == sp.get_action_space()
    assert sj.get_rendering_specs() == sp.get_rendering_specs()
    npt.assert_array_equal(sj.Y_bus.toarray(), sp.Y_bus.toarray())

    for s in (sj, sp):
        next(iter(s.branches.values())).rate = 0.01
        for dev in s.devices.values():
            if dev.type == 2:
                dev.p_pot = 3.0
    P_load = {i: -1.0 for i, d in sp.devices.items() if d.type == -1}
    gens = [i for i, d in sp.devices.items() if d.type in (1, 2)]
    P_pot = {i: 0.2 for i in gens}
    P_set = {i: 0.1 for i in gens}
    Q_set = {i: 0.0 for i in gens}
    Q_set.update({i: 0.1 for i, d in sp.devices.items() if d.type == 4})
    oj, op = sj.transition(P_load, P_pot, P_set, Q_set), sp.transition(P_load, P_pot, P_set, Q_set)
    assert op[4] == oj[4] and abs(op[3] - oj[3]) <= ATOL and op[3] > 0  # the rate write shows in the penalty
    assert_state_close(oj[0], op[0])


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device works here")
    with pytest.raises((AssertionError, RuntimeError)):
        Simulator(anm6_network, 0.25, 100)
    with pytest.raises((AssertionError, RuntimeError)):
        tc.IEEE33Env()


@pytest.mark.parametrize("env_id,name", [("gym_anm_torch/ANM6Easy-v0", "ANM6Easy"),
                                         ("gym_anm_torch/IEEE33-v0", "IEEE33Env")])
def test_registered_ids(env_id, name):
    """The namespaced IDs beside the JAX package's bare ones; ``make``
    passes ``device`` through to the constructor."""
    assert "ANM6Easy-v0" in gym.envs.registry and env_id in gym.envs.registry
    env = gym.make(env_id, device="cpu")
    assert type(env.unwrapped).__name__ == name
    assert env.unwrapped.simulator.device.type == "cpu"
    ref = ENVS[name](jc)
    oj, _ = ref.reset(seed=5)
    op, _ = env.reset(seed=5)
    npt.assert_allclose(op, oj, rtol=0, atol=ATOL)
    a = env.action_space.sample()
    oj, rj, *_ = ref.step(a)
    op, rp, *_ = env.step(a)
    npt.assert_allclose(op, oj, rtol=0, atol=ATOL)
    assert abs(rp - rj) <= ATOL


def test_import_needs_no_gymnasium():
    code = ("import sys, gym_anm_torch, gym_anm_torch.env, gym_anm_torch.vec, gym_anm_torch.agents; "
            "import gym_anm_torch.offline, gym_anm_torch.agents.algorithmic_hierarchy; "
            "import gym_anm_torch.agents.diversity_hierarchy, gym_anm_torch.agents.ready_hierarchy; "
            "import gym_anm_torch.agents.experimental_hierarchies; "
            "gym_anm_torch.generate_mixed_dataset, gym_anm_torch.behavior_cloning; "
            "assert 'gymnasium' not in sys.modules, 'gymnasium imported'; "
            "assert 'jax' not in sys.modules and 'gym_anm_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


# --- the host MPC agents ----------------------------------------------------
@pytest.mark.parametrize("cls_name,kw", [("MPCAgentConstant", {"planning_steps": 10, "safety_margin": 0.96}),
                                         ("MPCAgentPerfect", {"planning_steps": 4, "safety_margin": 0.96}),
                                         ("MPCAgentConstant", {"planning_steps": 1})])
def test_mpc_agents_equal_jax(cls_name, kw):
    """The closed loop of ``examples/mpc_constant.py`` and ``mpc_perfect.py``
    on ANM6Easy: both agents see the same state (both envs step with the JAX
    agent's action); actions within 1e-6, LP objectives within 1e-8
    relative."""
    ej, ep = make_pair("ANM6Easy")
    twin(lambda: ej.reset(seed=11), lambda: ep.reset(seed=11))
    aj = getattr(jagents, cls_name)(ej.simulator, ej.action_space, ej.gamma, **kw)
    ap = {"MPCAgentConstant": MPCAgentConstant, "MPCAgentPerfect": MPCAgentPerfect}[cls_name](
        ep.simulator, ep.action_space, ep.gamma, **kw)
    for t in range(12):
        act_j, act_p = aj.act(ej), ap.act(ep)
        npt.assert_allclose(act_p, act_j, rtol=0, atol=MPC_ATOL, err_msg=f"step {t}")
        fj = aj.structure.c @ aj.last_solution["x"]
        fp = ap.structure.c @ ap.last_solution["x"]
        assert abs(fp - fj) <= 1e-8 * max(1.0, abs(fj)), (t, fj, fp)
        for k in ("theta", "P_dev", "soc"):
            assert len(ap.last_solution[k]) == kw["planning_steps"]
        npt.assert_allclose(np.concatenate(ap.last_solution["P_dev"]), np.concatenate(aj.last_solution["P_dev"]),
                            rtol=0, atol=MPC_ATOL)
        twin(lambda: ej.step(act_j), lambda: ep.step(act_j))


def test_mpc_agent_base_structure_equals_jax():
    """The base agent's LP from the simulator (rates written through the
    views included) equals the JAX agent's; its ``forecast`` is abstract."""
    ej, ep = make_pair("IEEE33RenewableEnv")
    twin(lambda: ej.reset(seed=2), lambda: ep.reset(seed=2))  # the reset writes tiered rates
    aj = jagents.MPCAgent(ej.simulator, ej.action_space, ej.gamma, planning_steps=3)
    ap = MPCAgent(ep.simulator, ep.action_space, ep.gamma, planning_steps=3)
    sj, sp = aj.structure, ap.structure
    for f in ("c", "lb", "ub", "b_eq", "b_ub", "load_pin_idx", "gen_cap_idx", "gen_pmax", "soc_rows", "act_idx"):
        npt.assert_array_equal(getattr(sp, f), getattr(sj, f), err_msg=f)
    npt.assert_array_equal(sp.A_eq.toarray(), sj.A_eq.toarray())
    npt.assert_array_equal(sp.A_ub.toarray(), sj.A_ub.toarray())
    assert (ap.load_ids, ap.non_slack_gen_ids, ap.des_ids, ap.branch_ids) == (
        aj.load_ids, aj.non_slack_gen_ids, aj.des_ids, aj.branch_ids)
    with pytest.raises(NotImplementedError):
        ap.act(ep)


# --- test_vec_env.py's comparisons between the port's VecEnv and compat ----
def test_vec_vs_compat_reward_statistics():
    env_c = tc.IEEE33Env(device="cpu")
    obs_c, _ = env_c.reset(seed=0)
    env_v = VecEnv(make_ieee33_task(), dtype=torch.float64, device="cpu")
    state_v, obs_v = env_v.reset(1)
    npt.assert_allclose(obs_v[0].numpy(), obs_c, atol=1e-9)
    rng = np.random.default_rng(5)
    lo, hi = env_v.action_low.numpy(), env_v.action_high.numpy()
    for _ in range(20):
        a = rng.uniform(lo, hi)
        obs_c, r_c, term_c, _, _ = env_c.step(a)
        state_v, obs_v, r_v, done_v, _ = env_v.step(state_v, torch.as_tensor(a)[None])
        assert not term_c and not bool(done_v[0])
        npt.assert_allclose(float(r_v[0]), r_c, atol=1e-9)
        npt.assert_allclose(obs_v[0].numpy(), obs_c, atol=1e-9)


def _injected_compat(base_cls, s0, table, **kw):
    """A compat env whose init_state/next_vars replay fixed sequences."""

    class _Injected(base_cls):
        def __init__(self):
            self._k = 0
            super().__init__(device="cpu", **kw)

        def init_state(self):
            self._k = 0
            return np.array(s0, float).copy()

        def next_vars(self, s_t):
            v = table[min(self._k, len(table) - 1)]
            self._k += 1
            return np.array(v, float).copy()

    return _Injected()


def _injected_vec(task, s0, table):
    tbl = torch.as_tensor(np.asarray(table))
    s0t = torch.as_tensor(np.asarray(s0))

    def init_state_fn(generator, n, carry):
        return s0t.expand(n, -1)

    def next_vars_fn(generator, s_t, carry, t):
        idx = torch.clamp(t.long(), max=tbl.shape[0] - 1)
        return tbl[idx].to(s_t.dtype), carry

    return dataclasses.replace(task, init_state_fn=init_state_fn, next_vars_fn=next_vars_fn,
                               init_task_fn=lambda generator, n: ())


def _compat_bus_vm(env):
    vm = env.simulator.state["bus_v_magn"]["pu"]
    return np.array([vm[k] for k in sorted(vm)])


def _run_cross_tier(env_c, env_v, n_steps, r_atol=2e-4, v_atol=2e-4, r_rtol=1e-3, quantize_caps=False):
    """The f32 batched tier against the f64 compat tier on one lane, at the
    tolerances of ``test_vec_env.py`` (the f32 solver's accept band)."""
    env_c.reset(seed=0)
    state_v, _ = env_v.reset(1)
    rng = np.random.default_rng(7)
    lo, hi = env_v.action_low.double().numpy(), env_v.action_high.double().numpy()
    for t in range(n_steps):
        a = rng.uniform(lo, hi)
        if quantize_caps:
            # Cap deltas on a 0.04 grid: never at the 0.01 switch threshold.
            a[10:16] = np.floor(a[10:16] / 0.04) * 0.04
        _, r_c, term_c, _, info_c = env_c.step(a)
        state_v, _, r_v, done_v, info_v = env_v.step(state_v, torch.as_tensor(a, dtype=env_v.dtype)[None])
        assert term_c == bool(done_v[0]), f"step {t}: termination mismatch"
        assert not term_c, f"step {t}: unexpected divergence"
        npt.assert_allclose(float(r_v[0]), r_c, atol=r_atol, rtol=r_rtol, err_msg=f"step {t} reward")
        npt.assert_allclose(state_v.bus_vm[0].double().numpy(), _compat_bus_vm(env_c), atol=v_atol,
                            err_msg=f"step {t} bus |V|")
        if quantize_caps:
            npt.assert_allclose(float(info_v["switching_cost"][0]), info_c["switching_cost"], atol=1e-6)
            assert int(info_v["total_switches"][0]) == int(info_c["total_switches"])
            npt.assert_allclose(float(info_v["cumulative_switching_cost"][0]), info_c["cumulative_switching_cost"],
                                atol=1e-5)


def _diurnal_table(spec, n_steps, k_gen_extra=0):
    nominal = np.abs(spec.p_min[spec.load_pos]) * spec.baseMVA
    n_vars = spec.n_load + spec.n_gen + k_gen_extra
    rng = np.random.default_rng(123)
    rows = []
    for t in range(n_steps):
        factor = 0.8 + 0.3 * np.sin((t / 7.0 - 3.0) * np.pi / 12.0)
        noise = 1.0 + 0.02 * rng.standard_normal(nominal.shape)
        row = np.zeros(n_vars)
        row[: spec.n_load] = -nominal * factor * noise
        rows.append(row)
    return np.stack(rows)


def _zero_s0_and_table(task):
    spec = load_network(task.network)
    return np.zeros(spec.n_state + task.K), _diurnal_table(spec, 30, k_gen_extra=task.K)


@pytest.mark.parametrize("factory,env_name", [(make_ieee33_renewable_task, "IEEE33RenewableEnv"),
                                              (make_ieee33_multicap_task, "IEEE33MultiCapacitorEnv"),
                                              (make_ieee33_unequal_task, "IEEE33UnequalCapacitorsEnv")])
def test_cross_tier_trajectory_renewable_family(factory, env_name):
    task = factory()
    s0, table = _zero_s0_and_table(task)
    env_v = VecEnv(_injected_vec(task, s0, table), dtype=torch.float32, device="cpu")
    env_c = _injected_compat(getattr(tc, env_name), s0, table)
    _run_cross_tier(env_c, env_v, 25 if env_name != "IEEE33UnequalCapacitorsEnv" else 20,
                    quantize_caps=env_name == "IEEE33UnequalCapacitorsEnv")


def test_cross_tier_trajectory_anm6easy():
    from gym_anm_torch.compat.anm6_easy import _get_gen_time_series, _get_load_time_series

    spec = load_network(anm6_network)
    P_loads, P_maxs = _get_load_time_series(), _get_gen_time_series()
    n_dev, n_des, n_gen = spec.n_dev, spec.n_des, spec.n_gen
    t0 = 10
    s0 = np.zeros(2 * n_dev + n_des + n_gen + 1)
    s0[[1, 3, 5]] = P_loads[:, t0]
    s0[[1 + n_dev, 3 + n_dev, 5 + n_dev]] = P_loads[:, t0] * 0.2
    s0[[2, 4]] = P_maxs[:, t0]
    s0[2 * n_dev: 2 * n_dev + n_des] = 0.5 * (spec.soc_min + spec.soc_max)[spec.des_pos] * spec.baseMVA
    s0[2 * n_dev + n_des: 2 * n_dev + n_des + n_gen] = P_maxs[:, t0]
    s0[-1] = t0
    n_steps = 25
    table = np.stack([np.concatenate([P_loads[:, (t0 + 1 + t) % 96], P_maxs[:, (t0 + 1 + t) % 96],
                                      [(t0 + 1 + t) % 96]]) for t in range(n_steps)])
    env_v = VecEnv(_injected_vec(make_anm6easy_task(), s0, table), dtype=torch.float32, device="cpu")
    env_c = _injected_compat(tc.ANM6Easy, s0, table)
    _run_cross_tier(env_c, env_v, n_steps)


def test_anm6_render_names_the_missing_renderer():
    """The renderer is ported (``gym_anm_torch.render``): a mode other than
    "human" raises ``NotImplementedError``, as the JAX env does; "human"
    starts the dashboard, and ``close`` stops it and resets the flags."""
    import gym_anm_torch.render.rendering as rendering

    env = tc.ANM6Easy(device="cpu")
    env.reset(seed=0)
    with pytest.raises(NotImplementedError):
        env.render(mode="rgb_array")
    assert not env.is_rendering
    orig = rendering.webbrowser.open
    rendering.webbrowser.open = lambda *a, **k: None
    try:
        env.render()
        assert env.is_rendering and env.render_mode == "human"
    finally:
        rendering.webbrowser.open = orig
        env.close()
    assert not env.is_rendering and env.render_mode is None
