"""The port's observation plans against the JAX package's: both packages'
``extract`` on the same transition outputs (JAX's ``TransitionOut`` carried
over as numpy), float64, within 1e-12, with ``low``/``high`` exactly equal;
every variable of STATE_VARIABLES in its default and its other unit, on
IEEE33 and on ANM6Easy (storage, generators, aux).  Then the plan inside
``VecEnv``: a float64 step from JAX's state gives JAX's observation; the
error classes and the rollout guard of tests/test_vec_obs.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_anm_torch.convert import state_from_jax
from gym_anm_torch.errors import ObsNotSupportedError, ObsSpaceError, UnitsNotSupportedError
from gym_anm_torch.physics.transition import TransitionOut
from gym_anm_torch.specs.constants import STATE_VARIABLES
from gym_anm_torch.vec import VecEnv, make_anm6easy_task, make_ieee33_task, make_obs_plan
from gym_anm_tpu.vec import VecEnv as JVecEnv
from gym_anm_tpu.vec import make_anm6easy_task as j_make_anm6easy_task
from gym_anm_tpu.vec import make_ieee33_task as j_make_ieee33_task
from gym_anm_tpu.vec.obs import make_obs_plan as j_make_obs_plan

torch.set_num_threads(2)

B = 16


def _unit(var, default):
    units = STATE_VARIABLES[var]
    if isinstance(units, str):  # branch_i_magn's units are the string "pu" (reference quirk)
        return units
    return units[0] if default or len(units) == 1 else units[1]


# 2-tuples take the default unit; branch_i_magn's would be "p" (the first
# character of its unit string), which no package accepts.
FULL_DEFAULT = [(var, "all") if var != "branch_i_magn" else (var, "all", "pu") for var in STATE_VARIABLES]
FULL_OTHER = [(var, "all", _unit(var, default=False)) for var in STATE_VARIABLES]
IEEE33_OBS = [
    ("bus_v_magn", "all", "pu"),
    ("bus_v_ang", [0, 5, 10], "degree"),
    ("bus_p", [3, 7], "MW"),
    ("bus_q", [2], "pu"),
    ("bus_i_magn", [1, 4], "kA"),
    ("branch_s", "all", "MVA"),
    ("branch_p", [(0, 1), (1, 2)], "MW"),
    ("branch_q", [(1, 2)], "MVAr"),
    ("branch_i_magn", [(0, 1)], "pu"),
    ("branch_i_ang", [(0, 1)], "rad"),
    ("dev_p", "all", "MW"),
    ("dev_q", [0, 8], "MVAr"),
]
TASKS = {"ieee33": (j_make_ieee33_task, make_ieee33_task), "anm6easy": (j_make_anm6easy_task, make_anm6easy_task)}


def _jax_outs(jenv, seed):
    """B transition outputs of JAX's float64 transition from its reset
    states, with random set-points in 20% of the action box around zero."""
    js, _ = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(seed), B))
    rng = np.random.default_rng(seed)
    a = 0.2 * rng.uniform(np.asarray(jenv.action_low), np.asarray(jenv.action_high), (B, jenv.n_action))
    spec = jenv.spec
    P_load = js.dev_p[:, spec.load_pos] * spec.baseMVA
    P_pot = js.p_pot * spec.baseMVA

    def one(p_load, p_pot, action, soc):
        return jenv._run_transition(p_load, p_pot, *jenv.split_action(action), soc)

    out = jax.jit(jax.vmap(one))(P_load, P_pot, jnp.asarray(a), js.soc)
    return out, js.soc, js.aux


_OUTS = {}


def _outs(task):
    """JAX's float64 env of ``task`` and its transition outputs, made once."""
    if task not in _OUTS:
        jenv = JVecEnv(TASKS[task][0](), dtype=jnp.float64)
        _OUTS[task] = (jenv,) + _jax_outs(jenv, seed=5)
    return _OUTS[task]


def _port_out(jout):
    return TransitionOut(**{f: torch.as_tensor(np.array(getattr(jout, f))) for f in TransitionOut._fields})


@pytest.mark.parametrize("task,plan", [("ieee33", "default"), ("ieee33", "other"), ("ieee33", "ieee33"),
                                       ("anm6easy", "default"), ("anm6easy", "other")])
def test_extract_matches_jax(task, plan):
    values = {"default": FULL_DEFAULT, "other": FULL_OTHER, "ieee33": IEEE33_OBS}[plan]
    jenv, jout, soc, aux = _outs(task)
    spec = jenv.spec
    jplan = j_make_obs_plan(spec, jenv.task.K, values)
    tplan = make_obs_plan(spec, jenv.task.K, values, device="cpu")
    np.testing.assert_array_equal(tplan.low, jplan.low)
    np.testing.assert_array_equal(tplan.high, jplan.high)
    assert tplan.values == jplan.values and tplan.n == jplan.n
    assert bool(jout.stable.all())
    jobs = np.asarray(jax.vmap(jplan.extract)(jout, soc, aux))
    tobs = tplan.extract(_port_out(jout), torch.as_tensor(np.array(soc)), torch.as_tensor(np.array(aux)))
    assert tobs.shape == (B, jplan.n) and tobs.dtype == torch.float64
    np.testing.assert_allclose(tobs.numpy(), jobs, rtol=0, atol=1e-12)


def test_extract_keeps_the_output_dtype_with_float64_scales():
    """kV/kA segments multiply by a float64 per-bus scale, as JAX's numpy
    scale does, and the segment comes back at the output's dtype (float32
    here, within 2 ulp of JAX's: XLA's fused atan2, and its re² + im²
    contracted into a fused multiply-add, round apart from torch's)."""
    jenv = JVecEnv(j_make_ieee33_task(), dtype=jnp.float32)
    values = [("bus_v_magn", "all", "kV"), ("bus_i_magn", "all", "kA"), ("bus_v_ang", "all", "degree")]
    jplan, tplan = j_make_obs_plan(jenv.spec, 0, values), make_obs_plan(jenv.spec, 0, values, device="cpu")
    jout, soc, aux = _jax_outs(jenv, seed=3)
    tobs = tplan.extract(_port_out(jout), torch.as_tensor(np.array(soc)), torch.as_tensor(np.array(aux)))
    assert tobs.dtype == torch.float32
    np.testing.assert_array_max_ulp(tobs.numpy(), np.asarray(jax.vmap(jplan.extract)(jout, soc, aux)), maxulp=2)


@pytest.mark.parametrize("task", list(TASKS))
def test_env_step_with_plan_matches_jax(task):
    """A float64 step of the port's VecEnv with an observation plan, from
    JAX's reset state and with JAX's actions: the observation (clipped to the
    plan's bounds) and the bounds themselves match JAX's VecEnv.  Each
    package solves its own load flow, so a bus current below the solver's
    tolerance (1e-5 p.u.: a bus without devices, or whose devices are idle)
    is the residual, and its angle noise in both: bus current angles are
    compared where |i| >= 1e-5 p.u."""
    jmake, tmake = TASKS[task]
    values = FULL_OTHER if task == "anm6easy" else IEEE33_OBS
    jenv = JVecEnv(jmake(), dtype=jnp.float64, obs=values)
    tenv = VecEnv(tmake(), dtype=torch.float64, obs=values, device="cpu")
    np.testing.assert_array_equal(tenv.obs_low.numpy(), np.asarray(jenv.obs_low))
    np.testing.assert_array_equal(tenv.obs_high.numpy(), np.asarray(jenv.obs_high))
    js, _ = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(2), B))
    a = 0.2 * np.random.default_rng(2).uniform(np.asarray(jenv.action_low), np.asarray(jenv.action_high),
                                              (B, jenv.n_action))
    ts = state_from_jax(js, device="cpu")
    _, tobs, _, td, _ = tenv.step(ts, torch.as_tensor(a))
    _, jobs, _, jd, _ = jax.jit(jax.vmap(jenv.step))(js, jnp.asarray(a))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert tobs.shape == (B, tenv.n_obs)
    tobs, jobs = tobs.numpy(), np.array(jobs)
    segs, off = {}, 0
    for var, ids, unit in tenv._obs_plan.values:
        segs[var] = slice(off, off + len(ids))
        off += len(ids)
    if "bus_i_ang" in segs:
        i_pu = jobs[:, segs["bus_i_magn"]] * tenv.spec.base_kv / tenv.spec.baseMVA  # kA -> p.u.
        noise = np.zeros_like(jobs, bool)
        noise[:, segs["bus_i_ang"]] = i_pu < 1e-5
        assert noise.any() and not noise.all()
        tobs[noise] = jobs[noise] = 0.0
    np.testing.assert_allclose(tobs, jobs, rtol=0, atol=1e-8)


def test_obs_plan_errors_and_rollout_guard():
    with pytest.raises(ObsNotSupportedError):
        VecEnv(make_ieee33_task(), obs=[("no_such_var", "all", "pu")], device="cpu")
    with pytest.raises(UnitsNotSupportedError):
        VecEnv(make_ieee33_task(), obs=[("bus_p", "all", "furlongs")], device="cpu")
    with pytest.raises(ObsSpaceError):
        VecEnv(make_ieee33_task(), obs=42, device="cpu")
    with pytest.raises(ObsSpaceError):
        VecEnv(make_ieee33_task(), obs=[("bus_p", [999], "MW")], device="cpu")
    with pytest.raises(ObsSpaceError):
        VecEnv(make_anm6easy_task(), obs=[("aux", [1], None)], device="cpu")

    env = VecEnv(make_ieee33_task(), dtype=torch.float32, obs=[("bus_v_magn", "all", "pu")], device="cpu")
    state, obs = env.reset(2)
    assert obs.shape == (2, 33)
    with pytest.raises(ValueError):
        env.rollout(state, env.random_policy(), 3)
    # With obs0 given, a partial-observation rollout runs.
    _, traj = env.rollout(state, env.random_policy(), 3, obs0=obs, generator=torch.Generator().manual_seed(0))
    assert traj[0].shape == (3, 2, 33)
    assert torch.equal(traj[0][0], obs)


def test_obs_plan_default_unit_and_two_tuples():
    """A 2-tuple takes the variable's default unit (MW for dev_p)."""
    env2 = VecEnv(make_ieee33_task(), obs=[("dev_p", [0, 1])], device="cpu")
    env3 = VecEnv(make_ieee33_task(), obs=[("dev_p", [0, 1], "MW")], device="cpu")
    assert torch.equal(env2.obs_low, env3.obs_low)
    assert torch.equal(env2.reset(2)[1], env3.reset(2)[1])
