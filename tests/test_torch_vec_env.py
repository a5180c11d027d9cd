"""gym_anm_torch's base IEEE33 VecEnv against gym_anm_tpu's: golden
rollouts driven by the same numpy-made action tensors, state carried across
mid-rollout, and the package's import boundaries."""

import copy
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_anm_torch.convert import state_from_jax, tables_from_jax
from gym_anm_torch.vec import VecEnv, make_ieee33_task
from gym_anm_tpu.vec import VecEnv as JVecEnv, make_ieee33_task as j_make_ieee33_task

torch.set_num_threads(2)

B = 32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jenv64():
    env = JVecEnv(j_make_ieee33_task(), dtype=jnp.float64)
    return env, jax.jit(jax.vmap(env.reset)), jax.jit(jax.vmap(env.step))


@pytest.fixture(scope="module")
def actions():
    """[T, B, 3] uniform actions over the base IEEE33 action box."""
    env = VecEnv(make_ieee33_task(), dtype=torch.float64, device="cpu")
    lo, hi = env.action_low.numpy(), env.action_high.numpy()
    return np.random.default_rng(11).uniform(lo, hi, size=(20, B, env.n_action))


def _j_reset(jenv):
    env, reset, _ = jenv
    return reset(jax.random.split(jax.random.PRNGKey(0), B))


def _close(t, j, atol, rtol=0.0, name=""):
    np.testing.assert_allclose(t.double().numpy(), np.asarray(j, np.float64), rtol=rtol, atol=atol,
                               err_msg=name)


def test_golden_rollout_f64(jenv64, actions):
    """20 steps of 32 lanes: obs, reward, bus_vm and v_guess within 1e-8."""
    tenv = VecEnv(make_ieee33_task(), dtype=torch.float64, device="cpu")
    ts, tobs = tenv.reset(B)
    js, jobs = _j_reset(jenv64)
    _close(tobs, jobs, 1e-8, name="reset obs")
    _close(ts.v_guess, js.v_guess, 1e-8, name="reset v_guess")
    step = jenv64[2]
    for k in range(actions.shape[0]):
        a = actions[k]
        ts, tobs, tr, td, tinfo = tenv.step(ts, torch.as_tensor(a))
        js, jobs, jr, jd, jinfo = step(js, jnp.asarray(a))
        assert not td.any() and not bool(jd.any())
        _close(tobs, jobs, 1e-8, name=f"obs {k}")
        _close(tr, jr, 1e-8, name=f"reward {k}")
        _close(ts.bus_vm, js.bus_vm, 1e-8, name=f"bus_vm {k}")
        _close(ts.v_guess, js.v_guess, 1e-8, name=f"v_guess {k}")
        np.testing.assert_array_equal(tinfo["n_iter"].numpy(), np.asarray(jinfo["n_iter"]))


def test_f32_rollout_matches_f64_jax(jenv64, actions):
    """The port's f32 step (chord path) against the JAX f64 step (exact NR)
    at the f32 solver tolerances of tests/test_chord_solver.py."""
    tenv = VecEnv(make_ieee33_task(), dtype=torch.float32, device="cpu")
    ts, _ = tenv.reset(B)
    js, _ = _j_reset(jenv64)
    step = jenv64[2]
    for k in range(8):
        a = actions[k]
        ts, tobs, tr, td, tinfo = tenv.step(ts, torch.as_tensor(a, dtype=torch.float32))
        js, jobs, jr, jd, _ = step(js, jnp.asarray(a.astype(np.float32), jnp.float64))
        assert not td.any()
        assert float(tinfo["diff"].max()) <= 1e-4
        _close(tr, jr, 2e-4, rtol=2e-3, name=f"reward {k}")
        _close(ts.bus_vm, js.bus_vm, 5e-5, name=f"bus_vm {k}")


def test_state_from_jax_mid_rollout(jenv64, actions):
    """Carry the JAX state across after 10 steps; the next steps match."""
    js, _ = _j_reset(jenv64)
    step = jenv64[2]
    for k in range(10):
        js, *_ = step(js, jnp.asarray(actions[k]))
    tenv = VecEnv(make_ieee33_task(), dtype=torch.float64, device="cpu")
    ts = state_from_jax(js, device="cpu")
    assert ts.t.dtype == torch.int32 and int(ts.t[0]) == 10
    for k in range(10, 13):
        ts, tobs, tr, _, _ = tenv.step(ts, torch.as_tensor(actions[k]))
        js, jobs, jr, _, _ = step(js, jnp.asarray(actions[k]))
        _close(tobs, jobs, 1e-8, name="obs")
        _close(tr, jr, 1e-8, name="reward")
        _close(ts.bus_vm, js.bus_vm, 1e-8, name="bus_vm")
        _close(ts.v_guess, js.v_guess, 1e-8, name="v_guess")


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
def test_tables_from_jax_equal_make_tables(dtype):
    jtb = JVecEnv(j_make_ieee33_task(), dtype=dtype).tables
    ttb = tables_from_jax(jtb, device="cpu")
    ref = VecEnv(make_ieee33_task(), dtype=ttb.dtype, device="cpu").tables
    assert ttb.dtype == (torch.float64 if dtype == jnp.float64 else torch.float32)
    for name, a in ref._asdict().items():
        b = getattr(ttb, name)
        if torch.is_tensor(a):
            assert a.dtype == b.dtype, name
            # f32 tables are casts of the same f64 values; the chord's come
            # from two Y-bus builds that agree to ~1e-16.
            torch.testing.assert_close(b, a, rtol=1.2e-7 if a.dtype == torch.float32 else 1e-12,
                                       atol=1e-12, msg=name)
        elif name not in ("chord", "chord_t"):
            assert a == b, name


def test_f32_step_from_carried_state_matches_jax_f32():
    """Both f32 steps (chord + fallback) from the same carried state."""
    jenv = JVecEnv(j_make_ieee33_task(), dtype=jnp.float32)
    js, _ = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(0), B))
    a = np.random.default_rng(5).uniform(jenv.action_low, jenv.action_high, (B, 3)).astype(np.float32)
    js2, jobs, jr, _, _ = jax.jit(jax.vmap(jenv.step))(js, jnp.asarray(a))
    tenv = VecEnv(make_ieee33_task(), dtype=torch.float32, device="cpu")
    ts2, tobs, tr, td, tinfo = tenv.step(state_from_jax(js, device="cpu"), torch.as_tensor(a))
    assert not td.any() and float(tinfo["diff"].max()) <= 1e-4
    _close(ts2.bus_vm, js2.bus_vm, 5e-6, name="bus_vm")
    _close(tr, jr, 2e-4, rtol=2e-3, name="reward")


def test_import_leaves_jax_out():
    code = ("import sys, gym_anm_torch, gym_anm_torch.vec, gym_anm_torch.convert, "
            "gym_anm_torch.physics.linsolve_cuda, gym_anm_torch._build; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'gym_anm_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_build_import_needs_no_nvcc(tmp_path):
    """Importing the package and its build module, and asking for the
    library path, needs no nvcc; a CPU tensor never reaches the build."""
    code = ("import gym_anm_torch._build as b, torch; "
            "from gym_anm_torch.physics.linsolve_cuda import batched_solve, solve_gauss_jordan_cuda as k; "
            "p = b.library_path(); assert p.parent == b.BUILD_DIR and p.suffix == '.so'; "
            "A = torch.eye(4).expand(3, 4, 4) * 2; x = batched_solve(A, torch.ones(3, 4)); "
            "assert torch.equal(x, torch.full((3, 4), 0.5)) and k.launch_count == 0; "
            "assert b.load_library.cache_info().currsize == 0")
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120)


def test_reset_retries_unstable_lanes_and_terminates():
    """A lane whose load flow diverges is retried (≤100 tries) and, since
    its s0 stays the same, ends terminated; the other lanes keep their
    first solve."""
    task = make_ieee33_task()
    net = copy.deepcopy(task.network)
    loads = net["device"][:, 2] == -1
    net["device"][loads, 5] = net["device"][loads, 5] * 50  # PMIN: allow 50x the loads
    s0 = task.init_state_fn(None, 1, ())[0]
    calls = []

    def init_state_fn(generator, n, carry):
        calls.append(n)
        out = np.array(np.broadcast_to(s0, (n, s0.size)))
        heavy = slice(1, 2) if len(calls) == 1 else slice(None)
        out[heavy, 1:33] *= 5e3  # 50x the nominal loads: no load-flow solution
        return out

    env = VecEnv(dataclasses.replace(task, network=net, init_state_fn=init_state_fn),
                 dtype=torch.float32, device="cpu")
    state, obs = env.reset(3)
    assert calls == [3] + [1] * 99
    np.testing.assert_array_equal(state.terminated.numpy(), [False, True, False])
    ref_state, ref_obs = VecEnv(make_ieee33_task(), dtype=torch.float32, device="cpu").reset(2)
    torch.testing.assert_close(state.bus_vm[[0, 2]], ref_state.bus_vm)


def test_entry_points_default_to_the_card():
    """``VecEnv``, ``make_tables``, ``make_obs_plan`` and the ``convert``
    functions run on the card when no device is given: without one they
    raise, as torch raises for a CUDA tensor, and nothing falls back to the
    CPU."""
    import inspect

    from gym_anm_torch import convert
    from gym_anm_torch.physics.transition import make_tables
    from gym_anm_torch.vec.obs import make_obs_plan

    for fn in (VecEnv.__init__, make_tables, make_obs_plan, convert.tables_from_jax, convert.state_from_jax,
               convert.carry_from_jax):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__
    task = make_ieee33_task()
    spec = VecEnv(task, device="cpu").spec
    builds = (lambda: VecEnv(task), lambda: make_tables(spec, task.delta_t, task.lamb),
              lambda: make_obs_plan(spec, 0, [("bus_v_magn", "all", "pu")]),
              lambda: convert.carry_from_jax(np.zeros(3, np.float32)))
    if torch.cuda.is_available():
        assert VecEnv(task).device.type == "cuda"
        return
    for build in builds:
        with pytest.raises((AssertionError, RuntimeError)):
            build()
