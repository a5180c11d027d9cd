"""gym_anm_torch.utils: checkpoints and state round-trips, metrics, the debug
tools (``tests/test_utils.py`` and ``tests/test_debug_tools.py`` on the
port), the sync guard and the throughput counter.  The s0 round-trip is also
held against the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_anm_torch.parallel import CQLConfig, PPOConfig, init_cql_state, init_train_state
from gym_anm_torch.utils import (RolloutMetrics, Throughput, debug_nans, env_state_to_vector, explain_divergence,
                                 forbid_host_syncs, nan_guard, restore_checkpoint, save_checkpoint, validate_state,
                                 vector_to_env_state)
from gym_anm_torch.vec import VecEnv, make_anm6easy_task, make_ieee33_task
from gym_anm_tpu.utils import env_state_to_vector as j_env_state_to_vector
from gym_anm_tpu.utils import vector_to_env_state as j_vector_to_env_state
from gym_anm_tpu.vec import VecEnv as JVecEnv
from gym_anm_tpu.vec import make_ieee33_task as j_make_ieee33_task

torch.set_num_threads(2)


def test_env_state_vector_roundtrip():
    """EnvState -> s0 vector -> EnvState reproduces the physics state (the
    reference's de-facto serialization, Simulator.reset), as the JAX
    package's does."""
    env = VecEnv(make_ieee33_task(), dtype=torch.float64, device="cpu")
    state, obs = env.reset(1)
    a = env.action_low + 0.7 * (env.action_high - env.action_low)
    state, obs, r, d, _ = env.step(state, a.unsqueeze(0))

    s0 = env_state_to_vector(env, state)
    state2 = vector_to_env_state(env, s0[0], oltc_tap=state.oltc_tap)
    torch.testing.assert_close(state2.dev_p, state.dev_p, rtol=0, atol=1e-9)
    torch.testing.assert_close(state2.soc, state.soc, rtol=0, atol=1e-12)
    torch.testing.assert_close(state2.bus_vm, state.bus_vm, rtol=0, atol=1e-9)
    assert not state2.terminated.any() and state2.t.dtype == torch.int32

    jenv = JVecEnv(j_make_ieee33_task(), dtype=jnp.float64)
    js, _ = jax.jit(jenv.reset)(jax.random.PRNGKey(0))
    js, *_ = jax.jit(jenv.step)(js, jnp.asarray(a.numpy()))
    np.testing.assert_allclose(s0[0].numpy(), np.asarray(j_env_state_to_vector(jenv, js)), rtol=1e-12, atol=1e-12)
    js2 = jax.jit(lambda v, tap: j_vector_to_env_state(jenv, v, oltc_tap=tap))(j_env_state_to_vector(jenv, js),
                                                                              js.oltc_tap)
    np.testing.assert_allclose(state2.bus_vm[0].numpy(), np.asarray(js2.bus_vm), rtol=0, atol=1e-12)


@pytest.mark.parametrize("what", ["env_state", "ppo", "cql"])
def test_checkpoint_roundtrip(tmp_path, what):
    """EnvState (with its zero-width soc: the base task has no storage), a
    PPO TrainState and a CQLState come back bit for bit."""
    if what == "env_state":
        env = VecEnv(make_ieee33_task(), dtype=torch.float32, device="cpu")
        tree, _ = env.reset(4)
        assert tree.soc.numel() == 0
    elif what == "ppo":
        ts = init_train_state(0, 5, 2, PPOConfig(hidden=4), device="cpu")
        tree = ts._replace(opt_m={k: v + 1 for k, v in ts.opt_m.items()}, step=7)
    else:
        tree = init_cql_state(0, 5, 2, CQLConfig(hidden=4), dtype=torch.float64, device="cpu")
    path = save_checkpoint(tmp_path / "ckpt", tree, step=3)
    assert path.endswith("step_3.pt")
    ref = tree if what == "env_state" else tree.to()  # a copy, its parameters zeroed
    if what != "env_state":
        with torch.no_grad():
            for p in (ref.params if what == "ppo" else ref.train.params).parameters():
                p.zero_()
    restored = restore_checkpoint(tmp_path / "ckpt", ref, step=3)
    assert type(restored) is type(tree)

    def leaves(t):
        if isinstance(t, torch.nn.Module):
            return [v for _, v in sorted(t.state_dict().items())]
        if torch.is_tensor(t):
            return [t]
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in leaves(t[k])]
        if isinstance(t, tuple):
            return [x for e in t for x in leaves(e)]
        return [t]

    for a, b in zip(leaves(tree), leaves(restored), strict=True):
        if torch.is_tensor(a):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b


def test_rollout_metrics():
    m = RolloutMetrics.zero(device="cpu")
    info = {"e_loss": torch.tensor([0.5, 0.5]), "penalty": torch.tensor([0.0, 1.5]), "n_iter": torch.tensor([3, 4])}
    m = m.update(torch.tensor([-1.0, -2.0]), torch.tensor([False, True]), info)
    s = m.summary()
    assert float(s["steps"]) == 2
    assert abs(float(s["mean_reward"]) + 1.5) < 1e-6
    assert abs(float(s["violation_rate"]) - 0.5) < 1e-6
    assert abs(float(s["termination_rate"]) - 0.5) < 1e-6
    assert abs(float(s["mean_nr_iters"]) - 3.5) < 1e-6


def test_nan_guard_reports_and_passes_through(capsys):
    tree = (torch.tensor([1.0, float("nan")]), {"k": torch.zeros(2)})
    assert nan_guard(tree, "batch") is tree
    assert "NaN detected in batch" in capsys.readouterr().out
    nan_guard((torch.zeros(3),), "clean")
    assert capsys.readouterr().out == ""


# ---------------------------------------------------------------------------
# Debug tools (tests/test_debug_tools.py on the port).


@pytest.fixture(scope="module")
def stepped():
    # ANM6Easy: storage (a non-empty soc for the box check) and an OLTC.
    env = VecEnv(make_anm6easy_task(), dtype=torch.float32, device="cpu")
    state, obs = env.reset(8, torch.Generator().manual_seed(0))
    acts = ((env.action_low + env.action_high) / 2.0).expand(8, env.n_action)
    state, obs, r, d, info = env.step(state, acts)
    return env, state, d, info


def test_debug_nans_raises_at_producer_and_restores():
    x = torch.zeros(3) - 1.0
    with pytest.raises(FloatingPointError, match="log"):
        with debug_nans():
            y = x * 2.0  # finite: passes
            torch.log(y)
    # Restored on exit: the same computation is silent outside the guard.
    assert torch.isnan(torch.log(x)).all()
    with debug_nans(False):
        assert torch.isinf(1.0 / torch.zeros(1)).all()


def test_validate_state_clean_on_real_rollout(stepped):
    env, state, d, info = stepped
    assert validate_state(state, env.spec) == {}


def test_validate_state_flags_injected_corruption(stepped):
    env, state, d, info = stepped
    bus_vm, soc = state.bus_vm.clone(), state.soc.clone()
    bus_vm[3, 5] = float("nan")
    soc[6, 0] = 1e6
    bad = state._replace(bus_vm=bus_vm, soc=soc)
    report = validate_state(bad, env.spec)
    assert list(report["bus_vm_nonfinite"]) == [3]
    assert list(report["soc_outside_box"]) == [6]
    with pytest.raises(AssertionError):
        validate_state(bad, env.spec, strict=True)


def test_validate_state_exempts_terminated_lanes(stepped):
    env, state, d, info = stepped
    bus_vm, term = state.bus_vm.clone(), state.terminated.clone()
    bus_vm[2] = float("nan")
    term[2] = True
    assert validate_state(state._replace(bus_vm=bus_vm, terminated=term), env.spec) == {}


def test_explain_divergence_classification():
    done = np.array([False, True, True, False])
    info = {"diff": np.array([1e-6, 5.0, 1e-7, 2e-3]), "n_iter": np.array([4, 30, 7, 30])}
    out = explain_divergence(info, done, xtol=1e-4)
    assert list(out["collapsed"]) == [1]
    assert list(out["terminated_converged"]) == [2]
    assert list(out["unhealthy"]) == [3]
    assert out["n_iter_max"] == 30
    assert out["worst_live_diff"] == pytest.approx(2e-3)


def test_explain_divergence_on_real_step(stepped):
    env, state, d, info = stepped
    out = explain_divergence(info, d, state=state)
    assert out["unhealthy"].size == 0
    assert out["state_report"] == {}


def test_forbid_host_syncs_and_throughput_on_the_cpu():
    """Without a card the sync guard checks nothing and the counter reads
    the host clock."""
    with forbid_host_syncs():
        assert float(torch.ones(2).sum()) == 2.0
    clock = Throughput(device="cpu")
    assert clock.steps_per_s == 0.0
    clock.start()
    clock.add(1000)
    assert clock.steps_per_s > 0.0
