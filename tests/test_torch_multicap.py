"""The multicap17 path of gym_anm_torch against gym_anm_tpu: golden rollouts
of the diurnal multicap task from the same reset, actions and load noise,
autoreset and the shaping carry, the reset retry's per-lane task carry, and
the PFE invariant oracle (tests/oracle.py) on the port's solved states."""

import copy
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_anm_torch.convert import state_from_jax
from gym_anm_torch.physics.ybus import build_ybus
from gym_anm_torch.vec import (
    VecEnv,
    make_ieee33_multicap_task,
    make_ieee33_task,
    make_ieee33_unequal_task,
    make_two_bus_task,
)
from gym_anm_torch.vec import core as tcore
from gym_anm_tpu.vec import (
    VecEnv as JVecEnv,
    make_ieee33_multicap_task as j_make_ieee33_multicap_task,
    make_ieee33_task as j_make_ieee33_task,
    make_ieee33_unequal_task as j_make_ieee33_unequal_task,
)
from tests.oracle import check_pfe_solution

torch.set_num_threads(2)

B = 32
T = 20


def _close(t, j, atol, rtol=0.0, name=""):
    np.testing.assert_allclose(t.double().numpy(), np.asarray(j, np.float64), rtol=rtol, atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def jmulti64():
    env = JVecEnv(j_make_ieee33_multicap_task(), dtype=jnp.float64)
    return env, jax.jit(jax.vmap(env.reset)), jax.jit(jax.vmap(env.step))


@pytest.fixture(scope="module")
def multicap_actions(jmulti64):
    lo, hi = np.asarray(jmulti64[0].action_low), np.asarray(jmulti64[0].action_high)
    return np.random.default_rng(17).uniform(lo, hi, size=(T, B, len(lo)))


def _k_vars(keys):
    """JAX's step splits each lane key into (key, k_vars) and draws the
    exogenous variables from k_vars."""
    return jax.vmap(lambda k: jax.random.split(k)[1])(keys)


def _jax_noise(keys, n_load, dtype):
    """The standard normal load draw of JAX's step, lane by lane (the
    renewable family draws ``normal(k_vars, (n_load,), dtype)``)."""
    return np.array(jax.vmap(lambda k: jax.random.normal(k, (n_load,), dtype))(_k_vars(keys)))


def _fed_env(dtype):
    """A multicap VecEnv whose exogenous step is fed: from a standard normal
    load draw in ``feed['z']`` through the port's own diurnal formula, or
    JAX's (vars, hour) as they are in ``feed['vars']``."""
    task = make_ieee33_multicap_task()
    feed = {}

    def next_vars_fn(generator, s_t, hour, t):
        if "vars" in feed:
            v, h = feed["vars"]
            return torch.as_tensor(np.array(v), dtype=dtype), torch.as_tensor(np.array(h))
        return task.next_vars_fn.from_noise(hour, torch.as_tensor(feed["z"], dtype=dtype))

    return VecEnv(dataclasses.replace(task, next_vars_fn=next_vars_fn), dtype=dtype, device="cpu"), feed


class _Sim:
    """One lane of a port TransitionOut dressed as the simulator the PFE
    oracle reads (Y_bus, buses, devices, branches; positions as ids)."""

    def __init__(self, tb, spec, out, lane):
        tap = tb.tap0.clone()
        tap[tb.oltc_branch] = out.oltc_tap[lane]
        Yre, Yim = build_ybus(tb.n_bus, tb.br_f, tb.br_t, tb.series_re, tb.series_im, tb.shunt_im,
                              tb.shift_cos, tb.shift_sin, tap[None])
        Y = (Yre[0] + 1j * Yim[0]).numpy()
        self.Y_bus = types.SimpleNamespace(toarray=lambda: Y)
        v = (out.bus_v_re[lane] + 1j * out.bus_v_im[lane]).numpy()
        i = (out.bus_i_re[lane] + 1j * out.bus_i_im[lane]).numpy()
        self.buses = {k: types.SimpleNamespace(v=v[k], i=i[k], is_slack=k == tb.slack_bus,
                                               p=float(out.bus_p[lane, k]), q=float(out.bus_q[lane, k]))
                      for k in range(tb.n_bus)}
        self.devices = {d: types.SimpleNamespace(p=float(out.dev_p[lane, d]), q=float(out.dev_q[lane, d]),
                                                 bus_id=int(spec.dev_bus[d])) for d in range(tb.n_dev)}
        series = (tb.series_re + 1j * tb.series_im).numpy()
        self.branches = {}
        for e in range(tb.n_branch):
            f, t = int(tb.br_f[e]), int(tb.br_t[e])
            self.branches[(f, t)] = types.SimpleNamespace(
                tap_magn=float(tap[e]), shift=float(np.angle(complex(tb.shift_cos[e], tb.shift_sin[e]))),
                series=series[e], shunt=1j * float(tb.shunt_im[e]),
                i_from=complex(out.br_i_from_re[lane, e], out.br_i_from_im[lane, e]),
                i_to=complex(out.br_i_to_re[lane, e], out.br_i_to_im[lane, e]),
                p_from=float(out.br_p_from[lane, e]), q_from=float(out.br_q_from[lane, e]),
                p_to=float(out.br_p_to[lane, e]), q_to=float(out.br_q_to[lane, e]),
                s_apparent_max=float(out.br_s_signed[lane, e]))


@pytest.fixture
def solved_states(monkeypatch):
    """Every TransitionOut the port's VecEnv produces while the test runs."""
    outs = []
    real = tcore.transition

    def recording(*args, **kw):
        out = real(*args, **kw)
        outs.append(out)
        return out

    monkeypatch.setattr(tcore, "transition", recording)
    return outs


def _check_oracle(env, outs, lanes):
    n = 0
    for out in outs:
        for lane in lanes:
            if lane < len(out.stable) and bool(out.stable[lane]):
                check_pfe_solution(_Sim(env.tables, env.spec, out, lane), atol=5e-5)
                n += 1
    assert n > 0


def test_diurnal_loads_match_jax(jmulti64):
    """The port's diurnal load formula fed JAX's standard normal draw gives
    the loads and hour of JAX's compiled step.  The hour advance is bitwise
    equal.  The loads agree to float32 rounding: the time factor is a float32
    sine in both packages, and XLA's compiled sine and torch's differ by an
    ulp on some arguments (measured: max relative 1.2e-7 on 1167 of 4096
    lanes), so rtol 2e-7."""
    jenv, jreset, _ = jmulti64
    js, _ = jreset(jax.random.split(jax.random.PRNGKey(5), 256))
    n_vars = jenv.spec.n_load + jenv.spec.n_gen
    s_t = jnp.zeros((256, jenv.n_state))
    jvars, jhour = jax.jit(jax.vmap(jenv.task.next_vars_fn))(_k_vars(js.key), s_t, js.task, js.t)
    tvars, thour = make_ieee33_multicap_task().next_vars_fn.from_noise(
        torch.as_tensor(np.array(js.task)), torch.as_tensor(_jax_noise(js.key, jenv.spec.n_load, jnp.float64)))
    assert tvars.shape == (256, n_vars) and thour.dtype == torch.float32
    np.testing.assert_array_equal(thour.numpy(), np.asarray(jhour))
    np.testing.assert_allclose(tvars.numpy(), np.asarray(jvars), rtol=2e-7, atol=0)


def test_multicap_golden_rollout_f64(jmulti64, multicap_actions, solved_states):
    """20 steps x 32 lanes from JAX's reset, with JAX's actions and JAX's
    exogenous variables (the loads JAX drew, fed as they are: the formula is
    held apart in test_diurnal_loads_match_jax): obs, reward, bus_vm, v_guess
    and the hour carry within 1e-8, equal Newton iteration counts; the
    port's solved states pass the PFE oracle (satellite of ROADMAP queue 1
    item 3)."""
    jenv, jreset, jstep = jmulti64
    js, jobs = jreset(jax.random.split(jax.random.PRNGKey(3), B))
    tenv, feed = _fed_env(torch.float64)
    ts = state_from_jax(js, device="cpu")
    assert ts.task.dtype == torch.float32 and ts.task.shape == (B,)
    next_vars = jax.jit(jax.vmap(jenv.task.next_vars_fn))
    n_done = 0
    for k in range(T):
        a = multicap_actions[k]
        s_t = jax.vmap(jenv._state_vector)(js.dev_p, js.dev_q, js.soc, js.p_pot, js.aux)
        feed["vars"] = next_vars(_k_vars(js.key), s_t, js.task, js.t)
        ts, tobs, tr, td, tinfo = tenv.step(ts, torch.as_tensor(a))
        js, jobs, jr, jd, jinfo = jstep(js, jnp.asarray(a))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        n_done += int(td.sum())
        _close(tobs, jobs, 1e-8, name=f"obs {k}")
        _close(tr, jr, 1e-8, name=f"reward {k}")
        _close(ts.bus_vm, js.bus_vm, 1e-8, name=f"bus_vm {k}")
        _close(ts.v_guess, js.v_guess, 1e-8, name=f"v_guess {k}")
        _close(ts.p_pot, js.p_pot, 1e-8, name=f"p_pot {k}")
        np.testing.assert_array_equal(ts.task.numpy(), np.asarray(js.task), err_msg=f"hour {k}")
        np.testing.assert_array_equal(tinfo["n_iter"].numpy(), np.asarray(jinfo["n_iter"]))
    assert n_done < B
    _check_oracle(tenv, solved_states[::5], lanes=range(0, B, 7))


def test_multicap_f32_rollout_matches_f64_jax(jmulti64, multicap_actions):
    """The port's float32 step (chord path, linearized at the nominal-load
    point, loads from the port's formula and JAX's draws) against JAX at
    float64, at the f32 solver tolerances of tests/test_chord_solver.py:
    voltages within 5e-6; e_loss, and rewards of lanes without penalty,
    within rtol 2e-3 / atol 2e-4 where |e_loss| >= 1e-4 (ROADMAP P7).  The
    penalty multiplies the branch flows' error, which the 1e-5 residual
    bounds, by λ = 100: penalties within rtol 2e-3 / atol λ·Δt·1e-5."""
    jenv, jreset, jstep = jmulti64
    js, _ = jreset(jax.random.split(jax.random.PRNGKey(4), B))
    tenv, feed = _fed_env(torch.float32)
    ts = state_from_jax(js, device="cpu")
    ts = ts._replace(**{f: getattr(ts, f).float() for f in ("soc", "oltc_tap", "dev_p", "dev_q", "p_pot",
                                                            "bus_vm", "aux", "v_guess")})
    for k in range(8):
        a = multicap_actions[k].astype(np.float32)
        feed["z"] = _jax_noise(js.key, tenv.spec.n_load, jnp.float64)
        ts, tobs, tr, td, tinfo = tenv.step(ts, torch.as_tensor(a))
        js, jobs, jr, jd, jinfo = jstep(js, jnp.asarray(a, jnp.float64))
        live = ~np.asarray(jd)
        assert live.sum() >= B - 2
        np.testing.assert_array_equal(td.numpy(), ~live)
        assert float(tinfo["diff"][live].max()) <= 1e-4
        _close(ts.bus_vm[live], np.asarray(js.bus_vm)[live], 5e-6, name=f"bus_vm {k}")
        e_loss, penalty = np.asarray(jinfo["e_loss"]), np.asarray(jinfo["penalty"])
        clear = live & (np.abs(e_loss) >= 1e-4)
        _close(tinfo["e_loss"][clear], e_loss[clear], 2e-4, rtol=2e-3, name=f"e_loss {k}")
        _close(tr[clear & (penalty == 0)], np.asarray(jr)[clear & (penalty == 0)], 2e-4, rtol=2e-3,
               name=f"reward {k}")
        _close(tinfo["penalty"][live], penalty[live], 100 * 1e-5, rtol=2e-3, name=f"penalty {k}")


def test_step_autoreset_batch_matches_jax(solved_states):
    """Base IEEE33 (deterministic s0), float64, with lanes forced terminated:
    reset lanes, untouched lanes, obs and the carried oltc_tap match JAX's
    batched autoreset; the port's solved states pass the PFE oracle."""
    jenv = JVecEnv(j_make_ieee33_task(), dtype=jnp.float64)
    js, _ = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(0), B))
    tenv = VecEnv(make_ieee33_task(), dtype=torch.float64, device="cpu")
    ts = state_from_jax(js, device="cpu")
    rng = np.random.default_rng(8)
    lo, hi = np.asarray(jenv.action_low), np.asarray(jenv.action_high)
    jstep = jax.jit(jenv.step_autoreset_batch)
    for k in range(3):
        kill = np.zeros(B, bool)
        kill[rng.choice(B, 5, replace=False)] = True
        js = js._replace(terminated=jnp.asarray(kill))
        ts = ts._replace(terminated=torch.as_tensor(kill))
        taps_before = ts.oltc_tap.numpy().copy()
        a = rng.uniform(lo, hi, (B, len(lo)))
        ts, tobs, tr, td, _ = tenv.step_autoreset_batch(ts, torch.as_tensor(a))
        js, jobs, jr, jd, _ = jstep(js, jnp.asarray(a))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(td.numpy(), kill)
        assert (ts.t.numpy()[kill] == 0).all()
        np.testing.assert_array_equal(ts.t.numpy(), np.asarray(js.t))
        np.testing.assert_array_equal(ts.terminated.numpy(), np.asarray(js.terminated))
        np.testing.assert_array_equal(ts.oltc_tap.numpy(), np.asarray(js.oltc_tap))
        # Reset lanes keep the tap they carried (terminated lanes absorb the
        # step, so it is the tap from before it).
        np.testing.assert_array_equal(ts.oltc_tap.numpy()[kill], taps_before[kill])
        _close(tobs, jobs, 1e-8, name=f"obs {k}")
        _close(tr, jr, 1e-8, name=f"reward {k}")
        for f in ("dev_p", "dev_q", "bus_vm", "v_guess", "soc"):
            _close(getattr(ts, f), getattr(js, f), 1e-8, name=f"{f} {k}")
    _check_oracle(tenv, solved_states, lanes=(0, 13))


def test_unequal_shaping_carry_persists_across_reset():
    """The switching-cost tracker of the unequal-capacitor task survives an
    autoreset, as in JAX (whose carry depends on the actions only)."""
    jenv = JVecEnv(j_make_ieee33_unequal_task(), dtype=jnp.float64)
    js, _ = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(1), 8))
    tenv = VecEnv(make_ieee33_unequal_task(), dtype=torch.float64, device="cpu")
    ts, _ = tenv.reset(8, torch.Generator().manual_seed(1))
    for carry in ts.shaping:
        assert not carry.any()
    rng = np.random.default_rng(9)
    lo, hi = np.asarray(jenv.action_low), np.asarray(jenv.action_high)
    jstep = jax.jit(jenv.step_autoreset_batch)
    g = torch.Generator().manual_seed(2)
    for k in range(3):
        kill = np.arange(8) % 3 == k
        js = js._replace(terminated=jnp.asarray(kill))
        ts = ts._replace(terminated=torch.as_tensor(kill))
        a = rng.uniform(lo, hi, (8, len(lo)))
        ts, _, _, td, tinfo = tenv.step_autoreset_batch(ts, torch.as_tensor(a), g)
        js, _, _, _, jinfo = jstep(js, jnp.asarray(a))
        assert td.numpy()[kill].all() and (ts.t.numpy()[kill] == 0).all()
        for tc, jc in zip(ts.shaping, js.shaping):
            np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-12)
        _close(tinfo["switching_cost"], jinfo["switching_cost"], 1e-12)
    assert (ts.shaping[1].numpy() > 0).all()


def test_reset_retry_passes_each_lane_its_own_task_carry():
    """A retried lane draws again under its own task carry (JAX: each lane
    retries under its carry), not the whole batch's."""
    task = make_ieee33_task()
    net = copy.deepcopy(task.network)
    loads = net["device"][:, 2] == -1
    net["device"][loads, 5] = net["device"][loads, 5] * 50  # PMIN: allow 50x the loads
    s0 = task.init_state_fn(None, 1, ())[0]
    seen = []

    def init_state_fn(generator, n, carry):
        seen.append(carry.clone())
        assert carry.shape == (n,)
        out = np.array(np.broadcast_to(s0, (n, s0.size)))
        if len(seen) == 1:
            out[(carry.numpy() // 10) % 2 == 1, 1:33] *= 5e3  # no load-flow solution on odd lanes
        return out

    fixed = dataclasses.replace(task, network=net, init_task_fn=lambda generator, n: torch.arange(n) * 10,
                                init_state_fn=init_state_fn)
    state, _ = VecEnv(fixed, dtype=torch.float64, device="cpu").reset(6)
    assert len(seen) == 2
    torch.testing.assert_close(seen[1], torch.tensor([10, 30, 50]))
    assert not state.terminated.any()
    torch.testing.assert_close(state.task, torch.arange(6) * 10)


def test_base_rollout_passes_pfe_oracle(solved_states):
    """ROADMAP queue 1 item 3: the port's f64 base IEEE33 solved states
    satisfy the power-flow invariants (oracle atol 5e-5)."""
    env = VecEnv(make_ieee33_task(), dtype=torch.float64, device="cpu")
    state, obs = env.reset(8)
    state, traj = env.rollout(state, env.random_policy(), 4, generator=torch.Generator().manual_seed(0))
    assert traj[0].shape == (4, 8, env.n_obs) and traj[1].shape == (4, 8, env.n_action)
    assert not traj[3].any()
    _check_oracle(env, solved_states, lanes=range(8))


def test_rollout_and_two_bus_task_run_with_a_generator():
    """The two-bus task and rollout draw only from the generator they are
    given: the same seed gives the same trajectory."""
    env = VecEnv(make_two_bus_task(), dtype=torch.float64, device="cpu")
    runs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(5)
        state, _ = env.reset(4, g)
        runs.append(env.rollout(state, env.random_policy(), 6, generator=g)[1])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    obs, _, r, _ = runs[0]
    assert obs.shape == (6, 4, env.n_obs) and torch.isfinite(r).all()
