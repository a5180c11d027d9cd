"""The port on random radial feeders above 33 buses against gym_anm_tpu.

``tests/test_random_networks.py`` steps random feeders of 3..24 buses in the
JAX package; here the port's copy of its generator
(``gym_anm_torch/networks/random_feeder.py``) draws feeders of 40 to 130
buses, where the port's card path needs the wide chord kernel and, above
120 buses, the Gauss-Jordan kernel in device memory.  Both packages step the
same feeders from the same zero state with the same numpy-made loads and
actions:

* float64: observations, rewards and voltages within 1e-8 and equal Newton
  counts, and the PFE oracle (``tests/oracle.py``) holds on the port's
  solved states;
* float32: the port's chord path against JAX's float32 step, voltages within
  2e-5 (each solve stops somewhere within ‖F‖∞ ≤ 1e-5 of the solution, and
  the two sum in other orders; on the 64-bus feeder they differ by up to
  5.6e-6, over the 5e-6 of IEEE33), and against JAX's float64 step at
  the tolerances of ``tests/test_chord_solver.py`` (rewards rtol 2e-3 / atol
  2e-4 where |e_loss| ≥ 1e-4, ROADMAP P7; voltages 1e-4 as
  ``test_random_network_vec_f32_matches_f64``).

The 130-bus feeder is held at float32 only: the port's float64 CPU tier
solves its 258-unknown Newton systems with LAPACK, whose threaded batched LU
at that size hangs on this suite's machines with ``torch.set_num_threads(2)``
(the threads every port test module sets).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_anm_torch.networks.random_feeder import feeder_vars, make_feeder_task, random_radial_network
from gym_anm_torch.vec import VecEnv
from gym_anm_tpu.vec import VecEnv as JVecEnv, VecTask as JVecTask
from tests.oracle import check_pfe_solution
from tests.test_random_networks import random_radial_network as j_random_radial_network
from tests.test_torch_multicap import _Sim

torch.set_num_threads(2)

B, T = 8, 3
# (buses, load scale): the largest scale at which the float64 tier converges
# on every step of the seeded feeder.
FEEDERS = {40: 0.6, 64: 0.5, 130: 0.15}


def _feeder(n_bus):
    rng = np.random.default_rng(n_bus)
    net = random_radial_network(rng, n_bus)
    return net, feeder_vars(net, FEEDERS[n_bus], T, rng)


def _jax_task(net, vars_mw, n_state):
    table = jnp.asarray(vars_mw)

    def init_state_fn(key, carry):
        return jnp.zeros(n_state)

    def next_vars_fn(key, s_t, carry, t):
        return table[t % T].astype(s_t.dtype), carry

    return JVecTask(network=net, K=0, delta_t=0.5, gamma=0.99, lamb=100, costs_clipping=(None, None),
                    init_state_fn=init_state_fn, next_vars_fn=next_vars_fn, name="feeder")


def _rollouts(n_bus, port_dtype, jax_dtypes):
    """T steps of B lanes of the seeded feeder in the port at ``port_dtype``
    and in JAX at each of ``jax_dtypes``: per step the port's (state, obs,
    reward, done, info) and JAX's."""
    net, vars_mw = _feeder(n_bus)
    env = VecEnv(make_feeder_task(net, vars_mw), dtype=port_dtype, device="cpu")
    acts = np.random.default_rng(n_bus + 1).uniform(env.action_low.double().numpy(),
                                                    env.action_high.double().numpy(), (T, B, env.n_action))
    s, _ = env.reset(B)
    port = []
    for k in range(T):
        s, *out = env.step(s, torch.as_tensor(acts[k], dtype=port_dtype))
        port.append((s, *out))
    ref = {}
    for jdt in jax_dtypes:
        jenv = JVecEnv(_jax_task(net, vars_mw, env.n_state), dtype=jdt)
        js, _ = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(0), B))
        step = jax.jit(jax.vmap(jenv.step))
        ref[jdt] = []
        for k in range(T):
            js, *out = step(js, jnp.asarray(acts[k], jdt))
            ref[jdt].append((js, *out))
    return env, port, ref


def _np(x):
    return np.asarray(x, np.float64)


@pytest.mark.parametrize("n_bus", [40, 64, 130])
def test_generator_draws_the_jax_tests_feeder(n_bus):
    a = random_radial_network(np.random.default_rng(n_bus), n_bus)
    b = j_random_radial_network(np.random.default_rng(n_bus), n_bus)
    assert a["baseMVA"] == b["baseMVA"]
    for key in ("bus", "branch", "device"):
        assert a[key].shape == b[key].shape
        assert all((x is None and y is None) or x == y for x, y in zip(a[key].ravel(), b[key].ravel())), key


@pytest.mark.parametrize("n_bus", [40, 64])
def test_feeder_f64_matches_jax(n_bus, monkeypatch):
    """Float64 golden rollout against JAX at 1e-8 with equal Newton counts;
    the PFE oracle on the port's solved states."""
    from gym_anm_torch.vec import core as tcore

    outs, real = [], tcore.transition
    monkeypatch.setattr(tcore, "transition", lambda *a, **kw: outs.append(real(*a, **kw)) or outs[-1])
    env, port, ref = _rollouts(n_bus, torch.float64, (jnp.float64,))
    for k, ((ts, tobs, tr, td, tinfo), (js, jobs, jr, jd, jinfo)) in enumerate(zip(port, ref[jnp.float64])):
        assert not td.any() and not bool(jd.any())
        np.testing.assert_allclose(tobs.numpy(), _np(jobs), rtol=0, atol=1e-8, err_msg=f"obs {k}")
        np.testing.assert_allclose(tr.numpy(), _np(jr), rtol=0, atol=1e-8, err_msg=f"reward {k}")
        np.testing.assert_allclose(ts.bus_vm.numpy(), _np(js.bus_vm), rtol=0, atol=1e-8, err_msg=f"bus_vm {k}")
        np.testing.assert_array_equal(tinfo["n_iter"].numpy(), np.asarray(jinfo["n_iter"]))
    n = 0
    for out in outs[1:]:  # the steps' transitions (the first is the reset's)
        for lane in range(0, B, 3):
            assert bool(out.stable[lane])
            check_pfe_solution(_Sim(env.tables, env.spec, out, lane), atol=5e-5)
            n += 1
    assert n == T * len(range(0, B, 3))


@pytest.mark.parametrize("n_bus", [40, 64, 130])
def test_feeder_f32_matches_jax(n_bus):
    """The port's float32 step (the chord path at n = 39, 63, 129) against
    JAX's float32 and float64 steps on the same feeder."""
    env, port, ref = _rollouts(n_bus, torch.float32, (jnp.float32, jnp.float64))
    assert env.tables.chord is not None
    for k in range(T):
        ts, tobs, tr, td, tinfo = port[k]
        j32, j64 = ref[jnp.float32][k], ref[jnp.float64][k]
        assert not td.any() and float(tinfo["diff"].max()) <= 1e-4
        vm = ts.bus_vm.double().numpy()
        np.testing.assert_allclose(vm, _np(j32[0].bus_vm), rtol=0, atol=2e-5, err_msg=f"bus_vm vs f32 {k}")
        np.testing.assert_allclose(vm, _np(j64[0].bus_vm), rtol=0, atol=1e-4, err_msg=f"bus_vm vs f64 {k}")
        clear = np.abs(_np(j64[4]["e_loss"])) >= 1e-4
        np.testing.assert_allclose(tr.double().numpy()[clear], _np(j64[2])[clear], rtol=2e-3, atol=2e-4,
                                   err_msg=f"reward vs f64 {k}")
