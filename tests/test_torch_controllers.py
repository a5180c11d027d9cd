"""The port's L0-L5 controllers and expert zoo against the JAX package's, open
loop: a JAX multicap17 rollout runs with one controller in the loop, and at
every step the port's ``act`` gets the same state (``state_from_jax``) and
carry (``carry_from_jax``).  At float64 the actions agree to 1e-12 and the
carries exactly; at float32 the actions to 1 ulp and every carry (cap states,
tap indices, timers, the L5 grid choice) exactly.  A second test feeds both
packages random states and random carries, so that every branch of the rules
is taken."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_anm_torch.convert import carry_from_jax, state_from_jax
from gym_anm_torch.vec import VecEnv, make_ieee33_multicap_task
from gym_anm_torch.vec import controllers as tctrl
from gym_anm_torch.vec import experts as texp
from gym_anm_tpu.vec import VecEnv as JVecEnv
from gym_anm_tpu.vec import controllers as jctrl
from gym_anm_tpu.vec import experts as jexp
from gym_anm_tpu.vec import make_ieee33_multicap_task as j_make_ieee33_multicap_task

torch.set_num_threads(2)

B, T = 32, 20
DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}
# The suite's L1-L5 and the ten zoo members, by (family, index).
MEMBERS = [("suite", i) for i in range(1, 6)] + [("zoo", i) for i in range(10)]
_CACHE = {}


def _pair(dt):
    """(JAX env, jitted batched step, port env, {member: (jitted JAX act,
    JAX controller, port controller)}) at one dtype, made once per module,
    with JAX's reset of B lanes from two keys."""
    if dt not in _CACHE:
        jdt, tdt = DTYPES[dt]
        jenv = JVecEnv(j_make_ieee33_multicap_task(), dtype=jdt)
        tenv = VecEnv(make_ieee33_multicap_task(), dtype=tdt, device="cpu")
        ctrls = {}
        for fam, i in MEMBERS:
            jc = (jctrl.make_suite(jenv) if fam == "suite" else jexp.make_expert_zoo(jenv))[i]
            tc = (tctrl.make_suite(tenv) if fam == "suite" else texp.make_expert_zoo(tenv))[i]
            assert jc.name == tc.name
            ctrls[(fam, i)] = (jax.jit(jax.vmap(jc.act)), jc, tc)
        reset = jax.jit(jax.vmap(jenv.reset))
        _CACHE[dt] = (jenv, jax.jit(jax.vmap(jenv.step)), tenv, ctrls)
        _CACHE[dt, "reset"] = {seed: reset(jax.random.split(jax.random.PRNGKey(seed), B)) for seed in (1, 11)}
    return _CACHE[dt]


def _reset(dt, seed):
    _pair(dt)
    return _CACHE[dt, "reset"][seed]


def _leaves(c):
    if isinstance(c, tuple):
        return [x for e in c for x in _leaves(e)]
    return [c]


def _check(dt, ta, tcarry, ja, jcarry, what):
    if ta is not None:
        ja = np.asarray(ja)
        if dt == "f64":
            np.testing.assert_allclose(ta.numpy(), ja, rtol=0, atol=1e-12, err_msg=f"{what}: action")
        else:
            np.testing.assert_array_max_ulp(ta.numpy(), ja, maxulp=1)
    if isinstance(jcarry, tuple):
        assert type(tcarry).__name__ == type(jcarry).__name__
    tl, jl = _leaves(tcarry), _leaves(jcarry)
    assert len(tl) == len(jl)
    for k, (t, j) in enumerate(zip(tl, jl)):
        assert t.numpy().dtype == np.asarray(j).dtype, f"{what}: carry leaf {k} dtype"
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=f"{what}: carry leaf {k}")


def _j_carry0(jc, n):
    return jax.vmap(jc.init_carry)(jax.random.split(jax.random.PRNGKey(0), n))


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("member", MEMBERS, ids=[f"{f}{i}" for f, i in MEMBERS])
def test_controller_open_loop_matches_jax(dt, member):
    jenv, jstep, tenv, ctrls = _pair(dt)
    jact, jc, tc = ctrls[member]
    js, jobs = _reset(dt, 11)
    jcarry = _j_carry0(jc, B)
    _check(dt, None, tc.init_carry(B), None, jcarry, "init carry")
    lo, hi = jenv.action_low, jenv.action_high
    n_changes = 0
    for k in range(T):
        keys = jax.random.split(jax.random.PRNGKey(100 + k), B)
        ta, tcarry = tc.act(None, state_from_jax(js, device="cpu"), torch.as_tensor(np.array(jobs)),
                            carry_from_jax(jcarry, device="cpu"))
        ja, jcarry2 = jact(keys, js, jobs, jcarry)
        _check(dt, ta, tcarry, ja, jcarry2, f"{jc.name} step {k}")
        n_changes += sum(int((np.asarray(a) != np.asarray(b)).sum()) for a, b in zip(_leaves(jcarry),
                                                                                     _leaves(jcarry2)))
        jcarry = jcarry2
        js, jobs, _, _, _ = jstep(js, jnp.clip(ja, lo, hi))
    if member in (("suite", 2), ("suite", 3), ("suite", 4)):
        assert n_changes > 0, "the carry never changed"


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_l0_matches_jax_given_its_draw(dt):
    """L0 fed JAX's uniform draw as its noise gives JAX's actions."""
    jenv, _, tenv, _ = _pair(dt)
    jdt, _ = DTYPES[dt]
    jl0, tl0 = jctrl.make_l0(jenv), tctrl.make_l0(tenv)
    keys = jax.random.split(jax.random.PRNGKey(4), B)
    u = jax.vmap(lambda k: jax.random.uniform(k, (jenv.n_action,), dtype=jdt))(keys)
    js, jobs = _reset(dt, 1)
    ja, _ = jax.vmap(jl0.act)(keys, js, jobs, _j_carry0(jl0, B))
    ta, carry = tl0.act(torch.as_tensor(np.array(u)), state_from_jax(js, device="cpu"), None, tl0.init_carry(B))
    assert carry == ()
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


def _random_carry(jcarry, rng):
    """A JAX carry of the same structure with random values in each field's
    range (bools, tap indices 0-4, timers 0-6, cap set-points from the
    controllers' own values, L4's previous mean near 1)."""
    def rand(name, x):
        x = np.asarray(x)
        if x.dtype == bool:
            return rng.random(x.shape) < 0.5
        if x.dtype == np.int32:
            return rng.integers(0, 5 if "tap_idx" in name else 7, x.shape).astype(np.int32)
        if name == "prev_mean":
            return (0.95 + 0.1 * rng.random(x.shape)).astype(x.dtype)
        values = {"last_caps": (0.0, 0.4), "last_cap1": (0.0, 0.2, 0.3), "last_cap2": (0.0, 0.2, 0.3)}
        return rng.choice(np.asarray(values.get(name, (0.0, -0.5, 0.5)), x.dtype), x.shape)

    if isinstance(jcarry, tuple) and hasattr(jcarry, "_fields"):
        return type(jcarry)(*[jnp.asarray(rand(f, getattr(jcarry, f))) for f in jcarry._fields])
    if isinstance(jcarry, tuple):
        return jcarry
    return jnp.asarray(rand("", jcarry))


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("member", MEMBERS, ids=[f"{f}{i}" for f, i in MEMBERS])
def test_controller_on_random_states_and_carries(dt, member):
    """States after uniform-random actions (voltages across the controllers'
    thresholds, taps and caps anywhere in their range) and random carries:
    the same actions and carries as JAX."""
    jenv, jstep, tenv, ctrls = _pair(dt)
    jact, jc, tc = ctrls[member]
    rng = np.random.default_rng(MEMBERS.index(member))
    js, jobs = _reset(dt, 1)
    lo, hi = np.asarray(jenv.action_low), np.asarray(jenv.action_high)
    for k in range(4):
        js, jobs, _, _, _ = jstep(js, jnp.asarray(rng.uniform(lo, hi, (B, len(lo))), jenv.dtype))
        # Renewable potentials are zero on this task: give them values, so
        # that the set-points read them.
        js = js._replace(p_pot=jnp.asarray(rng.uniform(0.0, 0.05, js.p_pot.shape), jenv.dtype))
        jcarry = _random_carry(_j_carry0(jc, B), rng)
        ja, jcarry2 = jact(jax.random.split(jax.random.PRNGKey(k), B), js, jobs, jcarry)
        ta, tcarry = tc.act(None, state_from_jax(js, device="cpu"), torch.as_tensor(np.array(jobs)),
                            carry_from_jax(jcarry, device="cpu"))
        _check(dt, ta, tcarry, ja, jcarry2, f"{jc.name} state {k}")


def test_lane_mean_matches_jax_mean():
    """The controllers' lane mean equals ``jnp.mean`` under vmap bit for bit
    (33 and 6 entries, float64 and float32)."""
    rng = np.random.default_rng(0)
    for n in (33, 6, 70):
        for dt in (np.float64, np.float32):
            x = (0.9 + 0.2 * rng.random((512, n))).astype(dt)
            np.testing.assert_array_equal(tctrl._lane_mean(torch.as_tensor(x)).numpy(),
                                          np.asarray(jax.jit(jax.vmap(jnp.mean))(x)))


def test_carry_from_jax_keeps_structure():
    jenv, _, _, _ = _pair("f64")
    for jc in jctrl.make_suite(jenv) + jexp.make_expert_zoo(jenv):
        c = carry_from_jax(_j_carry0(jc, 3), device="cpu")
        if isinstance(c, tuple) and c:
            assert type(c) is getattr(tctrl, type(c).__name__)
            assert all(x.shape[0] == 3 for x in c)
    assert np.array_equal(tctrl.l5_grid(), jctrl._l5_grid())
    np.testing.assert_array_equal(tctrl.TAP_POSITIONS, jctrl.TAP_POSITIONS)
