"""The port's Gymnasium ``VectorEnv`` adapter: the counterparts of
``tests/test_gym_vector.py`` on the CPU, with ``devices=["cpu", "cpu"]`` in
place of the JAX package's 8-device mesh, and a float64 parity test against
the JAX adapter from JAX's reset state (``convert.state_from_jax``) at 1e-8.

The adapter's own semantics (spaces, the three autoreset modes, the wrapper
ecosystem) are pinned as in the JAX suite; driving ``VecEnv`` directly from
the same ``torch.Generator`` seed gives the adapter's trajectory exactly."""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_anm_torch.convert import state_from_jax
from gym_anm_torch.vec import (
    GymVectorEnv,
    make_anm6easy_task,
    make_ieee33_multicap_task,
)
from gym_anm_tpu.vec import GymVectorEnv as JGymVectorEnv
from gym_anm_tpu.vec import make_anm6easy_task as j_make_anm6easy_task

torch.set_num_threads(2)

ATOL = 1e-8  # float64 parity with the JAX adapter


def bang_bang(rng, lo, hi, n):
    """Actions at the bounds of the box: ANM6Easy lanes collapse under them."""
    return np.where(rng.random((n, lo.shape[0])) < 0.5, lo, hi).astype(lo.dtype)


@pytest.fixture(scope="module")
def adapter():
    return GymVectorEnv(make_ieee33_multicap_task(), num_envs=4, device="cpu")


def test_spaces_and_contract(adapter):
    assert isinstance(adapter.single_action_space, gym.spaces.Box)
    assert adapter.single_action_space.shape == (17,)
    assert adapter.metadata["autoreset_mode"] == gym.vector.AutoresetMode.SAME_STEP

    obs, infos = adapter.reset(seed=0)
    assert obs.shape == (4, adapter.venv.n_obs)
    assert adapter.observation_space.contains(obs)
    assert infos == {}

    acts = np.stack([adapter.single_action_space.sample() for _ in range(4)])
    obs, rew, term, trunc, infos = adapter.step(acts)
    assert obs.shape == (4, adapter.venv.n_obs)
    assert rew.shape == term.shape == trunc.shape == (4,)
    assert rew.dtype == np.float32
    assert term.dtype == bool and trunc.dtype == bool
    assert not trunc.any()
    for k in ("e_loss", "penalty", "n_iter", "diff"):
        assert infos[k].shape == (4,)
    assert infos["n_iter"].dtype == np.int32


def test_matches_direct_vecenv(adapter):
    """Same seed + same actions == driving ``step_autoreset_batch`` directly
    from a generator seeded alike."""
    obs_a, _ = adapter.reset(seed=123)
    env = adapter.venv
    g = torch.Generator().manual_seed(123)
    state, obs_d = env.reset(4, g)
    np.testing.assert_array_equal(obs_a, obs_d.numpy())

    rng = np.random.default_rng(7)
    lo, hi = env.action_low.numpy(), env.action_high.numpy()
    for _ in range(5):
        acts = np.broadcast_to(rng.uniform(lo, hi).astype(lo.dtype), (4, env.n_action))
        obs_a, rew_a, term_a, _, _ = adapter.step(acts)
        state, obs_d, rew_d, term_d, _ = env.step_autoreset_batch(state, torch.tensor(acts), g)
        np.testing.assert_array_equal(obs_a, obs_d.numpy())
        np.testing.assert_array_equal(rew_a, rew_d.numpy())
        np.testing.assert_array_equal(term_a, term_d.numpy())


def test_unseeded_resets_differ():
    """Unseeded resets draw anew (the multicap hour of day is the drawn
    carry); an explicit seed reproduces across instances."""
    ad = GymVectorEnv(make_ieee33_multicap_task(), num_envs=2, seed=5, device="cpu")
    ad.reset()
    h1 = ad.state.task.clone()
    ad.reset()
    h2 = ad.state.task.clone()
    assert not torch.equal(h1, h2)
    o3, _ = ad.reset(seed=5)
    ad2 = GymVectorEnv(make_ieee33_multicap_task(), num_envs=2, device="cpu")
    o4, _ = ad2.reset(seed=5)
    assert torch.equal(ad.state.task, ad2.state.task)
    np.testing.assert_array_equal(o3, o4)


def test_next_step_mode_semantics():
    """NEXT_STEP: the terminating step returns the zero terminal obs; the
    FOLLOWING step resets the lane (reward 0, terminations False, fresh obs)
    whatever the action passed for it."""
    ad = GymVectorEnv(make_anm6easy_task(), num_envs=16, autoreset_mode="NextStep", device="cpu")
    assert ad.metadata["autoreset_mode"] == gym.vector.AutoresetMode.NEXT_STEP
    ad.reset(seed=3)
    lo, hi = ad.venv.action_low.numpy(), ad.venv.action_high.numpy()
    rng = np.random.default_rng(11)

    prev_term = np.zeros(16, bool)
    saw_done = saw_reset = False
    for _ in range(40):
        obs, rew, term, trunc, infos = ad.step(bang_bang(rng, lo, hi, 16))
        assert "final_obs" not in infos
        for i in np.flatnonzero(prev_term):
            saw_reset = True
            assert not term[i]
            assert rew[i] == 0.0
            assert np.any(obs[i] != 0.0), "reset obs expected, got terminal zeros"
        for i in np.flatnonzero(term):
            saw_done = True
            np.testing.assert_array_equal(obs[i], np.zeros(ad.venv.n_obs))
            c2 = ad.venv.costs_clipping[1]
            np.testing.assert_allclose(rew[i], -c2 / (1 - ad.venv.task.gamma), rtol=1e-5)
        prev_term = term.copy()
    assert saw_done and saw_reset, "expected collapsed and reset lanes in 40 steps"


def test_disabled_mode_absorbs():
    """DISABLED: terminated lanes absorb (zero obs, reward 0, terminations
    stays True) until the whole farm is reset."""
    ad = GymVectorEnv(make_anm6easy_task(), num_envs=16, autoreset_mode=gym.vector.AutoresetMode.DISABLED,
                      device="cpu")
    ad.reset(seed=3)
    lo, hi = ad.venv.action_low.numpy(), ad.venv.action_high.numpy()
    rng = np.random.default_rng(11)

    stuck = np.zeros(16, bool)
    for _ in range(40):
        obs, rew, term, trunc, _ = ad.step(bang_bang(rng, lo, hi, 16))
        assert term[stuck].all()
        assert (obs[stuck] == 0.0).all() and (rew[stuck] == 0.0).all()
        stuck |= term
    assert stuck.any(), "expected at least one collapsed lane in 40 steps"
    obs, _ = ad.reset(seed=4)
    assert np.any(obs[stuck] != 0.0, axis=1).all()
    assert not ad.state.terminated.any()


def test_wrapper_ecosystem_composes():
    """Gymnasium's stateful vector wrappers (which require NEXT_STEP) compose
    over the adapter: normalize obs + reward, clip actions, record episode
    statistics, over a task whose lanes genuinely terminate."""
    from gymnasium.wrappers.vector import ClipAction, NormalizeObservation, NormalizeReward, RecordEpisodeStatistics

    ad = GymVectorEnv(make_anm6easy_task(), num_envs=8, autoreset_mode="NextStep", device="cpu")
    env = RecordEpisodeStatistics(NormalizeReward(NormalizeObservation(ClipAction(ad))))
    obs, _ = env.reset(seed=3)
    assert obs.shape == (8, ad.venv.n_obs)
    lo, hi = ad.venv.action_low.numpy(), ad.venv.action_high.numpy()
    rng = np.random.default_rng(11)

    episodes = 0
    for _ in range(50):
        # Out-of-box actions: ClipAction must clip them back into the box.
        acts = np.where(rng.random((8, ad.venv.n_action)) < 0.5, 2 * lo, 2 * hi).astype(lo.dtype)
        obs, rew, term, trunc, infos = env.step(acts)
        assert np.isfinite(obs).all() and np.isfinite(rew).all()
        if "episode" in infos:
            episodes += int(infos["_episode"].sum())
            assert np.isfinite(infos["episode"]["r"][infos["_episode"]]).all()
    assert episodes > 0, "RecordEpisodeStatistics saw no completed episodes"


@pytest.mark.parametrize("task_fn,mode", [(make_ieee33_multicap_task, "NextStep"), (make_anm6easy_task, "SameStep"),
                                          (make_anm6easy_task, "NextStep")])
def test_devices_split_farm_matches_whole(task_fn, mode):
    """devices=: the farm split over two devices equals the whole farm bit
    for bit (every draw is the whole farm's), through resets of collapsed
    lanes on ANM6Easy; num_envs must be a multiple of the device count."""
    task = task_fn()
    split = GymVectorEnv(task, num_envs=16, devices=["cpu", "cpu"], autoreset_mode=mode, device="cpu")
    whole = GymVectorEnv(task, num_envs=16, autoreset_mode=mode, device="cpu")
    o_s, _ = split.reset(seed=7)
    o_w, _ = whole.reset(seed=7)
    np.testing.assert_array_equal(o_s, o_w)
    assert len(split.state) == 2 and split.state[0].soc.shape[0] == 8

    rng = np.random.default_rng(0)
    lo, hi = split.venv.action_low.numpy(), split.venv.action_high.numpy()
    n_done = 0
    for _ in range(12):
        acts = bang_bang(rng, lo, hi, 16) if task_fn is make_anm6easy_task else \
            (lo + (0.4 + 0.2 * rng.random((16, lo.shape[0]))) * (hi - lo)).astype(np.float32)
        o_s, r_s, t_s, _, i_s = split.step(acts)
        o_w, r_w, t_w, _, i_w = whole.step(acts)
        np.testing.assert_array_equal(t_s, t_w)
        np.testing.assert_array_equal(o_s, o_w)
        np.testing.assert_array_equal(r_s, r_w)
        np.testing.assert_array_equal(i_s["n_iter"], i_w["n_iter"])
        n_done += int(t_w.sum())
    if task_fn is make_anm6easy_task:
        assert n_done > 0, "expected collapsed lanes under bang-bang actions"

    with pytest.raises(ValueError, match="multiple of"):
        GymVectorEnv(task, num_envs=12, devices=["cpu"] * 8, device="cpu")


def test_same_step_final_obs_on_collapse():
    """Bang-bang actions collapse ANM6Easy lanes; the step where a lane
    terminates returns the RESET obs with the zero terminal obs in
    infos['final_obs'] (SAME_STEP convention)."""
    ad = GymVectorEnv(make_anm6easy_task(), num_envs=16, device="cpu")
    ad.reset(seed=3)
    lo, hi = ad.venv.action_low.numpy(), ad.venv.action_high.numpy()
    rng = np.random.default_rng(11)

    saw_done = False
    for _ in range(40):
        obs, rew, term, trunc, infos = ad.step(bang_bang(rng, lo, hi, 16))
        if term.any():
            saw_done = True
            np.testing.assert_array_equal(infos["_final_obs"], term)
            for i in np.flatnonzero(term):
                np.testing.assert_array_equal(infos["final_obs"][i], np.zeros(ad.venv.n_obs))
                assert infos["final_info"][i] == {}
                c2 = ad.venv.costs_clipping[1]
                np.testing.assert_allclose(rew[i], -c2 / (1 - ad.venv.task.gamma), rtol=1e-5)
                assert np.any(obs[i] != 0.0)
            for i in np.flatnonzero(~term):
                assert infos["final_obs"][i] is None
        else:
            assert "final_obs" not in infos
    assert saw_done, "expected at least one collapsed lane in 40 steps"


@pytest.mark.parametrize("mode", ["Disabled", "SameStep"])
def test_f64_parity_with_jax_adapter(mode):
    """ANM6Easy at float64 from JAX's reset state: both adapters step with the
    same actions (bang-bang on half the lanes, so some collapse) and agree on
    obs, reward, terminations and infos at 1e-8.  Under SAME_STEP the
    collapsed lanes' resets draw from different generators, so from then on
    those lanes are compared no further."""
    B = 16
    jad = JGymVectorEnv(j_make_anm6easy_task(), num_envs=B, dtype=jnp.float64, autoreset_mode=mode)
    tad = GymVectorEnv(make_anm6easy_task(), num_envs=B, dtype=torch.float64, autoreset_mode=mode, device="cpu")
    o_j, _ = jad.reset(seed=2)
    tad.reset(seed=2)
    tad.state = state_from_jax(jax.device_get(jad.state), device="cpu")
    lo, hi = tad.venv.action_low.numpy(), tad.venv.action_high.numpy()
    rng = np.random.default_rng(5)
    live = np.ones(B, bool)
    n_done = 0
    for t in range(24):
        acts = rng.uniform(lo, hi, (B, lo.shape[0]))
        acts[: B // 2] = bang_bang(rng, lo, hi, B // 2)
        o_j, r_j, t_j, _, i_j = jad.step(acts)
        o_t, r_t, t_t, _, i_t = tad.step(acts)
        np.testing.assert_array_equal(t_t[live], t_j[live], err_msg=f"step {t}")
        np.testing.assert_allclose(r_t[live], r_j[live], rtol=0, atol=ATOL, err_msg=f"step {t} reward")
        ok = live & ~t_j  # a diverged load flow's costs and residual carry no digits
        for k in ("e_loss", "penalty", "diff"):
            np.testing.assert_allclose(i_t[k][ok], i_j[k][ok], rtol=0, atol=ATOL, err_msg=f"step {t} {k}")
        np.testing.assert_array_equal(i_t["n_iter"][ok], i_j["n_iter"][ok])
        n_done += int(t_j[live].sum())
        if mode == "SameStep":
            live &= ~t_j
        np.testing.assert_allclose(o_t[live], o_j[live], rtol=0, atol=ATOL, err_msg=f"step {t} obs")
    assert n_done > 0, "expected collapsed lanes"
