"""Drive the batched environment farm with standard Gymnasium tooling.

    python -m gym_anm_torch.examples.gym_vector_interop [--cpu]

Port of ``examples/gym_vector_interop.py``.  The vec tier's native
interface is batched torch tensors; this example shows the OTHER door:
``vec.GymVectorEnv`` exposes the same farm as a
``gymnasium.vector.VectorEnv``, so an off-the-shelf training loop (the
shape CleanRL / SB3-style scripts expect) runs against it unchanged,
including Gymnasium's stateful vector wrappers (which require the
``NextStep`` autoreset convention).  Needs ``gymnasium.wrappers.vector``.
"""

import sys

import numpy as np

from ..scripts.train_ppo_online import device_for


def run(num_envs=32, steps=60, seed=0, device="cuda"):
    """``steps`` steps of a noisy mid-box policy; returns (total reward,
    completed episodes)."""
    from gymnasium.wrappers.vector import ClipAction, NormalizeObservation, RecordEpisodeStatistics

    from ..vec import GymVectorEnv, make_ieee33_multicap_task

    # A 17-dim flagship-task farm behind the standard vector API.  (Pass
    # devices=[...] to spread the lanes over several cards with the same
    # code.)
    farm = GymVectorEnv(make_ieee33_multicap_task(), num_envs=num_envs, autoreset_mode="NextStep", device=device)
    envs = RecordEpisodeStatistics(NormalizeObservation(ClipAction(farm)))

    obs, _ = envs.reset(seed=seed)
    rng = np.random.default_rng(seed)
    # ClipAction widens the visible action space to (-inf, inf); read the
    # true MDP box from the underlying farm.
    lo = farm.single_action_space.low
    hi = farm.single_action_space.high

    total_reward, episodes = 0.0, 0
    for _ in range(steps):
        # Any policy that emits a [num_envs, act_dim] array works here; a
        # mildly noisy mid-box policy stands in for a learner.
        frac = 0.35 + 0.3 * rng.random((num_envs, lo.shape[0]))
        actions = (lo + frac * (hi - lo)).astype(np.float32)
        obs, rewards, terminations, truncations, infos = envs.step(actions)
        total_reward += float(rewards.sum())
        if "episode" in infos:
            episodes += int(infos["_episode"].sum())

    print(f"{num_envs} lanes x {steps} steps: total reward {total_reward:+.2f}, "
          f"{episodes} completed episodes, obs normalized to "
          f"mean {obs.mean():+.3f} / std {obs.std():.3f}")
    return total_reward, episodes


if __name__ == "__main__":
    run(device=device_for("--cpu" in sys.argv[1:]))
