"""Collect an offline dataset from a mixture of expert policies.

    python -m gym_anm_torch.examples.offline_mixed [--cpu]

Port of ``examples/offline_mixed.py``: the full capacitor-bank expert
family (plus a random agent via ``None``) drives
``gym_anm_torch/IEEE33-v0``, with per-step agent sampling (from the global
``np.random``) under the given probability weights.  For at-scale
collection of the same kind on the card, see
:func:`gym_anm_torch.offline_vec.generate_mixed_dataset_vec`.
"""

import sys

import gymnasium as gym

from .. import compat  # noqa: F401  (registers gym_anm_torch/IEEE33-v0)
from ..offline import (AggressiveCapBankExpert, ConservativeCapBankExpert, DelayedCapBankExpert,
                       HysteresisCapBankExpert, LaggingCapBankExpert, NoisyCapBankExpert, SimpleCapBankExpert,
                       generate_mixed_dataset)
from ..scripts.train_ppo_online import device_for


def run(steps=10, device="cuda", seed=None):
    """``steps`` transitions; returns (states, actions)."""
    env = gym.make("gym_anm_torch/IEEE33-v0", device=device)
    if seed is not None:
        env.reset(seed=seed)
        env.action_space.seed(seed)
    experts = [
        SimpleCapBankExpert(env),
        ConservativeCapBankExpert(env),
        AggressiveCapBankExpert(env),
        NoisyCapBankExpert(env),
        DelayedCapBankExpert(env),
        LaggingCapBankExpert(env),
        HysteresisCapBankExpert(env),
    ]
    agents = [None] + experts  # None = uniform-random actions
    weights = [0.15, 0.2, 0.1, 0.1, 0.1, 0.15, 0.1, 0.1]

    states, actions = generate_mixed_dataset(env, agents, steps=steps, weights=weights)
    print(f"collected {len(states)} transitions, "
          f"state dim {states.shape[1]}, action dim {actions.shape[1]}")
    return states, actions


if __name__ == "__main__":
    run(device=device_for("--cpu" in sys.argv[1:]))
