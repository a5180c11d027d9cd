"""Quick smoke test of the offline dataset pipeline (2 controllers, tiny).

    python -m gym_anm_torch.scripts.quick_dataset_test [--cpu]

Port of ``scripts/quick_dataset_test.py``, the equivalent of the
reference's repo-root ``quick_dataset_test.py:1-28``: the Simple L0 and L5
controllers of :mod:`.generate_final_offline_datasets` for two episodes of
20 steps on :class:`~gym_anm_torch.compat.IEEE33ProperEnvironment`, whose
float64 transition runs on the CUDA card, or on the CPU with ``--cpu``;
without a card and without ``--cpu`` it raises.
"""

import argparse

import numpy as np

from .generate_final_offline_datasets import SimpleL0_Random, SimpleL5_Optimal, collect_episode_data
from .train_ppo_online import device_for


def quick_test(device="cuda"):
    """Returns {controller name: its data dict}."""
    from ..compat import IEEE33ProperEnvironment

    print("QUICK DATASET GENERATION TEST")
    print("=" * 50)
    env = IEEE33ProperEnvironment(device=device)
    out = {}
    for controller in (SimpleL0_Random(), SimpleL5_Optimal()):
        print(f"\nTesting {controller.name}...")
        data = collect_episode_data(env, controller, num_episodes=2, steps=20)
        print(f"  Transitions: {len(data['rewards'])}")
        print(f"  Avg return: {np.mean(data['episode_returns']):.4f}")
        print(f"  Reward range: [{data['rewards'].min():.4f}, {data['rewards'].max():.4f}]")
        out[controller.name] = data
    print("\nQuick test complete.")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return quick_test(device_for(ap.parse_args(argv).cpu))


if __name__ == "__main__":
    main()
