"""Benchmark the algorithmically-diverse L0-L5 controllers across scenarios.

    python -m gym_anm_torch.scripts.create_algorithmic_diversity [--steps 100] [--cpu]

Port of ``scripts/create_algorithmic_diversity.py``: run each controller of
the diversity set (:mod:`gym_anm_torch.agents.diversity_hierarchy`) on
``IEEE33ProperEnvironment`` at three load scales, report per-controller
average rewards and the best-to-worst performance gap.

The environment's float64 transition runs on the CUDA card, or on the CPU
with ``--cpu``; without a card and without ``--cpu`` it raises.  The
controllers are host numpy whichever it is.
"""

import argparse

import numpy as np

from ..agents import diversity_hierarchy as dh
from ..compat import IEEE33ProperEnvironment
from .train_ppo_online import device_for, device_name

CONTROLLERS = [
    ("L0_Random", dh.L0_Random),
    ("L1_BangBang", dh.L1_BangBang),
    ("L2_Proportional", dh.L2_Proportional),
    ("L3_PI", dh.L3_PI_Controller),
    ("L4_RuleBased", dh.L4_RuleBasedExpert),
    ("L5_ScipyOptimal", dh.L5_ScipyOptimal),
]

SCENARIOS = [
    ("light_load", 0.5),
    ("nominal_load", 1.0),
    ("evening_peak", 1.2),
]


def run(controller_cls, load_scale, steps, seed=0, device="cuda"):
    """Mean reward of ``controller_cls`` over ``steps`` steps of
    ``IEEE33ProperEnvironment(load_scale)`` on ``device``."""
    np.random.seed(seed)
    env = IEEE33ProperEnvironment(load_scale=load_scale, device=device)
    env.reset(seed=seed)
    agent = controller_cls(env)
    total = 0.0
    for _ in range(steps):
        a = np.clip(agent.act(env), env.action_space.low, env.action_space.high)
        _, r, term, trunc, _ = env.step(a)
        total += r
        if term:
            env.reset(seed=seed)
    return total / steps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    device = device_for(args.cpu)

    print("=" * 72)
    print(f"ALGORITHMIC DIVERSITY BENCHMARK on {device} ({device_name(device)})")
    print("=" * 72)

    results = {}
    for scen_name, scale in SCENARIOS:
        print(f"\nScenario: {scen_name} (load x{scale})")
        for name, cls in CONTROLLERS:
            avg = run(cls, scale, args.steps, device=device)
            results.setdefault(name, []).append(avg)
            print(f"  {name:<16} avg reward {avg:+.4f}")

    print("\n" + "=" * 72)
    print("OVERALL (mean across scenarios, best first)")
    print("=" * 72)
    overall = sorted(((np.mean(v), k) for k, v in results.items()), reverse=True)
    for avg, name in overall:
        print(f"  {name:<16} {avg:+.4f}")
    best, worst = overall[0][0], overall[-1][0]
    if worst != 0:
        print(f"\nBest-to-worst gap: {abs(worst / best):.1f}x" if best != 0 else "")
    return results


if __name__ == "__main__":
    main()
