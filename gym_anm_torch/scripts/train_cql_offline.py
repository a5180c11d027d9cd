"""End-to-end offline RL: collect a dataset on the device, train CQL, evaluate.

    python -m gym_anm_torch.scripts.train_cql_offline [--lanes 512] [--steps 50]
        [--train-steps 2000] [--cpu]

1. collect transitions from the L0-L5 controller suite on the batched
   IEEE33 multi-capacitor env (``--lanes`` lanes × ``--steps`` steps per
   controller, with autoreset);
2. train a Conservative Q-Learning policy on the mixed dataset
   (``CQLConfig(hidden=128, cql_weight=2.0)``, minibatches of 512);
3. evaluate the learned deterministic policy against uniform-random actions
   (L0) and the L5 controller: 256 fresh lanes × 50 steps without autoreset.

Runs on the CUDA card (float32), or on the CPU with ``--cpu``; without a
card and without ``--cpu`` it raises.  ``main(argv)`` returns the run's
record (see its docstring).
"""

import argparse
import sys
import time

import torch

from ..offline_vec import generate_dataset_vec
from ..parallel import CQLConfig, train_cql
from ..vec import VecEnv, make_ieee33_multicap_task
from ..vec.controllers import make_l0, make_suite
from .train_ppo_online import device_for, device_name, evaluate, on_card, policy_controller


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lanes", type=int, default=512)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--train-steps", type=int, default=2000)
    ap.add_argument("--forbid-syncs", action="store_true",
                    help="run each update under torch.cuda.set_sync_debug_mode('error'): a host sync raises")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap


def collect(env, lanes, steps):
    """The mixed dataset of the L0-L5 suite, flattened to transitions, on the
    env's device (controller i's rollout drawn from a generator seeded i)."""
    parts = []
    for i, ctrl in enumerate(make_suite(env)):
        g = torch.Generator(device=env.device).manual_seed(i)
        parts.append(generate_dataset_vec(env, ctrl, g, lanes, steps))
    flat = lambda k: torch.cat([p[k].reshape(-1, *p[k].shape[2:]) for p in parts])  # noqa: E731
    return {"states": flat(0), "actions": flat(1), "rewards": flat(2), "next_states": flat(3),
            "dones": flat(4).to(torch.float32)}


def main(argv=None):
    """Collect, train, evaluate; returns a dict: ``device``, ``transitions``,
    ``collect_s``, ``train_s``, ``updates_per_s``, ``metrics`` (the last
    update's, as floats), ``eval`` ({"cql", "random", "L5"} mean reward per
    step), and the run's objects ``env``, ``dataset``, ``state`` (the
    CQLState) and ``policy``."""
    args = parser().parse_args(argv)
    device = device_for(args.cpu)
    print(f"device: {device} ({device_name(device)})")
    env = VecEnv(make_ieee33_multicap_task(), dtype=torch.float32, device=device)

    print("Collecting mixed dataset...")
    t0 = time.perf_counter()
    dataset = collect(env, args.lanes, args.steps)
    n = dataset["rewards"].shape[0]
    collect_s = time.perf_counter() - t0
    print(f"  {n:,} transitions in {collect_s:.1f} s")

    print(f"Training CQL for {args.train_steps} steps...")
    cfg = CQLConfig(hidden=128, cql_weight=2.0)
    if on_card(device):
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics, policy = train_cql(42, dataset, env.action_low, env.action_high, cfg, steps=args.train_steps,
                                       batch_size=512, device=device, forbid_syncs=args.forbid_syncs)
    metrics = {k: float(v) for k, v in metrics.items()}  # waits for the last update
    train_s = time.perf_counter() - t0
    print(f"  done in {train_s:.1f} s ({args.train_steps / train_s:.1f} updates/s); final loss "
          f"{metrics['loss']:.3f}, bellman {metrics['bellman']:.3f}")

    print("Evaluating...")
    result = {"cql": evaluate(env, policy_controller("cql", policy), 100),
              "random": evaluate(env, make_l0(env), 100),
              "L5": evaluate(env, make_suite(env)[-1], 100)}
    for name, r in result.items():
        print(f"  {name:6s} policy: {r:+.4f} avg reward/step")
    print("CQL beats random." if result["cql"] > result["random"] else "WARNING: CQL below random.")
    return {"device": device, "transitions": n, "collect_s": collect_s, "train_s": train_s,
            "updates_per_s": args.train_steps / train_s, "metrics": metrics, "eval": result, "env": env,
            "dataset": dataset, "state": state, "policy": policy}


if __name__ == "__main__":
    main(sys.argv[1:])
