"""Reproduce the reference's headline L0-L5 controller-quality table.

    python -m gym_anm_torch.scripts.l0l5_quality_table [--steps 300] [--seed 0]
        [--skip-reference] [--reference DIR] [--cpu]

Port of ``scripts/l0l5_quality_table.py``.  Runs the six "ready-to-use"
hierarchy controllers (``ready_to_use_l5_implementation.py:440-466``
protocol: fresh ``IEEE33ProperEnvironment(load_scale=0.9)``, fixed seed,
constant loads) for ``--steps`` steps each, on both stacks:

* ours: :class:`gym_anm_torch.compat.IEEE33ProperEnvironment` (its float64
  transition on the CUDA card, or on the CPU with ``--cpu``; without a card
  and without ``--cpu`` it raises) with
  :mod:`gym_anm_torch.agents.ready_hierarchy`;
* reference: the upstream classes imported from the gym-anm checkout at
  ``--reference DIR``, with stand-ins for its optional dependencies
  (:func:`install_reference_stubs`).  Without ``--reference``, or when DIR
  is absent, the reference table is skipped and the script says so.

Prints the per-step average reward table (the reference README's expected
hierarchy is L5 ~ -1.05 > L3 ~ -1.56 > L1 ~ -3.40 > L2 ~ -4.83 > L4 ~ -70 >
L0 ~ -6000; README.md:70-78).  ``main(argv)`` returns {"ours": {level:
average}, "reference": the same or None}.
"""

import argparse
import importlib.util
import os
import sys
import types

import numpy as np

from .train_ppo_online import device_for, device_name

ORDER = ["L5", "L3", "L1", "L2", "L4", "L0"]  # best -> worst (README.md:70-78)
# The repository's scipy-backed cvxpy stand-in, used where cvxpy is missing.
MINICVXPY = os.path.join(os.path.dirname(__file__), "..", "..", "tests", "minicvxpy.py")


def run_controller(env, agent, steps, seed):
    np.random.seed(seed)
    env.reset(seed=seed)
    total, n = 0.0, 0
    for _ in range(steps):
        a = agent.act(env)
        a = np.clip(a, env.action_space.low, env.action_space.high)
        _, r, terminated, _, _ = env.step(a)
        total += r
        n += 1
        if terminated:
            env.reset()
    return total / n


def ours_table(steps, seed, device="cuda"):
    from ..agents import ready_hierarchy as rh
    from ..compat import IEEE33ProperEnvironment

    classes = {
        "L0": rh.L0_Random, "L1": rh.L1_BangBang, "L2": rh.L2_Proportional,
        "L3": rh.L3_Coordinated, "L4": rh.L4_Predictive,
        "L5": rh.L5_MathematicalOptimization,
    }
    out = {}
    for name, cls in classes.items():
        env = IEEE33ProperEnvironment(load_scale=0.9, device=device)
        out[name] = run_controller(env, cls(env), steps, seed)
    return out


def install_reference_stubs():
    """Make the upstream package importable without its optional
    dependencies: cvxpy (the repository's ``tests/minicvxpy.py`` where cvxpy
    is missing) and the rendering stack's ``websocket_server``,
    ``websocket`` and ``requests`` (empty modules)."""
    try:
        import cvxpy  # noqa: F401
    except ImportError:
        spec = importlib.util.spec_from_file_location("cvxpy", MINICVXPY)
        cvxpy = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(cvxpy)
        sys.modules["cvxpy"] = cvxpy
    for name in ("websocket_server", "websocket", "requests"):
        if name not in sys.modules:
            sys.modules[name] = types.ModuleType(name)
    if not hasattr(sys.modules["websocket_server"], "WebsocketServer"):
        sys.modules["websocket_server"].WebsocketServer = object
    if not hasattr(sys.modules["websocket"], "create_connection"):
        sys.modules["websocket"].create_connection = lambda *a, **k: None


def reference_table(steps, seed, path):
    """The table of the upstream classes at ``path``, or None when ``path``
    is None or absent."""
    if path is None or not os.path.isdir(path):
        return None
    install_reference_stubs()
    if path not in sys.path:
        sys.path.insert(0, path)
    import ready_to_use_l5_implementation as ref

    classes = {
        "L0": ref.L0_Random, "L1": ref.L1_BangBang, "L2": ref.L2_Proportional,
        "L3": ref.L3_Coordinated, "L4": ref.L4_Predictive,
        "L5": ref.L5_MathematicalOptimization,
    }
    out = {}
    for name, cls in classes.items():
        env = ref.IEEE33ProperEnvironment(load_scale=0.9)
        out[name] = run_controller(env, cls(env), steps, seed)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-reference", action="store_true")
    ap.add_argument("--reference", default=None, metavar="DIR",
                    help="the upstream gym-anm checkout (its ready_to_use_l5_implementation.py)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    device = device_for(args.cpu)

    ours = ours_table(args.steps, args.seed, device)
    ref = None
    if args.skip_reference:
        print("reference table skipped (--skip-reference)")
    else:
        ref = reference_table(args.steps, args.seed, args.reference)
        if ref is None:
            print(f"reference table skipped: no upstream checkout at {args.reference!r} (--reference DIR)")

    print(f"\nAvg reward/step over {args.steps} steps, seed {args.seed} "
          f"(IEEE33ProperEnvironment, load_scale=0.9, on {device} ({device_name(device)})):\n")
    print(f"{'level':<6}{'ours':>14}" + (f"{'reference':>14}" if ref else ""))
    for name in ORDER:
        row = f"{name:<6}{ours[name]:>14.4f}"
        if ref:
            row += f"{ref[name]:>14.4f}"
        print(row)
    ranked = sorted(ours, key=lambda k: ours[k], reverse=True)
    print(f"\nours ranking   : {' > '.join(ranked)}")
    print(f"README expected: {' > '.join(ORDER)}")
    return {"ours": ours, "reference": ref}


if __name__ == "__main__":
    main()
