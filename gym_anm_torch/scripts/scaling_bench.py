"""Weak-scaling benchmark of the env farm over ``torch.distributed`` ranks.

    python -m gym_anm_torch.scripts.scaling_bench [--per-device 1024] [--steps 32] [--cpu]
    python -m gym_anm_torch.scripts.scaling_bench --multihost N [--per-device 256] [--cpu]

Port of ``scripts/scaling_bench.py``.  Steps a fixed per-rank batch of base
IEEE33 lanes (float32, uniform-random actions, no autoreset) on W ranks at
once and reports the global env-steps/s and the weak-scaling efficiency
against W = 1.  Each W spawns W processes (``--worker``), which join one
process group (:func:`gym_anm_torch.parallel.init_distributed`): nccl with
one card a rank (card ``rank % device_count``), or gloo on the CPU with
``--cpu``; without a card and without ``--cpu`` it raises.  Every step
all-reduces the reward sum over the ranks
(:func:`gym_anm_torch.parallel.mesh.all_reduce_sum`), so every step crosses
the process boundary.  Each rank resets and draws its own lanes' actions
from its own generator.

W runs over 1, 2, 4, 8 up to the number of cards (1 with ``--cpu``), or up
to N with ``--multihost N`` (ranks then share cards where N exceeds them,
and with ``--cpu`` share the host's cores: the efficiency column then
measures contention, not interconnect scaling).  A rank times ``reps`` runs
of ``--steps`` steps after a warm-up run, with CUDA events after
``torch.cuda.synchronize()`` on the card (the host clock on the CPU).
Prints a table and a JSON line; ``main(argv)`` returns the JSON object.
"""

import argparse
import json
import os
import re
import socket
import subprocess
import sys
import time

import torch

from ..parallel import init_distributed, mesh
from ..vec import VecEnv, make_ieee33_task
from .train_ppo_online import device_for, on_card

REPS = 3
WORKER_TIMEOUT_S = 900


def rollout_rate(per_device, n_steps, device, seed, reps=REPS):
    """This rank's part of the global farm: ``per_device`` lanes stepped
    ``reps`` times ``n_steps`` steps after a warm-up run, the reward sum
    all-reduced over the ranks every step.  Returns the global env-steps/s
    (the world's lanes over this rank's time) and the last global reward
    sum."""
    rank, world_size = mesh.world()
    env = VecEnv(make_ieee33_task(), dtype=torch.float32, device=device)
    g = torch.Generator(device=env.device).manual_seed(seed + rank)
    state, _ = env.reset(per_device, g)
    lo, hi = env.action_low, env.action_high
    total = torch.zeros(1, dtype=torch.float32, device=env.device)

    def run():
        nonlocal state
        for _ in range(n_steps):
            u = torch.rand(per_device, env.n_action, generator=g, dtype=env.dtype, device=env.device)
            state, _, r, _, _ = env.step(state, lo + u * (hi - lo))
            total.copy_(r.sum().reshape(1))
            mesh.all_reduce_sum([total])

    run()  # warm-up
    if on_card(env.device):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            run()
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        dt = time.perf_counter() - t0
    return per_device * world_size * n_steps * reps / dt, float(total)


def worker(rank, world_size, port, per_device, n_steps, cpu):
    """One rank: join the group, run :func:`rollout_rate`, print ``SPS
    <rank> <env-steps/s> <reward sum>``."""
    torch.set_num_threads(2)
    if not cpu:
        device_for(False)  # raises without a card
    init_distributed(rank, world_size, port, backend="gloo" if cpu else "nccl")
    try:
        sps, total = rollout_rate(per_device, n_steps, device_for(cpu), seed=0)
        print(f"SPS {rank} {sps!r} {total!r}", flush=True)
    finally:
        torch.distributed.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(world_size, per_device, n_steps, cpu):
    """Spawn ``world_size`` ranks; returns rank 0's (env-steps/s, reward
    sum).  Every rank is waited for, and killed if it outlives the timeout."""
    port = str(_free_port())
    cmd = [sys.executable, "-m", "gym_anm_torch.scripts.scaling_bench", "--per-device", str(per_device),
           "--steps", str(n_steps)] + (["--cpu"] if cpu else [])
    root = os.path.join(os.path.dirname(__file__), "..", "..")
    procs = [subprocess.Popen(cmd + ["--worker", str(r), str(world_size), port], cwd=root, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world_size)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"a rank failed at world size {world_size}:\n{out[-2000:]}")
    m = re.search(r"SPS 0 (\S+) (\S+)", outs[0])
    if m is None:
        raise RuntimeError(f"rank 0 printed no rate:\n{outs[0][-2000:]}")
    return float(m.group(1)), float(m.group(2))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU")
    ap.add_argument("--per-device", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--multihost", type=int, default=0, metavar="N",
                    help="spawn 1..N ranks whatever the number of cards")
    ap.add_argument("--worker", nargs=3, type=int, metavar=("RANK", "WORLD", "PORT"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(*args.worker, args.per_device, args.steps, args.cpu)
        return None
    if args.per_device < 1 or args.steps < 1 or args.multihost < 0:
        ap.error("--per-device and --steps must be >= 1, --multihost >= 0")
    device = device_for(args.cpu)
    n_cards = 0 if args.cpu else torch.cuda.device_count()
    max_world = args.multihost or max(n_cards, 1)
    what = f"{n_cards} card(s), {torch.cuda.get_device_name(device)}" if on_card(device) else "the CPU (gloo)"
    print(f"weak scaling of base IEEE33 on {what}: per-rank batch {args.per_device}, "
          f"{args.steps} steps x {REPS} reps")
    if max_world > max(n_cards, 1):
        shared = "the host's cores" if args.cpu else f"{n_cards} card(s)"
        print(f"  NOTE: {max_world} ranks share {shared}: the efficiency column measures contention, not "
              "interconnect scaling")
    base, results = None, []
    for n in [w for w in (1, 2, 4, 8) if w <= max_world]:
        sps, total = run_world(n, args.per_device, args.steps, args.cpu)
        base = sps if base is None else base
        eff = sps / (base * n)
        results.append({"ranks": n, "steps_per_s": sps, "efficiency": eff, "reward_sum": total})
        print(f"  {n} rank(s): {sps:,.0f} env-steps/s  (weak-scaling efficiency {eff:.1%})")
    out = {"metric": "ieee33_weak_scaling", "device": what, "per_device_batch": args.per_device,
           "gate_80pct_at_2plus_ranks": all(r["efficiency"] >= 0.8 for r in results if r["ranks"] >= 2)
           if len(results) > 1 else None,
           "results": results}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
