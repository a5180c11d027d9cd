"""Online RL: data-parallel PPO over the IEEE33 env farm.

    python -m gym_anm_torch.scripts.train_ppo_online [--lanes 512] [--iters 50]
        [--rollout 16] [--task ieee33|multicap] [--epochs 1] [--minibatches 1]
        [--lane-minibatches 1] [--refresh-interval 0] [--save DIR] [--eval] [--cpu]

Runs on the CUDA card (float32), or on the CPU with ``--cpu``; without a
card and without ``--cpu`` it raises.  In a process that has joined a
``torch.distributed`` process group (:func:`gym_anm_torch.parallel.
init_distributed`), the ``--lanes`` lanes split over the ranks.  Prints the
loss and mean reward every tenth of the run, the train loop's env-steps/s,
and on the card the split of an iteration between rollout and update.
``main(argv)`` returns the run's record (see its docstring).
"""

import argparse
import sys
import time

import torch

from ..offline_vec import generate_dataset_vec
from ..parallel import PPOConfig, init_train_state, make_train_step, mesh
from ..parallel.ppo import policy_dist
from ..utils import Throughput, forbid_host_syncs, save_checkpoint
from ..vec import VecEnv, make_ieee33_multicap_task, make_ieee33_task
from ..vec.controllers import Controller, make_l0


def device_for(cpu: bool) -> str:
    """``"cpu"`` when asked for, else the current card, ``"cuda:<index>"``
    (the rank's, once :func:`~gym_anm_torch.parallel.init_distributed` has
    pinned it); raises without a card."""
    if cpu:
        return "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass --cpu to run on the CPU")
    return f"cuda:{torch.cuda.current_device()}"


def on_card(device: str) -> bool:
    return torch.device(device).type == "cuda"


def device_name(device: str) -> str:
    return torch.cuda.get_device_name(device) if on_card(device) else "host"


def policy_controller(name, policy):
    """A host policy ``obs -> action`` as a :class:`Controller`."""
    return Controller(name, lambda n: (), lambda noise, state, obs, carry: (policy(obs), carry))


def evaluate(env, controller, seed, lanes=256, steps=50):
    """The offline-evaluation protocol: mean per-step reward over fresh lanes
    without autoreset (a collapsed lane absorbs at 0 after its terminal
    penalty)."""
    g = torch.Generator(device=env.device).manual_seed(seed)
    rewards = generate_dataset_vec(env, controller, g, lanes, steps, autoreset=False)[2]
    return float(torch.mean(rewards))


class _Split:
    """Per-iteration rollout and update times: CUDA events on the card, the
    host clock on the CPU (whose work is synchronous)."""

    def __init__(self, device):
        self.cuda = on_card(device)
        self.marks = []

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def ms(self, a, b):
        if self.cuda:
            return a.elapsed_time(b)
        return 1e3 * (b - a)


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lanes", type=int, default=512, help="env lanes over all ranks")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--rollout", type=int, default=16)
    ap.add_argument("--task", choices=("ieee33", "multicap"), default="ieee33",
                    help="ieee33 = static base task; multicap = the 17-dim task with diurnal loads")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--minibatches", type=int, default=1, help="time-axis minibatches per epoch")
    ap.add_argument("--lane-minibatches", type=int, default=1, help="contiguous lane-axis minibatches per epoch")
    ap.add_argument("--refresh-interval", type=int, default=0,
                    help="rotating lane refresh: each train step, reset lanes with (lane+step) %% N == 0 (0 = off)")
    ap.add_argument("--save", metavar="DIR", default=None,
                    help="save the final TrainState (module + Adam moments) as DIR/step_<iters>.pt; restore "
                         "with gym_anm_torch.utils.restore_checkpoint")
    ap.add_argument("--eval", action="store_true",
                    help="after training, evaluate the deterministic policy (a = mu) against uniform-random "
                         "actions: 256 fresh lanes x 50 steps, no autoreset")
    ap.add_argument("--forbid-syncs", action="store_true",
                    help="run each update under torch.cuda.set_sync_debug_mode('error'): a host sync raises")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap


def main(argv=None):
    """Train; returns a dict: ``device``, ``lanes``, ``metrics`` (one dict of
    floats per iteration), ``env_steps_per_s``, ``rollout_ms`` and
    ``update_ms`` (means over iterations 1.., the warm-up excluded), ``checkpoint`` (the saved
    file or None), ``eval`` ({"ppo", "random"} or None), and the run's
    objects ``env``, ``train_step``, ``ts``, ``state``, ``obs`` and
    ``generator``."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.lanes < 1 or args.iters < 1:
        ap.error("--lanes and --iters must be >= 1")
    device = device_for(args.cpu)
    rank, world = mesh.world()
    lanes = mesh.lane_slice(args.lanes, rank, world)
    n_local = lanes.stop - lanes.start
    if rank == 0:
        print(f"{world} rank(s), {device} ({device_name(device)}), "
              f"batch {args.lanes}")

    factory = make_ieee33_task if args.task == "ieee33" else make_ieee33_multicap_task
    env = VecEnv(factory(), dtype=torch.float32, device=device)
    cfg = PPOConfig(rollout_len=args.rollout, n_epochs=args.epochs,
                    n_minibatches=args.minibatches, n_lane_minibatches=args.lane_minibatches,
                    refresh_interval=args.refresh_interval)
    g = torch.Generator(device=device).manual_seed(rank)  # the env's draws, per rank
    state, obs = env.reset(n_local, g)
    ts = init_train_state(1, env.n_state, env.n_action, cfg, device=device)
    step = make_train_step(env, cfg, seed=0)

    split, history = _Split(device), []
    clock = Throughput(device)
    t0 = time.perf_counter()
    for it in range(args.iters):
        if it == 1:
            clock.start()
        split.mark()
        state, obs, traj = step.collect(ts, state, obs, g)
        split.mark()
        with forbid_host_syncs(args.forbid_syncs):
            ts, metrics = step.update(ts, traj, step.permutations(ts.step))
        split.mark()
        history.append(metrics)
        if it == 0 and rank == 0:
            print(f"first iteration: {time.perf_counter() - t0:.1f} s")
        if it % max(1, args.iters // 10) == 0 or it == args.iters - 1:
            if rank == 0:
                print(f"iter {it:4d}  loss {float(metrics['loss']):+.4f}  reward {float(metrics['mean_reward']):+.4f}")
        if it >= 1:
            clock.add(args.lanes * args.rollout)
    rate = clock.steps_per_s  # synchronizes the card first
    m, timed = split.marks, range(1, args.iters) if args.iters > 1 else range(1)
    rollout_ms = sum(split.ms(m[3 * i], m[3 * i + 1]) for i in timed) / len(timed)
    update_ms = sum(split.ms(m[3 * i + 1], m[3 * i + 2]) for i in timed) / len(timed)
    stacked = {k: torch.stack([h[k] for h in history]).double().cpu().tolist() for k in history[0]}
    metrics = [{k: stacked[k][i] for k in stacked} for i in range(args.iters)]
    if rank == 0:
        print(f"throughput: {rate:,.1f} env-steps/s (train loop, iterations 1..{args.iters - 1}, {world} rank(s)); "
              f"iteration: rollout {rollout_ms:.3f} ms, update {update_ms:.3f} ms")

    checkpoint = None
    if args.save and rank == 0:
        checkpoint = save_checkpoint(args.save, ts, step=args.iters)
        print(f"checkpoint saved: {checkpoint}")

    result = None
    if args.eval:
        norm_obs, act_mid, act_half = step.norm_obs, step.act_mid, step.act_half

        def ppo_policy(o):
            with torch.no_grad():
                mu, _ = policy_dist(ts.params, norm_obs(o))
            if cfg.normalize_io:
                mu = torch.clamp(mu, -1.0, 1.0)
            return act_mid + mu * act_half

        result = {"ppo": evaluate(env, policy_controller("ppo", ppo_policy), 100),
                  "random": evaluate(env, make_l0(env), 100)}
        if rank == 0:
            print(f"eval (deterministic, no-autoreset absorb protocol): PPO {result['ppo']:+.4f}  "
                  f"random {result['random']:+.4f}  per step")

    return {"device": device, "lanes": args.lanes, "metrics": metrics, "env_steps_per_s": rate,
            "rollout_ms": rollout_ms, "update_ms": update_ms, "checkpoint": checkpoint, "eval": result,
            "env": env, "train_step": step, "ts": ts, "state": state, "obs": obs, "generator": g}


if __name__ == "__main__":
    main(sys.argv[1:])
