"""Multi-process smoke worker: the learners over a real process group.

    python -m gym_anm_torch.scripts.multihost_smoke <rank> <world_size> <port> [--out FILE] [--cpu]

Joins the process group at ``tcp://localhost:<port>``: nccl on the rank's
card (card ``rank % device_count``, or ``LOCAL_RANK``), or gloo on the CPU
with ``--cpu``; without a card and without ``--cpu`` it raises.  The lanes
or rows split over the ranks:

* :func:`run_ppo`: two PPO train steps on the base IEEE33 task, B = 12
  lanes whose middle lane chunk (of three) crosses the rank boundary at
  two ranks, with a lane refresh whose period does not divide a rank's
  lanes;
* :func:`run_cql`: ``train_cql`` for five updates of 256 rows drawn from
  a numpy-made dataset (on the card, the last two replay its CUDA graph);
* :func:`run_mpc`: four steps of the ANM6Easy MPC farm (B = 16).

Prints ``RESULT <rank> <loss> <mean_reward>`` (PPO's global metrics, equal
on every rank) and, with ``--out``, saves the rank's results to FILE for
the distributed test, which runs the same functions in one process and
compares.
"""

import argparse
import sys

import numpy as np
import torch

from ..parallel import (CQLConfig, PPOConfig, init_distributed, init_train_state, make_train_step, shard_env_state,
                        train_cql, world)
from ..vec import VecEnv, make_anm6easy_task, make_ieee33_task, make_vec_mpc
from .train_ppo_online import device_for

PPO_CFG = PPOConfig(hidden=16, rollout_len=4, n_epochs=2, n_minibatches=2, n_lane_minibatches=3, refresh_interval=5)
PPO_LANES = 12


def _params(module):
    return {n: p.detach().cpu().clone() for n, p in module.named_parameters()}


def run_ppo(device):
    """Two train steps from a reset of all PPO_LANES lanes, sharded; returns
    the parameters and the last step's metrics."""
    rank, n_ranks = world()
    env = VecEnv(make_ieee33_task(), dtype=torch.float32, device=device)
    state, obs = env.reset(PPO_LANES)
    state, obs = shard_env_state((state, obs), rank, n_ranks)
    ts = init_train_state(1, env.n_state, env.n_action, PPO_CFG, device=device)
    step = make_train_step(env, PPO_CFG)
    for _ in range(2):
        ts, state, obs, metrics = step(ts, state, obs)
    return {"params": _params(ts.params), "metrics": {k: float(v) for k, v in metrics.items()}}


def cql_dataset():
    """1024 transitions of 6-dim observations and 3-dim actions, made from a
    seed (the offline schema of ``train_cql``)."""
    rng = np.random.RandomState(0)
    return {"states": rng.randn(1024, 6), "actions": np.clip(rng.randn(1024, 3), -1, 1), "rewards": rng.randn(1024),
            "next_states": rng.randn(1024, 6), "dones": rng.randint(0, 2, 1024)}


def run_cql(device):
    """Five ``train_cql`` updates of 256 rows, this rank's block of each;
    returns the parameters and the last update's metrics."""
    state, metrics, _ = train_cql(0, cql_dataset(), -np.ones(3), np.ones(3), CQLConfig(hidden=32), steps=5,
                                  batch_size=256, device=device)
    return {"params": _params(state.train.params), "metrics": {k: float(v) for k, v in metrics.items()}}


def run_mpc(device):
    """The MPC farm on this rank's lanes of one reset of all 16; returns its
    actions [4, lanes, A] and rewards [4, lanes] of four steps."""
    rank, n_ranks = world()
    env = VecEnv(make_anm6easy_task(), dtype=torch.float32, device=device)
    ctrl = make_vec_mpc(env, gamma=0.995, safety_margin=0.96, planning_steps=1)
    g = torch.Generator(device=device).manual_seed(0)
    state, obs = shard_env_state(env.reset(16, g), rank, n_ranks)
    carry = ctrl.init_carry(obs.shape[0])
    acts, rewards = [], []
    for _ in range(4):
        a, carry = ctrl.act(None, state, obs, carry)
        state, obs, r, _, _ = env.step_autoreset_batch(state, a, g)
        acts.append(a)
        rewards.append(r)
    return {"acts": torch.stack(acts).cpu(), "rewards": torch.stack(rewards).cpu()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("rank", type=int)
    ap.add_argument("world_size", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("--out", default=None, help="save the rank's results here (torch.save)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU over gloo")
    args = ap.parse_args(argv)
    torch.set_num_threads(2)
    if not args.cpu:
        device_for(False)  # raises without a card
    init_distributed(args.rank, args.world_size, args.port, backend="gloo" if args.cpu else "nccl")
    device = device_for(args.cpu)
    try:
        out = {"ppo": run_ppo(device), "cql": run_cql(device), "mpc": run_mpc(device)}
        m = out["ppo"]["metrics"]
        print(f"RESULT {args.rank} {m['loss']!r} {m['mean_reward']!r}", flush=True)
        if args.out:
            torch.save(out, args.out)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
