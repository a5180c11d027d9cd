"""Offline-RL dataset collection over whole lane batches.

Port of ``gym_anm_tpu/offline_vec.py``: controllers drive a batched
:class:`~gym_anm_torch.vec.VecEnv` and every transition (obs, action,
reward, next_obs, done) is kept on the env's device, as tensors of shape
[steps, batch, ...].  Each action is clipped to the action box before the
step; with autoreset, a done lane's ``next_obs`` is its reset observation.

Randomness comes from one ``torch.Generator``: per step, L0's uniform draw
[batch, n_action] (:func:`action_noise`, one draw for the whole batch, each
controller reading its own lanes' slice), then the env's exogenous variables
and resets.  The block and the mixed collectors therefore draw the same
numbers and give bit-identical trajectories under the same assignment.
"""

from typing import Optional, Sequence

import numpy as np
import torch

from .vec.controllers import Controller, make_l0
from .vec.core import VecEnv, tree_map

__all__ = ["action_noise", "generate_dataset_vec", "make_mixed_collector", "make_block_collector",
           "generate_mixed_dataset_vec", "behavior_cloning_vec", "evaluate_controller_vec"]


def action_noise(env: VecEnv, n: int, generator: Optional[torch.Generator]):
    """One step's uniform [0, 1) draw [n, n_action] of the env dtype, on the
    env's device (drawn on the generator's device)."""
    dev = env.device if generator is None else generator.device
    return torch.rand(n, env.n_action, generator=generator, dtype=env.dtype, device=dev).to(env.device)


def _start(env, batch, generator, start):
    if start is None:
        return env.reset(batch, generator)
    return start


def _stack(traj):
    return tuple(torch.stack(x) for x in zip(*traj))


def generate_dataset_vec(env: VecEnv, controller: Optional[Controller], generator, batch: int, steps: int,
                         autoreset: bool = True):
    """Collect (obs, action, reward, next_obs, done) for ``batch`` lanes ×
    ``steps`` steps under one controller (``None``: uniform-random, L0).
    Returns tensors of shape [steps, batch, ...]."""
    if controller is None:
        controller = make_l0(env)
    step = env.step_autoreset_batch if autoreset else env.step
    state, obs = env.reset(batch, generator)
    carry = controller.init_carry(batch)
    traj = []
    for _ in range(steps):
        action, carry = controller.act(action_noise(env, batch, generator), state, obs, carry)
        action = torch.clamp(action, env.action_low, env.action_high)
        state, obs2, r, d, _ = step(state, action, generator)
        traj.append((obs, action, r, obs2, d))
        obs = obs2
    return _stack(traj)


def make_mixed_collector(env: VecEnv, controllers: Sequence[Controller], batch: int, steps: int):
    """A reusable mixed-policy collector:

        collect(generator, assignment, start=None) -> traj

    with traj = (obs, action, reward, next_obs, done), each [steps, batch,
    ...].  ``assignment`` [batch] is the per-lane controller index; every
    controller acts on every lane and each lane takes its own controller's
    action.  ``start`` = (state, obs) of ``batch`` lanes replaces the reset.
    """

    def collect(generator, assignment, start=None):
        state, obs = _start(env, batch, generator, start)
        carries = [c.init_carry(batch) for c in controllers]
        pick = torch.as_tensor(assignment, device=env.device).long().view(1, batch, 1).expand(1, batch, env.n_action)
        traj = []
        for _ in range(steps):
            noise = action_noise(env, batch, generator)
            outs = [c.act(noise, state, obs, carries[i]) for i, c in enumerate(controllers)]
            carries = [o[1] for o in outs]
            action = torch.gather(torch.stack([o[0] for o in outs]), 0, pick)[0]
            action = torch.clamp(action, env.action_low, env.action_high)
            state, obs2, r, d, _ = env.step_autoreset_batch(state, action, generator)
            traj.append((obs, action, r, obs2, d))
            obs = obs2
        return _stack(traj)

    return collect


def make_block_collector(env: VecEnv, controllers: Sequence[Controller], batch: int, steps: int):
    """Block-assignment collector: lane block ``i`` (contiguous, ``batch //
    n`` lanes, the remainder to the last block) is driven by controller
    ``i``, which acts only on its own lanes.  Identical to
    :func:`make_mixed_collector` under the returned assignment.

        collect(generator, start=None) -> traj

    Returns ``(collect, assignment)``; traj as for the mixed collector.  This
    is the dataset-collection path of the L0-L5 suite.
    """
    n = len(controllers)
    sizes = [batch // n] * n
    sizes[-1] += batch - sum(sizes)
    starts = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
    blocks = [slice(int(starts[i]), int(starts[i + 1])) for i in range(n)]
    assignment = torch.as_tensor(np.repeat(np.arange(n), sizes), device=env.device)

    def collect(generator, start=None):
        state, obs = _start(env, batch, generator, start)
        carries = [c.init_carry(sizes[i]) for i, c in enumerate(controllers)]
        traj = []
        for _ in range(steps):
            noise = action_noise(env, batch, generator)
            parts = []
            for i, c in enumerate(controllers):
                sl = blocks[i]
                a_i, carries[i] = c.act(noise[sl], tree_map(lambda x: x[sl], state), obs[sl], carries[i])
                parts.append(a_i)
            action = torch.clamp(torch.cat(parts), env.action_low, env.action_high)
            state, obs2, r, d, _ = env.step_autoreset_batch(state, action, generator)
            traj.append((obs, action, r, obs2, d))
            obs = obs2
        return _stack(traj)

    return collect, assignment


def generate_mixed_dataset_vec(env: VecEnv, controllers: Sequence[Controller], generator, batch: int,
                               steps: int, weights: Optional[Sequence[float]] = None, assignment=None,
                               collector=None):
    """Mixed-policy dataset: each lane is assigned one controller, drawn
    with ``weights`` (uniform by default; with replacement, from
    ``generator``) or fixed by ``assignment`` [batch].  Pass a
    :func:`make_mixed_collector` as ``collector`` to reuse it.

    Returns (traj, assignment), traj = (obs, action, reward, next_obs, done)
    of shape [steps, batch, ...] and assignment the per-lane controller index.
    """
    n = len(controllers)
    if weights is None:
        probs = torch.full((n,), 1.0 / n)
    else:
        w = torch.as_tensor(weights, dtype=torch.float32)
        if w.shape[0] != n:
            raise ValueError("Length of weights must match number of controllers")
        probs = w / w.sum()
    if assignment is None:
        dev = env.device if generator is None else generator.device
        assignment = torch.multinomial(probs.to(dev), batch, replacement=True, generator=generator).to(env.device)
    else:
        assignment = torch.as_tensor(assignment, device=env.device).long()
        if tuple(assignment.shape) != (batch,):
            raise ValueError(f"assignment must have shape ({batch},)")
    if collector is None:
        collector = make_mixed_collector(env, controllers, batch, steps)
    return collector(generator, assignment), assignment


def _lstsq_min_norm(X, Y):
    """The minimum-norm least-squares solution of X·w = Y through an SVD,
    with ``jnp.linalg.lstsq(rcond=None)``'s cutoff: singular values below
    eps·max(M, N)·σ_max count as zero.  (On the card ``torch.linalg.lstsq``
    solves only full-rank systems (gels), and observations with all-zero
    columns are rank-deficient.)"""
    m, n = X.shape
    u, s, vt = torch.linalg.svd(X, full_matrices=False)
    rcond = torch.finfo(X.dtype).eps * max(n, m)
    mask = (s > 0) & (s >= rcond * s[0])
    safe_s = torch.where(mask, s, torch.ones_like(s))
    s_inv = torch.where(mask, 1 / safe_s, torch.zeros_like(s)).unsqueeze(1)
    return vt.T @ (s_inv * (u.T @ Y))


def behavior_cloning_vec(obs, actions, action_low, action_high):
    """Least-squares linear policy with bias.  Returns (policy, w) with
    ``policy(state_vec) = clip([state_vec, 1] @ w)``."""
    X = obs.reshape(-1, obs.shape[-1])
    Y = actions.reshape(-1, actions.shape[-1])
    X1 = torch.cat([X, torch.ones(X.shape[0], 1, dtype=X.dtype, device=X.device)], dim=1)
    w = _lstsq_min_norm(X1, Y.to(X.dtype))

    def policy(state_vec):
        ones = torch.ones(state_vec.shape[:-1] + (1,), dtype=state_vec.dtype, device=state_vec.device)
        return torch.clamp(torch.cat([state_vec, ones], dim=-1) @ w, action_low, action_high)

    return policy, w


def evaluate_controller_vec(env: VecEnv, controller: Controller, generator, batch: int, steps: int):
    """Mean per-step reward of a controller over a fresh batch."""
    _, _, rewards, _, _ = generate_dataset_vec(env, controller, generator, batch, steps)
    return float(torch.mean(rewards))
