"""Gymnasium ``VectorEnv`` adapter over the batched vec tier.

Port of ``gym_anm_tpu/vec/gym_vector.py``.  It wraps the batch-leading
:class:`~gym_anm_torch.vec.core.VecEnv` in the standard
``gymnasium.vector.VectorEnv`` API, so off-the-shelf RL tooling
(SB3-style training loops, CleanRL scripts, Gymnasium vector wrappers) can
drive the farm on the card without writing any torch.

All three Gymnasium autoreset conventions are supported (pass
``autoreset_mode=``):

* ``SAME_STEP`` (default): on the step where a lane terminates, the
  returned observation is the RESET observation of the new episode, and
  the terminal observation (the reference's zero vector,
  anm_env.py:444-448) rides in ``infos["final_obs"]`` with the usual
  ``_final_obs`` mask.
* ``NEXT_STEP``: the terminating step returns the terminal observation
  itself; the lane resets on the FOLLOWING step (its action is ignored,
  reward 0, terminations False).  This is the mode Gymnasium's stateful
  vector wrappers (``NormalizeObservation``, ``NormalizeReward``, ...)
  require, so the wrapper ecosystem composes over this adapter.
* ``DISABLED``: terminated lanes absorb (zero observation, reward 0,
  ``terminations`` stays True) until ``reset()`` is called on the whole
  farm: the batched tier's native absorbing semantics.

Rewards/terminations are the reference MDP's (terminal reward -c2/(1-gamma),
reward clipping, <=100 reset retries) in every mode.

Host crossing: each ``step`` moves the actions to each device as one tensor
and reads obs, reward, done and info back in one copy per device.  The
host learns which lanes are done from that copy, so autoreset adds no
device synchronisation of its own: in ``NEXT_STEP`` the lanes to reset are
the previous step's, already on the host; in ``SAME_STEP`` the done lanes
are reset after the read-back, and their fresh observations are read in a
second copy on the steps where a lane terminated.  A reset's own retry loop
(:meth:`VecEnv.reset`) checks on the host whether any lane still diverges.

Seeding differs from the JAX package's: there every lane carries its own
PRNG key (``farm_keys``, with the ``rng_impl`` choice), which the port does
not carry.  Here one ``torch.Generator`` on the first device, seeded from
``seed`` and the reset counter, draws every random number of the farm, all
lanes at once, so a lane's draws depend on the farm's size.
"""

from __future__ import annotations

import dataclasses

import gymnasium as gym
import numpy as np
import torch
from gymnasium.vector import AutoresetMode, VectorEnv
from gymnasium.vector.utils import batch_space

from ..parallel.mesh import lane_slice
from .core import EnvState, VecEnv as _VecEnv, tree_map

__all__ = ["GymVectorEnv"]


def _np_dtype(dtype):
    return torch.empty(0, dtype=dtype).numpy().dtype


def _to_host(tensors):
    """The [B, ...] tensors of one device as host numpy arrays, at their
    dtypes, read in one device-to-host copy."""
    parts = [t.reshape(t.shape[0], -1) for t in tensors]
    flat = torch.cat([p.to(torch.float64) for p in parts], dim=1).cpu().numpy()
    out, i = [], 0
    for t, p in zip(tensors, parts):
        w = p.shape[1]
        out.append(flat[:, i: i + w].astype(_np_dtype(t.dtype)).reshape(t.shape))
        i += w
    return out


def _lane_block_task(task, block: slice, n_lanes: int):
    """``task`` for the lanes ``block`` of a farm of ``n_lanes``: its
    ``next_vars_fn`` runs on the whole farm (the block's rows in place, zeros
    elsewhere), so it draws what the whole farm draws, and returns the
    block's rows."""

    def pad(x):
        full = torch.zeros((n_lanes,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        full[block] = x
        return full

    def next_vars_fn(generator, s_t, carry, t):
        vars, carry = task.next_vars_fn(generator, pad(s_t), tree_map(pad, carry), pad(t))
        return vars[block], tree_map(lambda x: x[block], carry)

    return dataclasses.replace(task, next_vars_fn=next_vars_fn)


class GymVectorEnv(VectorEnv):
    """A ``gymnasium.vector.VectorEnv`` view of a batched :class:`VecEnv`.

    Parameters
    ----------
    task : VecTask | VecEnv
        A task factory result (e.g. ``make_ieee33_multicap_task()``) or an
        already-constructed :class:`VecEnv` (then on one device).
    num_envs : int
        Number of parallel lanes.
    dtype : torch dtype
        Compute precision when ``task`` is a :class:`VecTask` (float32 for
        throughput, float64 for parity-grade numerics).
    seed : int
        Default RNG seed; ``reset(seed=None)`` advances an internal counter
        from it so successive unseeded resets differ.
    obs : str | list
        Observation spec forwarded to :class:`VecEnv` when ``task`` is a
        :class:`VecTask`: ``"state"`` or compat-style
        ``(variable, ids[, unit])`` triples.
    autoreset_mode : AutoresetMode | str
        ``SAME_STEP`` (default), ``NEXT_STEP``, or ``DISABLED``; see the
        module docstring.  Strings accept the enum values
        (``"SameStep"``/``"NextStep"``/``"Disabled"``).
    device : str | torch.device
        Where the farm runs: the card by default.
    devices : list | None
        Split the lanes over these devices of one process, the counterpart
        of the JAX package's ``mesh=``: lane block ``i``
        (``parallel.mesh.lane_slice(num_envs, i, len(devices))``) runs in a
        :class:`VecEnv` on ``devices[i]``, and the outputs are concatenated
        on the host.  ``num_envs`` must be a multiple of ``len(devices)``.
        Resets are drawn for the whole farm on ``devices[0]`` and sliced, and
        each block's exogenous draws are the whole farm's rows, so the split
        farm equals the whole one.
    """

    metadata = {"autoreset_mode": AutoresetMode.SAME_STEP, "render_modes": []}
    render_mode = None

    def __init__(self, task, num_envs: int, dtype=torch.float32, seed: int = 0, obs="state",
                 autoreset_mode=AutoresetMode.SAME_STEP, device="cuda", devices=None):
        self.num_envs = int(num_envs)
        if isinstance(task, _VecEnv):
            if devices is not None:
                raise ValueError("devices= needs a VecTask: a VecEnv lives on one device")
            self._venvs = [task]
        else:
            devices = [device] if devices is None else list(devices)
            if self.num_envs % len(devices):
                raise ValueError(f"num_envs={num_envs} must be a multiple of len(devices)={len(devices)}")
            self._slices = [lane_slice(self.num_envs, i, len(devices)) for i in range(len(devices))]
            tasks = [task] if len(devices) == 1 else [_lane_block_task(task, s, self.num_envs)
                                                      for s in self._slices]
            self._venvs = [_VecEnv(t, dtype=dtype, obs=obs, device=d) for t, d in zip(tasks, devices)]
        if len(self._venvs) == 1:
            self._slices = [slice(0, self.num_envs)]
        self.venv = self._venvs[0]
        self.autoreset_mode = AutoresetMode(autoreset_mode)
        # Per-instance metadata: wrappers read the mode from here.
        self.metadata = {**type(self).metadata, "autoreset_mode": self.autoreset_mode}
        self._seed0 = int(seed)
        self._reset_count = 0
        self._gen = torch.Generator(device=self.venv.device)
        self._states = None
        self._pending = np.zeros(self.num_envs, bool)  # NEXT_STEP: lanes to reset on the next step

        np_dtype = _np_dtype(self.venv.dtype)
        host = lambda t: t.cpu().numpy().astype(np_dtype)  # noqa: E731
        self.single_observation_space = gym.spaces.Box(
            low=host(self.venv.obs_low), high=host(self.venv.obs_high), dtype=np_dtype)
        self.single_action_space = gym.spaces.Box(
            low=host(self.venv.action_low), high=host(self.venv.action_high), dtype=np_dtype)
        self.observation_space = batch_space(self.single_observation_space, num_envs)
        self.action_space = batch_space(self.single_action_space, num_envs)

    # ------------------------------------------------------------------
    @property
    def state(self):
        """The farm's :class:`EnvState` on the device (advanced use): one
        state, or a list of the blocks' states under ``devices=``.  Setting a
        whole farm's state (e.g. one carried over with
        ``convert.state_from_jax``) splits it over the devices."""
        if self._states is None or len(self._states) > 1:
            return self._states
        return self._states[0]

    @state.setter
    def state(self, state: EnvState):
        self._split(state)
        self._pending = state.terminated.cpu().numpy().copy()

    def _split(self, state: EnvState):
        self._states = [tree_map(lambda x: x[s].to(v.device), state) for s, v in zip(self._slices, self._venvs)]

    def _blocks(self, idx):
        """For each device holding some of the farm's lanes ``idx`` (sorted
        host indices): its position, its venv, the lanes' indices in its
        block and their positions in ``idx`` (on the first device)."""
        for k, (s, v) in enumerate(zip(self._slices, self._venvs)):
            mine = (idx >= s.start) & (idx < s.stop)
            if mine.any():
                yield (k, v, torch.as_tensor(idx[mine] - s.start, device=v.device),
                       torch.as_tensor(np.flatnonzero(mine), device=self.venv.device))

    def _reset_lanes(self, idx):
        """Reset the farm's lanes ``idx`` in place, drawn for all of them at
        once on the first device; they keep their taps and their shaping
        carry.  Returns their fresh observations on the first device."""
        blocks = list(self._blocks(idx))
        taps = torch.cat([self._states[k].oltc_tap[local].to(self.venv.device) for k, _, local, _ in blocks])
        fresh, fresh_obs = self.venv.reset(len(idx), self._gen, oltc_tap=taps)
        for k, v, local, rows in blocks:
            put = lambda full, part: full.index_copy(0, local, part[rows].to(v.device))  # noqa: E731
            st = self._states[k]
            self._states[k] = EnvState(**{name: tree_map(put, getattr(st, name), getattr(fresh, name))
                                          for name in EnvState._fields if name != "shaping"},
                                       shaping=st.shaping)
        return fresh_obs

    # ------------------------------------------------------------------
    def reset(self, *, seed: int | None = None, options: dict | None = None):
        if seed is None:
            seed = self._seed0 + self._reset_count
        self._reset_count += 1
        self._gen.manual_seed(int(seed))
        state, obs = self.venv.reset(self.num_envs, self._gen)
        obs_np, self._pending = _to_host([obs, state.terminated])
        self._split(state)
        return obs_np, {}

    def step(self, actions):
        if self._states is None:
            raise RuntimeError("call reset() before step()")
        acts = torch.tensor(np.asarray(actions), dtype=self.venv.dtype)
        # Under devices= every block draws the whole farm's exogenous
        # variables from the same generator state (_lane_block_task).
        g0 = self._gen.get_state() if len(self._venvs) > 1 else None
        outs = []
        for s, v, st in zip(self._slices, self._venvs, self._states):
            if g0 is not None:
                self._gen.set_state(g0)
            outs.append(list(v.step(st, acts[s].to(v.device), self._gen)))
        self._states = [o[0] for o in outs]

        mode = self.autoreset_mode
        pending = np.flatnonzero(self._pending) if mode == AutoresetMode.NEXT_STEP else np.zeros(0, np.int64)
        if pending.size:
            # NEXT_STEP: the lanes whose previous step terminated reset now.
            fresh_obs = self._reset_lanes(pending)
            for k, v, local, rows in self._blocks(pending):
                outs[k][1] = outs[k][1].index_copy(0, local, fresh_obs[rows].to(v.device))

        keys = list(outs[0][4].keys())
        host = [_to_host([o[1], o[2], o[3]] + [o[4][k] for k in keys]) for o in outs]
        obs_np, reward_np, done_np, *info_np = (np.concatenate(parts) for parts in zip(*host))
        terminations = done_np.astype(bool)
        truncations = np.zeros(self.num_envs, dtype=bool)
        infos: dict = dict(zip(keys, info_np))

        if mode == AutoresetMode.NEXT_STEP:
            # Gymnasium's NEXT_STEP convention for the reset step: reward 0,
            # terminations False (the fresh episode has not stepped yet).
            reward_np[pending] = 0.0
            terminations[pending] = False
            self._pending = terminations.copy()
        elif mode == AutoresetMode.SAME_STEP and terminations.any():
            idx = np.flatnonzero(terminations)
            obs_np[idx] = _to_host([self._reset_lanes(idx)])[0]
            # SAME_STEP convention: the terminal observation (the
            # reference's zero vector) and a per-lane final info, masked.
            final_obs = np.full(self.num_envs, None, dtype=object)
            final_info = np.full(self.num_envs, None, dtype=object)
            zero = np.zeros(self.venv.n_obs, dtype=obs_np.dtype)
            for i in idx:
                final_obs[i] = zero.copy()
                final_info[i] = {}
            infos["final_obs"] = final_obs
            infos["_final_obs"] = terminations.copy()
            infos["final_info"] = final_info
            infos["_final_info"] = terminations.copy()

        return obs_np, reward_np, terminations, truncations, infos

    def close_extras(self, **kwargs):
        self._states = None
