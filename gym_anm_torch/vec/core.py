"""Vectorized environment engine, batch-leading.

Port of ``gym_anm_tpu/vec/core.py``.  The environment is a pair of plain
functions on tensors whose leading axis is the lane:

    reset(n, generator)            -> (EnvState, obs)
    step(EnvState, action, generator) -> (EnvState, obs, reward, done, info)

The MDP semantics (state layout, reward clipping, terminal handling,
reset-retry, autoreset) mirror the reference ``ANMEnv`` (anm_env.py:235-469).
Randomness, where a task has any, comes from an explicit
``torch.Generator``.  A task carry or a shaping carry is a tensor with the
lane on its first axis, a tuple of such carries, or ``()``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ..errors import ObsSpaceError
from ..physics.transition import GridTables, TransitionOut, make_tables, solution_guess, transition
from ..specs.network import NetworkSpec, load_network
from ..utils import profiling
from .obs import make_obs_plan


def tree_map(fn, *trees):
    """``fn`` over the tensors of carries of one structure (tensor, tuple or
    NamedTuple of carries, or ``()``); a NamedTuple, such as an
    :class:`EnvState`, keeps its type."""
    if isinstance(trees[0], tuple):
        leaves = [tree_map(fn, *group) for group in zip(*trees)]
        return type(trees[0])(*leaves) if hasattr(trees[0], "_fields") else tuple(leaves)
    return fn(*trees)


class EnvState(NamedTuple):
    """Per-lane carried state; every tensor has the lane on its first axis."""

    soc: torch.Tensor         # [B, n_des] p.u.
    oltc_tap: torch.Tensor    # [B, n_oltc] (persists across resets, like the ref)
    dev_p: torch.Tensor       # [B, n_dev] p.u.
    dev_q: torch.Tensor
    p_pot: torch.Tensor       # [B, n_gen] p.u.
    bus_vm: torch.Tensor      # [B, n_bus] voltage magnitudes
    aux: torch.Tensor         # [B, K]
    task: Any                 # task-specific carry (() when stateless)
    terminated: torch.Tensor  # [B] bool
    t: torch.Tensor           # [B] int32 timestep
    # Previous solve's [θ₁.., |V|₁..] — warm start for the f32 chord solver.
    # The solver starts flat where entries are non-finite.
    v_guess: torch.Tensor     # [B, 2·(n_bus−1)]
    # Reward-shaping carry (VecTask.shape_reward_fn); persists across
    # autoresets, like the reference tracker (ieee33_unequal_capacitors.py:
    # 118-125, set in __init__ and never cleared by reset()).
    shaping: Any = ()


@dataclasses.dataclass(frozen=True)
class VecTask:
    """A task definition: a network + MDP constants + batched hooks.

    init_state_fn(generator, n, task_carry) -> s0 [n, n_state + K] with the
        reference layout [dev_p (MW), dev_q (MVAr), des_soc (MWh),
        gen_p_max (MW), aux] (numpy or tensor; cast to the env dtype).
    next_vars_fn(generator, s_t, task_carry, t) -> (vars, new_task_carry)
        with vars [B, n_load + n_gen + K] = [P_load (MW), P_pot (MW), aux'].
    init_task_fn(generator, n) -> initial task carry (() when stateless).
    shape_reward_fn(carry, action, reward) -> (new_carry, reward, extras):
        optional post-step reward shaping with a per-lane carry, applied
        after the terminal reward and the absorbing-lane zeroing; ``extras``
        join the step's info dict.
    init_shape_fn(n, dtype, device) -> initial shaping carry.
    """

    network: dict
    K: int
    delta_t: float
    gamma: float
    lamb: float
    costs_clipping: tuple
    init_state_fn: Callable
    next_vars_fn: Callable
    init_task_fn: Callable = lambda generator, n: ()
    rates: Optional[np.ndarray] = None  # override the spec's branch rates
    shape_reward_fn: Optional[Callable] = None
    init_shape_fn: Callable = lambda n, dtype, device: ()
    # Optional chord linearization point [2(n_bus-1)] for the f32 solver;
    # None = flat start.
    chord_x_star: Optional[np.ndarray] = None
    name: str = "task"


class VecEnv:
    """Vectorized environment for one task on one device.

    ``dtype`` selects the compute precision: float64 for parity work,
    float32 for throughput (the chord solver).  ``obs`` selects the
    observation space, in the compat/reference format (anm_env.py:516-540):
    ``"state"`` (the flat MDP state vector, the default) or a list of
    ``(variable, ids[, unit])`` triples, compiled once into gathers over the
    transition output (:mod:`gym_anm_torch.vec.obs`).
    """

    def __init__(self, task: VecTask, dtype=torch.float32, obs="state", device="cuda"):
        self.task = task
        self.dtype = dtype
        self.device = torch.device(device)
        self.spec: NetworkSpec = load_network(task.network)
        self.tables: GridTables = make_tables(self.spec, task.delta_t, task.lamb, dtype=dtype,
                                              device=self.device, chord_x_star=task.chord_x_star)
        spec = self.spec

        c1 = np.inf if task.costs_clipping is None or task.costs_clipping[0] is None else task.costs_clipping[0]
        c2 = np.inf if task.costs_clipping is None or task.costs_clipping[1] is None else task.costs_clipping[1]
        self.costs_clipping = (float(c1), float(c2))

        lo, hi = spec.action_bounds()
        self.action_low = self._tensor(lo)
        self.action_high = self._tensor(hi)
        self.n_action = spec.n_action
        self.n_state = spec.n_state + task.K
        self._rates = self._tensor(task.rates if task.rates is not None else spec.br_rate)

        # Observation bounds for the fully-observable ("state") case,
        # including the reference's gen_p_max MW-bound quirk
        # (simulator.py:470).
        base = spec.baseMVA
        lows = np.concatenate([
            spec.p_min * base,
            spec.q_min * base,
            spec.soc_min[spec.des_pos] * base,
            spec.p_min[spec.gen_nonslack_pos] * base,
            np.full(task.K, -np.inf),
        ])
        highs = np.concatenate([
            spec.p_max * base,
            spec.q_max * base,
            spec.soc_max[spec.des_pos] * base,
            spec.q_max[spec.gen_nonslack_pos] * base,  # the quirk
            np.full(task.K, np.inf),
        ])
        if isinstance(obs, str) and obs == "state":
            self._obs_plan = None
            self.n_obs = self.n_state
            self.obs_low = self._tensor(lows)
            self.obs_high = self._tensor(highs)
        elif isinstance(obs, list):
            self._obs_plan = make_obs_plan(spec, task.K, obs, device=self.device)
            self.n_obs = self._obs_plan.n
            self.obs_low = self._tensor(self._obs_plan.low)
            self.obs_high = self._tensor(self._obs_plan.high)
        else:
            raise ObsSpaceError(f"obs must be 'state' or a list of (var, ids, unit) triples, got {obs!r}")

        sl, i = {}, 0
        for name, k in (("P_gen", spec.n_gen), ("Q_gen", spec.n_gen), ("P_des", spec.n_des),
                        ("Q_des", spec.n_des), ("Q_cap", spec.n_cap), ("tap", spec.n_oltc)):
            sl[name] = slice(i, i + k)
            i += k
        self._action_slices = sl

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, np.float64), device=self.device).to(self.dtype)

    # ------------------------------------------------------------------
    def split_action(self, action):
        sl = self._action_slices
        return (action[..., sl["P_gen"]], action[..., sl["Q_gen"]],
                action[..., sl["P_des"]], action[..., sl["Q_des"]],
                action[..., sl["Q_cap"]], action[..., sl["tap"]])

    def _state_vector(self, dev_p, dev_q, soc, p_pot, aux):
        """Flat MDP state [dev_p MW, dev_q MVAr, soc MWh, gen_p_max MW, aux]
        (anm_env.py:139-147)."""
        base = self.tables.baseMVA
        return torch.cat([dev_p * base, dev_q * base, soc * base, p_pot * base, aux], dim=-1)

    def observation(self, state_vec):
        return torch.clamp(state_vec, self.obs_low, self.obs_high)

    def _obs_from_out(self, out: TransitionOut, soc_pu, aux):
        """Observation from a transition output (obs-plan-aware)."""
        if self._obs_plan is None:
            return self.observation(self._state_vector(out.dev_p, out.dev_q, soc_pu, out.gen_p_pot, aux))
        return torch.clamp(self._obs_plan.extract(out, soc_pu, aux).to(self.dtype), self.obs_low, self.obs_high)

    def _run_transition(self, P_load, P_pot, P_gen, Q_gen, P_des, Q_des, Q_cap, taps, soc,
                        x_guess=None):
        c = lambda a: a.to(self.dtype)  # noqa: E731
        return transition(self.tables, c(P_load), c(P_pot), c(P_gen), c(Q_gen), c(P_des),
                          c(Q_des), c(Q_cap), c(taps), c(soc), self._rates, x_guess=x_guess)

    def _decode_s0(self, s0):
        """Split s0 [B, n] into transition inputs (simulator.py:267-301)."""
        spec = self.spec
        n_dev, n_des, n_gen = spec.n_dev, spec.n_des, spec.n_gen
        P_dev = s0[:, :n_dev]
        Q_dev = s0[:, n_dev: 2 * n_dev]
        soc_mwh = s0[:, 2 * n_dev: 2 * n_dev + n_des]
        P_max = s0[:, 2 * n_dev + n_des: 2 * n_dev + n_des + n_gen]
        aux = s0[:, 2 * n_dev + n_des + n_gen:]

        P_des = P_dev[:, spec.des_pos]
        # Seed SoC to empty/full so the requested injection is feasible.
        soc_seed = torch.where(P_des <= 0, self._tensor(spec.soc_min[spec.des_pos]),
                               self._tensor(spec.soc_max[spec.des_pos]))
        return (P_dev[:, spec.load_pos], P_max, P_dev[:, spec.gen_nonslack_pos],
                Q_dev[:, spec.gen_nonslack_pos], P_des, Q_dev[:, spec.des_pos],
                Q_dev[:, spec.cap_pos], soc_seed, soc_mwh, aux)

    # ------------------------------------------------------------------
    def reset(self, n, generator: Optional[torch.Generator] = None, oltc_tap=None):
        """Reset ``n`` lanes: sample initial states until each lane's load
        flow converges (≤100 tries, anm_env.py:266-289).  Returns
        (EnvState, obs)."""
        with profiling.span("env.reset"):
            if oltc_tap is None:
                oltc_tap = torch.ones(n, self.spec.n_oltc, dtype=self.dtype, device=self.device)
            task_carry = tree_map(lambda a: a.to(self.device), self.task.init_task_fn(generator, n))

            def attempt(lanes, taps, carry):
                s0 = self.task.init_state_fn(generator, lanes, carry)
                if not torch.is_tensor(s0):
                    s0 = torch.tensor(np.asarray(s0))
                s0 = s0.to(device=self.device, dtype=self.dtype)
                (P_load, P_max, P_gen, Q_gen, P_des, Q_des, Q_cap,
                 soc_seed, soc_mwh, aux) = self._decode_s0(s0)
                out = self._run_transition(P_load, P_max, P_gen, Q_gen, P_des, Q_des, Q_cap,
                                           taps, soc_seed)
                return out, soc_mwh / self.tables.baseMVA, aux

            out, soc, aux = attempt(n, oltc_tap, task_carry)
            tries = 1
            bad = ~out.stable
            while tries < 100 and profiling.host_bool(bad.any(), "env.reset"):
                # Each retried lane draws again under its own task carry.
                idx = torch.nonzero(bad).squeeze(1)
                sub, sub_soc, sub_aux = attempt(idx.numel(), oltc_tap[idx],
                                                tree_map(lambda a: a[idx], task_carry))
                for name, full, part in zip(out._fields, out, sub):
                    if name != "stable":
                        full[idx] = part
                # A new tensor, not written into: a recorded counter holds each attempt's own flags.
                out = out._replace(stable=out.stable.index_put((idx,), sub.stable))
                soc[idx], aux[idx] = sub_soc, sub_aux
                bad = ~out.stable
                tries += 1
            profiling.count("reset.lanes", n)
            profiling.count("reset.attempts", tries)

            state = EnvState(
                soc=soc,
                oltc_tap=out.oltc_tap,
                dev_p=out.dev_p,
                dev_q=out.dev_q,
                p_pot=out.gen_p_pot,
                bus_vm=torch.sqrt(out.bus_v_re ** 2 + out.bus_v_im ** 2),
                aux=aux,
                task=task_carry,
                terminated=~out.stable,
                t=torch.zeros(n, dtype=torch.int32, device=self.device),
                v_guess=solution_guess(out),
                shaping=self.task.init_shape_fn(n, self.dtype, self.device),
            )
            return state, self._obs_from_out(out, soc, aux)

    # ------------------------------------------------------------------
    def step(self, state: EnvState, action, generator: Optional[torch.Generator] = None):
        """One MDP step of every lane (anm_env.py:333-469)."""
        with profiling.span("env.step"):
            spec = self.spec
            s_t = self._state_vector(state.dev_p, state.dev_q, state.soc, state.p_pot, state.aux)
            vars, task_carry = self.task.next_vars_fn(generator, s_t, state.task, state.t)
            n_load, n_gen = spec.n_load, spec.n_gen
            P_load = vars[:, :n_load]
            P_pot = vars[:, n_load: n_load + n_gen]
            aux = vars[:, n_load + n_gen:].to(self.dtype)

            P_gen, Q_gen, P_des, Q_des, Q_cap, taps = self.split_action(action)
            out = self._run_transition(P_load, P_pot, P_gen, Q_gen, P_des, Q_des, Q_cap, taps,
                                       state.soc, x_guess=state.v_guess)

            terminated = ~out.stable
            c1, c2 = self.costs_clipping
            e_loss = torch.sign(out.e_loss) * torch.clamp(torch.abs(out.e_loss), 0.0, c1)
            penalty = torch.clamp(out.penalty, 0.0, c2)
            reward_ok = -(e_loss + penalty)
            reward_terminal = torch.full_like(reward_ok, -c2 / (1.0 - self.task.gamma))
            reward = torch.where(terminated, reward_terminal, reward_ok)
            # Lanes already terminated absorb with 0 reward (anm_env.py:363-367).
            reward = torch.where(state.terminated, torch.zeros_like(reward), reward)
            now_terminated = state.terminated | terminated

            # Post-step reward shaping, after terminal selection, where the
            # reference subclass adjusts the returned reward
            # (ieee33_unequal_capacitors.py:144-169).
            extras = {}
            shaping = state.shaping
            if self.task.shape_reward_fn is not None:
                shaping, reward, extras = self.task.shape_reward_fn(state.shaping, action, reward)

            was_done = state.terminated.unsqueeze(1)
            new_state = EnvState(
                soc=torch.where(was_done, state.soc, out.des_soc),
                oltc_tap=torch.where(was_done, state.oltc_tap, out.oltc_tap),
                dev_p=out.dev_p,
                dev_q=out.dev_q,
                p_pot=out.gen_p_pot,
                bus_vm=torch.sqrt(out.bus_v_re ** 2 + out.bus_v_im ** 2),
                aux=aux,
                task=task_carry,
                terminated=now_terminated,
                t=state.t + 1,
                # Keep the last STABLE solution as the next warm start: a
                # diverged solve's iterate would poison subsequent solves.
                v_guess=torch.where(out.stable.unsqueeze(1), solution_guess(out), state.v_guess),
                shaping=shaping,
            )
            obs = self._obs_from_out(out, out.des_soc, aux)
            obs = torch.where(now_terminated.unsqueeze(1), torch.zeros_like(obs), obs)
            info = {"e_loss": e_loss, "penalty": penalty, "n_iter": out.n_iter, "diff": out.diff, **extras}
            return new_state, obs, reward, now_terminated, info

    def step_autoreset_batch(self, state: EnvState, action, generator: Optional[torch.Generator] = None):
        """Step; every lane that is done afterwards is reset in place
        (gym_anm_tpu ``VecEnv.step_autoreset_batch``).  One host check per
        step (``done.any()``) skips the reset on steps where no lane is done;
        otherwise only the done lanes are reset.  Reset lanes keep their
        ``oltc_tap``; the shaping carry persists.  ``done`` is the step's."""
        new_state, obs, reward, done, info = self.step(state, action, generator)
        with profiling.span("env.autoreset"):
            if profiling.host_bool(done.any(), "env.autoreset"):
                idx = torch.nonzero(done).squeeze(1)
                fresh, fresh_obs = self.reset(idx.numel(), generator, oltc_tap=new_state.oltc_tap[idx])
                put = lambda full, part: full.index_copy(0, idx, part)  # noqa: E731
                new_state = EnvState(**{name: tree_map(put, getattr(new_state, name), getattr(fresh, name))
                                        for name in EnvState._fields if name != "shaping"},
                                     shaping=new_state.shaping)
                obs = put(obs, fresh_obs)
        return new_state, obs, reward, done, info

    # ------------------------------------------------------------------
    def rollout(self, state: EnvState, policy_fn, n_steps: int, autoreset=True, obs0=None,
                generator: Optional[torch.Generator] = None):
        """Run ``n_steps`` steps.  ``policy_fn(generator, obs, t) -> action``.
        Returns ``(final_state, (obs, action, reward, done))`` with time on the
        first axis of each trajectory tensor; ``obs0`` defaults to the
        observation of the carried state (0 for terminated lanes).  An env
        with an observation plan needs ``obs0`` (the observation returned by
        reset/step): it may hold solution quantities the state does not."""
        step = self.step_autoreset_batch if autoreset else self.step
        if obs0 is None:
            if self._obs_plan is not None:
                raise ValueError("rollout over a partial-observation env requires obs0 "
                                 "(the observation returned by reset/step)")
            s_vec = self._state_vector(state.dev_p, state.dev_q, state.soc, state.p_pot, state.aux)
            obs0 = torch.where(state.terminated.unsqueeze(1), torch.zeros_like(s_vec), self.observation(s_vec))
        obs, traj = obs0, []
        for t in range(n_steps):
            action = policy_fn(generator, obs, t)
            state, obs2, r, d, _ = step(state, action, generator)
            traj.append((obs, action, r, d))
            obs = obs2
        return state, tuple(torch.stack(x) for x in zip(*traj))

    def random_policy(self):
        """Uniform random policy over the action box."""
        lo, hi = self.action_low, self.action_high

        def policy(generator, obs, t):
            u = torch.rand(obs.shape[0], self.n_action, generator=generator, dtype=self.dtype,
                           device=self.device if generator is None else generator.device)
            return lo + u.to(self.device) * (hi - lo)

        return policy
