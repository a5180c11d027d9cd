"""Data-parallel PPO over the batched environment farm.

Port of ``gym_anm_tpu/parallel/ppo.py``.  A training step is: the rotating
lane refresh, the rollout of the env batch under the Gaussian policy,
generalized-advantage estimation, then ``n_epochs`` passes of clipped-
surrogate minibatch updates with the reference's hand-written Adam.  The
arithmetic is the JAX package's, casts included (rewards and dones stored as
float32, the I/O normalizers built in float32, Adam's bias correction in
float32); gradients come from autograd.

Data parallel (:mod:`.mesh`): each rank steps its contiguous block of the
global lane axis, and parameters are replicated.  Every mean that couples
lanes is global: each rank sums its part, divides by the global count, and
the sums and the gradients are summed over the ranks (one collective per
minibatch).  The minibatch schedule cuts the *global* lane axis, so a lane
chunk may lie on one rank or across two.  The policy noise is drawn for all
B lanes from a generator seeded alike on every rank and sliced, so the step
does not depend on the world size; an env's own noise (multicap's diurnal
loads, resets) comes from the caller's generator, per rank.

The update adds no host sync: the step count is a host int, so the refresh
mask and the epoch permutations are known on the host, and metrics stay
tensors until the caller reads them.
"""

import copy
import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..vec.core import EnvState, VecEnv, tree_map
from . import mesh

__all__ = ["PPOConfig", "ActorCritic", "TrainState", "init_train_state", "policy_dist", "value_fn", "sample_action",
           "log_prob", "gae", "ppo_loss", "adam_update", "make_io_norm", "make_train_step", "TrainStep"]


class PPOConfig(NamedTuple):
    hidden: int = 64
    lr: float = 3e-4
    gamma: float = 0.99
    lam: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.0
    rollout_len: int = 16
    # Nets see obs as (obs − mid)/half from the env's static box bounds, and
    # the Gaussian policy lives in the normalized [−1, 1] action box.  Dims
    # with non-finite or degenerate bounds pass through unscaled.
    normalize_io: bool = True
    # Rotating lane refresh: each train step, lanes with (global lane + step)
    # % refresh_interval == 0 are reset before the rollout.  0 disables.
    refresh_interval: int = 0
    # Scale on the reward entering GAE and the value targets (metrics report
    # the raw reward), and a symmetric clip on the scaled reward.
    reward_scale: float = 0.01
    reward_clip: float = 100.0
    # Each update makes n_epochs passes over an (n_minibatches ×
    # n_lane_minibatches) grid: time blocks of a per-epoch permutation of
    # the time axis × contiguous chunks of the global lane axis.
    n_epochs: int = 1
    n_minibatches: int = 1
    n_lane_minibatches: int = 1


def _dense(n_in, n_out, generator, dtype):
    """A linear layer with N(0, 2/n_in) weights and zero bias (drawn on the
    CPU from ``generator``, so every device gets the same numbers)."""
    layer = nn.utils.skip_init(nn.Linear, n_in, n_out, dtype=dtype)
    with torch.no_grad():
        w = torch.randn(n_in, n_out, generator=generator, dtype=dtype) * math.sqrt(2.0 / n_in)
        layer.weight.copy_(w.T)
        layer.bias.zero_()
    return layer


class ActorCritic(nn.Module):
    """The MLP actor-critic: two tanh hidden layers each for the policy mean
    (``pi1``, ``pi2``, ``mu``) and the value (``v1``, ``v2``, ``v``), and a
    state-independent ``log_std``."""

    def __init__(self, obs_dim, act_dim, hidden=64, dtype=torch.float32, seed=0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.pi1 = _dense(obs_dim, hidden, g, dtype)
        self.pi2 = _dense(hidden, hidden, g, dtype)
        self.mu = _dense(hidden, act_dim, g, dtype)
        self.v1 = _dense(obs_dim, hidden, g, dtype)
        self.v2 = _dense(hidden, hidden, g, dtype)
        self.v = _dense(hidden, 1, g, dtype)
        self.log_std = nn.Parameter(torch.zeros(act_dim, dtype=dtype))


class TrainState(NamedTuple):
    """The learner's state: the module (updated in place by
    :func:`adam_update`), Adam's moments by parameter name, and the update
    count as a host int."""

    params: nn.Module
    opt_m: dict
    opt_v: dict
    step: int

    def to(self, device=None, dtype=None):
        """A copy on ``device`` at ``dtype`` (the module deep-copied)."""
        moved = lambda d: {k: v.to(device=device, dtype=dtype) for k, v in d.items()}  # noqa: E731
        return TrainState(copy.deepcopy(self.params).to(device=device, dtype=dtype), moved(self.opt_m),
                          moved(self.opt_v), self.step)


def _zeros_like_params(module):
    return {name: torch.zeros_like(p) for name, p in module.named_parameters()}


def init_train_state(seed, obs_dim, act_dim, cfg: PPOConfig, dtype=torch.float32, device="cuda"):
    """A fresh :class:`TrainState`: the same parameters on every rank (drawn
    from ``seed``, then rank 0's broadcast), zero moments, step 0."""
    params = mesh.broadcast_params(ActorCritic(obs_dim, act_dim, cfg.hidden, dtype, seed).to(device))
    return TrainState(params, _zeros_like_params(params), _zeros_like_params(params), 0)


def _mlp(layers, x):
    for layer in layers[:-1]:
        x = torch.tanh(layer(x))
    return layers[-1](x)


def policy_dist(params, obs):
    mu = _mlp((params.pi1, params.pi2, params.mu), obs)
    return mu, torch.exp(params.log_std)


def value_fn(params, obs):
    return _mlp((params.v1, params.v2, params.v), obs)[..., 0]


def sample_action(params, noise, obs, act_low, act_high):
    """The Gaussian policy's action for the standard-normal draw ``noise``
    (the JAX package draws it from a key), clipped to the box."""
    mu, std = policy_dist(params, obs)
    return torch.clamp(mu + std * noise, act_low, act_high)


def log_prob(params, obs, act):
    mu, std = policy_dist(params, obs)
    z = (act - mu) / std
    return torch.sum(-0.5 * z * z - torch.log(std) - 0.5 * math.log(2 * math.pi), dim=-1)


def gae(rewards, values, dones, gamma, lam):
    """Generalized advantage estimation along the time axis (axis 0): the
    reference's scan body, its elementwise terms for all steps at once and
    the recursion a reverse loop over T.  As in the reference, the last step
    bootstraps from its own value."""
    nonterminal = 1.0 - dones
    v_next = torch.cat([values[1:], values[-1:]])
    delta = rewards + gamma * v_next * nonterminal - values
    decay = gamma * lam * nonterminal
    adv = torch.zeros_like(values[-1])
    advs = [None] * rewards.shape[0]
    for t in reversed(range(rewards.shape[0])):
        adv = delta[t] + decay[t] * adv
        advs[t] = adv
    return torch.stack(advs)


def ppo_loss(params, cfg: PPOConfig, obs, act, adv, ret, old_logp, count=None, with_entropy=True):
    """The clipped-surrogate loss ``(loss, pg_loss, v_loss)`` of a minibatch
    (``ppo.py:281-290``).  Under data parallelism each rank passes its part of
    the minibatch and the global ``count``: the means are the part's sums over
    ``count``, so the ranks' losses and gradients sum to the minibatch's; the
    entropy term enters on one rank only (``with_entropy``)."""
    if count is None:
        count = adv.numel()
    ratio = torch.exp(log_prob(params, obs, act) - old_logp)
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
    pg_loss = -torch.sum(torch.minimum(unclipped, clipped)) / count
    v = value_fn(params, obs)
    v_loss = torch.sum((v - ret) ** 2) / count
    loss = pg_loss + cfg.vf_coef * v_loss
    if with_entropy and cfg.ent_coef:
        ent = torch.sum(params.log_std + 0.5 * math.log(2 * math.pi * math.e))
        loss = loss - cfg.ent_coef * ent
    return loss, pg_loss, v_loss


def _bias_correction(beta, step):
    """``1 - beta**step`` in float32, as the reference computes it even at
    float64 (``ppo.py:159``).  The power is taken in float64 and rounded to
    float32, which equals XLA's float32 power for beta = 0.9 up to step 684
    and for beta = 0.999 up to step 872; beyond, the two differ by at most
    one float32 ulp on some steps."""
    t = np.float32(step)
    return float(np.float32(1) - np.float32(np.float64(np.float32(beta)) ** np.float64(t)))


def adam_update(ts: TrainState, grads, lr, b1=0.9, b2=0.999, eps=1e-8, bias_correction=None):
    """The reference's Adam (``ppo.py:155-165``) over the module's parameters:
    ``grads`` by parameter name.  The parameters and the moments are updated
    in place; the returned state holds them and ``step + 1``.

    ``bias_correction`` is the pair ``1 - b1**t``, ``1 - b2**t`` as 0-dim
    float32 tensors on the parameters' device; by default it is made here
    from the host step count (a CUDA graph of an update passes tensors that
    it fills before each replay)."""
    step = ts.step + 1
    names, params = zip(*ts.params.named_parameters())
    if bias_correction is None:
        bias_correction = [torch.full((), _bias_correction(b, step), dtype=torch.float32, device=params[0].device)
                           for b in (b1, b2)]
    g = [grads[n] for n in names]
    m, v = [ts.opt_m[n] for n in names], [ts.opt_v[n] for n in names]
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
    torch._foreach_mul_(v, b2)
    torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, 1 - b2), g))
    mhat = torch._foreach_div(m, bias_correction[0])
    vhat = torch._foreach_div(v, bias_correction[1])
    delta = torch._foreach_div(torch._foreach_mul(mhat, lr), torch._foreach_add(torch._foreach_sqrt(vhat), eps))
    with torch.no_grad():
        torch._foreach_sub_(list(params), delta)
    return TrainState(ts.params, ts.opt_m, ts.opt_v, step)


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def make_io_norm(env: VecEnv):
    """Static affine normalizers from the env's box bounds, built in float32
    whatever the env's dtype (as the reference builds them).

    Returns ``(norm_obs, act_mid, act_half)``: ``norm_obs`` maps raw obs to
    ~[−1, 1]; actions are ``act_mid + a_n · act_half`` for a policy in the
    normalized box.  Dims with non-finite or degenerate bounds get identity
    scaling.
    """
    device = env.obs_low.device if torch.is_tensor(env.obs_low) else torch.device("cpu")

    def mid_half(lo, hi):
        lo, hi = _host(lo).astype(np.float32), _host(hi).astype(np.float32)
        fin = np.isfinite(lo) & np.isfinite(hi) & (hi > lo)
        with np.errstate(invalid="ignore", over="ignore"):
            mid = np.where(fin, (lo + hi) * np.float32(0.5), np.float32(0.0))
            half = np.where(fin, (hi - lo) * np.float32(0.5), np.float32(1.0))
        return mid, half

    obs_mid, obs_half = mid_half(env.obs_low, env.obs_high)
    act_mid, act_half = mid_half(env.action_low, env.action_high)
    obs_mid = torch.from_numpy(obs_mid).to(device)
    obs_inv_half = torch.from_numpy(np.float32(1.0) / obs_half).to(device)

    def norm_obs(o):
        return (o - obs_mid) * obs_inv_half

    return norm_obs, torch.from_numpy(act_mid).to(device), torch.from_numpy(act_half).to(device)


def _seed(*ints):
    return int(np.random.SeedSequence(list(ints)).generate_state(1, np.uint64)[0] >> np.uint64(1))


class TrainStep:
    """The PPO training step over ``env`` (see :func:`make_train_step`).

    ``step(ts, state, obs, generator) -> (ts, state, obs, metrics)`` runs
    :meth:`collect` (refresh and rollout) then :meth:`update`; the parts are
    public so that a caller can time them apart, check the update alone, or
    inject the reference's noise and permutations.  ``ts`` is updated in
    place (its module); ``state`` and ``obs`` are the rank's lanes.
    """

    def __init__(self, env: VecEnv, cfg: PPOConfig, seed: int = 0):
        if cfg.rollout_len % cfg.n_minibatches != 0:
            raise ValueError(f"rollout_len ({cfg.rollout_len}) must be divisible by "
                             f"n_minibatches ({cfg.n_minibatches})")
        self.env, self.cfg, self.seed = env, cfg, seed
        if cfg.normalize_io:
            self.norm_obs, self.act_mid, self.act_half = make_io_norm(env)
            # The policy lives in the normalized box: clip at ±1 there.
            self.act_low, self.act_high = -torch.ones_like(env.action_low), torch.ones_like(env.action_high)
        else:
            self.norm_obs = lambda o: o  # noqa: E731
            self.act_mid, self.act_half = torch.zeros_like(env.action_low), torch.ones_like(env.action_low)
            self.act_low, self.act_high = env.action_low, env.action_high
        self._noise_gen = torch.Generator(device=env.device)

    def __call__(self, ts: TrainState, state: EnvState, obs, generator=None):
        state, obs, traj = self.collect(ts, state, obs, generator)
        ts, metrics = self.update(ts, traj, self.permutations(ts.step))
        return ts, state, obs, metrics

    # ------------------------------------------------------------------
    def permutations(self, step):
        """The ``n_epochs`` permutations of the time axis for update ``step``
        (host lists, from a CPU generator seeded from (17, step): the same on
        every rank)."""
        rng = np.random.default_rng([17, step])
        return [rng.permutation(self.cfg.rollout_len).tolist() for _ in range(self.cfg.n_epochs)]

    def policy_noise(self, step, params, n_local):
        """The rollout's standard-normal draws [T, lanes, n_action] for this
        rank: all B lanes drawn from a generator seeded from (seed, step) and
        sliced, so they do not depend on the world size."""
        rank, world = mesh.world()
        self._noise_gen.manual_seed(_seed(self.seed, step))
        dtype = next(params.parameters()).dtype
        z = torch.randn(self.cfg.rollout_len, n_local * world, self.env.n_action, generator=self._noise_gen,
                        dtype=dtype, device=self.env.device)
        return z[:, mesh.lane_slice(n_local * world, rank, world)]

    def refresh(self, step, state: EnvState, obs, generator=None):
        """Reset the lanes whose global index l has (l + step) %
        refresh_interval == 0 (an arithmetic progression, so the index is
        built on the device without a host round trip)."""
        interval = self.cfg.refresh_interval
        n_local = obs.shape[0]
        first = (-(mesh.world()[0] * n_local + step)) % interval
        n = len(range(first, n_local, interval))
        if n == 0:
            return state, obs
        idx = torch.arange(first, n_local, interval, device=obs.device)
        fresh, fresh_obs = self.env.reset(n, generator)
        put = lambda full, part: full.index_copy(0, idx, part)  # noqa: E731
        state = EnvState(**{name: tree_map(put, getattr(state, name), getattr(fresh, name))
                            for name in EnvState._fields})
        return state, put(obs, fresh_obs)

    def rollout(self, params, state: EnvState, obs, noise, generator=None):
        """``T`` steps of ``step_autoreset_batch`` under the policy.  Returns
        ``(state, obs, (obs_T, act_T, rew_T, done_T))``: the raw obs, the
        normalized action (clipped, the one ``log_prob`` is taken of), and
        rewards and dones as float32."""
        env, traj = self.env, []
        with torch.no_grad():
            for t in range(self.cfg.rollout_len):
                action_n = sample_action(params, noise[t], self.norm_obs(obs), self.act_low, self.act_high)
                action = torch.clamp(self.act_mid + action_n * self.act_half, env.action_low, env.action_high)
                state, obs2, r, d, _ = env.step_autoreset_batch(state, action, generator)
                traj.append((obs, action_n, r.to(torch.float32), d.to(torch.float32)))
                obs = obs2
        return state, obs, tuple(torch.stack(x) for x in zip(*traj))

    def collect(self, ts: TrainState, state: EnvState, obs, generator=None):
        """The refresh and the rollout of update ``ts.step``."""
        if self.cfg.refresh_interval:
            state, obs = self.refresh(ts.step, state, obs, generator)
        noise = self.policy_noise(ts.step, ts.params, obs.shape[0])
        return self.rollout(ts.params, state, obs, noise, generator)

    # ------------------------------------------------------------------
    def update(self, ts: TrainState, traj, perms):
        """The advantages and the ``n_epochs`` × minibatches Adam steps on the
        rank's trajectory batch ``traj`` [T, lanes, ...], with the epochs' time
        permutations ``perms``.  Returns ``(ts, metrics)``: the metrics of the
        last minibatch of the last epoch and the batch's raw mean reward and
        done rate, global, as 0-dim tensors."""
        cfg, model = self.cfg, ts.params
        obs_T, act_T, rew_T, done_T = traj
        rank, world = mesh.world()
        T, n_local = rew_T.shape
        n_lanes = n_local * world
        if n_lanes % cfg.n_lane_minibatches != 0:
            raise ValueError(f"batch ({n_lanes}) must be divisible by "
                             f"n_lane_minibatches ({cfg.n_lane_minibatches})")
        obs_T = self.norm_obs(obs_T)
        scaled = rew_T * cfg.reward_scale
        if cfg.reward_clip:
            c = cfg.reward_clip
            scaled = torch.clamp(torch.nan_to_num(scaled, neginf=-c, posinf=c), -c, c)

        # Advantages, once, from the pre-update parameters; normalized by the
        # global mean and population std.
        with torch.no_grad():
            values = value_fn(model, obs_T)
            adv = gae(scaled, values, done_T, cfg.gamma, cfg.lam)
            returns = adv + values
            f64 = torch.float64
            n_all = T * n_lanes
            sums = mesh.all_reduce_sum([torch.stack([adv.sum(dtype=f64), rew_T.sum(dtype=f64),
                                                     done_T.sum(dtype=f64)])])[0]
            mean = (sums[0] / n_all).to(adv.dtype)
            dev = adv - mean
            var = mesh.all_reduce_sum([(dev * dev).sum(dtype=f64).reshape(1)])[0][0] / n_all
            adv = dev / (torch.sqrt(var).to(adv.dtype) + 1e-8)
            old_logp = log_prob(model, obs_T, act_T)

        mb_len = T // cfg.n_minibatches
        lane_mb = n_lanes // cfg.n_lane_minibatches
        lo = rank * n_local
        names = [n for n, _ in model.named_parameters()]
        params = [p for _, p in model.named_parameters()]
        count = mb_len * lane_mb
        for perm in perms:
            shuffled = [torch.stack([x[t] for t in perm]) for x in (obs_T, act_T, adv, returns, old_logp)]
            for i in range(cfg.n_minibatches * cfg.n_lane_minibatches):
                t_i, l_i = divmod(i, cfg.n_lane_minibatches)
                # This rank's part of global lane chunk l_i (possibly empty).
                a = min(max(l_i * lane_mb - lo, 0), n_local)
                b = min(max((l_i + 1) * lane_mb - lo, 0), n_local)
                mb = [x[t_i * mb_len:(t_i + 1) * mb_len, a:b] for x in shuffled]
                loss, pg, vl = ppo_loss(model, cfg, *mb, count=count, with_entropy=rank == 0)
                grads = torch.autograd.grad(loss, params, allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
                stats = torch.stack([loss.detach(), pg.detach(), vl.detach()])
                mesh.all_reduce_sum(grads + [stats])
                ts = adam_update(ts, dict(zip(names, grads)), cfg.lr)

        metrics = {
            "loss": stats[0],
            "pg_loss": stats[1],
            "v_loss": stats[2],
            "mean_reward": (sums[1] / n_all).to(torch.float32),  # raw env reward, unscaled
            "done_rate": (sums[2] / n_all).to(torch.float32),
        }
        return ts, metrics


def make_train_step(env: VecEnv, cfg: PPOConfig, seed: int = 0) -> TrainStep:
    """The PPO training step over ``env``:

        train_step(ts, state, obs, generator) -> (ts, state, obs, metrics)

    ``state``/``obs`` are this rank's lanes; ``seed`` seeds the policy
    noise (with the step count)."""
    return TrainStep(env, cfg, seed)
