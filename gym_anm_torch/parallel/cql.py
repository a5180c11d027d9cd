"""Conservative Q-Learning (CQL), the offline-RL learner.

Port of ``gym_anm_tpu/parallel/cql.py``: a SAC-style actor-critic with twin
Q networks and the CQL(H) penalty (the log-sum-exp of Q over sampled
actions, uniform and policy, pushed down against the dataset actions' Q),
trained from logged transitions.  Actions are squashed into the env's box
with tanh.  It reuses PPO's Adam and :class:`~.ppo.TrainState`.

The reference's stop-gradients are ``.detach()`` (or ``torch.no_grad``) at
the same places: the Bellman target, the policy-sampled actions and their
log-probabilities in the penalty, and the Q parameters in the actor term.
Randomness is explicit: an update's standard-normal and uniform draws come
from a ``torch.Generator`` (or are passed in, as the parity tests pass the
JAX package's draws).

Data parallel (:mod:`.mesh`): each rank holds a contiguous block of the
minibatch; its means are sums over the block divided by the global batch
size, summed over the ranks with the gradients.  The draws are made for the
global batch from a generator seeded alike on every rank and sliced.
"""

import contextlib
import copy
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.debug import forbid_host_syncs
from . import mesh
from .ppo import TrainState, _bias_correction, _dense, _zeros_like_params, adam_update

__all__ = ["CQLConfig", "QNet", "PolicyNet", "CQLNet", "CQLState", "init_cql_state", "q_value", "sample_action",
           "deterministic_action", "make_cql_update", "train_cql"]


GRAPH_WARMUP = 3  # eager updates before train_cql captures its CUDA graph


class CQLConfig(NamedTuple):
    hidden: int = 128
    lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005          # target-network Polyak rate
    alpha: float = 0.2          # SAC entropy temperature
    cql_weight: float = 5.0     # conservative penalty weight
    n_cql_actions: int = 4      # sampled actions per side for the LSE


class QNet(nn.Module):
    """Q(s, a): two tanh layers over [obs, act], a scalar head ``out``."""

    def __init__(self, obs_dim, act_dim, hidden, dtype, generator):
        super().__init__()
        self.l1 = _dense(obs_dim + act_dim, hidden, generator, dtype)
        self.l2 = _dense(hidden, hidden, generator, dtype)
        self.out = _dense(hidden, 1, generator, dtype)

    def forward(self, obs, act, frozen=False):
        """Q(obs, act); with ``frozen``, on the parameters cut from the graph
        (the gradient reaches ``act`` only)."""
        x = torch.cat([obs, act], dim=-1)
        for layer in (self.l1, self.l2, self.out):
            w, b = (layer.weight.detach(), layer.bias.detach()) if frozen else (layer.weight, layer.bias)
            x = F.linear(x, w, b)
            if layer is not self.out:
                x = torch.tanh(x)
        return x[..., 0]


class PolicyNet(nn.Module):
    """The tanh-Gaussian policy: two tanh layers, heads ``mu`` and ``log_std``."""

    def __init__(self, obs_dim, act_dim, hidden, dtype, generator):
        super().__init__()
        self.l1 = _dense(obs_dim, hidden, generator, dtype)
        self.l2 = _dense(hidden, hidden, generator, dtype)
        self.mu = _dense(hidden, act_dim, generator, dtype)
        self.log_std = _dense(hidden, act_dim, generator, dtype)

    def forward(self, obs):
        h = torch.tanh(self.l2(torch.tanh(self.l1(obs))))
        return self.mu(h), torch.clamp(self.log_std(h), -5.0, 2.0)


class CQLNet(nn.Module):
    """The online networks: twin critics ``q1``, ``q2`` and the policy ``pi``."""

    def __init__(self, obs_dim, act_dim, hidden=128, dtype=torch.float32, seed=0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.q1 = QNet(obs_dim, act_dim, hidden, dtype, g)
        self.q2 = QNet(obs_dim, act_dim, hidden, dtype, g)
        self.pi = PolicyNet(obs_dim, act_dim, hidden, dtype, g)


class CQLState(NamedTuple):
    train: TrainState       # online networks + Adam moments
    target_q: nn.ModuleDict  # Polyak-averaged copies {"q1", "q2"}

    def to(self, device=None, dtype=None):
        """A copy on ``device`` at ``dtype``."""
        return CQLState(self.train.to(device, dtype), copy.deepcopy(self.target_q).to(device=device, dtype=dtype))


def init_cql_state(seed, obs_dim, act_dim, cfg: CQLConfig, dtype=torch.float32, device="cuda"):
    """Fresh networks (the same on every rank: drawn from ``seed``, then rank
    0's broadcast), zero moments, and targets equal to the critics."""
    net = mesh.broadcast_params(CQLNet(obs_dim, act_dim, cfg.hidden, dtype, seed).to(device))
    ts = TrainState(net, _zeros_like_params(net), _zeros_like_params(net), 0)
    return CQLState(ts, nn.ModuleDict({"q1": copy.deepcopy(net.q1), "q2": copy.deepcopy(net.q2)}))


def q_value(qp, obs, act):
    return qp(obs, act)


def sample_action(pp, noise, obs, act_low, act_high):
    """The tanh-squashed Gaussian action for the standard-normal draw
    ``noise`` mapped into the box; returns (action, log_prob) with the tanh
    Jacobian correction.  ``noise`` may carry leading sample axes."""
    mu, log_std = pp(obs)
    std = torch.exp(log_std)
    tanh = torch.tanh(mu + std * noise)
    logp = (-0.5 * (noise ** 2 + 2 * log_std + math.log(2 * math.pi))).sum(-1)
    logp = logp - torch.log(torch.clamp(1 - tanh ** 2, min=1e-6)).sum(-1)
    half = (act_high - act_low) / 2.0
    action = (act_high + act_low) / 2.0 + half * tanh
    logp = logp - torch.log(torch.clamp(half, min=1e-6)).sum()
    return action, logp


def deterministic_action(pp, obs, act_low, act_high):
    mu, _ = pp(obs)
    return (act_high + act_low) / 2.0 + (act_high - act_low) / 2.0 * torch.tanh(mu)


class CQLUpdate:
    """The minibatch update (see :func:`make_cql_update`)."""

    def __init__(self, cfg: CQLConfig, act_low, act_high):
        self.cfg = cfg
        self.act_low = torch.as_tensor(act_low)
        self.act_high = torch.as_tensor(act_high)
        self.span = self.act_high - self.act_low

    def buffers(self, n, dtype):
        """Empty buffers for the draws of a global batch of ``n`` rows:
        ``next`` [n, A], ``unif`` and ``pol`` [n_cql, n, A], ``actor`` [n, A]."""
        A, k = self.act_low.shape[0], self.cfg.n_cql_actions
        shapes = {"next": (n, A), "unif": (k, n, A), "pol": (k, n, A), "actor": (n, A)}
        return {key: torch.empty(shape, dtype=dtype, device=self.act_low.device) for key, shape in shapes.items()}

    def draw_global(self, generator, n, dtype, out=None):
        """The update's draws for the global batch of ``n`` rows, in the
        order of :meth:`buffers` (``unif`` uniform, the rest standard
        normal), into ``out`` (such buffers) in place; returns them."""
        out = self.buffers(n, dtype) if out is None else out
        for key, x in out.items():
            (torch.rand if key == "unif" else torch.randn)(x.shape, generator=generator, out=x)
        return out

    @staticmethod
    def rank_rows(noise):
        """This rank's rows of :meth:`draw_global`'s draws, as views (a later
        draw into the same buffers shows through them)."""
        rank, world = mesh.world()
        sl = mesh.lane_slice(noise["next"].shape[0], rank, world)
        return {key: (x[sl] if x.dim() == 2 else x[:, sl]) for key, x in noise.items()}

    def draw(self, generator, n_local, dtype):
        """The update's draws for this rank's ``n_local`` rows: those of the
        global batch, sliced, so they do not depend on the world size."""
        return self.rank_rows(self.draw_global(generator, n_local * mesh.world()[1], dtype))

    def loss(self, net, target_q, noise, batch):
        """(loss, metrics) of this rank's block of the minibatch; every mean
        is the block's sum over the global batch size."""
        cfg, low, high = self.cfg, self.act_low, self.act_high
        obs, acts = batch["obs"], batch["actions"]
        rew, next_obs, dones = batch["rewards"], batch["next_obs"], batch["dones"]
        n_local = obs.shape[0]
        count = n_local * mesh.world()[1]

        # Bellman targets from the target twins (no gradient).
        with torch.no_grad():
            next_act, next_logp = sample_action(net.pi, noise["next"], next_obs, low, high)
            tq = torch.minimum(target_q["q1"](next_obs, next_act),
                               target_q["q2"](next_obs, next_act)) - cfg.alpha * next_logp
            target = rew + cfg.gamma * (1.0 - dones) * tq

        q1 = net.q1(obs, acts)
        q2 = net.q2(obs, acts)
        bellman = ((q1 - target) ** 2 + (q2 - target) ** 2).sum() / count

        # CQL(H) penalty on the critics only: the policy-sampled actions and
        # their log-probabilities carry no gradient into the actor.
        n = cfg.n_cql_actions
        unif = low + self.span * noise["unif"]
        with torch.no_grad():
            pol, pol_logp = sample_action(net.pi, noise["pol"], obs, low, high)
        unif_logp = -torch.log(torch.clamp(self.span, min=1e-6)).sum()
        cat_acts = torch.cat([unif, pol], dim=0)  # [2n, B, A]
        cat_logp = torch.cat([unif_logp.to(obs.dtype).expand(n, n_local), pol_logp], dim=0)
        log_2n = torch.full((), 2 * n, dtype=obs.dtype, device=obs.device).log()
        obs_rep = obs.expand(2 * n, *obs.shape)

        def lse(qnet):
            return torch.logsumexp(qnet(obs_rep, cat_acts) - cat_logp, dim=0) - log_2n

        cql = (lse(net.q1) - q1).sum() / count + (lse(net.q2) - q2).sum() / count
        critic_loss = bellman + cfg.cql_weight * cql

        # Actor: the SAC objective against the conservative twins (frozen).
        new_act, logp = sample_action(net.pi, noise["actor"], obs, low, high)
        q_new = torch.minimum(net.q1(obs, new_act, frozen=True), net.q2(obs, new_act, frozen=True))
        actor_loss = (cfg.alpha * logp - q_new).sum() / count

        loss = critic_loss + actor_loss
        metrics = {"loss": loss, "bellman": bellman, "cql": cql, "actor_loss": actor_loss,
                   "q1_mean": q1.sum() / count}
        return loss, metrics

    def __call__(self, state: CQLState, generator, batch, noise: Optional[dict] = None, bias_correction=None):
        net = state.train.params
        if noise is None:
            noise = self.draw(generator, batch["obs"].shape[0], batch["obs"].dtype)
        loss, metrics = self.loss(net, state.target_q, noise, batch)
        names, params = zip(*net.named_parameters())
        grads = list(torch.autograd.grad(loss, params))
        stats = torch.stack([m.detach() for m in metrics.values()])
        mesh.all_reduce_sum(grads + [stats])
        ts = adam_update(state.train, dict(zip(names, grads)), self.cfg.lr, bias_correction=bias_correction)
        tau = self.cfg.tau
        with torch.no_grad():
            for key in ("q1", "q2"):
                for t, o in zip(state.target_q[key].parameters(), getattr(net, key).parameters()):
                    t.copy_((1 - tau) * t + tau * o)
        return CQLState(ts, state.target_q), dict(zip(metrics, stats))


def make_cql_update(cfg: CQLConfig, act_low, act_high) -> CQLUpdate:
    """The minibatch update on the device of ``act_low``/``act_high``:

        update(state, generator, batch, noise=None, bias_correction=None)
            -> (state', metrics)

    ``batch`` = dict(obs [B, O], actions [B, A], rewards [B], next_obs [B, O],
    dones [B]), this rank's rows; ``noise`` (default: drawn from
    ``generator``) and ``bias_correction`` as for :meth:`CQLUpdate.draw` and
    :func:`~.ppo.adam_update`.  The networks, moments and targets are updated
    in place."""
    return CQLUpdate(cfg, act_low, act_high)


def train_cql(seed, dataset, act_low, act_high, cfg: CQLConfig = CQLConfig(), steps: int = 1000,
              batch_size: int = 256, device="cuda", forbid_syncs: bool = False):
    """Train CQL on an in-memory dataset dict (states/actions/rewards/
    next_states/dones, the offline pickle schema), at float32 on ``device``.
    Minibatch indices (with replacement) and the updates' draws come from a
    generator on ``device`` seeded from ``seed``.

    On the card, the first :data:`GRAPH_WARMUP` updates run eagerly and the
    rest replay one CUDA graph of an update (its all-reduce included, under
    a process group): the draws are made outside the graph into the buffers
    it reads, and Adam's bias corrections are filled in before each replay,
    so every update computes what the eager one would.  On the CPU every
    update runs eagerly.  With ``forbid_syncs``, each update (each replay)
    runs under ``torch.cuda.set_sync_debug_mode("error")``.

    Returns (CQLState, metrics, policy_fn): the last update's metrics and
    the deterministic deployment policy ``policy_fn(obs) -> action``.
    """
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    f32 = torch.float32
    cast = lambda a: torch.as_tensor(a).to(device=device, dtype=f32)  # noqa: E731
    data = {"obs": cast(dataset["states"]), "actions": cast(dataset["actions"]), "rewards": cast(dataset["rewards"]),
            "next_obs": cast(dataset["next_states"]), "dones": cast(dataset["dones"])}
    n = data["obs"].shape[0]
    act_low, act_high = cast(act_low), cast(act_high)

    state = init_cql_state(seed, data["obs"].shape[-1], act_low.shape[0], cfg, f32, device)
    update = make_cql_update(cfg, act_low, act_high)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    rank, world = mesh.world()
    rows = mesh.lane_slice(batch_size, rank, world)
    idx = torch.empty(batch_size, dtype=torch.long, device=device)
    full = update.buffers(batch_size, f32)  # every draw fills these
    noise = update.rank_rows(full)

    def draw():
        torch.randint(0, n, (batch_size,), generator=g, device=device, out=idx)
        update.draw_global(g, batch_size, f32, out=full)

    def one(state, bias_correction=None):
        return update(state, None, {k: v[idx[rows]] for k, v in data.items()}, noise, bias_correction)

    graphed = torch.device(device).type == "cuda" and steps > GRAPH_WARMUP
    eager = GRAPH_WARMUP if graphed else steps
    side = torch.cuda.Stream() if graphed else None
    if graphed:  # warm up on a side stream, as CUDA graph capture asks
        side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side) if graphed else contextlib.nullcontext():
        for _ in range(eager):
            with forbid_host_syncs(forbid_syncs):
                draw()
                state, metrics = one(state)
    if graphed:
        torch.cuda.current_stream().wait_stream(side)
        bias = [torch.zeros((), dtype=f32, device=device) for _ in range(2)]
        graph = torch.cuda.CUDAGraph()
        # thread_local: nccl's watchdog thread may query its events while this one captures
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            captured, metrics = one(state, bias)
        for step in range(state.train.step + 1, steps + 1):
            with forbid_host_syncs(forbid_syncs):
                draw()
                for b, beta in zip(bias, (0.9, 0.999)):
                    b.fill_(_bias_correction(beta, step))
                graph.replay()
        state = CQLState(captured.train._replace(step=steps), captured.target_q)
        metrics = {k: v.clone() for k, v in metrics.items()}

    pi = state.train.params.pi

    def policy_fn(o):
        with torch.no_grad():
            return deterministic_action(pi, cast(o), act_low, act_high)

    return state, metrics, policy_fn
