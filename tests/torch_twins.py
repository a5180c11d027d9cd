"""Closed-loop twins: one host controller of the JAX package and its port,
each driving its own compat environment from the same state.

Both environments are built, reset and stepped from the same global
``np.random`` state (the IEEE33 family draws its clock and load noise from
it, and some controllers draw their own noise there), their action spaces
are seeded alike (the random controllers call ``action_space.sample()``),
and each controller's action, clipped to the action box, steps its own
environment.  Shared by the port's controller, offline and zoo tests.
"""

import numpy as np

from .test_torch_compat import twin

__all__ = ["twin", "make_envs", "start", "closed_loop", "policy_of"]


def make_envs(factory, seed=0):
    """The JAX and port environments of ``factory(pkg, **kw)`` built from
    the same global RNG state; the port's on the CPU."""
    import gym_anm_torch.compat as tc
    import gym_anm_tpu.compat as jc

    np.random.seed(seed)
    return twin(lambda: factory(jc), lambda: factory(tc, device="cpu"))


def start(ej, ep, seed):
    """Reset both environments alike and seed their action spaces."""
    np.random.seed(seed)
    twin(lambda: ej.reset(seed=seed), lambda: ep.reset(seed=seed))
    ej.action_space.seed(seed)
    ep.action_space.seed(seed)


def policy_of(agent):
    """An agent's ``act``; the zoo's ``BaseHeuristic`` has none and gives its
    base action."""
    return agent.act if hasattr(agent, "act") else agent.get_base_action


def closed_loop(ej, ep, make_j, make_p, steps, seed=0):
    """Run ``make_j(ej)`` on ``ej`` and ``make_p(ep)`` on ``ep`` for
    ``steps`` steps; returns the two agents and a dict of stacked
    ``actions_j``/``actions_p`` (raw, before the clip), ``rewards_j``/
    ``rewards_p`` and ``terminated_j``/``terminated_p``.  A terminated
    episode restarts from ``seed``."""
    start(ej, ep, seed)
    aj, ap = twin(lambda: make_j(ej), lambda: make_p(ep))
    pj, pp = policy_of(aj), policy_of(ap)
    lo, hi = ej.action_space.low, ej.action_space.high
    rec = {k: [] for k in ("actions_j", "actions_p", "rewards_j", "rewards_p", "terminated_j", "terminated_p")}
    for _ in range(steps):
        act_j, act_p = twin(lambda: np.asarray(pj(ej), float), lambda: np.asarray(pp(ep), float))
        (_, rj, tj, _, _), (_, rp, tp, _, _) = twin(lambda: ej.step(np.clip(act_j, lo, hi)),
                                                    lambda: ep.step(np.clip(act_p, lo, hi)))
        for k, v in (("actions_j", act_j), ("actions_p", act_p), ("rewards_j", rj), ("rewards_p", rp),
                     ("terminated_j", tj), ("terminated_p", tp)):
            rec[k].append(v)
        if tj or tp:
            np.random.seed(seed)
            twin(lambda: ej.reset(seed=seed), lambda: ep.reset(seed=seed))
    return aj, ap, {k: np.asarray(v) for k, v in rec.items()}
