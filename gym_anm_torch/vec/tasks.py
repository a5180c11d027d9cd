"""Vectorized task definitions (batched init_state / next_vars hooks).

Port of ``gym_anm_tpu/vec/tasks.py``.  Each factory returns a
:class:`~gym_anm_torch.vec.core.VecTask`.  Only the base IEEE33 task is
ported so far.
"""

import numpy as np
import torch

from ..networks import ieee33_network
from ..specs.network import load_network
from .core import VecTask

__all__ = ["make_ieee33_task"]


def _ieee33_quirk_s0(spec, K):
    """The base IEEE33 init state: per-unit p_min written into MW slots
    (the reference quirk, ieee33.py:25-37)."""
    n_dev = spec.n_dev
    s0 = np.zeros(spec.n_state + K)
    for k in range(n_dev):
        if spec.dev_type[k] == 0:
            continue
        p = spec.p_min[k]
        qp = spec.qp_ratio[k]
        q = p * qp if not np.isnan(qp) else 0.0
        s0[int(spec.dev_ids[k])] = p
        s0[n_dev + int(spec.dev_ids[k])] = q
    return s0


def make_ieee33_task():
    """Base IEEE33 voltage control: static grid, 3-dim action
    [Q_cap8, Q_cap25, tap].  Deterministic: s0 is the constant quirk table
    and the exogenous variables are zeros."""
    spec = load_network(ieee33_network)
    K = 0
    s0 = _ieee33_quirk_s0(spec, K)
    n_vars = spec.n_load + spec.n_gen + K

    def init_state_fn(generator, n, carry):
        return np.broadcast_to(s0, (n, s0.size))

    def next_vars_fn(generator, s_t, carry, t):
        return torch.zeros(s_t.shape[0], n_vars, dtype=s_t.dtype, device=s_t.device), carry

    return VecTask(
        network=ieee33_network, K=K, delta_t=1.0, gamma=0.99, lamb=100,
        costs_clipping=None, init_state_fn=init_state_fn,
        next_vars_fn=next_vars_fn, name="ieee33",
    )
