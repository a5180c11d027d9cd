"""Random radial feeders of any size, and a task that drives one.

The JAX package's property tests (``tests/test_random_networks.py``) step
feeders drawn by ``random_radial_network`` to show that any network of the
schema runs, not only the shipped ones.  This is the port's own copy of that
generator (it draws the same network from the same numpy generator), so that
code without JAX, the card's tests and ``chip_smoke.py`` among it, can build
the same feeders at sizes the shipped networks do not reach (above 33 buses:
the chord solve's wide kernel and the Gauss-Jordan path in device memory).
"""

import numpy as np

from ..specs import load_network

_NONE = [None] * 7  # QP-flexibility tail columns left unspecified


def random_radial_network(rng, n_bus=None):
    """A random radial feeder: slack at bus 0, each bus b>0 hangs off a
    random earlier bus; loads everywhere, 1-2 renewables, optionally one
    capacitor and one slack-adjacent OLTC.  ``rng`` is a numpy Generator;
    ``n_bus`` defaults to a draw from 3..24."""
    n_bus = n_bus or int(rng.integers(3, 25))
    buses = [[0, 0, 132, 1.04, 1.04]]
    buses += [[b, 1, 33, 1.1, 0.9] for b in range(1, n_bus)]

    branches = []
    has_oltc = bool(rng.random() < 0.5)
    for b in range(1, n_bus):
        f = 0 if b == 1 else int(rng.integers(0, b))
        r = float(rng.uniform(0.005, 0.08))
        x = float(rng.uniform(0.01, 0.15))
        bsh = float(rng.uniform(0.0, 0.02))
        branches.append([f, b, r, x, bsh, 10, 1, 0])

    devices = [[0, 0, 0, None, 500, -500, 500, -500] + _NONE]
    dev_id = 1
    for b in range(1, n_bus):
        p_min = -float(rng.uniform(0.1, 2.0))
        devices.append([dev_id, b, -1, float(rng.uniform(0.1, 0.4)), 0, p_min] + [None] * 9)
        dev_id += 1
    n_rer = int(rng.integers(1, 3))
    for _ in range(n_rer):
        b = int(rng.integers(1, n_bus))
        p_max = float(rng.uniform(0.5, 3.0))
        devices.append([dev_id, b, 2, None, p_max, 0, p_max / 2, -p_max / 2] + _NONE)
        dev_id += 1
    if rng.random() < 0.6:
        b = int(rng.integers(1, n_bus))
        q_max = float(rng.uniform(0.2, 1.5))
        devices.append([dev_id, b, 4, None, 0, 0, q_max, 0] + _NONE)
        dev_id += 1
    if has_oltc:
        # OLTC regulating branch (0, 1): t_bus in the Q/P column, tap
        # bounds in PMAX/PMIN (the reference's column convention).
        devices.append([dev_id, 0, 5, 1, 1.1, 0.9, None, None] + _NONE)
        dev_id += 1

    return {
        "baseMVA": 10,
        "bus": np.array(buses, dtype=float),
        "device": np.array(devices, dtype=object),
        "branch": np.array(branches, dtype=float),
    }


def feeder_vars(network, load_scale, n_steps, rng):
    """Exogenous variables of ``n_steps`` steps, MW, float64 numpy
    [n_steps, n_load + n_gen] in the spec's position order: each load at
    ``load_scale`` × U(0.5, 1) of its ``p_min`` (a feeder's full ``p_min``
    can exceed what its lines carry) and each renewable's potential at
    U(0, 1) of its ``p_max``.  The same table drives every lane."""
    spec = load_network(network)
    base = spec.baseMVA
    p_load = load_scale * rng.uniform(0.5, 1.0, (n_steps, spec.n_load)) * spec.p_min[spec.load_pos] * base
    p_pot = rng.uniform(0.0, 1.0, (n_steps, spec.n_gen)) * spec.p_max[spec.gen_nonslack_pos] * base
    return np.concatenate([p_load, p_pot], axis=1)


def make_feeder_task(network, vars_mw, name="feeder"):
    """A :class:`~gym_anm_torch.vec.core.VecTask` on ``network`` whose step t
    takes row ``t % len(vars_mw)`` of ``vars_mw`` (:func:`feeder_vars`) on
    every lane, from an all-zero initial state; Δt 0.5 h, γ 0.99, λ 100, no
    cost clipping (the JAX package's property tests' task)."""
    import torch

    from ..vec.core import VecTask

    table = np.asarray(vars_mw, np.float64)
    n_state = load_network(network).n_state
    tables = {}  # the table in each (type, device) a step asked for, copied once

    def init_state_fn(generator, n, carry):
        return np.zeros((n, n_state))

    def next_vars_fn(generator, s_t, carry, t):
        key = (s_t.dtype, s_t.device)
        if key not in tables:  # to a card from pinned memory, asynchronously: no step waits on the host
            rows = torch.as_tensor(table, dtype=s_t.dtype)
            tables[key] = rows.pin_memory().to(s_t.device, non_blocking=True) if s_t.is_cuda else rows
        return tables[key][torch.remainder(t.long(), len(table))], carry

    return VecTask(network=network, K=0, delta_t=0.5, gamma=0.99, lamb=100, costs_clipping=(None, None),
                   init_state_fn=init_state_fn, next_vars_fn=next_vars_fn, name=name)
