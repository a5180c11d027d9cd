"""Carry tables, environment state, controller carries and learner states
over from the JAX package.

Every function takes the JAX objects' fields as numpy arrays (``np.asarray``
reads a JAX array without importing jax), so a test can run
``gym_anm_tpu`` and ``gym_anm_torch`` from the same tables, the same state
and the same controller carries, mid-rollout.
"""

import copy

import numpy as np
import torch
from torch import nn

from .parallel.cql import CQLNet, CQLState
from .parallel.ppo import ActorCritic, TrainState
from .physics.power_flow import ChordConst
from .physics.transition import HOST_FIELDS, GridTables, tables_from_host
from .vec import controllers
from .vec.core import EnvState, tree_map


def tables_from_jax(grid_tables, device="cuda") -> GridTables:
    """The port's :class:`GridTables` from a ``gym_anm_tpu`` ``GridTables``
    (its numpy fields and its ``ChordConst``), at the same dtype.  The
    projectors are rebuilt from the generator and storage half-planes."""
    host = {name: getattr(grid_tables, name) for name in HOST_FIELDS}
    chord = None
    if grid_tables.chord is not None:
        src = grid_tables.chord
        arrays = ("Y0re", "Y0im", "invJ0", "G", "H", "C")
        chord = ChordConst(**{f: np.asarray(getattr(src, f)) if f in arrays else getattr(src, f)
                              for f in ChordConst._fields})
    return tables_from_host(host, chord, np.dtype(grid_tables.dtype), device)


def state_from_jax(env_state, device="cuda") -> EnvState:
    """The port's :class:`EnvState` from the numeric leaves of a batched
    ``gym_anm_tpu`` ``EnvState`` (lanes on the first axis), at their dtypes,
    the task and shaping carries included (tuples stay tuples).  The PRNG
    key is dropped: the port draws from ``torch.Generator``s."""

    def leaf(name):
        return tree_map(lambda x: torch.as_tensor(np.array(x), device=device), getattr(env_state, name))

    return EnvState(
        soc=leaf("soc"),
        oltc_tap=leaf("oltc_tap"),
        dev_p=leaf("dev_p"),
        dev_q=leaf("dev_q"),
        p_pot=leaf("p_pot"),
        bus_vm=leaf("bus_vm"),
        aux=leaf("aux"),
        task=leaf("task"),
        terminated=leaf("terminated"),
        t=leaf("t").to(torch.int32),
        v_guess=leaf("v_guess"),
        shaping=leaf("shaping"),
    )


def carry_from_jax(controller_carry, device="cuda"):
    """The port's controller carry from a batched ``gym_anm_tpu`` one (lanes
    on the first axis), at the same dtypes: a ``_L3Carry``/``_L4Carry``/
    ``_L5Carry`` becomes the port's NamedTuple of that name, L2's bool pair
    and the hysteresis expert's set-points a tensor, ``()`` stays ``()``."""
    if isinstance(controller_carry, tuple):
        leaves = [carry_from_jax(c, device) for c in controller_carry]
        if hasattr(controller_carry, "_fields"):
            return getattr(controllers, type(controller_carry).__name__)(*leaves)
        return tuple(leaves)
    return torch.as_tensor(np.array(controller_carry), device=device)


def param_from_jax(tree, name):
    """The leaf of a JAX parameter pytree (nested dicts of numpy-readable
    arrays) that the port's parameter ``name`` holds, in the port's layout: a
    ``"<layer>.weight"`` is the layer's ``"w"`` transposed ([out, in] against
    [in, out]), a ``"<layer>.bias"`` its ``"b"``, any other name a path of
    dict keys (``"log_std"``)."""
    *path, last = name.split(".")
    leaf = {"weight": "w", "bias": "b"}.get(last, last)
    for key in path + [leaf]:
        tree = tree[key]
    a = np.array(tree)
    return a.T if last == "weight" else a


def _load_from_jax(module: nn.Module, tree, device):
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(torch.as_tensor(param_from_jax(tree, name)))
    return module.to(device)


def _moments_from_jax(module, tree, device):
    return {name: torch.as_tensor(param_from_jax(tree, name), device=device) for name, _ in module.named_parameters()}


def _train_state_from_jax(module, ts, device):
    module = _load_from_jax(module, ts.params, device)
    return TrainState(module, _moments_from_jax(module, ts.opt_m, device),
                      _moments_from_jax(module, ts.opt_v, device), int(np.asarray(ts.step)))


def ppo_state_from_jax(ts, device="cuda") -> TrainState:
    """The port's PPO :class:`TrainState` (an :class:`ActorCritic`, Adam's
    moments, the step) from a ``gym_anm_tpu.parallel.TrainState``, at its
    dtype."""
    w1 = np.asarray(ts.params["pi1"]["w"])
    module = ActorCritic(w1.shape[0], np.asarray(ts.params["mu"]["w"]).shape[1], w1.shape[1],
                         torch.from_numpy(np.zeros(0, w1.dtype)).dtype)
    return _train_state_from_jax(module, ts, device)


def cql_state_from_jax(state, device="cuda") -> CQLState:
    """The port's :class:`CQLState` (a :class:`CQLNet` with its moments and
    step, and the target twins) from a ``gym_anm_tpu.parallel.CQLState``."""
    params = state.train.params
    w1 = np.asarray(params["pi"]["l1"]["w"])
    obs_dim, hidden = w1.shape
    act_dim = np.asarray(params["pi"]["mu"]["w"]).shape[1]
    module = CQLNet(obs_dim, act_dim, hidden, torch.from_numpy(np.zeros(0, w1.dtype)).dtype)
    ts = _train_state_from_jax(module, state.train, device)
    target = nn.ModuleDict({"q1": copy.deepcopy(module.q1), "q2": copy.deepcopy(module.q2)})
    target = _load_from_jax(target, state.target_q, device)
    return CQLState(ts, target)
