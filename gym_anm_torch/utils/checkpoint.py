"""Checkpoint / resume for environment farms and learners.

Port of ``gym_anm_tpu/utils/checkpoint.py``.  Two formats:

* any :class:`~gym_anm_torch.vec.EnvState`, learner ``TrainState`` or
  ``CQLState`` (tensors, modules, ints, in tuples, NamedTuples and dicts) is
  saved with ``torch.save`` as plain tensors and state dicts, and restored
  into the structure of a reference tree, zero-size tensors included (a grid
  without storage has ``soc`` of width 0);
* :func:`env_state_to_vector` / :func:`vector_to_env_state` convert between
  EnvState and the reference's flat s0 layout, so a farm lane can be
  re-hydrated into a compat env, and back.
"""

import copy
import os

import torch
from torch import nn

__all__ = ["save_checkpoint", "restore_checkpoint", "env_state_to_vector", "vector_to_env_state"]


def _saveable(tree):
    if isinstance(tree, nn.Module):
        return {k: v.detach().cpu() for k, v in tree.state_dict().items()}
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _saveable(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [_saveable(v) for v in tree]
    return tree


def _restored(ref, saved):
    if isinstance(ref, nn.Module):
        module = copy.deepcopy(ref)
        module.load_state_dict(saved)
        return module
    if torch.is_tensor(ref):
        return saved.to(ref.device)
    if isinstance(ref, dict):
        return {k: _restored(ref[k], saved[k]) for k in ref}
    if isinstance(ref, (tuple, list)):
        leaves = [_restored(r, s) for r, s in zip(ref, saved)]
        return type(ref)(*leaves) if hasattr(ref, "_fields") else type(ref)(leaves)
    return saved


def _file(path, step):
    return os.path.join(os.fspath(path), f"step_{step}.pt")


def save_checkpoint(path, tree, step: int = 0):
    """Save ``tree`` as ``<path>/step_<step>.pt`` (written to a temporary
    file first, then renamed, so an interrupted save leaves the previous
    checkpoint whole)."""
    os.makedirs(path, exist_ok=True)
    target = _file(path, step)
    torch.save(_saveable(tree), target + ".tmp")
    os.replace(target + ".tmp", target)
    return target


def restore_checkpoint(path, reference_tree, step: int = 0):
    """Restore a tree saved by :func:`save_checkpoint` in the structure of
    ``reference_tree`` (modules are copied, then loaded; tensors land on the
    reference's devices at their saved dtypes)."""
    saved = torch.load(_file(path, step), map_location="cpu", weights_only=True)
    return _restored(reference_tree, saved)


def env_state_to_vector(env, state):
    """EnvState -> the reference's flat s0 layout [dev_p MW, dev_q MVAr, soc
    MWh, gen_p_max MW, aux] (anm_env.py:139-147), lanes on the first axis."""
    return env._state_vector(state.dev_p, state.dev_q, state.soc, state.p_pot, state.aux)


def vector_to_env_state(env, s0, generator=None, oltc_tap=None):
    """Re-hydrate an EnvState from s0 vectors [B, n] (a vector [n] is one
    lane) by replaying the simulator's reset path (Simulator.reset,
    simulator.py:245-316): the transition from the decoded s0.  The task
    carry is drawn from ``generator`` as a reset draws it."""
    # Imported here: the physics and vec modules import this package's tracer.
    from ..physics.transition import solution_guess
    from ..vec.core import EnvState, tree_map

    s0 = torch.as_tensor(s0).to(device=env.device, dtype=env.dtype)
    if s0.dim() == 1:
        s0 = s0.unsqueeze(0)
    n = s0.shape[0]
    if oltc_tap is None:
        oltc_tap = torch.ones(n, env.spec.n_oltc, dtype=env.dtype, device=env.device)
    (P_load, P_max, P_gen, Q_gen, P_des, Q_des, Q_cap, soc_seed, soc_mwh, aux) = env._decode_s0(s0)
    out = env._run_transition(P_load, P_max, P_gen, Q_gen, P_des, Q_des, Q_cap,
                              oltc_tap.reshape(n, -1), soc_seed)
    return EnvState(
        soc=soc_mwh / env.tables.baseMVA,
        oltc_tap=out.oltc_tap,
        dev_p=out.dev_p,
        dev_q=out.dev_q,
        p_pot=out.gen_p_pot,
        bus_vm=torch.sqrt(out.bus_v_re ** 2 + out.bus_v_im ** 2),
        aux=aux,
        task=tree_map(lambda a: a.to(env.device), env.task.init_task_fn(generator, n)),
        terminated=~out.stable,
        t=torch.zeros(n, dtype=torch.int32, device=env.device),
        v_guess=solution_guess(out),
        shaping=env.task.init_shape_fn(n, env.dtype, env.device),
    )
