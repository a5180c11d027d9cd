"""The data-parallel layout of the environment farm over ``torch.distributed``.

Port of ``gym_anm_tpu/parallel/mesh.py``.  The env lanes are independent (no
coupling anywhere in the physics), so the farm splits by lane: of B lanes
over W ranks, rank r holds the contiguous block ``[r·B/W, (r+1)·B/W)``.
Parameters are replicated: the same init on every rank, then a broadcast
from rank 0 (:func:`broadcast_params`).  Collectives appear only at the
learner boundary: the sums behind every mean that couples lanes, and the
gradients (:func:`all_reduce_sum`).  Without an initialised process group
the world is one rank and every helper is the identity.  Backends: gloo on
the CPU, nccl on the card (:func:`init_distributed`).
"""

import os

import torch
import torch.distributed as dist

from ..vec.core import tree_map

__all__ = ["world", "lane_slice", "shard_env_state", "broadcast_params", "all_reduce_sum", "init_distributed"]


def world():
    """``(rank, world_size)``; ``(0, 1)`` without an initialised process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def lane_slice(n_lanes: int, rank=None, world_size=None) -> slice:
    """The rank's contiguous block of ``n_lanes`` global lanes (the calling
    rank's by default)."""
    if rank is None:
        rank, world_size = world()
    if n_lanes % world_size:
        raise ValueError(f"{n_lanes} lanes do not split evenly over {world_size} ranks")
    n = n_lanes // world_size
    return slice(rank * n, (rank + 1) * n)


def shard_env_state(state, rank, world_size):
    """The rank's lanes of a batched :class:`~gym_anm_torch.vec.EnvState`
    (or of any carry with the lane on the first axis)."""
    sl = lane_slice(next(_leaves(state)).shape[0], rank, world_size)
    return tree_map(lambda x: x[sl], state)


def _leaves(tree):
    if torch.is_tensor(tree):
        yield tree
    else:
        for t in tree:
            yield from _leaves(t)


def broadcast_params(module, src=0):
    """Rank ``src``'s parameters and buffers on every rank (the counterpart of
    the JAX package's ``replicated`` sharding); the module, updated in place."""
    if dist.is_available() and dist.is_initialized():
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src)
    return module


def all_reduce_sum(tensors):
    """Sum each tensor of ``tensors`` (a list, of one dtype and device) over
    the ranks, in place, with one collective; returns the list.  The identity
    without a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    i = 0
    for t in tensors:
        t.copy_(flat[i: i + t.numel()].view_as(t))
        i += t.numel()
    return tensors


def init_distributed(rank: int, world_size: int, port: int, backend=None):
    """Join the process group at ``tcp://localhost:<port>``: nccl when a card
    is visible, gloo otherwise (or ``backend``).  Under nccl the rank's card
    becomes the current device first: card ``LOCAL_RANK`` where the launcher
    sets it, else ``rank % device_count``, so that ranks on one node hold
    one card each (``"cuda"`` then names it)."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank, world_size=world_size)
    return backend
