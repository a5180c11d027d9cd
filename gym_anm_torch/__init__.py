"""gym-anm-torch: the batched Active Network Management environments in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

A port of :mod:`gym_anm_tpu` (JAX), which stays the reference.  This
package imports neither jax nor gym_anm_tpu.  It covers the batched step of
the base IEEE33 task, the renewable family (multicap17 among them), ANM6Easy
and the two-bus example: network specs, the Y-bus, the set-point
projections, the chord-Newton load flow (on the card one launch of the CUDA
kernel ``csrc/chord_newton.cu``) with its exact Newton-Raphson fallback
(whose linear solve is the CUDA kernel ``csrc/gauss_jordan.cu``), the
transition, :class:`~gym_anm_torch.vec.VecEnv` with observation plans,
autoreset and rollouts, the offline-RL collection path: the L0-L5
controllers and the expert zoo (``vec.controllers``, ``vec.experts``) and
the dataset collectors (``offline_vec``), the batched DC-OPF MPC farm
(``vec.mpc``), and the learners: data-parallel PPO over the env farm and
offline CQL over ``torch.distributed`` (``parallel``), with the utilities
they save and trace through (``utils``: checkpoints, metrics, debugging,
profiling) and their entry points (``scripts``: ``python -m
gym_anm_torch.scripts.train_ppo_online``, ``train_cql_offline``).  The
single-env tier sits over the same transition: the float64
:class:`~gym_anm_torch.env.Simulator`, the Gymnasium environments of
:mod:`gym_anm_torch.compat` (ANM6Easy, IEEE33 and its variants, registered
as ``gym_anm_torch/ANM6Easy-v0`` and ``gym_anm_torch/IEEE33-v0``), the host
MPC agents (``agents.MPCAgent*``) and the Gymnasium vector adapter
``vec.GymVectorEnv``; the modules that subclass Gymnasium's classes import
it, and ``import gym_anm_torch`` does not.
"""

from . import errors
from .specs import NetworkSpec, check_network_specs, load_network

__version__ = "0.1.0"

__all__ = [
    "errors",
    "NetworkSpec",
    "check_network_specs",
    "load_network",
]


def __getattr__(name):
    # Lazy: the compat tier imports gymnasium, which ``import gym_anm_torch``
    # must not (the card's machine may lack it); the agents pull in scipy.
    if name in ("ANMEnv", "ANM6", "ANM6Easy", "IEEE33Env", "IEEE33RenewableEnv",
                "IEEE33MultiCapacitorEnv", "IEEE33UnequalCapacitorsEnv", "IEEE33ProperEnvironment",
                "FinalCorrectEnv"):
        from . import compat

        return getattr(compat, name)
    if name in ("MPCAgent", "MPCAgentConstant", "MPCAgentPerfect"):
        from . import agents

        return getattr(agents, name)
    raise AttributeError(f"module 'gym_anm_torch' has no attribute {name!r}")
