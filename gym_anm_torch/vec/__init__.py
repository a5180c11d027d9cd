"""Vectorized batch-leading environment tier.

Submodules: :mod:`.controllers` (the L0-L5 suite), :mod:`.experts` (the
heuristic expert zoo), :mod:`.mpc` (the batched DC-OPF MPC controllers and
their ADMM solve; its CUDA kernel's wrapper is :mod:`.admm_cuda`), :mod:`.obs`
(observation plans), :mod:`.tasks` (task factories), and lazily
:class:`GymVectorEnv` (:mod:`.gym_vector`, the Gymnasium vector API over
the farm; it imports gymnasium).
"""

from .core import EnvState, VecEnv, VecTask
from .mpc import make_vec_mpc, make_vec_mpc_perfect
from .obs import ObsPlan, make_obs_plan
from .tasks import (
    make_anm6easy_task,
    make_ieee33_multicap_task,
    make_ieee33_renewable_task,
    make_ieee33_task,
    make_ieee33_unequal_task,
    make_two_bus_task,
)

__all__ = [
    "EnvState",
    "VecEnv",
    "VecTask",
    "ObsPlan",
    "make_obs_plan",
    "make_vec_mpc",
    "make_vec_mpc_perfect",
    "make_two_bus_task",
    "make_ieee33_task",
    "make_ieee33_renewable_task",
    "make_ieee33_multicap_task",
    "make_ieee33_unequal_task",
    "make_anm6easy_task",
    "GymVectorEnv",
]


def __getattr__(name):
    # Lazy: the Gymnasium adapter pulls in gymnasium, which the rest of the
    # batched tier never imports.
    if name == "GymVectorEnv":
        from .gym_vector import GymVectorEnv

        return GymVectorEnv
    raise AttributeError(f"module 'gym_anm_torch.vec' has no attribute {name!r}")
