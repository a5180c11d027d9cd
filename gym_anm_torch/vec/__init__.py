"""Vectorized batch-leading environment tier.

Submodules: :mod:`.controllers` (the L0-L5 suite), :mod:`.experts` (the
heuristic expert zoo), :mod:`.obs` (observation plans), :mod:`.tasks` (task
factories).
"""

from .core import EnvState, VecEnv, VecTask
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
    "make_two_bus_task",
    "make_ieee33_task",
    "make_ieee33_renewable_task",
    "make_ieee33_multicap_task",
    "make_ieee33_unequal_task",
    "make_anm6easy_task",
]
