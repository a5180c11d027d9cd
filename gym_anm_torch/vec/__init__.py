"""Vectorized batch-leading environment tier."""

from .core import EnvState, VecEnv, VecTask
from .tasks import (
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
    "make_two_bus_task",
    "make_ieee33_task",
    "make_ieee33_renewable_task",
    "make_ieee33_multicap_task",
    "make_ieee33_unequal_task",
]
