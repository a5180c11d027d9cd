"""Vectorized batch-leading environment tier."""

from .core import EnvState, VecEnv, VecTask
from .tasks import make_ieee33_task

__all__ = ["EnvState", "VecEnv", "VecTask", "make_ieee33_task"]
