"""Gymnasium-compatible single-env tier (reference API parity, float64).

Port of ``gym_anm_tpu.compat``.  Every environment takes ``device=`` (the
card by default; ``"cpu"`` on request) and runs its float64 transition
there.  Importing this module registers two Gymnasium IDs under the
``gym_anm_torch/`` namespace, so they do not collide with the JAX package's
``ANM6Easy-v0`` and ``IEEE33-v0``::

    import gymnasium as gym
    import gym_anm_torch.compat
    env = gym.make("gym_anm_torch/ANM6Easy-v0", device="cpu")
"""

from gymnasium.envs.registration import register as _register
from gymnasium.envs.registration import registry as _registry

from .anm_env import ANMEnv
from .ieee33 import IEEE33Env

__all__ = ["ANMEnv", "IEEE33Env"]

for _id, _ep in (
    ("gym_anm_torch/ANM6Easy-v0", "gym_anm_torch.compat:ANM6Easy"),
    ("gym_anm_torch/IEEE33-v0", "gym_anm_torch.compat:IEEE33Env"),
):
    if _id not in _registry:
        _register(id=_id, entry_point=_ep)


def __getattr__(name):
    if name in ("ANM6", "ANM6Easy"):
        from . import anm6_easy

        return getattr(anm6_easy, name)
    if name == "IEEE33RenewableEnv":
        from .ieee33_renewable import IEEE33RenewableEnv

        return IEEE33RenewableEnv
    if name == "IEEE33MultiCapacitorEnv":
        from .ieee33_multi_capacitor import IEEE33MultiCapacitorEnv

        return IEEE33MultiCapacitorEnv
    if name == "IEEE33UnequalCapacitorsEnv":
        from .ieee33_unequal_capacitors import IEEE33UnequalCapacitorsEnv

        return IEEE33UnequalCapacitorsEnv
    if name == "IEEE33ProperEnvironment":
        from .ieee33_proper import IEEE33ProperEnvironment

        return IEEE33ProperEnvironment
    if name == "FinalCorrectEnv":
        from .ieee33_legacy import FinalCorrectEnv

        return FinalCorrectEnv
    raise AttributeError(f"module 'gym_anm_torch.compat' has no attribute {name!r}")
