"""Agents of the host tier: the N-stage DC-OPF of the MPC policies
(:mod:`.mpc`), assembled from a :class:`~gym_anm_torch.specs.NetworkSpec`, and
the MPC agents over a compat ``Simulator`` (``MPCAgent``,
``MPCAgentConstant``, ``MPCAgentPerfect``)."""

from . import mpc
from .mpc import MPCAgent, MPCAgentConstant, MPCAgentPerfect

__all__ = ["mpc", "MPCAgent", "MPCAgentConstant", "MPCAgentPerfect"]
