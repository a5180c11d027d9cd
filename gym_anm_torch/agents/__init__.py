"""Agents of the host tier: the N-stage DC-OPF of the MPC policies
(:mod:`.mpc`), assembled from a :class:`~gym_anm_torch.specs.NetworkSpec`."""

from . import mpc

__all__ = ["mpc"]
