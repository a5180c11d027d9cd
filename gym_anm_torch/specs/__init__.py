"""Network-specification layer: schema constants, parsing, validation."""

from .constants import BRANCH_H, BUS_H, DEV_H, STATE_VARIABLES
from .network import NetworkSpec, check_network_specs, load_network

__all__ = [
    "BUS_H",
    "DEV_H",
    "BRANCH_H",
    "STATE_VARIABLES",
    "NetworkSpec",
    "check_network_specs",
    "load_network",
]
