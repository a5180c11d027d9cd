"""Input dictionaries for the shipped distribution networks."""

from .two_bus import network as two_bus_network
from .anm6 import network as anm6_network
from .ieee33 import network as ieee33_network
from .ieee33 import (
    create_renewable_network,
    create_multi_capacitor_network,
    create_unequal_capacitor_network,
)

__all__ = [
    "two_bus_network",
    "anm6_network",
    "ieee33_network",
    "create_renewable_network",
    "create_multi_capacitor_network",
    "create_unequal_capacitor_network",
]
