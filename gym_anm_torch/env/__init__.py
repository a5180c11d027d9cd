"""Host-side environment layer: the ``Simulator`` over the port's transition."""

from .simulator import Simulator

__all__ = ["Simulator"]
