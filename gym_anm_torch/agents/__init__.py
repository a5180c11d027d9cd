"""Agents of the host tier over a compat ``Simulator``.

* :mod:`.mpc` — the N-stage DC-OPF of the MPC policies, assembled from a
  :class:`~gym_anm_torch.specs.NetworkSpec`, and the MPC agents
  (``MPCAgent``, ``MPCAgentConstant``, ``MPCAgentPerfect``).
* :mod:`.ieee33_controllers` — the canonical 13-dim hierarchy
  (``CorrectedL0``-``CorrectedL5``), exported here.
* :mod:`.multicap_controllers` — 17-dim multi/unequal-capacitor fleet
  controllers (proportional, droop, hierarchical MPC, switching-aware MPC,
  true discrete MPC, size-aware unequal-cap L5), exported here.
* :mod:`.algorithmic_hierarchy`, :mod:`.diversity_hierarchy`,
  :mod:`.ready_hierarchy` and :mod:`.experimental_hierarchies` — the variant
  L0-L5 sets, by module.

Ports of ``gym_anm_tpu.agents``, by the same names.  The controllers are
host numpy (scipy for the SLSQP L5s) and take no ``device``: they follow
their environment's, reading its ``Simulator`` through the host views.
Importing this package imports neither gymnasium nor the compat tier.
"""

from . import (
    algorithmic_hierarchy,
    diversity_hierarchy,
    experimental_hierarchies,
    mpc,
    ready_hierarchy,
)
from .ieee33_controllers import (
    CorrectedL0_Random,
    CorrectedL1_Basic,
    CorrectedL2_VoltageThreshold,
    CorrectedL3_Coordinated,
    CorrectedL4_Predictive,
    CorrectedL5_Optimal,
)
from .mpc import MPCAgent, MPCAgentConstant, MPCAgentPerfect
from .multicap_controllers import (
    L2_DiscreteDroop,
    L2_ProportionalControl_MultiCap,
    L5_EnhancedSwitchingAware,
    L5_HierarchicalMPC_MultiCap,
    L5_SwitchingAwareMPC,
    L5_TrueMPC,
)

__all__ = [
    "mpc",
    "MPCAgent",
    "MPCAgentConstant",
    "MPCAgentPerfect",
    "CorrectedL0_Random",
    "CorrectedL1_Basic",
    "CorrectedL2_VoltageThreshold",
    "CorrectedL3_Coordinated",
    "CorrectedL4_Predictive",
    "CorrectedL5_Optimal",
    "L2_ProportionalControl_MultiCap",
    "L2_DiscreteDroop",
    "L5_HierarchicalMPC_MultiCap",
    "L5_SwitchingAwareMPC",
    "L5_TrueMPC",
    "L5_EnhancedSwitchingAware",
    "algorithmic_hierarchy",
    "diversity_hierarchy",
    "experimental_hierarchies",
    "ready_hierarchy",
]
