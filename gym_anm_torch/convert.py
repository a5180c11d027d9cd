"""Carry tables, environment state and controller carries over from the JAX
package.

Every function takes the JAX objects' fields as numpy arrays (``np.asarray``
reads a JAX array without importing jax), so a test can run
``gym_anm_tpu`` and ``gym_anm_torch`` from the same tables, the same state
and the same controller carries, mid-rollout.
"""

import numpy as np
import torch

from .physics.power_flow import ChordConst
from .physics.transition import HOST_FIELDS, GridTables, tables_from_host
from .vec import controllers
from .vec.core import EnvState, tree_map


def tables_from_jax(grid_tables, device="cpu") -> GridTables:
    """The port's :class:`GridTables` from a ``gym_anm_tpu`` ``GridTables``
    (its numpy fields and its ``ChordConst``), at the same dtype.  The
    projectors are rebuilt from the generator and storage half-planes."""
    host = {name: getattr(grid_tables, name) for name in HOST_FIELDS}
    chord = None
    if grid_tables.chord is not None:
        src = grid_tables.chord
        arrays = ("Y0re", "Y0im", "invJ0", "G", "H", "C")
        chord = ChordConst(**{f: np.asarray(getattr(src, f)) if f in arrays else getattr(src, f)
                              for f in ChordConst._fields})
    return tables_from_host(host, chord, np.dtype(grid_tables.dtype), device)


def state_from_jax(env_state, device="cpu") -> EnvState:
    """The port's :class:`EnvState` from the numeric leaves of a batched
    ``gym_anm_tpu`` ``EnvState`` (lanes on the first axis), at their dtypes,
    the task and shaping carries included (tuples stay tuples).  The PRNG
    key is dropped: the port draws from ``torch.Generator``s."""

    def leaf(name):
        return tree_map(lambda x: torch.as_tensor(np.array(x), device=device), getattr(env_state, name))

    return EnvState(
        soc=leaf("soc"),
        oltc_tap=leaf("oltc_tap"),
        dev_p=leaf("dev_p"),
        dev_q=leaf("dev_q"),
        p_pot=leaf("p_pot"),
        bus_vm=leaf("bus_vm"),
        aux=leaf("aux"),
        task=leaf("task"),
        terminated=leaf("terminated"),
        t=leaf("t").to(torch.int32),
        v_guess=leaf("v_guess"),
        shaping=leaf("shaping"),
    )


def carry_from_jax(controller_carry, device="cpu"):
    """The port's controller carry from a batched ``gym_anm_tpu`` one (lanes
    on the first axis), at the same dtypes: a ``_L3Carry``/``_L4Carry``/
    ``_L5Carry`` becomes the port's NamedTuple of that name, L2's bool pair
    and the hysteresis expert's set-points a tensor, ``()`` stays ``()``."""
    if isinstance(controller_carry, tuple):
        leaves = [carry_from_jax(c, device) for c in controller_carry]
        if hasattr(controller_carry, "_fields"):
            return getattr(controllers, type(controller_carry).__name__)(*leaves)
        return tuple(leaves)
    return torch.as_tensor(np.array(controller_carry), device=device)
