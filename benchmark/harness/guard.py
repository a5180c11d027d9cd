"""The modules that no run of the benchmark may load: JAX, its libraries and
the JAX package the port was made from.  Names are compared whole by their
top level (the part before the first dot): ``gym_anm_torch`` is not
``gym_anm_tpu``."""

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "gym_anm_tpu"})


def loaded(forbidden=FORBIDDEN, modules=None):
    """The forbidden top-level names among the loaded modules, sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(forbidden))
