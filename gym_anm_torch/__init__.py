"""gym-anm-torch: the batched Active Network Management environments in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

A port of :mod:`gym_anm_tpu` (JAX), which stays the reference.  This
package imports neither jax nor gym_anm_tpu.  So far it covers the base
IEEE33 batched step: network specs, the Y-bus, the chord-Newton load flow
with its exact Newton-Raphson fallback (whose linear solve is the CUDA
kernel ``csrc/gauss_jordan.cu`` on the card), the transition, and
:class:`~gym_anm_torch.vec.VecEnv` with :func:`~gym_anm_torch.vec.make_ieee33_task`.
"""

from . import errors
from .specs import NetworkSpec, check_network_specs, load_network

__version__ = "0.1.0"

__all__ = [
    "errors",
    "NetworkSpec",
    "check_network_specs",
    "load_network",
]
