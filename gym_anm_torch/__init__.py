"""gym-anm-torch: the batched Active Network Management environments in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

A port of :mod:`gym_anm_tpu` (JAX), which stays the reference.  This
package imports neither jax nor gym_anm_tpu.  It covers the batched step of
the base IEEE33 task, the renewable family (multicap17 among them) and the
two-bus example: network specs, the Y-bus, the set-point projections, the
chord-Newton load flow (on the card one launch of the CUDA kernel
``csrc/chord_newton.cu``) with its exact Newton-Raphson fallback (whose
linear solve is the CUDA kernel ``csrc/gauss_jordan.cu``), the transition,
and :class:`~gym_anm_torch.vec.VecEnv` with autoreset and rollouts.
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
