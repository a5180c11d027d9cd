"""Cross-cutting utilities: checkpointing, metrics, debugging, profiling."""

from .checkpoint import env_state_to_vector, restore_checkpoint, save_checkpoint, vector_to_env_state
from .debug import debug_nans, explain_divergence, forbid_host_syncs, validate_state
from .metrics import RolloutMetrics, log_metrics, nan_guard
from .profiling import Throughput, device_trace

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "env_state_to_vector",
    "vector_to_env_state",
    "RolloutMetrics",
    "log_metrics",
    "nan_guard",
    "debug_nans",
    "forbid_host_syncs",
    "validate_state",
    "explain_divergence",
    "Throughput",
    "device_trace",
]
