"""Data parallelism over ``torch.distributed`` and the learners: PPO over the
env farm and offline CQL."""

from .cql import CQLConfig, CQLState, deterministic_action, init_cql_state, make_cql_update, train_cql
from .mesh import all_reduce_sum, broadcast_params, init_distributed, lane_slice, shard_env_state, world
from .ppo import PPOConfig, TrainState, init_train_state, make_train_step

__all__ = [
    "world",
    "lane_slice",
    "shard_env_state",
    "broadcast_params",
    "all_reduce_sum",
    "init_distributed",
    "PPOConfig",
    "TrainState",
    "init_train_state",
    "make_train_step",
    "CQLConfig",
    "CQLState",
    "init_cql_state",
    "make_cql_update",
    "train_cql",
    "deterministic_action",
]
