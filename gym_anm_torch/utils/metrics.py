"""Rollout metric accumulators and host logging.

Port of ``gym_anm_tpu/utils/metrics.py``.  The accumulators are 0-dim
tensors on the rollout's device, updated without a host read; only
:func:`log_metrics` and :func:`nan_guard` read them on the host.
"""

from typing import NamedTuple

import torch
from torch.utils._pytree import tree_leaves

__all__ = ["RolloutMetrics", "log_metrics", "nan_guard"]


class RolloutMetrics(NamedTuple):
    steps: torch.Tensor            # total env-steps accumulated
    reward_sum: torch.Tensor
    e_loss_sum: torch.Tensor
    penalty_sum: torch.Tensor
    violation_steps: torch.Tensor  # steps with a nonzero constraint penalty
    terminations: torch.Tensor
    nr_iter_sum: torch.Tensor      # total load-flow iterations

    @classmethod
    def zero(cls, dtype=torch.float32, device="cuda"):
        z = torch.zeros((), dtype=dtype, device=device)
        return cls(z, z, z, z, z, z, z)

    def update(self, reward, done, info):
        def add(a, x):
            return a + torch.sum(x.to(a.dtype))

        return RolloutMetrics(
            steps=self.steps + reward.numel(),
            reward_sum=add(self.reward_sum, reward),
            e_loss_sum=add(self.e_loss_sum, info["e_loss"]),
            penalty_sum=add(self.penalty_sum, info["penalty"]),
            violation_steps=add(self.violation_steps, info["penalty"] > 0),
            terminations=add(self.terminations, done),
            nr_iter_sum=add(self.nr_iter_sum, info["n_iter"]),
        )

    def summary(self):
        s = torch.clamp(self.steps, min=1)
        return {
            "steps": self.steps,
            "mean_reward": self.reward_sum / s,
            "mean_e_loss": self.e_loss_sum / s,
            "mean_penalty": self.penalty_sum / s,
            "violation_rate": self.violation_steps / s,
            "termination_rate": self.terminations / s,
            "mean_nr_iters": self.nr_iter_sum / s,
        }


def log_metrics(metrics: RolloutMetrics, prefix: str = "rollout"):
    """Print the summary on the host (reads the accumulators)."""
    parts = ", ".join(f"{k}={float(v):.4g}" for k, v in metrics.summary().items())
    print(f"[{prefix}] {parts}")


def nan_guard(tree, name="tree"):
    """Warn if a floating tensor of ``tree`` holds a NaN; returns ``tree``.

    A host check: it reads one flag per tensor, so on the card it waits for
    the device.  (The JAX package defers the print to a ``debug.callback``
    inside the compiled program; eager PyTorch can simply look.)"""
    for leaf in tree_leaves(tree):
        if torch.is_tensor(leaf) and leaf.is_floating_point() and bool(torch.isnan(leaf).any()):
            print(f"[nan_guard] NaN detected in {name}")
            break
    return tree
