"""Exogenous rules, one file a kind, found by the name a configuration gives
in ``reference.exogenous``.  Each provides

* ``inputs(ref, d)``: (P_load, P_pot in MW, aux), float64, of the checked
  step ``d`` (:func:`harness.check.observe`'s dict, a block of lanes);
* ``carry_flips(ref, d, aux)``: the lanes whose carried exogenous state (the
  aux ``d["aux_out"]`` and the task carry ``d["task_out"]``) is not what the
  rule advances it to;
* ``fresh_start(ref, r, gaps)``: of the lanes the program reset (``r``, the
  step's fields at those lanes), those that do not report a fresh start; it
  may widen the gaps it compares.
"""

import torch


def carry_moved(d):
    """The lanes whose task carry differs after the step (bool [B])."""
    moved = d["aux_out"].new_zeros(d["aux_out"].shape[0], dtype=torch.bool)
    for before, after in zip(d["task_in"], d["task_out"]):
        moved |= (before != after).reshape(moved.shape[0], -1).any(1)
    return moved
