"""Exogenous rule ``zeros``: a static task whose every load and generation
potential is drawn as 0 MW on every step, with no auxiliary variable and no
task carry."""

import torch

from reference.exogenous import carry_moved


def inputs(ref, d):
    """(P_load, P_pot MW, aux) of the checked step: zeros, and no aux."""
    B, dev = d["aux_in"].shape[0], d["aux_in"].device
    net = ref.net
    z = torch.zeros(B, 0, dtype=torch.float64, device=dev)
    return (torch.zeros(B, len(net.loads), dtype=torch.float64, device=dev),
            torch.zeros(B, len(net.gens), dtype=torch.float64, device=dev), z)


def carry_flips(ref, d, aux):
    """The lanes whose aux is not the step's, or whose task carry moved."""
    return (d["aux_out"] != aux).any(1) | carry_moved(d)


def fresh_start(ref, r, gaps):
    raise NotImplementedError("a reset under a static task is not checked")
