"""The plain reference against ``gym_anm_torch`` on the CPU, at small
batches, on every layer the correctness check covers: the load flow (bus
voltages), the transition (projections, SoC, reward, termination,
observation), the lanes an autoreset resets, and the MPC controller's
action.  The port's float64 tier stops its load flow at a mismatch of 1e-5,
so the float64 comparisons hold it to what that leaves, not to rounding:
the slack's injection in MW carries up to baseMVA x 1e-5."""

import pytest
import torch

from bench_testkit import WORKLOADS, steps_of
from harness import check
from harness.spec import Spec

# What the port's float64 load flow, stopped at a mismatch of 1e-5 p.u., leaves.
V_TOL, OBS_TOL = 1e-5, 1e-3


def _readings(ref, steps):
    return check.judge(ref, steps, {})[0]


def test_ieee33_step_float64():
    ref, steps = steps_of("ieee33-rollout-b262144", 32, dtype="float64")
    g = _readings(ref, steps)
    assert g["done_flips"] == 0 and g["state_flips"] == 0
    assert g["vm_gap"] < V_TOL and g["va_gap"] < V_TOL
    assert g["obs_gap"] < OBS_TOL and g["reward_gap"] < OBS_TOL


def test_anm6easy_projections_and_storage_float64():
    """Uniform actions over ANM6Easy's box: the generators' and the storage
    unit's set-points land outside their polygons and are projected."""
    ref, steps = steps_of("anm6easy-mpc8-b65536", 64, dtype="float64",
                          traffic={"policy": {"kind": "uniform"}, "autoreset": False})
    g = _readings(ref, steps)
    assert g["done_flips"] == 0 and g["state_flips"] == 0
    assert g["vm_gap"] < V_TOL and g["va_gap"] < V_TOL
    assert g["obs_gap"] < OBS_TOL and g["reward_gap"] < OBS_TOL
    net = ref.net
    moved = 0
    for d in steps:
        P = d["obs"][:, :net.n_dev]
        live = ~d["done"]
        moved += int(((P[:, net.gens] - d["action"][:, :len(net.gens)]).abs().amax(1) > 1e-6)[live].sum())
    assert moved > 0, "no set-point was projected"


def test_anm6easy_reset_lanes_are_checked():
    """Uniform actions collapse ANM6Easy lanes; the autoreset's fresh lanes
    pass the reset check and the other lanes the step's."""
    ref, steps = steps_of("anm6easy-mpc8-b65536", 64, n_steps=12, dtype="float32",
                          traffic={"policy": {"kind": "uniform"}, "autoreset": True}, seed=7)
    resets = sum(int(d["done"].sum()) for d in steps)
    assert resets > 0, "no lane was reset"
    g = _readings(ref, steps)
    assert g["reset_lanes"] == resets
    assert g["state_flips"] == 0 and g["done_flips"] == 0
    assert g["vm_gap"] < 1e-3 and g["obs_gap"] < 1e-2  # float32 near collapse


@pytest.mark.parametrize("chained", [1, 3])
def test_mpc_action_float64(chained):
    """The port's plain ADMM at float64 against the reference's iteration:
    from the port's own carried state, or (chained) from the reference's own
    state carried from the cold start."""
    ref, steps = steps_of("anm6easy-mpc8-b65536", 16, dtype="float64", chained=chained)
    g = _readings(ref, steps)
    assert g["action_gap_mw"] < 1e-6
    assert g["done_flips"] == 0 and g["state_flips"] == 0 and g["vm_gap"] < V_TOL


@pytest.mark.parametrize("workload", WORKLOADS)
def test_float32_port_within_the_cells_limits(workload):
    """The configuration's own precision on the CPU's plain versions is
    correct by the cell's committed limits."""
    ref, steps = steps_of(workload, 64)
    limits = Spec().limits(workload)
    g = _readings(ref, steps)
    assert check.verdict(g, limits), (g, limits)


def test_reference_precision_is_float64():
    from reference import grid

    assert grid.Arith("f64").dtype == torch.float64
    assert grid.Arith("tf32").dtype == torch.float32
    x = torch.tensor([1.0 + 2.0 ** -12, 1.0 + 2.0 ** -10])
    assert grid._tf32(x).tolist() == [1.0, 1.0 + 2.0 ** -10]
