"""gym_anm_torch network specs against gym_anm_tpu: the numpy-only parser
and validators of the port give the same arrays and raise the same error
classes as the JAX package's."""

import dataclasses

import numpy as np
import pytest

import gym_anm_torch
import gym_anm_tpu
from gym_anm_torch import networks as t_networks
from gym_anm_tpu import networks as j_networks

NETWORKS = ["two_bus_network", "anm6_network", "ieee33_network",
            "create_renewable_network", "create_multi_capacitor_network",
            "create_unequal_capacitor_network"]


def _network(module, name):
    net = getattr(module, name)
    return net() if callable(net) else net


@pytest.mark.parametrize("name", NETWORKS)
def test_load_network_equal_arrays(name):
    j = gym_anm_tpu.load_network(_network(j_networks, name))
    t = gym_anm_torch.load_network(_network(t_networks, name))
    for field in dataclasses.fields(j):
        a, b = getattr(j, field.name), getattr(t, field.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, field.name
            np.testing.assert_array_equal(a, b, err_msg=field.name)
        else:
            assert a == b, field.name
    assert (j.n_state, j.n_action) == (t.n_state, t.n_action)
    for lo_hi_j, lo_hi_t in zip(j.action_bounds(), t.action_bounds()):
        np.testing.assert_array_equal(lo_hi_j, lo_hi_t)


_SLACK = [0, 0, 0, None, 200, -200, 200, -200, None, None, None, None, None, None, None]
_LOAD = [1, 1, -1, 0.2, 0, -10, None, None, None, None, None, None, None, None, None]
_BUS = [[0, 0, 132, 1.1, 0.9], [1, 1, 33, 1.1, 0.9]]
_BRANCH = [[0, 1, 0.1, 0.2, 0, 10, 1, 0]]

# (case, network overrides, expected error class name)
INVALID = [
    ("base_mva", dict(base=0.0), "BaseMVAError"),
    ("no_slack_bus", dict(bus=[[0, 1, 132, 1.1, 0.9], [1, 1, 33, 1.1, 0.9]]), "BusSpecError"),
    ("two_slack_buses", dict(bus=[[0, 0, 132, 1.1, 0.9], [1, 0, 33, 1.1, 0.9]]), "BusSpecError"),
    ("two_slack_devices", dict(device=[_SLACK, [1, 1, 0] + _SLACK[3:]]), "DeviceSpecError"),
    ("slack_device_bus", dict(device=[[0, 1] + _SLACK[2:], _LOAD]), "DeviceSpecError"),
    ("duplicate_bus_id", dict(bus=[[0, 0, 132, 1.1, 0.9], [0, 1, 33, 1.1, 0.9]]), "BusSpecError"),
    ("duplicate_dev_id", dict(device=[_SLACK, [0] + _LOAD[1:]]), "DeviceSpecError"),
    ("vmax_below_vmin", dict(bus=[[0, 0, 132, 1.1, 0.9], [1, 1, 33, 0.9, 1.1]]), "BusSpecError"),
    ("parallel_branch", dict(branch=_BRANCH + [[1, 0, 0.1, 0.2, 0, 10, 1, 0]]), "BranchSpecError"),
    ("branch_endpoint", dict(branch=[[0, 2, 0.1, 0.2, 0, 10, 1, 0]]), "BranchSpecError"),
    ("zero_impedance", dict(branch=[[0, 1, 0.0, 0.0, 0, 10, 1, 0]]), "BranchSpecError"),
    ("load_pmax", dict(device=[_SLACK, [1, 1, -1, 0.2, 5.0] + _LOAD[5:]]), "LoadSpecError"),
    ("gen_pmax", dict(device=[_SLACK, _LOAD, [2, 1, 1, None, -5] + _LOAD[5:]]), "GenSpecError"),
    ("storage_soc_max", dict(device=[_SLACK, [1, 1, 3, None, 50, -50, 50, -50, 30, -30, 25, -25,
                                              None, 0, 0.9]]), "StorageSpecError"),
]


def _net(bus=None, device=None, branch=None, base=100.0):
    return {
        "baseMVA": base,
        "bus": np.array(bus if bus is not None else _BUS),
        "device": np.array(device if device is not None else [_SLACK, _LOAD], dtype=object),
        "branch": np.array(branch if branch is not None else _BRANCH),
    }


@pytest.mark.parametrize("case,overrides,error", INVALID, ids=[c[0] for c in INVALID])
def test_validators_raise_same_error_class(case, overrides, error):
    with pytest.raises(getattr(gym_anm_tpu.errors, error)):
        gym_anm_tpu.load_network(_net(**overrides))
    with pytest.raises(getattr(gym_anm_torch.errors, error)):
        gym_anm_torch.load_network(_net(**overrides))


def test_check_network_specs_accepts_shipped_networks():
    for name in NETWORKS:
        gym_anm_torch.check_network_specs(_network(t_networks, name))
