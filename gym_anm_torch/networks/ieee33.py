"""The IEEE 33-bus distribution test system and its task variants.

Grid data: MATPOWER ``case33bw`` (Baran & Wu, 1989 — public test-system
data).  The network dictionary is built with the exact same pipeline as the
reference (``gym_anm/envs/ieee33_env/network.py:36-91``), including its
deliberate quirks, which the task environments depend on:

* ALL 37 branches are included — the 5 normally-open tie switches
  (status 0 in MATPOWER) are treated as closed, so the grid is MESHED,
  not radial (network.py:54-60);
* all branch rates are 0.0 → rate 0 p.u. (the renewable task variants
  overwrite them on reset);
* loads are specified as PMIN = −Pd in MW (converted to p.u. by the device
  parser);
* two controllable capacitor banks at buses 8 and 25 and one OLTC on the
  slack branch (0, 1) with tap ∈ [0.9, 1.1].

Variant builders (renewable / multi-capacitor / unequal-capacitor) mirror
``ieee33_renewable_complete.py:9-88``, ``ieee33_multi_capacitor.py:9-72``
and ``ieee33_unequal_capacitors.py:9-83``, including the PMAX-already-in-p.u.
convention for the added renewable generators.
"""

from copy import deepcopy

import numpy as np

BASE_MVA = 10.0
_BASE_KV = 12.66

# (bus_id_1indexed, Pd_kW, Qd_kVAr) from MATPOWER case33bw mpc.bus.
_BUS_LOADS = (
    (1, 0.0, 0.0),
    (2, 100.0, 60.0),
    (3, 90.0, 40.0),
    (4, 120.0, 80.0),
    (5, 60.0, 30.0),
    (6, 60.0, 20.0),
    (7, 200.0, 100.0),
    (8, 200.0, 100.0),
    (9, 60.0, 20.0),
    (10, 60.0, 20.0),
    (11, 45.0, 30.0),
    (12, 60.0, 35.0),
    (13, 60.0, 35.0),
    (14, 120.0, 80.0),
    (15, 60.0, 10.0),
    (16, 60.0, 20.0),
    (17, 60.0, 20.0),
    (18, 90.0, 40.0),
    (19, 90.0, 40.0),
    (20, 90.0, 40.0),
    (21, 90.0, 40.0),
    (22, 90.0, 40.0),
    (23, 90.0, 50.0),
    (24, 420.0, 200.0),
    (25, 420.0, 200.0),
    (26, 60.0, 25.0),
    (27, 60.0, 25.0),
    (28, 60.0, 20.0),
    (29, 120.0, 70.0),
    (30, 200.0, 600.0),
    (31, 150.0, 70.0),
    (32, 210.0, 100.0),
    (33, 60.0, 40.0),
)

# (f_1indexed, t_1indexed, R_ohm, X_ohm) from mpc.branch — all 37 rows,
# including the five tie-switch rows (status column ignored, like the
# reference parser).
_BRANCHES_OHM = (
    (1, 2, 0.0922, 0.047),
    (2, 3, 0.493, 0.2511),
    (3, 4, 0.366, 0.1864),
    (4, 5, 0.3811, 0.1941),
    (5, 6, 0.819, 0.707),
    (6, 7, 0.1872, 0.6188),
    (7, 8, 0.7114, 0.2351),
    (8, 9, 1.03, 0.74),
    (9, 10, 1.044, 0.74),
    (10, 11, 0.1966, 0.065),
    (11, 12, 0.3744, 0.1238),
    (12, 13, 1.468, 1.155),
    (13, 14, 0.5416, 0.7129),
    (14, 15, 0.591, 0.526),
    (15, 16, 0.7463, 0.545),
    (16, 17, 1.289, 1.721),
    (17, 18, 0.732, 0.574),
    (2, 19, 0.164, 0.1565),
    (19, 20, 1.5042, 1.3554),
    (20, 21, 0.4095, 0.4784),
    (21, 22, 0.7089, 0.9373),
    (3, 23, 0.4512, 0.3083),
    (23, 24, 0.898, 0.7091),
    (24, 25, 0.896, 0.7011),
    (6, 26, 0.203, 0.1034),
    (26, 27, 0.2842, 0.1447),
    (27, 28, 1.059, 0.9337),
    (28, 29, 0.8042, 0.7006),
    (29, 30, 0.5075, 0.2585),
    (30, 31, 0.9744, 0.963),
    (31, 32, 0.3105, 0.3619),
    (32, 33, 0.341, 0.5302),
    (21, 8, 2.0, 2.0),
    (9, 15, 2.0, 2.0),
    (12, 22, 2.0, 2.0),
    (18, 33, 0.5, 0.5),
    (25, 29, 0.5, 0.5),
)


def _build_base_network():
    v_base = _BASE_KV * 1e3          # volts
    s_base = BASE_MVA * 1e6          # VA
    z_base = v_base**2 / s_base      # ohms

    bus = []
    for bus_1idx, _, _ in _BUS_LOADS:
        bus_id = bus_1idx - 1
        bus_type = 0 if bus_1idx == 1 else 1
        bus.append([bus_id, bus_type, _BASE_KV, 1.05, 0.95])

    branch = []
    for f1, t1, r_ohm, x_ohm in _BRANCHES_OHM:
        branch.append([f1 - 1, t1 - 1, r_ohm / z_base, x_ohm / z_base, 0.0, 0.0, 1, 0])

    device = [
        # Slack generator, ±999 MW/MVAr bounds (network.py:64-66).
        [0, 0, 0, None, 999, -999, 999, -999, None, None, None, None, None, None, None]
    ]
    dev_id = 1
    for bus_1idx, pd_kw, qd_kvar in _BUS_LOADS[1:]:
        pd = pd_kw / 1000.0  # MW
        qd = qd_kvar / 1000.0
        qp = qd / pd if pd else 0.0
        device.append(
            [dev_id, bus_1idx - 1, -1, qp, 0, -pd, None, None, None, None, None, None, None, None, None]
        )
        dev_id += 1

    # Two controllable capacitor banks for voltage regulation.
    for cap_bus in (8, 25):
        device.append(
            [dev_id, cap_bus, 4, None, 0, 0, 1.0, -1.0, None, None, None, None, None, None, None]
        )
        dev_id += 1

    # OLTC on the slack branch (0, 1), tap in [0.9, 1.1].
    device.append([dev_id, 0, 5, 1, 1.1, 0.9, None, None, None, None, None, None, None, None, None])

    return {
        "baseMVA": BASE_MVA,
        "bus": np.array(bus, dtype=float),
        "device": np.array(device, dtype=object),
        "branch": np.array(branch, dtype=float),
    }


network = _build_base_network()


def _renewable_device(dev_id, bus, p_max_pu):
    """One renewable generator row.  NOTE: PMAX here is already in p.u.
    (power_MW / baseMVA) and the device parser divides by baseMVA again —
    a reference quirk kept for parity (ieee33_renewable_complete.py:35,63)."""
    q_max = p_max_pu * 0.4
    return [
        dev_id, bus, 2, None,
        p_max_pu, 0.0, q_max, -q_max,
        p_max_pu * 0.7, None, q_max * 0.8, -q_max * 0.8,
        None, None, None,
    ]


def create_renewable_network():
    """IEEE33 + 5 renewables: solar 0.5 MW @ buses 5, 11, 29; wind 1.0 MW @
    14, 30 (ieee33_renewable_complete.py:9-88)."""
    net = deepcopy(network)
    devices = net["device"].tolist()
    next_id = int(max(d[0] for d in devices)) + 1
    for bus in (5, 11, 29):
        devices.append(_renewable_device(next_id, bus, 0.5 / net["baseMVA"]))
        next_id += 1
    for bus in (14, 30):
        devices.append(_renewable_device(next_id, bus, 1.0 / net["baseMVA"]))
        next_id += 1
    net["device"] = np.array(devices, dtype=object)
    return net


def _capacitor_device(dev_id, bus, q_max):
    return [
        dev_id, bus, 4, None, 0.0, 0.0, q_max, 0.0,
        None, None, q_max, 0.0, None, None, None,
    ]


def create_multi_capacitor_network():
    """Renewable network + 4 extra capacitors at buses 6, 12, 17, 32
    (ieee33_multi_capacitor.py:9-72) — 6 capacitors total, 17-dim actions."""
    net = create_renewable_network()
    devices = net["device"].tolist()
    next_id = int(max(d[0] for d in devices)) + 1
    for bus, q_max in ((6, 0.15), (12, 0.10), (17, 0.20), (32, 0.15)):
        devices.append(_capacitor_device(next_id, bus, q_max))
        next_id += 1
    net["device"] = np.array(devices, dtype=object)
    return net


def create_unequal_capacitor_network():
    """Renewable network with the 2 stock capacitors replaced by 6 units of
    very different sizes (ieee33_unequal_capacitors.py:9-83).

    NB: the reference removes device IDs 8 and 9 believing them to be the
    stock capacitors, but those IDs are loads (the capacitors are devices
    33 and 34); the resulting env is never actually instantiated upstream
    (its ``__init__`` keeps the renewable network), so we implement the
    documented intent: drop the existing capacitor-bank devices."""
    net = create_renewable_network()
    devices = [d for d in net["device"].tolist() if d[2] != 4]
    next_id = int(max(d[0] for d in devices)) + 1
    for bus, q_max in ((17, 0.30), (24, 0.15), (30, 0.12), (8, 0.05), (12, 0.03), (32, 0.01)):
        devices.append(_capacitor_device(next_id, bus, q_max))
        next_id += 1
    net["device"] = np.array(devices, dtype=object)
    return net
