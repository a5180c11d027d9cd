"""Rendering entry points: ``start`` / ``update`` / ``close``.

Port of ``gym_anm_tpu/render/rendering.py``, unchanged in behaviour.
Equivalents of the reference's ``rendering/py/rendering.py:12-175`` on the
stdlib server stack (:mod:`.ws`, :mod:`.http_server`): ``start`` spins up
the HTTP + WebSocket servers, opens a browser tab, and publishes the init
message; ``update`` publishes one state frame per step; ``close`` shuts
both servers down.  Differences from the reference (deliberate):

* servers are daemon threads, not forked processes (fork + a live CUDA
  context is unsafe; threads also shut down with the env);
* ``update`` broadcasts in-process instead of opening a new client TCP
  connection per frame (rendering.py:110,144 pays a WS handshake every
  env step);
* the init message carries the network topology + a host-computed feeder
  layout, so the dashboard renders any grid, not just the hand-drawn ANM6.
"""

import json
import webbrowser

from .client import render_page
from .http_server import HttpServer
from .ws import WsServer


def feeder_layout(n_bus, branch_from, branch_to, slack=0):
    """[n_bus, 2] coordinates in [0,1]²: BFS depth from the slack on x,
    siblings spread on y — distribution feeders are near-radial, so this
    gives a readable one-line diagram for any of the shipped grids."""
    adj = {i: [] for i in range(n_bus)}
    for f, t in zip(branch_from, branch_to):
        adj[int(f)].append(int(t))
        adj[int(t)].append(int(f))
    depth = {slack: 0}
    order = [slack]
    frontier = [slack]
    while frontier:
        nxt = []
        for u in frontier:
            for v in adj[u]:
                if v not in depth:
                    depth[v] = depth[u] + 1
                    order.append(v)
                    nxt.append(v)
        frontier = nxt
    # Disconnected buses (shouldn't happen in a valid grid) land at x=0,
    # after the BFS-reached ones so every bus gets a coordinate.
    missing = [i for i in range(n_bus) if i not in depth]
    for i in missing:
        depth[i] = 0
    max_d = max(depth.values()) or 1
    # y: position within each depth level, stable by BFS order.
    by_level = {}
    coords = [None] * n_bus
    for v in order + missing:
        lvl = depth[v]
        k = by_level.get(lvl, 0)
        by_level[lvl] = k + 1
        coords[v] = [lvl, k]
    out = []
    for v in range(n_bus):
        lvl, k = coords[v]
        width = by_level[lvl]
        y = (k + 0.5) / width
        out.append([lvl / max_d, y])
    return out


# Hand-tuned one-line-diagram layout for the ANM6 grid, mirroring the
# spatial arrangement of the reference's hand-drawn dashboard artwork
# (envs/anm6/network.svg): the 132 kV substation on the left, the 33 kV
# trunk 0→1→2 running right, the {house+PV} lateral below bus 1, the
# {factory+wind} lateral below bus 2, and the {EV+storage} feeder
# continuing right.  Passed as ``topology["busXY"]`` by the ANM6 envs;
# other grids fall back to :func:`feeder_layout`.
ANM6_LAYOUT = {
    0: [0.05, 0.45],
    1: [0.32, 0.45],
    2: [0.58, 0.45],
    3: [0.32, 0.85],
    4: [0.58, 0.85],
    5: [0.88, 0.45],
}


def start(title, dev_type, p_max, q_max, s_rate, v_magn_min, v_magn_max,
          soc_max, costs_range, topology=None, open_browser=True):
    """Start the dashboard servers and publish the init message
    (rendering.py:12-107 equivalent; returns (http_server, ws_server)).

    ``topology``: optional dict with busIds, devBus, branchFrom, branchTo —
    enables the generic one-line diagram; an optional ``busXY`` entry
    ({bus_id: [x, y] in [0,1]²}) overrides the automatic feeder layout
    (e.g. :data:`ANM6_LAYOUT`).  Without topology the page shows only the
    scalar panels.
    """
    ws_server = WsServer()
    http_server = HttpServer(render_page(ws_server.address))

    init = {
        "messageLabel": "init",
        "title": title,
        "devType": list(map(int, dev_type)),
        "pMax": list(map(float, p_max)),
        "qMax": list(map(float, q_max)),
        "sRate": [float(s) if s is not None else 1e9 for s in s_rate],
        "vMin": list(map(float, v_magn_min)),
        "vMax": list(map(float, v_magn_max)),
        "socMax": list(map(float, soc_max)),
        "costsRange": [float(costs_range[0]), float(costs_range[1])],
    }
    if topology is not None:
        bus_ids = list(map(int, topology["busIds"]))
        bf = list(map(int, topology["branchFrom"]))
        bt = list(map(int, topology["branchTo"]))
        pos = {b: i for i, b in enumerate(bus_ids)}
        xy = topology.get("busXY")
        if xy is not None:
            bus_xy = [list(map(float, xy[b])) for b in bus_ids]
        else:
            bus_xy = feeder_layout(
                len(bus_ids), [pos[f] for f in bf], [pos[t] for t in bt]
            )
        init.update(
            busIds=bus_ids,
            devBus=[pos[int(b)] for b in topology["devBus"]],
            branchFrom=[pos[f] for f in bf],
            branchTo=[pos[t] for t in bt],
            busXY=bus_xy,
        )
    ws_server.broadcast(json.dumps(init))

    print(f"Rendering the environment at: {http_server.address}")
    if open_browser:
        try:
            webbrowser.open(http_server.address)
        except Exception:
            pass
    return http_server, ws_server


def update(ws_server, cur_time, year_count, p, q, s, soc, p_potential,
           bus_v_magn, costs, network_collapsed):
    """Publish one state frame (rendering.py:110-165 message schema).

    ``ws_server`` is the WsServer returned by :func:`start` (broadcasts
    in-process); a ``ws://...`` address string also works for
    out-of-process publishers.
    """
    message = json.dumps(
        {
            "messageLabel": "update",
            "time": [cur_time.month, cur_time.day, cur_time.hour, cur_time.minute],
            "yearCount": int(year_count),
            "pInjections": list(map(float, p)),
            "qInjections": list(map(float, q)),
            "sFlows": list(map(float, s)),
            "socStorage": list(map(float, soc)),
            "pPotential": list(map(float, p_potential)),
            "vMagn": list(map(float, bus_v_magn)),
            "reward": [float(costs[0]), float(costs[1])],
            "networkCollapsed": bool(network_collapsed),
        }
    )
    if isinstance(ws_server, str):
        from .ws import WsClient

        client = WsClient(ws_server)
        client.send(message)
        client.close()
    else:
        ws_server.broadcast(message)


def close(http_server, ws_server):
    """Shut both servers down (rendering.py:168-175)."""
    if http_server is not None:
        http_server.stop()
    if ws_server is not None:
        ws_server.stop()
