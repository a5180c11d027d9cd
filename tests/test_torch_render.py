"""The port's renderer (``gym_anm_torch.render`` and ``ANM6.render``): the
counterparts of ``test_rendering.py``, of the static JS gates of
``test_rendering_client_js.py`` and of ``test_rendering_browser.py`` on its
in-repo JS interpreter (``tests/minijs.py``), and parity with the JAX
package's renderer.

Every server binds port 0 on 127.0.0.1 and is closed in ``finally``; the
browser tab is patched out.  Parity: ANM6Easy of both packages (the port's
on the CPU) reset with the same seed and stepped with the same 8 actions
from a numpy generator publish equal init frames and update frames within
1e-8 on every float field (equal ``time``, ``yearCount`` and
``networkCollapsed``), and ``render_page`` returns the same bytes.
"""

import contextlib
import datetime
import json
import re
import socket
import time
import urllib.request

import numpy as np
import pytest
import torch

import gym_anm_torch.compat as tc
import gym_anm_torch.render.rendering as rmod
from gym_anm_torch.render import WsClient, close, feeder_layout, start, update
from gym_anm_torch.render.client import render_page
from gym_anm_torch.render.ws import WsServer

from .minijs import MiniJSPage, js_str
from .test_rendering_client_js import BUILTINS, KEYWORDS, lex_js

torch.set_num_threads(2)

ATOL = 1e-8
EXACT_FIELDS = ("messageLabel", "time", "yearCount", "networkCollapsed")


@contextlib.contextmanager
def no_browser(*modules):
    """``webbrowser.open`` of each rendering module patched out."""
    orig = [m.webbrowser.open for m in modules]
    for m in modules:
        m.webbrowser.open = lambda *a, **k: None
    try:
        yield
    finally:
        for m, o in zip(modules, orig):
            m.webbrowser.open = o


# --- test_rendering.py ------------------------------------------------------

def test_ws_broadcast_and_init_replay():
    server = WsServer()
    try:
        server.broadcast(json.dumps({"messageLabel": "init", "title": "t"}))  # before any client

        c1 = WsClient(server.address)
        assert json.loads(c1.recv())["messageLabel"] == "init"  # replayed

        server.broadcast(json.dumps({"messageLabel": "update", "x": 1}))
        assert json.loads(c1.recv())["x"] == 1

        c2 = WsClient(server.address)  # a late joiner still gets init
        assert json.loads(c2.recv())["messageLabel"] == "init"
        c1.close()
        c2.close()
    finally:
        server.stop()


def test_ws_client_to_server_relay():
    """Out-of-process publishers (``WsClient.send``) reach viewers.  A frame
    published before the server has registered the viewer is dropped by
    design (only init replays), so the publisher re-sends until one lands,
    as an env does every step."""
    server = WsServer()
    try:
        viewer = WsClient(server.address, timeout=5.0)
        publisher = WsClient(server.address, timeout=5.0)
        deadline = time.time() + 60.0
        got = None
        while got is None:
            publisher.send(json.dumps({"messageLabel": "update", "k": 42}))
            try:
                got = json.loads(viewer.recv())
            except TimeoutError:
                assert time.time() < deadline, "relay never delivered a frame"
        assert got["k"] == 42
        viewer.close()
        publisher.close()
    finally:
        server.stop()


def test_feeder_layout_properties():
    xy = feeder_layout(11, list(range(0, 10)), list(range(1, 11)))
    arr = np.array(xy)
    assert len(xy) == 11
    assert arr.min() >= 0 and arr.max() <= 1
    assert len({tuple(p) for p in xy}) == 11
    assert xy[0][0] == 0.0 and xy[10][0] == 1.0  # depth maps to x


def test_start_update_close_roundtrip():
    http_server, ws_server = start(
        "TestGrid", [0, -1, 2], [10, 5, 3], [5, 3, 2], [15, 10],
        [0.95, 0.95], [1.05, 1.05], [100.0], (1, 100),
        topology={"busIds": [0, 1], "devBus": [0, 1, 1], "branchFrom": [0], "branchTo": [1]},
        open_browser=False,
    )
    try:
        html = urllib.request.urlopen(http_server.address, timeout=5).read()
        assert b"<svg" in html and ws_server.address.encode() in html

        client = WsClient(ws_server.address)
        init = json.loads(client.recv())
        assert init["messageLabel"] == "init"
        assert init["busXY"] == [[0.0, 0.5], [1.0, 0.5]]
        assert init["devBus"] == [0, 1, 1]

        update(ws_server, datetime.datetime(2026, 8, 16, 12, 30), 0, [1.0, -0.5, 0.2], [0.1, 0.0, 0.0], [0.9],
               [50.0], [0.2], [1.0, 0.98], (0.1, 0.0), False)
        frame = json.loads(client.recv())
        assert frame["messageLabel"] == "update"
        assert frame["vMagn"] == [1.0, 0.98]
        assert frame["networkCollapsed"] is False
        client.close()
    finally:
        close(http_server, ws_server)


def test_layout_override_and_anm6_preset():
    assert sorted(rmod.ANM6_LAYOUT) == [0, 1, 2, 3, 4, 5]
    assert all(0 <= c <= 1 for xy in rmod.ANM6_LAYOUT.values() for c in xy)

    http_server, ws_server = start(
        "Custom", [0, -1], [10, 5], [5, 3], [15], [0.95, 0.95], [1.05, 1.05], [], (1, 100),
        topology={"busIds": [0, 1], "devBus": [0, 1], "branchFrom": [0], "branchTo": [1],
                  "busXY": {0: [0.1, 0.2], 1: [0.9, 0.8]}},
        open_browser=False,
    )
    try:
        client = WsClient(ws_server.address)
        assert json.loads(client.recv())["busXY"] == [[0.1, 0.2], [0.9, 0.8]]
        client.close()
    finally:
        close(http_server, ws_server)


def test_anm6_render_publishes_real_state():
    """``render()`` of the port's ANM6Easy publishes the init frame and an
    update frame a step with the live grid state; ``close()`` stops both
    servers."""
    env = tc.ANM6Easy(device="cpu")
    env.reset(seed=0)
    try:
        with no_browser(rmod):
            env.render()
        client = WsClient(env.ws_server.address)
        init = json.loads(client.recv())
        assert init["messageLabel"] == "init"
        assert len(init["devType"]) == 7 and len(init["busIds"]) == 6

        env.step(env.action_space.sample() * 0)
        env.render()
        frame = json.loads(client.recv())
        assert frame["messageLabel"] == "update"
        assert len(frame["vMagn"]) == 6
        assert all(np.isfinite(frame["pInjections"]))
        client.close()
    finally:
        env.close()
    with pytest.raises(OSError):
        urllib.request.urlopen(env.http_server.address, timeout=2)
    assert not env.is_rendering


def test_device_gauge_panel_in_page():
    html = render_page("ws://x").decode()
    assert 'id="devpanel"' in html
    for needle in ("buildDevPanel", "updateDevPanel", "setGauge", "pPotential", "socStorage", "qInjections"):
        assert needle in html, needle
    script = html.split("<script>")[1].split("</script>")[0]
    for o, c in ("{}", "()", "[]"):
        assert script.count(o) == script.count(c), f"unbalanced {o}{c}"


# --- test_rendering_client_js.py: the static gates on the port's page ---------

@pytest.fixture(scope="module")
def page():
    return render_page("ws://test-address").decode()


@pytest.fixture(scope="module")
def script(page):
    assert page.count("<script>") == 1
    return page.split("<script>")[1].split("</script>")[0]


def test_no_regex_literals_assumption(script):
    code, ok, err = lex_js(script)
    assert ok, err
    assert not re.search(r"[=(,:!&|?{;]\s*/[^/*]", code), "possible regex literal — extend lex_js before using one"


def test_js_lexes_and_brackets_nest(script):
    code, ok, err = lex_js(script)
    assert ok, err
    pairs = {")": "(", "]": "[", "}": "{"}
    stack = []
    for lineno, line in enumerate(code.split("\n"), 1):
        for ch in line:
            if ch in "([{":
                stack.append((ch, lineno))
            elif ch in ")]}":
                assert stack, f"unmatched {ch!r} at line {lineno}"
                op, opline = stack.pop()
                assert op == pairs[ch], f"mis-nested {op!r} (line {opline}) closed by {ch!r} (line {lineno})"
    assert not stack, f"unclosed {stack[-1][0]!r} at line {stack[-1][1]}"


def test_dom_ids_referenced_exist(page, script):
    code, ok, _ = lex_js(script)
    assert ok
    html_ids = set(re.findall(r'id="([^"]+)"', page))
    for m in re.finditer(r'getElementById\(\s*"([^"]+)"\s*\)', script):
        assert m.group(1) in html_ids, f"getElementById({m.group(1)!r})"
    assert len(re.findall(r"getElementById\(", script)) == len(
        re.findall(r'getElementById\(\s*"[^"]+"\s*\)', script)), "non-literal getElementById argument"


def _published_messages():
    """Real init + update messages from the port's producers, captured over
    a live server pair."""
    http_server = ws_server = None
    try:
        http_server, ws_server = start(
            "schema-check", [0, -1, 1, 2, 3], [100.0] * 5, [100.0] * 5, [30.0, 30.0, None, 25.0], [0.95] * 3,
            [1.05] * 3, [50.0], (0.0, 100.0),
            topology={"busIds": [0, 1, 2], "devBus": [0, 1, 1, 2, 2], "branchFrom": [0, 1], "branchTo": [1, 2]},
            open_browser=False,
        )
        client = WsClient(ws_server.address)
        init = json.loads(client.recv())
        update(ws_server, datetime.datetime(2020, 1, 1, 11, 55), 0, [0.0] * 5, [0.0] * 5, [1.0, 1.0], [12.0],
               [55.0, 40.0], [1.0, 1.0, 1.0], (1.0, 2.0), False)
        frame = json.loads(client.recv())
        client.close()
        return init, frame
    finally:
        close(http_server, ws_server)


def test_js_message_schema_matches_python_producers(script):
    code, ok, _ = lex_js(script)
    assert ok
    init, frame = _published_messages()
    init_reads = set(re.findall(r"\b(?:s|spec)\.([A-Za-z_]\w*)", code))
    update_reads = set(re.findall(r"\bm\.([A-Za-z_]\w*)", code))
    assert not init_reads - set(init), f"JS reads init fields Python never sends: {init_reads - set(init)}"
    assert not update_reads - set(frame), f"JS reads update fields Python never sends: {update_reads - set(frame)}"
    for key in ("busXY", "branchFrom", "devType", "pMax", "socMax"):
        assert key in init_reads, f"init key {key!r} no longer consumed by JS"
    for key in ("vMagn", "sFlows", "pInjections", "socStorage", "reward"):
        assert key in update_reads, f"update key {key!r} no longer consumed by JS"


def test_all_called_functions_are_defined(script):
    code, ok, _ = lex_js(script)
    assert ok
    defined = set(re.findall(r"\bfunction\s+([A-Za-z_]\w*)", code))
    defined |= set(re.findall(r"\b(?:const|let|var)\s+([A-Za-z_]\w*)\s*=", code))
    for params in re.findall(r"\bfunction\s+\w*\s*\(([^)]*)\)", code):
        defined |= {p.strip() for p in params.split(",") if p.strip()}
    calls = {m.group(1) for m in re.finditer(r"(?<![.\w])([A-Za-z_]\w*)\s*\(", code)}
    unknown = calls - defined - BUILTINS - KEYWORDS
    assert not unknown, f"undefined function(s) called in page JS: {unknown}"


# --- test_rendering_browser.py on the minijs backend --------------------------

class MiniJSBrowser:
    """The page fetched over the live HTTP server, its script executed by
    ``tests/minijs.py``, and a real WebSocket connection (the port's
    ``WsClient``) feeding every frame to the page's own handler."""

    def __init__(self, url):
        html = urllib.request.urlopen(url, timeout=10).read().decode()
        self.page = MiniJSPage(html)
        assert self.page.sockets, "page script never opened a WebSocket"
        self.client = WsClient(self.page.sockets[-1].address)
        self.client.sock._sock.settimeout(0.25)  # short reads, so pump() can poll

    def pump(self, seconds=0.5):
        deadline = time.time() + seconds
        while time.time() < deadline:
            try:
                msg = self.client.recv()
            except (TimeoutError, socket.timeout):
                break
            self.page.deliver(msg)

    def probe(self, timeout=10.0):
        deadline = time.time() + timeout
        while True:
            self.pump()
            page = self.page
            out = {
                "title": page.text("title"),
                "buses": len(page.query("#net circle.bus")),
                "branches": len(page.query("#net line.branch")),
                "cards": len(page.query("#devpanel .card")),
                "gauges": len(page.query("#devpanel .track .fill")),
                "clock": page.text("clock"),
                "eloss": page.text("eloss"),
                "vlabels": [e.js_get("textContent") for e in page.query("#net text.vlbl") if e.js_get("textContent")],
                "collapsed": js_str(page.root.get_by_id("collapsed").style.display) or "none",
            }
            if out["buses"] or time.time() > deadline:
                return out


def test_dashboard_e2e_anm6easy():
    """The port's ANM6Easy renders in the page: 6 buses, 5 branches, 7
    device cards; a step updates the clock, the reward and 6 voltage labels
    near 1 p.u. that equal the simulator's ``bus_v_magn``."""
    env = tc.ANM6Easy(device="cpu")
    env.reset(seed=0)
    browser = None
    try:
        with no_browser(rmod):
            env.render()
        browser = MiniJSBrowser(env.http_server.address)
        out = browser.probe()
        assert (out["buses"], out["branches"], out["cards"]) == (6, 5, 7), out
        assert out["gauges"] >= 14, out
        assert "ANM6Easy" in out["title"], out
        assert out["collapsed"] == "none", out

        before = out
        env.step(env.action_space.sample() * 0)
        env.render()
        deadline = time.time() + 10.0
        while time.time() < deadline:
            after = browser.probe()
            if after["clock"] != before["clock"]:
                break
        assert after["clock"] != before["clock"], (before, after)
        assert after["eloss"].startswith("E-loss: ") and float(after["eloss"].split(": ")[1]) >= 0.0
        volts = [float(v) for v in after["vlabels"]]
        assert len(volts) == 6 and all(0.5 < v < 1.5 for v in volts), after
        v_sim = list(env.simulator.state["bus_v_magn"]["pu"].values())
        assert [f"{v:.3f}" for v in v_sim] == after["vlabels"], (v_sim, after["vlabels"])
    finally:
        if browser is not None:
            browser.client.close()
        env.close()


def test_dashboard_collapse_banner_and_gauges():
    """Synthetic frames through the port's page JS: a collapsed network shows
    the banner; SoC and potential-P markers land in their gauges."""
    page = MiniJSPage(render_page("ws://127.0.0.1:1").decode())
    page.deliver(json.dumps({
        "messageLabel": "init", "title": "T", "devType": [-1, 2, 3], "pMax": [10.0, 5.0, 20.0],
        "qMax": [4.0, 3.0, 10.0], "sRate": [32.0, 18.0], "vMin": [0.95] * 3, "vMax": [1.05] * 3,
        "socMax": [100.0], "costsRange": [100, 10000], "busIds": [0, 1, 2], "devBus": [1, 1, 2],
        "branchFrom": [0, 1], "branchTo": [1, 2], "busXY": [[0.0, 0.5], [0.5, 0.5], [1.0, 0.5]],
    }))
    assert len(page.query("#net circle.bus")) == 3
    assert len(page.query("#devpanel .card")) == 3
    assert len(page.query("#devpanel .track .fill")) == 7  # 3*2 + 1 SoC
    assert len(page.query("#devpanel .track .pot")) == 1

    upd = {
        "messageLabel": "update", "time": [1, 2, 3, 4], "yearCount": 2, "pInjections": [-8.0, 4.0, -10.0],
        "qInjections": [-2.0, 1.0, -3.0], "sFlows": [33.0, 9.0], "socStorage": [55.0], "pPotential": [5.0],
        "vMagn": [1.0, 0.90, 1.01], "reward": [0.5, 123.4], "networkCollapsed": True,
    }
    page.deliver(json.dumps(upd))
    assert page.root.get_by_id("collapsed").style.display == "block"
    assert page.text("clock") == "month 1 day 2  03:04  (+2y)"
    assert page.text("penalty") == "Penalty: 123.400"
    lines = page.query("#net line.branch")
    assert lines[0].attrs.get("stroke") == "#c0392b"  # over its 32 MVA rating
    assert page.query("#net circle.bus")[1].attrs.get("fill") == "#c0392b"  # under-voltage
    soc_fill = page.query("#devpanel .track .fill")[-1]
    assert abs(float(js_str(soc_fill.style.width).rstrip("%")) - 55.0) < 1e-9
    assert float(js_str(page.query("#devpanel .track .pot")[0].style.left).rstrip("%")) == 100.0

    upd["networkCollapsed"], upd["sFlows"] = False, [10.0, 9.0]
    page.deliver(json.dumps(upd))
    assert page.root.get_by_id("collapsed").style.display == "none"
    assert lines[0].attrs.get("stroke") != "#c0392b"


# --- parity with the JAX package's renderer -----------------------------------

@pytest.mark.parametrize("address", ["ws://test-address", "ws://127.0.0.1:8765"])
def test_render_page_bytes_equal_jax(address):
    from gym_anm_tpu.render.client import render_page as jax_render_page

    assert render_page(address) == jax_render_page(address)


def test_anm6easy_frames_equal_jax():
    import gym_anm_tpu
    import gym_anm_tpu.render.rendering as jmod

    ej, ep = gym_anm_tpu.ANM6Easy(), tc.ANM6Easy(device="cpu")
    ej.reset(seed=0)
    ep.reset(seed=0)
    clients = []
    try:
        with no_browser(jmod, rmod):
            ej.render()
            ep.render()
        clients = [WsClient(ej.ws_server.address), WsClient(ep.ws_server.address)]
        init_j, init_p = (json.loads(c.recv()) for c in clients)
        assert init_j == init_p
        rng = np.random.default_rng(0)
        lo, hi = ej.action_space.low, ej.action_space.high
        for t in range(8):
            a = rng.uniform(lo, hi)
            ej.step(a)
            ep.step(a)
            ej.render()
            ep.render()
            fj, fp = (json.loads(c.recv()) for c in clients)
            assert fj.keys() == fp.keys()
            for k in EXACT_FIELDS:
                assert fj[k] == fp[k], (t, k)
            for k in fj.keys() - set(EXACT_FIELDS):
                np.testing.assert_allclose(fp[k], fj[k], rtol=0, atol=ATOL, err_msg=f"step {t} {k}")
    finally:
        for c in clients:
            c.close()
        ej.close()
        ep.close()
