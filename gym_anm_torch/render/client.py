"""The browser dashboard: a single self-contained HTML page.

Port of ``gym_anm_tpu/render/client.py``: the page is the same, byte for
byte, its title included.
Replacement for the reference's ~790 LoC JS/CSS/SVG client
(``rendering/js/*.js`` + the hand-drawn ``envs/anm6/network.svg``), with one
deliberate upgrade: instead of a fixed drawing that only works for the ANM6
grid, the page builds the one-line diagram from topology shipped in the
``init`` message (bus coordinates computed host-side by a BFS feeder
layout), so ANY network — ANM6, IEEE33, custom grids — renders without
artwork.  Message schema is the reference's (init/update labels,
rendering.py:88-163) plus the topology fields.

Below the diagram sits the per-device gauge panel — one card per device
with signed P/Q bars against the device's |P|max/|Q|max range, a
potential-P marker for curtailable generators, and a SoC fill bar for
storage units: the generic-topology equivalent of the reference
dashboard's per-device injection bars (rendering/js/devices.js
PowerInjection/StorageUnit).
"""

_PAGE = r"""<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8"><title>gym-anm-tpu</title>
<style>
  body { font-family: -apple-system, system-ui, sans-serif; margin: 0;
         background: #fafafa; color: #222; }
  #bar { padding: 10px 16px; background: #1d2733; color: #eee;
         display: flex; gap: 24px; align-items: baseline; }
  #bar h1 { font-size: 16px; margin: 0; }
  #bar .stat { font-size: 13px; opacity: .9; }
  #collapsed { display: none; background: #c0392b; color: #fff;
               padding: 6px 16px; font-weight: 600; }
  svg { display: block; margin: 8px auto; background: #fff;
        border: 1px solid #ddd; }
  .bus { stroke: #333; stroke-width: 1; }
  .branch { stroke-linecap: round; }
  .lbl { font-size: 9px; fill: #555; }
  .dev { font-size: 8px; }
  #devpanel { display: grid; gap: 8px; padding: 8px 16px 20px;
              grid-template-columns: repeat(auto-fill, minmax(210px, 1fr)); }
  .card { background: #fff; border: 1px solid #ddd; border-radius: 6px;
          padding: 6px 10px; font-size: 11px; }
  .card .hd { display: flex; align-items: center; gap: 6px;
              font-weight: 600; margin-bottom: 4px; }
  .chip { width: 9px; height: 9px; border-radius: 2px; display: inline-block; }
  .grow { display: grid; grid-template-columns: 28px 1fr 52px;
          align-items: center; gap: 6px; margin: 3px 0; }
  .grow .val { text-align: right; font-variant-numeric: tabular-nums; }
  .track { position: relative; height: 9px; background: #eef0f2;
           border-radius: 4px; overflow: hidden; }
  .track .mid { position: absolute; left: 50%; top: 0; bottom: 0;
                width: 1px; background: #c5c9cf; }
  .track .fill { position: absolute; top: 0; bottom: 0; border-radius: 2px; }
  .track .pot { position: absolute; top: -1px; bottom: -1px; width: 2px;
                background: #f39c12; }
</style>
</head>
<body>
<div id="bar">
  <h1 id="title">gym-anm-tpu</h1>
  <span class="stat" id="clock">--</span>
  <span class="stat" id="eloss">E-loss: --</span>
  <span class="stat" id="penalty">Penalty: --</span>
</div>
<div id="collapsed">NETWORK COLLAPSED — load flow did not converge</div>
<svg id="net" width="960" height="640" viewBox="0 0 960 640"></svg>
<div id="devpanel"></div>
<script>
const WS_ADDRESS = "__WS_ADDRESS__";
const NS = "http://www.w3.org/2000/svg";
let spec = null, nodes = [], edges = [], devGlyphs = [];

function el(tag, attrs, parent) {
  const e = document.createElementNS(NS, tag);
  for (const k in attrs) e.setAttribute(k, attrs[k]);
  (parent || document.getElementById("net")).appendChild(e);
  return e;
}
function xy(i) {  // spec.busXY in [0,1]^2 -> svg coords with margins
  return [60 + spec.busXY[i][0] * 840, 50 + spec.busXY[i][1] * 540];
}
function vColor(v, lo, hi) {
  if (v < lo || v > hi) return "#c0392b";
  const m = Math.min(v - lo, hi - v) / ((hi - lo) / 2);
  return m > 0.4 ? "#27ae60" : "#e67e22";
}
function sColor(u) {
  return u >= 1 ? "#c0392b" : (u > 0.7 ? "#e67e22" : "#7f8c8d");
}
const DEV_COLOR = {"-1": "#2980b9", "0": "#111", "1": "#8e44ad",
                   "2": "#27ae60", "3": "#d35400", "4": "#16a085",
                   "5": "#2c3e50"};
const DEV_NAME = {"-1": "load", "0": "slack", "1": "gen", "2": "RE",
                  "3": "DES", "4": "cap", "5": "OLTC"};
let cards = [];

function hel(tag, cls, parent) {
  const e = document.createElement(tag);
  if (cls) e.className = cls;
  parent.appendChild(e);
  return e;
}
function gaugeRow(card, label, maxAbs) {  // signed bar, range [-maxAbs, maxAbs]
  const row = hel("div", "grow", card);
  hel("span", "", row).textContent = label;
  const track = hel("div", "track", row);
  hel("div", "mid", track);
  const fill = hel("div", "fill", track);
  const val = hel("span", "val", row);
  return {fill, val, track, maxAbs};
}
function setGauge(g, v, color) {
  const f = Math.min(Math.abs(v) / (g.maxAbs || 1), 1) * 50;
  g.fill.style.background = color;
  g.fill.style.width = f + "%";
  g.fill.style.left = (v >= 0 ? 50 : 50 - f) + "%";
  g.val.textContent = v.toFixed(2);
}

function buildDevPanel(s) {
  // Per-device p/q/SoC gauge cards — the equivalent of the reference
  // dashboard's per-device injection bars + max ticks + potential-P
  // overlay (rendering/js/devices.js PowerInjection/StorageUnit).
  const panel = document.getElementById("devpanel");
  panel.innerHTML = "";
  cards = [];
  let socIdx = 0, potIdx = 0;
  s.devType.forEach((t, d) => {
    const card = hel("div", "card", panel);
    const hd = hel("div", "hd", card);
    hel("span", "chip", hd).style.background = DEV_COLOR[t] || "#999";
    const busTag = s.devBus ? ` @ bus ${s.busIds[s.devBus[d]]}` : "";
    hd.appendChild(document.createTextNode(
      `${DEV_NAME[t] || "?"} ${d}${busTag}`));
    const c = {t};
    c.p = gaugeRow(card, "P", s.pMax[d]);
    c.p.val.title = `|P| ≤ ${s.pMax[d].toFixed(1)} MW`;
    c.q = gaugeRow(card, "Q", s.qMax[d]);
    c.q.val.title = `|Q| ≤ ${s.qMax[d].toFixed(1)} MVAr`;
    if (t === 1 || t === 2) {        // curtailable gen: potential-P marker
      c.pot = hel("div", "pot", c.p.track);
      c.potIdx = potIdx++;
    }
    if (t === 3) {                   // storage: SoC fill 0..socMax
      c.soc = gaugeRow(card, "SoC", s.socMax[socIdx] || 1);
      c.socIdx = socIdx++;
    }
    cards.push(c);
  });
}

function updateDevPanel(m) {
  cards.forEach((c, d) => {
    const p = m.pInjections[d], q = m.qInjections[d];
    setGauge(c.p, p, p >= 0 ? "#27ae60" : "#2980b9");
    setGauge(c.q, q, q >= 0 ? "#16a085" : "#8e44ad");
    if (c.pot && m.pPotential) {
      const pp = m.pPotential[c.potIdx];
      const f = Math.min(Math.abs(pp) / (c.p.maxAbs || 1), 1) * 50;
      c.pot.style.left = (pp >= 0 ? 50 + f : 50 - f) + "%";
    }
    if (c.soc && m.socStorage) {
      const soc = m.socStorage[c.socIdx];
      const fr = Math.min(soc / (c.soc.maxAbs || 1), 1) * 100;
      c.soc.fill.style.background = "#d35400";
      c.soc.fill.style.left = "0%";
      c.soc.fill.style.width = fr + "%";
      c.soc.val.textContent = soc.toFixed(1);
    }
  });
}

function build(s) {
  spec = s;
  document.getElementById("title").textContent = s.title + " — gym-anm-tpu";
  const svg = document.getElementById("net");
  svg.innerHTML = "";
  nodes = []; edges = []; devGlyphs = [];
  buildDevPanel(s);
  if (!s.busXY || !s.branchFrom) {  // no topology: gauges only
    svg.style.display = "none";
    return;
  }
  svg.style.display = "block";
  edges = s.branchFrom.map((f, k) => {
    const [x1, y1] = xy(f), [x2, y2] = xy(s.branchTo[k]);
    const line = el("line", {x1, y1, x2, y2, class: "branch",
                             stroke: "#7f8c8d", "stroke-width": 2.5});
    const lbl = el("text", {x: (x1 + x2) / 2, y: (y1 + y2) / 2 - 4,
                            class: "lbl", "text-anchor": "middle"});
    return {line, lbl};
  });
  nodes = s.busIds.map((b, i) => {
    const [x, y] = xy(i);
    const c = el("circle", {cx: x, cy: y, r: 7, class: "bus", fill: "#bbb"});
    el("text", {x: x, y: y - 10, class: "lbl", "text-anchor": "middle"})
      .textContent = "bus " + b;
    const vlbl = el("text", {x: x, y: y + 19, class: "lbl vlbl",
                             "text-anchor": "middle"});
    return {c, vlbl};
  });
  devGlyphs = s.devType.map((t, d) => {
    const i = s.devBus[d];
    const [x, y] = xy(i);
    const slot = s.devType.slice(0, d).filter((_, j) => s.devBus[j] === i).length;
    const gx = x + 14 + 40 * slot, gy = y - 6;
    el("rect", {x: gx, y: gy, width: 10, height: 10, rx: 2,
                fill: DEV_COLOR[t] || "#999"});
    const lbl = el("text", {x: gx + 13, y: gy + 8, class: "dev"});
    lbl.textContent = DEV_NAME[t] || "?";
    return {lbl, t};
  });
}

function update(m) {
  if (!spec) return;
  document.getElementById("collapsed").style.display =
    m.networkCollapsed ? "block" : "none";
  const t = m.time;
  document.getElementById("clock").textContent =
    `month ${t[0]} day ${t[1]}  ${String(t[2]).padStart(2, "0")}:` +
    `${String(t[3]).padStart(2, "0")}  (+${m.yearCount}y)`;
  document.getElementById("eloss").textContent =
    "E-loss: " + m.reward[0].toFixed(3);
  document.getElementById("penalty").textContent =
    "Penalty: " + m.reward[1].toFixed(3);
  updateDevPanel(m);
  if (!nodes.length) return;  // gauges-only mode (no topology)
  m.vMagn.forEach((v, i) => {
    nodes[i].c.setAttribute("fill", vColor(v, spec.vMin[i], spec.vMax[i]));
    nodes[i].vlbl.textContent = v.toFixed(3);
  });
  m.sFlows.forEach((s, k) => {
    const rate = spec.sRate[k];
    const u = rate > 0 && rate < 1e8 ? Math.abs(s) / rate : 0;
    edges[k].line.setAttribute("stroke", sColor(u));
    edges[k].lbl.textContent = Math.abs(s).toFixed(2);
  });
  let soc_i = 0;
  m.pInjections.forEach((p, d) => {
    const g = devGlyphs[d];
    let txt = DEV_NAME[g.t] + " " + p.toFixed(2);
    if (g.t === 3) txt += ` [${m.socStorage[soc_i++].toFixed(1)}]`;
    g.lbl.textContent = txt;
  });
}

function connect() {
  const ws = new WebSocket(WS_ADDRESS);
  ws.onmessage = (ev) => {
    const m = JSON.parse(ev.data);
    if (m.messageLabel === "init") build(m);
    else if (m.messageLabel === "update") update(m);
  };
  ws.onclose = () => setTimeout(connect, 1000);
}
connect();
</script>
</body>
</html>
"""


def render_page(ws_address: str) -> bytes:
    return _PAGE.replace("__WS_ADDRESS__", ws_address).encode()
