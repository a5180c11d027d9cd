"""A configuration whose exogenous inputs are drawn: IEEE33 with five
renewables under autoreset, its loads drawn with noise on every step and its
clock in the task carry.  Added to a copy of the benchmark by new files and
entries alone (its network, an exogenous rule of its own, traffic and
limits), it runs and is checked with no file edited; the check comes out
false where one lane's recorded draw is altered, where the hour carry is left
unadvanced, and where a reset lane reports a wrong fresh start."""

import json
import math
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from harness import cell, check
from harness.spec import BENCH_DIR, ROOT, Spec

CONFIG, TRAFFIC = "ieee33_renewable", "rollout-autoreset-b48"
WORKLOAD = f"{CONFIG}-{TRAFFIC}"
SEED = 2147483713
FRESH_LANES = 4  # lanes carried in as terminated, so the autoreset resets them on the first step

# The rule a drawn configuration brings: the step's loads are the draw it
# recorded, its clock advances by delta_t / 3600 h in float32, and a fresh
# start is at time 0 and hour [0, 24), its load flow that of the set-points
# and the tap it reports.
RULE = '''"""Exogenous rule ``diurnal_draw``: the recorded draw, an hour carry."""

import torch

from reference import grid


def inputs(ref, d):
    n_load, n_gen = len(ref.net.loads), len(ref.net.gens)
    draw = d["draw"]
    return draw[:, :n_load], draw[:, n_load:n_load + n_gen], draw[:, n_load + n_gen:]


def carry_flips(ref, d, aux):
    (hour_in,), (hour_out,) = d["task_in"], d["task_out"]
    return (hour_out != (hour_in + ref.task["delta_t"] / 3600.0) % 24.0) | (d["aux_out"] != aux).any(1)


def fresh_start(ref, r, gaps):
    net = ref.net
    nd, n_des, n_gen = net.n_dev, len(net.des), len(net.gens)
    (hour,) = r["task_out"]
    bad = (r["t_out"] != 0) | r["terminated_out"] | (hour < 0) | (hour >= 24)
    obs = r["obs"]
    P, Q = obs[:, :nd], obs[:, nd:2 * nd]
    g, s = net.gens, net.des
    soc_lo = torch.as_tensor(net.soc_min[s], device=obs.device)
    soc_hi = torch.as_tensor(net.soc_max[s], device=obs.device)
    action = torch.cat([P[:, g], Q[:, g], P[:, s], Q[:, s], Q[:, net.caps], r["tap_out"]], 1)
    p_pot = obs[:, 2 * nd + n_des:2 * nd + n_des + n_gen]
    out = grid.step(net, ref.task, dict(soc=torch.where(P[:, s] <= 0, soc_lo, soc_hi),
                                        terminated=torch.zeros_like(bad)),
                    action, P[:, net.loads], p_pot, r["aux_out"])
    vm_gap = (r["vm"] - torch.complex(out["v_re"], out["v_im"]).abs()).abs().amax(1)
    cols = [k for k in range(obs.shape[1]) if not (2 * nd <= k < 2 * nd + n_des)]
    obs_gap = ((obs[:, cols] - out["obs"][:, cols]).abs() / (1.0 + out["obs"][:, cols].abs())).amax(1)
    gaps.take("vm_gap", vm_gap.max())
    gaps.take("obs_gap", obs_gap.max())
    lim = lambda k: gaps.limits.get(k, float("inf"))  # noqa: E731
    return bad | out["done"] | ~(vm_gap <= lim("vm_gap")) | ~(obs_gap <= lim("obs_gap"))
'''


def _json_number(v):
    return None if v is None or math.isnan(float(v)) else float(v)


def _frozen_network():
    """The port's IEEE33-renewable network in gym-anm's format, with the
    task's tiered branch rates (p.u.) written into the rate column in MVA."""
    from gym_anm_torch.networks import create_renewable_network
    from gym_anm_torch.vec import tasks

    net = create_renewable_network()
    rows = {k: [[_json_number(v) for v in row] for row in np.asarray(net[k], dtype=object).tolist()]
            for k in ("bus", "device", "branch")}
    base = float(net["baseMVA"])
    for row, rate in zip(rows["branch"], tasks.make_ieee33_renewable_task().rates):
        row[5] = float(rate) * base
    return {"note": "frozen by the test from gym_anm_torch's create_renewable_network()",
            "network": {"baseMVA": base, **rows}}


def _files(root):
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """A copy of the benchmark with the new configuration's files and
    entries added; returns (its root, the bytes of every file it had)."""
    root = tmp_path_factory.mktemp("checkout")
    bench = root / "benchmark"
    shutil.copytree(BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    before = _files(root)
    (bench / "reference" / f"{CONFIG}_network.json").write_text(json.dumps(_frozen_network()))
    (bench / "reference" / "exogenous" / "diurnal_draw.py").write_text(RULE)
    config = {"name": CONFIG, "source": "test", "reduced": [], "task": "make_ieee33_renewable_task",
              "dtype": "float32", "observation": "state",
              "reference": {"network": CONFIG, "delta_t": 1.0, "gamma": 0.99, "lamb": 100,
                            "costs_clipping": [None, None], "exogenous": "diurnal_draw"}}
    (bench / "configs" / f"{CONFIG}.json").write_text(json.dumps(config))
    (bench / "traffic" / f"{TRAFFIC}.json").write_text(json.dumps(
        {"batch": 48, "policy": {"kind": "uniform"}, "autoreset": True, "warmup_steps": 4, "checked_warmup": 1,
         "check_steps": 3, "check_within": 8, "trace_steps": 4}))
    shutil.copy(BENCH_DIR / "limits" / "ieee33-rollout-b262144.json", bench / "limits" / f"{WORKLOAD}.json")
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": CONFIG, "source": "test", "file": f"benchmark/configs/{CONFIG}.json",
                           "reduced": [], "why": "test"})
    doc["workloads"].append({"name": WORKLOAD, "config": CONFIG, "traffic": TRAFFIC, "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    return root, before


def test_rule_found_by_name(monkeypatch, checkout):
    """The whole run of the new cell is correct, with no file edited."""
    from harness import cli

    root, before = checkout
    spec = Spec(root, root / "benchmark")
    monkeypatch.setattr(cell, "check_steps", lambda traffic, seed: {0, 1, 2})
    result = cli.measure(spec, WORKLOAD, SEED, 0.3, 0, time.perf_counter(), device="cpu")
    assert result["correct"] is True and result["failed"] == 0, result["compared"]
    assert set(result["compared"]) == set(spec.limits(WORKLOAD))
    after = _files(root)
    assert [str(k) for k, v in before.items() if after[k] != v] == ["BENCHMARK.json"]  # entries added


def test_an_unknown_kind_names_the_file_it_looked_for(checkout):
    root, _ = checkout
    with pytest.raises(FileNotFoundError, match=r"exogenous/no_such_kind\.py"):
        check.exogenous_rule("no_such_kind", root / "benchmark")


def _altered_draw(monkeypatch, loop):
    """One lane's recorded draw doubled after the step used it."""
    loop.captures[1]["draw"][FRESH_LANES + 1] *= 2.0


def _unadvanced_hour(monkeypatch, loop):
    from gym_anm_torch.vec.tasks import DiurnalLoads

    orig = DiurnalLoads.from_noise

    def from_noise(self, hour, z):
        return orig(self, hour, z)[0], hour

    monkeypatch.setattr(DiurnalLoads, "from_noise", from_noise)


def _wrong_fresh_start(monkeypatch, loop):
    """Every reset reports its first lane's voltages off by 1e-2 p.u."""
    from gym_anm_torch.vec.core import VecEnv

    orig = VecEnv.reset

    def reset(self, n, generator=None, oltc_tap=None):
        state, obs = orig(self, n, generator, oltc_tap)
        vm = state.bus_vm.clone()
        vm[0] += 1e-2
        return state._replace(bus_vm=vm), obs

    monkeypatch.setattr(VecEnv, "reset", reset)


def _judged(checkout, monkeypatch, fault=None, n_steps=3):
    """(readings, verdict) of ``n_steps`` checked steps of the new cell on the
    CPU, its first ``FRESH_LANES`` lanes carried in as terminated."""
    root, _ = checkout
    spec = Spec(root, root / "benchmark")
    w = spec.workload(WORKLOAD)
    config, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
    loop = cell.Loop(*cell.make_cell(config, traffic, SEED, "cpu"))
    terminated = loop.state.terminated.clone()
    terminated[:FRESH_LANES] = True
    loop.state = loop.state._replace(terminated=terminated)
    if fault in (_unadvanced_hour, _wrong_fresh_start):
        fault(monkeypatch, loop)
    for _ in range(n_steps):
        loop.step(capture=True)
    if fault is _altered_draw:
        fault(monkeypatch, loop)
    steps = [check.observe(c, i < 1, "cpu") for i, c in enumerate(loop.captures)]
    limits = spec.limits(WORKLOAD)
    readings, failed = check.judge(check.Reference(config, traffic, spec.bench_dir), steps, limits)
    return readings, failed, check.verdict(readings, limits), steps


def test_drawn_steps_and_fresh_starts_are_correct(monkeypatch, checkout):
    readings, failed, correct, steps = _judged(checkout, monkeypatch)
    assert correct and failed == 0, readings
    assert readings["reset_lanes"] == FRESH_LANES
    d = steps[1]
    (hour_in,), (hour_out,) = d["task_in"], d["task_out"]
    assert hour_in.dtype == torch.float32 and bool((hour_out != hour_in).all())
    n_load = 32
    assert d["draw"].shape == (48, n_load + 5) and bool((d["draw"][:, :n_load] < 0).all())


@pytest.mark.parametrize("fault", [_altered_draw, _unadvanced_hour, _wrong_fresh_start])
def test_a_faulty_draw_carry_or_fresh_start_is_not_correct(monkeypatch, checkout, fault):
    readings, failed, correct, _ = _judged(checkout, monkeypatch, fault)
    assert not correct and failed > 0, readings
    if fault is _unadvanced_hour:
        assert readings["state_flips"] > 0
    else:
        assert readings["vm_gap"] > 4e-3


RULES = sorted(p.stem for p in (BENCH_DIR / "reference" / "exogenous").glob("*.py") if p.stem != "__init__")


@pytest.mark.parametrize("kind", RULES)
def test_a_rule_loads_nothing_of_the_program_or_jax(kind):
    from harness import guard

    code = (f"from harness import check\ncheck.exogenous_rule({kind!r})\n"
            "import sys, json\nprint(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH_DIR, capture_output=True, text=True, timeout=120,
                         check=True)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert guard.loaded(guard.FORBIDDEN | {"gym_anm_torch"}, mods) == []
