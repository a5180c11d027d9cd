"""The multicap17 configuration (IEEE33 with five renewables, six capacitor
banks and diurnal noisy loads) on the CPU, at small batches: the port
against the plain reference at float64, with set-points projected and, on
rates cut below the flows, branch penalties paid; the network file against
its source; the diurnal rule against faults of the draw and the carry; a
faulty step; the projections' byte count and the metrics that read the
``transition.project`` span.  The one card test runs the cell through the
harness on the card."""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from bench_testkit import measure, steps_of
from harness import cell, check, program_record, roofline, roofline_project
from harness.spec import BENCH_DIR, Spec
from reference import grid
from test_bench_harness import _altered, _false_done, _unchanged
from test_bench_reference import OBS_TOL, V_TOL

WORKLOAD = "ieee33-multicap17-rollout-b524288"
SEED = 2147483713


def _readings(ref, steps):
    return check.judge(ref, steps, {})[0]


def _generators_projected(ref, steps):
    """The live lanes of ``steps`` whose generator set-points the step moved."""
    net = ref.net
    ng, nd = len(net.gens), net.n_dev
    n = 0
    for d in steps:
        P, Q = d["obs"][:, :nd], d["obs"][:, nd:2 * nd]
        moved = (P[:, net.gens] - d["action"][:, :ng]).abs() + (Q[:, net.gens] - d["action"][:, ng:2 * ng]).abs()
        n += int(((moved.amax(1) > 1e-6) & ~d["done"]).sum())
    return n


def _branch_penalised(ref, steps):
    """The lanes of ``steps`` whose reward the rated branches lower: the
    reference's penalty against the same step with every rate infinite."""
    unrated = grid.load("ieee33_multicap17")[0]
    unrated.br_rate = np.full_like(unrated.br_rate, np.inf)
    n = 0
    for d in steps:
        P_load, P_pot, aux = ref.rule.inputs(ref, d)
        state = dict(soc=d["soc_in"], terminated=d["terminated_in"])
        rated = grid.step(ref.net, ref.task, state, d["action"], P_load, P_pot, aux)["penalty"]
        free = grid.step(unrated, ref.task, state, d["action"], P_load, P_pot, aux)["penalty"]
        n += int((rated > free + 1e-9).sum())
    return n


def _close(g):
    assert g["done_flips"] == 0 and g["state_flips"] == 0
    assert g["vm_gap"] < V_TOL and g["va_gap"] < V_TOL
    assert g["obs_gap"] < OBS_TOL and g["reward_gap"] < OBS_TOL


def test_port_against_reference_float64_projects_and_pays_penalties():
    """Uniform actions: generator set-points land outside their polygons and
    are projected, and lanes pay voltage penalties.  At the nominal loads the
    tiered rates are not reached (the flows stay below 0.6 of them), so no
    lane pays a branch penalty here; the next test cuts the rates."""
    ref, steps = steps_of(WORKLOAD, 32, dtype="float64")
    _close(_readings(ref, steps))
    assert _generators_projected(ref, steps) > 0, "no generator set-point was projected"
    assert sum(int((d["reward"] < 0).sum()) for d in steps) > 0
    assert _branch_penalised(ref, steps) == 0


def test_branch_penalties_float64_where_the_rates_are_cut(monkeypatch):
    """The task's rates and the reference network's cut to a tenth: lanes
    pay branch penalties, and the port charges them as the reference does."""
    make = cell._task
    monkeypatch.setattr(cell, "_task", lambda config: dataclasses.replace(make(config), rates=make(config).rates / 10))
    ref, steps = steps_of(WORKLOAD, 32, dtype="float64")
    ref.net.br_rate = ref.net.br_rate / 10
    _close(_readings(ref, steps))
    assert _branch_penalised(ref, steps) > 0, "no lane paid a branch penalty"


def test_network_file_against_its_source():
    from gym_anm_torch.networks import create_multi_capacitor_network
    from gym_anm_torch.vec import tasks

    raw = json.loads((BENCH_DIR / "reference" / "ieee33_multicap17_network.json").read_text())
    base = json.loads((BENCH_DIR / "reference" / "ieee33_network.json").read_text())["network"]
    net = raw["network"]
    assert net["baseMVA"] == base["baseMVA"] and net["bus"] == base["bus"]
    rate = 5
    assert [r[:rate] + r[rate + 1:] for r in net["branch"]] == [r[:rate] + r[rate + 1:] for r in base["branch"]]
    port = create_multi_capacitor_network()
    assert net["device"] == [[None if v is None else float(v) for v in r] for r in port["device"].tolist()]
    rates = np.array([r[rate] for r in net["branch"]]) / net["baseMVA"]
    assert np.array_equal(rates, tasks.make_ieee33_multicap_task().rates)
    assert raw["diurnal"] == {"base": 0.8, "amplitude": 0.3, "phase_h": 3.0, "noise": 0.02, "load_scale": 1.0}
    parsed = grid.Network(net)
    assert (parsed.n_bus, len(parsed.br_f), parsed.n_dev, parsed.n_action) == (33, 37, 45, 17)
    config = Spec().config("ieee33-multicap17")
    assert (config["buses"], config["branches"], config["devices"], config["action_dim"]) == (33, 37, 45, 17)


# ----------------------------------------------------------------------
# the diurnal rule against faults of the draw and the carry
# ----------------------------------------------------------------------

def _shifted_phase(orig):
    """The daily factor one hour late."""
    def from_noise(self, hour, z):
        return orig(self, hour - 1.0, z)[0], orig(self, hour, z)[1]
    return from_noise


def _no_noise(orig):
    return lambda self, hour, z: orig(self, hour, torch.zeros_like(z))


def _doubled_noise(orig):
    return lambda self, hour, z: orig(self, hour, 2.0 * z)


def _potential(orig):
    """A renewable's potential drawn as 0.1 MW, not 0."""
    def from_noise(self, hour, z):
        out, new_hour = orig(self, hour, z)
        out = out.clone()
        out[:, z.shape[1]] = 0.1
        return out, new_hour
    return from_noise


def _judged(monkeypatch, fault=None, batch=48, n_steps=3):
    from gym_anm_torch.vec.tasks import DiurnalLoads

    if fault is not None:
        monkeypatch.setattr(DiurnalLoads, "from_noise", fault(DiurnalLoads.from_noise))
    ref, steps = steps_of(WORKLOAD, batch, n_steps=n_steps, seed=SEED)
    limits = Spec().limits(WORKLOAD)
    readings, failed = check.judge(ref, steps, limits)
    return readings, failed, check.verdict(readings, limits)


def test_drawn_steps_are_correct(monkeypatch):
    readings, failed, correct = _judged(monkeypatch)
    assert correct and failed == 0, readings


@pytest.mark.parametrize("fault", [_shifted_phase, _no_noise, _doubled_noise, _potential])
def test_a_faulty_draw_is_not_correct(monkeypatch, fault):
    readings, failed, correct = _judged(monkeypatch, fault)
    assert not correct and failed > 0 and readings["state_flips"] > 0, readings


def test_an_altered_recorded_draw_is_not_correct():
    """One lane's recorded draw doubled after the step used it."""
    ref, steps = steps_of(WORKLOAD, 48, seed=SEED)
    steps[1]["draw"][5] *= 2.0
    limits = Spec().limits(WORKLOAD)
    readings, failed = check.judge(ref, steps, limits)
    assert not check.verdict(readings, limits) and failed > 0, readings
    assert readings["vm_gap"] > 4e-3 and readings["state_flips"] > 0


def test_an_unadvanced_hour_is_not_correct(monkeypatch):
    from gym_anm_torch.vec.tasks import DiurnalLoads

    orig = DiurnalLoads.from_noise
    monkeypatch.setattr(DiurnalLoads, "from_noise", lambda self, hour, z: (orig(self, hour, z)[0], hour))
    ref, steps = steps_of(WORKLOAD, 48, seed=SEED)
    readings, failed = check.judge(ref, steps, Spec().limits(WORKLOAD))
    assert readings["state_flips"] == 3 * 48 and failed > 0


def test_a_live_control_breaks_the_reward_limit(monkeypatch):
    """The reward's upper reading: the control (float32 with TF32 products)
    with its load flow solved in float64 and rounded to float32, so every
    lane stays live and its reward is compared; its reward gap lies far
    above the limit, while the program's lies far below."""
    ref, steps = steps_of(WORKLOAD, 64, n_steps=2, seed=SEED)
    limit = Spec().limits(WORKLOAD)["reward_gap"]
    assert _readings(ref, steps)["reward_gap"] < limit / 10
    orig = grid.load_flow

    def float64_load_flow(Yr, Yi, p, q, ar):
        v_re, v_im, ok = orig(Yr.double(), Yi.double(), p.double(), q.double(), grid.Arith("f64"))
        return v_re.to(Yr.dtype), v_im.to(Yr.dtype), ok

    monkeypatch.setattr(grid, "load_flow", float64_load_flow)
    readings = _readings(ref, check.control_steps(ref, steps))
    assert readings["done_flips"] == 0 and readings["reward_gap"] > 3 * limit, readings


@pytest.mark.parametrize("fault", [_unchanged, _altered, _false_done])
def test_a_faulty_step_is_not_correct(monkeypatch, fault):
    from gym_anm_torch.vec.core import VecEnv

    monkeypatch.setattr(VecEnv, "step", fault(VecEnv.step))
    result = measure(monkeypatch, WORKLOAD, 16, seed=SEED)
    assert result["correct"] is False and result["failed"] > 0
    if fault is _false_done:  # the autoreset reset the lane it was told was done
        assert result["compared"]["done_flips"]["value"] > 0 and result["checked"]["reset_lanes"] > 0


def test_a_whole_run_on_the_cpu_is_correct(monkeypatch):
    result = measure(monkeypatch, WORKLOAD, 16, trace=1, seed=SEED)
    assert result["correct"] is True and result["failed"] == 0, result["compared"]
    assert set(result["compared"]) == set(Spec().limits(WORKLOAD))
    assert result["metrics"]["chord_iters_per_lane"]["value"] > 3


# ----------------------------------------------------------------------
# the projections' bytes and their metrics
# ----------------------------------------------------------------------

def test_project_bytes_by_hand():
    # multicap17: 5 generators, no storage, float32; one call a step.
    B, steps = 524288, 24
    points, calls = steps * B * 5, steps
    per_step = B * 5 * (2 + 1 + 2) * 4 + 5 * (7 * 4 + 2)
    assert roofline_project.call_bytes(points, calls, 5, 0, 4) == steps * per_step
    assert roofline_project.bound_seconds(points, calls, 5, 0, 4) == steps * per_step / roofline.HBM
    # ANM6Easy: 2 generators and 1 storage unit, two calls a step.
    B = 65536
    per_step = B * (2 * 5 + 1 * 6) * 4 + 2 * (7 * 4 + 2) + 1 * (10 * 4 + 4)
    assert roofline_project.call_bytes(steps * B * 3, 2 * steps, 2, 1, 4) == steps * per_step


def _fake_run(monkeypatch, config, spans, counters, steps=24):
    record = {"spans": spans, "counters": counters}
    monkeypatch.setattr(program_record, "record", lambda run: record)
    return cell.Run(config=config, trace={"steps": steps}, batch=1024)


def test_project_metrics_read_the_span_and_counter(monkeypatch):
    spec = Spec()
    config = spec.config("ieee33-multicap17")
    run = _fake_run(monkeypatch, config, {"transition.project": {"count": 24, "device_ms": 12.0}},
                    {"project.points": 24 * 1024 * 5})
    assert spec.reader("project_ms_per_step")(run) == 0.5
    least = roofline_project.bound_seconds(24 * 1024 * 5, 24, 5, 0, 4)
    assert spec.reader("project_roofline")(run) == pytest.approx(100.0 * least / 12e-3, rel=1e-12)
    anm6 = _fake_run(monkeypatch, spec.config("anm6easy"), {"transition.project": {"count": 48, "device_ms": 3.0}},
                     {"project.points": 24 * 1024 * 3})
    assert spec.reader("project_roofline")(anm6) == pytest.approx(
        100.0 * roofline_project.bound_seconds(24 * 1024 * 3, 48, 2, 1, 4) / 3e-3, rel=1e-12)


def test_project_metrics_find_nothing_without_the_span(monkeypatch):
    """A program without the span (or a run without a card) reads None."""
    spec = Spec()
    config = spec.config("ieee33-multicap17")
    for spans, counters in (({}, {}), ({"transition.project": {"count": 24, "device_ms": None}},
                                       {"project.points": 10})):
        run = _fake_run(monkeypatch, config, spans, counters)
        assert spec.reader("project_ms_per_step")(run) is None
        assert spec.reader("project_roofline")(run) is None
    monkeypatch.setattr(program_record, "record", lambda run: None)
    assert spec.reader("project_roofline")(cell.Run(config=config, trace=None, batch=8)) is None


@pytest.mark.cuda
def test_the_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from harness import cli

    result = cli.measure(Spec(), WORKLOAD, 2147483731, 2.0, 0, time.perf_counter())
    assert result["correct"] is True and result["failed"] == 0, result["compared"]
    assert result["device"]["platform"] == "gpu"
