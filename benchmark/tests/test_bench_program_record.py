"""The readers of the program's own spans and counters: found by name, and a
traced CPU run reports the counter metrics at the values of the program's
record (its device-time metrics read nothing without a card)."""

import pytest

from bench_testkit import measure
from harness.spec import Spec

SPAN_METRICS = ["env_ms_per_step", "transition_pre_ms_per_step", "transition_post_ms_per_step",
                "sync_idle_ms_per_step"]
COUNTER_METRICS = {"chord_iters_per_lane": ("chord.lane_iterations", "chord.lanes", 1.0),
                   "fallback_lane_pct": ("newton.lanes", "chord.lanes", 100.0),
                   "admm_sweeps_per_lane": ("admm.sweeps", "admm.lanes", 1.0)}
CELLS = {"ieee33-rollout-b262144": (16, 5), "anm6easy-mpc8-b65536": (8, 7)}


def test_readers_found_by_name():
    spec = Spec()
    names = SPAN_METRICS + list(COUNTER_METRICS)
    assert all(callable(spec.reader(n)) for n in names)
    for workload, (_, n_new) in CELLS.items():
        reported = {m["name"] for m in spec.metrics(workload, "per_layer")}
        assert len(reported & set(names)) == n_new


@pytest.mark.parametrize("workload", list(CELLS))
def test_traced_run_reports_the_program_counters(monkeypatch, workload):
    from gym_anm_torch.utils import profiling

    result = measure(monkeypatch, workload, CELLS[workload][0], trace=1)
    counters = profiling.report()["counters"]
    metrics = result["metrics"]
    expected = {n: scale * counters[num] / counters[den] for n, (num, den, scale) in COUNTER_METRICS.items()
                if den in counters}
    assert expected and {n: metrics[n]["value"] for n in expected} == expected
    spec = Spec()
    traced_steps = spec.traffic(spec.workload(workload)["traffic"])["trace_steps"]
    assert counters["chord.lanes"] == CELLS[workload][0] * traced_steps  # the traced window's steps alone
    assert not set(SPAN_METRICS) & set(metrics)  # device times: none without a card
