"""The flows' byte count (``harness/roofline_flows.py``) for each
configuration against counts written out by hand, and ``flows_roofline``
reading the ``transition.flows`` span and the ``flows.lanes`` counter, and
None where the program has no counter."""

import pytest

from harness import cell, program_record, roofline, roofline_flows
from harness.spec import Spec
from reference import grid

# (lane values, static values a call) by hand: reads + writes, then the rows.
# ieee33: 33 buses, 37 branches, 1 OLTC, 33 loss devices (32 loads + slack).
#   reads 66 V + 64 F + 64 p, q + 1 tap + 32 injections = 227; writes 66 I + 4
#   slack + 333 branch + 3 = 406; rows 333 + 132 + 33.
# multicap17: as ieee33 with 5 generators, 38 loss devices: reads 66 + 64 + 64
#   + 1 + 37 + 5 potentials = 237, writes 406; rows 333 + 132 + 38 + 10.
# anm6easy: 6 buses, 5 branches, no OLTC, 6 loss devices (3 loads, 2
#   generators, slack), 2 generators: reads 12 + 10 + 10 + 0 + 5 + 2 = 39;
#   writes 12 + 4 + 45 + 3 = 64; rows 45 + 24 + 6 + 4.
BY_HAND = {"ieee33": (633, 498), "ieee33-multicap17": (643, 513), "anm6easy": (103, 79)}


@pytest.mark.parametrize("config", sorted(BY_HAND))
def test_byte_count_by_hand(config):
    spec = Spec()
    net, _ = grid.load(spec.config(config)["reference"]["network"])
    lane, static = BY_HAND[config]
    lanes, calls = 262144 * 48, 48
    assert roofline_flows.call_bytes(lanes, calls, net, 4) == 4 * (lanes * lane + calls * static)
    assert roofline_flows.bound_seconds(lanes, calls, net, 4) == 4 * (lanes * lane + calls * static) / roofline.HBM


def test_ieee33_lane_is_about_2_5_kb_and_0_2_ms_at_262144_lanes():
    net, _ = grid.load("ieee33")
    assert roofline_flows.call_bytes(1, 0, net, 4) == 2532
    assert roofline_flows.bound_seconds(262144, 1, net, 4) == pytest.approx(0.198e-3, rel=0.01)


def _fake_run(monkeypatch, config, spans, counters, steps=48):
    record = {"spans": spans, "counters": counters}
    monkeypatch.setattr(program_record, "record", lambda run: record)
    return cell.Run(config=config, trace={"steps": steps}, batch=1024)


def test_flows_roofline_reads_the_span_and_counter(monkeypatch):
    spec = Spec()
    for name in sorted(BY_HAND):
        config = spec.config(name)
        run = _fake_run(monkeypatch, config, {"transition.flows": {"count": 48, "device_ms": 24.0}},
                        {"flows.lanes": 48 * 1024})
        net, _ = grid.load(config["reference"]["network"])
        least = roofline_flows.bound_seconds(48 * 1024, 48, net, 4)
        assert spec.reader("flows_roofline")(run) == pytest.approx(100.0 * least / 24e-3, rel=1e-12)


def test_flows_roofline_finds_nothing_without_the_counter(monkeypatch):
    """A program without K6's counter (the parent's), without the span's
    device time, or a run without a traced window reads None."""
    spec = Spec()
    config = spec.config("ieee33")
    for spans, counters in (({"transition.flows": {"count": 48, "device_ms": 20.0}}, {}),
                            ({"transition.flows": {"count": 48, "device_ms": None}}, {"flows.lanes": 10}),
                            ({}, {"flows.lanes": 10})):
        assert spec.reader("flows_roofline")(_fake_run(monkeypatch, config, spans, counters)) is None
    monkeypatch.undo()
    assert spec.reader("flows_roofline")(cell.Run(config=config, trace=None, batch=1024)) is None


@pytest.mark.parametrize("config", sorted(BY_HAND))
def test_kernel_probe_bound_is_this_count(config):
    """``gym_anm_torch.bench.flows_probe`` (K6 alone on the card) bounds a call
    by this count, read from the port's tables of the configuration's
    network: the two agree on every size they read."""
    import torch

    from gym_anm_torch.bench import flows_probe
    from gym_anm_torch.vec import VecEnv, make_anm6easy_task, make_ieee33_multicap_task, make_ieee33_task

    make = {"ieee33": make_ieee33_task, "ieee33-multicap17": make_ieee33_multicap_task,
            "anm6easy": make_anm6easy_task}[config]
    tb = VecEnv(make(), dtype=torch.float32, device="cpu").tables
    net, _ = grid.load(Spec().config(config)["reference"]["network"])
    for lanes in (1, 262144, 524288):
        assert flows_probe.bound_bytes(tb, lanes) == roofline_flows.call_bytes(lanes, 1, net, 4)
