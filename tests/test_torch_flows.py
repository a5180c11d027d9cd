"""gym_anm_torch's flows, the transition's work after the load flow, on the
CPU: the plain route (``transition_flows_plain``, the plain version of the
CUDA kernel K6, and ``flows_from_currents`` on the float64 tier) against the
arithmetic it was factored from (``flows_oracle``), bit for bit on every
field and on the slack columns it writes in place, in 4-step rollouts of
the three measured tasks and on made-up voltages with diverged lanes; the
CPU and the float64 tier take the plain route and launch and count nothing;
K6's wrapper refuses what it does not take before it loads the library.
The file imports no JAX."""

import importlib

import numpy as np
import pytest
import torch

from gym_anm_torch.physics.flows_cuda import transition_flows_cuda
from gym_anm_torch.physics.transition import transition_flows_plain
from gym_anm_torch.utils import profiling
from gym_anm_torch.vec import VecEnv, make_anm6easy_task, make_ieee33_multicap_task, make_ieee33_task

from . import flows_oracle

transition_module = importlib.import_module("gym_anm_torch.physics.transition")  # the name is shadowed

torch.set_num_threads(2)

TASKS = {"ieee33": make_ieee33_task, "multicap17": make_ieee33_multicap_task, "anm6easy": make_anm6easy_task}
B = 48
IN_PLACE = (8, 9, 10, 11)  # bus_p, bus_q, dev_p, dev_q among transition_flows_plain's arguments


def _bits(x):
    return x.view(torch.int64 if x.dtype == torch.float64 else torch.int32)


def _assert_same(got, want, what):
    assert got.shape == want.shape and got.dtype == want.dtype, what
    same = (_bits(got) == _bits(want)) | (torch.isnan(got) & torch.isnan(want))
    assert bool(same.all()), f"{what}: {int((~same).sum())} entries differ"


def _lane_taps(tb, tap_new):
    tap_magn = tb.tap0.expand(tap_new.shape[0], -1).clone()
    tap_magn[:, tb.oltc_branch] = tap_new
    return tap_magn


def _oracle_chord(tb, v_re, v_im, F, p_ns, q_ns, dy, tap_new, bus_p, bus_q, dev_p, dev_q, p_pot, rates):
    """The oracle on ``transition_flows_plain``'s arguments (the in-place ones
    already copied); the generators' set-points are in ``dev_p``."""
    i_re, i_im = flows_oracle.chord_currents(tb, v_re, v_im, F, p_ns, q_ns, dy)
    p_g = dev_p[:, tb.gen_pos] if tb.gen_project is not None else p_pot
    return flows_oracle.finish(tb, v_re, v_im, i_re, i_im, _lane_taps(tb, tap_new), bus_p, bus_q, dev_p, dev_q,
                               p_pot, p_g, rates)


def _spy(real, oracle, calls):
    """``real`` checked against ``oracle`` on copies of the in-place
    arguments at each call, field by field and on those arguments after."""
    def call(tb, *args):
        copies = [a.clone() if i in IN_PLACE else a for i, a in enumerate(args, start=1)]
        got = real(tb, *args)
        want = oracle(tb, *copies)
        for name, g, w in zip(got._fields, got, want):
            _assert_same(g, w, name)
        for i in IN_PLACE:
            _assert_same(args[i - 1], copies[i - 1], f"argument {i} written in place")
        calls.append(args[0].shape[0])
        return got
    return call


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("task", sorted(TASKS))
def test_plain_flows_equal_the_oracle_bit_for_bit(task, dtype, monkeypatch):
    """4 steps of each task at B = 48 from random actions: on the chord tier
    (float32) ``transition_flows``, on the float64 tier
    ``flows_from_currents``, each held to the oracle at every step."""
    env = VecEnv(TASKS[task](), dtype=dtype, device="cpu")
    calls = []
    if dtype == torch.float32:
        assert env.tables.chord is not None
        real = transition_module.transition_flows
        monkeypatch.setattr(transition_module, "transition_flows", _spy(real, _oracle_chord, calls))
    else:
        real = transition_module.flows_from_currents
        monkeypatch.setattr(transition_module, "flows_from_currents", _spy(real, flows_oracle.finish, calls))
    g = torch.Generator().manual_seed(23)
    state, obs = env.reset(B, g)  # ANM6Easy's reset runs transitions too
    before = len(calls)
    policy = env.random_policy()
    for k in range(4):
        state, obs, reward, done, info = env.step(state, policy(g, obs, k), g)
    assert calls[before:] == [B] * 4


def _made_up(task, dtype, rng):
    """``transition_flows_plain``'s arguments for ``task``'s tables: voltages
    around 1 (the slack's too), small mismatches, injections and set-points, taps in range, lane 1
    with a NaN voltage, lane 2 an inf one, lane 3 zero voltages, lane 4 a
    zero tap; per-lane rates."""
    env = VecEnv(TASKS[task](), dtype=dtype, device="cpu")
    tb = env.tables
    N, Ne, n_dev, G = tb.n_bus, tb.n_branch, tb.n_dev, int(tb.gen_pos.numel())
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype)  # noqa: E731
    n = 64
    v_re, v_im = t(1 + 0.05 * rng.standard_normal((n, N))), t(0.05 * rng.standard_normal((n, N)))
    v_re[1, 5], v_im[2, 3] = float("nan"), float("inf")
    v_re[3], v_im[3] = 0.0, 0.0
    n_oltc = int(tb.oltc_branch.numel())
    tap_new = t(rng.uniform(0.9, 1.1, (n, n_oltc)))
    if n_oltc:
        tap_new[4] = 0.0
    args = (v_re, v_im, t(1e-5 * rng.standard_normal((n, 2 * (N - 1)))), t(0.1 * rng.standard_normal((n, N - 1))),
            t(0.1 * rng.standard_normal((n, N - 1))), tuple(t(rng.standard_normal(n)) for _ in range(4)), tap_new,
            t(rng.standard_normal((n, N))), t(rng.standard_normal((n, N))), t(rng.standard_normal((n, n_dev))),
            t(rng.standard_normal((n, n_dev))), t(rng.uniform(0, 1, (n, G))), t(rng.uniform(0, 0.05, (n, Ne))))
    return tb, args


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("task", sorted(TASKS))
def test_plain_flows_on_diverged_lanes(task, dtype):
    """Made-up inputs with NaN, inf and zero voltages and a zero tap: the
    plain route equals the oracle bit for bit, the NaN lane's slack
    injection is +inf in the four slack columns, and its reward NaN."""
    tb, args = _made_up(task, dtype, np.random.default_rng(5))
    copies = [a.clone() if i in IN_PLACE else a for i, a in enumerate(args, start=1)]
    got = transition_flows_plain(tb, *args)
    want = _oracle_chord(tb, *copies)
    for name, g, w in zip(got._fields, got, want):
        _assert_same(g, w, name)
    for i in IN_PLACE:
        _assert_same(args[i - 1], copies[i - 1], f"argument {i}")
    bus_p, dev_p = args[7], args[9]
    assert bus_p[1, tb.slack_bus] == float("inf") and dev_p[1, tb.slack_dev] == float("inf")
    assert bool(torch.isnan(got.reward[1])) and bool(torch.isfinite(got.reward[5:]).all())


def test_cpu_and_float64_tier_take_the_plain_route():
    """Steps on the CPU at float32 (the chord tier) and float64 launch no K6
    and count no ``flows.lanes``; the transition's spans record as before."""
    launches = transition_flows_cuda.launch_count
    for dtype in (torch.float32, torch.float64):
        env = VecEnv(make_ieee33_multicap_task(), dtype=dtype, device="cpu")
        g = torch.Generator().manual_seed(3)
        state, obs = env.reset(8, g)
        with profiling.recording():
            env.step(state, env.random_policy()(g, obs, 0), g)
        rep = profiling.report()
        assert "flows.lanes" not in rep["counters"] and rep["spans"]["transition.flows"]["count"] == 1
    assert transition_flows_cuda.launch_count == launches


def test_k6_wrapper_refuses_cpu_tensors_before_loading_the_library(monkeypatch):
    """The wrapper checks the device, the dtype and the contiguity before it
    loads the library (which needs nvcc)."""
    import gym_anm_torch._build as build

    monkeypatch.setattr(build, "load_library", lambda: pytest.fail("loaded the library"))
    tb, args = _made_up("ieee33", torch.float32, np.random.default_rng(2))
    with pytest.raises(ValueError, match="CUDA device"):
        transition_flows_cuda(tb, *args)
    with pytest.raises(ValueError, match="chord constants"):
        transition_flows_cuda(tb._replace(chord_t=None), *args)


def _nudge(x, lane, n_ulps, mag):
    """``x`` with its ``lane`` moved up by ``n_ulps`` float32 ulps of ``mag``."""
    m = mag[lane].float().abs()
    ulp = float(torch.nextafter(m, torch.tensor(float("inf"))) - m)
    y = x.clone()
    y[lane] = y[lane] + n_ulps * ulp
    return y


@pytest.mark.parametrize("task", sorted(TASKS))
def test_flows_probe_compare_holds_the_kernel_to_the_plain_version(task):
    """``flows_probe.compare``, the check chip_smoke and the card tests run
    on K6, here on two runs of the plain version: equal outputs pass with
    no gap; an elementwise output one bit off, a slack column's neighbour
    changed, or a reward 6 ulps of its terms' magnitudes off are refused; a
    reward 2 ulps off passes and is the gap returned."""
    from gym_anm_torch.bench import flows_probe

    tb, args = _made_up(task, torch.float32, np.random.default_rng(9))
    ka, pa = flows_probe.copy_args(args), flows_probe.copy_args(args)
    k, p = tuple(transition_flows_plain(tb, *ka)), transition_flows_plain(tb, *pa)
    assert flows_probe.compare(tb, args, k, ka, p, pa) == 0.0

    lane = 10  # a lane with finite voltages
    flipped = k[8].clone()
    flipped.view(torch.int32)[lane, 0] ^= 1
    with pytest.raises(AssertionError, match="br_p_to: 1 entries differ"):
        flows_probe.compare(tb, args, k[:8] + (flipped,) + k[9:], ka, p, pa)
    moved = list(ka)
    moved[7] = ka[7].clone()
    moved[7][lane, (tb.slack_bus + 1) % tb.n_bus] += 1.0
    with pytest.raises(AssertionError, match="off its slack column"):
        flows_probe.compare(tb, args, k, tuple(moved), p, pa)
    m_r = flows_probe.magnitudes(tb, args, p)[-1]
    with pytest.raises(AssertionError, match="reward: 1 lanes past 4 ulps"):
        flows_probe.compare(tb, args, k[:13] + (_nudge(k[13], lane, 6, m_r),), ka, p, pa)
    near = _nudge(k[13], lane, 2, m_r)
    assert flows_probe.compare(tb, args, k[:13] + (near,), ka, p, pa) == float((near - p.reward)[lane].abs())
