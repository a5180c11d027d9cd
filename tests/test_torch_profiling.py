"""gym_anm_torch.utils.profiling: the program's tracer.

Off, a span is the one shared null context and a counter does nothing; on
(under ``torch.profiler`` or ``recording()``) the spans nest as the layers
do, the step dispatches the same aten ops as off, the counters equal sums
taken by hand from the solvers' returns, a record starts afresh each time
recording turns on, and nothing records while a CUDA graph captures.  The
last test needs a card: every span has a device interval, the leaves' lie
inside ``env.step``'s, the tracer adds no device activity to the profiler's
trace, and ``report()`` synchronises once, after the recorded steps.  The
file imports no JAX.
"""

import importlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from gym_anm_torch.utils import profiling
from gym_anm_torch.vec import VecEnv, make_anm6easy_task, make_ieee33_task
from gym_anm_torch.vec import mpc

torch.set_num_threads(2)
transition_mod = importlib.import_module("gym_anm_torch.physics.transition")  # the package exports its function

LOAD_FLOW = {"transition.devices", "chord", "newton", "transition.flows"}
IEEE33_PARENTS = {"env.step": [None], "transition": ["env.step"], **{s: ["transition"] for s in LOAD_FLOW}}
MPC_PARENTS = {**IEEE33_PARENTS, "mpc.act": [None], "mpc.solve": ["mpc.act"], "env.autoreset": [None],
               "transition.project": ["transition.devices"]}


@pytest.fixture(autouse=True)
def tracer(monkeypatch):
    """A fresh tracer for each test: records of other tests never show."""
    t = profiling.Tracer()
    monkeypatch.setattr(profiling, "_tracer", t)
    return t


class OpCount(TorchDispatchMode):
    """Counts the aten ops dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def ieee33(B=64, device="cpu"):
    env = VecEnv(make_ieee33_task(), dtype=torch.float32, device=device)
    g = torch.Generator(device=device).manual_seed(7)
    state, _ = env.reset(B, g)
    action = env.action_low + torch.rand(B, env.n_action, generator=g, device=device) * (
        env.action_high - env.action_low)
    return env, state, action


def ieee33_steps(env, state, action, n=2):
    for _ in range(n):
        state, obs, reward, done, info = env.step(state, action)
    return state


def mpc_cell(B=16):
    env = VecEnv(make_anm6easy_task(), dtype=torch.float32, device="cpu")
    ctrl = mpc.make_vec_mpc_perfect(env, gamma=0.995, safety_margin=0.96, planning_steps=8, max_iter=48)
    g = torch.Generator().manual_seed(11)
    state, obs = env.reset(B, g)
    return env, ctrl, g, state, obs, ctrl.init_carry(B)


def mpc_steps(env, ctrl, g, state, obs, carry, n=2):
    for _ in range(n):
        action, carry = ctrl.act(None, state, obs, carry)
        state, obs, reward, done, info = env.step_autoreset_batch(state, action, g)
    return state


@pytest.mark.parametrize("mode", ["off", "profiler", "recording"])
def test_spans_nest_as_the_layers_and_dispatch_the_same_ops(mode):
    """Off: the shared null context and an empty record.  On: IEEE33's step
    and the MPC cell's act and autoreset step give the spans of their
    layers, each inside its parent on the host's clock, and dispatch as
    many aten ops as with recording off."""
    env, state, action = ieee33()
    with OpCount() as off:
        ieee33_steps(env, state, action)
    if mode == "off":
        assert profiling.span("env.step") is profiling.span("chord")
        assert profiling.report()["spans"] == {} and profiling.report()["counters"] == {}
        return
    opened = profile(activities=[ProfilerActivity.CPU]) if mode == "profiler" else profiling.recording()
    with opened, OpCount() as on:
        ieee33_steps(env, state, action)
    assert on.n == off.n
    rep = profiling.report()
    assert {k: v["parents"] for k, v in rep["spans"].items()} == IEEE33_PARENTS
    assert all(v["count"] == 2 for v in rep["spans"].values())
    raw = rep["raw"]
    for s in raw:
        assert s["device_ns"] is None  # no card
        if s["parent"] is not None:
            p = raw[s["parent"]]
            assert p["host_ns"][0] <= s["host_ns"][0] <= s["host_ns"][1] <= p["host_ns"][1]

    cell = mpc_cell()
    with OpCount() as off:
        mpc_steps(*cell)
    with (profile(activities=[ProfilerActivity.CPU]) if mode == "profiler" else profiling.recording()):
        with OpCount() as on:
            mpc_steps(*cell)
    assert on.n == off.n
    spans = profiling.report()["spans"]
    assert {k: v["parents"] for k, v in spans.items()} == MPC_PARENTS
    assert spans["mpc.solve"]["count"] == spans["env.autoreset"]["count"] == 2


def test_span_and_counter_launch_nothing():
    """A span and a counter dispatch no op off; a counter dispatches none on
    either (a tensor is held, not summed)."""
    t = torch.arange(8)
    with OpCount() as off:
        with profiling.span("x"):
            pass
        profiling.count("c", t)
        profiling.count("d", (t, t), lambda a, b: (a + b).sum())
    with profiling.recording():
        with OpCount() as on:
            with profiling.span("x"):
                profiling.count("c", t)
                profiling.count("d", (t, t), lambda a, b: (a + b).sum())
                profiling.count("e", 3)
    assert off.n == 0 and on.n == 0
    assert profiling.report()["counters"] == {"c": 28, "d": 56, "e": 3}


@pytest.mark.parametrize("chord_iterations", [None, 2])
def test_counters_equal_sums_by_hand(monkeypatch, chord_iterations):
    """The chord's and the fallback's counters against their returns (with
    the chord cut to 2 iterations, the fallback takes lanes), the unstable
    lanes against ``~stable``, the chord's iterations against
    ``info["n_iter"]`` where no lane falls back, and the ADMM counters
    against ``DCOPFSolution.iterations``."""
    seen = {"chord": [], "nr": [], "admm": []}
    chord, nr_lazy, solve = transition_mod.chord_solve, transition_mod.nr_solve_lazy, mpc.solve_dcopf

    def chord_solve(*a, **k):
        if chord_iterations:
            k["lim_iter"] = chord_iterations
        out = chord(*a, **k)
        seen["chord"].append(out)
        return out

    def nr_solve_lazy(*a, **k):
        out = nr_lazy(*a, **k)
        seen["nr"].append(out)
        return out

    def solve_dcopf(*a, **k):
        sol = solve(*a, **k)
        seen["admm"].append(sol.iterations)
        return sol

    monkeypatch.setattr(transition_mod, "chord_solve", chord_solve)
    monkeypatch.setattr(transition_mod, "nr_solve_lazy", nr_solve_lazy)
    monkeypatch.setattr(mpc, "solve_dcopf", solve_dcopf)
    env, state, action = ieee33()
    seen["chord"].clear(), seen["nr"].clear()
    n_iter = []
    with profiling.recording():
        for _ in range(3):
            state, _, _, _, info = env.step(state, action)
            n_iter.append(info["n_iter"])
        cell = mpc_cell()
        seen["admm"].clear()
        mpc_steps(*cell)
    c = profiling.report()["counters"]
    chords, nrs = seen["chord"], seen["nr"]
    assert c["chord.lanes"] == sum(int(x[3].numel()) for x in chords)
    assert c["chord.lane_iterations"] == sum(int(x[3].sum()) for x in chords)
    raised = [(nr.n_iter > ch[3]) for ch, nr in zip(chords, nrs)]
    assert c["newton.lanes"] == sum(int(r.sum()) for r in raised)
    assert c["newton.lane_iterations"] == sum(int((nr.n_iter - ch[3]).sum()) for ch, nr in zip(chords, nrs))
    assert c["loadflow.unstable_lanes"] == sum(int((~nr.stable).sum()) for nr in nrs)
    assert c["admm.lanes"] == 2 * 16 and c["admm.sweeps"] == sum(int(it.sum()) for it in seen["admm"])
    assert c["admm.streamed_lanes"] == 0  # the plain solve on the CPU streams nothing
    assert c["reset.lanes"] >= 16 and c["reset.attempts"] >= 1  # the MPC cell's own reset
    if chord_iterations:
        assert c["newton.lanes"] > 0
    else:
        assert c["newton.lanes"] == 0
        assert all(torch.equal(n.long(), ch[3].long()) for n, ch in zip(n_iter, chords))


def test_projected_points_equal_the_lanes_times_the_devices():
    """ANM6Easy projects its two generators and its storage unit in two
    ``transition.project`` spans a transition: ``project.points`` is the lanes
    times the three devices; IEEE33 has no such device and records neither."""
    env = VecEnv(make_anm6easy_task(), dtype=torch.float32, device="cpu")
    g = torch.Generator().manual_seed(5)
    state, _ = env.reset(16, g)
    action = env.action_low + torch.rand(16, env.n_action, generator=g) * (env.action_high - env.action_low)
    with profiling.recording():
        for _ in range(3):
            state, _, _, _, _ = env.step(state, action, g)
    rep = profiling.report()
    assert rep["counters"]["project.points"] == 3 * 16 * 3
    assert rep["spans"]["transition.project"]["count"] == 3 * 2
    assert rep["spans"]["transition.project"]["parents"] == ["transition.devices"]
    env, state, action = ieee33(B=8)
    with profiling.recording():
        ieee33_steps(env, state, action, 1)
    rep = profiling.report()
    assert "transition.project" not in rep["spans"] and "project.points" not in rep["counters"]


def test_reset_lanes_and_reads_equal_a_hand_loop():
    """Lanes forced done before each autoreset step: ``reset.lanes`` is the
    sum of ``done`` and ``host_reads.env.autoreset`` the number of steps."""
    env, state, action = ieee33()
    g = torch.Generator().manual_seed(3)
    done_lanes, steps = 0, 4
    with profiling.recording():
        for k in range(steps):
            forced = torch.zeros(state.terminated.shape, dtype=torch.bool)
            forced[k::5] = True
            state = state._replace(terminated=state.terminated | forced)
            state, _, _, done, _ = env.step_autoreset_batch(state, action, g)
            done_lanes += int(done.sum())
    rep = profiling.report()
    assert rep["counters"]["reset.lanes"] == done_lanes > 0
    assert rep["counters"]["host_reads.env.autoreset"] == steps
    assert rep["counters"]["reset.attempts"] >= steps
    assert rep["spans"]["env.reset"]["parents"] == ["env.autoreset"]
    assert rep["spans"]["transition"]["parents"] == ["env.step", "env.reset"]


@pytest.mark.parametrize("mode", ["profiler", "recording"])
def test_a_record_starts_afresh_and_report_is_idempotent(mode):
    env, state, action = ieee33(B=8)
    opened = lambda: profile(activities=[ProfilerActivity.CPU]) if mode == "profiler" else profiling.recording()  # noqa: E731
    with opened():
        state = ieee33_steps(env, state, action, 1)
    first = profiling.report()
    assert profiling.report() is first and first["spans"]["env.step"]["count"] == 1
    state = ieee33_steps(env, state, action, 1)  # off: the record stays
    assert profiling.report() is first
    with opened():
        ieee33_steps(env, state, action, 2)
    again = profiling.report()
    assert again["spans"]["env.step"]["count"] == 2 and again["counters"]["chord.lanes"] == 16


def test_held_tensors_fold_into_one_sum():
    t = torch.ones(3, dtype=torch.int32)
    with profiling.recording():
        for _ in range(profiling.FOLD_AT + 6):
            profiling.count("held", t)
        assert len(profiling._tracer.record.held["held"]) == 7
    assert profiling.report()["counters"]["held"] == 3 * (profiling.FOLD_AT + 6)


def test_nothing_records_while_a_graph_captures(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with profiling.recording():
        assert profiling.span("env.step") is profiling.span("chord")
        profiling.count("c", 1)
        assert profiling.host_bool(torch.tensor(True), "site")
    assert profiling.report()["counters"] == {} and profiling.report()["spans"] == {}


@pytest.mark.cuda
def test_spans_on_the_card(monkeypatch, tracer):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    env, state, action = ieee33(B=4096, device="cuda")
    state = ieee33_steps(env, state, action, 2)  # warm
    torch.cuda.synchronize()

    def device_ops():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ieee33_steps(env, state, action, 3)
            torch.cuda.synchronize()
        return sorted(e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)

    traced = device_ops()
    assert tracer.report()["spans"]["chord"]["count"] == 3
    tracer.active = lambda: None  # the tracer off under the profiler
    untraced = device_ops()
    del tracer.active
    assert traced == untraced  # the spans' CUDA events are no device activity

    syncs = []
    with profiling.recording():
        torch.cuda.set_sync_debug_mode("error")  # any synchronise inside the window raises
        try:
            ieee33_steps(env, state, action, 3)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: (syncs.append(1), real(*a))[1])
    rep = profiling.report()
    assert len(syncs) == 1 and profiling.report() is rep and len(syncs) == 1
    raw = rep["raw"]
    assert {s["name"] for s in raw} == set(IEEE33_PARENTS) and all(s["device_ns"] for s in raw)
    for s in raw:
        root = s
        while root["parent"] is not None:
            root = raw[root["parent"]]
        d0, d1 = s["device_ns"]
        assert root["name"] == "env.step" and root["device_ns"][0] <= d0 <= d1 <= root["device_ns"][1]
        assert d0 >= s["host_ns"][0] - 1e5  # the card trails the host (within 0.1 ms of clock error)
    spans = rep["spans"]
    assert rep["launches"]["chord_solve_cuda"] == 3 and rep["launches"]["newton_fallback_cuda"] == 3
    assert spans["env.step"]["self_device_ms"] < spans["env.step"]["device_ms"]
