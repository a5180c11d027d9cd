"""One run of one cell: set-up, warm-up, the measured window, the traced
window, and what the correctness check needs from them.

The generator is one closed loop of one caller: every step it draws the
traffic's action (uniform over the action box, on the device, from the
run's ``torch.Generator``; or the MPC controller's ``act``), then steps the
whole batch (``VecEnv.step``, or ``step_autoreset_batch``) and records a
CUDA event.  Nothing is compiled inside the window: the kernels are built
into the checkout's ``build/kernels/`` by the first run there, and every
shape the window uses is warmed up before it opens.
"""

import dataclasses
import statistics
import time
from contextlib import contextmanager

import numpy as np
import torch


class Run:
    """What one run measured; the metric readers read it."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


class Draws:
    """A task's ``next_vars_fn``, which keeps the exogenous vector a step
    drew while ``keep`` is set (a checked step) and otherwise holds nothing."""

    def __init__(self, next_vars_fn):
        self.next_vars_fn, self.keep, self.drawn = next_vars_fn, False, None

    def __call__(self, generator, s_t, carry, t):
        out, carry = self.next_vars_fn(generator, s_t, carry, t)
        if self.keep:
            self.drawn = out
        return out, carry

    def take(self):
        drawn, self.drawn, self.keep = self.drawn, None, False
        return drawn


def _task(config):
    from gym_anm_torch.vec import tasks

    task = getattr(tasks, config["task"])()
    return dataclasses.replace(task, next_vars_fn=Draws(task.next_vars_fn))


def make_cell(config, traffic, seed, device, batch=None):
    """(env, generator, act, the controller's initial carry or None, step
    function, batch) of a cell.  The env's task draws through :class:`Draws`."""
    from gym_anm_torch.vec import VecEnv

    dtype = getattr(torch, config["dtype"])
    env = VecEnv(_task(config), dtype=dtype, obs=config["observation"], device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    B = batch or traffic["batch"]
    pol = traffic["policy"]
    if pol["kind"] == "uniform":
        lo, hi = env.action_low, env.action_high

        def act(state, obs, carry):
            u = torch.rand(B, env.n_action, generator=gen, dtype=env.dtype, device=env.device)
            return lo + u * (hi - lo), carry

        init = None
    elif pol["kind"] == "mpc_perfect":
        from gym_anm_torch.vec.mpc import make_vec_mpc_perfect

        ctrl = make_vec_mpc_perfect(env, gamma=pol["gamma"], safety_margin=pol["safety_margin"],
                                    planning_steps=pol["planning_steps"], max_iter=pol["max_iter"])

        def act(state, obs, carry):
            action, carry = ctrl.act(None, state, obs, carry)
            return torch.clamp(action, env.action_low, env.action_high), carry

        init = ctrl.init_carry
    else:
        raise ValueError(f"unknown policy kind {pol['kind']!r}")
    step = env.step_autoreset_batch if traffic["autoreset"] else env.step
    return env, gen, act, init, step, B


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _leaves(tree):
    """The tensors of a carry (tensor, tuple or NamedTuple of carries, or
    ``()``) in tree order."""
    return [tree] if torch.is_tensor(tree) else [x for t in tree for x in _leaves(t)]


def snapshot(state_in, carry_in, action, drawn, state_out, obs, reward, done):
    """The tensors of one step that the check reads (views, no copy):
    ``drawn`` is the exogenous vector the step's ``next_vars_fn`` returned."""
    snap = dict(action=action, soc_in=state_in.soc, aux_in=state_in.aux, terminated_in=state_in.terminated,
                t_in=state_in.t, draw=drawn, obs=obs, reward=reward, done=done, vm=state_out.bus_vm,
                vguess=state_out.v_guess, t_out=state_out.t, terminated_out=state_out.terminated, aux_out=state_out.aux,
                soc_out=state_out.soc, tap_out=state_out.oltc_tap)
    snap.update({f"task_in{i}": x for i, x in enumerate(_leaves(state_in.task))})
    snap.update({f"task_out{i}": x for i, x in enumerate(_leaves(state_out.task))})
    if carry_in is not None:
        snap.update({f"warm{i}": w for i, w in enumerate(carry_in)})
    return snap


class Loop:
    """The closed loop's state and its step: ``act`` then ``step``.  A
    checked step's inputs and answers are copied to host memory (pinned,
    without a synchronize, into buffers reserved during set-up), so the
    check holds no device memory and every run's peak is the program's."""

    def __init__(self, env, gen, act, init, step, B):
        self.env, self.gen, self.act, self.step_fn, self.B = env, gen, act, step, B
        self.draws = env.task.next_vars_fn
        self.state, self.obs = env.reset(B, gen)
        self.carry = init(B) if init is not None else None
        self.captures, self.slots = [], []
        self.pinned = env.device.type == "cuda"

    def _buffers(self, like):
        return {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=self.pinned) for k, v in like.items()}

    def reserve(self, n):
        """Host buffers for ``n`` more checked steps, shaped as the first."""
        self.slots += [self._buffers(self.captures[0]) for _ in range(n)]

    def step(self, capture=False, act_events=None):
        state, obs, carry = self.state, self.obs, self.carry
        if act_events is not None:
            act_events[0].record()
        action, new_carry = self.act(state, obs, carry)
        if act_events is not None:
            act_events[1].record()
        self.draws.keep = capture
        new_state, new_obs, reward, done, info = self.step_fn(state, action, self.gen)
        if capture:
            snap = snapshot(state, carry, action, self.draws.take(), new_state, new_obs, reward, done)
            buf = self.slots.pop(0) if self.slots else self._buffers(snap)
            for k, v in snap.items():
                buf[k].copy_(v, non_blocking=self.pinned)
            self.captures.append(buf)
        self.state, self.obs, self.carry = new_state, new_obs, new_carry
        return info


def chained_steps(traffic):
    """How many warm-up steps, from the reset on, are checked in a row: the
    reference follows them with its own controller state from the cold
    start (``checked_warmup``, 1 where the traffic does not say)."""
    return min(traffic.get("checked_warmup", 1), traffic["warmup_steps"])


def check_steps(traffic, seed):
    """The window's steps whose answers the check compares: drawn from the
    seed among the first ``check_within`` steps."""
    rng = np.random.default_rng(seed)
    return set(int(k) for k in rng.choice(traffic["check_within"], size=traffic["check_steps"], replace=False))


def window(loop, seconds, capture_at, device, act_events=False):
    """The measured window: steps until ``seconds`` of the host clock have
    passed, a CUDA event after each.  Returns its readings."""
    cuda = torch.device(device).type == "cuda"
    ev = (lambda: torch.cuda.Event(enable_timing=True)) if cuda else None
    _sync(device)
    marks = [ev()] if cuda else []
    acts = []
    host = []
    if cuda:
        marks[0].record()
    t_open = time.perf_counter()
    k = 0
    while time.perf_counter() - t_open < seconds:
        pair = (ev(), ev()) if (cuda and act_events) else None
        h0 = time.perf_counter()
        loop.step(capture=k in capture_at, act_events=pair)
        host.append(time.perf_counter() - h0)
        if cuda:
            marks.append(ev())
            marks[-1].record()
        if pair is not None:
            acts.append(pair)
        k += 1
    _sync(device)
    t_close = time.perf_counter()
    intervals = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])] if cuda else []
    act_ms = sum(a.elapsed_time(b) for a, b in acts) if acts else None
    return dict(steps=k, window_s=t_close - t_open, intervals_ms=intervals, host_s=host, act_ms=act_ms,
                device_ms=sum(intervals) if intervals else None)


@contextmanager
def _solve_iterations(record):
    """Keep a reference to each ADMM solve's per-lane iterations (no device
    work) while the context is open."""
    from gym_anm_torch.vec import mpc

    orig = mpc.solve_dcopf

    def solve(spec, l, u, warm=None):
        sol = orig(spec, l, u, warm)
        record.append((spec, sol.iterations))
        return sol

    mpc.solve_dcopf = solve
    try:
        yield
    finally:
        mpc.solve_dcopf = orig


def traced(loop, n_steps, device):
    """``n_steps`` steps under ``torch.profiler``, each step inside a
    ``step`` span (its ``act`` in an ``act`` span); returns the reduced trace
    and the steps' chord iterations and ADMM solves."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from .trace import reduce

    solves, n_iter = [], []
    act = loop.act

    def spanned_act(*a):
        with record_function("act"):
            return act(*a)

    loop.act = spanned_act
    for _ in range(2):  # two untraced steps between the measured window and the trace
        loop.step()
    _sync(device)
    try:
        with _solve_iterations(solves), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with record_function("window"):
                for _ in range(n_steps):
                    with record_function("step"):
                        info = loop.step()
                    n_iter.append(info["n_iter"])
                _sync(device)
            t1 = time.perf_counter()
    finally:
        loop.act = act
    trace = reduce(prof.events(), n_steps)
    trace["host_window_s"] = t1 - t0
    trace["lane_iterations"] = int(torch.stack(n_iter).sum()) if n_iter else 0
    trace["admm"] = [(spec, int(it.sum())) for spec, it in solves]
    return trace


def run_cell(spec, workload, seed, seconds, trace, t0, device="cuda", batch=None):
    """One run of ``workload``; returns (Run, the loop).  The
    import guard and the reference check are the caller's."""
    w = spec.workload(workload)
    config, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
    env, gen, act, init, step, B = make_cell(config, traffic, seed, device, batch)
    loop = Loop(env, gen, act, init, step, B)
    chained = chained_steps(traffic)
    for k in range(traffic["warmup_steps"]):
        loop.step(capture=k < chained)  # from the reset and the cold controller state on
    loop.reserve(traffic["check_steps"])
    _sync(device)
    setup_s = time.perf_counter() - t0
    win = window(loop, seconds, check_steps(traffic, seed), device, act_events=bool(trace) and init is not None)
    tr = traced(loop, traffic["trace_steps"], device) if trace else None
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    run = Run(workload=workload, config=config, traffic=traffic, seed=seed, batch=B, setup_s=setup_s,
              peak_bytes=peak, trace=tr, env_n=_chord_shape(env), chained=chained, **win)
    return run, loop


def _chord_shape(env):
    """(unknowns n, buses N) of the chord solve."""
    N = env.spec.n_bus
    return 2 * (N - 1), N


def summary(run):
    """The window's step-interval statistics, for the log."""
    iv = run.intervals_ms
    if not iv:
        return "no device intervals"
    return (f"{len(iv)} step intervals: median {statistics.median(iv):.4f} ms, p95 {np.percentile(iv, 95):.4f} ms, "
            f"max {max(iv):.4f} ms")
