#!/usr/bin/env python3
"""Drive the gym_anm_torch port once on one CUDA card, end to end.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``gym_anm_torch/csrc`` with nvcc
(one process per source, in parallel), then runs these phases and exits
non-zero at the first failure:

1. the Gauss-Jordan kernel (K1) against its plain PyTorch version on the
   card: f32 and f64, n = 64 at B = 8192 and n = 10 at a ragged B = 1001,
   and a zero-pivot lane that must stay non-finite in both;
1b. the chord-Newton kernel (K2) against its plain version at B = 8192 on
   three input sets: base IEEE33 constants from flat and from warm starts,
   the multicap constants at their nominal-load point under diurnal loads,
   and the bad-basin guesses; times of both;
2. the base path: the base IEEE33 ``VecEnv`` at float32, reset at B = 8192
   and 128 steps of uniform-random actions, then one step from warm starts
   in a bad basin (a restored state whose guesses are far off), which sends
   every lane through the Newton fallback and its K1 solve.  Outputs are
   finite, residuals within 1e-4, no lane terminates, K2 and K1 launch, and
   the first 8 steps of 256 lanes match the port's float64 rollout on the
   CPU;
3. the chord solve and the Newton fallback called directly on bad-basin
   inputs tiled to B = 8192: every lane ends stable, K1 launches, and the
   voltages match the same call on the CPU (plain solve);
4. TF32 allowed globally changes no step output, bit for bit;
5. the multicap17 path: ``make_ieee33_multicap_task`` at float32, reset at
   B = 8192, 128 steps of uniform-random 17-dim actions through
   ``step_autoreset_batch``, halfway through from bad-basin warm starts and
   with 64 lanes already terminated: outputs finite, live lanes' residuals
   within 1e-4, reset lanes back at t = 0, K2 and K1 launched; the first 8
   steps of 256 lanes replayed through the port's float64 transition on the
   CPU;
6. times: env-steps/s of the base path at B = 8192 and 32768 and of the
   multicap17 path at B = 8192 (128 steps, median of 5 reps, CUDA events),
   chord iterations per step.

Prints the card's name and power limit first, a JSON line of the kernels
next to last, and ``{"ok": true, "device": {...}}`` last.  Needs one card;
imports nothing of JAX.
"""

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import torch

B_MAIN = 8192
B_LARGE = 32768
N_STEPS = 128
N_REPS = 5
N_CHECK_LANES, N_CHECK_STEPS = 256, 8


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, n_launch):
    """Mean ms per call of ``fn`` over ``n_launch`` calls, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n_launch):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_launch


def systems(B, n, dtype, seed):
    """Diagonally dominant systems on the card; lane 1 has a zero first pivot."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.randn(B, n, n, generator=g, device="cuda", dtype=dtype)
    A += n * torch.eye(n, device="cuda", dtype=dtype)
    b = torch.randn(B, n, generator=g, device="cuda", dtype=dtype)
    A[1, 0, 0] = 0.0
    return A.contiguous(), b.contiguous()


def phase1_kernel_vs_plain(lin):
    log("== phase 1: K1 against its plain version")
    result = {}
    for B, n, dtype, tol in ((B_MAIN, 64, torch.float32, 1e-4), (1001, 10, torch.float32, 1e-4),
                             (B_MAIN, 64, torch.float64, 1e-10), (1001, 10, torch.float64, 1e-10)):
        A, b = systems(B, n, dtype, seed=n)
        xk = lin.solve_gauss_jordan_cuda(A, b)
        xp = lin.solve_gauss_jordan(A, b)
        torch.cuda.synchronize()
        assert not torch.isfinite(xk[1]).all() and not torch.isfinite(xp[1]).all(), "zero pivot repaired"
        keep = torch.ones(B, dtype=torch.bool, device="cuda")
        keep[1] = False
        assert torch.isfinite(xk[keep]).all() and torch.isfinite(xp[keep]).all()
        err = float((xk[keep] - xp[keep]).abs().max())
        rel = err / float(xp[keep].abs().max())
        log(f"K1 B={B} n={n} {dtype}: max_abs_err={err:.3e} rel={rel:.3e} (tol {tol:g})")
        assert rel <= tol, f"K1 disagrees with its plain version: rel {rel:.3e} > {tol:g}"
        if (B, n, dtype) == (B_MAIN, 64, torch.float32):
            lin.solve_gauss_jordan_cuda(A, b)  # warm
            ms = [cuda_ms(lambda: lin.solve_gauss_jordan_cuda(A, b), 20) for _ in range(N_REPS)]
            lin.solve_gauss_jordan(A, b)
            plain = [cuda_ms(lambda: lin.solve_gauss_jordan(A, b), 3) for _ in range(N_REPS)]
            result = dict(max_abs_err=err, ms=statistics.median(ms), plain_ms=statistics.median(plain))
            log(f"K1 time B={B} n={n} f32: kernel {result['ms']:.4f} ms, plain {result['plain_ms']:.4f} ms "
                f"(median of {N_REPS})")
    return result


def bad_guesses(B, n, which=(0, 1, 2, 3)):
    """The bad-basin warm starts of tests/test_chord_solver.py (the patterns
    ``which``), tiled to B lanes."""
    pats = torch.stack([
        torch.cat([torch.zeros(n), torch.full((n,), 1e-6)]),   # vm ~ 0
        torch.cat([torch.zeros(n), torch.full((n,), -1.0)]),   # vm < 0
        torch.cat([torch.full((n,), 30.0), torch.ones(n)]),    # wild angles
        torch.cat([torch.zeros(n), torch.full((n,), 1e15)]),   # vm overflow
    ])[list(which)]
    return pats.repeat(B // len(which) + 1, 1)[:B]


def chord_vs_plain(pf, cuda_k, name, ct, args, x0):
    """K2 and the plain chord on the same card inputs.  Tolerance: the same
    accepted lanes; n_iter equal on all but 0.5% of lanes (a float32 AA sum
    in another order can move a plateau exit); x within 1e-5 (the solver's
    own scale is xtol = 1e-5 on the residual); F and diff within 1e-4 (the
    acceptance band).  Returns (max |Δx|, kernel ms, plain ms)."""
    before = cuda_k.launch_count
    xk, Fk, dk, ik, ak = cuda_k(*args, ct, x0=x0)
    torch.cuda.synchronize()
    xp, Fp, dp, ip, ap = pf.chord_solve_plain(*args, ct, x0=x0)
    torch.cuda.synchronize()
    assert cuda_k.launch_count == before + 1
    B = xk.shape[0]
    err = float((xk - xp).abs().max())
    n_diff = int((ik != ip).sum())
    log(f"K2 {name} B={B}: accepted {int(ak.sum())} / plain {int(ap.sum())}; n_iter differs on {n_diff} lanes "
        f"(max {int((ik - ip).abs().max())}), mean {float(ik.float().mean()):.3f}, worst {int(ik.max())}; "
        f"max|dx| {err:.3e}, max|dF| {float((Fk - Fp).abs().max()):.3e}, max|ddiff| {float((dk - dp).abs().max()):.3e}, "
        f"x bitwise equal on {int((xk == xp).all(1).sum())} lanes")
    assert torch.equal(ak, ap), "K2 and its plain version accept different lanes"
    assert n_diff <= B // 200, f"K2 n_iter differs on {n_diff} lanes"
    assert err <= 1e-5 and float((Fk - Fp).abs().max()) <= 1e-4 and float((dk - dp).abs().max()) <= 1e-4
    ms = [cuda_ms(lambda: cuda_k(*args, ct, x0=x0), 1) for _ in range(N_REPS)]
    plain = [cuda_ms(lambda: pf.chord_solve_plain(*args, ct, x0=x0), 1) for _ in range(N_REPS)]
    t_k, t_p = statistics.median(ms), statistics.median(plain)
    log(f"K2 {name} time: kernel {t_k:.4f} ms, plain {t_p:.4f} ms (median of {N_REPS})")
    return err, t_k, t_p


def multicap_injections(tb, B, g):
    """Bus injections of the multicap network under diurnal loads (random
    hour, 2% noise), random capacitor set-points and taps, and the tap's
    ΔY entries (transition.py's formulas), on the card."""
    dev = tb.device
    u = lambda *shape: torch.rand(*shape, generator=g, device=dev)  # noqa: E731
    hour = 24.0 * u(B, 1)
    load = tb.load_p_min * (0.8 + 0.3 * torch.sin((hour - 3.0) * (math.pi / 12.0)))
    load = load * (1.0 + 0.02 * torch.randn(B, len(tb.load_pos), generator=g, device=dev))
    dev_p = torch.zeros(B, tb.n_dev, device=dev)
    dev_q = torch.zeros(B, tb.n_dev, device=dev)
    dev_p[:, tb.load_pos] = load
    dev_q[:, tb.load_pos] = load * tb.load_qp
    dev_q[:, tb.cap_pos] = tb.cap_q_min + u(B, len(tb.cap_pos)) * (tb.cap_q_max - tb.cap_q_min)
    p_ns = (dev_p @ tb.dev_bus_mat)[:, 1:].contiguous()
    q_ns = (dev_q @ tb.dev_bus_mat)[:, 1:].contiguous()
    a = tb.oltc_tap_min[0] + u(B) * (tb.oltc_tap_max[0] - tb.oltc_tap_min[0])
    inv_da = 1.0 / a - 1.0 / tb.chord_a0
    dtf_re = -tb.chord_y_re * inv_da
    dtf_im = -tb.chord_y_im * inv_da
    return p_ns, q_ns, dtf_im, dtf_re, dtf_re, dtf_im


def phase1b_chord_kernel(pf, cuda_k, VecEnv, make_ieee33_task, make_ieee33_multicap_task):
    log(f"== phase 1b: K2 against its plain version, B={B_MAIN}")
    g = torch.Generator(device="cuda").manual_seed(11)
    tb = VecEnv(make_ieee33_task(), dtype=torch.float32, device="cuda").tables
    n = tb.n_bus - 1
    qc = torch.rand(B_MAIN, 2, generator=g, device="cuda")
    q = torch.zeros(B_MAIN, n, device="cuda")
    q[:, 7], q[:, 24] = qc[:, 0], qc[:, 1]
    a = 0.9 + 0.2 * torch.rand(B_MAIN, generator=g, device="cuda")
    inv_da = 1.0 / a - 1.0 / tb.chord_a0
    dr, di = -tb.chord_y_re * inv_da, -tb.chord_y_im * inv_da
    base = (torch.zeros(B_MAIN, n, device="cuda"), q, di, dr, dr, di)
    warm = tb.chord_t.flat + 0.01 * torch.randn(B_MAIN, 2 * n, generator=g, device="cuda")
    warm[3] = float("nan")
    errs, times = [], {}
    for name, ct, args, x0 in (
        ("base IEEE33 flat start", tb.chord_t, base, None),
        ("base IEEE33 warm starts", tb.chord_t, base, warm),
        ("multicap at x* under diurnal loads", None, None, None),
        ("bad-basin guesses", tb.chord_t, tuple(torch.full_like(base[0], -0.01) * s for s in (1, 0.5))
         + (torch.zeros_like(di),) * 4, bad_guesses(B_MAIN, n).to("cuda")),
    ):
        if ct is None:
            mtb = VecEnv(make_ieee33_multicap_task(), dtype=torch.float32, device="cuda").tables
            ct, args = mtb.chord_t, multicap_injections(mtb, B_MAIN, g)
        err, t_k, t_p = chord_vs_plain(pf, cuda_k, name, ct, args, x0)
        errs.append(err)
        times[name] = (t_k, t_p)
    t_k, t_p = times["base IEEE33 warm starts"]
    return dict(max_abs_err=max(errs), ms=t_k, plain_ms=t_p)


def uniform_actions(env, B, g):
    u = torch.rand(B, env.n_action, generator=g, device=env.device, dtype=env.dtype)
    return env.action_low + u * (env.action_high - env.action_low)


def check_step(obs, r, d, info, what):
    assert torch.isfinite(obs).all(), f"{what}: non-finite obs"
    assert torch.isfinite(r).all(), f"{what}: non-finite reward"
    assert not d.any(), f"{what}: {int(d.sum())} lanes terminated"
    worst = float(info["diff"].max())
    assert worst <= 1e-4, f"{what}: residual {worst:.3e} > 1e-4"


def phase2_main_path(VecEnv, make_ieee33_task, kernel, chord_k):
    log(f"== phase 2: base path, base IEEE33 f32, B={B_MAIN}, {N_STEPS} steps")
    env = VecEnv(make_ieee33_task(), dtype=torch.float32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    kernel.launch_count = 0
    chord_k.launch_count = 0
    state, obs = env.reset(B_MAIN)
    assert torch.isfinite(obs).all() and not state.terminated.any()
    record = []
    iters = []
    for k in range(N_STEPS):
        a = uniform_actions(env, B_MAIN, g)
        state, obs, r, d, info = env.step(state, a)
        check_step(obs, r, d, info, f"step {k}")
        iters.append(info["n_iter"])
        if k < N_CHECK_STEPS:
            lanes = slice(0, N_CHECK_LANES)
            record.append((a[lanes].cpu(), r[lanes].cpu(), state.bus_vm[lanes].cpu()))
    launches_plain = kernel.launch_count
    # A restored state whose warm starts are far off (wild angles, overflowing
    # magnitudes): the chord exit is reset to the flat start, unaccepted, and
    # every lane goes through the Newton fallback (K1).  (The two near-zero
    # and negative-magnitude guesses are left out here: under the task's real
    # loads they strand the fallback in a low-voltage basin, in the JAX
    # package as in the port.)
    n = env.spec.n_bus - 1
    bad = state._replace(v_guess=bad_guesses(B_MAIN, n, which=(2, 3)).to("cuda"))
    state2, obs, r, d, info = env.step(bad, uniform_actions(env, B_MAIN, g))
    check_step(obs, r, d, info, "bad-basin step")
    torch.cuda.synchronize()
    launches = kernel.launch_count
    chord_launches = chord_k.launch_count
    it = torch.stack(iters).float()
    log(f"base path: K2 launches {chord_launches}; K1 launches {launches} ({launches_plain} in the {N_STEPS} "
        f"random-action steps, {launches - launches_plain} in the bad-basin step, fallback iterations max "
        f"{int(info['n_iter'].max())})")
    log(f"chord iterations per step over {N_STEPS} steps: mean {float(it.mean()):.3f}, "
        f"worst lane {int(it.max())}, mean of per-step worst {float(it.max(dim=1).values.mean()):.3f}")
    assert launches > 0, "K1 never launched on the base path"
    assert chord_launches > 0, "K2 never launched on the base path"

    # The first steps of the first lanes against the port's f64 CPU rollout:
    # bus_vm within 5e-5 everywhere; rewards within rtol 2e-3 / atol 2e-4
    # (tests/test_chord_solver.py) wherever the slack branch's active flow,
    # which equals e_loss here (the task's loads are zero), is at least 1e-4
    # p.u.  Below that the f32 flow is within a few rounding quanta of zero
    # (|y| of that branch is ~155 p.u., so one f32 ulp of its terms is
    # ~1.5e-5), sign(p_from) in the branch's signed flow may come out 0, and
    # the rate-0 penalty of that branch (up to ~0.8 of reward) drops out: the
    # JAX package's f32 tier does the same on the same lanes.
    ref = VecEnv(make_ieee33_task(), dtype=torch.float64, device="cpu")
    s64, _ = ref.reset(N_CHECK_LANES)
    worst_r = worst_vm = 0.0
    n_checked = n_near_zero = 0
    for k, (a, r32, vm32) in enumerate(record):
        s64, _, r64, d64, info64 = ref.step(s64, a.double())
        assert not d64.any()
        torch.testing.assert_close(vm32.double(), s64.bus_vm, rtol=0, atol=5e-5, msg=f"bus_vm step {k}")
        sign_ok = info64["e_loss"].abs() >= 1e-4
        torch.testing.assert_close(r32.double()[sign_ok], r64[sign_ok], rtol=2e-3, atol=2e-4,
                                   msg=f"reward step {k}")
        n_checked += int(sign_ok.sum())
        n_near_zero += int((~sign_ok).sum())
        worst_r = max(worst_r, float((r32.double() - r64)[sign_ok].abs().max()))
        worst_vm = max(worst_vm, float((vm32.double() - s64.bus_vm).abs().max()))
    log(f"f32 card vs f64 CPU ({N_CHECK_STEPS} steps x {N_CHECK_LANES} lanes): bus_vm max abs diff "
        f"{worst_vm:.3e}; reward max abs diff {worst_r:.3e} over {n_checked} lane-steps "
        f"({n_near_zero} lane-steps with a slack-branch flow below 1e-4 p.u. not reward-compared)")
    return launches, chord_launches


def phase3_fallback(env_cls, make_ieee33_task, pf, ybus, kernel):
    log(f"== phase 3: chord + Newton fallback through K1 on bad-basin inputs, B={B_MAIN}")
    results = {}
    for device in ("cuda", "cpu"):
        B = B_MAIN if device == "cuda" else 8
        tb = env_cls(make_ieee33_task(), dtype=torch.float32, device=device).tables
        n = tb.n_bus - 1
        p = torch.full((B, n), -0.01, device=device)
        q = p * 0.5
        z = torch.zeros(B, device=device)
        x0 = bad_guesses(B, n).to(device)

        def ybus_fn(idx, tb=tb):
            taps = tb.tap0.expand(len(idx), -1)
            return ybus.build_ybus(tb.n_bus, tb.br_f, tb.br_t, tb.series_re, tb.series_im,
                                   tb.shunt_im, tb.shift_cos, tb.shift_sin, taps)

        before = kernel.launch_count
        init = pf.chord_solve(p, q, z, z, z, z, tb.chord_t, x0=x0)
        r = pf.nr_solve_lazy(ybus_fn, p, q, init=init)
        assert r.stable.all(), f"{device}: {int((~r.stable).sum())} lanes unstable"
        assert float(r.diff.max()) <= 1e-4
        if device == "cuda":
            assert kernel.launch_count > before, "the fallback did not launch K1"
            log(f"fallback on the card: K1 launches {kernel.launch_count - before}, "
                f"iterations max {int(r.n_iter.max())}, residual max {float(r.diff.max()):.3e}")
        results[device] = (r.v_re[:8].cpu(), r.v_im[:8].cpu())
    err = max(float((results["cuda"][i] - results["cpu"][i]).abs().max()) for i in range(2))
    log(f"fallback voltages card vs CPU (plain solve): max abs diff {err:.3e}")
    assert err <= 5e-6


def run_steps(env, B, actions):
    state, _ = env.reset(B)
    outs = []
    for a in actions:
        state, obs, r, d, info = env.step(state, a)
        outs += [obs, r, state.bus_vm, state.v_guess, info["diff"], info["n_iter"]]
    torch.cuda.synchronize()
    return outs


def phase4_tf32(VecEnv, make_ieee33_task):
    log("== phase 4: TF32 allowed globally changes no step output")
    env = VecEnv(make_ieee33_task(), dtype=torch.float32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(4)
    actions = [uniform_actions(env, B_MAIN, g) for _ in range(8)]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = run_steps(env, B_MAIN, actions)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = run_steps(env, B_MAIN, actions)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    same = all(torch.equal(a, b) for a, b in zip(ref, tf32))
    log(f"8 steps at B={B_MAIN}: outputs bitwise identical with allow_tf32=True: {same}")
    assert same


def phase5_multicap(VecEnv, make_ieee33_multicap_task, transition, kernel, chord_k):
    log(f"== phase 5: multicap17 path, f32, B={B_MAIN}, {N_STEPS} steps of step_autoreset_batch")
    task = make_ieee33_multicap_task()
    record = []

    def recording_vars(generator, s_t, hour, t):
        vars, new_hour = task.next_vars_fn(generator, s_t, hour, t)
        if len(record) < N_CHECK_STEPS:
            record.append([vars[:N_CHECK_LANES].cpu(), new_hour[:N_CHECK_LANES].cpu()])
        return vars, new_hour

    env = VecEnv(dataclasses.replace(task, next_vars_fn=recording_vars), dtype=torch.float32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(6)
    kernel.launch_count = 0
    chord_k.launch_count = 0
    state, obs = env.reset(B_MAIN, g)
    assert torch.isfinite(obs).all()
    n_term, iters = 0, []
    n = env.spec.n_bus - 1
    for k in range(N_STEPS):
        a = uniform_actions(env, B_MAIN, g)
        if k == N_STEPS // 2:
            # As from a restored state: far-off warm starts on every lane
            # (the chord resets them to flat and the Newton fallback, K1,
            # solves them) and 64 lanes already terminated (they absorb the
            # step and come back reset).
            state = state._replace(v_guess=bad_guesses(B_MAIN, n, which=(2, 3)).to("cuda"),
                                   terminated=torch.arange(B_MAIN, device="cuda") % (B_MAIN // 64) == 0)
        state, obs, r, d, info = env.step_autoreset_batch(state, a, g)
        assert torch.isfinite(obs).all() and torch.isfinite(r).all(), f"step {k}: non-finite output"
        live = ~d
        worst = float(info["diff"][live].max())
        assert worst <= 1e-4, f"step {k}: live-lane residual {worst:.3e} > 1e-4"
        assert (state.t[d] == 0).all(), f"step {k}: a reset lane is not at t = 0"
        n_term += int(d.sum())
        iters.append(info["n_iter"])
        if k < N_CHECK_STEPS:
            lanes = slice(0, N_CHECK_LANES)
            record[k] += [a[lanes].cpu(), r[lanes].cpu(), state.bus_vm[lanes].cpu(), d[lanes].cpu(),
                          info["e_loss"][lanes].cpu(), info["penalty"][lanes].cpu()]
    torch.cuda.synchronize()
    launches, chord_launches = kernel.launch_count, chord_k.launch_count
    it = torch.stack(iters).float()
    log(f"multicap17 path: K2 launches {chord_launches}, K1 launches {launches}; {n_term} lane terminations "
        f"(reset) in {N_STEPS} steps; chord iterations mean {float(it.mean()):.3f}, worst lane {int(it.max())}, "
        f"mean of per-step worst {float(it.max(dim=1).values.mean()):.3f}")
    assert chord_launches > 0, "K2 never launched on the multicap17 path"
    assert launches > 0, "K1 never launched on the multicap17 path"
    assert n_term >= 64

    # The first steps of the first lanes replayed through the port's float64
    # transition on the CPU (flat-start exact Newton): bus_vm within 5e-5 on
    # live lanes; e_loss within rtol 2e-3 / atol 2e-4 where |e_loss| >= 1e-4,
    # and the penalty within rtol 2e-3 / atol λ·Δt·1e-5 (it multiplies the
    # flows' error, bounded by the 1e-5 residual, by λ = 100).
    ref = VecEnv(make_ieee33_multicap_task(), dtype=torch.float64, device="cpu")
    tb, z = ref.tables, torch.zeros(N_CHECK_LANES, 0, dtype=torch.float64)
    worst_vm = worst_e = worst_p = 0.0
    n_checked = 0
    hours = torch.stack([rec[1] for rec in record])
    for k, (vars, _, a, r32, vm32, d32, e32, pen32) in enumerate(record):
        vars, a = vars.double(), a.double()
        P_gen, Q_gen, P_des, Q_des, Q_cap, taps = ref.split_action(a)
        n_load = ref.spec.n_load
        out = transition(tb, vars[:, :n_load], vars[:, n_load:n_load + ref.spec.n_gen], P_gen, Q_gen, P_des,
                         Q_des, Q_cap, taps, z, ref._rates)
        live = ~d32
        assert out.stable[live].all()
        vm64 = torch.sqrt(out.bus_v_re ** 2 + out.bus_v_im ** 2)
        torch.testing.assert_close(vm32.double()[live], vm64[live], rtol=0, atol=5e-5, msg=f"bus_vm step {k}")
        clear = live & (out.e_loss.abs() >= 1e-4)
        torch.testing.assert_close(e32.double()[clear], out.e_loss[clear], rtol=2e-3, atol=2e-4,
                                   msg=f"e_loss step {k}")
        torch.testing.assert_close(pen32.double()[live], out.penalty[live], rtol=2e-3, atol=100 * 1e-5,
                                   msg=f"penalty step {k}")
        torch.testing.assert_close(r32.double()[live], out.reward[live], rtol=2e-3, atol=2e-4 + 100 * 1e-5,
                                   msg=f"reward step {k}")
        worst_vm = max(worst_vm, float((vm32.double() - vm64)[live].abs().max()))
        worst_e = max(worst_e, float((e32.double() - out.e_loss)[clear].abs().max()))
        worst_p = max(worst_p, float((pen32.double() - out.penalty)[live].abs().max()))
        n_checked += int(live.sum())
    log(f"multicap17 f32 card vs f64 CPU replay ({len(record)} steps x {N_CHECK_LANES} lanes, {n_checked} live "
        f"lane-steps, hours {float(hours.min()):.3f}-{float(hours.max()):.3f}): bus_vm max abs diff "
        f"{worst_vm:.3e}, e_loss {worst_e:.3e}, penalty {worst_p:.3e}")
    return launches, chord_launches


def time_path(env, B, step, seed):
    """env-steps/s of ``step`` at B lanes: CUDA events around 128 steps after
    8 warm-up steps, median of 5 reps; also the chord iterations."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    state, _ = env.reset(B, g)
    for _ in range(8):  # warm-up
        state, *_ = step(state, uniform_actions(env, B, g), g)
    reps, iters, n_done = [], [], 0
    for _ in range(N_REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for _ in range(N_STEPS):
            state, obs, r, d, info = step(state, uniform_actions(env, B, g), g)
            iters.append(info["n_iter"])
            n_done += d
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        reps.append(N_STEPS * B / (start.elapsed_time(end) / 1e3))
    it = torch.stack(iters).float()
    rate = statistics.median(reps)
    log(f"{env.task.name} B={B}: {rate:.1f} env-steps/s (median of {N_REPS} reps of {N_STEPS} steps; reps "
        f"{[round(x, 1) for x in reps]}), {1e3 * B / rate:.3f} ms/step (last rep wall "
        f"{1e3 * wall / N_STEPS:.3f} ms/step); chord iterations mean {float(it.mean()):.3f}, "
        f"worst lane {int(it.max())}, mean per-step worst {float(it.max(dim=1).values.mean()):.3f}; "
        f"{int(n_done.sum())} lanes done")
    return rate, int(n_done.sum())


def phase6_times(VecEnv, make_ieee33_task, make_ieee33_multicap_task):
    log("== phase 6: times")
    for B in (B_MAIN, B_LARGE):
        env = VecEnv(make_ieee33_task(), dtype=torch.float32, device="cuda")
        _, n_done = time_path(env, B, env.step, 5)
        assert n_done == 0
    env = VecEnv(make_ieee33_multicap_task(), dtype=torch.float32, device="cuda")
    time_path(env, B_MAIN, env.step_autoreset_batch, 7)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is visible; it runs only on a card", file=sys.stderr)
        return 1
    from gym_anm_torch import _build
    from gym_anm_torch.physics import linsolve_cuda as lin
    from gym_anm_torch.physics import power_flow as pf
    from gym_anm_torch.physics import ybus
    from gym_anm_torch.physics.chord_cuda import chord_solve_cuda
    from gym_anm_torch.physics.transition import transition
    from gym_anm_torch.vec import VecEnv, make_ieee33_multicap_task, make_ieee33_task

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    log(f"nvidia-smi: {smi.stdout.strip().splitlines()[0]}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib_path = _build.library_path()
    _build.load_library()
    log(f"K1 and K2 built/loaded in {time.perf_counter() - t0:.1f} s: {lib_path.name}")

    kernel = lin.solve_gauss_jordan_cuda
    k1 = phase1_kernel_vs_plain(lin)
    k2 = phase1b_chord_kernel(pf, chord_solve_cuda, VecEnv, make_ieee33_task, make_ieee33_multicap_task)
    launches, chord_launches = phase2_main_path(VecEnv, make_ieee33_task, kernel, chord_solve_cuda)
    phase3_fallback(VecEnv, make_ieee33_task, pf, ybus, kernel)
    phase4_tf32(VecEnv, make_ieee33_task)
    mc_launches, mc_chord_launches = phase5_multicap(VecEnv, make_ieee33_multicap_task, transition, kernel,
                                                     chord_solve_cuda)
    phase6_times(VecEnv, make_ieee33_task, make_ieee33_multicap_task)

    # Launches: the base path's and the multicap17 path's runs together.
    print(json.dumps({"kernels": [{
        "name": "gauss_jordan",
        "route": "cuda",
        "source": "gym_anm_torch/csrc/gauss_jordan.cu",
        "replaces": "gym_anm_tpu/physics/linsolve_pallas.py:31",
        "launches": launches + mc_launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
    }, {
        "name": "chord_newton",
        "route": "cuda",
        "source": "gym_anm_torch/csrc/chord_newton.cu",
        "replaces": "scripts/chord_pallas_prototype.py:168",
        "launches": chord_launches + mc_chord_launches,
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
