"""gym_anm_torch on a CUDA card: the Gauss-Jordan kernel (K1, with its
blocked route for systems above a block's shared memory), the fused
chord-Newton kernels (K2, and its wide kernel above 33 buses) and the ADMM
kernel (K5) against their plain versions, and
the float32 and float64 steps on the card against the CPU, random feeders
above 33 buses among them.

Every test here needs a card and skips without one.  The file imports no
JAX, so on a machine with a card and no JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gym_anm_torch.networks import anm6_network, ieee33_network
from gym_anm_torch.physics import power_flow as pf
from gym_anm_torch.physics.chord_cuda import chord_solve_cuda
from gym_anm_torch.physics.linsolve_cuda import batched_solve, solve_gauss_jordan, solve_gauss_jordan_cuda
from gym_anm_torch.physics.transition import make_tables
from gym_anm_torch.specs import load_network
from gym_anm_torch.vec import VecEnv, make_ieee33_task

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
@pytest.mark.parametrize("B,n", [(512, 64), (33, 10), (7, 2), (3, 130)])
def test_kernel_matches_plain_version(cuda, dtype, rtol, B, n):
    g = torch.Generator(device=cuda).manual_seed(n)
    A = torch.randn(B, n, n, generator=g, device=cuda, dtype=dtype) + n * torch.eye(n, device=cuda, dtype=dtype)
    b = torch.randn(B, n, generator=g, device=cuda, dtype=dtype)
    A[1, 0, 0] = 0.0  # zero pivot: non-finite in both, never repaired
    before = solve_gauss_jordan_cuda.launch_count
    xk = solve_gauss_jordan_cuda(A, b)
    xp = solve_gauss_jordan(A, b)
    torch.cuda.synchronize()
    assert solve_gauss_jordan_cuda.launch_count == before + 1
    assert not torch.isfinite(xk[1]).all() and not torch.isfinite(xp[1]).all()
    keep = torch.arange(B, device=cuda) != 1
    torch.testing.assert_close(xk[keep], xp[keep], rtol=rtol, atol=rtol * float(xp[keep].abs().max()))


@pytest.mark.parametrize("n", [2, 5, 10, 16, 17, 33, 64])
@pytest.mark.parametrize("B", [1, 7, 1001])
def test_kernel_f32_is_bitwise_its_plain_version(cuda, n, B):
    """The float32 register path (packed systems at n <= 16, one system per
    warp above, identity padding at 33) rounds every operation as the plain
    version does: equal bit for bit on every lane, and the zero-pivot lane
    (lane 1) non-finite in both."""
    g = torch.Generator(device=cuda).manual_seed(100 * n + B)
    A = torch.randn(B, n, n, generator=g, device=cuda) + n * torch.eye(n, device=cuda)
    b = torch.randn(B, n, generator=g, device=cuda)
    if B > 1:
        A[1, 0, 0] = 0.0
    before = solve_gauss_jordan_cuda.launch_count
    xk = solve_gauss_jordan_cuda(A, b)
    xp = solve_gauss_jordan(A, b)
    torch.cuda.synchronize()
    assert solve_gauss_jordan_cuda.launch_count == before + 1
    zero = torch.arange(B, device=cuda) == 1
    assert not torch.isfinite(xk[zero]).all(dim=1).any() and not torch.isfinite(xp[zero]).all(dim=1).any()
    assert torch.isfinite(xp[~zero]).all() and torch.equal(xk[~zero], xp[~zero])


def test_batched_solve_on_cuda_launches_kernel(cuda):
    A = 2 * torch.eye(8, device=cuda).expand(5, 8, 8)
    before = solve_gauss_jordan_cuda.launch_count
    x = batched_solve(A, torch.ones(5, 8, device=cuda))
    assert solve_gauss_jordan_cuda.launch_count == before + 1
    torch.testing.assert_close(x, torch.full((5, 8), 0.5, device=cuda))


def test_vec_env_runs_on_the_card_by_default(cuda):
    env = VecEnv(make_ieee33_task())
    assert env.device.type == "cuda" and env.tables.chord_t.W_pack.is_cuda
    state, obs = env.reset(4)
    assert obs.is_cuda and state.bus_vm.is_cuda


def test_kernel_rejects_what_it_does_not_take(cuda):
    A = torch.eye(4, device=cuda).expand(2, 4, 4).contiguous()
    b = torch.ones(2, 4, device=cuda)
    for bad in ((A.half(), b.half()), (A.transpose(1, 2), b), (A.cpu(), b.cpu()), (A, b[:, :3]),
                (A[:0], b[:0])):
        with pytest.raises(ValueError):
            solve_gauss_jordan_cuda(*bad)


def test_f32_step_on_card_matches_cpu(cuda):
    """The f32 step on the card against the same step on the CPU.  Both run
    the same algorithm; sums are taken in another order, so the chord can
    exit an iteration apart and voltages agree to the solver's tolerance,
    not bitwise.  The slack device's injection (obs columns of the slack's
    P and Q) amplifies the voltage gap by the slack row of Y (~310 p.u.),
    hence its wider bound in MW; rewards are compared where the slack
    branch's flow is clear of zero (see chip_smoke.py)."""
    B = 64
    envs = {d: VecEnv(make_ieee33_task(), dtype=torch.float32, device=d) for d in ("cpu", "cuda")}
    states = {d: e.reset(B)[0] for d, e in envs.items()}
    spec = envs["cpu"].spec
    slack_cols = [spec.slack_dev_pos, spec.n_dev + spec.slack_dev_pos]
    other_cols = [c for c in range(envs["cpu"].n_obs) if c not in slack_cols]
    rng = np.random.default_rng(0)
    lo, hi = envs["cpu"].action_low.numpy(), envs["cpu"].action_high.numpy()
    for _ in range(4):
        a = torch.as_tensor(rng.uniform(lo, hi, (B, 3)).astype(np.float32))
        outs = {}
        for d, e in envs.items():
            states[d], obs, r, done, info = e.step(states[d], a.to(d))
            assert not done.any() and float(info["diff"].max()) <= 1e-4
            outs[d] = (obs.cpu(), r.cpu(), states[d].bus_vm.cpu(), info["e_loss"].cpu())
        (obs_g, r_g, vm_g, el_g), (obs_c, r_c, vm_c, _) = outs["cuda"], outs["cpu"]
        torch.testing.assert_close(vm_g, vm_c, rtol=0, atol=5e-6)
        # Set-point columns: the same clip of the same action, up to the card
        # dividing by baseMVA as a multiply by its reciprocal (1 ulp).
        torch.testing.assert_close(obs_g[:, other_cols], obs_c[:, other_cols], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(obs_g[:, slack_cols], obs_c[:, slack_cols], rtol=0, atol=2e-2)
        clear = el_g.abs() >= 1e-4
        torch.testing.assert_close(r_g[clear], r_c[clear], rtol=2e-3, atol=2e-4)


def _chord_problem(net, delta_t, B, seed, device):
    """Random injections and taps for a network's f32 chord constants, a
    noisy warm start, lane 0 with a NaN guess (it must start flat)."""
    tb = make_tables(load_network(net), delta_t, 100, dtype=torch.float32, device=device)
    n = tb.n_bus - 1
    rng = np.random.default_rng(seed)
    p = (0.01 * rng.standard_normal((B, n))).astype(np.float32)
    q = (0.01 * rng.standard_normal((B, n))).astype(np.float32)
    d = (rng.uniform(-2, 2, (B, 2)) * tb.chord_has_oltc).astype(np.float32)
    x0 = np.concatenate([np.zeros((B, n)), np.ones((B, n))], 1) + 0.01 * rng.standard_normal((B, 2 * n))
    x0 = x0.astype(np.float32)
    x0[0, 3] = np.nan
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return tb.chord_t, (t(p), t(q), t(d[:, 1]), t(d[:, 0]), t(d[:, 0]), t(d[:, 1]), t(x0))


@pytest.mark.parametrize("net,delta_t", [(ieee33_network, 1.0), (anm6_network, 0.25)], ids=["ieee33", "anm6"])
@pytest.mark.parametrize("B", [7, 33, 1001])
def test_chord_kernel_matches_plain_version(cuda, net, delta_t, B):
    """K2 against the plain chord on the same card inputs: the same accepted
    lanes, n_iter equal on all but a rare lane (a float64 dot product summed
    in another order can move a float32 rounding, and a plateau exit by an
    iteration), x within the solver's own scale (2e-5), F and diff within the
    acceptance band."""
    ct, args = _chord_problem(net, delta_t, B, B, cuda)
    before = chord_solve_cuda.launch_count
    xk, Fk, dk, ik, ak = pf.chord_solve(*args[:6], ct, x0=args[6])
    xp, Fp, dp, ip, ap = pf.chord_solve_plain(*args[:6], ct, x0=args[6])
    torch.cuda.synchronize()
    assert chord_solve_cuda.launch_count == before + 1
    assert torch.equal(ak, ap) and bool(ak.all())
    assert int((ik != ip).sum()) <= max(1, B // 500)
    torch.testing.assert_close(xk, xp, rtol=0, atol=2e-5)
    torch.testing.assert_close(Fk, Fp, rtol=0, atol=1e-4)
    torch.testing.assert_close(dk, dp, rtol=0, atol=1e-4)
    # Lane 0's NaN guess starts flat: the same exit as a flat start.
    xf, _, _, itf, _ = pf.chord_solve(*(a[:1] for a in args[:6]), ct)
    assert torch.equal(xk[0], xf[0]) and int(ik[0]) == int(itf[0])


@pytest.mark.parametrize("net,delta_t", [(ieee33_network, 1.0), (anm6_network, 0.25)], ids=["ieee33", "anm6"])
@pytest.mark.parametrize("B", [1, 7, 33, 1001])
def test_chord_kernel_on_mixed_starts(cuda, net, delta_t, B):
    """Flat (a NaN guess), warm and bad-basin starts mixed lane by lane, at
    fewer lanes than a block's slots and at enough to refill every slot
    many times: the same accepted lanes as the plain chord, n_iter equal on
    all but a rare lane, x within 2e-5, F and diff within the acceptance
    band; the reset lanes leave exactly flat."""
    ct, args = _chord_problem(net, delta_t, B, 3 * B + 1, cuda)
    n = ct.n
    rng = np.random.default_rng(B)
    kind = torch.as_tensor(rng.integers(0, 3, B), device=cuda)
    bad = torch.tensor([[0.0] * n + [1e-6] * n, [0.0] * n + [-1.0] * n, [30.0] * n + [1.0] * n,
                        [0.0] * n + [1e15] * n], device=cuda)[torch.as_tensor(rng.integers(0, 4, B), device=cuda)]
    x0 = torch.where((kind == 0)[:, None], torch.full_like(args[6], float("nan")), args[6])
    x0 = torch.where((kind == 2)[:, None], bad, x0).contiguous()
    before = chord_solve_cuda.launch_count
    xk, Fk, dk, ik, ak = pf.chord_solve(*args[:6], ct, x0=x0)
    xp, Fp, dp, ip, ap = pf.chord_solve_plain(*args[:6], ct, x0=x0)
    torch.cuda.synchronize()
    assert chord_solve_cuda.launch_count == before + 1
    assert torch.equal(ak, ap)
    assert int((ik != ip).sum()) <= max(1, B // 500)
    torch.testing.assert_close(xk, xp, rtol=0, atol=2e-5)
    torch.testing.assert_close(Fk, Fp, rtol=0, atol=1e-4)
    torch.testing.assert_close(dk, dp, rtol=0, atol=1e-4)
    reset = (ik == 0) & ~ak
    assert torch.equal(xk[reset], ct.flat.expand(int(reset.sum()), -1))


def test_chord_kernel_trig_guard_resets_to_flat(cuda):
    """A lane whose warm start at |θ| = 1 rad solves its injections exactly
    (with the kernel's own Taylor sin/cos) is not accepted and leaves flat,
    with the flat start's residual, as the plain version does."""
    tb = make_tables(load_network(ieee33_network), 1.0, 100, dtype=torch.float32, device=cuda)
    n = tb.n_bus - 1
    Y = np.asarray(tb.chord.Y0re, np.float64) + 1j * np.asarray(tb.chord.Y0im, np.float64)
    th = np.ones(n)
    t2 = th * th
    sn = th * (1.0 + t2 * (-1.0 / 6.0 + t2 * (1.0 / 120.0 - t2 * (1.0 / 5040.0))))
    cs = 1.0 + t2 * (-0.5 + t2 * (1.0 / 24.0 - t2 * (1.0 / 720.0)))
    V = np.concatenate([[1.0], cs + 1j * sn])
    S = V * np.conj(Y @ V)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=cuda)  # noqa: E731
    p, q = t(np.repeat(S.real[None, 1:], 3, 0)), t(np.repeat(S.imag[None, 1:], 3, 0))
    x0 = t(np.repeat(np.concatenate([th, np.ones(n)])[None], 3, 0))
    z = torch.zeros(3, device=cuda)
    xk, Fk, dk, ik, ak = pf.chord_solve(p, q, z, z, z, z, tb.chord_t, xtol=1e-2, x0=x0)
    xp, Fp, dp, ip, ap = pf.chord_solve_plain(p, q, z, z, z, z, tb.chord_t, xtol=1e-2, x0=x0)
    assert not ak.any() and not ap.any()
    assert torch.equal(xk, tb.chord_t.flat.expand(3, -1)) and torch.equal(xk, xp)
    assert (ik == 0).all() and torch.equal(dk, dp) and bool((dk > 1e-2).all())


def test_chord_kernel_rejects_what_it_does_not_take(cuda):
    ct, args = _chord_problem(ieee33_network, 1.0, 4, 0, cuda)
    p, q, wa, wb, dr, di, x0 = args
    ct64 = make_tables(load_network(ieee33_network), 1.0, 100, dtype=torch.float64, device=cuda).chord_t
    before = chord_solve_cuda.launch_count
    bad_calls = [
        ((p.double(), q.double(), wa.double(), wb.double(), dr.double(), di.double(), ct64), {}),  # f64
        ((p.cpu(), q.cpu(), wa.cpu(), wb.cpu(), dr.cpu(), di.cpu(), ct), {}),                     # CPU
        ((p.t().contiguous().t(), q, wa, wb, dr, di, ct), {}),                                   # strided
        ((p, q, wa, wb, dr, di, ct), {"x0": x0[:, ::2]}),                                          # x0 shape
        ((p[:0], q[:0], wa[:0], wb[:0], dr[:0], di[:0], ct), {}),                                  # empty
    ]
    for a, kw in bad_calls:
        with pytest.raises(ValueError):
            chord_solve_cuda(*a, **kw)
    assert chord_solve_cuda.launch_count == before
    with pytest.raises(ValueError):  # the dispatcher hands f64 on the card to the kernel, which refuses it
        pf.chord_solve(p.double(), q.double(), wa.double(), wb.double(), dr.double(), di.double(), ct64)


def _member_pairs(env_cpu, env_gpu):
    from gym_anm_torch.vec import controllers, experts

    cpu = controllers.make_suite(env_cpu) + experts.make_expert_zoo(env_cpu)
    gpu = controllers.make_suite(env_gpu) + experts.make_expert_zoo(env_gpu)
    return list(zip(cpu, gpu))


def _to(tree, device):
    from gym_anm_torch.vec.core import tree_map

    return tree_map(lambda x: x.to(device), tree)


def test_controllers_decide_on_the_card_as_on_the_cpu_without_syncing(cuda):
    """Every L0-L5 controller and zoo member at float32, from the same state
    and carry on the card and on the CPU: the same carries (cap states, tap
    indices, timers, the L5 grid choice) bit for bit, and actions within
    1e-6; no ``act`` on the card synchronizes with the host."""
    from gym_anm_torch.offline_vec import action_noise
    from gym_anm_torch.vec import make_ieee33_multicap_task
    from gym_anm_torch.vec.core import tree_map

    B = 96
    env_c = VecEnv(make_ieee33_multicap_task(), dtype=torch.float32, device="cpu")
    env_g = VecEnv(make_ieee33_multicap_task(), dtype=torch.float32, device=cuda)
    g = torch.Generator().manual_seed(0)
    state, obs = env_c.reset(B, g)
    states = []
    for k in range(6):  # voltages across the controllers' thresholds
        state, obs, _, _, _ = env_c.step_autoreset_batch(state, env_c.random_policy()(g, obs, k), g)
        states.append((state, obs))
    for c_cpu, c_gpu in _member_pairs(env_c, env_g):
        carry_c, carry_g = c_cpu.init_carry(B), c_gpu.init_carry(B)
        for state, obs in states:
            noise = action_noise(env_c, B, g)
            args = (noise.to(cuda), _to(state, cuda), obs.to(cuda), carry_g)
            a_c, carry_c = c_cpu.act(noise, state, obs, carry_c)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                a_g, carry_g = c_gpu.act(*args)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.testing.assert_close(a_g.cpu(), a_c, rtol=0, atol=1e-6, msg=c_cpu.name)
            tree_map(lambda x, y: torch.testing.assert_close(x.cpu(), y, rtol=0, atol=0, msg=c_cpu.name),
                     carry_g, carry_c)


def test_block_collector_on_the_card_launches_k2(cuda):
    """The L0-L5 block collector at a small batch on the card: trajectories
    of the expected shapes, finite, actions in the box, K2 launched."""
    from gym_anm_torch.offline_vec import make_block_collector
    from gym_anm_torch.vec import make_ieee33_multicap_task
    from gym_anm_torch.vec.controllers import make_suite

    env = VecEnv(make_ieee33_multicap_task(), dtype=torch.float32, device=cuda)
    collect, assignment = make_block_collector(env, make_suite(env), 60, 4)
    before = chord_solve_cuda.launch_count
    obs, act, rew, nobs, done = collect(torch.Generator(device=cuda).manual_seed(0))
    torch.cuda.synchronize()
    assert chord_solve_cuda.launch_count >= before + 4
    assert obs.shape == nobs.shape == (4, 60, env.n_obs) and act.shape == (4, 60, env.n_action)
    assert rew.shape == done.shape == (4, 60) and assignment.shape == (60,)
    assert all(bool(torch.isfinite(x).all()) for x in (obs, act, rew, nobs))
    assert bool((act >= env.action_low).all()) and bool((act <= env.action_high).all())


def test_anm6easy_on_the_card_launches_k2_at_n5(cuda):
    """ANM6Easy at float32 on the card with an observation plan: K2 runs the
    5-unknown chord, observations stay within the plan's bounds."""
    from gym_anm_torch.vec import make_anm6easy_task

    env = VecEnv(make_anm6easy_task(), dtype=torch.float32, device=cuda,
                 obs=[("bus_v_magn", "all", "kV"), ("des_soc", "all", "pu"), ("aux", "all", None)])
    g = torch.Generator(device=cuda).manual_seed(1)
    before = chord_solve_cuda.launch_count
    state, obs = env.reset(256, g)
    for k in range(4):
        state, obs, r, d, info = env.step_autoreset_batch(state, env.random_policy()(g, obs, k), g)
        assert bool(torch.isfinite(obs).all()) and bool((obs >= env.obs_low).all()) and bool((obs <= env.obs_high).all())
    assert env.tables.n_bus - 1 == 5 and chord_solve_cuda.launch_count > before


def _dcopf_lanes(task, N, B, seed, cuda, max_iter, gamma=0.995, safety_margin=0.96):
    """A task's N-stage DC-OPF on the card and the bounds of B reset states
    (the constant forecast; ANM6Easy's perfect forecast at N > 1)."""
    from gym_anm_torch.agents.mpc import build_dcopf_structure
    from gym_anm_torch.vec import mpc

    env = VecEnv(task, dtype=torch.float32, device=cuda)
    state, _ = env.reset(B, torch.Generator(device=cuda).manual_seed(seed))
    st = build_dcopf_structure(env.spec, env.task.delta_t, env.task.lamb, gamma, safety_margin, N)
    dc = mpc.make_vec_dcopf(st, device=cuda, max_iter=max_iter)
    if N > 1:
        P_load, P_pot = mpc.profile_forecast_fn(env, N)(state)
    else:
        P_load, P_pot = state.dev_p[:, torch.as_tensor(env.spec.load_pos, device=cuda)], state.p_pot
    return dc, *mpc.lane_bounds(dc, P_load, P_pot, state.soc)


@pytest.mark.parametrize("name,N,max_iter", [("anm6easy", 1, 4000), ("anm6easy", 2, 400), ("anm6easy", 4, 400),
                                             ("anm6easy", 8, 200), ("anm6easy", 16, 96),
                                             ("ieee33_renewable", 1, 400), ("multicap17", 1, 400)])
def test_admm_kernel_matches_plain_version(cuda, name, N, max_iter):
    """K5 against its plain version on the LPs of 96 reset states of each
    shape family (n = 21..336, m = 39..624 on ANM6Easy; n = 111/115 on the
    IEEE33 networks), cold and then warm from the kernel's solution, with
    three lanes made unsolvable: converged, bounds_ok and feasible equal on
    every lane, iterations on all but 0.5% of lanes, x within 1e-5 where
    they are; the unsolvable lanes run no sweep and keep their warm start."""
    from gym_anm_torch.vec import make_anm6easy_task, make_ieee33_multicap_task, make_ieee33_renewable_task
    from gym_anm_torch.vec import mpc
    from gym_anm_torch.vec.admm_cuda import solve_dcopf_cuda

    task = {"anm6easy": make_anm6easy_task, "ieee33_renewable": make_ieee33_renewable_task,
            "multicap17": make_ieee33_multicap_task}[name]()
    B = 96
    dc, l, u = _dcopf_lanes(task, N, B, N, cuda, max_iter)
    bad = torch.arange(B, device=cuda) % 40 == 7
    row = dc.m - dc.n + 1
    l[bad, row] = u[bad, row] + 1.0
    warm = mpc.init_warm(dc, B)
    for _ in range(2):
        before = solve_dcopf_cuda.launch_count
        sk = mpc.solve_dcopf(dc, l, u, warm)
        sp = mpc.solve_dcopf_plain(dc, l, u, warm)
        torch.cuda.synchronize()
        assert solve_dcopf_cuda.launch_count == before + 1
        for f in ("converged", "bounds_ok", "feasible"):
            assert torch.equal(getattr(sk, f), getattr(sp, f)), f
        same = sk.iterations == sp.iterations
        assert int((~same).sum()) <= B // 200
        torch.testing.assert_close(sk.x[same], sp.x[same], rtol=0, atol=1e-5)
        assert torch.equal(sk.bounds_ok, ~bad) and bool((sk.iterations[bad] == 0).all())
        assert all(torch.equal(w[bad], w0[bad]) for w, w0 in zip(sk.warm, warm))
        warm = sk.warm


def test_admm_kernel_rejects_what_it_does_not_take(cuda):
    from gym_anm_torch.vec import make_anm6easy_task
    from gym_anm_torch.vec import mpc
    from gym_anm_torch.vec.admm_cuda import solve_dcopf_cuda

    dc, l, u = _dcopf_lanes(make_anm6easy_task(), 1, 4, 0, cuda, 48)
    w = mpc.init_warm(dc, 4)
    before = solve_dcopf_cuda.launch_count
    for args in ((dc, l.double(), u.double(), w), (dc, l.cpu(), u.cpu(), tuple(x.cpu() for x in w)),
                 (dc, l.t().contiguous().t(), u, w), (dc, l[:, :-1].contiguous(), u, w), (dc, l[:0], u[:0], w)):
        with pytest.raises(ValueError):
            solve_dcopf_cuda(*args)
    assert solve_dcopf_cuda.launch_count == before


def test_mpc_act_on_the_card_launches_k5_without_syncing(cuda):
    """``make_vec_mpc`` on the card: one K5 launch per ``act``, no host sync
    inside it, and the same actions as on the CPU within 2e-2 MW from the
    same state (budget 48, float32 both)."""
    from gym_anm_torch.vec import make_anm6easy_task, make_vec_mpc
    from gym_anm_torch.vec.admm_cuda import solve_dcopf_cuda

    env_c = VecEnv(make_anm6easy_task(), dtype=torch.float32, device="cpu")
    env_g = VecEnv(make_anm6easy_task(), dtype=torch.float32, device=cuda)
    ctrl_c = make_vec_mpc(env_c, gamma=0.995, safety_margin=0.96)
    ctrl_g = make_vec_mpc(env_g, gamma=0.995, safety_margin=0.96)
    state, obs = env_c.reset(64, torch.Generator().manual_seed(2))
    carry_c, carry_g = ctrl_c.init_carry(64), ctrl_g.init_carry(64)
    for _ in range(3):
        a_c, carry_c = ctrl_c.act(None, state, obs, carry_c)
        before = solve_dcopf_cuda.launch_count
        state_g, obs_g = _to(state, cuda), obs.to(cuda)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            a_g, carry_g = ctrl_g.act(None, state_g, obs_g, carry_g)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert solve_dcopf_cuda.launch_count == before + 1
        torch.testing.assert_close(a_g.cpu(), a_c, rtol=0, atol=2e-2)
        state, obs, _, _, _ = env_c.step_autoreset_batch(state, a_c)


# ----------------------------------------------------------------------
# Networks above 33 buses: the wide chord kernel and K1's blocked route
# ----------------------------------------------------------------------

def _feeder_chord_problem(n_bus, B, seed, device):
    """_chord_problem's injections, taps and warm starts on a random radial
    feeder of ``n_bus`` buses (gym_anm_torch.networks.random_feeder)."""
    from gym_anm_torch.networks.random_feeder import random_radial_network

    return _chord_problem(random_radial_network(np.random.default_rng(n_bus), n_bus), 0.5, B, seed, device)


@pytest.mark.parametrize("n", [33, 47, 63, 129, 512])
@pytest.mark.parametrize("B", [1, 7, 1001])
def test_wide_chord_kernel_matches_plain_version(cuda, n, B):
    """The wide chord kernel (n > 32) against the plain chord on flat (a NaN
    guess), warm and bad-basin starts mixed lane by lane, so that a block's
    lane slots exit in different rounds and refill: the same accepted lanes,
    n_iter equal on all but a rare lane, x within 1e-5 (chip_smoke.py's
    chord_vs_plain limit), F and diff within the acceptance band, the reset
    lanes exactly flat; the dispatch counts a wide launch."""
    ct, args = _feeder_chord_problem(n + 1, B, 5 * B + n, cuda)
    assert ct.n == n
    rng = np.random.default_rng(n + B)
    kind = torch.as_tensor(rng.integers(0, 3, B), device=cuda)
    bad = torch.tensor([[0.0] * n + [1e-6] * n, [0.0] * n + [-1.0] * n, [30.0] * n + [1.0] * n,
                        [0.0] * n + [1e15] * n], device=cuda)[torch.as_tensor(rng.integers(0, 4, B), device=cuda)]
    x0 = torch.where((kind == 0)[:, None], torch.full_like(args[6], float("nan")), args[6])
    x0 = torch.where((kind == 2)[:, None], bad, x0).contiguous()
    before, wide = chord_solve_cuda.launch_count, chord_solve_cuda.launches["wide"]
    xk, Fk, dk, ik, ak = pf.chord_solve(*args[:6], ct, x0=x0)
    xp, Fp, dp, ip, ap = pf.chord_solve_plain(*args[:6], ct, x0=x0)
    torch.cuda.synchronize()
    assert chord_solve_cuda.launch_count == before + 1 and chord_solve_cuda.launches["wide"] == wide + 1
    assert torch.equal(ak, ap)
    assert int((ik != ip).sum()) <= max(1, B // 500)
    torch.testing.assert_close(xk, xp, rtol=0, atol=1e-5)
    torch.testing.assert_close(Fk, Fp, rtol=0, atol=1e-4)
    torch.testing.assert_close(dk, dp, rtol=0, atol=1e-4)
    reset = (ik == 0) & ~ak
    assert torch.equal(xk[reset], ct.flat.expand(int(reset.sum()), -1))


def test_wide_chord_kernel_refuses_networks_above_its_limit(cuda):
    from gym_anm_torch.physics.chord_cuda import MAX_N

    ct, args = _feeder_chord_problem(MAX_N + 2, 2, 0, cuda)
    before = chord_solve_cuda.launch_count
    with pytest.raises(ValueError, match=str(MAX_N)):
        chord_solve_cuda(*args[:6], ct, x0=args[6])
    assert chord_solve_cuda.launch_count == before


@pytest.mark.parametrize("dtype,n", [(torch.float32, 240), (torch.float32, 258), (torch.float32, 300),
                                     (torch.float32, 1024), (torch.float64, 170), (torch.float64, 258)])
def test_kernel_in_device_memory_matches_plain_version(cuda, dtype, n):
    """K1 on systems too large for a block's shared memory (blocked
    Gauss-Jordan on a device scratch buffer; none of these n is a multiple
    of the panel width): bitwise equal to the plain version at float32,
    within 1e-10 at float64; the zero-pivot lane and the lane with an inf
    entry non-finite in both, as the plain version has them."""
    B = 3 if n > 512 else 5
    g = torch.Generator(device=cuda).manual_seed(n)
    A = torch.randn(B, n, n, generator=g, device=cuda, dtype=dtype) + n * torch.eye(n, device=cuda, dtype=dtype)
    b = torch.randn(B, n, generator=g, device=cuda, dtype=dtype)
    A[1, 0, 0] = 0.0
    A[2, n // 2, 3] = float("inf")
    before = solve_gauss_jordan_cuda.launches["blocked"]
    xk = solve_gauss_jordan_cuda(A, b)
    xp = solve_gauss_jordan(A, b)
    torch.cuda.synchronize()
    assert solve_gauss_jordan_cuda.launches["blocked"] == before + 1
    for lane in (1, 2):
        assert not torch.isfinite(xk[lane]).all() and not torch.isfinite(xp[lane]).all()
    assert torch.equal(torch.isnan(xk), torch.isnan(xp))
    keep = torch.arange(B, device=cuda) > 2
    keep[0] = True
    if dtype == torch.float32:
        assert torch.equal(xk[keep], xp[keep])
    else:
        torch.testing.assert_close(xk[keep], xp[keep], rtol=1e-10, atol=1e-10 * float(xp[keep].abs().max()))


@pytest.mark.parametrize("n_bus,scale", [(48, 0.6), (130, 0.15)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_feeder_step_on_card_matches_cpu(cuda, n_bus, scale, dtype):
    """A random radial feeder above 33 buses steps on the card at float32
    (the wide chord kernel, and the Newton fallback from bad-basin warm
    starts) and at float64 (Newton with K1; above 85 buses in device
    memory), and matches the same step on the CPU: voltages within 5e-6 at
    float32 (the solver's tolerance) and 1e-9 at float64."""
    from gym_anm_torch.networks.random_feeder import feeder_vars, make_feeder_task, random_radial_network

    rng = np.random.default_rng(n_bus)
    net = random_radial_network(rng, n_bus)
    task = make_feeder_task(net, feeder_vars(net, scale, 3, rng))
    B = 16
    envs = {d: VecEnv(task, dtype=dtype, device=d) for d in ("cpu", "cuda")}
    states = {d: e.reset(B)[0] for d, e in envs.items()}
    lo, hi = envs["cpu"].action_low.double().numpy(), envs["cpu"].action_high.double().numpy()
    acts = np.random.default_rng(1).uniform(lo, hi, (3, B, len(lo)))
    k1 = solve_gauss_jordan_cuda.launch_count
    wide = chord_solve_cuda.launches["wide"]
    n = n_bus - 1
    for k in range(3):
        outs = {}
        for d, e in envs.items():
            s = states[d]
            if k == 2 and dtype == torch.float32:  # far-off warm starts: the chord resets, Newton solves
                s = s._replace(v_guess=torch.cat([torch.full((B, n), 30.0), torch.ones(B, n)], 1).to(d))
            states[d], obs, r, done, info = e.step(s, torch.as_tensor(acts[k], dtype=dtype).to(d))
            assert not done.any() and float(info["diff"].max()) <= 1e-4
            outs[d] = states[d].bus_vm.cpu()
        torch.testing.assert_close(outs["cuda"], outs["cpu"], rtol=0, atol=5e-6 if dtype == torch.float32 else 1e-9)
    torch.cuda.synchronize()
    assert solve_gauss_jordan_cuda.launch_count > k1
    if dtype == torch.float32:
        assert chord_solve_cuda.launches["wide"] > wide


# ----------------------------------------------------------------------
# K5 as lane tiles: ragged batches, exits at different checks, NaN bounds
# ----------------------------------------------------------------------

def _admm_agree(dc, l, u, warm, max_diff=0):
    from gym_anm_torch.vec import mpc
    from gym_anm_torch.vec.admm_cuda import solve_dcopf_cuda

    before = solve_dcopf_cuda.launch_count
    sk = mpc.solve_dcopf(dc, l, u, warm)
    sp = mpc.solve_dcopf_plain(dc, l, u, warm)
    torch.cuda.synchronize()
    assert solve_dcopf_cuda.launch_count == before + 1
    for f in ("converged", "bounds_ok", "feasible"):
        assert torch.equal(getattr(sk, f), getattr(sp, f)), f
    same = sk.iterations == sp.iterations
    assert int((~same).sum()) <= max_diff
    torch.testing.assert_close(sk.x[same], sp.x[same], rtol=0, atol=1e-5)
    for a, b_ in zip(sk.warm, sp.warm):
        torch.testing.assert_close(a[same], b_[same], rtol=0, atol=1e-4)
    return sk, sp


@pytest.mark.parametrize("B", [1, 7, 1001])
def test_admm_kernel_on_ragged_batches(cuda, B):
    """Batches that fill no whole tile of 8 lanes (and many tiles, refilled):
    the kernel's lanes against the plain version's, cold and then warm."""
    from gym_anm_torch.vec import make_anm6easy_task, mpc

    dc, l, u = _dcopf_lanes(make_anm6easy_task(), 1, B, B, cuda, 400)
    warm = mpc.init_warm(dc, B)
    for _ in range(2):
        sk, _ = _admm_agree(dc, l, u, warm, max_diff=B // 200)
        warm = sk.warm


def test_admm_kernel_tile_with_lanes_exiting_at_different_checks(cuda):
    """One tile of 8 lanes: two crossed-bound lanes (exit at entry), lanes
    warm from their own solutions (exit at an early check) and cold lanes
    (later checks), interleaved; then 24 such lanes so that slots refill."""
    from gym_anm_torch.vec import make_anm6easy_task, mpc

    for B in (8, 24):
        dc, l, u = _dcopf_lanes(make_anm6easy_task(), 1, B, 3, cuda, 4000)
        cold = mpc.init_warm(dc, B)
        solved = mpc.solve_dcopf_plain(dc, l, u, cold).warm
        lane = torch.arange(B, device=cuda)
        use_warm = (lane % 3 == 1)[:, None]
        warm = tuple(torch.where(use_warm, s, c).contiguous() for s, c in zip(solved, cold))
        bad = lane % 8 == 5
        l = l.clone()
        l[bad, dc.m - dc.n + 2] = u[bad, dc.m - dc.n + 2] + 1.0
        sk, _ = _admm_agree(dc, l, u, warm)
        its = sk.iterations[~bad]
        assert bool((sk.iterations[bad] == 0).all()) and len(set(its.tolist())) > 1
        assert all(torch.equal(w[bad], c[bad]) for w, c in zip(sk.warm, warm))


def test_admm_kernel_on_nan_bounds(cuda):
    """A NaN in a lane's bounds makes it unsolvable in both versions (no
    sweep, warm start passed through), and the other lanes are untouched."""
    from gym_anm_torch.vec import make_anm6easy_task, mpc

    B = 12
    dc, l, u = _dcopf_lanes(make_anm6easy_task(), 1, B, 4, cuda, 400)
    l, u = l.clone(), u.clone()
    l[2, 0] = float("nan")
    u[7, dc.m - 1] = float("nan")
    sk, sp = _admm_agree(dc, l, u, mpc.init_warm(dc, B))
    assert not bool(sk.bounds_ok[2]) and not bool(sk.bounds_ok[7]) and int(sk.bounds_ok.sum()) == B - 2
    assert torch.equal(torch.isinf(sk.r_prim), torch.isinf(sp.r_prim))
