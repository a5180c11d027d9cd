"""gym_anm_torch on a CUDA card: the Gauss-Jordan kernel (K1: its register,
shared-memory and blocked routes, at their edges), the fused
chord-Newton kernels (K2, and its wide kernel above 33 buses), the
exact-Newton kernel (K3), the ADMM kernel (K5) and the flows kernel (K6)
against their plain versions, 16 steps at B = 8192 without a host sync,
the float32 and float64 steps on the card against the CPU, random feeders
above 33 buses among them, and the learners' updates (PPO, CQL) on the card
against the CPU at float64, without a host sync, and under nccl, and the
compat tier's float64 ``Simulator`` on the card against the CPU.

Every test here needs a card and skips without one.  The file imports no
JAX, so on a machine with a card and no JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gym_anm_torch.networks import anm6_network, ieee33_network
from gym_anm_torch.physics import chord_cuda, power_flow as pf
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,n", [(512, 64), (33, 10), (7, 2), (3, 130)])
def test_kernel_matches_plain_version(cuda, dtype, B, n):
    """Every route (registers at n <= 64, the matrix resident in shared
    memory above) rounds as the plain version:
    bitwise equal on every finite lane, and the zero-pivot lane non-finite
    in both."""
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
    assert torch.isfinite(xp[keep]).all() and torch.equal(xk[keep], xp[keep])


@pytest.mark.parametrize("dtype,n,route", [
    (torch.float32, 64, "regs"), (torch.float32, 65, "smem"), (torch.float32, 94, "smem"),
    (torch.float32, 126, "smem"), (torch.float32, 161, "smem"), (torch.float32, 162, "blocked"),
    (torch.float64, 10, "regs"), (torch.float64, 33, "regs"), (torch.float64, 64, "regs"),
    (torch.float64, 65, "smem"), (torch.float64, 94, "smem"), (torch.float64, 111, "smem"),
    (torch.float64, 112, "blocked"), (torch.float64, 126, "blocked")])
@pytest.mark.parametrize("B", [7, 300])
def test_routes_at_their_edges_are_bitwise_the_plain_version(cuda, dtype, n, route, B):
    """Both sides of each route edge (registers | resident in shared memory
    | blocked in device memory, at the H100's edges; the card's own limit
    decides through ``k1_route``): bitwise equal to the plain version, the
    zero-pivot lane and the lane with an inf entry non-finite as the plain
    version has them, and the route's counter moved.  B = 300 gives the
    persistent grid more systems than blocks at large n."""
    from gym_anm_torch._build import load_library
    from gym_anm_torch.physics.linsolve_cuda import H100_SMEM_OPTIN, k1_route

    limit = load_library().gj_smem_limit_bytes()
    got = k1_route(n, dtype, limit)[0]
    if limit == H100_SMEM_OPTIN:
        assert got == route
    g = torch.Generator(device=cuda).manual_seed(10 * n + B)
    A = torch.randn(B, n, n, generator=g, device=cuda, dtype=dtype) + n * torch.eye(n, device=cuda, dtype=dtype)
    b = torch.randn(B, n, generator=g, device=cuda, dtype=dtype)
    A[1, 0, 0] = 0.0
    A[2, n // 2, 3] = float("inf")
    before = dict(solve_gauss_jordan_cuda.launches)
    xk = solve_gauss_jordan_cuda(A, b)
    xp = solve_gauss_jordan(A, b)
    torch.cuda.synchronize()
    assert solve_gauss_jordan_cuda.launches[got] == before[got] + 1
    for lane in (1, 2):
        assert not torch.isfinite(xk[lane]).all() and not torch.isfinite(xp[lane]).all()
    assert torch.equal(torch.isnan(xk), torch.isnan(xp))
    keep = torch.arange(B, device=cuda) > 2
    keep[0] = True
    assert torch.isfinite(xp[keep]).all() and torch.equal(xk[keep], xp[keep])


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


def _chord_batch(B, cuda):
    """A batch size, or one named against the tile kernel's routes on this
    card: "switch-1", "switch", "switch+1" about the 16-slot route's first
    batch (``chord_cuda.TILE16_LANES_PER_SM`` lanes on every SM), "card*k"
    k times that (every slot refills about k times)."""
    if isinstance(B, int):
        return B
    full = chord_cuda.TILE16_LANES_PER_SM * torch.cuda.get_device_properties(cuda).multi_processor_count
    if B.startswith("card*"):
        return full * int(B[5:])
    return full + {"switch-1": -1, "switch": 0, "switch+1": 1}[B]


def _tile_route(B, n, cuda):
    """The launch counter of the tile route the wrapper takes for B lanes."""
    return f"tile{chord_cuda.tile_slots(B, n, torch.cuda.get_device_properties(cuda).multi_processor_count)}"


@pytest.mark.parametrize("net,delta_t", [(ieee33_network, 1.0), (anm6_network, 0.25)], ids=["ieee33", "anm6"])
@pytest.mark.parametrize("B", [7, 31, 32, 33, 1001, "switch-1", "switch", "switch+1"])
def test_chord_kernel_matches_plain_version(cuda, net, delta_t, B):
    """K2 against the plain chord on the same card inputs: the same accepted
    lanes, n_iter equal on all but a rare lane (a float64 dot product summed
    in another order can move a float32 rounding, and a plateau exit by an
    iteration), x within the solver's own scale (2e-5), F and diff within the
    acceptance band; on each side of a block's slots and of the route
    switch, through the route the wrapper picks."""
    B = _chord_batch(B, cuda)
    ct, args = _chord_problem(net, delta_t, B, B, cuda)
    route = _tile_route(B, ct.n, cuda)
    before, on_route = chord_solve_cuda.launch_count, chord_solve_cuda.launches[route]
    xk, Fk, dk, ik, ak = pf.chord_solve(*args[:6], ct, x0=args[6])
    xp, Fp, dp, ip, ap = pf.chord_solve_plain(*args[:6], ct, x0=args[6])
    torch.cuda.synchronize()
    assert chord_solve_cuda.launch_count == before + 1 and chord_solve_cuda.launches[route] == on_route + 1
    assert torch.equal(ak, ap) and bool(ak.all())
    assert int((ik != ip).sum()) <= max(1, B // 500)
    torch.testing.assert_close(xk, xp, rtol=0, atol=2e-5)
    torch.testing.assert_close(Fk, Fp, rtol=0, atol=1e-4)
    torch.testing.assert_close(dk, dp, rtol=0, atol=1e-4)
    # Lane 0's NaN guess starts flat: the same exit as a flat start.
    xf, _, _, itf, _ = pf.chord_solve(*(a[:1] for a in args[:6]), ct)
    assert torch.equal(xk[0], xf[0]) and int(ik[0]) == int(itf[0])


@pytest.mark.parametrize("net,delta_t", [(ieee33_network, 1.0), (anm6_network, 0.25)], ids=["ieee33", "anm6"])
@pytest.mark.parametrize("B", [1, 7, 31, 32, 33, 1001, "switch-1", "switch", "switch+1", "card*4"])
def test_chord_kernel_on_mixed_starts(cuda, net, delta_t, B):
    """Flat (a NaN guess), warm and bad-basin starts mixed lane by lane, at
    fewer lanes than a block's slots, on each side of a block's slots and of
    the route switch, and at enough to refill every slot of the card many
    times (four times the 16-slot route's lanes on the card): the same
    accepted lanes as the plain chord, n_iter equal on all but a rare lane,
    x within 2e-5, F and diff within the acceptance band; the reset lanes
    leave exactly flat."""
    B = _chord_batch(B, cuda)
    ct, args = _chord_problem(net, delta_t, B, 3 * B + 1, cuda)
    n = ct.n
    rng = np.random.default_rng(B)
    kind = torch.as_tensor(rng.integers(0, 3, B), device=cuda)
    bad = torch.tensor([[0.0] * n + [1e-6] * n, [0.0] * n + [-1.0] * n, [30.0] * n + [1.0] * n,
                        [0.0] * n + [1e15] * n], device=cuda)[torch.as_tensor(rng.integers(0, 4, B), device=cuda)]
    x0 = torch.where((kind == 0)[:, None], torch.full_like(args[6], float("nan")), args[6])
    x0 = torch.where((kind == 2)[:, None], bad, x0).contiguous()
    route = _tile_route(B, n, cuda)
    before, on_route = chord_solve_cuda.launch_count, chord_solve_cuda.launches[route]
    xk, Fk, dk, ik, ak = pf.chord_solve(*args[:6], ct, x0=x0)
    xp, Fp, dp, ip, ap = pf.chord_solve_plain(*args[:6], ct, x0=x0)
    torch.cuda.synchronize()
    assert chord_solve_cuda.launch_count == before + 1 and chord_solve_cuda.launches[route] == on_route + 1
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
    of the panel width): bitwise equal to the plain version at float32 and
    float64; the zero-pivot lane and the lane with an inf entry non-finite
    in both, as the plain version has them."""
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
    assert torch.equal(xk[keep], xp[keep])


@pytest.mark.parametrize("n_bus,scale", [(48, 0.6), (130, 0.15)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_feeder_step_on_card_matches_cpu(cuda, n_bus, scale, dtype):
    """A random radial feeder above 33 buses steps on the card at float32
    (the wide chord kernel, and the Newton fallback from bad-basin warm
    starts) and at float64 (Newton in K3 wide, its [J | F] resident in a
    block's shared memory at 48 buses, on a cluster at 130 on an H100; K1
    never launches on its own), and matches the same step on the CPU:
    voltages within 5e-6 at float32 (the solver's tolerance) and 1e-9 at
    float64."""
    from gym_anm_torch._build import load_library
    from gym_anm_torch.physics.newton_cuda import newton_fallback_cuda, wide_launch
    from gym_anm_torch.networks.random_feeder import feeder_vars, make_feeder_task, random_radial_network

    rng = np.random.default_rng(n_bus)
    net = random_radial_network(rng, n_bus)
    task = make_feeder_task(net, feeder_vars(net, scale, 3, rng))
    B = 16
    envs = {d: VecEnv(task, dtype=dtype, device=d) for d in ("cpu", "cuda")}
    states = {d: e.reset(B)[0] for d, e in envs.items()}
    lo, hi = envs["cpu"].action_low.double().numpy(), envs["cpu"].action_high.double().numpy()
    acts = np.random.default_rng(1).uniform(lo, hi, (3, B, len(lo)))
    k1, k3w = solve_gauss_jordan_cuda.launch_count, dict(newton_fallback_cuda.launches_by_route)
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
    assert solve_gauss_jordan_cuda.launch_count == k1
    route = wide_launch(load_library(), 2 * n, dtype, B, True)[0]
    assert newton_fallback_cuda.launches_by_route[route] > k3w[route]
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


@pytest.mark.parametrize("N,B,max_iter", [pytest.param(1, B, 400, id=str(B)) for B in (1, 7, 1001)] +
                         [pytest.param(8, B, 200, id=f"n168-{B}") for B in (1, 15, 16, 17, 129)] +
                         [pytest.param(8, 16384, 48, id="n168-16384")])
def test_admm_kernel_on_ragged_batches(cuda, N, B, max_iter):
    """Batches that fill no whole tile of 8 lanes (and many tiles, refilled):
    the kernel's lanes against the plain version's, cold and then warm.  At
    the MPC cell's shape (N = 8: n = 168, m = 312, the streamed route) also
    batches about one consumer warp's 16 lanes and a few blocks' worth, at
    the 200 sweeps of ``test_admm_kernel_matches_plain_version``'s N = 8,
    and more lanes than the card's resident slots hold at once, at the
    cell's budget of 48."""
    from gym_anm_torch._build import load_library
    from gym_anm_torch.vec import make_anm6easy_task, mpc

    dc, l, u = _dcopf_lanes(make_anm6easy_task(), N, B, B, cuda, max_iter)
    lanes = load_library().admm_stream_lanes(B, dc.n, dc.m)
    assert (lanes > 0) == (N == 8)
    if B == 16384:
        assert lanes * torch.cuda.get_device_properties(cuda).multi_processor_count < B
    warm = mpc.init_warm(dc, B)
    for _ in range(2):
        sk, _ = _admm_agree(dc, l, u, warm, max_diff=B // 200)
        warm = sk.warm


@pytest.mark.parametrize("N,sizes,max_iter", [(1, (8, 24), 4000), (8, (16, 48), 200)])
def test_admm_kernel_tile_with_lanes_exiting_at_different_checks(cuda, N, sizes, max_iter):
    """One tile of 8 lanes: two crossed-bound lanes (exit at entry), lanes
    warm from their own solutions (exit at an early check) and cold lanes
    (later checks), interleaved; then 24 such lanes so that slots refill.  At
    the MPC cell's shape (N = 8, streamed) one consumer warp's 16 lanes, then
    48 in one block: its warps' lanes exit at different checks while the
    block's other slots sweep on, to the 200 sweeps of N = 8 in
    ``test_admm_kernel_matches_plain_version``."""
    from gym_anm_torch.vec import make_anm6easy_task, mpc

    for B in sizes:
        dc, l, u = _dcopf_lanes(make_anm6easy_task(), N, B, 3, cuda, max_iter)
        cold = mpc.init_warm(dc, B)
        solved = mpc.solve_dcopf_plain(dc._replace(max_iter=4000), l, u, cold).warm  # converged warm starts
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


@pytest.mark.parametrize("N", [1, 8])
def test_admm_kernel_on_nan_bounds(cuda, N):
    """A NaN in a lane's bounds makes it unsolvable in both versions (no
    sweep, warm start passed through), and the other lanes are untouched;
    N = 8 on the streamed route."""
    from gym_anm_torch.vec import make_anm6easy_task, mpc

    B = 12
    dc, l, u = _dcopf_lanes(make_anm6easy_task(), N, B, 4, cuda, 400)
    l, u = l.clone(), u.clone()
    l[2, 0] = float("nan")
    u[7, dc.m - 1] = float("nan")
    sk, sp = _admm_agree(dc, l, u, mpc.init_warm(dc, B))
    assert not bool(sk.bounds_ok[2]) and not bool(sk.bounds_ok[7]) and int(sk.bounds_ok.sum()) == B - 2
    assert torch.equal(torch.isinf(sk.r_prim), torch.isinf(sp.r_prim))


@pytest.mark.parametrize("name,N", [("anm6easy", 1), ("anm6easy", 2), ("anm6easy", 8), ("anm6easy", 16),
                                    ("ieee33_renewable", 1)])
def test_admm_stream_plan_and_counter_on_the_card(cuda, name, N):
    """K5's plan on this card equals ``admm_cuda.stream_lanes``' mirror of it
    at batches from 1 to past a wave of resident slots; a launch counts its
    route, and the tracer's ``admm.streamed_lanes`` reads the lanes of the
    launches that streamed (all of them above N = 1, none at N = 1)."""
    from gym_anm_torch._build import load_library
    from gym_anm_torch.utils import profiling
    from gym_anm_torch.vec import make_anm6easy_task, make_ieee33_renewable_task, mpc
    from gym_anm_torch.vec.admm_cuda import solve_dcopf_cuda, stream_lanes

    lib = load_library()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    task = {"anm6easy": make_anm6easy_task, "ieee33_renewable": make_ieee33_renewable_task}[name]()
    B = 40
    dc, l, u = _dcopf_lanes(task, N, B, 5, cuda, 48)
    for b in (1, 15, 16, 129, 2113, 8192, 16384, 50000):
        assert lib.admm_stream_lanes(b, dc.n, dc.m) == stream_lanes(b, dc.n, dc.m, sms, lib.gj_smem_limit_bytes())
    streamed = lib.admm_stream_lanes(B, dc.n, dc.m) > 0
    assert streamed == (N > 2 or name != "anm6easy")  # ANM6Easy's fragments fit in shared memory to N = 2
    before = dict(solve_dcopf_cuda.launches)
    with profiling.recording():
        for _ in range(2):
            sol = mpc.solve_dcopf(dc, l, u)
    c = profiling.report()["counters"]
    route = "streamed" if streamed else "staged"
    assert solve_dcopf_cuda.launches[route] == before[route] + 2
    assert c["admm.lanes"] == 2 * B and c["admm.streamed_lanes"] == (2 * B if streamed else 0)
    assert c["admm.sweeps"] == 2 * int(sol.iterations.sum())


# ----------------------------------------------------------------------
# The learners on the card
# ----------------------------------------------------------------------

def _rel(a, b):
    scale = float(b.abs().max())
    return float((a.cpu() - b.cpu()).abs().max()) / (scale if scale > 0 else 1.0)


def test_ppo_update_on_the_card_matches_cpu_f64_without_syncing(cuda):
    """One PPO update (GAE, losses, backward, Adam) on the card from a
    trajectory rolled out there, cast to float64, against the same update
    on the CPU with the same permutations: parameters and metrics within
    1e-10; the update on the card synchronizes nothing with the host."""
    from gym_anm_torch.parallel import ppo
    from gym_anm_torch.utils import forbid_host_syncs

    cfg = ppo.PPOConfig(hidden=32, rollout_len=8, n_epochs=2, n_minibatches=2, n_lane_minibatches=2)
    env_g = VecEnv(make_ieee33_task(), dtype=torch.float32, device=cuda)
    env_c = VecEnv(make_ieee33_task(), dtype=torch.float64, device="cpu")
    ts = ppo.init_train_state(0, env_g.n_state, env_g.n_action, cfg, device=cuda)
    step_g, step_c = ppo.make_train_step(env_g, cfg), ppo.make_train_step(env_c, cfg)
    state, obs = env_g.reset(256)
    _, _, traj = step_g.collect(ts, state, obs)
    traj = tuple(x.double() for x in traj)
    ts = ts.to(dtype=torch.float64)
    perms = step_g.permutations(ts.step)
    ts_c, m_c = step_c.update(ts.to("cpu"), tuple(x.cpu() for x in traj), perms)
    torch.cuda.synchronize()
    with forbid_host_syncs():
        ts_g, m_g = step_g.update(ts, traj, perms)
    for (name, p), q in zip(ts_g.params.named_parameters(), ts_c.params.parameters()):
        assert _rel(p.detach(), q.detach()) <= 1e-10, name
    for k in m_c:
        assert _rel(m_g[k], m_c[k]) <= 1e-10, k


def test_cql_update_on_the_card_matches_cpu_f64_without_syncing(cuda):
    """One CQL update at float64 on the card against the CPU from the same
    state, minibatch and draws: networks, targets and metrics within 1e-10;
    no host sync on the card."""
    from gym_anm_torch.parallel import cql
    from gym_anm_torch.utils import forbid_host_syncs

    cfg = cql.CQLConfig(hidden=64, cql_weight=2.0)
    rng = np.random.default_rng(0)
    batch = {"obs": rng.normal(size=(512, 12)), "actions": rng.uniform(-1, 1, (512, 4)),
             "rewards": rng.normal(size=512), "next_obs": rng.normal(size=(512, 12)),
             "dones": (rng.random(512) < 0.2).astype(np.float64)}
    batch_c = {k: torch.as_tensor(v) for k, v in batch.items()}
    lo, hi = -torch.ones(4, dtype=torch.float64), torch.ones(4, dtype=torch.float64)
    state_c = cql.init_cql_state(0, 12, 4, cfg, dtype=torch.float64, device="cpu")
    state_g = state_c.to(cuda)
    upd_c, upd_g = cql.make_cql_update(cfg, lo, hi), cql.make_cql_update(cfg, lo.to(cuda), hi.to(cuda))
    noise = upd_c.draw(torch.Generator().manual_seed(1), 512, torch.float64)
    noise_g, batch_g = ({k: v.to(cuda) for k, v in d.items()} for d in (noise, batch_c))
    new_c, m_c = upd_c(state_c, None, batch_c, noise)
    torch.cuda.synchronize()
    with forbid_host_syncs():
        new_g, m_g = upd_g(state_g, None, batch_g, noise_g)
    for (name, p), q in zip(new_g.train.params.named_parameters(), new_c.train.params.parameters()):
        assert _rel(p.detach(), q.detach()) <= 1e-10, name
    for p, q in zip(new_g.target_q.parameters(), new_c.target_q.parameters()):
        assert _rel(p.detach(), q.detach()) <= 1e-10
    for k in m_c:
        assert _rel(m_g[k], m_c[k]) <= 1e-10, k


def test_nccl_world_size_one_equals_no_process_group(cuda):
    """Two PPO train steps without a process group and under nccl at world
    size 1 (broadcast and all-reduce as identities): bitwise equal
    parameters."""
    import socket

    import torch.distributed as dist

    from gym_anm_torch.parallel import init_distributed, ppo

    cfg = ppo.PPOConfig(hidden=32, rollout_len=4, n_epochs=2, n_minibatches=2, n_lane_minibatches=2)
    env = VecEnv(make_ieee33_task(), dtype=torch.float32, device=cuda)

    def run():
        ts = ppo.init_train_state(0, env.n_state, env.n_action, cfg, device=cuda)
        step = ppo.make_train_step(env, cfg)
        state, obs = env.reset(128)
        for _ in range(2):
            ts, state, obs, _ = step(ts, state, obs)
        return [p.detach().clone() for p in ts.params.parameters()]

    alone = run()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert init_distributed(0, 1, port) == "nccl"
    try:
        grouped = run()
    finally:
        dist.destroy_process_group()
    assert all(torch.equal(a, b) for a, b in zip(alone, grouped))


def test_cql_graph_replays_equal_eager_updates(cuda, monkeypatch):
    """``train_cql`` on the card replays one CUDA graph of an update after its
    eager warm-up; twelve updates give bitwise the networks, targets and
    metrics of twelve eager ones (the draws and the bias corrections fed as
    the eager updates take them)."""
    from gym_anm_torch.parallel import cql

    rng = np.random.default_rng(0)
    data = {"states": rng.normal(size=(4096, 12)), "actions": rng.uniform(-1, 1, (4096, 4)),
            "rewards": rng.normal(size=4096), "next_states": rng.normal(size=(4096, 12)),
            "dones": (rng.random(4096) < 0.2).astype(np.float32)}
    lo, hi = -np.ones(4, np.float32), np.ones(4, np.float32)
    cfg = cql.CQLConfig(hidden=64, cql_weight=2.0)
    graphed, m_graph, _ = cql.train_cql(0, data, lo, hi, cfg, steps=12, batch_size=256, device=cuda,
                                        forbid_syncs=True)
    monkeypatch.setattr(cql, "GRAPH_WARMUP", 100)
    eager, m_eager, _ = cql.train_cql(0, data, lo, hi, cfg, steps=12, batch_size=256, device=cuda)
    assert graphed.train.step == eager.train.step == 12
    for a, b in zip(list(graphed.train.params.parameters()) + list(graphed.target_q.parameters()),
                    list(eager.train.params.parameters()) + list(eager.target_q.parameters())):
        assert torch.equal(a, b)
    for k in m_eager:
        assert torch.equal(m_graph[k], m_eager[k]), k


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cql_graph_under_nccl_world_size_one_equals_no_process_group(cuda):
    """``train_cql`` captures its all-reduce in the CUDA graph under a
    process group: under nccl at world size 1, eight updates (five of them
    replays) give bitwise the networks and metrics of eight without one."""
    import torch.distributed as dist

    from gym_anm_torch.parallel import cql, init_distributed

    rng = np.random.default_rng(1)
    data = {"states": rng.normal(size=(2048, 12)), "actions": rng.uniform(-1, 1, (2048, 4)),
            "rewards": rng.normal(size=2048), "next_states": rng.normal(size=(2048, 12)),
            "dones": (rng.random(2048) < 0.2).astype(np.float32)}
    lo, hi = -np.ones(4, np.float32), np.ones(4, np.float32)

    def run():
        state, m, _ = cql.train_cql(0, data, lo, hi, cql.CQLConfig(hidden=64), steps=8, batch_size=256,
                                    device=cuda, forbid_syncs=True)
        return [p.detach().clone() for p in state.train.params.parameters()], {k: v.clone() for k, v in m.items()}

    alone, m_alone = run()
    assert init_distributed(0, 1, _free_port()) == "nccl"
    try:
        grouped, m_grouped = run()
    finally:
        dist.destroy_process_group()
    assert all(torch.equal(a, b) for a, b in zip(alone, grouped))
    assert all(torch.equal(m_alone[k], m_grouped[k]) for k in m_alone)


def test_multihost_worker_on_two_cards(cuda, tmp_path):
    """``python -m gym_anm_torch.scripts.multihost_smoke`` as two ranks on
    two cards over nccl (PPO with a lane chunk across the ranks, graphed
    ``train_cql``, the MPC farm) against the same functions on one card
    without a process group, at the tolerances of
    ``tests/test_torch_distributed.py``; the ranks' metrics identical."""
    import subprocess
    import sys
    from pathlib import Path

    from gym_anm_torch._build import load_library
    from gym_anm_torch.scripts import multihost_smoke as worker

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    load_library()  # built once, before the ranks start
    one = {"ppo": worker.run_ppo(cuda), "cql": worker.run_cql(cuda), "mpc": worker.run_mpc(cuda)}
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-m", "gym_anm_torch.scripts.multihost_smoke", str(r), "2", port,
                               "--out", str(tmp_path / f"rank{r}.pt")], cwd=Path(__file__).resolve().parents[1],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"
    r0, r1 = (torch.load(tmp_path / f"rank{r}.pt") for r in range(2))
    for learner in ("ppo", "cql"):
        assert r0[learner]["metrics"] == r1[learner]["metrics"]
        for n, p in one[learner]["params"].items():
            assert torch.equal(r0[learner]["params"][n], r1[learner]["params"][n]), n
            np.testing.assert_allclose(r0[learner]["params"][n].numpy(), p.numpy(), rtol=1e-3, atol=2e-5)
        for k, v in one[learner]["metrics"].items():
            np.testing.assert_allclose(r0[learner]["metrics"][k], v, rtol=2e-4, atol=1e-6, err_msg=k)
    acts = torch.cat([r0["mpc"]["acts"], r1["mpc"]["acts"]], dim=1)
    rewards = torch.cat([r0["mpc"]["rewards"], r1["mpc"]["rewards"]], dim=1)
    np.testing.assert_allclose(acts.numpy(), one["mpc"]["acts"].numpy(), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(rewards.numpy(), one["mpc"]["rewards"].numpy(), rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("net,delta_t", [(anm6_network, 0.25), (ieee33_network, 1.0)])
def test_simulator_on_card_equals_cpu(cuda, net, delta_t):
    """The compat ``Simulator`` (float64, one lane; no gymnasium) on the card
    against the CPU over 16 steps of random loads and uniform set-points:
    equal ``pfe_converged`` flags, the state dict, reward, e_loss and
    penalty within 1e-8, and its Newton loop launched as K3 (nr_solve's
    dense Y), whose K1 sweeps run inside it."""
    from gym_anm_torch.physics.newton_cuda import newton_fallback_cuda

    from gym_anm_torch.env import Simulator

    card, cpu = Simulator(net, delta_t, 100), Simulator(net, delta_t, 100, device="cpu")
    spec = cpu.spec
    rng = np.random.default_rng(3)
    bounds = cpu.get_action_space()
    flat = {}
    for b in bounds:
        flat.update(b)
    loads = [int(spec.dev_ids[p]) for p in spec.load_pos]
    gens = [int(spec.dev_ids[p]) for p in spec.gen_nonslack_pos]
    oltcs = [int(spec.dev_ids[p]) for p in spec.oltc_pos]
    s0 = np.zeros(2 * spec.n_dev + spec.n_des + spec.n_gen)
    assert card.reset(s0) == cpu.reset(s0)
    dense0, n0 = newton_fallback_cuda.launches["dense"], newton_fallback_cuda.launch_count
    for t in range(16):
        P_load = {i: spec.p_min[spec.dev_ids.tolist().index(i)] * spec.baseMVA * rng.uniform(0.3, 1.0)
                  for i in loads}
        P_pot = {i: rng.uniform(*flat[i]) for i in gens}
        P_set = {i: rng.uniform(*bounds[0][i]) for i in bounds[0]} | {i: rng.uniform(*bounds[2][i]) for i in bounds[2]}
        Q_set = {i: rng.uniform(*bounds[1][i]) for i in bounds[1]} | {i: rng.uniform(*bounds[3][i]) for i in bounds[3]}
        if len(bounds) > 4:
            Q_set |= {i: rng.uniform(*bounds[4][i]) for i in bounds[4]}
        taps = {i: rng.uniform(*bounds[5][i]) for i in oltcs} if len(bounds) > 5 else None
        sa, ra, ea, pa, ca = card.transition(P_load, P_pot, P_set, Q_set, taps)
        sb, rb, eb, pb, cb = cpu.transition(P_load, P_pot, P_set, Q_set, taps)
        assert ca == cb, f"step {t}: pfe_converged differs"
        if not ca:
            continue
        for x, y in ((ra, rb), (ea, eb), (pa, pb)):
            assert abs(x - y) <= 1e-8
        for key in sa:
            if key.endswith("_i_ang"):  # compared through the complex currents
                continue
            for unit in sa[key]:
                for i, v in sa[key][unit].items():
                    assert abs(v - sb[key][unit][i]) <= 1e-8, (t, key, unit, i)
        for bus_a, bus_b in zip(card.buses.values(), cpu.buses.values()):
            assert abs(bus_a.v - bus_b.v) <= 1e-8 and abs(bus_a.i - bus_b.i) <= 1e-8
    assert newton_fallback_cuda.launch_count > n0
    assert newton_fallback_cuda.launches["dense"] - dense0 == newton_fallback_cuda.launch_count - n0


# ---------------------------------------------------------------------------
# K3: the exact-Newton fallback
# ---------------------------------------------------------------------------
def _k3_lanes(net, dtype, B, seed, cuda):
    """Lanes of ``net`` with random taps (IEEE33's OLTC in [0.9, 1.1]),
    loads p in [-0.02, -0.01] p.u. on IEEE33 (a quarter on ANM6), q = p / 2,
    and the four bad-basin warm starts tiled: (tables, LaneYbus, p, q, x0)."""
    from gym_anm_torch.physics.ybus import LaneYbus

    spec, delta_t = {"ieee33": (ieee33_network, 1.0), "anm6": (anm6_network, 0.25)}[net]
    tb = make_tables(load_network(spec), delta_t, 100, dtype=dtype, device=cuda)
    n = tb.n_bus - 1
    g = torch.Generator(device=cuda).manual_seed(seed)
    tap = tb.tap0.expand(B, -1).clone()
    if len(tb.oltc_branch):
        tap[:, tb.oltc_branch] = 0.9 + 0.2 * torch.rand(B, 1, generator=g, device=cuda, dtype=dtype)
    p = -(0.01 if n > 8 else 0.0025) * (1.0 + torch.rand(B, n, generator=g, device=cuda, dtype=dtype))
    pats = torch.stack([
        torch.cat([torch.zeros(n), torch.full((n,), 1e-6)]),
        torch.cat([torch.zeros(n), torch.full((n,), -1.0)]),
        torch.cat([torch.full((n,), 30.0), torch.ones(n)]),
        torch.cat([torch.zeros(n), torch.ones(n) * 1e15]),
    ]).to(cuda, dtype)
    ybus = LaneYbus(tb.n_bus, tb.br_f, tb.br_t, tb.series_re, tb.series_im, tb.shunt_im, tb.shift_cos,
                    tb.shift_sin, tap)
    return tb, ybus, p, 0.5 * p, pats.repeat(B // 4 + 1, 1)[:B].contiguous()


def _k3_chord_init(tb, ybus, p, q, x0):
    """The chord's exit: K2 in float32, the plain chord in float64 (the
    card's chord is the float32 tier's)."""
    B = p.shape[0]
    if tb.chord_has_oltc:
        a = ybus.tap_magn[:, int(tb.oltc_branch[0])]
        inv_da = 1.0 / a - 1.0 / tb.chord_a0
        dr, di = -tb.chord_y_re * inv_da, -tb.chord_y_im * inv_da
    else:
        dr = di = torch.zeros(B, device=p.device, dtype=p.dtype)
    chord = pf.chord_solve if p.dtype == torch.float32 else pf.chord_solve_plain
    return chord(p, q, di, dr, dr, di, tb.chord_t, x0=x0)


def _k3_against_plain(args, ybus, plain_ybus, tol):
    """K3 and its plain version (``_newton_loop`` with the plain solve) on
    the same card inputs: flags equal on every lane, n_iter on >= 99.5%, x
    within ``tol`` where both are stable."""
    from gym_anm_torch.physics.newton_cuda import newton_fallback_cuda

    x, F, diff, it, acc, p, q = args
    B = x.shape[0]
    f32 = p.dtype == torch.float32
    acc0 = torch.zeros(B, dtype=torch.bool, device=x.device) if acc is None else acc
    before = newton_fallback_cuda.launch_count
    out_k = newton_fallback_cuda(x, F, diff, it, acc, p, q, ybus)
    assert newton_fallback_cuda.launch_count == before + 1
    out_p = pf._newton_loop(x, F, diff, it, ~acc0, plain_ybus, p, q, 1e-5, 100, f32, solve_gauss_jordan)
    rk, rp = pf._nr_result(*out_k, acc0, 1e-5, f32), pf._nr_result(*out_p, acc0, 1e-5, f32)
    assert torch.equal(rk.stable, rp.stable) and torch.equal(rk.converged, rp.converged)
    assert int((out_k[3] == out_p[3]).sum()) >= 0.995 * B
    both = rk.stable & rp.stable
    if bool(both.any()):
        assert float((out_k[0] - out_p[0])[both].abs().max()) <= tol
    return out_k, out_p


@pytest.mark.parametrize("net", ["ieee33", "anm6"])
@pytest.mark.parametrize("B", [1, 7, 1001])
def test_newton_kernel_matches_plain_version_after_the_chord(cuda, net, B):
    """Sets (a) and (b): float32 lanes after the chord from bad-basin starts
    (none accepted), Y from the LaneYbus."""
    tb, ybus, p, q, x0 = _k3_lanes(net, torch.float32, B, 3, cuda)
    init = _k3_chord_init(tb, ybus, p, q, x0)
    _k3_against_plain(tuple(init) + (p, q), ybus, ybus, 1e-5)


@pytest.mark.parametrize("net", ["ieee33", "anm6"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-5)])
@pytest.mark.parametrize("B,broadcast", [(1, False), (1001, False), (33, True)])
def test_newton_kernel_matches_plain_version_from_the_flat_start(cuda, net, dtype, tol, B, broadcast):
    """Set (c): nr_solve's route, a dense Y [B, N, N] or one [N, N]."""
    tb, ybus, p, q, _ = _k3_lanes(net, dtype, B, 4, cuda)
    Yre, Yim = ybus(slice(None))
    Y = (Yre[0], Yim[0]) if broadcast else (Yre, Yim)
    x = torch.cat([torch.zeros_like(p), torch.ones_like(p)], dim=1)
    F, _ = pf._mismatch(x, p, q, *Y, p.shape[1])
    start = (x, F, torch.amax(F.abs(), dim=1), torch.zeros(B, dtype=torch.int32, device=cuda), None, p, q)
    oracle = (lambda idx: Y) if broadcast else (lambda idx: (Yre[idx], Yim[idx]))
    _k3_against_plain(start, Y, oracle, tol)
    r = pf.nr_solve(*Y, p, q)
    assert bool(r.stable.all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_newton_kernel_leaves_accepted_lanes_as_they_came(cuda, dtype):
    """Set (d): every lane accepted by the chord: outputs equal inputs."""
    tb, ybus, p, q, _ = _k3_lanes("ieee33", dtype, 513, 5, cuda)
    init = _k3_chord_init(tb, ybus, p, q, None)
    assert bool(init[4].all())
    x, F, diff, it, stall = _k3_against_plain(tuple(init) + (p, q), ybus, ybus, 0.0)[0]
    assert torch.equal(x, init[0]) and torch.equal(F, init[1]) and torch.equal(diff, init[2])
    assert torch.equal(it, init[3]) and not bool(stall.any())


def test_newton_kernel_keeps_a_zero_pivot_non_finite(cuda):
    """Set (e): a ragged batch, lane 1's Y zero (so its Jacobian): non-finite
    in both versions, converged false."""
    tb, ybus, p, q, _ = _k3_lanes("ieee33", torch.float32, 1001, 6, cuda)
    Yre, Yim = ybus(slice(None))
    Yre[1], Yim[1] = 0.0, 0.0
    x = torch.cat([torch.zeros_like(p), torch.ones_like(p)], dim=1)
    F, _ = pf._mismatch(x, p, q, Yre, Yim, p.shape[1])
    start = (x, F, torch.amax(F.abs(), dim=1), torch.zeros(1001, dtype=torch.int32, device=cuda), None, p, q)
    out_k, out_p = _k3_against_plain(start, (Yre, Yim), lambda idx: (Yre[idx], Yim[idx]), 1e-5)
    assert not bool(torch.isfinite(out_k[0][1]).all()) and not bool(torch.isfinite(out_p[0][1]).all())


def test_newton_kernel_rejects_what_it_does_not_take(cuda):
    from gym_anm_torch.physics.newton_cuda import newton_fallback_cuda

    tb, ybus, p, q, x0 = _k3_lanes("anm6", torch.float32, 8, 7, cuda)
    init = tuple(_k3_chord_init(tb, ybus, p, q, x0))
    good = init + (p, q)
    Y = ybus(slice(None))
    newton_fallback_cuda(*good, ybus)
    newton_fallback_cuda(*good, Y)
    bad_calls = [
        init + (p.cpu(), q.cpu()),                                   # a CPU tensor
        (init[0].half(),) + init[1:] + (p, q),                        # another type
        (init[0], init[1]) + (init[2], init[3].long(), init[4], p, q),  # n_iter not int32
        init + (p.t().contiguous().t(), q),                           # not contiguous
        init + (p[:, :4].contiguous(), q[:, :4].contiguous()),        # shapes
        tuple(t[:0] for t in init) + (p[:0], q[:0]),                  # an empty batch
    ]
    for args in bad_calls:
        with pytest.raises(ValueError):
            newton_fallback_cuda(*args, ybus if args[5].shape[0] == 8 else Y)
    with pytest.raises(ValueError):
        newton_fallback_cuda(*good, ybus._replace(tap_magn=ybus.tap_magn.double()))
    with pytest.raises(ValueError):
        newton_fallback_cuda(*good, (Y[0][:, :5, :5], Y[1][:, :5, :5]))
    from gym_anm_torch.physics.newton_cuda import MAX_N

    n = MAX_N // 2 + 1  # above K3 wide's largest network (4096 buses)
    x = torch.cat([torch.zeros(8, n, device=cuda), torch.ones(8, n, device=cuda)], dim=1)
    Yw = (torch.zeros(n + 1, n + 1, device=cuda),) * 2
    with pytest.raises(ValueError, match=f"n <= {MAX_N}"):
        newton_fallback_cuda(x, x, torch.ones(8, device=cuda), torch.zeros(8, dtype=torch.int32, device=cuda), None,
                             torch.zeros(8, n, device=cuda), torch.zeros(8, n, device=cuda), Yw)


def test_nr_solve_lazy_on_the_card_takes_a_lane_ybus(cuda):
    """No silent host loop hides the kernel: a bare callable is refused."""
    tb, ybus, p, q, x0 = _k3_lanes("ieee33", torch.float32, 8, 8, cuda)
    init = _k3_chord_init(tb, ybus, p, q, x0)
    with pytest.raises(TypeError, match="LaneYbus"):
        pf.nr_solve_lazy(lambda idx: ybus(idx), p, q, init=init)


def test_newton_above_64_unknowns_takes_the_wide_route(cuda, monkeypatch):
    """n > 64 (a 48-bus feeder, n = 94): one launch of K3 wide (its route
    counted), no standalone K1 launch, the plain loop nowhere."""
    from gym_anm_torch.networks.random_feeder import random_radial_network
    from gym_anm_torch.physics.newton_cuda import newton_fallback_cuda

    net = random_radial_network(np.random.default_rng(48), 48)
    tb = make_tables(load_network(net), 1.0, 100, dtype=torch.float64, device=cuda)
    n, B = tb.n_bus - 1, 4
    Yre, Yim = (t.expand(B, -1, -1).contiguous() for t in (tb.chord_t.Y0re, tb.chord_t.Y0im))
    p = torch.full((B, n), -0.002, dtype=torch.float64, device=cuda)
    k3, routes, k1 = (newton_fallback_cuda.launch_count, dict(newton_fallback_cuda.launches_by_route),
                      solve_gauss_jordan_cuda.launch_count)
    monkeypatch.setattr(pf, "_newton_loop", None)  # the card never reaches the plain loop
    r = pf.nr_solve(Yre, Yim, p, 0.5 * p)
    assert bool(r.stable.all())
    assert newton_fallback_cuda.launch_count == k3 + 1 and solve_gauss_jordan_cuda.launch_count == k1
    assert newton_fallback_cuda.launches_by_route["smem"] == routes["smem"] + 1  # float64 n = 94: resident


@pytest.mark.parametrize("task", ["ieee33", "anm6easy", "feeder48", "feeder130"])
def test_vec_env_steps_on_the_card_without_a_host_sync(cuda, task):
    """16 steps of VecEnv.step at B = 8192 under set_sync_debug_mode("error"):
    the chord (K2) and the Newton loop (K3, or K3 wide on the random feeders
    of 48 and 130 buses; one launch a step) read no flag on the host and K1
    never launches on its own; the 9th step starts from bad-basin warm
    starts, so the kernel runs Newton iterations.  The flows run on K6, one
    launch a step."""
    from gym_anm_torch.networks.random_feeder import feeder_vars, make_feeder_task, random_radial_network
    from gym_anm_torch.physics.flows_cuda import transition_flows_cuda
    from gym_anm_torch.physics.newton_cuda import newton_fallback_cuda
    from gym_anm_torch.vec import make_anm6easy_task

    if task.startswith("feeder"):
        n_bus = int(task[6:])
        rng = np.random.default_rng(n_bus)
        net = random_radial_network(rng, n_bus)
        task_obj = make_feeder_task(net, feeder_vars(net, {48: 0.6, 130: 0.15}[n_bus], 8, rng), name=task)
    else:
        task_obj = make_ieee33_task() if task == "ieee33" else make_anm6easy_task()
    env = VecEnv(task_obj, dtype=torch.float32, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(16)
    B = 8192
    state, obs = env.reset(B, g)
    n = env.spec.n_bus - 1
    bad = torch.cat([torch.full((B, n), 30.0, device=cuda), torch.ones(B, n, device=cuda)], dim=1)
    policy = env.random_policy()
    before, k1 = newton_fallback_cuda.launch_count, solve_gauss_jordan_cuda.launch_count
    k6 = transition_flows_cuda.launch_count
    actions = [policy(g, obs, k) for k in range(16)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for k, a in enumerate(actions):
            if k == 8:
                state = state._replace(v_guess=bad)
            state, obs, r, d, info = env.step(state, a, g)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert newton_fallback_cuda.launch_count == before + 16 and solve_gauss_jordan_cuda.launch_count == k1
    assert transition_flows_cuda.launch_count == k6 + 16
    assert bool(torch.isfinite(obs).all())


def _k3_bitwise(args, ybus, plain_ybus):
    """K3 and its plain version on the same card inputs, equal bit for bit
    on every lane: x, F, diff (NaN where both are NaN), n_iter and stall."""
    from gym_anm_torch.physics.newton_cuda import newton_fallback_cuda

    x, F, diff, it, acc, p, q = args
    B = x.shape[0]
    acc0 = torch.zeros(B, dtype=torch.bool, device=x.device) if acc is None else acc
    out_k = newton_fallback_cuda(x, F, diff, it, acc, p, q, ybus)
    out_p = pf._newton_loop(x, F, diff, it, ~acc0, plain_ybus, p, q, 1e-5, 100, p.dtype == torch.float32,
                            solve_gauss_jordan)
    for a, b in zip(out_k, out_p):
        same = (a == b) | (torch.isnan(a) & torch.isnan(b)) if a.is_floating_point() else a == b
        n_off = int((~same.reshape(B, -1).all(1)).sum())
        assert n_off == 0, f"K3 differs from its plain version on {n_off} lanes"
    return out_k


@pytest.mark.parametrize("net", ["ieee33", "anm6"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ysrc", ["lane", "dense"])
@pytest.mark.parametrize("start", [0, 2])
def test_newton_kernel_is_bitwise_at_one_lane(cuda, net, dtype, ysrc, start):
    """B = 1 (the compat Simulator's call) at n = 64 and 10, both types, the
    lane Y-bus and the dense Y, from the chord's exit after two bad-basin
    guesses (vm ~ 0, wild angles): bitwise the plain version."""
    tb, ybus, p, q, x0 = _k3_lanes(net, dtype, 3, 9, cuda)
    sl = slice(start, start + 1)
    ybus = ybus._replace(tap_magn=ybus.tap_magn[sl].contiguous())
    p, q = p[sl].contiguous(), q[sl].contiguous()
    init = tuple(t.contiguous() for t in _k3_chord_init(tb, ybus, p, q, x0[sl].contiguous()))
    Y = ybus(slice(None))
    _k3_bitwise(init + (p, q), ybus if ysrc == "lane" else Y, ybus if ysrc == "lane" else (lambda idx: Y))


@pytest.mark.parametrize("n_bad", [1, 8])
def test_newton_kernel_tail(cuda, n_bad):
    """The tail: B = 8192 IEEE33 float32 lanes, all accepted by the chord
    from the flat start but ``n_bad`` from the bad basin: the triage passes
    the accepted lanes through and the worklist's lanes come out bitwise the
    plain version's."""
    B = 8192
    tb, ybus, p, q, x0 = _k3_lanes("ieee33", torch.float32, B, 10, cuda)
    good = _k3_chord_init(tb, ybus, p, q, None)
    bad = _k3_chord_init(tb, ybus, p, q, x0)
    assert bool(good[4].all())
    pick = torch.zeros(B, dtype=torch.bool, device=cuda)
    pick[torch.arange(n_bad, device=cuda) * 997 + 3] = True
    init = tuple(torch.where(pick.view(-1, *[1] * (a.dim() - 1)), b, a).contiguous() for a, b in zip(good, bad))
    out = _k3_bitwise(init + (p, q), ybus, ybus)
    assert int((out[3] != init[3]).sum()) == int((pick & ~init[4]).sum()) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("per_sm", [1, 2])
@pytest.mark.parametrize("extra", [0, 1])
def test_newton_kernel_around_the_width_threshold(cuda, dtype, per_sm, extra):
    """B = 8192 IEEE33 lanes of which exactly ``per_sm`` x SMs + ``extra``
    iterate (from the bad basin, the rest accepted): the 64-row body takes
    4 threads a row where the lanes that iterate fit the grid's groups of
    that width at once (1 an SM in float64, 2 in float32), else 2, so these
    counts sit on each side of the threshold at both types: bitwise the
    plain version."""
    B = 8192
    go = per_sm * torch.cuda.get_device_properties(cuda).multi_processor_count + extra
    tb, ybus, p, q, x0 = _k3_lanes("ieee33", dtype, B, 11, cuda)
    good = _k3_chord_init(tb, ybus, p, q, None)
    bad = _k3_chord_init(tb, ybus, p, q, x0)
    assert bool(good[4].all())
    iterates = ~bad[4] & (bad[2] > 1e-5) & (bad[3] < 100)
    pick = iterates & (torch.cumsum(iterates.int(), 0) <= go)
    assert int(pick.sum()) == go
    init = tuple(torch.where(pick.view(-1, *[1] * (a.dim() - 1)), b, a).contiguous() for a, b in zip(good, bad))
    out = _k3_bitwise(init + (p, q), ybus, ybus)
    assert int((out[3] != init[3]).sum()) == go


@pytest.mark.parametrize("n", list(range(2, 33, 2)) + [40, 58])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_newton_kernel_every_body(cuda, n, dtype):
    """Every body the dispatch instantiates (n = 2..32 at their own size,
    one n in each of the 48- and 64-row bodies) on a random feeder of the
    JAX property test's generator, from the flat start (dense Y), from the
    chord's exit after bad-basin guesses (lane Y) and with one lane left to
    iterate: bitwise the plain version.  The 48- and 64-row bodies take
    B = 1001 lanes, more than the card holds at once at 4 threads a row, so
    the first two run at 2 threads a row and the third at 4."""
    from gym_anm_torch.networks.random_feeder import random_radial_network
    from gym_anm_torch.physics.ybus import LaneYbus

    net = random_radial_network(np.random.default_rng(100 + n), n // 2 + 1)
    tb = make_tables(load_network(net), 1.0, 100, dtype=dtype, device=cuda)
    nb, B = tb.n_bus - 1, 37 if n <= 32 else 1001
    assert 2 * nb == n
    g = torch.Generator(device=cuda).manual_seed(n)
    p = -0.02 * (1.0 + torch.rand(B, nb, generator=g, device=cuda, dtype=dtype))
    q = 0.5 * p
    tap = tb.tap0.expand(B, -1).clone()
    if len(tb.oltc_branch):
        tap[:, tb.oltc_branch] = 0.95 + 0.1 * torch.rand(B, 1, generator=g, device=cuda, dtype=dtype)
    ybus = LaneYbus(tb.n_bus, tb.br_f, tb.br_t, tb.series_re, tb.series_im, tb.shunt_im, tb.shift_cos,
                    tb.shift_sin, tap)
    Yre, Yim = ybus(slice(None))
    x = torch.cat([torch.zeros_like(p), torch.ones_like(p)], dim=1)
    F, _ = pf._mismatch(x, p, q, Yre, Yim, nb)
    flat = (x, F, torch.amax(F.abs(), dim=1), torch.zeros(B, dtype=torch.int32, device=cuda), None, p, q)
    x0 = torch.cat([torch.full((B, nb), 0.5, device=cuda, dtype=dtype), torch.full((B, nb), 0.3, device=cuda,
                                                                                    dtype=dtype)], dim=1)
    x0[::2, nb:] = 1.0
    F0, _ = pf._mismatch(x0, p, q, Yre, Yim, nb)
    bad = (x0, F0, torch.amax(F0.abs(), dim=1), torch.ones(B, dtype=torch.int32, device=cuda),
           torch.arange(B, device=cuda) % 5 == 0, p, q)
    _k3_bitwise(flat, (Yre, Yim), lambda idx: (Yre[idx], Yim[idx]))
    _k3_bitwise(bad, ybus, ybus)
    one = torch.arange(B, device=cuda) != 7
    _k3_bitwise(bad[:4] + (one,) + bad[5:], ybus, ybus)


@pytest.mark.parametrize("n_bus", [48, 64, 130, 194])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_newton_wide_kernel_is_bitwise_its_plain_version(cuda, n_bus, dtype):
    """K3 wide at n = 94, 126, 258 and 386 (the random feeders of 48, 64,
    130 and 194 buses; on an H100 float32 resident at 48 and 64 buses and
    float64 at 48; float64 at 64 buses a block a lane in device memory at B
    = 257 and on clusters at 33 (``batch_route``); float64 at 194 buses in
    device memory (above a cluster of 8); the rest on clusters), bitwise the
    plain loop with the plain solve on every lane, each launch on the route
    ``wide_launch`` gives: after the chord from bad-basin guesses with the
    LaneYbus (B = 257, more lanes than a small grid holds), from the flat
    start with a dense Y and a zero-pivot lane (B = 33), and one bad lane
    among accepted ones."""
    from gym_anm_torch.networks.random_feeder import random_radial_network
    from gym_anm_torch.physics.newton_cuda import newton_fallback_cuda, wide_launch
    from gym_anm_torch.physics.ybus import LaneYbus
    from gym_anm_torch._build import load_library

    net = random_radial_network(np.random.default_rng(n_bus), n_bus)
    tb = make_tables(load_network(net), 1.0, 100, dtype=dtype, device=cuda)
    nb, B = tb.n_bus - 1, 257
    g = torch.Generator(device=cuda).manual_seed(n_bus)
    p = -0.004 * (1.0 + torch.rand(B, nb, generator=g, device=cuda, dtype=dtype))
    q = 0.5 * p
    tap = tb.tap0.expand(B, -1).clone()
    if len(tb.oltc_branch):
        tap[:, tb.oltc_branch] = 0.95 + 0.1 * torch.rand(B, 1, generator=g, device=cuda, dtype=dtype)
    ybus = LaneYbus(tb.n_bus, tb.br_f, tb.br_t, tb.series_re, tb.series_im, tb.shunt_im, tb.shift_cos,
                    tb.shift_sin, tap)
    routes = [wide_launch(load_library(), 2 * nb, dtype, b, y)[0] for b, y in ((B, True), (B, True), (33, False))]
    before = dict(newton_fallback_cuda.launches_by_route)
    pats = torch.stack([torch.cat([torch.zeros(nb), torch.full((nb,), v)]) for v in (1e-6, -1.0, 1e15)]
                       + [torch.cat([torch.full((nb,), 30.0), torch.ones(nb)])]).to(cuda, dtype)
    x0 = pats.repeat(B // 4 + 1, 1)[:B].contiguous()
    init = tuple(t.contiguous() for t in _k3_chord_init(tb, ybus, p, q, x0))
    _k3_bitwise(init + (p, q), ybus, ybus)
    good = tuple(t.contiguous() for t in _k3_chord_init(tb, ybus, p, q, None))
    one = torch.arange(B, device=cuda) == 5
    tail = tuple(torch.where(one.view(-1, *[1] * (a.dim() - 1)), b, a).contiguous() for a, b in zip(good, init))
    _k3_bitwise(tail + (p, q), ybus, ybus)
    Bd = 33
    Yre, Yim = ybus(slice(0, Bd))
    Yre[1], Yim[1] = 0.0, 0.0
    pd, qd = p[:Bd].contiguous(), q[:Bd].contiguous()
    x = torch.cat([torch.zeros_like(pd), torch.ones_like(pd)], dim=1)
    F, _ = pf._mismatch(x, pd, qd, Yre, Yim, nb)
    out = _k3_bitwise((x, F, torch.amax(F.abs(), dim=1), torch.zeros(Bd, dtype=torch.int32, device=cuda), None, pd,
                       qd), (Yre, Yim), lambda idx: (Yre[idx], Yim[idx]))
    assert not bool(torch.isfinite(out[0][1]).all())
    for route in set(routes):
        assert newton_fallback_cuda.launches_by_route[route] == before[route] + routes.count(route)


def _feeder_lanes64(n_bus, B, cuda):
    """Float64 lanes on the random feeder of ``n_bus`` buses, each lane's
    load scaled by 1 to 8 (the heavier ones past what the feeder carries,
    so that lanes diverge): (tables, LaneYbus with random OLTC taps, p, q,
    the bad-basin guesses tiled)."""
    from gym_anm_torch.networks.random_feeder import random_radial_network
    from gym_anm_torch.physics.ybus import LaneYbus

    net = random_radial_network(np.random.default_rng(n_bus), n_bus)
    tb = make_tables(load_network(net), 1.0, 100, dtype=torch.float64, device=cuda)
    nb = tb.n_bus - 1
    g = torch.Generator(device=cuda).manual_seed(n_bus)
    scale = 1.0 + 7.0 * torch.rand(B, 1, generator=g, device=cuda, dtype=torch.float64)
    p = -0.004 * scale * (1.0 + torch.rand(B, nb, generator=g, device=cuda, dtype=torch.float64))
    tap = tb.tap0.expand(B, -1).clone()
    if len(tb.oltc_branch):
        tap[:, tb.oltc_branch] = 0.95 + 0.1 * torch.rand(B, 1, generator=g, device=cuda, dtype=torch.float64)
    ybus = LaneYbus(tb.n_bus, tb.br_f, tb.br_t, tb.series_re, tb.series_im, tb.shunt_im, tb.shift_cos,
                    tb.shift_sin, tap)
    pats = torch.stack([torch.cat([torch.zeros(nb), torch.full((nb,), v)]) for v in (1e-6, -1.0, 1e15)]
                       + [torch.cat([torch.full((nb,), 30.0), torch.ones(nb)])]).to(cuda, torch.float64)
    return tb, ybus, p, 0.5 * p, pats.repeat(B // 4 + 1, 1)[:B].contiguous()


def _anm6easy_step_lanes64(B, cuda):
    """Float64 lanes at the injections of an ANM6Easy step (the 8th of
    uniform-random actions at B lanes, float32, taken at the Newton
    fallback's call; its collapsing lanes among them): (float64 tables,
    LaneYbus at the step's taps, p, q, the bad-basin guesses tiled)."""
    import importlib

    from gym_anm_torch.physics.ybus import LaneYbus
    from gym_anm_torch.vec import make_anm6easy_task

    tm = importlib.import_module("gym_anm_torch.physics.transition")
    env = VecEnv(make_anm6easy_task(), dtype=torch.float32, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(12)
    state, _ = env.reset(B, g)
    real, seen = tm.nr_solve_lazy, []

    def capture(ybus_fn, p, q, **kw):
        if p.shape[0] == B:
            seen.append((ybus_fn, p, q))
        return real(ybus_fn, p, q, **kw)

    monkey = pytest.MonkeyPatch()
    monkey.setattr(tm, "nr_solve_lazy", capture)
    try:
        for _ in range(8):
            u = torch.rand(B, env.n_action, generator=g, device=cuda)
            state, *_ = env.step_autoreset_batch(state, env.action_low + u * (env.action_high - env.action_low), g)
    finally:
        monkey.undo()
    y32, p, q = seen[-1]
    tb = VecEnv(make_anm6easy_task(), dtype=torch.float64, device=cuda).tables
    nb = tb.n_bus - 1
    ybus = LaneYbus(tb.n_bus, tb.br_f, tb.br_t, tb.series_re, tb.series_im, tb.shunt_im, tb.shift_cos,
                    tb.shift_sin, y32.tap_magn.double())
    pats = torch.stack([torch.cat([torch.zeros(nb), torch.full((nb,), v)]) for v in (1e-6, -1.0)]
                       + [torch.cat([torch.full((nb,), 30.0), torch.ones(nb)]),
                          torch.cat([torch.zeros(nb), torch.full((nb,), 1e15)])]).to(cuda, torch.float64)
    return tb, ybus, p.double().contiguous(), q.double().contiguous(), pats.repeat(B // 4 + 1, 1)[:B].contiguous()


@pytest.mark.parametrize("net,B", [("anm6easy", 8192), ("feeder48", 1024), ("feeder64", 512), ("feeder64", 64)])
def test_float64_tier_card_against_cpu_on_diverging_lanes(cuda, net, B):
    """ROADMAP D2: the float64 ``nr_solve_lazy`` on the card (K3 on
    ANM6Easy, K3 wide on the 48- and 64-bus feeders: resident at 48 buses,
    a block a lane in device memory at 64 buses and 512 lanes, on clusters
    at 64 lanes; Y V in ``_fold_sum``'s order) against the CPU's (BLAS's order)
    from the same chord exit of bad-basin starts, where lanes diverge: at
    most 0.1% of the lanes flip ``converged`` or ``stable``, and where both
    are stable with equal ``n_iter`` the voltages agree within 1e-10."""
    from gym_anm_torch.physics.ybus import LaneYbus

    if net == "anm6easy":
        tb, ybus, p, q, x0 = _anm6easy_step_lanes64(B, cuda)
    else:
        tb, ybus, p, q, x0 = _feeder_lanes64(int(net[6:]), B, cuda)
    init = tuple(t.contiguous() for t in _k3_chord_init(tb, ybus, p, q, x0))
    rc = pf.nr_solve_lazy(ybus, p, q, init=init)
    cpu = lambda t: t.cpu()  # noqa: E731
    yh = LaneYbus(ybus.n_bus, *(cpu(t) for t in (ybus.f, ybus.t, ybus.series_re, ybus.series_im, ybus.shunt_im,
                                                 ybus.shift_cos, ybus.shift_sin, ybus.tap_magn)))
    rh = pf.nr_solve_lazy(yh, cpu(p), cpu(q), init=tuple(cpu(t) for t in init))
    assert not bool(rh.stable.all()), "no lane diverges on this set"
    flipped = int(((cpu(rc.converged) != rh.converged) | (cpu(rc.stable) != rh.stable)).sum())
    assert flipped <= 1e-3 * B
    both = cpu(rc.stable) & rh.stable & (cpu(rc.n_iter) == rh.n_iter)
    assert bool(both.any())
    for a, b in ((rc.v_re, rh.v_re), (rc.v_im, rh.v_im)):
        assert float((cpu(a) - b)[both].abs().max()) <= 1e-10


def test_refused_cluster_launch_raises(cuda, monkeypatch):
    """A cluster launch above what the card holds (a grid one cluster past
    the capacity) is refused and the wrapper raises: no other route, no
    plain loop, no CPU stands in."""
    from gym_anm_torch._build import load_library
    from gym_anm_torch.physics import newton_cuda

    route, plans, l2_bytes = newton_cuda.wide_plans(load_library(), 126, torch.float64, True)
    panel, cluster, cap = plans["cluster"]
    assert route == "cluster"
    tb, ybus, p, q, x0 = _feeder_lanes64(64, cap + 1, cuda)
    init = tuple(t.contiguous() for t in _k3_chord_init(tb, ybus, p, q, x0))
    plans = dict(plans, cluster=(panel, cluster, cap + 1))  # cap + 1 lanes, a cluster each at once
    monkeypatch.setattr(newton_cuda, "wide_plans", lambda *a: (route, plans, l2_bytes))
    monkeypatch.setattr(pf, "_newton_loop", None)
    with pytest.raises(RuntimeError, match="launch failed .*route cluster"):
        pf.nr_solve_lazy(ybus, p, q, init=init)


def _flows_task(task):
    from gym_anm_torch.networks.random_feeder import feeder_vars, make_feeder_task, random_radial_network
    from gym_anm_torch.vec import make_anm6easy_task, make_ieee33_multicap_task

    if task == "feeder130":
        rng = np.random.default_rng(130)
        net = random_radial_network(rng, 130)
        return make_feeder_task(net, feeder_vars(net, 0.15, 8, rng), name=task)
    return {"ieee33": make_ieee33_task, "multicap17": make_ieee33_multicap_task,
            "anm6easy": make_anm6easy_task}[task]()


def _flows_inputs(cuda, task, B):
    """The arguments of ``transition_flows`` at a real step of ``task`` on the
    card (B lanes, random actions), copied; lanes 0 and 2 given a NaN voltage,
    as a diverged solve leaves them, and lane 1 an inf one."""
    from gym_anm_torch.bench import flows_probe

    tb, args = flows_probe.step_inputs(lambda: _flows_task(task), B, seed=B)
    args = list(args)
    v_re, v_im = args[0], args[1]
    for lane, col, val in ((0, 1, float("nan")), (1, 2, float("inf")), (2, -1, float("nan"))):
        if lane < B:
            (v_re if lane != 1 else v_im)[lane, col] = val
    return tb, tuple(args)


@pytest.mark.parametrize("task", ["ieee33", "multicap17", "anm6easy", "feeder130"])
@pytest.mark.parametrize("size", ["one", "ragged", "65536"])
def test_flows_kernel_matches_plain_version(cuda, task, size):
    """K6 against its plain version on the same card inputs (a real step's,
    with diverged lanes): every elementwise output (the non-slack currents,
    the nine branch arrays, the columns it leaves alone) bit for bit; the
    values that follow a reduction (the slack current, the four slack
    columns, e_loss, penalty, reward), which K6 sums in float64 in its own
    order and cuBLAS and torch.sum in theirs, within 4 float32 ulps of the
    sum of their terms' magnitudes; the diverged lanes' slack injection +inf
    in both; two launches bit for bit alike."""
    B = {"one": 1, "ragged": 1009, "65536": 65536}[size]  # 1009 is prime: no tile (<= 128 lanes) divides it
    tb, args = _flows_inputs(cuda, task, B)
    _flows_kernel_against_plain(tb, args)


def _flows_kernel_against_plain(tb, args):
    """K6 and the plain version on copies of ``args`` (``flows_probe.compare``:
    elementwise bit for bit, the values after a reduction within 4 float32
    ulps of the sum of their terms' magnitudes), the NaN lanes 0 and 2's
    slack injection +inf, and two launches bit for bit alike."""
    from gym_anm_torch.bench import flows_probe
    from gym_anm_torch.physics.flows_cuda import transition_flows_cuda
    from gym_anm_torch.physics.transition import transition_flows_plain

    ka, pa = flows_probe.copy_args(args), flows_probe.copy_args(args)
    before = transition_flows_cuda.launch_count
    k = transition_flows_cuda(tb, *ka)
    p = transition_flows_plain(tb, *pa)
    again = transition_flows_cuda(tb, *flows_probe.copy_args(args))
    torch.cuda.synchronize()
    assert transition_flows_cuda.launch_count == before + 2
    for name, a, b in zip(p._fields, k, again):
        assert bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all()), f"{name} differs between launches"
    flows_probe.compare(tb, args, k, ka, p, pa, n_ulps=4)
    for lane in (0, 2)[:args[0].shape[0]]:  # the NaN lanes
        assert float(ka[7][lane, tb.slack_bus]) == float("inf") and float(ka[9][lane, tb.slack_dev]) == float("inf")
    return p


@pytest.mark.parametrize("task", ["ieee33", "multicap17"])
def test_flows_kernel_matches_plain_version_with_per_lane_rates(cuda, task):
    """K6's per-lane rates route ([B, Ne] rates, which ``transition`` takes)
    against the plain version, as ``test_flows_kernel_matches_plain_version``
    holds the shared route: 1009 lanes, each branch's rate its shared rate
    scaled by a lane's own draw in [0.2, 1.2), so that some lanes' branches
    run over their rate and their penalty is not 0."""
    tb, args = _flows_inputs(cuda, task, 1009)
    shared = args[12]
    assert shared.shape == (tb.n_branch,)
    g = torch.Generator(device=cuda).manual_seed(1009)
    scale = 0.2 + torch.rand(1009, tb.n_branch, generator=g, device=cuda)
    args = args[:12] + ((shared * scale).contiguous(),)
    p = _flows_kernel_against_plain(tb, args)
    over = (p.br_s_signed.abs() > args[12]) & torch.isfinite(p.br_s_signed)
    assert int(over.sum()) > 0, "no branch runs over its rate: the rate penalty is not exercised"


def test_flows_kernel_rejects_what_it_does_not_take(cuda):
    """The wrapper refuses, naming the fault, tensors of another dtype or
    device, non-contiguous or misshapen ones, more than one OLTC's taps and
    an empty batch."""
    from gym_anm_torch.bench import flows_probe
    from gym_anm_torch.physics.flows_cuda import transition_flows_cuda

    tb, args = _flows_inputs(cuda, "ieee33", 16)

    def with_(i, t):
        a = list(flows_probe.copy_args(args))
        a[i] = t
        return a

    bad = [(with_(0, args[0].double()), "float32"), (with_(0, args[0].cpu()), "CUDA device"),
           (with_(2, args[2].t().contiguous().t()), "contiguous"), (with_(3, args[3][:, :-1].contiguous()), "shape"),
           (with_(6, args[6].expand(-1, 2).contiguous()), "shape")]
    empty = [tuple(t[:0] for t in a) if isinstance(a, tuple) else a[:0] for a in flows_probe.copy_args(args)]
    empty[12] = args[12]  # the rates [Ne] are not the lanes'
    bad.append((empty, "non-empty"))
    for a, match in bad:
        with pytest.raises(ValueError, match=match):
            transition_flows_cuda(tb, *a)
