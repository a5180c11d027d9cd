"""gym_anm_torch on a CUDA card: the Gauss-Jordan kernel (K1) and the fused
chord-Newton kernel (K2) against their plain versions, and the float32 step
on the card against the CPU.

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
