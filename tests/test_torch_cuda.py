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


def test_batched_solve_on_cuda_launches_kernel(cuda):
    A = 2 * torch.eye(8, device=cuda).expand(5, 8, 8)
    before = solve_gauss_jordan_cuda.launch_count
    x = batched_solve(A, torch.ones(5, 8, device=cuda))
    assert solve_gauss_jordan_cuda.launch_count == before + 1
    torch.testing.assert_close(x, torch.full((5, 8), 0.5, device=cuda))


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
    lanes, n_iter equal on all but a rare lane (a float32 AA sum taken in
    another order can move a plateau exit by an iteration), x within the
    solver's own scale (2e-5), F and diff within the acceptance band."""
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
