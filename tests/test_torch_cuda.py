"""gym_anm_torch on a CUDA card: the Gauss-Jordan kernel against its plain
version, and the float32 step on the card against the CPU.

Every test here needs a card and skips without one.  The file imports no
JAX, so on a machine with a card and no JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gym_anm_torch.physics.linsolve_cuda import batched_solve, solve_gauss_jordan, solve_gauss_jordan_cuda
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
