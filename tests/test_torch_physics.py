"""gym_anm_torch physics against gym_anm_tpu on identical numpy-made inputs:
the Y-bus, the chord constants, the mismatch and Jacobian, the plain
Gauss-Jordan solve (the CUDA kernel's plain version), exact Newton-Raphson,
the chord solve and its Newton fallback.  The JAX side runs on the CPU, as
its own tests run it; its float32 linear solve there is
``solve_gauss_jordan``, the Pallas kernel's own reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_anm_torch.physics import power_flow as tpf
from gym_anm_torch.physics.chord_cuda import chord_solve_cuda
from gym_anm_torch.physics.linsolve_cuda import batched_solve, solve_gauss_jordan, solve_gauss_jordan_cuda
from gym_anm_torch.physics.transition import make_tables
from gym_anm_torch.physics.ybus import build_ybus as t_build_ybus
from gym_anm_torch.specs import load_network as t_load_network
from gym_anm_torch.networks import ieee33_network as t_ieee33
from gym_anm_tpu.physics import power_flow as jpf
from gym_anm_tpu.physics.ybus import build_ybus as j_build_ybus
from gym_anm_tpu.vec import VecEnv as JVecEnv, make_ieee33_task as j_make_ieee33_task

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jtb64():
    return JVecEnv(j_make_ieee33_task(), dtype=jnp.float64).tables


@pytest.fixture(scope="module")
def jtb32():
    return JVecEnv(j_make_ieee33_task(), dtype=jnp.float32).tables


@pytest.fixture(scope="module")
def ttb32():
    return make_tables(t_load_network(t_ieee33), 1.0, 100, dtype=torch.float32, device="cpu")


def _tap_lanes(tb, taps):
    lanes = np.repeat(np.asarray(tb.tap0, np.float64)[None], len(taps), axis=0)
    lanes[:, int(tb.oltc_branch[0])] = taps
    return lanes


def _j_ybus(tb, tap):
    f64 = lambda a: jnp.asarray(a, jnp.float64)  # noqa: E731
    return j_build_ybus(tb.n_bus, tb.br_f, tb.br_t, f64(tb.series_re), f64(tb.series_im),
                        f64(tb.shunt_im), f64(tb.shift_cos), f64(tb.shift_sin), f64(tap))


def _t_ybus(tb, taps):
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64))  # noqa: E731
    return t_build_ybus(tb.n_bus, torch.as_tensor(tb.br_f), torch.as_tensor(tb.br_t),
                        t(tb.series_re), t(tb.series_im), t(tb.shunt_im), t(tb.shift_cos),
                        t(tb.shift_sin), t(taps))


def test_build_ybus_matches_jax(jtb64):
    lanes = _tap_lanes(jtb64, np.linspace(0.9, 1.1, 5))
    Yre, Yim = _t_ybus(jtb64, lanes)
    assert Yre.shape == (5, 33, 33)
    for b in range(5):
        jr, ji = _j_ybus(jtb64, lanes[b])
        np.testing.assert_allclose(Yre[b].numpy(), np.asarray(jr), rtol=0, atol=1e-12)
        np.testing.assert_allclose(Yim[b].numpy(), np.asarray(ji), rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_chord_const_matches_jax(dtype, jtb64, jtb32):
    jc = (jtb64 if dtype == torch.float64 else jtb32).chord
    tc = make_tables(t_load_network(t_ieee33), 1.0, 100, dtype=dtype, device="cpu").chord
    # f32 arrays are casts of f64 values that agree to ~1e-15 relative.
    atol = 1e-12 if dtype == torch.float64 else 0.0
    rtol = 1e-12 if dtype == torch.float64 else 1.2e-7
    for name in ("Y0re", "Y0im", "invJ0", "G", "H", "C"):
        a, b = getattr(jc, name), getattr(tc, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol * max(1.0, np.abs(a).max()), err_msg=name)
    assert (jc.t_bus, jc.vstar_re, jc.vstar_im) == (tc.t_bus, tc.vstar_re, tc.vstar_im)


def test_chord_const_at_solved_point_matches_jax(jtb64):
    """make_chord_const linearized at a numpy_nr_solve operating point."""
    Y = np.asarray(jtb64.chord.Y0re) + 1j * np.asarray(jtb64.chord.Y0im)
    spec = t_load_network(t_ieee33)
    p = np.zeros(33)
    for d in spec.load_pos:
        p[spec.dev_bus[d]] += 0.8 * spec.p_min[d]
    q = 0.5 * p
    xj = jpf.numpy_nr_solve(Y, p[1:], q[1:])
    xt = tpf.numpy_nr_solve(Y, p[1:], q[1:])
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-12)
    assert np.abs(xt[:32]).max() > 1e-3  # a real operating point, not the flat start
    jc = jpf.make_chord_const(Y.real, Y.imag, 1, dtype=np.float64, x_star=xj)
    tc = tpf.make_chord_const(Y.real, Y.imag, 1, dtype=np.float64, x_star=xt)
    for name in ("invJ0", "G", "H", "C"):
        a = getattr(jc, name)
        np.testing.assert_allclose(getattr(tc, name), a, rtol=1e-12, atol=1e-12 * np.abs(a).max())
    np.testing.assert_allclose([tc.vstar_re, tc.vstar_im], [jc.vstar_re, jc.vstar_im], rtol=1e-14)


def test_mismatch_and_jacobian_match_jax(jtb64):
    rng = np.random.default_rng(0)
    B, n = 6, 32
    lanes = _tap_lanes(jtb64, rng.uniform(0.9, 1.1, B))
    x = np.concatenate([0.2 * rng.standard_normal((B, n)), 1.0 + 0.15 * rng.standard_normal((B, n))], 1)
    p = 0.3 * rng.standard_normal((B, n))
    q = 0.3 * rng.standard_normal((B, n))
    Yre, Yim = _t_ybus(jtb64, lanes)
    t = torch.as_tensor
    F, (vr, vi, yr, yi) = tpf._mismatch(t(x), t(p), t(q), Yre, Yim, n)
    J = tpf._jacobian(vr, vi, yr, yi, Yre, Yim, n)
    for b in range(B):
        jr, ji = _j_ybus(jtb64, lanes[b])
        Fj, aux = jpf._mismatch(jnp.asarray(x[b]), jnp.asarray(p[b]), jnp.asarray(q[b]), jr, ji, n)
        Jj = jpf._jacobian(*aux, jr, ji, n)
        np.testing.assert_allclose(F[b].numpy(), np.asarray(Fj), rtol=0, atol=1e-12)
        np.testing.assert_allclose(J[b].numpy(), np.asarray(Jj), rtol=0, atol=1e-12)


def _systems(rng, B, n, dtype):
    A = rng.standard_normal((B, n, n)) + n * np.eye(n)
    b = rng.standard_normal((B, n))
    A[1, 0, 0] = 0.0  # zero pivot at the first sweep: non-finite x (no pivoting)
    return A.astype(dtype), b.astype(dtype)


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-10), (np.float32, 1e-5)])
@pytest.mark.parametrize("n", [64, 10, 258])
def test_gauss_jordan_matches_jax(dtype, rtol, n):
    A, b = _systems(np.random.default_rng(n), 9, n, dtype)
    xt = solve_gauss_jordan(torch.as_tensor(A), torch.as_tensor(b)).numpy()
    xj = np.asarray(jpf.solve_gauss_jordan(jnp.asarray(A), jnp.asarray(b)))
    assert xt.dtype == dtype
    assert not np.isfinite(xt[1]).all() and not np.isfinite(xj[1]).all()
    keep = np.arange(9) != 1
    np.testing.assert_allclose(xt[keep], xj[keep], rtol=rtol, atol=rtol * np.abs(xj[keep]).max())
    ref = np.linalg.solve(A[keep].astype(np.float64), b[keep].astype(np.float64)[..., None])[..., 0]
    np.testing.assert_allclose(xt[keep], ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def test_batched_solve_on_cpu_takes_plain_version():
    A, b = _systems(np.random.default_rng(3), 5, 10, np.float32)
    A, b = torch.as_tensor(A), torch.as_tensor(b)
    before = solve_gauss_jordan_cuda.launch_count
    x = batched_solve(A, b)
    assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(solve_gauss_jordan(A, b)))
    assert solve_gauss_jordan_cuda.launch_count == before
    with pytest.raises(ValueError):
        solve_gauss_jordan_cuda(A, b)


def _random_problem(tb, B, seed, scale=0.02):
    rng = np.random.default_rng(seed)
    n = tb.n_bus - 1
    taps = rng.uniform(0.9, 1.1, B)
    p = scale * rng.standard_normal((B, n))
    q = scale * rng.standard_normal((B, n))
    return taps, p, q


def test_nr_solve_f64_matches_jax(jtb64):
    B = 16
    taps, p, q = _random_problem(jtb64, B, seed=7)
    lanes = _tap_lanes(jtb64, taps)
    Yre, Yim = _t_ybus(jtb64, lanes)
    rt = tpf.nr_solve(Yre, Yim, torch.as_tensor(p), torch.as_tensor(q))

    def lane(tap, p, q):
        jr, ji = _j_ybus(jtb64, tap)
        return jpf.nr_solve(jr, ji, p, q)

    rj = jax.jit(jax.vmap(lane))(jnp.asarray(lanes), jnp.asarray(p), jnp.asarray(q))
    assert rt.stable.all() and bool(rj.stable.all())
    np.testing.assert_array_equal(rt.n_iter.numpy(), np.asarray(rj.n_iter))
    for a, b in ((rt.v_re, rj.v_re), (rt.v_im, rj.v_im), (rt.diff, rj.diff), (rt.F, rj.F)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-8)


def _bench_like_problem(tb, B, seed=0):
    """The inputs of tests/test_chord_solver.py::_bench_like_problem, drawn
    with numpy: random caps in [0, 1] p.u. at buses 8 and 25, random taps,
    a noisy warm start and one lane with a NaN guess."""
    rng = np.random.default_rng(seed)
    n = tb.n_bus - 1
    qc = rng.uniform(0, 1, (B, 2)).astype(np.float32)
    taps = rng.uniform(0.9, 1.1, B).astype(np.float32)
    q_ns = np.zeros((B, n), np.float32)
    q_ns[:, 7], q_ns[:, 24] = qc[:, 0], qc[:, 1]
    p_ns = np.zeros((B, n), np.float32)
    inv_da = (np.float32(1.0) / taps - np.float32(1.0 / tb.chord_a0)).astype(np.float32)
    dtf_re = (-tb.chord_y_re * inv_da).astype(np.float32)
    dtf_im = (-tb.chord_y_im * inv_da).astype(np.float32)
    x0 = np.concatenate([np.zeros((B, n)), np.ones((B, n))], 1)
    x0 = (x0 + 0.01 * rng.standard_normal(x0.shape)).astype(np.float32)
    x0[3] = np.nan
    return p_ns, q_ns, dtf_im, dtf_re, dtf_re, dtf_im, x0


def _t_chord(tb, args, **kw):
    p, q, wa, wb, dr, di, x0 = (None if a is None else torch.as_tensor(a) for a in args)
    return tpf.chord_solve(p, q, wa, wb, dr, di, tb.chord_t, x0=x0, **kw)


def test_chord_solve_f32_matches_jax(jtb32, ttb32):
    B = 256
    args = _bench_like_problem(jtb32, B)

    def lane(p, q, wa, wb, dr, di, x):
        return jpf.chord_solve(p, q, wa, wb, dr, di, jtb32.chord, x0=x)

    xj, Fj, dj, ij, aj = jax.jit(jax.vmap(lane))(*map(jnp.asarray, args))
    xt, Ft, dt, it, at = _t_chord(ttb32, args)
    assert bool(aj.all()) and bool(at.all())
    assert float(dt.max()) <= 1e-4
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=5e-6)
    assert int(it.max()) > int(it.median()), "no straggler spread"


def test_chord_solve_on_cpu_takes_plain_version(ttb32):
    """chord_solve on CPU tensors is the plain version; the kernel's wrapper
    refuses CPU tensors and never launches."""
    args = _bench_like_problem(ttb32, 16)
    before = chord_solve_cuda.launch_count
    got = _t_chord(ttb32, args)
    p, q, wa, wb, dr, di, x0 = (torch.as_tensor(a) for a in args)
    ref = tpf.chord_solve_plain(p, q, wa, wb, dr, di, ttb32.chord_t, x0=x0)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        chord_solve_cuda(p, q, wa, wb, dr, di, ttb32.chord_t, x0=x0)
    assert chord_solve_cuda.launch_count == before


@pytest.mark.parametrize("n", [5, 10, 32])
def test_butterfly_sum_follows_the_warp_order(n):
    """The plain chord's Anderson sums take the kernel's warp order, emulated
    thread by thread in float32: thread i < n adds entries i and n + i, the
    idle threads hold 0, and each xor shuffle (offsets 16, 8, 4, 2, 1) adds
    the partner's value; every thread ends with the same sum."""
    rng = np.random.default_rng(n)
    a = (rng.standard_normal((64, 2 * n)) * 10.0 ** rng.integers(-6, 3, (64, 2 * n))).astype(np.float32)
    v = np.zeros((64, 32), np.float32)
    v[:, :n] = a[:, :n] + a[:, n:]
    for o in (16, 8, 4, 2, 1):
        v = v + v[:, np.arange(32) ^ o]
    assert (v == v[:, :1]).all()
    np.testing.assert_array_equal(tpf._butterfly_sum(torch.as_tensor(a)).numpy(), v[:, 0])


@pytest.mark.parametrize("n", [33, 63, 129, 300])
def test_butterfly_sum_follows_the_wide_kernels_fold(n):
    """Above one warp (n > 32) the wide chord kernel folds the zero-padded
    pair sums in place, v[j] += v[j + o] for j < o at each offset o >= 32 of
    the butterfly, then finishes with the warp's shuffles (16..1) on v[0..31]:
    the same float32 sums as the plain version's full butterfly."""
    rng = np.random.default_rng(n)
    a = (rng.standard_normal((64, 2 * n)) * 10.0 ** rng.integers(-6, 3, (64, 2 * n))).astype(np.float32)
    width = 1 << (n - 1).bit_length()
    v = np.zeros((64, width), np.float32)
    v[:, :n] = a[:, :n] + a[:, n:]
    o = width // 2
    while o >= 32:
        v[:, :o] = v[:, :o] + v[:, o:2 * o]
        o //= 2
    w = v[:, :32]
    for o in (16, 8, 4, 2, 1):
        w = w + w[:, np.arange(32) ^ o]
    np.testing.assert_array_equal(tpf._butterfly_sum(torch.as_tensor(a)).numpy(), w[:, 0])


@pytest.mark.parametrize("itemsize,n_max", [(4, 239), (8, 168)])
def test_gauss_jordan_switches_to_device_memory_above_the_cards_shared_memory(itemsize, n_max):
    """With an H100's 227 KB of opt-in shared memory per block, the
    shared-memory path takes n <= 239 in float32 and n <= 168 in float64;
    larger systems go to the path with the matrix in device memory."""
    from gym_anm_torch.physics.linsolve_cuda import smem_bytes

    h100 = 232448
    assert smem_bytes(n_max, itemsize) <= h100 < smem_bytes(n_max + 1, itemsize)


def test_chord_acceptance_rate_is_total(ttb32):
    """Port of tests/test_chord_solver.py::test_chord_acceptance_rate_is_total:
    on the bench action distribution at B=8192 every lane's chord exit is
    accepted (an unaccepted lane is sent to the Newton fallback)."""
    B = 8192
    n = ttb32.n_bus - 1
    for seed in range(3):
        rng = np.random.default_rng(100 + seed)
        qc = torch.as_tensor(rng.uniform(0, 1, (B, 2)).astype(np.float32))
        taps = torch.as_tensor(rng.uniform(0.9, 1.1, B).astype(np.float32))
        q_ns = torch.zeros(B, n)
        q_ns[:, 7], q_ns[:, 24] = qc[:, 0], qc[:, 1]
        inv_da = 1.0 / taps - 1.0 / ttb32.chord_a0
        dtf_re = -ttb32.chord_y_re * inv_da
        dtf_im = -ttb32.chord_y_im * inv_da
        x, F, diff, it, acc = tpf.chord_solve(torch.zeros(B, n), q_ns, dtf_im, dtf_re, dtf_re,
                                              dtf_im, ttb32.chord_t)
        n_unaccepted = int((~acc).sum())
        assert n_unaccepted == 0, (
            f"seed {seed}: {n_unaccepted}/{B} lanes unaccepted "
            f"(worst diff {float(torch.where(acc, 0.0, diff).max()):.2e})")
        assert float(diff.max()) <= 1e-4


def _t_ybus32(tb):
    def ybus_fn(idx):
        taps = tb.tap0.expand(len(idx), -1)
        return t_build_ybus(tb.n_bus, tb.br_f, tb.br_t, tb.series_re, tb.series_im,
                            tb.shunt_im, tb.shift_cos, tb.shift_sin, taps)
    return ybus_fn


def test_chord_divergence_recovers_via_fallback(ttb32):
    """Port of tests/test_chord_solver.py::test_chord_divergence_recovers_via_fallback
    through the port's nr_solve_lazy, with the four bad warm starts as four
    lanes of one batch."""
    n = ttb32.n_bus - 1
    z1 = torch.zeros(1)
    # Overflow case: the exit must be finite and unaccepted.
    p_huge = -torch.ones(1, n) * 1e12
    x, F, diff, it, acc = tpf.chord_solve(p_huge, p_huge, z1, z1, z1, z1, ttb32.chord_t)
    assert bool(torch.isfinite(x).all()) and bool(torch.isfinite(diff).all())
    assert not bool(acc.any())

    z = torch.zeros(4)
    p = (-torch.ones(n) * 0.01).expand(4, -1)
    q = p * 0.5
    x0 = torch.stack([
        torch.cat([torch.zeros(n), torch.full((n,), 1e-6)]),   # vm ~ 0
        torch.cat([torch.zeros(n), torch.full((n,), -1.0)]),   # vm < 0
        torch.cat([torch.full((n,), 30.0), torch.ones(n)]),    # wild angles
        torch.cat([torch.zeros(n), torch.full((n,), 1e15)]),   # vm overflow
    ])
    init = tpf.chord_solve(p, q, z, z, z, z, ttb32.chord_t, x0=x0)
    r = tpf.nr_solve_lazy(_t_ybus32(ttb32), p, q, init=init)
    assert bool(r.stable.all()), f"fallback failed, diff={r.diff.tolist()}"
    assert float(r.diff.max()) <= 1e-4


def _guard_problem(tb, n_lanes=2):
    """A warm start at |θ| = 1 rad with injections that make it an exact
    solution (computed with the same Taylor sin/cos the f32 chord uses), so
    the residual there passes xtol: only the |θ| ≤ 0.5 guard rejects it."""
    n = tb.n_bus - 1
    Y = np.asarray(tb.chord.Y0re, np.float64) + 1j * np.asarray(tb.chord.Y0im, np.float64)
    theta = np.ones(n)
    t2 = theta * theta
    sn = theta * (1.0 + t2 * (-1.0 / 6.0 + t2 * (1.0 / 120.0 - t2 * (1.0 / 5040.0))))
    cs = 1.0 + t2 * (-0.5 + t2 * (1.0 / 24.0 - t2 * (1.0 / 720.0)))
    V = np.concatenate([[1.0], cs + 1j * sn])
    S = V * np.conj(Y @ V)
    p = np.repeat(S.real[None, 1:], n_lanes, 0).astype(np.float32)
    q = np.repeat(S.imag[None, 1:], n_lanes, 0).astype(np.float32)
    x0 = np.repeat(np.concatenate([theta, np.ones(n)])[None], n_lanes, 0).astype(np.float32)
    z = np.zeros(n_lanes, np.float32)
    return p, q, z, z, z, z, x0


def test_trig_guard_rejects_out_of_range_angle_in_both_packages(jtb32, ttb32):
    """The f32 chord's fast-sincos validity guard (power_flow.py:620-622): an
    exit with |θ| ≈ 1 rad is never accepted and is reset to the flat start,
    even when its residual passes xtol."""
    xtol = 1e-2
    args = _guard_problem(jtb32)
    n = jtb32.n_bus - 1
    flat = np.concatenate([np.zeros(n), np.ones(n)]).astype(np.float32)

    def lane(p, q, wa, wb, dr, di, x):
        return jpf.chord_solve(p, q, wa, wb, dr, di, jtb32.chord, x0=x, xtol=xtol)

    outs = {
        "jax": [np.asarray(a) for a in jax.jit(jax.vmap(lane))(*map(jnp.asarray, args))],
        "torch": [a.numpy() for a in _t_chord(ttb32, args, xtol=xtol)],
    }
    # The residual at the warm start is within xtol: without the guard the
    # lane would exit at once, accepted, with x = x0.
    F0 = tpf._chord_mismatch(ttb32.chord_t, torch.as_tensor(args[6]), torch.as_tensor(args[0]),
                             torch.as_tensor(args[1]), torch.zeros(2), torch.zeros(2), True)
    assert float(F0.abs().max()) <= xtol
    for name, (x, F, diff, it, acc) in outs.items():
        assert not acc.any(), name
        np.testing.assert_array_equal(x, np.broadcast_to(flat, x.shape), err_msg=name)
        assert (it == 0).all(), name
        assert diff.min() > xtol, name  # the flat start's analytic residual
    np.testing.assert_allclose(outs["torch"][2], outs["jax"][2], rtol=1e-5)
    np.testing.assert_allclose(outs["torch"][1], outs["jax"][1], rtol=1e-5, atol=1e-5)


def test_trig_guard_is_float32_only(ttb32):
    """Control for the guard test: at float64 (native trig, no guard) the
    same out-of-range warm start is accepted as it is."""
    tb64 = make_tables(t_load_network(t_ieee33), 1.0, 100, dtype=torch.float64, device="cpu")
    args = [torch.as_tensor(a).double() for a in _guard_problem(ttb32)]
    x, F, diff, it, acc = tpf.chord_solve(*args[:6], tb64.chord_t, x0=args[6], xtol=1e-2)
    assert bool(acc.all())
    assert torch.equal(x, args[6])


@pytest.mark.parametrize("n_bus", [33, 48, 130])
def test_chord_tensors_float32_copies_are_exact_and_padded(n_bus):
    """The wide chord kernel streams ChordTensors.W_pack_f32 and invJ0_T_f32:
    the same values as the float64 W_pack and invJ0_T (float32 values, so
    the copies are exact), zeros in the padding, and rows of 8 (mod 32)
    floats with the Y0im^T half at a column of 4 (mod 16), the layout its
    shared-memory chunks take."""
    from gym_anm_torch.networks.random_feeder import feeder_vars, make_feeder_task, random_radial_network
    from gym_anm_torch.vec import VecEnv, make_ieee33_task

    if n_bus == 33:
        task = make_ieee33_task()
    else:
        rng = np.random.default_rng(n_bus)
        net = random_radial_network(rng, n_bus)
        task = make_feeder_task(net, feeder_vars(net, 0.5, 2, rng))
    ct = VecEnv(task, dtype=torch.float32, device="cpu").tables.chord_t
    n, N = ct.n, ct.n + 1
    W, J = ct.W_pack_f32, ct.invJ0_T_f32
    lw = W.shape[1] // 2
    assert W.dtype == J.dtype == torch.float32 and W.shape[0] == N and J.shape[0] == 2 * n
    assert W.shape[1] % 32 == 8 and lw % 16 == 4 and lw >= N and J.shape[1] % 32 == 8 and J.shape[1] >= 2 * n
    assert torch.equal(W[:, :N].double(), ct.W_pack[:, :N]) and torch.equal(W[:, lw:lw + N].double(), ct.W_pack[:, N:])
    assert torch.equal(J[:, :2 * n].double(), ct.invJ0_T)
    assert not W[:, N:lw].any() and not W[:, lw + N:].any() and not J[:, 2 * n:].any()
    ct64 = VecEnv(task, dtype=torch.float64, device="cpu").tables.chord_t
    assert ct64.W_pack_f32 is None and ct64.invJ0_T_f32 is None
