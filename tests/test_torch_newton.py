"""The exact-Newton fallback of gym_anm_torch against gym_anm_tpu's on the
same numpy-made inputs: ``nr_solve_lazy`` after the same chord exit
(bad-basin warm starts, so the lanes reach the Newton loop) on IEEE33 (n =
64) and ANM6 (n = 10) in float64 and float32, ``nr_solve`` from the flat
start in float64, the lanes' Y-bus as data (``LaneYbus``) against
``build_ybus``, the card's float64 summation order, and the card wrapper's
refusal of CPU tensors.  On the CPU the
port runs its plain loop (``power_flow._newton_loop``), the CUDA kernel's
oracle; the JAX side runs on the CPU as its own tests run it, its float32
linear solve there the Pallas kernel's own reference ``solve_gauss_jordan``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_anm_torch import _build
from gym_anm_torch.networks import anm6_network, ieee33_network
from gym_anm_torch.physics import power_flow as tpf
from gym_anm_torch.physics.newton_cuda import newton_fallback_cuda
from gym_anm_torch.physics.transition import make_tables
from gym_anm_torch.physics.ybus import LaneYbus, build_ybus
from gym_anm_torch.specs import load_network
from gym_anm_tpu.physics import power_flow as jpf
from gym_anm_tpu.physics.ybus import build_ybus as j_build_ybus

torch.set_num_threads(2)

NETS = {"ieee33": (ieee33_network, 1.0), "anm6": (anm6_network, 0.25)}


def _tables(net, dtype):
    spec, delta_t = NETS[net]
    return make_tables(load_network(spec), delta_t, 100, dtype=dtype, device="cpu")


def _lane_ybus(tb, taps):
    """The LaneYbus of the lanes' taps [B, Ne] (numpy) on the CPU tables."""
    return LaneYbus(tb.n_bus, tb.br_f, tb.br_t, tb.series_re, tb.series_im, tb.shunt_im, tb.shift_cos,
                    tb.shift_sin, torch.as_tensor(taps, dtype=tb.series_re.dtype))


def _lanes(tb, B, seed):
    """Random taps in [0.95, 1.05] on the OLTC branch (where there is one),
    random loads (each bus's p in [-0.02, -0.01] p.u. on IEEE33, a quarter
    of that on ANM6, q = p / 2) and the four bad-basin warm starts of
    tests/test_chord_solver.py, tiled: float64 numpy arrays."""
    rng = np.random.default_rng(seed)
    n = tb.n_bus - 1
    taps = np.repeat(tb.tap0.numpy()[None].astype(np.float64), B, axis=0)
    if len(tb.oltc_branch):
        taps[:, int(tb.oltc_branch[0])] = rng.uniform(0.95, 1.05, B)
    scale = 0.01 if n > 8 else 0.0025
    p = -scale * (1.0 + rng.uniform(0.0, 1.0, (B, n)))
    pats = np.stack([
        np.concatenate([np.zeros(n), np.full(n, 1e-6)]),
        np.concatenate([np.zeros(n), np.full(n, -1.0)]),
        np.concatenate([np.full(n, 30.0), np.ones(n)]),
        np.concatenate([np.zeros(n), np.full(n, 1e15)]),
    ])
    return taps, p, 0.5 * p, pats[np.arange(B) % 4]


def _chord_init(tb, taps, p, q, x0):
    """The port's chord exit on the lanes, as the Newton loop's ``init``."""
    dt = tb.series_re.dtype
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dt)  # noqa: E731
    B = p.shape[0]
    if tb.chord_has_oltc:
        a = t(taps[:, int(tb.oltc_branch[0])])
        inv_da = 1.0 / a - 1.0 / tb.chord_a0
        dtf_re, dtf_im = -tb.chord_y_re * inv_da, -tb.chord_y_im * inv_da
    else:
        dtf_re = dtf_im = torch.zeros(B, dtype=dt)
    return tpf.chord_solve(t(p), t(q), dtf_im, dtf_re, dtf_re, dtf_im, tb.chord_t, x0=t(x0))


def _jax_ybus(tb, tap):
    a = lambda v: jnp.asarray(v.numpy() if torch.is_tensor(v) else v)  # noqa: E731
    return j_build_ybus(tb.n_bus, tb.br_f.numpy(), tb.br_t.numpy(), a(tb.series_re), a(tb.series_im),
                        a(tb.shunt_im), a(tb.shift_cos), a(tb.shift_sin), tap)


def _jax_lazy(tb, taps, p, q, init):
    """jax.vmap of the reference's nr_solve_lazy, each lane's Y-bus built
    inside its loop body from its taps."""
    def lane(tap, p, q, x, F, diff, it, acc):
        return jpf.nr_solve_lazy(lambda: _jax_ybus(tb, tap), p, q, init=(x, F, diff, it, acc))

    args = (taps, p, q) + tuple(t.numpy() for t in init)
    return jax.jit(jax.vmap(lane))(*(jnp.asarray(a) for a in args))


@pytest.mark.parametrize("net", ["ieee33", "anm6"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lane_ybus_is_build_ybus(net, dtype):
    """LaneYbus(idx) is build_ybus of those lanes' taps, bit for bit."""
    tb = _tables(net, dtype)
    taps, *_ = _lanes(tb, 12, seed=3)
    ybus = _lane_ybus(tb, taps)
    idx = torch.tensor([7, 0, 3])
    want = build_ybus(tb.n_bus, tb.br_f, tb.br_t, tb.series_re, tb.series_im, tb.shunt_im, tb.shift_cos,
                      tb.shift_sin, ybus.tap_magn[idx])
    got = ybus(idx)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g, w) for g, w in zip(ybus(slice(None)), _lane_ybus(tb, taps)(torch.arange(12))))


@pytest.mark.parametrize("net,B", [("ieee33", 64), ("anm6", 64)])
def test_nr_solve_lazy_f64_matches_jax(net, B):
    """float64: the same chord exit through both fallbacks; voltages within
    1e-12, n_iter and stable equal on every lane.  The exit is the float32
    chord's (as the float32 tier hands it over), cast: its guard resets the
    bad-basin starts to the flat start or keeps an exit near the solution,
    so Newton converges on every lane.  (A lane that diverges ends at an
    iteration that a summation order's last bit decides, which the two
    packages' matrix products do not share.)"""
    tb = _tables(net, torch.float64)
    taps, p, q, x0 = _lanes(tb, B, seed=11)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    init = _chord_init(_tables(net, torch.float32), f32(taps), f32(p), f32(q), f32(x0))
    init = tuple(t.double() if t.is_floating_point() else t for t in init)
    assert not bool(init[4].any()), "a bad-basin lane was accepted by the chord"
    rt = tpf.nr_solve_lazy(_lane_ybus(tb, taps), torch.as_tensor(p), torch.as_tensor(q), init=init)
    rj = _jax_lazy(tb, taps, p, q, init)
    np.testing.assert_array_equal(rt.stable.numpy(), np.asarray(rj.stable))
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.n_iter.numpy(), np.asarray(rj.n_iter))
    assert bool(rt.stable.all())
    for a, b in ((rt.v_re, rj.v_re), (rt.v_im, rj.v_im)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)


@pytest.mark.parametrize("net,B", [("ieee33", 64), ("anm6", 64)])
def test_nr_solve_lazy_f32_matches_jax(net, B):
    """float32: stable and converged equal on every lane, voltages within
    1e-5 and diff within 1e-4 on the stable lanes (sums taken in another
    order move float32 roundings, so n_iter may differ by a plateau exit)."""
    tb = _tables(net, torch.float32)
    taps, p, q, x0 = _lanes(tb, B, seed=12)
    taps, p, q = (a.astype(np.float32) for a in (taps, p, q))
    init = _chord_init(tb, taps, p, q, x0.astype(np.float32))
    assert not bool(init[4].any()), "a bad-basin lane was accepted by the chord"
    rt = tpf.nr_solve_lazy(_lane_ybus(tb, taps), torch.as_tensor(p), torch.as_tensor(q), init=init)
    rj = _jax_lazy(tb, taps, p, q, init)
    np.testing.assert_array_equal(rt.stable.numpy(), np.asarray(rj.stable))
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    ok = rt.stable.numpy()
    assert ok.sum() >= B // 2, f"only {ok.sum()} of {B} lanes stable"
    for a, b in ((rt.v_re, rj.v_re), (rt.v_im, rj.v_im)):
        np.testing.assert_allclose(a.numpy()[ok], np.asarray(b)[ok], rtol=0, atol=1e-5)
    assert float(rt.diff[ok].max()) <= 1e-4 and float(np.asarray(rj.diff)[ok].max()) <= 1e-4


@pytest.mark.parametrize("net", ["ieee33", "anm6"])
@pytest.mark.parametrize("broadcast", [False, True])
def test_nr_solve_f64_from_flat_start_matches_jax(net, broadcast):
    """nr_solve from the flat start in float64, a Y per lane [B, N, N] or one
    [N, N] for every lane: voltages within 1e-12, n_iter and stable equal."""
    B = 16
    tb = _tables(net, torch.float64)
    taps, p, q, _ = _lanes(tb, B, seed=5)
    if broadcast:
        taps[:] = taps[0]
    Yre, Yim = _lane_ybus(tb, taps)(slice(None))
    Y = (Yre[0], Yim[0]) if broadcast else (Yre, Yim)
    rt = tpf.nr_solve(*Y, torch.as_tensor(p), torch.as_tensor(q))

    def lane(tap, p, q):
        return jpf.nr_solve(*_jax_ybus(tb, tap), p, q)

    rj = jax.jit(jax.vmap(lane))(jnp.asarray(taps), jnp.asarray(p), jnp.asarray(q))
    assert bool(rt.stable.all()) and bool(rj.stable.all())
    np.testing.assert_array_equal(rt.n_iter.numpy(), np.asarray(rj.n_iter))
    for a, b in ((rt.v_re, rj.v_re), (rt.v_im, rj.v_im)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_batch_with_no_unaccepted_lane_comes_back_as_its_init(dtype):
    """Every lane accepted by the chord: the fallback moves nothing."""
    tb = _tables("ieee33", dtype)
    B, n = 32, tb.n_bus - 1
    taps, p, q, _ = _lanes(tb, B, seed=2)
    init = _chord_init(tb, taps, p, q, np.concatenate([np.zeros((B, n)), np.ones((B, n))], 1))
    assert bool(init[4].all())
    r = tpf.nr_solve_lazy(_lane_ybus(tb, taps), torch.as_tensor(p, dtype=dtype), torch.as_tensor(q, dtype=dtype),
                          init=init)
    v_re, v_im = tpf._assemble_v(init[0][:, :n], init[0][:, n:])
    assert torch.equal(r.v_re, v_re) and torch.equal(r.v_im, v_im)
    assert torch.equal(r.F, init[1]) and torch.equal(r.diff, init[2]) and torch.equal(r.n_iter, init[3])
    assert bool(r.stable.all())


@pytest.mark.parametrize("n", [1, 6, 33, 64])
def test_fold_sum_follows_the_kernels_tree(n):
    """``_fold_sum`` (the card's float64 Y·V order) sums as K3's
    ``fold_node`` does: the root of the tree over w = 2^k >= n leaves (zeros
    past n) whose node (J, stride S) adds its even-leaf half (J, 2S) to its
    odd-leaf half (J + S, 2S), each sum rounded, bit for bit."""
    rng = np.random.default_rng(n)
    P = torch.as_tensor(rng.standard_normal((5, n)) * 10.0 ** rng.integers(-8, 8, (5, n)))

    def node(w, j, stride):
        if w == 1:
            return P[:, j] if j < n else torch.zeros(5, dtype=P.dtype)
        return node(w // 2, j, 2 * stride) + node(w // 2, j + stride, 2 * stride)

    assert torch.equal(tpf._fold_sum(P), node(1 << (n - 1).bit_length(), 0, 1))


def test_card_wrapper_refuses_cpu_tensors_before_loading_the_library(monkeypatch):
    def no_build():
        raise AssertionError("load_library was called")

    monkeypatch.setattr(_build, "load_library", no_build)
    tb = _tables("anm6", torch.float32)
    B, n = 4, tb.n_bus - 1
    taps, p, q, _ = _lanes(tb, B, seed=1)
    x = torch.zeros(B, 2 * n)
    args = (x, x.clone(), torch.ones(B), torch.zeros(B, dtype=torch.int32), torch.zeros(B, dtype=torch.bool),
            torch.as_tensor(p, dtype=torch.float32), torch.as_tensor(q, dtype=torch.float32))
    with pytest.raises(ValueError, match="CUDA device"):
        newton_fallback_cuda(*args, _lane_ybus(tb, taps))
    with pytest.raises(ValueError, match="CUDA device"):
        newton_fallback_cuda(*args, _lane_ybus(tb, taps)(slice(None)))


def test_card_route_is_chosen_by_n():
    """The card's Newton loop: the kernel up to n = 64 (33 buses), the plain
    loop around K1's panel routes above, each counted."""
    before = tpf.newton_routes["wide"]
    assert tpf._card_route(64) == "k3" and tpf._card_route(10) == "k3" and tpf._card_route(94) == "wide"
    assert tpf.newton_routes == {"wide": before + 1}


def _wrapper_args(dtype=torch.float32):
    tb = _tables("anm6", dtype)
    B, n = 4, tb.n_bus - 1
    taps, p, q, _ = _lanes(tb, B, seed=1)
    x = torch.zeros(B, 2 * n, dtype=dtype)
    args = [x, x.clone(), torch.ones(B, dtype=dtype), torch.zeros(B, dtype=torch.int32),
            torch.zeros(B, dtype=torch.bool), torch.as_tensor(p, dtype=dtype), torch.as_tensor(q, dtype=dtype)]
    return tb, taps, args


@pytest.mark.parametrize("fault,message", [
    ("float16", "float32 or float64"), ("x shape", "shape"), ("n_iter int64", "n_iter as int32"),
    ("accepted uint8", "accepted as bool"), ("mixed types", "of one type"), ("dense Y shape", "Yre, Yim"),
    ("Y type", "in the lanes' type"), ("LaneYbus buses", "LaneYbus does not match"),
    ("LaneYbus taps", "LaneYbus does not match")])
def test_card_wrapper_checks_its_arguments(monkeypatch, fault, message):
    """``k3_arguments`` (the checks K3's wrapper and PR 13's design, timed
    beside it, share) refuses each malformed argument before the library is
    loaded and before any tensor is read on a device."""
    from gym_anm_torch.physics.newton_cuda import k3_arguments

    def no_build():
        raise AssertionError("load_library was called")

    monkeypatch.setattr(_build, "load_library", no_build)
    tb, taps, args = _wrapper_args()
    ybus = _lane_ybus(tb, taps)
    if fault == "float16":
        args = [t.half() if t.is_floating_point() else t for t in args]
    elif fault == "x shape":
        args[0] = args[0][:, :-1]
    elif fault == "n_iter int64":
        args[3] = args[3].long()
    elif fault == "accepted uint8":
        args[4] = args[4].to(torch.uint8)
    elif fault == "mixed types":
        args[1] = args[1].double()
    elif fault == "dense Y shape":
        ybus = tuple(t[:, :-1] for t in ybus(slice(None)))
    elif fault == "Y type":
        ybus = tuple(t.double() for t in ybus(slice(None)))
    elif fault == "LaneYbus buses":
        ybus = ybus._replace(n_bus=ybus.n_bus + 1)
    else:
        ybus = ybus._replace(tap_magn=ybus.tap_magn[:-1])
    with pytest.raises(ValueError, match=message):
        k3_arguments(*args, ybus)
    with pytest.raises(ValueError, match=message):
        newton_fallback_cuda(*args, ybus)


def test_pr13_baseline_goes_through_the_wrappers_checks(monkeypatch):
    """PR 13's design, timed beside K3 on the host clock, takes its
    arguments through the same checks and allocations as K3's wrapper: it
    refuses CPU tensors as the wrapper does, before reading its library."""
    from gym_anm_torch.bench.kernel_probes import pr13_newton

    tb, taps, args = _wrapper_args(torch.float64)
    with pytest.raises(ValueError, match="CUDA device"):
        pr13_newton(None, *args, _lane_ybus(tb, taps))
