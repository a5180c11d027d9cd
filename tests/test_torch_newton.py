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
from gym_anm_torch.networks.random_feeder import random_radial_network
from gym_anm_torch.physics import power_flow as tpf
from gym_anm_torch.physics import newton_cuda
from gym_anm_torch.physics.linsolve_cuda import H100_SMEM_OPTIN
from gym_anm_torch.physics.newton_cuda import newton_fallback_cuda
from gym_anm_torch.physics.transition import make_tables
from gym_anm_torch.physics.ybus import LaneYbus, build_ybus
from gym_anm_torch.specs import load_network
from gym_anm_tpu.physics import power_flow as jpf
from gym_anm_tpu.physics.ybus import build_ybus as j_build_ybus

H100_L2 = 50 * 2**20  # bytes of L2 cache on an H100

torch.set_num_threads(2)

NETS = {"ieee33": (ieee33_network, 1.0), "anm6": (anm6_network, 0.25),
        # the random feeder of 48 buses (n = 94, K3 wide's size on the card) of chip_smoke.py's phase 10
        "feeder48": (random_radial_network(np.random.default_rng(48), 48), 1.0)}


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


@pytest.mark.parametrize("net,B", [("ieee33", 64), ("anm6", 64), ("feeder48", 16)])
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


@pytest.mark.parametrize("net,B", [("ieee33", 64), ("anm6", 64), ("feeder48", 16)])
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


def _fold_tree(P, n):
    """The root of the tree over w = 2^k >= n leaves (zeros past n) whose
    node (J, stride S) adds its even-leaf half (J, 2S) to its odd-leaf half
    (J + S, 2S), each sum rounded (K3's ``fold_node``)."""
    def node(w, j, stride):
        if w == 1:
            return P[:, j] if j < n else torch.zeros(P.shape[0], dtype=P.dtype)
        return node(w // 2, j, 2 * stride) + node(w // 2, j + stride, 2 * stride)

    return node(1 << (n - 1).bit_length(), 0, 1)


@pytest.mark.parametrize("n", [1, 6, 33, 40, 48, 64, 65, 130])
def test_fold_sum_follows_the_kernels_tree(n):
    """``_fold_sum`` (the card's float64 Y·V order) sums as K3's
    ``fold_node`` does, bit for bit, at K3's sizes (N up to 33) and K3
    wide's (the 40-, 48-, 64- and 130-bus feeders: 64, 64, 64 and 256
    leaves)."""
    rng = np.random.default_rng(n)
    P = torch.as_tensor(rng.standard_normal((5, n)) * 10.0 ** rng.integers(-8, 8, (5, n)))
    assert torch.equal(tpf._fold_sum(P), _fold_tree(P, n))


@pytest.mark.parametrize("n", [34, 48, 64, 65, 130, 256])
def test_wide_kernels_depth_first_walk_is_the_fold_tree(n):
    """The depth-first walk of the fold tree at a run-time N
    (``newton_fallback_wide.cuh:dot_fold_warp`` walks a lane's leaves so):
    leaf i of the depth-first order is bit-reversed i over L = ceil(log2 N)
    bits, and a finished subtree's sum waits at its level for its sibling's;
    bit for bit the fold, negative zeros included."""
    rng = np.random.default_rng(n)
    P = torch.as_tensor(rng.standard_normal((5, n)) * 10.0 ** rng.integers(-8, 8, (5, n)))
    P[:, ::7] = -0.0
    L = max(1, (n - 1).bit_length())
    stack, s = [None] * 12, None
    for i in range(1 << L):
        k = int(f"{i:0{L}b}"[::-1], 2)
        s = P[:, k] if k < n else torch.zeros(5, dtype=P.dtype)
        level = 0
        while (i >> level) & 1:
            s = stack[level] + s
            level += 1
        stack[level] = s
    assert torch.equal(s, _fold_tree(P, n)) and torch.equal(torch.signbit(s), torch.signbit(_fold_tree(P, n)))


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


class _Lib:
    """A stand-in for the kernel library: records which entry point a launch
    called and its route arguments, and reports a card of ``smem`` bytes of
    opt-in shared memory a block, 132 SMs holding ``per_sm`` blocks and an
    H100's L2 (50 MiB)."""

    def __init__(self, smem=H100_SMEM_OPTIN, per_sm=2):
        self.smem, self.per_sm, self.calls = smem, per_sm, []

    def newton_wide_smem_limit(self):
        return self.smem

    def newton_l2_bytes(self):
        return H100_L2

    def newton_wide_grid(self, f64, n, panel, resident, lane_y):
        return 132 * self.per_sm

    def newton_cluster_grid(self, f64, n, panel, cluster, lane_y):
        return 132 // cluster

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


def _launch(lib, n, dtype, B, lane_y=True):
    """newton_cuda.launch on CPU tensors of a network of n unknowns."""
    nb = n // 2
    outs = [torch.empty(B, n, dtype=dtype), torch.empty(B, n, dtype=dtype), torch.empty(B, dtype=dtype),
            torch.empty(B, dtype=torch.int32), torch.empty(B, dtype=torch.int32)]
    args = (0,) * 18 + (1,)
    return newton_cuda.launch(lib, "lane_ybus" if lane_y else "dense", args, outs, B, nb, dtype, "cpu", 1e-5, 100,
                              None)


@pytest.mark.parametrize("n,dtype,route,panel,cluster,big", [
    (10, torch.float32, "regs", 0, 1, None), (64, torch.float64, "regs", 0, 1, None),
    (66, torch.float32, "smem", 16, 1, None), (94, torch.float32, "smem", 16, 1, None),
    (126, torch.float32, "smem", 8, 1, None), (94, torch.float64, "smem", 16, 1, None),
    (126, torch.float64, "cluster", 8, 2, ("blocked", 16)), (258, torch.float32, "cluster", 16, 2, None),
    (258, torch.float64, "cluster", 8, 4, None), (600, torch.float32, "blocked", 32, 1, None),
    (400, torch.float64, "blocked", 16, 1, None)])
def test_card_route_is_chosen_by_n(n, dtype, route, panel, cluster, big):
    """The card's Newton loop on an H100's shared memory: K3's register
    bodies to n = 64, K3 wide above by ``wide_route``: [J | F] resident in a
    block for the 48- and 64-bus feeders in float32 (48 in float64), on a
    cluster of 2 blocks at 130 buses in float32 and 64 in float64, of 4 at
    130 in float64, in device memory above a cluster of 8; at B = 8192 with
    the lane's Y (``big``: the route and panel there, where they differ) a
    block a lane in device memory at 64 buses in float64, whose slots fit
    the L2 (``batch_route``); the grid is the card's capacity or B (blocks,
    or clusters on the cluster route), and each block has one slot: [J | F]
    on the blocked route, then the lane's Y."""
    lib = _Lib()
    plain = route, panel
    for B, lane_y in ((8192, True), (3, False)):
        lib.calls.clear()
        route, panel = big if big is not None and B == 8192 else plain
        assert _launch(lib, n, dtype, B, lane_y) == route
        (name, args), = lib.calls
        f64 = dtype == torch.float64
        suffix = "f64" if f64 else "f32"
        N = n // 2 + 1
        y_slot = 2 * N * N if lane_y else 0
        if route == "regs":
            assert name == f"newton_fallback_{suffix}"
        elif route == "cluster":
            assert name == f"newton_fallback_cluster_{suffix}"
            got_panel, got_cluster, _, slot, grid, _ = args[-6:]
            assert (got_panel, got_cluster, slot, grid) == (panel, cluster, y_slot, min(B, 132 // cluster))
        else:
            assert name == f"newton_fallback_wide_{suffix}"
            got_panel, resident, _, slot, grid, _ = args[-6:]
            want_slot = (0 if route == "smem" else n * (n + 1)) + y_slot
            assert (got_panel, resident, slot, grid) == (panel, int(route == "smem"), want_slot, min(B, 264))


@pytest.mark.parametrize("n_bus", [40, 48, 64, 130])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wide_route_of_each_feeder(n_bus, dtype):
    """``wide_route`` at the feeders' sizes on an H100 (232448 bytes of
    opt-in shared memory a block): ``"smem"`` where K1's rule keeps the
    matrix resident two blocks an SM, else the cluster route at the smallest
    cluster whose blocks hold their rows with the widest panel that fits:
    the sum of ``cluster_smem_bytes`` fits, no smaller cluster does at any
    panel, and a block's rows are whole panels."""
    from gym_anm_torch.physics.linsolve_cuda import H100_SMEM_OPTIN

    n = 2 * (n_bus - 1)
    want = {(40, torch.float32): ("smem", 16, 1), (40, torch.float64): ("smem", 8, 1),
            (48, torch.float32): ("smem", 16, 1), (48, torch.float64): ("smem", 16, 1),
            (64, torch.float32): ("smem", 8, 1), (64, torch.float64): ("cluster", 8, 2),
            (130, torch.float32): ("cluster", 16, 2), (130, torch.float64): ("cluster", 8, 4)}[n_bus, dtype]
    got = newton_cuda.wide_route(n, dtype, H100_SMEM_OPTIN)
    assert got == want
    route, panel, cluster = got
    if route == "cluster":
        item = dtype.itemsize
        assert newton_cuda.cluster_smem_bytes(n, item, panel, cluster) <= H100_SMEM_OPTIN
        smaller = [c for c in newton_cuda.CLUSTER_SIZES if c < cluster]
        assert all(newton_cuda.cluster_smem_bytes(n, item, bp, c) > H100_SMEM_OPTIN
                   for c in smaller for bp in newton_cuda.CLUSTER_PANELS[item])
        rows = newton_cuda.cluster_rows(n, panel, cluster)
        assert rows % panel == 0 and rows * cluster >= n



@pytest.mark.parametrize("n_bus,dtype,lanes,want", [
    (48, torch.float32, 8192, "smem"), (64, torch.float32, 8192, "smem"), (64, torch.float64, 1, "cluster"),
    (64, torch.float64, 66, "cluster"), (64, torch.float64, 67, "blocked"), (64, torch.float64, 8192, "blocked"),
    (130, torch.float32, 8192, "cluster"), (130, torch.float64, 8192, "cluster")])
def test_batch_route_of_each_feeder(n_bus, dtype, lanes, want):
    """``batch_route`` at the feeders' sizes on an H100 (132 SMs: 66
    clusters of 2, 33 of 4, 264 one-block lanes at once; 50 MiB of L2) with
    the lanes' Y built in the slots: the cluster route while the clusters
    hold every lane at once; past that a block a lane where the blocked
    route's slots fit the L2 (64 buses in float64: 264 slots of 193,552
    bytes), else still clusters (130 buses: 106 and 213 MB of slots)."""
    n, item = 2 * (n_bus - 1), dtype.itemsize
    route, _, cluster = newton_cuda.wide_route(n, dtype, H100_SMEM_OPTIN)
    slot = (n * (n + 1) + 2 * (n // 2 + 1) ** 2) * item
    assert newton_cuda.batch_route(route, lanes, 132 // cluster, 264, slot, H100_L2) == want

@pytest.mark.parametrize("n", [34, 48, 64, 65, 127, 130, 256])
def test_cluster_routes_warp_fold_is_the_fold_tree(n):
    """The cluster route's float64 sum (``newton_fallback_wide.cuh:
    dot_fold_warp``): lane l of a warp folds its leaves l + 32 m, m <
    2^(L-5), by the depth-first walk over m, then the lanes' sums are added
    16 apart, then 8, 4, 2, 1 (lane l takes lane l + d's); bit for bit the
    fold, negative zeros included, at the feeders' N and the largest N of
    each tree width."""
    rng = np.random.default_rng(n)
    P = torch.as_tensor(rng.standard_normal((5, n)) * 10.0 ** rng.integers(-8, 8, (5, n)))
    P[:, ::7] = -0.0
    L = max(6, (n - 1).bit_length())
    Lm = L - 5
    lanes = []
    for lane in range(32):
        stack, s = [None] * 7, None
        for i in range(1 << Lm):
            m = int(f"{i:0{Lm}b}"[::-1], 2) if Lm else 0
            k = lane + 32 * m
            s = P[:, k] if k < n else torch.zeros(5, dtype=P.dtype)
            level = 0
            while (i >> level) & 1:
                s = stack[level] + s
                level += 1
            stack[level] = s
        lanes.append(s)
    d = 16
    while d:
        lanes = [lanes[j] + (lanes[j + d] if j + d < 32 else lanes[j]) for j in range(32)]
        d //= 2
    root = _fold_tree(P, n)
    assert torch.equal(lanes[0], root) and torch.equal(torch.signbit(lanes[0]), torch.signbit(root))


def test_card_route_raises_where_no_blocked_panel_fits():
    """A card whose shared memory takes no panel of K1's blocked route at n
    (with the lane's vectors) is refused, as ``k1_route`` refuses K1."""
    with pytest.raises(ValueError, match="too large for the blocked route"):
        _launch(_Lib(smem=24 * 1024), 258, torch.float64, 4)
    assert _launch(_Lib(smem=24 * 1024), 94, torch.float64, 4) == "blocked"


def test_wide_wrapper_checks_its_arguments_before_loading_the_library(monkeypatch):
    """K3 wide's sizes take the wrapper's checks: CPU tensors refused at n =
    94 and 258 before the library loads, and n above ``MAX_N`` (networks of
    more than 4096 buses) refused with the largest n named."""
    def no_build():
        raise AssertionError("load_library was called")

    monkeypatch.setattr(_build, "load_library", no_build)
    for n in (94, 258, newton_cuda.MAX_N + 2):
        nb, B = n // 2, 2
        x = torch.zeros(B, n)
        args = (x, x.clone(), torch.ones(B), torch.zeros(B, dtype=torch.int32), None, torch.zeros(B, nb),
                torch.zeros(B, nb))
        Y = (torch.zeros(nb + 1, nb + 1), torch.zeros(nb + 1, nb + 1))
        match = "CUDA device" if n <= newton_cuda.MAX_N else f"2 <= n <= {newton_cuda.MAX_N} .*4096 buses"
        with pytest.raises(ValueError, match=match):
            newton_fallback_cuda(*args, Y)


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
    """``k3_arguments`` (K3's wrapper's checks) refuses each malformed
    argument before the library is loaded and before any tensor is read on
    a device."""
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
