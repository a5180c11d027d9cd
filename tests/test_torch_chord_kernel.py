"""K2, the tile chord kernel (``gym_anm_torch/csrc/chord_newton.cu``), on the
CPU: the wrapper's route rule (:func:`chord_cuda.tile_slots`), and the
kernel's own source compiled with g++ against the CUDA emulation of
``tests/test_torch_k3_emulation.py`` (one std::thread per CUDA thread, a
2-SM card), with the FP64 tensor-core product ``mma.sync.m16n8k4`` emulated
for a warp (every thread's fragments gathered through the warp's slots, each
entry of D summed in k order).  Held there:

* both routes, 8 slots a block (a lane a warp) and 16 (two lanes a warp,
  each constant fragment read for two lane tiles), give the same bits on
  every output of every lane, as the kernel promises (each accumulator keeps
  its k-order whatever the width);
* each route against the plain chord ``power_flow.chord_solve_plain`` on
  flat, warm and bad-basin starts mixed lane by lane, at more lanes than the
  emulated card's slots: the card tests' bars (the same accepted lanes,
  n_iter equal on all but a rare lane, x within 2e-5, F and diff within the
  acceptance band, the reset lanes exactly flat).

Source edits make the kernel host code (the launch syntax, the dynamic shared
memory, the mma instruction); the arithmetic is the kernel's own.  Needs g++
(C++20).
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gym_anm_torch import _build
from gym_anm_torch.networks import anm6_network, ieee33_network
from gym_anm_torch.networks.random_feeder import random_radial_network
from gym_anm_torch.physics import chord_cuda, power_flow as pf
from gym_anm_torch.physics.transition import make_tables
from gym_anm_torch.specs import load_network
from tests.test_torch_k3_emulation import EMULATION

torch.set_num_threads(2)

# What the K3 emulation lacks: __all_sync, the warp's maximum reduction and
# bit casts, and the warp's FP64 mma.
K2_EMULATION = r"""
inline bool __all_sync(unsigned m, int pred) { return __ballot_sync(m, pred) == 0xffffffffu; }
// __syncthreads_and: a count of the block's true votes, between barriers
// (a counter for each block of the emulated grid).
inline std::atomic<int> emulated_votes[64];
inline int __syncthreads_and(int pred) {
  if (threadIdx.x == 0) emulated_votes[blockIdx.x].store(0);
  __syncthreads();
  if (pred) emulated_votes[blockIdx.x].fetch_add(1);
  __syncthreads();
  const int votes = emulated_votes[blockIdx.x].load();
  __syncthreads();
  return votes == static_cast<int>(blockDim.x);
}
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, sizeof(u)); return u; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, sizeof(f)); return f; }
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  WarpState& w = my_warp();
  w.slot[threadIdx.x & 31] = v;
  w.bar.arrive_and_wait();
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m = static_cast<unsigned>(w.slot[i]) > m ? static_cast<unsigned>(w.slot[i]) : m;
  w.bar.arrive_and_wait();
  return m;
}
// Every thread's v, gathered through the warp's slots.
inline void emulated_gather(double v, double (&all)[32]) {
  WarpState& w = my_warp();
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(double));
  w.slot[threadIdx.x & 31] = bits;
  w.bar.arrive_and_wait();
  for (int i = 0; i < 32; ++i) std::memcpy(&all[i], &w.slot[i], sizeof(double));
  w.bar.arrive_and_wait();
}
// mma.sync.m16n8k4 f64: thread l = 4 g + t holds A[g][t] (a0), A[g + 8][t]
// (a1), B[t][g], and D[g][2t], D[g][2t + 1], D[g + 8][2t], D[g + 8][2t + 1].
inline void emulated_dmma(double (&d)[4], double a0, double a1, double b) {
  double A0[32], A1[32], Bk[32];
  emulated_gather(a0, A0);
  emulated_gather(a1, A1);
  emulated_gather(b, Bk);
  const int l = threadIdx.x & 31, g = l >> 2, t = l & 3;
  for (int e = 0; e < 4; ++e) {
    const double* A = e < 2 ? A0 : A1;
    const int col = 2 * t + (e & 1);
    double acc = d[e];
    for (int k = 0; k < 4; ++k) acc += A[4 * g + k] * Bk[4 * col + k];
    d[e] = acc;
  }
}
"""

# (pattern, replacement) in chord_newton.cu.
EDITS = (
    (r"extern __shared__ __align__\(16\) unsigned char smem_raw\[\];", "unsigned char* smem_raw = emulated_smem();"),
    (r'asm\("mma\.sync\.aligned\.m16n8k4.*?\);', "emulated_dmma(d, a0, a1, b);"),
    (r"kernel<<<grid, kWarps \* 32, L::bytes, stream>>>\(P\);",
     "{ Params a_ = P; void* args_[] = {&a_}; emulated_launch(kernel, dim3(grid), dim3(kWarps * 32), args_, "
     "L::bytes, stream); }"),
)


@pytest.mark.parametrize("n", [32, 19, 5])
def test_tile_slots_by_batch_on_a_132_sm_card(n):
    """The route rule on an H100's 132 SMs: at IEEE33's full width (n = 32)
    8 slots a block below the 4,224 lanes that fill the 16-slot route's 32
    lanes an SM, 16 from there; at a 20-bus feeder's 19 and ANM6's 5 always
    8."""
    picks = {B: chord_cuda.tile_slots(B, n, 132) for B in (1, 7, 1001, 4223, 4224, 8192, 262144, 524288)}
    wide = 16 if n == 32 else 8
    assert picks == {1: 8, 7: 8, 1001: 8, 4223: 8, 4224: wide, 8192: wide, 262144: wide, 524288: wide}
    with pytest.raises(ValueError):
        chord_cuda.tile_slots(8192, chord_cuda.TILE_MAX_N + 1, 132)


@pytest.fixture(scope="module")
def k2_emulated(tmp_path_factory):
    """The emulated K2 as a ctypes library (its entry point declared as the
    card build's)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the emulation")
    d = tmp_path_factory.mktemp("k2_emulation")
    (d / "cuda_runtime.h").write_text(EMULATION + K2_EMULATION)
    text = (_build.CSRC_DIR / "chord_newton.cu").read_text()
    for pattern, repl in EDITS:
        text, count = re.subn(pattern, repl, text, flags=re.S)
        assert count == 1, f"the kernel's source changed: {pattern}"
    (d / "chord_newton.cu").write_text(text)
    lib = d / "libk2_emulated.so"
    proc = subprocess.run([gxx, "-x", "c++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-pthread",
                           f"-I{d}", "-Wno-unknown-pragmas", "-Wno-attributes", "-shared", "-o", str(lib),
                           str(d / "chord_newton.cu")], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return _build.declare(ctypes.CDLL(str(lib)))


def _k2(lib, args, ct, x0, slots):
    """One emulated launch at ``slots`` slots a block, on chord_solve_cuda's
    arguments (CPU tensors): (x, F, diff, n_iter, accepted)."""
    B, n = args[0].shape
    outs = chord_cuda.kernel_outputs(B, n, "cpu")
    nxt = torch.zeros(1, dtype=torch.int32)
    rc = lib.chord_newton_f32(*chord_cuda.kernel_args(args, ct, x0, outs), nxt.data_ptr(), B, n, slots, None)
    assert rc == 0, f"the emulated K2 refused the launch ({rc})"
    grid = min(-(-B // slots), 2)  # the persistent grid on the emulated card's 2 SMs
    assert int(nxt) == B + grid * slots, "every slot claims lanes until the counter passes B, then once more"
    return outs


def _problem(net, delta_t, B, seed):
    """The card tests' chord problem on the CPU (random injections and taps,
    noisy warm starts), the starts mixed lane by lane: flat (a NaN guess),
    warm, and the four bad-basin guesses."""
    tb = make_tables(load_network(net), delta_t, 100, dtype=torch.float32, device="cpu")
    n = tb.n_bus - 1
    rng = np.random.default_rng(seed)
    p = torch.tensor(0.01 * rng.standard_normal((B, n)), dtype=torch.float32)
    q = torch.tensor(0.01 * rng.standard_normal((B, n)), dtype=torch.float32)
    d = torch.tensor(rng.uniform(-2, 2, (B, 2)) * tb.chord_has_oltc, dtype=torch.float32)
    warm = torch.cat([torch.zeros(B, n), torch.ones(B, n)], 1) + torch.tensor(
        0.01 * rng.standard_normal((B, 2 * n)), dtype=torch.float32)
    bad = torch.tensor([[0.0] * n + [1e-6] * n, [0.0] * n + [-1.0] * n, [30.0] * n + [1.0] * n,
                        [0.0] * n + [1e15] * n])[torch.as_tensor(rng.integers(0, 4, B))]
    kind = torch.as_tensor(rng.integers(0, 3, B))[:, None]
    x0 = torch.where(kind == 0, torch.full_like(warm, float("nan")), torch.where(kind == 1, warm, bad))
    args = tuple(t.contiguous() for t in (p, q, d[:, 1], d[:, 0], d[:, 0], d[:, 1]))
    return tb.chord_t, args, x0.contiguous()


NETS = [(ieee33_network, 1.0), (anm6_network, 0.25)]
# A random radial feeder of 20 buses (n = 19: the 8-slot route with n read
# at run time between ANM6's and IEEE33's widths).
FEEDER20 = random_radial_network(np.random.default_rng(20), 20)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("B", [5, 17, 40, 77])
def test_both_routes_give_the_same_bits(k2_emulated, B):
    """8 and 16 slots a block on IEEE33, on fewer lanes than a block's slots
    and on enough to refill them: every output of every lane bit for bit."""
    ct, args, x0 = _problem(ieee33_network, 1.0, B, B)
    for a, b in zip(_k2(k2_emulated, args, ct, x0, 8), _k2(k2_emulated, args, ct, x0, 16)):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("net,delta_t,slots", [(ieee33_network, 1.0, 8), (ieee33_network, 1.0, 16),
                                               (anm6_network, 0.25, 8), (FEEDER20, 0.5, 8)],
                         ids=["ieee33-8", "ieee33-16", "anm6-8", "feeder20-8"])
def test_emulated_kernel_matches_plain_version(k2_emulated, net, delta_t, slots):
    """Each route against the plain chord on mixed starts, 48 lanes (every
    slot of the emulated card refills): the card tests' bars."""
    B = 48
    ct, args, x0 = _problem(net, delta_t, B, 7 + slots)
    xk, Fk, dk, ik, ak = _k2(k2_emulated, args, ct, x0, slots)
    xp, Fp, dp, ip, ap = pf.chord_solve_plain(*args, ct, x0=x0)
    assert torch.equal(ak, ap) and bool(ak.any())
    assert int((ik != ip).sum()) <= 1
    torch.testing.assert_close(xk, xp, rtol=0, atol=2e-5)
    torch.testing.assert_close(Fk, Fp, rtol=0, atol=1e-4)
    torch.testing.assert_close(dk, dp, rtol=0, atol=1e-4)
    reset = (ik == 0) & ~ak
    assert bool(reset.any()) and torch.equal(xk[reset], ct.flat.expand(int(reset.sum()), -1))


@pytest.mark.parametrize("net,delta_t,slots", [(anm6_network, 0.25, 16), (FEEDER20, 0.5, 16), (ieee33_network, 1.0, 12)],
                         ids=["anm6-16", "feeder20-16", "ieee33-12"])
def test_the_launcher_refuses_what_it_has_no_route_for(k2_emulated, net, delta_t, slots):
    """16 slots a block exist at n = 32 only, and no count but 8 and 16."""
    ct, args, x0 = _problem(net, delta_t, 4, 0)
    outs = chord_cuda.kernel_outputs(4, ct.n, "cpu")
    rc = k2_emulated.chord_newton_f32(*chord_cuda.kernel_args(args, ct, x0, outs),
                                      torch.zeros(1, dtype=torch.int32).data_ptr(), 4, ct.n, slots, None)
    assert rc != 0
