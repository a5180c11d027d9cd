"""K3's own CUDA source run on the CPU: ``gym_anm_torch/csrc/newton_fallback*``
compiled with g++ against a header that emulates the CUDA calls the kernel
makes (one std::thread per CUDA thread, ``std::barrier`` for
``__syncthreads``, ``__syncwarp`` and the named barriers, shuffles and
ballots through a slot array, atomics on the host), then held bit for bit
against the plain loop ``power_flow._newton_loop`` on the same inputs: x, F,
diff, n_iter and stall of every lane, at both widths of the 48- and 64-row
bodies (the kernel's own choice from the worklist's length, which the
emulation records and the tests check), both types, both Y sources, the
48-row body padded, a zero pivot and a tail of accepted lanes.

Source edits make the source host code (the launch syntax, the dynamic shared
memory, the cooperative launch, the named barrier's instruction, the
cluster's rank, barrier and mapa, the thread index's read, sinf/cosf
evaluated in float64 and rounded, as the plain side then does them too) or
record the width the kernel takes; the arithmetic is the kernel's own.  The plain side takes glibc's sin, cos and sqrt (torch's CPU
ones are not correctly rounded; CUDA's are where the card's plain version
uses them) and, in float32, the kernel's k-ordered float64 sums for Y V.
Needs g++ (C++20).
"""

import concurrent.futures
import ctypes
import math
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gym_anm_torch import _build
from gym_anm_torch.networks import anm6_network, ieee33_network
from gym_anm_torch.networks.random_feeder import random_radial_network
from gym_anm_torch.physics import newton_cuda, power_flow as pf
from gym_anm_torch.physics.linsolve_cuda import panel_smem_bytes, solve_gauss_jordan
from gym_anm_torch.physics.transition import make_tables
from gym_anm_torch.physics.ybus import LaneYbus
from gym_anm_torch.specs import load_network

torch.set_num_threads(2)

EMULATION = r"""
#pragma once
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(...)
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct uint3 { unsigned x, y, z; };
inline thread_local uint3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum { cudaDevAttrMultiProcessorCount = 16, cudaDevAttrL2CacheSize = 38, cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
struct float4 { float x, y, z, w; };
struct double2 { double x, y; };
struct int4 { int x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline double2 make_double2(double a, double b) { return {a, b}; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline double __dsqrt_rn(double a) { return std::sqrt(a); }
using std::copysign;
using std::fma;

struct WarpState { std::barrier<> bar{32}; uint64_t slot[32]; };
struct BlockState;
struct ClusterState {  // a thread-block cluster: its blocks and its barrier
  std::barrier<> bar;
  std::vector<BlockState*> blocks;
  explicit ClusterState(int threads) : bar(threads) {}
};
struct BlockState {
  std::barrier<> bar;
  std::vector<std::unique_ptr<WarpState>> warps;
  std::vector<unsigned char> smem;
  std::mutex named_mu;
  std::unique_ptr<std::barrier<>> named[16];  // bar.sync id, count: made by the first arrival
  BlockState(int threads, size_t bytes) : bar(threads), smem(bytes + 64) {
    for (int w = 0; w < threads / 32; ++w) warps.emplace_back(new WarpState);
  }
};
inline std::atomic<int> emulated_width{0};  // threads a row of the kernel's last Newton loop
extern "C" __attribute__((weak)) int emulated_width_read() { return emulated_width.load(); }
inline thread_local BlockState* tl_block;
inline thread_local ClusterState* tl_cluster;
inline thread_local int tl_rank;
inline WarpState& my_warp() { return *tl_block->warps[threadIdx.x / 32]; }
inline unsigned char* emulated_smem() {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(tl_block->smem.data()) + 15) & ~uintptr_t(15));
}
inline void __syncthreads() { tl_block->bar.arrive_and_wait(); }
inline int emulated_cluster_rank() { return tl_rank; }
inline void emulated_cluster_sync() { tl_cluster->bar.arrive_and_wait(); }
inline unsigned char* emulated_smem_of(BlockState* b) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(b->smem.data()) + 15) & ~uintptr_t(15));
}
// mapa: the same offset in the shared memory of block `rank` of the cluster.
inline unsigned long long emulated_cluster_map(unsigned long long p, int rank) {
  const uintptr_t off = static_cast<uintptr_t>(p) - reinterpret_cast<uintptr_t>(emulated_smem());
  return reinterpret_cast<uintptr_t>(emulated_smem_of(tl_cluster->blocks[rank])) + off;
}
inline void emulated_bar_sync(int id, int count) {
  std::barrier<>* b;
  {
    std::lock_guard<std::mutex> lock(tl_block->named_mu);
    if (!tl_block->named[id]) tl_block->named[id].reset(new std::barrier<>(count));
    b = tl_block->named[id].get();
  }
  b->arrive_and_wait();
}
inline void __syncwarp(unsigned = 0xffffffffu) { my_warp().bar.arrive_and_wait(); }
template <typename T> T __shfl_sync(unsigned, T v, int src, int = 32) {
  WarpState& w = my_warp();
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  w.slot[threadIdx.x & 31] = bits;
  w.bar.arrive_and_wait();
  const uint64_t r = w.slot[((src % 32) + 32) % 32];
  w.bar.arrive_and_wait();
  T out;
  std::memcpy(&out, &r, sizeof(T));
  return out;
}
template <typename T> T __shfl_down_sync(unsigned m, T v, unsigned d, int = 32) {
  const int src = static_cast<int>(threadIdx.x & 31) + static_cast<int>(d);
  return __shfl_sync(m, v, src < 32 ? src : static_cast<int>(threadIdx.x & 31));
}
template <typename T> T __shfl_xor_sync(unsigned m, T v, int o, int = 32) {
  return __shfl_sync(m, v, (threadIdx.x & 31) ^ o);
}
inline unsigned __ballot_sync(unsigned, int pred) {
  WarpState& w = my_warp();
  w.slot[threadIdx.x & 31] = pred ? 1 : 0;
  w.bar.arrive_and_wait();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= (w.slot[i] ? 1u : 0u) << i;
  w.bar.arrive_and_wait();
  return r;
}
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline unsigned __brev(unsigned v) {
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= ((v >> i) & 1u) << (31 - i);
  return r;
}
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline void __nanosleep(unsigned) { std::this_thread::yield(); }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
template <typename T> T __ldcg(const T* p) { return __atomic_load_n(p, __ATOMIC_SEQ_CST); }
template <typename T> T __ldg(const T* p) { return *p; }
template <typename K> cudaError_t cudaFuncSetAttribute(K, int, int) { return 0; }
template <typename K> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 1;
  return 0;
}
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
// Two SMs (a grid of two blocks), and less opt-in shared memory a block than
// an H100's 232448 bytes (by default 98304: K3 wide's float64 lanes at n = 78
// and 94 take the cluster route, float32 the resident route; the tests set
// other limits to reach the others).
inline int emulated_smem_optin = 98304;
extern "C" __attribute__((weak)) void emulated_set_smem_optin(int v) { emulated_smem_optin = v; }
// An L2 of 4096 bytes, which holds no blocked slot: the wrapper's batch rule
// keeps the cluster route unless a test sets a larger one.
inline int emulated_l2 = 4096;
extern "C" __attribute__((weak)) void emulated_set_l2(int v) { emulated_l2 = v; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int attr, int) {
  *v = attr == cudaDevAttrMaxSharedMemoryPerBlockOptin ? emulated_smem_optin
       : attr == cudaDevAttrL2CacheSize                ? emulated_l2
                                                       : 2;
  return 0;
}
enum cudaLaunchAttributeID { cudaLaunchAttributeCooperative = 2, cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  union { int cooperative; struct { unsigned x, y, z; } clusterDim; } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
inline int emulated_cluster_dim(const cudaLaunchConfig_t* cfg) {
  for (unsigned a = 0; a < cfg->numAttrs; ++a) {
    if (cfg->attrs[a].id == cudaLaunchAttributeClusterDimension) return static_cast<int>(cfg->attrs[a].val.clusterDim.x);
  }
  return 1;
}
// Clusters as a card of four SMs would hold them, one block an SM: two of
// two blocks, one of four.
template <typename K> cudaError_t cudaOccupancyMaxActiveClusters(int* n, K, const cudaLaunchConfig_t* cfg) {
  const int c = emulated_cluster_dim(cfg);
  *n = c <= 4 ? 4 / c : 0;
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
template <typename P>
cudaError_t emulated_launch(void (*kernel)(const P), dim3 grid, dim3 block, void** args, size_t smem, cudaStream_t,
                            int cluster = 1) {
  const P prm = *static_cast<P*>(args[0]);
  gridDim = grid;
  blockDim = block;
  std::vector<std::unique_ptr<BlockState>> blocks;
  std::vector<std::unique_ptr<ClusterState>> clusters;
  for (unsigned b = 0; b < grid.x; ++b) {
    blocks.emplace_back(new BlockState(block.x, smem));
    if (b % cluster == 0) clusters.emplace_back(new ClusterState(cluster * block.x));
    clusters.back()->blocks.push_back(blocks.back().get());
  }
  std::vector<std::thread> th;
  for (unsigned b = 0; b < grid.x; ++b) {
    for (unsigned t = 0; t < block.x; ++t) {
      th.emplace_back([&, b, t] {
        blockIdx = {b, 0, 0};
        threadIdx = {t, 0, 0};
        tl_block = blocks[b].get();
        tl_cluster = clusters[b / cluster].get();
        tl_rank = static_cast<int>(b % cluster);
        kernel(prm);
      });
    }
  }
  for (auto& x : th) x.join();
  return 0;
}
template <typename P>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(const P), const P& arg) {
  const int c = emulated_cluster_dim(cfg);
  if (c < 1 || cfg->gridDim.x % c != 0) return cudaErrorInvalidConfiguration;
  P prm = arg;
  void* args[] = {&prm};
  return emulated_launch(kernel, cfg->gridDim, cfg->blockDim, args, cfg->dynamicSmemBytes, cfg->stream, c);
}
"""

# The source edits that make the kernel host code: (file, pattern, replacement).
EDITS = (
    ("gauss_jordan.cuh", r"<<<.*?>>>", ""),
    ("newton_fallback.cuh", r"extern __shared__ __align__\(16\) unsigned char smem_raw\[\];",
     "unsigned char* smem_raw = emulated_smem();"),
    ("newton_fallback.cuh", r"cudaLaunchCooperativeKernel\(reinterpret_cast<const void\*>\(kernel\)",
     "emulated_launch(kernel"),
    ("newton_fallback.cuh", r'asm volatile\("bar\.sync %0, %1;" ::"r"\(bar\), "r"\(threads\) : "memory"\);',
     "emulated_bar_sync(bar, threads);"),
    ("newton_fallback.cuh", r"(newton_lanes<T, NP, BB::(TW_\w+), BB::G_\w+, kLaneY>\(P, count, smem_raw\);)",
     r"emulated_width.store(BB::\2); \1"),
    ("newton_fallback.cuh", r"return cosf\(a\);", "return static_cast<float>(std::cos(static_cast<double>(a)));"),
    ("newton_fallback.cuh", r"return sinf\(a\);", "return static_cast<float>(std::sin(static_cast<double>(a)));"),
    ("newton_fallback_wide.cuh", r"extern __shared__ __align__\(16\) unsigned char smem_raw\[\];",
     "unsigned char* smem_raw = emulated_smem();"),
    ("newton_fallback_wide.cuh", r"cudaLaunchCooperativeKernel\(reinterpret_cast<const void\*>\(kernel\)",
     "emulated_launch(kernel"),
    ("newton_fallback_wide.cuh", r'asm volatile\("mov\.u32 %0, %%cluster_ctarank;" : "=r"\(r\)\);',
     "r = emulated_cluster_rank();"),
    ("newton_fallback_wide.cuh", r'asm volatile\("mov\.u32 %0, %%tid\.x;" : "=r"\(t\)\);',
     "t = static_cast<int>(threadIdx.x);"),
    ("newton_fallback_wide.cuh", r'asm volatile\("barrier\.cluster\.arrive\.release\.aligned;\\n\\tbarrier\.cluster\.wait'
     r'\.acquire\.aligned;" ::: "memory"\);', "emulated_cluster_sync();"),
    ("newton_fallback_wide.cuh", r'asm volatile\("mapa\.u64 %0, %1, %2;" : "=l"\(a\) : "l"\(reinterpret_cast<unsigned '
     r'long long>\(p\)\), "r"\(rank\)\);', "a = emulated_cluster_map(reinterpret_cast<unsigned long long>(p), rank);"),
)


@pytest.fixture(scope="module")
def k3_emulated(tmp_path_factory):
    """The emulated K3 as a ctypes library (its entry points declared as the
    card build's)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the emulation")
    d = tmp_path_factory.mktemp("k3_emulation")
    (d / "cuda_runtime.h").write_text(EMULATION)
    units = sorted(_build.CSRC_DIR.glob("newton_fallback*.cu"))
    for f in units + [_build.CSRC_DIR / h for h in ("gauss_jordan.cuh", "newton_fallback.cuh",
                                                     "newton_fallback_wide.cuh")]:
        (d / f.name).write_text(f.read_text())
    for name, pattern, repl in EDITS:
        text = (d / name).read_text()
        text, count = re.subn(pattern, repl, text, flags=re.S)
        assert count > 0, f"the kernel's source changed: {pattern} is not in {name}"
        (d / name).write_text(text)
    flags = ["-x", "c++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-pthread", f"-I{d}",
             "-Wno-unknown-pragmas", "-Wno-attributes"]
    objs = [d / f"{u.stem}.o" for u in units]

    def build(unit, obj):
        return subprocess.run([gxx, *flags, "-c", str(d / unit.name), "-o", str(obj)], capture_output=True,
                              text=True, timeout=600)

    with concurrent.futures.ThreadPoolExecutor(len(units)) as pool:
        for proc in pool.map(build, units, objs):
            assert proc.returncode == 0, proc.stderr[-4000:]
    lib = d / "libk3_emulated.so"
    proc = subprocess.run([gxx, "-shared", "-pthread", "-o", str(lib), *map(str, objs)], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return _build.declare(ctypes.CDLL(str(lib)))


def _k3(lib, args, ybus):
    """One emulated launch on ``newton_fallback_cuda``'s arguments (CPU
    tensors): ((x, F, diff, n_iter, stall), the route that ran).  K3 wide
    launches through the wrapper's own ``newton_cuda.launch`` (its route,
    panel, grid and slots)."""
    x, F, diff, it, acc, p, q = args
    B, nb = p.shape
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    outs = [torch.empty_like(x), torch.empty_like(F), torch.empty_like(diff), torch.empty_like(it),
            torch.empty_like(it)]
    if isinstance(ybus, LaneYbus):
        tables = (ybus.f, ybus.t, ybus.series_re, ybus.series_im, ybus.shunt_im, ybus.shift_cos, ybus.shift_sin,
                  ybus.tap_magn)
        y_args = (None, None, 0) + tuple(ptr(t) for t in tables) + (ybus.f.shape[0],)
    else:
        y_args = (ptr(ybus[0]), ptr(ybus[1]), ybus[0].shape[-1] ** 2 if ybus[0].dim() == 3 else 0) + (None,) * 8 + (0,)
    acc8 = None if acc is None else acc.to(torch.uint8)
    cargs = (ptr(x), ptr(F), ptr(diff), ptr(it), ptr(acc8), ptr(p), ptr(q)) + y_args
    if 2 * nb > newton_cuda.REGS_MAX_N:
        kind = "lane_ybus" if isinstance(ybus, LaneYbus) else "dense"
        return outs, newton_cuda.launch(lib, kind, cargs, outs, B, nb, p.dtype, p.device, 1e-5, 100, None)
    scratch = torch.full((3 + B,), -1, dtype=torch.int32)  # the counters, then the worklist
    scratch[:3] = 0
    fn = lib.newton_fallback_f64 if p.dtype == torch.float64 else lib.newton_fallback_f32
    rc = fn(*cargs, 1e-5, 100, *(ptr(t) for t in outs), ptr(scratch), ptr(scratch) + 12, B, nb, None)
    assert rc == 0, f"the emulated K3 refused the launch ({rc})"
    return outs, "regs"


def _libm(fn, t):
    """``fn`` (a math function: glibc's, correctly rounded where torch's CPU
    one is not) on every entry of t, in float64, rounded to t's type."""
    vals = [fn(v) for v in t.reshape(-1).tolist()]
    return torch.tensor(vals, dtype=torch.float64).reshape(t.shape).to(t.dtype)


@pytest.fixture
def plain_as_the_card(monkeypatch):
    """The plain loop's numerics as on the card: correctly rounded sin, cos
    and sqrt, Y V in float32 as float64 sums in k order (the kernel's
    dot_full), in float64 in the fold's order."""
    def assemble_v(theta, vm):
        one, zero = torch.ones(*theta.shape[:-1], 1, dtype=theta.dtype), torch.zeros(*theta.shape[:-1], 1,
                                                                                      dtype=theta.dtype)
        return (torch.cat([one, vm * _libm(math.cos, theta)], dim=-1),
                torch.cat([zero, vm * _libm(math.sin, theta)], dim=-1))

    def dot(M, v):
        P = M.double() * v.double().unsqueeze(-2)
        if M.dtype == torch.float64:
            return pf._fold_sum(P)
        acc = torch.zeros(P.shape[:-1], dtype=torch.float64)
        for k in range(P.shape[-1]):
            acc = acc + P[..., k]
        return acc.to(M.dtype)

    def matvec(Yre, Yim, v_re, v_im):
        return dot(Yre, v_re) - dot(Yim, v_im), dot(Yre, v_im) + dot(Yim, v_re)

    monkeypatch.setattr(pf, "_assemble_v", assemble_v)
    monkeypatch.setattr(pf, "_ybus_matvec", matvec)
    monkeypatch.setattr(torch, "sqrt", lambda t: _libm(math.sqrt, t))


def _lanes(net, dtype, B, seed):
    """IEEE33 (random OLTC taps) or ANM6 lanes: (tables, LaneYbus, p, q, the
    four bad-basin guesses tiled)."""
    spec, delta_t = {"ieee33": (ieee33_network, 1.0), "anm6": (anm6_network, 0.25)}[net]
    tb = make_tables(load_network(spec), delta_t, 100, dtype=dtype, device="cpu")
    n = tb.n_bus - 1
    rng = np.random.default_rng(seed)
    tap = tb.tap0.expand(B, -1).clone()
    if len(tb.oltc_branch):
        tap[:, tb.oltc_branch] = torch.tensor(rng.uniform(0.9, 1.1, (B, 1)), dtype=dtype)
    p = -(0.01 if n > 8 else 0.0025) * (1.0 + torch.tensor(rng.random((B, n)), dtype=dtype))
    pats = torch.tensor([[0.0] * n + [1e-6] * n, [0.0] * n + [-1.0] * n, [30.0] * n + [1.0] * n,
                         [0.0] * n + [1e15] * n], dtype=dtype)
    ybus = LaneYbus(tb.n_bus, tb.br_f, tb.br_t, tb.series_re, tb.series_im, tb.shunt_im, tb.shift_cos,
                    tb.shift_sin, tap)
    return tb, ybus, p, 0.5 * p, pats.repeat(B // 4 + 1, 1)[:B].contiguous()


def _chord(tb, ybus, p, q, x0):
    B = p.shape[0]
    if tb.chord_has_oltc:
        inv_da = 1.0 / ybus.tap_magn[:, int(tb.oltc_branch[0])] - 1.0 / tb.chord_a0
        dr, di = -tb.chord_y_re * inv_da, -tb.chord_y_im * inv_da
    else:
        dr = di = torch.zeros(B, dtype=p.dtype)
    chord = pf.chord_solve if p.dtype == torch.float32 else pf.chord_solve_plain
    return tuple(t.contiguous() for t in chord(p, q, di, dr, dr, di, tb.chord_t, x0=x0))


def _flat(p, q, Y):
    x = torch.cat([torch.zeros_like(p), torch.ones_like(p)], dim=1)
    F, _ = pf._mismatch(x, p, q, *Y, p.shape[1])
    return (x, F, torch.amax(F.abs(), dim=1), torch.zeros(p.shape[0], dtype=torch.int32), None, p, q)


def _bitwise(lib, args, ybus, plain_ybus, width, route="regs"):
    """The emulated kernel and the plain loop bitwise on every lane, the
    kernel's Newton loop at ``width`` threads a row (K3) or on ``route`` (K3
    wide: ``width`` None)."""
    x, F, diff, it, acc, p, q = args
    acc0 = torch.zeros(x.shape[0], dtype=torch.bool) if acc is None else acc
    out_p = pf._newton_loop(x, F, diff, it, ~acc0, plain_ybus, p, q, 1e-5, 100, p.dtype == torch.float32,
                            solve_gauss_jordan)
    lib.emulated_width_read.restype = ctypes.c_int
    out_k, ran = _k3(lib, args, ybus)
    assert ran == route, f"the kernel ran route {ran}, not {route}"
    if width is not None:
        assert lib.emulated_width_read() == width, "the kernel took another width"
    for a, b in zip(out_k, out_p):
        same = (a == b) | (torch.isnan(a) & torch.isnan(b)) if a.is_floating_point() else a == b
        assert bool(same.all()), f"width {width}: the kernel and the plain loop differ"
    assert bool((out_p[3] > it).any()), "no lane iterated"
    return out_p


# The emulation's card: 2 SMs, a block of each body an SM.  The 64-row body
# then holds 2 lanes at once at 4 threads a row in float64 (a group of 8
# warps in a block of 3 groups of 4), 4 in float32 (2 of 8 in 4 of 4).
WIDE_CAPACITY = {torch.float32: 4, torch.float64: 2}


@pytest.mark.parametrize("net", ["ieee33", "anm6"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_bad", [1, 4, 6])
def test_emulated_k3_after_the_chord_with_the_lane_ybus(k3_emulated, plain_as_the_card, net, dtype, n_bad):
    """The chord's exit from bad-basin guesses on ``n_bad`` of 6 lanes, Y
    from the LaneYbus, the others accepted by the chord from the flat start
    (a tail): at n = 64, 4 threads a row where the lanes that iterate fit
    the grid's groups of that width, else 2."""
    tb, ybus, p, q, x0 = _lanes(net, dtype, 6, 3)
    bad, good = _chord(tb, ybus, p, q, x0), _chord(tb, ybus, p, q, None)
    assert bool(good[4].all()) and not bool(bad[4].any())
    pick = torch.arange(6) % 3 != 0 if n_bad == 4 else torch.arange(6) < n_bad
    init = tuple(torch.where(pick.view(-1, *[1] * (u.dim() - 1)), u, v).contiguous() for u, v in zip(bad, good))
    n = 2 * (tb.n_bus - 1)
    width = 32 // n if n <= 32 else (4 if n_bad <= WIDE_CAPACITY[dtype] else 2)
    _bitwise(k3_emulated, init + (p, q), ybus, ybus, width)


@pytest.mark.parametrize("net", ["ieee33", "anm6"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_emulated_k3_from_the_flat_start_with_a_dense_y(k3_emulated, plain_as_the_card, net, dtype):
    """nr_solve's route: the flat start, a dense Y per lane, lane 1's Y zero
    (a zero pivot: non-finite in both)."""
    tb, ybus, p, q, _ = _lanes(net, dtype, 3, 4)
    Yre, Yim = ybus(slice(None))
    Yre[1], Yim[1] = 0.0, 0.0
    n = 2 * (tb.n_bus - 1)
    width = 32 // n if n <= 32 else (4 if 3 <= WIDE_CAPACITY[dtype] else 2)
    out = _bitwise(k3_emulated, _flat(p, q, (Yre, Yim)), (Yre, Yim), lambda idx: (Yre[idx], Yim[idx]), width)
    assert not bool(torch.isfinite(out[0][1]).all())


@pytest.mark.parametrize("n_bus,B,width", [(2, 3, 16), (12, 3, 1), (21, 3, 4), (21, 9, 2)])
def test_emulated_k3_on_random_feeders(k3_emulated, plain_as_the_card, n_bus, B, width):
    """A random feeder of the JAX property test's generator at n = 2 (16
    threads a row), 22 (a row a thread) and 40 (the 48-row body, padded:
    float64 holds 4 lanes at once at 4 threads a row on the emulation's
    card, so 3 lanes take 4 and 9 take 2), float64 from the flat start with
    one Y broadcast to every lane."""
    tb = make_tables(load_network(random_radial_network(np.random.default_rng(n_bus), n_bus)), 1.0, 100,
                     dtype=torch.float64, device="cpu")
    nb = tb.n_bus - 1
    Y = (tb.chord_t.Y0re.contiguous(), tb.chord_t.Y0im.contiguous())
    p = -0.02 * (1.0 + torch.tensor(np.random.default_rng(n_bus).random((B, nb))))
    _bitwise(k3_emulated, _flat(p, 0.5 * p, Y), Y, lambda idx: Y, width)


# K3 wide: random feeders of 40 and 48 buses (n = 78 and 94).  On the
# emulated card (98304 bytes of opt-in shared memory a block) float32 takes
# the resident route (panels of 16 at n = 78, 8 at 94) and float64 the
# device-memory route (panels of 16), as the wrapper's k1_route rule gives.
WIDE_ROUTES = {torch.float32: "smem", torch.float64: "cluster"}


def _feeder_lanes(n_bus, dtype, B, seed):
    """A random feeder of the JAX property test's generator and B lanes on
    it: (tables, LaneYbus with random taps on the OLTC branch where there is
    one, p, q, the bad-basin guesses tiled)."""
    net = random_radial_network(np.random.default_rng(n_bus), n_bus)
    tb = make_tables(load_network(net), 1.0, 100, dtype=dtype, device="cpu")
    nb = tb.n_bus - 1
    rng = np.random.default_rng(seed)
    tap = tb.tap0.expand(B, -1).clone()
    if len(tb.oltc_branch):
        tap[:, tb.oltc_branch] = torch.tensor(rng.uniform(0.95, 1.05, (B, 1)), dtype=dtype)
    p = -0.004 * (1.0 + torch.tensor(rng.random((B, nb)), dtype=dtype))
    pats = torch.tensor([[0.0] * nb + [1e-6] * nb, [0.0] * nb + [-1.0] * nb, [30.0] * nb + [1.0] * nb,
                         [0.0] * nb + [1e15] * nb], dtype=dtype)
    ybus = LaneYbus(tb.n_bus, tb.br_f, tb.br_t, tb.series_re, tb.series_im, tb.shunt_im, tb.shift_cos,
                    tb.shift_sin, tap)
    return tb, ybus, p, 0.5 * p, pats.repeat(B // 4 + 1, 1)[:B].contiguous()


@pytest.mark.parametrize("n_bus", [40, 48])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_emulated_k3_wide_after_the_chord_with_the_lane_ybus(k3_emulated, plain_as_the_card, n_bus, dtype):
    """The chord's exit from bad-basin guesses on 3 lanes, Y from the
    LaneYbus (built in the block's slot, after [J | F] on the device-memory
    route): bitwise the plain loop."""
    tb, ybus, p, q, x0 = _feeder_lanes(n_bus, dtype, 3, 5)
    init = _chord(tb, ybus, p, q, x0)
    assert not bool(init[4].any())
    _bitwise(k3_emulated, init + (p, q), ybus, ybus, None, WIDE_ROUTES[dtype])


@pytest.mark.parametrize("n_bus", [40, 48])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_emulated_k3_wide_from_the_flat_start_with_a_dense_y(k3_emulated, plain_as_the_card, n_bus, dtype):
    """nr_solve's route: the flat start, a dense Y per lane read in place,
    lane 1's Y zero (a zero pivot: non-finite in both)."""
    tb, ybus, p, q, _ = _feeder_lanes(n_bus, dtype, 3, 6)
    Yre, Yim = ybus(slice(None))
    Yre[1], Yim[1] = 0.0, 0.0
    out = _bitwise(k3_emulated, _flat(p, q, (Yre, Yim)), (Yre, Yim), lambda idx: (Yre[idx], Yim[idx]), None,
                   WIDE_ROUTES[dtype])
    assert not bool(torch.isfinite(out[0][1]).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_emulated_k3_wide_tail(k3_emulated, plain_as_the_card, dtype):
    """The tail: one lane of bad-basin guesses among five the chord accepted
    from the flat start (the triage passes them through), on the 48-bus
    feeder with the LaneYbus."""
    tb, ybus, p, q, x0 = _feeder_lanes(48, dtype, 6, 7)
    bad, good = _chord(tb, ybus, p, q, x0), _chord(tb, ybus, p, q, None)
    assert bool(good[4].all()) and not bool(bad[4][2])
    pick = torch.arange(6) == 2
    init = tuple(torch.where(pick.view(-1, *[1] * (u.dim() - 1)), u, v).contiguous() for u, v in zip(bad, good))
    out = _bitwise(k3_emulated, init + (p, q), ybus, ybus, None, WIDE_ROUTES[dtype])
    assert torch.equal(out[3][~pick], good[3][~pick])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_emulated_k3_wide_shared_memory_and_grid(k3_emulated, dtype):
    """The kernel's shared memory a block is the wrapper's sum (K1's panels
    and matrix, then ``wide_lane_bytes``) at every panel and route the rule
    picks; the grid is the emulated card's (one block an SM, two SMs); a
    panel the kernel has no body for is refused."""
    lib, f64, item = k3_emulated, int(dtype == torch.float64), dtype.itemsize
    for n in (66, 78, 94, 258):
        for panel in (8, 16):
            for resident in (True, False):
                want = panel_smem_bytes(n, item, panel, resident) + newton_cuda.wide_lane_bytes(n, item)
                assert lib.newton_wide_smem_bytes(f64, n, panel, int(resident)) == want
    assert lib.newton_wide_smem_limit() == 98304
    assert lib.newton_wide_grid(f64, 94, 16, 0, 1) == 2
    assert (lib.newton_wide_grid(f64, 94, 32, 0, 0) > 0) == (dtype == torch.float32)
    assert lib.newton_wide_grid(f64, 94, 32, 1, 0) < 0 and lib.newton_wide_grid(f64, 64, 8, 0, 0) < 0


@pytest.fixture
def emulated_smem(k3_emulated):
    """Sets the emulated card's opt-in shared memory a block (the wrapper's
    plans, cached by size, cleared with it); 98304 bytes again after the
    test."""
    k3_emulated.emulated_set_smem_optin.argtypes = [ctypes.c_int]

    def set_limit(v):
        k3_emulated.emulated_set_smem_optin(v)
        newton_cuda.wide_plans.cache_clear()

    yield set_limit
    set_limit(98304)


# K3 wide's other routes, through the wrapper on a card of less opt-in
# shared memory a block: at 40000 bytes float32 takes clusters of 2 (panels
# of 16) at n = 78 and 94 and float64 clusters of 4 (panels of 8); at 24576
# float64 the device-memory route.
@pytest.mark.parametrize("n_bus", [40, 48])
@pytest.mark.parametrize("dtype,limit,route,cluster", [
    (torch.float32, 40000, "cluster", 2), (torch.float64, 40000, "cluster", 4), (torch.float64, 24576, "blocked", 1)])
def test_emulated_k3_wide_routes_by_shared_memory(k3_emulated, plain_as_the_card, emulated_smem, n_bus, dtype, limit,
                                                  route, cluster):
    """Bitwise the plain loop on the route and cluster the wrapper picks for
    the card: after the chord from bad-basin guesses on 2 lanes with the
    LaneYbus (each block of a cluster builds the lane's Y in its slot), and
    from the flat start with a dense Y on 2 lanes."""
    emulated_smem(limit)
    got = newton_cuda.wide_route(2 * (n_bus - 1), dtype, limit)
    assert (got[0], got[2]) == (route, cluster)
    tb, ybus, p, q, x0 = _feeder_lanes(n_bus, dtype, 2, 8)
    _bitwise(k3_emulated, _chord(tb, ybus, p, q, x0) + (p, q), ybus, ybus, None, route)
    Yre, Yim = ybus(slice(None))
    _bitwise(k3_emulated, _flat(p, q, (Yre, Yim)), (Yre, Yim), lambda idx: (Yre[idx], Yim[idx]), None, route)



@pytest.fixture
def emulated_l2(k3_emulated):
    """Sets the emulated card's L2 bytes (the wrapper's plans cleared with
    it); 4096 again after the test."""
    k3_emulated.emulated_set_l2.argtypes = [ctypes.c_int]

    def set_l2(v):
        k3_emulated.emulated_set_l2(v)
        newton_cuda.wide_plans.cache_clear()

    yield set_l2
    set_l2(4096)


@pytest.mark.parametrize("B,route", [(2, "cluster"), (3, "blocked")])
def test_emulated_k3_wide_routes_by_batch(k3_emulated, plain_as_the_card, emulated_l2, B, route):
    """``batch_route`` through the wrapper: float64 at 48 buses, on clusters
    of 2 on the emulated card (two at once), with an L2 of 16 MiB, which
    holds the blocked route's two slots: 2 lanes stay on the clusters, 3
    (more than they hold at once) go a block a lane in device memory;
    bitwise the plain loop after the chord from bad-basin guesses with the
    LaneYbus."""
    emulated_l2(1 << 24)
    tb, ybus, p, q, x0 = _feeder_lanes(48, torch.float64, B, 10)
    _bitwise(k3_emulated, _chord(tb, ybus, p, q, x0) + (p, q), ybus, ybus, None, route)

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_emulated_k3_wide_cluster_shared_memory_and_grid(k3_emulated, monkeypatch, dtype):
    """The cluster route's shared memory a block is the wrapper's sum
    (``cluster_smem_bytes``) at every size, panel and cluster; the grid is
    the emulated card's clusters (two of 2 blocks, one of 4, none of 8); a
    panel without a body, K3's sizes and a grid above the capacity are
    refused, and the wrapper raises on a refused launch."""
    lib, f64, item = k3_emulated, int(dtype == torch.float64), dtype.itemsize
    for n in (66, 78, 94, 126, 258):
        for panel in (8, 16):
            for cluster in (2, 4, 8):
                want = newton_cuda.cluster_smem_bytes(n, item, panel, cluster)
                assert lib.newton_cluster_smem_bytes(f64, n, panel, cluster) == want
    assert lib.newton_cluster_grid(f64, 94, 8, 2, 1) == 2 and lib.newton_cluster_grid(f64, 94, 8, 4, 0) == 1
    assert lib.newton_cluster_grid(f64, 94, 8, 8, 0) < 0 and lib.newton_cluster_grid(f64, 94, 32, 2, 0) < 0
    assert lib.newton_cluster_grid(f64, 64, 8, 2, 0) < 0
    tb, ybus, p, q, _ = _feeder_lanes(48, dtype, 3, 9)
    Yre, Yim = ybus(slice(None))
    blocked = (16, 1, 2)
    for plan in ((8, 2, 3), (8, 8, 3)):  # 3 clusters of 2, or any of 8: more than the card holds
        plans = ("cluster", {"cluster": plan, "blocked": blocked}, 4096)
        monkeypatch.setattr(newton_cuda, "wide_plans", lambda *a, plans=plans: plans)
        with pytest.raises(RuntimeError, match="launch failed .*route cluster"):
            _k3(lib, _flat(p, q, (Yre, Yim)), (Yre, Yim))
