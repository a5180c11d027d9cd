// K3's device code (csrc/newton_fallback.cu describes the kernel): a
// coalesced triage pass over every lane, a grid barrier, then the exact
// Newton loop of the lanes that iterate, taken from a device worklist by
// groups of threads that spread each lane's system over TW threads a row.
// Four translation units instantiate it, so that nvcc builds the bodies in
// parallel: newton_fallback_f32.cu and newton_fallback_f64.cu (n = 2..26 and
// the 48-row body) and newton_fallback_f32_high.cu and
// newton_fallback_f64_high.cu (n = 28..32 and the 64-row body);
// newton_fallback.cu holds the entry points.

#pragma once

#include <math.h>
#include <stdint.h>

#include "gauss_jordan.cuh"

namespace {

constexpr unsigned kWarpMask = 0xffffffffu;
constexpr int kStallLimit = 3;    // power_flow.py:_STALL_LIMIT, the float32 tier's plateau rule
constexpr int kSmallGroups = 4;   // lanes (one a warp) a block of the bodies to n = 32 holds at once

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float cos_of(float a) { return cosf(a); }
__device__ __forceinline__ double cos_of(double a) { return cos(a); }
__device__ __forceinline__ float sin_of(float a) { return sinf(a); }
__device__ __forceinline__ double sin_of(double a) { return sin(a); }
__device__ __forceinline__ float abs_of(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_of(double a) { return fabs(a); }

// The larger of a and b, NaN if either is (torch.amax's rule).
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a > b || a != a) ? a : b;
}

// The sum of y[k] v[k] over the leaves k = J + m STRIDE (m < W) below N, as
// power_flow.py:_fold_sum sums it: the products padded with zeros to W, then
// the halves added until one is left, each sum rounded on its own.  The left
// half of a node is its even leaves, the right half its odd ones.
template <int W, int J, int STRIDE>
__device__ __forceinline__ double fold_node(const double* y, const double* v, int N) {
  if constexpr (W == 1) {
    return J < N ? __dmul_rn(y[J], v[J]) : 0.0;
  } else {
    return __dadd_rn(fold_node<W / 2, J, 2 * STRIDE>(y, v, N), fold_node<W / 2, J + STRIDE, 2 * STRIDE>(y, v, N));
  }
}

__host__ __device__ constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }

// The sum over k < N <= NMAX of y[k] v[k]: in float32 as
// complexops.py:matmul_full forms it (float64 sums of exact products,
// rounded once; summed in k order, cuBLAS may sum in another, which moves a
// float32 rounding rarely); in float64 in power_flow.py:_fold_sum's order.
template <int NMAX>
__device__ __forceinline__ float dot_full(const float* y, const float* v, int N) {
  double acc = 0.0;
  for (int k = 0; k < N; ++k) acc = fma(static_cast<double>(y[k]), static_cast<double>(v[k]), acc);
  return static_cast<float>(acc);
}
template <int NMAX>
__device__ __forceinline__ double dot_full(const double* y, const double* v, int N) {
  return fold_node<pow2_at_least(NMAX), 0, 1>(y, v, N);
}

// What a launch reads and writes; n = 2 nb unknowns a lane, N = nb + 1 buses.
template <typename T>
struct NewtonParams {
  const T* x_in;                  // [B, n]  the start: the chord's exit, or the flat start
  const T* F_in;                  // [B, n]  its mismatch
  const T* diff_in;               // [B]     its max |F|
  const int* it_in;               // [B]     iterations so far
  const unsigned char* accepted;  // [B], or nullptr where no lane is
  const T* p;                     // [B, nb]
  const T* q;                     // [B, nb]
  const T* Yre;                   // dense source: [B, N, N] (y_stride N^2) or [N, N] (y_stride 0)
  const T* Yim;
  long long y_stride;
  const long long* br_f;          // lane source (ybus.py:LaneYbus): [Ne] from and to buses,
  const long long* br_t;
  const T* series_re;             // [Ne] the branch tables,
  const T* series_im;
  const T* shunt_im;
  const T* shift_cos;
  const T* shift_sin;
  const T* tap_magn;              // [B, Ne] and each lane's taps
  int n_branch;
  T xtol;
  int lim_iter;
  T* x;                           // [B, n]
  T* F;                           // [B, n]
  T* diff;                        // [B]
  int* n_iter;                    // [B]
  int* stall;                     // [B]
  int* counters;                  // [3] zeroed by the wrapper: worklist length, next item, barrier arrivals
  int* work;                      // [B] the worklist: the lanes that iterate
  int B, nb;
};

// A lane's system at body size NP spread over TW threads a row: thread
// (r, t) holds the columns t, t + TW, t + 2 TW, ... (S of them; those from
// NP + 1 on are padding) of row r of the augmented matrix [J | F], so sweep
// k's pivot column lives in thread k % TW's register k / TW, a static index
// when sweeps run in rounds u = k / TW.
template <typename T, int NP, int TW>
struct Spread {
  static constexpr int W = NP + 1;                             // augmented columns
  static constexpr int S = (W + TW - 1) / TW;                  // columns a thread holds
  static constexpr int U = (NP + TW - 1) / TW;                 // sweep rounds
  static constexpr int V = 16 / sizeof(T);                     // entries of a 16-byte access
  static constexpr int SP = (S + V - 1) / V * V;               // a thread's segment of a pivot-row buffer
  static constexpr int THREADS = (NP * TW + 31) / 32 * 32;     // a group
  static constexpr int GW = THREADS / 32;                      // its warps
  static constexpr int NMAX = NP / 2 + 1;                      // buses
  static constexpr int YS = NMAX * NMAX;
  static constexpr int PB = 2 * TW * SP;                       // the pivot-row buffers, by sweep parity
  // A group's shared memory: the pivot-row buffers (16-byte aligned), its
  // lane's Y-bus Yre, Yim [N][N], V, V / |V| and Y V, its x, the max's
  // scratch (a warp each).
  static constexpr int SLOT = (PB + 2 * YS + 6 * NMAX + NP + GW + V - 1) / V * V;
  // Registers a thread: its segment's and ~80 more.
  static constexpr int REGS = S * static_cast<int>(sizeof(T) / 4) + 80;
};

// The block of body NP.  Up to n = 32 a group is one warp, TW = floor(32 /
// NP) threads a row (3 at ANM6's n = 10), kSmallGroups groups a block, as
// many blocks an SM as fit by registers.  The 48- and 64-row bodies (n =
// 34..64, IEEE33's 64) run one block an SM of G_LO groups at 2 threads a row
// (as many as fit by registers: 4 at float32 n = 64, 3 at float64), or, where
// the lanes that iterate all fit the grid at once at 4 threads a row, G_HI =
// G_LO / 2 groups at 4 (8 warps a lane at n = 64, its sweeps on all four of
// an SM's schedulers): the kernel picks after the triage, from the
// worklist's length.  A group's threads meet at the warp's barrier, or at the
// group's named barrier.
template <typename T, int NP>
struct Body {
  static constexpr bool WIDE = NP > 32;
  static constexpr int TW_LO = WIDE ? 2 : 32 / NP;
  static constexpr int TW_HI = WIDE ? 4 : TW_LO;
  using LO = Spread<T, NP, TW_LO>;
  using HI = Spread<T, NP, TW_HI>;
  // Warps a scheduler holds by registers (its quarter of the SM's 64 K,
  // the block's warps dealt round the four), then the groups of 2 threads a
  // row that fill all four schedulers' share.
  static constexpr int PART = 512 / LO::REGS;
  static constexpr int FIT = 4 * PART / LO::GW;
  static constexpr int G_LO = WIDE ? (FIT < 1 ? 1 : FIT) : kSmallGroups;
  static constexpr int G_HI = WIDE ? G_LO * LO::THREADS / HI::THREADS : G_LO;
  static constexpr int BLOCK = G_LO * LO::THREADS;
  static_assert(BLOCK <= 1024 && G_HI >= 1 && G_LO <= 15, "a block of groups with a named barrier each");
  static constexpr int SMALL_FIT = 65536 / (BLOCK * LO::REGS);
  static constexpr int MIN_BLOCKS = WIDE ? 1 : (SMALL_FIT < 1 ? 1 : (SMALL_FIT > 8 ? 8 : SMALL_FIT));
  static constexpr int SLOTS = G_LO * LO::SLOT > G_HI * HI::SLOT ? G_LO * LO::SLOT : G_HI * HI::SLOT;
  // The groups' slots, then an int a group (the claim's broadcast).
  static constexpr size_t BYTES = sizeof(T) * static_cast<size_t>(SLOTS) + sizeof(int) * G_LO;
};

// The threads of a group meet here: the warp, or the group's named barrier
// `bar` (1 + the group's index in its block).
__device__ __forceinline__ void bar_sync(int bar, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(threads) : "memory");
}
template <int GW>
__device__ __forceinline__ void group_sync(int bar) {
  if constexpr (GW == 1) {
    __syncwarp();
  } else {
    bar_sync(bar, 32 * GW);
  }
}

// The group's next worklist item (count: none left), the same in each of
// its threads; once the worklist is taken a group leaves on a read, without
// an atomic.
template <int GW>
__device__ __forceinline__ int claim(int* head, int count, int* cell, int g, int bar) {
  if constexpr (GW == 1) {
    int c = 0;
    if (g == 0) c = __ldcg(head) >= count ? count : atomicAdd(head, 1);
    return __shfl_sync(kWarpMask, c, 0);
  } else {
    if (g == 0) *cell = __ldcg(head) >= count ? count : atomicAdd(head, 1);
    group_sync<GW>(bar);
    const int c = *cell;
    group_sync<GW>(bar);  // read by all before the next claim writes it
    return c;
  }
}

// Every block of the grid meets here.  The launch is cooperative, so every
// block is resident and the arrivals counted in device memory can be awaited;
// a grid of one block needs only its own barrier.
__device__ __forceinline__ void grid_barrier(int* arrive) {
  __syncthreads();
  if (gridDim.x > 1 && threadIdx.x == 0) {
    __threadfence();
    atomicAdd(arrive, 1);
    while (*reinterpret_cast<volatile int*>(arrive) < static_cast<int>(gridDim.x)) __nanosleep(32);
    __threadfence();
  }
  if (gridDim.x > 1) __syncthreads();
}

// dst[e] = src[e] for e < cnt, by the grid's threads, in 16-byte vectors where
// both are aligned (bit copies).
template <typename T>
__device__ __forceinline__ void copy_flat(const T* src, T* dst, long long cnt, long long tid, long long nthr) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  const long long nvec = vec ? cnt / V : 0;
  for (long long i = tid; i < nvec; i += nthr) {
    reinterpret_cast<int4*>(dst)[i] = reinterpret_cast<const int4*>(src)[i];
  }
  for (long long e = V * nvec + tid; e < cnt; e += nthr) dst[e] = src[e];
}

// copy_flat of two arrays of cnt entries at once, in rounds of kUnroll
// vectors of each a thread: every load of a round is issued before its
// stores, and the last round is predicated, so that a thread waits on
// memory once a round (the cluster route's grid has an eighth of K3's
// threads an SM).
template <typename T, int kUnroll>
__device__ __forceinline__ void copy_flat2(const T* sa, T* da, const T* sb, T* db, long long cnt, long long tid,
                                           long long nthr) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = ((reinterpret_cast<uintptr_t>(sa) | reinterpret_cast<uintptr_t>(da) |
                     reinterpret_cast<uintptr_t>(sb) | reinterpret_cast<uintptr_t>(db)) & 15) == 0;
  if (!vec) {
    copy_flat(sa, da, cnt, tid, nthr);
    copy_flat(sb, db, cnt, tid, nthr);
    return;
  }
  const long long nvec = cnt / V;
  for (long long i = tid; i < nvec; i += kUnroll * nthr) {
    int4 va[kUnroll], vb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i + u * nthr < nvec) {
        va[u] = reinterpret_cast<const int4*>(sa)[i + u * nthr];
        vb[u] = reinterpret_cast<const int4*>(sb)[i + u * nthr];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i + u * nthr < nvec) {
        reinterpret_cast<int4*>(da)[i + u * nthr] = va[u];
        reinterpret_cast<int4*>(db)[i + u * nthr] = vb[u];
      }
    }
  }
  for (long long e = V * nvec + tid; e < cnt; e += nthr) {
    da[e] = sa[e];
    db[e] = sb[e];
  }
}

// The triage, by every thread of the grid: a lane a thread reads its flags;
// a lane that does not iterate (accepted, within xtol, out of iterations or
// NaN) gets its diff, n_iter and a stall count of 0, a lane that iterates
// joins the worklist (one atomic a warp); x and F are copied through for
// every lane (the worklist's lanes are overwritten at their exit).
template <typename T, int kCopyUnroll = 1>
__device__ __forceinline__ void triage(const NewtonParams<T>& P, int n) {
  const long long nthr = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  for (long long b0 = tid - lane; b0 < P.B; b0 += nthr) {  // warp-uniform
    const long long b = b0 + lane;
    bool go = false;
    if (b < P.B) {
      const bool acc = P.accepted != nullptr && P.accepted[b] != 0;
      const T d0 = P.diff_in[b];
      const int i0 = P.it_in[b];
      go = !acc && d0 > P.xtol && i0 < P.lim_iter;  // false on a NaN residual, as in the reference
      if (!go) {
        P.diff[b] = d0;
        P.n_iter[b] = i0;
        P.stall[b] = 0;
      }
    }
    const unsigned vote = __ballot_sync(kWarpMask, go);
    if (vote != 0) {
      int base = 0;
      if (lane == 0) base = atomicAdd(P.counters, __popc(vote));
      base = __shfl_sync(kWarpMask, base, 0);
      if (go) P.work[base + __popc(vote & ((1u << lane) - 1u))] = static_cast<int>(b);
    }
  }
  const long long cnt = static_cast<long long>(P.B) * n;
  if constexpr (kCopyUnroll > 1) {
    copy_flat2<T, kCopyUnroll>(P.x_in, P.x, P.F_in, P.F, cnt, tid, nthr);
  } else {
    copy_flat(P.x_in, P.x, cnt, tid, nthr);
    copy_flat(P.F_in, P.F, cnt, tid, nthr);
  }
}

// Lane b's Y-bus from the branch tables, in a slot whose Y is zero, by the
// slot's threads (tid < nthr): ybus.py:build_ybus operation for operation,
// -y / conj(tau) and -y / tau by complexops.py:cdiv, and the diagonal as
// the per-bus sums over the incident branches, in branch order, in float64,
// rounded to T (build_ybus's one-hot incidence products).  kUnroll: the
// branches of the diagonal's loop in flight (K3's 4; the wide bodies take 1,
// so that it needs no more registers than their sweeps).
template <typename T, int kUnroll = 4>
__device__ __forceinline__ void lane_ybus(const NewtonParams<T>& P, int b, int N, T* Yr, T* Yi, int tid, int nthr) {
  const int Ne = P.n_branch;
  const T* tap = P.tap_magn + static_cast<long long>(b) * Ne;
  for (int e = tid; e < Ne; e += nthr) {  // no parallel branches: each entry is written once
    const T a = tap[e];
    const T tr = mul_rn(a, P.shift_cos[e]), ti = mul_rn(a, P.shift_sin[e]), mti = -ti;
    const T ar = -P.series_re[e], ai = -P.series_im[e];
    const T d1 = add_rn(mul_rn(tr, tr), mul_rn(mti, mti));  // cdiv(ar, ai, tr, -ti)
    const T ft_re = div_rn(add_rn(mul_rn(ar, tr), mul_rn(ai, mti)), d1);
    const T ft_im = div_rn(sub_rn(mul_rn(ai, tr), mul_rn(ar, mti)), d1);
    const T d2 = add_rn(mul_rn(tr, tr), mul_rn(ti, ti));  // cdiv(ar, ai, tr, ti)
    const T tf_re = div_rn(add_rn(mul_rn(ar, tr), mul_rn(ai, ti)), d2);
    const T tf_im = div_rn(sub_rn(mul_rn(ai, tr), mul_rn(ar, ti)), d2);
    const int f = static_cast<int>(P.br_f[e]), t = static_cast<int>(P.br_t[e]);
    Yr[f * N + t] = ft_re;
    Yi[f * N + t] = ft_im;
    Yr[t * N + f] = tf_re;
    Yi[t * N + f] = tf_im;
  }
  for (int k = tid; k < N; k += nthr) {
    // Every branch's terms formed and selected where it is incident (no
    // branch that skips), so that the loads of successive branches overlap.
    double f_re = 0.0, f_im = 0.0, t_re = 0.0, t_im = 0.0;
#pragma unroll (kUnroll)
    for (int e = 0; e < Ne; ++e) {
      const bool from = __ldg(P.br_f + e) == k, to = __ldg(P.br_t + e) == k;
      const T tot_re = __ldg(P.series_re + e), tot_im = add_rn(__ldg(P.series_im + e), __ldg(P.shunt_im + e));
      const T a2 = mul_rn(__ldg(tap + e), __ldg(tap + e));  // (y + y_sh) / a^2 from, y + y_sh to
      const T q_re = div_rn(tot_re, a2), q_im = div_rn(tot_im, a2);
      f_re = from ? __dadd_rn(f_re, static_cast<double>(q_re)) : f_re;
      f_im = from ? __dadd_rn(f_im, static_cast<double>(q_im)) : f_im;
      t_re = to ? __dadd_rn(t_re, static_cast<double>(tot_re)) : t_re;
      t_im = to ? __dadd_rn(t_im, static_cast<double>(tot_im)) : t_im;
    }
    Yr[k * N + k] = add_rn(static_cast<T>(f_re), static_cast<T>(t_re));
    Yi[k * N + k] = add_rn(static_cast<T>(f_im), static_cast<T>(t_im));
  }
}

// Sweeps k = TW u .. TW u + TW - 1 (below NP): the row-k threads publish
// their segments to the pivot-row buffer of k's parity, the group meets once,
// and every thread takes its row's factor (column k of the row, a shuffle
// from the row's thread that holds it, over the pivot; zeroed on the pivot
// row by a multiply) and updates its segment from its segment of the buffer:
// gauss_jordan.cuh:sweep's operations on the same entries, in the same
// order, spread over the group.  The quotient is IEEE division's, bit for
// bit, exact zeros included.
template <typename T, int NP, int TW, int u>
__device__ __forceinline__ void sweep_round(T (&m)[Spread<T, NP, TW>::S], int r, int t, T* pb, int src0, int bar) {
  using SS = Spread<T, NP, TW>;
  constexpr int S = SS::S, SP = SS::SP, V = SS::V;
#pragma unroll 1
  for (int tp = 0; tp < TW; ++tp) {
    const int k = TW * u + tp;
    if (k >= NP) break;  // the same in every thread
    T* const buf = pb + (k & 1) * (TW * SP);
    if (r == k) {
#pragma unroll
      for (int c = 0; c < SP / V; ++c) {
        T vv[V];
#pragma unroll
        for (int e = 0; e < V; ++e) vv[e] = V * c + e < S ? m[V * c + e] : T(0);
        st16(buf + t * SP + V * c, vv);
      }
    }
    group_sync<SS::GW>(bar);
    const T piv = buf[tp * SP + u];
    const T mk = __shfl_sync(kWarpMask, m[u], src0 + tp);
    // 0 / piv is the signed zero 0 * sign(piv) for piv neither 0 nor NaN:
    // selected, so that no thread's exact zero sends the division to its
    // slow path (most rows' entries of column k are zeros in a sparse J).
    const bool zero = mk == T(0) && piv == piv && piv != T(0);
    const T q = div_rn(zero ? T(1) : mk, piv);
    const T f = mul_rn(zero ? mul_rn(mk, copysign(T(1), piv)) : q, r == k ? T(0) : T(1));
#pragma unroll
    for (int c = 0; c < SP / V; ++c) {
      T vv[V];
      ld16(buf + t * SP + V * c, vv);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (V * c + e < S) m[V * c + e] = sub_rn(m[V * c + e], mul_rn(f, vv[e]));
      }
    }
  }
}

template <typename T, int NP, int TW, int... Us>
__device__ __forceinline__ void sweep_rounds(std::integer_sequence<int, Us...>, T (&m)[Spread<T, NP, TW>::S], int r,
                                             int t, T* pb, int src0, int bar) {
  (sweep_round<T, NP, TW, Us>(m, r, t, pb, src0, bar), ...);
}

// The Newton loop of the worklist's `count` lanes by GROUPS groups a block at
// TW threads a row, each group taking a lane at a time.  NP: the body's size
// (n itself up to 32, the 48- or 64-row body for n = 34..64); kLaneY: the
// Y-bus from the branch tables and the lanes' taps, or read from a dense Y.
// The owner of row r, thread (r, NP % TW), which holds column NP (the
// residual), keeps unknown r (theta of bus r + 1 below nb, |V| of bus r - nb
// + 1 from nb): x_r, F_r, its injection, and the per-bus work of bus r (V and
// V / |V| for r <= nb, Re or Im of (Y V) of its bus).
template <typename T, int NP, int TW, int GROUPS, bool kLaneY>
__device__ __forceinline__ void newton_lanes(const NewtonParams<T>& P, int count, unsigned char* smem_raw) {
  using SS = Spread<T, NP, TW>;
  constexpr int S = SS::S, GW = SS::GW, THREADS = SS::THREADS, NMAX = SS::NMAX;
  constexpr int OWN = NP % TW;  // the owner's column group
  constexpr bool kStallRule = sizeof(T) == 4;  // the float32 tier's plateau exit
  const int gi = threadIdx.x / THREADS, g = threadIdx.x - gi * THREADS;
  if (gi >= GROUPS) return;  // a block's threads beyond its groups at 4 threads a row
  const int bar = 1 + gi;
  const int nb = NP <= 32 ? NP / 2 : P.nb;
  const int n = 2 * nb, N = nb + 1;
  const int lane = threadIdx.x & 31;
  const int r = g / TW, t = g - r * TW;  // row r, columns t + TW v
  const int src0 = lane - t;             // the lane of thread (r, 0)
  const int bus = r < nb ? r + 1 : r - nb + 1;
  const bool owner = r < n && t == OWN;  // holds unknown r
  T* const pb = reinterpret_cast<T*>(smem_raw) + gi * SS::SLOT;
  T* const Yr = pb + SS::PB;
  T* const Yi = Yr + SS::YS;
  T* const Vr = Yi + SS::YS;  // V
  T* const Vi = Vr + NMAX;
  T* const Ur = Vi + NMAX;  // V / |V|
  T* const Ui = Ur + NMAX;
  T* const Wr = Ui + NMAX;  // Y V
  T* const Wi = Wr + NMAX;
  T* const xs = Wi + NMAX;
  T* const red = xs + NP;
  int* const cell = reinterpret_cast<int*>(smem_raw + sizeof(T) * Body<T, NP>::SLOTS) + gi;
  const T xtol = P.xtol;

  // V, V / |V| and Y V of the lane at x (power_flow.py:_assemble_v,
  // _mismatch's matvec, _jacobian's V / |V|), by the owners.
  auto vectors = [&](T x_r) {
    if (owner) xs[r] = x_r;
    group_sync<GW>(bar);
    if (t == OWN && r <= nb) {  // bus r; the slack is 1 + 0j
      T vr = T(1), vi = T(0);
      if (r > 0) {
        const T th = xs[r - 1], vm = xs[nb + r - 1];
        vr = mul_rn(vm, cos_of(th));
        vi = mul_rn(vm, sin_of(th));
      }
      const T va = sqrt_rn(add_rn(mul_rn(vr, vr), mul_rn(vi, vi)));
      Vr[r] = vr;
      Vi[r] = vi;
      Ur[r] = div_rn(vr, va);
      Ui[r] = div_rn(vi, va);
    }
    group_sync<GW>(bar);
    if (owner) {  // Re (Y V) of the bus on a theta row, Im on a |V| row
      const T* yr = Yr + bus * N;
      const T* yi = Yi + bus * N;
      if (r < nb) {
        Wr[bus] = sub_rn(dot_full<NMAX>(yr, Vr, N), dot_full<NMAX>(yi, Vi, N));
      } else {
        Wi[bus] = add_rn(dot_full<NMAX>(yr, Vi, N), dot_full<NMAX>(yi, Vr, N));
      }
    }
    group_sync<GW>(bar);
  };

  while (true) {
    const int i = claim<GW>(P.counters + 1, count, cell, g, bar);
    if (i >= count) break;
    const int b = __ldcg(P.work + i);
    group_sync<GW>(bar);  // the previous lane's shared memory is read by all

    // The lane's start, its Y-bus, its vectors.
    T x_r = T(0), F_r = T(0), pq = T(0);
    if (owner) {
      const long long o = static_cast<long long>(b) * n + r;
      x_r = P.x_in[o];
      F_r = P.F_in[o];
      pq = r < nb ? P.p[static_cast<long long>(b) * nb + r] : P.q[static_cast<long long>(b) * nb + r - nb];
    }
    T diff = P.diff_in[b];
    int it = P.it_in[b], stall = 0;
    {
      const T* gr = kLaneY ? nullptr : P.Yre + b * P.y_stride;
      const T* gy = kLaneY ? nullptr : P.Yim + b * P.y_stride;
      for (int e = g; e < N * N; e += THREADS) {
        Yr[e] = kLaneY ? T(0) : gr[e];
        Yi[e] = kLaneY ? T(0) : gy[e];
      }
    }
    if constexpr (kLaneY) {
      group_sync<GW>(bar);
      lane_ybus(P, b, N, Yr, Yi, g, THREADS);
    }
    vectors(x_r);

    while (true) {
      // Thread (r, t)'s entries of [J | F] (power_flow.py:_jacobian, each
      // operation rounded as the plain version rounds it, the eye factors
      // included), entry by entry; rows and columns from n to NP are the
      // identity's, as K1's register route pads a system.
      T m[S];
      if (r < n) {
        const T vri = Vr[bus], vii = Vi[bus];
        const T* yr = Yr + bus * N;
        const T* yi = Yi + bus * N;
        const bool p_row = r < nb;
#pragma unroll
        for (int v = 0; v < S; ++v) {
          // Both of the entry's formulas from unconditional loads (a column
          // beyond n reads bus 1), then selected, so that the loads of all
          // S entries can be scheduled ahead of their arithmetic.
          const int c = t + TW * v;
          const bool theta = c < nb;
          const int k = theta ? c + 1 : (c < n ? c - nb + 1 : 1);
          const T eye = k == bus ? T(1) : T(0);
          const T yre = yr[k], yim = yi[k], vrk = Vr[k], vik = Vi[k], wrk = Wr[k], wik = Wi[k];
          const T urk = Ur[k], uik = Ui[k];
          // dS/dtheta = j diag(V) conj(diag(YV) - Y diag(V))
          const T M_re = add_rn(sub_rn(mul_rn(wrk, eye), mul_rn(yre, vrk)), mul_rn(yim, vik));
          const T M_im = sub_rn(sub_rn(mul_rn(wik, eye), mul_rn(yre, vik)), mul_rn(yim, vrk));
          const T Jt = p_row ? -sub_rn(mul_rn(vii, M_re), mul_rn(vri, M_im))
                             : add_rn(mul_rn(vri, M_re), mul_rn(vii, M_im));
          // dS/d|V| = diag(V) conj(Y diag(V/|V|)) + diag(V/|V| conj(YV))
          const T B_re = sub_rn(mul_rn(yre, urk), mul_rn(yim, uik));
          const T B_im = add_rn(mul_rn(yre, uik), mul_rn(yim, urk));
          const T C = p_row ? add_rn(mul_rn(vri, B_re), mul_rn(vii, B_im))
                            : sub_rn(mul_rn(vii, B_re), mul_rn(vri, B_im));
          const T d = p_row ? add_rn(mul_rn(urk, wrk), mul_rn(uik, wik))
                            : sub_rn(mul_rn(uik, wrk), mul_rn(urk, wik));
          const T Jv = add_rn(C, mul_rn(d, eye));
          m[v] = c < n ? (theta ? Jt : Jv) : (c == NP ? F_r : T(0));  // F: the owner's column
        }
      } else {
#pragma unroll
        for (int v = 0; v < S; ++v) m[v] = t + TW * v == r ? T(1) : T(0);
      }

      // The elimination, then x <- x - J^-1 F on the owner: the row's
      // diagonal entry comes from the row's thread that holds column r,
      // (r, r % TW).
      sweep_rounds<T, NP, TW>(std::make_integer_sequence<int, SS::U>{}, m, r, t, pb, src0, bar);
      T dloc = m[0];
#pragma unroll
      for (int v = 1; v < S; ++v) dloc = t + TW * v == r ? m[v] : dloc;
      const T dg = __shfl_sync(kWarpMask, dloc, src0 + r % TW);
      if (owner) x_r = sub_rn(x_r, div_rn(m[NP / TW], dg));

      // The new mismatch and its max over the lane.
      vectors(x_r);
      T vmax = T(0);
      if (owner) {
        const T vr = Vr[bus], vi = Vi[bus], wr = Wr[bus], wi = Wi[bus];
        F_r = r < nb ? sub_rn(add_rn(mul_rn(vr, wr), mul_rn(vi, wi)), pq)
                     : sub_rn(sub_rn(mul_rn(vi, wr), mul_rn(vr, wi)), pq);
        vmax = abs_of(F_r);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) vmax = nan_max(vmax, __shfl_xor_sync(kWarpMask, vmax, o));
      if constexpr (GW > 1) {
        if (lane == 0) red[g >> 5] = vmax;
        group_sync<GW>(bar);
        vmax = red[0];
#pragma unroll
        for (int w = 1; w < GW; ++w) vmax = nan_max(vmax, red[w]);
      }

      // The reference's stall rule and loop condition, the same in every
      // thread of the group.
      const bool improving = vmax < mul_rn(diff, T(0.5));  // false on NaN
      stall = improving ? 0 : stall + 1;
      diff = vmax;
      ++it;
      if (!(diff > xtol && it < P.lim_iter && (!kStallRule || stall < kStallLimit))) break;
    }
    if (owner) {
      const long long o = static_cast<long long>(b) * n + r;
      P.x[o] = x_r;
      P.F[o] = F_r;
    }
    if (g == 0) {
      P.diff[b] = diff;
      P.n_iter[b] = it;
      P.stall[b] = stall;
    }
  }
}

// The kernel: the triage, a grid barrier, then the worklist's Newton loops;
// the 48- and 64-row bodies at 4 threads a row where the worklist fits the
// grid's groups of that width at once, else at 2.
template <typename T, int NP, bool kLaneY>
__global__ void __launch_bounds__(Body<T, NP>::BLOCK, Body<T, NP>::MIN_BLOCKS)
    newton_kernel(const NewtonParams<T> P) {
  using BB = Body<T, NP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  triage(P, NP <= 32 ? NP : 2 * P.nb);
  grid_barrier(P.counters + 2);
  const int count = __ldcg(P.counters);
  if constexpr (BB::WIDE) {
    if (count <= static_cast<int>(gridDim.x) * BB::G_HI) {
      newton_lanes<T, NP, BB::TW_HI, BB::G_HI, kLaneY>(P, count, smem_raw);
      return;
    }
  }
  newton_lanes<T, NP, BB::TW_LO, BB::G_LO, kLaneY>(P, count, smem_raw);
}

// One cooperative launch of a persistent grid: as many blocks as the card
// holds at once, fewer where the lanes need fewer (a group of the bodies'
// widest layout a lane).
template <typename T, int NP, bool kLaneY>
int launch_newton(const NewtonParams<T>& P, cudaStream_t stream) {
  using BB = Body<T, NP>;
  void (*kernel)(const NewtonParams<T>) = newton_kernel<T, NP, kLaneY>;
  cudaError_t err = cudaSuccess;
  if (BB::BYTES > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(BB::BYTES));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int device = 0, n_sm = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BB::BLOCK, BB::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long cap = static_cast<long long>(per_sm) * n_sm;
  const long long need = (static_cast<long long>(P.B) + BB::G_HI - 1) / BB::G_HI;
  const int grid = static_cast<int>(need < cap ? need : cap);
  NewtonParams<T> arg = P;
  void* args[] = {&arg};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid), dim3(BB::BLOCK), args,
                                    BB::BYTES, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Even n = LO..HI at their own size.
template <typename T, bool kLaneY, int LO, int HI>
int dispatch_small(const NewtonParams<T>& P, int n, cudaStream_t stream) {
  if (n == HI) return launch_newton<T, HI, kLaneY>(P, stream);
  if constexpr (HI > LO) {
    return dispatch_small<T, kLaneY, LO, HI - 2>(P, n, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bodies in two halves of about equal build time: the low half n =
// 2..26 at their own size and 34..48 in the 48-row body, the high half n =
// 28..32 and 50..64 in the 64-row body (n = 2 nb is even).
inline bool newton_low(int n) { return (n >= 2 && n <= 26) || (n >= 34 && n <= 48); }

template <typename T, bool kLaneY>
int newton_low_half(const NewtonParams<T>& P, cudaStream_t stream) {
  const int n = 2 * P.nb;
  if (!newton_low(n)) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 26) return dispatch_small<T, kLaneY, 2, 26>(P, n, stream);
  return launch_newton<T, 48, kLaneY>(P, stream);
}

template <typename T, bool kLaneY>
int newton_high_half(const NewtonParams<T>& P, cudaStream_t stream) {
  const int n = 2 * P.nb;
  if (n < 28 || n > 64 || newton_low(n)) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 32) return dispatch_small<T, kLaneY, 28, 32>(P, n, stream);
  return launch_newton<T, 64, kLaneY>(P, stream);
}

}  // namespace
