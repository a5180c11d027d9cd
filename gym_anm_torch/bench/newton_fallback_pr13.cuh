// K3 as PR 13 shipped it (a lane slot per system of K1's register route:
// one warp to n = 32, floor(32 / n) lanes a warp to 16, two warps for n =
// 34..64; lanes claimed one at a time from a work counter, a lane that does
// not iterate copied through at its claim), kept as the baseline of
// chip_smoke.py phase 3b and gym_anm_torch/bench/kernel_probes.py: every
// later reading can put csrc/newton_fallback.cu beside this design in one
// call.  The kernel is PR 13's, unchanged but for the path of K1's header;
// newton_fallback_pr13_f32.cu and newton_fallback_pr13_f64.cu hold its entry
// points and the low halves of its bodies, the _high.cu units the high halves.
//
// PR 13's header comment follows.
//
// K3's device code (csrc/newton_fallback.cu describes the kernel): the
// exact Newton loop of the load-flow fallback, a lane slot per system of
// K1's register route, whose sweeps (gauss_jordan.cuh:sweep/sweeps) solve
// each iteration's system in registers.  Four translation units instantiate
// it, so that nvcc builds the unrolled bodies in parallel:
// newton_fallback_f32.cu and newton_fallback_f64.cu (n = 2..26 and the
// 48-row body) and newton_fallback_f32_high.cu and newton_fallback_f64_high.cu
// (n = 28..32 and the 64-row body); newton_fallback.cu holds the entry points.

#pragma once

#include <math.h>

#include "../csrc/gauss_jordan.cuh"

namespace {

constexpr unsigned kWarpMask = 0xffffffffu;
constexpr int kStallLimit = 3;  // power_flow.py:_STALL_LIMIT, the float32 tier's plateau rule

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
  int* next_lane;                 // the work counter, zeroed by the wrapper
  int B, nb;
};

// A block's shared memory: K1's buffers a warp (RegShape::SMEM: the staging
// rows, then the pivot rows), a region a lane slot (its Y-bus Yre, Yim [N][N]
// with N <= NP / 2 + 1, its V, V / |V| and Y V, its x, the max's scratch),
// and an int a system of two warps (the claim's broadcast).
template <typename T, int NP>
struct NewtonShape {
  using S = RegShape<T, NP>;
  static constexpr int NMAX = NP / 2 + 1;
  static constexpr int YS = NMAX * NMAX;
  static constexpr int SLOT = 2 * YS + 6 * NMAX + 2 * NP;
  static constexpr int SLOTS = kRegWarps / S::H * S::G;  // lanes a block holds at once
  static constexpr size_t BYTES = sizeof(T) * (static_cast<size_t>(kRegWarps) * S::SMEM +
                                               static_cast<size_t>(SLOTS) * SLOT) + sizeof(int) * kRegWarps;
};

// The next lane of the work counter, the same in every thread of the system.
template <int H>
__device__ __forceinline__ int claim(int* next_lane, int* cell, int lane, int h, int warp) {
  if constexpr (H == 1) {
    int c = 0;
    if (lane == 0) c = atomicAdd(next_lane, 1);
    return __shfl_sync(kWarpMask, c, 0);
  } else {
    if (h == 0 && lane == 0) *cell = atomicAdd(next_lane, 1);
    system_sync<H>(warp);
    const int c = *cell;
    system_sync<H>(warp);  // read by all before the next claim writes it
    return c;
  }
}

// Lane b's Y-bus from the branch tables, in a slot whose Y is zero, by the
// slot's threads (tid < nthr): ybus.py:build_ybus operation for operation,
// -y / conj(tau) and -y / tau by complexops.py:cdiv, and the diagonal as
// the per-bus sums over the incident branches, in branch order, in float64,
// rounded to T (build_ybus's one-hot incidence products).
template <typename T>
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
    double f_re = 0.0, f_im = 0.0, t_re = 0.0, t_im = 0.0;
    for (int e = 0; e < Ne; ++e) {
      const bool from = P.br_f[e] == k, to = P.br_t[e] == k;
      if (!(from || to)) continue;
      const T tot_re = P.series_re[e], tot_im = add_rn(P.series_im[e], P.shunt_im[e]);
      if (from) {  // (y + y_sh) / a^2
        const T a2 = mul_rn(tap[e], tap[e]);
        f_re += static_cast<double>(div_rn(tot_re, a2));
        f_im += static_cast<double>(div_rn(tot_im, a2));
      }
      if (to) {  // y + y_sh
        t_re += static_cast<double>(tot_re);
        t_im += static_cast<double>(tot_im);
      }
    }
    Yr[k * N + k] = add_rn(static_cast<T>(f_re), static_cast<T>(t_re));
    Yi[k * N + k] = add_rn(static_cast<T>(f_im), static_cast<T>(t_im));
  }
}

// NP: K1's register size (n itself up to 32, the 48- or 64-row body for n =
// 34..64); kLaneY: the Y-bus from the branch tables and the lanes' taps, or
// read from a dense Y.  Thread `row` of a lane's system owns unknown `row`
// (theta of bus row + 1 below nb, |V| of bus row - nb + 1 from nb), its
// residual and its row of the Jacobian, as the thread of K1's row.
template <typename T, int NP, bool kLaneY>
__global__ void __launch_bounds__(kRegWarps * 32, 1) newton_kernel(const NewtonParams<T> P) {
  using S = RegShape<T, NP>;
  using NS = NewtonShape<T, NP>;
  constexpr int G = S::G, H = S::H, SLD = S::SLD;
  constexpr bool kStallRule = sizeof(T) == 4;  // the float32 tier's plateau exit
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int nb = NP <= 32 ? NP / 2 : P.nb;
  const int n = 2 * nb, N = nb + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, h = warp % H;
  // K1's layout: system (lane slot) s of the warp, row `row` of it.
  const int s = G > 1 ? (lane / NP < G ? lane / NP : G - 1) : 0;
  const bool in_sys = G > 1 ? lane < G * NP : true;
  const int row = (G > 1 ? lane - s * NP : lane) + 32 * h;
  const int nthr = G > 1 ? NP : 32 * H;  // threads of a slot
  const bool own = in_sys && row < n;    // the thread holds an unknown
  const int bus = row < nb ? row + 1 : row - nb + 1;
  T* const wsm = smem + warp * S::SMEM;
  T* const prow = smem + (warp - h) * S::SMEM;
  T* const Yr = smem + kRegWarps * S::SMEM + ((warp / H) * G + s) * NS::SLOT;
  T* const Yi = Yr + NS::YS;
  T* const Vr = Yi + NS::YS;  // V
  T* const Vi = Vr + NS::NMAX;
  T* const Ur = Vi + NS::NMAX;  // V / |V|
  T* const Ui = Ur + NS::NMAX;
  T* const Wr = Ui + NS::NMAX;  // Y V
  T* const Wi = Wr + NS::NMAX;
  T* const xs = Wi + NS::NMAX;
  T* const red = xs + NP;
  int* const cell = reinterpret_cast<int*>(smem + kRegWarps * S::SMEM + NS::SLOTS * NS::SLOT) + warp / H;

  const T xtol = P.xtol;
  int b = -1;  // the slot's lane
  bool exhausted = false;
  T x_r = T(0), F_r = T(0), pq = T(0), diff = T(0);
  int it = 0, stall = 0;

  // V, V / |V| and Y V of the lanes of the slots where `act`, at their x
  // (power_flow.py:_assemble_v, _mismatch's matvec, _jacobian's V / |V|).
  auto vectors = [&](bool act) {
    if (act && own) xs[row] = x_r;
    system_sync<H>(warp);
    if (act && in_sys && row <= nb) {  // bus `row`; the slack is 1 + 0j
      T vr = T(1), vi = T(0);
      if (row > 0) {
        const T th = xs[row - 1], vm = xs[nb + row - 1];
        vr = mul_rn(vm, cos_of(th));
        vi = mul_rn(vm, sin_of(th));
      }
      const T va = sqrt_rn(add_rn(mul_rn(vr, vr), mul_rn(vi, vi)));
      Vr[row] = vr;
      Vi[row] = vi;
      Ur[row] = div_rn(vr, va);
      Ui[row] = div_rn(vi, va);
    }
    system_sync<H>(warp);
    if (act && own) {  // Re (Y V) of the bus on a theta row, Im on a |V| row
      const T* yr = Yr + bus * N;
      const T* yi = Yi + bus * N;
      if (row < nb) {
        Wr[bus] = sub_rn(dot_full<NS::NMAX>(yr, Vr, N), dot_full<NS::NMAX>(yi, Vi, N));
      } else {
        Wi[bus] = add_rn(dot_full<NS::NMAX>(yr, Vi, N), dot_full<NS::NMAX>(yi, Vr, N));
      }
    }
    system_sync<H>(warp);
  };

  while (true) {
    // Fill the empty slots, one after another, from the work counter.  A
    // lane that does not iterate (accepted, within xtol or out of
    // iterations) is copied through with a stall count of 0 at its claim.
    bool fresh = false;
    for (int sp = 0; sp < G; ++sp) {
      const int b_sp = G > 1 ? __shfl_sync(kWarpMask, b, sp * NP) : b;
      if (b_sp >= 0 || exhausted) continue;
      while (true) {
        const int c = claim<H>(P.next_lane, cell, lane, h, warp);
        if (c >= P.B) {
          exhausted = true;
          break;
        }
        const bool acc = P.accepted != nullptr && P.accepted[c] != 0;
        const T d0 = P.diff_in[c];
        const int i0 = P.it_in[c];
        if (!acc && d0 > xtol && i0 < P.lim_iter) {  // false on a NaN residual, as in the reference
          if (s == sp) {
            b = c;
            fresh = true;
            diff = d0;
            it = i0;
            stall = 0;
          }
          break;
        }
        const int gt = lane + 32 * h;
        const long long o = static_cast<long long>(c) * n;
        for (int e = gt; e < n; e += 32 * H) {
          P.x[o + e] = P.x_in[o + e];
          P.F[o + e] = P.F_in[o + e];
        }
        if (gt == 0) {
          P.diff[c] = d0;
          P.n_iter[c] = i0;
          P.stall[c] = 0;
        }
      }
    }
    const bool act = in_sys && b >= 0;
    if (!__any_sync(kWarpMask, act)) break;  // the same in both warps of a two-warp system

    // A new lane: its start, its Y-bus, its vectors.
    if (__any_sync(kWarpMask, fresh)) {
      const bool load = fresh && in_sys;
      if (fresh && own) {
        const long long o = static_cast<long long>(b) * n + row;
        x_r = P.x_in[o];
        F_r = P.F_in[o];
        pq = row < nb ? P.p[static_cast<long long>(b) * nb + row] : P.q[static_cast<long long>(b) * nb + row - nb];
      }
      if (load) {
        const T* gr = kLaneY ? nullptr : P.Yre + b * P.y_stride;
        const T* gi = kLaneY ? nullptr : P.Yim + b * P.y_stride;
        for (int e = row; e < N * N; e += nthr) {
          Yr[e] = kLaneY ? T(0) : gr[e];
          Yi[e] = kLaneY ? T(0) : gi[e];
        }
      }
      if constexpr (kLaneY) {
        system_sync<H>(warp);
        if (load) lane_ybus(P, b, N, Yr, Yi, row, nthr);
      }
      vectors(fresh);
    }

    // Row `row` of the lane's Jacobian (power_flow.py:_jacobian, each
    // operation rounded as the plain version rounds it, the eye factors
    // included) into the warp's staging rows, then into registers as K1
    // loads a system: rows and columns from n to NP are the identity's.
    if (act && own) {
      const T vri = Vr[bus], vii = Vi[bus];
      const T* yr = Yr + bus * N;
      const T* yi = Yi + bus * N;
      T* out = wsm + lane * SLD;
      const bool p_row = row < nb;
      for (int c = 0; c < n; ++c) {
        const int k = c < nb ? c + 1 : c - nb + 1;
        const T eye = k == bus ? T(1) : T(0);
        const T yre = yr[k], yim = yi[k];
        T J;
        if (c < nb) {  // dS/dtheta = j diag(V) conj(diag(YV) - Y diag(V))
          const T M_re = add_rn(sub_rn(mul_rn(Wr[k], eye), mul_rn(yre, Vr[k])), mul_rn(yim, Vi[k]));
          const T M_im = sub_rn(sub_rn(mul_rn(Wi[k], eye), mul_rn(yre, Vi[k])), mul_rn(yim, Vr[k]));
          J = p_row ? -sub_rn(mul_rn(vii, M_re), mul_rn(vri, M_im)) : add_rn(mul_rn(vri, M_re), mul_rn(vii, M_im));
        } else {  // dS/d|V| = diag(V) conj(Y diag(V/|V|)) + diag(V/|V| conj(YV))
          const T B_re = sub_rn(mul_rn(yre, Ur[k]), mul_rn(yim, Ui[k]));
          const T B_im = add_rn(mul_rn(yre, Ui[k]), mul_rn(yim, Ur[k]));
          if (p_row) {
            const T C_re = add_rn(mul_rn(vri, B_re), mul_rn(vii, B_im));
            const T d_re = add_rn(mul_rn(Ur[k], Wr[k]), mul_rn(Ui[k], Wi[k]));
            J = add_rn(C_re, mul_rn(d_re, eye));
          } else {
            const T C_im = sub_rn(mul_rn(vii, B_re), mul_rn(vri, B_im));
            const T d_im = sub_rn(mul_rn(Ui[k], Wr[k]), mul_rn(Ur[k], Wi[k]));
            J = add_rn(C_im, mul_rn(d_im, eye));
          }
        }
        out[c] = J;
      }
    }
    T m[S::W];
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      T v = row == j ? T(1) : T(0);
      if (act && own && j < n) v = wsm[lane * SLD + j];
      m[j] = v;
    }
    m[NP] = act && own ? F_r : T(0);
    // The pivot rows reuse the first warp's staging rows, once all are read.
    system_sync<H>(warp);
    sweeps<T, NP>(std::make_integer_sequence<int, NP>{}, m, row, prow, s, in_sys, warp);
    T d = m[0];
#pragma unroll
    for (int j = 1; j < NP; ++j) d = row == j ? m[j] : d;
    if (act && own) x_r = sub_rn(x_r, div_rn(m[NP], d));  // x <- x - J^-1 F

    // The new mismatch and its max over the lane.
    vectors(act);
    T v = T(0);
    if (act && own) {
      const T vr = Vr[bus], vi = Vi[bus], wr = Wr[bus], wi = Wi[bus];
      F_r = row < nb ? sub_rn(add_rn(mul_rn(vr, wr), mul_rn(vi, wi)), pq)
                     : sub_rn(sub_rn(mul_rn(vi, wr), mul_rn(vr, wi)), pq);
      v = abs_of(F_r);
    }
    if constexpr (G > 1) {
      if (in_sys) red[row] = v;
      __syncwarp();
      v = T(0);
      for (int j = 0; j < NP; ++j) v = nan_max(v, red[j]);
    } else {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(kWarpMask, v, o));
      if constexpr (H == 2) {
        if (lane == 0) red[h] = v;
        system_sync<H>(warp);
        v = nan_max(red[0], red[1]);
      }
    }

    // The reference's stall rule and loop condition; a lane that exits
    // writes its outputs and leaves its slot empty.
    if (act) {
      const bool improving = v < mul_rn(diff, T(0.5));  // false on NaN
      stall = improving ? 0 : stall + 1;
      diff = v;
      ++it;
      if (!(diff > xtol && it < P.lim_iter && (!kStallRule || stall < kStallLimit))) {
        if (own) {
          const long long o = static_cast<long long>(b) * n + row;
          P.x[o] = x_r;
          P.F[o] = F_r;
        }
        if (row == 0) {
          P.diff[b] = diff;
          P.n_iter[b] = it;
          P.stall[b] = stall;
        }
        b = -1;
      }
    }
  }
}

template <typename T, int NP, bool kLaneY>
int launch_newton(const NewtonParams<T>& P, cudaStream_t stream) {
  using NS = NewtonShape<T, NP>;
  void (*kernel)(const NewtonParams<T>) = newton_kernel<T, NP, kLaneY>;
  cudaError_t err = cudaSuccess;
  if (NS::BYTES > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(NS::BYTES));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int device = 0, n_sm = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kRegWarps * 32, NS::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long need = (static_cast<long long>(P.B) + NS::SLOTS - 1) / NS::SLOTS;
  const long long cap = static_cast<long long>(per_sm > 0 ? per_sm : 1) * n_sm;
  const int grid = static_cast<int>(need < cap ? need : cap);
  kernel<<<grid, kRegWarps * 32, NS::BYTES, stream>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// Even n = LO..HI at their own size.
template <typename T, bool kLaneY, int LO, int HI>
int dispatch_newton(const NewtonParams<T>& P, int n, cudaStream_t stream) {
  if (n == HI) return launch_newton<T, HI, kLaneY>(P, stream);
  if constexpr (HI > LO) {
    return dispatch_newton<T, kLaneY, LO, HI - 2>(P, n, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bodies in two halves of about equal build time, as K1's register
// route splits them: the low half n = 2..26 at their own size and 34..48 in
// the 48-row body, the high half n = 28..32 and 50..64 in the 64-row body
// (n = 2 nb is even).
inline bool newton_low(int n) { return (n >= 2 && n <= 26) || (n >= 34 && n <= 48); }

template <typename T, bool kLaneY>
int newton_low_half(const NewtonParams<T>& P, cudaStream_t stream) {
  const int n = 2 * P.nb;
  if (!newton_low(n)) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 26) return dispatch_newton<T, kLaneY, 2, 26>(P, n, stream);
  return launch_newton<T, 48, kLaneY>(P, stream);
}

template <typename T, bool kLaneY>
int newton_high_half(const NewtonParams<T>& P, cudaStream_t stream) {
  const int n = 2 * P.nb;
  if (n < 28 || n > 64 || newton_low(n)) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 32) return dispatch_newton<T, kLaneY, 28, 32>(P, n, stream);
  return launch_newton<T, 64, kLaneY>(P, stream);
}

}  // namespace
