// K3 wide as PR 15 shipped it (a block of 256 a lane: [J | F] resident in
// the block's shared memory or in its slot of device memory, eliminated by
// K1's panel body, the rest of the iteration spread over the block), kept
// as the baseline of chip_smoke.py phase 10: every later reading can put
// csrc/newton_fallback_wide.cuh beside this design in one call.  The kernel
// is PR 15's, unchanged but for the path of K3's header and the entry point
// below (newton_fallback.cu's newton_wide_entry, folded in);
// newton_fallback_wide_pr15_f32.cu and newton_fallback_wide_pr15_f64.cu
// instantiate it, one a type.
//
// PR 15's header comment follows.
//
// K3 wide's device code (csrc/newton_fallback.cu describes the kernel): the
// exact Newton loop of networks above 33 buses (n = 66 unknowns and more).
// K3's triage, grid barrier, worklist claim and Y-bus builder, then a block
// a lane: the lane's [J | F] in the block's shared memory (route "smem") or
// in its slot of device memory (route "blocked"), eliminated by K1's panel
// body (gauss_jordan.cuh:gj_panel_sweeps), the rest of the iteration spread
// over the block's threads.  Two translation units instantiate it, one a
// type: newton_fallback_wide_f32.cu and newton_fallback_wide_f64.cu.

#pragma once

#include <type_traits>

#include "../csrc/newton_fallback.cuh"

namespace {

constexpr int kFoldLevels = 12;  // the float64 Y V tree's levels a thread keeps: networks of up to 4096 buses
constexpr int kWideWarps = kPanThreads / 32;

// A launch of the wide kernel: K3's parameters, and the slots, one a
// resident block of the grid, of `slot` entries each: the lane's [J | F]
// [n][n + 1] on route "blocked", then its Y-bus Yre, Yim [N][N] where it is
// built from the branch tables.
template <typename T>
struct WideParams {
  NewtonParams<T> P;
  T* slots;
  long long slot;
};

// A block's shared memory beyond the panels and the resident matrix: the
// lane's V, V / |V| and Y V (N each, real and imaginary parts), x, F and the
// injections (n each), the warps' maxima and the claim's cell.
// newton_cuda.py:wide_lane_bytes is the same sum.
template <typename T>
size_t wide_lane_bytes(int n) {
  return sizeof(T) * (6 * static_cast<size_t>(n / 2 + 1) + 3 * static_cast<size_t>(n) + 32) + 16;
}

template <typename T>
size_t wide_smem_bytes(int n, int panel, bool resident) {
  return panel_smem_bytes<T>(n, panel, resident) + wide_lane_bytes<T>(n);
}

// The sum over k < N of y[k] v[k] by dot_full's rules at a run-time N: in
// float32 float64 sums in k order, rounded once; in float64 the tree of
// power_flow.py:_fold_sum (fold_node's) over 2^L >= N leaves, L >= 1: the
// leaves taken in the tree's depth-first order (leaf i of that order is
// bit-reversed i) and each finished subtree's sum kept at its level until
// its sibling's is formed, each sum rounded on its own.
__device__ __forceinline__ float dot_tree(const float* y, const float* v, int N, int) {
  return dot_full<1>(y, v, N);
}
__device__ __forceinline__ double dot_tree(const double* y, const double* v, int N, int L) {
  double st[kFoldLevels];
  double s = 0.0;
  for (int i = 0; i < (1 << L); ++i) {
    const int k = static_cast<int>(__brev(static_cast<unsigned>(i)) >> (32 - L));
    s = k < N ? __dmul_rn(y[k], v[k]) : 0.0;
    bool open = true;
#pragma unroll
    for (int l = 0; l < kFoldLevels; ++l) {
      if (open && ((i >> l) & 1)) {
        s = __dadd_rn(st[l], s);
      } else if (open) {
        st[l] = s;
        open = false;
      }
    }
  }
  return s;  // the last leaf's merges end at the root
}

// The kernel: the triage, a grid barrier, then each block takes a lane at a
// time from the worklist and runs it to its exit.  BP: the panel width;
// kResident: [J | F] in shared memory (else in the block's slot); kLaneY:
// the Y-bus built from the branch tables in the block's slot (else read in
// place from the dense Y).
template <typename T, int BP, bool kResident, bool kLaneY>
__global__ void __launch_bounds__(kPanThreads, kPanMinBlocks<T, kResident>)
    newton_wide_kernel(const WideParams<T> W) {
  const NewtonParams<T>& P = W.P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr bool kStallRule = sizeof(T) == 4;  // the float32 tier's plateau exit
  const int nb = P.nb, n = 2 * nb, N = nb + 1, ld = n + 1, ldn = (n + 3) / 4 * 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int L = 1;
  while ((1 << L) < N) ++L;
  T* const fp = reinterpret_cast<T*>(smem_raw);  // K1's panels (gj_panels' layout)
  T* const pr = fp + BP * ldn;
  T* const Fd = pr + BP * ld;
  T* const D = Fd + BP * BP;
  T* const slot = W.slots + static_cast<long long>(blockIdx.x) * W.slot;
  T* const M = kResident ? D + BP * BP : slot;  // [n][ld]: the lane's [J | F]
  T* const Vr = D + BP * BP + (kResident ? n * ld : 0);
  T* const Vi = Vr + N;
  T* const Ur = Vi + N;  // V / |V|
  T* const Ui = Ur + N;
  T* const Wr = Ui + N;  // Y V
  T* const Wi = Wr + N;
  T* const xs = Wi + N;
  T* const Fs = xs + n;
  T* const pq = Fs + n;
  T* const red = pq + n;
  int* const cell = reinterpret_cast<int*>(red + 32);
  const T xtol = P.xtol;

  triage(P, n);
  grid_barrier(P.counters + 2);
  const int count = __ldcg(P.counters);

  // V, V / |V| at x (a thread a bus) and Y V (a thread a row: Re of its
  // bus's on a theta row, Im on a |V| row), as K3's owners form them.
  auto vectors = [&](const T* Yr, const T* Yi) {
    for (int k = tid; k <= nb; k += kPanThreads) {  // the slack is 1 + 0j
      T vr = T(1), vi = T(0);
      if (k > 0) {
        const T th = xs[k - 1], vm = xs[nb + k - 1];
        vr = mul_rn(vm, cos_of(th));
        vi = mul_rn(vm, sin_of(th));
      }
      const T va = sqrt_rn(add_rn(mul_rn(vr, vr), mul_rn(vi, vi)));
      Vr[k] = vr;
      Vi[k] = vi;
      Ur[k] = div_rn(vr, va);
      Ui[k] = div_rn(vi, va);
    }
    __syncthreads();
    for (int r = tid; r < n; r += kPanThreads) {
      const int bus = r < nb ? r + 1 : r - nb + 1;
      const T* yr = Yr + bus * N;
      const T* yi = Yi + bus * N;
      if (r < nb) {
        Wr[bus] = sub_rn(dot_tree(yr, Vr, N, L), dot_tree(yi, Vi, N, L));
      } else {
        Wi[bus] = add_rn(dot_tree(yr, Vi, N, L), dot_tree(yi, Vr, N, L));
      }
    }
    __syncthreads();
  };

  while (true) {
    const int i = claim<kWideWarps>(P.counters + 1, count, cell, tid, 0);
    if (i >= count) break;
    const int b = __ldcg(P.work + i);

    // The lane's start, its Y-bus, its vectors.
    const long long o = static_cast<long long>(b) * n, ob = static_cast<long long>(b) * nb;
    for (int r = tid; r < n; r += kPanThreads) {
      xs[r] = P.x_in[o + r];
      Fs[r] = P.F_in[o + r];
      pq[r] = r < nb ? P.p[ob + r] : P.q[ob + r - nb];
    }
    T diff = P.diff_in[b];
    int it = P.it_in[b], stall = 0;
    const T* Yr;
    const T* Yi;
    if constexpr (kLaneY) {
      T* const yr = slot + (kResident ? 0 : static_cast<long long>(n) * ld);
      T* const yi = yr + N * N;
      for (int e = tid; e < N * N; e += kPanThreads) {
        yr[e] = T(0);
        yi[e] = T(0);
      }
      __syncthreads();
      lane_ybus(P, b, N, yr, yi, tid, kPanThreads);
      Yr = yr;
      Yi = yi;
    } else {
      Yr = P.Yre + b * P.y_stride;
      Yi = P.Yim + b * P.y_stride;
    }
    __syncthreads();
    vectors(Yr, Yi);

    while (true) {
      // [J | F] (power_flow.py:_jacobian, each operation rounded as the
      // plain version rounds it, the eye factors included), a warp a row.
      for (int r = warp; r < n; r += kWideWarps) {
        const int bus = r < nb ? r + 1 : r - nb + 1;
        const bool p_row = r < nb;
        const T vri = Vr[bus], vii = Vi[bus];
        const T* yr = Yr + bus * N;
        const T* yi = Yi + bus * N;
        T* const row = M + r * ld;
        for (int c = lane; c < n; c += 32) {
          const bool theta = c < nb;
          const int k = theta ? c + 1 : c - nb + 1;
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
          row[c] = theta ? Jt : add_rn(C, mul_rn(d, eye));
        }
        if (lane == 0) row[n] = Fs[r];
      }
      __syncthreads();

      // The elimination, K1's panel sweeps, then x <- x - J^-1 F.
      gj_panel_sweeps<T, BP>(static_cast<const T*>(nullptr), static_cast<const T*>(nullptr), M, fp, pr, Fd, D, n,
                             [&](int r, T dx) { xs[r] = sub_rn(xs[r], dx); });

      // The new mismatch and its max over the lane.
      vectors(Yr, Yi);
      T vmax = T(0);
      for (int r = tid; r < n; r += kPanThreads) {
        const int bus = r < nb ? r + 1 : r - nb + 1;
        const T vr = Vr[bus], vi = Vi[bus], wr = Wr[bus], wi = Wi[bus];
        const T f = r < nb ? sub_rn(add_rn(mul_rn(vr, wr), mul_rn(vi, wi)), pq[r])
                           : sub_rn(sub_rn(mul_rn(vi, wr), mul_rn(vr, wi)), pq[r]);
        Fs[r] = f;
        vmax = nan_max(vmax, abs_of(f));
      }
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) vmax = nan_max(vmax, __shfl_xor_sync(kWarpMask, vmax, s));
      if (lane == 0) red[warp] = vmax;
      __syncthreads();
      vmax = red[0];
#pragma unroll
      for (int w = 1; w < kWideWarps; ++w) vmax = nan_max(vmax, red[w]);

      // The reference's stall rule and loop condition, the same in every
      // thread of the block (red is written again only after the next
      // sweeps' barriers).
      const bool improving = vmax < mul_rn(diff, T(0.5));  // false on NaN
      stall = improving ? 0 : stall + 1;
      diff = vmax;
      ++it;
      if (!(diff > xtol && it < P.lim_iter && (!kStallRule || stall < kStallLimit))) break;
    }
    for (int r = tid; r < n; r += kPanThreads) {
      P.x[o + r] = xs[r];
      P.F[o + r] = Fs[r];
    }
    if (tid == 0) {
      P.diff[b] = diff;
      P.n_iter[b] = it;
      P.stall[b] = stall;
    }
  }
}

template <typename T>
using WideKernel = void (*)(const WideParams<T>);

// The kernel of a panel width and route: the widths linsolve_cuda.py:k1_route
// picks (8 or 16 resident; 8, 16 or 32 blocked in float32, 8 or 16 in
// float64), nullptr for any other.
template <typename T, bool kLaneY>
WideKernel<T> wide_kernel_of(int panel, bool resident) {
  if (resident) {
    if (panel == 8) return newton_wide_kernel<T, 8, true, kLaneY>;
    if (panel == 16) return newton_wide_kernel<T, 16, true, kLaneY>;
    return nullptr;
  }
  if (panel == 8) return newton_wide_kernel<T, 8, false, kLaneY>;
  if (panel == 16) return newton_wide_kernel<T, 16, false, kLaneY>;
  if constexpr (sizeof(T) == 4) {
    if (panel == 32) return newton_wide_kernel<T, 32, false, kLaneY>;
  }
  return nullptr;
}

// The blocks of (n, panel, route, Y source) the card holds at once (the
// occupancy query at the launch's shared memory, times the SMs): the most a
// cooperative launch takes, and the slots the wrapper allocates for it; or
// minus a CUDA error.
template <typename T>
int wide_capacity(int n, int panel, bool resident, bool lane_y) {
  const WideKernel<T> kernel = lane_y ? wide_kernel_of<T, true>(panel, resident) : wide_kernel_of<T, false>(panel, resident);
  const size_t smem = wide_smem_bytes<T>(n, panel, resident);
  if (kernel == nullptr || n < 66 || smem > static_cast<size_t>(max_smem_optin())) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  int device = 0, n_sm = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kPanThreads, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (per_sm == 0) return -static_cast<int>(cudaErrorInvalidConfiguration);
  return per_sm * n_sm;
}

// One cooperative launch of `grid` blocks (at most the capacity: a block of
// the grid waits at the grid barrier for all others).
template <typename T>
int launch_wide(const WideParams<T>& W, int panel, bool resident, bool lane_y, int grid, cudaStream_t stream) {
  const int n = 2 * W.P.nb;
  const int cap = wide_capacity<T>(n, panel, resident, lane_y);
  if (cap < 0) return -cap;
  if (grid < 1 || grid > cap) return static_cast<int>(cudaErrorInvalidConfiguration);
  const WideKernel<T> kernel = lane_y ? wide_kernel_of<T, true>(panel, resident) : wide_kernel_of<T, false>(panel, resident);
  WideParams<T> arg = W;
  void* args[] = {&arg};
  cudaError_t err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid), dim3(kPanThreads),
                                                args, wide_smem_bytes<T>(n, panel, resident), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// PR 15's entry point (newton_fallback.cu:newton_wide_entry with its
// newton_params), at (n = 66 up to 2 (2^kFoldLevels - 1)): `grid` blocks,
// each with a slot of `slot` entries in `slots`.
template <typename T>
int pr15_entry(const T* x_in, const T* F_in, const T* diff_in, const int* it_in, const unsigned char* accepted,
               const T* p, const T* q, const T* Yre, const T* Yim, long long y_stride, const long long* br_f,
               const long long* br_t, const T* series_re, const T* series_im, const T* shunt_im, const T* shift_cos,
               const T* shift_sin, const T* tap_magn, int n_branch, double xtol, int lim_iter, T* x, T* F, T* diff,
               int* n_iter, int* stall, int* counters, int* work, int B, int nb, int panel, int resident, T* slots,
               long long slot, int grid, void* stream) {
  if (B <= 0 || counters == nullptr || work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (Yre == nullptr && (tap_magn == nullptr || n_branch <= 0)) return static_cast<int>(cudaErrorInvalidValue);
  const NewtonParams<T> P{x_in, F_in, diff_in, it_in, accepted, p, q, Yre, Yim, y_stride, br_f, br_t,
                          series_re, series_im, shunt_im, shift_cos, shift_sin, tap_magn, n_branch,
                          static_cast<T>(xtol), lim_iter, x, F, diff, n_iter, stall, counters, work, B, nb};
  const long long n = 2LL * nb, N = nb + 1LL;
  const long long need = (resident ? 0 : n * (n + 1)) + (Yre == nullptr ? 2 * N * N : 0);
  if (nb < 33 || N > (1LL << kFoldLevels) || slot < need || (need > 0 && slots == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const WideParams<T> W{P, slots, slot};
  return launch_wide<T>(W, panel, resident != 0, Yre == nullptr, grid, static_cast<cudaStream_t>(stream));
}

}  // namespace
