// K3 wide's device code (csrc/newton_fallback.cu describes the kernel): the
// exact Newton loop of networks above 33 buses (n = 66 unknowns and more).
// K3's triage, grid barrier, worklist claim and Y-bus builder, then either
// a block a lane, the lane's [J | F] in the block's shared memory (route
// "smem") or in its slot of device memory (route "blocked"), eliminated by
// K1's panel body (gauss_jordan.cuh:gj_panel_sweeps); or a thread-block
// cluster a lane (route "cluster"), [J | F] dealt by panels of rows over
// the cluster's shared memory, eliminated by ClusterLane::sweeps below.
// Four translation units instantiate it, two a type:
// newton_fallback_wide_f32.cu and _f64.cu (routes "smem" and "blocked"),
// newton_fallback_cluster_f32.cu and _f64.cu (route "cluster").

#pragma once

#include <type_traits>

#include "newton_fallback.cuh"

namespace {

constexpr int kFoldLevels = 12;  // levels of the float64 Y V tree: networks of up to 4096 buses
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
  int cluster;  // blocks a lane: C on route "cluster", else 1
};

// The blocks an SM each one-block body's launch bounds fit by registers:
// float32 resident, K1's four (64 registers a thread) at panels of 16, three
// (80) at panels of 8, which K1's rule takes where the shared memory holds
// three (the 64-bus feeder); two of every other body (128).  At 64
// registers the panel-16 bodies still spill 40 bytes (the earlier
// block-a-lane design spilled 16-68 there); at 80 they would lose the
// fourth block.  The kernel holds little else across the sweeps
// (WideBlock, thread_x).
template <typename T, int BP, bool kResident>
constexpr int kWideMinBlocks = sizeof(T) == 4 && kResident ? (BP == 8 ? 3 : 4) : 2;

// v, as a value the compiler cannot see through: what is computed from it
// after this point is computed anew, not held in a register from before.
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

// threadIdx.x, read anew at each call (an instruction the compiler does not
// merge with another read), so that it is not held across the sweeps.
__device__ __forceinline__ int thread_x() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

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

// The float64 sum over k < N of y[k] v[k] in power_flow.py:_fold_sum's order
// (2^L >= 64 leaves, zeros past N), by a warp: lane l takes the leaves
// l + 32 m and folds its 2^(L-5) of them as _fold_sum folds them (the halves
// added until one is left), walked depth first: leaf i of the walk is m =
// bit-reversed i, and a finished subtree's sum waits at its level for its
// sibling's; then the lanes' sums are folded by shuffles, 16 apart, then 8,
// ... 1.  Lane 0 holds the sum; each sum is rounded on its own.  Every
// wide route's float64 Y V (power_flow.py:_ybus_matvec on the card).
__device__ __forceinline__ double dot_fold_warp(const double* y, const double* v, int N, int L, int lane) {
  constexpr int kLaneLevels = kFoldLevels - 5;
  const int Lm = L - 5;  // L >= 6: N >= 34 on this route
  double st[kLaneLevels];
  double s = 0.0;
  for (int i = 0; i < (1 << Lm); ++i) {
    const int m = Lm == 0 ? 0 : static_cast<int>(__brev(static_cast<unsigned>(i)) >> (32 - Lm));
    const int k = lane + 32 * m;
    s = k < N ? __dmul_rn(y[k], v[k]) : 0.0;
    bool open = true;
#pragma unroll
    for (int l = 0; l < kLaneLevels; ++l) {
      if (open && ((i >> l) & 1)) {
        s = __dadd_rn(st[l], s);
      } else if (open) {
        st[l] = s;
        open = false;
      }
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) s = __dadd_rn(s, __shfl_down_sync(kWarpMask, s, d));
  return s;
}

// A block of the one-block routes, laid out from nb: K1's panels (gj_panels'
// layout) and the resident matrix in shared memory, then the lane's V, V /
// |V| and Y V (N each), x, F and the injections (n each), the warps' maxima
// (32) and the claim's cell; the lane's [J | F] on route "blocked" and its
// Y where it is built (kLaneY) in the block's slot of device memory.  The
// kernel lays it out anew after each elimination from an opaque nb, so
// that no address of it is held in a register across the sweeps.
template <typename T, int BP, bool kResident, bool kLaneY>
struct WideBlock {
  int nb, n, N, ld, L;
  T *fp, *pr, *Fd, *D, *M, *Vr, *Vi, *Ur, *Ui, *Wr, *Wi, *xs, *Fs, *pq, *red, *slot;
  int* cell;
  const T* Yr;
  const T* Yi;

  __device__ __forceinline__ WideBlock(const WideParams<T>& W, unsigned char* raw, int nb_) {
    nb = nb_, n = 2 * nb, N = nb + 1, ld = n + 1;
    const int ldn = (n + 3) / 4 * 4;
    L = 1;
    while ((1 << L) < N) ++L;
    fp = reinterpret_cast<T*>(raw);
    pr = fp + BP * ldn;
    Fd = pr + BP * ld;
    D = Fd + BP * BP;
    slot = W.slots + static_cast<long long>(opaque(static_cast<int>(blockIdx.x))) * W.slot;
    M = kResident ? D + BP * BP : slot;
    Vr = D + BP * BP + (kResident ? n * ld : 0);
    Vi = Vr + N;
    Ur = Vi + N;
    Ui = Ur + N;
    Wr = Ui + N;
    Wi = Wr + N;
    xs = Wi + N;
    Fs = xs + n;
    pq = Fs + n;
    red = pq + n;
    cell = reinterpret_cast<int*>(red + 32);
  }

  // Lane b's Y: in the slot past [J | F] (kLaneY), else the dense Y's.
  __device__ __forceinline__ void lane(const NewtonParams<T>& P, int b) {
    if constexpr (kLaneY) {
      Yr = slot + (kResident ? 0 : static_cast<long long>(n) * ld);
      Yi = Yr + N * N;
    } else {
      Yr = P.Yre + b * P.y_stride;
      Yi = P.Yim + b * P.y_stride;
    }
  }

  // V, V / |V| at x (a thread a bus) and Y V (float64 a warp a row in the
  // fold's order, float32 a thread a row: Re of its bus's on a theta row,
  // Im on a |V| row), as K3's owners form them.
  __device__ __forceinline__ void vectors() {
    const int tid = thread_x(), lane = tid & 31, warp = tid >> 5;
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
    if constexpr (sizeof(T) == 8) {
      for (int r = warp; r < n; r += kWideWarps) {
        const int bus = r < nb ? r + 1 : r - nb + 1;
        const T a = dot_fold_warp(Yr + bus * N, r < nb ? Vr : Vi, N, L, lane);
        const T c = dot_fold_warp(Yi + bus * N, r < nb ? Vi : Vr, N, L, lane);
        if (lane == 0) (r < nb ? Wr : Wi)[bus] = r < nb ? sub_rn(a, c) : add_rn(a, c);
      }
    } else {  // float64 sums in k order rounded once
      for (int r = tid; r < n; r += kPanThreads) {
        const int bus = r < nb ? r + 1 : r - nb + 1;
        const T* yr = Yr + bus * N;
        const T* yi = Yi + bus * N;
        if (r < nb) {
          Wr[bus] = sub_rn(dot_full<1>(yr, Vr, N), dot_full<1>(yi, Vi, N));
        } else {
          Wi[bus] = add_rn(dot_full<1>(yr, Vi, N), dot_full<1>(yi, Vr, N));
        }
      }
    }
    __syncthreads();
  }

  // [J | F] (power_flow.py:_jacobian, each operation rounded as the plain
  // version rounds it, the eye factors included), a warp a row.
  __device__ __forceinline__ void jacobian() {
    const int lane = thread_x() & 31, warp = thread_x() >> 5;
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
  }

  // The new mismatch F and its max over the lane, the same in every thread
  // of the block (red is written again only after the next sweeps'
  // barriers).
  __device__ __forceinline__ T mismatch() {
    const int tid = thread_x(), lane = tid & 31, warp = tid >> 5;
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
    return vmax;
  }
};

// The kernel: the triage, a grid barrier, then each block takes a lane at a
// time from the worklist and runs it to its exit.  BP: the panel width;
// kResident: [J | F] in shared memory (else in the block's slot); kLaneY:
// the Y-bus built from the branch tables in the block's slot (else read in
// place from the dense Y).  Across the sweeps the block holds only the
// lane's diff, n_iter and stall (and x's address for the sweeps' exit);
// the rest is laid out anew after them, the lane from the claim's cell.
template <typename T, int BP, bool kResident, bool kLaneY>
__global__ void __launch_bounds__(kPanThreads, kWideMinBlocks<T, BP, kResident>)
    newton_wide_kernel(const WideParams<T> W) {
  using Block = WideBlock<T, BP, kResident, kLaneY>;
  const NewtonParams<T>& P = W.P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr bool kStallRule = sizeof(T) == 4;  // the float32 tier's plateau exit

  triage(P, 2 * P.nb);
  grid_barrier(P.counters + 2);

  while (true) {
    Block S(W, smem_raw, opaque(P.nb));
    const int count = __ldcg(P.counters);
    const int i = claim<kWideWarps>(P.counters + 1, count, S.cell, thread_x(), 0);
    if (i >= count) break;
    int b = __ldcg(P.work + i);
    S.lane(P, b);

    // The lane's start, its Y-bus, its vectors.
    const int n = S.n, nb = S.nb;
    const long long o = static_cast<long long>(b) * n, ob = static_cast<long long>(b) * nb;
    for (int r = thread_x(); r < n; r += kPanThreads) {
      S.xs[r] = P.x_in[o + r];
      S.Fs[r] = P.F_in[o + r];
      S.pq[r] = r < nb ? P.p[ob + r] : P.q[ob + r - nb];
    }
    T diff = P.diff_in[b];
    int it = P.it_in[b], stall = 0;
    if constexpr (kLaneY) {
      T* const yr = const_cast<T*>(S.Yr);
      T* const yi = const_cast<T*>(S.Yi);
      for (int e = thread_x(); e < S.N * S.N; e += kPanThreads) {
        yr[e] = T(0);
        yi[e] = T(0);
      }
      __syncthreads();
      lane_ybus<T, 1>(P, b, S.N, yr, yi, thread_x(), kPanThreads);
    }
    __syncthreads();
    S.vectors();

    while (true) {
      S.jacobian();
      // The elimination, K1's panel sweeps, then x <- x - J^-1 F.
      T* const xs = S.xs;
      gj_panel_sweeps<T, BP>(static_cast<const T*>(nullptr), static_cast<const T*>(nullptr), S.M, S.fp, S.pr, S.Fd,
                             S.D, S.n, [xs](int r, T dx) { xs[r] = sub_rn(xs[r], dx); });
      S = Block(W, smem_raw, opaque(P.nb));
      b = __ldcg(P.work + *S.cell);
      S.lane(P, b);

      S.vectors();
      const T vmax = S.mismatch();
      // The reference's stall rule and loop condition, the same in every
      // thread of the block.
      const bool improving = vmax < mul_rn(diff, T(0.5));  // false on NaN
      stall = improving ? 0 : stall + 1;
      diff = vmax;
      ++it;
      if (!(diff > P.xtol && it < P.lim_iter && (!kStallRule || stall < kStallLimit))) break;
    }
    const long long ox = static_cast<long long>(b) * S.n;
    for (int r = thread_x(); r < S.n; r += kPanThreads) {
      P.x[ox + r] = S.xs[r];
      P.F[ox + r] = S.Fs[r];
    }
    if (thread_x() == 0) {
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

// ---------------------------------------------------------------------------
// Route "cluster": a lane on a thread-block cluster of C blocks (2, 4 or 8).
// ---------------------------------------------------------------------------
constexpr int kClThreads = 256;  // a block of the cluster route, one an SM (255 registers a thread)
constexpr int kClWarps = kClThreads / 32;
constexpr int kClMax = 8;  // the portable cluster size

// Columns a thread of the cluster route's step 3 at n unknowns: of 3 or 4
// (float32; float64 2 or 3: its 4-column lane-Y body spilled at 255
// registers), the count that leaves fewer of a warp's columns past n + 1
// idle, the larger on a tie: 3 at n = 258, 2 at float64 n = 126.  Each
// load of 4 rows' factors then serves that many columns; at one column a
// thread the loads, not the arithmetic, bounded step 3.
__host__ __device__ inline int cluster_cols(int n, int itemsize) {
  const int lo = itemsize == 4 ? 3 : 2, ld = n + 1;
  const int w_lo = (ld + 32 * lo - 1) / (32 * lo) * (32 * lo);
  const int w_hi = (ld + 32 * lo + 31) / (32 * lo + 32) * (32 * lo + 32);
  return w_lo < w_hi ? lo : lo + 1;
}

// This block's rank in its cluster.
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}

// Every thread of the cluster meets here; what each wrote before, to its own
// or another block's shared memory or to device memory, is seen by all after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\tbarrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The address of p's counterpart in the shared memory of block `rank` of the
// cluster (distributed shared memory, a generic address).
template <typename T>
__device__ __forceinline__ T* cluster_map(T* p, int rank) {
  unsigned long long a;
  asm volatile("mapa.u64 %0, %1, %2;" : "=l"(a) : "l"(reinterpret_cast<unsigned long long>(p)), "r"(rank));
  return reinterpret_cast<T*>(a);
}

// Rows of [J | F] a block of the cluster holds at most: the panels of BP
// pivot rows are dealt round the cluster, panel p to block p % C, so that
// each panel's pivot rows lie in one block.
__host__ __device__ inline int cluster_rows(int n, int bp, int C) {
  const int panels = (n + bp - 1) / bp;
  return bp * ((panels + C - 1) / C);
}

// A block's shared memory on route "cluster": its rows of [J | F] [R][n + 1],
// their column panel [BP][R], the pivot rows [2][BP][n + 1], the diagonal
// block's factors and pivot rows [2][BP][BP] each (double-buffered by the
// panel's parity), the blocks' maxima [kClMax], then wide_lane_bytes.
// newton_cuda.py:cluster_smem_bytes is the same sum.
template <typename T>
size_t cluster_smem_bytes(int n, int bp, int C) {
  const size_t R = cluster_rows(n, bp, C), ld = static_cast<size_t>(n) + 1;
  return sizeof(T) * (R * ld + bp * R + 2 * bp * ld + 4 * static_cast<size_t>(bp) * bp + kClMax) +
         wide_lane_bytes<T>(n);
}

// Step 2 for a row of the block (gauss_jordan.cuh:column_row's operations):
// its panel's columns read from the row itself, its factor at each pivot
// (the pivot row's own times 0) written to column li of the column panel fp
// [BP][ldf] once all are formed, from the diagonal block's pivot rows D.
// 0 / piv is the signed zero 0 * sign(piv) for piv neither 0 nor NaN:
// selected, as K3 selects it, so that no thread's exact zero sends the
// division to its slow path (most of a feeder's Jacobian entries are zeros).
// gi: the row's index in [J | F].
template <typename T, int BP>
__device__ __forceinline__ void cl_column_row(const T* row, T* fp, int ldf, const T* D, int li, int gi, int k0,
                                              int bw) {
  T c[BP], f[BP];
#pragma unroll
  for (int cc = 0; cc < BP; ++cc) c[cc] = cc < bw ? row[k0 + cc] : T(0);
#pragma unroll
  for (int kk = 0; kk < BP; ++kk) {
    f[kk] = T(0);
    if (kk < bw) {
      const T* Dk = D + kk * BP;
      const T piv = Dk[kk], mk = c[kk];
      const bool zero = mk == T(0) && piv == piv && piv != T(0);
      const T q = div_rn(zero ? T(1) : mk, piv);
      f[kk] = mul_rn(zero ? mul_rn(mk, copysign(T(1), piv)) : q, gi == k0 + kk ? T(0) : T(1));
#pragma unroll
      for (int q4 = (kk + 1) / 4; q4 < BP / 4; ++q4) {
        T dv[4];
        load4(Dk + 4 * q4, dv);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (4 * q4 + u > kk) c[4 * q4 + u] = sub_rn(c[4 * q4 + u], mul_rn(f[kk], dv[u]));
        }
      }
    }
  }
#pragma unroll
  for (int kk = 0; kk < BP; ++kk) {
    if (kk < bw) fp[kk * ldf + li] = f[kk];
  }
}

// dst[e] = src[e] for e < cnt in every block of the cluster (dst a local
// address, mapped to each block's), by threads t < nthr, in 16-byte vectors
// where both are aligned.
template <typename T>
__device__ __forceinline__ void cluster_push(const T* src, T* dst, int cnt, int C, int t, int nthr) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  const int nvec = vec ? cnt / V : 0;
  for (int q = 0; q < C; ++q) {
    T* const d = cluster_map(dst, q);
    for (int i = t; i < nvec; i += nthr) reinterpret_cast<int4*>(d)[i] = reinterpret_cast<const int4*>(src)[i];
    for (int e = V * nvec + t; e < cnt; e += nthr) d[e] = src[e];
  }
}

// One lane's Gauss-Jordan elimination on the cluster, then x <- x - J^-1 F
// in every block: gj_panel_sweeps' operations on every entry, in the same
// order, with [J | F]'s rows dealt by panels (block rank holds panels rank,
// rank + C, ...; local row li of local panel li / BP).  A panel p is
// pushed, with its diagonal block factored (diag_block), by its owner into
// every block (pr, F, D [p & 1]) before the cluster meets at its start;
// each block then forms its rows' factors and the panel's rows (step 2),
// meets at a block barrier, and updates its rows (step 3).  Look-ahead: the
// owner of panel p + 1 updates that panel's rows first, factors its
// diagonal block on warp 0 and pushes both while its other warps go on
// with step 3; step 3's units (32 columns by a local panel) are claimed
// from a counter, so warp 0 joins late without a straggler.  (Forming the
// pivot-row panel on the owner's warp 0 as well, so that step 2 is only the
// block's rows, made the owner the cluster's straggler.)  Every thread
// of the cluster calls it, after lookahead(0) by block 0 and a cluster
// barrier; it ends on a cluster barrier.
template <typename T, int BP, int CW>
struct ClusterLane {
  T* M;    // [R][ld] this block's rows
  T* fp;   // [BP][R] their factors at the panel's pivots
  T* pr0;  // [2][BP][ld] the panel's rows, by its parity
  T* FD0;  // [2][2][BP][BP] the diagonal block's factors F and pivot rows D, a pair a parity
  int* ctr;
  int n, ld, C, rank, R, panels, my_panels, Rb;

  __device__ __forceinline__ T* Fb(int buf) const { return FD0 + buf * 2 * BP * BP; }
  __device__ __forceinline__ T* Db(int buf) const { return Fb(buf) + BP * BP; }

  __device__ __forceinline__ int glob(int li) const {
    const int lp = li / BP;
    return (lp * C + rank) * BP + (li - lp * BP);
  }

  // By the owner of panel p (every thread of its block), its rows as they
  // stand before panel p: the diagonal block on warp 0 (its factors and
  // pivot rows, then pushed), the rows pushed by the other warps.
  __device__ __forceinline__ void lookahead(int p, int tid) const {
    const int k0 = p * BP, bw = n - k0 < BP ? n - k0 : BP, buf = p & 1;
    const T* rows = M + (p / C) * BP * ld;
    if (tid < 32) {
      diag_block<T, BP>(rows, ld, k0, bw, Fb(buf), Db(buf), tid);
      __syncwarp();
      cluster_push(Fb(buf), Fb(buf), 2 * BP * BP, C, tid, 32);  // F and D
    } else {
      cluster_push(rows, pr0 + buf * BP * ld, bw * ld, C, tid - 32, kClThreads - 32);
    }
  }

  // Step 3 on CW columns a thread (chunk cj: columns 32 (CW cj + c) +
  // lane) of this block's row groups [g0, g1) (4 rows each): every entry's
  // BP updates in k order.  A load of 4 rows' factors serves the thread's
  // CW columns.
  __device__ __forceinline__ void trail(const T* pr, int cj, int g0, int g1, int lane) const {
    int j[CW];
    bool jv[CW];
    T p[CW][BP];
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      j[c] = 32 * (CW * cj + c) + lane;
      jv[c] = j[c] < ld;
#pragma unroll
      for (int kk = 0; kk < BP; ++kk) p[c][kk] = jv[c] ? pr[kk * ld + j[c]] : T(0);
    }
    for (int g = g0; g < g1; ++g) {
      const int i = 4 * g;
      T v[CW][4];
#pragma unroll
      for (int c = 0; c < CW; ++c) {
#pragma unroll
        for (int r = 0; r < 4; ++r) v[c][r] = (jv[c] && i + r < Rb) ? M[(i + r) * ld + j[c]] : T(0);
      }
#pragma unroll
      for (int kk = 0; kk < BP; ++kk) {
        T f[4];
        load4(fp + kk * R + i, f);
#pragma unroll
        for (int c = 0; c < CW; ++c) {
#pragma unroll
          for (int r = 0; r < 4; ++r) v[c][r] = sub_rn(v[c][r], mul_rn(f[r], p[c][kk]));
        }
      }
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        if (jv[c]) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if (i + r < Rb) M[(i + r) * ld + j[c]] = v[c][r];
          }
        }
      }
    }
  }

  template <typename Out>
  __device__ __forceinline__ void sweeps(int tid, Out out) const {
    const int lane = tid & 31, warp = tid >> 5;
    const int nc = (ld + 32 * CW - 1) / (32 * CW), gpp = BP / 4, ng = (Rb + 3) / 4;
    for (int p = 0; p < panels; ++p) {
      const int k0 = p * BP, bw = n - k0 < BP ? n - k0 : BP, buf = p & 1;
      T* const pr = pr0 + buf * BP * ld;
      // Step 2: this block's rows of the column panel and the n + 1 columns
      // of the pivot-row panel, one a thread.
      for (int w = tid; w < Rb + ld; w += kClThreads) {
        if (w < Rb) {
          cl_column_row<T, BP>(M + w * ld, fp, R, Db(buf), w, glob(w), k0, bw);
        } else {
          pivot_col<T, BP>(pr, ld, Fb(buf), w - Rb, bw);
        }
      }
      if (tid == 0) *ctr = 0;
      __syncthreads();
      if (k0 + bw < n) {
        // Step 3, the next panel's owner first on that panel's rows.
        const int next = (p + 1) % C == rank ? (p + 1) / C : -1;
        if (next >= 0) {
          for (int u = warp; u < nc * gpp; u += kClWarps) {
            const int g = next * gpp + u % gpp;
            trail(pr, u / gpp, g, g + 1 < ng ? g + 1 : ng, lane);
          }
          __syncthreads();
          lookahead(p + 1, tid);
        }
        const int total = nc * my_panels;
        while (true) {
          int u = 0;
          if (lane == 0) u = atomicAdd(ctr, 1);
          u = __shfl_sync(kWarpMask, u, 0);
          if (u >= total) break;
          const int lp = u % my_panels, g0 = lp * gpp;
          if (lp != next) trail(pr, u / my_panels, g0, g0 + gpp < ng ? g0 + gpp : ng, lane);
        }
      } else {
        // The last panel: only the diagonal and column n, then x.
        for (int li = tid; li < Rb; li += kClThreads) {
          const int gi = glob(li);
          T d = M[li * ld + gi], r = M[li * ld + n];
          for (int kk = 0; kk < bw; ++kk) {
            const T f = fp[kk * R + li];
            d = sub_rn(d, mul_rn(f, pr[kk * ld + gi]));
            r = sub_rn(r, mul_rn(f, pr[kk * ld + n]));
          }
          out(gi, div_rn(r, d));
        }
      }
      cluster_sync();
    }
  }
};

// The cluster route's kernel: the triage and grid barrier (a cooperative
// launch of clusters), then each cluster takes a lane at a time from the
// worklist and runs it to its exit, every exchange between its blocks
// through distributed shared memory.  Each block builds the lane's Y in its
// own slot where it comes from the branch tables (kLaneY), holds V, V / |V|,
// Y V and x whole, and forms Y V, F and the max for its own rows.
template <typename T, int BP, int CW, bool kLaneY>
__global__ void __launch_bounds__(kClThreads, 1) newton_cluster_kernel(const WideParams<T> W) {
  const NewtonParams<T>& P = W.P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr bool kStallRule = sizeof(T) == 4;  // the float32 tier's plateau exit
  const int nb = P.nb, n = 2 * nb, N = nb + 1, ld = n + 1, C = W.cluster;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = cluster_rank();
  int L = 1;
  while ((1 << L) < N) ++L;
  ClusterLane<T, BP, CW> S;
  S.n = n, S.ld = ld, S.C = C, S.rank = rank, S.R = cluster_rows(n, BP, C), S.panels = (n + BP - 1) / BP;
  S.my_panels = (S.panels - rank + C - 1) / C;
  S.Rb = 0;
  if (S.my_panels > 0) {
    const int k_last = ((S.my_panels - 1) * C + rank) * BP;
    S.Rb = (S.my_panels - 1) * BP + (n - k_last < BP ? n - k_last : BP);
  }
  const int R = S.R, Rb = S.Rb;
  S.M = reinterpret_cast<T*>(smem_raw);
  S.fp = S.M + R * ld;
  S.pr0 = S.fp + BP * R;
  S.FD0 = S.pr0 + 2 * BP * ld;
  T* const cmax = S.FD0 + 4 * BP * BP;
  T* const Vr = cmax + kClMax;
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
  S.ctr = cell + 1;
  T* const slot = W.slots + static_cast<long long>(blockIdx.x) * W.slot;
  const T xtol = P.xtol;

  triage<T, 8>(P, n);
  grid_barrier(P.counters + 2);  // every block of the grid has started: the cluster's shared memory is there
  const int count = __ldcg(P.counters);

  // V, V / |V| at x for every bus (a thread a bus), then Y V of this block's
  // rows (Re on a theta row, Im on a |V| row; float64 a warp a row in the
  // fold's order, float32 a thread a row), pushed to every block.
  auto vectors = [&](const T* Yr, const T* Yi) {
    for (int k = tid; k <= nb; k += kClThreads) {  // the slack is 1 + 0j
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
    if constexpr (sizeof(T) == 8) {
      for (int li = warp; li < Rb; li += kClWarps) {
        const int r = S.glob(li);
        const int bus = r < nb ? r + 1 : r - nb + 1;
        const T* yr = Yr + bus * N;
        const T* yi = Yi + bus * N;
        const T a = dot_fold_warp(yr, r < nb ? Vr : Vi, N, L, lane);
        const T c = dot_fold_warp(yi, r < nb ? Vi : Vr, N, L, lane);
        const T w = __shfl_sync(kWarpMask, r < nb ? sub_rn(a, c) : add_rn(a, c), 0);
        if (lane < C) cluster_map(r < nb ? Wr : Wi, lane)[bus] = w;
      }
    } else {
      for (int li = tid; li < Rb; li += kClThreads) {
        const int r = S.glob(li);
        const int bus = r < nb ? r + 1 : r - nb + 1;
        const T* yr = Yr + bus * N;
        const T* yi = Yi + bus * N;
        const T w = r < nb ? sub_rn(dot_full<1>(yr, Vr, N), dot_full<1>(yi, Vi, N))
                           : add_rn(dot_full<1>(yr, Vi, N), dot_full<1>(yi, Vr, N));
        for (int q = 0; q < C; ++q) cluster_map(r < nb ? Wr : Wi, q)[bus] = w;
      }
    }
    cluster_sync();
  };

  while (true) {
    // The cluster's next worklist item: block 0 claims, every block reads
    // its cell (and is done reading before the next claim writes it).
    if (rank == 0 && tid == 0) *cell = __ldcg(P.counters + 1) >= count ? count : atomicAdd(P.counters + 1, 1);
    cluster_sync();
    const int i = *cluster_map(cell, 0);
    cluster_sync();
    if (i >= count) break;
    const int b = __ldcg(P.work + i);

    // The lane's start, its Y-bus, its vectors.
    const long long o = static_cast<long long>(b) * n, ob = static_cast<long long>(b) * nb;
    for (int r = tid; r < n; r += kClThreads) {
      xs[r] = P.x_in[o + r];
      Fs[r] = P.F_in[o + r];
      pq[r] = r < nb ? P.p[ob + r] : P.q[ob + r - nb];
    }
    T diff = P.diff_in[b];
    int it = P.it_in[b], stall = 0;
    const T* Yr;
    const T* Yi;
    if constexpr (kLaneY) {
      T* const yr = slot;
      T* const yi = yr + N * N;
      for (int e = tid; e < N * N; e += kClThreads) {
        yr[e] = T(0);
        yi[e] = T(0);
      }
      __syncthreads();
      lane_ybus<T, 1>(P, b, N, yr, yi, tid, kClThreads);
      Yr = yr;
      Yi = yi;
    } else {
      Yr = P.Yre + b * P.y_stride;
      Yi = P.Yim + b * P.y_stride;
    }
    __syncthreads();
    vectors(Yr, Yi);

    while (true) {
      // This block's rows of [J | F] (newton_wide_kernel's operations), a
      // warp a row.
      for (int li = warp; li < Rb; li += kClWarps) {
        const int r = S.glob(li);
        const int bus = r < nb ? r + 1 : r - nb + 1;
        const bool p_row = r < nb;
        const T vri = Vr[bus], vii = Vi[bus];
        const T* yr = Yr + bus * N;
        const T* yi = Yi + bus * N;
        T* const row = S.M + li * ld;
        for (int c = lane; c < n; c += 32) {
          const bool theta = c < nb;
          const int k = theta ? c + 1 : c - nb + 1;
          const T eye = k == bus ? T(1) : T(0);
          const T yre = yr[k], yim = yi[k], vrk = Vr[k], vik = Vi[k], wrk = Wr[k], wik = Wi[k];
          const T urk = Ur[k], uik = Ui[k];
          const T M_re = add_rn(sub_rn(mul_rn(wrk, eye), mul_rn(yre, vrk)), mul_rn(yim, vik));
          const T M_im = sub_rn(sub_rn(mul_rn(wik, eye), mul_rn(yre, vik)), mul_rn(yim, vrk));
          const T Jt = p_row ? -sub_rn(mul_rn(vii, M_re), mul_rn(vri, M_im))
                             : add_rn(mul_rn(vri, M_re), mul_rn(vii, M_im));
          const T B_re = sub_rn(mul_rn(yre, urk), mul_rn(yim, uik));
          const T B_im = add_rn(mul_rn(yre, uik), mul_rn(yim, urk));
          const T Cc = p_row ? add_rn(mul_rn(vri, B_re), mul_rn(vii, B_im))
                             : sub_rn(mul_rn(vii, B_re), mul_rn(vri, B_im));
          const T d = p_row ? add_rn(mul_rn(urk, wrk), mul_rn(uik, wik))
                            : sub_rn(mul_rn(uik, wrk), mul_rn(urk, wik));
          row[c] = theta ? Jt : add_rn(Cc, mul_rn(d, eye));
        }
        if (lane == 0) row[n] = Fs[r];
      }
      __syncthreads();
      if (rank == 0) S.lookahead(0, tid);
      cluster_sync();

      // The elimination; x <- x - J^-1 F in every block.
      S.sweeps(tid, [&](int r, T dx) {
        const T v = sub_rn(xs[r], dx);
        for (int q = 0; q < C; ++q) cluster_map(xs, q)[r] = v;
      });

      // The new mismatch of this block's rows and its max over the lane.
      vectors(Yr, Yi);
      T vmax = T(0);
      for (int li = tid; li < Rb; li += kClThreads) {
        const int r = S.glob(li);
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
      if (tid == 0) {
        T m = red[0];
#pragma unroll
        for (int w = 1; w < kClWarps; ++w) m = nan_max(m, red[w]);
        for (int q = 0; q < C; ++q) cluster_map(cmax, q)[rank] = m;
      }
      cluster_sync();
      vmax = cmax[0];
      for (int q = 1; q < C; ++q) vmax = nan_max(vmax, cmax[q]);

      // The reference's stall rule and loop condition, the same in every
      // thread of the cluster (cmax is written again only after the next
      // sweeps' cluster barriers).
      const bool improving = vmax < mul_rn(diff, T(0.5));  // false on NaN
      stall = improving ? 0 : stall + 1;
      diff = vmax;
      ++it;
      if (!(diff > xtol && it < P.lim_iter && (!kStallRule || stall < kStallLimit))) break;
    }
    for (int li = tid; li < Rb; li += kClThreads) P.F[o + S.glob(li)] = Fs[S.glob(li)];
    if (rank == 0) {
      for (int r = tid; r < n; r += kClThreads) P.x[o + r] = xs[r];
      if (tid == 0) {
        P.diff[b] = diff;
        P.n_iter[b] = it;
        P.stall[b] = stall;
      }
    }
  }
}

// The cluster kernel of a panel width (16 or 8 in float32, 8 in float64:
// at 16 its float64 body spilled at 255 registers) and of n's columns a
// thread (cluster_cols), nullptr for any other panel.
template <typename T, int CW, bool kLaneY>
WideKernel<T> cluster_kernel_at(int panel) {
  if constexpr (sizeof(T) == 4) {
    if (panel == 16) return newton_cluster_kernel<T, 16, CW, kLaneY>;
  }
  if (panel == 8) return newton_cluster_kernel<T, 8, CW, kLaneY>;
  return nullptr;
}

template <typename T>
WideKernel<T> cluster_kernel_of(int n, int panel, bool lane_y) {
  constexpr int lo = sizeof(T) == 4 ? 3 : 2;
  if (cluster_cols(n, sizeof(T)) == lo) {
    return lane_y ? cluster_kernel_at<T, lo, true>(panel) : cluster_kernel_at<T, lo, false>(panel);
  }
  return lane_y ? cluster_kernel_at<T, lo + 1, true>(panel) : cluster_kernel_at<T, lo + 1, false>(panel);
}

// The launch configuration of `clusters` clusters of C blocks.
inline cudaLaunchConfig_t cluster_config(int clusters, int C, size_t smem, cudaLaunchAttribute* attrs, int n_attrs,
                                         cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * C);
  cfg.blockDim = dim3(kClThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attrs;
  cfg.numAttrs = n_attrs;
  return cfg;
}

// The clusters of (n, panel, C, Y source) the card holds at once (the
// occupancy query for clusters): the most a cooperative launch takes, and
// the slots (C a cluster) the wrapper allocates; or minus a CUDA error.
template <typename T>
int cluster_capacity(int n, int panel, int C, bool lane_y) {
  const WideKernel<T> kernel = cluster_kernel_of<T>(n, panel, lane_y);
  const size_t smem = cluster_smem_bytes<T>(n, panel, C);
  if (kernel == nullptr || n < 66 || C < 2 || C > kClMax || smem > static_cast<size_t>(max_smem_optin())) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  const cudaLaunchConfig_t cfg = cluster_config(1, C, smem, attr, 1, nullptr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (clusters == 0) return -static_cast<int>(cudaErrorInvalidConfiguration);
  return clusters;
}

// One cooperative launch of `clusters` clusters of C blocks (at most the
// capacity: a block waits at the grid barrier for all others).  A launch
// the card refuses returns its error; nothing stands in for it.
template <typename T>
int launch_cluster(const WideParams<T>& W, int panel, bool lane_y, int clusters, cudaStream_t stream) {
  const int n = 2 * W.P.nb, C = W.cluster;
  const int cap = cluster_capacity<T>(n, panel, C, lane_y);
  if (cap < 0) return -cap;
  if (clusters < 1 || clusters > cap) return static_cast<int>(cudaErrorInvalidConfiguration);
  const WideKernel<T> kernel = cluster_kernel_of<T>(n, panel, lane_y);
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  const cudaLaunchConfig_t cfg = cluster_config(clusters, C, cluster_smem_bytes<T>(n, panel, C), attr, 2, stream);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, W);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
