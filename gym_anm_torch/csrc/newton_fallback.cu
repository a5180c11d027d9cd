// Exact Newton-Raphson load-flow fallback (K3): the whole Newton loop of
// every lane that the chord phase left unaccepted, in one launch, each lane
// iterating until its own exit, with no host involvement.
//
// Replaces the reference's device loop gym_anm_tpu/physics/power_flow.py:699
// nr_solve_lazy (the jax.lax.while_loop at :740, cond :719, body :727) and
// the same loop in :755 nr_solve, whose body builds the lane's Y-bus
// (transition.py:ybus_now), forms the mismatch and the Jacobian (_mismatch,
// _jacobian) and solves through the Pallas kernel K1
// (linsolve_pallas.py:_gj_kernel).  It computes what the plain version
// gym_anm_torch/physics/power_flow.py:_newton_loop computes with the plain
// solve: per lane, while diff > xtol, it < lim_iter and (float32 only)
// stall < 3,
//   V, Y V and V / |V| at x; the Jacobian J; x <- x - J^-1 F by unpivoted
//   Gauss-Jordan; F at the new x; diff = max |F| (NaN if any entry is);
//   stall <- 0 if diff < diff_prev / 2, else stall + 1; it <- it + 1;
// a NaN residual ends the lane (diff > xtol is false), as in the reference.
// The iteration counter carries on from the input's (the chord's n_iter:
// lim_iter counts both phases), the stall counter starts at 0, accepted lanes
// and lanes that do not iterate leave as they came (stall 0).  The result
// feeds power_flow.py:_nr_result, the epilogue both versions share.
//
// The Y-bus comes from one of two sources, a template parameter: the branch
// tables and each lane's taps (ybus.py:LaneYbus, nr_solve_lazy), built by
// the formulas of ybus.py:build_ybus with the diagonal summed per bus over the
// incident branches in branch order in float64; or a dense Y [B, N, N] or
// [N, N] (nr_solve).  A lane's Y is built once, when a group takes the lane
// (the reference rebuilds the same matrix each iteration).
//
// Design.  One cooperative launch of a persistent grid (as many blocks as
// the card holds at once, fewer for a small batch), in two phases.
//   1. Triage, by every thread of the grid: a thread a lane reads accepted,
//      diff_in and it_in; a lane that does not iterate gets its diff, n_iter
//      and stall; a lane that iterates joins a worklist in device memory,
//      one atomicAdd a warp (ballot, popc); x and F are copied through for
//      all lanes as flat 16-byte vectors.  The blocks then meet at a grid
//      barrier: arrivals counted by an atomic in device memory, awaited by a
//      spin, which the cooperative launch (cudaLaunchCooperativeKernel)
//      makes safe, since it refuses a grid that is not resident at once; a
//      grid of one block meets at its own barrier.  The wrapper zeroes the
//      three counters (worklist length, next item, arrivals) with one fill.
//   2. Groups of threads take lanes from the worklist (an atomicAdd on the
//      next item) and run each to its exit.  A group spreads its lane's
//      system over TW threads a row: thread (r, t) holds columns t, t + TW,
//      t + 2 TW, ... of row r of [J | F] in registers, so sweep k's pivot
//      column is thread k % TW's register k / TW, a static index when the
//      sweeps run in rounds of TW.  Up to n = 32 a group is one warp, TW =
//      floor(32 / n) (3 at ANM6's n = 10), four groups a block.  The 48- and
//      64-row bodies (n = 34..64, IEEE33's 64) run one block an SM that holds
//      as many groups of TW = 2 (4 warps at n = 64) as fit by registers, or
//      half as many of TW = 4 (8 warps, a lane's sweeps on all four of an
//      SM's schedulers); after the triage every block reads the worklist's
//      length and takes TW = 4 where the lanes that iterate all fit the
//      grid's groups of that width at once (a single lane, the tail, a small
//      batch: each lane's chain is then the kernel's time, and TW = 4
//      shortens it), else TW = 2 (twice the lanes an SM, for batches in
//      which the lanes that iterate outnumber the groups).  Both widths do
//      the same operations on every entry, so the choice moves no bit.  A
//      sweep: the row's TW threads publish their segments to a pivot-row
//      buffer in shared memory (double-buffered by the sweep's parity), the
//      group meets once (the warp's barrier, or the group's named barrier),
//      each thread takes its factor (its row's column k by a shuffle from
//      the thread that holds it, over the pivot) and updates its segment
//      from its segment of the buffer.  An exact zero dividend takes its
//      quotient, the signed zero, by a select: in a sparse Jacobian most
//      rows' column-k entries are zeros, and one such lane sends the warp's
//      division into its slow path (~100 cycles a sweep).  The Jacobian is
//      built entry by entry into the registers that hold it, from the lane's
//      Y, V, Y V and V / |V| in shared memory, both of an entry's formulas
//      (theta or |V| column) formed from unconditional loads and one
//      selected, so that the loads of a thread's entries overlap.  The row's
//      owner, thread (r, NP % TW) (it holds column NP, the residual), keeps
//      x_r and F_r, forms V and V / |V| of bus r and Re or Im of (Y V) of
//      its row's bus, one thread a bus; the lane's max |F| is a butterfly
//      over each warp and a scan of the warps' maxima.
// The host reads no flag: a call is one launch, whatever the number of
// lanes that iterate, zero included.
//
// Numerics follow the plain version op for op.  Every elementwise product,
// sum and quotient is rounded one by one (mul_rn, add_rn, sub_rn, div_rn), so
// nvcc contracts nothing into a fused multiply-add that the plain version
// rounds twice, and the eye factors of _jacobian are multiplied in, so an
// infinite Y V entry gives NaN off the diagonal as there.  The float32
// matrix-vector products are float64 sums rounded once, as
// complexops.py:matmul_full forms them (summed in k order; cuBLAS may sum in
// another, which can move a float32 rounding, rarely).  The float64 ones sum
// in the tree order of power_flow.py:_fold_sum, which the plain version
// follows on the card: cuBLAS's own order moved an ulp, and a diverging lane
// amplified it into another exit.  The elimination does solve_gauss_jordan's
// operations on each entry in its order (the factor a quotient, then the
// mask's product; each update a product, then a difference), the rows and
// columns from n to the body's size padded as K1's register route pads
// them, so K3 is bitwise the plain version.  sin, cos and sqrt are CUDA's
// correctly rounded or libm functions, as torch's on the card.
//
// Bound (IEEE33, n = 64, float32, H100 SXM): a lane iteration costs the
// Jacobian (~14 operations an entry, 57 K), two mismatches (8 N^2 + ~10 n,
// 18 K) and the elimination (n^2 (n + 1) multiply-subtract pairs, 0.54 M), so
// the elimination dominates and a call that iterates is bound by operations
// (~0.6 MFLOP a lane-iteration, 9 ns at 67 TFLOP/s); device memory sees each
// lane's inputs and outputs once (~1.6 KB), which bounds a call where few
// lanes iterate.  Float64 runs on the CUDA cores' 34 TFLOP/s.  Where few
// lanes iterate the kernel is bound by one lane's chain instead: n sweeps a
// lane-iteration, each a meeting of the group, a shared-memory load, a
// shuffle, a division and S = (n + 1) / TW updates a thread.
//
// K3 wide (newton_fallback_wide.cuh; units newton_fallback_wide_f32.cu and
// _f64.cu, the cluster route's newton_fallback_cluster_f32.cu and _f64.cu):
// the same loop above 33 buses (n = 66 and more; the random feeders of 48,
// 64 and 130 buses: n = 94, 126, 258), where a lane's system no longer fits
// a group's registers.  The same triage, grid barrier and
// worklist, one cooperative launch; then one of three routes, chosen by
// newton_cuda.py:wide_route from (n, type, the card's opt-in shared memory)
// alone, never as a fallback:
//   "smem": a block of 256 threads a lane, its [J | F] [n][n + 1] resident
//     in shared memory, while two such blocks fit an SM
//     (linsolve_cuda.py:k1_route with the lane's vectors counted; on an H100
//     float32 n = 94, 126 and float64 n = 94);
//   "cluster": above that, while a cluster of C = 2, 4 or 8 blocks of 256
//     threads holds the rows (float32 n = 258 on 2 blocks, float64 n = 126
//     on 2, n = 258 on 4): a lane a thread-block cluster, [J | F]'s panels
//     of BP = 16 (float32; else 8) pivot rows dealt round the blocks' shared
//     memory, each panel's rows pushed by its owner into every block
//     through distributed shared memory (mapa), the blocks meeting at
//     cluster barriers (barrier.cluster, release / acquire); a lone lane
//     runs on C SMs;
//   "blocked": above a cluster of 8, a block of 256 a lane with [J | F] in
//     a slot of device memory, one slot a block of the grid (never one a
//     lane).
// A lane's Y-bus is built once into the block's slot (LaneYbus; each block
// of a cluster builds its own) or read in place (dense).  Each iteration: V
// and V / |V| (a thread a bus) and Y V (by dot_full's rules: float64 sums
// rounded once in float32; in float64 power_flow.py:_fold_sum's tree at the
// run-time N, its 64, 128 or 256 leaves walked depth first by a thread, or
// on the cluster route by a warp, the lanes' leaves l + 32 m folded in the
// lane and then by shuffles); [J | F] a warp a row, the entries as K3 forms
// them; the elimination by K1's panel body (gauss_jordan.cuh:
// gj_panel_sweeps: panels of 8, 16 or 32 pivots, the diagonal block on one
// warp, each entry read and written once a panel), or on the cluster route
// by ClusterLane::sweeps (the same operations on every entry in the same
// order; the next panel's owner updates that panel's rows first and
// factors its diagonal block on one warp while its other warps go on, so
// the diagonal block leaves the panel's chain; a row's factors with K3's
// select of an exact zero's quotient; 3 or 4 columns a thread in the
// trailing update, so that a load of the factors serves them all), bitwise
// K1's panel routes and the plain solve; x <- x - J^-1 F from the last panel; the new F and its max (a
// butterfly a warp, then the warps', then the cluster's blocks'); the same
// stall rule and exit.  No host sync: the card never runs the plain loop.
//
// Bound (the 130-bus feeder, n = 258, float32): the elimination's n^2 (n +
// 1) multiply-subtract pairs, 34.5 MFLOP a lane-iteration, 0.51 us at 67
// TFLOP/s, far above the Jacobian's and the mismatches' ~1.3 M; device
// memory sees a lane's inputs and outputs once.  Each product and each
// difference is rounded apart (the plain version's bits), one instruction
// each: a fused multiply-add would do both in one, so the reachable rate is
// half the FMA peak the bound is taken at.  On the blocked route each panel
// reads and writes the lane's [J | F] once (267 KB at n = 258) from a
// block's slot in L2; on the cluster route it stays in shared memory, and a
// lane's chain is n / BP panels of one cluster barrier, one block barrier
// and a thread's panel row or column.

#include "newton_fallback_wide.cuh"

using NewtonHalf = int (*)(const void*, int, void*);
using WideLaunch = int (*)(const void*, int, int, int, int, void*);
extern "C" int newton_f32_low(const void* params, int lane_ybus, void* stream);
extern "C" int newton_f32_high(const void* params, int lane_ybus, void* stream);
extern "C" int newton_f64_low(const void* params, int lane_ybus, void* stream);
extern "C" int newton_f64_high(const void* params, int lane_ybus, void* stream);
extern "C" int newton_wide_f32_launch(const void* params, int panel, int resident, int lane_ybus, int grid,
                                      void* stream);
extern "C" int newton_wide_f64_launch(const void* params, int panel, int resident, int lane_ybus, int grid,
                                      void* stream);
extern "C" int newton_cluster_f32_launch(const void* params, int panel, int lane_ybus, int clusters, void* stream);
extern "C" int newton_cluster_f64_launch(const void* params, int panel, int lane_ybus, int clusters, void* stream);
extern "C" int newton_cluster_f32_capacity(int n, int panel, int cluster, int lane_ybus);
extern "C" int newton_cluster_f64_capacity(int n, int panel, int cluster, int lane_ybus);
extern "C" int newton_wide_f32_capacity(int n, int panel, int resident, int lane_ybus);
extern "C" int newton_wide_f64_capacity(int n, int panel, int resident, int lane_ybus);

namespace {

// The K3 launch's parameters, or a CUDA error where the pointers do not fit
// the Y source (lane_y: Y from the branch tables, Yre == nullptr).
template <typename T>
int newton_params(NewtonParams<T>& P, const T* x_in, const T* F_in, const T* diff_in, const int* it_in,
                  const unsigned char* accepted, const T* p, const T* q, const T* Yre, const T* Yim,
                  long long y_stride, const long long* br_f, const long long* br_t, const T* series_re,
                  const T* series_im, const T* shunt_im, const T* shift_cos, const T* shift_sin, const T* tap_magn,
                  int n_branch, double xtol, int lim_iter, T* x, T* F, T* diff, int* n_iter, int* stall,
                  int* counters, int* work, int B, int nb) {
  if (B <= 0 || counters == nullptr || work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (Yre == nullptr && (tap_magn == nullptr || n_branch <= 0)) return static_cast<int>(cudaErrorInvalidValue);
  P = NewtonParams<T>{x_in, F_in, diff_in, it_in, accepted, p, q, Yre, Yim, y_stride, br_f, br_t,
                      series_re, series_im, shunt_im, shift_cos, shift_sin, tap_magn, n_branch,
                      static_cast<T>(xtol), lim_iter, x, F, diff, n_iter, stall, counters, work, B, nb};
  return 0;
}

}  // namespace

#define K3_ARGS(T)                                                                                                  \
  const T *x_in, const T *F_in, const T *diff_in, const int *it_in, const unsigned char *accepted, const T *p,     \
      const T *q, const T *Yre, const T *Yim, long long y_stride, const long long *br_f, const long long *br_t,   \
      const T *series_re, const T *series_im, const T *shunt_im, const T *shift_cos, const T *shift_sin,          \
      const T *tap_magn, int n_branch, double xtol, int lim_iter, T *x, T *F, T *diff, int *n_iter, int *stall,  \
      int *counters, int *work, int B, int nb
#define K3_PASS                                                                                                    \
  x_in, F_in, diff_in, it_in, accepted, p, q, Yre, Yim, y_stride, br_f, br_t, series_re, series_im, shunt_im,     \
      shift_cos, shift_sin, tap_magn, n_branch, xtol, lim_iter, x, F, diff, n_iter, stall, counters, work, B, nb

namespace {

// K3 (n = 2..64): the body halves by n.
template <typename T>
int newton_entry(K3_ARGS(T), void* stream, NewtonHalf low, NewtonHalf high) {
  NewtonParams<T> P;
  const int rc = newton_params<T>(P, K3_PASS);
  if (rc != 0) return rc;
  if (nb < 1 || nb > 32) return static_cast<int>(cudaErrorInvalidValue);
  return (newton_low(2 * nb) ? low : high)(&P, Yre == nullptr, stream);
}

// K3 wide (n = 66 up to 2 (2^kFoldLevels - 1)): `grid` blocks, each with a
// slot of `slot` entries in `slots` (the lane's [J | F] off the resident
// route, and the lane's Y where it is built).
template <typename T>
int newton_wide_entry(K3_ARGS(T), int panel, int resident, T* slots, long long slot, int grid, void* stream,
                      WideLaunch launch) {
  NewtonParams<T> P;
  const int rc = newton_params<T>(P, K3_PASS);
  if (rc != 0) return rc;
  const long long n = 2LL * nb, N = nb + 1LL;
  const long long need = (resident ? 0 : n * (n + 1)) + (Yre == nullptr ? 2 * N * N : 0);
  if (nb < 33 || N > (1LL << kFoldLevels) || slot < need || (need > 0 && slots == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const WideParams<T> W{P, slots, slot, 1};
  return launch(&W, panel, resident, Yre == nullptr, grid, stream);
}

// K3 wide's cluster route: `clusters` clusters of `cluster` blocks, each
// block with a slot of `slot` entries in `slots` (the lane's Y where it is
// built).
template <typename T>
int newton_cluster_entry(K3_ARGS(T), int panel, int cluster, T* slots, long long slot, int clusters, void* stream,
                         int (*launch)(const void*, int, int, int, void*)) {
  NewtonParams<T> P;
  const int rc = newton_params<T>(P, K3_PASS);
  if (rc != 0) return rc;
  const long long N = nb + 1LL;
  const long long need = Yre == nullptr ? 2 * N * N : 0;
  if (nb < 33 || N > (1LL << kFoldLevels) || slot < need || (need > 0 && slots == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const WideParams<T> W{P, slots, slot, cluster};
  return launch(&W, panel, Yre == nullptr, clusters, stream);
}

}  // namespace

extern "C" int newton_fallback_f32(K3_ARGS(float), void* stream) {
  return newton_entry<float>(K3_PASS, stream, newton_f32_low, newton_f32_high);
}

extern "C" int newton_fallback_f64(K3_ARGS(double), void* stream) {
  return newton_entry<double>(K3_PASS, stream, newton_f64_low, newton_f64_high);
}

extern "C" int newton_fallback_wide_f32(K3_ARGS(float), int panel, int resident, float* slots, long long slot,
                                        int grid, void* stream) {
  return newton_wide_entry<float>(K3_PASS, panel, resident, slots, slot, grid, stream, newton_wide_f32_launch);
}

extern "C" int newton_fallback_wide_f64(K3_ARGS(double), int panel, int resident, double* slots, long long slot,
                                        int grid, void* stream) {
  return newton_wide_entry<double>(K3_PASS, panel, resident, slots, slot, grid, stream, newton_wide_f64_launch);
}

extern "C" int newton_fallback_cluster_f32(K3_ARGS(float), int panel, int cluster, float* slots, long long slot,
                                           int clusters, void* stream) {
  return newton_cluster_entry<float>(K3_PASS, panel, cluster, slots, slot, clusters, stream,
                                     newton_cluster_f32_launch);
}

extern "C" int newton_fallback_cluster_f64(K3_ARGS(double), int panel, int cluster, double* slots, long long slot,
                                           int clusters, void* stream) {
  return newton_cluster_entry<double>(K3_PASS, panel, cluster, slots, slot, clusters, stream,
                                      newton_cluster_f64_launch);
}

// The blocks of K3 wide the card holds at once at (type, n, panel, route, Y
// source): the largest grid, and the slots, of a launch; minus a CUDA error
// where there is no such kernel or its shared memory does not fit.
extern "C" int newton_wide_grid(int f64, int n, int panel, int resident, int lane_ybus) {
  return (f64 ? newton_wide_f64_capacity : newton_wide_f32_capacity)(n, panel, resident, lane_ybus);
}

// A block's dynamic shared memory at (type, n, panel, route), bytes.
extern "C" long long newton_wide_smem_bytes(int f64, int n, int panel, int resident) {
  return static_cast<long long>(f64 ? wide_smem_bytes<double>(n, panel, resident != 0)
                                    : wide_smem_bytes<float>(n, panel, resident != 0));
}

// The card's opt-in shared memory a block, bytes: the route rule's limit
// (linsolve_cuda.py:k1_route).
extern "C" int newton_wide_smem_limit() { return max_smem_optin(); }

// The card's L2 cache, bytes, or minus a CUDA error: the bound of the batch
// rule on the blocked route's slots (newton_cuda.py:batch_route).
extern "C" int newton_l2_bytes() {
  int device = 0, v = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&v, cudaDevAttrL2CacheSize, device);
  return err == cudaSuccess ? v : -static_cast<int>(err);
}

// The clusters of K3 wide's cluster route the card holds at once at (type,
// n, panel, C, Y source): the largest grid of a launch, in clusters; minus a
// CUDA error where there is no such kernel or its shared memory does not
// fit.
extern "C" int newton_cluster_grid(int f64, int n, int panel, int cluster, int lane_ybus) {
  return (f64 ? newton_cluster_f64_capacity : newton_cluster_f32_capacity)(n, panel, cluster, lane_ybus);
}

// A block's dynamic shared memory on the cluster route at (type, n, panel,
// C), bytes.
extern "C" long long newton_cluster_smem_bytes(int f64, int n, int panel, int cluster) {
  return static_cast<long long>(f64 ? cluster_smem_bytes<double>(n, panel, cluster)
                                    : cluster_smem_bytes<float>(n, panel, cluster));
}
