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
// [N, N] (nr_solve).  A lane's Y is built once, when its slot takes the lane
// (the reference rebuilds the same matrix each iteration).
//
// Design.  The threads of a lane are those of a system of K1's register
// route (gauss_jordan.cuh:gj_regs): one warp for n <= 32, floor(32 / n)
// lanes a warp at n <= 16 (3 at ANM6's n = 10), two warps with a 64-thread
// named barrier for n = 34..64 (IEEE33's n = 64), 4 warps a block.  Thread r
// owns unknown r, its residual F_r and row r of the Jacobian.  A lane's Y,
// V, Y V and V / |V| live in the block's shared memory (IEEE33: ~9 KB float32,
// ~17 KB float64 for Y).  An iteration: thread r builds its row of J from
// row i of Y (i the row's bus) into K1's staging rows in shared memory and
// loads it into registers as K1 loads a system (rows and columns from n to
// the body's size are the identity's), K1's own sweeps (gauss_jordan.cuh:
// sweep/sweeps, unrolled per size) eliminate, thread r updates x_r, then
// threads 0..nb form V and V / |V| of their bus, threads r < n the real or
// imaginary part of (Y V)_i, threads r < n their F_r, and the lane's max |F|
// is a butterfly over the warp (a scan of shared memory where a warp holds
// several lanes).  Lanes come from a work counter (an atomicAdd on a device
// int the wrapper zeroes, as K2 takes them): a lane that does not iterate is
// copied through at its claim, and a slot whose lane exits takes the next
// at the start of the next round.  The grid is persistent (SMs x resident
// blocks).  The host reads no flag: a call is one launch, whatever the
// number of lanes that iterate, zero included.
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
// amplified it into another exit.  The elimination is K1's, bitwise the plain
// solve_gauss_jordan.  sin, cos and sqrt are CUDA's correctly rounded or libm
// functions, as torch's on the card.
//
// Bound (IEEE33, n = 64, float32, H100 SXM): a lane iteration costs the
// Jacobian (~16 operations an entry, 65 K), two mismatches (8 N^2 + ~60 n,
// 9 K) and the elimination (n^2 (n + 1) multiply-subtract pairs, 0.54 M), so
// the elimination dominates and the kernel is bound by operations: a lane
// iteration is ~0.6 MFLOP, 9 ns at 67 TFLOP/s; device memory sees each lane's
// inputs and outputs once (~1.6 KB).  Float64 runs on the CUDA cores' 34
// TFLOP/s.

#include "newton_fallback.cuh"

extern "C" int newton_f32_low(const void* params, int lane_ybus, void* stream);
extern "C" int newton_f32_high(const void* params, int lane_ybus, void* stream);
extern "C" int newton_f64_low(const void* params, int lane_ybus, void* stream);
extern "C" int newton_f64_high(const void* params, int lane_ybus, void* stream);

namespace {

// The body halves by n; lane_ybus: Y from the branch tables (Yre == nullptr).
template <typename T>
int newton_entry(const T* x_in, const T* F_in, const T* diff_in, const int* it_in, const unsigned char* accepted,
                 const T* p, const T* q, const T* Yre, const T* Yim, long long y_stride, const long long* br_f,
                 const long long* br_t, const T* series_re, const T* series_im, const T* shunt_im,
                 const T* shift_cos, const T* shift_sin, const T* tap_magn, int n_branch, double xtol,
                 int lim_iter, T* x, T* F, T* diff, int* n_iter, int* stall, int* next_lane, int B, int nb,
                 void* stream, int (*low)(const void*, int, void*), int (*high)(const void*, int, void*)) {
  if (B <= 0 || nb < 1 || nb > 32) return static_cast<int>(cudaErrorInvalidValue);
  const bool lane_y = Yre == nullptr;
  if (lane_y && (tap_magn == nullptr || n_branch <= 0)) return static_cast<int>(cudaErrorInvalidValue);
  const NewtonParams<T> P{x_in, F_in, diff_in, it_in, accepted, p, q, Yre, Yim, y_stride, br_f, br_t,
                          series_re, series_im, shunt_im, shift_cos, shift_sin, tap_magn, n_branch,
                          static_cast<T>(xtol), lim_iter, x, F, diff, n_iter, stall, next_lane, B, nb};
  return newton_low(2 * nb) ? low(&P, lane_y, stream) : high(&P, lane_y, stream);
}

}  // namespace

extern "C" int newton_fallback_f32(const float* x_in, const float* F_in, const float* diff_in, const int* it_in,
                                   const unsigned char* accepted, const float* p, const float* q, const float* Yre,
                                   const float* Yim, long long y_stride, const long long* br_f,
                                   const long long* br_t, const float* series_re, const float* series_im,
                                   const float* shunt_im, const float* shift_cos, const float* shift_sin,
                                   const float* tap_magn, int n_branch, double xtol, int lim_iter, float* x,
                                   float* F, float* diff, int* n_iter, int* stall, int* next_lane, int B, int nb,
                                   void* stream) {
  return newton_entry<float>(x_in, F_in, diff_in, it_in, accepted, p, q, Yre, Yim, y_stride, br_f, br_t, series_re,
                             series_im, shunt_im, shift_cos, shift_sin, tap_magn, n_branch, xtol, lim_iter, x, F,
                             diff, n_iter, stall, next_lane, B, nb, stream, newton_f32_low, newton_f32_high);
}

extern "C" int newton_fallback_f64(const double* x_in, const double* F_in, const double* diff_in,
                                   const int* it_in, const unsigned char* accepted, const double* p,
                                   const double* q, const double* Yre, const double* Yim, long long y_stride,
                                   const long long* br_f, const long long* br_t, const double* series_re,
                                   const double* series_im, const double* shunt_im, const double* shift_cos,
                                   const double* shift_sin, const double* tap_magn, int n_branch, double xtol,
                                   int lim_iter, double* x, double* F, double* diff, int* n_iter, int* stall,
                                   int* next_lane, int B, int nb, void* stream) {
  return newton_entry<double>(x_in, F_in, diff_in, it_in, accepted, p, q, Yre, Yim, y_stride, br_f, br_t,
                              series_re, series_im, shunt_im, shift_cos, shift_sin, tap_magn, n_branch, xtol,
                              lim_iter, x, F, diff, n_iter, stall, next_lane, B, nb, stream, newton_f64_low,
                              newton_f64_high);
}
