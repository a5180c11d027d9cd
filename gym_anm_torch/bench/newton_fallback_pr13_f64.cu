// PR 13's K3 in double (newton_fallback_pr13.cuh), its entry point renamed
// newton_fallback_pr13_f64 so that it loads beside the current kernel; the
// arguments are those of PR 13's newton_fallback_f64 (next_lane: a device int
// the caller zeroes).  This unit builds the low half of its bodies,
// newton_fallback_pr13_f64_high.cu the high half, beside each other.

#include "newton_fallback_pr13.cuh"

extern "C" int newton_pr13_f64_high(const void* params, int lane_ybus, void* stream);

extern "C" int newton_fallback_pr13_f64(
    const double* x_in, const double* F_in, const double* diff_in, const int* it_in, const unsigned char* accepted,
    const double* p, const double* q, const double* Yre, const double* Yim, long long y_stride, const long long* br_f,
    const long long* br_t, const double* series_re, const double* series_im, const double* shunt_im,
    const double* shift_cos, const double* shift_sin, const double* tap_magn, int n_branch, double xtol, int lim_iter,
    double* x, double* F, double* diff, int* n_iter, int* stall, int* next_lane, int B, int nb, void* stream) {
  if (B <= 0 || nb < 1 || nb > 32) return static_cast<int>(cudaErrorInvalidValue);
  const bool lane_y = Yre == nullptr;
  if (lane_y && (tap_magn == nullptr || n_branch <= 0)) return static_cast<int>(cudaErrorInvalidValue);
  const NewtonParams<double> P{x_in, F_in, diff_in, it_in, accepted, p, q, Yre, Yim, y_stride, br_f, br_t,
                          series_re, series_im, shunt_im, shift_cos, shift_sin, tap_magn, n_branch,
                          static_cast<double>(xtol), lim_iter, x, F, diff, n_iter, stall, next_lane, B, nb};
  if (!newton_low(2 * nb)) return newton_pr13_f64_high(&P, lane_y, stream);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return lane_y ? newton_low_half<double, true>(P, st) : newton_low_half<double, false>(P, st);
}
