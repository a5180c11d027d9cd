// PR 13's K3 in float (newton_fallback_pr13.cuh), its entry point renamed
// newton_fallback_pr13_f32 so that it loads beside the current kernel; the
// arguments are those of PR 13's newton_fallback_f32 (next_lane: a device int
// the caller zeroes).  This unit builds the low half of its bodies,
// newton_fallback_pr13_f32_high.cu the high half, beside each other.

#include "newton_fallback_pr13.cuh"

extern "C" int newton_pr13_f32_high(const void* params, int lane_ybus, void* stream);

extern "C" int newton_fallback_pr13_f32(
    const float* x_in, const float* F_in, const float* diff_in, const int* it_in, const unsigned char* accepted,
    const float* p, const float* q, const float* Yre, const float* Yim, long long y_stride, const long long* br_f,
    const long long* br_t, const float* series_re, const float* series_im, const float* shunt_im,
    const float* shift_cos, const float* shift_sin, const float* tap_magn, int n_branch, double xtol, int lim_iter,
    float* x, float* F, float* diff, int* n_iter, int* stall, int* next_lane, int B, int nb, void* stream) {
  if (B <= 0 || nb < 1 || nb > 32) return static_cast<int>(cudaErrorInvalidValue);
  const bool lane_y = Yre == nullptr;
  if (lane_y && (tap_magn == nullptr || n_branch <= 0)) return static_cast<int>(cudaErrorInvalidValue);
  const NewtonParams<float> P{x_in, F_in, diff_in, it_in, accepted, p, q, Yre, Yim, y_stride, br_f, br_t,
                          series_re, series_im, shunt_im, shift_cos, shift_sin, tap_magn, n_branch,
                          static_cast<float>(xtol), lim_iter, x, F, diff, n_iter, stall, next_lane, B, nb};
  if (!newton_low(2 * nb)) return newton_pr13_f32_high(&P, lane_y, stream);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return lane_y ? newton_low_half<float, true>(P, st) : newton_low_half<float, false>(P, st);
}
