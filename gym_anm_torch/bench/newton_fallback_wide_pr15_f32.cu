// PR 15's K3 wide in float (newton_fallback_wide_pr15.cuh), its entry points
// renamed newton_fallback_wide_pr15_f32 and newton_wide_pr15_f32_grid so that
// they load beside the current kernel; the arguments are those of PR 15's
// newton_fallback_wide_f32 and newton_wide_grid.

#include "newton_fallback_wide_pr15.cuh"

extern "C" int newton_fallback_wide_pr15_f32(
    const float* x_in, const float* F_in, const float* diff_in, const int* it_in, const unsigned char* accepted,
    const float* p, const float* q, const float* Yre, const float* Yim, long long y_stride, const long long* br_f,
    const long long* br_t, const float* series_re, const float* series_im, const float* shunt_im,
    const float* shift_cos, const float* shift_sin, const float* tap_magn, int n_branch, double xtol, int lim_iter,
    float* x, float* F, float* diff, int* n_iter, int* stall, int* counters, int* work, int B, int nb, int panel,
    int resident, float* slots, long long slot, int grid, void* stream) {
  return pr15_entry<float>(x_in, F_in, diff_in, it_in, accepted, p, q, Yre, Yim, y_stride, br_f, br_t, series_re,
                         series_im, shunt_im, shift_cos, shift_sin, tap_magn, n_branch, xtol, lim_iter, x, F, diff,
                         n_iter, stall, counters, work, B, nb, panel, resident, slots, slot, grid, stream);
}

extern "C" int newton_wide_pr15_f32_grid(int n, int panel, int resident, int lane_ybus) {
  return wide_capacity<float>(n, panel, resident != 0, lane_ybus != 0);
}
