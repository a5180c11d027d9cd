// PR 15's K3 wide in double (newton_fallback_wide_pr15.cuh), its entry points
// renamed newton_fallback_wide_pr15_f64 and newton_wide_pr15_f64_grid so that
// they load beside the current kernel; the arguments are those of PR 15's
// newton_fallback_wide_f64 and newton_wide_grid.

#include "newton_fallback_wide_pr15.cuh"

extern "C" int newton_fallback_wide_pr15_f64(
    const double* x_in, const double* F_in, const double* diff_in, const int* it_in, const unsigned char* accepted,
    const double* p, const double* q, const double* Yre, const double* Yim, long long y_stride, const long long* br_f,
    const long long* br_t, const double* series_re, const double* series_im, const double* shunt_im,
    const double* shift_cos, const double* shift_sin, const double* tap_magn, int n_branch, double xtol, int lim_iter,
    double* x, double* F, double* diff, int* n_iter, int* stall, int* counters, int* work, int B, int nb, int panel,
    int resident, double* slots, long long slot, int grid, void* stream) {
  return pr15_entry<double>(x_in, F_in, diff_in, it_in, accepted, p, q, Yre, Yim, y_stride, br_f, br_t, series_re,
                         series_im, shunt_im, shift_cos, shift_sin, tap_magn, n_branch, xtol, lim_iter, x, F, diff,
                         n_iter, stall, counters, work, B, nb, panel, resident, slots, slot, grid, stream);
}

extern "C" int newton_wide_pr15_f64_grid(int n, int panel, int resident, int lane_ybus) {
  return wide_capacity<double>(n, panel, resident != 0, lane_ybus != 0);
}
