// K1's register route in float64: the high half of its bodies (n = 29..32,
// 49..64; csrc/gauss_jordan.cu describes the route), called by
// gauss_jordan_regs_f64.cu:gj_solve_f64_regs.

#include "gauss_jordan.cuh"

extern "C" int gj_regs_f64_high(const double* A, const double* b, double* x, int B, int n, void* stream) {
  return solve_regs_high<double>(A, b, x, B, n, stream);
}
