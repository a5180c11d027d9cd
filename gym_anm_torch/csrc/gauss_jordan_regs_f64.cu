// K1's register route in float64 (1 <= n <= 64; csrc/gauss_jordan.cu
// describes it): the entry point and the low half of its bodies (n = 1..28,
// 33..48), a translation unit of its own so that its unrolled bodies build
// beside the high half's and the float32 ones.

#include "gauss_jordan.cuh"

extern "C" int gj_regs_f64_high(const double* A, const double* b, double* x, int B, int n, void* stream);

extern "C" int gj_solve_f64_regs(const double* A, const double* b, double* x, int B, int n, void* stream) {
  if (regs_low(n)) return solve_regs_low<double>(A, b, x, B, n, stream);
  return gj_regs_f64_high(A, b, x, B, n, stream);
}
