// K1's register route in float32: the high half of its bodies (n = 29..32,
// 49..64; csrc/gauss_jordan.cu describes the route), called by
// gauss_jordan_regs_f32.cu:gj_solve_f32_regs.

#include "gauss_jordan.cuh"

extern "C" int gj_regs_f32_high(const float* A, const float* b, float* x, int B, int n, void* stream) {
  return solve_regs_high<float>(A, b, x, B, n, stream);
}
