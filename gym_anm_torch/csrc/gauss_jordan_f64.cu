// K1's panel routes in float64 (csrc/gauss_jordan.cu describes them), a
// translation unit of its own so that its kernels build beside the float32
// ones.

#include "gauss_jordan.cuh"

// Panels of `panel` pivots (8 or 16), the matrix resident in shared memory.
extern "C" int gj_solve_f64_resident(const double* A, const double* b, double* x, int B, int n, int panel,
                                     void* stream) {
  return launch_panels<double, true>(A, b, x, nullptr, B, n, panel, stream);
}

// Panels of `panel` pivots (8, 16 or 32), the matrix in `scratch` [B, n, n + 1].
extern "C" int gj_solve_f64_blocked(const double* A, const double* b, double* x, double* scratch, int B, int n,
                                    int panel, void* stream) {
  return launch_panels<double, false>(A, b, x, scratch, B, n, panel, stream);
}
