// K3 wide in float64: its kernels (csrc/newton_fallback.cu describes
// them), a translation unit of its own so that they build beside the other
// type's.

#include "newton_fallback_wide.cuh"

extern "C" int newton_wide_f64_launch(const void* params, int panel, int resident, int lane_ybus, int grid,
                                      void* stream) {
  const WideParams<double>& W = *static_cast<const WideParams<double>*>(params);
  return launch_wide<double>(W, panel, resident != 0, lane_ybus != 0, grid, static_cast<cudaStream_t>(stream));
}

extern "C" int newton_wide_f64_capacity(int n, int panel, int resident, int lane_ybus) {
  return wide_capacity<double>(n, panel, resident != 0, lane_ybus != 0);
}
