// K3 in float64: the low half of its bodies (n = 2..26, 34..48;
// csrc/newton_fallback.cu describes the kernel), a translation unit of its
// own so that its unrolled bodies build beside the other halves.

#include "newton_fallback.cuh"

extern "C" int newton_f64_low(const void* params, int lane_ybus, void* stream) {
  const NewtonParams<double>& P = *static_cast<const NewtonParams<double>*>(params);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return lane_ybus ? newton_low_half<double, true>(P, st) : newton_low_half<double, false>(P, st);
}
