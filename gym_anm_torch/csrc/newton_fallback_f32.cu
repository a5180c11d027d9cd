// K3 in float32: the low half of its bodies (n = 2..26, 34..48;
// csrc/newton_fallback.cu describes the kernel), a translation unit of its
// own so that its unrolled bodies build beside the other halves.

#include "newton_fallback.cuh"

extern "C" int newton_f32_low(const void* params, int lane_ybus, void* stream) {
  const NewtonParams<float>& P = *static_cast<const NewtonParams<float>*>(params);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return lane_ybus ? newton_low_half<float, true>(P, st) : newton_low_half<float, false>(P, st);
}
