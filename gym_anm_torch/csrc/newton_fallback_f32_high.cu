// K3 in float32: the high half of its bodies (n = 28..32, 50..64;
// csrc/newton_fallback.cu describes the kernel), a translation unit of its
// own so that its unrolled bodies build beside the other halves.

#include "newton_fallback.cuh"

extern "C" int newton_f32_high(const void* params, int lane_ybus, void* stream) {
  const NewtonParams<float>& P = *static_cast<const NewtonParams<float>*>(params);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return lane_ybus ? newton_high_half<float, true>(P, st) : newton_high_half<float, false>(P, st);
}
