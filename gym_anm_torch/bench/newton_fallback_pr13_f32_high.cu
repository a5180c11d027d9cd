// PR 13's K3 in float: the high half of its bodies (n = 28..32, 50..64), a
// unit of its own so that it builds beside newton_fallback_pr13_f32.cu.

#include "newton_fallback_pr13.cuh"

extern "C" int newton_pr13_f32_high(const void* params, int lane_ybus, void* stream) {
  const NewtonParams<float>& P = *static_cast<const NewtonParams<float>*>(params);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return lane_ybus ? newton_high_half<float, true>(P, st) : newton_high_half<float, false>(P, st);
}
