// PR 13's K3 in double: the high half of its bodies (n = 28..32, 50..64), a
// unit of its own so that it builds beside newton_fallback_pr13_f64.cu.

#include "newton_fallback_pr13.cuh"

extern "C" int newton_pr13_f64_high(const void* params, int lane_ybus, void* stream) {
  const NewtonParams<double>& P = *static_cast<const NewtonParams<double>*>(params);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return lane_ybus ? newton_high_half<double, true>(P, st) : newton_high_half<double, false>(P, st);
}
