// K3 wide's cluster route in double (newton_fallback_wide.cuh:
// newton_cluster_kernel; csrc/newton_fallback.cu describes it), a
// translation unit of its own so that nvcc builds its bodies beside the
// other wide bodies.

#include "newton_fallback_wide.cuh"

extern "C" int newton_cluster_f64_launch(const void* params, int panel, int lane_ybus, int clusters, void* stream) {
  const WideParams<double>& W = *static_cast<const WideParams<double>*>(params);
  return launch_cluster<double>(W, panel, lane_ybus != 0, clusters, static_cast<cudaStream_t>(stream));
}

extern "C" int newton_cluster_f64_capacity(int n, int panel, int cluster, int lane_ybus) {
  return cluster_capacity<double>(n, panel, cluster, lane_ybus != 0);
}
