// Batched unpivoted Gauss-Jordan solve x = A^{-1} b for many tiny dense systems.
//
// Replaces the TPU kernel gym_anm_tpu/physics/linsolve_pallas.py:_gj_kernel
// (wrapped by solve_gauss_jordan_pallas), the linear solve of the exact
// Newton-Raphson load-flow fallback.  It computes what the plain version
// gym_anm_torch/physics/linsolve_cuda.py:solve_gauss_jordan computes:
// n rank-1 sweeps over the augmented [n, n+1] matrix, the pivot row's own
// factor zeroed by a multiply (so a non-finite factor stays non-finite), then
// x[i] = M[i][n] / M[i][i].  No pivoting and no repair of a zero pivot: a zero
// pivot gives inf/NaN, which the Newton loop reads as divergence, exactly
// like the reference.  A pivoted solve could converge a lane the reference
// marks diverged.
//
// Design: one thread block per system.  The augmented matrix lives in shared
// memory for all n sweeps (64 x 65 x 4 B = 16.6 KB at n = 64 in float32), so
// device memory sees one read of A and b and one write of x: at B = 8192,
// n = 64 about 17 MB read and 2 MB written.  The work is about 2 n^3 = 0.5
// MFLOP per system, and each sweep needs two block barriers (2n per system),
// so the kernel is bound by barriers and shared-memory latency, not by
// device memory or arithmetic.  The row stride n + 1 is odd, so the column
// reads of a sweep hit distinct banks.  Warps own rows and lanes own columns,
// so no thread divides an index.  Products and differences are rounded one
// by one (no fused multiply-add), as the plain version rounds them.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

template <typename T>
__global__ void gj_kernel(const T* __restrict__ A, const T* __restrict__ b, T* __restrict__ x, int n) {
  extern __shared__ unsigned char smem_raw[];
  T* M = reinterpret_cast<T*>(smem_raw);  // [n][ld]
  const int ld = n + 1;
  T* prow = M + n * ld;  // [ld]  pivot row of the current sweep
  T* fcol = prow + ld;   // [n]   elimination factors of the current sweep

  const long long sys = blockIdx.x;
  const T* As = A + sys * n * n;
  const T* bs = b + sys * n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  for (int i = warp; i < n; i += n_warps) {
    for (int j = lane; j < n; j += 32) M[i * ld + j] = As[i * n + j];
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) M[i * ld + n] = bs[i];
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    const T pivot = M[k * ld + k];
    for (int j = threadIdx.x; j < ld; j += blockDim.x) prow[j] = M[k * ld + j];
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      fcol[i] = mul_rn(M[i * ld + k] / pivot, i == k ? T(0) : T(1));
    }
    __syncthreads();
    for (int i = warp; i < n; i += n_warps) {
      const T f = fcol[i];
      for (int j = lane; j < ld; j += 32) M[i * ld + j] = sub_rn(M[i * ld + j], mul_rn(f, prow[j]));
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n; i += blockDim.x) x[sys * n + i] = M[i * ld + n] / M[i * ld + i];
}

template <typename T>
int launch(const T* A, const T* b, T* x, int B, int n, void* stream) {
  if (B <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (static_cast<size_t>(n) * (n + 1) + (n + 1) + n) * sizeof(T);
  int device = 0, max_smem = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (smem > static_cast<size_t>(max_smem)) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(gj_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = n > 16 ? 128 : 32;
  gj_kernel<T><<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(A, b, x, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gj_solve_f32(const float* A, const float* b, float* x, int B, int n, void* stream) {
  return launch<float>(A, b, x, B, n, stream);
}

extern "C" int gj_solve_f64(const double* A, const double* b, double* x, int B, int n, void* stream) {
  return launch<double>(A, b, x, B, n, stream);
}
