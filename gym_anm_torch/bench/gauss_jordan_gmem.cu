// The device-memory design of K1 above a block's shared memory, kept as the
// baseline of gym_anm_torch/bench/kernel_probes.py and chip_smoke.py phase
// 10 (the kernel itself is csrc/gauss_jordan.cu:gj_blocked): gj_smem with
// the augmented matrix in a device scratch buffer [B, n, n + 1], one block
// per system, every sweep reading and writing the whole matrix in device
// memory between two block barriers.  Bitwise equal to the plain version
// gym_anm_torch/physics/linsolve_cuda.py:solve_gauss_jordan.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// ---------------------------------------------------------------------------
// gj_smem: one block per system, the matrix in shared memory.
// ---------------------------------------------------------------------------
// kGlobal: the augmented matrix in `scratch` (device memory) rather than in
// shared memory; the sweeps are the same.
template <typename T, bool kGlobal>
__global__ void gj_smem(const T* __restrict__ A, const T* __restrict__ b, T* __restrict__ x, T* __restrict__ scratch,
                        int n) {
  extern __shared__ unsigned char smem_raw[];
  const int ld = n + 1;
  const long long sys = blockIdx.x;
  T* M = kGlobal ? scratch + sys * n * ld : reinterpret_cast<T*>(smem_raw);  // [n][ld]
  T* prow = kGlobal ? reinterpret_cast<T*>(smem_raw) : M + n * ld;           // [ld]  pivot row of the sweep
  T* fcol = prow + ld;                                                       // [n]   elimination factors
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

int max_smem_optin() {
  int device = 0, max_smem = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return max_smem;
}

// scratch == nullptr: the matrix in shared memory (it must fit); else in
// scratch [B, n, n + 1].
template <typename T>
int launch_smem(const T* A, const T* b, T* x, T* scratch, int B, int n, void* stream) {
  if (B <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t vecs = static_cast<size_t>(n + 1) + n;
  const size_t smem = (scratch == nullptr ? static_cast<size_t>(n) * (n + 1) + vecs : vecs) * sizeof(T);
  if (smem > static_cast<size_t>(max_smem_optin())) return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(const T*, const T*, T*, T*, int) = scratch == nullptr ? gj_smem<T, false> : gj_smem<T, true>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = n > 16 ? (scratch == nullptr ? 128 : 256) : 32;
  kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(A, b, x, scratch, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Any n: the matrix in `scratch` [B, n, n + 1].
extern "C" int gj_solve_f32_gmem(const float* A, const float* b, float* x, float* scratch, int B, int n,
                                 void* stream) {
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_smem<float>(A, b, x, scratch, B, n, stream);
}

extern "C" int gj_solve_f64_gmem(const double* A, const double* b, double* x, double* scratch, int B, int n,
                                 void* stream) {
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_smem<double>(A, b, x, scratch, B, n, stream);
}
