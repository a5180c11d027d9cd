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
// marks diverged.  Every sweep updates all n + 1 columns, the eliminated ones
// too: an eliminated entry is a rounding residue, not exactly 0, and it moves
// the diagonal.  Products and differences are rounded one by one (__fmul_rn,
// __fsub_rn: no fused multiply-add), as the plain version rounds them, so the
// kernel is bitwise equal to it.
//
// Bound (B = 8192, n = 64, float32, H100 SXM): per system 64 sweeps of 64
// divides, 64 mask multiplies and 2 * 64 * 65 multiplies and subtracts, 0.54
// MFLOP, 4.43 GFLOP per call: 66 us at 67 TFLOP/s (FP32 outside the tensor
// cores).  Without fused multiply-adds each multiply and each subtract takes
// its own issue slot, so about 131 us is the floor of this arithmetic.  Device
// memory sees one read of A and b and one write of x, 138 MB: 41 us at 3.35
// TB/s.  So the kernel is bound by operations.
//
// Design, float32 at n <= 64 (gj_regs): each row of a system lives in one
// thread's registers, all n + 1 columns (65 floats at n = 64), for all n
// sweeps.  A system takes one warp for n <= 32 (thread t owns row t) and two
// warps for 33..64 (warp h owns rows 32 h..32 h + 31); for n <= 16 a warp
// holds floor(32 / n) systems (3 at n = 10), so the ANM6 fallback does not
// leave most threads idle.  n is a template parameter and the sweeps are
// fully unrolled (one instantiation per sweep), so every register index is
// static.  In sweep k the owner of row k writes it to the system's pivot-row
// buffer in shared memory (double-buffered by k's parity, so one meeting per
// sweep orders writes and reads: __syncwarp, or a 64-thread named barrier
// for a two-warp system) and every thread of the system reads it back with
// 128-bit broadcast loads and computes its own row's factor.  There is no
// block barrier, and shared memory carries only the pivot row: 260 B per
// sweep at n = 64, where gj_smem (below) reads and writes the whole 16.6 KB
// matrix there in every sweep, between two block barriers.  Two warps
// per system at n = 64 rather than two rows per thread: half the registers
// and half the unrolled code of a warp, and twice the warps in flight.  A warp loads its rows with coalesced 16-byte
// loads through a staging buffer in shared memory (row stride odd, so the
// row reads are free of bank conflicts).  Sizes 33..64 run in a 48- or a
// 64-row body, padded with identity rows and columns: on finite inputs every
// padded operation is an exact identity, so the result is bitwise that of the
// unpadded solve, and the build compiles two large unrolled bodies, not 32.
//
// Design, float64 or n > 64 (gj_smem): one thread block per system, the
// augmented matrix in shared memory (stride n + 1, odd for even n, so column
// reads hit distinct banks), warps own rows and lanes own columns, two block
// barriers per sweep.  It serves the float64 tier and the networks above 33
// buses.
//
// Design, a matrix too large for a block's shared memory (gj_gmem): the same
// kernel with the augmented matrix in a device scratch buffer [B, n, n + 1]
// that the wrapper allocates (the pivot row and the factors stay in shared
// memory).  It sweeps in gj_smem's order and rounds alike, so it is bitwise
// equal to it and to the plain version.  The opt-in limit (227 KB on an H100)
// puts the switch at n = 239 in float32 (networks of 121 buses and more) and
// n = 168 in float64 (86 buses); at n = 258, float64, a system's matrix is
// 535 KB and stays in L2 while its block runs.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int kRegWarps = 4;  // warps per block of gj_regs

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// ---------------------------------------------------------------------------
// gj_regs: float32, each row of a system in one thread's registers.
// ---------------------------------------------------------------------------
template <int NP>
struct RegShape {
  static constexpr int G = NP <= 16 ? 32 / NP : 1;  // systems per warp
  static constexpr int H = NP > 32 ? 2 : 1;         // warps per system
  static constexpr int W = NP + 1;                  // augmented row width
  static constexpr int WP = (W + 3) / 4 * 4;        // pivot-row buffer width (float4 reads)
  static constexpr int SLD = NP | 1;                // staging row stride (odd)
  static constexpr int STAGE = 32 * SLD;
  static constexpr int PROW = 2 * G * WP;
  static constexpr int SMEM = STAGE > PROW ? STAGE : PROW;  // floats per warp
};

// The threads that share a system's pivot rows meet here: the warp, or the
// system's two warps (named barrier 1 + warp / 2, 64 threads).
template <int H>
__device__ __forceinline__ void system_sync(int warp) {
  if constexpr (H == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, 64;" ::"r"(1 + warp / 2) : "memory");
  }
}

// Sweep k: the owner of row k publishes it to the system's pivot-row buffer
// (double-buffered by k's parity, so one meeting per sweep orders writes and
// reads), and every row takes its update.
template <int NP, int k>
__device__ __forceinline__ void sweep(float (&m)[RegShape<NP>::W], int row, float* prow, int s, bool in_sys,
                                      int warp) {
  using S = RegShape<NP>;
  constexpr int G = S::G, W = S::W, WP = S::WP;
  float* buf = prow + (k & 1) * (G * WP) + s * WP;
  if (in_sys && row == k) {
#pragma unroll
    for (int c = 0; c < WP / 4; ++c) {
      float4 v;
      v.x = 4 * c + 0 < W ? m[4 * c + 0] : 0.0f;
      v.y = 4 * c + 1 < W ? m[4 * c + 1] : 0.0f;
      v.z = 4 * c + 2 < W ? m[4 * c + 2] : 0.0f;
      v.w = 4 * c + 3 < W ? m[4 * c + 3] : 0.0f;
      reinterpret_cast<float4*>(buf)[c] = v;
    }
  }
  system_sync<S::H>(warp);
  const float f = mul_rn(m[k] / buf[k], row == k ? 0.0f : 1.0f);
#pragma unroll
  for (int c = 0; c < WP / 4; ++c) {
    const float4 v = reinterpret_cast<const float4*>(buf)[c];
    const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (4 * c + u < W) m[4 * c + u] = sub_rn(m[4 * c + u], mul_rn(f, vv[u]));
    }
  }
}

// All NP sweeps, one instantiation each (a fold over 0..NP-1), so that the
// column index k is static in every one.
template <int NP, int... K>
__device__ __forceinline__ void sweeps(std::integer_sequence<int, K...>, float (&m)[RegShape<NP>::W], int row,
                                       float* prow, int s, bool in_sys, int warp) {
  (sweep<NP, K>(m, row, prow, s, in_sys, warp), ...);
}

// NP: the size in registers.  Up to 32 each size has its own body and n is
// the constant NP; the 48- and 64-row bodies take n (33..64) at run time.
template <int NP>
__global__ void __launch_bounds__(kRegWarps * 32) gj_regs(const float* __restrict__ A, const float* __restrict__ b,
                                                         float* __restrict__ x, int B, int n_rt) {
  using S = RegShape<NP>;
  constexpr int G = S::G, H = S::H, W = S::W, SLD = S::SLD;
  __shared__ __align__(16) float smem[kRegWarps * S::SMEM];
  const int n = NP <= 32 ? NP : n_rt;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int h = warp % H;  // which 32 rows of its system this warp holds
  const long long sys0 = ((long long)blockIdx.x * (kRegWarps / H) + warp / H) * G;
  if (sys0 >= B) return;  // uniform over the system's warps: no block barrier follows
  const int g_here = (int)(B - sys0 < G ? B - sys0 : G);

  // This thread's row: system s, row `row` of it.
  const int s = G > 1 ? (lane / NP < G ? lane / NP : G - 1) : 0;
  const bool in_sys = G > 1 ? lane < G * NP : true;
  const int row = (G > 1 ? lane - s * NP : lane) + 32 * h;
  const bool valid = in_sys && s < g_here && row < n;

  // Stage the warp's rows (all its G n rows, or rows 32 h.. of its system;
  // contiguous in A) through its shared-memory buffer, with coalesced 16-byte
  // loads where the source is aligned, into the row's registers; rows and
  // columns from n to NP are the identity's.
  float* wsm = smem + warp * S::SMEM;
  const int e0 = H == 1 ? 0 : 32 * h * n;
  const int e1 = H == 1 ? g_here * n * n : (32 * (h + 1) < n ? 32 * (h + 1) : n) * n;
  if (e1 > e0) {
    const int cnt = e1 - e0;
    const float* src = A + sys0 * (long long)n * n + e0;
    const int nvec = (reinterpret_cast<uintptr_t>(src) & 15) == 0 ? cnt / 4 : 0;
    for (int q = lane; q < nvec; q += 32) {
      const float4 v = reinterpret_cast<const float4*>(src)[q];
      int lr = 4 * q / n, c = 4 * q - lr * n;
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        wsm[lr * SLD + c] = vv[u];
        if (++c == n) {
          c = 0;
          ++lr;
        }
      }
    }
    for (int e = 4 * nvec + lane; e < cnt; e += 32) {
      const int lr = e / n;
      wsm[lr * SLD + (e - lr * n)] = src[e];
    }
  }
  __syncwarp();
  float m[W];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    float v = row == j ? 1.0f : 0.0f;
    if (valid && j < n) v = wsm[lane * SLD + j];
    m[j] = v;
  }
  m[NP] = valid ? b[(sys0 + s) * n + row] : 0.0f;
  // The pivot-row buffers reuse the staging buffer of the system's first
  // warp, once every warp of the system has read its rows.
  system_sync<H>(warp);
  sweeps<NP>(std::make_integer_sequence<int, NP>{}, m, row, smem + (warp - h) * S::SMEM, s, in_sys, warp);

  float d = m[0];
#pragma unroll
  for (int j = 1; j < NP; ++j) d = row == j ? m[j] : d;
  if (valid) x[(sys0 + s) * n + row] = m[NP] / d;
}

template <int NP>
int launch_regs(const float* A, const float* b, float* x, int B, int n, cudaStream_t stream) {
  constexpr int per_block = kRegWarps / RegShape<NP>::H * RegShape<NP>::G;
  const long long grid = (static_cast<long long>(B) + per_block - 1) / per_block;
  gj_regs<NP><<<static_cast<unsigned>(grid), kRegWarps * 32, 0, stream>>>(A, b, x, B, n);
  return static_cast<int>(cudaGetLastError());
}

// n = 1..32 at their own size.
template <int NP>
int dispatch_exact(const float* A, const float* b, float* x, int B, int n, cudaStream_t stream) {
  if (n == NP) return launch_regs<NP>(A, b, x, B, n, stream);
  if constexpr (NP > 1) {
    return dispatch_exact<NP - 1>(A, b, x, B, n, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

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

// float32, 1 <= n <= 64: the system in registers.
extern "C" int gj_solve_f32_regs(const float* A, const float* b, float* x, int B, int n, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || n <= 0 || n > 64) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 32) return dispatch_exact<32>(A, b, x, B, n, st);
  if (n <= 48) return launch_regs<48>(A, b, x, B, n, st);
  return launch_regs<64>(A, b, x, B, n, st);
}

// Any n whose matrix fits in a block's shared memory.
extern "C" int gj_solve_f32(const float* A, const float* b, float* x, int B, int n, void* stream) {
  return launch_smem<float>(A, b, x, nullptr, B, n, stream);
}

extern "C" int gj_solve_f64(const double* A, const double* b, double* x, int B, int n, void* stream) {
  return launch_smem<double>(A, b, x, nullptr, B, n, stream);
}

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

// The card's opt-in shared memory per block, bytes: gj_smem takes n while
// (n (n + 1) + 2 n + 1) elements fit in it (linsolve_cuda.py).
extern "C" int gj_smem_limit_bytes() { return max_smem_optin(); }
