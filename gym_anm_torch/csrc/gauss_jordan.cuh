// K1's device code (csrc/gauss_jordan.cu describes the kernel and its
// routes): the rounded operations, 16-byte shared-memory accesses, the
// register route gj_regs and the panel routes gj_panels.  Six translation
// units instantiate them, so that nvcc builds the unrolled bodies in
// parallel: gauss_jordan.cu (the panel routes in float32),
// gauss_jordan_f64.cu (in float64), and gauss_jordan_regs_f32.cu,
// gauss_jordan_regs_f32_high.cu, gauss_jordan_regs_f64.cu and
// gauss_jordan_regs_f64_high.cu (the register route's two halves a type).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int kRegWarps = 4;  // warps per block of gj_regs

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// One 16-byte access: 4 floats or 2 doubles.
__device__ __forceinline__ void ld16(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}
__device__ __forceinline__ void ld16(const double* p, double* v) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  v[0] = a.x, v[1] = a.y;
}
__device__ __forceinline__ void st16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st16(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// Four consecutive entries of a shared-memory array (16-byte aligned).
template <typename T>
__device__ __forceinline__ void load4(const T* p, T (&v)[4]) {
  ld16(p, v);
  if constexpr (sizeof(T) == 8) ld16(p + 2, v + 2);
}

// ---------------------------------------------------------------------------
// gj_regs: each row of a system in one thread's registers.
// ---------------------------------------------------------------------------
template <typename T, int NP>
struct RegShape {
  static constexpr int G = NP <= 16 ? 32 / NP : 1;  // systems per warp
  static constexpr int H = NP > 32 ? 2 : 1;         // warps per system
  static constexpr int W = NP + 1;                  // augmented row width
  static constexpr int V = 16 / sizeof(T);          // entries of a 16-byte access
  static constexpr int WP = (W + V - 1) / V * V;    // pivot-row buffer width
  static constexpr int SLD = NP | 1;                // staging row stride (odd)
  static constexpr int STAGE = 32 * SLD;
  static constexpr int PROW = 2 * G * WP;
  static constexpr int SMEM = STAGE > PROW ? STAGE : PROW;  // entries per warp
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
template <typename T, int NP, int k>
__device__ __forceinline__ void sweep(T (&m)[RegShape<T, NP>::W], int row, T* prow, int s, bool in_sys, int warp) {
  using S = RegShape<T, NP>;
  constexpr int G = S::G, W = S::W, WP = S::WP, V = S::V;
  T* buf = prow + (k & 1) * (G * WP) + s * WP;
  if (in_sys && row == k) {
#pragma unroll
    for (int c = 0; c < WP / V; ++c) {
      T v[V];
#pragma unroll
      for (int u = 0; u < V; ++u) v[u] = V * c + u < W ? m[V * c + u] : T(0);
      st16(buf + V * c, v);
    }
  }
  system_sync<S::H>(warp);
  const T f = mul_rn(div_rn(m[k], buf[k]), row == k ? T(0) : T(1));
#pragma unroll
  for (int c = 0; c < WP / V; ++c) {
    T vv[V];
    ld16(buf + V * c, vv);
#pragma unroll
    for (int u = 0; u < V; ++u) {
      if (V * c + u < W) m[V * c + u] = sub_rn(m[V * c + u], mul_rn(f, vv[u]));
    }
  }
}

// All NP sweeps, one instantiation each (a fold over 0..NP-1), so that the
// column index k is static in every one.
template <typename T, int NP, int... K>
__device__ __forceinline__ void sweeps(std::integer_sequence<int, K...>, T (&m)[RegShape<T, NP>::W], int row,
                                       T* prow, int s, bool in_sys, int warp) {
  (sweep<T, NP, K>(m, row, prow, s, in_sys, warp), ...);
}

// NP: the size in registers.  Up to 32 each size has its own body and n is
// the constant NP; the 48- and 64-row bodies take n (33..64) at run time.
template <typename T, int NP>
__global__ void __launch_bounds__(kRegWarps * 32) gj_regs(const T* __restrict__ A, const T* __restrict__ b,
                                                         T* __restrict__ x, int B, int n_rt) {
  using S = RegShape<T, NP>;
  constexpr int G = S::G, H = S::H, W = S::W, SLD = S::SLD, V = S::V;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
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
  T* wsm = smem + warp * S::SMEM;
  const int e0 = H == 1 ? 0 : 32 * h * n;
  const int e1 = H == 1 ? g_here * n * n : (32 * (h + 1) < n ? 32 * (h + 1) : n) * n;
  if (e1 > e0) {
    const int cnt = e1 - e0;
    const T* src = A + sys0 * (long long)n * n + e0;
    const int nvec = (reinterpret_cast<uintptr_t>(src) & 15) == 0 ? cnt / V : 0;
    for (int q = lane; q < nvec; q += 32) {
      T vv[V];
      ld16(src + V * q, vv);
      int lr = V * q / n, c = V * q - lr * n;
#pragma unroll
      for (int u = 0; u < V; ++u) {
        wsm[lr * SLD + c] = vv[u];
        if (++c == n) {
          c = 0;
          ++lr;
        }
      }
    }
    for (int e = V * nvec + lane; e < cnt; e += 32) {
      const int lr = e / n;
      wsm[lr * SLD + (e - lr * n)] = src[e];
    }
  }
  __syncwarp();
  T m[W];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    T v = row == j ? T(1) : T(0);
    if (valid && j < n) v = wsm[lane * SLD + j];
    m[j] = v;
  }
  m[NP] = valid ? b[(sys0 + s) * n + row] : T(0);
  // The pivot-row buffers reuse the staging buffer of the system's first
  // warp, once every warp of the system has read its rows.
  system_sync<H>(warp);
  sweeps<T, NP>(std::make_integer_sequence<int, NP>{}, m, row, smem + (warp - h) * S::SMEM, s, in_sys, warp);

  T d = m[0];
#pragma unroll
  for (int j = 1; j < NP; ++j) d = row == j ? m[j] : d;
  if (valid) x[(sys0 + s) * n + row] = div_rn(m[NP], d);
}

template <typename T, int NP>
int launch_regs(const T* A, const T* b, T* x, int B, int n, cudaStream_t stream) {
  constexpr int per_block = kRegWarps / RegShape<T, NP>::H * RegShape<T, NP>::G;
  const size_t smem = sizeof(T) * kRegWarps * RegShape<T, NP>::SMEM;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(gj_regs<T, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long grid = (static_cast<long long>(B) + per_block - 1) / per_block;
  gj_regs<T, NP><<<static_cast<unsigned>(grid), kRegWarps * 32, smem, stream>>>(A, b, x, B, n);
  return static_cast<int>(cudaGetLastError());
}

// n = LO..HI at their own size.
template <typename T, int LO, int HI>
int dispatch_exact(const T* A, const T* b, T* x, int B, int n, cudaStream_t stream) {
  if (n == HI) return launch_regs<T, HI>(A, b, x, B, n, stream);
  if constexpr (HI > LO) {
    return dispatch_exact<T, LO, HI - 1>(A, b, x, B, n, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The register route's bodies in two halves of about equal build time, each
// instantiated by a translation unit of its own: the low half takes n =
// 1..28 at their own size and 33..48 in the 48-row body, the high half n =
// 29..32 and 49..64 in the 64-row body.
inline bool regs_low(int n) {
  return (n >= 1 && n <= 28) || (n >= 33 && n <= 48);
}

template <typename T>
int solve_regs_low(const T* A, const T* b, T* x, int B, int n, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || !regs_low(n)) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 28) return dispatch_exact<T, 1, 28>(A, b, x, B, n, st);
  return launch_regs<T, 48>(A, b, x, B, n, st);
}

template <typename T>
int solve_regs_high(const T* A, const T* b, T* x, int B, int n, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || n < 29 || n > 64 || regs_low(n)) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 32) return dispatch_exact<T, 29, 32>(A, b, x, B, n, st);
  return launch_regs<T, 64>(A, b, x, B, n, st);
}

inline int max_smem_optin() {
  int device = 0, max_smem = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return max_smem;
}

// ---------------------------------------------------------------------------
// gj_panels: blocked Gauss-Jordan, the matrix resident in shared memory
// (kResident) or in a device scratch buffer.
// ---------------------------------------------------------------------------
constexpr int kPanThreads = 256;
// The blocks an SM each panel kernel is compiled to fit by its registers
// (at most 65536 / (256 x this) a thread): four resident float32 blocks
// (64 registers), three float64 (85), two blocked (128).  Left to itself
// ptxas gave some widths 156 registers (one block an SM) and others spills.
// linsolve_cuda.py:RESIDENT_REG_BLOCKS mirrors the resident values.
template <typename T, bool kResident>
constexpr int kPanMinBlocks = kResident ? (sizeof(T) == 4 ? 4 : 3) : 2;

// Shared memory of a block, in entries: the column panel [BP][ldn] (column
// by column, ldn = n rounded up to 4), the pivot-row panel [BP][n + 1], the
// diagonal block's factors F [BP][BP] and pivot rows D [BP][BP], and on the
// resident route the matrix [n][n + 1].  linsolve_cuda.py:panel_smem_bytes
// is the same sum.
template <typename T>
size_t panel_smem_bytes(int n, int bp, bool resident) {
  const size_t ldn = (static_cast<size_t>(n) + 3) / 4 * 4, ld = static_cast<size_t>(n) + 1;
  return sizeof(T) * (bp * (ldn + ld) + 2 * static_cast<size_t>(bp) * bp + (resident ? n * ld : 0));
}

// Step 1, one warp: the diagonal block's sweeps, lane r holding row r of the
// block as the pivot-row panel has it.  At pivot kk lane kk writes its row,
// final now, to D[kk]; every lane r > kk computes its factor F[kk][r] =
// f_{k0+r}(kk), the one the plain version computes at sweep k0 + kk (an
// IEEE division), and updates its columns right of kk from row kk (a shuffle
// from lane kk each).  Columns left of kk are not kept: nothing reads them.
template <typename T, int BP>
__device__ __forceinline__ void diag_block(const T* pr, int ld, int k0, int bw, T* F, T* D, int lane) {
  const bool rv = lane < bw;
  T d[BP];
#pragma unroll
  for (int c = 0; c < BP; ++c) d[c] = (rv && c < bw) ? pr[lane * ld + k0 + c] : T(0);
#pragma unroll
  for (int kk = 0; kk < BP; ++kk) {
    if (kk < bw) {
      if (lane == kk) {
#pragma unroll
        for (int q = 0; q < BP / 4; ++q) {
          const T v[4] = {d[4 * q], d[4 * q + 1], d[4 * q + 2], d[4 * q + 3]};
          st16(D + kk * BP + 4 * q, v);
          if constexpr (sizeof(T) == 8) st16(D + kk * BP + 4 * q + 2, v + 2);
        }
      }
      const bool below = rv && lane > kk;
      const T f = mul_rn(div_rn(d[kk], __shfl_sync(0xffffffffu, d[kk], kk)), T(1));
      if (below) F[kk * BP + lane] = f;
#pragma unroll
      for (int c = kk + 1; c < BP; ++c) {
        const T pk = __shfl_sync(0xffffffffu, d[c], kk);
        d[c] = below ? sub_rn(d[c], mul_rn(f, pk)) : d[c];
      }
    }
  }
}

// Step 2, a row i of the column panel: its factor at each pivot (the pivot
// row's own times 0), then its later columns, from D; the factors replace
// the panel's entries.
template <typename T, int BP>
__device__ __forceinline__ void column_row(T* fp, int ldn, const T* D, int i, int k0, int bw) {
  T c[BP];
#pragma unroll
  for (int cc = 0; cc < BP; ++cc) c[cc] = cc < bw ? fp[cc * ldn + i] : T(0);
#pragma unroll
  for (int kk = 0; kk < BP; ++kk) {
    if (kk < bw) {
      const T* Dk = D + kk * BP;
      const T f = mul_rn(div_rn(c[kk], Dk[kk]), i == k0 + kk ? T(0) : T(1));
      fp[kk * ldn + i] = f;
#pragma unroll
      for (int q = (kk + 1) / 4; q < BP / 4; ++q) {
        T dv[4];
        load4(Dk + 4 * q, dv);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (4 * q + u > kk) c[4 * q + u] = sub_rn(c[4 * q + u], mul_rn(f, dv[u]));
        }
      }
    }
  }
}

// Step 2, a column j of the pivot-row panel: its later rows at each pivot,
// from F; the rows as they stand at their own sweep replace the panel's.
template <typename T, int BP>
__device__ __forceinline__ void pivot_col(T* pr, int ld, const T* F, int j, int bw) {
  T p[BP];
#pragma unroll
  for (int r = 0; r < BP; ++r) p[r] = r < bw ? pr[r * ld + j] : T(0);
#pragma unroll
  for (int kk = 0; kk < BP; ++kk) {
    if (kk < bw) {
#pragma unroll
      for (int q = (kk + 1) / 4; q < BP / 4; ++q) {
        T fv[4];
        load4(F + kk * BP + 4 * q, fv);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (4 * q + u > kk) p[4 * q + u] = sub_rn(p[4 * q + u], mul_rn(fv[u], p[kk]));
        }
      }
    }
  }
#pragma unroll
  for (int r = 1; r < BP; ++r) {
    if (r < bw) pr[r * ld + j] = p[r];
  }
}

// One system's blocked Gauss-Jordan by a block of kPanThreads threads: the
// matrix's home M [n][n + 1] (shared or device memory), the first panel read
// from A and b where As is given (else M already holds [A | b]), the panels
// in shared memory at fp, pr, F, D; out(i, x_i) takes each x_i = M[i][n] /
// M[i][i] of the last panel.  Every thread of the block calls it, and it
// ends on a block barrier.  K1's panel routes and the wide Newton kernel
// (newton_fallback_wide.cuh) run this body.
template <typename T, int BP, typename Out>
__device__ __forceinline__ void gj_panel_sweeps(const T* As, const T* bs, T* M, T* fp, T* pr, T* F, T* D, int n,
                                                Out out) {
  const int ld = n + 1, ldn = (n + 3) / 4 * 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kPanThreads / 32;
  for (int k0 = 0; k0 < n; k0 += BP) {
    const int bw = n - k0 < BP ? n - k0 : BP;
    const bool first = k0 == 0 && As != nullptr, last = k0 + bw == n;
    // The matrix as it stood before this panel: A and b, or its home.
    auto at = [&](int i, int j) -> T { return first ? (j < n ? As[i * n + j] : bs[i]) : M[i * ld + j]; };

    // Load both panels (the padding rows of the column panel are zeros).
    for (int c = warp; c < bw; c += kWarps) {
      for (int i = lane; i < ldn; i += 32) fp[c * ldn + i] = i < n ? at(i, k0 + c) : T(0);
    }
    for (int r = warp; r < bw; r += kWarps) {
      for (int j = lane; j < ld; j += 32) pr[r * ld + j] = at(k0 + r, j);
    }
    __syncthreads();

    // Step 1: the diagonal block, on one warp.
    if (warp == 0) diag_block<T, BP>(pr, ld, k0, bw, F, D, lane);
    __syncthreads();

    // Step 2: the n rows of the column panel and the n + 1 columns of the
    // pivot-row panel, one a thread; each reads and writes only its own.
    for (int w = tid; w < n + ld; w += kPanThreads) {
      if (w < n) {
        column_row<T, BP>(fp, ldn, D, w, k0, bw);
      } else {
        pivot_col<T, BP>(pr, ld, F, w - n, bw);
      }
    }
    __syncthreads();

    if (!last) {
      // Step 3: every entry once, its BP updates in k order (bw == BP
      // here).  A warp walks over units (32 columns, 4 rows), columns
      // outermost, with the pivot-row entries of its column in registers.
      const int nc = (ld + 31) / 32, ng = ldn / 4;
      const int total = nc * ng, per = (total + kWarps - 1) / kWarps;
      int u = warp * per;
      const int u_end = total < u + per ? total : u + per;
      while (u < u_end) {
        const int cj = u / ng, g0 = u - cj * ng;
        const int g1 = ng < g0 + (u_end - u) ? ng : g0 + (u_end - u);
        const int j = 32 * cj + lane;
        const bool jv = j < ld;
        T p[BP];
#pragma unroll
        for (int kk = 0; kk < BP; ++kk) p[kk] = jv ? pr[kk * ld + j] : T(0);
        for (int g = g0; g < g1; ++g) {
          const int i = 4 * g;
          T v[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) v[r] = (jv && i + r < n) ? at(i + r, j) : T(0);
#pragma unroll
          for (int kk = 0; kk < BP; ++kk) {
            T f[4];
            load4(fp + kk * ldn + i, f);
#pragma unroll
            for (int r = 0; r < 4; ++r) v[r] = sub_rn(v[r], mul_rn(f[r], p[kk]));
          }
          if (jv) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              if (i + r < n) M[(i + r) * ld + j] = v[r];
            }
          }
        }
        u += g1 - g0;
      }
    } else {
      // The last panel: only the diagonal and column n, then x.
      for (int i = tid; i < n; i += kPanThreads) {
        T d = at(i, i), r = at(i, n);
        for (int kk = 0; kk < bw; ++kk) {
          const T f = fp[kk * ldn + i];
          d = sub_rn(d, mul_rn(f, pr[kk * ld + i]));
          r = sub_rn(r, mul_rn(f, pr[kk * ld + n]));
        }
        out(i, div_rn(r, d));
      }
    }
    __syncthreads();
  }
}

template <typename T, int BP, bool kResident>
__global__ void __launch_bounds__(kPanThreads, kPanMinBlocks<T, kResident>) gj_panels(const T* __restrict__ A, const T* __restrict__ bv,
                                                         T* __restrict__ x, T* __restrict__ S, int B, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = n + 1, ldn = (n + 3) / 4 * 4;
  T* fp = reinterpret_cast<T*>(smem_raw);  // [BP][ldn]: the column panel, then the factors f_i(k)
  T* pr = fp + BP * ldn;                   // [BP][ld]:  the pivot-row panel, then the rows p(k)
  T* F = pr + BP * ld;                     // [BP][BP]:  the diagonal block's factors
  T* D = F + BP * BP;                      // [BP][BP]:  the diagonal block's pivot rows
  for (long long sys = blockIdx.x; sys < B; sys += gridDim.x) {
    T* xs = x + sys * n;
    T* M = kResident ? D + BP * BP : S + sys * n * ld;  // [n][ld]: the matrix's home
    gj_panel_sweeps<T, BP>(A + sys * n * n, bv + sys * n, M, fp, pr, F, D, n, [&](int i, T v) { xs[i] = v; });
  }
}

// The panel width (8 or 16 resident, 8, 16 or 32 blocked) is the wrapper's
// choice (linsolve_cuda.py:k1_route).  A width whose shared memory does not fit
// the card is refused, never replaced.
template <typename T, bool kResident>
int launch_panels(const T* A, const T* b, T* x, T* scratch, int B, int n, int panel, void* stream) {
  if (B <= 0 || n <= 0 || (!kResident && scratch == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(const T*, const T*, T*, T*, int, int) = nullptr;
  switch (panel) {
    case 8: kernel = gj_panels<T, 8, kResident>; break;
    case 16: kernel = gj_panels<T, 16, kResident>; break;
    case 32:
      if constexpr (!kResident) kernel = gj_panels<T, 32, false>;
      break;
    default: break;
  }
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = panel_smem_bytes<T>(n, panel, kResident);
  if (smem > static_cast<size_t>(max_smem_optin())) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, n_sm = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kPanThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long cap = static_cast<long long>(per_sm > 0 ? per_sm : 1) * n_sm;
  const int grid = static_cast<int>(B < cap ? B : cap);
  kernel<<<grid, kPanThreads, smem, static_cast<cudaStream_t>(stream)>>>(A, b, x, scratch, B, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
