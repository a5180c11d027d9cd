// K5 as PR 5 shipped it (one thread block per lane), kept as the baseline of
// gym_anm_torch/bench/kernel_probes.py: every later reading can put the
// current csrc/admm_dcopf.cu beside this design in one call.  Built twice by
// the probe:
//   as it is:       the matrices float32, every multiply-add of the two
//                   products converting both operands to float64 (cvt.f64.f32);
//   -DADMM_F64:     the matrices passed as float64 copies and the lane's
//                   vectors (rho z - y, rhs, y) staged once per sweep as
//                   float64 in shared memory, so the k-loops convert nothing.
// The difference of the two times is the conversions' share of the kernel.
// The entry point is admm_probe_f32 in both builds; the arguments are those of
// PR 5's admm_dcopf_f32 (with A and PT double in the -DADMM_F64 build).
//
// PR 5's header comment follows.
//
// K5: the batched OSQP-style ADMM solve of the N-stage DC-OPF, every lane's
// whole solve loop in one launch.
//
// Replaces the JAX package's on-device solve gym_anm_tpu/vec/mpc.py:solve_dcopf
// (its sweep and body, an XLA while_loop under vmap; the TPU ran no Pallas
// kernel here).  It computes what the plain version
// gym_anm_torch/vec/mpc.py:solve_dcopf_plain computes, lane by lane:
//
//   sweep:  v = rho*z - y;  t = v . A_bar;  rhs = (sigma*x - q_bar) + t;
//           w = P_pack . rhs  (x~ = w[:n], A_bar x~ = w[n:]);
//           x = alpha*x~ + (1-alpha)*x;  Ax = alpha*zt + (1-alpha)*Ax;
//           z_pre = (alpha*zt + (1-alpha)*z) + y/rho;  z = clip(z_pre, l_bar, u_bar);
//           y = rho*(z_pre - z)
//   every K sweeps, a check: the unscaled residuals (A_bar^T y once), the
//   best-so-far improvement test at 1e-3*K, the stall count, the strict and
//   plateau exits; it += K.  A lane with a crossed bound row (any l > u) is
//   done at entry: no sweep, its warm start passed through, converged false,
//   r_prim = r_dual = inf.  At exit the primal band gives `feasible`, and
//   x = D*x_bar.
//
// Precision, as the plain version's: every entry of a product is the float64
// sum of exact float32 x float32 products (an fma on doubles whose product is
// exact), rounded once to float32; the elementwise chain is float32 with every
// operation rounded on its own (__fmul_rn, __fadd_rn: nvcc contracts none of
// them into a fused multiply-add the plain version does not have), and the
// divisions by the cost scale are IEEE divisions (__fdiv_rn).  The six maxima
// of a check are block reductions that propagate NaN as torch.amax does; a
// maximum is exact in any order, so they match the plain version bit for bit.
// The products' float64 sums run in another order than the plain version's
// matmul, so an entry may round to the other neighbouring float32 where the
// float64 sum lies within an ulp of a float32 tie.
//
// Bound (bench.py workload 4: ANM6Easy N=1, n=21, m=39, B=8192, budget 48 = 6
// checks of 8 sweeps): per lane and sweep m*n + (n+m)*n = 2,079 multiply-adds,
// per check m*n more, 0.21 MFLOP a lane at the full budget, 1.7 GFLOP a call:
// 26 us at 67 TFLOP/s (float64 on the tensor cores, the rate K2 uses; this
// kernel runs its products on the FP64 cores, 34 TFLOP/s, 51 us).  A lane
// moves ~1.5 KB (bounds, warm start in and out, solution), 12 MB a call, 4 us
// at 3.35 TB/s.  So the kernel is bound by operations; the lanes that exit
// early (warm starts) do less of them, and chip_smoke.py counts the sweeps a
// run's lanes actually ran.
//
// Design (a simple kernel first): one thread block per lane, each lane
// exiting on its own.  The lane's x [n], y, z, Ax, l_bar, u_bar [m], rhs [n]
// and w [n+m] live in dynamic shared memory (v = rho*z - y in the first m
// entries of w, dead by the time w is written): 3n + 6m floats, 2.3 KB at
// workload 4, 21 KB at ANM6Easy N=16.  A_bar [m, n] and P_pack^T [n, n+m]
// are read from global memory, where they stay in L1/L2 (8.3 KB at workload
// 4): thread j of the t product walks column j down the rows of A_bar, thread
// r of the w product walks column r down the rows of P_pack^T, so
// consecutive threads read consecutive addresses.  Four block barriers a
// sweep.  A block has round_up(n + m, 32) threads, at most 256 (64 at
// workload 4), so 32 blocks fit on an SM.  The control scalars (it, the
// residuals, their bests, the stall count, done) are computed by every
// thread from the same reduced values, so the loop is uniform in the block.
// Sharing the matrices between several lanes of a block in shared memory,
// the products on the FP64 tensor cores as K2 does, and fewer barriers are
// left to a later redesign.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifdef ADMM_F64
typedef double Mat;
#else
typedef float Mat;
#endif

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kChecks = 5;  // maxima reduced at a check
constexpr float kBig = 1e20f;

struct Problem {
  const Mat* A;          // [m, n] A_bar
  const Mat* PT;         // [n, n+m] P_pack^T
  const float* q;        // [n] q_bar
  const float* rho;      // [m]
  const float* inv_rho;  // [m]
  const float* D;        // [n]
  const float* D_inv;    // [n]
  const float* E;        // [m]
  const float* E_inv;    // [m]
  float sigma, alpha, one_minus_alpha, c_scale, q_ref, eps_abs, eps_rel, improve, plateau_cap, feas_band;
  int max_iter, K, stall_checks, n, m;
};

struct Lanes {
  const float *l, *u, *x0, *y0, *z0, *Ax0;  // [B, m] bounds, [B, n] / [B, m] warm start
  float *x_out, *xw, *yw, *zw, *Axw;        // [B, n] solution, the new warm start
  int* iterations;
  float *r_prim, *r_dual;
  uint8_t *converged, *bounds_ok, *feasible;
};

// The maximum of torch.amax / torch.maximum: NaN wins.
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || isnan(a)) ? a : b; }
// torch.minimum's: NaN wins.
__device__ __forceinline__ float nan_min(float a, float b) { return (a < b || isnan(a)) ? a : b; }

// v[0..R) reduced by nan_max over the block; every thread gets the results.
template <int R>
__device__ void block_max(float (&v)[R], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < R; ++k)
    for (int off = 16; off > 0; off >>= 1) v[k] = nan_max(v[k], __shfl_xor_sync(0xffffffffu, v[k], off));
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < R; ++k) red[warp * R + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < R; ++k) {
    float r = red[k];
    for (int w = 1; w < n_warps; ++w) r = nan_max(r, red[w * R + k]);
    v[k] = r;
  }
  __syncthreads();
}

// One bare ADMM iteration of the block's lane (header comment).
__device__ __forceinline__ void sweep(const Problem& P, float* x, float* y, float* z, float* Ax, const float* lb,
                                      const float* ub, float* rhs, float* w, double* vd) {
  const int n = P.n, m = P.m, nm = n + m, tid = threadIdx.x, nt = blockDim.x;
#ifdef ADMM_F64
  for (int i = tid; i < m; i += nt) vd[i] = static_cast<double>(__fsub_rn(__fmul_rn(P.rho[i], z[i]), y[i]));
  __syncthreads();
  for (int j = tid; j < n; j += nt) {
    double acc = 0.0;
    for (int i = 0; i < m; ++i) acc = fma(vd[i], P.A[i * n + j], acc);
    rhs[j] = __fadd_rn(__fsub_rn(__fmul_rn(P.sigma, x[j]), P.q[j]), static_cast<float>(acc));
  }
  __syncthreads();
  for (int j = tid; j < n; j += nt) vd[j] = static_cast<double>(rhs[j]);  // rhs, staged once
  __syncthreads();
  for (int r = tid; r < nm; r += nt) {
    double acc = 0.0;
    for (int k = 0; k < n; ++k) acc = fma(P.PT[k * nm + r], vd[k], acc);
    w[r] = static_cast<float>(acc);
  }
  __syncthreads();
#else
  for (int i = tid; i < m; i += nt) w[i] = __fsub_rn(__fmul_rn(P.rho[i], z[i]), y[i]);
  __syncthreads();
  for (int j = tid; j < n; j += nt) {
    double acc = 0.0;
    for (int i = 0; i < m; ++i) acc = fma(static_cast<double>(w[i]), static_cast<double>(P.A[i * n + j]), acc);
    rhs[j] = __fadd_rn(__fsub_rn(__fmul_rn(P.sigma, x[j]), P.q[j]), static_cast<float>(acc));
  }
  __syncthreads();
  for (int r = tid; r < nm; r += nt) {
    double acc = 0.0;
    for (int k = 0; k < n; ++k) acc = fma(static_cast<double>(P.PT[k * nm + r]), static_cast<double>(rhs[k]), acc);
    w[r] = static_cast<float>(acc);
  }
  __syncthreads();
#endif
  const float a = P.alpha, b = P.one_minus_alpha;
  for (int j = tid; j < n; j += nt) x[j] = __fadd_rn(__fmul_rn(a, w[j]), __fmul_rn(b, x[j]));
  for (int i = tid; i < m; i += nt) {
    const float zt = w[n + i];
    Ax[i] = __fadd_rn(__fmul_rn(a, zt), __fmul_rn(b, Ax[i]));
    const float z_pre = __fadd_rn(__fadd_rn(__fmul_rn(a, zt), __fmul_rn(b, z[i])), __fmul_rn(P.inv_rho[i], y[i]));
    // clamp(z_pre, lb, ub) as torch computes it: min(max(z_pre, lb), ub), NaN kept.
    float z_new = z_pre < lb[i] ? lb[i] : z_pre;
    z_new = ub[i] < z_new ? ub[i] : z_new;
    y[i] = __fmul_rn(P.rho[i], __fsub_rn(z_pre, z_new));
    z[i] = z_new;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kMaxThreads) admm_kernel(Problem P, Lanes L) {
  extern __shared__ float smem[];
  __shared__ float red[kMaxWarps * kChecks];
  const int n = P.n, m = P.m, tid = threadIdx.x, nt = blockDim.x;
  const int64_t lane = blockIdx.x;
  float* x = smem;
  float* y = x + n;
  float* z = y + m;
  float* Ax = z + m;
  float* lb = Ax + m;
  float* ub = lb + m;
  float* rhs = ub + m;
  float* w = rhs + n;  // [n + m]
  // ADMM_F64: the staged float64 vectors [max(n, m)], 8-byte aligned.
  double* vd = reinterpret_cast<double*>(smem + ((3 * n + 6 * m + 1) & ~1));

  int crossed = 0;
  for (int j = tid; j < n; j += nt) x[j] = L.x0[lane * n + j];
  for (int i = tid; i < m; i += nt) {
    const int64_t k = lane * m + i;
    y[i] = L.y0[k];
    z[i] = L.z0[k];
    Ax[i] = L.Ax0[k];
    const float lo = L.l[k], hi = L.u[k], e = P.E[i];
    // Scaled bounds; the infinities stay ±BIG, so the clip passes them through.
    lb[i] = lo <= -kBig ? -kBig : __fmul_rn(e, lo);
    ub[i] = hi >= kBig ? kBig : __fmul_rn(e, hi);
    crossed |= !(lo <= hi);
  }
  const bool bounds_ok = !__syncthreads_or(crossed);

  const float inf = __int_as_float(0x7f800000);
  float r_prim = inf, r_dual = inf, best_rp = inf, best_rd = inf;
  int it = 0, stall = 0;
  bool done = !bounds_ok;
  while (it < P.max_iter && !done) {
    for (int s = 0; s < P.K; ++s) sweep(P, x, y, z, Ax, lb, ub, rhs, w, vd);
    // |D⁻¹(q̄ + Āᵀy)|, |D⁻¹Āᵀy|, |E⁻¹(Āx − z)|, |E⁻¹Āx|, |E⁻¹z|
    float v[kChecks] = {0.f, 0.f, 0.f, 0.f, 0.f};
#ifdef ADMM_F64
    for (int i = tid; i < m; i += nt) vd[i] = static_cast<double>(y[i]);
    __syncthreads();
#endif
    for (int j = tid; j < n; j += nt) {
      double acc = 0.0;
#ifdef ADMM_F64
      for (int i = 0; i < m; ++i) acc = fma(vd[i], P.A[i * n + j], acc);
#else
      for (int i = 0; i < m; ++i) acc = fma(static_cast<double>(y[i]), static_cast<double>(P.A[i * n + j]), acc);
#endif
      const float t_y = static_cast<float>(acc), d = P.D_inv[j];
      v[0] = nan_max(v[0], fabsf(__fmul_rn(d, __fadd_rn(P.q[j], t_y))));
      v[1] = nan_max(v[1], fabsf(__fmul_rn(d, t_y)));
    }
    for (int i = tid; i < m; i += nt) {
      const float e = P.E_inv[i];
      v[2] = nan_max(v[2], fabsf(__fmul_rn(e, __fsub_rn(Ax[i], z[i]))));
      v[3] = nan_max(v[3], fabsf(__fmul_rn(e, Ax[i])));
      v[4] = nan_max(v[4], fabsf(__fmul_rn(e, z[i])));
    }
    block_max(v, red);
    const float rp = v[2];
    const float rd = __fdiv_rn(v[0], P.c_scale);
    const float p_ref = nan_max(v[3], v[4]);
    const float d_ref = nan_max(__fdiv_rn(v[1], P.c_scale), P.q_ref);
    const bool improved = rd < __fmul_rn(best_rd, P.improve) || rp < __fmul_rn(best_rp, P.improve);
    best_rp = nan_min(best_rp, rp);
    best_rd = nan_min(best_rd, rd);
    stall = improved ? 0 : stall + 1;
    const float tol_p = __fadd_rn(P.eps_abs, __fmul_rn(P.eps_rel, p_ref));
    const bool strict = rp <= tol_p && rd <= __fadd_rn(P.eps_abs, __fmul_rn(P.eps_rel, d_ref));
    const bool plateau = stall >= P.stall_checks && rp <= tol_p && rd <= __fmul_rn(P.plateau_cap, d_ref);
    done = strict || plateau;
    r_prim = rp;
    r_dual = rd;
    it += P.K;
  }

  // The primal band at the exit iterate.
  float v[2] = {0.f, 0.f};
  for (int i = tid; i < m; i += nt) {
    const float e = P.E_inv[i];
    v[0] = nan_max(v[0], fabsf(__fmul_rn(e, Ax[i])));
    v[1] = nan_max(v[1], fabsf(__fmul_rn(e, z[i])));
  }
  block_max(v, red);
  const float p_ref_exit = nan_max(v[0], v[1]);
  const bool feasible =
      bounds_ok && r_prim <= __fmul_rn(P.feas_band, __fadd_rn(P.eps_abs, __fmul_rn(P.eps_rel, p_ref_exit)));

  for (int j = tid; j < n; j += nt) {
    L.xw[lane * n + j] = x[j];
    L.x_out[lane * n + j] = __fmul_rn(P.D[j], x[j]);
  }
  for (int i = tid; i < m; i += nt) {
    const int64_t k = lane * m + i;
    L.yw[k] = y[i];
    L.zw[k] = z[i];
    L.Axw[k] = Ax[i];
  }
  if (tid == 0) {
    L.iterations[lane] = it;
    L.r_prim[lane] = r_prim;
    L.r_dual[lane] = r_dual;
    L.converged[lane] = done && bounds_ok;
    L.bounds_ok[lane] = bounds_ok;
    L.feasible[lane] = feasible;
  }
}

}  // namespace

extern "C" int admm_probe_f32(const Mat* A, const Mat* PT, const float* q, const float* rho,
                              const float* inv_rho, const float* D, const float* D_inv, const float* E,
                              const float* E_inv, const float* l, const float* u, const float* x0, const float* y0,
                              const float* z0, const float* Ax0, float* x_out, float* xw, float* yw, float* zw,
                              float* Axw, int* iterations, float* r_prim, float* r_dual, uint8_t* converged,
                              uint8_t* bounds_ok, uint8_t* feasible, float sigma, float alpha,
                              float one_minus_alpha, float c_scale, float q_ref, float eps_abs, float eps_rel,
                              float improve, float plateau_cap, float feas_band, int max_iter, int K,
                              int stall_checks, int B, int n, int m, void* stream) {
  if (B <= 0 || n <= 0 || m <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
#ifdef ADMM_F64
  const size_t smem = sizeof(float) * ((3 * static_cast<size_t>(n) + 6 * m + 1) & ~static_cast<size_t>(1)) +
                      sizeof(double) * (n > m ? n : m);
#else
  const size_t smem = sizeof(float) * (3 * static_cast<size_t>(n) + 6 * static_cast<size_t>(m));
#endif
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(admm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = ((n + m + 31) / 32) * 32 < kMaxThreads ? ((n + m + 31) / 32) * 32 : kMaxThreads;
  const Problem P{A, PT, q, rho, inv_rho, D, D_inv, E, E_inv,
                  sigma, alpha, one_minus_alpha, c_scale, q_ref, eps_abs, eps_rel, improve, plateau_cap, feas_band,
                  max_iter, K, stall_checks, n, m};
  const Lanes L{l, u, x0, y0, z0, Ax0, x_out, xw, yw, zw, Axw, iterations, r_prim, r_dual, converged, bounds_ok,
                feasible};
  admm_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(P, L);
  return static_cast<int>(cudaGetLastError());
}
