// The block-per-lane design of the wide chord kernel (one block per lane,
// constants from L2), kept as the baseline of
// gym_anm_torch/bench/kernel_probes.py and chip_smoke.py phase 10; the kernel
// itself is csrc/chord_newton_wide.cu.
//
// Fused chord-Newton load-flow solve for networks above 33 buses (n > 32
// non-slack buses): the whole chord phase of a batch of grids in one launch,
// every grid lane iterating until its own exit test.
//
// Replaces, with chord_newton.cu (n <= 32), the TPU kernel
// scripts/chord_pallas_prototype.py:168 `kernel` (wrapped by :267
// chord_pallas, pallas_call at :269), whose reference is the JAX package's
// gym_anm_tpu/physics/power_flow.py:_chord_lane_core and chord_solve.  It
// computes what the plain version
// gym_anm_torch/physics/power_flow.py:chord_solve_plain computes, op for op:
//   prologue: the Woodbury 2x2 K = W (I + C W)^-1 as scalars, the warm start
//             (flat where any entry is non-finite), F and ||F||inf;
//   loop:     f = -invJ0 F + G K (H F), g = x + f, an Anderson(1) step with
//             gamma clipped to +-5 and off within 100 xtol, the 7th-order
//             Taylor sin/cos, the mismatch F = V o conj(Y0 V + dY V) - (p + jq),
//             the best-so-far stall rule; it runs while ||F||inf > xtol,
//             it < lim_iter and stall < limit (1 inside the 10 xtol band,
//             else 3);
//   epilogue: acceptance, and the flat-start reset of non-finite,
//             |theta| > 0.5 or worse-than-flat exits.
//
// Numerics.  The elementwise float32 arithmetic is rounded op by op
// (__fmul_rn, __fadd_rn, ...); max, minimum and clamp propagate NaN as
// torch.amax, torch.minimum and torch.clamp do.  The products (invJ0 F, H F
// and the mismatch's [vre; vim] W_pack) are float64 sums of exact float32
// products, rounded once to float32, as complexops.matmul_full forms them,
// summed in another order than the plain version's matmul (which can move a
// float32 rounding, rarely).  The Anderson sums are float32 sums in the order
// of power_flow.py:_butterfly_sum: the pair sums of entries i and n + i,
// padded with zeros to width = max(32, next power of two >= n), then
// v[i] += v[i ^ o] for o = width / 2 .. 1.  Only v[0] is needed, and at an
// offset o >= 32 the entries i < o and i + o lie in the same residue class
// mod 32, so one warp folds them without a barrier (thread l owns the
// entries l mod 32) and finishes with its butterfly shuffles, offsets 16..1.
//
// Bound (the 130-bus feeder of chip_smoke.py, n = 129): per lane iteration
// the update product 4 n^2 = 66,564 and the mismatch 4 N^2 = 67,600 float64
// multiply-adds, so the work is the run's lane-iterations times that (the
// smoke counts them).  Device memory sees p, q, x0, x, F and a few scalars
// per lane once, and the constants (invJ0^T 532 KB, W_pack 270 KB) once: it
// is bound by operations.
//
// Design (a simple kernel first): one thread block per lane, each thread
// owning up to two buses i (the unknowns theta_i, |V|_i and the rows P_i,
// Q_i), so n <= 512 (networks up to 513 buses).  F and V are staged in
// shared memory as doubles; a thread forms its own rows of invJ0 F (reading
// invJ0^T by columns, coalesced over the threads) and its own buses'
// columns of the mismatch products, so the F it needs never leaves the
// thread.  Five block barriers an iteration: after staging F and the H F
// partial sums, after the Anderson pair sums, after warp 0's fold of them,
// after staging V, and after the ||F||inf partial maxima.  The constant
// matrices are read from L2 every iteration (a later redesign can share them
// between lanes, as chord_newton.cu does on the tensor cores).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kPer = 2;                  // buses per thread, at most
constexpr int kMaxN = kMaxThreads * kPer;  // 512 non-slack buses
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* p;        // [B, n]
  const float* q;        // [B, n]
  const float* w_a;      // [B]  Im delta
  const float* w_b;      // [B]  Re delta
  const float* dtf_re;   // [B]  dY[t, f]
  const float* dtf_im;   // [B]
  const float* x0;       // [B, 2n] warm start, or nullptr for the flat start
  const double* W_pack;  // [N, 2N]  [Y0re^T | Y0im^T]
  const double* invJ0_T;  // [2n, 2n]
  const double* H_T;     // [2n, 2]
  const float* g_col0;   // [2n]
  const float* g_col1;   // [2n]
  const float* C;        // [4]  c00 c01 c10 c11
  const float* e_t;      // [N]  one-hot of the regulated bus
  const float* rs_re;    // [N]  row sums of Y0
  const float* rs_im;    // [N]
  float va, vb, inv_vmag;     // V* at the regulated bus, 1 / |V*|
  float xtol, band, aa_gate;  // xtol, stall_tol_factor xtol, 100 xtol
  int lim_iter;
  int B, n, width;  // width: the Anderson sums' padded length
  float* x;                 // [B, 2n]
  float* F;                 // [B, 2n]
  float* diff;              // [B]
  int* n_iter;              // [B]
  unsigned char* accepted;  // [B]
};

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }
// NaN-propagating max / min (torch.amax, torch.minimum).
__device__ __forceinline__ float nanmax(float a, float b) { return (a != a || a > b) ? a : b; }
__device__ __forceinline__ float nanmin(float a, float b) { return (a != a || a < b) ? a : b; }

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = nanmax(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The NaN-propagating maximum of v over the block, in every thread.
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r = nanmax(r, red[w]);
  __syncthreads();
  return r;
}

// 7th-order Taylor sin/cos in the plain version's evaluation order.
__device__ __forceinline__ void sincos7(float t, float* s, float* c) {
  const float t2 = fmul(t, t);
  float a = fmul(t2, (float)(1.0 / 5040.0));
  a = fsub((float)(1.0 / 120.0), a);
  a = fadd(fmul(t2, a), (float)(-1.0 / 6.0));
  a = fadd(fmul(t2, a), 1.0f);
  *s = fmul(t, a);
  float b = fmul(t2, (float)(1.0 / 720.0));
  b = fsub((float)(1.0 / 24.0), b);
  b = fadd(fmul(t2, b), -0.5f);
  *c = fadd(fmul(t2, b), 1.0f);
}

__global__ void __launch_bounds__(kMaxThreads) chord_wide_kernel(const Params P) {
  extern __shared__ double smem[];
  const int n = P.n, N = n + 1, n2 = 2 * n, N2 = 2 * N;
  double* sF = smem;             // [2n]  F of this iteration
  double* sV = sF + n2;          // [2][N]  V at the current point (re, im), bus 0 = slack
  float* sAA = reinterpret_cast<float*>(sV + 2 * N);  // [2][width]  the Anderson pair sums
  __shared__ double sRedU[kMaxWarps][2];
  __shared__ float sRed[kMaxWarps];
  __shared__ float sGamma;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nt = blockDim.x;
  const long long b = blockIdx.x;
  const int width = P.width;
  for (int i = n + tid; i < width; i += nt) {
    sAA[i] = 0.0f;
    sAA[width + i] = 0.0f;
  }

  // This thread's buses i = tid + k nt (k < kPer) and their constants.
  bool own[kPer];
  float p[kPer], q[kPer], e[kPer], h00[kPer], h01[kPer], h10[kPer], h11[kPer];
  float g0a[kPer], g1a[kPer], g0b[kPer], g1b[kPer];
  float xa[kPer], xb[kPer], Fa[kPer], Fb[kPer], vr[kPer], vi[kPer];
  float gpa[kPer], gpb[kPer], fpa[kPer], fpb[kPer];
  bool warm_ok = true;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = tid + k * nt;
    own[k] = i < n;
    const int ii = own[k] ? i : 0;
    p[k] = own[k] ? P.p[b * n + ii] : 0.0f;
    q[k] = own[k] ? P.q[b * n + ii] : 0.0f;
    e[k] = P.e_t[ii + 1];
    h00[k] = (float)P.H_T[2 * ii];
    h01[k] = (float)P.H_T[2 * ii + 1];
    h10[k] = (float)P.H_T[2 * (n + ii)];
    h11[k] = (float)P.H_T[2 * (n + ii) + 1];
    g0a[k] = P.g_col0[ii];
    g1a[k] = P.g_col1[ii];
    g0b[k] = P.g_col0[n + ii];
    g1b[k] = P.g_col1[n + ii];
    xa[k] = 0.0f;
    xb[k] = 1.0f;
    if (own[k] && P.x0 != nullptr) {
      xa[k] = P.x0[b * n2 + ii];
      xb[k] = P.x0[b * n2 + n + ii];
      warm_ok = warm_ok && isfinite(xa[k]) && isfinite(xb[k]);
    }
    Fa[k] = Fb[k] = vr[k] = vi[k] = 0.0f;
  }
  // Warm start, or the flat start where any entry is non-finite.
  warm_ok = __syncthreads_and(warm_ok) && P.x0 != nullptr;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (!warm_ok) {
      xa[k] = 0.0f;
      xb[k] = 1.0f;
    }
  }

  // K = W (I + C W)^-1, with W(a) at the linearization point V* = va + j vb.
  const float dtf_re = P.dtf_re[b], dtf_im = P.dtf_im[b];
  float k00, k01, k10, k11;
  {
    const float d_i = P.w_a[b], d_r = P.w_b[b];
    const float w00 = fsub(fmul(P.va, d_i), fmul(P.vb, d_r));
    const float w01 = fmul(fadd(fmul(P.va, d_r), fmul(P.vb, d_i)), P.inv_vmag);
    const float w10 = fadd(fmul(P.va, d_r), fmul(P.vb, d_i));
    const float w11 = fmul(fsub(fmul(P.vb, d_r), fmul(P.va, d_i)), P.inv_vmag);
    const float c00 = P.C[0], c01 = P.C[1], c10 = P.C[2], c11 = P.C[3];
    const float m00 = fadd(fadd(1.0f, fmul(c00, w00)), fmul(c01, w10));
    const float m01 = fadd(fmul(c00, w01), fmul(c01, w11));
    const float m10 = fadd(fmul(c10, w00), fmul(c11, w10));
    const float m11 = fadd(fadd(1.0f, fmul(c10, w01)), fmul(c11, w11));
    const float det = fsub(fmul(m00, m11), fmul(m01, m10));
    k00 = fdiv(fsub(fmul(w00, m11), fmul(w01, m10)), det);
    k01 = fdiv(fsub(fmul(w01, m00), fmul(w00, m01)), det);
    k10 = fdiv(fsub(fmul(w10, m11), fmul(w11, m10)), det);
    k11 = fdiv(fsub(fmul(w11, m00), fmul(w10, m01)), det);
  }

  // The mismatch at x: stage V, then each thread's own columns of
  // [vre; vim] W_pack (buses i + 1 of both halves), F and ||F||inf.
  auto mismatch = [&]() -> float {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (own[k]) {
        const int i = tid + k * nt;
        float sn, cs;
        sincos7(xa[k], &sn, &cs);
        vr[k] = fmul(xb[k], cs);
        vi[k] = fmul(xb[k], sn);
        sV[i + 1] = (double)vr[k];
        sV[N + i + 1] = (double)vi[k];
      }
    }
    if (tid == 0) {
      sV[0] = 1.0;
      sV[N] = 0.0;
    }
    __syncthreads();
    float m = 0.0f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (!own[k]) continue;
      const int c = tid + k * nt + 1;
      double are = 0.0, aim = 0.0, bre = 0.0, bim = 0.0;  // vre Y0re^T, vre Y0im^T, vim Y0re^T, vim Y0im^T
      for (int j = 0; j < N; ++j) {
        const double wr = P.W_pack[(long long)j * N2 + c], wi = P.W_pack[(long long)j * N2 + N + c];
        const double ur = sV[j], ui = sV[N + j];
        are = fma(ur, wr, are);
        aim = fma(ur, wi, aim);
        bre = fma(ui, wr, bre);
        bim = fma(ui, wi, bim);
      }
      const float yv_re = fadd(fsub((float)are, (float)bim), fmul(e[k], dtf_re));
      const float yv_im = fadd(fadd((float)bre, (float)aim), fmul(e[k], dtf_im));
      const float s_re = fadd(fmul(vr[k], yv_re), fmul(vi[k], yv_im));
      const float s_im = fsub(fmul(vi[k], yv_re), fmul(vr[k], yv_im));
      Fa[k] = fsub(s_re, p[k]);
      Fb[k] = fsub(s_im, q[k]);
      m = nanmax(m, nanmax(fabsf(Fa[k]), fabsf(Fb[k])));
    }
    return block_max(m, sRed);
  };

  float diff = mismatch();
  float best = diff;
  int it = 0, stall = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    gpa[k] = xa[k];
    gpb[k] = xb[k];
    fpa[k] = fpb[k] = 0.0f;
  }

  while (diff > P.xtol && it < P.lim_iter && stall < (diff <= P.band ? 1 : 3)) {
    // (1) Stage F; H F partial sums.
    double u0d = 0.0, u1d = 0.0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (own[k]) {
        const int i = tid + k * nt;
        sF[i] = (double)Fa[k];
        sF[n + i] = (double)Fb[k];
        u0d += fma((double)Fa[k], (double)h00[k], (double)Fb[k] * (double)h10[k]);
        u1d += fma((double)Fa[k], (double)h01[k], (double)Fb[k] * (double)h11[k]);
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      u0d += __shfl_xor_sync(kFull, u0d, o);
      u1d += __shfl_xor_sync(kFull, u1d, o);
    }
    if (lane == 0) {
      sRedU[warp][0] = u0d;
      sRedU[warp][1] = u1d;
    }
    __syncthreads();
    u0d = sRedU[0][0];
    u1d = sRedU[0][1];
    for (int w = 1; w < (nt >> 5); ++w) {
      u0d += sRedU[w][0];
      u1d += sRedU[w][1];
    }
    // (2) Chord direction f = -invJ0 F + G K (H F), map value g = x + f, and
    // the Anderson pair sums.
    const float u0 = (float)u0d, u1 = (float)u1d;
    const float t0 = fadd(fmul(k00, u0), fmul(k01, u1));
    const float t1 = fadd(fmul(k10, u0), fmul(k11, u1));
    float fa[kPer], fb[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      fa[k] = fb[k] = 0.0f;
      if (!own[k]) continue;
      const int i = tid + k * nt;
      double ua = 0.0, ub = 0.0;
      for (int j = 0; j < n2; ++j) {
        const double fj = sF[j];
        ua = fma(fj, P.invJ0_T[(long long)j * n2 + i], ua);
        ub = fma(fj, P.invJ0_T[(long long)j * n2 + n + i], ub);
      }
      fa[k] = fadd(-(float)ua, fadd(fmul(t0, g0a[k]), fmul(t1, g1a[k])));
      fb[k] = fadd(-(float)ub, fadd(fmul(t0, g0b[k]), fmul(t1, g1b[k])));
      const float dfa = fsub(fa[k], fpa[k]), dfb = fsub(fb[k], fpb[k]);
      sAA[i] = fadd(fmul(dfa, dfa), fmul(dfb, dfb));
      sAA[P.width + i] = fadd(fmul(fa[k], dfa), fmul(fb[k], dfb));
    }
    __syncthreads();
    // Warp 0 folds the pair sums in the butterfly's order (header comment).
    if (warp == 0) {
      for (int o = width >> 1; o >= 32; o >>= 1) {
        for (int j = lane; j < o; j += 32) {
          sAA[j] = fadd(sAA[j], sAA[j + o]);
          sAA[width + j] = fadd(sAA[width + j], sAA[width + j + o]);
        }
      }
      float den = sAA[lane], num = sAA[width + lane];
      for (int o = 16; o > 0; o >>= 1) {
        const float dd = __shfl_xor_sync(kFull, den, o), dn = __shfl_xor_sync(kFull, num, o);
        den = fadd(den, dd);
        num = fadd(num, dn);
      }
      if (lane == 0) sGamma = den > 1e-30f ? fdiv(num, den) : 0.0f;
    }
    __syncthreads();
    const bool use_aa = it > 0 && diff > P.aa_gate;
    float gamma = sGamma;
    gamma = use_aa ? (gamma < -5.0f ? -5.0f : (gamma > 5.0f ? 5.0f : gamma)) : 0.0f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (!own[k]) continue;
      const float ga = fadd(xa[k], fa[k]), gb = fadd(xb[k], fb[k]);
      xa[k] = fsub(ga, fmul(gamma, fsub(ga, gpa[k])));
      xb[k] = fsub(gb, fmul(gamma, fsub(gb, gpb[k])));
      gpa[k] = ga;
      gpb[k] = gb;
      fpa[k] = fa[k];
      fpb[k] = fb[k];
    }
    // (3) The mismatch at the new point and the stall rule.
    const float new_diff = mismatch();
    // Stalled = no iteration beating the best residual so far by >= 20%.
    stall = new_diff < fmul(best, 0.8f) ? 0 : stall + 1;
    best = nanmin(best, new_diff);
    diff = new_diff;
    ++it;
  }

  // Epilogue: accept, or reset to the flat start with its analytic residual
  // (S = conj(row sums of Y) at V = 1) for the Newton fallback.
  bool fin_x = true;
  float th = 0.0f, mflat = 0.0f;
  float Ffa[kPer], Ffb[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    Ffa[k] = Ffb[k] = 0.0f;
    if (!own[k]) continue;
    const int i = tid + k * nt;
    fin_x = fin_x && isfinite(xa[k]) && isfinite(xb[k]);
    th = nanmax(th, fabsf(xa[k]));
    Ffa[k] = fsub(fadd(P.rs_re[i + 1], fmul(e[k], dtf_re)), p[k]);
    Ffb[k] = fsub(-fadd(P.rs_im[i + 1], fmul(e[k], dtf_im)), q[k]);
    mflat = nanmax(mflat, nanmax(fabsf(Ffa[k]), fabsf(Ffb[k])));
  }
  fin_x = __syncthreads_and(fin_x);
  th = block_max(th, sRed);
  const float diff_flat = block_max(mflat, sRed);
  const bool fin = isfinite(diff) && fin_x && th <= 0.5f;
  const int eff_limit = diff <= P.band ? 1 : 3;
  const bool plateaued = fin && stall >= eff_limit;
  const bool acc = (fin && diff <= P.xtol) || (plateaued && diff <= P.band);
  const bool reset = !acc && (!fin || !(diff <= diff_flat));
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (!own[k]) continue;
    const long long o = b * n2 + tid + k * nt;
    P.x[o] = reset ? 0.0f : xa[k];
    P.x[o + n] = reset ? 1.0f : xb[k];
    P.F[o] = reset ? Ffa[k] : Fa[k];
    P.F[o + n] = reset ? Ffb[k] : Fb[k];
  }
  if (tid == 0) {
    P.diff[b] = reset ? diff_flat : diff;
    P.n_iter[b] = reset ? 0 : it;
    P.accepted[b] = acc ? 1 : 0;
  }
}

}  // namespace

// n = 33..512 non-slack buses (chord_newton_f32 takes n <= 32).
extern "C" int chord_newton_wide_lane_f32(const float* p, const float* q, const float* w_a, const float* w_b,
                                     const float* dtf_re, const float* dtf_im, const float* x0,
                                     const double* W_pack, const double* invJ0_T, const double* H_T,
                                     const float* g_col0, const float* g_col1, const float* C,
                                     const float* e_t, const float* rs_re, const float* rs_im,
                                     float va, float vb, float inv_vmag, float xtol, float band, float aa_gate,
                                     int lim_iter, float* x, float* F, float* diff, int* n_iter,
                                     unsigned char* accepted, int B, int n, void* stream) {
  if (B <= 0 || n <= 32 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  int width = 32;
  while (width < n) width <<= 1;
  const Params P{p, q, w_a, w_b, dtf_re, dtf_im, x0, W_pack, invJ0_T, H_T, g_col0, g_col1, C,
                 e_t, rs_re, rs_im, va, vb, inv_vmag, xtol, band, aa_gate, lim_iter, B, n, width,
                 x, F, diff, n_iter, accepted};
  const int threads = ((n + kPer - 1) / kPer + 31) / 32 * 32;  // n <= 512: at most 256
  const size_t smem = sizeof(double) * (2 * static_cast<size_t>(n) + 2 * (n + 1)) + sizeof(float) * 2 * width;
  chord_wide_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}
