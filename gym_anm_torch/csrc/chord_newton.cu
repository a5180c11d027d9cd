// Fused chord-Newton load-flow solve: the whole chord phase of a batch of
// grids in one launch, every grid lane iterating until its own exit test.
//
// Replaces the TPU kernel scripts/chord_pallas_prototype.py:168 `kernel`
// (wrapped by :267 chord_pallas, pallas_call at :269).  It computes what the
// plain version gym_anm_torch/physics/power_flow.py:chord_solve_plain computes
// (the JAX package's gym_anm_tpu/physics/power_flow.py:_chord_lane_core and
// chord_solve), not the prototype's older body: 7th-order Taylor sin/cos, the
// |theta| <= 0.5 validity guard with the flat-start reset, an in-band stall
// limit of 1, and an optional warm start.  Per lane:
//   prologue: the Woodbury 2x2 K = W (I + C W)^-1 as scalars, the warm start
//             (flat where any entry is non-finite), F and ||F||inf;
//   loop:     f = -invJ0 F + G K (H F), g = x + f, an Anderson(1) step with
//             gamma clipped to +-5 and off within 100 xtol, the mismatch
//             F = V o conj(Y0 V + dY V) - (p + jq), the best-so-far stall rule;
//             it runs while ||F||inf > xtol, it < lim_iter and stall < limit
//             (limit 1 inside the 10 xtol band, else 3);
//   epilogue: acceptance, and the flat-start reset of non-finite, out-of-radius
//             or worse-than-flat exits.
//
// Design: one warp per lane; thread i < n owns the unknowns i (theta_i, row
// P_i) and n + i (|V|_i, row Q_i) in registers.  A block of 8 warps loads the
// shared constants once into shared memory (W_pack [N, 2N] and invJ0^T
// [2n, 2n] as float64 copies of the float32 values: 17.4 KB + 32.8 KB at
// IEEE33) and walks the batch grid-stride, a warp taking its next lane when
// its own lane exits.  Per iteration and lane the work is 4 N^2 + 4 n^2 + 4 n
// multiply-adds (~8.5 K at IEEE33) against shared memory, so the kernel is
// bound by shared-memory reads of the two matrices (8 bytes per multiply-add),
// not by device memory (one read of p, q, x0 and one write of x, F per lane)
// nor by the host: there is no host synchronisation and no launch per
// iteration.  The lane's scalars (diff, best, it, stall, gamma) come out of
// butterfly shuffles and are bitwise equal in all 32 threads, so every branch
// is warp-uniform.
//
// Numerics follow the plain version op for op: each dot product of the
// mismatch and the update is accumulated in float64 from exact float32
// products and rounded once (matmul_full); elementwise float32 arithmetic is
// rounded op by op (__fmul_rn, __fadd_rn, ...), so no multiply-add is
// contracted that the plain version does not form; max, minimum and clamp
// propagate NaN as torch.amax, torch.minimum and torch.clamp do.  The AA sums
// are float32 sums in butterfly order, not torch's order, hence a comparison
// with the plain version by tolerance, not bitwise.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxN = 32;   // non-slack buses per lane: 2n <= 64 (IEEE33)
constexpr int kWarps = 8;   // lanes in flight per block
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* p;       // [B, n]
  const float* q;       // [B, n]
  const float* w_a;     // [B]  Im delta
  const float* w_b;     // [B]  Re delta
  const float* dtf_re;  // [B]  dY[t, f]
  const float* dtf_im;  // [B]
  const float* x0;      // [B, 2n] warm start, or nullptr for the flat start
  const double* W_pack;  // [N, 2N]  [Y0re^T | Y0im^T]
  const double* invJ0_T;  // [2n, 2n]
  const double* H_T;     // [2n, 2]
  const float* g_col0;   // [2n]
  const float* g_col1;   // [2n]
  const float* C;        // [4]  c00 c01 c10 c11
  const float* e_t;      // [N]  one-hot of the regulated bus
  const float* rs_re;    // [N]  row sums of Y0
  const float* rs_im;    // [N]
  float va, vb, inv_vmag;  // V* at the regulated bus, 1 / |V*|
  float xtol, band, aa_gate;  // xtol, stall_tol_factor xtol, 100 xtol
  int lim_iter;
  int B, n;
  float* x;             // [B, 2n]
  float* F;             // [B, 2n]
  float* diff;          // [B]
  int* n_iter;          // [B]
  unsigned char* accepted;  // [B]
};

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }
// NaN-propagating max / min (torch.amax, torch.minimum).
__device__ __forceinline__ float nanmax(float a, float b) { return (a != a || a > b) ? a : b; }
__device__ __forceinline__ float nanmin(float a, float b) { return (a != a || a < b) ? a : b; }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fadd(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v = __dadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = nanmax(v, __shfl_xor_sync(kFull, v, o));
  return v;
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

// Per-thread constants of rows i = lane (P_i, theta_i) and n + lane (Q_i, |V|_i).
struct Rows {
  float p, q;             // injections of bus lane + 1
  float e, rs_re, rs_im;  // e_t, row sums at bus lane + 1
  double h00, h01, h10, h11;  // H^T rows lane and n + lane
  float g0a, g1a, g0b, g1b;   // G rows lane and n + lane
};

// True mismatch at (xa, xb) = (theta_lane, |V|_lane); returns F rows lane and
// n + lane.  vre / vim are the warp's [N] buffers.
__device__ __forceinline__ void mismatch(const Params& P, const double* W, double* vre, double* vim,
                                         const Rows& r, float dtf_re, float dtf_im, int lane,
                                         float xa, float xb, float* Fa, float* Fb) {
  const int n = P.n, N = n + 1, N2 = 2 * N;
  if (lane < n) {
    float sn, cs;
    sincos7(xa, &sn, &cs);
    vre[lane + 1] = (double)fmul(xb, cs);
    vim[lane + 1] = (double)fmul(xb, sn);
  }
  if (lane == 0) {
    vre[0] = 1.0;
    vim[0] = 0.0;
  }
  __syncwarp();
  if (lane < n) {
    const int j = lane + 1;
    double are = 0.0, aim = 0.0, bre = 0.0, bim = 0.0;
    for (int k = 0; k < N; ++k) {
      const double wr = W[k * N2 + j], wi = W[k * N2 + N + j];
      const double vr = vre[k], vi = vim[k];
      are = fma(vr, wr, are);
      aim = fma(vr, wi, aim);
      bre = fma(vi, wr, bre);
      bim = fma(vi, wi, bim);
    }
    const float yv_re = fadd(fsub((float)are, (float)bim), fmul(r.e, dtf_re));
    const float yv_im = fadd(fadd((float)bre, (float)aim), fmul(r.e, dtf_im));
    const float vr = (float)vre[j], vi = (float)vim[j];
    const float s_re = fadd(fmul(vr, yv_re), fmul(vi, yv_im));
    const float s_im = fsub(fmul(vi, yv_re), fmul(vr, yv_im));
    *Fa = fsub(s_re, r.p);
    *Fb = fsub(s_im, r.q);
  } else {
    *Fa = 0.0f;
    *Fb = 0.0f;
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kWarps * 32) chord_kernel(const Params P) {
  extern __shared__ double smem[];
  const int n = P.n, N = n + 1, n2 = 2 * n;
  double* W = smem;                 // [N, 2N]
  double* invJT = W + N * 2 * N;    // [2n, 2n]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  double* vre = invJT + n2 * n2 + warp * (2 * N + n2);  // [N]
  double* vim = vre + N;                                // [N]
  double* Fs = vim + N;                                 // [2n]

  for (int i = threadIdx.x; i < N * 2 * N; i += blockDim.x) W[i] = P.W_pack[i];
  for (int i = threadIdx.x; i < n2 * n2; i += blockDim.x) invJT[i] = P.invJ0_T[i];
  __syncthreads();

  const bool own = lane < n;
  Rows r{};
  if (own) {
    r.e = P.e_t[lane + 1];
    r.rs_re = P.rs_re[lane + 1];
    r.rs_im = P.rs_im[lane + 1];
    r.h00 = P.H_T[2 * lane];
    r.h01 = P.H_T[2 * lane + 1];
    r.h10 = P.H_T[2 * (n + lane)];
    r.h11 = P.H_T[2 * (n + lane) + 1];
    r.g0a = P.g_col0[lane];
    r.g1a = P.g_col1[lane];
    r.g0b = P.g_col0[n + lane];
    r.g1b = P.g_col1[n + lane];
  }
  const float c00 = P.C[0], c01 = P.C[1], c10 = P.C[2], c11 = P.C[3];

  for (long long b = (long long)blockIdx.x * kWarps + warp; b < P.B; b += (long long)gridDim.x * kWarps) {
    if (own) {
      r.p = P.p[b * n + lane];
      r.q = P.q[b * n + lane];
    }
    const float dtf_re = P.dtf_re[b], dtf_im = P.dtf_im[b];

    // K = W (I + C W)^-1, with W(a) at the linearization point V* = va + j vb.
    const float d_i = P.w_a[b], d_r = P.w_b[b];
    const float w00 = fsub(fmul(P.va, d_i), fmul(P.vb, d_r));
    const float w01 = fmul(fadd(fmul(P.va, d_r), fmul(P.vb, d_i)), P.inv_vmag);
    const float w10 = fadd(fmul(P.va, d_r), fmul(P.vb, d_i));
    const float w11 = fmul(fsub(fmul(P.vb, d_r), fmul(P.va, d_i)), P.inv_vmag);
    const float m00 = fadd(fadd(1.0f, fmul(c00, w00)), fmul(c01, w10));
    const float m01 = fadd(fmul(c00, w01), fmul(c01, w11));
    const float m10 = fadd(fmul(c10, w00), fmul(c11, w10));
    const float m11 = fadd(fadd(1.0f, fmul(c10, w01)), fmul(c11, w11));
    const float det = fsub(fmul(m00, m11), fmul(m01, m10));
    const float k00 = fdiv(fsub(fmul(w00, m11), fmul(w01, m10)), det);
    const float k01 = fdiv(fsub(fmul(w01, m00), fmul(w00, m01)), det);
    const float k10 = fdiv(fsub(fmul(w10, m11), fmul(w11, m10)), det);
    const float k11 = fdiv(fsub(fmul(w11, m00), fmul(w10, m01)), det);

    // Warm start, or the flat start where any entry is non-finite.
    float xa = 0.0f, xb = 1.0f;
    if (P.x0 != nullptr) {
      float ga = 0.0f, gb = 1.0f;
      if (own) {
        ga = P.x0[b * n2 + lane];
        gb = P.x0[b * n2 + n + lane];
      }
      if (__all_sync(kFull, isfinite(ga) && isfinite(gb))) {
        xa = ga;
        xb = gb;
      }
    }
    float Fa, Fb;
    mismatch(P, W, vre, vim, r, dtf_re, dtf_im, lane, xa, xb, &Fa, &Fb);
    float diff = warp_max(nanmax(fabsf(Fa), fabsf(Fb)));
    float best = diff;
    int it = 0, stall = 0;
    float gpa = xa, gpb = xb, fpa = 0.0f, fpb = 0.0f;

    while (diff > P.xtol && it < P.lim_iter && stall < (diff <= P.band ? 1 : 3)) {
      // Chord direction f = -invJ0 F + G K (H F), map value g = x + f.
      if (own) {
        Fs[lane] = (double)Fa;
        Fs[n + lane] = (double)Fb;
      }
      __syncwarp();
      const double u0d = warp_sum(own ? fma((double)Fa, r.h00, (double)Fb * r.h10) : 0.0);
      const double u1d = warp_sum(own ? fma((double)Fa, r.h01, (double)Fb * r.h11) : 0.0);
      const float u0 = (float)u0d, u1 = (float)u1d;
      const float t0 = fadd(fmul(k00, u0), fmul(k01, u1));
      const float t1 = fadd(fmul(k10, u0), fmul(k11, u1));
      float fa = 0.0f, fb = 0.0f;
      if (own) {
        double ma = 0.0, mb = 0.0;
        for (int k = 0; k < n2; ++k) {
          const double fk = Fs[k];
          ma = fma(invJT[k * n2 + lane], fk, ma);
          mb = fma(invJT[k * n2 + n + lane], fk, mb);
        }
        fa = fadd(-(float)ma, fadd(fmul(t0, r.g0a), fmul(t1, r.g1a)));
        fb = fadd(-(float)mb, fadd(fmul(t0, r.g0b), fmul(t1, r.g1b)));
      }
      __syncwarp();
      const float ga = fadd(xa, fa), gb = fadd(xb, fb);

      // Anderson(1) along the last two chord-map evaluations.
      const bool use_aa = it > 0 && diff > P.aa_gate;
      const float dfa = fsub(fa, fpa), dfb = fsub(fb, fpb);
      const float denom = warp_sum(own ? fadd(fmul(dfa, dfa), fmul(dfb, dfb)) : 0.0f);
      const float num = warp_sum(own ? fadd(fmul(fa, dfa), fmul(fb, dfb)) : 0.0f);
      float gamma = denom > 1e-30f ? fdiv(num, denom) : 0.0f;
      gamma = use_aa ? (gamma < -5.0f ? -5.0f : (gamma > 5.0f ? 5.0f : gamma)) : 0.0f;
      xa = fsub(ga, fmul(gamma, fsub(ga, gpa)));
      xb = fsub(gb, fmul(gamma, fsub(gb, gpb)));

      mismatch(P, W, vre, vim, r, dtf_re, dtf_im, lane, xa, xb, &Fa, &Fb);
      const float new_diff = warp_max(nanmax(fabsf(Fa), fabsf(Fb)));
      // Stalled = no iteration beating the best residual so far by >= 20%.
      stall = new_diff < fmul(best, 0.8f) ? 0 : stall + 1;
      best = nanmin(best, new_diff);
      diff = new_diff;
      ++it;
      gpa = ga;
      gpb = gb;
      fpa = fa;
      fpb = fb;
    }

    // Epilogue: accept, or reset to the flat start with its analytic residual
    // (S = conj(row sums of Y) at V = 1) for the Newton fallback.
    bool fin = isfinite(diff) && __all_sync(kFull, !own || (isfinite(xa) && isfinite(xb)));
    fin = fin && warp_max(own ? fabsf(xa) : 0.0f) <= 0.5f;
    float Ffa = 0.0f, Ffb = 0.0f;
    if (own) {
      Ffa = fsub(fadd(r.rs_re, fmul(r.e, dtf_re)), r.p);
      Ffb = fsub(-fadd(r.rs_im, fmul(r.e, dtf_im)), r.q);
    }
    const float diff_flat = warp_max(nanmax(fabsf(Ffa), fabsf(Ffb)));
    const int eff_limit = diff <= P.band ? 1 : 3;
    const bool plateaued = fin && stall >= eff_limit;
    const bool acc = (fin && diff <= P.xtol) || (plateaued && diff <= P.band);
    const bool reset = !acc && (!fin || !(diff <= diff_flat));
    if (reset) {
      xa = 0.0f;
      xb = 1.0f;
      Fa = Ffa;
      Fb = Ffb;
      diff = diff_flat;
      it = 0;
    }
    if (own) {
      P.x[b * n2 + lane] = xa;
      P.x[b * n2 + n + lane] = xb;
      P.F[b * n2 + lane] = Fa;
      P.F[b * n2 + n + lane] = Fb;
    }
    if (lane == 0) {
      P.diff[b] = diff;
      P.n_iter[b] = it;
      P.accepted[b] = acc ? 1 : 0;
    }
  }
}

}  // namespace

extern "C" int chord_newton_f32(const float* p, const float* q, const float* w_a, const float* w_b,
                                const float* dtf_re, const float* dtf_im, const float* x0,
                                const double* W_pack, const double* invJ0_T, const double* H_T,
                                const float* g_col0, const float* g_col1, const float* C,
                                const float* e_t, const float* rs_re, const float* rs_im,
                                float va, float vb, float inv_vmag, float xtol, float band, float aa_gate,
                                int lim_iter, float* x, float* F, float* diff, int* n_iter,
                                unsigned char* accepted, int B, int n, void* stream) {
  if (B <= 0 || n <= 0 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  const Params P{p, q, w_a, w_b, dtf_re, dtf_im, x0, W_pack, invJ0_T, H_T, g_col0, g_col1, C,
                 e_t, rs_re, rs_im, va, vb, inv_vmag, xtol, band, aa_gate, lim_iter, B, n,
                 x, F, diff, n_iter, accepted};
  const int N = n + 1, n2 = 2 * n;
  const size_t smem = (static_cast<size_t>(N) * 2 * N + static_cast<size_t>(n2) * n2 +
                       static_cast<size_t>(kWarps) * (2 * N + n2)) * sizeof(double);
  int device = 0, max_smem = 0, n_sm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (smem > static_cast<size_t>(max_smem)) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(chord_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chord_kernel, kWarps * 32, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long need = (static_cast<long long>(B) + kWarps - 1) / kWarps;
  const long long cap = static_cast<long long>(per_sm > 0 ? per_sm : 1) * n_sm;
  const int grid = static_cast<int>(need < cap ? need : cap);
  chord_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}
