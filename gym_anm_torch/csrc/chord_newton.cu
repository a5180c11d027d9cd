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
// Bound (IEEE33, n = 32, B = 8192 base warm starts, H100 SXM): each lane
// iteration multiplies [vre | vim] [2, N] by W_pack [N, 2N] and F [2n] by
// invJ0^T [2n, 2n], 4 N^2 + 4 n^2 = 8,452 float64 multiply-adds (plus ~130
// elementwise), so the work is the lane-iterations of the run times that:
// about 0.7 GFLOP in float64, 22 us at 34 TFLOP/s on the FP64 cores (11 us at
// the 67 TFLOP/s of the FP64 tensor cores).  Device memory sees p, q, x0, x, F
// and a few scalars per lane once, ~8.6 MB: 2.6 us.  So it is bound by
// operations.
//
// Design (a tile of lane slots shares every read of the constant matrices).
// A block holds kSlots = 8 lane slots, one warp each.  A slot warp keeps its
// lane's state in registers, thread i < n owning the unknowns i (theta_i, row
// P_i) and n + i (|V|_i, row Q_i), and does all of the lane's elementwise work
// and reductions (butterfly shuffles, so the lane scalars are bitwise equal in
// all 32 threads and every branch is warp-uniform).  The two matrix products
// of a round are computed for the 8 slots together on the FP64 tensor cores
// (mma.sync m16n8k4, sm_90), with the constant matrices' fragments held in
// registers for the whole launch (25 doubles a thread at n = 32):
//   mismatch: [vre; vim] of the 8 slots (16 rows, A) times W_pack (B), warp w
//             computing the w-th 8-column tile (columns 1..n of the Y0re^T
//             and Y0im^T halves);
//   update:   transposed, invJ0 (A, 16 of its rows per tile) times F^T of the
//             8 slots (B), warp w computing tile w % 4 over half w / 4 of k;
//             the slot adds the two halves.
// Each constant entry is thus read once per round for 8 lanes, from
// registers; one warp per lane with the matrices in shared memory would read
// it once per lane per iteration from shared memory, 8 bytes per
// multiply-add, and be bound by that.  The products stay
// float64 sums of exact float32 products, rounded once to float32, as
// complexops.matmul_full forms them (summed in another order than the plain
// version's cuBLAS product, which can move a float32 rounding, rarely).  The
// 16-row shape: on an H100 the 8-row m8n8k4 tops out near 29 TFLOP/s and the
// m16n8 shapes near 62 (a microbenchmark of ours), and with 8 slots only the
// mismatch's [vre; vim] and the transposed update fill 16 rows.
//
// A round, with block barriers between the steps: (1) an empty slot takes its
// next lane and runs its prologue up to the warm start, and iterating slots
// stage F; (2) F x invJ0^T; (3) iterating slots form f, g and the Anderson
// step, and every slot with a lane stages V at its new point; (4) the
// mismatch product; (5) the slots finish F, ||F||inf and the stall rule; a
// slot whose lane exits writes its outputs and is empty for the next round.
// A refilled slot's prologue mismatch thus joins the block's next mismatch
// round, and a slot with no lane left stages zeros until the block is done.
// Lanes come from a work counter (an atomicAdd on a device int the wrapper
// zeroes).
// The grid is persistent (SMs x resident blocks).  n <= 8 (ANM6Easy) runs an
// instantiation with the k-chunks of that width.
//
// Numerics follow the plain version op for op: elementwise float32 arithmetic
// is rounded op by op (__fmul_rn, __fadd_rn, ...), so no multiply-add is
// contracted that the plain version does not form; max, minimum and clamp
// propagate NaN as torch.amax, torch.minimum and torch.clamp do.  The AA sums
// are float32 sums in butterfly order over the warp (thread i's pair of
// entries i and n + i first, the idle threads' zeros included), and the plain
// version sums in that order too (power_flow.py:_butterfly_sum), so the two
// round alike at any n.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxN = 32;   // non-slack buses per lane: 2n <= 64 (IEEE33)
constexpr int kSlots = 8;   // lane slots per block, one warp each
constexpr unsigned kFull = 0xffffffffu;
constexpr int kKC1 = (kMaxN + 1 + 3) / 4;  // k-chunks of 4 of the mismatch product (N <= 33)
constexpr int kKH2 = 2 * kMaxN / 8;        // k-chunks of 4 of each half of the update product (2n <= 64)
constexpr int kVLD = 4 * kKC1;             // row stride of the staged voltages (doubles)
constexpr int kFLD = 8 * kKH2 + 4;         // row stride of the staged mismatch (doubles; +4: no bank conflicts)
constexpr int kOLD = 2 * kMaxN + 4;        // row stride of the update product's halves (doubles)
constexpr int kMLD = kMaxN + 8;            // row stride of the mismatch products (floats)

enum Phase : int { kEmpty = 0, kPro = 1, kIter = 2, kDone = 3 };

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
  int* next_lane;       // [1] work counter, 0 at launch
};

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }
// NaN-propagating max / min (torch.amax, torch.minimum).
__device__ __forceinline__ float nanmax(float a, float b) { return (a != a || a > b) ? a : b; }
__device__ __forceinline__ float nanmin(float a, float b) { return (a != a || a < b) ? a : b; }

// Two butterfly sums over the warp at once (offsets 16, 8, 4, 2, 1).
__device__ __forceinline__ void warp_sum2(float& u, float& v) {
  for (int o = 16; o > 0; o >>= 1) {
    const float du = __shfl_xor_sync(kFull, u, o), dv = __shfl_xor_sync(kFull, v, o);
    u = fadd(u, du);
    v = fadd(v, dv);
  }
}
__device__ __forceinline__ void warp_sum2(double& u, double& v) {
  for (int o = 16; o > 0; o >>= 1) {
    const double du = __shfl_xor_sync(kFull, u, o), dv = __shfl_xor_sync(kFull, v, o);
    u = __dadd_rn(u, du);
    v = __dadd_rn(v, dv);
  }
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = nanmax(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// D = A B + D for a 16x8 float64 tile, k = 4 (sm_90): with g = l / 4 and
// t = l % 4, thread l holds A[g][t] (a0) and A[g + 8][t] (a1), B[t][g], and
// D[g][2t], D[g][2t + 1], D[g + 8][2t], D[g + 8][2t + 1] (d[0..3]).
__device__ __forceinline__ void dmma(double (&d)[4], double a0, double a1, double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
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
// (Registers are the scarce resource at 16 slots a streaming multiprocessor:
// what is needed only at a lane's entry or exit is read there.)
struct Rows {
  float p, q;                 // injections of bus lane + 1
  float e;                    // e_t at bus lane + 1
  float h00, h01, h10, h11;   // H^T rows lane and n + lane (float32 values)
  float g0a, g1a, g0b, g1b;   // G rows lane and n + lane
};

// A lane's inputs as one thread of its slot warp holds them: its own
// injections and warm-start entries (threads i < n), the lane's scalars.
struct LaneIn {
  float p = 0.0f, q = 0.0f, x0a = 0.0f, x0b = 1.0f;
  float w_a = 0.0f, w_b = 0.0f, dtf_re = 0.0f, dtf_im = 0.0f;
};

__device__ __forceinline__ LaneIn load_lane(const Params& P, long long b, int lane) {
  LaneIn in;
  if (b >= P.B) return in;
  const int n = P.n;
  if (lane < n) {
    in.p = P.p[b * n + lane];
    in.q = P.q[b * n + lane];
    if (P.x0 != nullptr) {
      in.x0a = P.x0[b * 2 * n + lane];
      in.x0b = P.x0[b * 2 * n + n + lane];
    }
  }
  in.w_a = P.w_a[b];
  in.w_b = P.w_b[b];
  in.dtf_re = P.dtf_re[b];
  in.dtf_im = P.dtf_im[b];
  return in;
}

// KC1: k-chunks of 4 of the mismatch product, KH2: of each half of the
// update product, for the sizes this instantiation takes (the staged rows
// are zero beyond N and 2n).
template <int KC1, int KH2>
__global__ void __launch_bounds__(kSlots * 32, 2) chord_kernel(const Params P) {
  __shared__ double sV[2][kSlots][kVLD];    // V of each slot at its current point (re, im), bus 0 = slack
  __shared__ double sF[kSlots][kFLD];       // F of each iterating slot
  __shared__ double sUpd[2][kSlots][kOLD];  // invJ0 F over each half of k
  __shared__ float sMM[4][kSlots][kMLD];    // vre Y0re^T, vre Y0im^T, vim Y0re^T, vim Y0im^T at buses 1..n
  __shared__ int sPhase[kSlots];

  const int n = P.n, N = n + 1, n2 = 2 * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tph = (n + 7) / 8;           // mismatch tiles per half
  const int tiles1 = 2 * tph;
  const int grp = lane >> 2, tig = lane & 3;  // mma fragment coordinates

  // Zero the staging rows (their padding stays zero) and load this warp's
  // fragments of both constant matrices: W_pack as the B operand of the
  // mismatch tile `warp`; invJ0 (invJ0^T read by columns) as the A operand
  // of the update tile: 16 output columns (warp % 4) over one half of k
  // (warp / 4).
  for (int i = threadIdx.x; i < 2 * kSlots * kVLD; i += blockDim.x) (&sV[0][0][0])[i] = 0.0;
  for (int i = threadIdx.x; i < kSlots * kFLD; i += blockDim.x) (&sF[0][0])[i] = 0.0;
  double bm[KC1], au[2 * KH2];
  const int mt = warp & 3, kh = warp >> 2;  // update tile: columns 16 mt.., k from 4 KH2 kh
  {
    const int half = warp / tph;                      // 0: the Y0re^T columns, 1: the Y0im^T columns
    const int j = 1 + 8 * (warp - half * tph) + grp;  // bus of this thread's B column
#pragma unroll
    for (int c = 0; c < KC1; ++c) {
      const int k = 4 * c + tig;
      bm[c] = (warp < tiles1 && k < N && j <= n) ? P.W_pack[k * 2 * N + half * N + j] : 0.0;
    }
    const int col = 16 * mt + grp;
#pragma unroll
    for (int c = 0; c < KH2; ++c) {
      const int k = 4 * (KH2 * kh + c) + tig;
      au[2 * c] = (k < n2 && col < n2) ? P.invJ0_T[k * n2 + col] : 0.0;
      au[2 * c + 1] = (k < n2 && col + 8 < n2) ? P.invJ0_T[k * n2 + col + 8] : 0.0;
    }
  }

  const bool own = lane < n;
  Rows r{};
  if (own) {
    r.e = P.e_t[lane + 1];
    r.h00 = (float)P.H_T[2 * lane];
    r.h01 = (float)P.H_T[2 * lane + 1];
    r.h10 = (float)P.H_T[2 * (n + lane)];
    r.h11 = (float)P.H_T[2 * (n + lane) + 1];
    r.g0a = P.g_col0[lane];
    r.g1a = P.g_col1[lane];
    r.g0b = P.g_col0[n + lane];
    r.g1b = P.g_col1[n + lane];
  }
  __syncthreads();

  // This warp's slot.
  int phase = kEmpty;
  int b = 0;
  float dtf_re = 0.0f, dtf_im = 0.0f, k00 = 0.0f, k01 = 0.0f, k10 = 0.0f, k11 = 0.0f;
  float xa = 0.0f, xb = 1.0f, Fa = 0.0f, Fb = 0.0f, diff = 0.0f, best = 0.0f;
  int it = 0, stall = 0;
  float gpa = 0.0f, gpb = 0.0f, fpa = 0.0f, fpb = 0.0f;  // g and f of the previous iteration
  float vr = 0.0f, vi = 0.0f;                            // V at this round's point (own threads)

  while (true) {
    // (1) Refill an empty slot; stage F for the update product.
    if (phase == kEmpty) {
      int claim = 0;
      if (lane == 0) claim = atomicAdd(P.next_lane, 1);
      b = __shfl_sync(kFull, claim, 0);
      if (b >= P.B) {
        phase = kDone;
      } else {
        phase = kPro;
        const LaneIn in = load_lane(P, b, lane);
        r.p = in.p;
        r.q = in.q;
        dtf_re = in.dtf_re;
        dtf_im = in.dtf_im;
        // K = W (I + C W)^-1, with W(a) at the linearization point V* = va + j vb.
        const float d_i = in.w_a, d_r = in.w_b;
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
        // Warm start, or the flat start where any entry is non-finite.
        xa = 0.0f;
        xb = 1.0f;
        if (P.x0 != nullptr && __all_sync(kFull, isfinite(in.x0a) && isfinite(in.x0b))) {
          xa = in.x0a;
          xb = in.x0b;
        }
      }
    }
    if (lane == 0) sPhase[warp] = phase;
    if (own) {
      sF[warp][lane] = phase == kIter ? (double)Fa : 0.0;
      sF[warp][n + lane] = phase == kIter ? (double)Fb : 0.0;
    }
    __syncthreads();
    bool all_done = true;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) all_done &= sPhase[s] == kDone;
    if (all_done) break;

    // (2) The update product, transposed: (invJ0 F^T) [2n, 8 slots] as tiles
    // of 16 rows of invJ0 (A, in registers) times F^T (B, staged), each warp
    // one tile over one half of k, in two accumulator chains (a warp past the
    // last tile multiplies zeros); beside it, in the same
    // straight-line code so that the two interleave, this warp's slot's H F
    // (the Woodbury projection).
    double u0d = own ? fma((double)Fa, (double)r.h00, (double)Fb * (double)r.h10) : 0.0;
    double u1d = own ? fma((double)Fa, (double)r.h01, (double)Fb * (double)r.h11) : 0.0;
    {
      double d[2][4] = {};
#pragma unroll
      for (int c = 0; c < KH2; ++c) dmma(d[c & 1], au[2 * c], au[2 * c + 1], sF[grp][4 * (KH2 * kh + c) + tig]);
      warp_sum2(u0d, u1d);
      const int col = 16 * mt + grp;  // D rows grp and grp + 8: columns col and col + 8; D columns: slots
      if (col < n2) {
        sUpd[kh][2 * tig][col] = d[0][0] + d[1][0];
        sUpd[kh][2 * tig + 1][col] = d[0][1] + d[1][1];
      }
      if (col + 8 < n2) {
        sUpd[kh][2 * tig][col + 8] = d[0][2] + d[1][2];
        sUpd[kh][2 * tig + 1][col + 8] = d[0][3] + d[1][3];
      }
    }
    __syncthreads();

    // (3) Chord direction f = -invJ0 F + G K (H F), map value g = x + f, and
    // Anderson(1) along the last two chord-map evaluations; then stage V.
    if (phase == kIter) {
      const float u0 = (float)u0d, u1 = (float)u1d;
      const float t0 = fadd(fmul(k00, u0), fmul(k01, u1));
      const float t1 = fadd(fmul(k10, u0), fmul(k11, u1));
      float fa = 0.0f, fb = 0.0f;
      if (own) {
        const float ua = (float)(sUpd[0][warp][lane] + sUpd[1][warp][lane]);
        const float ub = (float)(sUpd[0][warp][n + lane] + sUpd[1][warp][n + lane]);
        fa = fadd(-ua, fadd(fmul(t0, r.g0a), fmul(t1, r.g1a)));
        fb = fadd(-ub, fadd(fmul(t0, r.g0b), fmul(t1, r.g1b)));
      }
      const float ga = fadd(xa, fa), gb = fadd(xb, fb);
      const bool use_aa = it > 0 && diff > P.aa_gate;
      const float dfa = fsub(fa, fpa), dfb = fsub(fb, fpb);
      float denom = own ? fadd(fmul(dfa, dfa), fmul(dfb, dfb)) : 0.0f;
      float num = own ? fadd(fmul(fa, dfa), fmul(fb, dfb)) : 0.0f;
      warp_sum2(denom, num);
      float gamma = denom > 1e-30f ? fdiv(num, denom) : 0.0f;
      gamma = use_aa ? (gamma < -5.0f ? -5.0f : (gamma > 5.0f ? 5.0f : gamma)) : 0.0f;
      xa = fsub(ga, fmul(gamma, fsub(ga, gpa)));
      xb = fsub(gb, fmul(gamma, fsub(gb, gpb)));
      gpa = ga;
      gpb = gb;
      fpa = fa;
      fpb = fb;
    }
    const bool live = phase == kPro || phase == kIter;
    if (own) {
      float sn, cs;
      sincos7(xa, &sn, &cs);
      vr = fmul(xb, cs);
      vi = fmul(xb, sn);
      sV[0][warp][lane + 1] = live ? (double)vr : 0.0;
      sV[1][warp][lane + 1] = live ? (double)vi : 0.0;
    }
    if (lane == 0) {
      sV[0][warp][0] = live ? 1.0 : 0.0;
      sV[1][warp][0] = 0.0;
    }
    __syncthreads();

    // (4) The mismatch products of the 8 slots, [vre; vim] (16 rows: A) times
    // tile `warp` of W_pack (B), in two accumulator chains (even and odd
    // chunks).
    if (warp < tiles1) {
      double d[2][4] = {};
#pragma unroll
      for (int c = 0; c < KC1; ++c) dmma(d[c & 1], sV[0][grp][4 * c + tig], sV[1][grp][4 * c + tig], bm[c]);
      const int half = warp / tph;
      const int i = 8 * (warp - half * tph) + 2 * tig;  // bus i + 1
      if (i < n) {
        sMM[half][grp][i] = (float)(d[0][0] + d[1][0]);
        sMM[2 + half][grp][i] = (float)(d[0][2] + d[1][2]);
      }
      if (i + 1 < n) {
        sMM[half][grp][i + 1] = (float)(d[0][1] + d[1][1]);
        sMM[2 + half][grp][i + 1] = (float)(d[0][3] + d[1][3]);
      }
    }
    __syncthreads();

    // (5) True mismatch, ||F||inf, the stall rule and the exit test.
    if (live) {
      Fa = 0.0f;
      Fb = 0.0f;
      if (own) {
        const float are = sMM[0][warp][lane], aim = sMM[1][warp][lane];
        const float bre = sMM[2][warp][lane], bim = sMM[3][warp][lane];
        const float yv_re = fadd(fsub(are, bim), fmul(r.e, dtf_re));
        const float yv_im = fadd(fadd(bre, aim), fmul(r.e, dtf_im));
        const float s_re = fadd(fmul(vr, yv_re), fmul(vi, yv_im));
        const float s_im = fsub(fmul(vi, yv_re), fmul(vr, yv_im));
        Fa = fsub(s_re, r.p);
        Fb = fsub(s_im, r.q);
      }
      const float new_diff = warp_max(nanmax(fabsf(Fa), fabsf(Fb)));
      if (phase == kPro) {
        diff = new_diff;
        best = new_diff;
        it = 0;
        stall = 0;
        gpa = xa;
        gpb = xb;
        fpa = 0.0f;
        fpb = 0.0f;
        phase = kIter;
      } else {
        // Stalled = no iteration beating the best residual so far by >= 20%.
        stall = new_diff < fmul(best, 0.8f) ? 0 : stall + 1;
        best = nanmin(best, new_diff);
        diff = new_diff;
        ++it;
      }
      if (!(diff > P.xtol && it < P.lim_iter && stall < (diff <= P.band ? 1 : 3))) {
        // Epilogue: accept, or reset to the flat start with its analytic
        // residual (S = conj(row sums of Y) at V = 1) for the Newton fallback.
        bool fin = isfinite(diff) && __all_sync(kFull, !own || (isfinite(xa) && isfinite(xb)));
        fin = fin && warp_max(own ? fabsf(xa) : 0.0f) <= 0.5f;
        float Ffa = 0.0f, Ffb = 0.0f;
        if (own) {
          Ffa = fsub(fadd(P.rs_re[lane + 1], fmul(r.e, dtf_re)), r.p);
          Ffb = fsub(-fadd(P.rs_im[lane + 1], fmul(r.e, dtf_im)), r.q);
        }
        const float diff_flat = warp_max(nanmax(fabsf(Ffa), fabsf(Ffb)));
        const int eff_limit = diff <= P.band ? 1 : 3;
        const bool plateaued = fin && stall >= eff_limit;
        const bool acc = (fin && diff <= P.xtol) || (plateaued && diff <= P.band);
        const bool reset = !acc && (!fin || !(diff <= diff_flat));
        float oa = xa, ob = xb, oFa = Fa, oFb = Fb, odiff = diff;
        int oit = it;
        if (reset) {
          oa = 0.0f;
          ob = 1.0f;
          oFa = Ffa;
          oFb = Ffb;
          odiff = diff_flat;
          oit = 0;
        }
        if (own) {
          const long long o = (long long)b * n2 + lane;
          P.x[o] = oa;
          P.x[o + n] = ob;
          P.F[o] = oFa;
          P.F[o + n] = oFb;
        }
        if (lane == 0) {
          P.diff[b] = odiff;
          P.n_iter[b] = oit;
          P.accepted[b] = acc ? 1 : 0;
        }
        phase = kEmpty;
      }
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
                                unsigned char* accepted, int* next_lane, int B, int n, void* stream) {
  if (B <= 0 || n <= 0 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  const Params P{p, q, w_a, w_b, dtf_re, dtf_im, x0, W_pack, invJ0_T, H_T, g_col0, g_col1, C,
                 e_t, rs_re, rs_im, va, vb, inv_vmag, xtol, band, aa_gate, lim_iter, B, n,
                 x, F, diff, n_iter, accepted, next_lane};
  int device = 0, n_sm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  // n <= 8: the products' chunks of IEEE33's width would be zeros.
  void (*kernel)(const Params) = n <= 8 ? chord_kernel<3, 2> : chord_kernel<kKC1, kKH2>;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSlots * 32, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long need = (static_cast<long long>(B) + kSlots - 1) / kSlots;
  const long long cap = static_cast<long long>(per_sm > 0 ? per_sm : 1) * n_sm;
  const int grid = static_cast<int>(need < cap ? need : cap);
  kernel<<<grid, kSlots * 32, 0, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}
