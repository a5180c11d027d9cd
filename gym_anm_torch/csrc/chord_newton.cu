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
// operations; what holds it back is the latency of a round's dependent steps.
//
// Design (a tile of lane slots shares every read of the constant matrices).
// A block has 8 warps, and a warp carries LW lanes (a template argument: 1 or
// 2), so a block holds 8 LW lane slots, slot s on warp s % 8.  A warp keeps
// its lanes' state in registers, thread i < n owning the unknowns i (theta_i,
// row P_i) and n + i (|V|_i, row Q_i) of each, and does all of their
// elementwise work and reductions (warp shuffles and reductions, so the lane
// scalars are bitwise equal in all 32 threads and every branch is
// warp-uniform); its lanes' arithmetic is interleaved in each thread, and
// their sums share one reduction.  Shuffles bound much of a round (an SM
// runs one a cycle for all its warps), so the sums trade half their values
// at the first offsets instead of all of them (warp_sum) and the maxima are
// one integer reduction (warp_max), both giving the butterfly's bits.
// The two matrix products of a round are computed for the block's slots
// together on the FP64 tensor cores (mma.sync m16n8k4, sm_90), in lane tiles
// of 8 slots (tile t: the t-th lane of every warp), from the constant
// matrices' fragments (25 doubles a thread at n = 32):
//   mismatch: [vre; vim] of a tile's 8 slots (16 rows, A) times W_pack (B),
//             warp w computing the w-th 8-column tile (columns 1..n of the
//             Y0re^T and Y0im^T halves) for every lane tile;
//   update:   transposed, invJ0 (A, 16 of its rows per tile) times F^T of a
//             tile's 8 slots (B), warp w computing row tile w % 4 over half
//             w / 4 of k for every lane tile; the slot adds the two halves.
// Each fragment a warp reads thus serves all LW lane tiles, and the warp
// keeps 2 LW accumulator chains in flight (even and odd k-chunks of each
// tile).  The fragments live where they cost no block an SM: in registers at
// 8 slots (125 a thread, two blocks an SM); in shared memory at 16 slots
// (51,200 bytes a block, read once a round: in registers beside a second
// lane they spill) and at n <= 8 (80 registers a thread: three blocks an
// SM).  Two blocks of 16 slots hold 32 lanes in flight an SM on one copy of
// the constants a block, where two of 8 held 16.  The products stay float64
// sums of exact float32 products, rounded once to float32, as
// complexops.matmul_full forms them (summed in another order than the plain
// version's cuBLAS product, which can move a float32 rounding, rarely);
// every accumulator keeps its k-order whatever LW is, so the two widths give
// the same bits.  The 16-row shape: on an H100 the 8-row m8n8k4 tops out
// near 29 TFLOP/s and the m16n8 shapes near 62 (a microbenchmark of ours),
// and with 8 slots a tile only the mismatch's [vre; vim] and the transposed
// update fill 16 rows.  The wrapper picks the width (chord_cuda.tile_slots):
// 16 slots at n = 32 (the instantiation with n compiled in) once the batch
// fills every such slot of the card, else 8.
//
// A round, with block barriers between the steps: (1) an empty slot takes its
// next lane and runs its prologue up to the warm start (a warp claims all its
// empty slots' lanes at once and has their loads in flight before it uses
// the first), and iterating slots stage F, the barrier after it voting
// whether every slot of the block is done; (2) F x invJ0^T; (3) iterating
// slots form f, g and the Anderson step, and every slot with a lane stages V
// at its new point; (4) the mismatch product; (5) the slots finish F,
// ||F||inf and the stall rule; a slot whose lane exits writes its outputs and
// is empty for the next round.  A refilled slot's prologue mismatch thus
// joins the block's next mismatch round, and a slot with no lane left stages
// zeros until the block is done.  Lanes come from a work counter (an
// atomicAdd on a device int the wrapper zeroes).  The grid is persistent
// (SMs x resident blocks).  n <= 8 (ANM6Easy) runs an instantiation with the
// k-chunks of that width.
//
// Numerics follow the plain version op for op: elementwise float32 arithmetic
// is rounded op by op (__fmul_rn, __fadd_rn, ...), so no multiply-add is
// contracted that the plain version does not form; max, minimum and clamp
// propagate NaN as torch.amax, torch.minimum and torch.clamp do.  The AA sums
// are float32 sums in butterfly order over the warp (thread i's pair of
// entries i and n + i first, the idle threads' zeros included), and the plain
// version sums in that order too (power_flow.py:_butterfly_sum), so the two
// round alike at any n; the Woodbury projection H F is a float64 sum in the
// same order.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxN = 32;   // non-slack buses per lane: 2n <= 64 (IEEE33)
constexpr int kWarps = 8;   // warps per block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kKC1 = (kMaxN + 1 + 3) / 4;  // k-chunks of 4 of the mismatch product (N <= 33)
constexpr int kKH2 = 2 * kMaxN / 8;        // k-chunks of 4 of each half of the update product (2n <= 64)
constexpr int kVLD = 4 * kKC1;             // row stride of the staged voltages (doubles)
constexpr int kFLD = 8 * kKH2 + 4;         // row stride of the staged mismatch (doubles; +4: no bank conflicts)
constexpr int kOLD = 2 * kMaxN + 4;        // row stride of the update product's halves (doubles)
constexpr int kMLD = kMaxN + 8;            // row stride of the mismatch products (floats)

enum Phase : int { kEmpty = 0, kPro = 1, kIter = 2, kDone = 3 };

// A block's shared memory (byte offsets) at LW lanes a warp: the staged
// voltages [2][S][kVLD] and mismatch [S][kFLD] (doubles), the update
// product's halves [2][S][kOLD] (doubles), the warps' constant fragments
// [kWarps][kFrag][32] (doubles; none where FR holds them in registers) and
// the mismatch products [4][S][kMLD] (floats).
template <int KC1, int KH2, int LW, bool FR>
struct Layout {
  static constexpr int S = kWarps * LW;      // lane slots
  static constexpr int kFrag = KC1 + 2 * KH2;  // fragment doubles a thread
  static constexpr size_t V = 0;
  static constexpr size_t F = V + sizeof(double) * 2 * S * kVLD;
  static constexpr size_t U = F + sizeof(double) * S * kFLD;
  static constexpr size_t W = U + sizeof(double) * 2 * S * kOLD;
  static constexpr size_t M = W + (FR ? 0 : sizeof(double) * kWarps * kFrag * 32);
  static constexpr size_t bytes = M + sizeof(float) * 4 * S * kMLD;
};

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
// A sum rounded once, in either type (the warp sums').
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
// NaN-propagating max / min (torch.amax, torch.minimum).
__device__ __forceinline__ float nanmax(float a, float b) { return (a != a || a > b) ? a : b; }
__device__ __forceinline__ float nanmin(float a, float b) { return (a != a || a < b) ? a : b; }

// K butterfly sums over the warp at once (offsets 16, 8, 4, 2, 1), each bit
// for bit the sum one butterfly alone gives, in every thread, with about
// half the shuffles: at the first log2 K offsets a thread keeps the half of
// its values its lane bit selects and trades the other half with its
// partner, who holds the same values (IEEE addition commutes, so each kept
// partial is the butterfly's); the last offsets sum the one value left; then
// value k is broadcast from lane k 32 / K, which holds it.
template <typename T, int K>
__device__ __forceinline__ void warp_sum(T (&u)[K], int lane) {
  static_assert(K >= 2 && K <= 32 && (K & (K - 1)) == 0, "K: a power of two");
  T v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = u[k];
  int o = 16;
#pragma unroll
  for (int held = K; held > 1; held /= 2, o >>= 1) {
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int j = 0; j < held / 2; ++j) {
      const T mine = upper ? v[held / 2 + j] : v[j];
      v[j] = add_rn(mine, __shfl_xor_sync(kFull, upper ? v[j] : v[held / 2 + j], o));
    }
  }
  for (; o > 0; o >>= 1) v[0] = add_rn(v[0], __shfl_xor_sync(kFull, v[0], o));
#pragma unroll
  for (int k = 0; k < K; ++k) u[k] = __shfl_sync(kFull, v[0], k * (32 / K));
}
// The NaN-propagating maximum over the warp of non-negative floats (or
// NaN): their bit patterns order as unsigned integers, NaN above infinity,
// so one warp reduction gives torch.amax's value.
template <int K>
__device__ __forceinline__ void warp_max(float (&v)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = __uint_as_float(__reduce_max_sync(kFull, __float_as_uint(v[k])));
}
__device__ __forceinline__ float warp_max(float v) {
  float a[1] = {v};
  warp_max(a);
  return a[0];
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
// (Registers are the scarce resource at 32 slots a streaming multiprocessor:
// what is needed only at a lane's entry or exit is read there.)
struct Rows {
  float e;                    // e_t at bus lane + 1
  float h00, h01, h10, h11;   // H^T rows lane and n + lane (float32 values)
  float g0a, g1a, g0b, g1b;   // G rows lane and n + lane
};

// One lane slot's state as one thread of its warp holds it.
struct Slot {
  int phase = kEmpty, b = 0, it = 0, stall = 0;
  float p = 0.0f, q = 0.0f;  // injections of bus lane + 1 (own threads)
  float dtf_re = 0.0f, dtf_im = 0.0f, k00 = 0.0f, k01 = 0.0f, k10 = 0.0f, k11 = 0.0f;
  float xa = 0.0f, xb = 1.0f, Fa = 0.0f, Fb = 0.0f, diff = 0.0f, best = 0.0f;
  float gpa = 0.0f, gpb = 0.0f, fpa = 0.0f, fpb = 0.0f;  // g and f of the previous iteration
};

// A slot given lane b (claimed from the work counter) loads its injections,
// warm start and scalars (refill_load), then forms K = W (I + C W)^-1 and
// takes its warm start, or the flat start where any entry is non-finite
// (refill_start): the loads of all of a warp's refilled slots are in flight
// before the first is used.
struct Fresh {
  float x0a = 0.0f, x0b = 1.0f, w_a = 0.0f, w_b = 0.0f;
};
__device__ __forceinline__ void refill_load(const Params& P, Slot& s, Fresh& f, int lane, int n) {
  const long long b = s.b;
  s.p = 0.0f;
  s.q = 0.0f;
  if (lane < n) {
    s.p = P.p[b * n + lane];
    s.q = P.q[b * n + lane];
    if (P.x0 != nullptr) {
      f.x0a = P.x0[b * 2 * n + lane];
      f.x0b = P.x0[b * 2 * n + n + lane];
    }
  }
  s.dtf_re = P.dtf_re[b];
  s.dtf_im = P.dtf_im[b];
  f.w_a = P.w_a[b];
  f.w_b = P.w_b[b];
}
__device__ __forceinline__ void refill_start(const Params& P, Slot& s, const Fresh& f) {
  // K = W (I + C W)^-1, with W(a) at the linearization point V* = va + j vb.
  const float d_i = f.w_a, d_r = f.w_b;
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
  s.k00 = fdiv(fsub(fmul(w00, m11), fmul(w01, m10)), det);
  s.k01 = fdiv(fsub(fmul(w01, m00), fmul(w00, m01)), det);
  s.k10 = fdiv(fsub(fmul(w10, m11), fmul(w11, m10)), det);
  s.k11 = fdiv(fsub(fmul(w11, m00), fmul(w10, m01)), det);
  s.xa = 0.0f;
  s.xb = 1.0f;
  if (P.x0 != nullptr && __all_sync(kFull, isfinite(f.x0a) && isfinite(f.x0b))) {
    s.xa = f.x0a;
    s.xb = f.x0b;
  }
}

// A lane's exit: accept, or reset to the flat start with its analytic
// residual (S = conj(row sums of Y) at V = 1) for the Newton fallback; write
// its outputs and empty the slot.
__device__ __forceinline__ void finish(const Params& P, Slot& s, const Rows& r, int lane, int n) {
  const bool own = lane < n;
  bool fin = isfinite(s.diff) && __all_sync(kFull, !own || (isfinite(s.xa) && isfinite(s.xb)));
  fin = fin && warp_max(own ? fabsf(s.xa) : 0.0f) <= 0.5f;
  float Ffa = 0.0f, Ffb = 0.0f;
  if (own) {
    Ffa = fsub(fadd(P.rs_re[lane + 1], fmul(r.e, s.dtf_re)), s.p);
    Ffb = fsub(-fadd(P.rs_im[lane + 1], fmul(r.e, s.dtf_im)), s.q);
  }
  const float diff_flat = warp_max(nanmax(fabsf(Ffa), fabsf(Ffb)));
  const int eff_limit = s.diff <= P.band ? 1 : 3;
  const bool plateaued = fin && s.stall >= eff_limit;
  const bool acc = (fin && s.diff <= P.xtol) || (plateaued && s.diff <= P.band);
  const bool reset = !acc && (!fin || !(s.diff <= diff_flat));
  float oa = s.xa, ob = s.xb, oFa = s.Fa, oFb = s.Fb, odiff = s.diff;
  int oit = s.it;
  if (reset) {
    oa = 0.0f;
    ob = 1.0f;
    oFa = Ffa;
    oFb = Ffb;
    odiff = diff_flat;
    oit = 0;
  }
  if (own) {
    const long long o = (long long)s.b * 2 * n + lane;
    P.x[o] = oa;
    P.x[o + n] = ob;
    P.F[o] = oFa;
    P.F[o + n] = oFb;
  }
  if (lane == 0) {
    P.diff[s.b] = odiff;
    P.n_iter[s.b] = oit;
    P.accepted[s.b] = acc ? 1 : 0;
  }
  s.phase = kEmpty;
}

// KC1: k-chunks of 4 of the mismatch product, KH2: of each half of the
// update product, for the sizes this instantiation takes (the staged rows
// are zero beyond N and 2n); LW: lanes a warp; FR: the constant fragments
// held in registers (else read from shared memory each round); NN: n
// compiled in (0: read from the parameters).
template <int KC1, int KH2, int LW, bool FR, int NN>
__global__ void __launch_bounds__(kWarps * 32, 2) chord_kernel(const Params P) {
  using L = Layout<KC1, KH2, LW, FR>;
  constexpr int S = L::S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double(*sV)[S][kVLD] = reinterpret_cast<double(*)[S][kVLD]>(smem_raw + L::V);  // V at the slot's point (re, im), bus 0 = slack
  double(*sF)[kFLD] = reinterpret_cast<double(*)[kFLD]>(smem_raw + L::F);        // F of each iterating slot
  double(*sUpd)[S][kOLD] = reinterpret_cast<double(*)[S][kOLD]>(smem_raw + L::U);  // invJ0 F over each half of k
  float(*sMM)[S][kMLD] = reinterpret_cast<float(*)[S][kMLD]>(smem_raw + L::M);  // vre Y0re^T, vre Y0im^T, vim Y0re^T, vim Y0im^T

  const int n = NN > 0 ? NN : P.n, N = n + 1, n2 = 2 * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tph = (n + 7) / 8;           // mismatch tiles per half
  const int tiles1 = 2 * tph;
  const int grp = lane >> 2, tig = lane & 3;  // mma fragment coordinates

  // Zero the staging rows (their padding stays zero) and place this warp's
  // fragments of both constant matrices, thread `lane`'s c-th in frr[c]
  // (FR) or at fr[32 c] in shared memory: W_pack as the B operand of the
  // mismatch tile `warp` (c < KC1); invJ0 (invJ0^T read by columns) as the A
  // operand of the update tile, 16 output columns (warp % 4) over one half of
  // k (warp / 4), a pair for each chunk.
  for (int i = threadIdx.x; i < 2 * S * kVLD; i += blockDim.x) (&sV[0][0][0])[i] = 0.0;
  for (int i = threadIdx.x; i < S * kFLD; i += blockDim.x) (&sF[0][0])[i] = 0.0;
  double frr[FR ? L::kFrag : 1];
  double* const fr = reinterpret_cast<double*>(smem_raw + L::W) + warp * L::kFrag * 32 + lane;
  const auto place = [&](int c, double v) {
    if constexpr (FR) {
      frr[c] = v;
    } else {
      fr[32 * c] = v;
    }
  };
  const auto frag = [&](int c) -> double {
    if constexpr (FR) return frr[c];
    return fr[32 * c];
  };
  const int mt = warp & 3, kh = warp >> 2;  // update tile: columns 16 mt.., k from 4 KH2 kh
  {
    const int half = warp / tph;                      // 0: the Y0re^T columns, 1: the Y0im^T columns
    const int j = 1 + 8 * (warp - half * tph) + grp;  // bus of this thread's B column
#pragma unroll
    for (int c = 0; c < KC1; ++c) {
      const int k = 4 * c + tig;
      place(c, (warp < tiles1 && k < N && j <= n) ? P.W_pack[k * 2 * N + half * N + j] : 0.0);
    }
    const int col = 16 * mt + grp;
#pragma unroll
    for (int c = 0; c < KH2; ++c) {
      const int k = 4 * (KH2 * kh + c) + tig;
      place(KC1 + 2 * c, (k < n2 && col < n2) ? P.invJ0_T[k * n2 + col] : 0.0);
      place(KC1 + 2 * c + 1, (k < n2 && col + 8 < n2) ? P.invJ0_T[k * n2 + col + 8] : 0.0);
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

  // This warp's slots: slot warp + kWarps t is lane t of the warp, the
  // row (or column) `warp` of lane tile t.
  Slot s[LW];

  while (true) {
    // (1) Refill the warp's empty slots (one claim of as many lanes from
    // the work counter); stage F for the update product.
    {
      int empties = 0;
#pragma unroll
      for (int t = 0; t < LW; ++t) empties += s[t].phase == kEmpty;
      if (empties > 0) {
        int first = 0;
        if (lane == 0) first = atomicAdd(P.next_lane, empties);
        first = __shfl_sync(kFull, first, 0);
        Fresh f[LW];
#pragma unroll
        for (int t = 0; t < LW; ++t) {
          if (s[t].phase != kEmpty) continue;
          s[t].b = first++;
          s[t].phase = s[t].b < P.B ? kPro : kDone;
          if (s[t].phase == kPro) refill_load(P, s[t], f[t], lane, n);
        }
#pragma unroll
        for (int t = 0; t < LW; ++t) {
          if (s[t].phase == kPro) refill_start(P, s[t], f[t]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < LW; ++t) {
      const int slot = warp + kWarps * t;
      if (own) {
        sF[slot][lane] = s[t].phase == kIter ? (double)s[t].Fa : 0.0;
        sF[slot][n + lane] = s[t].phase == kIter ? (double)s[t].Fb : 0.0;
      }
    }
    bool done = true;
#pragma unroll
    for (int t = 0; t < LW; ++t) done &= s[t].phase == kDone;
    if (__syncthreads_and(done)) break;

    // (2) The update product, transposed: (invJ0 F^T) [2n, 8 slots] for each
    // lane tile, as tiles of 16 rows of invJ0 (A, one fragment read for all
    // lane tiles) times F^T (B, staged), each warp one row tile over one half
    // of k, in two accumulator chains a lane tile (a warp past the last tile
    // multiplies zeros); beside it, in the same straight-line code so that
    // the two interleave, this warp's slots' H F (the Woodbury projection).
    double u[2 * LW];  // (H F)_0 and (H F)_1 of each of the warp's slots
#pragma unroll
    for (int t = 0; t < LW; ++t) {
      u[2 * t] = own ? fma((double)s[t].Fa, (double)r.h00, (double)s[t].Fb * (double)r.h10) : 0.0;
      u[2 * t + 1] = own ? fma((double)s[t].Fa, (double)r.h01, (double)s[t].Fb * (double)r.h11) : 0.0;
    }
    {
      double d[LW][2][4] = {};
#pragma unroll
      for (int c = 0; c < KH2; ++c) {
        const double a0 = frag(KC1 + 2 * c), a1 = frag(KC1 + 2 * c + 1);
#pragma unroll
        for (int t = 0; t < LW; ++t) dmma(d[t][c & 1], a0, a1, sF[kWarps * t + grp][4 * (KH2 * kh + c) + tig]);
      }
      warp_sum(u, lane);
      const int col = 16 * mt + grp;  // D rows grp and grp + 8: columns col and col + 8; D columns: slots
#pragma unroll
      for (int t = 0; t < LW; ++t) {
        const int s0 = kWarps * t + 2 * tig;
        if (col < n2) {
          sUpd[kh][s0][col] = d[t][0][0] + d[t][1][0];
          sUpd[kh][s0 + 1][col] = d[t][0][1] + d[t][1][1];
        }
        if (col + 8 < n2) {
          sUpd[kh][s0][col + 8] = d[t][0][2] + d[t][1][2];
          sUpd[kh][s0 + 1][col + 8] = d[t][0][3] + d[t][1][3];
        }
      }
    }
    __syncthreads();

    // (3) Chord direction f = -invJ0 F + G K (H F), map value g = x + f, and
    // Anderson(1) along the last two chord-map evaluations (the slots' sums
    // in one butterfly); then stage V.
    {
      float fa[LW], fb[LW], sums[2 * LW];  // sums: each slot's AA denominator and numerator
#pragma unroll
      for (int t = 0; t < LW; ++t) {
        const int slot = warp + kWarps * t;
        const Slot& z = s[t];
        const float u0 = (float)u[2 * t], u1 = (float)u[2 * t + 1];
        const float t0 = fadd(fmul(z.k00, u0), fmul(z.k01, u1));
        const float t1 = fadd(fmul(z.k10, u0), fmul(z.k11, u1));
        fa[t] = 0.0f;
        fb[t] = 0.0f;
        if (own) {
          const float ua = (float)(sUpd[0][slot][lane] + sUpd[1][slot][lane]);
          const float ub = (float)(sUpd[0][slot][n + lane] + sUpd[1][slot][n + lane]);
          fa[t] = fadd(-ua, fadd(fmul(t0, r.g0a), fmul(t1, r.g1a)));
          fb[t] = fadd(-ub, fadd(fmul(t0, r.g0b), fmul(t1, r.g1b)));
        }
        const float dfa = fsub(fa[t], z.fpa), dfb = fsub(fb[t], z.fpb);
        sums[2 * t] = own ? fadd(fmul(dfa, dfa), fmul(dfb, dfb)) : 0.0f;
        sums[2 * t + 1] = own ? fadd(fmul(fa[t], dfa), fmul(fb[t], dfb)) : 0.0f;
      }
      warp_sum(sums, lane);
#pragma unroll
      for (int t = 0; t < LW; ++t) {
        Slot& z = s[t];
        if (z.phase == kIter) {
          const float ga = fadd(z.xa, fa[t]), gb = fadd(z.xb, fb[t]);
          const bool use_aa = z.it > 0 && z.diff > P.aa_gate;
          const float denom = sums[2 * t], num = sums[2 * t + 1];
          float gamma = denom > 1e-30f ? fdiv(num, denom) : 0.0f;
          gamma = use_aa ? (gamma < -5.0f ? -5.0f : (gamma > 5.0f ? 5.0f : gamma)) : 0.0f;
          z.xa = fsub(ga, fmul(gamma, fsub(ga, z.gpa)));
          z.xb = fsub(gb, fmul(gamma, fsub(gb, z.gpb)));
          z.gpa = ga;
          z.gpb = gb;
          z.fpa = fa[t];
          z.fpb = fb[t];
        }
      }
    }
#pragma unroll
    for (int t = 0; t < LW; ++t) {
      const int slot = warp + kWarps * t;
      const bool live = s[t].phase == kPro || s[t].phase == kIter;
      if (own) {
        float sn, cs;
        sincos7(s[t].xa, &sn, &cs);
        sV[0][slot][lane + 1] = live ? (double)fmul(s[t].xb, cs) : 0.0;
        sV[1][slot][lane + 1] = live ? (double)fmul(s[t].xb, sn) : 0.0;
      }
      if (lane == 0) {
        sV[0][slot][0] = live ? 1.0 : 0.0;
        sV[1][slot][0] = 0.0;
      }
    }
    __syncthreads();

    // (4) The mismatch products of the slots, [vre; vim] of each lane tile
    // (16 rows: A) times tile `warp` of W_pack (B, one fragment read for all
    // lane tiles), in two accumulator chains a lane tile (even and odd
    // chunks).
    if (warp < tiles1) {
      double d[LW][2][4] = {};
#pragma unroll
      for (int c = 0; c < KC1; ++c) {
        const double bw = frag(c);
#pragma unroll
        for (int t = 0; t < LW; ++t) {
          const int row = kWarps * t + grp;
          dmma(d[t][c & 1], sV[0][row][4 * c + tig], sV[1][row][4 * c + tig], bw);
        }
      }
      const int half = warp / tph;
      const int i = 8 * (warp - half * tph) + 2 * tig;  // bus i + 1
#pragma unroll
      for (int t = 0; t < LW; ++t) {
        const int row = kWarps * t + grp;
        if (i < n) {
          sMM[half][row][i] = (float)(d[t][0][0] + d[t][1][0]);
          sMM[2 + half][row][i] = (float)(d[t][0][2] + d[t][1][2]);
        }
        if (i + 1 < n) {
          sMM[half][row][i + 1] = (float)(d[t][0][1] + d[t][1][1]);
          sMM[2 + half][row][i + 1] = (float)(d[t][0][3] + d[t][1][3]);
        }
      }
    }
    __syncthreads();

    // (5) True mismatch and ||F||inf of every slot (their maxima in one
    // butterfly), the stall rule and the exit test.  V is read back from its
    // staged float64 copy, which holds the float32 value exactly.
    float worst[LW];
#pragma unroll
    for (int t = 0; t < LW; ++t) {
      const int slot = warp + kWarps * t;
      Slot& z = s[t];
      z.Fa = 0.0f;
      z.Fb = 0.0f;
      if (own) {
        const float vr = (float)sV[0][slot][lane + 1], vi = (float)sV[1][slot][lane + 1];
        const float are = sMM[0][slot][lane], aim = sMM[1][slot][lane];
        const float bre = sMM[2][slot][lane], bim = sMM[3][slot][lane];
        const float yv_re = fadd(fsub(are, bim), fmul(r.e, z.dtf_re));
        const float yv_im = fadd(fadd(bre, aim), fmul(r.e, z.dtf_im));
        const float s_re = fadd(fmul(vr, yv_re), fmul(vi, yv_im));
        const float s_im = fsub(fmul(vi, yv_re), fmul(vr, yv_im));
        z.Fa = fsub(s_re, z.p);
        z.Fb = fsub(s_im, z.q);
      }
      worst[t] = nanmax(fabsf(z.Fa), fabsf(z.Fb));
    }
    warp_max(worst);
#pragma unroll
    for (int t = 0; t < LW; ++t) {
      Slot& z = s[t];
      if (z.phase != kPro && z.phase != kIter) continue;
      const float new_diff = worst[t];
      if (z.phase == kPro) {
        z.diff = new_diff;
        z.best = new_diff;
        z.it = 0;
        z.stall = 0;
        z.gpa = z.xa;
        z.gpb = z.xb;
        z.fpa = 0.0f;
        z.fpb = 0.0f;
        z.phase = kIter;
      } else {
        // Stalled = no iteration beating the best residual so far by >= 20%.
        z.stall = new_diff < fmul(z.best, 0.8f) ? 0 : z.stall + 1;
        z.best = nanmin(z.best, new_diff);
        z.diff = new_diff;
        ++z.it;
      }
      if (!(z.diff > P.xtol && z.it < P.lim_iter && z.stall < (z.diff <= P.band ? 1 : 3))) finish(P, z, r, lane, n);
    }
  }
}

template <int KC1, int KH2, int LW, bool FR, int NN>
cudaError_t launch(const Params& P, int n_sm, cudaStream_t stream) {
  using L = Layout<KC1, KH2, LW, FR>;
  void (*kernel)(const Params) = chord_kernel<KC1, KH2, LW, FR, NN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::bytes));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarps * 32, L::bytes);
  if (err != cudaSuccess) return err;
  const long long need = (static_cast<long long>(P.B) + L::S - 1) / L::S;
  const long long cap = static_cast<long long>(per_sm > 0 ? per_sm : 1) * n_sm;
  const int grid = static_cast<int>(need < cap ? need : cap);
  kernel<<<grid, kWarps * 32, L::bytes, stream>>>(P);
  return cudaGetLastError();
}

}  // namespace

// slots: lane slots a block, 8 (a lane a warp) or, at n = 32, 16 (two), the
// wrapper's choice (chord_cuda.tile_slots).
extern "C" int chord_newton_f32(const float* p, const float* q, const float* w_a, const float* w_b,
                                const float* dtf_re, const float* dtf_im, const float* x0,
                                const double* W_pack, const double* invJ0_T, const double* H_T,
                                const float* g_col0, const float* g_col1, const float* C,
                                const float* e_t, const float* rs_re, const float* rs_im,
                                float va, float vb, float inv_vmag, float xtol, float band, float aa_gate,
                                int lim_iter, float* x, float* F, float* diff, int* n_iter,
                                unsigned char* accepted, int* next_lane, int B, int n, int slots, void* stream) {
  if (B <= 0 || n <= 0 || n > kMaxN || (slots != kWarps && (slots != 2 * kWarps || n != kMaxN))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params P{p, q, w_a, w_b, dtf_re, dtf_im, x0, W_pack, invJ0_T, H_T, g_col0, g_col1, C,
                 e_t, rs_re, rs_im, va, vb, inv_vmag, xtol, band, aa_gate, lim_iter, B, n,
                 x, F, diff, n_iter, accepted, next_lane};
  int device = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // n <= 8 (ANM6Easy): the chunks of IEEE33's width would be zeros; the
  // fragments in shared memory, so that a thread needs 80 registers and
  // three blocks fit an SM (24 lanes in flight: faster than 16 slots).
  if (n <= 8) return static_cast<int>(launch<3, 2, 1, false, 0>(P, n_sm, st));
  // 8 slots: the fragments in registers (126 a thread: two blocks an SM as
  // with them in shared memory, and a shorter round).
  if (slots == kWarps) return static_cast<int>(launch<kKC1, kKH2, 1, true, 0>(P, n_sm, st));
  // 16 slots, at n = 32 only: every thread of a warp owns a bus, and the
  // sizes compiled in keep a thread at 126 registers with no spill (read at
  // run time they spill).
  return static_cast<int>(launch<kKC1, kKH2, 2, false, kMaxN>(P, n_sm, st));
}
