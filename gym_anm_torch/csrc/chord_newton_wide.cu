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
// mod 32, so the lane's warp folds them in registers (thread l owns the
// entries l mod 32) and finishes with its butterfly shuffles, offsets 16..1.
//
// Bound (the 130-bus feeder of chip_smoke.py, n = 129): per lane iteration
// the update product 4 n^2 = 66,564 and the mismatch 4 N^2 = 67,600 float64
// multiply-adds, so the work is the run's lane-iterations times that (the
// smoke counts them): 0.21 ms at the 67 TFLOP/s of the FP64 tensor cores at
// the feeder's warm starts.  Device memory sees p, q, x0, x, F and a few
// scalars per lane once, and the constants (invJ0^T 532 KB, W_pack 270 KB)
// once: it is bound by operations.  A design with one block per lane (this
// kernel's predecessor) read the constants from L2 for every
// lane-iteration, 38 GB a call at the warm starts, and was bound by that.
//
// Design: lane tiles on the FP64 tensor cores, as chord_newton.cu for
// n <= 32, with the constants streamed through shared memory.  A block holds
// kSlots = 16 lane slots, one warp each.  A slot warp does all of its lane's
// elementwise work and reductions (thread l owns the buses l, l + 32, ...;
// the butterfly shuffles make every lane scalar bitwise equal in all 32
// threads, so every branch is warp-uniform).  The lane's vectors (its x, F,
// the previous f and g, its p and q) live in the slot's shared memory where
// the block's share fits (n up to about 200), else in device memory (x and
// F in the outputs, f and g in a scratch buffer [B, 4n] that the wrapper
// allocates).  The two products of a round are computed for the 16 slots
// together on FP64 mma.sync.m16n8k4, the 16 slots as the 16 rows of A:
//   update:   F (A, staged as float32 in shared memory) times invJ0^T (B),
//             8 output columns a tile, one accumulator chain a tile in k
//             order;
//   mismatch: vre and vim (A) times the Y0re^T and Y0im^T columns of
//             W_pack of 8 buses (B): four chains a tile, so the warp that
//             owns a bus tile forms F = V o conj(Y0 V + dY V) - (p + jq) of
//             its 8 buses for all 16 slots.
// The tiles of a product are dealt to the 16 warps (at most 4 update tiles
// or 2 mismatch tiles a warp at once; wider networks take several passes
// over the tiles), and a warp runs a k-step body for its own tile count, so
// no DMMA issues for a tile it lacks.  The constants do not fit shared
// memory: they stream through a ring of two stages (k-chunks of a pass's
// columns), the next chunk in flight while a chunk is used, and each chunk
// is read from L2 once a block round and used for all 16 slots: 16 times
// fewer L2 reads than one block per lane.  They stream as float32 (the exact
// values: the float64 copies hold float32 values), halving the bytes; a
// fragment converts to float64 as it loads.  The float32 copies
// (ChordTensors.W_pack_f32, invJ0_T_f32) have rows padded to 8 (mod 32)
// floats, the layout of a ring chunk, so that a product in one pass (n up
// to 256) loads a chunk as one TMA bulk copy from one thread, completing on
// its stage's mbarrier, and the B fragments' loads are free of bank
// conflicts; a product in several passes loads its chunks by 16-byte
// cp.async from every thread.

// A round, with block barriers between the steps: (1) an empty slot takes
// its next lane from a work counter (an atomicAdd on a device int the
// wrapper zeroes) and runs its prologue up to the warm start, and iterating
// slots stage F and form H F; (2) the update product; (3) iterating slots
// form f, g and the Anderson step, and every slot with a lane stages V at
// its new point; (4) the mismatch product, and F into the slots' vectors;
// (5) the slots finish ||F||inf and the stall rule; a slot whose lane exits
// writes its outputs and is empty for the next round.  A slot claims its
// next lane one lane ahead, so the atomic's latency stays off the round.  A refilled slot's prologue mismatch
// joins the block's next mismatch round, and a slot with no lane left stages
// zeros until the block is done.  The grid is persistent (one 512-thread
// block a streaming multiprocessor).  W32 = width / 32 (2, 4, 8 or 16) is a
// template parameter, so the Anderson fold runs in registers.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxN = 512;  // non-slack buses: networks up to 513 buses
constexpr int kSlots = 16;  // lane slots per block, one warp each
constexpr int kThreads = 32 * kSlots;
constexpr int kStages = 2;  // ring stages: k-chunks of the constants in flight
constexpr int kJU = 4;      // update tiles per warp in a pass
constexpr int kJM = 2;      // mismatch tiles per warp in a pass
constexpr unsigned kFull = 0xffffffffu;

enum Phase : int { kEmpty = 0, kPro = 1, kIter = 2, kDone = 3 };

// One product's walk over its constant matrix (row-major, k = row): passes
// over its 8-column tiles, k-chunks of `ks` k-steps (4 rows) within a pass.
struct Product {
  const float* src;   // invJ0^T [2n, 2n] or W_pack [N, 2N] as float32, rows padded to 16 bytes
  int src_ld;         // its row stride (floats)
  int K;              // rows that exist (2n or N); rows up to 4 ksteps are zeros
  int ksteps;         // k-steps of 4 rows
  int tiles;          // tiles in all (update: 8 output columns; mismatch: 8 buses)
  int jp;             // tiles per pass (the last pass may hold fewer)
  int ks;             // k-steps per chunk
  int ld;             // row stride of a chunk in shared memory (floats, 8 mod 32)
  bool whole;         // one pass over all columns: a chunk is whole rows, one bulk copy (ld = src_ld)
  int cpp;            // chunks per pass
  int n_chunks;       // chunks in all
};

struct Params {
  const float* p;        // [B, n]
  const float* q;        // [B, n]
  const float* w_a;      // [B]  Im delta
  const float* w_b;      // [B]  Re delta
  const float* dtf_re;   // [B]  dY[t, f]
  const float* dtf_im;   // [B]
  const float* x0;       // [B, 2n] warm start, or nullptr for the flat start
  const float* W_pack;   // [N, 2 LW]  [Y0re^T | 0 | Y0im^T | 0], LW = N rounded up to 4
  const float* invJ0_T;  // [2n, LU]  LU = 2n rounded up to 4
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
  int B, n;
  float* x;                 // [B, 2n]  the lane's point while it iterates
  float* F;                 // [B, 2n]  the lane's mismatch while it iterates
  float* diff;              // [B]
  int* n_iter;              // [B]
  unsigned char* accepted;  // [B]
  int* next_lane;           // [1] work counter, 0 at launch
  float* scratch;           // [B, 4n]  the previous f (2n) and g (2n), where they are not in shared memory
  Product U, M;             // the update and the mismatch products
  int ldo;                  // row stride of the staged operands (floats, 4 mod 32)
  int km;                   // where vim starts in a staged row (4 mismatch k-steps)
  int ldr;                  // row stride of the products' results (floats)
  int lds;                  // row stride of a slot's vectors in shared memory (floats), 0: in device memory
  int stage;                // floats per ring stage
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

// D = A B + D for a 16x8 float64 tile, k = 4 (sm_90): with g = l / 4 and
// t = l % 4, thread l holds A[g][t] (a0) and A[g + 8][t] (a1), B[t][g], and
// D[g][2t], D[g][2t + 1], D[g + 8][2t], D[g + 8][2t + 1] (d[0..3]).
__device__ __forceinline__ void dmma(double (&d)[4], double a0, double a1, double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra.uni DONE;\n"
      "bra.uni LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// One bulk copy (the TMA) of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory to shared memory, announced to and completing
// on `bar`; one thread issues it.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, unsigned long long* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
// The copies of all but the newest `N` committed groups have landed.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v[m] += v[m + o] for o = O, O / 2, .., 1: the Anderson sums' fold over a
// thread's entries (static indices: the sums stay in registers).
template <int O, int W>
__device__ __forceinline__ void fold(float (&v)[W]) {
  if constexpr (O >= 1) {
#pragma unroll
    for (int m = 0; m < O; ++m) v[m] = __fadd_rn(v[m], v[m + O]);
    fold<O / 2>(v);
  }
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

// The (pass, k-chunk) of chunk c, its tiles t0 .. t0 + jp - 1 and its
// k-steps s0 .. s0 + ns - 1.
struct ChunkAt {
  int t0, jp, s0, ns;
  bool pass_start, pass_end;
};
__device__ __forceinline__ ChunkAt chunk_at(const Product& Pr, int c) {
  const int pass = c / Pr.cpp, q = c - pass * Pr.cpp;
  ChunkAt a;
  a.t0 = pass * Pr.jp;
  a.jp = Pr.tiles - a.t0 < Pr.jp ? Pr.tiles - a.t0 : Pr.jp;
  a.s0 = Pr.ks * q;
  a.ns = Pr.ksteps - a.s0 < Pr.ks ? Pr.ksteps - a.s0 : Pr.ks;
  a.pass_start = q == 0;
  a.pass_end = q == Pr.cpp - 1;
  return a;
}

// Where a chunk's columns come from: the update's tiles t0 .. t0 + jp - 1
// (columns 8 t0 ..), or the mismatch's buses 8 t0 + 1 .. of the Y0re^T half
// (from column 0) and of the Y0im^T half (from column LW).  A part starts at
// a multiple of 4 columns (16-byte copies), so the mismatch's first bus lies
// at offset 1 of its part; each mismatch part is 8 jp + 4 columns wide.  A
// product in one pass holds whole rows instead (a bus at its own column).
struct Cols {
  int b0, len0, b1, len1;  // source column and count (a multiple of 4) of each part (len1 = 0: none)
  int off0, off1;          // ring column of each part's first wanted column
};
__device__ __forceinline__ Cols chunk_cols(const Product& Pr, bool mismatch, int t0, int jp) {
  Cols c{};
  c.b0 = 8 * t0;
  if (!mismatch) {
    c.len0 = 8 * jp < Pr.src_ld - c.b0 ? 8 * jp : Pr.src_ld - c.b0;
    return c;
  }
  const int lw = Pr.src_ld / 2;
  if (Pr.whole) {  // the ring holds whole rows: the Y0im^T half from column lw
    c.off0 = 1;
    c.off1 = lw + 1;
    return c;
  }
  c.len0 = 8 * jp + 4 < lw - c.b0 ? 8 * jp + 4 : lw - c.b0;
  c.off0 = 1;
  c.b1 = lw + c.b0;
  c.len1 = c.len0;
  c.off1 = 8 * jp + 4 + 1;
  return c;
}

// Chunk c of a product into ring stage `dst`, called by every thread of the
// block: rows 4 ks q .. of the pass's columns; whole rows in one bulk copy
// completing on `bar` (one pass), else 16-byte copies (cp.async, one group
// a chunk).  Rows past K are zeros (the A operand's padding is zero,
// and 0 x stale could be NaN); columns past the matrix are left stale (they
// feed only output columns nobody reads).
__device__ __forceinline__ void issue_chunk(const Product& Pr, bool mismatch, int c, float* dst,
                                            unsigned long long* bar) {
  if (c < Pr.n_chunks) {
    const ChunkAt a = chunk_at(Pr, c);
    const int k0 = 4 * a.s0, rows = 4 * a.ns;
    const int real = Pr.K - k0 < rows ? Pr.K - k0 : rows;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = real + warp; r < rows; r += kSlots) {
      for (int cl = lane; cl < Pr.ld; cl += 32) dst[r * Pr.ld + cl] = 0.0f;
    }
    if (Pr.whole) {
      if (threadIdx.x == 0) {
        bulk_load(dst, Pr.src + static_cast<long long>(k0) * Pr.src_ld,
                  static_cast<unsigned>(sizeof(float) * real * Pr.ld), bar);
      }
      return;
    }
    const Cols cc = chunk_cols(Pr, mismatch, a.t0, a.jp);
    const int part1 = 8 * a.jp + 4;
    for (int r = warp; r < real; r += kSlots) {
      const float* src = Pr.src + static_cast<long long>(k0 + r) * Pr.src_ld;
      for (int q = 4 * lane; q < cc.len0; q += 128) cp_async16(dst + r * Pr.ld + q, src + cc.b0 + q);
      for (int q = 4 * lane; q < cc.len1; q += 128) cp_async16(dst + r * Pr.ld + part1 + q, src + cc.b1 + q);
    }
  }
  cp_async_commit();
}

// A chunk's k-steps of the update product for a warp holding J tiles (its
// tiles jl = warp + 16 j, j < J): J accumulator chains, one DMMA each a
// k-step.  J is static so that no DMMA issues for a tile the warp lacks.
template <int J>
__device__ __forceinline__ void update_steps(double (&acc)[kJU][4], const float* opA0, const float* opA1,
                                             const float* ch, int ld, int s0, int ns, int warp) {
  for (int s = 0; s < ns; ++s) {
    const int k = 4 * (s0 + s);
    const double a0 = (double)opA0[k], a1 = (double)opA1[k];
#pragma unroll
    for (int j = 0; j < J; ++j) dmma(acc[j], a0, a1, (double)ch[4 * s * ld + 8 * (warp + kSlots * j)]);
  }
}

// The same for the mismatch product: four chains a tile.
template <int J>
__device__ __forceinline__ void mismatch_steps(double (&acc)[kJM][4][4], const float* opA0, const float* opA1,
                                               const float* ch, int ld, int off0, int off1, int km, int s0, int ns,
                                               int warp) {
  for (int s = 0; s < ns; ++s) {
    const int k = 4 * (s0 + s);
    const double r0 = (double)opA0[k], r1 = (double)opA1[k];
    const double i0 = (double)opA0[km + k], i1 = (double)opA1[km + k];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int col = 4 * s * ld + 8 * (warp + kSlots * j);
      const double wre = (double)ch[col + off0], wim = (double)ch[col + off1];
      dmma(acc[j][0], r0, r1, wre);
      dmma(acc[j][1], i0, i1, wre);
      dmma(acc[j][2], r0, r1, wim);
      dmma(acc[j][3], i0, i1, wim);
    }
  }
}

// A lane's vectors: its point x and mismatch F, the previous iteration's f
// and g (2n each), and its injections p, q (n each); in the slot's shared
// memory where the block's share fits (P.lds > 0), else x and F in the
// outputs, f and g in the scratch buffer and p, q in the inputs.
struct LaneMem {
  float *x, *F, *f, *g;
  const float *p, *q;
};
__device__ __forceinline__ LaneMem lane_mem(const Params& P, float* sState, int slot, long long b) {
  const int n = P.n;
  if (P.lds > 0) {
    float* s = sState + slot * P.lds;
    return {s, s + 2 * n, s + 4 * n, s + 6 * n, s + 8 * n, s + 9 * n};
  }
  float* s = P.scratch + b * 4 * n;
  return {P.x + b * 2 * n, P.F + b * 2 * n, s, s + 2 * n, P.p + b * n, P.q + b * n};
}

template <int W32>
__global__ void __launch_bounds__(kThreads, 1) chord_wide_kernel(const Params P) {
  extern __shared__ __align__(16) double smem[];
  float* ring = reinterpret_cast<float*>(smem);                     // [kStages][stage]  constants' chunks
  float* sOp = ring + kStages * P.stage;                            // [kSlots][ldo]  A operands
  float* sRes = sOp + kSlots * P.ldo;                               // [kSlots][ldr]  invJ0 F
  float* sState = sRes + kSlots * P.ldr;                            // [kSlots][lds]  the lanes' vectors
  __shared__ int sPhase[kSlots];
  __shared__ int sLane[kSlots];
  __shared__ float sDtf[kSlots][2];

  const int n = P.n, n2 = 2 * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int ldo = P.ldo, ldr = P.ldr, km = P.km;
  float* op = sOp + warp * ldo;  // this warp's slot: its staged operand and its results
  float* res = sRes + warp * ldr;
  const float* opA0 = sOp + grp * ldo + tig;  // A rows: slots grp and grp + 8
  const float* opA1 = sOp + (grp + 8) * ldo + tig;
  __shared__ unsigned long long sBar[kStages];  // a stage's whole-row bulk copy lands on its mbarrier
  if (threadIdx.x < kStages) mbar_init(&sBar[threadIdx.x]);
  __syncthreads();
  int seq = 0;               // the ring's chunks so far: chunk q uses stage q % kStages
  unsigned bar_parity = 0;   // bit st: the parity of stage st's next mbarrier phase
  auto stage = [&](int q) { return ring + (q % kStages) * P.stage; };
  auto bar = [&](int q) { return &sBar[q % kStages]; };
  // Wait until chunk q of product Pr has landed in its stage.
  auto land = [&](const Product& Pr, int q) {
    if (Pr.whole) {
      const int st = q % kStages;
      mbar_wait(&sBar[st], (bar_parity >> st) & 1u);
      bar_parity ^= 1u << st;
    } else {
      cp_async_wait<kStages - 2>();
    }
  };

  // This warp's slot, and the next lane it takes (from the work counter).
  auto claim = [&]() {
    int c = 0;
    if (lane == 0) c = atomicAdd(P.next_lane, 1);
    return __shfl_sync(kFull, c, 0);
  };
  int next = claim();
  int phase = kEmpty;
  long long b = 0;
  float dtf_re = 0.0f, dtf_im = 0.0f, k00 = 0.0f, k01 = 0.0f, k10 = 0.0f, k11 = 0.0f;
  float diff = 0.0f, best = 0.0f;
  int it = 0, stall = 0;

  while (true) {
    // The update product's first chunks load while the slots refill.
    for (int c = 0; c < kStages - 1; ++c) issue_chunk(P.U, false, c, stage(seq + c), bar(seq + c));

    // (1) Refill an empty slot; stage F for the update product, and H F.
    if (phase == kEmpty) {
      b = next;
      if (b >= P.B) {
        phase = kDone;
      } else {
        phase = kPro;
        next = claim();  // the slot's next lane, claimed a lane ahead: the atomic's latency stays off the round
        // The lane's scalars, warm start and injections, loaded together.
        const float d_i = P.w_a[b], d_r = P.w_b[b];
        dtf_re = P.dtf_re[b];
        dtf_im = P.dtf_im[b];
        float xa[W32], xb[W32], pp[W32], qq[W32];
#pragma unroll
        for (int m = 0; m < W32; ++m) {
          const int i = lane + 32 * m;
          xa[m] = 0.0f;
          xb[m] = 1.0f;
          pp[m] = qq[m] = 0.0f;
          if (i < n) {
            if (P.x0 != nullptr) {
              xa[m] = P.x0[b * n2 + i];
              xb[m] = P.x0[b * n2 + n + i];
            }
            if (P.lds > 0) {
              pp[m] = P.p[b * n + i];
              qq[m] = P.q[b * n + i];
            }
          }
        }
        // K = W (I + C W)^-1, with W(a) at the linearization point V* = va + j vb.
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
        bool ok = P.x0 != nullptr;
#pragma unroll
        for (int m = 0; m < W32; ++m) ok = ok && isfinite(xa[m]) && isfinite(xb[m]);
        ok = __all_sync(kFull, ok);
        const LaneMem L = lane_mem(P, sState, warp, b);
#pragma unroll
        for (int m = 0; m < W32; ++m) {
          const int i = lane + 32 * m;
          if (i < n) {
            L.x[i] = ok ? xa[m] : 0.0f;
            L.x[n + i] = ok ? xb[m] : 1.0f;
            if (P.lds > 0) {
              L.x[8 * n + i] = pp[m];  // the slot's copy of p and q
              L.x[9 * n + i] = qq[m];
            }
          }
        }
      }
    }
    double u0d = 0.0, u1d = 0.0;
    for (int j = lane; j < 4 * P.U.ksteps; j += 32) op[j] = 0.0f;
    __syncwarp();
    if (phase == kIter) {
      const LaneMem L = lane_mem(P, sState, warp, b);
#pragma unroll
      for (int m = 0; m < W32; ++m) {
        const int i = lane + 32 * m;
        if (i < n) {
          const float Fa = L.F[i], Fb = L.F[n + i];
          op[i] = Fa;
          op[n + i] = Fb;
          u0d += fma((double)Fa, __ldg(P.H_T + 2 * i), (double)Fb * __ldg(P.H_T + 2 * (n + i)));
          u1d += fma((double)Fa, __ldg(P.H_T + 2 * i + 1), (double)Fb * __ldg(P.H_T + 2 * (n + i) + 1));
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        u0d += __shfl_xor_sync(kFull, u0d, o);
        u1d += __shfl_xor_sync(kFull, u1d, o);
      }
    }
    if (lane == 0) {
      sPhase[warp] = phase;
      sLane[warp] = (int)b;
      sDtf[warp][0] = dtf_re;
      sDtf[warp][1] = dtf_im;
    }
    __syncthreads();
    bool all_done = true;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) all_done &= sPhase[s] == kDone;
    if (all_done) {
      // The update's first chunks are in flight: let them land before exit.
      if (P.U.whole) {
        for (int c = 0; c < kStages - 1 && c < P.U.n_chunks; ++c) {
          mbar_wait(bar(seq + c), (bar_parity >> ((seq + c) % kStages)) & 1u);
        }
      } else {
        cp_async_wait<0>();
      }
      break;
    }

    // (2) The update product (invJ0 F)^T = F invJ0^T: 16 slots x 8 columns a
    // tile, warp w holding tiles w, w + 16, ... of the pass, one chain each.
    {
      const Product& Pr = P.U;
      int c = 0;  // the product's chunk
      for (int t0 = 0; t0 < Pr.tiles; t0 += Pr.jp) {
        const int jp = Pr.tiles - t0 < Pr.jp ? Pr.tiles - t0 : Pr.jp;
        const int mine = (jp - warp + kSlots - 1) / kSlots;  // this warp's tiles in the pass
        double acc[kJU][4] = {};
        for (int s0 = 0; s0 < Pr.ksteps; s0 += Pr.ks, ++c) {
          const int ns = Pr.ksteps - s0 < Pr.ks ? Pr.ksteps - s0 : Pr.ks;
          land(Pr, seq + c);
          __syncthreads();
          issue_chunk(Pr, false, c + kStages - 1, stage(seq + c + kStages - 1), bar(seq + c + kStages - 1));
          const float* ch = stage(seq + c) + tig * Pr.ld + grp;
          static_assert(kJU == 4, "update_steps dispatch");
          if (mine == 4) update_steps<4>(acc, opA0, opA1, ch, Pr.ld, s0, ns, warp);
          else if (mine == 3) update_steps<3>(acc, opA0, opA1, ch, Pr.ld, s0, ns, warp);
          else if (mine == 2) update_steps<2>(acc, opA0, opA1, ch, Pr.ld, s0, ns, warp);
          else if (mine == 1) update_steps<1>(acc, opA0, opA1, ch, Pr.ld, s0, ns, warp);
        }
#pragma unroll
        for (int j = 0; j < kJU; ++j) {
          const int jl = warp + kSlots * j;
          const int i = 8 * (t0 + jl) + 2 * tig;  // D columns: outputs i, i + 1; rows: slots grp, grp + 8
          if (jl < jp) {
            if (i < n2) {
              sRes[grp * ldr + i] = (float)acc[j][0];
              sRes[(grp + 8) * ldr + i] = (float)acc[j][2];
            }
            if (i + 1 < n2) {
              sRes[grp * ldr + i + 1] = (float)acc[j][1];
              sRes[(grp + 8) * ldr + i + 1] = (float)acc[j][3];
            }
          }
        }
      }
      seq += Pr.n_chunks;
    }
    __syncthreads();

    // The mismatch product's first chunks load while the slots step.
    for (int c = 0; c < kStages - 1; ++c) issue_chunk(P.M, true, c, stage(seq + c), bar(seq + c));

    // (3) Chord direction f = -invJ0 F + G K (H F), map value g = x + f, and
    // Anderson(1) along the last two chord-map evaluations; then stage V.
    const bool live = phase == kPro || phase == kIter;
    if (phase == kIter) {
      const LaneMem L = lane_mem(P, sState, warp, b);
      const float u0 = (float)u0d, u1 = (float)u1d;
      const float t0 = fadd(fmul(k00, u0), fmul(k01, u1));
      const float t1 = fadd(fmul(k10, u0), fmul(k11, u1));
      float den[W32], num[W32];
#pragma unroll
      for (int m = 0; m < W32; ++m) {
        const int i = lane + 32 * m;
        den[m] = num[m] = 0.0f;
        if (i < n) {
          const float fa = fadd(-res[i], fadd(fmul(t0, __ldg(P.g_col0 + i)), fmul(t1, __ldg(P.g_col1 + i))));
          const float fb = fadd(-res[n + i], fadd(fmul(t0, __ldg(P.g_col0 + n + i)), fmul(t1, __ldg(P.g_col1 + n + i))));
          const float dfa = fsub(fa, L.f[i]), dfb = fsub(fb, L.f[n + i]);
          den[m] = fadd(fmul(dfa, dfa), fmul(dfb, dfb));
          num[m] = fadd(fmul(fa, dfa), fmul(fb, dfb));
          L.f[i] = fa;
          L.f[n + i] = fb;
        }
      }
      __syncwarp();
      // The Anderson sums in the butterfly's order (header comment).
      fold<W32 / 2>(den);
      fold<W32 / 2>(num);
      float dsum = den[0], nsum = num[0];
      for (int o = 16; o > 0; o >>= 1) {
        const float dd = __shfl_xor_sync(kFull, dsum, o), dn = __shfl_xor_sync(kFull, nsum, o);
        dsum = fadd(dsum, dd);
        nsum = fadd(nsum, dn);
      }
      const bool use_aa = it > 0 && diff > P.aa_gate;
      float gamma = dsum > 1e-30f ? fdiv(nsum, dsum) : 0.0f;
      gamma = use_aa ? (gamma < -5.0f ? -5.0f : (gamma > 5.0f ? 5.0f : gamma)) : 0.0f;
      for (int i = lane; i < n2; i += 32) {
        const float gi = fadd(L.x[i], L.f[i]);
        L.x[i] = fsub(gi, fmul(gamma, fsub(gi, L.g[i])));
        L.g[i] = gi;
      }
      __syncwarp();
    }
    // Stage V = |V| (cos theta + j sin theta) at the slot's point: vre at
    // buses 0 .. N - 1, vim from km; zeros past N and for a slot without a lane.
    for (int j = lane; j < 2 * km; j += 32) op[j] = 0.0f;
    __syncwarp();
    if (live) {
      const LaneMem L = lane_mem(P, sState, warp, b);
      for (int i = lane; i < n; i += 32) {
        float sn, cs;
        const float xb = L.x[n + i];
        sincos7(L.x[i], &sn, &cs);
        op[i + 1] = fmul(xb, cs);
        op[km + i + 1] = fmul(xb, sn);
      }
      if (lane == 0) op[0] = 1.0f;
    }
    // (4) The mismatch product: vre and vim (16 slots) x the Y0re^T and
    // Y0im^T columns of 8 buses a tile, four chains, and F of those buses.
    {
      const Product& Pr = P.M;
      int c = 0;  // the product's chunk
      for (int t0 = 0; t0 < Pr.tiles; t0 += Pr.jp) {
        const int jp = Pr.tiles - t0 < Pr.jp ? Pr.tiles - t0 : Pr.jp;
        const Cols cc = chunk_cols(Pr, true, t0, jp);
        const int mine = (jp - warp + kSlots - 1) / kSlots;  // this warp's tiles in the pass
        double acc[kJM][4][4] = {};  // [tile][vre Y0re^T, vim Y0re^T, vre Y0im^T, vim Y0im^T][D]
        for (int s0 = 0; s0 < Pr.ksteps; s0 += Pr.ks, ++c) {
          const int ns = Pr.ksteps - s0 < Pr.ks ? Pr.ksteps - s0 : Pr.ks;
          land(Pr, seq + c);
          __syncthreads();
          issue_chunk(Pr, true, c + kStages - 1, stage(seq + c + kStages - 1), bar(seq + c + kStages - 1));
          const float* ch = stage(seq + c) + tig * Pr.ld + grp;
          static_assert(kJM == 2, "mismatch_steps dispatch");
          if (mine == 2) mismatch_steps<2>(acc, opA0, opA1, ch, Pr.ld, cc.off0, cc.off1, km, s0, ns, warp);
          else if (mine == 1) mismatch_steps<1>(acc, opA0, opA1, ch, Pr.ld, cc.off0, cc.off1, km, s0, ns, warp);
        }
#pragma unroll
        for (int j = 0; j < kJM; ++j) {
          const int jl = warp + kSlots * j;
          if (jl < jp) {
#pragma unroll
            for (int d = 0; d < 4; ++d) {
              const int s = grp + 8 * (d >> 1);                // slot
              const int i = 8 * (t0 + jl) + 2 * tig + (d & 1);  // bus i + 1
              const int ph = sPhase[s];
              if (i < n && (ph == kPro || ph == kIter)) {
                const LaneMem L = lane_mem(P, sState, s, sLane[s]);
                const float e = __ldg(P.e_t + i + 1);
                const float are = (float)acc[j][0][d], bre = (float)acc[j][1][d];
                const float aim = (float)acc[j][2][d], bim = (float)acc[j][3][d];
                const float yv_re = fadd(fsub(are, bim), fmul(e, sDtf[s][0]));
                const float yv_im = fadd(fadd(bre, aim), fmul(e, sDtf[s][1]));
                const float vr = sOp[s * ldo + i + 1], vi = sOp[s * ldo + km + i + 1];
                const float s_re = fadd(fmul(vr, yv_re), fmul(vi, yv_im));
                const float s_im = fsub(fmul(vi, yv_re), fmul(vr, yv_im));
                L.F[i] = fsub(s_re, L.p[i]);
                L.F[n + i] = fsub(s_im, L.q[i]);
              }
            }
          }
        }
      }
      seq += Pr.n_chunks;
    }
    __syncthreads();

    // (5) ||F||inf, the stall rule and the exit test.
    if (live) {
      const LaneMem L = lane_mem(P, sState, warp, b);
      float mx = 0.0f;
      for (int i = lane; i < n2; i += 32) {
        mx = nanmax(mx, fabsf(L.F[i]));
        if (phase == kPro) {  // g = x, f = 0 before the first iteration
          L.f[i] = 0.0f;
          L.g[i] = L.x[i];
        }
      }
      __syncwarp();
      const float new_diff = warp_max(mx);
      if (phase == kPro) {
        diff = new_diff;
        best = new_diff;
        it = 0;
        stall = 0;
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
        bool fin_x = true;
        float th = 0.0f, mflat = 0.0f;
        for (int i = lane; i < n; i += 32) {
          const float xa = L.x[i], xb = L.x[n + i];
          fin_x = fin_x && isfinite(xa) && isfinite(xb);
          th = nanmax(th, fabsf(xa));
          const float e = __ldg(P.e_t + i + 1);
          const float Ffa = fsub(fadd(__ldg(P.rs_re + i + 1), fmul(e, dtf_re)), L.p[i]);
          const float Ffb = fsub(-fadd(__ldg(P.rs_im + i + 1), fmul(e, dtf_im)), L.q[i]);
          mflat = nanmax(mflat, nanmax(fabsf(Ffa), fabsf(Ffb)));
        }
        fin_x = __all_sync(kFull, fin_x);
        th = warp_max(th);
        const float diff_flat = warp_max(mflat);
        const bool fin = isfinite(diff) && fin_x && th <= 0.5f;
        const int eff_limit = diff <= P.band ? 1 : 3;
        const bool plateaued = fin && stall >= eff_limit;
        const bool acc = (fin && diff <= P.xtol) || (plateaued && diff <= P.band);
        const bool reset = !acc && (!fin || !(diff <= diff_flat));
        for (int i = lane; i < n; i += 32) {
          const float e = __ldg(P.e_t + i + 1);
          const float xa = L.x[i], xb = L.x[n + i], Fa = L.F[i], Fb = L.F[n + i];
          const float pi = L.p[i], qi = L.q[i];
          P.x[b * n2 + i] = reset ? 0.0f : xa;
          P.x[b * n2 + n + i] = reset ? 1.0f : xb;
          P.F[b * n2 + i] = reset ? fsub(fadd(__ldg(P.rs_re + i + 1), fmul(e, dtf_re)), pi) : Fa;
          P.F[b * n2 + n + i] = reset ? fsub(-fadd(__ldg(P.rs_im + i + 1), fmul(e, dtf_im)), qi) : Fb;
        }
        if (lane == 0) {
          P.diff[b] = reset ? diff_flat : diff;
          P.n_iter[b] = reset ? 0 : it;
          P.accepted[b] = acc ? 1 : 0;
        }
        phase = kEmpty;
      }
      __syncwarp();
    }
  }
}

// The smallest x' >= x with x' = r (mod m).
int pad_to(int x, int r, int m) { return x + ((r - x % m) % m + m) % m; }

Product make_product(const float* src, int src_ld, int K, int tiles, int per_warp) {
  Product Pr{};
  Pr.src = src;
  Pr.src_ld = src_ld;
  Pr.K = K;
  Pr.ksteps = (K + 3) / 4;
  Pr.tiles = tiles;
  const int passes = (tiles + kSlots * per_warp - 1) / (kSlots * per_warp);
  Pr.jp = (tiles + passes - 1) / passes;
  return Pr;
}

// k-steps per chunk, so that a stage holds at most `stage_bytes`.
void set_chunks(Product& Pr, int cols, size_t stage_bytes) {
  Pr.whole = Pr.jp == Pr.tiles && Pr.src_ld % 32 == 8;
  Pr.ld = Pr.whole ? Pr.src_ld : pad_to(cols, 8, 32);
  const size_t kstep = 4 * sizeof(float) * static_cast<size_t>(Pr.ld);
  Pr.ks = static_cast<int>(stage_bytes / kstep);
  if (Pr.ks < 1) Pr.ks = 1;
  if (Pr.ks > Pr.ksteps) Pr.ks = Pr.ksteps;
  Pr.cpp = (Pr.ksteps + Pr.ks - 1) / Pr.ks;
  const int passes = (Pr.tiles + Pr.jp - 1) / Pr.jp;
  Pr.n_chunks = passes * Pr.cpp;
}

}  // namespace

// n = 33..512 non-slack buses (chord_newton_f32 takes n <= 32).  W_pack and
// invJ0_T are ChordTensors.W_pack_f32 and .invJ0_T_f32 (float32, rows of
// w_ld and u_ld floats); scratch: B * 4 * n floats (used where the lanes'
// vectors do not fit shared memory).
extern "C" int chord_newton_wide_f32(const float* p, const float* q, const float* w_a, const float* w_b,
                                     const float* dtf_re, const float* dtf_im, const float* x0,
                                     const float* W_pack, const float* invJ0_T, const double* H_T,
                                     const float* g_col0, const float* g_col1, const float* C,
                                     const float* e_t, const float* rs_re, const float* rs_im,
                                     float va, float vb, float inv_vmag, float xtol, float band, float aa_gate,
                                     int lim_iter, float* x, float* F, float* diff, int* n_iter,
                                     unsigned char* accepted, int* next_lane, float* scratch, int B, int n,
                                     int w_ld, int u_ld, void* stream) {
  if (B <= 0 || n <= 32 || n > kMaxN || next_lane == nullptr || scratch == nullptr || w_ld % 8 != 0 ||
      w_ld < 2 * (n + 1) || u_ld % 4 != 0 || u_ld < 2 * n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int N = n + 1;
  Params P{p, q, w_a, w_b, dtf_re, dtf_im, x0, W_pack, invJ0_T, H_T, g_col0, g_col1, C,
           e_t, rs_re, rs_im, va, vb, inv_vmag, xtol, band, aa_gate, lim_iter, B, n,
           x, F, diff, n_iter, accepted, next_lane, scratch};
  P.U = make_product(invJ0_T, u_ld, 2 * n, (2 * n + 7) / 8, kJU);
  P.M = make_product(W_pack, w_ld, N, (n + 7) / 8, kJM);
  P.km = 4 * P.M.ksteps;
  const int op_len = 4 * P.U.ksteps > 2 * P.km ? 4 * P.U.ksteps : 2 * P.km;
  P.ldo = pad_to(op_len, 4, 32);
  P.ldr = 2 * n + 4;
  int device = 0, n_sm = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  // Shared memory: the ring, the staged operands and results, and the
  // lanes' vectors where 48 KB of ring stages still fit beside
  // them (n up to about 200 on an H100); else the vectors stay in device
  // memory.
  const size_t fixed = sizeof(float) * kSlots * static_cast<size_t>(P.ldo + P.ldr) + 1024;  // + static
  const size_t state = sizeof(float) * kSlots * 10 * static_cast<size_t>(n);
  if (fixed + 3 * 16 * 1024 + state <= static_cast<size_t>(limit)) P.lds = 10 * n;
  const size_t used = fixed + (P.lds > 0 ? state : 0);
  if (used >= static_cast<size_t>(limit)) return static_cast<int>(cudaErrorInvalidValue);
  size_t stage_bytes = (static_cast<size_t>(limit) - used) / kStages;
  if (stage_bytes > 64 * 1024) stage_bytes = 64 * 1024;
  set_chunks(P.U, 8 * P.U.jp, stage_bytes);
  set_chunks(P.M, 2 * (8 * P.M.jp + 4), stage_bytes);
  const int su = 4 * P.U.ks * P.U.ld, sm = 4 * P.M.ks * P.M.ld;
  P.stage = su > sm ? su : sm;
  const size_t smem = sizeof(float) * kStages * static_cast<size_t>(P.stage) + used - 1024;
  if (smem + 1024 > static_cast<size_t>(limit)) return static_cast<int>(cudaErrorInvalidValue);
  int width = 32;
  while (width < n) width <<= 1;
  void (*kernel)(const Params) = width == 64    ? chord_wide_kernel<2>
                                 : width == 128 ? chord_wide_kernel<4>
                                 : width == 256 ? chord_wide_kernel<8>
                                                : chord_wide_kernel<16>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long need = (static_cast<long long>(B) + kSlots - 1) / kSlots;
  const long long cap = static_cast<long long>(per_sm > 0 ? per_sm : 1) * n_sm;
  const int grid = static_cast<int>(need < cap ? need : cap);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}
