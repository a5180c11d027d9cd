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
//   plateau exits; it += K.  A lane with a crossed bound row (any l > u, or a
//   NaN bound) is done at entry: no sweep, its warm start passed through,
//   converged false, r_prim = r_dual = inf.  At exit the primal band gives
//   `feasible`, and x = D*x_bar.
//
// Precision, as the plain version's: every entry of a product is the float64
// sum of exact float32 x float32 products, rounded once to float32; the
// elementwise chain is float32 with every operation rounded on its own
// (__fmul_rn, __fadd_rn: nvcc contracts none of them into a fused
// multiply-add the plain version does not have), and the divisions by the
// cost scale are IEEE divisions (__fdiv_rn).  The maxima of a check propagate
// NaN as torch.amax does, and a maximum is exact in any order, so they match
// the plain version bit for bit; the clamp is torch's min(max()), NaN kept.
// The products' float64 sums run in another order than the plain version's
// matmul, so an entry may round to the other neighbouring float32 where the
// float64 sum lies within an ulp of a float32 tie.
//
// Bound (bench.py workload 4: ANM6Easy N=1, n=21, m=39, B=8192, budget 48 = 6
// checks of 8 sweeps): per lane and sweep m*n + (n+m)*n = 2,079 multiply-adds,
// per check m*n more, 0.21 MFLOP a lane at the full budget, 1.7 GFLOP a call:
// 26 us at 67 TFLOP/s (float64 on the tensor cores, where this kernel runs
// its products).  A lane moves ~1.5 KB (bounds, warm start in and out,
// solution), 12 MB a call, 4 us at 3.35 TB/s.  So the kernel is bound by
// operations; the lanes that exit early do less of them, and chip_smoke.py
// counts the sweeps a run's lanes actually ran.  At the MPC cell's 8 stages
// (n = 168, m = 312, B = 16384, 48 sweeps) a lane-sweep is 133,056
// multiply-adds: 3.3 ms a call at that peak.
//
// Both products run on the FP64 tensor cores (mma.sync m16n8k4, as
// chord_newton.cu), 8 lanes to a B operand:
//   t^T = A_bar^T v^T:   the matrix A_bar^T [n, m] as the 16-row A operand, the
//                        lanes' v = rho z - y as the B operand (k = row i);
//   w^T = P_pack rhs^T:  P_pack [n+m, n] as the A operand, the lanes' rhs as
//                        the B operand (k = unknown j).
// The matrices come as fragment-ordered float64 copies of the float32 values
// (made once by make_vec_dcopf), so a thread loads its (a0, a1) with one
// 16-byte load and converts nothing.  Each product accumulates a row tile in
// one chain in k order, as the plain version's float64 matmul sums (splitting
// k into two chains moved float32 roundings and cost bitwise agreement), and
// gets its parallelism from 4 row tiles at once.  Two routes, by whether the
// fragments fit in shared memory (admm_scratch_bytes owns the choice):
//
// Staged (namespace staged; the tile design, which replaced a design of one
// block per lane).  A warp is a tile of 8 lane slots.  Where the two
// copies (VecDCOPF.A_frag / P_frag, [rt][kc][32]) fit beside two warps'
// state (2,079 multiply-adds: 22.5 KB padded, at the farm's shape), the
// block stages them in shared memory once and its warps share them; the
// lanes' state lives in the warp's shared memory.  At the farm's shape that
// is 2 x 10 + 4 x 6 = 44 DMMAs a warp-sweep.
//
// Streamed (namespace streamed).  Where they do not fit (ANM6Easy N >= 4,
// IEEE33-renewable N = 1; 1.08 MB at the cell's 8 stages), the tile design had
// every warp read them from L2 for its 8 lanes: 135.5 KB a lane-sweep, ~3.7 TB/s
// of L2 at the cell, which paced the kernel at 11% of its bound.  Here a
// persistent block of W consumer warps, each holding 16 lanes as two 8-lane
// B operands, shares one stream of the fragments through a ring of
// shared-memory stages that one producer warp fills with TMA bulk copies
// (cp.async.bulk on mbarriers): the copies VecDCOPF.A_stream / P_stream are
// laid out by groups of 4 row tiles, [group][chunk][tile][32], their k-chunks
// padded with zeros to whole stages, so a stage (6 k-chunks of a group, 12
// KB; the cell's 78 and 42 chunks need no padding) is one contiguous copy;
// a ring of up to 8 stages keeps 96 KB in flight an SM.  Every consumer warp
// reads each stage once, and each A fragment it loads feeds both of its
// DMMAs: one L2 read of the matrices serves 16 W lanes.  A stage's chunks are
// one unpredicated run (templated on its group's tiles), the next chunk's
// fragments loading while the current one multiplies.  The B operands
// (float32 in shared memory, [k][8 columns] of float2 for the two operands:
// one 8-byte load gives both) and the row constants take the rest of shared
// memory; the lanes' state (x; y, z, Ax and the scaled bounds, float32)
// lives in a device scratch buffer sized by the resident slots, an
// epilogue's rows loaded in batches of 4 (the read-only bounds as streaming
// loads).  W (at most 4, one a scheduler; 4 at the cell) is picked from B,
// the SM count and what fits (stream_warps), so a small batch still spreads
// over the SMs.  v = rho z - y for the next sweep and the check's
// |E^-1(Ax - z)|, |E^-1 Ax|, |E^-1 z| and staged y are made in the w
// product's epilogue, where the new y and z are at hand (the same operations
// on the same values as a separate pass).  All warps of a block consume
// every stage: a round (K sweeps and the check) ends at a block barrier that
// decides whether any of its slots still holds a lane, and a warp whose
// slots are all empty waits and releases each stage without multiplying.
// At the cell (H100) a call takes ~9.8 ms against the bound's 3.3 ms: the
// products alone ~6.5-7 ms (a warp-stage waits on the ring and issues its
// DMMAs at ~26 cycles against the 16 a scheduler sustains), the epilogues
// the rest (one consumer warp a scheduler leaves them unhidden).
//
// Layout (both routes).  Thread l = 4 g + t of a warp holds the mma
// accumulator entries of rows 16 rt + g and 16 rt + g + 8 and columns 2t,
// 2t + 1 of every row tile rt and B operand.  The two products' rows
// coincide for j < n (both start at 0 and tile by 16), so a thread owns the
// same cells (row r, slot s) of the lane state in both products and in the
// elementwise chain: x for r < n; y, z, Ax and the scaled bounds for
// r = n + i.  No other thread touches a cell, so the chain needs no barrier.
// Only the staged operands cross threads: a sweep has two __syncwarp.
//
// Per-lane exits.  The slot scalars (lane, it, stall, the residuals and their
// bests) are kept by the 8 threads of the slot's column, from maxima reduced
// over them with three shuffles.  At a check, a slot whose lane is done or
// has reached max_iter writes its outputs and takes the next lane from a
// device work counter (an atomicAdd on the int the wrapper zeroes), so no
// slot idles while lanes remain; a slot with no lane left sweeps zeros.  The
// grid is persistent (the resident blocks of every SM).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 8;        // lane slots per B operand (the mma's n = 8)
constexpr int kMaxWarps = 4;     // warps per block of the staged route
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e20f;

struct Problem {
  const double2* Af;     // fragments of A_bar^T (A operand of t), in the route's order
  const double2* Pf;     // fragments of P_pack (A operand of w)
  const float* q;        // [n] q_bar
  const float* rho;      // [m]
  const float* inv_rho;  // [m]
  const float* D;        // [n]
  const float* D_inv;    // [n]
  const float* E;        // [m]
  const float* E_inv;    // [m]
  float sigma, alpha, one_minus_alpha, c_scale, q_ref, eps_abs, eps_rel, improve, plateau_cap, feas_band;
  int max_iter, K, stall_checks, n, m;
  int rt_t, kc_t, rt_w, kc_w;  // row tiles of 16 and k-chunks of 4 of the two products
};

struct Lanes {
  const float *l, *u, *x0, *y0, *z0, *Ax0;  // [B, m] bounds, [B, n] / [B, m] warm start
  float *x_out, *xw, *yw, *zw, *Axw;        // [B, n] solution, the new warm start
  int* iterations;
  float *r_prim, *r_dual;
  uint8_t *converged, *bounds_ok, *feasible;
  int* next_lane;  // [1] work counter, 0 at launch
  unsigned char* scratch;  // the streamed route's lane state, or nullptr
  int B;
};

// The maximum of torch.amax / torch.maximum: NaN wins.
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || isnan(a)) ? a : b; }
// torch.minimum's: NaN wins.
__device__ __forceinline__ float nan_min(float a, float b) { return (a < b || isnan(a)) ? a : b; }

// D = A B + D for a 16x8 float64 tile, k = 4 (sm_90): with g = l / 4 and
// t = l % 4, thread l holds A[g][t] (a0) and A[g + 8][t] (a1), B[t][g], and
// D[g][2t], D[g][2t + 1], D[g + 8][2t], D[g + 8][2t + 1] (d[0..3]).
__device__ __forceinline__ void dmma(double (&d)[4], double a0, double a1, double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// A constraint row's chain after w: the relaxation of Ax and z, the clip
// to [lo, hi] and the dual update, one cell.
__device__ __forceinline__ void relax_clip(float zt, float a, float bm, float inv_rho, float rho, float lo, float hi,
                                           float& ax, float& y, float& z) {
  ax = __fadd_rn(__fmul_rn(a, zt), __fmul_rn(bm, ax));
  const float z_pre = __fadd_rn(__fadd_rn(__fmul_rn(a, zt), __fmul_rn(bm, z)), __fmul_rn(inv_rho, y));
  // clamp(z_pre, lb, ub) as torch computes it: min(max(z_pre, lb), ub), NaN kept.
  float z_new = z_pre < lo ? lo : z_pre;
  z_new = hi < z_new ? hi : z_new;
  y = __fmul_rn(rho, __fsub_rn(z_pre, z_new));
  z = z_new;
}

namespace staged {

// Row tiles of a product accumulated together.  (8 with prefetching took the
// farm's call from 0.19 to 0.32 ms on an H100: registers.)
constexpr int kStagedGroup = 4;

// Row tiles rt0 .. rt0 + kG - 1 (those below rt_end) of a product: d[q] =
// the sum over the k-chunks of A (fragments [rt][kc][32] in shared memory)
// times the staged operand sB [4 kc][8] (double).  Each tile's entries
// accumulate in one chain in k order, the order of the plain version's
// float64 matmul (so the kernel rounds as it does); the tiles of the group are
// independent chains that share each B load.
__device__ __forceinline__ void product_group(double (&d)[kStagedGroup][4], const double2* frag, const double* sB,
                                              int rt0, int rt_end, int kc, int lane) {
  constexpr int kG = kStagedGroup;
  const int g = lane >> 2, t = lane & 3;
  const int nq = rt_end - rt0 < kG ? rt_end - rt0 : kG;
  const double2* base = frag + static_cast<size_t>(rt0) * kc * 32 + lane;
  const size_t stride = static_cast<size_t>(kc) * 32;  // one row tile
#pragma unroll
  for (int q = 0; q < kG; ++q) d[q][0] = d[q][1] = d[q][2] = d[q][3] = 0.0;
#pragma unroll 2
  for (int c = 0; c < kc; ++c) {
    const double bv = sB[(4 * c + t) * kSlots + g];
#pragma unroll
    for (int q = 0; q < kG; ++q) {
      if (q < nq) {
        const double2 a = base[q * stride + c * 32];
        dmma(d[q], a.x, a.y, bv);
      }
    }
  }
}


// The warp's shared memory: its lanes' state and the two staged operands.
struct WarpMem {
  float2 *x, *y, *z, *Ax, *lb, *ub;  // [rows][4]: a float2 of slots (2t, 2t + 1) per thread t
  double *sv, *sr;                   // [4 kc_t][8], [4 kc_w][8]: B operands of t and w
};

// The fragments and each warp's WarpMem staged in shared memory.
__global__ void __launch_bounds__(kMaxWarps * 32) admm_kernel(Problem P, Lanes L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = P.n, m = P.m, nm = n + m;
  constexpr int kG = kStagedGroup;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  // Block-shared: the fragments (when staged) and the row constants.
  const int n_af = P.rt_t * P.kc_t * 32, n_pf = P.rt_w * P.kc_w * 32;
  double2* sAf = reinterpret_cast<double2*>(smem_raw);
  double2* sPf = sAf + n_af;
  float* cq = reinterpret_cast<float*>(sPf + n_pf);  // [n] q_bar
  float* cdi = cq + n;                               // [n] D_inv
  float* crho = cdi + n;                             // [m] rho
  float* cir = crho + m;                             // [m] 1/rho
  float* cei = cir + m;                              // [m] E_inv
  unsigned char* wbase = reinterpret_cast<unsigned char*>(cei + m);
  wbase += (16 - (reinterpret_cast<uintptr_t>(wbase) & 15)) & 15;
  const size_t wbytes = 8 * sizeof(float) * (static_cast<size_t>(n) + 5 * m) +
                        8 * sizeof(double) * 4 * (static_cast<size_t>(P.kc_t) + P.kc_w);
  WarpMem W;
  {
    unsigned char* p = wbase + warp * wbytes;
    W.sv = reinterpret_cast<double*>(p);
    W.sr = W.sv + 32 * P.kc_t;
    W.x = reinterpret_cast<float2*>(W.sr + 32 * P.kc_w);
    W.y = W.x + 4 * n;
    W.z = W.y + 4 * m;
    W.Ax = W.z + 4 * m;
    W.lb = W.Ax + 4 * m;
    W.ub = W.lb + 4 * m;
  }
  for (int i = threadIdx.x; i < n_af; i += blockDim.x) sAf[i] = P.Af[i];
  for (int i = threadIdx.x; i < n_pf; i += blockDim.x) sPf[i] = P.Pf[i];
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    cq[j] = P.q[j];
    cdi[j] = P.D_inv[j];
  }
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    crho[i] = P.rho[i];
    cir[i] = P.inv_rho[i];
    cei[i] = P.E_inv[i];
  }
  // The staged operands' padding rows (k >= m, k >= n) stay zero.
  for (int i = lane; i < 32 * (P.kc_t + P.kc_w); i += 32) W.sv[i] = 0.0;
  __syncthreads();
  const double2* Af = sAf;
  const double2* Pf = sPf;
  const float inf = __int_as_float(0x7f800000);

  // The slots 2t + e (e = 0, 1) of this thread: their scalars, equal in the
  // 8 threads g = 0..7 of the column pair.
  int b[2] = {-1, -1}, it[2] = {0, 0}, stall[2] = {0, 0};
  float r_prim[2] = {inf, inf}, r_dual[2] = {inf, inf}, best_rp[2] = {inf, inf}, best_rd[2] = {inf, inf};
  float p_ref[2] = {0.f, 0.f};
  bool done[2] = {false, false}, need[2] = {true, true}, bounds_ok[2] = {true, true};

  // Reduce v over the slot's 8 threads (lane bits 2..4) with NaN kept.
  auto slot_max = [&](float v) {
    for (int o = 4; o < 32; o <<= 1) v = nan_max(v, __shfl_xor_sync(kFull, v, o));
    return v;
  };

  // Write slot e's outputs (its lane b[e] exits).
  auto finish = [&](int e) {
    const int64_t lb_ = b[e];
    for (int rt = 0; rt < P.rt_w; ++rt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * rt + 8 * h + g;
        if (r < n) {
          const float xv = e ? W.x[r * 4 + t].y : W.x[r * 4 + t].x;
          L.xw[lb_ * n + r] = xv;
          L.x_out[lb_ * n + r] = __fmul_rn(P.D[r], xv);
        } else if (r < nm) {
          const int i = r - n;
          L.yw[lb_ * m + i] = e ? W.y[i * 4 + t].y : W.y[i * 4 + t].x;
          L.zw[lb_ * m + i] = e ? W.z[i * 4 + t].y : W.z[i * 4 + t].x;
          L.Axw[lb_ * m + i] = e ? W.Ax[i * 4 + t].y : W.Ax[i * 4 + t].x;
        }
      }
    }
    if (g == 0) {
      L.iterations[lb_] = it[e];
      L.r_prim[lb_] = r_prim[e];
      L.r_dual[lb_] = r_dual[e];
      L.converged[lb_] = done[e] && bounds_ok[e];
      L.bounds_ok[lb_] = bounds_ok[e];
      L.feasible[lb_] = bounds_ok[e] &&
                        r_prim[e] <= __fmul_rn(P.feas_band, __fadd_rn(P.eps_abs, __fmul_rn(P.eps_rel, p_ref[e])));
    }
  };

  // Give every slot that needs one its next lane; a lane with a crossed bound
  // row (or max_iter <= 0) exits at entry and the slot takes another.
  auto refill = [&]() {
    while (__any_sync(kFull, need[0] || need[1])) {
      bool fresh[2] = {false, false};
      const bool touch[2] = {need[0], need[1]};  // slots whose cells this round rewrites
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        int claim = 0;
        if (need[e] && g == 0) claim = atomicAdd(L.next_lane, 1);
        claim = __shfl_sync(kFull, claim, t);
        if (!need[e]) continue;
        if (claim >= L.B) {
          b[e] = -1;
          need[e] = false;
        } else {
          b[e] = claim;
          fresh[e] = true;
        }
      }
      // Load the fresh lanes' cells (an exhausted slot's cells are zeros).
      bool crossed[2] = {false, false};
      float pa[2] = {0.f, 0.f}, pb[2] = {0.f, 0.f};
      for (int rt = 0; rt < P.rt_w; ++rt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * rt + 8 * h + g;
          if (r >= nm) continue;
          float vx[2], vy[2], vz[2], va[2], vl[2], vu[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            vx[e] = vy[e] = vz[e] = va[e] = vl[e] = vu[e] = 0.f;
            if (!fresh[e]) continue;
            const int64_t bb = b[e];
            if (r < n) {
              vx[e] = L.x0[bb * n + r];
            } else {
              const int i = r - n;
              const int64_t k = bb * m + i;
              vy[e] = L.y0[k];
              vz[e] = L.z0[k];
              va[e] = L.Ax0[k];
              const float lo = L.l[k], hi = L.u[k], ee = P.E[i];
              // Scaled bounds; the infinities stay ±BIG, so the clip passes them through.
              vl[e] = lo <= -kBig ? -kBig : __fmul_rn(ee, lo);
              vu[e] = hi >= kBig ? kBig : __fmul_rn(ee, hi);
              crossed[e] = crossed[e] || !(lo <= hi);
              pa[e] = nan_max(pa[e], fabsf(__fmul_rn(cei[i], va[e])));
              pb[e] = nan_max(pb[e], fabsf(__fmul_rn(cei[i], vz[e])));
            }
          }
          if (!(touch[0] || touch[1])) continue;
          // The cells of slots that took a lane (or ran out: zeros) are rewritten.
          if (r < n) {
            float2 c = W.x[r * 4 + t];
            if (touch[0]) c.x = vx[0];
            if (touch[1]) c.y = vx[1];
            W.x[r * 4 + t] = c;
          } else {
            const int i = r - n;
            float2 cy = W.y[i * 4 + t], cz = W.z[i * 4 + t], ca = W.Ax[i * 4 + t], cl = W.lb[i * 4 + t],
                   cu = W.ub[i * 4 + t];
            if (touch[0]) {
              cy.x = vy[0]; cz.x = vz[0]; ca.x = va[0]; cl.x = vl[0]; cu.x = vu[0];
            }
            if (touch[1]) {
              cy.y = vy[1]; cz.y = vz[1]; ca.y = va[1]; cl.y = vl[1]; cu.y = vu[1];
            }
            W.y[i * 4 + t] = cy;
            W.z[i * 4 + t] = cz;
            W.Ax[i * 4 + t] = ca;
            W.lb[i * 4 + t] = cl;
            W.ub[i * 4 + t] = cu;
          }
        }
      }
      // The crossed flags and p_ref of the fresh slots, over each slot's threads.
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float cf = crossed[e] ? 1.f : 0.f;
        cf = slot_max(cf);
        const float ref = nan_max(slot_max(pa[e]), slot_max(pb[e]));
        if (!fresh[e]) continue;
        bounds_ok[e] = cf == 0.f;
        it[e] = 0;
        stall[e] = 0;
        r_prim[e] = r_dual[e] = best_rp[e] = best_rd[e] = inf;
        p_ref[e] = ref;
        done[e] = !bounds_ok[e];
        if (done[e] || P.max_iter <= 0) {
          finish(e);  // exits at entry with its warm start
          need[e] = true;
        } else {
          need[e] = false;
        }
      }
    }
  };

  refill();
  const float a = P.alpha, bm = P.one_minus_alpha;
  while (__any_sync(kFull, b[0] >= 0 || b[1] >= 0)) {
    for (int s = 0; s < P.K; ++s) {
      // (a) Stage v = rho z - y (rows n + i of this thread's cells).
      for (int rt = n / 16; rt < P.rt_w; ++rt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * rt + 8 * h + g;
          if (r < n || r >= nm) continue;
          const int i = r - n;
          const float2 zz = W.z[i * 4 + t], yy = W.y[i * 4 + t];
          const float rh = crho[i];
          W.sv[i * kSlots + 2 * t] = static_cast<double>(__fsub_rn(__fmul_rn(rh, zz.x), yy.x));
          W.sv[i * kSlots + 2 * t + 1] = static_cast<double>(__fsub_rn(__fmul_rn(rh, zz.y), yy.y));
        }
      }
      __syncwarp();
      // (b) t = v A_bar, and rhs = (sigma x - q_bar) + t staged for w.
      for (int rt0 = 0; rt0 < P.rt_t; rt0 += kG) {
        double d[kG][4];
        product_group(d, Af, W.sv, rt0, P.rt_t, P.kc_t, lane);
#pragma unroll
        for (int q = 0; q < kG; ++q) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = 16 * (rt0 + q) + 8 * h + g;
            if (j >= n) continue;
            const float2 xx = W.x[j * 4 + t];
            const float base_q = cq[j];
            const float r0 = __fadd_rn(__fsub_rn(__fmul_rn(P.sigma, xx.x), base_q), static_cast<float>(d[q][2 * h]));
            const float r1 =
                __fadd_rn(__fsub_rn(__fmul_rn(P.sigma, xx.y), base_q), static_cast<float>(d[q][2 * h + 1]));
            W.sr[j * kSlots + 2 * t] = static_cast<double>(r0);
            W.sr[j * kSlots + 2 * t + 1] = static_cast<double>(r1);
          }
        }
      }
      __syncwarp();
      // (c) w = P_pack rhs, then the relaxation, the clip and the dual update.
      for (int rt0 = 0; rt0 < P.rt_w; rt0 += kG) {
        double d[kG][4];
        product_group(d, Pf, W.sr, rt0, P.rt_w, P.kc_w, lane);
#pragma unroll
        for (int qh = 0; qh < 2 * kG; ++qh) {
          const int q = qh >> 1, h = qh & 1;
          const int r = 16 * (rt0 + q) + 8 * h + g;
          if (r >= nm) continue;
          const float w0 = static_cast<float>(d[q][2 * h]), w1 = static_cast<float>(d[q][2 * h + 1]);
          if (r < n) {
            float2 xx = W.x[r * 4 + t];
            xx.x = __fadd_rn(__fmul_rn(a, w0), __fmul_rn(bm, xx.x));
            xx.y = __fadd_rn(__fmul_rn(a, w1), __fmul_rn(bm, xx.y));
            W.x[r * 4 + t] = xx;
          } else {
            const int i = r - n;
            const float ir = cir[i], rh = crho[i];
            float2 yy = W.y[i * 4 + t], zz = W.z[i * 4 + t], ax = W.Ax[i * 4 + t];
            const float2 lo = W.lb[i * 4 + t], hi = W.ub[i * 4 + t];
            relax_clip(w0, a, bm, ir, rh, lo.x, hi.x, ax.x, yy.x, zz.x);
            relax_clip(w1, a, bm, ir, rh, lo.y, hi.y, ax.y, yy.y, zz.y);
            W.y[i * 4 + t] = yy;
            W.z[i * 4 + t] = zz;
            W.Ax[i * 4 + t] = ax;
          }
        }
      }
    }

    // The check: stage y, t_y = y A_bar, and |D⁻¹(q̄ + Āᵀy)|, |D⁻¹Āᵀy|,
    // |E⁻¹(Āx − z)|, |E⁻¹Āx|, |E⁻¹z| per slot.
    float v[2][5] = {{0.f, 0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f, 0.f}};
    for (int rt = n / 16; rt < P.rt_w; ++rt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * rt + 8 * h + g;
        if (r < n || r >= nm) continue;
        const int i = r - n;
        const float2 yy = W.y[i * 4 + t], zz = W.z[i * 4 + t], ax = W.Ax[i * 4 + t];
        W.sv[i * kSlots + 2 * t] = static_cast<double>(yy.x);
        W.sv[i * kSlots + 2 * t + 1] = static_cast<double>(yy.y);
        const float ei = cei[i];
        const float axv[2] = {ax.x, ax.y}, zv[2] = {zz.x, zz.y};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e][2] = nan_max(v[e][2], fabsf(__fmul_rn(ei, __fsub_rn(axv[e], zv[e]))));
          v[e][3] = nan_max(v[e][3], fabsf(__fmul_rn(ei, axv[e])));
          v[e][4] = nan_max(v[e][4], fabsf(__fmul_rn(ei, zv[e])));
        }
      }
    }
    __syncwarp();
    for (int rt0 = 0; rt0 < P.rt_t; rt0 += kG) {
      double d[kG][4];
      product_group(d, Af, W.sv, rt0, P.rt_t, P.kc_t, lane);
#pragma unroll
      for (int qh = 0; qh < 2 * kG; ++qh) {
        const int q = qh >> 1, h = qh & 1;
        const int j = 16 * (rt0 + q) + 8 * h + g;
        if (j >= n) continue;
        const float di = cdi[j], qj = cq[j];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float t_y = static_cast<float>(d[q][2 * h + e]);
          v[e][0] = nan_max(v[e][0], fabsf(__fmul_rn(di, __fadd_rn(qj, t_y))));
          v[e][1] = nan_max(v[e][1], fabsf(__fmul_rn(di, t_y)));
        }
      }
    }
    __syncwarp();  // the next sweep overwrites the staged y
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int k = 0; k < 5; ++k) v[e][k] = slot_max(v[e][k]);
      if (b[e] < 0) continue;
      const float rp = v[e][2];
      const float rd = __fdiv_rn(v[e][0], P.c_scale);
      const float pr = nan_max(v[e][3], v[e][4]);
      const float d_ref = nan_max(__fdiv_rn(v[e][1], P.c_scale), P.q_ref);
      const bool improved = rd < __fmul_rn(best_rd[e], P.improve) || rp < __fmul_rn(best_rp[e], P.improve);
      best_rp[e] = nan_min(best_rp[e], rp);
      best_rd[e] = nan_min(best_rd[e], rd);
      stall[e] = improved ? 0 : stall[e] + 1;
      const float tol_p = __fadd_rn(P.eps_abs, __fmul_rn(P.eps_rel, pr));
      const bool strict = rp <= tol_p && rd <= __fadd_rn(P.eps_abs, __fmul_rn(P.eps_rel, d_ref));
      const bool plateau = stall[e] >= P.stall_checks && rp <= tol_p && rd <= __fmul_rn(P.plateau_cap, d_ref);
      done[e] = strict || plateau;
      r_prim[e] = rp;
      r_dual[e] = rd;
      p_ref[e] = pr;
      it[e] += P.K;
      if (done[e] || it[e] >= P.max_iter) {
        finish(e);
        need[e] = true;
      }
    }
    refill();
  }
}


}  // namespace staged

namespace streamed {

constexpr int kLanes = 2 * kSlots;  // lanes a consumer warp: two B operands (o = 0, 1)
constexpr int kG = 4;               // row tiles a group (vec/mpc.py STREAM_TILES: the streams' layout)
constexpr int kKS = 6;              // k-chunks a ring stage (vec/mpc.py STREAM_CHUNKS)
constexpr int kStageBytes = kG * kKS * 32 * 16;
constexpr int kMaxStages = 8;
constexpr int kMaxConsumers = 4;    // one a scheduler of the SM
constexpr int kBatch = 4;           // rows of an epilogue whose cells load together
constexpr int kHead = 128;          // the ring's mbarriers, before its stages
static_assert(kHead >= 2 * kMaxStages * 8, "the ring's full and empty mbarriers fit in the head");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}
// Wait for the completion of the phase of `bar` whose parity is `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
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
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// One bulk copy (the TMA) of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory to shared memory, announced to and completing
// on `bar`; one thread issues it.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}
// The ring of stages: the next stage's slot and the parity of its use
// (stage i takes slot i % S in its use i / S).
struct Ring {
  unsigned char* base;
  uint64_t* full;   // [S]: the stage's copy has landed (one arrival and its bytes)
  uint64_t* empty;  // [S]: every consumer warp has released it (W arrivals)
  int stages, slot;
  unsigned parity;
  __device__ __forceinline__ void advance() {
    if (++slot == stages) {
      slot = 0;
      parity ^= 1u;
    }
  }
};

// k-chunks of a product as the stream holds them: padded with zero chunks to
// whole stages.
__host__ __device__ inline int stream_chunks(int kc) { return (kc + kKS - 1) / kKS * kKS; }

// The producer: one product's stages, group after group (kG row tiles), each
// group's k-chunks kKS at a time (KC of them, whole stages), as the consumers
// take them.
__device__ __forceinline__ void issue(Ring& R, const double2* src, int RT, int KC) {
  for (int rt0 = 0; rt0 < RT; rt0 += kG) {
    const int nq = RT - rt0 < kG ? RT - rt0 : kG;
    for (int c0 = 0; c0 < KC; c0 += kKS) {
      mbar_wait(&R.empty[R.slot], R.parity ^ 1u);  // its previous use released (a fresh slot passes)
      bulk_load(R.base + R.slot * kStageBytes, src + (static_cast<size_t>(rt0) * KC + c0 * nq) * 32,
                static_cast<unsigned>(kKS * nq * 512), &R.full[R.slot]);
      R.advance();
    }
  }
}

// One stage of NQ row tiles: d[q][o] += the stage's kKS chunks of tile q
// ([c][q][32] at st) times B operand o (b: the stage's first row), chunk by
// chunk; chunk c + 1's fragments load while chunk c multiplies.
template <int NQ>
__device__ __forceinline__ void stage_product(double (&d)[kG][2][4], const double2* st, const float2* b) {
  double2 a[2][NQ];
  float2 bb[2];
#pragma unroll
  for (int q = 0; q < NQ; ++q) a[0][q] = st[q * 32];
  bb[0] = b[0];
#pragma unroll
  for (int c = 0; c < kKS; ++c) {
    const int cur = c & 1, nxt = cur ^ 1;
    if (c + 1 < kKS) {
#pragma unroll
      for (int q = 0; q < NQ; ++q) a[nxt][q] = st[((c + 1) * NQ + q) * 32];
      bb[nxt] = b[(c + 1) * 4 * kSlots];
    }
    const double b0 = bb[cur].x, b1 = bb[cur].y;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      dmma(d[q][0], a[cur][q].x, a[cur][q].y, b0);
      dmma(d[q][1], a[cur][q].x, a[cur][q].y, b1);
    }
  }
}

// A consumer warp: one product for its 16 lanes.  Per group of kG row tiles,
// d[q][o] = the sum over the KC k-chunks of A (the ring's stages: [c][q][32])
// times B operand o of sB [4 KC][8] (float2: o = 0, 1); each (tile, operand)
// one chain in k order.  epi(rt0, nq, d) runs when the group ends; a warp
// with no lane (live false) takes and releases the stages and runs no
// product and no epilogue.
template <class Epi>
__device__ __forceinline__ void consume(Ring& R, const float2* sB, int RT, int KC, bool live, int lane, Epi&& epi) {
  const int g = lane >> 2, t = lane & 3;
  for (int rt0 = 0; rt0 < RT; rt0 += kG) {
    const int nq = RT - rt0 < kG ? RT - rt0 : kG;
    double d[kG][2][4];
#pragma unroll
    for (int q = 0; q < kG; ++q)
#pragma unroll
      for (int o = 0; o < 2; ++o) d[q][o][0] = d[q][o][1] = d[q][o][2] = d[q][o][3] = 0.0;
    static_assert(kG == 4, "the stages' tile counts below");
    for (int c0 = 0; c0 < KC; c0 += kKS) {
      mbar_wait(&R.full[R.slot], R.parity);
      const double2* st = reinterpret_cast<const double2*>(R.base + R.slot * kStageBytes) + lane;
      const float2* b = sB + (4 * c0 + t) * kSlots + g;
      if (live) {
        if (nq == 4)
          stage_product<4>(d, st, b);
        else if (nq == 3)
          stage_product<3>(d, st, b);
        else if (nq == 2)
          stage_product<2>(d, st, b);
        else
          stage_product<1>(d, st, b);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&R.empty[R.slot]);
      R.advance();
    }
    if (live) epi(rt0, nq, d);
  }
}

// Component k of a thread's cell: slot 2t + (k & 1) of B operand k >> 1.
__device__ __forceinline__ float& cell(float4& v, int k) { return reinterpret_cast<float*>(&v)[k]; }
__device__ __forceinline__ float cell(const float4& v, int k) { return reinterpret_cast<const float*>(&v)[k]; }
// Row r of a staged B operand from a thread's cell: columns 2t and 2t + 1,
// each a float2 of the two operands.
__device__ __forceinline__ void stage_row(float2* s, int r, int t, const float4& v) {
  *reinterpret_cast<float4*>(s + r * kSlots + 2 * t) = make_float4(v.x, v.z, v.y, v.w);
}

// Shared memory: the head (mbarriers), the ring, the row constants, then each
// consumer warp's two B operands.
__host__ __device__ inline size_t consts_bytes(int n, int m) {
  return (sizeof(float) * (2 * static_cast<size_t>(n) + 3 * m) + 15) & ~static_cast<size_t>(15);
}
__host__ __device__ inline size_t operand_bytes(int n, int m) {
  return sizeof(float2) * kSlots * 4 * (static_cast<size_t>(stream_chunks((m + 3) / 4)) + stream_chunks((n + 3) / 4));
}

__global__ void __launch_bounds__((kMaxConsumers + 1) * 32, 1) admm_kernel(Problem P, Lanes L, int n_stages) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int n = P.n, m = P.m, nm = n + m;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, W = (blockDim.x >> 5) - 1;
  const int g = lane >> 2, t = lane & 3;
  const bool producer = warp == W;

  Ring R{smem_raw + kHead, reinterpret_cast<uint64_t*>(smem_raw), reinterpret_cast<uint64_t*>(smem_raw) + kMaxStages,
         n_stages, 0, 0u};
  float* cq = reinterpret_cast<float*>(R.base + static_cast<size_t>(n_stages) * kStageBytes);  // [n] q_bar
  float* cdi = cq + n;                                                                           // [n] D_inv
  float* crho = cdi + n;                                                                         // [m] rho
  float* cir = crho + m;                                                                         // [m] 1/rho
  float* cei = cir + m;                                                                          // [m] E_inv
  // This consumer warp's B operands: v (or y at a check) [4 kc_t][8], rhs [4 kc_w][8].
  float2* sv = reinterpret_cast<float2*>(reinterpret_cast<unsigned char*>(cq) + consts_bytes(n, m) +
                                         (producer ? 0 : warp) * operand_bytes(n, m));
  const int kc_t = stream_chunks(P.kc_t), kc_w = stream_chunks(P.kc_w);  // the streams' chunks
  float2* sr = sv + kSlots * 4 * kc_t;
  // Its lanes' state: [row][4] float4, the cell of thread t (slots 2t, 2t + 1 of both operands).
  float4* X = reinterpret_cast<float4*>(L.scratch) + (static_cast<size_t>(blockIdx.x) * W + warp) * 4 * (n + 5 * m);
  float4* Y = X + 4 * n;
  float4* Z = Y + 4 * m;
  float4* AX = Z + 4 * m;
  float4* LB = AX + 4 * m;
  float4* UB = LB + 4 * m;

  if (threadIdx.x == 0) {
    for (int s = 0; s < n_stages; ++s) {
      mbar_init(&R.full[s], 1);
      mbar_init(&R.empty[s], W);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    cq[j] = P.q[j];
    cdi[j] = P.D_inv[j];
  }
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    crho[i] = P.rho[i];
    cir[i] = P.inv_rho[i];
    cei[i] = P.E_inv[i];
  }
  // The B operands' padding rows (k >= m, k >= n) stay zero.
  if (!producer)
    for (int i = lane; i < kSlots * 4 * (kc_t + kc_w); i += 32) sv[i] = make_float2(0.f, 0.f);
  __syncthreads();
  const float inf = __int_as_float(0x7f800000);
  const double2* At = P.Af;  // the streams: Āᵀ's and P_pack's fragments by groups of kG row tiles
  const double2* Pw = P.Pf;

  // The slots k = 2o + e (operand o, column 2t + e) of this thread: their
  // scalars, equal in the 8 threads g = 0..7 of the column.
  int b[4] = {-1, -1, -1, -1}, it[4] = {0, 0, 0, 0}, stall[4] = {0, 0, 0, 0};
  float r_prim[4], r_dual[4], best_rp[4], best_rd[4], p_ref[4];
  bool done[4], need[4], bounds_ok[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    r_prim[k] = r_dual[k] = best_rp[k] = best_rd[k] = inf;
    p_ref[k] = 0.f;
    done[k] = false;
    need[k] = !producer;
    bounds_ok[k] = true;
  }

  // Reduce v over the slot's 8 threads (lane bits 2..4) with NaN kept.
  auto slot_max = [&](float v) {
    for (int o = 4; o < 32; o <<= 1) v = nan_max(v, __shfl_xor_sync(kFull, v, o));
    return v;
  };

  // Write slot k's outputs (its lane b[k] exits).
  auto finish = [&](int k) {
    const int64_t lb_ = b[k];
    for (int rt = 0; rt < P.rt_w; ++rt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * rt + 8 * h + g;
        if (r < n) {
          const float xv = cell(X[r * 4 + t], k);
          L.xw[lb_ * n + r] = xv;
          L.x_out[lb_ * n + r] = __fmul_rn(P.D[r], xv);
        } else if (r < nm) {
          const int i = r - n;
          L.yw[lb_ * m + i] = cell(Y[i * 4 + t], k);
          L.zw[lb_ * m + i] = cell(Z[i * 4 + t], k);
          L.Axw[lb_ * m + i] = cell(AX[i * 4 + t], k);
        }
      }
    }
    if (g == 0) {
      L.iterations[lb_] = it[k];
      L.r_prim[lb_] = r_prim[k];
      L.r_dual[lb_] = r_dual[k];
      L.converged[lb_] = done[k] && bounds_ok[k];
      L.bounds_ok[lb_] = bounds_ok[k];
      L.feasible[lb_] = bounds_ok[k] &&
                        r_prim[k] <= __fmul_rn(P.feas_band, __fadd_rn(P.eps_abs, __fmul_rn(P.eps_rel, p_ref[k])));
    }
  };

  // Give every slot that needs one its next lane; a lane with a crossed bound
  // row (or max_iter <= 0) exits at entry and the slot takes another.
  auto refill = [&]() {
    while (__any_sync(kFull, need[0] || need[1] || need[2] || need[3])) {
      bool fresh[4], touch[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        fresh[k] = false;
        touch[k] = need[k];  // slots whose cells this round rewrites
        int claim = 0;
        if (need[k] && g == 0) claim = atomicAdd(L.next_lane, 1);
        claim = __shfl_sync(kFull, claim, t);
        if (!need[k]) continue;
        if (claim >= L.B) {
          b[k] = -1;
          need[k] = false;
        } else {
          b[k] = claim;
          fresh[k] = true;
        }
      }
      // Load the fresh lanes' cells (an exhausted slot's cells are zeros).
      bool crossed[4] = {false, false, false, false};
      float pa[4] = {0.f, 0.f, 0.f, 0.f}, pb[4] = {0.f, 0.f, 0.f, 0.f};
      for (int rt = 0; rt < P.rt_w; ++rt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * rt + 8 * h + g;
          if (r >= nm) continue;
          const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
          float4 vx = zero, vy = zero, vz = zero, va = zero, vl = zero, vu = zero;
          if (r < n) {
            vx = X[r * 4 + t];
          } else {
            const int i = r - n;
            vy = Y[i * 4 + t];
            vz = Z[i * 4 + t];
            va = AX[i * 4 + t];
            vl = LB[i * 4 + t];
            vu = UB[i * 4 + t];
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (!touch[k]) continue;
            float x0 = 0.f, y0 = 0.f, z0 = 0.f, a0 = 0.f, l0 = 0.f, u0 = 0.f;
            if (fresh[k]) {
              const int64_t bb = b[k];
              if (r < n) {
                x0 = L.x0[bb * n + r];
              } else {
                const int i = r - n;
                const int64_t kk = bb * m + i;
                y0 = L.y0[kk];
                z0 = L.z0[kk];
                a0 = L.Ax0[kk];
                const float lo = L.l[kk], hi = L.u[kk], ee = P.E[i];
                // Scaled bounds; the infinities stay ±BIG, so the clip passes them through.
                l0 = lo <= -kBig ? -kBig : __fmul_rn(ee, lo);
                u0 = hi >= kBig ? kBig : __fmul_rn(ee, hi);
                crossed[k] = crossed[k] || !(lo <= hi);
                pa[k] = nan_max(pa[k], fabsf(__fmul_rn(cei[i], a0)));
                pb[k] = nan_max(pb[k], fabsf(__fmul_rn(cei[i], z0)));
              }
            }
            cell(vx, k) = x0;
            cell(vy, k) = y0;
            cell(vz, k) = z0;
            cell(va, k) = a0;
            cell(vl, k) = l0;
            cell(vu, k) = u0;
          }
          if (!(touch[0] || touch[1] || touch[2] || touch[3])) continue;
          if (r < n) {
            X[r * 4 + t] = vx;
          } else {
            const int i = r - n;
            Y[i * 4 + t] = vy;
            Z[i * 4 + t] = vz;
            AX[i * 4 + t] = va;
            LB[i * 4 + t] = vl;
            UB[i * 4 + t] = vu;
          }
        }
      }
      // The crossed flags and p_ref of the fresh slots, over each slot's threads.
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float cf = slot_max(crossed[k] ? 1.f : 0.f);
        const float ref = nan_max(slot_max(pa[k]), slot_max(pb[k]));
        if (!fresh[k]) continue;
        bounds_ok[k] = cf == 0.f;
        it[k] = 0;
        stall[k] = 0;
        r_prim[k] = r_dual[k] = best_rp[k] = best_rd[k] = inf;
        p_ref[k] = ref;
        done[k] = !bounds_ok[k];
        if (done[k] || P.max_iter <= 0) {
          finish(k);  // exits at entry with its warm start
          need[k] = true;
        } else {
          need[k] = false;
        }
      }
    }
  };

  // The epilogues.  t: rhs = (sigma x - q_bar) + t staged for w.
  // An epilogue loads a batch of its rows' cells before it stores any: one
  // memory latency a batch, not one a row.
  auto epi_t = [&](int rt0, int nq, double (&d)[kG][2][4]) {
    float4 xs[2 * kG];
#pragma unroll
    for (int qh = 0; qh < 2 * kG; ++qh) {
      const int j = 16 * (rt0 + (qh >> 1)) + 8 * (qh & 1) + g;
      if ((qh >> 1) < nq && j < n) xs[qh] = X[j * 4 + t];
    }
#pragma unroll
    for (int qh = 0; qh < 2 * kG; ++qh) {
      const int q = qh >> 1, h = qh & 1;
      const int j = 16 * (rt0 + q) + 8 * h + g;
      if (q >= nq || j >= n) continue;
      const float4 xx = xs[qh];
      const float base_q = cq[j];
      float4 rr;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        cell(rr, k) = __fadd_rn(__fsub_rn(__fmul_rn(P.sigma, cell(xx, k)), base_q),
                                static_cast<float>(d[q][k >> 1][2 * h + (k & 1)]));
      stage_row(sr, j, t, rr);
    }
  };
  // w: the relaxation, the clip and the dual update; then the next sweep's
  // v = rho z - y staged, or (the round's last sweep) y staged for the check
  // and the check's maxima over the constraint rows.
  float vmax[4][5];
  bool last = false;
  const float alpha = P.alpha, beta = P.one_minus_alpha;
  auto epi_w = [&](int rt0, int nq, double (&d)[kG][2][4]) {
#pragma unroll
    for (int qh0 = 0; qh0 < 2 * kG; qh0 += kBatch) {
      float4 c0[kBatch], c1[kBatch], c2[kBatch], c3[kBatch], c4[kBatch];  // x, or y, z, Ax, l_bar, u_bar
#pragma unroll
      for (int e = 0; e < kBatch; ++e) {
        const int qh = qh0 + e, r = 16 * (rt0 + (qh >> 1)) + 8 * (qh & 1) + g;
        if ((qh >> 1) >= nq || r >= nm) continue;
        if (r < n) {
          c0[e] = X[r * 4 + t];
        } else {
          const int i = r - n;
          c0[e] = Y[i * 4 + t];
          c1[e] = Z[i * 4 + t];
          c2[e] = AX[i * 4 + t];
          c3[e] = __ldcs(LB + i * 4 + t);  // the bounds only read: streamed through the caches
          c4[e] = __ldcs(UB + i * 4 + t);
        }
      }
#pragma unroll
      for (int e = 0; e < kBatch; ++e) {
        const int qh = qh0 + e, q = qh >> 1, h = qh & 1;
        const int r = 16 * (rt0 + q) + 8 * h + g;
        if (q >= nq || r >= nm) continue;
        if (r < n) {
          float4 xx = c0[e];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            cell(xx, k) = __fadd_rn(__fmul_rn(alpha, static_cast<float>(d[q][k >> 1][2 * h + (k & 1)])),
                                    __fmul_rn(beta, cell(xx, k)));
          X[r * 4 + t] = xx;
        } else {
          const int i = r - n;
          const float ir = cir[i], rh = crho[i];
          float4 yy = c0[e], zz = c1[e], ax = c2[e];
          const float4 lo = c3[e], hi = c4[e];
          float4 vv;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            relax_clip(static_cast<float>(d[q][k >> 1][2 * h + (k & 1)]), alpha, beta, ir, rh, cell(lo, k), cell(hi, k),
                       cell(ax, k), cell(yy, k), cell(zz, k));
            cell(vv, k) = __fsub_rn(__fmul_rn(rh, cell(zz, k)), cell(yy, k));
          }
          Y[i * 4 + t] = yy;
          Z[i * 4 + t] = zz;
          AX[i * 4 + t] = ax;
          if (!last) {
            stage_row(sv, i, t, vv);
          } else {
            stage_row(sv, i, t, yy);
            const float ei = cei[i];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              vmax[k][2] = nan_max(vmax[k][2], fabsf(__fmul_rn(ei, __fsub_rn(cell(ax, k), cell(zz, k)))));
              vmax[k][3] = nan_max(vmax[k][3], fabsf(__fmul_rn(ei, cell(ax, k))));
              vmax[k][4] = nan_max(vmax[k][4], fabsf(__fmul_rn(ei, cell(zz, k))));
            }
          }
        }
      }
    }
  };
  // The check: t_y = y A_bar, then |D⁻¹(q̄ + Āᵀy)| and |D⁻¹Āᵀy|.
  auto epi_check = [&](int rt0, int nq, double (&d)[kG][2][4]) {
#pragma unroll
    for (int qh = 0; qh < 2 * kG; ++qh) {
      const int q = qh >> 1, h = qh & 1;
      const int j = 16 * (rt0 + q) + 8 * h + g;
      if (q >= nq || j >= n) continue;
      const float di = cdi[j], qj = cq[j];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float t_y = static_cast<float>(d[q][k >> 1][2 * h + (k & 1)]);
        vmax[k][0] = nan_max(vmax[k][0], fabsf(__fmul_rn(di, __fadd_rn(qj, t_y))));
        vmax[k][1] = nan_max(vmax[k][1], fabsf(__fmul_rn(di, t_y)));
      }
    }
  };

  bool live = false;
  if (!producer) {
    refill();
    live = __any_sync(kFull, b[0] >= 0 || b[1] >= 0 || b[2] >= 0 || b[3] >= 0);
  }
  // A round: K sweeps and a check, on every warp of the block, while any slot
  // of the block holds a lane.
  while (__syncthreads_or(live)) {
    if (producer) {
      if (lane == 0) {
        for (int sweep = 0; sweep < P.K; ++sweep) {
          issue(R, At, P.rt_t, kc_t);
          issue(R, Pw, P.rt_w, kc_w);
        }
        issue(R, At, P.rt_t, kc_t);
      }
      __syncwarp();
      continue;
    }
    // v = rho z - y for the round's first sweep (the others' come from w).
    if (live) {
      for (int rt0 = n / 16; rt0 < P.rt_w; rt0 += kBatch / 2) {
        float4 zs[kBatch], ys[kBatch];
#pragma unroll
        for (int e = 0; e < kBatch; ++e) {
          const int r = 16 * (rt0 + (e >> 1)) + 8 * (e & 1) + g;
          if (r >= n && r < nm) {
            zs[e] = Z[(r - n) * 4 + t];
            ys[e] = Y[(r - n) * 4 + t];
          }
        }
#pragma unroll
        for (int e = 0; e < kBatch; ++e) {
          const int r = 16 * (rt0 + (e >> 1)) + 8 * (e & 1) + g;
          if (r < n || r >= nm) continue;
          const int i = r - n;
          const float rh = crho[i];
          float4 vv;
#pragma unroll
          for (int k = 0; k < 4; ++k) cell(vv, k) = __fsub_rn(__fmul_rn(rh, cell(zs[e], k)), cell(ys[e], k));
          stage_row(sv, i, t, vv);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int c = 0; c < 5; ++c) vmax[k][c] = 0.f;
    __syncwarp();
    for (int sweep = 0; sweep < P.K; ++sweep) {
      last = sweep == P.K - 1;
      consume(R, sv, P.rt_t, kc_t, live, lane, epi_t);
      __syncwarp();
      consume(R, sr, P.rt_w, kc_w, live, lane, epi_w);
      __syncwarp();
    }
    consume(R, sv, P.rt_t, kc_t, live, lane, epi_check);
    __syncwarp();  // the next round's first sweep overwrites the staged y
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int c = 0; c < 5; ++c) vmax[k][c] = slot_max(vmax[k][c]);
      if (b[k] < 0) continue;
      const float rp = vmax[k][2];
      const float rd = __fdiv_rn(vmax[k][0], P.c_scale);
      const float pr = nan_max(vmax[k][3], vmax[k][4]);
      const float d_ref = nan_max(__fdiv_rn(vmax[k][1], P.c_scale), P.q_ref);
      const bool improved = rd < __fmul_rn(best_rd[k], P.improve) || rp < __fmul_rn(best_rp[k], P.improve);
      best_rp[k] = nan_min(best_rp[k], rp);
      best_rd[k] = nan_min(best_rd[k], rd);
      stall[k] = improved ? 0 : stall[k] + 1;
      const float tol_p = __fadd_rn(P.eps_abs, __fmul_rn(P.eps_rel, pr));
      const bool strict = rp <= tol_p && rd <= __fadd_rn(P.eps_abs, __fmul_rn(P.eps_rel, d_ref));
      const bool plateau = stall[k] >= P.stall_checks && rp <= tol_p && rd <= __fmul_rn(P.plateau_cap, d_ref);
      done[k] = strict || plateau;
      r_prim[k] = rp;
      r_dual[k] = rd;
      p_ref[k] = pr;
      it[k] += P.K;
      if (done[k] || it[k] >= P.max_iter) {
        finish(k);
        need[k] = true;
      }
    }
    refill();
    live = __any_sync(kFull, b[0] >= 0 || b[1] >= 0 || b[2] >= 0 || b[3] >= 0);
  }
}

}  // namespace streamed

size_t block_shared_bytes(int n, int m, int n_frag, int n_warps, size_t warp_bytes) {
  const size_t consts = sizeof(float) * (2 * static_cast<size_t>(n) + 3 * m) + 16;  // + alignment
  return 16 * static_cast<size_t>(n_frag) + consts + n_warps * warp_bytes;
}

// Bytes of one staged warp's state (its 8 lanes' x [n] and y, z, Ax, l_bar,
// u_bar [m] as float32, and the two staged operands, padded to k-chunks of 4)
// and the double pairs of both matrices' fragments (admm_cuda.py:frag_count),
// for (n, m).
long long warp_shared_bytes(int n, int m) {
  const int kc_t = (m + 3) / 4, kc_w = (n + 3) / 4;
  return 8LL * 4 * (n + 5LL * m) + 8LL * 8 * 4 * (kc_t + kc_w);
}

long long frag_count(int n, int m) {
  return 32LL * (((n + 15) / 16) * ((m + 3) / 4) + ((n + m + 15) / 16) * ((n + 3) / 4));
}

// Shared memory of a streamed block of W consumer warps and `stages` stages.
size_t stream_shared_bytes(int n, int m, int W, int stages) {
  return streamed::kHead + static_cast<size_t>(stages) * streamed::kStageBytes + streamed::consts_bytes(n, m) +
         W * streamed::operand_bytes(n, m);
}

// The streamed route's consumer warps a block for B lanes of (n, m) on a card
// of n_sm SMs and max_smem bytes of shared memory a block (vec/admm_cuda.py:
// stream_warps): the fewest that hold B lanes in one wave of resident lanes
// (a block an SM, 16 lanes a warp), at most kMaxConsumers (one a scheduler)
// and those whose B operands fit with two ring stages.  0 where not even one
// warp fits.
int stream_warps(long long B, int n, int m, int n_sm, int max_smem) {
  int w_fit = 0;
  while (w_fit < streamed::kMaxConsumers && stream_shared_bytes(n, m, w_fit + 1, 2) <= static_cast<size_t>(max_smem))
    ++w_fit;
  const long long wave = static_cast<long long>(n_sm) * streamed::kLanes;
  const long long one_wave = (B + wave - 1) / wave;
  return static_cast<int>(one_wave < w_fit ? one_wave : w_fit);
}

// The card's SM count and opt-in shared memory a block; a CUDA error or 0.
cudaError_t card(int* n_sm, int* max_smem) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, device);
  return err;
}

// The launch of B lanes of (n, m): staged (the fragments and two warps' state
// fit in shared memory beside the row constants: the farm's shape), else
// streamed with W consumer warps, `stages` ring stages and `grid` blocks.
struct Plan {
  bool staged;
  int W, stages, grid;
  size_t smem;
};

// 0 and *plan, -1 where neither route takes (n, m), or a CUDA error.
int plan_launch(int B, int n, int m, Plan* plan) {
  int n_sm = 0, max_smem = 0;
  cudaError_t err = card(&n_sm, &max_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t limit = static_cast<size_t>(max_smem);
  const size_t warp_bytes = static_cast<size_t>(warp_shared_bytes(n, m));
  const int n_frag = static_cast<int>(frag_count(n, m));
  if (block_shared_bytes(n, m, n_frag, 2, warp_bytes) <= limit) {
    int n_warps = kMaxWarps;
    while (n_warps > 2 && block_shared_bytes(n, m, n_frag, n_warps, warp_bytes) > limit) --n_warps;
    plan->staged = true;
    plan->W = n_warps;
    plan->stages = 0;
    plan->smem = block_shared_bytes(n, m, n_frag, n_warps, warp_bytes);
    err = cudaFuncSetAttribute(staged::admm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(plan->smem));
    int per_sm = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, staged::admm_kernel, n_warps * 32, plan->smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long need = (static_cast<long long>(B) + kSlots * n_warps - 1) / (kSlots * n_warps);
    const long long cap = static_cast<long long>(per_sm > 0 ? per_sm : 1) * n_sm;
    plan->grid = static_cast<int>(need < cap ? need : cap);
    return 0;
  }
  const int W = stream_warps(B, n, m, n_sm, max_smem);
  if (W == 0) return -1;
  int stages = static_cast<int>((limit - stream_shared_bytes(n, m, W, 0)) / streamed::kStageBytes);
  stages = stages < streamed::kMaxStages ? stages : streamed::kMaxStages;
  plan->staged = false;
  plan->W = W;
  plan->stages = stages;
  plan->smem = stream_shared_bytes(n, m, W, stages);
  err = cudaFuncSetAttribute(streamed::admm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(plan->smem));
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, streamed::admm_kernel, (W + 1) * 32, plan->smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long need = (static_cast<long long>(B) + streamed::kLanes * W - 1) / (streamed::kLanes * W);
  const long long cap = static_cast<long long>(per_sm > 0 ? per_sm : 1) * n_sm;
  plan->grid = static_cast<int>(need < cap ? need : cap);
  return 0;
}

}  // namespace

// Bytes of the scratch buffer that admm_dcopf_f32 needs for B lanes of
// (n, m): 0 where it stages everything in shared memory, else the streamed
// route's resident slots' state (its blocks' consumer warps, 16 lanes each,
// x [n] and y, z, Ax, l_bar, u_bar [m] as float32); -1 where neither route
// takes the shape or the card cannot be asked.
extern "C" long long admm_scratch_bytes(int B, int n, int m) {
  Plan plan;
  if (B <= 0 || n <= 0 || m <= 0 || plan_launch(B, n, m, &plan) != 0) return -1;
  return plan.staged ? 0 : static_cast<long long>(plan.grid) * plan.W * 64 * (n + 5LL * m);
}

// The lanes a streamed block serves from one read of the matrices (16 a
// consumer warp) for B lanes of (n, m); 0 where the launch is staged; -1 as
// admm_scratch_bytes.
extern "C" int admm_stream_lanes(int B, int n, int m) {
  Plan plan;
  if (B <= 0 || n <= 0 || m <= 0 || plan_launch(B, n, m, &plan) != 0) return -1;
  return plan.staged ? 0 : streamed::kLanes * plan.W;
}

// Af, Pf: the fragments of A_bar^T and P_pack in the route's order, [rt][kc][32]
// (VecDCOPF.A_frag, P_frag) where the launch is staged (admm_scratch_bytes
// 0), by groups of 4 row tiles (A_stream, P_stream) where it streams.
extern "C" int admm_dcopf_f32(const double* Af, const double* Pf, const float* q, const float* rho,
                              const float* inv_rho, const float* D, const float* D_inv, const float* E,
                              const float* E_inv, const float* l, const float* u, const float* x0, const float* y0,
                              const float* z0, const float* Ax0, float* x_out, float* xw, float* yw, float* zw,
                              float* Axw, int* iterations, float* r_prim, float* r_dual, uint8_t* converged,
                              uint8_t* bounds_ok, uint8_t* feasible, int* next_lane, unsigned char* scratch,
                              float sigma, float alpha,
                              float one_minus_alpha, float c_scale, float q_ref, float eps_abs, float eps_rel,
                              float improve, float plateau_cap, float feas_band, int max_iter, int K,
                              int stall_checks, int B, int n, int m, void* stream) {
  if (B <= 0 || n <= 0 || m <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int rt_t = (n + 15) / 16, kc_t = (m + 3) / 4, rt_w = (n + m + 15) / 16, kc_w = (n + 3) / 4;
  Plan plan;
  const int rc = plan_launch(B, n, m, &plan);
  if (rc < 0 || (!plan.staged && scratch == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (rc > 0) return rc;
  const Problem P{reinterpret_cast<const double2*>(Af), reinterpret_cast<const double2*>(Pf), q, rho, inv_rho, D,
                  D_inv, E, E_inv, sigma, alpha, one_minus_alpha, c_scale, q_ref, eps_abs, eps_rel, improve,
                  plateau_cap, feas_band, max_iter, K, stall_checks, n, m, rt_t, kc_t, rt_w, kc_w};
  const Lanes L{l, u, x0, y0, z0, Ax0, x_out, xw, yw, zw, Axw, iterations, r_prim, r_dual, converged, bounds_ok,
                feasible, next_lane, scratch, B};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plan.staged)
    staged::admm_kernel<<<plan.grid, plan.W * 32, plan.smem, s>>>(P, L);
  else
    streamed::admm_kernel<<<plan.grid, (plan.W + 1) * 32, plan.smem, s>>>(P, L, plan.stages);
  return static_cast<int>(cudaGetLastError());
}
