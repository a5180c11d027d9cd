// K5's tile design (a warp a tile of 8 lanes; the fragments staged in shared
// memory where they fit, else read from L2 by every warp), kept as the
// baseline of chip_smoke.py phase 9a and gym_anm_torch/bench/kernel_probes.py:
// every later reading can put the current csrc/admm_dcopf.cu beside this
// design in one call.  Its C entry points are renamed admm_dcopf_pr6_f32 and
// admm_pr6_scratch_bytes (the arguments of admm_dcopf_f32 and
// admm_scratch_bytes), so it links beside the other baselines.
//
// The design's header comment follows.
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
// counts the sweeps a run's lanes actually ran.
//
// Design (the one-block-per-lane kernel before it is kept in
// gym_anm_torch/bench/admm_dcopf_pr5.cu as the probes' baseline).  A warp is a
// tile of 8 lane slots, and the two products of a sweep run for the 8 lanes
// together on the FP64 tensor cores (mma.sync m16n8k4, as chord_newton.cu):
//   t^T = A_bar^T v^T:   the matrix A_bar^T [n, m] as the 16-row A operand, the
//                        8 slots' v = rho z - y as the B operand (k = row i);
//   w^T = P_pack rhs^T:  P_pack [n+m, n] as the A operand, the 8 slots' rhs as
//                        the B operand (k = unknown j).
// At the farm's shape that is 2 x 10 + 4 x 6 = 44 DMMAs a warp-sweep, each
// matrix entry read once for 8 lanes.  The matrices come as fragment-ordered
// float64 copies (VecDCOPF.A_frag / P_frag, made once by make_vec_dcopf from
// the float32 values), so a thread loads its (a0, a1) with one 16-byte load
// and converts nothing; a lane's vector is converted once, when it is staged
// in shared memory as the B operand.  Where the two copies fit beside the
// warps' state (2,079 multiply-adds: 22.5 KB padded, at the farm's shape),
// the block stages them in shared memory once and its warps share them;
// where they do not (IEEE33-renewable N=1: 498 KB, ANM6Easy N=4: 281 KB),
// every warp reads its fragments from L2, 512 bytes per DMMA, and keeps its
// lanes' state in a device scratch buffer (L1/L2-resident), so that only the
// row constants take shared memory and the SM holds more warps to hide L2's
// latency; any (n, m) whose row constants fit runs (the one-block kernel took
// 3n + 6m <= 57.8k floats).
//
// Layout.  Thread l = 4 g + t of a warp holds the mma accumulator entries of
// rows 16 rt + g and 16 rt + g + 8 and slots 2t, 2t + 1 of every row tile rt.
// The two products' rows coincide for j < n (both start at 0 and tile by
// 16), so a thread owns the same cells (row r, slot s) of the lane state in
// both products and in the elementwise chain: x for r < n; y, z, Ax and the
// scaled bounds for r = n + i.  The state lives in the warp's shared memory
// ([row][8 slots] float32, a float2 per thread and row); no other thread
// touches a cell, so the chain needs no barrier.  Only the two staged
// operands cross threads: a sweep has two __syncwarp and no block barrier,
// and each warp runs on its own.  Each product accumulates a row tile in one
// chain in k order, as the plain version's float64 matmul sums, and gets its
// parallelism from up to 8 row tiles at once instead (splitting k into two
// chains moved float32 roundings and cost bitwise agreement).
//
// Per-lane exits.  The slot scalars (lane, it, stall, the residuals and their
// bests) are kept by the 8 threads of the slot's column pair, from maxima
// reduced over them with three shuffles.  At a check, a slot whose lane is
// done or has reached max_iter writes its outputs and takes the next lane
// from a device work counter (an atomicAdd on the int the wrapper zeroes), so
// no slot idles while lanes remain; a slot with no lane left sweeps zeros.
// The grid is persistent (the resident blocks of every SM).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 8;        // lane slots per warp (the mma's n = 8)
constexpr int kMaxWarps = 4;     // warps per block
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e20f;

struct Problem {
  const double2* Af;     // [rt_t][kc_t][32] fragments of A_bar^T (A operand of t)
  const double2* Pf;     // [rt_w][kc_w][32] fragments of P_pack (A operand of w)
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
  unsigned char* scratch;  // the warps' state where it is not in shared memory, or nullptr
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

// Row tiles of a product accumulated together: 4 where the fragments come
// from shared memory, 8 (with the next k-chunk's loads in flight) where they
// come from L2.  (8 with prefetching in shared memory took the farm's call
// from 0.19 to 0.32 ms on an H100: registers.)
template <bool kSmemMat>
struct Group {
  static constexpr int kSize = kSmemMat ? 4 : 8;
};

// Row tiles rt0 .. rt0 + kSize - 1 (those below rt_end) of a product: d[q] =
// the sum over the k-chunks of A (fragments [rt][kc][32]) times the staged
// operand sB [4 kc][8] (double).  Each tile's entries accumulate in one chain
// in k order, the order of the plain version's float64 matmul (so the kernel
// rounds as it does); the tiles of the group are independent chains that
// share each B load.  From L2, the fragments of chunk c + 1 are loaded while
// chunk c multiplies: 16 loads of 16 bytes in flight a thread, which is what
// hides L2's latency.
template <bool kSmemMat>
__device__ __forceinline__ void product_group(double (&d)[Group<kSmemMat>::kSize][4], const double2* frag,
                                              const double* sB, int rt0, int rt_end, int kc, int lane) {
  constexpr int kG = Group<kSmemMat>::kSize;
  const int g = lane >> 2, t = lane & 3;
  const int nq = rt_end - rt0 < kG ? rt_end - rt0 : kG;
  const double2* base = frag + static_cast<size_t>(rt0) * kc * 32 + lane;
  const size_t stride = static_cast<size_t>(kc) * 32;  // one row tile
#pragma unroll
  for (int q = 0; q < kG; ++q) d[q][0] = d[q][1] = d[q][2] = d[q][3] = 0.0;
  if constexpr (kSmemMat) {
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
  } else {
    double2 cur[kG], nxt[kG];
#pragma unroll
    for (int q = 0; q < kG; ++q) cur[q] = q < nq ? __ldg(base + q * stride) : make_double2(0.0, 0.0);
    for (int c = 0; c < kc; ++c) {
#pragma unroll
      for (int q = 0; q < kG; ++q)
        nxt[q] = q < nq && c + 1 < kc ? __ldg(base + q * stride + (c + 1) * 32) : make_double2(0.0, 0.0);
      const double bv = sB[(4 * c + t) * kSlots + g];
#pragma unroll
      for (int q = 0; q < kG; ++q) {
        if (q < nq) dmma(d[q], cur[q].x, cur[q].y, bv);
        cur[q] = nxt[q];
      }
    }
  }
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

// The warp's shared memory: its lanes' state and the two staged operands.
struct WarpMem {
  float2 *x, *y, *z, *Ax, *lb, *ub;  // [rows][4]: a float2 of slots (2t, 2t + 1) per thread t
  double *sv, *sr;                   // [4 kc_t][8], [4 kc_w][8]: B operands of t and w
};

// kSmemMat: the fragments and each warp's WarpMem staged in shared memory;
// else the fragments read from L2 and each warp's WarpMem in L.scratch.
template <bool kSmemMat>
__global__ void __launch_bounds__(kMaxWarps * 32) admm_kernel(Problem P, Lanes L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = P.n, m = P.m, nm = n + m;
  constexpr int kG = Group<kSmemMat>::kSize;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  // Block-shared: the fragments (when staged) and the row constants.
  const int n_af = P.rt_t * P.kc_t * 32, n_pf = P.rt_w * P.kc_w * 32;
  double2* sAf = reinterpret_cast<double2*>(smem_raw);
  double2* sPf = sAf + (kSmemMat ? n_af : 0);
  float* cq = reinterpret_cast<float*>(sPf + (kSmemMat ? n_pf : 0));  // [n] q_bar
  float* cdi = cq + n;                                                // [n] D_inv
  float* crho = cdi + n;                                              // [m] rho
  float* cir = crho + m;                                              // [m] 1/rho
  float* cei = cir + m;                                               // [m] E_inv
  unsigned char* wbase = reinterpret_cast<unsigned char*>(cei + m);
  wbase += (16 - (reinterpret_cast<uintptr_t>(wbase) & 15)) & 15;
  const size_t wbytes = 8 * sizeof(float) * (static_cast<size_t>(n) + 5 * m) +
                        8 * sizeof(double) * 4 * (static_cast<size_t>(P.kc_t) + P.kc_w);
  WarpMem W;
  {
    unsigned char* p = !kSmemMat ? L.scratch + (static_cast<size_t>(blockIdx.x) * n_warps + warp) * wbytes
                                    : wbase + warp * wbytes;
    W.sv = reinterpret_cast<double*>(p);
    W.sr = W.sv + 32 * P.kc_t;
    W.x = reinterpret_cast<float2*>(W.sr + 32 * P.kc_w);
    W.y = W.x + 4 * n;
    W.z = W.y + 4 * m;
    W.Ax = W.z + 4 * m;
    W.lb = W.Ax + 4 * m;
    W.ub = W.lb + 4 * m;
  }
  if (kSmemMat) {
    for (int i = threadIdx.x; i < n_af; i += blockDim.x) sAf[i] = P.Af[i];
    for (int i = threadIdx.x; i < n_pf; i += blockDim.x) sPf[i] = P.Pf[i];
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
  // The staged operands' padding rows (k >= m, k >= n) stay zero.
  for (int i = lane; i < 32 * (P.kc_t + P.kc_w); i += 32) W.sv[i] = 0.0;
  __syncthreads();
  const double2* Af = kSmemMat ? sAf : P.Af;
  const double2* Pf = kSmemMat ? sPf : P.Pf;
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
        product_group<kSmemMat>(d, Af, W.sv, rt0, P.rt_t, P.kc_t, lane);
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
        product_group<kSmemMat>(d, Pf, W.sr, rt0, P.rt_w, P.kc_w, lane);
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
      product_group<kSmemMat>(d, Af, W.sv, rt0, P.rt_t, P.kc_t, lane);
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

size_t block_shared_bytes(int n, int m, int n_frag, int n_warps, size_t warp_bytes) {
  const size_t consts = sizeof(float) * (2 * static_cast<size_t>(n) + 3 * m) + 16;  // + alignment
  return 16 * static_cast<size_t>(n_frag) + consts + n_warps * warp_bytes;
}

// Bytes of one warp's state (its 8 lanes' x [n] and y, z, Ax, l_bar, u_bar [m]
// as float32, and the two staged operands, padded to k-chunks of 4) and the
// double pairs of both matrices' fragments (admm_cuda.py:frag_count), for
// (n, m).
long long warp_shared_bytes(int n, int m) {
  const int kc_t = (m + 3) / 4, kc_w = (n + 3) / 4;
  return 8LL * 4 * (n + 5LL * m) + 8LL * 8 * 4 * (kc_t + kc_w);
}

long long frag_count(int n, int m) {
  return 32LL * (((n + 15) / 16) * ((m + 3) / 4) + ((n + m + 15) / 16) * ((n + 3) / 4));
}

// The layout of (n, m) on the current card: 1 where the fragments and the
// state of two warps fit in shared memory beside the row constants (the
// farm's shape: staged), 0 where only the row constants fit (the fragments
// from L2, the state in a scratch buffer), -1 where those do not fit either;
// or a CUDA error, negated, below -1.  *max_smem gets the card's opt-in limit.
int layout(int n, int m, int* max_smem) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -static_cast<int>(err) - 1;
  const size_t limit = static_cast<size_t>(*max_smem);
  if (block_shared_bytes(n, m, 0, 0, 0) > limit) return -1;
  return block_shared_bytes(n, m, static_cast<int>(frag_count(n, m)), 2, warp_shared_bytes(n, m)) <= limit;
}

}  // namespace

// Bytes of the scratch buffer that admm_dcopf_f32 needs for B lanes of
// (n, m): 0 where it stages everything in shared memory, ceil(B / 8) + 4 warp
// areas where it keeps the warps' state in device memory; -1 where the row
// constants do not fit in the card's shared memory per block (the shape is
// not taken) or the card cannot be asked.
extern "C" long long admm_pr6_scratch_bytes(int B, int n, int m) {
  int max_smem = 0;
  if (B <= 0 || n <= 0 || m <= 0) return -1;
  const int staged = layout(n, m, &max_smem);
  if (staged < 0) return -1;
  return staged ? 0 : ((static_cast<long long>(B) + kSlots - 1) / kSlots + kMaxWarps) * warp_shared_bytes(n, m);
}

extern "C" int admm_dcopf_pr6_f32(const double* Af, const double* Pf, const float* q, const float* rho,
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
  const int n_frag = static_cast<int>(frag_count(n, m));
  const size_t warp_bytes = static_cast<size_t>(warp_shared_bytes(n, m));
  int max_smem = 0, n_sm = 0, device = 0;
  // Staged: the fragments and the warps' state in shared memory; else the
  // fragments from L2 and the state in `scratch` (admm_scratch_bytes).
  const int staged = layout(n, m, &max_smem);
  if (staged < -1) return -staged - 1;
  if (staged < 0 || (!staged && scratch == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int n_warps = kMaxWarps;
  while (staged && n_warps > 2 &&
         block_shared_bytes(n, m, n_frag, n_warps, warp_bytes) > static_cast<size_t>(max_smem))
    --n_warps;
  const size_t smem = block_shared_bytes(n, m, staged ? n_frag : 0, staged ? n_warps : 0, warp_bytes);
  void (*kernel)(Problem, Lanes) = staged ? admm_kernel<true> : admm_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, n_warps * 32, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long need = (static_cast<long long>(B) + kSlots * n_warps - 1) / (kSlots * n_warps);
  const long long cap = static_cast<long long>(per_sm > 0 ? per_sm : 1) * n_sm;
  const int grid = static_cast<int>(need < cap ? need : cap);
  const Problem P{reinterpret_cast<const double2*>(Af), reinterpret_cast<const double2*>(Pf), q, rho, inv_rho, D,
                  D_inv, E, E_inv, sigma, alpha, one_minus_alpha, c_scale, q_ref, eps_abs, eps_rel, improve,
                  plateau_cap, feas_band, max_iter, K, stall_checks, n, m, rt_t, kc_t, rt_w, kc_w};
  const Lanes L{l, u, x0, y0, z0, Ax0, x_out, xw, yw, zw, Axw, iterations, r_prim, r_dual, converged, bounds_ok,
                feasible, next_lane, scratch, B};
  kernel<<<grid, n_warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(P, L);
  return static_cast<int>(cudaGetLastError());
}
