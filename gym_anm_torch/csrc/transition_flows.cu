// K6: the transition's work after the load flow, one pass over each lane.
//
// Replaces no TPU kernel: the JAX package leaves this work
// (gym_anm_tpu/physics/transition.py, after the load flow) to XLA, which
// fuses it.  Eager PyTorch ran it as ~150 elementwise launches over [B, Ne]
// and [B, N] tensors, each reading and writing its operands in device memory.
// It computes what the plain version
// gym_anm_torch/physics/transition.py:transition_flows_plain computes, on the
// chord tier (float32):
//   the non-slack bus currents I = conj(S / V) with S = p + F_p + j(q + F_q)
//   (the solver's final mismatch F); the slack row's current from row 0 of the
//   nominal Y-bus, the products summed in float64 (as complexops.matmul_full
//   forms them) and rounded to float32, plus the lane's dY terms; the measured
//   slack injection (NaN -> +inf) written into the slack columns of bus_p,
//   bus_q, dev_p and dev_q; the nine branch arrays of branch_flows
//   (sign(p_from) * max(|s_from|, |s_to|) for s_signed); e_loss with the
//   renewables' curtailment; the voltage and rate penalties; the reward.
//
// Bound (H100 SXM, HBM at 3.35 TB/s): a lane reads V (2N), F (2(N-1)), p and
// q of the non-slack buses (2(N-1)), its tap and dY terms, its device
// injections (n_dev) and the generators' potentials, and writes the bus
// currents (2N), four slack entries, 9 Ne branch values and three scalars:
// ~640 float32 values, ~2.5 KB, at IEEE33 (N = 33, Ne = 37).  About 60
// float32 operations a branch and 20 a bus: ~0.2 operations a byte, far below
// the card's ~20, so the bytes bound it (0.2 ms at 262,144 lanes).
//
// Design: every byte moved once, coalesced, and the loads kept in flight
// while the card computes.  A block of 512 threads takes tiles of L lanes
// (L from N, Ne, n_dev and n_gen at launch, a multiple of 4 where a tile
// holds 4 or more: 32 at IEEE33 and multicap17, fewer on larger feeders, at
// least one), two blocks an SM, and the grid is persistent (the tiles dealt
// round the resident blocks).  A block reads the network's static rows
// into shared memory once.  A tile's inputs (V, F, p, q, dev_p, p_pot, the dY
// terms and the tap) are contiguous rows in device memory; they are copied
// into one of two shared-memory buffers with cp.async (16 bytes a thread
// where aligned), the next tile's while the block computes this one (step
// 1).  Then:
//   2. threads walk the flat (lane, bus) index: the non-slack currents,
//      written in row order, and each bus's voltage penalty into shared
//      memory; then the flat (lane, branch) index: the nine branch values,
//      written in row order (a warp's stores are contiguous), and each
//      branch's rate penalty into shared memory;
//   3. one thread a lane sums the lane's terms in a fixed order: the slack
//      row's products (float64), the slack injection and its four scattered
//      stores, e_loss and the two penalties (float64 sums, rounded once), the
//      reward.  No atomics: a run repeats bit for bit.
// (Measured on an H100 at 262,144 IEEE33 lanes, one call: 0.57 ms with the
// inputs read by the computing threads, 0.44 with this double buffer at 256
// threads, 0.38 at 512 threads and two blocks an SM; four running sums a
// lane in step 3 cost 0.06 ms more.)
// Every elementwise product, sum, difference, quotient and square root is
// rounded as the torch op is (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn,
// __fsqrt_rn: nothing contracted into a multiply-add), and clamp, maximum and
// sign treat NaN as torch does, so every elementwise output is the plain
// version's bits.  The values that follow a reduction (the slack current and
// injection, e_loss, penalty, reward) are summed in another order than
// cuBLAS's and torch.sum's, in float64, and agree within a few float32 ulps
// of the sum of their terms' magnitudes.

#include <cuda_runtime.h>
#include <math.h>

#include <mutex>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxTileLanes = 128;
constexpr int kLaneBytes = 72 * 1024;        // shared memory for a tile's lanes: 2 blocks an SM
constexpr int kMaxStaticBytes = 160 * 1024;  // the static rows (a 513-bus feeder takes ~40 KB)

struct Params {
  const float *v_re, *v_im, *F, *p_ns, *q_ns;
  const float* dy[4];               // dff_re, dff_im, dft_re, dft_im [B]
  const float* tap;                 // [B], the OLTC's tap, null without one
  const long long* oltc_branch;     // [1], null without an OLTC
  const float *p_pot, *rates;       // [B, G]; [Ne] or [B, Ne]
  const long long *br_f, *br_t;
  const float *series_re, *series_im, *shunt_im, *shift_cos, *shift_sin, *tap0;
  const float *y0_re, *y0_im, *v_min, *v_max;
  const long long *genload, *gen_pos;
  const float* rer_mask;
  float *bus_p, *bus_q, *dev_p, *dev_q;
  float *i_re, *i_im;
  float *ifr, *ifi, *itr, *iti, *p_from, *q_from, *p_to, *q_to, *s_signed;
  float *e_loss, *penalty, *reward;
  float delta_t, lamb;
  int rates_per_lane, B, N, Ne, n_dev, K, G, t_bus, slack_bus, slack_dev;
  int L;  // lanes a tile
};

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }  // 16-byte aligned array starts

// Shared memory, in floats: the static rows; two buffers of a tile's inputs
// (V, F, p, q, dev_p, p_pot, the dY terms and the tap, each row-major as in
// device memory); the tile's voltage and rate penalty terms.
struct Layout {
  int L, in_floats, static_floats, tile_floats;
};

__host__ __device__ inline int static_floats(int N, int Ne, int K, int G) {
  return pad4(9 * Ne + 4 * N + K + 2 * G);
}

__host__ __device__ inline int input_floats(int L, int N, int n_dev, int G) {
  const int n = N - 1;
  return 2 * pad4(L * N) + pad4(L * 2 * n) + 2 * pad4(L * n) + pad4(L * n_dev) + pad4(L * G) + 5 * pad4(L);
}

Layout layout(int N, int Ne, int n_dev, int K, int G) {
  const int n = N - 1;
  const long long lane = 4LL * (2 * (2 * N + 4 * n + n_dev + G + 5) + N + Ne);
  long long L = kLaneBytes / lane;
  L = L > kMaxTileLanes ? kMaxTileLanes : L;
  L = L >= 4 ? L & ~3LL : (L < 1 ? 1 : L);  // whole 16-byte groups of lanes for the per-lane rows
  Layout s;
  s.L = static_cast<int>(L);
  s.in_floats = input_floats(s.L, N, n_dev, G);
  s.static_floats = static_floats(N, Ne, K, G);
  s.tile_floats = 2 * s.in_floats + pad4(s.L * N) + pad4(s.L * Ne);
  return s;
}

// torch.clamp(x, min=0): NaN stays NaN.
__device__ inline float clamp0(float x) { return x != x ? x : fmaxf(x, 0.0f); }
// torch.maximum: NaN if either is NaN.
__device__ inline float nan_max(float a, float b) { return a != a ? a : (b != b ? b : fmaxf(a, b)); }
// torch.sign: (0 < x) - (x < 0), so 0 for zeros and NaN.
__device__ inline float sign_of(float x) { return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f); }

__device__ inline void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ inline void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ inline void cp_async_wait_prior() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// Start copying `count` contiguous floats from device memory into shared
// memory (dst 16-byte aligned): 16 bytes a thread where src is aligned.
__device__ inline void copy_async(float* dst, const float* src, int count) {
  int k = threadIdx.x;
  if ((reinterpret_cast<unsigned long long>(src) & 15) == 0) {
    const int n4 = count >> 2;
    for (; k < n4; k += kThreads) cp_async16(dst + 4 * k, src + 4 * k);
    k = 4 * n4 + threadIdx.x;
  }
  for (; k < count; k += kThreads) cp_async4(dst + k, src + k);
}

// One buffer of a tile's inputs.
struct Tile {
  float *vre, *vim, *F, *p, *q, *devp, *ppot, *dy[4], *tap;
};

__device__ inline Tile tile_at(float* base, int L, int N, int n_dev, int G) {
  const int n = N - 1;
  Tile t;
  t.vre = base;
  t.vim = t.vre + pad4(L * N);
  t.F = t.vim + pad4(L * N);
  t.p = t.F + pad4(L * 2 * n);
  t.q = t.p + pad4(L * n);
  t.devp = t.q + pad4(L * n);
  t.ppot = t.devp + pad4(L * n_dev);
  t.dy[0] = t.ppot + pad4(L * G);
  for (int j = 1; j < 4; ++j) t.dy[j] = t.dy[j - 1] + pad4(L);
  t.tap = t.dy[3] + pad4(L);
  return t;
}

__device__ inline void load_tile(const Tile& t, const Params& P, long long lane0, int lanes) {
  const int N = P.N, n = N - 1;
  copy_async(t.vre, P.v_re + lane0 * N, lanes * N);
  copy_async(t.vim, P.v_im + lane0 * N, lanes * N);
  copy_async(t.F, P.F + lane0 * 2 * n, lanes * 2 * n);
  copy_async(t.p, P.p_ns + lane0 * n, lanes * n);
  copy_async(t.q, P.q_ns + lane0 * n, lanes * n);
  copy_async(t.devp, P.dev_p + lane0 * P.n_dev, lanes * P.n_dev);
  if (P.G > 0) copy_async(t.ppot, P.p_pot + lane0 * P.G, lanes * P.G);
  for (int j = 0; j < 4; ++j) copy_async(t.dy[j], P.dy[j] + lane0, lanes);
  if (P.tap != nullptr) copy_async(t.tap, P.tap + lane0, lanes);
}

__global__ void __launch_bounds__(kThreads, 2) flows_kernel(const Params P) {
  extern __shared__ __align__(16) float smem[];
  const int N = P.N, Ne = P.Ne, n = P.N - 1, L = P.L;
  // static rows
  int* s_f = reinterpret_cast<int*>(smem);
  int* s_t = s_f + Ne;
  float* s_sre = reinterpret_cast<float*>(s_t + Ne);
  float* s_sim = s_sre + Ne;
  float* s_totim = s_sim + Ne;
  float* s_cos = s_totim + Ne;
  float* s_sin = s_cos + Ne;
  float* s_tap0 = s_sin + Ne;
  float* s_rate = s_tap0 + Ne;
  float* s_y0r = s_rate + Ne;
  float* s_y0i = s_y0r + N;
  float* s_vmin = s_y0i + N;
  float* s_vmax = s_vmin + N;
  int* s_gl = reinterpret_cast<int*>(s_vmax + N);
  int* s_gp = s_gl + P.K;
  float* s_rer = reinterpret_cast<float*>(s_gp + P.G);
  // two input buffers, then the tile's penalty terms
  float* buf0 = smem + static_floats(N, Ne, P.K, P.G);
  const int in_floats = input_floats(L, N, P.n_dev, P.G);
  float* t_vpen = buf0 + 2 * in_floats;
  float* t_rpen = t_vpen + pad4(L * N);

  for (int e = threadIdx.x; e < Ne; e += kThreads) {
    s_f[e] = static_cast<int>(P.br_f[e]);
    s_t[e] = static_cast<int>(P.br_t[e]);
    s_sre[e] = P.series_re[e];
    s_sim[e] = P.series_im[e];
    s_totim[e] = __fadd_rn(P.series_im[e], P.shunt_im[e]);
    s_cos[e] = P.shift_cos[e];
    s_sin[e] = P.shift_sin[e];
    s_tap0[e] = P.tap0[e];
    s_rate[e] = P.rates_per_lane ? 0.0f : P.rates[e];
  }
  for (int b = threadIdx.x; b < N; b += kThreads) {
    s_y0r[b] = P.y0_re[b];
    s_y0i[b] = P.y0_im[b];
    s_vmin[b] = P.v_min[b];
    s_vmax[b] = P.v_max[b];
  }
  for (int k = threadIdx.x; k < P.K; k += kThreads) s_gl[k] = static_cast<int>(P.genload[k]);
  for (int g = threadIdx.x; g < P.G; g += kThreads) {
    s_gp[g] = static_cast<int>(P.gen_pos[g]);
    s_rer[g] = P.rer_mask[g];
  }
  const int oltc_e = P.oltc_branch != nullptr ? static_cast<int>(P.oltc_branch[0]) : -1;

  const long long n_tiles = (static_cast<long long>(P.B) + L - 1) / L;
  auto lanes_of = [&](long long tile) {
    const long long left = P.B - tile * L;
    return static_cast<int>(left < L ? left : L);
  };
  if (blockIdx.x < n_tiles) load_tile(tile_at(buf0, L, N, P.n_dev, P.G), P, blockIdx.x * L, lanes_of(blockIdx.x));
  cp_async_commit();
  int which = 0;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, which ^= 1) {
    const long long lane0 = tile * L;
    const int lanes = lanes_of(tile);
    // The next tile's inputs stream in while this one is computed; the
    // barrier at the end of the previous tile freed their buffer.
    const long long next = tile + gridDim.x;
    if (next < n_tiles) load_tile(tile_at(buf0 + (which ^ 1) * in_floats, L, N, P.n_dev, P.G), P, next * L,
                                  lanes_of(next));
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();  // this tile's inputs (and, the first time, the static rows) are in shared memory
    const Tile t = tile_at(buf0 + which * in_floats, L, N, P.n_dev, P.G);

    // 2a. (lane, bus): the non-slack currents and the voltage penalties.
    for (int k = threadIdx.x; k < lanes * N; k += kThreads) {
      const int r = k / N, b = k - r * N;
      const float vr = t.vre[k], vi = t.vim[k];
      const float vmag2 = __fadd_rn(__fmul_rn(vr, vr), __fmul_rn(vi, vi));
      const float vm = __fsqrt_rn(vmag2);
      t_vpen[k] = __fadd_rn(clamp0(__fsub_rn(vm, s_vmax[b])), clamp0(__fsub_rn(s_vmin[b], vm)));
      if (b > 0) {
        const int pq = r * n + (b - 1), f = r * 2 * n + (b - 1);
        const float s_re = __fadd_rn(t.p[pq], t.F[f]);
        const float s_im = __fadd_rn(t.q[pq], t.F[f + n]);
        const long long o = lane0 * N + k;
        P.i_re[o] = __fdiv_rn(__fadd_rn(__fmul_rn(s_re, vr), __fmul_rn(s_im, vi)), vmag2);
        P.i_im[o] = __fdiv_rn(-__fsub_rn(__fmul_rn(s_im, vr), __fmul_rn(s_re, vi)), vmag2);
      }
    }

    // 2b. (lane, branch): branch_flows and the rate penalties.
    for (int k = threadIdx.x; k < lanes * Ne; k += kThreads) {
      const int r = k / Ne, e = k - r * Ne;
      const float* vre = t.vre + r * N;
      const float* vim = t.vim + r * N;
      const float vf_re = vre[s_f[e]], vf_im = vim[s_f[e]];
      const float vt_re = vre[s_t[e]], vt_im = vim[s_t[e]];
      const float tap = e == oltc_e ? t.tap[r] : s_tap0[e];
      const float tap_re = __fmul_rn(tap, s_cos[e]), tap_im = __fmul_rn(tap, s_sin[e]);
      const float a2 = __fmul_rn(tap, tap);
      const float sre = s_sre[e], sim = s_sim[e], tot_re = sre, tot_im = s_totim[e];

      const float t1_re = __fdiv_rn(__fsub_rn(__fmul_rn(tot_re, vf_re), __fmul_rn(tot_im, vf_im)), a2);
      const float t1_im = __fdiv_rn(__fadd_rn(__fmul_rn(tot_re, vf_im), __fmul_rn(tot_im, vf_re)), a2);
      const float vtc_re = __fdiv_rn(__fsub_rn(__fmul_rn(vt_re, tap_re), __fmul_rn(vt_im, tap_im)), a2);
      const float vtc_im = __fdiv_rn(__fadd_rn(__fmul_rn(vt_im, tap_re), __fmul_rn(vt_re, tap_im)), a2);
      const float t2_re = __fsub_rn(__fmul_rn(sre, vtc_re), __fmul_rn(sim, vtc_im));
      const float t2_im = __fadd_rn(__fmul_rn(sre, vtc_im), __fmul_rn(sim, vtc_re));
      const float if_re = __fsub_rn(t1_re, t2_re), if_im = __fsub_rn(t1_im, t2_im);

      const float t3_re = __fsub_rn(__fmul_rn(tot_re, vt_re), __fmul_rn(tot_im, vt_im));
      const float t3_im = __fadd_rn(__fmul_rn(tot_re, vt_im), __fmul_rn(tot_im, vt_re));
      const float vft_re = __fdiv_rn(__fadd_rn(__fmul_rn(vf_re, tap_re), __fmul_rn(vf_im, tap_im)), a2);
      const float vft_im = __fdiv_rn(__fsub_rn(__fmul_rn(vf_im, tap_re), __fmul_rn(vf_re, tap_im)), a2);
      const float t4_re = __fsub_rn(__fmul_rn(sre, vft_re), __fmul_rn(sim, vft_im));
      const float t4_im = __fadd_rn(__fmul_rn(sre, vft_im), __fmul_rn(sim, vft_re));
      const float it_re = __fsub_rn(t3_re, t4_re), it_im = __fsub_rn(t3_im, t4_im);

      const float pf = __fadd_rn(__fmul_rn(vf_re, if_re), __fmul_rn(vf_im, if_im));
      const float qf = __fsub_rn(__fmul_rn(vf_im, if_re), __fmul_rn(vf_re, if_im));
      const float pt = __fadd_rn(__fmul_rn(vt_re, it_re), __fmul_rn(vt_im, it_im));
      const float qt = __fsub_rn(__fmul_rn(vt_im, it_re), __fmul_rn(vt_re, it_im));
      const float s_from = __fsqrt_rn(__fadd_rn(__fmul_rn(pf, pf), __fmul_rn(qf, qf)));
      const float s_to = __fsqrt_rn(__fadd_rn(__fmul_rn(pt, pt), __fmul_rn(qt, qt)));
      const float ss = __fmul_rn(sign_of(pf), nan_max(s_from, s_to));

      const long long o = lane0 * Ne + k;
      P.ifr[o] = if_re;
      P.ifi[o] = if_im;
      P.itr[o] = it_re;
      P.iti[o] = it_im;
      P.p_from[o] = pf;
      P.q_from[o] = qf;
      P.p_to[o] = pt;
      P.q_to[o] = qt;
      P.s_signed[o] = ss;
      const float rate = P.rates_per_lane ? __ldg(P.rates + o) : s_rate[e];
      t_rpen[k] = clamp0(__fsub_rn(fabsf(ss), rate));
    }
    __syncthreads();

    // 3. A thread a lane: the slack row, the slack injection, e_loss, the
    //    penalties and the reward.
    for (int r = threadIdx.x; r < lanes; r += kThreads) {
      const long long lane = lane0 + r;
      const float* vre = t.vre + r * N;
      const float* vim = t.vim + r * N;
      double rr = 0.0, ii = 0.0, ri = 0.0, ir = 0.0;  // sum v_re y0r, v_im y0i, v_re y0i, v_im y0r
      for (int b = 0; b < N; ++b) {
        const double vr = vre[b], vi = vim[b], yr = s_y0r[b], yi = s_y0i[b];
        rr = fma(vr, yr, rr);  // the float32 products are exact in float64
        ii = fma(vi, yi, ii);
        ri = fma(vr, yi, ri);
        ir = fma(vi, yr, ir);
      }
      float i0_re = __fsub_rn(static_cast<float>(rr), static_cast<float>(ii));
      float i0_im = __fadd_rn(static_cast<float>(ri), static_cast<float>(ir));
      const float dff_re = t.dy[0][r], dff_im = t.dy[1][r], dft_re = t.dy[2][r], dft_im = t.dy[3][r];
      const float vt_re = vre[P.t_bus], vt_im = vim[P.t_bus];
      i0_re = __fsub_rn(__fadd_rn(__fadd_rn(i0_re, dff_re), __fmul_rn(dft_re, vt_re)), __fmul_rn(dft_im, vt_im));
      i0_im = __fadd_rn(__fadd_rn(__fadd_rn(i0_im, dff_im), __fmul_rn(dft_re, vt_im)), __fmul_rn(dft_im, vt_re));
      P.i_re[lane * N] = i0_re;
      P.i_im[lane * N] = i0_im;

      float sl_re = __fadd_rn(__fmul_rn(vre[0], i0_re), __fmul_rn(vim[0], i0_im));
      float sl_im = __fsub_rn(__fmul_rn(vim[0], i0_re), __fmul_rn(vre[0], i0_im));
      if (sl_re != sl_re) sl_re = INFINITY;
      if (sl_im != sl_im) sl_im = INFINITY;
      P.bus_p[lane * N + P.slack_bus] = sl_re;
      P.bus_q[lane * N + P.slack_bus] = sl_im;
      P.dev_p[lane * P.n_dev + P.slack_dev] = sl_re;
      P.dev_q[lane * P.n_dev + P.slack_dev] = sl_im;

      const float* devp = t.devp + r * P.n_dev;
      double acc = 0.0;
      for (int k = 0; k < P.K; ++k) acc += s_gl[k] == P.slack_dev ? sl_re : devp[s_gl[k]];
      float el = static_cast<float>(acc);
      if (P.G > 0) {
        const float* ppot = t.ppot + r * P.G;
        double cur = 0.0;
        for (int g = 0; g < P.G; ++g) cur += __fmul_rn(clamp0(__fsub_rn(ppot[g], devp[s_gp[g]])), s_rer[g]);
        el = __fadd_rn(el, static_cast<float>(cur));
      }
      el = __fmul_rn(el, P.delta_t);

      const float* vpen = t_vpen + r * N;
      const float* rpen = t_rpen + r * Ne;
      double pv = 0.0, pr = 0.0;
      for (int b = 0; b < N; ++b) pv += vpen[b];
      for (int e = 0; e < Ne; ++e) pr += rpen[e];
      float pen = __fadd_rn(static_cast<float>(pv), static_cast<float>(pr));
      pen = __fmul_rn(__fmul_rn(pen, P.delta_t), P.lamb);

      P.e_loss[lane] = el;
      P.penalty[lane] = pen;
      P.reward[lane] = -__fadd_rn(el, pen);
    }
    __syncthreads();  // the buffer and the penalty terms are free for the next tile
  }
}

// A network's launch on one device: the shared memory it asks for and the
// blocks the card keeps resident.  Set up at the network's first launch on
// the device and read at every later one; the kernel's shared-memory limit
// only ever rises, so a plan made earlier stays valid.
struct Plan {
  int device, N, Ne, n_dev, K, G, smem;
  long long cap;
};
constexpr int kPlans = 16;
constexpr int kMaxDevices = 64;
Plan g_plans[kPlans];
int g_n_plans = 0, g_next_plan = 0;
int g_smem_limit[kMaxDevices] = {};
std::mutex g_plans_mutex;

cudaError_t plan_for(int N, int Ne, int n_dev, int K, int G, Plan* out) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_plans_mutex);
  for (int i = 0; i < g_n_plans; ++i) {
    const Plan& p = g_plans[i];
    if (p.device == device && p.N == N && p.Ne == Ne && p.n_dev == n_dev && p.K == K && p.G == G) {
      *out = p;
      return cudaSuccess;
    }
  }
  const Layout s = layout(N, Ne, n_dev, K, G);
  Plan p{device, N, Ne, n_dev, K, G, 4 * (s.static_floats + s.tile_floats), 0};
  int n_sm = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (p.smem > 48 * 1024 && p.smem > g_smem_limit[device]) {
    err = cudaFuncSetAttribute(flows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
    g_smem_limit[device] = p.smem;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flows_kernel, kThreads, p.smem);
  if (err != cudaSuccess) return err;
  p.cap = static_cast<long long>(per_sm > 0 ? per_sm : 1) * n_sm;
  g_plans[g_next_plan] = p;
  g_next_plan = (g_next_plan + 1) % kPlans;
  if (g_n_plans < kPlans) ++g_n_plans;
  *out = p;
  return cudaSuccess;
}

}  // namespace

// (lane inputs, static rows, in-place columns, outputs, scalars, sizes, stream);
// returns a cudaError_t.
extern "C" int transition_flows_f32(
    const float* v_re, const float* v_im, const float* F, const float* p_ns, const float* q_ns,
    const float* dff_re, const float* dff_im, const float* dft_re, const float* dft_im, const float* tap,
    const long long* oltc_branch, const float* p_pot, const float* rates,
    const long long* br_f, const long long* br_t, const float* series_re, const float* series_im,
    const float* shunt_im, const float* shift_cos, const float* shift_sin, const float* tap0,
    const float* y0_re, const float* y0_im, const float* v_min, const float* v_max,
    const long long* genload, const long long* gen_pos, const float* rer_mask,
    float* bus_p, float* bus_q, float* dev_p, float* dev_q, float* i_re, float* i_im,
    float* ifr, float* ifi, float* itr, float* iti, float* p_from, float* q_from, float* p_to, float* q_to,
    float* s_signed, float* e_loss, float* penalty, float* reward, float delta_t, float lamb,
    int rates_per_lane, int B, int N, int Ne, int n_dev, int K, int G, int t_bus, int slack_bus, int slack_dev,
    void* stream) {
  if (B <= 0 || N < 2 || Ne <= 0 || n_dev <= 0 || K < 0 || G < 0 || t_bus < 0 || t_bus >= N || slack_bus < 0 ||
      slack_bus >= N || slack_dev < 0 || slack_dev >= n_dev)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout s = layout(N, Ne, n_dev, K, G);
  if (4LL * s.static_floats > kMaxStaticBytes) return static_cast<int>(cudaErrorInvalidValue);
  const Params P{v_re, v_im, F, p_ns, q_ns, {dff_re, dff_im, dft_re, dft_im}, tap, oltc_branch, p_pot, rates,
                 br_f, br_t, series_re, series_im, shunt_im, shift_cos, shift_sin, tap0, y0_re, y0_im, v_min, v_max,
                 genload, gen_pos, rer_mask, bus_p, bus_q, dev_p, dev_q, i_re, i_im, ifr, ifi, itr, iti, p_from,
                 q_from, p_to, q_to, s_signed, e_loss, penalty, reward, delta_t, lamb, rates_per_lane, B, N, Ne,
                 n_dev, K, G, t_bus, slack_bus, slack_dev, s.L};
  Plan plan;
  const cudaError_t err = plan_for(N, Ne, n_dev, K, G, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long need = (static_cast<long long>(B) + s.L - 1) / s.L;
  const int grid = static_cast<int>(need < plan.cap ? need : plan.cap);
  flows_kernel<<<grid, kThreads, plan.smem, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}
