// Batched unpivoted Gauss-Jordan solve x = A^{-1} b for many tiny dense systems.
//
// Replaces the TPU kernel gym_anm_tpu/physics/linsolve_pallas.py:_gj_kernel
// (wrapped by solve_gauss_jordan_pallas), the linear solve of the exact
// Newton-Raphson load-flow fallback.  It computes what the plain version
// gym_anm_torch/physics/linsolve_cuda.py:solve_gauss_jordan computes:
// n rank-1 sweeps over the augmented [n, n+1] matrix, the pivot row's own
// factor zeroed by a multiply (so a non-finite factor stays non-finite), then
// x[i] = M[i][n] / M[i][i].  No pivoting and no repair of a zero pivot: a zero
// pivot gives inf/NaN, which the Newton loop reads as divergence, exactly
// like the reference.  A pivoted solve could converge a lane the reference
// marks diverged.  Every sweep updates all n + 1 columns, the eliminated ones
// too: an eliminated entry is a rounding residue, not exactly 0, and it moves
// the diagonal.  Products and differences are rounded one by one (mul_rn,
// sub_rn: no fused multiply-add), as the plain version rounds them, and each
// factor is an IEEE division, so every route is bitwise equal to it in
// float32 and in float64.  Two roundings per update keep the float64 work off
// the FP64 tensor cores (DMMA fuses the multiply and the subtract).
//
// Bound (B = 8192, n = 64, float32, H100 SXM): per system 64 sweeps of 64
// divides, 64 mask multiplies and 2 * 64 * 65 multiplies and subtracts, 0.54
// MFLOP, 4.43 GFLOP per call: 66 us at 67 TFLOP/s (FP32 outside the tensor
// cores).  Without fused multiply-adds each multiply and each subtract takes
// its own issue slot, so about 131 us is the floor of this arithmetic.  Device
// memory sees one read of A and b and one write of x, 138 MB: 41 us at 3.35
// TB/s.  So the kernel is bound by operations.  Float64 runs on the CUDA
// cores' 34 TFLOP/s: at n = 126 and B = 8192, 33.3 GFLOP, 0.98 ms.
//
// The wrapper (linsolve_cuda.py:k1_route) picks one of three routes by n,
// the type and the card's opt-in shared memory per block alone.
//
// Route "regs" (gj_regs, n <= 64 in both types): each row of a system lives
// in one thread's registers, all n + 1 columns (65 floats or doubles at n =
// 64: 166 registers a thread in float64, no spill), for all n sweeps.  A
// system takes one warp for n <= 32 (thread t owns row t) and two warps for
// 33..64 (warp h owns rows 32 h..32 h + 31); for n <= 16 a warp holds floor(32 / n) systems (3 at n =
// 10), so the ANM6 fallback does not leave most threads idle.  n is a
// template parameter and the sweeps are fully unrolled (one instantiation per
// sweep), so every register index is static.  In sweep k the owner of row k
// writes it to the system's pivot-row buffer in shared memory
// (double-buffered by k's parity, so one meeting per sweep orders writes and
// reads: __syncwarp, or a 64-thread named barrier for a two-warp system) and
// every thread of the system reads it back with 16-byte broadcast loads and
// computes its own row's factor.  There is no block barrier, and shared
// memory carries only the pivot row.  A warp loads its rows with coalesced
// 16-byte loads through a staging buffer in shared memory (row stride odd,
// so the row reads are free of bank conflicts in float32).  Sizes 33..64 run
// in a 48- or a 64-row body, padded with identity rows and columns: on finite
// inputs every padded operation is an exact identity, so the result is
// bitwise that of the unpadded solve.
//
// Routes "smem" and "blocked" (gj_panels): blocked Gauss-Jordan.  On route
// "smem" the augmented matrix is resident in the block's shared memory for
// the whole solve; on route "blocked" (a matrix too large for that) it lives
// in a device scratch buffer [B, n, n + 1] that the wrapper allocates.  One
// kernel body serves both, the matrix's home a template parameter.  The
// pivots go in panels of BP.  For the pivots k0 .. k0 + BP - 1 the block
// loads two panels into shared memory: the n x BP column panel and the BP x
// (n + 1) pivot-row panel.  Then:
//   1. One warp factors the panel's BP x BP diagonal block, lane r holding
//      row r of it (as the pivot-row panel has it) in registers: at pivot k
//      lane k writes its row, final now, to D[k]; each lane below computes
//      its factor F[k][r] (an IEEE division) and updates its row right of k
//      from row k (shuffles from lane k).
//   2. Every thread then runs, with no barrier between pivots, a row of the
//      column panel (in registers: its factor at each pivot from D[k], then
//      its later columns) or a column of the pivot-row panel (in registers:
//      its later rows from F[k]).  That leaves each row's factor
//      f_i(k) in the column panel and each pivot row p(k) as it stood at
//      sweep k in the row panel.
//   3. Every entry of the matrix is read once, takes its BP updates
//      M <- M - f_i(k) p_j(k) in k order, each rounded one by one, and is
//      written back once: the eliminated columns and the pivot rows too, as
//      the plain version updates all n + 1 columns of every row.  A warp's
//      unit is 32 columns x 4 rows, with the BP pivot-row entries of its
//      column in registers and four rows' factors of a pivot from one 16-byte
//      broadcast load.
// Each value in steps 1 and 2 is the plain version's value at that sweep
// (the diagonal block's entries take the same updates in the same order in
// its row view as in its column view), so every entry sees the same
// operations in the same order as in the plain version: bitwise equal in
// float32 and float64, and a zero pivot or a non-finite entry stays
// non-finite (tests/test_torch_blocked_gj.py emulates this order on the
// CPU).  The first panel reads A and b in place of the matrix's home, and the
// last panel updates only the diagonal and column n and writes x.  Three
// block barriers a panel, where the earlier one-block design took two a
// pivot and read and wrote the whole matrix in shared memory at each.  The grid is persistent (SMs x resident blocks by the occupancy
// query), a block walking over systems.
//
// Resident ("smem"): shared memory holds the matrix and the panels.  The
// wrapper takes this route while two such blocks fit an SM (float32 to n =
// 161, float64 to n = 111 on an H100), in panels of 8 or 16, whichever fits
// more blocks an SM (the wider on a tie): the panel steps cost BP^2 a thread
// a panel, the trailing update reads and writes the matrix n / BP times.  A
// block alone on an SM leaves it idle in each panel's serial steps (the
// diagonal block's chain of divisions, then the panel's rows), and the
// blocked route, two or more blocks an SM with the matrix in L2, beats it
// there (kernel_probes.py:probe_route_edges).  Blocked: the matrix crosses
// device memory once a panel, n / BP times (~35 GB a call at n = 258, BP =
// 32, float32: ~10 ms at 3.35 TB/s, less where the resident blocks'
// matrices stay in the 50 MB L2); BP is the first of 32, 16 and 8 (float32)
// or of 16 and 8 (float64) whose panels fit: float32 up to n = 875 at 32,
// 1,797 at 16 and 3,623 at 8; float64 up to n = 891 at 16 and 1,807 at 8.
// The launch bounds fix each panel kernel's registers (kPanMinBlocks).

#include "gauss_jordan.cuh"

// Panels of `panel` pivots (8 or 16), the matrix resident in shared memory.
extern "C" int gj_solve_f32_resident(const float* A, const float* b, float* x, int B, int n, int panel,
                                     void* stream) {
  return launch_panels<float, true>(A, b, x, nullptr, B, n, panel, stream);
}

// Panels of `panel` pivots (8, 16 or 32), the matrix in `scratch` [B, n, n + 1].
extern "C" int gj_solve_f32_blocked(const float* A, const float* b, float* x, float* scratch, int B, int n,
                                    int panel, void* stream) {
  return launch_panels<float, false>(A, b, x, scratch, B, n, panel, stream);
}

// The card's opt-in shared memory per block, bytes: the route function's
// third argument (linsolve_cuda.py:k1_route).
extern "C" int gj_smem_limit_bytes() { return max_smem_optin(); }
