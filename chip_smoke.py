#!/usr/bin/env python3
"""Drive the gym_anm_torch port once on one CUDA card, end to end.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``gym_anm_torch/csrc`` with nvcc
(one process per source, in parallel), then runs these phases and exits
non-zero at the first failure:

1. the Gauss-Jordan kernel (K1) against its plain PyTorch version on the
   card: its register route bitwise in f32 and f64, n = 64 at B = 8192 and
   n = 10 at a ragged B = 1001, and a zero-pivot lane that must stay
   non-finite in both; times of the kernel, of the plain version and of
   ``torch.linalg.solve_ex`` (the yardstick; the port never calls it), and
   the kernel's bound;
1b. the chord-Newton kernel (K2) against its plain version at B = 8192 on
   these input sets: base IEEE33 constants from flat and from warm starts,
   the multicap constants at their nominal-load point under diurnal loads,
   the bad-basin guesses, and ANM6Easy (n = 5) at the injections of a real
   step from the flat start, from the step's warm starts (collapsing lanes
   among them) and from the bad-basin guesses; times of both and the
   kernel's bound from the set's iteration count; then the warm starts'
   first 1 and 1001 lanes, checked and timed the same way (the 8-slot
   route at n = 32, where B = 8192 takes the 16-slot one), each set failing
   unless its launch took the route the wrapper's rule gives it;
2. the base path: the base IEEE33 ``VecEnv`` at float32, reset at B = 8192
   and 128 steps of uniform-random actions, then one step from warm starts
   in a bad basin (a restored state whose guesses are far off), which sends
   every lane through the Newton fallback, K3, and K1's solves inside it.
   Outputs are finite, residuals within 1e-4, no lane terminates, K2 and K3
   launch and K3 runs Newton iterations, and the first 8 steps of 256 lanes
   match the port's float64 rollout on the CPU;
3. the chord solve and the Newton fallback called directly on bad-basin
   inputs tiled to B = 8192: every lane ends stable, K3 launches once, and
   the voltages match the same call on the CPU (plain loop);
3b. the exact-Newton kernel (K3) against its plain version
   (``power_flow._newton_loop`` with the plain Gauss-Jordan solve) on the
   card: (a) IEEE33 float32 after the chord from the bad-basin guesses, every
   lane unaccepted, random taps; (b) ANM6Easy float32 (n = 10) at a real
   step's fallback inputs; (c) IEEE33 and ANM6 float64 from the flat start
   with a dense Y (nr_solve's route), B = 8192 and B = 1; (d) a batch with no
   unaccepted lane (the launch's own time); (e) a ragged B = 1001 with a
   zero-pivot lane (non-finite in both); (f) the tail: one lane of (a) among
   (d)'s accepted ones: stable and converged equal on every lane, n_iter on
   >= 99.5%, stable lanes' x within 1e-5 (float32) / 1e-10 (float64), the
   bitwise-equal share, times of the kernel and of the plain version, the
   lanes that iterate (the 64-row body takes 4 threads a row where they fit the
   card at once at that width, else 2), the slowest lane's iterations and
   µs an iteration, and the bound;
4. TF32 allowed globally changes no step output, bit for bit;
5. the multicap17 path: ``make_ieee33_multicap_task`` at float32, reset at
   B = 8192, 128 steps of uniform-random 17-dim actions through
   ``step_autoreset_batch``, halfway through from bad-basin warm starts and
   with 64 lanes already terminated: outputs finite, live lanes' residuals
   within 1e-4, reset lanes back at t = 0, K2 and K3 launched; the first 8
   steps of 256 lanes replayed through the port's float64 transition on the
   CPU;
6. times: env-steps/s of the base path at B = 8192 and 32768 and of the
   multicap17 path at B = 8192 (128 steps, median of 5 reps, CUDA events),
   chord iterations per step; a torch.profiler window of 16 steps of each
   for the device's busy time per step and K2's share of it;
7. the L0-L5 collection path (``bench.py`` workload 3): the block collector
   over ``make_suite`` on multicap17 at float32, B = 8192, 64 steps, every
   controller's ``act`` under ``torch.cuda.set_sync_debug_mode("error")``:
   trajectories [64, 8192, ...] finite, actions in the box, L1's caps at 0
   and tap at 1, L5's taps on their positions, K2 launched; the per-
   controller mean rewards (an informed controller beats L0); the first 8
   steps of 256 lanes from all six blocks replayed through the float64
   transition on the CPU and the same controllers run on the CPU from the
   card's states and carries (the same discrete decisions); the collector's
   env-steps/s beside phase 6's bare multicap17 rate, split into controllers
   and env step, its GPU ops and host syncs per step, and what the lane
   mean in the reference's summation order costs;
8. ANM6Easy at float32, B = 8192, 96 steps (one day) of uniform-random
   actions through ``step_autoreset_batch`` with an observation plan of
   every state variable in its non-default unit, halfway through from
   bad-basin warm starts and with 64 lanes terminated: K2 (n = 5) and K3
   (n = 10) launched, outputs finite, live residuals within 1e-4, reset
   lanes at t = 0 with a time index in [0, 96), the entries the clip to the
   plan's bounds moved; the first 8 steps of 256 lanes replayed through the
   float64 step on the CPU, before the clip, with per-entry tolerances from
   the load flow's accuracy and the entry's sensitivity to the voltages, and
   two controls that must fail them; its env-steps/s, the share of a step
   spent in the Newton fallback (K3) and K3's device time a step;
9. the MPC farm (``bench.py`` workload 4) and its ADMM kernel K5:
   9a. K5 against its plain version at B = 8192 on the LPs of ANM6Easy reset
   states (N = 1 cold at max_iter 4000, the same lanes warm from their own
   solutions, N = 4 perfect forecast cold), IEEE33-renewable N = 1 cold, and
   1% of the lanes with a crossed bound row: flags equal on every lane,
   iterations on >= 99.5%, x within 1e-5; times of both and the bound;
   then K5 on each side of its launch plan (staged: the farm's call;
   streamed: ANM6Easy N = 4 and N = 8, IEEE33-renewable N = 1): the plan
   equal to ``admm_cuda.stream_lanes``, the kernel's time and its share of
   the bound, the N = 8 set against the plain version;
   9b. 64 lanes of the N = 1 cold set against scipy's HiGHS: objective within
   1e-3 relative and the stage-0 action within 2e-2 MW of the LP's optimal
   face on the lanes that exited by the strict rule;
   9c. ``make_vec_mpc`` (N = 1, budget 48) driving ANM6Easy at float32, B =
   8192, 64 steps of ``step_autoreset_batch``, every ``act`` under
   ``torch.cuda.set_sync_debug_mode("error")``: one K5 launch per step, mean
   reward at an informed controller's level; env-steps/s, the share of the
   step inside ``act``, K5 µs per step, ADMM iterations, the converged
   share, the device's idle share, GPU ops and host syncs per step;
   9d. the farm's first 8 steps of 64 lanes replayed at float64 on the CPU
   from the card's states and warm carries: actions within 2e-2 MW;
10. networks above 33 buses: random radial feeders of 48, 64 and 130 buses
   (``gym_anm_torch.networks.random_feeder``) at B = 8192: the wide chord
   kernel against its plain version from flat, warm and bad-basin starts,
   and timed; K1's blocked route at n = 258 (bitwise in float32 and
   float64) timed beside ``torch.linalg.solve_ex``; K1's routes bitwise at
   both sides of each route edge and at float32 n = 94, 126 and float64
   n = 64, 126, the latter timed beside the blocked route in device memory
   and ``solve_ex``; each feeder's float32 ``VecEnv`` for 5 steps, the last
   from bad-basin warm starts (the Newton fallback: K3 wide, resident in
   shared memory at 48 and 64 buses, its [J | F] in device memory at 130),
   every step under ``set_sync_debug_mode("error")``, no standalone K1
   launch, the bad-basin step's peak device memory, held against the
   float64 tier on the card (K3 wide too); then K3 wide against its plain version on each feeder's
   sets: (a) the bad-basin step's fallback inputs (float32, B = 8192, the
   LaneYbus), (c) float64 from the flat start with a dense Y at B = 1001 and
   B = 1, (d) no lane iterating, (f) one lane of (a) among accepted ones:
   every lane bitwise, times of the kernel and of the host loop around K1
   that the card ran before it (``_newton_loop`` with ``batched_solve``, a
   sync an iteration; its peak memory on (a)), the bound;
11. PPO through ``gym_anm_torch.scripts.train_ppo_online.main``, every
   update under ``torch.cuda.set_sync_debug_mode("error")``:
   11a. base IEEE33 at B = 8192, rollout 16, 10 iterations: env-steps/s of
   the train loop, the split of an iteration between rollout and update
   (CUDA events), the device's idle share over a torch.profiler window of 2
   iterations, GPU ops and host syncs of the rollout and of the update (0);
   then a short run without a process group and under nccl at world size 1,
   bitwise equal;
   11b. the multicap17 run of ``docs/distributed.md:52-55`` (B = 4096,
   rollout 16, 2 epochs × 2 × 2 minibatches, hidden 64) for 150 iterations:
   every loss and reward finite, the mean reward of iterations 140-149 above
   that of 0-9, the reward trajectory, the deterministic policy against
   random (256 lanes × 50 steps without autoreset), the saved TrainState
   restored bit for bit, and one update of the card against the CPU at
   float64 from the card's trajectory and parameters (within 1e-10);
12. CQL through ``gym_anm_torch.scripts.train_cql_offline.main``
   (``docs/distributed.md:79-83``): the L0-L5 dataset on multicap17 (512
   lanes × 50 steps × 6 controllers), 3000 updates of 512 under
   ``set_sync_debug_mode("error")``, updates/s, the final loss and Bellman
   error, the deterministic policy against random and L5 (256 lanes × 50
   steps without autoreset; CQL above random), and one update of the card
   against the CPU at float64 (within 1e-10).

13. the compat tier's ``Simulator`` (float64, one lane) on the card: 96
   steps of ANM6 (ANM6Easy's daily profiles, uniform set-points) and of
   IEEE33 (diurnal loads with 2% noise, uniform capacitor and tap
   set-points) through ``Simulator(device="cuda")`` and the same sequence
   through ``Simulator(device="cpu")``: equal ``pfe_converged`` flags, bus
   voltages, device P/Q, branch flows, reward, e_loss and penalty within
   1e-8, K3 launched with nr_solve's dense Y (float64, B = 1, n = 10 and
   64); ms per transition on both devices, GPU ops and host syncs of one
   beside PR 10's (before K3); K1 at B = 1, n = 64 and 10, float64, timed
   beside ``torch.linalg.solve_ex`` and its bound.
14. the host tier over the compat environments on the card (float64, one
   lane; ``gym_anm_torch.compat`` through gymnasium, or where the machine
   lacks it through this script's stand-in module: ``Env``, ``spaces.Box``,
   ``envs.registration``, no physics and no controller logic; the line
   ``14 gymnasium:`` says which):
   14a. every controller hierarchy of ``gym_anm_torch.agents`` on the
   environment its test uses (Corrected L0-L5 and the algorithmic and
   experimental sets on ``IEEE33RenewableEnv``, the multi-capacitor
   controllers on ``IEEE33MultiCapacitorEnv``, ``L5_EnhancedSwitchingAware``
   on ``IEEE33UnequalCapacitorsEnv``, the diversity and ready sets on
   ``IEEE33ProperEnvironment(load_scale=0.9)``), a fresh pair of
   environments each, for 24 steps on the card and on the CPU from the same
   seed and global ``np.random`` state: actions and rewards within 1e-8 (the
   two SLSQP L5s' actions within 1e-6; ``L5_ScipyOptimal``'s capacitor tie,
   where SLSQP splits its two 1.0-rated capacitors 0.5/0.5 and the last
   digits switch them, ends its comparison and is logged), K3 launched on
   every step, all with the dense Y, 0 GPU ops and 0 host syncs in an
   ``act`` (every card ``act`` under ``set_sync_debug_mode("error")``, the
   second counted by torch.profiler), ms per step split into ``act`` and
   ``step`` on both devices;
   14b. ``offline.generate_mixed_dataset`` over Corrected L0-L5 with unequal
   weights on ``IEEE33RenewableEnv`` for 96 steps, ``behavior_cloning`` on
   it and ``evaluate_policy`` of the fitted policy (2 episodes × 10 steps),
   card against CPU within 1e-8 (states, actions, coefficients, returns);
   each of the 31 heuristics of the expert zoo for 4 steps, card against
   CPU within 1e-8;
   14c. ``gym_anm_torch.scripts.create_algorithmic_diversity.run`` for each
   of its controllers on the card at 5 steps, beside the same on the CPU.
15. the renderer, the examples and the scripts on the card (the browser tab
   suppressed; the gymnasium stand-in of phase 14 where gymnasium is
   missing, which also provides ``make``):
   15a. ANM6Easy with ``render()`` after each of 96 steps of seeded uniform
   actions on the card and on the CPU: a ``WsClient`` on each env's server
   gets equal init frames and update frames within 1e-8 (``time``,
   ``yearCount`` and ``networkCollapsed`` equal); ``render()`` on the card
   runs 0 GPU ops and 0 host syncs (torch.profiler; every other call under
   ``set_sync_debug_mode("error")``); the page fetched over HTTP from the
   card's server and executed by ``tests/minijs.py`` shows 6 buses, 5
   branches, 7 device cards and voltage labels equal to the card's
   ``bus_v_magn``; ms of a step with and without ``render()``;
   15b. the examples of ``gym_anm_torch.examples`` at the JAX examples'
   defaults on the card, each beside the same run on the CPU from the same
   seed and global ``np.random`` state: ``simple_env``, ``custom_anm6``,
   ``random_agent`` (rendering, no sleep), ``offline_mixed`` within 1e-8;
   ``mpc_constant`` and ``mpc_perfect`` (100 steps, N = 10) within 1e-6;
   ``mpc_vec`` (float32, B = 16, 96 steps, N = 1 constant and 2/4/8
   perfect) within F32_REWARD_ATOL; ``gym_vector_interop`` where
   ``gymnasium.wrappers.vector`` exists (the log says when it does not);
   15c. through each script's ``main``: ``generate_final_offline_datasets``
   in vec mode at its default 6 x 1024 lanes x 100 steps (finite, actions
   in the box, L0 below the informed controllers, transitions/s) and in
   compat mode at ``--episodes 2`` against the CPU within 1e-8,
   ``quick_dataset_test``, ``l0l5_quality_table --skip-reference`` at
   L0L5_TABLE_STEPS steps, ``exp_rti_budget`` at budgets 24, 32, 48, 96
   and 200, ``scaling_bench`` at world size 1 (one rank spawned on the
   card) and ``verify_h100`` (every probe PASS, the clean build timed);
16. the flows kernel (K6) alone at each benchmark cell's shape (IEEE33 at
   262,144 lanes, multicap17 at 524,288, ANM6Easy at 65,536), on the
   arguments of one real step, beside its plain version (the torch ops the
   chord tier ran before it), in turns
   (``gym_anm_torch.bench.flows_probe``): first K6's outputs held to the
   plain version's (elementwise bit for bit, the values after a sum within
   4 float32 ulps of their terms' magnitudes), then times, the bytes bound
   and K6's share of it.

K3, K2 and K6 launches of phases 11 to 15 and K5's of phase 15 count in the
kernels' line; K6's are those of the main paths (phases 2, 5, 7, 8, 11, 12
and 15, where K2's are counted), not phase 16's own.  On the paths of
networks up to 33 buses K1's register route runs inside K3, one solve a lane-iteration: K1's count in the line is those
solves on the main paths (K3's n_iter out - n_iter in, read from K3's own
outputs after each run).  Above 33 buses K1's panel routes run inside K3
wide the same way: the resident and blocked rows count the solves of the
feeders' float32 path on each route.

Every kernel time is device time: ``cuda_ms`` puts N_LAUNCH back-to-back
launches between one pair of CUDA events behind a sleep kernel, so the host
has enqueued them all before the card reaches them; the median of N_REPS
such readings.  Bounds are the larger of the bytes a call must move (each
input read once, each output written once) over 3.35 TB/s and its
operations over the H100 SXM's peak for their type (67 TFLOP/s float32 on
the CUDA cores; 67 TFLOP/s float64 on the tensor cores, where K2 and K5
run their products; 34 TFLOP/s float64 on the CUDA cores, where K1 and K3
round each product and difference apart).

Prints the card's name and power limit and ptxas's register and spill
report of every kernel first, a JSON line of the kernels next to last, and
``{"ok": true, "device": {...}}`` last.  Needs one card; imports nothing of
JAX.
"""

import contextlib
import dataclasses
import importlib
import io
import json
import math
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

B_MAIN = 8192
B_LARGE = 32768
N_STEPS = 128
N_COLLECT = 64  # steps of the L0-L5 collection (bench.py workload 3)
N_REPS = 5
N_CHECK_LANES, N_CHECK_STEPS = 256, 8
N_LAUNCH = 20  # launches per event pair of every kernel reading
SLEEP_CYCLES = 20_000_000  # ~10 ms of the card's clock: the host enqueues N_LAUNCH calls meanwhile
PEAK_F32 = 67e12  # FLOP/s, H100 SXM, float32 outside the tensor cores
PEAK_F64_TC = 67e12  # FLOP/s, H100 SXM, float64 on the tensor cores (DMMA)
PEAK_F64 = 34e12  # FLOP/s, H100 SXM, float64 on the CUDA cores
HBM = 3.35e12  # bytes/s


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, n_launch=N_LAUNCH):
    """Mean device ms per call of ``fn`` over ``n_launch`` back-to-back
    calls between one pair of CUDA events.  A sleep kernel ahead of the
    first event keeps the card busy while the host enqueues the calls, so a
    call shorter than its own enqueue is timed on the card, not on the
    host; a call that synchronizes is timed end to end as before."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(n_launch):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_launch


def systems(B, n, dtype, seed):
    """Diagonally dominant systems on the card; lane 1 has a zero first pivot."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.randn(B, n, n, generator=g, device="cuda", dtype=dtype)
    A += n * torch.eye(n, device="cuda", dtype=dtype)
    b = torch.randn(B, n, generator=g, device="cuda", dtype=dtype)
    A[1, 0, 0] = 0.0
    return A.contiguous(), b.contiguous()


def bound(flops, peak, n_bytes):
    """(ms, "operations" or "bytes"): the least time of a call that does
    ``flops`` at ``peak`` FLOP/s and moves ``n_bytes`` at the HBM rate."""
    t_ops, t_bytes = flops / peak, n_bytes / HBM
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def k1_bound(B, n, itemsize=4):
    """K1's bound: per system n sweeps of n divides, n mask multiplies and
    n (n + 1) multiply/subtract pairs, then n divides; A and b read once, x
    written once.  Float64 counts at the CUDA cores' peak: the kernel rounds
    each product and difference apart, which the FP64 tensor cores (DMMA,
    fused) cannot."""
    flops = B * (n * (2 * n + 2 * n * (n + 1)) + n)
    return bound(flops, PEAK_F64 if itemsize == 8 else PEAK_F32, itemsize * B * (n * n + 2 * n))


def phase1_kernel_vs_plain(lin):
    """K1's register route (n = 64 at B = 8192, n = 10 at B = 1001; float32
    and float64) against its plain version, bitwise, the zero-pivot lane
    non-finite in both; each timed beside the plain version and
    ``torch.linalg.solve_ex``, with its bound."""
    log("== phase 1: K1 against its plain version")
    result = {}
    errs = []
    for B, n, dtype in ((B_MAIN, 64, torch.float32), (1001, 10, torch.float32),
                        (B_MAIN, 64, torch.float64), (1001, 10, torch.float64)):
        A, b = systems(B, n, dtype, seed=n)
        before = lin.solve_gauss_jordan_cuda.launches["regs"]
        xk = lin.solve_gauss_jordan_cuda(A, b)
        xp = lin.solve_gauss_jordan(A, b)
        torch.cuda.synchronize()
        assert lin.solve_gauss_jordan_cuda.launches["regs"] == before + 1, "K1's register route did not run"
        assert not torch.isfinite(xk[1]).all() and not torch.isfinite(xp[1]).all(), "zero pivot repaired"
        keep = torch.ones(B, dtype=torch.bool, device="cuda")
        keep[1] = False
        assert torch.isfinite(xk[keep]).all() and torch.isfinite(xp[keep]).all()
        err = float((xk[keep] - xp[keep]).abs().max())
        n_equal = int((xk[keep] == xp[keep]).all(1).sum())
        log(f"K1 B={B} n={n} {dtype}: max_abs_err={err:.3e}; bitwise equal on {n_equal} of {B - 1} finite lanes")
        # The register route rounds every operation as the plain version does, in both types.
        assert torch.equal(xk[keep], xp[keep]), f"K1 {dtype} is not bitwise equal to its plain version"
        errs.append(err)
        lin.solve_gauss_jordan_cuda(A, b)  # warm
        torch.linalg.solve_ex(A, b)
        t = {name: statistics.median(cuda_ms(fn, k) for _ in range(N_REPS)) for name, fn, k in (
            ("ms", lambda: lin.solve_gauss_jordan_cuda(A, b), N_LAUNCH),
            ("library_ms", lambda: torch.linalg.solve_ex(A, b), N_LAUNCH),
            ("plain_ms", lambda: lin.solve_gauss_jordan(A, b), 3))}
        bound_ms, bound_by = k1_bound(B, n, A.element_size())
        log(f"K1 time B={B} n={n} {dtype} (device time, {N_LAUNCH} launches per reading, median of {N_REPS}): "
            f"kernel {t['ms']:.4f} ms, torch.linalg.solve_ex {t['library_ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}), kernel at {bound_ms / t['ms']:.4f} of it")
        if (B, n, dtype) == (B_MAIN, 64, torch.float32):
            result = dict(t, bound_ms=bound_ms, bound_by=bound_by)
    result["max_abs_err"] = max(errs)
    return result


class K3Counts:
    """K3's counts on a main path, installed in place of
    ``power_flow.newton_fallback_cuda`` (the name the load flow calls): its
    launches (the wrapper's own count) and K1's solves that ran inside it,
    the sum over its calls of n_iter out - n_iter in (the Newton iterations
    past the chord's), from the calls' own outputs, kept by reference and
    summed when read, so the run gains no GPU op and no host sync.  Setting
    ``launch_count`` resets both."""

    def __init__(self, pf):
        self.real, self.calls = pf.newton_fallback_cuda, []
        pf.newton_fallback_cuda = self

    def __call__(self, x, F, diff, n_iter, *args, **kwargs):
        out = self.real(x, F, diff, n_iter, *args, **kwargs)
        self.calls.append((n_iter, out[3]))
        return out

    @property
    def launch_count(self):
        return self.real.launch_count

    @launch_count.setter
    def launch_count(self, value):
        self.real.launch_count = value
        self.calls.clear()

    @property
    def launches(self):
        return self.real.launches

    @property
    def solves(self):
        if not self.calls:
            return 0
        return int(sum((o - i).sum(dtype=torch.int64) for i, o in self.calls))


def bad_guesses(B, n, which=(0, 1, 2, 3)):
    """The bad-basin warm starts of tests/test_chord_solver.py (the patterns
    ``which``), tiled to B lanes."""
    pats = torch.stack([
        torch.cat([torch.zeros(n), torch.full((n,), 1e-6)]),   # vm ~ 0
        torch.cat([torch.zeros(n), torch.full((n,), -1.0)]),   # vm < 0
        torch.cat([torch.full((n,), 30.0), torch.ones(n)]),    # wild angles
        torch.cat([torch.zeros(n), torch.full((n,), 1e15)]),   # vm overflow
    ])[list(which)]
    return pats.repeat(B // len(which) + 1, 1)[:B]


def k2_bound(ct, B, n_iter, x0):
    """K2's bound from a run's iteration counts: a prologue mismatch per lane
    (4 N^2 float64 multiply-adds) and per iteration a mismatch, an update
    product and H F (4 N^2 + 4 n^2 + 4 n), at the float64 tensor-core rate;
    p, q, the four per-lane scalars, x0, the constants read once, x, F,
    diff, n_iter and accepted written once.  Lanes reset to the flat start
    report 0 iterations, so on sets where many are reset this undercounts."""
    n, N = ct.n, ct.n + 1
    macs = B * 4 * N * N + int(n_iter.sum()) * (4 * N * N + 4 * n * n + 4 * n)
    consts = 8 * (2 * N * N + 4 * n * n + 4 * n) + 4 * (4 * n + 4 + 3 * N)
    n_bytes = 4 * B * (2 * n + 4) + (0 if x0 is None else 4 * B * 2 * n) + consts + B * (4 * 2 * 2 * n + 9)
    return bound(2 * macs, PEAK_F64_TC, n_bytes)


def chord_vs_plain(pf, cuda_k, name, ct, args, x0):
    """K2 and the plain chord on the same card inputs.  Both sum in the same
    order (the Anderson sums in the warp's butterfly order, the dot products
    in float64 and rounded once), so they agree bitwise but for a float64
    dot product whose other accumulation order moves a float32 rounding.
    Tolerance: the same accepted lanes; n_iter equal on all but 0.5% of
    lanes; x within 1e-5 (the solver's own scale is xtol = 1e-5 on the
    residual); F and diff within 1e-4 (the acceptance band).  Returns
    (max |dx|, kernel ms, plain ms, bound ms, what bounds it).  Fails unless
    the launch took the route the wrapper's rule gives the set: the wide
    kernel above TILE_MAX_N, else the tile kernel at ``tile_slots`` slots a
    block."""
    from gym_anm_torch.physics.chord_cuda import TILE_MAX_N, tile_slots

    B = args[0].shape[0]
    n_sm = torch.cuda.get_device_properties(args[0].device).multi_processor_count
    route = "wide" if ct.n > TILE_MAX_N else f"tile{tile_slots(B, ct.n, n_sm)}"
    before, before_route = cuda_k.launch_count, cuda_k.launches[route]
    xk, Fk, dk, ik, ak = cuda_k(*args, ct, x0=x0)
    torch.cuda.synchronize()
    xp, Fp, dp, ip, ap = pf.chord_solve_plain(*args, ct, x0=x0)
    torch.cuda.synchronize()
    assert cuda_k.launch_count == before + 1
    assert cuda_k.launches[route] == before_route + 1, f"K2 {name} B={B} did not take the {route} route"
    err = float((xk - xp).abs().max())
    n_diff = int((ik != ip).sum())
    mean_it = float(ik.float().mean())
    log(f"K2 {name} B={B} ({route}): accepted {int(ak.sum())} / plain {int(ap.sum())}; n_iter differs on {n_diff} lanes "
        f"(max {int((ik - ip).abs().max())}), mean {mean_it:.3f}, worst {int(ik.max())}; "
        f"max|dx| {err:.3e}, max|dF| {float((Fk - Fp).abs().max()):.3e}, "
        f"max|ddiff| {float((dk - dp).abs().max()):.3e}, x bitwise equal on {int((xk == xp).all(1).sum())} of "
        f"{B} lanes")
    assert torch.equal(ak, ap), "K2 and its plain version accept different lanes"
    assert n_diff <= B // 200, f"K2 n_iter differs on {n_diff} lanes"
    assert err <= 1e-5 and float((Fk - Fp).abs().max()) <= 1e-4 and float((dk - dp).abs().max()) <= 1e-4
    t_k = statistics.median(cuda_ms(lambda: cuda_k(*args, ct, x0=x0)) for _ in range(N_REPS))
    t_p = statistics.median(cuda_ms(lambda: pf.chord_solve_plain(*args, ct, x0=x0), 3) for _ in range(N_REPS))
    bound_ms, bound_by = k2_bound(ct, B, ik, x0)
    log(f"K2 {name} time (device time, {N_LAUNCH} launches per reading, median of {N_REPS}): kernel {t_k:.4f} ms, "
        f"plain {t_p:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}, {int(ik.sum())} lane-iterations), kernel at "
        f"{bound_ms / t_k:.3f} of it")
    return err, t_k, t_p, bound_ms, bound_by


def multicap_injections(tb, B, g):
    """Bus injections of the multicap network under diurnal loads (random
    hour, 2% noise), random capacitor set-points and taps, and the tap's
    ΔY entries (transition.py's formulas), on the card."""
    dev = tb.device
    u = lambda *shape: torch.rand(*shape, generator=g, device=dev)  # noqa: E731
    hour = 24.0 * u(B, 1)
    load = tb.load_p_min * (0.8 + 0.3 * torch.sin((hour - 3.0) * (math.pi / 12.0)))
    load = load * (1.0 + 0.02 * torch.randn(B, len(tb.load_pos), generator=g, device=dev))
    dev_p = torch.zeros(B, tb.n_dev, device=dev)
    dev_q = torch.zeros(B, tb.n_dev, device=dev)
    dev_p[:, tb.load_pos] = load
    dev_q[:, tb.load_pos] = load * tb.load_qp
    dev_q[:, tb.cap_pos] = tb.cap_q_min + u(B, len(tb.cap_pos)) * (tb.cap_q_max - tb.cap_q_min)
    p_ns = (dev_p @ tb.dev_bus_mat)[:, 1:].contiguous()
    q_ns = (dev_q @ tb.dev_bus_mat)[:, 1:].contiguous()
    a = tb.oltc_tap_min[0] + u(B) * (tb.oltc_tap_max[0] - tb.oltc_tap_min[0])
    inv_da = 1.0 / a - 1.0 / tb.chord_a0
    dtf_re = -tb.chord_y_re * inv_da
    dtf_im = -tb.chord_y_im * inv_da
    return p_ns, q_ns, dtf_im, dtf_re, dtf_re, dtf_im


def phase1b_chord_kernel(pf, cuda_k, VecEnv, make_ieee33_task, make_ieee33_multicap_task, make_anm6easy_task):
    from gym_anm_torch.bench.kernel_probes import step_chord_inputs

    log(f"== phase 1b: K2 against its plain version, B={B_MAIN}")
    g = torch.Generator(device="cuda").manual_seed(11)
    tb = VecEnv(make_ieee33_task(), dtype=torch.float32, device="cuda").tables
    n = tb.n_bus - 1
    qc = torch.rand(B_MAIN, 2, generator=g, device="cuda")
    q = torch.zeros(B_MAIN, n, device="cuda")
    q[:, 7], q[:, 24] = qc[:, 0], qc[:, 1]
    a = 0.9 + 0.2 * torch.rand(B_MAIN, generator=g, device="cuda")
    inv_da = 1.0 / a - 1.0 / tb.chord_a0
    dr, di = -tb.chord_y_re * inv_da, -tb.chord_y_im * inv_da
    base = (torch.zeros(B_MAIN, n, device="cuda"), q, di, dr, dr, di)
    warm = tb.chord_t.flat + 0.01 * torch.randn(B_MAIN, 2 * n, generator=g, device="cuda")
    warm[3] = float("nan")
    mtb = VecEnv(make_ieee33_multicap_task(), dtype=torch.float32, device="cuda").tables
    # ANM6Easy (n = 5: 27 of the warp's threads idle) at a real step's
    # injections: from the flat start, from the step's warm starts (its
    # collapsing lanes are not accepted), and from the bad-basin guesses.
    a6_ct, a6_args, a6_warm = step_chord_inputs(make_anm6easy_task(), B_MAIN, 8, 12)
    errs, times = [], {}
    for name, ct, args, x0 in (
        ("base IEEE33 flat start", tb.chord_t, base, None),
        ("base IEEE33 warm starts", tb.chord_t, base, warm),
        ("multicap at x* under diurnal loads", mtb.chord_t, multicap_injections(mtb, B_MAIN, g), None),
        ("bad-basin guesses", tb.chord_t, tuple(torch.full_like(base[0], -0.01) * s for s in (1, 0.5))
         + (torch.zeros_like(di),) * 4, bad_guesses(B_MAIN, n).to("cuda")),
        ("ANM6Easy flat start", a6_ct, a6_args, None),
        ("ANM6Easy warm starts of a step", a6_ct, a6_args, a6_warm),
        ("ANM6Easy bad-basin guesses", a6_ct, a6_args, bad_guesses(B_MAIN, a6_warm.shape[1] // 2).to("cuda")),
    ):
        err, *times[name] = chord_vs_plain(pf, cuda_k, name, ct, args, x0)
        errs.append(err)
    t_k, t_p, bound_ms, bound_by = times["base IEEE33 warm starts"]
    # Small batches (the compat Simulator's B = 1, a ragged 1001), which take
    # the 8-slot route at n = 32 where B_MAIN takes the 16-slot one: the
    # first lanes of the warm-start set, checked and timed beside B_MAIN's.
    small = {}
    for k in (1, 1001):
        sub = tuple(a[:k].contiguous() for a in base)
        err, small[k], *_ = chord_vs_plain(pf, cuda_k, f"base IEEE33 warm starts, first {k} lanes", tb.chord_t, sub,
                                           warm[:k].contiguous())
        errs.append(err)
    log(f"K2 base IEEE33 warm starts, device time by batch: B=1 {small[1]:.4f} ms, B=1001 {small[1001]:.4f} ms, "
        f"B={B_MAIN} {t_k:.4f} ms")
    return dict(max_abs_err=max(errs), ms=t_k, plain_ms=t_p, bound_ms=bound_ms, bound_by=bound_by, ms_b1=small[1],
                ms_b1001=small[1001])


def uniform_actions(env, B, g):
    u = torch.rand(B, env.n_action, generator=g, device=env.device, dtype=env.dtype)
    return env.action_low + u * (env.action_high - env.action_low)


def check_step(obs, r, d, info, what):
    assert torch.isfinite(obs).all(), f"{what}: non-finite obs"
    assert torch.isfinite(r).all(), f"{what}: non-finite reward"
    assert not d.any(), f"{what}: {int(d.sum())} lanes terminated"
    worst = float(info["diff"].max())
    assert worst <= 1e-4, f"{what}: residual {worst:.3e} > 1e-4"


def phase2_main_path(VecEnv, make_ieee33_task, kernel, chord_k, flows_k):
    log(f"== phase 2: base path, base IEEE33 f32, B={B_MAIN}, {N_STEPS} steps")
    env = VecEnv(make_ieee33_task(), dtype=torch.float32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    kernel.launch_count = 0
    chord_k.launch_count = 0
    flows_k.launch_count = 0
    state, obs = env.reset(B_MAIN)
    assert torch.isfinite(obs).all() and not state.terminated.any()
    record = []
    iters = []
    for k in range(N_STEPS):
        a = uniform_actions(env, B_MAIN, g)
        state, obs, r, d, info = env.step(state, a)
        check_step(obs, r, d, info, f"step {k}")
        iters.append(info["n_iter"])
        if k < N_CHECK_STEPS:
            lanes = slice(0, N_CHECK_LANES)
            record.append((a[lanes].cpu(), r[lanes].cpu(), state.bus_vm[lanes].cpu()))
    launches_plain, solves_plain = kernel.launch_count, kernel.solves
    # A restored state whose warm starts are far off (wild angles, overflowing
    # magnitudes): the chord exit is reset to the flat start, unaccepted, and
    # every lane goes through the Newton fallback (K3).  (The two near-zero
    # and negative-magnitude guesses are left out here: under the task's real
    # loads they strand the fallback in a low-voltage basin, in the JAX
    # package as in the port.)
    n = env.spec.n_bus - 1
    bad = state._replace(v_guess=bad_guesses(B_MAIN, n, which=(2, 3)).to("cuda"))
    state2, obs, r, d, info = env.step(bad, uniform_actions(env, B_MAIN, g))
    check_step(obs, r, d, info, "bad-basin step")
    torch.cuda.synchronize()
    launches, solves = kernel.launch_count, kernel.solves
    chord_launches, flows_launches = chord_k.launch_count, flows_k.launch_count
    it = torch.stack(iters).float()
    log(f"base path: K2 launches {chord_launches}, K6 {flows_launches}; K3 launches {launches} ({launches_plain} "
        f"in the reset and the {N_STEPS} random-action steps, {launches - launches_plain} in the bad-basin step); "
        f"K1 solves inside K3 "
        f"{solves} ({solves_plain} in the reset and the steps, {solves - solves_plain} in the bad-basin step, "
        f"fallback iterations max {int(info['n_iter'].max())})")
    log(f"chord iterations per step over {N_STEPS} steps: mean {float(it.mean()):.3f}, "
        f"worst lane {int(it.max())}, mean of per-step worst {float(it.max(dim=1).values.mean()):.3f}")
    assert launches > 0 and solves > 0, "K3 never launched, or ran no Newton iteration, on the base path"
    assert chord_launches > 0, "K2 never launched on the base path"

    # The first steps of the first lanes against the port's f64 CPU rollout:
    # bus_vm within 5e-5 everywhere; rewards within rtol 2e-3 / atol 2e-4
    # (tests/test_chord_solver.py) wherever the slack branch's active flow,
    # which equals e_loss here (the task's loads are zero), is at least 1e-4
    # p.u.  Below that the f32 flow is within a few rounding quanta of zero
    # (|y| of that branch is ~155 p.u., so one f32 ulp of its terms is
    # ~1.5e-5), sign(p_from) in the branch's signed flow may come out 0, and
    # the rate-0 penalty of that branch (up to ~0.8 of reward) drops out: the
    # JAX package's f32 tier does the same on the same lanes.
    ref = VecEnv(make_ieee33_task(), dtype=torch.float64, device="cpu")
    s64, _ = ref.reset(N_CHECK_LANES)
    worst_r = worst_vm = 0.0
    n_checked = n_near_zero = 0
    for k, (a, r32, vm32) in enumerate(record):
        s64, _, r64, d64, info64 = ref.step(s64, a.double())
        assert not d64.any()
        torch.testing.assert_close(vm32.double(), s64.bus_vm, rtol=0, atol=5e-5, msg=f"bus_vm step {k}")
        sign_ok = info64["e_loss"].abs() >= 1e-4
        torch.testing.assert_close(r32.double()[sign_ok], r64[sign_ok], rtol=2e-3, atol=2e-4,
                                   msg=f"reward step {k}")
        n_checked += int(sign_ok.sum())
        n_near_zero += int((~sign_ok).sum())
        worst_r = max(worst_r, float((r32.double() - r64)[sign_ok].abs().max()))
        worst_vm = max(worst_vm, float((vm32.double() - s64.bus_vm).abs().max()))
    log(f"f32 card vs f64 CPU ({N_CHECK_STEPS} steps x {N_CHECK_LANES} lanes): bus_vm max abs diff "
        f"{worst_vm:.3e}; reward max abs diff {worst_r:.3e} over {n_checked} lane-steps "
        f"({n_near_zero} lane-steps with a slack-branch flow below 1e-4 p.u. not reward-compared)")
    assert flows_launches > 0, "K6 never launched on the base path"
    return launches, chord_launches, flows_launches, solves


def phase3_fallback(env_cls, make_ieee33_task, pf, ybus, kernel):
    log(f"== phase 3: chord + Newton fallback through K3 on bad-basin inputs, B={B_MAIN}")
    results = {}
    for device in ("cuda", "cpu"):
        B = B_MAIN if device == "cuda" else 8
        tb = env_cls(make_ieee33_task(), dtype=torch.float32, device=device).tables
        n = tb.n_bus - 1
        p = torch.full((B, n), -0.01, device=device)
        q = p * 0.5
        z = torch.zeros(B, device=device)
        x0 = bad_guesses(B, n).to(device)

        ybus_fn = ybus.LaneYbus(tb.n_bus, tb.br_f, tb.br_t, tb.series_re, tb.series_im, tb.shunt_im,
                                tb.shift_cos, tb.shift_sin, tb.tap0.expand(B, -1).contiguous())
        kernel.launch_count = 0
        init = pf.chord_solve(p, q, z, z, z, z, tb.chord_t, x0=x0)
        r = pf.nr_solve_lazy(ybus_fn, p, q, init=init)
        assert r.stable.all(), f"{device}: {int((~r.stable).sum())} lanes unstable"
        assert float(r.diff.max()) <= 1e-4
        if device == "cuda":
            assert kernel.launch_count == 1 and kernel.solves > 0, "the fallback did not launch K3 once"
            log(f"fallback on the card: K3 launches {kernel.launch_count}, K1 solves inside it {kernel.solves}, "
                f"iterations max {int(r.n_iter.max())}, residual max {float(r.diff.max()):.3e}")
        results[device] = (r.v_re[:8].cpu(), r.v_im[:8].cpu())
    err = max(float((results["cuda"][i] - results["cpu"][i]).abs().max()) for i in range(2))
    log(f"fallback voltages card vs CPU (plain solve): max abs diff {err:.3e}")
    assert err <= 5e-6


def lane_iteration_flops(n):
    """Operations of one lane-iteration of the Newton loop at n unknowns
    (N = n / 2 + 1 buses): the Jacobian (~14 an entry), two mismatches (the
    complex matvec, 8 N^2, and ~10 a bus), and the Gauss-Jordan sweeps (n^2
    (n + 1) multiply-subtract pairs, n^2 divides and mask multiplies)."""
    N = n // 2 + 1
    return 14 * n * n + 2 * (8 * N * N + 10 * n) + 2 * n * n * (n + 1) + 2 * n * n


def k3_bound(B, n, itemsize, lane_iters, y_bytes):
    """K3's bound from a run's lane-iterations (the elimination's operations
    at the type's CUDA-core peak: the kernel rounds each product and
    difference apart), or the bytes: x, F, diff, n_iter, accepted, p, q read
    once, x, F, diff, n_iter and stall written once, and the Y source."""
    n_bytes = B * (itemsize * (3 * n + 1) + 5) + B * (itemsize * (2 * n + 1) + 8) + y_bytes
    return bound(lane_iters * lane_iteration_flops(n), PEAK_F64 if itemsize == 8 else PEAK_F32, n_bytes)


def bitwise_rows(a, b):
    """Rows of a and b equal bit for bit (NaN where both are NaN)."""
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    return same.all(1) if same.dim() > 1 else same


def k3_vs_plain(pf, lin, nc, name, args, ybus, plain_ybus, tol, xtol=1e-5, lim_iter=100):
    """K3 and its plain version (``power_flow._newton_loop`` with the plain
    Gauss-Jordan solve, no kernel in the oracle) on the same card inputs
    ``args`` = (x, F, diff, n_iter, accepted or None, p, q), their results
    through the shared epilogue ``_nr_result``.  Gates: ``stable`` and
    ``converged`` equal on every lane, ``n_iter`` equal on >= 99.5% of
    lanes, x within ``tol`` on the lanes stable in both.  Returns a dict of
    the readings (bitwise share, the slowest lane's iterations, times of the
    kernel and of the plain version, µs an iteration of the slowest lane,
    the bound)."""
    x, F, diff, it, acc, p, q = args
    B, n = x.shape
    f32 = p.dtype == torch.float32
    before = nc.launch_count
    out_k = nc(x, F, diff, it, acc, p, q, ybus, xtol, lim_iter)
    torch.cuda.synchronize()
    assert nc.launch_count == before + 1, "K3 did not launch once"
    xk, Fk, dk, ik, sk = out_k
    acc0 = torch.zeros(B, dtype=torch.bool, device="cuda") if acc is None else acc
    xp, Fp, dp, ip, sp = pf._newton_loop(x, F, diff, it, ~acc0, plain_ybus, p, q, xtol, lim_iter, f32,
                                         lin.solve_gauss_jordan)
    rk = pf._nr_result(xk, Fk, dk, ik, sk, acc0, xtol, f32)
    rp = pf._nr_result(xp, Fp, dp, ip, sp, acc0, xtol, f32)
    torch.cuda.synchronize()
    both = rk.stable & rp.stable
    err = float((xk - xp)[both].abs().max()) if bool(both.any()) else 0.0
    n_it = int((ik == ip).sum())

    n_bit = int((bitwise_rows(xk, xp) & bitwise_rows(Fk, Fp) & bitwise_rows(dk, dp) & (ik == ip)
                 & (sk == sp)).sum())
    lane_iters = int((ik - it).sum())
    n_go = int(((ik - it) > 0).sum())
    max_it = int((ik - it).max())
    out = dict(max_abs_err=err, bitwise=n_bit / B, n_iter_equal=n_it / B, lane_iters=lane_iters, max_it=max_it)
    log(f"K3 {name} B={B} n={n} {p.dtype}: {n_go} lanes iterated, {lane_iters} lane-iterations (max "
        f"{max_it}); stable {int(rk.stable.sum())} / plain {int(rp.stable.sum())}, converged "
        f"{int(rk.converged.sum())} / {int(rp.converged.sum())}; n_iter equal on {n_it} of {B}; max|dx| on lanes "
        f"stable in both {err:.3e}; bitwise equal (x, F, diff, n_iter, stall) on {n_bit} of {B} lanes "
        f"({n_bit / B:.4f})")
    assert torch.equal(rk.stable, rp.stable), "K3 and its plain version disagree on stable"
    assert torch.equal(rk.converged, rp.converged), "K3 and its plain version disagree on converged"
    assert n_it >= math.ceil(0.995 * B), f"K3 n_iter differs on {B - n_it} lanes"
    assert err <= tol, f"K3 x differs by {err:.3e} > {tol:.0e} on a stable lane"
    out["ms"] = statistics.median(
        cuda_ms(lambda: nc(x, F, diff, it, acc, p, q, ybus, xtol, lim_iter)) for _ in range(N_REPS))
    out["plain_ms"] = statistics.median(
        cuda_ms(lambda: pf._newton_loop(x, F, diff, it, ~acc0, plain_ybus, p, q, xtol, lim_iter, f32,
                                        lin.solve_gauss_jordan), 3) for _ in range(N_REPS))
    if hasattr(ybus, "tap_magn"):  # a LaneYbus: the taps and the branch tables
        y_bytes = x.element_size() * (ybus.tap_magn.numel() + 5 * ybus.f.numel()) + 16 * ybus.f.numel()
    else:
        y_bytes = x.element_size() * sum(t.numel() for t in ybus)
    out["bound_ms"], out["bound_by"] = k3_bound(B, n, x.element_size(), lane_iters, y_bytes)
    per_it = f"{1e3 * out['ms'] / max_it:.2f} µs" if max_it else "-"
    log(f"K3 {name} time (device time, {N_LAUNCH} launches per reading, median of {N_REPS}): kernel "
        f"{out['ms']:.4f} ms ({n_go} lanes iterate), plain {out['plain_ms']:.4f} ms; bound {out['bound_ms']:.4f} ms "
        f"({1e3 * out['bound_ms']:.4g} µs, {out['bound_by']}, {lane_iters} lane-iterations), kernel at "
        f"{out['bound_ms'] / out['ms']:.4f} of it; slowest lane {max_it} iterations, {per_it} an iteration")
    return out


def task_newton_inputs(VecEnv, task, n_steps, seed):
    """The Newton fallback's inputs at the last of ``n_steps`` steps of
    ``task`` at B_MAIN lanes on the card (uniform-random actions through
    ``step_autoreset_batch``), taken at the call: (LaneYbus, p, q, the
    chord's result)."""
    tm = importlib.import_module("gym_anm_torch.physics.transition")
    env = VecEnv(task, dtype=torch.float32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    state, _ = env.reset(B_MAIN, g)
    real, seen = tm.nr_solve_lazy, []

    def capture(ybus_fn, p, q, **kw):
        if p.shape[0] == B_MAIN:  # the step's solve (a reset's takes the done lanes)
            seen.append((ybus_fn, p, q, kw["init"]))
        return real(ybus_fn, p, q, **kw)

    tm.nr_solve_lazy = capture
    try:
        for _ in range(n_steps):
            state, *_ = env.step_autoreset_batch(state, uniform_actions(env, B_MAIN, g), g)
    finally:
        tm.nr_solve_lazy = real
    return seen[-1]


def flat_start(pf, Yre, Yim, p, q):
    """nr_solve's start: (x, F, diff, n_iter) at the flat start, no lane accepted."""
    B, nb = p.shape
    x = torch.cat([torch.zeros(B, nb, dtype=p.dtype, device="cuda"), torch.ones(B, nb, dtype=p.dtype, device="cuda")],
                  dim=1)
    F, _ = pf._mismatch(x, p, q, Yre, Yim, nb)
    return x, F, torch.amax(torch.abs(F), dim=1), torch.zeros(B, dtype=torch.int32, device="cuda")


def dense_oracle(Yre, Yim):
    return (lambda idx: (Yre, Yim)) if Yre.dim() == 2 else (lambda idx: (Yre[idx], Yim[idx]))


def phase3b_newton_kernel(pf, lin, nc, VecEnv, make_ieee33_task, make_anm6easy_task, LaneYbus):
    """K3 against its plain version on the card, sets (a)-(f): (a) IEEE33
    float32 after the chord from the bad-basin guesses (every lane
    unaccepted) under random loads, random taps through the LaneYbus; (b) ANM6Easy float32 (n =
    10) at a real step's fallback inputs (its collapsing lanes); (c) IEEE33
    and ANM6 float64 from the flat start with a dense Y (nr_solve's route), at
    B = 8192 and at B = 1; (d) a batch with no unaccepted lane (the launch's
    own time); (e) a ragged B = 1001 from the flat start with lane 1's Y
    zero (a zero pivot: non-finite in both); (f) the tail: one lane of (a)
    among (d)'s accepted ones.  Returns the (a) set's numbers for the
    kernels' line."""
    log(f"== phase 3b: K3 (the exact-Newton fallback) against its plain version, B={B_MAIN}")
    g = torch.Generator(device="cuda").manual_seed(31)
    env32 = VecEnv(make_ieee33_task(), dtype=torch.float32, device="cuda")
    tb = env32.tables
    n = tb.n_bus - 1
    B = B_MAIN
    # Phase 3's loads, each bus's drawn in [0.01, 0.02] p.u., and random
    # taps: the chord accepts none of the bad-basin lanes (the mirrored
    # negative-magnitude solution is not in reach of these loads).
    p = -0.01 * (1.0 + torch.rand(B, n, generator=g, device="cuda"))
    q = 0.5 * p
    a = 0.9 + 0.2 * torch.rand(B, generator=g, device="cuda")
    inv_da = 1.0 / a - 1.0 / tb.chord_a0
    dr, di = -tb.chord_y_re * inv_da, -tb.chord_y_im * inv_da
    tap = tb.tap0.expand(B, -1).clone()
    tap[:, tb.oltc_branch] = a.unsqueeze(1)
    ybus = LaneYbus(tb.n_bus, tb.br_f, tb.br_t, tb.series_re, tb.series_im, tb.shunt_im, tb.shift_cos,
                    tb.shift_sin, tap)
    results, errs = {}, []

    # (a) every lane unaccepted by the chord.
    init = pf.chord_solve(p, q, di, dr, dr, di, tb.chord_t, x0=bad_guesses(B, n).to("cuda"))
    assert not bool(init[4].any()), "set (a): a lane was accepted by the chord"
    init_a = init
    results["a"] = k3_vs_plain(pf, lin, nc, "(a) IEEE33 after the chord from bad-basin guesses", init + (p, q),
                               ybus, ybus, 1e-5)

    # (b) ANM6Easy at a real step's fallback inputs.
    a6_ybus, a6_p, a6_q, a6_init = task_newton_inputs(VecEnv, make_anm6easy_task(), 8, 12)
    log(f"K3 (b): {int((~a6_init[4]).sum())} of {B} ANM6Easy lanes unaccepted by the chord at step 8")
    results["b"] = k3_vs_plain(pf, lin, nc, "(b) ANM6Easy at a step's injections", tuple(a6_init) + (a6_p, a6_q),
                               a6_ybus, a6_ybus, 1e-5)

    # (c) float64 from the flat start, dense Y, at B = 8192 and B = 1.
    tb64 = VecEnv(make_ieee33_task(), dtype=torch.float64, device="cuda").tables
    a6tb64 = VecEnv(make_anm6easy_task(), dtype=torch.float64, device="cuda").tables
    for net, t64, yb, pp, qq in (("IEEE33", tb64, ybus, p, q), ("ANM6", a6tb64, a6_ybus, a6_p, a6_q)):
        Yre, Yim = LaneYbus(t64.n_bus, t64.br_f, t64.br_t, t64.series_re, t64.series_im, t64.shunt_im,
                            t64.shift_cos, t64.shift_sin, yb.tap_magn.double())(slice(None))
        p64, q64 = pp.double(), qq.double()
        for BB in (B, 1):
            Y = (Yre[:BB].contiguous(), Yim[:BB].contiguous())
            start = flat_start(pf, *Y, p64[:BB].contiguous(), q64[:BB].contiguous())
            results[f"c {net} {BB}"] = k3_vs_plain(
                pf, lin, nc, f"(c) {net} float64 from the flat start", start + (None, p64[:BB].contiguous(),
                                                                           q64[:BB].contiguous()),
                Y, dense_oracle(*Y), 1e-10)

    # ROADMAP D2: the float64 tier on the card (K3, Y V in the fold's order)
    # against the CPU's (BLAS's order), ANM6Easy from bad-basin starts.
    y6 = LaneYbus(a6tb64.n_bus, a6tb64.br_f, a6tb64.br_t, a6tb64.series_re, a6tb64.series_im, a6tb64.shunt_im,
                  a6tb64.shift_cos, a6tb64.shift_sin, a6_ybus.tap_magn.double())
    p6, q6 = a6_p.double().contiguous(), a6_q.double().contiguous()
    x6 = bad_guesses(B, a6tb64.n_bus - 1).to("cuda", torch.float64)
    d2_card_vs_cpu(pf, "ANM6Easy (K3), bad-basin starts", y6, p6, q6, chord64(pf, a6tb64, y6, p6, q6, x6))

    # (d) no lane unaccepted: the chord from the flat start accepts every lane.
    init = pf.chord_solve(p, q, di, dr, dr, di, tb.chord_t)
    assert bool(init[4].all()), "set (d): the chord left a lane unaccepted"
    xk, Fk, dk, ik, sk = nc(*init, p, q, ybus)
    assert torch.equal(xk, init[0]) and torch.equal(Fk, init[1]) and torch.equal(dk, init[2]) and \
        torch.equal(ik, init[3]) and not bool(sk.any()), "set (d): a lane that does not iterate moved"
    results["d"] = k3_vs_plain(pf, lin, nc, "(d) no lane unaccepted", init + (p, q), ybus, ybus, 1e-5)

    # (f) the tail: (a)'s lane 1 (the vm < 0 guess) among (d)'s accepted lanes.
    tail = torch.zeros(B, dtype=torch.bool, device="cuda")
    tail[1] = True
    init_f = tuple(torch.where(tail.view(-1, *[1] * (a.dim() - 1)), a, d).contiguous() for a, d in zip(init_a, init))
    results["f"] = k3_vs_plain(pf, lin, nc, "(f) the tail: one lane of (a) among accepted ones",
                               init_f + (p, q), ybus, ybus, 1e-5)

    # (e) ragged B with a zero pivot: lane 1's Y is zero, its Jacobian too.
    Be = min(1001, B)
    Yre, Yim = ybus(slice(0, Be))
    Yre[1], Yim[1] = 0.0, 0.0
    start = flat_start(pf, Yre, Yim, p[:Be].contiguous(), q[:Be].contiguous())
    xk = nc(*start, None, p[:Be].contiguous(), q[:Be].contiguous(), (Yre, Yim))[0]
    xp = pf._newton_loop(*start, torch.ones(Be, dtype=torch.bool, device="cuda"), dense_oracle(Yre, Yim),
                         p[:Be], q[:Be], 1e-5, 100, True, lin.solve_gauss_jordan)[0]
    assert not bool(torch.isfinite(xk[1]).all()) and not bool(torch.isfinite(xp[1]).all()), "zero pivot repaired"
    results["e"] = k3_vs_plain(pf, lin, nc, "(e) ragged B with a zero-pivot lane",
                               start + (None, p[:Be].contiguous(), q[:Be].contiguous()), (Yre, Yim),
                               dense_oracle(Yre, Yim), 1e-5)
    log("K3 sets: " + ", ".join(f"{k}: bitwise {v['bitwise']:.4f}, n_iter equal {v['n_iter_equal']:.4f}, "
                                f"{v['ms']:.4f} ms (plain {v['plain_ms']:.4f}; "
                                f"bound {v['bound_ms']:.4f}, {v['bound_by']}; slowest lane {v['max_it']} iterations"
                                + (f", {1e3 * v['ms'] / v['max_it']:.2f} µs an iteration)" if v["max_it"] else ")")
                                for k, v in results.items()))
    ra = results["a"]
    return dict(max_abs_err=max(v["max_abs_err"] for k, v in results.items() if not k.startswith("c")),
                ms=ra["ms"], plain_ms=ra["plain_ms"], bound_ms=ra["bound_ms"], bound_by=ra["bound_by"],
                zero_ms=results["d"]["ms"])


def run_steps(env, B, actions):
    state, _ = env.reset(B)
    outs = []
    for a in actions:
        state, obs, r, d, info = env.step(state, a)
        outs += [obs, r, state.bus_vm, state.v_guess, info["diff"], info["n_iter"]]
    torch.cuda.synchronize()
    return outs


def phase4_tf32(VecEnv, make_ieee33_task):
    log("== phase 4: TF32 allowed globally changes no step output")
    env = VecEnv(make_ieee33_task(), dtype=torch.float32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(4)
    actions = [uniform_actions(env, B_MAIN, g) for _ in range(8)]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = run_steps(env, B_MAIN, actions)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = run_steps(env, B_MAIN, actions)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    same = all(torch.equal(a, b) for a, b in zip(ref, tf32))
    log(f"8 steps at B={B_MAIN}: outputs bitwise identical with allow_tf32=True: {same}")
    assert same


def replay_multicap(VecEnv, make_ieee33_multicap_task, transition, record, what):
    """The recorded first steps of the card's multicap17 lanes replayed
    through the port's float64 transition on the CPU (flat-start exact
    Newton).  ``record`` holds per step [vars, hour, action, reward, bus_vm,
    done, e_loss, penalty] of the check lanes.  bus_vm within 5e-5 on live
    lanes; e_loss within rtol 2e-3 / atol 2e-4 where |e_loss| >= 1e-4, and the
    penalty within rtol 2e-3 / atol λ·Δt·1e-5 (it multiplies the flows'
    error, bounded by the 1e-5 residual, by λ = 100)."""
    ref = VecEnv(make_ieee33_multicap_task(), dtype=torch.float64, device="cpu")
    n_lanes = record[0][0].shape[0]
    tb, z = ref.tables, torch.zeros(n_lanes, 0, dtype=torch.float64)
    worst_vm = worst_e = worst_p = 0.0
    n_checked = 0
    hours = torch.stack([rec[1] for rec in record])
    for k, (vars, _, a, r32, vm32, d32, e32, pen32) in enumerate(record):
        vars, a = vars.double(), a.double()
        P_gen, Q_gen, P_des, Q_des, Q_cap, taps = ref.split_action(a)
        n_load = ref.spec.n_load
        out = transition(tb, vars[:, :n_load], vars[:, n_load:n_load + ref.spec.n_gen], P_gen, Q_gen, P_des,
                         Q_des, Q_cap, taps, z, ref._rates)
        live = ~d32
        assert out.stable[live].all()
        vm64 = torch.sqrt(out.bus_v_re ** 2 + out.bus_v_im ** 2)
        torch.testing.assert_close(vm32.double()[live], vm64[live], rtol=0, atol=5e-5, msg=f"bus_vm step {k}")
        clear = live & (out.e_loss.abs() >= 1e-4)
        torch.testing.assert_close(e32.double()[clear], out.e_loss[clear], rtol=2e-3, atol=2e-4,
                                   msg=f"e_loss step {k}")
        torch.testing.assert_close(pen32.double()[live], out.penalty[live], rtol=2e-3, atol=100 * 1e-5,
                                   msg=f"penalty step {k}")
        torch.testing.assert_close(r32.double()[live], out.reward[live], rtol=2e-3, atol=2e-4 + 100 * 1e-5,
                                   msg=f"reward step {k}")
        worst_vm = max(worst_vm, float((vm32.double() - vm64)[live].abs().max()))
        worst_e = max(worst_e, float((e32.double() - out.e_loss)[clear].abs().max()))
        worst_p = max(worst_p, float((pen32.double() - out.penalty)[live].abs().max()))
        n_checked += int(live.sum())
    log(f"{what} f32 card vs f64 CPU replay ({len(record)} steps x {n_lanes} lanes, {n_checked} live "
        f"lane-steps, hours {float(hours.min()):.3f}-{float(hours.max()):.3f}): bus_vm max abs diff "
        f"{worst_vm:.3e}, e_loss {worst_e:.3e}, penalty {worst_p:.3e}")


def phase5_multicap(VecEnv, make_ieee33_multicap_task, transition, kernel, chord_k, flows_k):
    log(f"== phase 5: multicap17 path, f32, B={B_MAIN}, {N_STEPS} steps of step_autoreset_batch")
    task = make_ieee33_multicap_task()
    record = []

    def recording_vars(generator, s_t, hour, t):
        vars, new_hour = task.next_vars_fn(generator, s_t, hour, t)
        if len(record) < N_CHECK_STEPS:
            record.append([vars[:N_CHECK_LANES].cpu(), new_hour[:N_CHECK_LANES].cpu()])
        return vars, new_hour

    env = VecEnv(dataclasses.replace(task, next_vars_fn=recording_vars), dtype=torch.float32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(6)
    kernel.launch_count = 0
    chord_k.launch_count = 0
    flows_k.launch_count = 0
    state, obs = env.reset(B_MAIN, g)
    assert torch.isfinite(obs).all()
    n_term, iters = 0, []
    n = env.spec.n_bus - 1
    for k in range(N_STEPS):
        a = uniform_actions(env, B_MAIN, g)
        if k == N_STEPS // 2:
            # As from a restored state: far-off warm starts on every lane
            # (the chord resets them to flat and the Newton fallback, K3,
            # solves them) and 64 lanes already terminated (they absorb the
            # step and come back reset).
            state = state._replace(v_guess=bad_guesses(B_MAIN, n, which=(2, 3)).to("cuda"),
                                   terminated=torch.arange(B_MAIN, device="cuda") % (B_MAIN // 64) == 0)
        state, obs, r, d, info = env.step_autoreset_batch(state, a, g)
        assert torch.isfinite(obs).all() and torch.isfinite(r).all(), f"step {k}: non-finite output"
        live = ~d
        worst = float(info["diff"][live].max())
        assert worst <= 1e-4, f"step {k}: live-lane residual {worst:.3e} > 1e-4"
        assert (state.t[d] == 0).all(), f"step {k}: a reset lane is not at t = 0"
        n_term += int(d.sum())
        iters.append(info["n_iter"])
        if k < N_CHECK_STEPS:
            lanes = slice(0, N_CHECK_LANES)
            record[k] += [a[lanes].cpu(), r[lanes].cpu(), state.bus_vm[lanes].cpu(), d[lanes].cpu(),
                          info["e_loss"][lanes].cpu(), info["penalty"][lanes].cpu()]
    torch.cuda.synchronize()
    launches, chord_launches, solves = kernel.launch_count, chord_k.launch_count, kernel.solves
    flows_launches = flows_k.launch_count
    it = torch.stack(iters).float()
    log(f"multicap17 path: K2 launches {chord_launches}, K6 {flows_launches}, K3 launches {launches} (K1 solves "
        f"inside it {solves}); {n_term} lane terminations "
        f"(reset) in {N_STEPS} steps; chord iterations mean {float(it.mean()):.3f}, worst lane {int(it.max())}, "
        f"mean of per-step worst {float(it.max(dim=1).values.mean()):.3f}")
    assert chord_launches > 0, "K2 never launched on the multicap17 path"
    assert flows_launches > 0, "K6 never launched on the multicap17 path"
    assert launches > 0 and solves > 0, "K3 never launched, or ran no Newton iteration, on the multicap17 path"
    assert n_term >= 64

    replay_multicap(VecEnv, make_ieee33_multicap_task, transition, record, "multicap17")
    return launches, chord_launches, flows_launches, solves


def time_path(env, B, step, seed):
    """env-steps/s of ``step`` at B lanes: CUDA events around 128 steps after
    8 warm-up steps, median of 5 reps; also the chord iterations."""
    g = torch.Generator(device=env.device).manual_seed(seed)
    state, _ = env.reset(B, g)
    for _ in range(8):  # warm-up
        state, *_ = step(state, uniform_actions(env, B, g), g)
    reps, iters, n_done = [], [], 0
    for _ in range(N_REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for _ in range(N_STEPS):
            state, obs, r, d, info = step(state, uniform_actions(env, B, g), g)
            iters.append(info["n_iter"])
            n_done += d
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        reps.append(N_STEPS * B / (start.elapsed_time(end) / 1e3))
    it = torch.stack(iters).float()
    rate = statistics.median(reps)
    log(f"{env.task.name} B={B}: {rate:.1f} env-steps/s (median of {N_REPS} reps of {N_STEPS} steps; reps "
        f"{[round(x, 1) for x in reps]}), {1e3 * B / rate:.3f} ms/step (last rep wall "
        f"{1e3 * wall / N_STEPS:.3f} ms/step); chord iterations mean {float(it.mean()):.3f}, "
        f"worst lane {int(it.max())}, mean per-step worst {float(it.max(dim=1).values.mean()):.3f}; "
        f"{int(n_done.sum())} lanes done")
    return rate, int(n_done.sum())


def device_profile(env, B, step, seed, n_steps=16):
    """torch.profiler over ``n_steps`` steps after 8 warm-up steps: the
    device's busy time per step (the union of its kernels' and copies'
    spans), K2's device time per step and the GPU ops per step."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=env.device).manual_seed(seed)
    state, _ = env.reset(B, g)
    for _ in range(8):
        state, *_ = step(state, uniform_actions(env, B, g), g)
    actions = [uniform_actions(env, B, g) for _ in range(n_steps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for a in actions:
            state, *_ = step(state, a, g)
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy, last = 0.0, float("-inf")
    for start, end in sorted((e.time_range.start, e.time_range.end) for e in evs):
        busy += max(0.0, end - max(start, last))
        last = max(last, end)
    k2 = sum(e.time_range.end - e.time_range.start for e in evs if "chord_kernel" in e.name)
    log(f"{env.task.name} B={B} profile ({n_steps} steps): device busy {busy / 1e3 / n_steps:.4f} ms/step, K2 "
        f"{k2 / n_steps:.2f} us/step ({k2 / busy if busy else 0.0:.3f} of busy), {len(evs) / n_steps:.1f} GPU "
        f"ops/step")


def phase6_times(VecEnv, make_ieee33_task, make_ieee33_multicap_task):
    """Returns the multicap17 rate (env-steps/s at B_MAIN)."""
    log("== phase 6: times")
    for B in (B_MAIN, B_LARGE):
        env = VecEnv(make_ieee33_task(), dtype=torch.float32, device="cuda")
        _, n_done = time_path(env, B, env.step, 5)
        assert n_done == 0
        device_profile(env, B, lambda s, a, g: env.step(s, a), 5)
    env = VecEnv(make_ieee33_multicap_task(), dtype=torch.float32, device="cuda")
    rate = time_path(env, B_MAIN, env.step_autoreset_batch, 7)[0]
    device_profile(env, B_MAIN, env.step_autoreset_batch, 7)
    return rate


def leaves(tree):
    if isinstance(tree, tuple):
        return [x for e in tree for x in leaves(e)]
    return [tree]


def block_starts(B, n):
    """First lane of each of the block collector's n blocks, and B."""
    sizes = [B // n] * n
    sizes[-1] += B - sum(sizes)
    return [sum(sizes[:i]) for i in range(n + 1)]


def guarded(Controller, tree_map, ctrl, rec, n_keep):
    """``ctrl`` whose act runs under torch.cuda.set_sync_debug_mode("error"),
    so that a host sync inside it raises, and whose first N_CHECK_STEPS calls
    are recorded (inputs and outputs) for the first ``n_keep`` lanes of its
    block, after the act and outside the checked region."""

    def act(noise, state, obs, carry):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = ctrl.act(noise, state, obs, carry)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if len(rec) < N_CHECK_STEPS:
            rec.append(tree_map(lambda x: x[:n_keep].cpu(), (noise, state, obs, carry) + tuple(out)))
        return out

    return Controller(ctrl.name, ctrl.init_carry, act)


def count_ops(fn, baseline=(0, 0)):
    """(GPU ops, host sync calls) of one call of ``fn``, by torch.profiler,
    less ``baseline`` (the count of an empty call: the profile's own
    synchronizes)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = prof.events()
    n_ops = sum(1 for e in evs if e.device_type == torch.autograd.DeviceType.CUDA)
    n_sync = sum(1 for e in evs if e.device_type == torch.autograd.DeviceType.CPU and "Synchronize" in e.name)
    return n_ops - baseline[0], n_sync - baseline[1]


def phase7_collection(VecEnv, make_ieee33_multicap_task, transition, kernel, chord_k, flows_k, bare_rate):
    """The L0-L5 block collector at full width (bench.py workload 3)."""
    from gym_anm_torch.offline_vec import action_noise, make_block_collector
    from gym_anm_torch.vec import controllers as ctrl
    from gym_anm_torch.vec.core import tree_map

    B, T = B_MAIN, N_COLLECT
    log(f"== phase 7: L0-L5 block collector on multicap17, f32, B={B}, {T} steps")
    task = make_ieee33_multicap_task()
    starts = block_starts(B, 6)
    per = [N_CHECK_LANES // 6 + (1 if i < N_CHECK_LANES % 6 else 0) for i in range(6)]
    lanes = torch.cat([torch.arange(starts[i], starts[i] + per[i]) for i in range(6)]).to("cuda")
    record, steps = [], []

    def recording_vars(generator, s_t, hour, t):
        vars, new_hour = task.next_vars_fn(generator, s_t, hour, t)
        if len(record) < N_CHECK_STEPS:
            record.append([vars[lanes].cpu(), new_hour[lanes].cpu()])
        return vars, new_hour

    env = VecEnv(dataclasses.replace(task, next_vars_fn=recording_vars), dtype=torch.float32, device="cuda")
    real_step = env.step_autoreset_batch

    def recording_step(state, action, generator=None):
        out = real_step(state, action, generator)
        new_state, _, r, d, info = out
        steps.append((torch.where(d, torch.zeros_like(info["diff"]), info["diff"]).amax(), d.sum(),
                      info["n_iter"].float().mean(), info["n_iter"].amax()))
        if len(steps) <= N_CHECK_STEPS:
            record[len(steps) - 1] += [action[lanes].cpu(), r[lanes].cpu(), new_state.bus_vm[lanes].cpu(),
                                       d[lanes].cpu(), info["e_loss"][lanes].cpu(), info["penalty"][lanes].cpu()]
        return out

    env.step_autoreset_batch = recording_step
    recs = [[] for _ in range(6)]
    suite = [guarded(ctrl.Controller, tree_map, c, recs[i], per[i]) for i, c in enumerate(ctrl.make_suite(env))]
    collect, assignment = make_block_collector(env, suite, B, T)
    assert [int(x) for x in torch.bincount(assignment.cpu())] == [starts[i + 1] - starts[i] for i in range(6)]
    kernel.launch_count = 0
    chord_k.launch_count = 0
    flows_k.launch_count = 0
    obs, act, rew, nobs, done = collect(torch.Generator(device="cuda").manual_seed(70))
    torch.cuda.synchronize()
    launches, chord_launches, solves = kernel.launch_count, chord_k.launch_count, kernel.solves
    flows_launches = flows_k.launch_count
    assert flows_launches > 0, "K6 never launched in the collection"

    assert obs.shape == nobs.shape == (T, B, env.n_obs) and act.shape == (T, B, env.n_action)
    assert rew.shape == done.shape == (T, B)
    for name, x in (("obs", obs), ("action", act), ("reward", rew), ("next_obs", nobs)):
        assert torch.isfinite(x).all(), f"non-finite {name}"
    assert (act >= env.action_low).all() and (act <= env.action_high).all(), "an action outside the box"
    res, n_done, it_mean, it_max = (torch.stack(x) for x in zip(*steps))
    assert float(res.max()) <= 1e-4, f"live-lane residual {float(res.max()):.3e} > 1e-4"
    cap_sl, tap_sl = env._action_slices["Q_cap"], env._action_slices["tap"]
    blk = [slice(starts[i], starts[i + 1]) for i in range(6)]
    assert (act[:, blk[1], cap_sl] == 0).all() and (act[:, blk[1], tap_sl] == 1.0).all(), "L1: caps or tap moved"
    taps = torch.tensor(ctrl.TAP_POSITIONS, dtype=torch.float32, device="cuda")
    assert torch.isin(act[:, blk[5], tap_sl], taps).all(), "L5: a tap off its positions"
    assert chord_launches > 0, "K2 never launched on the collection path"
    log(f"collection: K2 launches {chord_launches}, K3 launches {launches} (K1 solves inside it {solves}); "
        f"{int(n_done.sum())} lane terminations; "
        f"chord iterations mean {float(it_mean.mean()):.3f}, worst lane {int(it_max.max())}; worst live residual "
        f"{float(res.max()):.3e}; trajectories [{T}, {B}, ...] stay on {obs.device}")
    log("per-controller mean reward per step (the card's L0-L5 quality table):")
    means = []
    for i, c in enumerate(suite):
        means.append(float(rew[:, blk[i]].mean()))
        log(f"  {c.name:15s} lanes {starts[i]:5d}-{starts[i + 1] - 1:5d}: mean reward {means[i]:.6f}, "
            f"done {int(done[:, blk[i]].sum())}, distinct taps {torch.unique(act[:, blk[i], tap_sl]).numel()}")
    assert max(means[1:]) > means[0], "no informed controller beats L0"

    # The same controllers on the CPU at float32 from the card's recorded
    # states and carries: every carry (cap states, tap indices, timers, the
    # L5 choice) and the caps and taps of the action must equal the card's;
    # the continuous set-points are the same ops on the same inputs.
    env_cpu = VecEnv(make_ieee33_multicap_task(), dtype=torch.float32, device="cpu")
    grid = torch.tensor(ctrl.l5_grid(), dtype=torch.float32)
    discrete = list(range(cap_sl.start, tap_sl.stop))
    n_ls = n_bad = 0
    worst_a = 0.0
    l5_choices = set()
    for i, c in enumerate(ctrl.make_suite(env_cpu)):
        for noise, state, o, carry, a_card, c_card in recs[i]:
            a_cpu, c_cpu = c.act(noise, state, o, carry)
            bad = (a_cpu[:, discrete] != a_card[:, discrete]).any(1)
            for x, y in zip(leaves(c_cpu), leaves(c_card)):
                bad |= (x != y).reshape(x.shape[0], -1).any(1)
            if i == 5:
                # The grid row chosen: (0.2, cap 1, cap 2, tap index); only the
                # |ren − 0.2| term depends on ren, so 0.2 is always chosen.
                for cc in (c_cpu, c_card):
                    row = torch.stack([torch.full_like(cc.last_cap1, 0.2), cc.last_cap1, cc.last_cap2,
                                       cc.last_tap_idx.float()], 1)
                    idx = (row[:, None, :] == grid[None]).all(2).float().argmax(1)
                    l5_choices.update(idx.tolist())
            n_bad += int(bad.sum())
            n_ls += bad.numel()
            if (~bad).any():
                worst_a = max(worst_a, float((a_cpu - a_card)[~bad].abs().max()))
    log(f"controllers on the CPU from the card's states and carries: {n_bad} of {n_ls} lane-steps with another "
        f"discrete decision; max |action difference| elsewhere {worst_a:.3e}; L5 grid rows chosen {sorted(l5_choices)}")
    assert n_bad <= n_ls // 1000, f"{n_bad} lane-steps decide otherwise on the CPU"
    assert worst_a <= 1e-6
    replay_multicap(VecEnv, make_ieee33_multicap_task, transition, record, "collection")

    # Times: the collector alone (no recording, no sync checks).
    env = VecEnv(make_ieee33_multicap_task(), dtype=torch.float32, device="cuda")
    suite = ctrl.make_suite(env)
    timed, _ = make_block_collector(env, suite, B, T)
    g = torch.Generator(device="cuda").manual_seed(71)
    timed(g)  # warm-up
    ms = [cuda_ms(lambda: timed(g), 1) for _ in range(N_REPS)]
    reset_ms = statistics.median(cuda_ms(lambda: env.reset(B, g), 1) for _ in range(3))
    t_ms = statistics.median(ms)
    rate = T * B / (t_ms / 1e3)
    log(f"collector: {rate:.1f} env-steps/s (median of {N_REPS} reps of {T} steps at B={B}, reset included; reps "
        f"{[round(T * B / (m / 1e3), 1) for m in ms]}); {t_ms / T:.3f} ms/step, of which the reset "
        f"{reset_ms:.3f} ms per collection; bare multicap17 step (phase 6, this run) {bare_rate:.1f} env-steps/s, "
        f"ratio {rate / bare_rate:.3f}")

    # Split by stage: CUDA events around every act and every env step of one
    # collection (device timeline; the step is host-bound, so this is mostly
    # the time to enqueue each stage) and host time of the same calls.
    ev = {"controllers": [], "env step": []}
    host = {"controllers": 0.0, "env step": 0.0}

    def stage(fn, key):
        def run(*args):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            s.record()
            out = fn(*args)
            e.record()
            host[key] += time.perf_counter() - t0
            ev[key].append((s, e))
            return out
        return run

    env.step_autoreset_batch = stage(env.step_autoreset_batch, "env step")
    split, _ = make_block_collector(env, [ctrl.Controller(c.name, c.init_carry, stage(c.act, "controllers"))
                                          for c in suite], B, T)
    total = cuda_ms(lambda: split(g), 1) / T
    dev_ms = {k: sum(s.elapsed_time(e) for s, e in v) / T for k, v in ev.items()}
    log(f"collector step split ({T} steps): total {total:.3f} ms/step; controllers {dev_ms['controllers']:.3f} ms "
        f"(host {1e3 * host['controllers'] / T:.3f}), env step {dev_ms['env step']:.3f} ms (host "
        f"{1e3 * host['env step'] / T:.3f}), the rest (noise draw, clip, concat, reset, stacking) "
        f"{total - dev_ms['controllers'] - dev_ms['env step']:.3f} ms")

    # GPU ops and host syncs per collector step (torch.profiler).
    env = VecEnv(make_ieee33_multicap_task(), dtype=torch.float32, device="cuda")
    suite = ctrl.make_suite(env)
    short, _ = make_block_collector(env, suite, B, 8)
    short(g)
    empty = count_ops(lambda: None)
    ops_c, syncs_c = count_ops(lambda: short(g), empty)
    ops_r, syncs_r = count_ops(lambda: env.reset(B, g), empty)
    state, o = env.reset(B, g)
    carries = [c.init_carry(starts[i + 1] - starts[i]) for i, c in enumerate(suite)]
    noise = action_noise(env, B, g)
    ops_a, syncs_a = count_ops(lambda: [c.act(noise[blk[i]], tree_map(lambda x: x[blk[i]], state), o[blk[i]],
                                              carries[i]) for i, c in enumerate(suite)], empty)
    a = uniform_actions(env, B, g)
    ops_s, syncs_s = count_ops(lambda: env.step_autoreset_batch(state, a, g), empty)
    log(f"GPU ops per collector step {(ops_c - ops_r) / 8:.1f} (8-step collection {ops_c}, its reset {ops_r}), host "
        f"syncs per step {(syncs_c - syncs_r) / 8:.2f}; of which the six controllers {ops_a} ops, {syncs_a} syncs "
        f"and the env step {ops_s} ops, {syncs_s} syncs")
    # What L3's and L4's lane mean in the reference's summation order costs
    # against torch's own mean (one call each per step).
    vm = state.bus_vm[blk[3]]
    ops_m, ops_t = count_ops(lambda: ctrl._lane_mean(vm), empty)[0], count_ops(lambda: vm.mean(-1), empty)[0]
    ms_m, ms_t = cuda_ms(lambda: ctrl._lane_mean(vm), 64), cuda_ms(lambda: vm.mean(-1), 64)
    log(f"lane mean of bus_vm [{vm.shape[0]}, {vm.shape[1]}] in the reference's order: {ops_m} GPU ops, {ms_m:.4f} ms "
        f"per call; torch's mean: {ops_t} ops, {ms_t:.4f} ms (2 calls per collector step)")
    return launches, chord_launches, flows_launches, solves


def other_unit_plan(STATE_VARIABLES):
    """Every variable of STATE_VARIABLES, all ids, in its non-default unit
    where it has one (branch_i_magn's units are the string "pu")."""
    plan = []
    for var, units in STATE_VARIABLES.items():
        units = (units,) if isinstance(units, str) else units
        plan.append((var, "all", units[1] if len(units) > 1 else units[0]))
    return plan


def plan_segments(plan, spec):
    """(variable, unit, slice, scale) of each segment of ``plan`` (an
    ObsPlan over ``spec``); ``scale`` [n_ids] is the unit's value of 1 p.u."""
    segs, off = [], 0
    for var, ids, unit in plan.values:
        k = len(ids)
        if unit in ("MW", "MVAr", "MVA", "MWh"):
            scale = torch.full((k,), float(spec.baseMVA), dtype=torch.float64)
        elif unit == "kV":
            scale = torch.tensor(spec.base_kv, dtype=torch.float64)
        elif unit == "kA":
            scale = spec.baseMVA / torch.tensor(spec.base_kv, dtype=torch.float64)
        elif unit == "degree":
            scale = torch.full((k,), 180.0 / math.pi, dtype=torch.float64)
        else:
            scale = torch.ones(k, dtype=torch.float64)
        segs.append((var, unit, slice(off, off + k), scale))
        off += k
    return segs


def replay_anm6easy(VecEnv, make_anm6easy_task, plan, build_ybus, record):
    """The card's first ANM6Easy steps replayed through the port's float64
    step on the CPU, from the card's pre-step states.  ``record`` holds per
    step (state, action, the plan's extract before the clip, reward, done,
    residual) of the check lanes.

    Tolerances, per live lane and entry, to first order.  The f32 solve's
    [θ, |V|] lies within J⁻¹·δF of the f64 solution, with J the exact
    Jacobian there and |δF| ≤ r32 + r64 (+ the f32 rounding of the residual
    itself) componentwise, r32 and r64 the two solves' final ‖F‖∞.  An entry
    x of the extract, with G = ∂x/∂[θ, |V|] taken by central differences
    through the port's own float64 code at forced voltages, then lies within
    |G·J⁻¹|·1·δF, plus its float32 evaluation error 16·ε·(1 p.u. + |x| +
    |G|·[1, |V|]) (ε = 2⁻²⁴, the inputs rounded by ε).  Current angles are
    compared where this bound is under 0.1 rad; a flow's sign within its
    tolerance of zero is not compared.  The reward is held to the errors of
    the observed entries it is made of (|Δr| ≤ Δt·(2·Σ|Δp_dev| + Σ|Δp_pot|)
    + λ·Δt·(Σ|Δ|V|| + Σ|Δ|s||), the clips being 1-Lipschitz) plus its
    float32 rounding.  The clip to the plan's bounds must move the same
    entries as on the CPU, except within tolerance of a bound.

    Two controls must fail these limits: C1, the f64 solution moved by
    10·J⁻¹·(δF·σ) (σ = ±1 at random: a solve ten times less accurate than
    both residuals say), in every segment that depends on the voltages and
    in the reward; C2, every entry off by 2⁻¹⁴ of (|x| + 1 p.u.), in every
    segment."""
    from gym_anm_torch.physics.complexops import cmatvec
    from gym_anm_torch.physics.power_flow import NRResult, _assemble_v
    from gym_anm_torch.physics.power_flow import _jacobian as jacobian
    from gym_anm_torch.vec.core import tree_map

    tm = importlib.import_module("gym_anm_torch.physics.transition")
    eps = 2.0 ** -24
    ref = VecEnv(make_anm6easy_task(), dtype=torch.float64, obs=plan, device="cpu")
    spec, tb = ref.spec, ref.tables
    n, n_load, n_gen = spec.n_bus - 1, spec.n_load, spec.n_gen
    Yre, Yim = build_ybus(tb.n_bus, tb.br_f, tb.br_t, tb.series_re, tb.series_im, tb.shunt_im, tb.shift_cos,
                          tb.shift_sin, tb.tap0[None])
    Yre, Yim = Yre[0], Yim[0]
    segs = plan_segments(ref._obs_plan, spec)
    seg = {var: (sl, scale) for var, _, sl, scale in segs}
    scale = torch.cat([s for *_, s in segs])
    half = torch.zeros_like(scale)
    for var, unit, sl, _ in segs:
        if var in ("bus_v_ang", "bus_i_ang", "branch_i_ang"):
            half[sl] = 180.0 if unit == "degree" else math.pi
    is_ang = half > 0
    i_ang = torch.zeros_like(is_ang)
    for var in ("bus_i_ang", "branch_i_ang"):
        i_ang[seg[var][0]] = True
    low, high = ref.obs_low, ref.obs_high
    c1_cost, c2_cost = ref.costs_clipping
    sigma_g = torch.Generator().manual_seed(81)

    def fields(o):
        """The transition output's quantities the plan reads, each smooth in
        the voltages (magnitudes that can be 0 are bounded by their parts)."""
        return {"vm": torch.hypot(o.bus_v_re, o.bus_v_im), "va": torch.atan2(o.bus_v_im, o.bus_v_re),
                "i_re": o.bus_i_re, "i_im": o.bus_i_im, "bus_p": o.bus_p, "bus_q": o.bus_q, "dev_p": o.dev_p,
                "dev_q": o.dev_q, "p_f": o.br_p_from, "q_f": o.br_q_from, "p_t": o.br_p_to, "q_t": o.br_q_to,
                "if_re": o.br_i_from_re, "if_im": o.br_i_from_im}

    def wrap(dx):  # ±180° are one angle
        return torch.where(is_ang, torch.remainder(dx + half, 2 * half) - half, dx)

    worst = {v: [0.0, 0.0, 0.0] for v, *_ in segs}  # sound run, C1, C2: worst error over its tolerance
    worst_r, worst_r_c1, r_tols = 0.0, 0.0, []
    n_live = n_skipped = n_clip = n_clip_near = 0
    for pre, a, x32, r32, d32, diff32 in record:
        st = tree_map(lambda x: x.double() if x.is_floating_point() else x, pre)
        s_t = ref._state_vector(st.dev_p, st.dev_q, st.soc, st.p_pot, st.aux)
        vars, _ = ref.task.next_vars_fn(None, s_t, st.task, st.t)
        args = (vars[:, :n_load], vars[:, n_load:n_load + n_gen], *ref.split_action(a.double()), st.soc)
        aux = vars[:, n_load + n_gen:]
        out = ref._run_transition(*args)
        x64 = ref._obs_plan.extract(out, out.des_soc, aux)
        _, _, r64, d64, info64 = ref.step(st, a.double())
        assert torch.equal(d64, d32), "a lane is done on the card and not on the CPU, or the reverse"
        live = ~d32
        L = int(live.sum())
        n_live += L

        def at(v):
            """The transition output, extract and reward with the voltages
            forced to [θ, |V|] = v."""
            v_re, v_im = _assemble_v(v[:, :n], v[:, n:])
            ok = torch.ones(v.shape[0], dtype=torch.bool)
            zero = torch.zeros(v.shape[0], dtype=torch.float64)
            real = tm.nr_solve
            tm.nr_solve = lambda *_, **__: NRResult(v_re, v_im, zero.int(), zero, ok, ok)
            try:
                o = ref._run_transition(*args)
            finally:
                tm.nr_solve = real
            e = torch.sign(o.e_loss) * torch.clamp(o.e_loss.abs(), 0.0, c1_cost)
            return o, ref._obs_plan.extract(o, o.des_soc, aux), -(e + torch.clamp(o.penalty, 0.0, c2_cost))

        sol = tm.solution_guess(out)
        h = 1e-6
        ups, downs = zip(*[(fields(at(sol + h * e)[0]), fields(at(sol - h * e)[0]))
                           for e in torch.eye(2 * n, dtype=torch.float64)])
        v_re, v_im = out.bus_v_re[live], out.bus_v_im[live]
        yv_re, yv_im = cmatvec(Yre, Yim, v_re, v_im)
        J_inv = torch.linalg.inv(jacobian(v_re, v_im, yv_re, yv_im, Yre, Yim, n))
        dF = diff32.double()[live] + out.diff[live] + 4 * eps  # + the f32 residual's own rounding
        w = torch.cat([torch.ones(L, n, dtype=torch.float64), sol[live, n:]], 1)
        f64 = {f: x[live] for f, x in fields(out).items()}
        ft = {}  # each field's tolerance, p.u.
        for f in f64:
            G = (torch.stack([u[f] - d[f] for u, d in zip(ups, downs)], -1) / (2 * h))[live]  # [L, m, 2n]
            ft[f] = ((G @ J_inv).abs().sum(-1) * dF[:, None]
                     + 16 * eps * ((G.abs() * w[:, None, :]).sum(-1) + f64[f].abs()))
        seg_tol = {
            "bus_p": ft["bus_p"], "bus_q": ft["bus_q"], "dev_p": ft["dev_p"], "dev_q": ft["dev_q"],
            "branch_p": ft["p_f"], "branch_q": ft["q_f"], "branch_i_magn": ft["if_re"],
            "bus_v_magn": ft["vm"], "bus_v_ang": ft["va"], "bus_i_magn": ft["i_re"] + ft["i_im"],
            "bus_i_ang": (ft["i_re"] + ft["i_im"]) / torch.hypot(f64["i_re"], f64["i_im"]),
            "branch_s": torch.maximum(ft["p_f"] + ft["q_f"], ft["p_t"] + ft["q_t"]),
            "branch_i_ang": (ft["if_re"] + ft["if_im"]) / torch.hypot(f64["if_re"], f64["if_im"]),
        }
        xl32, xl64 = x32.double()[live], x64[live]
        tol_v = torch.zeros_like(xl64)
        for var, _, sl, s in segs:
            if var in seg_tol:
                tol_v[:, sl] = seg_tol[var] * s
        tol = tol_v + 16 * eps * (scale + xl64.abs())
        compare = ~(i_ang & ~(tol_v <= 0.1 * scale))
        n_skipped += int((~compare).sum())
        # sign(p_from) of a flow within its tolerance of zero is a coin flip.
        sl_p, sl_s = seg["branch_p"][0], seg["branch_s"][0]
        near0 = torch.zeros_like(compare)
        near0[:, sl_s] = xl64[:, sl_p].abs() <= tol[:, sl_p]

        def ratio(x):
            err = torch.where(near0, (x.abs() - xl64.abs()).abs(), wrap(x - xl64).abs())
            return torch.where(compare, err / tol, torch.zeros_like(tol))

        sigma = torch.randint(0, 2, (L, 2 * n), generator=sigma_g, dtype=torch.float64) * 2 - 1
        moved = torch.zeros_like(sol)
        moved[live] = sol[live] + 10 * (J_inv @ (sigma * dF[:, None]).unsqueeze(-1)).squeeze(-1)
        _, x_c1, r_c1 = at(torch.where(live[:, None], moved, sol))
        c2 = xl64 + 2.0 ** -14 * (xl64.abs() + scale)
        for k, x in enumerate((xl32, x_c1[live], c2)):
            rat = ratio(x)
            for var, _, sl, _ in segs:
                worst[var][k] = max(worst[var][k], float(rat[:, sl].max()) if L else 0.0)
            if k == 0:
                bad = rat > 1
                assert not bad.any(), f"{[v for v, _, sl, _ in segs if bad[:, sl].any()]} off their tolerance"

        # The reward, from the errors of the observed entries it is made of.
        def pu_err(var, signless=False):
            sl, s = seg[var]
            d = (xl32[:, sl].abs() - xl64[:, sl].abs()) if signless else (xl32[:, sl] - xl64[:, sl])
            return (d.abs() / s).sum(1)

        sl_d, s_d = seg["dev_p"]
        lam_dt = tb.lamb * tb.delta_t
        r_tol = (tb.delta_t * (2 * pu_err("dev_p") + pu_err("gen_p_max"))
                 + lam_dt * (pu_err("bus_v_magn") + pu_err("branch_s", signless=True))
                 + 16 * eps * (1 + info64["e_loss"][live].abs() + info64["penalty"][live]
                               + tb.delta_t * (xl64[:, sl_d].abs() / s_d).sum(1)
                               + lam_dt * ((xl64[:, seg["bus_v_magn"][0]] / seg["bus_v_magn"][1]).sum(1)
                                           + (xl64[:, sl_s].abs() / seg["branch_s"][1]).sum(1))))
        r_tols.append(r_tol)
        r_ratio = (r32.double()[live] - r64[live]).abs() / r_tol
        assert (r_ratio <= 1).all(), f"reward off by {float(r_ratio.max()):.3f}× its tolerance"
        worst_r = max(worst_r, float(r_ratio.max()) if L else 0.0)
        worst_r_c1 = max(worst_r_c1, float(((r_c1[live] - r64[live]).abs() / r_tol).max()) if L else 0.0)

        # The clip: the same entries moved on the card as on the CPU.
        out32 = (xl32 < low.float()) | (xl32 > high.float())  # the card's bounds are float32
        out64 = (xl64 < low) | (xl64 > high)
        near_bound = ((xl64 - low).abs() <= tol) | ((xl64 - high).abs() <= tol)
        assert not ((out32 != out64) & ~near_bound).any(), "the clip moves other entries on the card"
        n_clip += int(out32.sum())
        n_clip_near += int(((out32 != out64) & near_bound).sum())

    r_tols = torch.cat(r_tols)
    log(f"ANM6Easy f32 card vs f64 CPU replay ({len(record)} steps x {N_CHECK_LANES} lanes, {n_live} live "
        f"lane-steps; {n_skipped} current angles with a bound over 0.1 rad not compared): worst error as a share of "
        f"its tolerance, sound run / control C1 (a 10x less accurate solve) / C2 (2^-14 off): " + ", ".join(
            f"{v} {a:.3f}/{b:.3g}/{c:.3g}" for v, (a, b, c) in worst.items())
        + f"; reward {worst_r:.3f}/{worst_r_c1:.3g} (tolerance median {float(r_tols.median()):.3e}, max "
        f"{float(r_tols.max()):.3e}); clipped entries {n_clip}, {n_clip_near} of them clipped on one side only "
        f"within tolerance of a bound")
    for var, (_, c1, c2) in worst.items():
        assert c2 > 1, f"{var}: control C2 passes its tolerance"
        if var not in ("des_soc", "gen_p_max", "aux"):  # the voltages move these
            assert c1 > 1, f"{var}: control C1 passes its tolerance"
    assert worst_r_c1 > 1, "reward: control C1 passes its tolerance"


def phase8_anm6easy(VecEnv, make_anm6easy_task, STATE_VARIABLES, build_ybus, kernel, chord_k, flows_k):
    from gym_anm_torch.vec.core import tree_map

    B, T = B_MAIN, 96
    plan = other_unit_plan(STATE_VARIABLES)
    log(f"== phase 8: ANM6Easy, f32, B={B}, {T} steps (one day) of uniform-random actions, obs plan "
        f"{[(v, u) for v, _, u in plan]}")
    env = VecEnv(make_anm6easy_task(), dtype=torch.float32, obs=plan, device="cuda")
    n = env.spec.n_bus - 1
    low, high = env.obs_low, env.obs_high
    # The plan's extract before the clip to [low, high]: the step's is the
    # first call of each step_autoreset_batch (a reset's follows it).
    extract, extracts = env._obs_plan.extract, []

    def keep_extract(out, soc, aux):
        extracts.append(extract(out, soc, aux))
        return extracts[-1]

    env._obs_plan = env._obs_plan._replace(extract=keep_extract)
    g = torch.Generator(device="cuda").manual_seed(8)
    kernel.launch_count = 0
    chord_k.launch_count = 0
    flows_k.launch_count = 0
    state, obs = env.reset(B, g)
    assert torch.isfinite(obs).all()
    clipped = torch.zeros(env.n_obs, dtype=torch.int64, device="cuda")
    record, iters, n_term = [], [], 0
    for k in range(T):
        a = uniform_actions(env, B, g)
        if k == T // 2:
            # As phase 5: far-off warm starts on every lane (the chord resets
            # them to flat, the Newton fallback solves them with K3 at n = 10)
            # and 64 lanes already terminated.
            state = state._replace(v_guess=bad_guesses(B, n, which=(2, 3)).to("cuda"),
                                   terminated=torch.arange(B, device="cuda") % (B // 64) == 0)
        pre = tree_map(lambda x: x[:N_CHECK_LANES].cpu(), state) if k < N_CHECK_STEPS else None
        extracts.clear()
        state, obs, r, d, info = env.step_autoreset_batch(state, a, g)
        assert torch.isfinite(obs).all() and torch.isfinite(r).all(), f"step {k}: non-finite output"
        live = ~d
        x = extracts[0]
        clipped += (((x < low) | (x > high)) & live[:, None]).sum(0)
        worst = float(info["diff"][live].max()) if live.any() else 0.0
        assert worst <= 1e-4, f"step {k}: live-lane residual {worst:.3e} > 1e-4"
        assert (state.t[d] == 0).all(), f"step {k}: a reset lane is not at t = 0"
        t_idx = state.aux[:, -1]
        assert (t_idx == t_idx.round()).all() and (t_idx >= 0).all() and (t_idx < 96).all(), f"step {k}: time index"
        n_term += int(d.sum())
        iters.append(info["n_iter"])
        if pre is not None:
            record.append((pre, a[:N_CHECK_LANES].cpu(), x[:N_CHECK_LANES].cpu(), r[:N_CHECK_LANES].cpu(),
                           d[:N_CHECK_LANES].cpu(), info["diff"][:N_CHECK_LANES].cpu()))
    torch.cuda.synchronize()
    launches, chord_launches, solves = kernel.launch_count, chord_k.launch_count, kernel.solves
    flows_launches = flows_k.launch_count
    it = torch.stack(iters).float()
    log(f"ANM6Easy: K2 launches {chord_launches} (n = {n}), K6 {flows_launches}, K3 launches {launches} "
        f"(n = {2 * n}; K1 solves inside it {solves}); {n_term} lane "
        f"terminations (reset) in {T} steps; chord iterations mean {float(it.mean()):.3f}, worst lane {int(it.max())}")
    assert chord_launches > 0 and launches > 0 and solves > 0, "K2 or K3 never launched on the ANM6Easy path"
    assert flows_launches > 0, "K6 never launched on the ANM6Easy path"
    clipped = clipped.cpu()
    log("live-lane entries the clip to the plan's bounds moved, by segment: " + ", ".join(
        f"{var} {int(clipped[sl].sum())}" for var, _, sl, _ in plan_segments(env._obs_plan, env.spec)))
    replay_anm6easy(VecEnv, make_anm6easy_task, plan, build_ybus, record)

    env = VecEnv(make_anm6easy_task(), dtype=torch.float32, obs=plan, device="cuda")
    rate, _ = time_path(env, B, env.step_autoreset_batch, 9)

    # Where a step's time goes: wall time inside the Newton fallback (the
    # step's and the resets'; the card synchronized at its entry and exit:
    # one K3 launch a call) against the whole step, and the fallback's Newton
    # iterations (K1's solves inside K3) per step.
    # (by import_module: the package's ``transition`` attribute is the function)
    transition_module = importlib.import_module("gym_anm_torch.physics.transition")
    real_nr, in_nr = transition_module.nr_solve_lazy, [0.0]

    def timed_nr(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_nr(*args, **kwargs)
        torch.cuda.synchronize()
        in_nr[0] += time.perf_counter() - t0
        return out

    n_split = 32
    g_split = torch.Generator(device="cuda").manual_seed(88)
    state, _ = env.reset(B, g_split)
    transition_module.nr_solve_lazy = timed_nr
    try:
        kernel.launch_count = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_split):
            state, *_ = env.step_autoreset_batch(state, uniform_actions(env, B, g_split), g_split)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n_split
    finally:
        transition_module.nr_solve_lazy = real_nr
    nr = in_nr[0] / n_split
    k3_launches, k3_solves = kernel.launch_count, kernel.solves
    # K3's own device time on the same steps (torch.profiler): the host clock
    # above also holds the wrapper's Python and the syncs.
    from torch.profiler import ProfilerActivity, profile

    g_split = torch.Generator(device="cuda").manual_seed(88)
    state, _ = env.reset(B, g_split)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n_split):
            state, *_ = env.step_autoreset_batch(state, uniform_actions(env, B, g_split), g_split)
        torch.cuda.synchronize()
    k3_us = sum(e.time_range.end - e.time_range.start for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA and "newton_kernel" in e.name) / n_split
    log(f"ANM6Easy step split ({n_split} steps): wall {1e3 * wall:.3f} ms/step, of which the Newton fallback (K3) "
        f"{1e3 * nr:.3f} ms ({nr / wall:.3f}); K3's device time (torch.profiler, the same steps) {k3_us:.2f} µs a "
        f"step; {k3_launches / n_split:.2f} K3 launches and {k3_solves / n_split:.2f} lane-iterations of Newton "
        f"(K1's solves inside K3) per step")
    return launches, chord_launches, flows_launches, rate, solves


FEEDERS = ((48, 0.6), (64, 0.5), (130, 0.15))  # (buses, load scale): the f64 tier converges at these loads
BLOCKED_FEEDER, B_BLOCKED = (194, 0.1), 64  # K3 wide's device-memory route: the f64 tier's step at 194 buses
D2_FEEDERS = {48: 512, 64: 64}  # D2's lanes: K3 wide resident at 48 buses, on clusters at 64 (64 lanes, 66 at once)


def feeder_env_task(n_bus, scale, n_steps=8):
    """The seeded random radial feeder of ``n_bus`` buses and its task
    (gym_anm_torch.networks.random_feeder; the CPU tests' feeders)."""
    from gym_anm_torch.networks.random_feeder import feeder_vars, make_feeder_task, random_radial_network

    rng = np.random.default_rng(n_bus)
    net = random_radial_network(rng, n_bus)
    return make_feeder_task(net, feeder_vars(net, scale, n_steps, rng), name=f"feeder{n_bus}")


def phase10_feeders(pf, lin, cuda_k, VecEnv, kernel, nc):
    """Networks above 33 buses (ROADMAP F3): random radial feeders of 48, 64
    and 130 buses at B = 8192.  The wide chord kernel against its plain
    version on a real step's injections from flat, warm and bad-basin
    starts; K1's blocked route (n = 258) against its plain version, bitwise
    in float32 and float64, timed beside ``torch.linalg.solve_ex``; K1's routes at their edges and the feeders'
    other sizes (``phase10_k1_routes``); then the feeders' path: a float32
    VecEnv, 4 steps of uniform-random actions and one from bad-basin warm
    starts (the Newton fallback: K3 wide at n = 94, 126 and 258), each step
    under ``set_sync_debug_mode("error")``, every output finite, live
    residuals within 1e-4, no lane terminated, the first 256 lanes' voltages
    within 1e-4 of the float64 tier's on the card (K3 wide in float64), each
    feeder's fallback on the route the wrapper's rule gives its batch, no
    standalone K1 launch, the bad-basin step's peak device memory; then a
    step of the float64 tier on the feeder of BLOCKED_FEEDER buses (K3
    wide's device-memory route); then K3 wide's
    sets on the bad-basin steps' inputs (``phase10_newton_wide``).
    ``kernel`` is the run's K3Counts (K1's solves inside K3 wide, from its
    outputs), ``nc`` K3's wrapper (its route tally).  Returns the wide chord
    kernel's, K1's blocked route's, K1's shared-memory route's and K3
    wide's numbers for the kernels' line, their launches those of the
    float32 path alone (K1's: its solves inside K3 wide on each route), K3
    wide's device-memory route's those of the 194-bus float64 step."""
    from gym_anm_torch.bench.kernel_probes import step_chord_inputs

    log(f"== phase 10: random radial feeders above 33 buses, B={B_MAIN}")
    wide, blocked = {"errs": []}, {}
    for n_bus, scale in FEEDERS:
        task = feeder_env_task(n_bus, scale)
        ct, args, warm = step_chord_inputs(task, B_MAIN, 4, n_bus)
        n = ct.n
        for name, x0 in (("flat start", None), ("warm starts of a step", warm),
                         ("bad-basin guesses", bad_guesses(B_MAIN, n).to("cuda"))):
            err, t_k, t_p, bound_ms, bound_by = chord_vs_plain(
                pf, cuda_k, f"wide, {n_bus}-bus feeder, {name}", ct, args, x0)
            wide["errs"].append(err)
            if n_bus == 130 and x0 is warm:
                wide.update(ms=t_k, plain_ms=t_p, bound_ms=bound_ms, bound_by=bound_by)

    # K1 above the card's shared memory per block: n = 258 (the 130-bus feeder).
    n = 258
    for B, dtype in ((B_MAIN, torch.float32), (1001, torch.float64)):
        A, b = systems(B, n, dtype, seed=n)
        before = lin.solve_gauss_jordan_cuda.launches["blocked"]
        xk = lin.solve_gauss_jordan_cuda(A, b)
        xp = lin.solve_gauss_jordan(A, b)
        torch.cuda.synchronize()
        assert lin.solve_gauss_jordan_cuda.launches["blocked"] == before + 1, "K1's blocked route did not run"
        assert not torch.isfinite(xk[1]).all() and not torch.isfinite(xp[1]).all(), "zero pivot repaired"
        keep = torch.ones(B, dtype=torch.bool, device="cuda")
        keep[1] = False
        err = float((xk[keep] - xp[keep]).abs().max())
        rel = err / float(xp[keep].abs().max())
        log(f"K1 blocked B={B} n={n} {dtype}: max_abs_err={err:.3e} rel={rel:.3e}; bitwise equal on "
            f"{int((xk[keep] == xp[keep]).all(1).sum())} of {B - 1} finite lanes")
        assert torch.equal(xk[keep], xp[keep]), f"K1 {dtype} blocked is not bitwise equal to its plain version"
        if dtype == torch.float64:
            continue
        # Since K3 wide no path launches this route on its own: its readings are cut to 5 launches, median of 3.
        t = {key: statistics.median(cuda_ms(fn, k) for _ in range(r)) for key, fn, k, r in (
            ("ms", lambda: lin.solve_gauss_jordan_cuda(A, b), 5, 3),
            ("library_ms", lambda: torch.linalg.solve_ex(A, b), 5, 3),
            ("plain_ms", lambda: lin.solve_gauss_jordan(A, b), 1, 1))}
        bound_ms, bound_by = k1_bound(B, n)
        log(f"K1 blocked time B={B} n={n} f32 (device time; kernel and solve_ex 5 launches a reading, median "
            f"of 3; plain 1 launch): kernel {t['ms']:.4f} ms, torch.linalg.solve_ex {t['library_ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}), kernel at {bound_ms / t['ms']:.4f} of it")
        blocked = dict(t, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err)

    resident = phase10_k1_routes(lin)

    # The feeders' path, the float32 tier: the counts zeroed just before each
    # of its calls and read just after, so that the float64 tier that checks
    # it (on the card too, K3 wide) is counted apart.  Every float32 step runs
    # under set_sync_debug_mode("error"): the Newton loop reads no flag on the
    # host.  The bad-basin step's fallback inputs are kept for K3 wide's sets.
    tm = importlib.import_module("gym_anm_torch.physics.transition")
    k1 = lin.solve_gauss_jordan_cuda
    routes = nc.launches_by_route
    keys = ("wide", "k1", "k3w", "smem", "cluster", "blocked", "smem_solves", "cluster_solves", "blocked_solves")

    def counted(tally, fn, *args, strict=False):
        cuda_k.launches["wide"] = k1.launch_count = kernel.launch_count = 0
        routes["smem"] = routes["cluster"] = routes["blocked"] = 0
        if strict:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        solves = kernel.solves  # read after the call: K3 wide's lane-iterations
        for key, got in (("wide", cuda_k.launches["wide"]), ("k1", k1.launch_count),
                         ("k3w", routes["smem"] + routes["cluster"] + routes["blocked"]), ("smem", routes["smem"]),
                         ("cluster", routes["cluster"]), ("blocked", routes["blocked"]),
                         ("smem_solves", solves if routes["smem"] else 0),
                         ("cluster_solves", solves if routes["cluster"] else 0),
                         ("blocked_solves", solves if routes["blocked"] else 0)):
            tally[key] += got
        return out

    counts = dict.fromkeys(keys, 0)
    fallback_inputs = {}
    for n_bus, scale in FEEDERS:
        task = feeder_env_task(n_bus, scale)
        env = VecEnv(task, dtype=torch.float32, device="cuda")
        ref = VecEnv(task, dtype=torch.float64, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(100 + n_bus)
        n = env.spec.n_bus - 1
        f32, f32_bad, f64 = (dict.fromkeys(keys, 0) for _ in range(3))
        t0 = time.perf_counter()
        state, obs = counted(f32, env.reset, B_MAIN, g)
        s64, _ = counted(f64, ref.reset, N_CHECK_LANES)
        worst_vm, peak = 0.0, None
        for k in range(5):
            a = uniform_actions(env, B_MAIN, g)
            real, seen = tm.nr_solve_lazy, []
            if k == 4:
                state = state._replace(v_guess=bad_guesses(B_MAIN, n, which=(2, 3)).to("cuda"))

                def capture(ybus_fn, p, q, **kw):
                    seen.append((ybus_fn, p, q, kw["init"]))
                    return real(ybus_fn, p, q, **kw)

                tm.nr_solve_lazy = capture
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
            try:
                state, obs, r, d, info = counted(f32_bad if k == 4 else f32, env.step, state, a, strict=True)
            finally:
                tm.nr_solve_lazy = real
            if k == 4:
                torch.cuda.synchronize()
                peak = (torch.cuda.max_memory_allocated() - held, torch.cuda.max_memory_allocated())
                fallback_inputs[n_bus] = (seen[0], ref.tables)
            check_step(obs, r, d, info, f"{n_bus}-bus feeder step {k}")
            s64, _, _, d64, info64 = counted(f64, ref.step, s64, a[:N_CHECK_LANES].double())
            assert not d64.any() and float(info64["diff"].max()) <= 1e-5
            worst_vm = max(worst_vm, float((state.bus_vm[:N_CHECK_LANES].double() - s64.bus_vm).abs().max()))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for key in counts:
            counts[key] += f32[key] + f32_bad[key]
        route32, route64 = wide_route(2 * n, torch.float32, B_MAIN), wide_route(2 * n, torch.float64, N_CHECK_LANES)
        log(f"{n_bus}-bus feeder path (n = {2 * n}): 5 f32 steps at B={B_MAIN} and the f64 tier's on {N_CHECK_LANES} "
            f"lanes in {wall:.2f} s; f32 path: wide chord launches {f32['wide'] + f32_bad['wide']}, K3 wide launches "
            f"{f32['k3w'] + f32_bad['k3w']} on route {route32} ({f32_bad['k3w']} in the bad-basin step, "
            f"{f32_bad['smem_solves'] + f32_bad['cluster_solves'] + f32_bad['blocked_solves']} lane-iterations), "
            f"standalone K1 launches "
            f"{f32['k1'] + f32_bad['k1']}, host syncs 0 in every step (set_sync_debug_mode(\"error\")); the "
            f"bad-basin step's peak device memory {peak[0] / 2**20:.1f} MiB above the {(peak[1] - peak[0]) / 2**20:.1f} "
            f"MiB held before it ({peak[1] / 2**20:.1f} MiB in all); f64 tier: K3 wide launches {f64['k3w']} on route "
            f"{route64}, standalone K1 launches {f64['k1']}; f32 voltages against the f64 tier on {N_CHECK_LANES} "
            f"lanes: max abs diff {worst_vm:.3e}")
        assert f32["wide"] + f32_bad["wide"] > 0, "the wide chord kernel never launched on the feeder path"
        assert f32_bad["k3w"] == 1 and f32_bad[route32] == 1 and f32_bad[route32 + "_solves"] > 0, \
            f"the f32 fallback did not run K3 wide's {route32} route in the bad-basin step"
        assert f64[route64] > 0, f"the f64 tier did not run K3 wide's {route64} route on the {n_bus}-bus feeder"
        assert f32["k1"] + f32_bad["k1"] + f64["k1"] == 0, "K1 launched on its own on the feeders' path"
        # The JAX package's bar for random feeders (tests/test_random_networks.py:143): the f32
        # chord stops within ||F|| <= 1e-5 (1e-4 on a plateau), and these feeders' voltages are
        # more sensitive to the residual than IEEE33's (5e-5 above).
        assert worst_vm <= 1e-4, f"{n_bus}-bus feeder: f32 voltages off the f64 tier's by {worst_vm:.3e}"
        if n_bus == 130:
            wide_peak = peak
    # K3 wide's device-memory route on a path a user runs: a step of the
    # float64 tier (VecEnv; the reference's exact loop from the flat start
    # over the dense Y, nr_solve) on the feeder of BLOCKED_FEEDER buses
    # (float64 n = 386, above what a cluster of 8 holds on an H100), its
    # counts zeroed just before and read just after; the step's Newton
    # inputs kept for K3 wide's sets.
    n_bus, scale = BLOCKED_FEEDER
    ref = VecEnv(feeder_env_task(n_bus, scale), dtype=torch.float64, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(100 + n_bus)
    s64, _ = ref.reset(B_BLOCKED, g)
    real, seen = tm.nr_solve, []

    def capture(Yre, Yim, p, q, **kw):
        seen.append((Yre, Yim, p, q))
        return real(Yre, Yim, p, q, **kw)

    tm.nr_solve = capture
    blk = dict.fromkeys(keys, 0)
    t0 = time.perf_counter()
    try:
        _, obs, r, d, info = counted(blk, ref.step, s64, uniform_actions(ref, B_BLOCKED, g))
    finally:
        tm.nr_solve = real
    torch.cuda.synchronize()
    check_step(obs, r, d, info, f"{n_bus}-bus feeder, float64 tier")
    route = wide_route(2 * (n_bus - 1), torch.float64, B_BLOCKED, lane_y=False)
    log(f"{n_bus}-bus feeder path, the float64 tier (n = {2 * (n_bus - 1)}): a step at B={B_BLOCKED} in "
        f"{time.perf_counter() - t0:.2f} s: K3 wide launches {blk['k3w']} on route {route} "
        f"({blk['blocked_solves']} lane-iterations), standalone K1 launches {blk['k1']}")
    assert route == "blocked" and blk["blocked"] == 1 and blk["blocked_solves"] > 0 and blk["k1"] == 0, \
        f"the {n_bus}-bus float64 step did not run K3 wide's device-memory route once"
    wide["max_abs_err"] = max(wide.pop("errs"))
    k3w = phase10_newton_wide(pf, lin, nc, fallback_inputs, tuple(t.contiguous() for t in seen[-1]))
    k3w["peak_step"] = wide_peak
    return (dict(wide, launches=counts["wide"]), dict(blocked, launches=counts["blocked_solves"]),
            dict(resident, launches=counts["smem_solves"]), dict(k3w, launches=counts["k3w"] + blk["k3w"],
                                                                   by_route=(counts["smem"], counts["cluster"],
                                                                             blk["blocked"])))


def wide_route(n, dtype, B, lane_y=True):
    """K3 wide's route for B lanes at n unknowns of ``dtype`` on this card
    (the wrapper's rule, ``newton_cuda.wide_launch``)."""
    from gym_anm_torch._build import load_library
    from gym_anm_torch.physics.newton_cuda import wide_launch

    return wide_launch(load_library(), n, dtype, B, lane_y)[0]


def timed(fn, budget_ms=200.0):
    """Device ms of ``fn`` (``cuda_ms``): as many launches a reading as fit
    ``budget_ms`` (1 to N_LAUNCH), the median of N_REPS readings, 3 where a
    call takes over 10 ms."""
    t1 = cuda_ms(fn, 1)
    k = max(1, min(N_LAUNCH, int(budget_ms / max(t1, 1e-3))))
    return statistics.median(cuda_ms(fn, k) for _ in range(3 if t1 > 10.0 else N_REPS))


def k3_wide_vs_plain(pf, lin, nc, name, args, ybus, plain_ybus, route, xtol=1e-5, lim_iter=100, memory=False):
    """K3 wide and its plain version (``_newton_loop`` with the plain
    Gauss-Jordan solve) on the same card inputs ``args`` = (x, F, diff,
    n_iter, accepted or None, p, q): one launch on ``route``, every lane
    bitwise (x, F, diff, n_iter, stall).  Times the kernel, the plain
    version once, with the bound; ``memory``: the peak device memory of a
    call, above what was held before it."""
    x, F, diff, it, acc, p, q = args
    B, n = x.shape
    f32 = p.dtype == torch.float32
    acc0 = torch.zeros(B, dtype=torch.bool, device="cuda") if acc is None else acc
    call = lambda: nc(x, F, diff, it, acc, p, q, ybus, xtol, lim_iter)  # noqa: E731
    before = nc.launches_by_route[route]
    out_k = call()
    torch.cuda.synchronize()
    assert nc.launches_by_route[route] == before + 1, f"K3 wide did not launch once on route {route}"
    plain = []
    plain_ms = cuda_ms(lambda: plain.append(pf._newton_loop(x, F, diff, it, ~acc0, plain_ybus, p, q, xtol, lim_iter,
                                                            f32, lin.solve_gauss_jordan)), 1)

    n_bit = int((bitwise_rows(out_k[0], plain[0][0]) & bitwise_rows(out_k[1], plain[0][1])
                 & bitwise_rows(out_k[2], plain[0][2]) & (out_k[3] == plain[0][3]) & (out_k[4] == plain[0][4])).sum())
    rk = pf._nr_result(*out_k, acc0, xtol, f32)
    lane_iters = int((out_k[3] - it).sum())
    n_go = int(((out_k[3] - it) > 0).sum())
    max_it = int((out_k[3] - it).max())
    log(f"K3 wide {name} B={B} n={n} {p.dtype} (route {route}): {n_go} lanes iterated, "
        f"{lane_iters} lane-iterations (max {max_it}); stable {int(rk.stable.sum())}, converged "
        f"{int(rk.converged.sum())}; bitwise equal to the plain version (x, F, diff, n_iter, stall) on {n_bit} of "
        f"{B} lanes")
    assert n_bit == B, f"K3 wide differs from its plain version on {B - n_bit} lanes"
    out = dict(max_abs_err=0.0, lane_iters=lane_iters, max_it=max_it, plain_ms=plain_ms,  # bitwise, asserted
               out=out_k)
    if memory:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        call()
        torch.cuda.synchronize()
        out["peak_kernel"] = torch.cuda.max_memory_allocated() - held
    out["ms"] = timed(call, budget_ms=50.0)
    if hasattr(ybus, "tap_magn"):  # a LaneYbus: the taps and the branch tables
        y_bytes = x.element_size() * (ybus.tap_magn.numel() + 5 * ybus.f.numel()) + 16 * ybus.f.numel()
    else:
        y_bytes = x.element_size() * sum(t.numel() for t in ybus)
    out["bound_ms"], out["bound_by"] = k3_bound(B, n, x.element_size(), lane_iters, y_bytes)
    per_it = f"{1e3 * out['ms'] / max_it:.2f} µs an iteration of the slowest lane" if max_it else "no lane iterates"
    log(f"K3 wide {name} time (device time, median of {N_REPS} readings, 3 above 10 ms a call): kernel "
        f"{out['ms']:.4f} ms, plain {plain_ms:.4f} ms (one call); bound {out['bound_ms']:.4f} ms "
        f"({out['bound_by']}, {lane_iters} lane-iterations), kernel at {out['bound_ms'] / out['ms']:.4f} of it; "
        f"{per_it}" + (f"; peak device memory of a call {out['peak_kernel'] / 2**20:.1f} MiB" if memory else ""))
    return out


def chord64(pf, t64, ybus64, p, q, x0):
    """The plain float64 chord's exit ``(x, F, diff, n_iter, accepted)`` on
    the card from the warm starts ``x0``."""
    B = p.shape[0]
    if t64.chord_has_oltc:
        inv_da = 1.0 / ybus64.tap_magn[:, int(t64.oltc_branch[0])] - 1.0 / t64.chord_a0
        dr, di = -t64.chord_y_re * inv_da, -t64.chord_y_im * inv_da
    else:
        dr = di = torch.zeros(B, dtype=torch.float64, device="cuda")
    return tuple(t.contiguous() for t in pf.chord_solve_plain(p, q, di, dr, dr, di, t64.chord_t, x0=x0))


def d2_card_vs_cpu(pf, name, ybus64, p, q, init, share=1e-3, tol=1e-10):
    """ROADMAP D2: the float64 tier's ``nr_solve_lazy`` on the card (K3 or
    K3 wide: Y V in ``_fold_sum``'s order, CUDA's sin, cos and sqrt) against
    the CPU's (BLAS's order, torch's CPU functions) from the same chord exit
    ``init``, on lanes that diverge; beside it the CPU against itself with
    the card's order (``_fold_sum``), which shows how many flips the order
    alone makes.  Gates: the lanes whose ``stable`` flag differs at most
    ``share`` of the batch; on the lanes stable in both with equal
    ``n_iter``, the voltages within ``tol``.  Counts apart the lanes whose
    ``converged`` flag differs (NaN on one device only, on lanes unstable
    on both in this repo's runs): the bound of ``share`` on both flags is
    not met, by the card or by the CPU's two orders (ROADMAP D2), so it is
    printed, not gated; the card test
    ``test_float64_tier_card_against_cpu_on_diverging_lanes`` asserts it.
    Returns (converged flips, stable flips, max |dV|, the CPU's own
    converged flips)."""
    from gym_anm_torch.physics.ybus import LaneYbus

    rc = pf.nr_solve_lazy(ybus64, p, q, init=init)
    cpu = lambda t: t.cpu()  # noqa: E731
    yh = LaneYbus(ybus64.n_bus, *(cpu(t) for t in (ybus64.f, ybus64.t, ybus64.series_re, ybus64.series_im,
                                                   ybus64.shunt_im, ybus64.shift_cos, ybus64.shift_sin,
                                                   ybus64.tap_magn)))
    host = (yh, cpu(p), cpu(q))
    rh = pf.nr_solve_lazy(*host, init=tuple(cpu(t) for t in init))
    blas = pf._ybus_matvec

    def fold(Yre, Yim, v_re, v_im):  # the card's order on the CPU
        dot = lambda M, v: pf._fold_sum(M * v.unsqueeze(-2))  # noqa: E731
        return dot(Yre, v_re) - dot(Yim, v_im), dot(Yre, v_im) + dot(Yim, v_re)

    pf._ybus_matvec = fold
    try:
        rf = pf.nr_solve_lazy(*host, init=tuple(cpu(t) for t in init))
    finally:
        pf._ybus_matvec = blas
    B = p.shape[0]
    conv, stab, it = (cpu(getattr(rc, k)) for k in ("converged", "stable", "n_iter"))
    conv_flip, stab_flip = conv != rh.converged, stab != rh.stable
    unstable_both = ~stab & ~rh.stable
    both = stab & rh.stable & (it == rh.n_iter)
    dv = max(float((cpu(rc.v_re) - rh.v_re)[both].abs().max()), float((cpu(rc.v_im) - rh.v_im)[both].abs().max())) \
        if bool(both.any()) else 0.0
    n_conv, n_stab = int(conv_flip.sum()), int(stab_flip.sum())
    n_own, n_own_stab = int((rf.converged != rh.converged).sum()), int((rf.stable != rh.stable).sum())
    log(f"D2 {name}, float64 nr_solve_lazy card vs CPU, B={B}: {int((~init[4]).sum())} lanes past the chord, card "
        f"stable {int(stab.sum())} / CPU {int(rh.stable.sum())}, converged {int(conv.sum())} / "
        f"{int(rh.converged.sum())}; stable flips {n_stab} (gate <= {share * B:.1f}); converged flips {n_conv} "
        f"({n_conv / B:.5f} of the lanes, {int((conv_flip & unstable_both).sum())} of them unstable on both; "
        f"the bound {share} on both flags: {'met' if n_conv + n_stab <= share * B else 'NOT MET'}); the "
        f"CPU with the card's order against the CPU: converged flips {n_own}, stable flips {n_own_stab}; max |dV| "
        f"on the {int(both.sum())} lanes stable in both with equal n_iter {dv:.3e} (gate {tol:.0e})")
    assert n_stab <= share * B, f"D2 {name}: {n_stab} of {B} lanes flip stable between card and CPU"
    assert dv <= tol, f"D2 {name}: voltages differ by {dv:.3e} between card and CPU"
    return n_conv, n_stab, dv, n_own


def phase10_newton_wide(pf, lin, nc, fallback_inputs, blocked_inputs):
    """K3 wide against its plain version on each feeder's sets, in float32
    and float64, each on the route ``wide_route`` gives its batch: (a) the float32 bad-basin step's
    fallback inputs (B = 8192, the LaneYbus; in float64 the same inputs
    widened, Y from the float64 tables at (a)'s taps), (d) (a)'s lanes all
    accepted (no lane iterates), (f) the tail: one lane of (a) that iterates
    among (d)'s, and (c) float64 from the flat start with a dense Y at B =
    1001 and B = 1; then ``blocked_inputs`` (Yre, Yim, p, q), the float64
    tier's Newton inputs of a step at BLOCKED_FEEDER's buses, from the flat
    start (the device-memory route).  D2 on the 48-bus
    feeder (512 lanes from bad-basin starts, resident) and the 64-bus one
    (64 lanes, on clusters).  Timed at 50 ms of launches a reading.
    Returns the (a) sets' numbers of the resident route (64 buses), the
    cluster route (130 buses) and the device-memory route (194 buses) for
    the kernels' line."""
    from gym_anm_torch.physics.ybus import LaneYbus

    results = {}
    for n_bus, ((ybus, p, q, init), t64) in fallback_inputs.items():
        init = tuple(t.contiguous() for t in init)
        n, B = 2 * p.shape[1], p.shape[0]
        res = results[n_bus] = {}
        ybus64 = LaneYbus(t64.n_bus, t64.br_f, t64.br_t, t64.series_re, t64.series_im, t64.shunt_im,
                          t64.shift_cos, t64.shift_sin, ybus.tap_magn.double())
        p64, q64 = p.double().contiguous(), q.double().contiguous()
        init64 = tuple((t.double() if t.is_floating_point() else t).contiguous() for t in init)
        for dtype, yb, pp, qq, ini in ((torch.float32, ybus, p, q, init), (torch.float64, ybus64, p64, q64, init64)):
            route, tag = wide_route(n, dtype, B), "" if dtype == torch.float32 else " f64"
            res["a" + tag] = k3_wide_vs_plain(pf, lin, nc, f"(a){tag} {n_bus}-bus feeder, the bad-basin "
                                              f"step's fallback", ini + (pp, qq), yb, yb, route,
                                              memory=n_bus == 130 and dtype == torch.float32)
            accepted = torch.ones_like(ini[4])
            res["d" + tag] = k3_wide_vs_plain(pf, lin, nc, f"(d){tag} {n_bus}-bus feeder, no lane iterating",
                                              ini[:4] + (accepted, pp, qq), yb, yb, route)
            go = int(torch.nonzero((ini[2] > 1e-5) & (ini[3] < 100) & ~ini[4])[0])
            tail = accepted.clone()
            tail[go] = False
            res["f" + tag] = k3_wide_vs_plain(pf, lin, nc, f"(f){tag} {n_bus}-bus feeder, one lane among "
                                              f"accepted ones", ini[:4] + (tail, pp, qq), yb, yb, route)
        Yre, Yim = ybus64(slice(0, 1001))
        for BB in (1001, 1):
            Y = (Yre[:BB].contiguous(), Yim[:BB].contiguous())
            pc, qc = p64[:BB].contiguous(), q64[:BB].contiguous()
            res[f"c {BB}"] = k3_wide_vs_plain(pf, lin, nc, f"(c) {n_bus}-bus feeder, float64 from the flat "
                                              f"start", flat_start(pf, *Y, pc, qc) + (None, pc, qc), Y,
                                              dense_oracle(*Y), wide_route(n, torch.float64, BB, False))
        if n_bus in D2_FEEDERS:
            BD = D2_FEEDERS[n_bus]
            x0 = bad_guesses(BD, n // 2, which=(2, 3)).to("cuda", torch.float64)
            yd = LaneYbus(t64.n_bus, t64.br_f, t64.br_t, t64.series_re, t64.series_im, t64.shunt_im, t64.shift_cos,
                          t64.shift_sin, ybus64.tap_magn[:BD].contiguous())
            pd, qd = p64[:BD].contiguous(), q64[:BD].contiguous()
            res["d2"] = d2_card_vs_cpu(pf, f"{n_bus}-bus feeder (K3 wide, route "
                                       f"{wide_route(n, torch.float64, BD)}), bad-basin starts", yd, pd, qd,
                                       chord64(pf, t64, yd, pd, qd, x0))
    Yre, Yim, p, q = blocked_inputs
    B, n = p.shape[0], 2 * p.shape[1]
    results[BLOCKED_FEEDER[0]] = {"a f64": k3_wide_vs_plain(
        pf, lin, nc, f"(a) f64 {BLOCKED_FEEDER[0]}-bus feeder, the float64 tier's step", flat_start(
            pf, Yre, Yim, p, q) + (None, p, q), (Yre, Yim), dense_oracle(Yre, Yim), wide_route(n, p.dtype, B, False))}
    log("K3 wide sets (all bitwise): " + "; ".join(
        f"{n_bus} buses {k}: {v['ms']:.4f} ms (plain {v['plain_ms']:.4f}; bound {v['bound_ms']:.4f}, {v['bound_by']}, at {v['bound_ms'] / v['ms']:.4f}; "
        f"slowest lane {v['max_it']} iterations)"
        for n_bus, sets in results.items() for k, v in sets.items() if k != "d2"))
    a130 = results[130]["a"]
    log(f"K3 wide, the 130-bus bad-basin fallback: peak device memory of a call {a130['peak_kernel'] / 2**20:.1f} MiB")
    for sets in results.values():
        for v in sets.values():
            if isinstance(v, dict):
                v.pop("out", None)
    return dict(resident=results[64]["a"], cluster=a130, blocked=results[BLOCKED_FEEDER[0]]["a f64"])


def admm_bound(dc, B, iterations):
    """K5's bound from a run's per-lane iterations (each one sweep): per
    sweep m·n + (n+m)·n multiply-adds of the two products (float64 sums of
    exact float32 products, at the float64 tensor-core rate) and 14m + 6n
    float32 operations of the elementwise chain; per check (one per K sweeps)
    m·n multiply-adds and 8m + 5n operations more.  Bounds, warm start in and
    out and the solution read or written once per lane, the matrices once."""
    n, m, K = dc.n, dc.m, dc.check_every
    sweeps = int(iterations.sum())
    checks = sweeps // K
    macs = sweeps * (m * n + (n + m) * n) + checks * m * n
    t_ops = 2 * macs / PEAK_F64_TC + (sweeps * (14 * m + 6 * n) + checks * (8 * m + 5 * n)) / PEAK_F32
    n_bytes = 4 * B * (2 * m + 2 * (n + 3 * m) + n + 3) + 3 * B + 4 * (m * n + n * (n + m) + 3 * n + 4 * m)
    t_bytes = n_bytes / HBM
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), sweeps


def admm_vs_plain(mpc, cuda_k, name, dc, l, u, warm, n_launch=N_LAUNCH, plain_launch=3, reps=N_REPS):
    """K5 and its plain version on the same card inputs.  They differ only in
    the order of the products' float64 sums, which moves a float32 rounding
    where a sum lies within an ulp of a tie.  Limits: converged, bounds_ok
    and feasible equal on every lane; iterations equal on >= 99.5% of lanes;
    x within 1e-5 where they are.  Returns the kernel's solution and
    (max |dx|, kernel ms, plain ms, bound ms, what bounds it)."""
    before = cuda_k.launch_count
    sk = cuda_k(dc, l, u, warm)
    torch.cuda.synchronize()
    sp = mpc.solve_dcopf_plain(dc, l, u, warm)
    torch.cuda.synchronize()
    assert cuda_k.launch_count == before + 1
    B = l.shape[0]
    same = sk.iterations == sp.iterations
    flags = {f: int((getattr(sk, f) == getattr(sp, f)).sum()) for f in ("converged", "bounds_ok", "feasible")}
    err = float((sk.x - sp.x)[same].abs().max()) if same.any() else 0.0
    werr = [float((a - b)[same].abs().max()) if same.any() else 0.0 for a, b in zip(sk.warm, sp.warm)]
    it = sk.iterations.float()
    log(f"K5 {name} B={B} (n={dc.n}, m={dc.m}, max_iter {dc.max_iter}): iterations equal on {int(same.sum())} lanes "
        f"(max diff {int((sk.iterations - sp.iterations).abs().max())}), mean {float(it.mean()):.2f}, max "
        f"{int(it.max())}; lanes with equal flags {flags}; converged {int(sk.converged.sum())}, bounds_ok "
        f"{int(sk.bounds_ok.sum())}, feasible {int(sk.feasible.sum())}; max|dx| {err:.3e}, max|d warm| (x, y, z, Ax) "
        f"{', '.join(f'{e:.3e}' for e in werr)}; x bitwise equal on {int((sk.x == sp.x).all(1).sum())} lanes")
    assert all(v == B for v in flags.values()), f"K5 and its plain version disagree on a flag: {flags}"
    assert int(same.sum()) >= B - B // 200, f"K5 iterations differ on {B - int(same.sum())} lanes"
    assert err <= 1e-5, f"K5 x differs by {err:.3e} > 1e-5"
    t_k = statistics.median(cuda_ms(lambda: cuda_k(dc, l, u, warm), n_launch) for _ in range(reps))
    t_p = statistics.median(cuda_ms(lambda: mpc.solve_dcopf_plain(dc, l, u, warm), plain_launch) for _ in range(reps))
    bound_ms, bound_by, sweeps = admm_bound(dc, B, sk.iterations)
    from gym_anm_torch._build import load_library
    from gym_anm_torch.vec.admm_cuda import l2_bytes_per_lane_sweep

    lanes = load_library().admm_stream_lanes(B, dc.n, dc.m)
    where = f"streamed through shared memory, {lanes} lanes a block" if lanes else "staged in shared memory"
    log(f"K5 {name} time (device time, {n_launch} launches per reading, median of {reps}): kernel {t_k:.4f} ms, "
        f"plain {t_p:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}, {sweeps} lane-sweeps), kernel at "
        f"{bound_ms / t_k:.3f} of it; matrix fragments {where}, {l2_bytes_per_lane_sweep(dc.n, dc.m, lanes)} L2 "
        f"bytes per lane-sweep")
    return sk, (err, t_k, t_p, bound_ms, bound_by)


def strict_exit(mpc, dc, sol):
    """Lanes that exited by the strict rule (both residuals within their
    tolerances), from the exit iterate; the others exited by the plateau
    rule, at the budget, or not at all (crossed bounds)."""
    _, y, z, Ax = sol.warm
    t_y = mpc.matmul_full(y, dc.A_bar)
    d_ref = torch.clamp(torch.amax(torch.abs(dc.D_inv * t_y), dim=1) / dc.c_scale, min=dc.q_ref)
    p_ref = mpc._p_ref(dc, Ax, z)
    return (sol.converged & (sol.r_prim <= dc.eps_abs + dc.eps_rel * p_ref)
            & (sol.r_dual <= dc.eps_abs + dc.eps_rel * d_ref))


def face_distance(st, P_load, P_gen, soc, a_hat, fun):
    """The ∞-norm distance (p.u.) from the stage-0 action ``a_hat`` to the
    stage-0 actions of the LP's optimal face (objective within 1e-7 relative
    of HiGHS's ``fun``), by one more HiGHS solve: min s over (x, s) with x
    feasible and optimal and |x[act_idx] − a_hat| <= s.  Where the optimum is
    unique it is the gap to HiGHS's action; on a degenerate LP (a zero-cost
    trade between storage and renewables) any point of the face is as good."""
    from scipy.optimize import linprog
    from scipy.sparse import csr_matrix, hstack, vstack

    lb, ub, b_eq = st.lb.copy(), st.ub.copy(), st.b_eq.copy()
    lb[st.load_pin_idx] = P_load
    ub[st.load_pin_idx] = P_load
    ub[st.gen_cap_idx] = np.minimum(st.gen_pmax[:, None], P_gen)
    b_eq[st.soc_rows] = soc
    n, k = st.n_var, len(st.act_idx)
    S = csr_matrix((np.ones(k), (np.arange(k), st.act_idx)), shape=(k, n))
    one = csr_matrix(np.ones((k, 1)))
    A_ub = vstack([hstack([st.A_ub, csr_matrix((st.A_ub.shape[0], 1))]),
                   hstack([csr_matrix(st.c[None]), csr_matrix((1, 1))]), hstack([S, -one]), hstack([-S, -one])]).tocsr()
    b_ub = np.concatenate([st.b_ub, [fun + 1e-7 * max(1.0, abs(fun))], a_hat, -a_hat])
    c = np.zeros(n + 1)
    c[-1] = 1.0
    res = linprog(c, A_eq=hstack([st.A_eq, csr_matrix((st.A_eq.shape[0], 1))]).tocsr(), b_eq=b_eq, A_ub=A_ub, b_ub=b_ub,
                  bounds=np.concatenate([np.stack([lb, ub], 1), [[0.0, np.inf]]]), method="highs")
    assert res.success, res.message
    return res.fun


def phase9a_admm_kernel(mpc, cuda_k, VecEnv, make_anm6easy_task, make_ieee33_renewable_task):
    """K5 against its plain version on five sets at B = B_MAIN; returns the
    N=1 cold set (for 9b) and the warm set's numbers (the JSON line)."""
    from gym_anm_torch.agents.mpc import build_dcopf_structure

    B = B_MAIN
    log(f"== phase 9a: K5 against its plain version, B={B}")
    g = torch.Generator(device="cuda").manual_seed(90)
    env = VecEnv(make_anm6easy_task(), dtype=torch.float32, device="cuda")
    state, _ = env.reset(B, g)
    spec = env.spec
    load_pos = torch.as_tensor(spec.load_pos, device="cuda")
    st1 = build_dcopf_structure(spec, env.task.delta_t, env.task.lamb, 0.995, 0.96, 1)
    dc1 = mpc.make_vec_dcopf(st1, device="cuda", max_iter=4000)
    l1, u1 = mpc.lane_bounds(dc1, state.dev_p[:, load_pos], state.p_pot, state.soc)
    cold = mpc.init_warm(dc1, B)
    errs = []
    sol1, r = admm_vs_plain(mpc, cuda_k, "ANM6Easy N=1 cold (reset states)", dc1, l1, u1, cold, 3, 1, 3)
    errs.append(r[0])
    # The farm's call (bench.py workload 4): warm starts at the budget of 48.
    _, warm_r = admm_vs_plain(mpc, cuda_k, "ANM6Easy N=1 warm from its own solutions, budget 48",
                              dc1._replace(max_iter=48), l1, u1, sol1.warm)
    errs.append(warm_r[0])
    # The perfect-forecast N=4 LP (time-varying pins and caps) and the IEEE33
    # renewable N=1 LP (n = 111, m = 218: the matrices, 241 KB, stay in L2),
    # cold; max_iter 400 keeps their plain version's time inside the run.
    st4 = build_dcopf_structure(spec, env.task.delta_t, env.task.lamb, 0.995, 0.96, 4)
    dc4 = mpc.make_vec_dcopf(st4, device="cuda", max_iter=400)
    P_load4, P_pot4 = mpc.profile_forecast_fn(env, 4)(state)
    l4, u4 = mpc.lane_bounds(dc4, P_load4, P_pot4, state.soc)
    errs.append(admm_vs_plain(mpc, cuda_k, "ANM6Easy N=4 perfect forecast cold", dc4, l4, u4,
                              mpc.init_warm(dc4, B), 3, 1, 3)[1][0])
    renv = VecEnv(make_ieee33_renewable_task(), dtype=torch.float32, device="cuda")
    rstate, _ = renv.reset(B, g)
    stR = build_dcopf_structure(renv.spec, renv.task.delta_t, renv.task.lamb, 0.99, 0.9, 1)
    dcR = mpc.make_vec_dcopf(stR, device="cuda", max_iter=400)
    lR, uR = mpc.lane_bounds(dcR, rstate.dev_p[:, torch.as_tensor(renv.spec.load_pos, device="cuda")],
                             rstate.p_pot, rstate.soc)
    errs.append(admm_vs_plain(mpc, cuda_k, "IEEE33-renewable N=1 cold", dcR, lR, uR, mpc.init_warm(dcR, B),
                              3, 1, 3)[1][0])
    # 1% of the lanes unsolvable (a variable-bound row crossed), at the farm's
    # budget from the cold start: those exit at entry with their warm start.
    bad = torch.arange(B, device="cuda") % 100 == 0
    row = dc1.m - dc1.n + 3
    l_bad = l1.clone()
    l_bad[bad, row] = u1[bad, row] + 1.0
    sb, r = admm_vs_plain(mpc, cuda_k, "ANM6Easy N=1, 1% of lanes with a crossed bound row, budget 48",
                          dc1._replace(max_iter=48), l_bad, u1, cold)
    errs.append(r[0])
    assert torch.equal(sb.bounds_ok, ~bad) and (sb.iterations[bad] == 0).all() and not sb.converged[bad].any()
    assert torch.isinf(sb.r_prim[bad]).all() and all(torch.equal(w[bad], c[bad]) for w, c in zip(sb.warm, cold))
    assert (sb.iterations[~bad] > 0).all()
    t_k, t_p, bound_ms, bound_by = warm_r[1:]
    return (st1, state, load_pos, sol1, dc1), dict(max_abs_err=max(errs), ms=t_k, plain_ms=t_p, bound_ms=bound_ms,
                                                   bound_by=bound_by)


def phase9a_k5_routes(mpc, cuda_k, VecEnv, make_anm6easy_task, make_ieee33_renewable_task):
    """K5 on each side of its plan (``admm_stream_lanes``): the staged
    route's shape (ANM6Easy N = 1, the farm's call at B = 8192) and the
    streamed route's: ANM6Easy N = 4 cold (400 sweeps), N = 8 at B = 16384
    and the MPC cell's budget of 48 sweeps, and IEEE33-renewable N = 1 cold
    (400).  For each: the kernel's plan equal to ``admm_cuda.stream_lanes``,
    device ms (a median of 3 readings), the L2 fragment bytes a lane-sweep
    and the share of the bound.  The N = 8 set is also held against the
    plain version (``phase9a_admm_kernel`` holds the others)."""
    from gym_anm_torch._build import load_library
    from gym_anm_torch.agents.mpc import build_dcopf_structure
    from gym_anm_torch.vec.admm_cuda import l2_bytes_per_lane_sweep, stream_lanes

    log("== phase 9a (routes): K5 on each side of its plan")
    lib = load_library()
    props = torch.cuda.get_device_properties(0)
    g = torch.Generator(device="cuda").manual_seed(93)

    def anm6(N, B, max_iter):
        env = VecEnv(make_anm6easy_task(), dtype=torch.float32, device="cuda")
        state, _ = env.reset(B, g)
        st = build_dcopf_structure(env.spec, env.task.delta_t, env.task.lamb, 0.995, 0.96, N)
        dc = mpc.make_vec_dcopf(st, device="cuda", max_iter=max_iter)
        if N > 1:
            P_load, P_pot = mpc.profile_forecast_fn(env, N)(state)
        else:
            P_load, P_pot = state.dev_p[:, torch.as_tensor(env.spec.load_pos, device="cuda")], state.p_pot
        l, u = mpc.lane_bounds(dc, P_load, P_pot, state.soc)
        return dc, l, u, mpc.init_warm(dc, B)

    dc1, l1, u1, cold1 = anm6(1, B_MAIN, 4000)
    sets = {"ANM6Easy N=1, the farm's call (warm, budget 48; staged)":
            (dc1._replace(max_iter=48), l1, u1, cuda_k(dc1, l1, u1, cold1).warm),
            "ANM6Easy N=4 perfect forecast cold, 400": anm6(4, B_MAIN, 400),
            "ANM6Easy N=8 perfect forecast, budget 48 (the MPC cell's shape)": anm6(8, 16384, 48)}
    renv = VecEnv(make_ieee33_renewable_task(), dtype=torch.float32, device="cuda")
    rstate, _ = renv.reset(B_MAIN, g)
    dcR = mpc.make_vec_dcopf(build_dcopf_structure(renv.spec, renv.task.delta_t, renv.task.lamb, 0.99, 0.9, 1),
                             device="cuda", max_iter=400)
    lR, uR = mpc.lane_bounds(dcR, rstate.dev_p[:, torch.as_tensor(renv.spec.load_pos, device="cuda")],
                             rstate.p_pot, rstate.soc)
    sets["IEEE33-renewable N=1 cold, 400"] = (dcR, lR, uR, mpc.init_warm(dcR, B_MAIN))
    out = {}
    for name, (dc, l, u, warm) in sets.items():
        B, n, m = l.shape[0], dc.n, dc.m
        lanes = lib.admm_stream_lanes(B, n, m)
        assert lanes == stream_lanes(B, n, m, props.multi_processor_count, lib.gj_smem_limit_bytes()), \
            f"admm_cuda.stream_lanes disagrees with the kernel's plan on this card: {lanes}"
        sk = cuda_k(dc, l, u, warm)
        k = 20 if dc.max_iter <= 48 and n < 100 else 3
        tk = statistics.median(cuda_ms(lambda: cuda_k(dc, l, u, warm), k) for _ in range(3))
        bound_ms, bound_by, sweeps = admm_bound(dc, B, sk.iterations)
        route = f"streamed, {lanes} lanes a block" if lanes else "staged"
        log(f"K5 {name} B={B} (n={n}, m={m}): this kernel {tk:.4f} ms; route {route}; L2 fragment bytes a "
            f"lane-sweep {l2_bytes_per_lane_sweep(n, m, lanes)}; bound {bound_ms:.4f} ms ({bound_by}, {sweeps} "
            f"lane-sweeps): this kernel at {bound_ms / tk:.3f} of it")
        out[name] = tk
        if n == 168:
            admm_vs_plain(mpc, cuda_k, name, dc, l, u, warm, 3, 1, 3)
    return out


def phase9b_highs(mpc, cold_set, n_lanes=64):
    """K5's N=1 cold solutions against scipy's HiGHS on the same LPs, with
    the bars of tests/test_vec_mpc.py:75-92: objective within 1e-3 relative,
    stage-0 action within 2e-2 MW.  The action is measured to the LP's
    optimal face (face_distance): reset states give degenerate LPs, where
    HiGHS's vertex is one optimum of many.  The bars hold on the first
    ``n_lanes`` lanes that exited by the strict rule.  The first ``n_lanes``
    lanes of the set, whatever their exit, are measured and printed: the
    solver's plateau rule accepts a dual residual up to d_ref, which the
    λ = 100 overflow cost sets to 100 here, and a few lanes stop there short
    of the optimum (the JAX package's solve does the same)."""
    from gym_anm_torch.agents.mpc import solve_highs

    st, state, load_pos, sol, dc = cold_set
    strict = strict_exit(mpc, dc, sol).cpu()
    held = torch.nonzero(strict).squeeze(1)[:n_lanes].tolist()
    first = list(range(n_lanes))
    log(f"== phase 9b: K5's N=1 cold solutions against HiGHS: the first {n_lanes} lanes that exited strictly "
        f"({int(strict.sum())} of {strict.numel()} did) and the first {n_lanes} lanes")
    x = sol.x.double().cpu().numpy()
    P_load = state.dev_p[:, load_pos].double().cpu().numpy()
    P_gen, soc = state.p_pot.double().cpu().numpy(), state.soc.double().cpu().numpy()
    rows = {}
    for b in sorted(set(held + first)):
        _, res = solve_highs(st, P_load[b][:, None], P_gen[b][:, None], soc[b])
        assert res.success, f"lane {b}: HiGHS fails on a reset state's LP"
        a = x[b][st.act_idx]
        rows[b] = (abs(float(st.c @ x[b]) - res.fun) / max(1.0, abs(res.fun)),
                   float(np.abs(a - res.x[st.act_idx]).max()) * st.baseMVA,
                   face_distance(st, P_load[b][:, None], P_gen[b][:, None], soc[b], a, res.fun) * st.baseMVA)

    def report(lanes, what):
        r = np.array([rows[b] for b in lanes])
        over = [b for b in lanes if rows[b][0] > 1e-3 or rows[b][2] > 2e-2]
        log(f"HiGHS, {what}: objective gap max {r[:, 0].max():.3e} (rel), stage-0 action to the optimal face max "
            f"{r[:, 2].max():.3e} MW (to HiGHS's vertex max {r[:, 1].max():.3e} MW, {int((r[:, 1] > 2e-2).sum())} "
            f"lanes over 2e-2 MW on degenerate LPs); {len(over)} lanes over a bar")
        for b in over:
            log(f"  lane {b}: objective gap {rows[b][0]:.3e}, action to the face {rows[b][2]:.3e} MW; iterations "
                f"{int(sol.iterations[b])}, converged {bool(sol.converged[b])}, strict {bool(strict[b])}, r_dual "
                f"{float(sol.r_dual[b]):.3e}")
        return over

    assert len(held) == n_lanes, f"only {len(held)} lanes exited strictly"
    assert not report(held, f"the first {n_lanes} strict exits"), "a strict exit misses a HiGHS bar"
    report(first, f"the first {n_lanes} lanes")


def phase9c_farm(mpc, cuda_k, VecEnv, make_anm6easy_task, kernel, chord_k):
    """bench.py workload 4: the MPC farm on the card.  Returns the launches of
    K5 in the recorded run (K1's and K2's are printed: K1 launches once per
    Newton iteration of the fallback), its record for 9d and the rate."""
    from gym_anm_torch.vec.core import tree_map

    B, T = B_MAIN, N_COLLECT
    log(f"== phase 9c: the MPC farm (bench.py workload 4): ANM6Easy f32, B={B}, {T} steps, make_vec_mpc N=1 budget 48")
    env = VecEnv(make_anm6easy_task(), dtype=torch.float32, device="cuda")
    ctrl = mpc.make_vec_mpc(env, gamma=0.995, safety_margin=0.96, planning_steps=1)
    real_solve, sols = mpc.solve_dcopf, []

    def recording_solve(*args, **kw):
        sol = real_solve(*args, **kw)
        sols.append((sol.iterations, sol.converged))
        return sol

    g = torch.Generator(device="cuda").manual_seed(91)
    state, obs = env.reset(B, g)
    carry = ctrl.init_carry(B)
    lanes = slice(0, N_CHECK_LANES // 4)
    record, rewards, n_done = [], [], 0
    mpc.solve_dcopf = recording_solve
    cuda_k.launch_count = kernel.launch_count = chord_k.launch_count = 0
    try:
        for k in range(T):
            pre = tree_map(lambda x: x[lanes].cpu(), (state, carry)) if k < N_CHECK_STEPS else None
            torch.cuda.set_sync_debug_mode("error")
            try:
                a, carry = ctrl.act(None, state, obs, carry)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            state, obs, r, d, info = env.step_autoreset_batch(state, a, g)
            rewards.append(r)
            n_done += int(d.sum())
            if pre is not None:
                record.append(pre + (a[lanes].cpu(), r[lanes].cpu(), sols[-1][0][lanes].cpu()))
        torch.cuda.synchronize()
    finally:
        mpc.solve_dcopf = real_solve
    launches = cuda_k.launch_count
    rew = torch.stack(rewards)
    its = torch.stack([s[0] for s in sols]).float()
    conv = torch.stack([s[1] for s in sols]).float()
    assert torch.isfinite(rew).all() and torch.isfinite(obs).all()
    assert launches == T, f"K5 launched {launches} times in {T} steps"
    log(f"farm: K5 launches {launches}, K2 {chord_k.launch_count}, K3 {kernel.launch_count} (K1 solves inside it "
        f"{kernel.solves}); mean reward {float(rew.mean()):.6f}, {n_done} lane terminations; ADMM iterations per lane "
        f"per step mean {float(its.mean()):.3f}, max {int(its.max())}; converged share {float(conv.mean()):.4f}; no "
        f"host sync inside act")
    assert float(rew.mean()) > -5.0, "the farm's mean reward is not at an informed controller's level"

    # The rate: CUDA events around T steps (act and step), median of N_REPS.
    reps = []
    for _ in range(N_REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(T):
            a, carry = ctrl.act(None, state, obs, carry)
            state, obs, r, d, info = env.step_autoreset_batch(state, a, g)
        end.record()
        torch.cuda.synchronize()
        reps.append(T * B / (start.elapsed_time(end) / 1e3))
    rate = statistics.median(reps)

    # The share inside act (CUDA events around each act on the device's
    # timeline, and host time), K5's device time per step and the device's
    # busy time (torch.profiler over 16 steps), ops and syncs per step.
    ev, host_act, n_split = [], 0.0, 32
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    total_start, total_end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    total_start.record()
    for _ in range(n_split):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        h = time.perf_counter()
        s.record()
        a, carry = ctrl.act(None, state, obs, carry)
        e.record()
        host_act += time.perf_counter() - h
        ev.append((s, e))
        state, obs, r, d, info = env.step_autoreset_batch(state, a, g)
    total_end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n_split
    total = total_start.elapsed_time(total_end) / n_split
    act_ms = sum(s.elapsed_time(e) for s, e in ev) / n_split

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    n_prof = 16
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            a, carry = ctrl.act(None, state, obs, carry)
            state, obs, r, d, info = env.step_autoreset_batch(state, a, g)
        torch.cuda.synchronize()
    prof_wall = (time.perf_counter() - t0) / n_prof
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy, last = 0.0, float("-inf")
    for s0, e0 in sorted((e.time_range.start, e.time_range.end) for e in evs):
        busy += max(0.0, e0 - max(s0, last))
        last = max(last, e0)
    k5 = sum(e.time_range.end - e.time_range.start for e in evs if "admm_kernel" in e.name)
    busy_ms = busy / 1e3 / n_prof
    count_ops(lambda: None)  # the first profile after a window may still report some of its events
    empty = count_ops(lambda: None)
    ops_act, syncs_act = count_ops(lambda: ctrl.act(None, state, obs, carry), empty)
    a, _ = ctrl.act(None, state, obs, carry)
    ops_step, syncs_step = count_ops(lambda: env.step_autoreset_batch(state, a, g), empty)
    step_ms = 1e3 * B / rate
    log(f"farm: {rate:.1f} env-steps/s (median of {N_REPS} reps of {T} steps at B={B}; reps "
        f"{[round(x, 1) for x in reps]}), {step_ms:.3f} ms/step")
    log(f"farm step split ({n_split} steps): {total:.3f} ms/step (wall {1e3 * wall:.3f}), act {act_ms:.3f} ms on the "
        f"device's timeline ({act_ms / total:.3f} of the step; host {1e3 * host_act / n_split:.3f} ms)")
    log(f"farm profile ({n_prof} steps, {1e3 * prof_wall:.3f} ms/step under the profiler): device busy "
        f"{busy_ms:.4f} ms/step, idle share {1 - busy_ms / step_ms:.3f} of the timed step ({step_ms:.3f} ms); K5 "
        f"{k5 / n_prof:.2f} us/step ({k5 / busy if busy else 0.0:.3f} of busy); GPU ops per step "
        f"{ops_act + ops_step} (act {ops_act}, env step {ops_step}), host syncs per step {syncs_act + syncs_step} "
        f"(act {syncs_act}; empty-call baseline {empty})")
    assert syncs_act == 0, "act synchronizes with the host"
    return launches, record, rate


def phase9d_replay(mpc, VecEnv, make_anm6easy_task, record):
    """The farm's first steps of its first lanes replayed on the CPU at
    float64 through the plain solve, from the card's states and warm
    carries: the actions within 2e-2 MW (the HiGHS bar of the float32 tier;
    both solves stop at the same budget of 48 sweeps from the same start, so
    the float32 rounding is all that moves them)."""
    from gym_anm_torch.vec.core import tree_map

    log(f"== phase 9d: the farm's first {len(record)} steps of {record[0][2].shape[0]} lanes replayed at float64 "
        f"on the CPU")
    env = VecEnv(make_anm6easy_task(), dtype=torch.float64, device="cpu")
    ctrl = mpc.make_vec_mpc(env, gamma=0.995, safety_margin=0.96, planning_steps=1)
    real_solve, its = mpc.solve_dcopf, []

    def recording_solve(*args, **kw):
        sol = real_solve(*args, **kw)
        its.append(sol.iterations)
        return sol

    mpc.solve_dcopf = recording_solve
    worst_a, worst_r, n_it = 0.0, 0.0, 0
    try:
        for k, (state, carry, a32, r32, it32) in enumerate(record):
            to64 = lambda x: x.double() if x.is_floating_point() else x  # noqa: E731
            st64 = tree_map(to64, state)
            a64, _ = ctrl.act(None, st64, None, tree_map(to64, carry))
            _, _, r64, _, _ = env.step(st64, a64)
            da = float((a64 - a32.double()).abs().max())
            worst_a = max(worst_a, da)
            worst_r = max(worst_r, float((r64 - r32.double()).abs().max()))
            n_it += int((its[-1] == it32).sum())
            assert da <= 2e-2, f"step {k}: the float64 replay's action differs by {da:.3e} MW"
    finally:
        mpc.solve_dcopf = real_solve
    n = len(record) * record[0][2].shape[0]
    log(f"replay: max |action difference| {worst_a:.3e} MW, max |reward difference| {worst_r:.3e}, ADMM iterations "
        f"equal on {n_it} of {n} lane-steps")


def phase10_k1_routes(lin):
    """K1's routes at the feeders' sizes (float32 n = 94, 126; float64 n =
    64, 126; B = 8192) and at both sides of each route edge (B = 1001): the
    route ``k1_route`` picks runs, and is bitwise equal to the plain version
    with the zero-pivot lane (and, at the edges, a lane with an inf entry)
    non-finite in both.  At the feeders' sizes each is timed beside the
    blocked route in device memory (bitwise the plain version too) and
    ``torch.linalg.solve_ex``, each with its share of the bound.  Returns the
    shared-memory route's numbers at float32 n = 126 (the 64-bus feeder's
    fallback) for the kernels' line."""
    from gym_anm_torch._build import load_library
    from gym_anm_torch.bench.kernel_probes import panel_solve

    k1 = lin.solve_gauss_jordan_cuda
    limit = load_library().gj_smem_limit_bytes()

    def check(B, n, dtype, inf_lane):
        A, b = systems(B, n, dtype, seed=n + B)
        if inf_lane:
            A[2, n // 2, 3] = float("inf")
        route, panel = lin.k1_route(n, dtype, limit)
        before = k1.launches[route]
        xk = k1(A, b)
        xp = lin.solve_gauss_jordan(A, b)
        torch.cuda.synchronize()
        assert k1.launches[route] == before + 1, f"K1's {route} route did not run at n={n} {dtype}"
        bad = (1, 2) if inf_lane else (1,)
        for lane in bad:
            assert not torch.isfinite(xk[lane]).all() and not torch.isfinite(xp[lane]).all(), "non-finite lost"
        assert torch.equal(torch.isnan(xk), torch.isnan(xp))
        keep = torch.ones(B, dtype=torch.bool, device="cuda")
        keep[list(bad)] = False
        assert torch.isfinite(xp[keep]).all()
        assert torch.equal(xk[keep], xp[keep]), f"K1's {route} route at n={n} {dtype} is not bitwise the plain version"
        return A, b, route, panel, xp

    # Both sides of each edge: registers | resident | blocked, where this card's limit puts them.
    for dtype in (torch.float32, torch.float64):
        top = 65
        while lin.k1_route(top + 1, dtype, limit)[0] == "smem":
            top += 1
        routes = []
        for n in (lin.REG_MAX_N, lin.REG_MAX_N + 1, top, top + 1):
            routes.append(f"n={n} {check(1001, n, dtype, True)[2]}")
        log(f"K1 route edges {dtype}, B=1001: " + ", ".join(routes) + "; each bitwise equal to the plain version, "
            "the zero-pivot and inf lanes non-finite in both")

    resident = {}
    for n, dtype in ((94, torch.float32), (126, torch.float32), (64, torch.float64), (126, torch.float64)):
        A, b, route, panel, xp = check(B_MAIN, n, dtype, False)
        itemsize = A.element_size()
        blocked_panel = next(bp for bp in lin.BLOCKED_PANELS[itemsize]
                             if lin.panel_smem_bytes(n, itemsize, bp, False) <= limit)
        keep = torch.arange(B_MAIN, device="cuda") != 1
        xb = panel_solve(load_library(), A, b, blocked_panel, False)
        torch.cuda.synchronize()
        assert torch.equal(xb[keep], xp[keep]), "the blocked route is not bitwise the plain version"
        t = {key: statistics.median(cuda_ms(fn, k) for _ in range(r)) for key, fn, k, r in (
            ("ms", lambda: k1(A, b), N_LAUNCH, 3),
            ("blocked_ms", lambda: panel_solve(load_library(), A, b, blocked_panel, False), N_LAUNCH, 3),
            ("library_ms", lambda: torch.linalg.solve_ex(A, b), N_LAUNCH, 3))}
        bound_ms, bound_by = k1_bound(B_MAIN, n, itemsize)
        log(f"K1 B={B_MAIN} n={n} {dtype}, route {route} (panel {panel}): kernel {t['ms']:.4f} ms "
            f"({bound_ms / t['ms']:.4f} of the bound), blocked route in device memory (panel {blocked_panel}) "
            f"{t['blocked_ms']:.4f} ms ({bound_ms / t['blocked_ms']:.4f}), torch.linalg.solve_ex "
            f"{t['library_ms']:.4f} ms ({bound_ms / t['library_ms']:.4f}); bound {bound_ms:.4f} ms ({bound_by}); "
            f"device time, median of 3 readings of {N_LAUNCH} launches")
        if (n, dtype) == (126, torch.float32):
            assert route == "smem", "float32 n = 126 is off the shared-memory route"
            t_plain = statistics.median(cuda_ms(lambda: lin.solve_gauss_jordan(A, b), 1) for _ in range(3))
            resident = dict(ms=t["ms"], plain_ms=t_plain, library_ms=t["library_ms"], bound_ms=bound_ms,
                            bound_by=bound_by, max_abs_err=float((k1(A, b)[keep] - xp[keep]).abs().max()))
    return resident


PPO_TIMED = ["--task", "ieee33", "--lanes", str(B_MAIN), "--rollout", "16", "--iters", "10"]
PPO_DOC = ["--task", "multicap", "--lanes", "4096", "--rollout", "16", "--epochs", "2", "--minibatches", "2",
           "--lane-minibatches", "2", "--iters", "150"]  # docs/distributed.md:52-55, hidden 64 (the default)
CQL_DOC = ["--lanes", "512", "--steps", "50", "--train-steps", "3000"]  # docs/distributed.md:79-83


def rel_err(a, b):
    """max |a - b| over max |b| (norm-wise relative; over 1 where b is 0)."""
    scale = float(b.abs().max())
    return float((a.cpu() - b.cpu()).abs().max()) / (scale if scale > 0 else 1.0)


def counted(kernel, chord_k, flows_k, fn):
    """``fn()`` with the K3, K2 and K6 counts set to 0 just before and read
    just after: (fn's result, K3 launches, K2 launches, K6 launches, K1 solves
    inside K3)."""
    kernel.launch_count = 0
    chord_k.launch_count = 0
    flows_k.launch_count = 0
    out = fn()
    torch.cuda.synchronize()
    return out, kernel.launch_count, chord_k.launch_count, flows_k.launch_count, kernel.solves


def ppo_profile(run, n_iter=2):
    """A torch.profiler window of ``n_iter`` train iterations after the run:
    the device's idle share (1 − busy / wall, busy the union of the card's
    kernel and copy spans), then GPU ops and host syncs of one rollout and
    of one update apart."""
    from torch.profiler import ProfilerActivity, profile

    step, ts, state, obs, g = (run[k] for k in ("train_step", "ts", "state", "obs", "generator"))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_iter):
            ts, state, obs, _ = step(ts, state, obs, g)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy, last = 0.0, float("-inf")
    for start, end in sorted((e.time_range.start, e.time_range.end) for e in evs):
        busy += max(0.0, end - max(start, last))
        last = max(last, end)
    busy_ms = busy / 1e3 / n_iter
    idle = 1.0 - busy_ms / (1e3 * wall / n_iter)
    empty = count_ops(lambda: None)
    holder = {}
    ops_c, syncs_c = count_ops(lambda: holder.update(out=step.collect(ts, state, obs, g)), empty)
    traj = holder["out"][2]
    perms = step.permutations(ts.step)
    ops_u, syncs_u = count_ops(lambda: step.update(ts, traj, perms), empty)
    log(f"PPO profile ({n_iter} iterations): wall {1e3 * wall / n_iter:.3f} ms/iteration, device busy "
        f"{busy_ms:.3f} ms/iteration, idle share {idle:.4f}; GPU ops per iteration {ops_c + ops_u} (rollout "
        f"{ops_c}, update {ops_u}), host syncs per iteration {syncs_c + syncs_u} (rollout {syncs_c}, update "
        f"{syncs_u})")
    assert syncs_u == 0, f"the update synchronized {syncs_u} times"
    return idle


def nccl_equals_alone(ppo_main, args):
    """The same short PPO run without a process group and under nccl at
    world size 1: bitwise equal parameters."""
    import socket

    import torch.distributed as dist

    from gym_anm_torch.parallel import init_distributed

    alone = [p.detach().clone() for p in ppo_main(args)["ts"].params.parameters()]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert init_distributed(0, 1, port) == "nccl"
    try:
        grouped = [p.detach().clone() for p in ppo_main(args)["ts"].params.parameters()]
    finally:
        dist.destroy_process_group()
    same = all(torch.equal(a, b) for a, b in zip(alone, grouped))
    log(f"PPO without a process group and under nccl at world size 1 ({' '.join(args)}): parameters bitwise "
        f"equal: {same}")
    assert same


def ppo_update_card_vs_cpu(VecEnv, run, task):
    """One PPO update of the card against the same update on the CPU: the
    card's next trajectory batch and parameters cast to float64, the same
    permutations; parameters and metrics within 1e-10 (norm-wise)."""
    from gym_anm_torch.parallel import ppo
    from gym_anm_torch.utils import forbid_host_syncs

    step, ts, state, obs, g = (run[k] for k in ("train_step", "ts", "state", "obs", "generator"))
    _, _, traj = step.collect(ts, state, obs, g)
    traj = tuple(x.double() for x in traj)
    ts64 = ts.to(dtype=torch.float64)
    perms = step.permutations(ts.step)
    step_c = ppo.make_train_step(VecEnv(task, dtype=torch.float64, device="cpu"), step.cfg)
    ts_c, m_c = step_c.update(ts64.to("cpu"), tuple(x.cpu() for x in traj), perms)
    torch.cuda.synchronize()
    with forbid_host_syncs():
        ts_g, m_g = step.update(ts64, traj, perms)
    err = max(rel_err(p.detach(), q.detach()) for p, q in zip(ts_g.params.parameters(), ts_c.params.parameters()))
    err_m = max(rel_err(m_g[k], m_c[k]) for k in m_c)
    log(f"PPO update at float64, card vs CPU (trajectory [{traj[2].shape[0]}, {traj[2].shape[1]}], the card's "
        f"parameters): parameters max rel err {err:.3e}, metrics {err_m:.3e}")
    assert err <= 1e-10 and err_m <= 1e-10
    return err


def phase11_ppo(VecEnv, make_ieee33_multicap_task, kernel, chord_k, flows_k):
    """PPO through ``python -m gym_anm_torch.scripts.train_ppo_online``'s
    ``main``: the timed base IEEE33 run, the documented multicap17 run, the
    card against the CPU, nccl against no process group.  Returns the K3,
    K2 and K6 launches and K1's solves inside K3 of the two runs."""
    import tempfile

    from gym_anm_torch.scripts.train_ppo_online import main as ppo_main
    from gym_anm_torch.utils import restore_checkpoint

    log(f"== phase 11a: PPO on base IEEE33, f32, B={B_MAIN}, rollout 16, 10 iterations, every update under "
        f"set_sync_debug_mode('error')")
    t0 = time.perf_counter()
    run, k3a, k2a, k6a, k1a = counted(kernel, chord_k, flows_k, lambda: ppo_main(PPO_TIMED + ["--forbid-syncs"]))
    t_run = time.perf_counter() - t0
    losses = [m["loss"] for m in run["metrics"]]
    assert all(math.isfinite(x) for x in losses), "a non-finite PPO loss"
    iter_ms = run["rollout_ms"] + run["update_ms"]
    log(f"PPO base IEEE33: {run['env_steps_per_s']:.1f} env-steps/s (train loop, iterations 1-9); an iteration "
        f"{iter_ms:.3f} ms on the card's timeline: rollout {run['rollout_ms']:.3f} ms "
        f"({run['rollout_ms'] / iter_ms:.3f}), update {run['update_ms']:.3f} ms ({run['update_ms'] / iter_ms:.3f}); "
        f"K2 launches {k2a}, K6 {k6a}, K3 launches {k3a} (K1 solves inside it {k1a}); the run took {t_run:.1f} s")
    assert k2a > 0 and k6a > 0, "K2 or K6 never launched in the PPO rollout"
    t0 = time.perf_counter()
    ppo_profile(run)
    t1 = time.perf_counter()
    nccl_equals_alone(ppo_main, ["--task", "ieee33", "--lanes", "1024", "--rollout", "8", "--iters", "2",
                                 "--minibatches", "2", "--lane-minibatches", "2", "--forbid-syncs"])
    log(f"(profile {t1 - t0:.1f} s, nccl check {time.perf_counter() - t1:.1f} s)")

    log("== phase 11b: PPO on multicap17 (docs/distributed.md:52-55): B=4096, rollout 16, 2 epochs x 2 x 2 "
        "minibatches, hidden 64, 150 iterations, --eval, --save")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        run, k3b, k2b, k6b, k1b = counted(kernel, chord_k, flows_k,
                                          lambda: ppo_main(PPO_DOC + ["--eval", "--save", tmp, "--forbid-syncs"]))
        ts = run["ts"]
        restored = restore_checkpoint(tmp, ts, step=len(run["metrics"]))
    same = (all(torch.equal(p, q) for p, q in zip(ts.params.parameters(), restored.params.parameters()))
            and all(torch.equal(ts.opt_m[k], restored.opt_m[k]) and torch.equal(ts.opt_v[k], restored.opt_v[k])
                    for k in ts.opt_m) and restored.step == ts.step)
    rewards = [m["mean_reward"] for m in run["metrics"]]
    assert all(math.isfinite(m[k]) for m in run["metrics"] for k in m), "a non-finite loss or reward"
    early, late = statistics.mean(rewards[:10]), statistics.mean(rewards[-10:])
    log(f"PPO multicap17 mean reward by iteration: {[float(f'{r:.4g}') for r in rewards]}")
    log(f"PPO multicap17: mean reward of iterations 0-9 {early:.4f}, of 140-149 {late:.4f}; "
        f"{run['env_steps_per_s']:.1f} env-steps/s; rollout {run['rollout_ms']:.3f} ms, update "
        f"{run['update_ms']:.3f} ms an iteration; K2 launches {k2b}, K6 {k6b}, K3 launches {k3b} (K1 solves inside it "
        f"{k1b}); the run (150 iterations, eval, save and restore) took {time.perf_counter() - t0:.1f} s")
    log(f"PPO multicap17 eval (deterministic, 256 lanes x 50 steps, no autoreset): PPO {run['eval']['ppo']:+.4f}, "
        f"random {run['eval']['random']:+.4f} per step; checkpoint restored bit for bit: {same}")
    assert late > early, "PPO did not improve its mean reward"
    assert same, "the restored TrainState differs"
    t0 = time.perf_counter()
    ppo_update_card_vs_cpu(VecEnv, run, make_ieee33_multicap_task())
    log(f"(card against CPU {time.perf_counter() - t0:.1f} s)")
    return k3a + k3b, k2a + k2b, k6a + k6b, k1a + k1b


def phase12_cql(kernel, chord_k, flows_k):
    """CQL through ``python -m gym_anm_torch.scripts.train_cql_offline``'s
    ``main`` (docs/distributed.md:79-83), every update under
    set_sync_debug_mode('error'), then one update of the card against the CPU
    at float64.  Returns the K3, K2 and K6 launches and K1's solves inside
    K3 of the run."""
    from gym_anm_torch.parallel import cql
    from gym_anm_torch.scripts.train_cql_offline import main as cql_main
    from gym_anm_torch.utils import forbid_host_syncs

    log("== phase 12: CQL on multicap17: L0-L5 dataset 512 lanes x 50 steps x 6, 3000 updates of 512, "
        "CQLConfig(hidden=128, cql_weight=2.0)")
    run, k3, k2, k6, k1 = counted(kernel, chord_k, flows_k, lambda: cql_main(CQL_DOC + ["--forbid-syncs"]))
    m, ev = run["metrics"], run["eval"]
    assert run["transitions"] == 153_600
    assert all(math.isfinite(v) for v in m.values()), "a non-finite CQL metric"
    log(f"CQL: {run['transitions']} transitions collected in {run['collect_s']:.1f} s; {run['updates_per_s']:.1f} "
        f"updates/s ({run['train_s']:.1f} s for 3000); final loss {m['loss']:.4f}, bellman {m['bellman']:.4f}; "
        f"K2 launches {k2}, K6 {k6}, K3 launches {k3} (K1 solves inside it {k1})")
    log(f"CQL eval (deterministic, 256 lanes x 50 steps, no autoreset): CQL {ev['cql']:+.4f}, random "
        f"{ev['random']:+.4f}, L5 {ev['L5']:+.4f} per step")
    assert ev["cql"] > ev["random"], "CQL does not beat random"

    # One update at float64, card against CPU.
    env, data = run["env"], run["dataset"]
    idx = torch.randint(0, run["transitions"], (512,), generator=torch.Generator().manual_seed(3)).to("cuda")
    keys = {"obs": "states", "actions": "actions", "rewards": "rewards", "next_obs": "next_states", "dones": "dones"}
    batch = {k: data[v][idx].double() for k, v in keys.items()}
    cfg = cql.CQLConfig(hidden=128, cql_weight=2.0)
    lo, hi = env.action_low.double(), env.action_high.double()
    upd_g, upd_c = cql.make_cql_update(cfg, lo, hi), cql.make_cql_update(cfg, lo.cpu(), hi.cpu())
    noise = upd_c.draw(torch.Generator().manual_seed(4), 512, torch.float64)
    state = run["state"].to(dtype=torch.float64)
    new_c, m_c = upd_c(state.to("cpu"), None, {k: v.cpu() for k, v in batch.items()}, noise)
    noise = {k: v.to("cuda") for k, v in noise.items()}
    torch.cuda.synchronize()
    with forbid_host_syncs():
        new_g, m_g = upd_g(state, None, batch, noise)
    pairs = list(zip(new_g.train.params.parameters(), new_c.train.params.parameters())) + list(
        zip(new_g.target_q.parameters(), new_c.target_q.parameters()))
    err = max(rel_err(p.detach(), q.detach()) for p, q in pairs)
    err_m = max(rel_err(m_g[k], m_c[k]) for k in m_c)
    log(f"CQL update at float64, card vs CPU (the trained networks, 512 rows of the dataset): parameters and "
        f"targets max rel err {err:.3e}, metrics {err_m:.3e}")
    assert err <= 1e-10 and err_m <= 1e-10
    return k3, k2, k6, k1


def simulator_inputs(sim, n_steps, seed, anm6):
    """A reset state and ``n_steps`` transitions' inputs for a compat
    ``Simulator``, from numpy: on ANM6 ANM6Easy's daily profiles from a random
    start (loads, generation maxima) with uniform set-points from
    ``get_action_space()``; on IEEE33 the renewable family's diurnal loads
    (0.8 + 0.3 sin of the hour, 2% noise) with uniform capacitor and tap
    set-points."""
    from gym_anm_torch.networks.anm6 import anm6easy_gen_time_series, anm6easy_load_time_series

    rng = np.random.default_rng(seed)
    spec = sim.spec
    ids = lambda pos: [int(spec.dev_ids[p]) for p in pos]  # noqa: E731
    loads, gens, des, caps, oltcs = (ids(spec.load_pos), ids(spec.gen_nonslack_pos), ids(spec.des_pos),
                                     ids(spec.cap_pos), ids(spec.oltc_pos))
    bounds = sim.get_action_space()
    P_gen_b, Q_gen_b, P_des_b, Q_des_b = bounds[:4]
    Q_cap_b = bounds[4] if len(bounds) > 4 else {}
    tap_b = bounds[5] if len(bounds) > 5 else {}
    u = lambda b, i: float(rng.uniform(*b[i]))  # noqa: E731
    if anm6:
        P_loads, P_maxs = anm6easy_load_time_series(), anm6easy_gen_time_series()
        t0 = int(rng.integers(0, 96))
        load_at = lambda t: dict(zip(loads, P_loads[:, (t0 + t) % 96]))  # noqa: E731
        pot_at = lambda t: dict(zip(gens, P_maxs[:, (t0 + t) % 96]))  # noqa: E731
    else:
        nominal = np.abs(spec.p_min[spec.load_pos]) * spec.baseMVA
        hour = rng.uniform(0, 24)
        load_at = lambda t: dict(zip(loads, -nominal * (0.8 + 0.3 * np.sin((hour + t - 3) * np.pi / 12))  # noqa: E731
                                     * (1 + 0.02 * rng.standard_normal(len(loads)))))
        pot_at = lambda t: {i: 0.0 for i in gens}  # noqa: E731
    s0 = np.zeros(2 * spec.n_dev + spec.n_des + spec.n_gen)
    for i, p in zip(loads, load_at(0).values()):
        s0[spec.dev_ids.tolist().index(i)] = p
    steps = []
    for t in range(1, n_steps + 1):
        P_set = {i: u(P_gen_b, i) for i in gens} | {i: u(P_des_b, i) for i in des}
        Q_set = {i: u(Q_gen_b, i) for i in gens} | {i: u(Q_des_b, i) for i in des} | {i: u(Q_cap_b, i)
                                                                                    for i in caps}
        steps.append((load_at(t), pot_at(t), P_set, Q_set, {i: u(tap_b, i) for i in oltcs}))
    return s0, steps


def run_simulator(sim, s0, steps):
    """Reset and step ``sim`` through ``steps``: (per-step outputs, ms per
    transition on the host clock, the reset's flag)."""
    ok = sim.reset(s0)
    outs = []
    t0 = time.perf_counter()
    for P_load, P_pot, P_set, Q_set, taps in steps:
        _, r, e_loss, penalty, conv = sim.transition(P_load, P_pot, P_set, Q_set, taps)
        outs.append((sim._last, r, e_loss, penalty, conv))
    return outs, 1e3 * (time.perf_counter() - t0) / len(steps), ok


# GPU ops and host syncs of one Simulator transition on the card before the
# Newton loop ran in K3 (PR 10's phase 13: one K1 launch an iteration and the
# plain loop's host reads around it).
PR10_TRANSITION = {"ANM6": (1340, 7), "IEEE33": (630, 7)}


def phase13_simulator(lin, kernel):
    """The compat ``Simulator`` (float64, one lane) on the card against the
    CPU, its GPU ops and host syncs per transition (its Newton loop one K3
    launch with the dense Y of ``nr_solve``), and K1 at B = 1, float64 (the
    size of its solves inside K3), beside ``solve_ex``."""
    from gym_anm_torch.env import Simulator
    from gym_anm_torch.networks import anm6_network, ieee33_network

    T = 96
    log(f"== phase 13a: the compat Simulator, float64, one lane: {T} steps of ANM6 and of IEEE33 on the card "
        "against the CPU")
    launches, solves, errs = 0, 0, []
    for name, net, delta_t, anm6 in (("ANM6", anm6_network, 0.25, True), ("IEEE33", ieee33_network, 1.0, False)):
        card, cpu = Simulator(net, delta_t, 100), Simulator(net, delta_t, 100, device="cpu")
        assert card._tables.device.type == "cuda"
        s0, steps = simulator_inputs(cpu, T, seed=13, anm6=anm6)
        run_simulator(card, s0, steps[:2])  # warm
        kernel.launch_count = 0
        dense0 = kernel.launches["dense"]
        out_card, ms_card, ok_card = run_simulator(card, s0, steps)
        torch.cuda.synchronize()
        n_k3, n_dense, n_solves = kernel.launch_count, kernel.launches["dense"] - dense0, kernel.solves
        out_cpu, ms_cpu, ok_cpu = run_simulator(cpu, s0, steps)
        assert ok_card == ok_cpu, "the reset's load flow converged on one device only"
        assert n_k3 > 0 and n_dense == n_k3 and n_solves > 0, \
            f"{name}: K3 launched {n_k3} times, {n_dense} with the dense Y, {n_solves} solves inside"
        launches += n_k3
        solves += n_solves
        err, n_stable = 0.0, 0
        for t, (a, b) in enumerate(zip(out_card, out_cpu)):
            assert a[4] == b[4], f"{name} step {t}: pfe_converged {a[4]} on the card, {b[4]} on the CPU"
            if not a[4]:
                continue
            n_stable += 1
            for f in ("bus_v_re", "bus_v_im", "dev_p", "dev_q", "br_p_from", "br_q_from", "br_p_to", "br_q_to",
                      "br_s_signed"):
                err = max(err, float(np.max(np.abs(getattr(a[0], f) - getattr(b[0], f)))))
            err = max(err, *(abs(x - y) for x, y in zip(a[1:4], b[1:4])))
        errs.append(err)
        log(f"13a {name}: {n_stable} of {T} steps converged on both devices (flags equal on all); max |card - CPU| "
            f"over bus voltages, device P/Q, branch flows, reward, e_loss and penalty {err:.3e}; K3 launches "
            f"{n_k3} ({n_k3 / T:.2f} per step, all with nr_solve's dense Y), K1 solves inside it {n_solves} "
            f"({n_solves / n_k3:.2f} per launch); ms per transition: card "
            f"{ms_card:.3f}, CPU {ms_cpu:.3f} (host clock, {T} steps)")
        assert err <= 1e-8, f"{name}: the card's Simulator is {err:.3e} from the CPU's"
        assert n_stable > T // 2, f"{name}: only {n_stable} of {T} steps converged"
        ops, syncs = count_ops(lambda: card.transition(*steps[-1]), count_ops(lambda: None))
        log(f"13a {name}: GPU ops {ops} and host syncs {syncs} in one transition on the card (before K3, PR 10: "
            f"{PR10_TRANSITION[name][0]} ops, {PR10_TRANSITION[name][1]} syncs)")

    for n in (64, 10):
        g = torch.Generator(device="cuda").manual_seed(n)
        A = torch.randn(1, n, n, generator=g, device="cuda", dtype=torch.float64)
        A += n * torch.eye(n, device="cuda", dtype=torch.float64)
        b = torch.randn(1, n, generator=g, device="cuda", dtype=torch.float64)
        xk, xp = lin.solve_gauss_jordan_cuda(A, b), lin.solve_gauss_jordan(A, b)
        assert torch.equal(xk, xp), f"K1 at B = 1, n = {n} is not bitwise its plain version"
        torch.linalg.solve_ex(A, b)
        t = {k: statistics.median(cuda_ms(fn, c) for _ in range(N_REPS)) for k, fn, c in (
            ("ms", lambda: lin.solve_gauss_jordan_cuda(A, b), N_LAUNCH),
            ("library_ms", lambda: torch.linalg.solve_ex(A, b), N_LAUNCH),
            ("plain_ms", lambda: lin.solve_gauss_jordan(A, b), 3))}
        bound_ms, bound_by = k1_bound(1, n, 8)
        log(f"13a K1 at B=1 n={n} float64 (device time, {N_LAUNCH} launches per reading, median of {N_REPS}): "
            f"kernel {t['ms']:.4f} ms, torch.linalg.solve_ex {t['library_ms']:.4f} ms, plain {t['plain_ms']:.4f} "
            f"ms; bound {1e3 * bound_ms:.4f} µs ({bound_by}); bitwise equal to the plain version")
    return launches, max(errs), solves


def gymnasium_module():
    """``"gymnasium <version>"``, or ``"stand-in"`` after registering this
    script's stand-in for the part of gymnasium that ``gym_anm_torch.compat``
    uses, where the machine has no gymnasium: ``Env`` (``reset(seed=)`` seeds
    ``np_random`` as ``np.random.default_rng(seed)``; ``unwrapped``),
    ``spaces.Box`` (``low``, ``high``, ``shape``, ``dtype``, ``seed``,
    ``contains``, and ``sample`` uniform in the box, as gymnasium draws a
    bounded float box), ``envs.registration`` (``register``, ``registry``)
    and ``make`` (the registry's entry point called with the keyword
    arguments, no wrappers).  It holds no physics and no controller logic;
    the card's and the CPU's runs both go through it."""
    import types

    try:
        import gymnasium

        return f"gymnasium {gymnasium.__version__}"
    except ImportError:
        pass

    class Env:
        _np_random = None

        @property
        def np_random(self):
            if self._np_random is None:
                self._np_random = np.random.default_rng()
            return self._np_random

        def reset(self, *, seed=None, options=None):
            if seed is not None:
                self._np_random = np.random.default_rng(seed)

        @property
        def unwrapped(self):
            return self

    class Box:
        def __init__(self, low, high, dtype=np.float32):
            self.dtype = np.dtype(dtype)
            self.low, self.high = np.asarray(low, dtype=self.dtype), np.asarray(high, dtype=self.dtype)
            self.shape = self.low.shape
            self.np_random = np.random.default_rng()

        def seed(self, seed=None):
            self.np_random = np.random.default_rng(seed)
            return [seed]

        def sample(self):
            if not (np.all(np.isfinite(self.low)) and np.all(np.isfinite(self.high))):
                raise ValueError("the stand-in samples bounded boxes only")
            return self.np_random.uniform(low=self.low, high=self.high, size=self.shape).astype(self.dtype)

        def contains(self, x):
            if not isinstance(x, np.ndarray):
                try:
                    x = np.asarray(x, dtype=self.dtype)
                except (ValueError, TypeError):
                    return False
            return bool(np.can_cast(x.dtype, self.dtype) and x.shape == self.shape
                        and np.all(x >= self.low) and np.all(x <= self.high))

    gym, spaces = types.ModuleType("gymnasium"), types.ModuleType("gymnasium.spaces")
    envs, registration = types.ModuleType("gymnasium.envs"), types.ModuleType("gymnasium.envs.registration")
    registration.registry = {}
    registration.register = lambda id, entry_point, **kwargs: registration.registry.setdefault(id, entry_point)

    def make(id, **kwargs):
        module, attr = registration.registry[id].split(":")
        return getattr(importlib.import_module(module), attr)(**kwargs)

    spaces.Box, gym.Env, gym.spaces, gym.envs, envs.registration = Box, Env, spaces, envs, registration
    gym.make = make
    gym.__version__ = "stand-in"
    sys.modules.update({"gymnasium": gym, "gymnasium.spaces": spaces, "gymnasium.envs": envs,
                        "gymnasium.envs.registration": registration})
    return "stand-in"


def host_twin(f_card, f_cpu):
    """``f_card()`` and ``f_cpu()`` from the same global numpy RNG state; the
    state after them is the one ``f_cpu`` leaves (both draw alike)."""
    st = np.random.get_state()
    a = f_card()
    np.random.set_state(st)
    return a, f_cpu()


def env_pair(factory, seed=0):
    """The card's and the CPU's environment of ``factory(device)`` from the
    same global RNG state."""
    np.random.seed(seed)
    return host_twin(lambda: factory("cuda"), lambda: factory("cpu"))


def spy_on_solutions(agent, xs):
    """Record each SLSQP solution ``x`` that ``agent`` (the diversity set's
    ``L5_ScipyOptimal``) turns into an action."""
    inner = agent._action_from_x
    agent._action_from_x = lambda x: (xs.append(np.array(x)), inner(x))[1]
    return agent


def scipy_tie(x_c, x_h, a_c, a_h, atol):
    """Whether a disagreement of ``L5_ScipyOptimal`` is its capacitor tie:
    both SLSQP solutions put the two 1.0-rated capacitors (x[5], x[6]) at
    0.5 within 1e-9, and the actions differ beyond ``atol`` only in those
    two capacitors' switch (entries 10 and 11)."""
    rest = np.r_[0:10, 12:17]
    return bool(np.all(np.abs(x_c[5:7] - 0.5) <= 1e-9) and np.all(np.abs(x_h[5:7] - 0.5) <= 1e-9)
                and np.max(np.abs(a_c[rest] - a_h[rest])) <= atol)


def card_vs_cpu(kernel, ec, eh, cls, steps, seed, op_step, op_base, atol=1e-8, tie=False):
    """``cls`` on the card's environment ``ec`` and on the CPU's ``eh`` in
    closed loop for ``steps`` steps from ``seed``, each agent's action
    clipped to the box stepping its own environment.  Every card ``act``
    runs under ``set_sync_debug_mode("error")``; the one of step ``op_step``
    is counted by torch.profiler, less ``op_base`` (``count_ops`` of an
    empty call).  With ``tie``, a first disagreement beyond
    ``atol`` that is ``L5_ScipyOptimal``'s capacitor tie (``scipy_tie``)
    ends the comparison there: from that step on the two devices run
    different discrete decisions.  Returns a dict: ``da``/``dr`` (max |card
    - CPU| of actions and rewards over the compared steps), ``steps`` (how
    many), ``tie`` (the tie's step, or None), ``k3``/``dense`` (K3's launches in
    those steps, and those with the dense Y), ``k3_min`` (the fewest in one step), ``ops``/``syncs`` (of
    the counted act, or None), ``act``/``step`` ({"card", "cpu"}: host ms
    per call), ``r_card`` (the card's mean reward) and ``finite``."""
    np.random.seed(seed)
    host_twin(lambda: ec.reset(seed=seed), lambda: eh.reset(seed=seed))
    ec.action_space.seed(seed)
    eh.action_space.seed(seed)
    ac, ah = host_twin(lambda: cls(ec), lambda: cls(eh))
    xs_c, xs_h = [], []
    if tie:
        spy_on_solutions(ac, xs_c)
        spy_on_solutions(ah, xs_h)
    pc = ac.act if hasattr(ac, "act") else ac.get_base_action
    ph = ah.act if hasattr(ah, "act") else ah.get_base_action
    lo, hi = eh.action_space.low, eh.action_space.high
    out = {"da": 0.0, "dr": 0.0, "steps": 0, "tie": None, "k3": 0, "dense": 0, "k3_min": None, "ops": None,
           "syncs": None, "finite": True, "act": {"card": [], "cpu": []}, "step": {"card": [], "cpu": []},
           "r_card": []}

    def timed(key, dev, fn):
        t0 = time.perf_counter()
        x = fn()
        out[key][dev].append(1e3 * (time.perf_counter() - t0))
        return x

    def card_act():
        torch.cuda.set_sync_debug_mode("error")
        try:
            return np.asarray(pc(ec), float)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    for t in range(steps):
        st = np.random.get_state()
        n_x = len(xs_c)
        if t == op_step:
            got = {}
            out["ops"], out["syncs"] = count_ops(lambda: got.setdefault("a", card_act()), op_base)
            a_c = got["a"]
        else:
            a_c = timed("act", "card", card_act)
        np.random.set_state(st)
        a_h = timed("act", "cpu", lambda: np.asarray(ph(eh), float))
        da = float(np.max(np.abs(a_c - a_h)))
        if tie and da > atol and len(xs_c) > n_x and scipy_tie(xs_c[-1], xs_h[-1], a_c, a_h, atol):
            out["tie"] = t
            log(f"   {cls.__name__} step {t}: the capacitor tie, x[5:7] card {xs_c[-1][5:7].tolist()} CPU "
                f"{xs_h[-1][5:7].tolist()}, capacitors 1-2 card {a_c[10:12].tolist()} CPU {a_h[10:12].tolist()}")
            break
        st = np.random.get_state()
        n0, r0 = kernel.launch_count, kernel.launches["dense"]
        _, r_c, term_c, _, _ = timed("step", "card", lambda: ec.step(np.clip(a_c, lo, hi)))
        n_k3, n_dense = kernel.launch_count - n0, kernel.launches["dense"] - r0
        np.random.set_state(st)
        _, r_h, term_h, _, _ = timed("step", "cpu", lambda: eh.step(np.clip(a_h, lo, hi)))
        assert term_c == term_h, f"{cls.__name__} step {t}: terminated {term_c} on the card, {term_h} on the CPU"
        out["steps"] += 1
        out["da"] = max(out["da"], da)
        out["dr"] = max(out["dr"], abs(r_c - r_h))
        out["k3"] += n_k3
        out["dense"] += n_dense
        out["k3_min"] = n_k3 if out["k3_min"] is None else min(out["k3_min"], n_k3)
        out["finite"] &= bool(np.all(np.isfinite(a_c)) and np.isfinite(r_c))
        out["r_card"].append(r_c)
        if term_c:
            np.random.seed(seed)
            host_twin(lambda: ec.reset(seed=seed), lambda: eh.reset(seed=seed))
    for key in ("act", "step"):
        out[key] = {d: statistics.mean(v) if v else float("nan") for d, v in out[key].items()}
    out["r_card"] = statistics.mean(out["r_card"]) if out["r_card"] else float("nan")
    return out


T_HIER = 24  # one day at delta_t = 1 h
# The SLSQP L5s (diversity, ready): SLSQP's finite-difference gradients turn
# the load flow's last-digit differences between the card and the CPU into
# iterate differences (5.1e-8 measured on the card): held at 1e-6.
SLSQP_ATOL = 1e-6


def phase14_host_tier(kernel):
    """The controller hierarchies, the offline tools and the expert zoo over
    the compat environments on the card, against the CPU."""
    log("== phase 14: the host tier over the compat environments, float64, one lane, card against CPU")
    log(f"14 gymnasium: {gymnasium_module()}")
    import gym_anm_torch.compat as tc
    from gym_anm_torch import agents, offline
    from gym_anm_torch.agents import (algorithmic_hierarchy as ah, diversity_hierarchy as dh,
                                      experimental_hierarchies as xh, multicap_controllers as mc,
                                      ready_hierarchy as rh)
    from gym_anm_torch.scripts import create_algorithmic_diversity as cad

    op_base = count_ops(lambda: None)
    t_phase = time.perf_counter()
    kernel.launch_count = 0
    renewable = lambda d: tc.IEEE33RenewableEnv(device=d)  # noqa: E731
    proper = lambda d: tc.IEEE33ProperEnvironment(load_scale=0.9, device=d)  # noqa: E731
    corrected = [getattr(agents, n) for n in agents.__all__ if n.startswith("Corrected")]
    sets = (
        ("Corrected", renewable, corrected),
        ("algorithmic", renewable, [ah.L0_RandomControl, ah.L1_BangBangControl, ah.L2_ProportionalControl,
                                    ah.L3_PIControl, ah.L4_MPCControl, ah.L5_HierarchicalMPCControl]),
        ("multicap", lambda d: tc.IEEE33MultiCapacitorEnv(device=d),
         [mc.L2_ProportionalControl_MultiCap, mc.L2_DiscreteDroop, mc.L5_HierarchicalMPC_MultiCap,
          mc.L5_SwitchingAwareMPC, mc.L5_TrueMPC]),
        ("unequal", lambda d: tc.IEEE33UnequalCapacitorsEnv(device=d), [mc.L5_EnhancedSwitchingAware]),
        ("diversity", proper, [dh.L0_Random, dh.L1_BangBang, dh.L2_Proportional, dh.L3_PI_Controller,
                               dh.L4_RuleBasedExpert, dh.L5_ScipyOptimal]),
        ("ready", proper, [rh.L0_Random, rh.L1_BangBang, rh.L2_Proportional, rh.L3_Coordinated,
                           rh.L4_Predictive, rh.L5_MathematicalOptimization]),
        ("experimental", renewable, [c for n, c in vars(xh).items()
                                     if isinstance(c, type) and n[:1] in "IFM" and "_" in n]),
    )
    failures, worst = [], {"da": 0.0, "dr": 0.0, "ops": 0, "syncs": 0}
    for set_name, factory, classes in sets:
        acts, steps_ = {"card": [], "cpu": []}, {"card": [], "cpu": []}
        for cls in classes:
            # A fresh pair a class: an env carries its taps across resets.
            ec, eh_ = env_pair(factory)
            assert ec.simulator.device.type == "cuda" and eh_.simulator.device.type == "cpu"
            slsqp = cls in (dh.L5_ScipyOptimal, rh.L5_MathematicalOptimization)
            atol = SLSQP_ATOL if slsqp else 1e-8
            o = card_vs_cpu(kernel, ec, eh_, cls, T_HIER, 0, 1, op_base, atol=atol, tie=cls is dh.L5_ScipyOptimal)
            for d in ("card", "cpu"):
                acts[d].append(o["act"][d])
                steps_[d].append(o["step"][d])
            for k in ("da", "dr", "ops", "syncs"):
                worst[k] = max(worst[k], o[k])
            tie = "" if o["tie"] is None else f" (the capacitor tie at step {o['tie']} ends the comparison)"
            log(f"14a {set_name} {cls.__name__}: {o['steps']} steps compared{tie}, max |card - CPU| actions "
                f"{o['da']:.3e} (tolerance {atol:.0e}), rewards {o['dr']:.3e}; mean reward {o['r_card']:+.5f}; "
                f"K3 {o['k3'] / max(o['steps'], 1):.2f} per step (at least {o['k3_min']}), {o['dense']} of "
                f"{o['k3']} with the dense Y; one act: {o['ops']} GPU ops, {o['syncs']} host syncs; ms per "
                f"step: act card {o['act']['card']:.3f} CPU {o['act']['cpu']:.3f}, step card "
                f"{o['step']['card']:.3f} CPU {o['step']['cpu']:.3f}")
            if not (o["finite"] and o["steps"] > 0 and o["da"] <= atol and o["dr"] <= 1e-8 and o["k3_min"] > 0
                    and o["dense"] == o["k3"] and o["ops"] == 0 and o["syncs"] == 0):
                failures.append(f"{set_name} {cls.__name__}")
        log(f"14a {set_name} ({len(classes)} classes, up to {T_HIER} steps): mean ms per step act card "
            f"{statistics.mean(acts['card']):.3f} CPU {statistics.mean(acts['cpu']):.3f}, step card "
            f"{statistics.mean(steps_['card']):.3f} CPU {statistics.mean(steps_['cpu']):.3f} (host clock)")
    log(f"14a: {sum(len(c) for _, _, c in sets)} classes; worst |card - CPU| actions {worst['da']:.3e}, rewards "
        f"{worst['dr']:.3e}; most GPU ops {worst['ops']} and host syncs {worst['syncs']} in one act; "
        f"{time.perf_counter() - t_phase:.1f} s")

    # 14b: the offline tools over the Corrected hierarchy, then the zoo.
    ec, eh_ = env_pair(renewable)
    weights = [6.0, 1.0, 1.0, 2.0, 1.0, 3.0]
    np.random.seed(2)
    host_twin(lambda: ec.reset(seed=2), lambda: eh_.reset(seed=2))
    ec.action_space.seed(2)
    eh_.action_space.seed(2)
    ag_c, ag_h = host_twin(lambda: [c(ec) for c in corrected], lambda: [c(eh_) for c in corrected])
    n0, st = kernel.launch_count, np.random.get_state()
    t0 = time.perf_counter()
    d_c = offline.generate_mixed_dataset(ec, ag_c, 96, weights=weights)
    ms_c = 1e3 * (time.perf_counter() - t0) / 96
    n_mix = kernel.launch_count - n0
    np.random.set_state(st)
    t0 = time.perf_counter()
    d_h = offline.generate_mixed_dataset(eh_, ag_h, 96, weights=weights)
    ms_h = 1e3 * (time.perf_counter() - t0) / 96
    d_err = max(float(np.max(np.abs(x - y))) for x, y in zip(d_c, d_h))
    p_c, p_h = offline.behavior_cloning(*d_c, ec.action_space), offline.behavior_cloning(*d_h, eh_.action_space)
    coef = lambda p: [c.cell_contents for n, c in zip(p.__code__.co_freevars, p.__closure__)  # noqa: E731
                      if n in ("W", "b")]
    c_err = max(float(np.max(np.abs(x - y))) for x, y in zip(coef(p_c), coef(p_h)))
    np.random.seed(5)
    r_c, r_h = host_twin(lambda: offline.evaluate_policy(ec, p_c, episodes=2, max_steps=10),
                         lambda: offline.evaluate_policy(eh_, p_h, episodes=2, max_steps=10))
    log(f"14b generate_mixed_dataset (Corrected L0-L5, weights {weights}, 96 steps): states {d_c[0].shape}, "
        f"max |card - CPU| of states and actions {d_err:.3e}; K3 {n_mix / 96:.2f} per step; ms per step card "
        f"{ms_c:.3f} CPU {ms_h:.3f}; behavior_cloning coefficients {c_err:.3e}; evaluate_policy (2 x 10 steps) "
        f"card {r_c:+.6f} CPU {r_h:+.6f}")
    if not (d_err <= 1e-8 and c_err <= 1e-8 and abs(r_c - r_h) <= 1e-8 and np.isfinite(r_c) and n_mix > 0):
        failures.append("offline tools")
    zoo = [c for n, c in vars(offline).items() if isinstance(c, type) and c.__module__ == offline.__name__
           and n == c.__name__]
    assert len(zoo) == 31, len(zoo)
    zoo_worst, t0 = {"da": 0.0, "dr": 0.0, "ops": 0}, time.perf_counter()
    for cls in zoo:
        o = card_vs_cpu(kernel, ec, eh_, cls, 4, 4, 3, op_base)
        for k in zoo_worst:
            zoo_worst[k] = max(zoo_worst[k], o[k])
        if not (o["finite"] and o["da"] <= 1e-8 and o["dr"] <= 1e-8 and o["k3_min"] > 0 and o["dense"] == o["k3"]
                and o["ops"] == 0 and o["syncs"] == 0):
            failures.append(f"zoo {cls.__name__}")
            log(f"14b zoo {cls.__name__}: actions {o['da']:.3e}, rewards {o['dr']:.3e}, K3 {o['k3']} "
                f"({o['dense']} dense, at least {o['k3_min']} a step), ops {o['ops']}, syncs {o['syncs']}")
    log(f"14b zoo: {len(zoo)} heuristics x 4 steps, worst |card - CPU| actions {zoo_worst['da']:.3e}, rewards "
        f"{zoo_worst['dr']:.3e}, most GPU ops in one act {zoo_worst['ops']}; {time.perf_counter() - t0:.1f} s")

    # 14c: the script's entry point on the card, beside the CPU.
    for name, cls in cad.CONTROLLERS:
        avg_c = cad.run(cls, load_scale=1.0, steps=5)
        avg_h = cad.run(cls, load_scale=1.0, steps=5, device="cpu")
        log(f"14c create_algorithmic_diversity.run({name}, load_scale=1.0, steps=5): card {avg_c:+.6f}, "
            f"CPU {avg_h:+.6f}")
        if not np.isfinite(avg_c):
            failures.append(f"script {name}")
    torch.cuda.synchronize()
    launches, solves = kernel.launch_count, kernel.solves
    log(f"14: K3 launches {launches} (K1 solves inside it {solves}); {time.perf_counter() - t_phase:.1f} s")
    assert not failures, f"phase 14 failed for: {', '.join(failures)}"
    return launches, solves


def quietly(fn):
    """``fn()`` with its standard output kept out of the log; returns (its
    result, what it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue()


@contextlib.contextmanager
def no_browser():
    """The dashboard's browser tab suppressed: the card's machine is
    headless."""
    import gym_anm_torch.render.rendering as rendering

    orig = rendering.webbrowser.open
    rendering.webbrowser.open = lambda *a, **k: None
    try:
        yield
    finally:
        rendering.webbrowser.open = orig


def minijs_module():
    """``tests/minijs.py``, the repository's pure-Python JS interpreter."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent / "tests" / "minijs.py"
    spec = importlib.util.spec_from_file_location("minijs", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def frames_differ(fc, fh):
    """The largest |card - CPU| over an update frame's float fields (none
    where the network collapsed: such a frame shows the load flow's last
    iterate, not a solution), or inf where a field that must be equal
    (``time``, ``yearCount``, ``networkCollapsed``) or the set of fields
    differs."""
    exact = ("messageLabel", "time", "yearCount", "networkCollapsed")
    if fc.keys() != fh.keys() or any(fc[k] != fh[k] for k in exact):
        return math.inf
    floats = [] if fc["networkCollapsed"] else fc.keys() - set(exact)
    return max((float(np.max(np.abs(np.asarray(fc[k], float) - np.asarray(fh[k], float)))) for k in floats),
               default=0.0)


T_RENDER = 96  # one day of ANM6Easy at delta_t = 15 min
# mpc_vec runs float32 on both devices: their transitions' elementwise float32
# arithmetic rounds apart (CUDA's and the CPU's sin, exp), so a policy's mean
# reward per step is held within 1e-4.
F32_REWARD_ATOL = 1e-4


def phase15a_renderer(op_base):
    """ANM6Easy with ``render()`` every step on the card and on the CPU: equal
    frames, no GPU op and no sync in ``render()``, the page executed by
    ``tests/minijs.py`` against the card's servers."""
    import urllib.request

    import gym_anm_torch.compat as tc
    from gym_anm_torch.render import WsClient

    minijs = minijs_module()
    ec, eh = env_pair(lambda d: tc.ANM6Easy(device=d))
    clients, browser, ms_render = [], None, []
    try:
        np.random.seed(15)
        host_twin(lambda: ec.reset(seed=15), lambda: eh.reset(seed=15))
        with no_browser():
            quietly(lambda: host_twin(ec.render, eh.render))
        clients = [WsClient(ec.ws_server.address), WsClient(eh.ws_server.address)]
        init_c, init_h = (json.loads(c.recv()) for c in clients)
        assert init_c == init_h, "the init frames differ between the card and the CPU"
        rng = np.random.default_rng(15)
        lo, hi = eh.action_space.low, eh.action_space.high
        err, ops, syncs, n_term = 0.0, None, None, 0
        for t in range(T_RENDER):
            a = rng.uniform(lo, hi)
            (_, _, term_c, _, _), (_, _, term_h, _, _) = host_twin(lambda: ec.step(a), lambda: eh.step(a))
            t1 = time.perf_counter()
            if t == 1:
                ops, syncs = count_ops(ec.render, op_base)
            else:
                torch.cuda.set_sync_debug_mode("error")
                try:
                    ec.render()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            t2 = time.perf_counter()
            eh.render()
            if t != 1:
                ms_render.append(1e3 * (t2 - t1))
            fc, fh = (json.loads(c.recv()) for c in clients)
            assert fc["messageLabel"] == "update" and term_c == term_h, f"step {t}: frames or terms differ"
            err = max(err, frames_differ(fc, fh))
            if term_c:
                n_term += 1
                host_twin(ec.reset, eh.reset)
        # The card's step alone, for its time beside render(), from a reset
        # under zero set-points.
        ec.reset()
        ms_alone = []
        for _ in range(8):
            t0 = time.perf_counter()
            ec.step(np.zeros_like(lo))
            ms_alone.append(1e3 * (time.perf_counter() - t0))
        # The page, fetched over HTTP from the card's server, executed by minijs.
        html = urllib.request.urlopen(ec.http_server.address, timeout=10).read().decode()
        page = minijs.MiniJSPage(html)
        browser = WsClient(page.sockets[-1].address)
        page.deliver(browser.recv())  # the init frame, replayed
        ec.render()
        page.deliver(browser.recv())
        v_card = [f"{v:.3f}" for v in ec.simulator.state["bus_v_magn"]["pu"].values()]
        labels = [e.js_get("textContent") for e in page.query("#net text.vlbl") if e.js_get("textContent")]
        counts = (len(page.query("#net circle.bus")), len(page.query("#net line.branch")),
                  len(page.query("#devpanel .card")))
    finally:
        for c in clients + ([browser] if browser is not None else []):
            c.close()
        ec.close()
        eh.close()
    ms_step, ms_render = statistics.mean(ms_alone), statistics.mean(ms_render)
    log(f"15a renderer: ANM6Easy, {T_RENDER} steps with render() on the card and the CPU ({n_term} terminal, each "
        f"followed by a reset of both): init frames equal, update frames max |card - CPU| {err:.3e} (time, "
        f"yearCount, networkCollapsed equal; float fields where the network stands); render() on the card: {ops} "
        f"GPU ops, {syncs} host syncs; ms per step on the card {ms_step:.3f} without render(), "
        f"{ms_step + ms_render:.3f} with it (render() {ms_render:.3f}, host clock); the page over HTTP in "
        f"tests/minijs.py: {counts[0]} buses, {counts[1]} branches, {counts[2]} device cards, voltage labels "
        f"{labels} (card bus_v_magn {v_card})")
    assert err <= 1e-8, f"the card's frames are {err:.3e} from the CPU's"
    assert ops == 0 and syncs == 0, f"render() on the card ran {ops} GPU ops and {syncs} host syncs"
    assert counts == (6, 5, 7) and labels == v_card, "the page does not show the card's network"
    assert all(0.5 < float(v) < 1.5 for v in labels), f"voltage labels {labels} far from 1 p.u."


def phase15b_examples():
    """The examples of ``gym_anm_torch.examples`` at their JAX defaults on the
    card, each beside the same example on the CPU."""
    from gym_anm_torch.examples import (custom_anm6, mpc_constant, mpc_perfect, mpc_vec, offline_mixed, random_agent,
                                        simple_env)

    failures = []
    runs = (
        ("simple_env", simple_env.run, dict(seed=15), 1e-8),
        ("custom_anm6", custom_anm6.run, dict(seed=15), 1e-8),
        ("random_agent", random_agent.run, dict(render=True, sleep=0, seed=15), 1e-8),
        ("mpc_constant", mpc_constant.run, dict(seed=15), 1e-6),
        ("mpc_perfect", mpc_perfect.run, dict(seed=15), 1e-6),
        ("offline_mixed", offline_mixed.run, dict(seed=15), 1e-8),
        ("mpc_vec", mpc_vec.run, {}, F32_REWARD_ATOL),
    )
    for name, run, kw, atol in runs:
        np.random.seed(15)
        t0 = time.perf_counter()
        with no_browser():
            (res_c, _), (res_h, _) = host_twin(lambda: quietly(lambda: run(device="cuda", **kw)),
                                               lambda: quietly(lambda: run(device="cpu", **kw)))
        torch.cuda.synchronize()
        if name == "mpc_vec":
            assert res_c.keys() == res_h.keys()
            res_c, res_h = list(res_c.values()), list(res_h.values())
            what = "mean reward per step of constant N=1, perfect N=2/4/8"
        elif name == "offline_mixed":
            res_c, res_h = np.concatenate([x.ravel() for x in res_c]), np.concatenate([x.ravel() for x in res_h])
            what = "states and actions"
        else:
            what = "rewards"
        res_c, res_h = np.asarray(res_c, float), np.asarray(res_h, float)
        err = float(np.max(np.abs(res_c - res_h)))
        log(f"15b {name}: {res_c.size} values ({what}); max |card - CPU| {err:.3e} (tolerance {atol:.0e}); card "
            f"mean {res_c.mean():+.6f}; {time.perf_counter() - t0:.1f} s for both")
        if not (res_c.shape == res_h.shape and np.all(np.isfinite(res_c)) and err <= atol):
            failures.append(name)
    try:
        import gymnasium.wrappers.vector  # noqa: F401

        from gym_anm_torch.examples import gym_vector_interop

        total, episodes = quietly(lambda: gym_vector_interop.run(device="cuda"))[0]
        log(f"15b gym_vector_interop: total reward {total:+.4f}, {episodes} episodes")
        if not np.isfinite(total):
            failures.append("gym_vector_interop")
    except ImportError as e:
        log(f"15b gym_vector_interop: not run: it needs gymnasium.wrappers.vector, which this machine lacks ({e})")
    assert not failures, f"phase 15b failed for: {', '.join(failures)}"


L0L5_TABLE_STEPS = 100  # of the script's 300: the phase's time


def seeded_action_spaces(module):
    """``module.IEEE33ProperEnvironment`` replaced by a factory whose
    environments' action spaces are seeded with 0 (the dataset script's
    compat mode leaves them unseeded, and its L0 samples them); returns the
    function that restores it."""
    cls = module.IEEE33ProperEnvironment

    def make(*args, **kwargs):
        env = cls(*args, **kwargs)
        env.action_space.seed(0)
        return env

    module.IEEE33ProperEnvironment = make
    return lambda: setattr(module, "IEEE33ProperEnvironment", cls)


def phase15c_scripts(smi_line):
    """The dataset, quality-table and bench scripts through their ``main`` on
    the card."""
    import pickle
    import tempfile

    import gym_anm_torch.compat as tc
    from gym_anm_torch import _build
    from gym_anm_torch.scripts import exp_rti_budget as rti
    from gym_anm_torch.scripts import generate_final_offline_datasets as gfod
    from gym_anm_torch.scripts import l0l5_quality_table as l0l5
    from gym_anm_torch.scripts import quick_dataset_test as quick
    from gym_anm_torch.scripts import scaling_bench as scaling
    from gym_anm_torch.scripts import verify_h100 as verify
    from gym_anm_torch.vec import VecEnv, make_ieee33_multicap_task

    def load(d, name):
        with open(f"{d}/{name}.pkl", "rb") as f:
            return pickle.load(f)

    with tempfile.TemporaryDirectory(prefix="phase15_", dir=_build.BUILD_DIR.parent) as tmp:
        t0 = time.perf_counter()
        _, printed = quietly(lambda: gfod.main(["--out", f"{tmp}/vec"]))
        dt = time.perf_counter() - t0
        rate = float(re.search(r"\(([\d,]+) transitions/s", printed).group(1).replace(",", ""))
        combined, summary = load(f"{tmp}/vec", "combined_dataset"), load(f"{tmp}/vec", "summary")
        box = VecEnv(make_ieee33_multicap_task(), device="cpu")
        lo, hi = box.action_low.numpy(), box.action_high.numpy()
        finite = all(np.all(np.isfinite(combined[k])) for k in ("states", "actions", "rewards", "next_states"))
        in_box = bool(np.all(combined["actions"] >= lo) and np.all(combined["actions"] <= hi))
        returns = {s["controller"]: s["avg_return"] for s in summary}
        log(f"15c generate_final_offline_datasets (vec, 6 x 1024 lanes x 100 steps, multicap17 float32): "
            f"{len(combined['rewards'])} transitions, finite {finite}, actions in the box {in_box}; "
            f"{rate:,.0f} transitions/s in the collection, {dt:.1f} s in main with the pickles ({smi_line}); "
            f"avg return per lane {', '.join(f'{k} {v:+.4f}' for k, v in returns.items())}")
        assert finite and in_box and len(combined["rewards"]) == 6 * 1024 * gfod.VEC_STEPS
        assert returns["L0"] < min(v for k, v in returns.items() if k != "L0"), "L0 beats an informed controller"

        restore = seeded_action_spaces(tc)
        try:
            np.random.seed(15)
            t0 = time.perf_counter()
            host_twin(lambda: quietly(lambda: gfod.main(["--compat", "--episodes", "2", "--out", f"{tmp}/c"])),
                      lambda: quietly(lambda: gfod.main(["--compat", "--episodes", "2", "--out", f"{tmp}/h",
                                                         "--cpu"])))
        finally:
            restore()
        err, n = 0.0, 0
        for cls in gfod.CONTROLLERS:
            dc, dh = load(f"{tmp}/c", f"{cls.name}_data"), load(f"{tmp}/h", f"{cls.name}_data")
            for k in ("states", "actions", "rewards", "next_states", "episode_returns"):
                assert np.shape(dc[k]) == np.shape(dh[k]), (cls.name, k)
                err = max(err, float(np.max(np.abs(np.asarray(dc[k]) - np.asarray(dh[k])))))
            assert np.array_equal(dc["dones"], dh["dones"]), cls.name
            n += len(dc["rewards"])
        log(f"15c generate_final_offline_datasets --compat --episodes 2: {n} transitions of the six Simple "
            f"controllers on the card and the CPU, max |card - CPU| {err:.3e}; {time.perf_counter() - t0:.1f} s "
            "for both")
        assert err <= 1e-8, f"the compat datasets differ by {err:.3e}"

    out, _ = quietly(lambda: quick.main([]))
    runs = [f"{k} {len(d['rewards'])} transitions, avg return {np.mean(d['episode_returns']):+.4f}"
            for k, d in out.items()]
    log(f"15c quick_dataset_test: {', '.join(runs)}")
    assert all(np.all(np.isfinite(d["rewards"])) for d in out.values())

    t0 = time.perf_counter()
    table, _ = quietly(lambda: l0l5.main(["--steps", str(L0L5_TABLE_STEPS), "--skip-reference"]))
    ours = table["ours"]
    log(f"15c l0l5_quality_table --steps {L0L5_TABLE_STEPS} (cut from 300 for the phase's time) --skip-reference: "
        f"{', '.join(f'{k} {ours[k]:+.4f}' for k in l0l5.ORDER)}; ranking "
        f"{' > '.join(sorted(ours, key=ours.get, reverse=True))}; {time.perf_counter() - t0:.1f} s")
    assert all(np.isfinite(v) for v in ours.values())

    t0 = time.perf_counter()
    budgets, _ = quietly(lambda: rti.main(["--budgets", "24,32,48,96,200"]))
    log(f"15c exp_rti_budget (ANM6Easy float32, quality {rti.QUALITY[0]} lanes x {rti.QUALITY[1]} steps, "
        f"throughput {rti.THROUGHPUT[0]} lanes x {rti.THROUGHPUT[1]} steps, median of {rti.THROUGHPUT[2]}; "
        f"{smi_line}): " + "; ".join(f"budget {b}: {tp:,.0f} env-steps/s, reward/step {q:+.5f}"
                                      for b, (tp, q) in budgets.items()) + f"; {time.perf_counter() - t0:.1f} s")
    assert all(tp > 0 and np.isfinite(q) for tp, q in budgets.values())

    t0 = time.perf_counter()
    sc, _ = quietly(lambda: scaling.main([]))
    r = sc["results"][0]
    log(f"15c scaling_bench (one rank spawned on the card, per-rank batch {sc['per_device_batch']}, its kernel "
        f"launches not counted here): world size {r['ranks']}: {r['steps_per_s']:,.0f} env-steps/s; "
        f"{time.perf_counter() - t0:.1f} s")
    assert [x["ranks"] for x in sc["results"]] == [1] and r["steps_per_s"] > 0

    t0 = time.perf_counter()
    ok, printed = quietly(lambda: verify.main([]))
    lines = printed.splitlines()
    n_pass, fails = sum(x.startswith("PASS") for x in lines), [x for x in lines if x.startswith(("FAIL", "SKIP"))]
    build_s = next((x.split()[-1] for x in lines if x.startswith("BUILD_WALL_SECONDS")), "?")
    log(f"15c verify_h100: {n_pass} PASS, {len(fails)} FAIL or SKIP {fails}; clean build {build_s} s; "
        f"{lines[-1]}; {time.perf_counter() - t0:.1f} s")
    assert ok and not fails and n_pass == 15, "verify_h100 did not pass every probe"


def phase15_render_examples_scripts(kernel, chord_k, admm_k, flows_k, smi_line):
    """The renderer, the examples and the scripts on the card (15a-c); returns
    the launches of K3, K2, K5 and K6 in its runs on the card and K1's solves
    inside K3."""
    log("== phase 15: the renderer, the examples and the scripts on the card, against the CPU")
    log(f"15 gymnasium: {gymnasium_module()}")
    op_base = count_ops(lambda: None)
    t_phase = time.perf_counter()
    kernel.launch_count = chord_k.launch_count = admm_k.launch_count = flows_k.launch_count = 0
    dense0 = kernel.launches["dense"]
    for part in (lambda: phase15a_renderer(op_base), phase15b_examples, lambda: phase15c_scripts(smi_line)):
        t0 = time.perf_counter()
        part()
        log(f"15: part done in {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    launches = (kernel.launch_count, chord_k.launch_count, admm_k.launch_count, flows_k.launch_count)
    solves = kernel.solves
    log(f"15: K3 launches {launches[0]} ({kernel.launches['dense'] - dense0} with the dense Y; K1 solves inside it "
        f"{solves}), K2 {launches[1]}, K5 {launches[2]}, K6 {launches[3]}; {time.perf_counter() - t_phase:.1f} s")
    assert all(n > 0 for n in launches) and solves > 0, f"a kernel of phase 15's path never launched: {launches}"
    return launches + (solves,)


def log_ptxas(report):
    """One line per kernel of ptxas's report: registers and spill bytes."""
    b = {"0": "false", "1": "true", "f": "float", "d": "double"}
    names = ((r"gj_regsI([fd])Li(\d+)E", lambda t, k: f"gj_regs<{b[t]}, {k}>"),
             (r"gj_panelsI([fd])Li(\d+)ELb([01])E", lambda t, k, r: f"gj_panels<{b[t]}, {k}, {b[r]}>"),
             (r"chord_kernelILi(\d+)ELi(\d+)E", lambda a, c: f"chord_kernel<{a}, {c}>"),
             (r"chord_wide_kernelILi(\d+)E", lambda k: f"chord_wide_kernel<{k}>"),
             (r"(staged|streamed)11admm_kernel", lambda r: f"{r}::admm_kernel"),
             (r"newton_kernelI([fd])Li(\d+)ELb([01])E", lambda t, k, y: f"newton_kernel<{b[t]}, {k}, {b[y]}>"),
             (r"newton_wide_kernelI([fd])Li(\d+)ELb([01])ELb([01])E",
              lambda t, k, r, y: f"newton_wide_kernel<{b[t]}, {k}, {b[r]}, {b[y]}>"),
             (r"newton_cluster_kernelI([fd])Li(\d+)ELi(\d+)ELb([01])E",
              lambda t, k, c, y: f"newton_cluster_kernel<{b[t]}, {k}, {c}, {b[y]}>"))
    name = spill = None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = next((fmt(*k.groups()) for pat, fmt in names if (k := re.search(pat, m.group(1)))), m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            log(f"ptxas: {name}: {m.group(1)} registers, {spill}")
            name = None


def phase16_flows():
    """K6 beside its plain version at the cells' shapes, on the arguments of
    one real step: ``flows_probe.measure`` first holds K6's outputs to the
    plain version's (elementwise bit for bit, the values after a sum within
    4 float32 ulps; a mismatch fails the run), then times both.  Returns the
    rows, the IEEE33 shape's first.  The device ops a call come from
    ``python -m gym_anm_torch.bench.flows_probe`` alone: after this run's
    many profiler sessions a session loses its last events."""
    from gym_anm_torch.bench import flows_probe

    log("== phase 16: K6 against its plain version at the cells' shapes, then timed")
    rows = flows_probe.measure(N_LAUNCH, count_ops=False)
    for r in rows:
        log(f"16 flows {r['shape']} B={r['lanes']}: K6 equals the plain version (largest gap after a sum "
            f"{r['max_abs_err']:.3e}); K6 {r['k6_median_ms']:.4f} ms (readings "
            f"{', '.join(f'{x:.4f}' for x in r['k6_ms'])}), plain {r['plain_median_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), K6 at {r['share']:.3f} of it")
    return rows


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is visible; it runs only on a card", file=sys.stderr)
        return 1
    from gym_anm_torch import _build
    from gym_anm_torch.physics import linsolve_cuda as lin
    from gym_anm_torch.physics import power_flow as pf
    from gym_anm_torch.physics import ybus
    from gym_anm_torch.physics.chord_cuda import chord_solve_cuda
    from gym_anm_torch.physics.flows_cuda import transition_flows_cuda
    from gym_anm_torch.physics.transition import transition
    from gym_anm_torch.specs.constants import STATE_VARIABLES
    from gym_anm_torch.vec import (VecEnv, make_anm6easy_task, make_ieee33_multicap_task, make_ieee33_renewable_task,
                                   make_ieee33_task)
    from gym_anm_torch.vec import mpc
    from gym_anm_torch.vec.admm_cuda import solve_dcopf_cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0]
    log(f"nvidia-smi: {smi_line}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib_path = _build.library_path()
    _build.load_library()
    log(f"K1, K2 (tile and wide), K3, K5 and K6 built/loaded in {time.perf_counter() - t0:.1f} s: {lib_path.name}")
    log_ptxas(_build.ptxas_report())

    nc = pf.newton_fallback_cuda
    kernel = K3Counts(pf)  # the main paths' Newton loop: K3's launches and K1's solves inside it
    t_run = time.perf_counter()

    def run(phase, *args):
        out = phase(*args)
        log(f"-- {phase.__name__} done, {time.perf_counter() - t_run:.1f} s since the build")
        return out

    k1 = run(phase1_kernel_vs_plain, lin)
    k2 = run(phase1b_chord_kernel, pf, chord_solve_cuda, VecEnv, make_ieee33_task, make_ieee33_multicap_task,
             make_anm6easy_task)
    flows_k = transition_flows_cuda
    launches, chord_launches, flows_launches, solves = run(phase2_main_path, VecEnv, make_ieee33_task, kernel,
                                                           chord_solve_cuda, flows_k)
    run(phase3_fallback, VecEnv, make_ieee33_task, pf, ybus, kernel)
    k3 = run(phase3b_newton_kernel, pf, lin, nc, VecEnv, make_ieee33_task, make_anm6easy_task, ybus.LaneYbus)
    run(phase4_tf32, VecEnv, make_ieee33_task)
    mc_launches, mc_chord_launches, mc_flows_launches, mc_solves = run(
        phase5_multicap, VecEnv, make_ieee33_multicap_task, transition, kernel, chord_solve_cuda, flows_k)
    bare_rate = run(phase6_times, VecEnv, make_ieee33_task, make_ieee33_multicap_task)
    col_launches, col_chord_launches, col_flows_launches, col_solves = run(
        phase7_collection, VecEnv, make_ieee33_multicap_task, transition, kernel, chord_solve_cuda, flows_k, bare_rate)
    a6_launches, a6_chord_launches, a6_flows_launches, a6_rate, a6_solves = run(
        phase8_anm6easy, VecEnv, make_anm6easy_task, STATE_VARIABLES, ybus.build_ybus, kernel, chord_solve_cuda,
        flows_k)
    cold_set, k5 = run(phase9a_admm_kernel, mpc, solve_dcopf_cuda, VecEnv, make_anm6easy_task,
                       make_ieee33_renewable_task)
    run(phase9a_k5_routes, mpc, solve_dcopf_cuda, VecEnv, make_anm6easy_task, make_ieee33_renewable_task)
    run(phase9b_highs, mpc, cold_set)
    k5_launches, farm_record, _ = run(phase9c_farm, mpc, solve_dcopf_cuda, VecEnv, make_anm6easy_task, kernel,
                                      chord_solve_cuda)
    run(phase9d_replay, mpc, VecEnv, make_anm6easy_task, farm_record)
    k2w, k1g, k1s, k3w = run(phase10_feeders, pf, lin, chord_solve_cuda, VecEnv, kernel, nc)
    ppo_k3, ppo_k2, ppo_k6, ppo_k1 = run(phase11_ppo, VecEnv, make_ieee33_multicap_task, kernel, chord_solve_cuda,
                                         flows_k)
    cql_k3, cql_k2, cql_k6, cql_k1 = run(phase12_cql, kernel, chord_solve_cuda, flows_k)
    sim_k3, _, sim_k1 = run(phase13_simulator, lin, kernel)
    host_k3, host_k1 = run(phase14_host_tier, kernel)
    tail_k3, tail_k2, tail_k5, tail_k6, tail_k1 = run(phase15_render_examples_scripts, kernel, chord_solve_cuda,
                                                      solve_dcopf_cuda, flows_k, smi_line)
    k6_rows = run(phase16_flows)
    k6 = k6_rows[0]  # IEEE33 at 262,144 lanes

    # Launches: the runs of the base, multicap17, collection, ANM6Easy, the learners', the compat Simulator's, the
    # host tier's and phase 15's paths together.  On these paths (n <= 64) K1's register route runs inside K3, one
    # solve a lane-iteration: its "launches" count those solves (K3's n_iter out - n_iter in, from K3's outputs).
    # On the feeders' path (phase 10) K1's panel routes run inside K3 wide the same way.
    print(json.dumps({"kernels": [{
        "name": "gauss_jordan",
        "route": "cuda",
        "source": "gym_anm_torch/csrc/gauss_jordan.cu",
        "replaces": "gym_anm_tpu/physics/linsolve_pallas.py:31",
        "launches": (solves + mc_solves + col_solves + a6_solves + ppo_k1 + cql_k1 + sim_k1 + host_k1 + tail_k1),
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"],
    }, {
        "name": "newton_fallback",
        "route": "cuda",
        "source": "gym_anm_torch/csrc/newton_fallback.cu",
        "replaces": "gym_anm_tpu/physics/power_flow.py:699",
        "launches": (launches + mc_launches + col_launches + a6_launches + ppo_k3 + cql_k3 + sim_k3 + host_k3
                     + tail_k3),
        "max_abs_err": k3["max_abs_err"],
        "ms": k3["ms"],
        "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"],
        "library_ms": None,  # no single PyTorch call runs the Newton loop
    }, {
        "name": "chord_newton",
        "route": "cuda",
        "source": "gym_anm_torch/csrc/chord_newton.cu",
        "replaces": "scripts/chord_pallas_prototype.py:168",
        "launches": (chord_launches + mc_chord_launches + col_chord_launches + a6_chord_launches + ppo_k2 + cql_k2
                     + tail_k2),
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "ms_b1": k2["ms_b1"],
        "ms_b1001": k2["ms_b1001"],
        "library_ms": None,  # no single PyTorch call runs the chord iteration
    }, {
        "name": "admm_dcopf",
        "route": "cuda",
        "source": "gym_anm_torch/csrc/admm_dcopf.cu",
        "replaces": "gym_anm_tpu/vec/mpc.py:357",
        "launches": k5_launches + tail_k5,  # the MPC farm's run (phase 9c) and phase 15's
        "max_abs_err": k5["max_abs_err"],
        "ms": k5["ms"],
        "plain_ms": k5["plain_ms"],
        "bound_ms": k5["bound_ms"],
        "bound_by": k5["bound_by"],
        "library_ms": None,  # no single PyTorch call runs the ADMM loop
    }, {
        "name": "chord_newton_wide",
        "route": "cuda",
        "source": "gym_anm_torch/csrc/chord_newton_wide.cu",
        "replaces": "scripts/chord_pallas_prototype.py:168",
        "launches": k2w["launches"],  # the random feeders' path (phase 10)
        "max_abs_err": k2w["max_abs_err"],
        "ms": k2w["ms"],
        "plain_ms": k2w["plain_ms"],
        "bound_ms": k2w["bound_ms"],
        "bound_by": k2w["bound_by"],
        "library_ms": None,  # no single PyTorch call runs the chord iteration
    }, {
        "name": "gauss_jordan_blocked",
        "route": "cuda",
        "source": "gym_anm_torch/csrc/gauss_jordan.cu",
        "replaces": "gym_anm_tpu/physics/linsolve_pallas.py:31",
        "launches": k1g["launches"],  # the random feeders' path (phase 10)
        "max_abs_err": k1g["max_abs_err"],
        "ms": k1g["ms"],
        "plain_ms": k1g["plain_ms"],
        "bound_ms": k1g["bound_ms"],
        "bound_by": k1g["bound_by"],
        "library_ms": k1g["library_ms"],
    }, {
        "name": "gauss_jordan_resident",
        "route": "cuda",
        "source": "gym_anm_torch/csrc/gauss_jordan.cu",
        "replaces": "gym_anm_tpu/physics/linsolve_pallas.py:31",
        "launches": k1s["launches"],  # the random feeders' path (phase 10)
        "max_abs_err": k1s["max_abs_err"],
        "ms": k1s["ms"],
        "plain_ms": k1s["plain_ms"],
        "bound_ms": k1s["bound_ms"],
        "bound_by": k1s["bound_by"],
        "library_ms": k1s["library_ms"],
    }] + [{
        "name": f"newton_fallback_wide_{route}",
        "route": "cuda",
        "source": "gym_anm_torch/csrc/newton_fallback_wide.cuh",
        "replaces": "gym_anm_tpu/physics/power_flow.py:699",
        # phase 10: [J | F] resident in a block or on a cluster (the random feeders' f32 path), or in device
        # memory (the f64 tier's step at 194 buses)
        "launches": k3w["by_route"][i],
        "max_abs_err": k3w[route]["max_abs_err"],
        "ms": k3w[route]["ms"],  # set (a) at 64 buses (resident), 130 buses (cluster) and 194 buses (f64, blocked)
        "plain_ms": k3w[route]["plain_ms"],
        "bound_ms": k3w[route]["bound_ms"],
        "bound_by": k3w[route]["bound_by"],
        "library_ms": None,  # no single PyTorch call runs the Newton loop
    } for i, route in enumerate(("resident", "cluster", "blocked"))] + [{
        "name": "transition_flows",
        "route": "cuda",
        "source": "gym_anm_torch/csrc/transition_flows.cu",
        "replaces": None,  # XLA fuses this work on the TPU; eager torch ran it as ~160 device ops
        "launches": (flows_launches + mc_flows_launches + col_flows_launches + a6_flows_launches + ppo_k6 + cql_k6
                     + tail_k6),
        "max_abs_err": max(r["max_abs_err"] for r in k6_rows),  # the values after a sum; elementwise bit for bit
        "ms": k6["k6_median_ms"],
        "plain_ms": k6["plain_median_ms"],
        "bound_ms": k6["bound_ms"],
        "bound_by": k6["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the flows
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
