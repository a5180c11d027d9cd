"""Where the kernels' time goes, on one card.

    python -m gym_anm_torch.bench.kernel_probes

1. ``dmma_shapes.cu``: the float64 tensor-core rate by mma shape.
2. K2 (``csrc/chord_newton.cu``), alone with ``python -m
   gym_anm_torch.bench.kernel_probes chord``: a copy with ``clock64``
   counters around the five steps of a round and the barrier after each
   (thread 0 of every block, read once a block), on the base IEEE33
   constants from warm starts at B = 8192 (``chip_smoke.py`` phase 1b's
   set) and on the chord inputs of a step of each IEEE33 cell (262,144 and
   524,288 lanes), at 8 and 16 slots a block: rounds per block, lanes a
   round, cycles per round by step, beside the kernel's own time at each
   width.
3. K1's register route (``csrc/gauss_jordan.cuh``): a copy with ``clock64``
   around the sweeps of the float32 64-row body, at B = 8192 and at few enough systems that every
   scheduler holds one warp: cycles per sweep of a warp.
4. K5 (``csrc/admm_dcopf.cu``): a copy with ``clock64`` counters (lane 0
   of every warp) gives its staged route's cycles per warp-sweep by step at
   the farm's call (``chip_smoke.py`` phase 9a's set, B = 8192).
5. The wide K2 (``csrc/chord_newton_wide.cu``): a copy with ``clock64``
   counters around the five steps of a round (thread 0 of every block), on
   the 130-bus feeder's warm starts at B = 8192 (``chip_smoke.py`` phase
   10's set): rounds per block and cycles per round by step, beside the
   kernel's own time.
6. K1's blocked route (``gj_panels`` in device memory) at n = 258, float32,
   B = 8192 with panels of 8, 16 and 32 pivots, each bitwise the plain
   version, beside ``torch.linalg.solve_ex``.
7. K1's shared-memory route (``gj_panels`` with the matrix resident in
   shared memory) at float32 n = 94, 126 and float64 n = 64, 126, B = 8192,
   at each panel width that fits, beside the blocked route on the same
   systems, ``solve_ex`` and, at float64 n = 48 and 64, the register
   route's float64 bodies.
8. K3 (``csrc/newton_fallback.cuh``): copies with ``clock64`` counters, one
   a variant of the source (:data:`NEWTON_VARIANTS`: as built, the 64-row
   body held at 2 or at 4 threads a row whatever the worklist's length, zero
   dividends divided), on ``chip_smoke.py`` phase 3b's sets (a), (c) at
   B = 1 and (f): cycles of a lane's start and, by lane-iteration, of the
   Jacobian, the sweeps, x with the vectors and F with the max, a block's
   triage and barrier, and each copy's time beside the kernel's own.
9. K3 wide's cluster route (``csrc/newton_fallback_wide.cuh``), alone with
   ``python -m gym_anm_torch.bench.kernel_probes newton_wide``: an
   instrumented copy's cycles a lane-iteration by step (the Jacobian,
   panel 0's push, step 2, step 3, the panels' cluster barriers, x and the
   vectors, F and the max), block 0 apart from the others, on the 130-bus
   feeder's lanes (all 8192 after the chord from bad-basin guesses, and one
   among accepted ones) and float64 from the flat start at B = 1 (64 and
   130 buses).
10. K3 wide's routes by batch, alone with ``python -m
   gym_anm_torch.bench.kernel_probes wide_routes``: the cluster and the
   blocked route held in turns on the same lanes, beside the rule's choice
   (``newton_cuda.batch_route``), at float64 64 buses from 1 to 8192 lanes
   and float32 82 and 130 buses at 264 and 1001.

The copies are built into ``build/kernels/probe/``; the counters cost
registers, so the instrumented K2 runs ~15% slower than the kernel itself
(both times are printed).  Needs a card and nvcc.
"""

import ctypes
import importlib
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from .. import _build
from ..physics import chord_cuda
from ..physics.chord_cuda import chord_solve_cuda
from ..physics.linsolve_cuda import BLOCKED_PANELS, k1_route, panel_smem_bytes, solve_gauss_jordan
from ..vec import (VecEnv, make_anm6easy_task, make_ieee33_multicap_task, make_ieee33_renewable_task,
                   make_ieee33_task)

OUT = _build.BUILD_DIR / "probe"
# The counters and their read-out, added to an instrumented copy.
COUNTERS = "__device__ unsigned long long g_probe[16];\nnamespace {\n"
READOUT = ('\nextern "C" int probe_read(unsigned long long* out) {\n'
           '  return (int)cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));\n}\n'
           'extern "C" int probe_zero() {\n  unsigned long long z[16] = {};\n'
           '  return (int)cudaMemcpyToSymbol(g_probe, z, sizeof(z));\n}\n')
CHORD_STEPS = ["(1) refill, stage F", "barrier", "(2) update product", "barrier", "(3) direction, AA, stage V",
               "barrier", "(4) mismatch product", "barrier", "(5) mismatch, exit test"]


def nvcc(src, out, *flags):
    OUT.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stderr)
    return out


def device_ms(fn, n=20):
    """Device ms per call over n back-to-back calls behind a sleep kernel."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def instrument_chord(src):
    """chord_newton.cu with cycle counters: thread 0 of every block times each
    step of a round and the barrier after it (:data:`CHORD_STEPS`), counts
    its rounds and the slots that held a lane in each, and adds its sums to
    ``g_probe`` once, when its block is done: [0..8] cycles by step, [9]
    rounds, [10] blocks, [11] slot-rounds with a lane.  The round's first
    barrier, an AND of the warps' all-done votes, becomes a count of the
    block's live slots (the first ``live`` lanes of a warp with ``live``
    slots vote), which gives both the exit and the count."""
    head = "  while (true) {\n"
    first = ("    bool done = true;\n#pragma unroll\n    for (int t = 0; t < LW; ++t) done &= s[t].phase == kDone;\n"
             "    if (__syncthreads_and(done)) break;\n")
    tail = "  }\n}\n\ntemplate <int KC1, int KH2, int LW, bool FR, int NN>\ncudaError_t launch("  # the loop's and kernel's end
    bar = "\n    __syncthreads();\n"
    assert all(src.count(m) == 1 for m in (head, first, tail)) and src.count(bar) == 3, "the round's layout changed"
    s = src.replace(head, "  long long T_[9] = {}, rounds_ = 0, live_ = 0;\n" + head
                    + "    const long long ta0 = clock64();\n")
    s = s.replace(first, "    int nlive_ = 0;\n#pragma unroll\n    for (int t = 0; t < LW; ++t) nlive_ += s[t].phase == kPro || "
                  "s[t].phase == kIter;\n    const long long tb1 = clock64();\n"
                  "    const int live_now_ = __syncthreads_count(lane < nlive_);\n    const long long ta1 = clock64();\n"
                  "    if (live_now_ == 0) break;\n    live_ += live_now_;\n")
    parts = s.split(bar)
    s = parts[0] + "".join(f"\n    const long long tb{i + 1} = clock64();\n    __syncthreads();\n"
                           f"    const long long ta{i + 1} = clock64();\n" + parts[i] for i in range(1, 4))
    s = s.replace(tail, "    const long long t[10] = {ta0, tb1, ta1, tb2, ta2, tb3, ta3, tb4, ta4, clock64()};\n"
                  "    for (int i = 0; i < 9; ++i) T_[i] += t[i + 1] - t[i];\n    ++rounds_;\n"
                  "  }\n  if (threadIdx.x == 0) {\n    for (int i = 0; i < 9; ++i) atomicAdd(&g_probe[i], "
                  "(unsigned long long)T_[i]);\n    atomicAdd(&g_probe[9], (unsigned long long)rounds_);\n"
                  "    atomicAdd(&g_probe[10], 1ull);\n    atomicAdd(&g_probe[11], (unsigned long long)live_);\n  }\n"
                  + tail[len("  }\n"):], 1)
    return s.replace("namespace {\n", COUNTERS, 1) + READOUT


def gj_source(*units):
    """K1's ``gauss_jordan.cuh`` and the translation units ``units`` of
    ``csrc/`` without their include, as one source."""
    text = (_build.CSRC_DIR / "gauss_jordan.cuh").read_text().replace("#pragma once\n", "")
    for unit in units:
        text += (_build.CSRC_DIR / unit).read_text().replace('#include "gauss_jordan.cuh"\n', "")
    return text


def instrument_gj(src):
    """K1's source (:func:`gj_source`) with the register route's float32
    64-row body's sweeps timed per warp."""
    a, b = "  sweeps<T, NP>(std::make_integer_sequence<int, NP>{}", "  T d = m[0];"
    assert src.count(a) == 1 and src.count(b) == 1, "the kernel's layout changed"
    s = src.replace(a, "  const long long t0 = clock64();\n" + a)
    s = s.replace(b, "  if (NP == 64 && sizeof(T) == 4 && lane == 0) {"
                  " atomicAdd(&g_probe[0], (unsigned long long)(clock64() - t0));"
                  " atomicAdd(&g_probe[1], 1ull); }\n" + b)
    return s.replace("namespace {\n", COUNTERS, 1) + READOUT


NEWTON_STEPS = ["lane start (Y, vectors)", "Jacobian", "sweeps", "x, vectors", "F, max, exit test"]
# The bodies the probe builds: n = 10's (one warp a lane) and the 64-row body.
NEWTON_BODIES = (10, 64)


def instrument_newton(src):
    """K3's device code (``newton_fallback.cuh``) with cycle counters: thread 0
    of every group sums its lanes' start (claim to the first vectors), and by
    lane-iteration the Jacobian, the sweeps, x with the vectors, and F with
    the max and the exit test; thread 0 of every block its triage and grid
    barrier.  Then an entry ``k3_probe`` for :data:`NEWTON_BODIES`."""
    marks = ("    const int i = claim<GW>(P.counters + 1, count, cell, g, bar);\n",
             "    while (true) {\n      // Thread (r, t)'s entries",
             "      // The elimination, then x <- x - J^-1 F",
             "      sweep_rounds<T, NP, TW>(std::make_integer_sequence<int, SS::U>{}, m, r, t, pb, src0, bar);\n",
             "      T vmax = T(0);\n",
             "      const bool improving = vmax < mul_rn(diff, T(0.5));",
             "  triage(P, NP <= 32 ? NP : 2 * P.nb);\n",
             "  const int count = __ldcg(P.counters);\n",
             "  const int bar = 1 + gi;\n")
    assert all(src.count(m) == 1 for m in marks), "K3's layout changed"
    clk = lambda q: f"{{ const long long tq = clock64(); T_[{q}] += tq - t_; t_ = tq; }}\n"  # noqa: E731
    s = src.replace(marks[6], "  const long long tk_ = clock64();\n" + marks[6])
    s = s.replace(marks[7], marks[7] + "  if (threadIdx.x == 0) { atomicAdd(&g_probe[8], (unsigned long long)"
                  "(clock64() - tk_)); atomicAdd(&g_probe[9], 1ull); }\n")
    s = s.replace(marks[8], marks[8] + "  long long T_[5] = {}, t_ = 0;\n  unsigned long long its_ = 0, lanes_ = 0;\n")
    s = s.replace(marks[0], "    t_ = clock64();\n" + marks[0])
    s = s.replace(marks[1], "    " + clk(0) + "    ++lanes_;\n" + marks[1])
    s = s.replace(marks[2], "      " + clk(1) + marks[2])
    s = s.replace(marks[3], marks[3] + "      " + clk(2))
    s = s.replace(marks[4], "      " + clk(3) + marks[4])
    s = s.replace(marks[5], "      " + clk(4) + "      ++its_;\n" + marks[5])
    tail = "      P.stall[b] = stall;\n    }\n  }\n}\n"
    assert s.count(tail) == 1, "K3's layout changed"
    s = s.replace(tail, "      P.stall[b] = stall;\n    }\n  }\n  if (g == 0) {\n    for (int q = 0; q < 5; ++q) "
                  "atomicAdd(&g_probe[q], (unsigned long long)T_[q]);\n    atomicAdd(&g_probe[5], its_);\n"
                  "    atomicAdd(&g_probe[6], lanes_);\n  }\n}\n")
    s = s.replace('#include "gauss_jordan.cuh"\n',
                  '#include "gauss_jordan.cuh"\n__device__ unsigned long long g_probe[16];\n')
    entry = ['\ntemplate <typename T>\nint k3_probe_t(bool lane_y, int np, void** a, long long y_stride, '
             'int n_branch, double xtol, int lim_iter, int B, int nb, cudaStream_t st) {\n'
             '  const NewtonParams<T> P{(const T*)a[0], (const T*)a[1], (const T*)a[2], (const int*)a[3], '
             '(const unsigned char*)a[4], (const T*)a[5], (const T*)a[6], (const T*)a[7], (const T*)a[8], y_stride, '
             '(const long long*)a[9], (const long long*)a[10], (const T*)a[11], (const T*)a[12], (const T*)a[13], '
             '(const T*)a[14], (const T*)a[15], (const T*)a[16], n_branch, (T)xtol, lim_iter, (T*)a[17], (T*)a[18], '
             '(T*)a[19], (int*)a[20], (int*)a[21], (int*)a[22], (int*)a[23], B, nb};\n']
    for n in NEWTON_BODIES:
        for y in ("true", "false"):
            entry.append(f"  if (np == {n} && lane_y == {y}) return launch_newton<T, {n}, {y}>(P, st);\n")
    entry.append("  return -1;\n}\n}  // namespace\n\n"
                 'extern "C" int k3_probe(int f64, int lane_y, int np, void** a, long long y_stride, int n_branch, '
                 "double xtol, int lim_iter, int B, int nb, void* st) {\n"
                 "  const cudaStream_t s = static_cast<cudaStream_t>(st);\n"
                 "  return f64 ? k3_probe_t<double>(lane_y, np, a, y_stride, n_branch, xtol, lim_iter, B, nb, s)\n"
                 "             : k3_probe_t<float>(lane_y, np, a, y_stride, n_branch, xtol, lim_iter, B, nb, s);\n}\n")
    end = "\n}  // namespace\n"
    assert s.endswith(end)
    return s[: -len(end)] + "".join(entry) + READOUT


def newton_probe_call(lib, args, ybus):
    """One launch of the instrumented K3 (``lib``) on ``newton_fallback_cuda``'s
    arguments; returns its five outputs."""
    x, F, diff, it, acc, p, q = args
    B, nb = p.shape
    outs = [torch.empty_like(x), torch.empty_like(F), torch.empty_like(diff), torch.empty_like(it),
            torch.empty_like(it)]
    scratch = torch.zeros(3 + B, dtype=torch.int32, device=p.device)  # the counters, then the worklist
    lane_y = hasattr(ybus, "tap_magn")
    if lane_y:
        y = [None, None, ybus.f, ybus.t, ybus.series_re, ybus.series_im, ybus.shunt_im, ybus.shift_cos,
             ybus.shift_sin, ybus.tap_magn]
        y_stride, n_branch = 0, ybus.f.shape[0]
    else:
        y = [ybus[0], ybus[1]] + [None] * 8
        y_stride, n_branch = (ybus[0].shape[-1] ** 2 if ybus[0].dim() == 3 else 0), 0
    tensors = [x, F, diff, it, acc, p, q] + y + outs + [scratch]
    ptrs = [None if t is None else t.data_ptr() for t in tensors] + [scratch.data_ptr() + 12]
    ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    rc = lib.k3_probe(int(p.dtype == torch.float64), int(lane_y), 2 * nb, ptrs, y_stride, n_branch,
                      ctypes.c_double(1e-5), 100, B, nb, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    assert rc == 0, f"the instrumented K3 failed with {rc}"
    return outs


def probe_newton_sets():
    """Phase 3b's IEEE33 sets (a), (c) at B = 8192 and 1, (d) and (f): name ->
    (args, ybus)."""
    from ..physics import power_flow as pf
    from ..physics.ybus import LaneYbus

    sets = {}
    for dtype in (torch.float32, torch.float64):
        tb = VecEnv(make_ieee33_task(), dtype=dtype).tables
        n, B = tb.n_bus - 1, 8192
        g = torch.Generator(device="cuda").manual_seed(31)
        p = (-0.01 * (1.0 + torch.rand(B, n, generator=g, device="cuda"))).to(dtype)
        q = 0.5 * p
        a = (0.9 + 0.2 * torch.rand(B, generator=g, device="cuda")).to(dtype)
        tap = tb.tap0.expand(B, -1).clone()
        tap[:, tb.oltc_branch] = a.unsqueeze(1)
        ybus = LaneYbus(tb.n_bus, tb.br_f, tb.br_t, tb.series_re, tb.series_im, tb.shunt_im, tb.shift_cos,
                        tb.shift_sin, tap)
        if dtype == torch.float32:
            inv_da = 1.0 / a - 1.0 / tb.chord_a0
            dr, di = -tb.chord_y_re * inv_da, -tb.chord_y_im * inv_da
            pats = torch.stack([torch.cat([torch.zeros(n), torch.full((n,), v)]) for v in (1e-6, -1.0)]
                               + [torch.cat([torch.full((n,), 30.0), torch.ones(n)])]).to("cuda")
            bad = pf.chord_solve(p, q, di, dr, dr, di, tb.chord_t, x0=pats.repeat(B // 3 + 1, 1)[:B].contiguous())
            good = pf.chord_solve(p, q, di, dr, dr, di, tb.chord_t)
            sets["(a) IEEE33 f32 B=8192"] = (tuple(bad) + (p, q), ybus)
            sets["(d) IEEE33 f32 no lane iterates"] = (tuple(good) + (p, q), ybus)
            tail = torch.zeros(B, dtype=torch.bool, device="cuda")
            tail[1] = True
            init = tuple(torch.where(tail.view(-1, *[1] * (u.dim() - 1)), u, v).contiguous() for u, v in zip(bad, good))
            sets["(f) IEEE33 f32 tail"] = (init + (p, q), ybus)
        else:
            for b in (B, 1):
                Y = tuple(t[:b].contiguous() for t in ybus(slice(0, b)))
                x = torch.cat([torch.zeros(b, n, dtype=dtype, device="cuda"),
                               torch.ones(b, n, dtype=dtype, device="cuda")], dim=1)
                pb, qb = p[:b].contiguous(), q[:b].contiguous()
                F, _ = pf._mismatch(x, pb, qb, *Y, n)
                sets[f"(c) IEEE33 f64 B={b}"] = ((x, F, torch.amax(F.abs(), 1),
                                                  torch.zeros(b, dtype=torch.int32, device="cuda"), None, pb, qb), Y)
    return sets


# Variants of K3's source the probe builds beside it: name -> edit.  The
# width variants hold the 64-row body at one width whatever the worklist's
# length (the kernel picks 4 threads a row where the lanes that iterate fit
# its groups at once, else 2).
_K3_RULE = "    if (count <= static_cast<int>(gridDim.x) * BB::G_HI) {\n"
_K3_FACTOR = ("    const T q = div_rn(zero ? T(1) : mk, piv);\n"
              "    const T f = mul_rn(zero ? mul_rn(mk, copysign(T(1), piv)) : q, r == k ? T(0) : T(1));\n")
NEWTON_VARIANTS = {
    "as built": lambda s: s,
    "2 threads a row throughout": lambda s: s.replace(_K3_RULE, "    if (false) {\n"),
    "4 threads a row throughout": lambda s: s.replace(_K3_RULE, "    if (true) {\n"),
    "zero dividends divided": lambda s: s.replace(
        _K3_FACTOR, "    const T f = mul_rn(div_rn(mk, piv), r == k ? T(0) : T(1));\n"),
}


def probe_newton(variants=NEWTON_VARIANTS):
    """K3 by step (instrumented copies, one a variant of the source): cycles
    of a lane-iteration in the Jacobian, the sweeps, x with the vectors, and
    F with the max, and of a lane's start and a block's triage, on phase
    3b's sets (a), (c) at B = 1 and (f); each copy's time beside the
    kernel's own."""
    import concurrent.futures

    from ..physics.newton_cuda import newton_fallback_cuda

    src = (_build.CSRC_DIR / "newton_fallback.cuh").read_text()
    assert all(edit(src) != src for name, edit in variants.items() if name != "as built"), "K3's layout changed"
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        libs = dict(zip(variants, pool.map(lambda iv: load(instrument_newton(iv[1](src)), f"k3_probe_{iv[0]}"),
                                           enumerate(variants.values()))))
    for lib in libs.values():
        lib.k3_probe.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                                                       ctypes.c_double] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.k3_probe.restype = ctypes.c_int
    for name, (args, ybus) in probe_newton_sets().items():
        ref = newton_fallback_cuda(*args, ybus)
        t_k3 = statistics.median(device_ms(lambda: newton_fallback_cuda(*args, ybus)) for _ in range(5))
        for variant, lib in libs.items():
            lib.probe_zero()
            out = newton_probe_call(lib, args, ybus)
            torch.cuda.synchronize()
            assert all(torch.equal(u, v) for u, v in zip(out[3:], ref[3:])), "the instrumented copy's n_iter moved"
            T = read(lib)
            its, lanes = max(T[5], 1), max(T[6], 1)
            t_new = statistics.median(device_ms(lambda: newton_probe_call(lib, args, ybus)) for _ in range(5))
            steps = ", ".join(f"{s} {T[q] / (lanes if q == 0 else its):.0f}" for q, s in enumerate(NEWTON_STEPS))
            print(f"K3 {name} ({variant}, instrumented): {t_new:.4f} ms (the kernel {t_k3:.4f}); cycles a "
                  f"lane ({int(T[6])} lanes) / a lane-iteration ({int(T[5])}): {steps}; a block's triage and "
                  f"barrier {T[8] / max(T[9], 1):.0f}", flush=True)


CLUSTER_STEPS = ["lane start (Y, vectors)", "Jacobian", "panel 0 pushed, cluster barrier", "step 2 and block barrier",
              "step 3 (look-ahead in the owner)", "cluster barrier at a panel's end", "x, vectors, cluster barrier",
              "F, max, cluster barrier"]


def instrument_cluster(src):
    """K3 wide's device code (``newton_fallback_wide.cuh``) with cycle
    counters in thread 0 of every block of the cluster route: by
    lane-iteration the Jacobian, panel 0's push and barrier, then by panel
    step 2 with its block barrier, step 3, the wait at the panel's cluster
    barrier, then x with the vectors and F with the max (:data:`CLUSTER_STEPS`;
    block 0 in counters 0-7, the others in 8-15), a lane's start, and the
    lanes, lane-iterations and panels of block 0 (16-18)."""
    probe = ("#define PROBE_(q) if (threadIdx.x == 0) { const long long now_ = clock64(); "
             "atomicAdd(&g_probe[(q) + (rank ? 8 : 0)], (unsigned long long)(now_ - t_)); t_ = now_; }\n")
    edits = (
        ("namespace {\n", "namespace {\n__device__ unsigned long long g_probe[32];\n" + probe),
        ("    for (int p = 0; p < panels; ++p) {\n",
         "    for (int p = 0; p < panels; ++p) {\n      long long t_ = clock64();\n"
         "      if (threadIdx.x == 0 && rank == 0) atomicAdd(&g_probe[18], 1ull);\n"),
        ("      if (tid == 0) *ctr = 0;\n      __syncthreads();\n",
         "      if (tid == 0) *ctr = 0;\n      __syncthreads();\n      PROBE_(3)\n"),
        ("      cluster_sync();\n    }\n  }\n};\n",
         "      PROBE_(4)\n      cluster_sync();\n      PROBE_(5)\n    }\n  }\n};\n"),
        ("    for (int r = tid; r < n; r += kClThreads) {\n      xs[r] = P.x_in[o + r];\n",
         "    long long t_ = clock64();\n"
         "    for (int r = tid; r < n; r += kClThreads) {\n      xs[r] = P.x_in[o + r];\n"),
        ("    vectors(Yr, Yi);\n\n    while (true) {\n      // This block's rows",
         "    vectors(Yr, Yi);\n    PROBE_(0)\n"
         "    if (threadIdx.x == 0 && rank == 0) atomicAdd(&g_probe[17], 1ull);\n\n"
         "    while (true) {\n      // This block's rows"),
        ("      __syncthreads();\n      if (rank == 0) S.lookahead(0, tid);\n      cluster_sync();\n",
         "      __syncthreads();\n      PROBE_(1)\n      if (rank == 0) S.lookahead(0, tid);\n      cluster_sync();\n"
         "      PROBE_(2)\n"),
        ("      // The new mismatch of this block's rows and its max over the lane.\n      vectors(Yr, Yi);\n",
         "      t_ = clock64();\n      vectors(Yr, Yi);\n      PROBE_(6)\n"),
        ("      // The reference's stall rule and loop condition, the same in every\n      // thread of the cluster",
         "      PROBE_(7)\n      if (threadIdx.x == 0 && rank == 0) atomicAdd(&g_probe[16], 1ull);\n"
         "      // The reference's stall rule and loop condition, the same in every\n      // thread of the cluster"),
    )
    for a, b in edits:
        assert src.count(a) == 1, f"K3 wide's layout changed: {a!r}"
        src = src.replace(a, b)
    return src


def load_cluster_probe():
    """The kernel library with K3 wide's cluster route instrumented
    (:func:`instrument_cluster`), built from copies of ``csrc/`` under
    ``build/kernels/probe/k3w/``, with ``probe_read_f32``/``_f64`` and
    ``probe_zero_f32``/``_f64`` (the counters of each type's unit)."""
    d = OUT / "k3w"
    d.mkdir(parents=True, exist_ok=True)
    for f in _build.CSRC_DIR.glob("*.cu*"):
        text = f.read_text()
        if f.name == "newton_fallback_wide.cuh":
            text = instrument_cluster(text)
        for ty in ("f32", "f64"):
            if f.name == f"newton_fallback_cluster_{ty}.cu":
                text += (f'\nextern "C" int probe_read_{ty}(unsigned long long* out) {{\n'
                         f"  return (int)cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));\n}}\n"
                         f'extern "C" int probe_zero_{ty}() {{\n  unsigned long long z[32] = {{}};\n'
                         f"  return (int)cudaMemcpyToSymbol(g_probe, z, sizeof(z));\n}}\n")
        if not (d / f.name).exists() or (d / f.name).read_text() != text:
            (d / f.name).write_text(text)
    units = ["newton_fallback.cu", "newton_fallback_f32.cu", "newton_fallback_f32_high.cu", "newton_fallback_f64.cu",
             "newton_fallback_f64_high.cu", "newton_fallback_wide_f32.cu", "newton_fallback_wide_f64.cu",
             "newton_fallback_cluster_f32.cu", "newton_fallback_cluster_f64.cu"]
    lib = _build.declare(ctypes.CDLL(str(_build.build_library([d / u for u in units], "libk3w_probe", OUT))))
    for ty in ("f32", "f64"):
        getattr(lib, f"probe_read_{ty}").argtypes = [ctypes.c_void_p]
    return lib


def probe_newton_wide():
    """K3 wide's cluster route by step (an instrumented copy, the card's own
    route at each size): cycles a lane-iteration in each of
    :data:`CLUSTER_STEPS` for block 0 and for the others, on the 130-bus
    feeder's lanes after the chord from bad-basin guesses (float32, all 8192
    lanes, and one lane among accepted ones) and float64 from the flat
    start at B = 1 (64 and 130 buses); each beside the kernel's own time."""
    from ..networks.random_feeder import random_radial_network
    from ..physics import newton_cuda
    from ..physics import power_flow as pf
    from ..physics.transition import make_tables
    from ..physics.ybus import LaneYbus
    from ..specs import load_network

    lib, main = load_cluster_probe(), _build.load_library()
    for n_bus, dtype, B, kind in ((130, torch.float32, 8192, "bad"), (130, torch.float32, 8192, "one"),
                                  (130, torch.float64, 1, "flat"), (64, torch.float64, 1, "flat")):
        tb = make_tables(load_network(random_radial_network(np.random.default_rng(n_bus), n_bus)), 1.0, 100,
                         dtype=dtype, device="cuda")
        nb = tb.n_bus - 1
        g = torch.Generator(device="cuda").manual_seed(n_bus)
        p = (-0.004 * (1.0 + torch.rand(B, nb, generator=g, device="cuda"))).to(dtype)
        q = 0.5 * p
        tap = tb.tap0.expand(B, -1).clone()
        ybus = LaneYbus(tb.n_bus, tb.br_f, tb.br_t, tb.series_re, tb.series_im, tb.shunt_im, tb.shift_cos,
                        tb.shift_sin, tap)
        if kind == "flat":
            Y = tuple(t.contiguous() for t in ybus(slice(None)))
            x = torch.cat([torch.zeros_like(p), torch.ones_like(p)], dim=1)
            F, _ = pf._mismatch(x, p, q, *Y, nb)
            args, yb = (x, F, torch.amax(F.abs(), 1), torch.zeros(B, dtype=torch.int32, device="cuda"), None, p, q), Y
        else:
            dz = torch.zeros(B, dtype=dtype, device="cuda")
            bad = torch.cat([torch.full((B, nb), 30.0), torch.ones(B, nb)], dim=1).to("cuda", dtype)
            init = [t.contiguous() for t in pf.chord_solve(p, q, dz, dz, dz, dz, tb.chord_t, x0=bad)]
            if kind == "one":
                good = pf.chord_solve(p, q, dz, dz, dz, dz, tb.chord_t)
                keep = torch.arange(B, device="cuda") != 5
                init = [torch.where(keep.view(-1, *[1] * (u.dim() - 1)), v, u).contiguous() for u, v in zip(init, good)]
            args, yb = tuple(init) + (p, q), ybus
        route = newton_cuda.wide_route(2 * nb, dtype, main.newton_wide_smem_limit())
        ty = "f64" if dtype == torch.float64 else "f32"

        def call(lib_):
            kind_, cargs, outs = newton_cuda.k3_arguments(*args, yb)
            newton_cuda.launch(lib_, kind_, cargs, outs, B, nb, dtype, p.device, 1e-5, 100,
                               torch.cuda.current_stream().cuda_stream)
            return outs

        ref = call(main)
        getattr(lib, f"probe_zero_{ty}")()
        out = call(lib)
        torch.cuda.synchronize()
        assert all(torch.equal(u, v) for u, v in zip(out[3:], ref[3:])), "the instrumented copy's n_iter moved"
        T = (ctypes.c_ulonglong * 32)()
        getattr(lib, f"probe_read_{ty}")(T)
        its, lanes, panels = max(T[16], 1), max(T[17], 1), max(T[18], 1)
        blocks_other = route[2] - 1
        t_k = statistics.median(device_ms(lambda: call(main), 5) for _ in range(3))
        t_i = statistics.median(device_ms(lambda: call(lib), 5) for _ in range(3))
        per = lambda q, o: T[q + o] / (lanes if q == 0 else its) / (blocks_other if o else 1)  # noqa: E731
        steps = "; ".join(f"{s} {per(q, 0):.0f} / {per(q, 8):.0f}" for q, s in enumerate(CLUSTER_STEPS))
        print(f"K3 wide {n_bus} buses {dtype} B={B} ({kind}; route {route}): kernel {t_k:.4f} ms, instrumented "
              f"{t_i:.4f} ms; {int(T[17])} lanes, {int(T[16])} lane-iterations, {T[18] / its:.1f} panels an "
              f"iteration (block 0's); cycles a lane-iteration (a lane for the start), block 0 / each other block: "
              f"{steps}", flush=True)



def wide_route_lanes(n_bus, B, dtype, seed):
    """B lanes after the chord from bad-basin guesses on the random feeder
    of ``n_bus`` buses, the lanes' Y-bus a LaneYbus with random OLTC taps:
    (x, F, diff, n_iter, accepted, p, q), ybus."""
    from ..networks.random_feeder import random_radial_network
    from ..physics import power_flow as pf
    from ..physics.transition import make_tables
    from ..physics.ybus import LaneYbus
    from ..specs import load_network

    tb = make_tables(load_network(random_radial_network(np.random.default_rng(n_bus), n_bus)), 1.0, 100,
                     dtype=dtype, device="cuda")
    nb = tb.n_bus - 1
    g = torch.Generator(device="cuda").manual_seed(seed)
    p = -0.004 * (1.0 + torch.rand(B, nb, generator=g, device="cuda", dtype=dtype))
    tap = tb.tap0.expand(B, -1).clone()
    if len(tb.oltc_branch):
        tap[:, tb.oltc_branch] = 0.95 + 0.1 * torch.rand(B, 1, generator=g, device="cuda", dtype=dtype)
    ybus = LaneYbus(tb.n_bus, tb.br_f, tb.br_t, tb.series_re, tb.series_im, tb.shunt_im, tb.shift_cos,
                    tb.shift_sin, tap)
    pats = torch.stack([torch.cat([torch.zeros(nb), torch.full((nb,), v)]) for v in (1e-6, -1.0, 1e15)]
                       + [torch.cat([torch.full((nb,), 30.0), torch.ones(nb)])]).to("cuda", dtype)
    x0 = pats.repeat(B // 4 + 1, 1)[:B].contiguous()
    dz = torch.zeros(B, dtype=dtype, device="cuda")
    init = pf.chord_solve_plain(p, 0.5 * p, dz, dz, dz, dz, tb.chord_t, x0=x0)
    return tuple(t.contiguous() for t in init) + (p, (0.5 * p).contiguous()), ybus


def probe_wide_routes():
    """K3 wide's routes by batch (``newton_cuda.batch_route``): at each size
    whose shape route is the cluster's, the cluster route and the blocked
    route (a block a lane, [J | F] in device memory) on the same lanes
    through the wrapper, each held by replacing the rule for its reading,
    in turns, both bitwise equal, beside the rule's own choice: float64 at
    64 buses (the blocked grid's slots fit the L2) from 1 to 8192 lanes,
    float32 at 82 buses (fit) and at 130 buses (do not fit)."""
    from ..physics import newton_cuda

    rule = newton_cuda.batch_route
    nc = newton_cuda.newton_fallback_cuda
    cases = [(64, torch.float64, B) for B in (1, 66, 67, 132, 264, 1001, 8192)]
    cases += [(82, torch.float32, B) for B in (264, 1001)] + [(130, torch.float32, B) for B in (264, 1001)]
    for n_bus, dtype, B in cases:
        args, ybus = wide_route_lanes(n_bus, B, dtype, n_bus)
        calls, outs = {}, {}
        for held in ("cluster", "blocked"):
            def call(held=held):
                newton_cuda.batch_route = lambda *a: held
                try:
                    return nc(*args, ybus)
                finally:
                    newton_cuda.batch_route = rule
            before = nc.launches_by_route[held]
            outs[held] = call()
            assert nc.launches_by_route[held] == before + 1, f"the {held} route did not run"
            calls[held] = call
        torch.cuda.synchronize()
        same = all(torch.equal(torch.nan_to_num(u, 7.0), torch.nan_to_num(v, 7.0))
                   for u, v in zip(outs["cluster"], outs["blocked"]))
        ms = {k: [] for k in calls}
        for r in range(5):
            for k in (("cluster", "blocked") if r % 2 == 0 else ("blocked", "cluster")):
                ms[k].append(device_ms(calls[k], 5))
        med = {k: statistics.median(v) for k, v in ms.items()}
        before = dict(nc.launches_by_route)
        nc(*args, ybus)
        chose = next(k for k, v in nc.launches_by_route.items() if v != before[k])
        it = outs["cluster"][3] - args[3]
        print(f"K3 wide routes, {n_bus} buses {dtype} B={B}: {int((it > 0).sum())} lanes iterate, "
              f"{int(it.sum())} lane-iterations; cluster {med['cluster']:.4f} ms, blocked {med['blocked']:.4f} ms "
              f"(device time, 5 calls a reading, median of 5 in turns); the rule takes {chose}; the two routes "
              f"bitwise equal: {same}", flush=True)


PANEL_STEPS = ["load the panels", "(1) diagonal block", "(2) panel rows and columns", "(3) trailing update"]


def instrument_panels(src):
    """K1's source (:func:`gj_source`) with the panel kernel's four steps
    timed by thread 0 of every block (cycles summed over blocks and panels;
    the panels counted)."""
    loop = "  for (int k0 = 0; k0 < n; k0 += BP) {\n"
    bar = "\n    __syncthreads();\n"
    assert src.count(loop) == 1 and src.count(bar) == 4, "the kernel's layout changed"
    s = src.replace(loop, loop + "    long long t_p = clock64();\n"
                    "    if (tid == 0) atomicAdd(&g_probe[4], 1ull);\n")
    parts = s.split(bar)
    s = parts[0] + "".join(
        bar + f"    {{ const long long t_q = clock64(); if (tid == 0) atomicAdd(&g_probe[{q}], "
        f"(unsigned long long)(t_q - t_p)); t_p = t_q; }}\n" + part for q, part in enumerate(parts[1:]))
    return s.replace("namespace {\n", COUNTERS, 1) + READOUT


ADMM_STEPS = ["(a) stage v", "(b) t product, stage rhs", "(c) w product and the chain", "check and refill"]


def instrument_admm(src):
    """admm_dcopf.cu with cycle counters (lane 0 of every warp) around the
    three steps of a sweep, and around a check with its exits and refills."""
    marks = {
        "  const float a = P.alpha, bm = P.one_minus_alpha;\n":
            "  long long PT[6] = {0, 0, 0, 0, 0, 0};\n",
        "    for (int s = 0; s < P.K; ++s) {\n": "    const long long tl0 = clock64();\n",
        "      // (a) Stage v = rho z - y": "      const long long ta = clock64();\n      ++PT[5];\n",
        "      // (b) t = v A_bar": "      const long long tb = clock64();\n      PT[0] += tb - ta;\n",
        "      // (c) w = P_pack rhs": "      PT[1] += clock64() - tb;\n",
        "    // The check: stage y": "    const long long tk = clock64();\n    PT[2] += tk - tl0;\n",
    }
    for mark, code in marks.items():
        assert src.count(mark) == 1, f"the kernel's layout changed: {mark!r}"
        src = src.replace(mark, code + mark if mark.startswith("    ") or mark.startswith("      ") else mark + code)
    tail = "    refill();\n  }\n}\n"
    assert src.count(tail) == 1, "the kernel's layout changed"
    src = src.replace(tail, "    refill();\n    PT[3] += clock64() - tk;\n    ++PT[4];\n  }\n"
                      "  if (lane == 0)\n    for (int i = 0; i < 6; ++i) atomicAdd(&g_probe[i], (unsigned long long)PT[i]);\n"
                      "  if (lane == 0) atomicAdd(&g_probe[6], 1ull);\n}\n")
    return src.replace("namespace {\n", COUNTERS, 1) + READOUT


def load(src_text, name):
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / f"{name}.cu"
    src.write_text(src_text)
    return _build.declare(ctypes.CDLL(str(nvcc(src, OUT / f"{name}.so", "-shared", "-I", str(_build.CSRC_DIR)))))


def read(lib):
    buf = (ctypes.c_ulonglong * 16)()
    lib.probe_read(buf)
    return list(buf)


def probe_dmma():
    exe = nvcc(Path(__file__).with_name("dmma_shapes.cu"), OUT / "dmma_shapes")
    print(subprocess.run([str(exe)], capture_output=True, text=True, check=True).stdout, end="")


def chord_call(lib, args, ct, x0, slots):
    """One launch of K2's ``chord_newton_f32`` from ``lib`` (the kernel or an
    instrumented copy) at ``slots`` slots a block, on ``chord_solve_cuda``'s
    arguments; returns n_iter."""
    B, n = args[0].shape
    outs = chord_cuda.kernel_outputs(B, n, "cuda")
    nxt = torch.zeros(1, dtype=torch.int32, device="cuda")
    rc = lib.chord_newton_f32(*chord_cuda.kernel_args(args, ct, x0, outs), nxt.data_ptr(), B, n, slots,
                              torch.cuda.current_stream().cuda_stream)
    assert rc == 0, rc
    return outs[3]


def step_chord_inputs(task, B, n_steps, seed, device="cuda"):
    """The chord solve's inputs of the last of ``n_steps`` steps of ``task``
    at ``B`` lanes on ``device`` (a seeded reset, then uniform actions
    through ``step_autoreset_batch``), taken at the call: (constants,
    injections, warm starts).  Lanes that collapse under the step's actions
    are among them (on ANM6Easy)."""
    tm = importlib.import_module("gym_anm_torch.physics.transition")
    env = VecEnv(task, dtype=torch.float32, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    state, _ = env.reset(B, g)
    real, seen = tm.chord_solve, []

    def capture(*args, x0=None):
        if x0 is not None:  # the step's solve (a reset's starts flat)
            seen.append((args, x0))
        return real(*args, x0=x0)

    tm.chord_solve = capture
    try:
        for _ in range(n_steps):
            u = torch.rand(B, env.n_action, generator=g, device=env.device, dtype=env.dtype)
            state, *_ = env.step_autoreset_batch(state, env.action_low + u * (env.action_high - env.action_low), g)
    finally:
        tm.chord_solve = real
    args, x0 = seen[-1]
    return args[-1], tuple(a.contiguous() for a in args[:-1]), x0.contiguous()


def probe_chord():
    g = torch.Generator(device="cuda").manual_seed(11)
    tb = VecEnv(make_ieee33_task(), dtype=torch.float32).tables
    ct, n, B = tb.chord_t, tb.n_bus - 1, 8192
    qc = torch.rand(B, 2, generator=g, device="cuda")
    q = torch.zeros(B, n, device="cuda")
    q[:, 7], q[:, 24] = qc[:, 0], qc[:, 1]
    a = 0.9 + 0.2 * torch.rand(B, generator=g, device="cuda")
    inv_da = 1.0 / a - 1.0 / tb.chord_a0
    dr, di = (-tb.chord_y_re * inv_da).contiguous(), (-tb.chord_y_im * inv_da).contiguous()
    warm = (ct.flat + 0.01 * torch.randn(B, 2 * n, generator=g, device="cuda")).contiguous()
    warm[3] = float("nan")
    sets = [("base warm starts B=8192", ct, (torch.zeros(B, n, device="cuda"), q, di, dr, dr, di), warm),
            ("ieee33 cell step B=262144", *step_chord_inputs(make_ieee33_task(), 262144, 2, 12)),
            ("multicap17 cell step B=524288", *step_chord_inputs(make_ieee33_multicap_task(), 524288, 2, 13))]
    kernel = _build.load_library()
    lib = load(instrument_chord((_build.CSRC_DIR / "chord_newton.cu").read_text()), "chord_probe")
    for name, ct, args, x0 in sets:
        for slots in (8, 16):
            kernel_ms = statistics.median(device_ms(lambda: chord_call(kernel, args, ct, x0, slots), 5)
                                          for _ in range(5))
            probe_ms = statistics.median(device_ms(lambda: chord_call(lib, args, ct, x0, slots), 5) for _ in range(5))
            lib.probe_zero()
            it = chord_call(lib, args, ct, x0, slots)
            torch.cuda.synchronize()
            T = read(lib)
            rounds, blocks, live = T[9], T[10], T[11]
            print(f"K2 {name}, {slots} slots a block: kernel {kernel_ms:.4f} ms, instrumented copy {probe_ms:.4f} ms; "
                  f"{int(it.sum())} lane-iterations, {blocks} blocks, {rounds / blocks:.1f} rounds a block, "
                  f"{live / rounds:.2f} of {slots} slots with a lane a round, {sum(T[:9]) / rounds:.0f} cycles a "
                  "round (block thread 0): " + ", ".join(f"{s} {T[i] / rounds:.0f}" for i, s in enumerate(CHORD_STEPS)))


def probe_gj():
    A = torch.randn(8192, 64, 64, device="cuda") + 64 * torch.eye(64, device="cuda")
    b = torch.randn(8192, 64, device="cuda")
    lib = load(instrument_gj(gj_source("gauss_jordan_regs_f32.cu", "gauss_jordan_regs_f32_high.cu")), "gj_probe")
    cuobjdump = str(Path(_build._nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(OUT / "gj_probe.so")], capture_output=True, text=True).stdout
    body = next(f for f in re.split(r"\n\s*Function : ", sass) if "gj_regsIfLi64E" in f.split("\n")[0])
    n_ins = len(re.findall(r"/\*[0-9a-f]{4,}\*/", body))  # one address comment per instruction
    print(f"K1 n=64 body: {n_ins} SASS instructions a warp")
    x = torch.empty_like(b)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B in (2 * sms, 8192):  # one warp per scheduler (two systems of two warps per SM); the main path's batch
        def call():
            assert lib.gj_solve_f32_regs(A.data_ptr(), b.data_ptr(), x.data_ptr(), B, 64,
                                         torch.cuda.current_stream().cuda_stream) == 0
        lib.probe_zero()
        call()
        torch.cuda.synchronize()
        assert torch.equal(x[:B], solve_gauss_jordan(A[:B], b[:B]))
        cyc, warps = read(lib)[:2]
        ms = statistics.median(device_ms(call) for _ in range(5))
        print(f"K1 n=64 B={B}: {ms:.4f} ms (instrumented copy); {cyc / warps / 64:.0f} cycles per sweep of a warp")


def panel_solve(lib, A, b, panel, resident):
    """x = A^-1 b by K1's panel kernel at a given panel width, the matrix
    resident in shared memory or in a device scratch buffer."""
    B, n = b.shape
    x, stream = torch.empty_like(b), torch.cuda.current_stream().cuda_stream
    f64 = A.dtype == torch.float64
    if resident:
        fn = lib.gj_solve_f64_resident if f64 else lib.gj_solve_f32_resident
        rc = fn(A.data_ptr(), b.data_ptr(), x.data_ptr(), B, n, panel, stream)
    else:
        scratch = torch.empty(B, n, n + 1, dtype=A.dtype, device=A.device)
        fn = lib.gj_solve_f64_blocked if f64 else lib.gj_solve_f32_blocked
        rc = fn(A.data_ptr(), b.data_ptr(), x.data_ptr(), scratch.data_ptr(), B, n, panel, stream)
    assert rc == 0, f"K1's panel kernel (panel {panel}, resident {resident}) failed with CUDA error {rc}"
    return x


WIDE_STEPS = ["(1) refill, stage F", "(2) update product", "(3) direction, AA, stage V", "(4) mismatch product",
              "(5) exit test"]


def instrument_wide(src):
    """chord_newton_wide.cu with cycle counters around each step of a round."""
    marks = ["    // (1) Refill an empty slot", "    // (2) The update product", "    // The mismatch product's first",
             "    // (4) The mismatch product:", "    // (5) ||F||inf"]
    for i, mark in enumerate(marks):
        assert src.count(mark) == 1, f"the kernel's layout changed: {mark!r}"
        src = src.replace(mark, f"    const long long t{i} = clock64();\n" + mark)
    head, tail = "  while (true) {\n", "  }\n}\n\n// The smallest"
    assert src.count(head) == 1 and src.count(tail) == 1, "the kernel's layout changed"
    src = src.replace(head, "  long long T[6] = {}; long long t_prev = 0;\n" + head)
    src = src.replace("    // (1) Refill an empty slot", "    if (t_prev) T[4] += t0 - t_prev;\n    ++T[5];\n"
                      "    // (1) Refill an empty slot")
    src = src.replace("    // (2) The update product", "    T[0] += t1 - t0;\n    // (2) The update product")
    src = src.replace("    // The mismatch product's first", "    T[1] += t2 - t1;\n    // The mismatch product's first")
    src = src.replace("    // (4) The mismatch product:", "    T[2] += t3 - t2;\n    // (4) The mismatch product:")
    src = src.replace("    // (5) ||F||inf", "    T[3] += t4 - t3;\n    t_prev = t4;\n    // (5) ||F||inf")
    src = src.replace(tail, "  }\n  if (threadIdx.x == 0) {\n    for (int i = 0; i < 6; ++i) atomicAdd(&g_probe[i], "
                      "(unsigned long long)T[i]);\n    atomicAdd(&g_probe[6], 1ull);\n  }\n}\n\n// The smallest")
    return src.replace("namespace {\n", COUNTERS, 1) + READOUT


def feeder_chord_inputs(n_bus=130, scale=0.15, n_steps=4):
    """``chip_smoke.py`` phase 10's warm-start set: the chord solve's
    inputs at step ``n_steps`` of the seeded random feeder at B = 8192."""
    from ..networks.random_feeder import feeder_vars, make_feeder_task, random_radial_network

    rng = np.random.default_rng(n_bus)
    net = random_radial_network(rng, n_bus)
    task = make_feeder_task(net, feeder_vars(net, scale, 8, rng), name=f"feeder{n_bus}")
    return step_chord_inputs(task, 8192, n_steps, n_bus)


def probe_wide():
    ct, args, warm = feeder_chord_inputs()
    B, n = args[0].shape
    kernel_ms = statistics.median(device_ms(lambda: chord_solve_cuda(*args, ct, x0=warm)) for _ in range(5))
    lib = load(instrument_wide((_build.CSRC_DIR / "chord_newton_wide.cu").read_text()), "wide_probe")
    outs = chord_cuda.kernel_outputs(B, n, "cuda")
    wide_args = list(chord_cuda.kernel_args(args, ct, warm, outs))
    wide_args[7], wide_args[8] = ct.W_pack_f32.data_ptr(), ct.invJ0_T_f32.data_ptr()
    scratch = torch.empty(B, 4 * n, device="cuda")
    nxt = torch.zeros(1, dtype=torch.int32, device="cuda")
    lib.probe_zero()
    rc = lib.chord_newton_wide_f32(*wide_args, nxt.data_ptr(), scratch.data_ptr(), B, n, ct.W_pack_f32.shape[1],
                                   ct.invJ0_T_f32.shape[1], torch.cuda.current_stream().cuda_stream)
    assert rc == 0, rc
    torch.cuda.synchronize()
    T = read(lib)
    rounds, blocks = T[5], T[6]
    print(f"K2 wide, 130-bus feeder warm starts B={B} (n={n}): kernel {kernel_ms:.4f} ms; "
          f"{int(outs[3].sum())} lane-iterations, {blocks} blocks, {rounds / blocks:.1f} rounds a block, "
          f"{sum(T[:5]) / rounds:.0f} cycles a round (block thread 0): "
          + ", ".join(f"{name} {T[i] / rounds:.0f}" for i, name in enumerate(WIDE_STEPS)))


def probe_panels():
    """K1's panel kernel's cycles by step (a clock64 copy, thread 0 of every
    block), at B = 8192 on the feeders' sizes, resident and blocked."""
    lib = load(instrument_panels(gj_source("gauss_jordan.cu", "gauss_jordan_f64.cu")), "gj_panels_probe")
    B = 8192
    for n, dtype, panel, resident in ((126, torch.float64, 8, True), (126, torch.float64, 32, False),
                                      (126, torch.float32, 8, True), (126, torch.float32, 16, True),
                                      (94, torch.float32, 16, True)):
        g = torch.Generator(device="cuda").manual_seed(n)
        A = torch.randn(B, n, n, generator=g, device="cuda", dtype=dtype) + n * torch.eye(n, device="cuda", dtype=dtype)
        b = torch.randn(B, n, generator=g, device="cuda", dtype=dtype)
        lib.probe_zero()
        panel_solve(lib, A, b, panel, resident)
        torch.cuda.synchronize()
        T = read(lib)
        ms = statistics.median(device_ms(lambda: panel_solve(lib, A, b, panel, resident)) for _ in range(3))
        total = sum(T[:4])
        print(f"K1 panels n={n} {dtype} BP={panel} {'resident' if resident else 'blocked'}: {ms:.4f} ms (instrumented "
              f"copy); {T[4]} block-panels, {total / T[4]:.0f} cycles a panel (thread 0 of a block): "
              + ", ".join(f"{name} {T[i] / T[4]:.0f} ({T[i] / total:.2f})" for i, name in enumerate(PANEL_STEPS)),
              flush=True)


def probe_route_edges():
    """K1's panel kernel resident against blocked across the sizes the
    resident route can take (B = 8192, device ms, median of 3 readings of 20
    launches), for the route function's resident ceiling."""
    lib = _build.load_library()
    limit = lib.gj_smem_limit_bytes()
    B = 8192
    for dtype, sizes in ((torch.float32, (150, 162, 180, 200, 224)), (torch.float64, (80, 94, 110, 116, 126, 153, 258))):
        for n in sizes:
            g = torch.Generator(device="cuda").manual_seed(n)
            A = torch.randn(B, n, n, generator=g, device="cuda", dtype=dtype) + n * torch.eye(n, device="cuda",
                                                                                          dtype=dtype)
            b = torch.randn(B, n, generator=g, device="cuda", dtype=dtype)
            line = []
            for resident, panels in ((True, (8, 16)), (False, (8, 16, 32))):
                for panel in panels:
                    if panel_smem_bytes(n, A.element_size(), panel, resident) > limit:
                        continue
                    t = statistics.median(device_ms(lambda: panel_solve(lib, A, b, panel, resident)) for _ in range(3))
                    line.append(f"{'resident' if resident else 'blocked'} BP={panel} {t:.4f}")
            print(f"K1 n={n} {dtype} B={B}: " + ", ".join(line), flush=True)


def probe_blocked():
    """K1's blocked route by panel width at n = 258, float32, B = 8192."""
    B, n = 8192, 258
    g = torch.Generator(device="cuda").manual_seed(n)
    A = torch.randn(B, n, n, generator=g, device="cuda") + n * torch.eye(n, device="cuda")
    b = torch.randn(B, n, generator=g, device="cuda")
    lib = _build.load_library()
    xp = solve_gauss_jordan(A, b)
    line = []
    for panel in (8, 16, 32):
        x = panel_solve(lib, A, b, panel, False)
        torch.cuda.synchronize()
        assert torch.equal(x, xp), f"panel {panel} is not bitwise the plain version"
        t = statistics.median(device_ms(lambda: panel_solve(lib, A, b, panel, False)) for _ in range(5))
        line.append(f"panel {panel} {t:.4f}")
    t_ex = statistics.median(device_ms(lambda: torch.linalg.solve_ex(A, b)) for _ in range(3))
    print(f"K1 blocked B={B} n={n} f32 (device ms, median of 5 readings of 20 launches; the route takes panel "
          f"{k1_route(n, torch.float32, lib.gj_smem_limit_bytes())[1]}): " + ", ".join(line)
          + f"; torch.linalg.solve_ex {t_ex:.4f}")


def probe_resident():
    """K1's shared-memory route by panel width at the feeders' sizes, B =
    8192, beside the blocked route and ``solve_ex``; and the register
    route's float64 bodies at n = 48 and 64 beside it.  Every variant is
    checked bitwise against the plain version first."""
    lib = _build.load_library()
    limit = lib.gj_smem_limit_bytes()
    B = 8192
    for n, dtype in ((94, torch.float32), (126, torch.float32), (48, torch.float64), (64, torch.float64),
                     (126, torch.float64)):
        g = torch.Generator(device="cuda").manual_seed(n)
        A = torch.randn(B, n, n, generator=g, device="cuda", dtype=dtype) + n * torch.eye(n, device="cuda", dtype=dtype)
        b = torch.randn(B, n, generator=g, device="cuda", dtype=dtype)
        A[1, 0, 0] = 0.0
        xp = solve_gauss_jordan(A, b)
        keep = torch.ones(B, dtype=torch.bool, device="cuda")
        keep[1] = False
        itemsize = A.element_size()
        variants = {f"resident BP={bp}": lambda bp=bp: panel_solve(lib, A, b, bp, True)
                    for bp in (8, 16) if panel_smem_bytes(n, itemsize, bp, True) <= limit}
        blocked_bp = next(bp for bp in BLOCKED_PANELS[itemsize] if panel_smem_bytes(n, itemsize, bp, False) <= limit)
        variants[f"blocked BP={blocked_bp}"] = lambda: panel_solve(lib, A, b, blocked_bp, False)
        if dtype == torch.float64 and n <= 64:
            def regs():
                x = torch.empty_like(b)
                assert lib.gj_solve_f64_regs(A.data_ptr(), b.data_ptr(), x.data_ptr(), B, n,
                                             torch.cuda.current_stream().cuda_stream) == 0
                return x
            variants["regs f64"] = regs
        line = []
        for name, fn in variants.items():
            x = fn()
            torch.cuda.synchronize()
            assert not torch.isfinite(x[1]).all(), f"{name}: the zero pivot was repaired"
            assert torch.equal(x[keep], xp[keep]), f"{name} at n={n} {dtype} is not bitwise the plain version"
            line.append(f"{name} {statistics.median(device_ms(fn) for _ in range(3)):.4f}")
        t_ex = statistics.median(device_ms(lambda: torch.linalg.solve_ex(A, b)) for _ in range(3))
        print(f"K1 n={n} {dtype} B={B} (device ms, median of 3 readings; the route: "
              f"{k1_route(n, dtype, limit)}): " + ", ".join(line) + f", torch.linalg.solve_ex {t_ex:.4f}", flush=True)


def admm_sets(B=8192, seed=90):
    """``chip_smoke.py`` phase 9a's five K5 input sets on the card, built the
    same way from the same seed: name -> (spec, l, u, warm)."""
    from ..agents.mpc import build_dcopf_structure
    from ..vec import mpc

    g = torch.Generator(device="cuda").manual_seed(seed)
    env = VecEnv(make_anm6easy_task(), dtype=torch.float32)
    state, _ = env.reset(B, g)
    spec = env.spec
    load_pos = torch.as_tensor(spec.load_pos, device="cuda")
    dc1 = mpc.make_vec_dcopf(build_dcopf_structure(spec, env.task.delta_t, env.task.lamb, 0.995, 0.96, 1),
                             max_iter=4000)
    l1, u1 = mpc.lane_bounds(dc1, state.dev_p[:, load_pos], state.p_pot, state.soc)
    cold = mpc.init_warm(dc1, B)
    warm = mpc.solve_dcopf(dc1, l1, u1, cold).warm
    dc4 = mpc.make_vec_dcopf(build_dcopf_structure(spec, env.task.delta_t, env.task.lamb, 0.995, 0.96, 4),
                             max_iter=400)
    P_load4, P_pot4 = mpc.profile_forecast_fn(env, 4)(state)
    l4, u4 = mpc.lane_bounds(dc4, P_load4, P_pot4, state.soc)
    renv = VecEnv(make_ieee33_renewable_task(), dtype=torch.float32)
    rstate, _ = renv.reset(B, g)
    dcR = mpc.make_vec_dcopf(build_dcopf_structure(renv.spec, renv.task.delta_t, renv.task.lamb, 0.99, 0.9, 1),
                             max_iter=400)
    lR, uR = mpc.lane_bounds(dcR, rstate.dev_p[:, torch.as_tensor(renv.spec.load_pos, device="cuda")],
                             rstate.p_pot, rstate.soc)
    bad = torch.arange(B, device="cuda") % 100 == 0
    row = dc1.m - dc1.n + 3
    l_bad = l1.clone()
    l_bad[bad, row] = u1[bad, row] + 1.0
    return {
        "ANM6Easy N=1 cold, max_iter 4000": (dc1, l1, u1, cold),
        "the farm's call (N=1 warm, budget 48)": (dc1._replace(max_iter=48), l1, u1, warm),
        "ANM6Easy N=4 perfect forecast cold, 400": (dc4, l4, u4, mpc.init_warm(dc4, B)),
        "IEEE33-renewable N=1 cold, 400": (dcR, lR, uR, mpc.init_warm(dcR, B)),
        "1% crossed bounds, budget 48": (dc1._replace(max_iter=48), l_bad, u1, cold),
    }


def probe_admm_cycles():
    """Cycles per warp-sweep of each step of K5's staged route (an
    instrumented copy) at the farm's call."""
    lib = load(instrument_admm((_build.CSRC_DIR / "admm_dcopf.cu").read_text()), "admm_probe")
    name = "the farm's call (N=1 warm, budget 48)"
    dc, l, u, (x0, y0, z0, Ax0) = admm_sets()[name]
    B, n, m = l.shape[0], dc.n, dc.m
    empty = lambda *shape, dtype=torch.float32: torch.empty(*shape, dtype=dtype, device="cuda")  # noqa: E731
    outs = (empty(B, n), empty(B, n), empty(B, m), empty(B, m), empty(B, m), empty(B, dtype=torch.int32),
            empty(B), empty(B), *(empty(B, dtype=torch.bool) for _ in range(3)))
    nxt = torch.zeros(1, dtype=torch.int32, device="cuda")
    assert lib.admm_scratch_bytes(B, n, m) == 0, (n, m)  # the staged route: no scratch
    K = dc.check_every
    lib.probe_zero()
    rc = lib.admm_dcopf_f32(
        *(t.data_ptr() for t in (dc.A_frag, dc.P_frag, dc.q_bar, dc.rho, dc.inv_rho, dc.D, dc.D_inv, dc.E,
                                 dc.E_inv, l, u, x0, y0, z0, Ax0) + outs), nxt.data_ptr(),
        None, dc.sigma, dc.alpha, 1.0 - dc.alpha, dc.c_scale_value,
        dc.q_ref, dc.eps_abs, dc.eps_rel, 1.0 - 1e-3 * K, dc.dual_plateau_cap, dc.feas_band_factor, dc.max_iter,
        K, -(-dc.dual_stall_limit // K), B, n, m, torch.cuda.current_stream().cuda_stream)
    assert rc == 0, rc
    torch.cuda.synchronize()
    T = read(lib)
    sweeps, checks, warps = T[5], T[4], T[6]
    a, b, loop, chk = T[0] / sweeps, T[1] / sweeps, T[2] / sweeps, T[3] / checks
    print(f"K5 {name} (instrumented copy, lane 0 of {warps} warps, {sweeps / warps:.1f} sweeps a warp): "
          f"cycles per warp-sweep {ADMM_STEPS[0]} {a:.0f}, {ADMM_STEPS[1]} {b:.0f}, {ADMM_STEPS[2]} "
          f"{loop - a - b:.0f}; per check, {ADMM_STEPS[3]} {chk:.0f}")


if __name__ == "__main__":
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}")
    if sys.argv[1:] == ["newton_wide"]:  # python -m gym_anm_torch.bench.kernel_probes newton_wide
        probe_newton_wide()
        sys.exit(0)
    if sys.argv[1:] == ["wide_routes"]:  # python -m gym_anm_torch.bench.kernel_probes wide_routes
        probe_wide_routes()
        sys.exit(0)
    if sys.argv[1:] == ["chord"]:  # python -m gym_anm_torch.bench.kernel_probes chord
        probe_chord()
        sys.exit(0)
    probe_newton()
    probe_newton_wide()
    probe_resident()
    probe_wide()
    probe_blocked()
    probe_admm_cycles()
    probe_dmma()
    probe_chord()
    probe_gj()
