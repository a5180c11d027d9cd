"""Where the kernels' time goes, on one card.

    python -m gym_anm_torch.bench.kernel_probes

1. ``dmma_shapes.cu``: the float64 tensor-core rate by mma shape.
2. K2 (``csrc/chord_newton.cu``): a copy with ``clock64`` counters around the
   five steps of a round (read by thread 0 of every block), on the base
   IEEE33 constants from warm starts at B = 8192 (``chip_smoke.py`` phase
   1b's set): rounds per block and cycles per round by step.
3. K1 (``csrc/gauss_jordan.cu``): a copy with ``clock64`` around the sweeps
   of the 64-row body, at B = 8192 and at few enough systems that every
   scheduler holds one warp: cycles per sweep of a warp.
4. K5 (``csrc/admm_dcopf.cu``) beside PR 5's design, kept in
   ``admm_dcopf_pr5.cu`` (one block per lane, float32 matrices, every
   multiply-add converting both operands to float64), and that design built
   with ``-DADMM_F64`` (float64 matrices, the lane's vectors staged once as
   float64: no conversion in the k-loops), on ``chip_smoke.py`` phase 9a's
   five sets at B = 8192, in one call: the conversions' share of PR 5's time
   is (PR 5 − its float64 build) / PR 5.  A copy of K5 with ``clock64``
   counters gives its cycles per warp-sweep by step at the farm's call and
   on IEEE33-renewable.

5. The wide K2 (``csrc/chord_newton_wide.cu``): a copy with ``clock64``
   counters around the five steps of a round (thread 0 of every block), on
   the 130-bus feeder's warm starts at B = 8192 (``chip_smoke.py`` phase
   10's set): rounds per block and cycles per round by step, beside the
   block-per-lane design.
6. K1's blocked route (``gj_blocked``) at n = 258, float32, B = 8192 with
   panels of 16, 32 and 64 pivots and the kernel's own choice, beside the
   device-memory design (``gauss_jordan_gmem.cu``: the matrix read and
   written in device memory every sweep) and ``torch.linalg.solve_ex``.

The earlier designs of K1 above the card's shared memory (the matrix swept
in device memory) and of the wide chord kernel (one block per lane) stay in
``gauss_jordan_gmem.cu`` and ``chord_newton_wide_lane.cu`` as the baselines
of probes 5 and 6 and of ``chip_smoke.py`` phase 10 (:func:`load_baselines`,
:func:`gmem_solve`, :func:`lane_chord`).

The copies are built into ``build/kernels/probe/``; the counters cost
registers, so the instrumented K2 runs ~15% slower than the kernel itself
(both times are printed).  Needs a card and nvcc.
"""

import ctypes
import importlib
import math
import re
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

from .. import _build
from ..physics.chord_cuda import chord_solve_cuda
from ..physics.linsolve_cuda import solve_gauss_jordan
from ..vec import VecEnv, make_anm6easy_task, make_ieee33_renewable_task, make_ieee33_task

OUT = _build.BUILD_DIR / "probe"
# The counters and their read-out, added to an instrumented copy.
COUNTERS = "__device__ unsigned long long g_probe[16];\nnamespace {\n"
READOUT = ('\nextern "C" int probe_read(unsigned long long* out) {\n'
           '  return (int)cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));\n}\n'
           'extern "C" int probe_zero() {\n  unsigned long long z[16] = {};\n'
           '  return (int)cudaMemcpyToSymbol(g_probe, z, sizeof(z));\n}\n')
STEPS = ["(1) refill / stage F", "barrier", "(2) update product", "barrier", "(3) direction, AA, stage V",
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
    """chord_newton.cu with cycle counters around each step of a round."""
    lines, out, n_bar, in_loop = src.split("\n"), [], 0, False
    for line in lines:
        if line.strip() == "while (true) {" and not in_loop:
            in_loop = True
            out += ["  long long T[9] = {}; int rounds = 0;", line, "    long long ta = clock64(); ++rounds;"]
        elif in_loop and line.strip() == "__syncthreads();":
            n_bar += 1
            out += [f"    long long tb{n_bar} = clock64();", line, f"    long long ta{n_bar} = clock64();"]
        else:
            out.append(line)
    s = "\n".join(out)
    end = "        phase = kEmpty;\n      }\n    }\n"
    tail = "  }\n}\n\n}  // namespace"
    assert n_bar == 4 and s.count(end) == 1 and s.count(tail) == 1, "the round's layout changed"
    s = s.replace(end, end + "    { const long long te = clock64();\n"
                  "      long long t[10] = {ta, tb1, ta1, tb2, ta2, tb3, ta3, tb4, ta4, te};\n"
                  "      for (int i = 0; i < 9; ++i) T[i] += t[i + 1] - t[i]; }\n")
    s = s.replace(tail, "  }\n  if (threadIdx.x == 0) {\n"
                  "    for (int i = 0; i < 9; ++i)\n"
                  "      atomicAdd(&g_probe[i], (unsigned long long)T[i]);\n"
                  "    atomicAdd(&g_probe[9], (unsigned long long)rounds);\n"
                  "    atomicAdd(&g_probe[10], 1ull);\n  }\n}\n\n}  // namespace")
    return s.replace("namespace {\n", COUNTERS, 1) + READOUT


def instrument_gj(src):
    """gauss_jordan.cu with the 64-row body's sweeps timed per warp."""
    a, b = "  sweeps<NP>(std::make_integer_sequence<int, NP>{}", "  float d = m[0];"
    assert src.count(a) == 1 and src.count(b) == 1, "the kernel's layout changed"
    s = src.replace(a, "  const long long t0 = clock64();\n" + a)
    s = s.replace(b, "  if (NP == 64 && lane == 0) { atomicAdd(&g_probe[0], (unsigned long long)(clock64() - t0));"
                  " atomicAdd(&g_probe[1], 1ull); }\n" + b)
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
    return _build.declare(ctypes.CDLL(str(nvcc(src, OUT / f"{name}.so", "-shared"))))


def read(lib):
    buf = (ctypes.c_ulonglong * 16)()
    lib.probe_read(buf)
    return list(buf)


def probe_dmma():
    exe = nvcc(Path(__file__).with_name("dmma_shapes.cu"), OUT / "dmma_shapes")
    print(subprocess.run([str(exe)], capture_output=True, text=True, check=True).stdout, end="")


def probe_chord():
    B = 8192
    g = torch.Generator(device="cuda").manual_seed(11)
    tb = VecEnv(make_ieee33_task(), dtype=torch.float32).tables
    ct, n = tb.chord_t, tb.n_bus - 1
    qc = torch.rand(B, 2, generator=g, device="cuda")
    q = torch.zeros(B, n, device="cuda")
    q[:, 7], q[:, 24] = qc[:, 0], qc[:, 1]
    a = 0.9 + 0.2 * torch.rand(B, generator=g, device="cuda")
    inv_da = 1.0 / a - 1.0 / tb.chord_a0
    dr, di = (-tb.chord_y_re * inv_da).contiguous(), (-tb.chord_y_im * inv_da).contiguous()
    args = (torch.zeros(B, n, device="cuda"), q, di, dr, dr, di)
    warm = (ct.flat + 0.01 * torch.randn(B, 2 * n, generator=g, device="cuda")).contiguous()
    warm[3] = float("nan")
    kernel_ms = statistics.median(device_ms(lambda: chord_solve_cuda(*args, ct, x0=warm)) for _ in range(5))
    lib = load(instrument_chord((_build.CSRC_DIR / "chord_newton.cu").read_text()), "chord_probe")
    consts = (ct.W_pack, ct.invJ0_T, ct.H_T, ct.g_col0, ct.g_col1, ct.c, ct.e_t, ct.rs_re, ct.rs_im)

    def call():
        x = torch.empty(B, 2 * n, device="cuda")
        F, diff = torch.empty_like(x), torch.empty(B, device="cuda")
        it, acc = torch.empty(B, dtype=torch.int32, device="cuda"), torch.empty(B, dtype=torch.bool, device="cuda")
        nxt = torch.zeros(1, dtype=torch.int32, device="cuda")
        va, vb = ct.vstar_re, ct.vstar_im
        rc = lib.chord_newton_f32(*(t.data_ptr() for t in args), warm.data_ptr(), *(t.data_ptr() for t in consts),
                                  va, vb, 1.0 / math.hypot(va, vb), 1e-5, 1e-4, 1e-3, 48, x.data_ptr(), F.data_ptr(),
                                  diff.data_ptr(), it.data_ptr(), acc.data_ptr(), nxt.data_ptr(), B, n,
                                  torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return it

    probe_ms = statistics.median(device_ms(call) for _ in range(5))
    lib.probe_zero()
    it = call()
    torch.cuda.synchronize()
    T = read(lib)
    rounds, blocks = T[9], T[10]
    print(f"K2 base warm starts B={B}: kernel {kernel_ms:.4f} ms, instrumented copy {probe_ms:.4f} ms; "
          f"{int(it.sum())} lane-iterations, {blocks} blocks, {rounds / blocks:.1f} rounds per block, "
          f"{sum(T[:9]) / rounds:.0f} cycles per round (block thread 0): "
          + ", ".join(f"{name} {T[i] / rounds:.0f}" for i, name in enumerate(STEPS)))


def probe_gj():
    A = torch.randn(8192, 64, 64, device="cuda") + 64 * torch.eye(64, device="cuda")
    b = torch.randn(8192, 64, device="cuda")
    lib = load(instrument_gj((_build.CSRC_DIR / "gauss_jordan.cu").read_text()), "gj_probe")
    cuobjdump = str(Path(_build._nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(OUT / "gj_probe.so")], capture_output=True, text=True).stdout
    body = next(f for f in re.split(r"\n\s*Function : ", sass) if "gj_regsILi64E" in f.split("\n")[0])
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


# The baselines: K1 with the matrix in device memory, and the wide chord
# kernel with one block per lane.
BASELINE_SOURCES = ("gauss_jordan_gmem.cu", "chord_newton_wide_lane.cu")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
BASELINE_SIGNATURES = {
    "gj_solve_f32_gmem": [_P, _P, _P, _P, _I, _I, _P],  # (A, b, x, scratch, B, n, stream)
    "gj_solve_f64_gmem": [_P, _P, _P, _P, _I, _I, _P],
    # chord_newton_f32's arguments without next_lane
    "chord_newton_wide_lane_f32": [_P] * 16 + [_F] * 6 + [_I] + [_P] * 5 + [_I, _I, _P],
}


def load_baselines():
    """Build (if needed) and load the two baselines as one library."""
    here = Path(__file__).parent
    lib = ctypes.CDLL(str(_build.build_library([here / f for f in BASELINE_SOURCES], "libgym_anm_baselines")))
    for name, argtypes in BASELINE_SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def gmem_solve(lib, A, b):
    """x = A^-1 b by K1's device-memory design (A [B, n, n], b [B, n] on the card)."""
    B, n = b.shape
    x, scratch = torch.empty_like(b), torch.empty(B, n, n + 1, dtype=A.dtype, device=A.device)
    fn = lib.gj_solve_f64_gmem if A.dtype == torch.float64 else lib.gj_solve_f32_gmem
    rc = fn(A.data_ptr(), b.data_ptr(), x.data_ptr(), scratch.data_ptr(), B, n, torch.cuda.current_stream().cuda_stream)
    assert rc == 0, f"K1's device-memory design failed with CUDA error {rc}"
    return x


def lane_chord(lib, p, q, w_a, w_b, dtf_re, dtf_im, ct, xtol=1e-5, lim_iter=48, stall_tol_factor=10.0, x0=None):
    """The block-per-lane wide chord kernel on chord_solve_cuda's arguments; returns
    (x, F, diff, n_iter, accepted)."""
    B, n = p.shape
    consts = (ct.W_pack, ct.invJ0_T, ct.H_T, ct.g_col0, ct.g_col1, ct.c, ct.e_t, ct.rs_re, ct.rs_im)
    x = torch.empty(B, 2 * n, device=p.device)
    F, diff = torch.empty_like(x), torch.empty(B, device=p.device)
    n_iter = torch.empty(B, dtype=torch.int32, device=p.device)
    accepted = torch.empty(B, dtype=torch.bool, device=p.device)
    va, vb = float(ct.vstar_re), float(ct.vstar_im)
    rc = lib.chord_newton_wide_lane_f32(
        *(t.data_ptr() for t in (p, q, w_a, w_b, dtf_re, dtf_im)), None if x0 is None else x0.data_ptr(),
        *(t.data_ptr() for t in consts), va, vb, 1.0 / math.hypot(va, vb), xtol, stall_tol_factor * xtol,
        100.0 * xtol, int(lim_iter), *(t.data_ptr() for t in (x, F, diff, n_iter, accepted)), B, n,
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0, f"the block-per-lane wide chord kernel failed with CUDA error {rc}"
    return x, F, diff, n_iter, accepted


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

    tm = importlib.import_module("gym_anm_torch.physics.transition")
    rng = np.random.default_rng(n_bus)
    net = random_radial_network(rng, n_bus)
    env = VecEnv(make_feeder_task(net, feeder_vars(net, scale, 8, rng), name=f"feeder{n_bus}"), dtype=torch.float32)
    g = torch.Generator(device="cuda").manual_seed(n_bus)
    state, _ = env.reset(8192, g)
    real, seen = tm.chord_solve, []

    def capture(*args, x0=None):
        if x0 is not None:
            seen.append((args, x0))
        return real(*args, x0=x0)

    tm.chord_solve = capture
    try:
        for _ in range(n_steps):
            u = torch.rand(8192, env.n_action, generator=g, device="cuda")
            state, *_ = env.step_autoreset_batch(state, env.action_low + u * (env.action_high - env.action_low), g)
    finally:
        tm.chord_solve = real
    args, x0 = seen[-1]
    return args[-1], tuple(a.contiguous() for a in args[:-1]), x0.contiguous()


def probe_wide():
    ct, args, warm = feeder_chord_inputs()
    B, n = args[0].shape
    base = load_baselines()
    t = {key: statistics.median(device_ms(fn) for _ in range(5)) for key, fn in (
        ("kernel", lambda: chord_solve_cuda(*args, ct, x0=warm)),
        ("lane", lambda: lane_chord(base, *args, ct, x0=warm)))}
    lib = load(instrument_wide((_build.CSRC_DIR / "chord_newton_wide.cu").read_text()), "wide_probe")
    consts = (ct.W_pack_f32, ct.invJ0_T_f32, ct.H_T, ct.g_col0, ct.g_col1, ct.c, ct.e_t, ct.rs_re, ct.rs_im)
    x, scratch = torch.empty(B, 2 * n, device="cuda"), torch.empty(B, 4 * n, device="cuda")
    F, diff = torch.empty_like(x), torch.empty(B, device="cuda")
    it, acc = torch.empty(B, dtype=torch.int32, device="cuda"), torch.empty(B, dtype=torch.bool, device="cuda")
    nxt = torch.zeros(1, dtype=torch.int32, device="cuda")
    va, vb = float(ct.vstar_re), float(ct.vstar_im)
    lib.probe_zero()
    rc = lib.chord_newton_wide_f32(*(a.data_ptr() for a in args), warm.data_ptr(), *(c.data_ptr() for c in consts),
                                   va, vb, 1.0 / math.hypot(va, vb), 1e-5, 1e-4, 1e-3, 48, x.data_ptr(), F.data_ptr(),
                                   diff.data_ptr(), it.data_ptr(), acc.data_ptr(), nxt.data_ptr(), scratch.data_ptr(),
                                   B, n, ct.W_pack_f32.shape[1], ct.invJ0_T_f32.shape[1],
                                   torch.cuda.current_stream().cuda_stream)
    assert rc == 0, rc
    torch.cuda.synchronize()
    T = read(lib)
    rounds, blocks = T[5], T[6]
    print(f"K2 wide, 130-bus feeder warm starts B={B} (n={n}): kernel {t['kernel']:.4f} ms, block-per-lane design "
          f"{t['lane']:.4f} ms; {int(it.sum())} lane-iterations, {blocks} blocks, {rounds / blocks:.1f} rounds a block, "
          f"{sum(T[:5]) / rounds:.0f} cycles a round (block thread 0): "
          + ", ".join(f"{name} {T[i] / rounds:.0f}" for i, name in enumerate(WIDE_STEPS)))


def probe_blocked():
    """K1's blocked route by panel width at n = 258, float32, B = 8192."""
    B, n = 8192, 258
    g = torch.Generator(device="cuda").manual_seed(n)
    A = torch.randn(B, n, n, generator=g, device="cuda") + n * torch.eye(n, device="cuda")
    b = torch.randn(B, n, generator=g, device="cuda")
    lib, base = _build.load_library(), load_baselines()
    x, scratch = torch.empty_like(b), torch.empty(B, n, n + 1, device="cuda")
    xp = gmem_solve(base, A, b)  # bitwise the plain version (its card tests)

    def blocked(panel):
        rc = lib.gj_solve_f32_blocked(A.data_ptr(), b.data_ptr(), x.data_ptr(), scratch.data_ptr(), B, n, panel,
                                      torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return x

    line = []
    for panel in (0, 16, 32, 64):
        blocked(panel)
        torch.cuda.synchronize()
        assert torch.equal(x, xp), f"panel {panel} is not bitwise the device-memory design"
        line.append(f"panel {panel or 'auto'} {statistics.median(device_ms(lambda: blocked(panel)) for _ in range(5)):.4f}")
    t_ex = statistics.median(device_ms(lambda: torch.linalg.solve_ex(A, b)) for _ in range(3))
    t_gmem = statistics.median(device_ms(lambda: gmem_solve(base, A, b), 2) for _ in range(3))
    print(f"K1 blocked B={B} n={n} f32 (device ms, median of 5 readings of 20 launches): " + ", ".join(line)
          + f"; device-memory design {t_gmem:.4f} (2 launches, median of 3); torch.linalg.solve_ex {t_ex:.4f}")


# PR 5's admm_dcopf_f32 arguments (admm_dcopf_pr5.cu's admm_probe_f32).
PR5_ARGS = [ctypes.c_void_p] * 26 + [ctypes.c_float] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


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


def pr5_solve(lib, f64, dc, l, u, warm):
    """One launch of PR 5's K5 (``admm_dcopf_pr5.cu``, built with or without
    ``-DADMM_F64``); returns (iterations, converged, x)."""
    B, n, m = l.shape[0], dc.n, dc.m
    A, PT = (dc.A_bar.double(), dc.P_pack_T.double()) if f64 else (dc.A_bar, dc.P_pack_T)
    empty = lambda *shape, dtype=torch.float32: torch.empty(*shape, dtype=dtype, device="cuda")  # noqa: E731
    x, xw, yw, zw, Axw = empty(B, n), empty(B, n), empty(B, m), empty(B, m), empty(B, m)
    it, rp, rd = empty(B, dtype=torch.int32), empty(B), empty(B)
    flags = [empty(B, dtype=torch.bool) for _ in range(3)]
    K = dc.check_every
    consts = (A, PT, dc.q_bar, dc.rho, dc.inv_rho, dc.D, dc.D_inv, dc.E, dc.E_inv)
    rc = lib.admm_probe_f32(*(t.data_ptr() for t in consts + (l, u) + tuple(warm)),
                            *(t.data_ptr() for t in (x, xw, yw, zw, Axw, it, rp, rd, *flags)),
                            dc.sigma, dc.alpha, 1.0 - dc.alpha, dc.c_scale_value, dc.q_ref, dc.eps_abs, dc.eps_rel,
                            1.0 - 1e-3 * K, dc.dual_plateau_cap, dc.feas_band_factor, dc.max_iter, K,
                            -(-dc.dual_stall_limit // K), B, n, m, torch.cuda.current_stream().cuda_stream)
    assert rc == 0, rc
    return it, flags[0], x


def probe_admm_cycles():
    """Cycles per warp-sweep of each step of K5 (an instrumented copy) at the
    farm's call and on IEEE33-renewable (fragments from L2)."""
    lib = load(instrument_admm((_build.CSRC_DIR / "admm_dcopf.cu").read_text()), "admm_probe")
    sets = admm_sets()
    for name in ("the farm's call (N=1 warm, budget 48)", "IEEE33-renewable N=1 cold, 400"):
        dc, l, u, (x0, y0, z0, Ax0) = sets[name]
        B, n, m = l.shape[0], dc.n, dc.m
        empty = lambda *shape, dtype=torch.float32: torch.empty(*shape, dtype=dtype, device="cuda")  # noqa: E731
        outs = (empty(B, n), empty(B, n), empty(B, m), empty(B, m), empty(B, m), empty(B, dtype=torch.int32),
                empty(B), empty(B), *(empty(B, dtype=torch.bool) for _ in range(3)))
        nxt = torch.zeros(1, dtype=torch.int32, device="cuda")
        scratch_bytes = lib.admm_scratch_bytes(B, n, m)
        assert scratch_bytes >= 0, (n, m)
        scratch = torch.empty(scratch_bytes, dtype=torch.uint8, device="cuda") if scratch_bytes else None
        K = dc.check_every
        lib.probe_zero()
        rc = lib.admm_dcopf_f32(
            *(t.data_ptr() for t in (dc.A_frag, dc.P_frag, dc.q_bar, dc.rho, dc.inv_rho, dc.D, dc.D_inv, dc.E,
                                     dc.E_inv, l, u, x0, y0, z0, Ax0) + outs), nxt.data_ptr(),
            None if scratch is None else scratch.data_ptr(), dc.sigma, dc.alpha, 1.0 - dc.alpha, dc.c_scale_value,
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


def probe_admm():
    from ..vec.admm_cuda import frag_count, solve_dcopf_cuda

    src = Path(__file__).with_name("admm_dcopf_pr5.cu")
    libs = {}
    for f64 in (False, True):
        name = "admm_pr5_f64" if f64 else "admm_pr5"
        lib = ctypes.CDLL(str(nvcc(src, OUT / f"{name}.so", "-shared", *(["-DADMM_F64"] if f64 else []))))
        lib.admm_probe_f32.argtypes = PR5_ARGS
        lib.admm_probe_f32.restype = ctypes.c_int
        libs[f64] = lib
    for name, (dc, l, u, warm) in admm_sets().items():
        sol = solve_dcopf_cuda(dc, l, u, warm)
        its = {}
        for f64, lib in libs.items():
            it, conv, x = pr5_solve(lib, f64, dc, l, u, warm)
            torch.cuda.synchronize()
            same = it == sol.iterations
            its[f64] = (int(same.sum()), int((conv == sol.converged).sum()),
                        float((x - sol.x)[same].abs().max()) if same.any() else 0.0)
        k = 3 if dc.max_iter > 48 else 20
        t = {key: statistics.median(device_ms(fn, k) for _ in range(3)) for key, fn in (
            ("new", lambda: solve_dcopf_cuda(dc, l, u, warm)),
            ("pr5", lambda: pr5_solve(libs[False], False, dc, l, u, warm)),
            ("pr5_f64", lambda: pr5_solve(libs[True], True, dc, l, u, warm)))}
        n, m = dc.n, dc.m
        print(f"K5 {name} B={l.shape[0]} (n={n}, m={m}): this kernel {t['new']:.4f} ms; PR 5's design "
              f"{t['pr5']:.4f} ms, its float64 build {t['pr5_f64']:.4f} ms (the conversions' share "
              f"{(t['pr5'] - t['pr5_f64']) / t['pr5']:.3f}); mean {float(sol.iterations.float().mean()):.2f} sweeps "
              f"a lane; PR 5's design / its float64 build against this kernel: (iterations equal, converged "
              f"equal, max|dx| where iterations are equal) {its[False]} / {its[True]} of {l.shape[0]} lanes; "
              f"this kernel's fragments {16 * frag_count(n, m)} bytes")


if __name__ == "__main__":
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}")
    probe_wide()
    probe_blocked()
    probe_admm()
    probe_admm_cycles()
    probe_dmma()
    probe_chord()
    probe_gj()
