"""Where the two kernels' time goes, on one card.

    python -m gym_anm_torch.bench.kernel_probes

1. ``dmma_shapes.cu``: the float64 tensor-core rate by mma shape.
2. K2 (``csrc/chord_newton.cu``): a copy with ``clock64`` counters around the
   five steps of a round (read by thread 0 of every block), on the base
   IEEE33 constants from warm starts at B = 8192 (``chip_smoke.py`` phase
   1b's set): rounds per block and cycles per round by step.
3. K1 (``csrc/gauss_jordan.cu``): a copy with ``clock64`` around the sweeps
   of the 64-row body, at B = 8192 and at few enough systems that every
   scheduler holds one warp: cycles per sweep of a warp.

The copies are built into ``build/kernels/probe/``; the counters cost
registers, so the instrumented K2 runs ~15% slower than the kernel itself
(both times are printed).  Needs a card and nvcc.
"""

import ctypes
import math
import re
import statistics
import subprocess
from pathlib import Path

import torch

from .. import _build
from ..physics.chord_cuda import chord_solve_cuda
from ..physics.linsolve_cuda import solve_gauss_jordan
from ..vec import VecEnv, make_ieee33_task

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


def load(src_text, name):
    src = OUT / f"{name}.cu"
    src.write_text(src_text)
    lib = ctypes.CDLL(str(nvcc(src, OUT / f"{name}.so", "-shared")))
    for fn, args in _build._SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
    return lib


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


if __name__ == "__main__":
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}")
    probe_dmma()
    probe_chord()
    probe_gj()
