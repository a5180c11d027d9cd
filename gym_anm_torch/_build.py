"""Build the hand-written CUDA kernels of ``csrc/`` at first use.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (Hopper), one process
per source, all started together, and links the objects into one shared
library with a plain C interface under ``build/kernels/`` beside the
package, keyed by a hash of the sources and flags; ``ctypes`` loads it.
``ptxas``'s report of each kernel's registers, shared memory and spills is
kept beside the library (:func:`ptxas_report`).  Nothing here runs at
import: :func:`load_library` builds on its first call, so importing the
package needs neither ``nvcc`` nor a card.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F, _D, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double, ctypes.c_longlong
# C entry points, returning a cudaError_t as int unless _RESTYPES says otherwise.
_SIGNATURES = {
    # (A, b, x, B, n, stream)
    "gj_solve_f32_regs": [_P, _P, _P, _I, _I, _P],
    "gj_solve_f64_regs": [_P, _P, _P, _I, _I, _P],
    # (A, b, x, B, n, panel, stream)
    "gj_solve_f32_resident": [_P, _P, _P, _I, _I, _I, _P],
    "gj_solve_f64_resident": [_P, _P, _P, _I, _I, _I, _P],
    # (A, b, x, scratch, B, n, panel, stream)
    "gj_solve_f32_blocked": [_P, _P, _P, _P, _I, _I, _I, _P],
    "gj_solve_f64_blocked": [_P, _P, _P, _P, _I, _I, _I, _P],
    "gj_smem_limit_bytes": [],
    # (p, q, w_a, w_b, dtf_re, dtf_im, x0, W_pack, invJ0_T, H_T, g_col0,
    #  g_col1, C, e_t, rs_re, rs_im, va, vb, inv_vmag, xtol, band, aa_gate,
    #  lim_iter, x, F, diff, n_iter, accepted, next_lane, B, n, slots, stream)
    "chord_newton_f32": [_P] * 16 + [_F] * 6 + [_I] + [_P] * 6 + [_I, _I, _I, _P],
    # as chord_newton_f32 without slots, with the float32 W_pack and
    # invJ0_T, then scratch after next_lane and their row strides (w_ld,
    # u_ld) after n
    "chord_newton_wide_f32": [_P] * 16 + [_F] * 6 + [_I] + [_P] * 7 + [_I] * 4 + [_P],
    # (A_frag, P_frag, q_bar, rho, inv_rho, D, D_inv, E, E_inv, l, u, x0, y0,
    #  z0, Ax0, x, xw, yw, zw, Axw, iterations, r_prim, r_dual, converged,
    #  bounds_ok, feasible, next_lane, scratch, sigma, alpha, 1 - alpha,
    #  c_scale, q_ref, eps_abs, eps_rel, improve, plateau_cap, feas_band,
    #  max_iter, K, stall_checks, B, n, m, stream)
    "admm_dcopf_f32": [_P] * 28 + [_F] * 10 + [_I] * 6 + [_P],
    # (B, n, m) -> bytes, not an error code
    "admm_scratch_bytes": [_I, _I, _I],
    # (B, n, m) -> the lanes a streamed block serves, 0 staged, -1 not taken
    "admm_stream_lanes": [_I, _I, _I],
    # (x_in, F_in, diff_in, it_in, accepted, p, q, Yre, Yim, y_stride, br_f,
    #  br_t, series_re, series_im, shunt_im, shift_cos, shift_sin, tap_magn,
    #  n_branch, xtol, lim_iter, x, F, diff, n_iter, stall, counters, work,
    #  B, nb, stream)
    "newton_fallback_f32": [_P] * 9 + [_L] + [_P] * 8 + [_I, _D, _I] + [_P] * 7 + [_I] * 2 + [_P],
    "newton_fallback_f64": [_P] * 9 + [_L] + [_P] * 8 + [_I, _D, _I] + [_P] * 7 + [_I] * 2 + [_P],
    # newton_fallback_f32's arguments to nb, then (panel, resident, slots,
    # slot, grid, stream)
    "newton_fallback_wide_f32": [_P] * 9 + [_L] + [_P] * 8 + [_I, _D, _I] + [_P] * 7 + [_I] * 4 + [_P, _L, _I, _P],
    "newton_fallback_wide_f64": [_P] * 9 + [_L] + [_P] * 8 + [_I, _D, _I] + [_P] * 7 + [_I] * 4 + [_P, _L, _I, _P],
    # newton_fallback_f32's arguments to nb, then (panel, cluster, slots,
    # slot, clusters, stream)
    "newton_fallback_cluster_f32": [_P] * 9 + [_L] + [_P] * 8 + [_I, _D, _I] + [_P] * 7 + [_I] * 4 + [_P, _L, _I, _P],
    "newton_fallback_cluster_f64": [_P] * 9 + [_L] + [_P] * 8 + [_I, _D, _I] + [_P] * 7 + [_I] * 4 + [_P, _L, _I, _P],
    # (f64, n, panel, resident, lane_ybus) -> blocks, or minus a CUDA error
    "newton_wide_grid": [_I] * 5,
    # (f64, n, panel, cluster, lane_ybus) -> clusters, or minus a CUDA error
    "newton_cluster_grid": [_I] * 5,
    # (f64, n, panel, cluster) -> bytes
    "newton_cluster_smem_bytes": [_I] * 4,
    # (f64, n, panel, resident) -> bytes
    "newton_wide_smem_bytes": [_I] * 4,
    "newton_wide_smem_limit": [],
    "newton_l2_bytes": [],
    # (v_re, v_im, F, p_ns, q_ns, dff_re, dff_im, dft_re, dft_im, tap,
    #  oltc_branch, p_pot, rates, br_f, br_t, series_re, series_im, shunt_im,
    #  shift_cos, shift_sin, tap0, y0_re, y0_im, v_min, v_max, genload,
    #  gen_pos, rer_mask, bus_p, bus_q, dev_p, dev_q, i_re, i_im, the nine
    #  branch arrays, e_loss, penalty, reward, delta_t, lamb, rates_per_lane,
    #  B, N, Ne, n_dev, K, G, t_bus, slack_bus, slack_dev, stream)
    "transition_flows_f32": [_P] * 46 + [_F] * 2 + [_I] * 10 + [_P],
}
# Every other entry point returns an int.
_RESTYPES = {"admm_scratch_bytes": ctypes.c_longlong, "newton_wide_smem_bytes": ctypes.c_longlong,
             "newton_cluster_smem_bytes": ctypes.c_longlong}


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(sources=None, stem="libgym_anm_kernels", build_dir=None):
    """Path of the shared library for ``sources`` (default: every
    ``csrc/*.cu``), the headers beside them and the flags, under
    ``build_dir`` (default ``BUILD_DIR``)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    sources = sorted(sources or CSRC_DIR.glob("*.cu"))
    headers = sorted({hdr for src in sources for hdr in Path(src).parent.glob("*.cuh")})
    for src in sources + headers:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return (build_dir or BUILD_DIR) / f"{stem}_{h.hexdigest()[:16]}.so"


def ptxas_report():
    """``ptxas -v``'s output for the current library (registers, shared
    memory and spill stores/loads of every kernel), as the build wrote it."""
    return library_path().with_suffix(".ptxas.txt").read_text()


def _check(cmd, stderr, returncode):
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}):\n{' '.join(cmd)}\n{stderr}")


def build_library(sources, stem, build_dir=None):
    """Compile ``sources`` (one nvcc per source, all started together) and
    link them into one shared library under ``build_dir`` (default
    ``build/kernels/``), unless it is there already; returns its path."""
    sources = sorted(sources)
    out = library_path(sources, stem, build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    jobs = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(sources, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for cmd in jobs]
    try:
        report = []
        for cmd, proc in zip(jobs, procs):
            stderr = proc.communicate()[1]
            _check(cmd, stderr, proc.returncode)
            report.append(stderr)
        out.with_suffix(".ptxas.txt").write_text("".join(report))
        cmd = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        _check(cmd, proc.stderr, proc.returncode)
        os.replace(tmp, out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in objs:
            f.unlink(missing_ok=True)
    return out


def declare(lib):
    """Declare ``argtypes``/``restype`` of every entry point ``lib`` has."""
    for name, argtypes in _SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return lib


@functools.cache
def load_library():
    """Build (if needed) and load the kernel library; returns the CDLL with
    every entry point's ``argtypes``/``restype`` declared."""
    lib = ctypes.CDLL(str(build_library(CSRC_DIR.glob("*.cu"), "libgym_anm_kernels")))
    for name in _SIGNATURES:
        getattr(lib, name)  # every entry point is there
    return declare(lib)
