"""The kernel probes (gym_anm_torch/bench) instrument the kernels' current
sources: every marker they place their counters at is still there; and
their baselines (K5 with one block per lane; K1 with the matrix in device
memory, the wide chord kernel with one block per lane and PR 13's K3) keep
the C interfaces the probes and chip_smoke.py call."""

import ctypes
import re
from pathlib import Path

import pytest

from gym_anm_torch import _build
from gym_anm_torch.bench import kernel_probes


def test_probes_instrument_the_current_kernel_sources():
    chord = kernel_probes.instrument_chord((_build.CSRC_DIR / "chord_newton.cu").read_text())
    assert chord.count("clock64()") == 10 and "g_probe[10]" in chord and 'extern "C" int probe_read' in chord
    gj = kernel_probes.instrument_gj(
        kernel_probes.gj_source("gauss_jordan_regs_f32.cu", "gauss_jordan_regs_f32_high.cu"))
    assert gj.count("clock64()") == 2 and "g_probe[1]" in gj
    panels = kernel_probes.instrument_panels(kernel_probes.gj_source("gauss_jordan.cu", "gauss_jordan_f64.cu"))
    assert panels.count("clock64()") == 5 and "g_probe[4]" in panels and 'extern "C" int probe_read' in panels
    admm = kernel_probes.instrument_admm((_build.CSRC_DIR / "admm_dcopf.cu").read_text())
    assert admm.count("clock64()") == 6 and "g_probe[6]" in admm and 'extern "C" int probe_read' in admm
    wide = kernel_probes.instrument_wide((_build.CSRC_DIR / "chord_newton_wide.cu").read_text())
    assert wide.count("clock64()") == 5 and "g_probe[6]" in wide and 'extern "C" int probe_read' in wide


def _entry_params(src, name):
    sig = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", src, re.S).group(1)
    return [p.strip() for p in sig.split(",")]


@pytest.mark.parametrize("f64", [False, True])
def test_pr5_baseline_keeps_the_probes_interface(f64):
    """``admm_dcopf_pr5.cu`` (PR 5's K5) takes the 43 arguments of
    ``PR5_ARGS`` in both builds (pointers, then 10 floats, 6 ints, the
    stream), and its ``-DADMM_F64`` build takes the matrices as doubles and
    converts nothing in the k-loops."""
    src = (Path(kernel_probes.__file__).with_name("admm_dcopf_pr5.cu")).read_text()
    params = _entry_params(src, "admm_probe_f32")
    assert len(params) == len(kernel_probes.PR5_ARGS) == 43
    assert params[0].startswith("const Mat*") and params[1].startswith("const Mat*")
    kinds = ["float" if p.startswith("float ") else "int" if p.startswith("int ") else "ptr" for p in params]
    assert kinds == ["ptr"] * 26 + ["float"] * 10 + ["int"] * 6 + ["ptr"]
    f64_parts = "".join(re.split(r"#else|#endif", part)[0] for part in src.split("#ifdef ADMM_F64")[1:])
    assert "static_cast<double>(P." not in f64_parts and "fma(vd[i], P.A[i * n + j], acc)" in f64_parts
    assert ("typedef double Mat;" if f64 else "typedef float Mat;") in src


def _ctype(param):
    """The ctypes type a C parameter takes: a scalar by its type, else a pointer."""
    scalars = (("float ", ctypes.c_float), ("double ", ctypes.c_double), ("int ", ctypes.c_int),
               ("long long ", ctypes.c_longlong))
    return next((t for prefix, t in scalars if param.startswith(prefix)), ctypes.c_void_p)


@pytest.mark.parametrize("name", sorted(kernel_probes.BASELINE_SIGNATURES))
def test_baselines_keep_the_probes_interface(name):
    """Each entry point of the baselines (K1's, the wide chord kernel's and
    PR 13's K3) takes the arguments that ``BASELINE_SIGNATURES`` declares
    (pointers and scalars in that order), and the wide chord kernel's
    baseline takes the current kernel's arguments without its work counter,
    its scratch buffer and the row strides of its float32 constants."""
    here = Path(kernel_probes.__file__).parent
    src = "".join((here / f).read_text() for f in kernel_probes.BASELINE_SOURCES)
    params = _entry_params(src, name)
    assert [_ctype(p) for p in params] == list(kernel_probes.BASELINE_SIGNATURES[name])
    if name == "chord_newton_wide_lane_f32":
        new = _entry_params((_build.CSRC_DIR / "chord_newton_wide.cu").read_text(), "chord_newton_wide_f32")
        assert [p.split()[-1] for p in new if p.split()[-1] not in ("next_lane", "scratch", "w_ld", "u_ld")] == \
            [p.split()[-1] for p in params]


@pytest.mark.parametrize("variant", sorted(kernel_probes.NEWTON_VARIANTS))
def test_k3_probe_instruments_each_variant_of_the_current_source(variant):
    """K3's probe places its counters in the current source and each of its
    variants (the 64-row body held at one width, zero dividends divided)
    edits it, and its entry reaches every body the probe times."""
    src = (_build.CSRC_DIR / "newton_fallback.cuh").read_text()
    edited = kernel_probes.NEWTON_VARIANTS[variant](src)
    assert (edited == src) == (variant == "as built")
    probe = kernel_probes.instrument_newton(edited)
    assert probe.count("clock64()") == 8 and "g_probe[9]" in probe and 'extern "C" int k3_probe' in probe
    for n in kernel_probes.NEWTON_BODIES:
        assert f"launch_newton<T, {n}, true>" in probe and f"launch_newton<T, {n}, false>" in probe
