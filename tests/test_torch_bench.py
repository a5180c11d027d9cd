"""The kernel probes (gym_anm_torch/bench) instrument the kernels' current
sources: every marker they place their counters at is still there."""

import pytest

from gym_anm_torch import _build
from gym_anm_torch.bench import kernel_probes


def test_probes_instrument_the_current_kernel_sources():
    chord = kernel_probes.instrument_chord((_build.CSRC_DIR / "chord_newton.cu").read_text())
    assert chord.count("clock64()") == 10 and "g_probe[11]" in chord and 'extern "C" int probe_read' in chord
    gj = kernel_probes.instrument_gj(
        kernel_probes.gj_source("gauss_jordan_regs_f32.cu", "gauss_jordan_regs_f32_high.cu"))
    assert gj.count("clock64()") == 2 and "g_probe[1]" in gj
    panels = kernel_probes.instrument_panels(kernel_probes.gj_source("gauss_jordan.cu", "gauss_jordan_f64.cu"))
    assert panels.count("clock64()") == 5 and "g_probe[4]" in panels and 'extern "C" int probe_read' in panels
    admm = kernel_probes.instrument_admm((_build.CSRC_DIR / "admm_dcopf.cu").read_text())
    assert admm.count("clock64()") == 6 and "g_probe[6]" in admm and 'extern "C" int probe_read' in admm
    wide = kernel_probes.instrument_wide((_build.CSRC_DIR / "chord_newton_wide.cu").read_text())
    assert wide.count("clock64()") == 5 and "g_probe[6]" in wide and 'extern "C" int probe_read' in wide


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
