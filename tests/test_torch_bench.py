"""The kernel probes (gym_anm_torch/bench) instrument the kernels' current
sources: every marker they place their counters at is still there."""

from gym_anm_torch import _build
from gym_anm_torch.bench import kernel_probes


def test_probes_instrument_the_current_kernel_sources():
    chord = kernel_probes.instrument_chord((_build.CSRC_DIR / "chord_newton.cu").read_text())
    assert chord.count("clock64()") == 10 and "g_probe[10]" in chord and 'extern "C" int probe_read' in chord
    gj = kernel_probes.instrument_gj((_build.CSRC_DIR / "gauss_jordan.cu").read_text())
    assert gj.count("clock64()") == 2 and "g_probe[1]" in gj
