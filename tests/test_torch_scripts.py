"""The port's controller benchmark scripts (the counterparts of
``test_scripts.py``'s two cases on ``create_algorithmic_diversity`` and
``test_diverse_load_patterns``), on the CPU, and their device rule: the
card by default, the CPU with ``--cpu``, an error without a card."""

import numpy as np
import pytest
import torch

from gym_anm_torch.scripts import create_algorithmic_diversity as cad
from gym_anm_torch.scripts import diverse_load_patterns as dlp

torch.set_num_threads(2)


def test_load_patterns_are_bounded():
    for name, fn in dlp.create_load_patterns().items():
        vals = np.array([fn(t) for t in range(300)])
        assert np.all(vals > 0), name
        assert np.all(vals < 2.0), name


def test_diversity_benchmark_single_run():
    avg = cad.run(cad.CONTROLLERS[1][1], load_scale=1.0, steps=5, device="cpu")
    assert np.isfinite(avg)


def test_diversity_benchmark_equals_jax_script():
    """The port's ``run`` gives the JAX script's average at load x1.2 for
    every controller but ``L5_ScipyOptimal``, which meets its capacitor tie
    at step 1 there (``test_torch_controller_variants.py::
    test_scipy_optimal_tie_at_nominal_load``): the two packages switch on
    different ones of its two interchangeable capacitors, and their averages
    differ by 2.05e-5."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "scripts", "create_algorithmic_diversity.py")
    spec = importlib.util.spec_from_file_location("create_algorithmic_diversity", path)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert [n for n, _ in ref.CONTROLLERS] == [n for n, _ in cad.CONTROLLERS]
    for (name, jcls), (_, pcls) in zip(ref.CONTROLLERS[:-1], cad.CONTROLLERS[:-1]):
        aj = ref.run(jcls, load_scale=1.2, steps=4)
        ap = cad.run(pcls, load_scale=1.2, steps=4, device="cpu")
        assert abs(ap - aj) <= 1e-8, (name, ap, aj)


@pytest.mark.parametrize("mod", [cad, dlp], ids=["create_algorithmic_diversity", "diverse_load_patterns"])
def test_scripts_need_a_card_or_cpu_flag(mod, tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--cpu"):
            mod.main(["--steps", "1"])
    argv = ["--steps", "2", "--cpu"] + (["--out", str(tmp_path)] if mod is dlp else [])
    results = mod.main(argv)
    per_controller = results if mod is cad else results["baseline_workday"]
    assert set(per_controller) == {n for n, _ in mod.CONTROLLERS}
