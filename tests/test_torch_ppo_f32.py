"""gym_anm_torch's PPO training step at float32 against the JAX package's:
one step on base IEEE33 (``tests/ppo_reference.py``; JAX's noise and
permutations injected) within the tolerances that hold the JAX learner on
one device against eight (``tests/test_multidevice_equivalence.py:66-75``):
metrics rtol 2e-4 atol 1e-6, parameters rtol 1e-3 atol 2e-5.  Its own
file, so that each file compiles JAX's train step once.
"""

import jax.numpy as jnp
import numpy as np
import torch

from gym_anm_torch import convert

from .ppo_reference import run_both

torch.set_num_threads(2)


def test_train_step_matches_jax_f32():
    (jts, _, jobs, jm), (ts, _, obs, m) = run_both(jnp.float32, torch.float32)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-4, atol=1e-6, err_msg=f"metric {k}")
    for n, p in ts.params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), convert.param_from_jax(jts.params, n), rtol=1e-3, atol=2e-5,
                                   err_msg=f"param {n}")
    assert ts.step == int(jts.step)
    assert obs.dtype == torch.float32 and np.isfinite(obs.numpy()).all()
