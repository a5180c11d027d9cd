"""The port's heuristic expert zoo against the JAX package's: each of the 31
classes of ``offline.py``, from ``BaseHeuristic`` (its base action) to
``MPCBasedExpert``, in closed loop on ``IEEE33RenewableEnv`` (five renewables,
two capacitors and the OLTC, so every family acts) for 8 steps from the same
seed and global ``np.random`` state (``torch_twins``; the noisy heuristics
draw their noise there).  Actions and rewards agree within 1e-8.  The
``*Expert`` aliases are the same objects as their heuristics."""

import inspect

import numpy as np
import numpy.testing as npt
import pytest
import torch

import gym_anm_torch.offline as toff
import gym_anm_tpu.offline as joff

from .torch_twins import closed_loop, make_envs

torch.set_num_threads(2)

ATOL = 1e-8
T = 8

ZOO = [name for name, obj in vars(joff).items()
       if inspect.isclass(obj) and obj.__module__ == joff.__name__ and name == obj.__name__]
ALIASES = {name: obj.__name__ for name, obj in vars(joff).items()
           if inspect.isclass(obj) and obj.__module__ == joff.__name__ and name != obj.__name__}


@pytest.fixture(scope="module")
def envs():
    return make_envs(lambda pkg, **kw: pkg.IEEE33RenewableEnv(**kw))


def test_zoo_has_31_classes():
    assert len(ZOO) == 31 and ZOO[0] == "BaseHeuristic" and ZOO[-1] == "MPCBasedExpert"
    assert [n for n, o in vars(toff).items() if inspect.isclass(o) and o.__module__ == toff.__name__
            and n == o.__name__] == ZOO


@pytest.mark.parametrize("name", ZOO)
def test_heuristic_equals_jax(envs, name):
    ej, ep = envs
    _, _, rec = closed_loop(ej, ep, getattr(joff, name), getattr(toff, name), T, seed=4)
    assert np.all(np.isfinite(rec["actions_p"])) and np.all(np.isfinite(rec["rewards_p"]))
    npt.assert_array_equal(rec["terminated_p"], rec["terminated_j"])
    for t in range(T):
        npt.assert_allclose(rec["actions_p"][t], rec["actions_j"][t], rtol=0, atol=ATOL, err_msg=f"step {t}")
    npt.assert_allclose(rec["rewards_p"], rec["rewards_j"], rtol=0, atol=ATOL)


@pytest.mark.parametrize("alias", sorted(ALIASES))
def test_expert_alias_is_its_heuristic(alias):
    assert getattr(toff, alias) is getattr(toff, ALIASES[alias])
