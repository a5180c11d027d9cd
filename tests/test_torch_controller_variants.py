"""The port's controller hierarchies against the JAX package's: the
multi-capacitor controllers, the algorithmic, diversity, ready and
experimental L0-L5 sets (the counterpart of ``test_controller_variants.py``).

Every class runs on the environment its JAX test uses, the JAX class on the
JAX environment and the port's on the port's (``device="cpu"``), in closed
loop from the same seed and global ``np.random`` state (``torch_twins``) for
12 steps.  Actions and rewards agree within 1e-8, and so do the two SLSQP
L5s (``diversity_hierarchy.L5_ScipyOptimal``,
``ready_hierarchy.L5_MathematicalOptimization``; measured 7.782e-9 and
6.366e-10): SLSQP's iterates move with inputs that differ by the load flow's
last digits, but not past 1e-8 here.  At nominal load ``L5_ScipyOptimal``
meets a tie: its two 1.0-rated capacitors are interchangeable in its model,
SLSQP splits them 0.5/0.5 to the 12th digit, and its rounding ``x > 0.5``
then switches one or both on by those last digits; the JAX package and the
port may decide differently there, and ``test_scipy_optimal_tie_at_nominal_load`` pins
that the first disagreement is that tie.  The JAX file's behaviour checks
stay: finite actions and rewards, the size tiers of
``L5_EnhancedSwitchingAware`` and the key set of ``get_switching_stats``.
"""

import numpy as np
import numpy.testing as npt
import pytest
import torch

import gym_anm_torch.agents as tagents
import gym_anm_tpu.agents as jagents

from .torch_twins import closed_loop, make_envs

torch.set_num_threads(2)

ATOL = 1e-8
T = 12

ENVS = {
    "renewable": lambda pkg, **kw: pkg.IEEE33RenewableEnv(**kw),
    "multicap": lambda pkg, **kw: pkg.IEEE33MultiCapacitorEnv(**kw),
    "unequal": lambda pkg, **kw: pkg.IEEE33UnequalCapacitorsEnv(**kw),
    "proper": lambda pkg, **kw: pkg.IEEE33ProperEnvironment(load_scale=0.9, **kw),
    "proper_nominal": lambda pkg, **kw: pkg.IEEE33ProperEnvironment(load_scale=1.0, **kw),
}

CASES = (
    [("multicap_controllers", n, "multicap") for n in (
        "L2_ProportionalControl_MultiCap", "L2_DiscreteDroop", "L5_HierarchicalMPC_MultiCap",
        "L5_SwitchingAwareMPC", "L5_TrueMPC")]
    + [("multicap_controllers", "L5_EnhancedSwitchingAware", "unequal")]
    + [("algorithmic_hierarchy", n, "renewable") for n in (
        "L0_RandomControl", "L1_BangBangControl", "L2_ProportionalControl", "L3_PIControl",
        "L4_MPCControl", "L5_HierarchicalMPCControl")]
    + [("diversity_hierarchy", n, "proper") for n in (
        "L0_Random", "L1_BangBang", "L2_Proportional", "L3_PI_Controller", "L4_RuleBasedExpert",
        "L5_ScipyOptimal")]
    + [("ready_hierarchy", n, "proper") for n in (
        "L0_Random", "L1_BangBang", "L2_Proportional", "L3_Coordinated", "L4_Predictive",
        "L5_MathematicalOptimization")]
    + [("experimental_hierarchies", f"{fam}{n}", "renewable") for fam, names in (
        ("Improved", ("L0_Random", "L1_Basic", "L2_VoltageReactive", "L3_SingleDevice", "L4_MultiDevice",
                      "L5_Optimal")),
        ("Final", ("L0_Random", "L1_Minimal", "L2_Reactive", "L3_SingleDevice", "L4_MultiDevice",
                   "L5_Optimal")),
        ("Modified", ("L0_Random", "L1_Conservative", "L2_Wasteful", "L3_Aggressive", "L4_Uncoordinated",
                      "L5_Smart"))) for n in names]
)


@pytest.fixture(scope="module")
def envs():
    """One JAX/port environment pair per kind, built on first use."""
    cache = {}

    def get(kind):
        if kind not in cache:
            cache[kind] = make_envs(ENVS[kind])
        return cache[kind]

    return get


def _classes(module, name):
    return getattr(getattr(jagents, module), name), getattr(getattr(tagents, module), name)


def run(envs, module, name, kind, steps=T, seed=0):
    jcls, pcls = _classes(module, name)
    ej, ep = envs(kind)
    return closed_loop(ej, ep, jcls, pcls, steps, seed=seed)


@pytest.mark.parametrize("module,name,kind", CASES, ids=[f"{m.split('_')[0]}:{n}" for m, n, _ in CASES])
def test_actions_and_rewards_equal_jax(envs, module, name, kind):
    _, _, rec = run(envs, module, name, kind)
    assert np.all(np.isfinite(rec["actions_p"])) and np.all(np.isfinite(rec["rewards_p"]))
    npt.assert_array_equal(rec["terminated_p"], rec["terminated_j"])
    for t in range(T):
        npt.assert_allclose(rec["actions_p"][t], rec["actions_j"][t], rtol=0, atol=ATOL, err_msg=f"step {t}")
    npt.assert_allclose(rec["rewards_p"], rec["rewards_j"], rtol=0, atol=ATOL)


def test_module_class_names_equal_jax():
    for module in ("algorithmic_hierarchy", "diversity_hierarchy", "ready_hierarchy", "experimental_hierarchies",
                   "multicap_controllers", "ieee33_controllers"):
        names = lambda m: {k for k, v in vars(m).items() if isinstance(v, type) and v.__module__ == m.__name__}  # noqa: E731
        assert names(getattr(tagents, module)) == names(getattr(jagents, module)), module
    assert set(jagents.__all__) <= set(tagents.__all__)


def test_enhanced_switching_aware_size_tiers(envs):
    """The tiers partition the fleet; with the env's ratings (q_max · baseMVA
    = [0.3, 0.15, 0.12, 0.05, 0.03, 0.01]) every unit is in the < 0.4 tier,
    as in the JAX package."""
    aj, ap, _ = run(envs, "multicap_controllers", "L5_EnhancedSwitchingAware", "unequal")
    tiers = ap.large + ap.medium + ap.small + ap.tiny
    assert sorted(tiers) == list(range(ap.num_caps))
    assert ap.tiny == list(range(ap.num_caps))
    for k in ("large", "medium", "small", "tiny"):
        assert getattr(ap, k) == getattr(aj, k), k


def test_switching_aware_stats_equal_jax(envs):
    aj, ap, _ = run(envs, "multicap_controllers", "L5_SwitchingAwareMPC", "multicap", steps=30)
    sp, sj = ap.get_switching_stats(), aj.get_switching_stats()
    assert set(sp) == {"total_switches", "emergency_switches", "normal_switches", "avg_time_between_switches"}
    for k in sp:
        assert abs(sp[k] - sj[k]) <= ATOL, (k, sp[k], sj[k])


def test_scipy_optimal_tie_at_nominal_load(envs):
    """Until the two packages' ``L5_ScipyOptimal`` disagree, they agree
    within 1e-8; where they first disagree, both SLSQP solutions put the two
    1.0-rated capacitors (x[5], x[6]) at 0.5 within 1e-9, the two switches
    (entries 10-11) are each fully on or off, and the rest of that action
    agrees within 1e-6, the
    SLSQP bar: from two 0.5 splits that differ at the 12th digit SLSQP stops
    at iterates whose tap differs by 1.027e-8 (measured)."""
    xs = {"j": [], "p": []}

    def spying(cls, tag):
        def make(env):
            agent = cls(env)
            inner = agent._action_from_x
            agent._action_from_x = lambda x: (xs[tag].append(np.array(x)), inner(x))[1]
            return agent
        return make

    jcls, pcls = _classes("diversity_hierarchy", "L5_ScipyOptimal")
    ej, ep = envs("proper_nominal")
    _, _, rec = closed_loop(ej, ep, spying(jcls, "j"), spying(pcls, "p"), T)
    for t in range(T):
        aj, ap = rec["actions_j"][t], rec["actions_p"][t]
        if np.abs(ap - aj).max() <= ATOL:
            continue
        for x in (xs["j"][t], xs["p"][t]):
            npt.assert_allclose(x[5:7], 0.5, rtol=0, atol=1e-9, err_msg=f"step {t}")
        for a in (aj, ap):
            assert set(a[10:12]) <= {0.0, 1.0}, (t, a[10:12])
        rest = np.r_[0:10, 12:17]
        npt.assert_allclose(ap[rest], aj[rest], rtol=0, atol=1e-6, err_msg=f"step {t}")
        break
