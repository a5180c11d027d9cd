"""The port's scripts on the CPU: the counterparts of ``test_scripts.py``'s
cases (``create_algorithmic_diversity``, ``test_diverse_load_patterns``,
``generate_final_offline_datasets``), the dataset, quality-table and bench
scripts at small sizes, and their device rule: the card by default, the CPU
with ``--cpu``, an error without a card.

``run_compat`` equals the JAX script's at 1e-8 (both packages' environments
built from the same global ``np.random`` state with their action spaces
seeded alike, for L0's uniform draws); so does ``l0l5_quality_table``'s
table of the ready hierarchy, its SLSQP L5 at 1e-6 (as in
``chip_smoke.py``'s phase 14)."""

import importlib.util
import os
import pickle

import numpy as np
import pytest
import torch

import gym_anm_torch.compat as tc
from gym_anm_torch.scripts import create_algorithmic_diversity as cad
from gym_anm_torch.scripts import diverse_load_patterns as dlp
from gym_anm_torch.scripts import exp_rti_budget as rti
from gym_anm_torch.scripts import generate_final_offline_datasets as gfod
from gym_anm_torch.scripts import l0l5_quality_table as l0l5
from gym_anm_torch.scripts import quick_dataset_test as quick
from gym_anm_torch.scripts import scaling_bench as scaling
from gym_anm_torch.scripts import verify_h100 as verify

torch.set_num_threads(2)

SCRIPTS = os.path.join(os.path.dirname(__file__), "..", "scripts")


def jax_script(name):
    """The JAX package's ``scripts/<name>.py``, loaded under its own name."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


def test_collect_episode_data_schema():
    env = tc.IEEE33ProperEnvironment(device="cpu")
    data = gfod.collect_episode_data(env, gfod.SimpleL5_Optimal(), num_episodes=2, steps=5)
    assert set(data) == {"states", "actions", "rewards", "next_states", "dones", "episode_returns"}
    assert data["states"].shape[0] == data["actions"].shape[0] == 10
    assert data["actions"].shape[1] == 17
    assert np.all(np.isfinite(data["rewards"]))


def test_simple_controllers_produce_valid_actions():
    env = tc.IEEE33ProperEnvironment(device="cpu")
    env.reset(seed=0)
    for cls in gfod.CONTROLLERS:
        a = np.clip(cls().act(env), env.action_space.low, env.action_space.high)
        assert env.action_space.contains(np.asarray(a, dtype=env.action_space.dtype))


def _seed_action_spaces(monkeypatch, module):
    """``module.IEEE33ProperEnvironment`` builds environments whose action
    space is seeded with 0 (``run_compat`` leaves it unseeded)."""
    cls = module.IEEE33ProperEnvironment

    def make(*args, **kwargs):
        env = cls(*args, **kwargs)
        env.action_space.seed(0)
        return env

    monkeypatch.setattr(module, "IEEE33ProperEnvironment", make, raising=False)


def test_run_compat_equals_jax_script(monkeypatch, tmp_path):
    import gym_anm_tpu.compat as jc

    ref = jax_script("generate_final_offline_datasets")
    _seed_action_spaces(monkeypatch, jc)
    _seed_action_spaces(monkeypatch, tc)
    np.random.seed(0)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    dj, sj = ref.run_compat(1, str(tmp_path / "jax"))
    np.random.seed(0)
    dp, sp = gfod.run_compat(1, str(tmp_path / "port"), device="cpu")
    assert [s["controller"] for s in sj] == [s["controller"] for s in sp]
    for a, b in zip(dj, dp):
        assert a.keys() == b.keys() and a["controller_name"] == b["controller_name"]
        for k in ("states", "actions", "rewards", "next_states", "episode_returns"):
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-8, err_msg=f"{a['controller_name']} {k}")
        np.testing.assert_array_equal(b["dones"], a["dones"])
    with open(tmp_path / "port" / "L0_Random_data.pkl", "rb") as f:
        assert pickle.load(f)["controller_id"] == 0


def test_run_vec_small(monkeypatch, tmp_path):
    """Six blocks of 4 lanes x 5 steps: finite trajectories, actions in the
    box, a pickle a controller, L0 below the informed controllers."""
    monkeypatch.setattr(gfod, "VEC_STEPS", 5)
    all_data, summary, rate = gfod.run_vec(0, 4, str(tmp_path), device="cpu")
    assert [d["controller_name"] for d in all_data] == [f"L{i}" for i in range(6)] and rate > 0
    from gym_anm_torch.vec import VecEnv, make_ieee33_multicap_task

    env = VecEnv(make_ieee33_multicap_task(), device="cpu")
    lo, hi = env.action_low.numpy(), env.action_high.numpy()
    for d in all_data:
        assert d["states"].shape == (20, env.n_obs) and d["actions"].shape == (20, env.n_action)
        for k in ("states", "actions", "rewards", "next_states"):
            assert np.all(np.isfinite(d[k])), (d["controller_name"], k)
        assert np.all(d["actions"] >= lo) and np.all(d["actions"] <= hi)
        assert (tmp_path / f"{d['controller_name']}_data.pkl").exists()
    returns = {s["controller"]: s["avg_return"] for s in summary}
    assert returns["L0"] < min(returns[f"L{i}"] for i in range(1, 6))


def test_quick_dataset_test():
    out = quick.main(["--cpu"])
    assert set(out) == {"L0_Random", "L5_Optimal"}
    for data in out.values():
        assert data["rewards"].shape == (40,) and np.all(np.isfinite(data["rewards"]))


def test_l0l5_quality_table_skip_reference():
    out = l0l5.main(["--steps", "3", "--skip-reference", "--cpu"])
    assert out["reference"] is None and set(out["ours"]) == set(l0l5.ORDER)
    ref = jax_script("l0l5_quality_table").ours_table(3, 0)
    for level, avg in out["ours"].items():
        assert abs(avg - ref[level]) <= (1e-6 if level == "L5" else 1e-8), (level, avg, ref[level])


def test_l0l5_reference_skipped_without_checkout(tmp_path):
    assert l0l5.reference_table(1, 0, None) is None
    assert l0l5.reference_table(1, 0, str(tmp_path / "absent")) is None


def test_exp_rti_budget_small(monkeypatch):
    monkeypatch.setattr(rti, "QUALITY", (4, 3))
    monkeypatch.setattr(rti, "THROUGHPUT", (4, 2, 2))
    out = rti.main(["--budgets", "8,48", "--cpu"])
    assert set(out) == {8, 48}
    for rate, reward in out.values():
        assert rate > 0 and np.isfinite(reward)


def test_scaling_bench_two_gloo_ranks():
    out = scaling.main(["--multihost", "2", "--cpu", "--per-device", "4", "--steps", "2"])
    assert [r["ranks"] for r in out["results"]] == [1, 2]
    assert all(r["steps_per_s"] > 0 and np.isfinite(r["reward_sum"]) for r in out["results"])


def test_verify_h100_cpu(monkeypatch, capsys):
    for name, value in (("B_VEC", 16), ("N_RANDOM", 3), ("B_ACCEPT", 64), ("B_MPC", 8), ("MPC_STEPS", 2)):
        monkeypatch.setattr(verify, name, value)
    assert verify.main(["--cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "VERIFY OK" and not any(x.startswith("FAIL") for x in lines)
    assert sum(x.startswith("PASS") for x in lines) == 14


SCRIPTS_CPU_RUN = {"create_algorithmic_diversity": ["--steps", "2"], "diverse_load_patterns": ["--steps", "2"]}


@pytest.mark.parametrize("mod", [cad, dlp, gfod, quick, l0l5, rti, scaling, verify],
                         ids=["create_algorithmic_diversity", "diverse_load_patterns", "generate_final_offline_datasets",
                              "quick_dataset_test", "l0l5_quality_table", "exp_rti_budget", "scaling_bench",
                              "verify_h100"])
def test_scripts_need_a_card_or_cpu_flag(mod, tmp_path):
    """Without ``--cpu`` a script raises where no card is visible, before
    any work; the two controller benchmarks also run with ``--cpu`` here (the
    other scripts' ``--cpu`` runs are the tests above)."""
    name = mod.__name__.rsplit(".", 1)[1]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--cpu"):
            mod.main(SCRIPTS_CPU_RUN.get(name, []) + (["--out", str(tmp_path)] if mod is gfod else []))
    if name not in SCRIPTS_CPU_RUN:
        return
    argv = SCRIPTS_CPU_RUN[name] + ["--cpu"] + (["--out", str(tmp_path)] if mod is dlp else [])
    results = mod.main(argv)
    per_controller = results if mod is cad else results["baseline_workday"]
    assert set(per_controller) == {n for n, _ in mod.CONTROLLERS}
