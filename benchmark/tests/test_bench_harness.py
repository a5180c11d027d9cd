"""The harness on the CPU: the import guard, the roofline arithmetic against
hand counts, discovery of a new cell's and metric's files by name, the
result line, the refusal without a card, and that the check comes out false
on the control and on each fault a cell can have."""

import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from bench_testkit import WORKLOADS, measure, steps_of
from harness import check, guard, roofline, roofline_k2, roofline_k5
from harness.spec import BENCH_DIR, ROOT, Spec


@pytest.mark.parametrize("modules, found", [
    ({"jax": 1, "numpy": 1}, ["jax"]),
    ({"jax.numpy": 1}, ["jax"]),
    ({"jaxlib.xla_client": 1}, ["jaxlib"]),
    ({"flax.linen": 1}, ["flax"]),
    ({"gym_anm_tpu.vec.core": 1}, ["gym_anm_tpu"]),
    ({"gym_anm_torch": 1, "gym_anm_torch.vec": 1, "jaxtyping": 1, "flaxen": 1}, []),
])
def test_guard_compares_whole_top_level_names(modules, found):
    assert guard.loaded(modules=modules) == found


def _modules_after(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps(sorted(sys.modules)))"],
                         cwd=BENCH_DIR, capture_output=True, text=True, timeout=120, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_loads_nothing_of_the_program_or_jax():
    mods = _modules_after("import reference.grid, reference.dcopf")
    assert guard.loaded(guard.FORBIDDEN | {"gym_anm_torch"}, mods) == []


def test_a_run_loads_no_jax():
    code = (f"import sys, time; sys.path[:0] = [{str(BENCH_DIR)!r}, {str(ROOT)!r}]\n"
            "import torch; torch.set_num_threads(2)\n"
            "from harness import cell, cli\nfrom harness.spec import Spec\n"
            "cell.check_steps = lambda traffic, seed: {0}\n"
            "cli.measure(Spec(), 'anm6easy-mpc8-b65536', 5, 0.2, 1, time.perf_counter(), device='cpu', batch=8)")
    assert guard.loaded(modules=_modules_after(code)) == []


def test_k2_counts_by_hand():
    # IEEE33: 32 non-slack buses, 64 unknowns; a prologue of 4 * 33^2, then
    # 4 * 33^2 + 4 * 32^2 + 4 * 32 = 8580 multiply-adds a lane-iteration.
    assert roofline_k2.macs(32, 1, 0) == 4356
    assert roofline_k2.macs(32, 0, 1) == 8580
    assert roofline_k2.macs(32, 10, 7) == 10 * 4356 + 7 * 8580
    # ANM6: 5 non-slack buses, 10 unknowns.
    assert roofline_k2.macs(5, 1, 1) == 4 * 36 + (4 * 36 + 4 * 25 + 20)
    consts = 8 * (2 * 33 * 33 + 4 * 32 * 32 + 4 * 32) + 4 * (4 * 32 + 4 + 3 * 33)
    assert roofline_k2.call_bytes(32, 1) == 4 * (64 + 4) + 4 * 64 + consts + (4 * 2 * 64 + 9)
    flops = 2 * (131072 * 4356 + 500_000 * 8580)
    assert roofline_k2.bound_seconds(32, 131072, 1, 500_000) == max(
        flops / roofline.PEAK_F64_TC, roofline_k2.call_bytes(32, 131072) / roofline.HBM)


def test_k5_counts_by_hand():
    # ANM6 at 8 stages: n = 168 variables, m = 312 rows; a sweep is
    # m n + (n + m) n = 52416 + 80640 multiply-adds a lane.
    n, m = 168, 312
    assert roofline_k5.call_macs(n, m, 8, 1) == 133056
    assert roofline_k5.call_macs(n, m, 8, 16) == 16 * 133056 + 2 * 52416
    B, sweeps = 16384, 16384 * 48
    t_ops = 2 * roofline_k5.call_macs(n, m, 8, sweeps) / roofline.PEAK_F64_TC + (
        sweeps * (14 * m + 6 * n) + sweeps // 8 * (8 * m + 5 * n)) / roofline.PEAK_F32
    assert roofline_k5.bound_seconds(n, m, 8, B, sweeps) == max(t_ops, roofline_k5.call_bytes(n, m, B) / roofline.HBM)


def test_dcopf_shapes_at_eight_stages():
    ref, _ = steps_of("anm6easy-mpc8-b65536", 2, n_steps=1)
    assert (ref.lp.n, ref.lp.m) == (168, 312)


def test_new_cell_and_metric_found_by_name(tmp_path):
    """A traffic file, a metric reader, a limits file and their entries in
    BENCHMARK.json: the harness finds and runs them with no file edited."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH_DIR, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(root): p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "benchmark" / "traffic" / "rollout-b48.json").write_text(json.dumps(
        dict(json.loads((BENCH_DIR / "traffic" / "rollout-b262144.json").read_text()), batch=48)))
    (root / "benchmark" / "limits" / "ieee33-rollout-b48.json").write_text(
        (BENCH_DIR / "limits" / "ieee33-rollout-b262144.json").read_text())
    (root / "benchmark" / "metrics" / "steps_in_window.py").write_text(
        '"""Steps in the window."""\n\n\ndef read(run):\n    return float(run.steps)\n')
    doc["workloads"].append({"name": "ieee33-rollout-b48", "config": "ieee33", "traffic": "rollout-b48", "chips": 1,
                             "why": "test"})
    doc["per_layer"].append({"name": "steps_in_window", "unit": "steps", "better": "higher", "source": "host_clock",
                             "layer": "env step", "moves": "env_steps_per_s", "workloads": ["ieee33-rollout-b48"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    spec = Spec(root, root / "benchmark")
    assert spec.traffic(spec.workload("ieee33-rollout-b48")["traffic"])["batch"] == 48
    names = [m["name"] for m in spec.metrics("ieee33-rollout-b48", "per_layer")]
    assert "steps_in_window" in names and "k5_roofline" not in names
    assert "steps_in_window" not in [m["name"] for m in spec.metrics("ieee33-rollout-b262144", "per_layer")]
    from harness import cell

    run, loop = cell.run_cell(spec, "ieee33-rollout-b48", 3, 0.2, 0, time.perf_counter(), device="cpu")
    assert run.batch == 48 and spec.reader("steps_in_window")(run) == float(run.steps)
    after = {p.relative_to(root): p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items() if "__pycache__" not in k.parts)


def test_result_line(monkeypatch):
    result = measure(monkeypatch, "ieee33-rollout-b262144", 16)
    compared = result["compared"]
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "compared" and result["correct"] is True and result["failed"] == 0
    assert set(result["metrics"]) == {"env_steps_per_s", "setup_s"}  # a CPU run has no device readings
    assert all(set(v) == {"value", "limit"} for v in compared.values())
    traced = measure(monkeypatch, "anm6easy-mpc8-b65536", 8, trace=1)
    assert "breakdown" in traced and "busy_s" in traced["device"]
    assert "host_ms_per_step" in traced["metrics"] and "env_steps_per_s" not in traced["metrics"]


def test_run_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    for cwd in (ROOT, tmp_path):
        if cwd == tmp_path:  # only BENCHMARK.json and the benchmark's files
            shutil.copytree(BENCH_DIR, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
        out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", WORKLOADS[0], "--seed", "1",
                              "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0 and out.stdout.strip() == ""


# ----------------------------------------------------------------------
# the check against its control and the faults a cell can have
# ----------------------------------------------------------------------

@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(workload):
    ref, steps = steps_of(workload, 32)
    limits = Spec().limits(workload)
    readings, _ = check.judge(ref, check.control_steps(ref, steps), limits)
    assert not check.verdict(readings, limits), readings


def _unchanged(orig):
    def step(self, state, action, generator=None):
        _, obs, reward, done, info = orig(self, state, action, generator)
        return state, obs, reward, done, info
    return step


def _half_batch(orig):
    from gym_anm_torch.vec.core import tree_map

    def step(self, state, action, generator=None):
        h = action.shape[0] // 2
        out = orig(self, tree_map(lambda a: a[:h], state), action[:h], generator)
        fill = lambda a: torch.cat([a, a[:a.shape[0]]])[:2 * h] if a.dim() else a  # noqa: E731
        new_state = tree_map(fill, out[0])
        return (new_state, fill(out[1]), fill(out[2]), fill(out[3]), {k: fill(v) for k, v in out[4].items()})
    return step


def _altered(orig):
    def step(self, state, action, generator=None):
        new_state, obs, reward, done, info = orig(self, state, action, generator)
        vm = new_state.bus_vm.clone()
        vm[1, 5] += 1e-2
        return new_state._replace(bus_vm=vm), obs, reward, done, info
    return step


def _false_done(orig):
    """Lane 1 ended although its load flow is sound (a wrong collapse test)."""
    def step(self, state, action, generator=None):
        new_state, obs, reward, done, info = orig(self, state, action, generator)
        done = done.clone()
        done[1] = True
        return new_state._replace(terminated=done), obs, reward, done, info
    return step


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered, _false_done])
@pytest.mark.parametrize("workload", ["ieee33-rollout-b262144", "anm6easy-mpc8-b65536"])
def test_a_faulty_step_is_not_correct(monkeypatch, fault, workload):
    from gym_anm_torch.vec.core import VecEnv

    monkeypatch.setattr(VecEnv, "step", fault(VecEnv.step))
    result = measure(monkeypatch, workload, 16)
    assert result["correct"] is False and result["failed"] > 0
    if fault is _false_done:
        assert result["compared"]["done_flips"]["value"] > 0
        if workload == "anm6easy-mpc8-b65536":  # the autoreset reset every lane it was told was done
            assert result["checked"]["reset_lanes"] >= result["checked"]["steps"]


def _stale_carry(monkeypatch):
    """The solve hands back the state it started from."""
    from gym_anm_torch.vec import mpc

    orig = mpc.solve_dcopf
    monkeypatch.setattr(mpc, "solve_dcopf", lambda spec, l, u, warm=None: orig(spec, l, u, warm)._replace(
        warm=warm if warm is not None else mpc.init_warm(spec, l.shape[0])))


def _unshifted_carry(monkeypatch):
    """The receding-horizon shift left out: stage k warm-starts from its own
    last solution instead of stage k + 1's."""
    from gym_anm_torch.vec import mpc

    monkeypatch.setattr(mpc, "make_shift_warm", lambda spec, structure, planning_steps: (lambda warm: warm))


@pytest.mark.parametrize("fault", [_stale_carry, _unshifted_carry])
def test_a_faulty_controller_carry_is_not_correct(monkeypatch, fault):
    """The steps chained from the reset hold the controller's carried ADMM
    state to the reference's own."""
    fault(monkeypatch)
    result = measure(monkeypatch, "anm6easy-mpc8-b65536", 16)
    assert result["correct"] is False and result["compared"]["action_gap_mw"]["value"] > 0.5, result["compared"]


def test_an_altered_action_is_not_correct(monkeypatch):
    """The MPC's action of one lane moved by 0.5 MW where the solve
    produces it."""
    from gym_anm_torch.vec import mpc

    orig = mpc.solve_dcopf

    def solve(spec, l, u, warm=None):
        sol = orig(spec, l, u, warm)
        x = sol.x.clone()
        x[2, spec.act_idx[0]] += 0.5 / spec.baseMVA
        return sol._replace(x=x)

    monkeypatch.setattr(mpc, "solve_dcopf", solve)
    result = measure(monkeypatch, "anm6easy-mpc8-b65536", 16)
    assert result["correct"] is False and result["compared"]["action_gap_mw"]["value"] > 0.4


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", WORKLOADS[0], "--seed", "2147483659",
                          "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
