"""gym_anm_torch's data parallelism over ``torch.distributed``: one rank
against two gloo ranks on the CPU.

The two-rank run is ``python -m gym_anm_torch.scripts.multihost_smoke``
spawned as two processes with ``--cpu`` (gloo), once for the module (each
with a 120 s timeout, killed past it).  Each runs PPO train steps on base
IEEE33 (a lane chunk crosses the rank boundary), ``train_cql`` on split
minibatches and the
ANM6Easy MPC farm on its lanes; this process runs the same functions at
world size 1 (no process group).  A silent sharding fault (a missing sum,
a local instead of a global mean, a wrong lane offset) changes the numbers
far outside the tolerances of ``tests/test_multidevice_equivalence.py``,
which hold here: metrics rtol 2e-4 atol 1e-6, parameters rtol 1e-3 atol
2e-5, MPC actions rtol 2e-4 atol 2e-5 and rewards rtol 2e-4 atol 1e-5.
"""

import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gym_anm_torch.scripts import multihost_smoke as worker

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 120


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The two ranks' outputs: (stdout, saved results) per rank."""
    out = tmp_path_factory.mktemp("ranks")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-m", "gym_anm_torch.scripts.multihost_smoke", str(r), "2", port,
                               "--out", str(out / f"rank{r}.pt"), "--cpu"], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"
    return [(log, torch.load(out / f"rank{r}.pt")) for r, log in enumerate(logs)]


@pytest.fixture(scope="module")
def one_rank():
    return {"ppo": worker.run_ppo("cpu"), "cql": worker.run_cql("cpu"), "mpc": worker.run_mpc("cpu")}


def _assert_learner_equal(one, two):
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(two["metrics"][k], v, rtol=2e-4, atol=1e-6, err_msg=f"metric {k}")
    for n, p in one["params"].items():
        np.testing.assert_allclose(two["params"][n].numpy(), p.numpy(), rtol=1e-3, atol=2e-5, err_msg=f"param {n}")


@pytest.mark.parametrize("learner", ["ppo", "cql"])
def test_learner_equivalent_on_one_and_two_ranks(two_ranks, one_rank, learner):
    """Both ranks hold the same parameters and metrics, equal to one rank's."""
    (_, r0), (_, r1) = two_ranks
    for n in r0[learner]["params"]:
        assert torch.equal(r0[learner]["params"][n], r1[learner]["params"][n]), n
    assert r0[learner]["metrics"] == r1[learner]["metrics"]
    _assert_learner_equal(one_rank[learner], r0[learner])


def test_ppo_lane_chunk_crosses_the_rank_boundary():
    """The configuration the PPO equivalence runs: of 12 lanes in 3 chunks
    of 4 over 2 ranks of 6, the middle chunk lies on both ranks, and the
    refresh period 5 does not divide a rank's lanes."""
    cfg, lanes = worker.PPO_CFG, worker.PPO_LANES
    chunk, per_rank = lanes // cfg.n_lane_minibatches, lanes // 2
    assert any(c * chunk < per_rank < (c + 1) * chunk for c in range(cfg.n_lane_minibatches))
    assert per_rank % cfg.refresh_interval != 0


def test_mpc_rollout_equivalent_on_one_and_two_ranks(two_ranks, one_rank):
    (_, r0), (_, r1) = two_ranks
    acts = torch.cat([r0["mpc"]["acts"], r1["mpc"]["acts"]], dim=1)
    rewards = torch.cat([r0["mpc"]["rewards"], r1["mpc"]["rewards"]], dim=1)
    np.testing.assert_allclose(acts.numpy(), one_rank["mpc"]["acts"].numpy(), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(rewards.numpy(), one_rank["mpc"]["rewards"].numpy(), rtol=2e-4, atol=1e-5)


def test_two_process_workers_report_identical_global_metrics(two_ranks, one_rank):
    """The workers' RESULT lines: identical on both ranks (the sums are
    global), and equal to one rank's within 2e-4."""
    results = {}
    for log, _ in two_ranks:
        m = re.search(r"RESULT (\d+) (\S+) (\S+)", log)
        assert m, f"no RESULT line:\n{log[-2000:]}"
        results[int(m.group(1))] = (float(m.group(2)), float(m.group(3)))
    assert set(results) == {0, 1}
    assert results[0] == results[1]
    ref = one_rank["ppo"]["metrics"]
    np.testing.assert_allclose(results[0], (ref["loss"], ref["mean_reward"]), rtol=2e-4, atol=1e-6)
