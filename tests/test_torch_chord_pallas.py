"""The port's plain chord solve against the TPU kernel it stands beside on
the card: the Pallas chord-Newton prototype
``scripts/chord_pallas_prototype.py`` (``kernel`` / ``chord_pallas``), run in
interpret mode on the CPU.

The prototype asserts that JAX's x64 mode is off, and it is loaded by file
path so that the package's ``__init__`` (which turns x64 on) never runs, so
it runs in a subprocess of its own.  That subprocess wraps ``pl.pallas_call``
with ``interpret=True`` and points the prototype's hard-coded path of the
IEEE33 network file at this checkout; the script itself is not edited.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gym_anm_torch.networks import ieee33_network
from gym_anm_torch.physics import power_flow as tpf
from gym_anm_torch.physics.transition import make_tables
from gym_anm_torch.specs import load_network

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 256  # the prototype's default TILE: one grid step

# Runs in the subprocess: argv = repo, output .npz path, input .npz path.
_RUNNER = r"""
import functools, re, sys
import numpy as np
import jax
from jax.experimental import pallas as pl

repo, out_path, in_path = sys.argv[1:]
pl.pallas_call = functools.partial(pl.pallas_call, interpret=True)
script = repo + "/scripts/chord_pallas_prototype.py"
src = open(script).read()
src = re.sub(r'"[^"]*gym_anm_tpu/networks/ieee33\.py"', repr(repo + "/gym_anm_tpu/networks/ieee33.py"), src)
mod = {"__name__": "chord_pallas_prototype", "__file__": script}
exec(compile(src, script, "exec"), mod)

inp = np.load(in_path)
q_ns, taps = inp["q_ns"], inp["taps"]
Bn, n = q_ns.shape
# The prototype's own input recipe (its __main__ block): flat start, the tap's
# dY entries and the per-lane Woodbury K = W (I + C W)^-1.
inv_da = 1.0 / taps - 1.0 / mod["tap0"][mod["oltc_branch"]]
dtf_re = (-mod["y_br"].real * inv_da).astype(np.float32)
dtf_im = (-mod["y_br"].imag * inv_da).astype(np.float32)
C = mod["C"].astype(np.float64)
Ks = []
for wa, wb in zip(dtf_im.astype(np.float64), dtf_re.astype(np.float64)):
    W = np.array([[wa, wb], [wb, -wa]])
    Ks.append((W @ np.linalg.inv(np.eye(2) + C @ W)).reshape(-1))
Ks = np.asarray(Ks, np.float32)
scalars = np.concatenate([dtf_re[:, None], dtf_im[:, None], Ks, np.zeros((Bn, 2), np.float32)], axis=1)
x0 = np.concatenate([np.zeros((Bn, n)), np.ones((Bn, n))], axis=1).astype(np.float32)
pq = np.concatenate([np.zeros((Bn, n), np.float32), q_ns], axis=1)
x, F, diff, it = mod["chord_pallas"](x0, pq, scalars, Bn)
np.savez(out_path, x=np.asarray(x), F=np.asarray(F), diff=np.asarray(diff)[:, 0], it=np.asarray(it)[:, 0],
         dtf_re=dtf_re, dtf_im=dtf_im, t_bus=int(mod["T_BUS"]))
"""


@pytest.fixture(scope="module")
def pallas_run(tmp_path_factory):
    """The Pallas kernel's outputs on the prototype's inputs (numpy-drawn)."""
    d = tmp_path_factory.mktemp("chord_pallas")
    rng = np.random.default_rng(0)
    q_ns = np.zeros((B, 32), np.float32)
    qc = rng.uniform(0, 1, (B, 2)).astype(np.float32)
    q_ns[:, 7], q_ns[:, 24] = qc[:, 0], qc[:, 1]
    taps = rng.uniform(0.9, 1.1, B).astype(np.float32)
    np.savez(d / "in.npz", q_ns=q_ns, taps=taps)
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_ENABLE_X64", "TILE")}
    env["JAX_PLATFORMS"] = "cpu"
    subprocess.run([sys.executable, "-c", _RUNNER, REPO, str(d / "out.npz"), str(d / "in.npz")],
                   cwd=str(d), env=env, check=True, timeout=600)
    out = dict(np.load(d / "out.npz"))
    out["q_ns"] = q_ns
    return out


def test_plain_chord_matches_pallas_kernel(pallas_run):
    """Both solves end within the f32 acceptance band (≤ 1e-4) and agree on
    x within 2e-4.  They are not the same program: the prototype keeps exact
    sin/cos where the package (and the port) use the 7th-order Taylor form,
    and its in-band stall limit is 2 where theirs is 1, so exits may lie an
    iteration apart on the residual plateau (measured: max |Δx| 4.8e-6 on
    these inputs, mean iterations 7.1 against the prototype's 8.4)."""
    tb = make_tables(load_network(ieee33_network), 1.0, 100, dtype=torch.float32, device="cpu")
    assert tb.chord.t_bus == pallas_run["t_bus"]
    t = torch.as_tensor
    dtf_re, dtf_im = t(pallas_run["dtf_re"]), t(pallas_run["dtf_im"])
    x, F, diff, n_iter, acc = tpf.chord_solve_plain(
        torch.zeros(B, 32), t(pallas_run["q_ns"]), dtf_im, dtf_re, dtf_re, dtf_im, tb.chord_t)
    assert bool(acc.all())
    assert float(diff.max()) <= 1e-4
    assert float(pallas_run["diff"].max()) <= 1e-4
    dx = np.abs(x.numpy() - pallas_run["x"])
    print(json.dumps({"max_abs_dx": float(dx.max()), "iters_port_mean": float(n_iter.float().mean()),
                      "iters_pallas_mean": float(pallas_run["it"].mean()),
                      "iters_pallas_max": int(pallas_run["it"].max())}))
    np.testing.assert_allclose(x.numpy(), pallas_run["x"], rtol=0, atol=2e-4)
    # The residual each reports is its own iterate's true mismatch.
    np.testing.assert_allclose(F.numpy(), pallas_run["F"], rtol=0, atol=2e-4)
