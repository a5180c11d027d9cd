"""One-shot verification drive of the port on the card.

    python -m gym_anm_torch.scripts.verify_h100 [--skip-compat] [--skip-build] [--cpu]

Port of ``scripts/verify_tpu.py``: the same probes, each printing PASS or
FAIL with its detail, and ``VERIFY OK`` or ``VERIFY FAILED`` last:

* the vec probes (float32, B_VEC lanes of base IEEE33, multicap17 and
  ANM6Easy): one step at the action box's low corner, one at its high
  corner, then N_RANDOM uniform-random steps from a fresh reset; every lane
  converged (residual within 1e-4) or terminated, observations and rewards
  finite;
* the acceptance probe: base IEEE33's chord solve (on the card the kernel
  ``csrc/chord_newton.cu``) under random capacitors and taps at B_ACCEPT
  lanes, three seeds: every lane accepted, so none reaches the Newton
  fallback;
* the MPC probe: ``make_vec_mpc`` on ANM6Easy, B_MPC lanes x MPC_STEPS
  steps: actions finite, mean reward per step above -5;
* the clean build (in place of the JAX script's cold-compile gate): every
  ``csrc/*.cu`` compiled by ``gym_anm_torch._build`` into a fresh
  directory and loaded, with its time;
* the compat smoke: ``compat.IEEE33Env`` reset and one step, finite (where
  gymnasium is missing the probe is skipped and says so).

Runs on the CUDA card, or with ``--cpu`` on the CPU, where every probe but
the build runs with the kernels' plain versions; without a card and
without ``--cpu`` it raises.  ``main(argv)`` returns whether every probe
passed; run as a module it exits 0 only then.
"""

import argparse
import ctypes
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .train_ppo_online import device_for, device_name, on_card

B_VEC, N_RANDOM = 1024, 30
B_ACCEPT = 8192
B_MPC, MPC_STEPS = 256, 8


def check(name, ok, detail=""):
    print(f"{'PASS' if ok else 'FAIL'}  {name}  {detail}", flush=True)
    return bool(ok)


def vec_probes(device):
    from ..vec import VecEnv, make_anm6easy_task, make_ieee33_multicap_task, make_ieee33_task

    ok = True
    B = B_VEC
    for factory, name in ((make_ieee33_task, "ieee33"), (make_ieee33_multicap_task, "multicap17"),
                          (make_anm6easy_task, "anm6easy")):
        env = VecEnv(factory(), dtype=torch.float32, device=device)
        t0 = time.perf_counter()
        g = torch.Generator(device=env.device).manual_seed(0)
        state, obs = env.reset(B, g)
        lo, hi = env.action_low, env.action_high

        # Genuine network collapse is valid behaviour (ANM6 terminates lanes
        # under aggressive random actions in f64 too), so the health
        # invariant is: every lane is either converged (diff <= 1e-4) or
        # flagged done; obs/rewards finite throughout.
        def healthy(d, info, obs, r):
            live = ~d
            live_ok = bool((info["diff"][live] <= 1e-4).all()) if bool(live.any()) else True
            return live_ok and bool(torch.isfinite(obs).all()) and bool(torch.isfinite(r).all())

        def detail(d, info):
            live = ~d
            live_max = float(info["diff"][live].max()) if bool(live.any()) else 0.0
            return f"done={int(d.sum())}/{B} live-diff={live_max:.2e} it={int(info['n_iter'].max())}"

        for probe, acts in (("low", lo.expand(B, -1)), ("high", hi.expand(B, -1))):
            state, obs, r, d, info = env.step(state, acts.contiguous(), g)
            ok &= check(f"{name} action-{probe}", healthy(d, info, obs, r), detail(d, info))
        # A fresh reset for the random phase.
        g = torch.Generator(device=env.device).manual_seed(1)
        state, obs = env.reset(B, g)
        for _ in range(N_RANDOM):
            u = torch.rand(B, env.n_action, generator=g, dtype=env.dtype, device=env.device)
            state, obs, r, d, info = env.step(state, lo + u * (hi - lo), g)
        if on_card(device):
            torch.cuda.synchronize()
        ok &= check(f"{name} {N_RANDOM}-step random", healthy(d, info, obs, r),
                    detail(d, info) + f" {time.perf_counter() - t0:.1f}s")
    return ok


def acceptance_probe(device):
    """On the bench action distribution (random capacitors, random taps)
    every lane's chord exit must be accepted: an unaccepted lane goes
    through the Newton fallback, a host loop several times slower.  The
    CPU test ``test_chord_acceptance_rate_is_total`` cannot see a
    regression of the kernel alone; this probe runs it."""
    from ..physics.power_flow import chord_solve
    from ..vec import VecEnv, make_ieee33_task

    tb = VecEnv(make_ieee33_task(), dtype=torch.float32, device=device).tables
    n = tb.n_bus - 1
    B = B_ACCEPT
    ok = True
    t0 = time.perf_counter()
    for seed in range(3):
        g = torch.Generator(device=device).manual_seed(seed)
        qc = torch.rand(B, 2, generator=g, device=device)
        taps = 0.9 + 0.2 * torch.rand(B, generator=g, device=device)
        q_ns = torch.zeros(B, n, device=device)
        q_ns[:, 7], q_ns[:, 24] = qc[:, 0], qc[:, 1]
        inv_da = 1.0 / taps - 1.0 / tb.chord_a0
        dtf_re = -tb.chord_y_re * inv_da
        dtf_im = -tb.chord_y_im * inv_da
        x, F, diff, it, acc = chord_solve(torch.zeros(B, n, device=device), q_ns, dtf_im, dtf_re, dtf_re, dtf_im,
                                          tb.chord_t)
        n_unacc = int((~acc).sum())
        ok &= check(f"ieee33 chord acceptance (seed {seed})", n_unacc == 0 and float(diff.max()) <= 1e-4,
                    f"unaccepted={n_unacc}/{B} max-diff={float(diff.max()):.2e} device={device_name(device)}")
    print(f"ACCEPTANCE_WALL_SECONDS {time.perf_counter() - t0:.1f}")
    return ok


def mpc_probe(device):
    """The MPC farm's health: actions finite, reward at an informed
    controller's level."""
    from ..vec import VecEnv, make_anm6easy_task, make_vec_mpc

    env = VecEnv(make_anm6easy_task(), dtype=torch.float32, device=device)
    ctrl = make_vec_mpc(env, gamma=0.995, safety_margin=0.96, planning_steps=1)
    t0 = time.perf_counter()
    g = torch.Generator(device=env.device).manual_seed(0)
    state, obs = env.reset(B_MPC, g)
    carry = ctrl.init_carry(B_MPC)
    tot, finite = 0.0, True
    for _ in range(MPC_STEPS):
        a, carry = ctrl.act(None, state, obs, carry)
        state, obs, r, d, info = env.step(state, a, g)
        tot += float(r.mean())
        finite &= bool(torch.isfinite(a).all())
    m = tot / MPC_STEPS
    return check(f"anm6easy vec-MPC {MPC_STEPS}-step rollout", np.isfinite(m) and m > -5.0 and finite,
                 f"mean r/step={m:.3f} wall={time.perf_counter() - t0:.1f}s")


def clean_build():
    """Compile every ``csrc/*.cu`` into a fresh directory and load the
    library: the build of the current tree, with no library of an earlier
    build to reuse."""
    from .. import _build

    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(prefix="verify_build_", dir=_build.BUILD_DIR.parent) as d:
            path = _build.build_library(_build.CSRC_DIR.glob("*.cu"), "libgym_anm_kernels", build_dir=Path(d))
            lib = _build.declare(ctypes.CDLL(str(path)))
            missing = [name for name in _build._SIGNATURES if not hasattr(lib, name)]
        ok, detail = not missing, f"wall={time.perf_counter() - t0:.1f}s"
        if missing:
            detail += f" missing entry points: {missing}"
    except RuntimeError as e:  # nvcc failed or is missing
        ok, detail = False, f"wall={time.perf_counter() - t0:.1f}s :: {str(e).strip().splitlines()[-1][:300]}"
    print(f"BUILD_WALL_SECONDS {time.perf_counter() - t0:.1f}")
    return check("kernels build from clean into a fresh directory and load", ok, detail)


def compat_smoke(device):
    t0 = time.perf_counter()
    try:
        from .. import compat
    except ImportError as e:
        print(f"SKIP  compat IEEE33Env reset+step  ({e})")
        return True
    env = compat.IEEE33Env(device=device)
    env.reset(seed=0)
    obs2, r, term, _, _ = env.step(env.action_space.sample())
    dt = time.perf_counter() - t0
    ok = check("compat IEEE33Env reset+step", np.isfinite(obs2).all() and np.isfinite(r),
               f"r={r:.4f} wall={dt:.1f}s device={device_name(device)}")
    print(f"COMPAT_WALL_SECONDS {dt:.1f}")
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--skip-compat", action="store_true")
    ap.add_argument("--skip-build", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="the probes that need no kernel, on the CPU")
    args = ap.parse_args(argv)
    device = device_for(args.cpu)
    print(f"verifying on {device} ({device_name(device)})")
    ok = vec_probes(device)
    ok = acceptance_probe(device) and ok
    ok = mpc_probe(device) and ok
    if not (args.cpu or args.skip_build):
        ok = clean_build() and ok
    if not args.skip_compat:
        ok = compat_smoke(device) and ok
    print("VERIFY", "OK" if ok else "FAILED")
    return ok


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
