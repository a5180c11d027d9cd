"""NaN / divergence debugging tools.

Port of ``gym_anm_tpu/utils/debug.py``.  A non-finite value produced by one
op is usually observed many ops downstream, or swallowed (``diff > xtol`` is
False for NaN, which is why the solvers sanitize their exits).  Tools:

* :func:`debug_nans`: inside it, the FIRST op whose output holds a NaN or an
  Inf raises ``FloatingPointError`` naming that op.  PyTorch has no
  ``jax_debug_nans``; this is a ``TorchDispatchMode`` that checks every op's
  outputs (one host read each: debug only, never in a benchmark).
* :func:`forbid_host_syncs`: inside it, an operation that synchronizes the
  host with the card raises (``torch.cuda.set_sync_debug_mode("error")``).
* :func:`validate_state`: host-side invariant audit of a batched
  :class:`~gym_anm_torch.vec.EnvState`.
* :func:`explain_divergence`: classify a step's lanes from its ``info``.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["debug_nans", "forbid_host_syncs", "validate_state", "explain_divergence"]


class _NonFiniteCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if torch.is_tensor(t) and (t.is_floating_point() or t.is_complex()) and not bool(torch.isfinite(t).all()):
                raise FloatingPointError(f"non-finite value produced by {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Raise ``FloatingPointError`` at the first op inside the block whose
    output holds a NaN or an Inf; nothing is checked once the block exits
    (or with ``enable=False``)."""
    if not enable:
        yield
        return
    with _NonFiniteCheck():
        yield


@contextlib.contextmanager
def forbid_host_syncs(enable: bool = True):
    """Inside the block, a host-device synchronization raises (``torch.cuda.
    set_sync_debug_mode("error")``; the previous mode is restored on exit).
    Nothing is checked without a card or with ``enable=False``."""
    if not (enable and torch.cuda.is_available()):
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def validate_state(state, spec=None, *, v_band=(0.2, 2.0), strict: bool = False):
    """Audit a batched EnvState (lane on the first axis) for physical-
    invariant violations.

    ``spec`` (a :class:`~gym_anm_torch.NetworkSpec`) enables the SoC-box
    check; ``v_band`` is a plausibility band for live-lane voltage magnitudes
    (p.u.), far outside any operating band but catching the solver-divergence
    signature (|V| → 0 or explosion); ``strict`` raises ``AssertionError`` on
    any violation.

    Returns ``{check_name: bad_lane_index_array}`` of the failing checks only
    (empty == clean).  Terminated lanes are exempt from value checks.
    """
    report = {}
    live = ~_np(state.terminated).astype(bool).reshape(-1)

    def check(name, bad_mask):
        bad_mask = np.asarray(bad_mask).reshape(live.shape[0], -1).any(axis=1)
        bad = np.nonzero(bad_mask & live)[0]
        if bad.size:
            report[name] = bad

    for field in ("soc", "dev_p", "dev_q", "p_pot", "bus_vm", "v_guess", "oltc_tap"):
        check(f"{field}_nonfinite", ~np.isfinite(_np(getattr(state, field))))

    vm = _np(state.bus_vm)
    check("bus_vm_outside_band", (vm < v_band[0]) | (vm > v_band[1]))

    if spec is not None:
        soc = _np(state.soc)
        soc_max = np.asarray(spec.soc_max)[np.asarray(spec.des_pos)]
        soc_min = np.asarray(spec.soc_min)[np.asarray(spec.des_pos)]
        tol = 1e-4
        check("soc_outside_box", (soc < soc_min - tol) | (soc > soc_max + tol))

    if state.t.dtype.is_floating_point or state.t.dtype.is_complex:
        report["t_not_integer"] = np.arange(live.shape[0])

    if strict and report:
        raise AssertionError(f"EnvState invariant violations: { {k: v[:8] for k, v in report.items()} }")
    return report


def explain_divergence(info, done, xtol: float = 1e-4, state: Optional[object] = None):
    """Classify a step's lanes from its ``info``/``done`` outputs.

    Returns index arrays ``collapsed`` (done, residual above ``xtol``: the
    load flow genuinely diverged, valid physics under aggressive actions),
    ``terminated_converged`` (done lanes whose solve converged),
    ``unhealthy`` (LIVE lanes with a residual above ``xtol``: the bug
    class), the scalars ``n_iter_max`` and ``worst_live_diff``, and, given
    ``state``, its :func:`validate_state` report.
    """
    done = _np(done).astype(bool).reshape(-1)
    diff = _np(info["diff"]).reshape(-1)
    out = {
        "collapsed": np.nonzero(done & (diff > xtol))[0],
        "terminated_converged": np.nonzero(done & (diff <= xtol))[0],
        "unhealthy": np.nonzero(~done & (diff > xtol))[0],
        "n_iter_max": int(np.max(_np(info["n_iter"]))),
        "worst_live_diff": float(diff[~done].max()) if (~done).any() else 0.0,
    }
    if state is not None:
        out["state_report"] = validate_state(state)
    return out
