"""K6, the flows kernel, alone on the card, beside its plain version.

At each benchmark cell's shape (IEEE33 at 262,144 lanes, multicap17 at
524,288, ANM6Easy at 65,536) the arguments of ``transition_flows`` are taken
from one real step on the card, then K6 (``transition_flows_cuda``) and the
plain version (``transition_flows_plain``, the torch ops the chord tier ran
before K6) are timed in turns (plain, K6, K6, plain) on those arguments:
each reading is ``--launches`` calls between one pair of CUDA events behind
a sleep kernel, so the host has enqueued them before the card reaches them.
The bound is the bytes the work has to move (each lane's voltages, final
mismatch, non-slack injections, taps, the injections the loss sums but the
slack's and the generators' potentials read once; its currents, four slack
entries, nine branch arrays and three scalars written once; the static rows
once a call) at the HBM rate.  Prints one JSON line: the card, its power
limit, and per shape the readings, their medians, the bound, K6's share and
each side's device ops a call.  Before the timing, K6's outputs are held
to the plain version's on copies of the same arguments (:func:`compare`):
the run fails on a mismatch and prints the worst gap as ``max_abs_err``.

    python -m gym_anm_torch.bench.flows_probe [--launches 20] [--seed 0]

Run from the repository's root: the bound is the benchmark's byte count
(``benchmark/harness/roofline_flows.py``).
"""

import argparse
import importlib
import json
import statistics
import subprocess

import torch

from ..physics.flows_cuda import transition_flows_cuda
from ..vec import VecEnv, make_anm6easy_task, make_ieee33_multicap_task, make_ieee33_task

HBM = 3.35e12  # bytes/s, H100 SXM
SLEEP_CYCLES = 20_000_000  # ~10 ms of the card's clock
CELLS = (("ieee33", make_ieee33_task, 262144), ("multicap17", make_ieee33_multicap_task, 524288),
         ("anm6easy", make_anm6easy_task, 65536))
ORDER = ("plain", "k6", "k6", "plain")


def step_inputs(make_task, B, seed):
    """(tables, arguments of ``transition_flows``) at one step of ``B``
    lanes under uniform random actions, from a fresh reset, on the card."""
    tm = importlib.import_module("gym_anm_torch.physics.transition")
    env = VecEnv(make_task(), dtype=torch.float32, device="cuda")
    seen = []
    real = tm.transition_flows

    def record(tb, *args):
        seen.append(tuple(tuple(t.clone() for t in a) if isinstance(a, tuple) else a.clone() for a in args))
        return real(tb, *args)

    tm.transition_flows = record
    try:
        g = torch.Generator(device="cuda").manual_seed(seed)
        state, obs = env.reset(B, g)
        env.step(state, env.random_policy()(g, obs, 0), g)
    finally:
        tm.transition_flows = real
    return env.tables, seen[-1]


def bound_bytes(tb, B):
    """Bytes the flows of ``B`` lanes have to move in one call (module
    docstring): the benchmark's count, on the sizes of ``tb``."""
    from benchmark.harness.roofline_flows import lane_values, static_values

    N, Ne, K, G = tb.n_bus, tb.n_branch, int(tb.genload_pos.numel()), int(tb.gen_pos.numel())
    return 4 * (B * lane_values(N, Ne, int(tb.oltc_branch.numel()), K, G) + static_values(N, Ne, K, G))


def copy_args(args):
    """A copy of the arguments of ``transition_flows`` (the kernel and the
    plain version write into four of them)."""
    return tuple(tuple(t.clone() for t in a) if isinstance(a, tuple) else a.clone() for a in args)


def bitwise(got, want, what):
    """``got`` and ``want`` hold the same bits (NaN where either is NaN)."""
    same = (got.view(torch.int32) == want.view(torch.int32)) | (torch.isnan(got) & torch.isnan(want))
    if not bool(same.all()):
        raise AssertionError(f"{what}: {int((~same).sum())} entries differ")


def within_ulps(got, want, mag, n_ulps, what):
    """|got − want| <= n_ulps float32 ulps of ``mag`` (the sum of the terms'
    magnitudes) where both are finite, the same NaN and inf elsewhere;
    returns the largest |got − want| where both are finite."""
    fin = torch.isfinite(got) & torch.isfinite(want)
    same_nonfinite = (torch.isnan(got) == torch.isnan(want)) & (torch.isinf(got) == torch.isinf(want)) & (
        (got == want) | torch.isnan(got) | fin)
    if not bool(same_nonfinite.all()):
        raise AssertionError(f"{what}: non-finite entries differ")
    m = mag.float().abs()
    ulp = (torch.nextafter(m, torch.full_like(m, float("inf"))) - m).double()
    gap = (got.double() - want.double()).abs()
    bad = fin & (gap > n_ulps * ulp)
    if bool(bad.any()):
        worst = float((gap / ulp)[fin].max())
        raise AssertionError(f"{what}: {int(bad.sum())} lanes past {n_ulps} ulps, worst {worst}")
    return float(gap[fin].max()) if bool(fin.any()) else 0.0


def magnitudes(tb, args, plain):
    """Sums of the magnitudes of the terms of the values that follow a
    reduction, down to the slack row's products, in float64: the slack
    current (re, im), the slack injection (re, im), e_loss, penalty, reward.
    ``plain`` is the plain version's ``Flows`` on ``args``."""
    v_re, v_im, F, p_ns, q_ns, dy, tap_new, bus_p, bus_q, dev_p, dev_q, p_pot, rates = args
    d = lambda t: t.double()  # noqa: E731
    vr, vi = d(v_re), d(v_im)
    y0r, y0i = d(tb.chord_t.Y0re[0]), d(tb.chord_t.Y0im[0])
    dff_re, dff_im, dft_re, dft_im = map(d, dy)
    t = tb.chord.t_bus
    m_re = (vr * y0r).abs().sum(1) + (vi * y0i).abs().sum(1) + dff_re.abs() + (dft_re * vr[:, t]).abs() + (
        dft_im * vi[:, t]).abs()
    m_im = (vr * y0i).abs().sum(1) + (vi * y0r).abs().sum(1) + dff_im.abs() + (dft_re * vi[:, t]).abs() + (
        dft_im * vr[:, t]).abs()
    v0r, v0i = vr[:, 0].abs(), vi[:, 0].abs()
    ms_re, ms_im = v0r * m_re + v0i * m_im, v0i * m_re + v0r * m_im
    loss = [c for c in tb.genload_pos.tolist() if c != tb.slack_dev]
    m_e = d(dev_p)[:, loss].abs().sum(1) + ms_re
    if tb.gen_project is not None:
        m_e = m_e + ((d(p_pot) - d(dev_p)[:, tb.gen_pos]).clamp(min=0) * d(tb.gen_rer_mask)).sum(1)
    m_e = m_e * tb.delta_t
    vm = torch.sqrt(vr * vr + vi * vi)
    vpen = (vm - d(tb.bus_v_max)).clamp(min=0) + (d(tb.bus_v_min) - vm).clamp(min=0)
    rpen = (d(plain.br_s_signed).abs() - d(rates)).clamp(min=0)
    m_p = (vpen.sum(1) + rpen.sum(1)) * tb.delta_t * tb.lamb
    return m_re, m_im, ms_re, ms_im, m_e, m_p, m_e + m_p


def compare(tb, args, kernel, kernel_args, plain, plain_args, n_ulps=4):
    """Holds the kernel's outputs ``kernel`` and its in-place arguments
    ``kernel_args`` to the plain version's (``plain``, a ``Flows``, and
    ``plain_args``), both run on copies of ``args``: every elementwise output
    (the non-slack currents, the nine branch arrays, the columns the slack
    injection leaves alone) bit for bit; the values that follow a reduction
    (the slack current, the four slack columns, e_loss, penalty, reward),
    which K6 sums in float64 in its own order and cuBLAS and torch.sum in
    theirs, within ``n_ulps`` float32 ulps of the sum of their terms'
    magnitudes.  Raises AssertionError on the first field past; returns the
    largest absolute gap (0 where bit for bit)."""
    bitwise(kernel[0][:, 1:], plain.bus_i_re[:, 1:], "bus_i_re")
    bitwise(kernel[1][:, 1:], plain.bus_i_im[:, 1:], "bus_i_im")
    for name, a, b in zip(plain._fields[2:11], kernel[2:11], plain[2:11]):
        bitwise(a, b, name)
    m_re, m_im, ms_re, ms_im, m_e, m_p, m_r = magnitudes(tb, args, plain)
    gaps = [within_ulps(kernel[0][:, 0], plain.bus_i_re[:, 0], m_re, n_ulps, "slack current re"),
            within_ulps(kernel[1][:, 0], plain.bus_i_im[:, 0], m_im, n_ulps, "slack current im")]
    for i, col, mag in ((7, tb.slack_bus, ms_re), (8, tb.slack_bus, ms_im), (9, tb.slack_dev, ms_re),
                        (10, tb.slack_dev, ms_im)):
        keep = torch.arange(kernel_args[i].shape[1], device=mag.device) != col
        bitwise(kernel_args[i][:, keep], plain_args[i][:, keep], f"argument {i} off its slack column")
        gaps.append(within_ulps(kernel_args[i][:, col], plain_args[i][:, col], mag, n_ulps,
                                f"argument {i}'s slack column"))
    gaps += [within_ulps(kernel[11], plain.e_loss, m_e, n_ulps, "e_loss"),
             within_ulps(kernel[12], plain.penalty, m_p, n_ulps, "penalty"),
             within_ulps(kernel[13], plain.reward, m_r, n_ulps, "reward")]
    return max(gaps)


def device_ms(fn, n_launch):
    """Mean device ms a call over ``n_launch`` calls between one event pair."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(n_launch):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_launch


def launches(fn):
    """The device ops (kernels, copies, fills) of one call of ``fn``, read
    from a profiler session of the host and the card (as the benchmark's
    traced runs read them)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def measure(n_launch=20, seed=0, count_ops=True):
    """One row a cell's shape: K6's largest gap to the plain version
    (:func:`compare`, which raises on a mismatch), their readings in turns,
    their medians, the bound and K6's share of it, and with ``count_ops``
    each side's device ops a call (read right only in a process whose
    earlier profiler sessions left the card's trace whole: a process that
    has run many loses the last events of a session)."""
    tm = importlib.import_module("gym_anm_torch.physics.transition")
    rows = []
    for name, make_task, B in CELLS:
        tb, args = step_inputs(make_task, B, seed)
        ka, pa = copy_args(args), copy_args(args)
        err = compare(tb, args, transition_flows_cuda(tb, *ka), ka, tm.transition_flows_plain(tb, *pa), pa)
        del ka, pa
        fns = {"k6": lambda: transition_flows_cuda(tb, *args), "plain": lambda: tm.transition_flows_plain(tb, *args)}
        for fn in fns.values():
            fn()  # warm: the library, the allocator's blocks
        readings = {"k6": [], "plain": []}
        for which in ORDER:
            readings[which].append(device_ms(fns[which], n_launch))
        k6, plain = statistics.median(readings["k6"]), statistics.median(readings["plain"])
        bound_ms = 1e3 * bound_bytes(tb, B) / HBM
        rows.append(dict(shape=name, lanes=B, k6_ms=readings["k6"], plain_ms=readings["plain"], k6_median_ms=k6,
                         plain_median_ms=plain, bound_ms=bound_ms, bound_by="bytes", share=bound_ms / k6,
                         max_abs_err=err))
        if count_ops:
            rows[-1]["launches_a_call"] = {k: launches(fn) for k, fn in fns.items()}
        del tb, args, fns
        torch.cuda.empty_cache()
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--launches", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flows_probe runs on a card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "device": torch.cuda.get_device_name(0), "shapes": measure(a.launches, a.seed)}))


if __name__ == "__main__":
    main()
