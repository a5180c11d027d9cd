"""Reduce a ``torch.profiler`` trace of the traced window to what the
per-layer readers take.

Device busy time is the union of the device events' spans (kernels,
copies, sets); the idle gaps are the holes in that union inside the
``window`` span, each labelled by the innermost host event running at its
middle (a launch, a synchronize, an aten op or one of the benchmark's own
``step``/``act`` spans).  Kernels are told apart by the names of the
program's CUDA kernels.
"""

import re
from collections import defaultdict

import numpy as np
import torch

KERNELS = {
    "k2": re.compile(r"\bchord(_wide)?_kernel\b"),
    "k3": re.compile(r"\bnewton(_wide|_cluster)?_kernel\b"),
    "k5": re.compile(r"\badmm_kernel\b"),
}
TOP = 10
SPANS = frozenset({"window", "step", "act"})  # the record_function names of cell.traced


def _union(spans):
    """Total length of the union of ``spans`` [(start, end)], and the merged
    intervals."""
    total, merged = 0.0, []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                total += e - merged[-1][1]
                merged[-1][1] = e
        else:
            merged.append([s, e])
            total += e - s
    return total, merged


def reduce(events, n_steps):
    """The traced window's readings (times in microseconds)."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    win = next(e for e in events if e.device_type == cpu and e.name == "window")
    w0, w1 = win.time_range.start, win.time_range.end
    # The benchmark's spans also show on the device's timeline as annotations: not device work.
    dev = [(e.name, e.time_range.start, e.time_range.end) for e in events
           if e.device_type == cuda and e.name not in SPANS and w0 <= e.time_range.start <= w1]
    host = [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.device_type == cpu and e.name != "window" and w0 <= e.time_range.start <= w1]
    busy, merged = _union([(s, e) for _, s, e in dev])
    kernel_us = {k: sum(e - s for n, s, e in dev if pat.search(n)) for k, pat in KERNELS.items()}
    other, _ = _union([(s, e) for n, s, e in dev if not any(p.search(n) for p in KERNELS.values())])
    by_name = defaultdict(float)
    for n, s, e in dev:
        by_name[n] += e - s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    # One synchronize closes the window: it is the benchmark's, not the step's.
    syncs = sum(1 for n, _, _ in host if "Synchronize" in n) - 1
    return dict(steps=n_steps, window_us=w1 - w0, busy_us=busy, kernel_us=kernel_us, other_busy_us=other,
                n_ops=len(dev), syncs=syncs, device_ops=[[n[:200], us / 1e6] for n, us in ops],
                idle_gaps=_gaps(merged, host, w0, w1))


def _gaps(merged, host, w0, w1):
    """The idle time inside [w0, w1] by the host event running at each gap's
    middle, summed by name, largest first (the 500 longest gaps labelled)."""
    edges = [w0] + [x for m in merged for x in m] + [w1]
    gaps = [(max(a, w0), min(b, w1)) for a, b in zip(edges[::2], edges[1::2])]
    gaps = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])[:500]
    if not host:
        return []
    names = [n for n, _, _ in host]
    starts = np.array([s for _, s, _ in host])
    ends = np.array([e for _, _, e in host])
    dur = ends - starts
    out = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        cover = np.where((starts <= mid) & (ends >= mid), dur, np.inf)
        k = int(np.argmin(cover))
        out[names[k][:200] if np.isfinite(cover[k]) else "no host event"] += (b - a) / 1e6
    return [[n, s] for n, s in sorted(out.items(), key=lambda kv: -kv[1])[:TOP]]
