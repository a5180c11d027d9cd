"""Profiling: the program's tracer, device traces and throughput counters.

The tracer records spans and counters at the boundaries of the program's
layers (the env step, the transition, the chord solve, the Newton fallback,
the MPC controller) and the host reads on the step path:

* ``with span(name): ...`` times a block: the host's ``perf_counter_ns`` at
  entry and exit, and on a CUDA device a timing CUDA event recorded on the
  current stream at each edge; the innermost open span is its parent;
* ``count(name, value)`` adds a host integer, or holds a reference to a
  device tensor the step already made (optionally with a function that
  reduces it) and sums it only in :func:`report`;
* ``host_bool(t, site)`` is ``bool(t)``, counted under ``site`` and, while
  recording, preceded by a mark on the stream, so :func:`report` can give
  the device's idle from the read to the next mark.

Recording is on while a ``torch.profiler`` session records (whoever opened
it) and inside ``with recording():``; never while the current stream
captures a CUDA graph.  Off, :func:`span` returns one shared null context and
:func:`count` returns at once: no tensor op, no allocation, no CUDA event, no
host sync.  On, spans and counters launch no op and make no host sync; the
events come from a pool.  A record starts afresh when recording turns on
after being off (seen at the next span or counter) and when
:func:`recording` opens; :func:`report` synchronises once and reads the
newest record.  An operator records with::

    with profiling.recording():
        for _ in range(n):
            state, obs, reward, done, info = env.step(state, action)
    rep = profiling.report()

In another profiler session the spans are CUDA events alone, not
``record_function`` ranges: the profiler would place each range on the
device's timeline as an annotation spanning its kernels, and a reading of
that timeline (device ops, busy time, idle gaps) would count it as device
work.  Inside the program's own :func:`device_trace`, each span also opens
``record_function(name)``, so the written trace shows the layers on the
profiler's own host and device timelines.
"""

import contextlib
import sys
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler

__all__ = ["span", "count", "host_bool", "recording", "report", "device_trace", "Throughput"]

# Held tensors of one counter are folded into one sum once this many are held.
FOLD_AT = 64

# The kernels' wrappers and their launch counters: (module, function).
KERNEL_WRAPPERS = (
    ("gym_anm_torch.physics.chord_cuda", "chord_solve_cuda"),
    ("gym_anm_torch.physics.newton_cuda", "newton_fallback_cuda"),
    ("gym_anm_torch.physics.linsolve_cuda", "solve_gauss_jordan_cuda"),
    ("gym_anm_torch.vec.admm_cuda", "solve_dcopf_cuda"),
)

_NULL = contextlib.nullcontext()


def _launch_counts():
    """Each imported kernel wrapper's ``launch_count`` (0 for a module not
    yet imported: it has launched nothing)."""
    out = {}
    for module, fn in KERNEL_WRAPPERS:
        mod = sys.modules.get(module)
        out[fn] = getattr(getattr(mod, fn), "launch_count", 0) if mod is not None else 0
    return out


def _capturing():
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


def _total(value, reduce):
    """A held counter value as a tensor or an int: ``reduce`` applied to it
    (to the tuple's items), or its sum."""
    if reduce is not None:
        return reduce(*value) if isinstance(value, tuple) else reduce(value)
    return value.sum()


class _Record:
    """What one recording holds: spans in entry order, the CUDA marks in
    host order, counters and host reads."""

    def __init__(self):
        self.spans = []
        self.stack = []
        self.marks = []           # CUDA events, in the order the host recorded them
        self.counters = defaultdict(int)
        self.held = defaultdict(list)
        self.read_marks = []      # (index into marks, site)
        self.launches0 = _launch_counts()
        self.report = None


class _Span:
    __slots__ = ("tracer", "rec", "name", "parent", "host", "marks", "annotation")

    def __init__(self, tracer, rec, name):
        self.tracer, self.rec, self.name = tracer, rec, name
        self.annotation = None

    def __enter__(self):
        rec = self.rec
        self.parent = rec.stack[-1] if rec.stack else None
        rec.spans.append(self)
        rec.stack.append(self)
        rec.report = None
        if self.tracer.annotate:
            self.annotation = record_function(self.name)
            self.annotation.__enter__()
        self.marks = [self.tracer.mark(rec), None]
        self.host = [time.perf_counter_ns(), None]
        return self

    def __exit__(self, *exc):
        self.marks[1] = self.tracer.mark(self.rec)
        self.host[1] = time.perf_counter_ns()
        self.rec.stack.pop()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        return False


class Tracer:
    """The process's recorder of spans, counters and host reads (the module
    functions use one instance)."""

    def __init__(self):
        self.depth = 0          # open recording() blocks
        self.annotate = 0       # open device_trace() blocks
        self.was_on = False
        self.record = None
        self.pool = []          # timing events free for reuse

    def active(self):
        """The current record while recording is on, else None."""
        if not (self.depth or torch.autograd._profiler_enabled()):
            self.was_on = False
            return None
        if _capturing():
            return None
        if not self.was_on:
            self.start()
        return self.record

    def start(self):
        """A fresh record; the last one's events go back to the pool."""
        if self.record is not None:
            self.pool.extend(self.record.marks)
        self.record = _Record()
        self.was_on = True

    def mark(self, rec):
        """A timing event on the current stream (None without CUDA); its
        index among the record's marks."""
        if not torch.cuda.is_initialized():
            return None
        ev = self.pool.pop() if self.pool else torch.cuda.Event(enable_timing=True)
        ev.record()
        rec.marks.append(ev)
        return len(rec.marks) - 1

    def span(self, name):
        rec = self.active()
        return _NULL if rec is None else _Span(self, rec, name)

    def count(self, name, value, reduce=None):
        rec = self.active()
        if rec is None:
            return
        rec.report = None
        if isinstance(value, int):
            rec.counters[name] += value
            return
        held = rec.held[name]
        held.append((value, reduce))
        if len(held) >= FOLD_AT:
            rec.held[name] = [(torch.stack([_total(v, r) for v, r in held]).sum(), None)]

    def host_bool(self, t, site):
        rec = self.active()
        if rec is not None:
            rec.report = None
            rec.counters[f"host_reads.{site}"] += 1
            i = self.mark(rec)
            if i is not None:
                rec.read_marks.append((i, site))
        return bool(t)

    @contextlib.contextmanager
    def recording(self):
        if self.depth == 0:
            self.start()
        self.depth += 1
        try:
            yield
        finally:
            self.depth -= 1

    def report(self):
        rec = self.record
        if rec is None:
            return {"spans": {}, "counters": {}, "launches": {}, "read_idle": {}, "raw": []}
        if rec.report is None:
            rec.report = _report(rec, self.pool)
        return rec.report


def _report(rec, pool):
    held = [(name, _total(v, r)) for name, vals in rec.held.items() for v, r in vals]
    sums = [(name, t) for name, t in held if torch.is_tensor(t)]
    dev = None
    if rec.marks or any(t.is_cuda for _, t in sums):
        anchor = pool.pop() if pool else torch.cuda.Event(enable_timing=True)
        anchor.record()
        torch.cuda.synchronize()  # the record's one synchronise
        t_anchor = time.perf_counter_ns()
        # Each mark on the host's clock: the anchor's host time less the device time from the mark to it.
        dev = [t_anchor - 1e6 * ev.elapsed_time(anchor) for ev in rec.marks]
        pool.append(anchor)
    counters = dict(rec.counters)
    values = torch.stack([t.to(torch.int64) for _, t in sums]).tolist() if sums else []
    for (name, _), v in zip(sums, values):
        counters[name] = counters.get(name, 0) + v
    for name, t in held:
        if not torch.is_tensor(t):
            counters[name] = counters.get(name, 0) + int(t)

    raw, spans = [], {}
    index = {id(s): k for k, s in enumerate(rec.spans)}
    for s in rec.spans:
        # An open span, or one entered before the card was in use, has no device interval.
        d0, d1 = (dev[s.marks[0]], dev[s.marks[1]]) if dev is not None and None not in s.marks else (None, None)
        raw.append({"name": s.name, "parent": None if s.parent is None else index[id(s.parent)],
                    "host_ns": tuple(s.host), "device_ns": None if d0 is None else (d0, d1)})
    children = defaultdict(list)
    for k, r in enumerate(raw):
        if r["parent"] is not None:
            children[r["parent"]].append(k)
    for k, r in enumerate(raw):
        e = spans.setdefault(r["name"], {"count": 0, "parents": [], "host_ms": 0.0, "device_ms": None,
                                         "self_device_ms": None})
        e["count"] += 1
        parent = None if r["parent"] is None else raw[r["parent"]]["name"]
        if parent not in e["parents"]:
            e["parents"].append(parent)
        if r["host_ns"][1] is not None:
            e["host_ms"] += (r["host_ns"][1] - r["host_ns"][0]) / 1e6
        if r["device_ns"] is not None:
            d0, d1 = r["device_ns"]
            covered = _union([(max(raw[c]["device_ns"][0], d0), min(raw[c]["device_ns"][1], d1))
                              for c in children[k] if raw[c]["device_ns"] is not None])
            e["device_ms"] = (e["device_ms"] or 0.0) + (d1 - d0) / 1e6
            e["self_device_ms"] = (e["self_device_ms"] or 0.0) + (d1 - d0 - covered) / 1e6

    read_idle = {}
    for i, site in rec.read_marks:
        e = read_idle.setdefault(site, {"measured": 0, "idle_ms": 0.0})
        if dev is not None and i + 1 < len(dev):  # a read with no later mark is left out
            e["measured"] += 1
            e["idle_ms"] += (dev[i + 1] - dev[i]) / 1e6
    now = _launch_counts()
    launches = {fn: now[fn] - rec.launches0[fn] for fn in now}
    return {"spans": spans, "counters": counters, "launches": launches, "read_idle": read_idle, "raw": raw}


def _union(intervals):
    """Total length of the union of ``intervals`` [(start, end)]."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += max(e - s, 0.0)
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


_tracer = Tracer()


def span(name):
    """A named span around a block (see the module's docstring)."""
    return _tracer.span(name)


def count(name, value, reduce=None):
    """Add ``value`` to the counter ``name`` while recording: a host int is
    added at once; a tensor is held (no copy, no op) and summed, or passed
    to ``reduce`` (a tuple's items as its arguments), in :func:`report`.
    A held tensor must be one no later call writes into."""
    _tracer.count(name, value, reduce)


def host_bool(t, site):
    """``bool(t)``: a read of the device's value on the host, counted as
    ``host_reads.<site>``; while recording, the stream is marked just before
    it, and the device's time from that mark to the next one is the idle
    the read caused."""
    return _tracer.host_bool(t, site)


def recording():
    """Record the block, outside any profiler too (a fresh record)."""
    return _tracer.recording()


def report():
    """The newest record as a plain dict; synchronises once (after the
    recorded work) and is idempotent until the next record starts.

    * ``spans``: for each name its ``count``, ``parents`` (the parent span
      names seen, None for a root), ``host_ms``, ``device_ms`` (None without
      CUDA) and ``self_device_ms`` (its device interval less the parts its
      child spans cover), summed over its instances;
    * ``counters``: each counter's total, the held tensors summed, and
      ``host_reads.<site>``;
    * ``launches``: each kernel wrapper's ``launch_count`` over the record;
    * ``read_idle``: for each host-read site, the reads with a later mark
      (``measured``) and the device's ``idle_ms`` from each read to that mark;
    * ``raw``: every span in entry order (``name``, ``parent`` index,
      ``host_ns`` and ``device_ns`` (start, end), both on the host's
      ``perf_counter_ns`` clock: the card's marks are placed there by one
      anchor event recorded after the synchronise).
    """
    return _tracer.report()


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile the block (host, and the card when one is visible) and write
    the trace into ``logdir``; yields the profiler.  The program's spans
    show in it as ``record_function`` ranges."""
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(logdir))) as prof:
        _tracer.annotate += 1
        try:
            yield prof
        finally:
            _tracer.annotate -= 1


class Throughput:
    """Wall-clock env-steps/s counter with warm-up exclusion.

    On the card (``device`` of type cuda, the default) it synchronizes the
    device before it reads the clock, at :meth:`start` and in
    :attr:`steps_per_s`, so queued work is counted where it runs."""

    def __init__(self, device="cuda"):
        self._sync = torch.device(device).type == "cuda"
        self.reset()

    def reset(self):
        self._t0 = None
        self._steps = 0

    def _clock(self):
        if self._sync:
            torch.cuda.synchronize()
        return time.perf_counter()

    def start(self):
        self._t0 = self._clock()
        self._steps = 0

    def add(self, n_steps: int):
        self._steps += n_steps

    @property
    def steps_per_s(self):
        if self._t0 is None or self._steps == 0:
            return 0.0
        return self._steps / (self._clock() - self._t0)
