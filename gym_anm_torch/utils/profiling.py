"""Profiling hooks: trace annotations, device traces and throughput counters.

Port of ``gym_anm_tpu/utils/profiling.py`` over ``torch.profiler``: named
regions show up in the trace, and :func:`device_trace` writes a trace that
TensorBoard's profiler plugin or Perfetto reads.
"""

import contextlib
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler

__all__ = ["trace_annotation", "device_trace", "Throughput"]


@contextlib.contextmanager
def trace_annotation(name: str):
    """A named region in the trace (``torch.profiler.record_function``)."""
    with record_function(name):
        yield


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile the block (host, and the card when one is visible) and write
    the trace into ``logdir``; yields the profiler."""
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(logdir))) as prof:
        yield prof


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
