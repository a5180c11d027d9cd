"""The 95th percentile of the intervals between the CUDA events recorded on
the stream after consecutive steps of the window (device timeline: host
stalls and device work both show)."""

import numpy as np


def read(run):
    return float(np.percentile(run.intervals_ms, 95)) if run.intervals_ms else None
