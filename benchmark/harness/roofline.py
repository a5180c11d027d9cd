"""The H100's published peaks and the least time of a kernel's work.

The peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit
(dense rates); a card held below 700 W runs below them, so every share is
stated beside the card's power limit.
"""

PEAK_F32 = 67e12     # FLOP/s, float32 outside the tensor cores
PEAK_F64_TC = 67e12  # FLOP/s, float64 on the tensor cores (DMMA)
HBM = 3.35e12        # bytes/s


def least_seconds(flops_time, n_bytes):
    """max(operations' time, bytes over the HBM rate)."""
    return max(flops_time, n_bytes / HBM)
