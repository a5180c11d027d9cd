"""K2, the chord solve: operations and bytes of a run's calls.

Per lane a prologue mismatch (4 N² float64 multiply-adds, N buses) and per
lane-iteration a mismatch, the update product and H·F (4 N² + 4 n² + 4 n,
n = N - 1 non-slack buses, so 2n = 64 unknowns at 33 buses), at the float64
tensor-core rate.  Bytes: p, q, the four per-lane scalars and the warm start
read once, the constants once a call, x, F, diff, n_iter and accepted
written once.  Lanes the kernel resets to the flat start report 0
iterations, so where many are reset this counts low.
"""

from .roofline import PEAK_F64_TC, least_seconds


def macs(n_ns, lane_calls, lane_iterations):
    N = n_ns + 1
    return lane_calls * 4 * N * N + lane_iterations * (4 * N * N + 4 * n_ns * n_ns + 4 * n_ns)


def call_bytes(n_ns, B):
    N = n_ns + 1
    consts = 8 * (2 * N * N + 4 * n_ns * n_ns + 4 * n_ns) + 4 * (4 * n_ns + 4 + 3 * N)
    return 4 * B * (2 * n_ns + 4) + 4 * B * 2 * n_ns + consts + B * (4 * 2 * 2 * n_ns + 9)


def bound_seconds(n_ns, B, calls, lane_iterations):
    """Least time of ``calls`` launches over B lanes with ``lane_iterations``
    chord iterations in all."""
    flops = 2 * macs(n_ns, B * calls, lane_iterations)
    return least_seconds(flops / PEAK_F64_TC, calls * call_bytes(n_ns, B))
