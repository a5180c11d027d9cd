"""K5, the batched ADMM of the DC-OPF: operations and bytes of one call.

Per sweep m·n + (n + m)·n multiply-adds (Āᵀ(ρz - y) and the packed
[M⁻¹; ĀM⁻¹] product: float64 sums of exact float32 products, at the float64
tensor-core rate) and 14m + 6n float32 operations of the elementwise chain;
per check (one every K sweeps) m·n multiply-adds and 8m + 5n operations
more.  Bounds, warm state in and out and the solution read or written once
a lane, the matrices once a call.  ANM6 at 8 stages: n = 168, m = 312.
"""

from .roofline import PEAK_F32, PEAK_F64_TC, least_seconds


def call_macs(n, m, K, sweeps):
    return sweeps * (m * n + (n + m) * n) + (sweeps // K) * m * n


def call_bytes(n, m, B):
    return 4 * B * (2 * m + 2 * (n + 3 * m) + n + 3) + 3 * B + 4 * (m * n + n * (n + m) + 3 * n + 4 * m)


def bound_seconds(n, m, K, B, sweeps):
    """Least time of one call over B lanes that ran ``sweeps`` sweeps in all."""
    checks = sweeps // K
    elementwise = sweeps * (14 * m + 6 * n) + checks * (8 * m + 5 * n)
    t_ops = 2 * call_macs(n, m, K, sweeps) / PEAK_F64_TC + elementwise / PEAK_F32
    return least_seconds(t_ops, call_bytes(n, m, B))
