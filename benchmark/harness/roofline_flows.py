"""The transition's work after the load flow (the ``transition.flows``
span): bytes of a run's flows calls.

A call takes B lanes of a network of N buses, Ne branches, n_oltc OLTCs, K
devices whose injections the energy loss sums (loads, generators and the
slack) and n_gen generators, and computes each lane's bus currents, slack
injection, branch flows and reward.  What that work has to move, whatever
implements it, each value once:

* a lane reads its voltages (2N), the solver's final mismatch (2(N − 1)),
  the p and q of its non-slack buses (2(N − 1)), its OLTC taps (n_oltc),
  the injections the loss sums but the slack's, which the work computes
  (K − 1; the generators' set-points among them), and the generators'
  potentials (n_gen);
* it writes the bus currents (2N), the slack injection into the slack
  columns of the bus and device injections (4), the nine branch arrays
  (9 Ne) and e_loss, penalty and reward (3);
* a call reads the static rows once: a branch's two ends, series
  admittance (2), shunt, shift (cos and sin), nominal tap and rate (9 Ne);
  a bus's row-0 Y-bus entry (2) and voltage limits (2) (4N); the loss's
  device positions (K); a generator's position and renewable flag (2 n_gen).

The work is elementwise with a few short sums a lane, ~0.2 operations a
byte, so the bytes bound it: the least time is the bytes at the HBM rate.
"""

from .roofline import least_seconds


def lane_values(n_bus, n_branch, n_oltc, n_genload, n_gen):
    """Values one lane reads and writes."""
    reads = 2 * n_bus + 4 * (n_bus - 1) + n_oltc + (n_genload - 1) + n_gen
    writes = 2 * n_bus + 4 + 9 * n_branch + 3
    return reads + writes


def static_values(n_bus, n_branch, n_genload, n_gen):
    """Values of the static rows a call reads."""
    return 9 * n_branch + 4 * n_bus + n_genload + 2 * n_gen


def call_bytes(lanes, calls, net, elem):
    """Bytes of ``calls`` calls over ``lanes`` lanes in all on ``net`` (a
    ``reference.grid.Network``), ``elem`` bytes a value."""
    sizes = (net.n_bus, len(net.br_f))
    lane = lane_values(*sizes, len(net.oltcs), len(net.genload), len(net.gens))
    return elem * (lanes * lane + calls * static_values(*sizes, len(net.genload), len(net.gens)))


def bound_seconds(lanes, calls, net, elem):
    """Least time of ``calls`` calls over ``lanes`` lanes."""
    return least_seconds(0.0, call_bytes(lanes, calls, net, elem))
