"""Physics: Y-bus, load flow (chord-Newton + exact Newton-Raphson), the
batched linear solve and the transition."""

from .linsolve_cuda import batched_solve, solve_gauss_jordan, solve_gauss_jordan_cuda
from .power_flow import ChordConst, NRResult, chord_solve, make_chord_const, nr_solve, nr_solve_lazy
from .transition import GridTables, TransitionOut, branch_flows, make_tables, solution_guess, transition
from .ybus import build_ybus

__all__ = [
    "batched_solve",
    "solve_gauss_jordan",
    "solve_gauss_jordan_cuda",
    "ChordConst",
    "NRResult",
    "chord_solve",
    "make_chord_const",
    "nr_solve",
    "nr_solve_lazy",
    "build_ybus",
    "GridTables",
    "TransitionOut",
    "make_tables",
    "transition",
    "branch_flows",
    "solution_guess",
]
