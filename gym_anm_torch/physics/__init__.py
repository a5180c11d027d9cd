"""Physics: Y-bus, load flow (chord-Newton + exact Newton-Raphson), the
batched linear solve, the set-point projections and the transition."""

from .chord_cuda import chord_solve_cuda
from .linsolve_cuda import batched_solve, solve_gauss_jordan, solve_gauss_jordan_cuda
from .power_flow import (
    ChordConst,
    NRResult,
    chord_solve,
    chord_solve_plain,
    make_chord_const,
    nr_solve,
    nr_solve_lazy,
)
from .projection import make_box_slopes_projector
from .transition import GridTables, TransitionOut, branch_flows, make_tables, solution_guess, transition
from .newton_cuda import newton_fallback_cuda
from .ybus import LaneYbus, build_ybus

__all__ = [
    "batched_solve",
    "solve_gauss_jordan",
    "solve_gauss_jordan_cuda",
    "ChordConst",
    "NRResult",
    "chord_solve",
    "chord_solve_plain",
    "chord_solve_cuda",
    "make_box_slopes_projector",
    "make_chord_const",
    "nr_solve",
    "nr_solve_lazy",
    "build_ybus",
    "LaneYbus",
    "newton_fallback_cuda",
    "GridTables",
    "TransitionOut",
    "make_tables",
    "transition",
    "branch_flows",
    "solution_guess",
]
