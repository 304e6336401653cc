"""SQP-RTI solver: batched RTI step, condensed QP interior point, RK4."""

from .integrator import erk4, erk4_with_sensitivities
from .qp import QpData, QpDuals, QpResult, solve_qp
from .sqp import (
    STATUS_NAN,
    STATUS_NOT_CONVERGED,
    STATUS_OK,
    SolveInputs,
    SolveResult,
    SolverState,
    init_state,
    make_rti_step,
    shift_state,
)

__all__ = [
    "QpData", "QpDuals", "QpResult", "STATUS_NAN", "STATUS_NOT_CONVERGED", "STATUS_OK",
    "SolveInputs", "SolveResult", "SolverState", "erk4", "erk4_with_sensitivities",
    "init_state", "make_rti_step", "shift_state", "solve_qp",
]
