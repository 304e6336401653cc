"""SQP-RTI solver: batched RTI step, condensed and stage-wise (Riccati) QP
interior points, RK4, the blocked Cholesky of ``chol_impl: custom``."""

from .integrator import erk4, erk4_with_sensitivities
from .qp import QpData, QpDuals, QpResult, solve_qp
from .qp_riccati import RiccatiQpResult, StageQpData, solve_qp_riccati
from .sqp import (
    STATUS_NAN,
    STATUS_NOT_CONVERGED,
    STATUS_OK,
    SolveInputs,
    SolveResult,
    SolverState,
    init_state,
    make_rti_step,
    resolve_qp_backend,
    shift_state,
)

__all__ = [
    "QpData", "QpDuals", "QpResult", "RiccatiQpResult", "STATUS_NAN", "STATUS_NOT_CONVERGED",
    "STATUS_OK", "SolveInputs", "SolveResult", "SolverState", "StageQpData", "erk4",
    "erk4_with_sensitivities", "init_state", "make_rti_step", "resolve_qp_backend",
    "shift_state", "solve_qp", "solve_qp_riccati",
]
