"""Krylov solvers and preconditioners."""

from .cg import (
    CGResult,
    IdentityPrecond,
    cg_solve,
    cg_solve_snapshots,
    cg_solve_with_state,
)
from .precond import (
    AMGPreconditioner,
    DiagonalPreconditioner,
    jacobi_preconditioner,
    smoothed_aggregation_setup,
)

__all__ = [
    "CGResult",
    "IdentityPrecond",
    "cg_solve",
    "cg_solve_snapshots",
    "cg_solve_with_state",
    "AMGPreconditioner",
    "DiagonalPreconditioner",
    "jacobi_preconditioner",
    "smoothed_aggregation_setup",
]
