"""Krylov solvers and preconditioners."""

from .bicgstab import BiCGStabResult, bicgstab_solve
from .cg import (
    CGResult,
    IdentityPrecond,
    cg_solve,
    cg_solve_snapshots,
    cg_solve_with_state,
)
from .fused_cg import fused_cg_solve
from .gmres import GMRESResult, gmres_solve
from .precond import (
    AMGPreconditioner,
    ChebyshevPreconditioner,
    DiagonalPreconditioner,
    ILU0Preconditioner,
    chebyshev_preconditioner,
    estimate_lmax_dinv_a,
    ilu0_preconditioner,
    ilut_preconditioner,
    jacobi_preconditioner,
    smoothed_aggregation_setup,
)

__all__ = [
    "BiCGStabResult",
    "bicgstab_solve",
    "CGResult",
    "IdentityPrecond",
    "cg_solve",
    "cg_solve_snapshots",
    "cg_solve_with_state",
    "fused_cg_solve",
    "GMRESResult",
    "gmres_solve",
    "AMGPreconditioner",
    "ChebyshevPreconditioner",
    "DiagonalPreconditioner",
    "ILU0Preconditioner",
    "chebyshev_preconditioner",
    "estimate_lmax_dinv_a",
    "ilu0_preconditioner",
    "ilut_preconditioner",
    "jacobi_preconditioner",
    "smoothed_aggregation_setup",
]
