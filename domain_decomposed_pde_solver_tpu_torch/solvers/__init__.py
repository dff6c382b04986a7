"""Krylov solvers, eigen utilities and preconditioners."""

from .bicgstab import BiCGStabResult, bicgstab_solve
from .cg import (
    CGResult,
    IdentityPrecond,
    cg_solve,
    cg_solve_resumable,
    cg_solve_snapshots,
    cg_solve_with_state,
)
from .fused_cg import fused_cg_solve
from .gmres import GMRESResult, gmres_solve
from .lanczos import LanczosResult, lanczos_extremes
from .mixed import MixedSolveResult, iterative_refinement_solve
from .power import PowerResult, power_method
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
    "cg_solve_resumable",
    "cg_solve_snapshots",
    "cg_solve_with_state",
    "fused_cg_solve",
    "GMRESResult",
    "gmres_solve",
    "LanczosResult",
    "lanczos_extremes",
    "MixedSolveResult",
    "iterative_refinement_solve",
    "PowerResult",
    "power_method",
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
