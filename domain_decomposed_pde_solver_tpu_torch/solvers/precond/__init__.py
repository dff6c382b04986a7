"""Preconditioners: Jacobi, Chebyshev (smoother and preconditioner),
ILU(0)/ILUT, SA-AMG and the precision cast."""

from .jacobi import DiagonalPreconditioner, jacobi_preconditioner
from .cheby import chebyshev_smooth
from .chebyshev import (
    ChebyshevPreconditioner,
    chebyshev_preconditioner,
    estimate_lmax_dinv_a,
)
from .ilu import (
    ILU0Preconditioner,
    ilu0_factor,
    ilu0_preconditioner,
    ilut_preconditioner,
)
from .amg import (
    AMGLevel,
    AMGPreconditioner,
    aggregate_greedy,
    infer_free_grid,
    smoothed_aggregation_preconditioner,
    smoothed_aggregation_setup,
)
from .wrappers import CastPreconditioner

__all__ = [
    "DiagonalPreconditioner",
    "jacobi_preconditioner",
    "chebyshev_smooth",
    "ChebyshevPreconditioner",
    "chebyshev_preconditioner",
    "estimate_lmax_dinv_a",
    "ILU0Preconditioner",
    "ilu0_factor",
    "ilu0_preconditioner",
    "ilut_preconditioner",
    "AMGLevel",
    "AMGPreconditioner",
    "aggregate_greedy",
    "infer_free_grid",
    "smoothed_aggregation_preconditioner",
    "smoothed_aggregation_setup",
    "CastPreconditioner",
]
