"""Preconditioners: Jacobi, Chebyshev (smoother and preconditioner),
ILU(0)/ILUT and SA-AMG."""

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
from .amg import AMGLevel, AMGPreconditioner, smoothed_aggregation_setup

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
    "smoothed_aggregation_setup",
]
