"""Preconditioners: Jacobi, the Chebyshev smoother and SA-AMG."""

from .jacobi import DiagonalPreconditioner, jacobi_preconditioner
from .cheby import chebyshev_smooth
from .amg import AMGLevel, AMGPreconditioner, smoothed_aggregation_setup

__all__ = [
    "DiagonalPreconditioner",
    "jacobi_preconditioner",
    "chebyshev_smooth",
    "AMGLevel",
    "AMGPreconditioner",
    "smoothed_aggregation_setup",
]
