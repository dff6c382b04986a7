"""Jacobi (diagonal) preconditioner — counterpart of the JAX package's
``solvers/precond/jacobi.py``."""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["DiagonalPreconditioner", "jacobi_preconditioner"]


@dataclasses.dataclass
class DiagonalPreconditioner:
    """``M(r) = r * inv_diag``."""

    inv_diag: torch.Tensor

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return r * self.inv_diag


def jacobi_preconditioner(A) -> DiagonalPreconditioner:
    """``M(r) = r / diag(A)`` (padding slots use diag 1).  The inverse is
    taken in the dtype of ``A.diagonal_padded`` (float32 for the
    sliced-ELL operator, as for the JAX BSG operator)."""
    return DiagonalPreconditioner(inv_diag=1.0 / A.diagonal_padded(fill=1.0))
