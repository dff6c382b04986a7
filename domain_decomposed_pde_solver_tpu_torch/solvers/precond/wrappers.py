"""Preconditioner combinators.

Counterpart of the JAX package's ``solvers/precond/wrappers.py``."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["CastPreconditioner"]


@dataclasses.dataclass
class CastPreconditioner:
    """Run ``inner`` in ``dtype`` and cast the result back to the input's
    dtype: the Krylov recurrence stays in f64 while the V-cycle or smoother
    runs in f32 (preconditioner quality, not accuracy, is what matters for
    convergence)."""

    inner: Any
    dtype: torch.dtype

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return self.inner(r.to(self.dtype)).to(r.dtype)
