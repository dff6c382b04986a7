"""Whole-solver fusion: Jacobi-preconditioned CG in ONE kernel launch.

Counterpart of the JAX package's ``solvers/fused_cg.py``, which runs the
whole Krylov loop (matvec, dots, axpys, the convergence test) inside one
``pallas_call`` so that a solve costs one dispatch.  On a CUDA tensor
:func:`fused_cg_solve` launches ``csrc/fused_cg.cu`` once, a persistent
cooperative kernel that keeps every block resident and meets at grid-wide
barriers, and reads the stats buffer once; if the launch fails it raises
(there is no fallback to :func:`.cg.cg_solve`).  On a CPU tensor it runs
:func:`fused_cg_plain`, the same recurrence and stopping test in plain
PyTorch on :func:`..ops.bsg.spmv_plain`.

The contract is JAX's (``fused_cg.py:148-194`` there): a dense-layout
float32 operator, float32 vectors in its internal padded space,
``invd = where(d != 0, 1/d, 0)`` (not the Jacobi preconditioner's fill of
1 on zero diagonals), the stopping test on squared norms
``rnorm2 > tol^2 * bnorm2`` with ``bnorm2 = 1`` when ``b = 0``,
``relres = sqrt(rnorm2 / bnorm2)`` and ``converged = rnorm2 <= target2``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.bsg import BSGMatrix, spmv_plain
from .cg import CGResult

__all__ = ["fused_cg_plain", "fused_cg_solve"]


def _inverse_diagonal(A: BSGMatrix) -> torch.Tensor:
    d = A.diag
    return torch.where(d != 0, 1.0 / torch.where(d == 0, 1.0, d), 0.0)


def fused_cg_plain(A: BSGMatrix, b: torch.Tensor, x0: torch.Tensor,
                   invd: torch.Tensor, *, tol: float,
                   maxiter: int) -> CGResult:
    """The fused kernel's recurrence in plain PyTorch: Jacobi-PCG with the
    squared-norm stopping test, float32 throughout."""
    target_scale = torch.tensor(np.float32(tol * tol))
    x = x0.clone()
    r = b - spmv_plain(A, x)
    z = invd * r
    p = z
    b2 = torch.dot(b, b)
    bnorm2 = torch.where(b2 == 0, torch.ones_like(b2), b2)
    target2 = target_scale.to(b.device) * bnorm2
    rz = torch.dot(r, z)
    rnorm2 = torch.dot(r, r)
    k = 0
    while k < maxiter and bool(rnorm2 > target2):
        ap = spmv_plain(A, p)
        alpha = rz / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = invd * r
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        rnorm2 = torch.dot(r, r)
        k += 1
    return CGResult(
        x=x,
        iterations=k,
        relres=float(torch.sqrt(rnorm2 / bnorm2)),
        converged=bool(rnorm2 <= target2),
    )


def fused_cg_solve(
    A: BSGMatrix,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    tol: float = 1e-6,
    maxiter: int = 300,
) -> CGResult:
    """Solve ``A x = b`` (both in the operator's padded space) with
    Jacobi-preconditioned CG, the whole solve in one kernel launch on the
    card.  Same contract as :func:`.cg.cg_solve` with ``precond=jacobi``;
    vectors are float32."""
    if A.chunk:
        raise ValueError(
            "fused_cg_solve requires the dense sliced-ELL layout (the kernel "
            "walks each slice with one thread per row); pack with "
            "bsg_from_csr(..., layout='dense')"
        )
    if A.vals.dtype != torch.float32 or A.x_len != A.n_pad:
        raise ValueError("fused_cg_solve takes a square float32-stored "
                         "operator")
    b = b.to(torch.float32).contiguous()
    x0 = (torch.zeros_like(b) if x0 is None
          else x0.to(torch.float32).contiguous())
    if b.numel() != A.n_pad or x0.numel() != A.n_pad:
        raise ValueError(f"vectors must have the operator's {A.n_pad} rows")
    invd = _inverse_diagonal(A)
    if b.device.type == "cpu":
        return fused_cg_plain(A, b, x0, invd, tol=tol, maxiter=maxiter)
    from ..ops._kernels import fused_cg_launch

    x, stats = fused_cg_launch(A.slice_ptr, A.cols, A.vals, b, invd, x0,
                               tol, maxiter)
    k, relres, converged, _rnorm2 = stats.tolist()
    return CGResult(x=x, iterations=int(k), relres=float(relres),
                    converged=converged > 0)
