"""BiCGStab — counterpart of the JAX package's ``solvers/bicgstab.py``.

Rounds out the Krylov family (the reference's Belos factory exposes
BiCGStab beside GMRES and CG; its executable only ever builds "GMRES",
``BelosMueLuSolver.cpp:105-106``).  Right-preconditioned, with JAX's
recurrence, guards against zero denominators and stopping test
(``||r|| > tol * ||b||`` checked before every iteration).  A Python loop
that reads one boolean from the device per iteration, like :mod:`.cg`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .cg import IdentityPrecond

__all__ = ["BiCGStabResult", "bicgstab_solve"]


@dataclasses.dataclass
class BiCGStabResult:
    x: torch.Tensor
    iterations: int
    relres: float
    converged: bool


def bicgstab_solve(
    A: Any,
    b: torch.Tensor,
    x0: torch.Tensor,
    *,
    precond: Any = None,  # right preconditioner
    tol: float = 1e-14,
    maxiter: int = 300,
) -> BiCGStabResult:
    """Right-preconditioned BiCGStab; ``tol`` is relative
    ``||r|| / ||b||``."""
    M = precond if precond is not None else IdentityPrecond()
    eps = torch.finfo(b.dtype).tiny
    bnorm = torch.sqrt(torch.dot(b, b))
    bnorm = torch.where(bnorm == 0, torch.ones_like(bnorm), bnorm)
    target = tol * bnorm

    def nonzero(v):
        return torch.where(v == 0, eps, v)

    r = b - A.matvec(x0)
    rhat = r  # shadow residual
    x = x0
    p = v = torch.zeros_like(b)
    rho = alpha = omega = torch.ones((), dtype=b.dtype, device=b.device)
    k = 0
    while k < maxiter and bool(torch.sqrt(torch.dot(r, r)) > target):
        rho_new = torch.dot(rhat, r)
        beta = (rho_new / nonzero(rho)) * (alpha / nonzero(omega))
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = A.matvec(phat)
        alpha = rho_new / nonzero(torch.dot(rhat, v))
        s = r - alpha * v
        shat = M(s)
        t = A.matvec(shat)
        tt = torch.dot(t, t)
        omega = torch.where(tt == 0, 0.0, torch.dot(t, s) / nonzero(tt))
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        k += 1
    rnorm = torch.sqrt(torch.dot(r, r))
    return BiCGStabResult(x=x, iterations=k, relres=float(rnorm / bnorm),
                          converged=bool(rnorm <= target))
