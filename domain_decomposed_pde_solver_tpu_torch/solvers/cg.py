"""Preconditioned conjugate gradient on PyTorch tensors.

Counterpart of the JAX package's ``solvers/cg.py``: the same recurrence,
stopping rule (``||r|| <= tol * ||b||``, compared in the vectors' dtype) and
result record.  JAX runs the loop as one ``lax.while_loop`` program; here it
is a Python loop that reads one boolean from the device per iteration (the
stopping test).  Capturing the loop in a CUDA graph is later work.

Operators are objects with ``.matvec(x)``; preconditioners are callables.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

__all__ = [
    "CGResult",
    "IdentityPrecond",
    "cg_solve",
    "cg_solve_snapshots",
    "cg_solve_with_state",
]


class IdentityPrecond:
    """No-op preconditioner."""

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return r


@dataclasses.dataclass
class CGResult:
    x: torch.Tensor
    iterations: int
    relres: float  # achieved ||r|| / ||b||
    converged: bool


def cg_solve(
    A: Any,
    b: torch.Tensor,
    x0: torch.Tensor,
    *,
    precond: Any = None,
    tol: float = 1e-14,
    maxiter: int = 300,
) -> CGResult:
    """Solve ``A x = b`` with (preconditioned) CG; ``tol`` is relative to
    ``||b||``."""
    result, _ = cg_solve_with_state(
        A, b, x0, precond=precond, tol=tol, maxiter=maxiter
    )
    return result


def cg_solve_with_state(
    A: Any,
    b: torch.Tensor,
    x0: torch.Tensor,
    *,
    state: Any = None,
    precond: Any = None,
    tol: float = 1e-14,
    maxiter: int = 300,
):
    """Like :func:`cg_solve` but returns ``(result, (r, p, rz))`` and can
    resume from a prior state exactly."""
    M = precond if precond is not None else IdentityPrecond()
    bnorm = torch.sqrt(torch.dot(b, b))
    bnorm = torch.where(bnorm == 0, torch.ones_like(bnorm), bnorm)
    target = torch.as_tensor(tol, dtype=b.dtype, device=b.device) * bnorm

    if state is None:
        r = b - A.matvec(x0)
        z = M(r)
        p = z
        rz = torch.dot(r, z)
    else:
        r, p, rz = state
    x = x0
    rnorm = torch.sqrt(torch.dot(r, r))
    k = 0
    while k < maxiter and bool(rnorm > target):
        Ap = A.matvec(p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = torch.dot(r, z)
        p = z + rz_new / rz * p
        rz = rz_new
        rnorm = torch.sqrt(torch.dot(r, r))
        k += 1
    return (
        CGResult(
            x=x,
            iterations=k,
            relres=float(rnorm / bnorm),
            converged=bool(rnorm <= target),
        ),
        (r, p, rz),
    )


def cg_solve_snapshots(
    A: Any,
    b: torch.Tensor,
    x0: torch.Tensor,
    *,
    precond: Any = None,
    tol: float = 1e-14,
    maxiter: int = 300,
    callback: Optional[Callable[[int, torch.Tensor, float], None]] = None,
) -> CGResult:
    """CG with a host callback after every iteration, ``callback(k, x,
    relres)``: the reference's per-iteration solution snapshots
    (``BelosMueLuSolver.cpp:112-133``) on one continuous Krylov
    recurrence.  The stopping test is JAX's: ``||r|| / ||b|| > tol`` on
    host floats."""
    M = precond if precond is not None else IdentityPrecond()
    bnorm = float(torch.sqrt(torch.dot(b, b)))
    bnorm = bnorm if bnorm != 0 else 1.0
    r = b - A.matvec(x0)
    z = M(r)
    p = z
    rz = torch.dot(r, z)
    x = x0
    rnorm = float(torch.sqrt(torch.dot(r, r)))
    k = 0
    while rnorm / bnorm > tol and k < maxiter:
        Ap = A.matvec(p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = torch.dot(r, z)
        p = z + rz_new / rz * p
        rz = rz_new
        rnorm = float(torch.sqrt(torch.dot(r, r)))
        k += 1
        if callback is not None:
            callback(k, x, rnorm / bnorm)
    return CGResult(
        x=x,
        iterations=k,
        relres=rnorm / bnorm,
        converged=rnorm / bnorm <= tol,
    )
