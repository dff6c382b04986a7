"""Restarted GMRES — literal parity with the reference solver.

Counterpart of the JAX package's ``solvers/gmres.py``.  The reference
solves with Belos ``"GMRES"`` and right preconditioning
(``BelosMueLuSolver.cpp:101-106``).  This is GMRES(m) with modified
Gram-Schmidt Arnoldi and Givens rotations, with JAX's restart and maxiter
semantics: a restart cycle runs inner steps until the implicit residual
``|g[j+1]|`` reaches ``tol * ||b||`` or ``m`` steps are taken, the count
of inner steps is the iteration count, and the outer loop stops when the
implicit residual is below the target or ``maxiter`` is reached (checked
between cycles, so a cycle may run past ``maxiter``).  The result reports
the true residual ``||b - A x|| / ||b||``.

The Krylov basis and the vectors stay on the operator's device; the small
Hessenberg column, Givens rotations and back-substitution run on the host
in the vectors' dtype (one read of the new column per inner step, which
also serves the convergence test).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .cg import IdentityPrecond

__all__ = ["GMRESResult", "gmres_solve"]

_NP = {torch.float32: np.float32, torch.float64: np.float64}


@dataclasses.dataclass
class GMRESResult:
    x: torch.Tensor
    iterations: int  # total inner iterations
    relres: float  # true ||b - A x|| / ||b||
    converged: bool


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.dot(v, v))


def gmres_solve(
    A: Any,
    b: torch.Tensor,
    x0: torch.Tensor,
    *,
    precond: Any = None,  # right preconditioner M (callable)
    restart: int = 30,
    tol: float = 1e-14,
    maxiter: int = 300,
) -> GMRESResult:
    """Solve ``A x = b`` with right-preconditioned GMRES(m).

    ``tol`` is relative (``||r|| / ||b||``), matching Belos' scaled
    residual test for the tolerance passed at ``BelosMueLuSolver.cpp:151``.
    """
    M = precond if precond is not None else IdentityPrecond()
    dt = _NP[b.dtype]
    bnorm = dt(_norm(b).item())
    bnorm = dt(1.0) if bnorm == 0 else bnorm
    target = dt(tol) * bnorm
    x = x0
    rnorm = dt(_norm(b - A.matvec(x0)).item())
    k = 0
    while rnorm > target and k < maxiter:
        x, rnorm, j_used = _restart_cycle(A, M, b, x, restart, target, dt)
        k += j_used
    # Report the true residual, not the implicit one.
    true = dt(_norm(b - A.matvec(x)).item())
    return GMRESResult(x=x, iterations=k, relres=float(true / bnorm),
                       converged=bool(true <= target))


def _restart_cycle(A, M, b, x, m, target, dt):
    """One GMRES(m) cycle from ``x``: returns (x, |g[j_used]|, j_used)."""
    eps = np.finfo(dt).tiny
    r = b - A.matvec(x)
    beta = _norm(r)
    V = torch.zeros((m + 1, r.numel()), dtype=r.dtype, device=r.device)
    V[0] = r / torch.clamp(beta, min=eps)
    H = np.zeros((m + 1, m), dtype=dt)
    cs = np.zeros(m, dtype=dt)
    sn = np.zeros(m, dtype=dt)
    g = np.zeros(m + 1, dtype=dt)
    g[0] = beta.item()
    j_used = m
    for j in range(m):
        # w = A M v_j, then modified Gram-Schmidt against v_0..v_j.
        w = A.matvec(M(V[j]))
        col = []
        for i in range(j + 1):
            hij = torch.dot(V[i], w)
            w = w - hij * V[i]
            col.append(hij)
        wnorm = _norm(w)
        V[j + 1] = w / torch.clamp(wnorm, min=eps)
        col.append(wnorm)
        h = np.zeros(m + 1, dtype=dt)
        h[: j + 2] = torch.stack(col).cpu().numpy()
        # Apply the accumulated Givens rotations to the new column.
        for i in range(j):
            hi, hi1 = h[i], h[i + 1]
            h[i] = cs[i] * hi + sn[i] * hi1
            h[i + 1] = -sn[i] * hi + cs[i] * hi1
        # A new rotation zeroes h[j+1].
        denom = np.sqrt(h[j] ** 2 + h[j + 1] ** 2)
        c = h[j] / max(denom, eps) if denom > 0 else dt(1.0)
        s = h[j + 1] / max(denom, eps) if denom > 0 else dt(0.0)
        h[j] = c * h[j] + s * h[j + 1]
        h[j + 1] = 0.0
        cs[j], sn[j] = c, s
        g[j + 1] = -s * g[j]
        g[j] = c * g[j]
        H[:, j] = h
        if abs(g[j + 1]) <= target:
            j_used = j + 1
            break
    # Back-substitution on the j_used x j_used upper-triangular system.
    y = np.zeros(m, dtype=dt)
    for i in range(j_used - 1, -1, -1):
        hii = H[i, i]
        y[i] = (g[i] - np.dot(H[i, :], y)) / (hii if hii != 0 else dt(1.0))
    # x += M (V[:m]^T y)  (right preconditioning)
    update = torch.from_numpy(y).to(V.device) @ V[:m]
    return x + M(update), abs(g[j_used]), j_used
