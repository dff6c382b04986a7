"""Power-method eigensolver — parity with ``ExodusMatrixTest``.

Counterpart of the JAX package's ``solvers/power.py``.  The reference runs
a power iteration over any Tpetra operator (``q = z/||z||; z = A q;
lambda = q . z``, ``ExodusMatrixTest.cpp:27-129``) with the residual
``||A q - lambda q||_2`` checked every ``reportFrequency`` iterations and
defaults of 500 iterations and tolerance 1e-2 (``ExodusMatrixTest.cpp:166,
:95``).  JAX runs the loop as one ``lax.while_loop``; here it is a Python
loop that reads the device only on the check iterations, where the residual
changes (elsewhere the last one is carried, as in JAX), so the iteration
counts are JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

__all__ = ["PowerResult", "power_method"]


@dataclasses.dataclass
class PowerResult:
    eigenvalue: float
    eigenvector: torch.Tensor
    iterations: int
    residual: float
    converged: bool


def power_method(
    A,
    z0: torch.Tensor,
    *,
    maxiter: int = 500,
    tol: float = 1e-2,
    check_every: int = 50,
    dot: Callable = torch.dot,
) -> PowerResult:
    """``A``: an operator with ``.matvec(x)``; ``z0`` the start vector in
    its space.  Stops when the checked residual is at most ``tol`` (compared
    in ``z0``'s dtype) or after ``maxiter`` iterations.  ``dot`` is
    injectable, as in :func:`.cg.cg_solve` (the sharded power method)."""

    def _norm(v):
        return torch.sqrt(dot(v, v))

    tiny = torch.finfo(z0.dtype).tiny
    tol = float(torch.tensor(tol, dtype=z0.dtype))
    z = z0
    lam = torch.zeros((), dtype=z0.dtype, device=z0.device)
    res = float("inf")
    k = 0
    while res > tol and k < maxiter:
        q = z / torch.clamp_min(_norm(z), tiny)
        z = A.matvec(q)
        lam = dot(q, z)
        k += 1
        # The reference's residual check, on report iterations only
        # (``ExodusMatrixTest.cpp:95-107``).
        if k % check_every == 0:
            res = float(_norm(z - lam * q))
    q = z / torch.clamp_min(_norm(z), tiny)
    Aq = A.matvec(q)
    final = float(_norm(Aq - dot(q, Aq) * q))
    return PowerResult(
        eigenvalue=float(lam),
        eigenvector=q,
        iterations=k,
        residual=final,
        converged=final <= tol,
    )
