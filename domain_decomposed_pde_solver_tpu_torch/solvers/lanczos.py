"""Lanczos spectral estimation (lambda_min, lambda_max, condition number).

Counterpart of the JAX package's ``solvers/lanczos.py``.  The reference
ships a power method (``ExodusMatrixTest.cpp:27-129``), which converges
slowly when eigenvalues cluster.  Lanczos gives both ends of the spectrum
in a few dozen products: k steps with full reorthogonalization (the basis
``V`` is ``(k + 1, n_pad)`` on the operator's device: at 1M DOF and k = 40
in float64, 331 MB), then the k x k tridiagonal eigenproblem on the host.
The reorthogonalization is a dense product, ``w -= V[:j+1]^T (V[:j+1] w)``,
which JAX too computes outside any kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

__all__ = ["LanczosResult", "lanczos_extremes"]


@dataclasses.dataclass
class LanczosResult:
    lmin: float  # smallest Ritz value (upper bound on lambda_min)
    lmax: float  # largest Ritz value (lower bound on lambda_max)
    ritz_values: np.ndarray  # (k,) the full Ritz spectrum, ascending

    @property
    def condition(self) -> float:
        return self.lmax / self.lmin


def _tridiagonal(alphas: np.ndarray, betas: np.ndarray) -> np.ndarray:
    """JAX's T with its breakdown mask.  A tiny beta_j means the Krylov
    space became invariant at step j: every later alpha and beta is noise
    from a re-normalized near-zero vector and would add spurious Ritz
    values (lmin = 0, say).  Steps after the first tiny beta get the
    diagonal alphas[0], a Rayleigh quotient inside the captured Ritz
    interval, so the extremes are unchanged, and zero off-diagonals."""
    k = alphas.size
    scale = np.abs(alphas).max() + betas.max()
    tiny = np.finfo(alphas.dtype).eps * max(scale, 1.0)
    brk = betas <= tiny  # breakdown at step j
    # valid[j]: no breakdown strictly before step j.
    valid = np.concatenate([[True], np.cumsum(brk[:-1]) == 0])
    diag = np.where(valid, alphas, alphas[0])
    off = np.where(valid[1:] & ~brk[: k - 1], betas[: k - 1], 0.0)
    return np.diag(diag) + np.diag(off, 1) + np.diag(off, -1)


def lanczos_extremes(A: Any, z0: torch.Tensor, *, k: int = 40) -> LanczosResult:
    """k-step Lanczos with full reorthogonalization on operator ``A``.

    ``z0`` should be random and must be zero on padding slots, so the
    recurrence stays in the logical subspace."""
    n = z0.shape[0]
    tiny = torch.finfo(z0.dtype).tiny
    V = torch.zeros((k + 1, n), dtype=z0.dtype, device=z0.device)
    V[0] = z0 / torch.clamp_min(torch.sqrt(torch.dot(z0, z0)), tiny)
    alphas = torch.zeros(k, dtype=z0.dtype, device=z0.device)
    betas = torch.zeros(k, dtype=z0.dtype, device=z0.device)
    for j in range(k):
        v = V[j]
        w = A.matvec(v)
        alpha = torch.dot(v, w)
        w = w - alpha * v
        if j > 0:
            w = w - betas[j - 1] * V[j - 1]
        B = V[: j + 1]
        w = w - B.T @ (B @ w)
        beta = torch.sqrt(torch.dot(w, w))
        V[j + 1] = w / torch.clamp_min(beta, tiny)
        alphas[j] = alpha
        betas[j] = beta
    T = _tridiagonal(alphas.cpu().numpy(), betas.cpu().numpy())
    ritz = np.linalg.eigvalsh(T)
    return LanczosResult(lmin=float(ritz[0]), lmax=float(ritz[-1]),
                         ritz_values=ritz)
