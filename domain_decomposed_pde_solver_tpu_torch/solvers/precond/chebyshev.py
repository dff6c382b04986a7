"""Chebyshev polynomial preconditioner — counterpart of the JAX package's
``solvers/precond/chebyshev.py``, with the same interval, degree and
recurrence: ``M(r) ~ A^{-1} r`` by a degree-k Chebyshev polynomial in
``D^-1 A`` over ``[lmax / eig_ratio, 1.1 * lmax]`` (x0 = 0).

:func:`estimate_lmax_dinv_a` is JAX's power method.  JAX draws its start
vector with ``jax.random.uniform(PRNGKey(seed))``; the port draws it from
an explicit ``torch.Generator`` seeded with ``seed``, so the two estimates
differ slightly (tests compare them within 2 %), or takes the start vector
as given (``q0``), which lets a test hand both packages the same one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

__all__ = [
    "ChebyshevPreconditioner",
    "chebyshev_preconditioner",
    "estimate_lmax_dinv_a",
]


def estimate_lmax_dinv_a(A: Any, iters: int = 20, seed: int = 0,
                         q0: Optional[torch.Tensor] = None,
                         dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Power-method estimate of lambda_max(D^-1 A) as a 0-d tensor in
    ``dtype`` (default: the operator's) on the operator's device (cf. the
    reference's standalone power method, ``ExodusMatrixTest.cpp:27-129``).

    ``q0``: the start vector (padded space); by default uniform [0, 1)
    from ``torch.Generator().manual_seed(seed)``.  Padding rows are zeroed
    so they never contribute."""
    dtype = dtype or A.dtype
    dev = A.device
    inv_diag = 1.0 / A.diagonal_padded(fill=1.0).to(dtype)
    if q0 is None:
        gen = torch.Generator().manual_seed(seed)
        q0 = torch.rand(A.n_pad, generator=gen, dtype=dtype)
    q = q0.to(device=dev, dtype=dtype)
    q = q * (torch.arange(A.n_pad, device=dev) < A.n_rows).to(dtype)
    for _ in range(iters):
        z = inv_diag * A.matvec(q)
        q = z / torch.clamp(torch.sqrt(torch.dot(z, z)), min=1e-30)
    z = inv_diag * A.matvec(q)
    return torch.dot(q, z)


@dataclasses.dataclass
class ChebyshevPreconditioner:
    """``M(r) ~ A^{-1} r`` via a degree-k Chebyshev polynomial in D^-1 A
    over [lmax/eig_ratio, 1.1*lmax] (classic three-term recurrence,
    x0 = 0)."""

    A: Any
    inv_diag: torch.Tensor
    lmax: torch.Tensor
    degree: int = 4
    eig_ratio: float = 30.0

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        upper = 1.1 * self.lmax
        lower = self.lmax / self.eig_ratio
        theta = 0.5 * (upper + lower)
        delta = 0.5 * (upper - lower)
        z = torch.zeros_like(r)
        d = (1.0 / theta) * (self.inv_diag * r)
        sigma = theta / delta
        rho = 1.0 / sigma
        for _ in range(self.degree):
            z = z + d
            res = self.inv_diag * (r - self.A.matvec(z))
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * res
            rho = rho_new
        return z + d


def chebyshev_preconditioner(A: Any, lmax, degree: int = 4,
                             eig_ratio: float = 30.0,
                             dtype: Optional[torch.dtype] = None
                             ) -> ChebyshevPreconditioner:
    """The preconditioner for ``A`` with ``lmax`` (a float or a 0-d
    tensor) held as a 0-d CPU tensor in ``dtype`` (default: the
    operator's): the recurrence's scalars are computed in that dtype, as in
    JAX, on the host (PyTorch takes a 0-d CPU tensor as a scalar next to
    CUDA tensors), so they cost no launches."""
    dtype = dtype or A.dtype
    if isinstance(lmax, torch.Tensor):
        lmax = lmax.to(device="cpu", dtype=dtype)
    else:
        lmax = torch.tensor(lmax, dtype=dtype)
    return ChebyshevPreconditioner(
        A=A,
        inv_diag=1.0 / A.diagonal_padded(fill=1.0),
        lmax=lmax,
        degree=degree,
        eig_ratio=eig_ratio,
    )
