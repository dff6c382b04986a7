"""The Chebyshev smoother of the V-cycle — counterpart of the JAX package's
``solvers/precond/cheby.py``, with the same interval and recurrence.

Chebyshev(1) iteration over ``[lmax/4, 1.1*lmax]`` of ``D^-1 A``.  ``lmax``
is a 0-d tensor in the working dtype (a CPU tensor is fine: PyTorch treats
a 0-d CPU tensor as a scalar next to CUDA tensors), so the scalar
coefficients are computed in that dtype, as JAX computes them.
"""

from __future__ import annotations

__all__ = ["chebyshev_smooth"]


def chebyshev_smooth(matvec, inv_diag, lmax, smooth_steps, x, b,
                     x_zero: bool = False):
    """Return the Chebyshev-smoothed iterate for ``A x = b``.

    ``x_zero``: the pre-smooth starts from x = 0, so the first residual is
    ``b`` and one SpMV per level per V-cycle is skipped (bit-identical).
    """
    upper = 1.1 * lmax
    lower = lmax / 4.0
    theta = 0.5 * (upper + lower)
    delta = 0.5 * (upper - lower)
    r0 = b if x_zero else b - matvec(x)
    d = (1.0 / theta) * (inv_diag * r0)
    sigma = theta / delta
    rho = 1.0 / sigma
    for _ in range(smooth_steps):
        x = x + d
        res = inv_diag * (b - matvec(x))
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * res
        rho = rho_new
    return x + d
