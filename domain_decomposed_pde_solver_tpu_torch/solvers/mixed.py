"""Mixed-precision solve: f32 Krylov sweeps with f64 iterative refinement.

Counterpart of the JAX package's ``solvers/mixed.py``.  Classical iterative
refinement reaches f64 accuracy with an f32 inner solver:

    repeat:  r = b - A x        (f64)
             solve A d ~= r     (f32 CG, loose tolerance)
             x := x + d         (f64 accumulation)

Each sweep contracts the error by about the inner solve's tolerance until
the f64 residual floor.  With a lattice-stencil operator whose assembled
entries are f32-exact, the f64 residual runs on the device through the
operator's dtype-generic product (the pad-stencil kernel's double
instantiation on the card); otherwise on the host CSR.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..ops.csr import CSRMatrix
from ..ops.dia import choose_operator
from ..utils.timers import host_value, span, spanned
from .cg import cg_solve
from .precond.jacobi import DiagonalPreconditioner

__all__ = ["MixedSolveResult", "iterative_refinement_solve"]


def _f32_exact(A: CSRMatrix) -> bool:
    """True iff every CSR entry round-trips f64 -> f32 -> f64 exactly (so
    the f32-stored operator is the f64 operator); memoized on ``A``."""
    cached = getattr(A, "_f32_exact_cache", None)
    if cached is None:
        cached = bool(
            np.all(A.data.astype(np.float32).astype(np.float64) == A.data)
        )
        A._f32_exact_cache = cached
    return cached


def _stencil_like(A32) -> bool:
    from ..ops.stencil import StencilOperator
    from ..ops.stencil_kernel import PadStencilOperator

    return isinstance(A32, (StencilOperator, PadStencilOperator))


def _matvec_f64(A32, x64: torch.Tensor) -> torch.Tensor:
    """f64 product through a (pad-)stencil operator's dtype-generic path:
    its f32-stored coefficients are upcast and summed in double, which is
    the exact f64 operator when the assembled entries are f32-exact (gated
    by the caller).  On the card a pad-stencil operator runs its kernel's
    double instantiation."""
    return A32.matvec(x64)


def _refine_sweep(A32, M, b64, x64, r64, *, inner_tol, inner_maxiter):
    """One refinement sweep on the device: scaled f32 inner CG on the
    current f64 residual, f64 update, new f64 residual (one f64 product).
    Returns (x_new, r_new, ||r_new||, inner iterations)."""
    rnorm = torch.sqrt(torch.dot(r64, r64))
    rnorm = torch.where(rnorm == 0, torch.ones_like(rnorm), rnorm)
    r32 = (r64 / rnorm).to(torch.float32)
    res = cg_solve(
        A32, r32, torch.zeros_like(r32), precond=M,
        tol=inner_tol, maxiter=inner_maxiter,
    )
    x_new = x64 + res.x.to(torch.float64) * rnorm
    rn = b64 - _matvec_f64(A32, x_new)
    return x_new, rn, torch.sqrt(torch.dot(rn, rn)), res.iterations


def _adaptive_inner_tol(inner_tol: float, tol: float, relres: float) -> float:
    """Inner CG tolerance for the next sweep: one sweep contracts the outer
    residual by about the inner solve's achieved tolerance, so the last
    sweep needs only ``~tol/relres`` (with a 4x margin); early sweeps keep
    ``inner_tol``."""
    gap = 0.25 * tol / max(relres, 1e-300)
    return float(min(0.5, max(inner_tol, gap)))


@dataclasses.dataclass
class MixedSolveResult:
    x: np.ndarray  # f64 solution
    refinements: int
    inner_iterations: int
    relres: float  # f64 relative residual
    converged: bool
    # Device path only: {"stage_ms", "sweeps_ms", "fetch_ms"} — staging of
    # b and x0, the sweep loop (the solve), the answer's copy to the host:
    # the durations of the spans refine.stage, refine.sweeps, refine.fetch.
    timings: Optional[dict] = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _refine_device(
    A32, b, x0, bnorm, M, *, tol, inner_tol, inner_maxiter, max_refinements,
    b_device=None,
) -> MixedSolveResult:
    """Device-resident refinement loop: one host read (the residual norm)
    per sweep; ``b_device`` lets callers stage the right-hand side once.
    ``x0`` (None: zero) is staged as it is, never written to."""
    dev = A32.device
    with span("refine.stage") as stage:
        b64 = (
            b_device.to(torch.float64)
            if b_device is not None
            else A32.put_vector(b, dtype=torch.float64)
        )
        if x0 is None:
            x64 = torch.zeros(A32.n_pad, dtype=torch.float64, device=dev)
            r64 = b64  # r0 = b exactly
            relres = 1.0
        else:
            x64 = A32.put_vector(x0, dtype=torch.float64)
            r64 = b64 - _matvec_f64(A32, x64)
            relres = host_value(torch.sqrt(torch.dot(r64, r64))) / bnorm
        _sync(dev)
    with span("refine.sweeps") as sweeps:
        inner_total = 0
        refinements = 0
        while relres > tol and refinements < max_refinements:
            x_new, r_new, rnorm_new, iters = _refine_sweep(
                A32, M, b64, x64, r64,
                inner_tol=_adaptive_inner_tol(inner_tol, tol, relres),
                inner_maxiter=inner_maxiter,
            )
            # The host read is the sync point.
            new_relres = host_value(rnorm_new) / bnorm
            inner_total += int(iters)
            refinements += 1
            if new_relres >= relres:  # stagnation at the f32 floor
                break
            x64, r64, relres = x_new, r_new, new_relres
    with span("refine.fetch") as fetch:
        x_host = np.asarray(A32.get_vector(x64), dtype=np.float64)
    return MixedSolveResult(
        x=x_host,
        refinements=refinements,
        inner_iterations=inner_total,
        relres=relres,
        converged=relres <= tol,
        timings={
            "stage_ms": stage.ms,
            "sweeps_ms": sweeps.ms,
            "fetch_ms": fetch.ms,
        },
    )


@spanned("refine")
def iterative_refinement_solve(
    A: CSRMatrix,
    b: np.ndarray,
    x0: Optional[np.ndarray] = None,
    *,
    tol: float = 1e-10,
    inner_tol: float = 1e-6,
    inner_maxiter: int = 1000,
    max_refinements: int = 20,
    precond: Any = "jacobi",
    operator=None,
    device_residual: Any = "auto",
    b_device=None,
    device=None,
) -> MixedSolveResult:
    """Solve ``A x = b`` to f64 accuracy with an f32 device solver.

    ``A``/``b`` are host f64; the f32 operator is ``operator`` or
    ``choose_operator(A, float32, device=device)`` (``device`` defaults to
    the card).  ``precond``: ``"jacobi"`` | None | a callable built by the
    caller in the operator's space.

    ``device_residual="auto"`` runs the f64 residual on the device when the
    operator is a (pad-)stencil operator and the CSR entries are f32-exact
    (JAX also requires x64; PyTorch has f64 always); otherwise the residual
    is a host CSR product with a vector upload and download per sweep.
    ``b_device``: an optional staged padded device right-hand side (device
    path only)."""
    n = A.n_rows
    b = np.asarray(b, dtype=np.float64)
    bnorm = float(np.linalg.norm(b)) or 1.0

    A32 = (operator if operator is not None
           else choose_operator(A, dtype=torch.float32, device=device))
    if precond == "jacobi":
        M = DiagonalPreconditioner(1.0 / A32.diagonal_padded(fill=1.0))
    else:
        M = precond

    if device_residual == "auto":
        device_residual = _stencil_like(A32) and _f32_exact(A)
    if device_residual:
        return _refine_device(
            A32, b, x0, bnorm, M,
            tol=tol, inner_tol=inner_tol, inner_maxiter=inner_maxiter,
            max_refinements=max_refinements, b_device=b_device,
        )

    # The host loop returns its iterate: a copy, never the caller's x0.
    x = np.zeros(n) if x0 is None else np.array(x0, dtype=np.float64)
    inner_total = 0
    refinements = 0
    relres = float(np.linalg.norm(b - A.matvec(x))) / bnorm
    while relres > tol and refinements < max_refinements:
        r = b - A.matvec(x)  # f64 residual on the host
        rnorm = float(np.linalg.norm(r)) or 1.0
        r32 = A32.put_vector((r / rnorm).astype(np.float32),
                             dtype=torch.float32)
        res = cg_solve(
            A32, r32, torch.zeros_like(r32), precond=M,
            tol=_adaptive_inner_tol(inner_tol, tol, relres),
            maxiter=inner_maxiter,
        )
        d = A32.get_vector(res.x).astype(np.float64) * rnorm
        x = x + d
        inner_total += int(res.iterations)
        refinements += 1
        new_relres = float(np.linalg.norm(b - A.matvec(x))) / bnorm
        if new_relres >= relres:  # stagnation at the f32 floor
            x = x - d  # keep the better iterate
            break
        relres = new_relres
    return MixedSolveResult(
        x=x,
        refinements=refinements,
        inner_iterations=inner_total,
        relres=relres,
        converged=relres <= tol,
    )
