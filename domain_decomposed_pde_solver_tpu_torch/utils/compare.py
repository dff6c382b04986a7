"""Preconditioner comparison harness — the ILUT parity story.

Counterpart of the JAX package's ``utils/compare.py``.  The reference
preconditions GMRES with Ifpack2 ILUT (``BelosMueLuSolver.cpp:92-97``).
This harness gives iteration counts of scipy's GMRES(30) to a fixed
tolerance under scipy's ILU (a superset of ILUT, via SuperLU), Jacobi and
the port's SA-AMG on the same operator, and with a halo plan the
additive-Schwarz per-part ILUT of the partitioned solvers.  GMRES runs on
the host; the AMG and Schwarz applies run on ``device``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..ops.csr import CSRMatrix

__all__ = ["compare_preconditioners"]


def _count_iters_scipy(A, b, M=None, tol=1e-10, maxiter=2000, restart=30):
    """GMRES(30) iteration count — the reference's solver
    (``BelosMueLuSolver.cpp:105-106``); valid for nonsymmetric
    preconditioners like ILU, where CG would break."""
    import scipy.sparse.linalg as spla

    count = {"n": 0}

    def cb(rk):
        count["n"] += 1

    x, info = spla.gmres(
        A, b, rtol=tol, maxiter=maxiter, M=M, restart=restart,
        callback=cb, callback_type="pr_norm",
    )
    return count["n"], info == 0


def compare_preconditioners(
    A: CSRMatrix, b: np.ndarray, tol: float = 1e-10, maxiter: int = 2000,
    plan=None, device=None,
) -> Dict[str, dict]:
    """Iteration counts of GMRES(30) under each preconditioner (f64).

    Returns ``{name: {"iterations": k, "converged": bool}}`` for
    none / jacobi / ilut (scipy SuperLU ILU ~ Ifpack2 ILUT) / amg, plus —
    when a :class:`..parallel.halo.HaloPlan` is passed as ``plan`` — a
    ``schwarz_ilut`` row: the per-part ILUT of
    :func:`..parallel.schwarzilu.build_block_ilu`, what the reference's
    per-rank Ifpack2 ILUT does under ``mpirun -n P``
    (``BelosMueLuSolver.cpp:92-97``).  ``device``: where the AMG and
    Schwarz applies run (default: the card)."""
    import scipy.sparse.linalg as spla
    import torch

    from ..utils.device import resolve_device

    dev = resolve_device(device)
    S = A.to_scipy().tocsc()
    n = A.n_rows
    out: Dict[str, dict] = {}

    k, ok = _count_iters_scipy(S, b, tol=tol, maxiter=maxiter)
    out["none"] = {"iterations": k, "converged": ok}

    d = S.diagonal()
    Mj = spla.LinearOperator((n, n), matvec=lambda v: v / d)
    k, ok = _count_iters_scipy(S, b, M=Mj, tol=tol, maxiter=maxiter)
    out["jacobi"] = {"iterations": k, "converged": ok}

    try:
        ilu = spla.spilu(S, drop_tol=1e-4, fill_factor=10)
        Mi = spla.LinearOperator((n, n), matvec=ilu.solve)
        k, ok = _count_iters_scipy(S, b, M=Mi, tol=tol, maxiter=maxiter)
        out["ilut"] = {"iterations": k, "converged": ok}
    except RuntimeError as e:  # singular factor etc.
        out["ilut"] = {"iterations": -1, "converged": False, "error": str(e)}

    from ..solvers.precond.amg import smoothed_aggregation_setup

    M_amg = smoothed_aggregation_setup(A, dtype=torch.float64, device=dev)
    n_pad = M_amg.levels[0].A.n_pad if M_amg.levels else n

    def amg_mv(v):
        vp = torch.zeros(n_pad, dtype=torch.float64)
        vp[:n] = torch.from_numpy(np.ravel(v).astype(np.float64))
        return M_amg(vp.to(dev))[:n].cpu().numpy()

    Ma = spla.LinearOperator((n, n), matvec=amg_mv)
    k, ok = _count_iters_scipy(S, b, M=Ma, tol=tol, maxiter=maxiter)
    out["amg"] = {"iterations": k, "converged": ok}

    if plan is not None:
        from ..parallel.schwarzilu import build_block_ilu

        Ms = build_block_ilu(A, plan, dtype=torch.float64, device=dev)
        if Ms is None:
            out["schwarz_ilut"] = {
                "iterations": -1, "converged": False, "error": "zero pivot"
            }
        else:
            def schwarz_mv(v):
                rp = plan.scatter_vector(np.ravel(v).astype(np.float64))
                z = Ms(torch.from_numpy(rp).to(dev))
                return plan.gather_vector(z.cpu().numpy())

            Msl = spla.LinearOperator((n, n), matvec=schwarz_mv)
            k, ok = _count_iters_scipy(S, b, M=Msl, tol=tol, maxiter=maxiter)
            out["schwarz_ilut"] = {
                "iterations": k, "converged": ok, "nparts": plan.nparts
            }
    return out
