"""Additive-Schwarz ILU(0)/ILUT: the distributed counterpart of the
reference's production preconditioner.

Counterpart of the JAX package's ``parallel/schwarzilu.py``.  What an
``mpirun``-ed Ifpack2 ILUT does is factor each rank's LOCAL diagonal block
and apply the triangular solves with no inter-rank communication
(``BelosMueLuSolver.cpp:92-97``); the ranks couple only in the Belos
product.  So here each part's (owned x owned) block is factored on the host
with the port's ILU(0)/ILUT (:mod:`..solvers.precond.ilu`: native
factorization, level-scheduled sweeps on the device), and the per-part
preconditioners are applied each to its part (:class:`.schwarz.BlockPrecond`).
JAX pads and stacks the factors to one static shape for its SPMD program;
that padding is an exact no-op and the port keeps the list instead.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.csr import CSRMatrix
from ..solvers.precond.ilu import ilu0_preconditioner, ilut_preconditioner
from .halo import HaloPlan
from .schwarz import (
    BlockPrecond,
    _block_expansions,
    _local_diagonal_block,
    agree,
    local_parts,
)
from .sharded import DeviceMesh

__all__ = ["build_block_ilu"]


def build_block_ilu(
    A: CSRMatrix,
    plan: HaloPlan,
    dtype=torch.float32,
    kind: str = "ilut",
    fill_factor: float = 1.0,
    droptol: float = 0.0,
    device=None,
    mesh: Optional[DeviceMesh] = None,
) -> Optional[BlockPrecond]:
    """Per-part ILU(0)/ILUT preconditioners (pass as ``block_precond`` to
    :func:`.sharded.sharded_gmres_solve` or ``block_amg`` to
    :func:`.sharded.sharded_cg_solve`), applied on ``device`` (default: the
    card).

    ``kind``: ``"ilut"`` (the reference's Ifpack2 defaults: level-of-fill
    1.0, drop tolerance 0, ``BelosMueLuSolver.cpp:92-97``) or ``"ilu0"``.
    Returns ``None`` when a part's block hits a zero pivot (the caller falls
    back to Jacobi).  Over a ``mesh`` of several processes each factors its
    own parts, and a zero pivot in any process gives ``None`` in all (the
    reference's per-rank ILUT under ``mpirun``)."""
    if kind not in ("ilut", "ilu0"):
        raise ValueError(f"unknown ILU kind: {kind!r}")
    rows, pr, pc = _block_expansions(A, plan)
    parts = []
    pivot = False
    for p in local_parts(plan, mesh):
        local = _local_diagonal_block(A, plan, p, rows, pr, pc)
        try:
            if kind == "ilut":
                m = ilut_preconditioner(
                    local, n_pad=plan.n_local, dtype=dtype,
                    fill_factor=fill_factor, droptol=droptol, device=device,
                )
            else:
                m = ilu0_preconditioner(local, n_pad=plan.n_local,
                                        dtype=dtype, device=device)
        except ZeroDivisionError:
            pivot = True
            break
        parts.append(m)
    if agree(pivot, mesh):
        return None
    return BlockPrecond(parts=parts)
