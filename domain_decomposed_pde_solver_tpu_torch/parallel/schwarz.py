"""Block-Schwarz AMG: per-part AMG preconditioning for partitioned solves.

Counterpart of the JAX package's ``parallel/schwarz.py``.  Additive Schwarz
without overlap: each part applies a full SA-AMG V-cycle to its *local
diagonal block* (off-part couplings dropped), so the preconditioner needs
no communication; only the CG products and dots exchange.  Convergence sits
between Jacobi and global AMG; the two-level variant
(:func:`build_coarse_correction` + :class:`TwoLevelPrecond`) adds a global
partition-constant coarse solve.

JAX pads every part's hierarchy to common per-level shapes and stacks them
with a leading part axis, only so that one SPMD program fits every device
(padding slots are exact no-ops: zero rows, unit diagonals).  The port keeps
a list of per-part hierarchies (:class:`BlockPrecond`) and applies each to
its part.  What changes the algebra is kept: every part is built with
explicit ELL levels (``operator_format="ell"``,
``factored_transfers=False``), rebuilt to the common depth of the
shallowest part, and a part whose coarse solve is the diagonal fallback
makes the whole build return ``None`` (the caller falls back to Jacobi).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from ..ops.csr import CSRMatrix, coo_to_csr
from ..solvers.precond.amg import AMGPreconditioner, smoothed_aggregation_setup
from ..utils.device import resolve_device
from .halo import HaloPlan
from .sharded import DeviceMesh, part_sums

__all__ = [
    "BlockPrecond",
    "TwoLevelPrecond",
    "build_block_amg",
    "build_coarse_correction",
]


@dataclasses.dataclass
class BlockPrecond:
    """One preconditioner per part, each applied to its part's rows of a
    ``(P, n_local)`` residual (over a process mesh, one per local part of
    a ``(k, n_local)`` one), with no communication."""

    parts: List[Callable]

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        if r.shape[0] != len(self.parts):
            raise ValueError(f"a residual of {r.shape[0]} parts for "
                             f"{len(self.parts)} part preconditioners")
        return torch.stack([m(r[p]) for p, m in enumerate(self.parts)])


def local_parts(plan: HaloPlan, mesh: Optional[DeviceMesh]) -> range:
    """The part ids a per-part build covers: the mesh's local parts, or
    all of the plan's without a mesh."""
    if mesh is None:
        return range(plan.nparts)
    return range(mesh.parts_lo, mesh.parts_lo + mesh.local_parts)


def agree(value: int, mesh: Optional[DeviceMesh]) -> int:
    """The largest of every process's ``value`` over ``mesh`` (``value``
    without one): a build's decision every process takes alike."""
    return int(value) if mesh is None else mesh.max(value)


def build_coarse_correction(A: CSRMatrix, plan: HaloPlan,
                            device=None) -> torch.Tensor:
    """Nicolaides coarse space: one constant basis vector per part.

    Returns ``inv(Z^T A Z)`` as a dense ``(P, P)`` float64 tensor on
    ``device`` (default: the card), where Z's p-th column is the indicator
    of part p: the global coupling that block-Schwarz drops."""
    P_ = plan.nparts
    rows = np.repeat(np.arange(A.n_rows), A.row_lengths())
    pr = plan.part_of_row[rows].astype(np.int64)
    pc = plan.part_of_row[A.indices].astype(np.int64)
    Ac = np.zeros((P_, P_))
    np.add.at(Ac, (pr, pc), A.data)
    # The reduced system has boundary mass, so Ac is SPD; regularize
    # defensively for the full Laplacian (rows summing to zero).
    Ac += 1e-12 * np.trace(Ac) / P_ * np.eye(P_)
    return torch.from_numpy(np.linalg.inv(Ac)).to(resolve_device(device))


@dataclasses.dataclass
class TwoLevelPrecond:
    """Block-Schwarz local cycle + global partition-constant coarse solve:
    ``M(r) = M_local(r) + Z (Z^T A Z)^{-1} Z^T r``.  The coarse term is the
    parts' residual sums (JAX's ``all_gather`` of P scalars) and a
    ``(P, P)`` product; ``valid`` masks real rows against padding.  Over
    a ``mesh`` of several processes ``valid`` and the residual hold the
    local parts, and every process gathers all P sums."""

    local: Callable
    Ac_inv: torch.Tensor  # (P, P)
    valid: torch.Tensor  # (P, n_local) bool
    mesh: Optional[DeviceMesh] = None

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        x = self.local(r)
        rbars = part_sums(r * self.valid, self.mesh)  # (P,)
        coef = torch.mv(self.Ac_inv.to(r.dtype), rbars)
        if self.mesh is not None:
            coef = self.mesh.local(coef)
        return x + coef[:, None] * self.valid


def _local_diagonal_block(
    A: CSRMatrix, plan: HaloPlan, p: int, rows: np.ndarray,
    pr: np.ndarray, pc: np.ndarray,
) -> CSRMatrix:
    """Part p's rows/cols of A in part-local ordering (off-part entries
    dropped), sized to the uniform padded local width ``plan.n_local``.
    ``rows``/``pr``/``pc`` are the O(nnz) expansions, computed once by the
    caller."""
    keep = (pr == p) & (pc == p)
    lr = plan.local_of_row[rows[keep]]
    lc = plan.local_of_row[A.indices[keep]]
    # Padding rows get a unit diagonal so the block stays nonsingular; the
    # residual there is always zero, so this is a no-op in the cycle.
    n_real = int((plan.part_of_row == p).sum())
    pad_rows = np.arange(n_real, plan.n_local, dtype=np.int64)
    lr = np.concatenate([lr, pad_rows])
    lc = np.concatenate([lc, pad_rows])
    data = np.concatenate([A.data[keep], np.ones(pad_rows.size)])
    return coo_to_csr(
        lr, lc, data, (plan.n_local, plan.n_local), sum_dups=False
    )


def _block_expansions(A: CSRMatrix, plan: HaloPlan):
    rows = np.repeat(np.arange(A.n_rows), A.row_lengths())
    return rows, plan.part_of_row[rows], plan.part_of_row[A.indices]


def build_block_amg(
    A: CSRMatrix,
    plan: HaloPlan,
    dtype=torch.float32,
    max_levels: int = 4,
    coarse_size: int = 64,
    device=None,
    mesh: Optional[DeviceMesh] = None,
    **amg_kwargs,
) -> Optional[BlockPrecond]:
    """The per-part AMG hierarchies as a :class:`BlockPrecond` (pass it as
    ``block_amg`` to :func:`.sharded.sharded_cg_solve`), on ``device``
    (default: the card); over a ``mesh`` of several processes, this
    process's parts', the common depth and the outcome agreed across the
    processes.  Returns ``None`` if a uniform structure could not be built
    (the caller falls back to Jacobi), as JAX does.  ``amg_kwargs`` go to
    every part's set-up (``smoother="jacobi"`` among them), so each part's
    hierarchy smooths as it says; the V-cycles per apply are each part
    preconditioner's ``cycles`` field, as they are the stacked one's in
    JAX."""
    rows, pr, pc = _block_expansions(A, plan)
    mine = local_parts(plan, mesh)

    def setup(p, levels):
        local = _local_diagonal_block(A, plan, p, rows, pr, pc)
        return smoothed_aggregation_setup(
            local, dtype=dtype, max_levels=levels, coarse_size=coarse_size,
            factored_transfers=False, operator_format="ell", device=device,
            **amg_kwargs,
        )

    parts_M: List[AMGPreconditioner] = [setup(p, max_levels) for p in mine]
    n_levels = -agree(-min(len(m.levels) for m in parts_M), mesh)
    if n_levels == 0:
        return None
    # Rebuild any deeper hierarchies at the common depth.
    uneven = False
    for i, m in enumerate(parts_M):
        if len(m.levels) != n_levels:
            parts_M[i] = setup(mine[i], n_levels + 1)
            uneven = uneven or len(parts_M[i].levels) != n_levels
    # Mixed dense/diagonal coarse solves: bail to Jacobi.
    mixed = any(m.coarse_inv.dim() != 2 for m in parts_M)
    if agree(uneven or mixed, mesh):
        return None
    return BlockPrecond(parts=parts_M)
