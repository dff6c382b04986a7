"""Global SA-AMG over a general halo partition.

Counterpart of the JAX package's ``parallel/haloamg.py``: the
preconditioner applies the GLOBAL greedy-aggregation hierarchy over an
arbitrary graph partition, so CG iteration counts do not depend on the part
count — the single-device hierarchy's algebra laid out over the parts.

- **Fine level partitioned**: the smoothing products are the operator's
  halo-exchange product (ELL or sliced-ELL local blocks).
- **Factored transfers with a psum restriction**: ``P = (I - s D^-1 A) T``
  in factored form; the tentative half of ``R`` is a per-part segment sum
  into the GLOBAL coarse numbering followed by one :func:`.sharded.psum`
  of the coarse vectors (the only collective besides the halo exchange),
  and ``P``'s a gather back.
- **Coarse tail replicated**: levels 1 and below are the port's
  single-device levels (sliced-ELL or DIA kernels on the card); JAX runs a
  copy on every device, the port's one device runs it once.

Setup reuses :func:`..solvers.precond.amg.smoothed_aggregation_setup` with
its ``level_info_out`` hook, so the hierarchy is the single-device one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.csr import CSRMatrix
from ..solvers.cg import cg_solve
from ..solvers.precond.amg import AMGPreconditioner, smoothed_aggregation_setup
from ..solvers.precond.cheby import chebyshev_smooth
from .halo import HaloPlan
from .sharded import psum

__all__ = ["HaloAMG", "build_halo_amg", "halo_amg_cg_solve"]


@dataclasses.dataclass
class HaloAMG:
    """Host-side bundle: per-part level-0 pieces + the coarse tail."""

    plan: HaloPlan
    agg: np.ndarray  # (P, n_local) int32 — global coarse id per local row
    tval: np.ndarray  # (P, n_local) float32
    scale: np.ndarray  # (P, n_local) float32
    inv_diag: np.ndarray  # (P, n_local) float32
    lmax: float
    smooth_steps: int
    tail: AMGPreconditioner
    n_c: int
    n_pad_c: int


@dataclasses.dataclass
class _HaloAMGBlock:
    """The preconditioner's apply over ``(P, n_local)`` vectors."""

    A: object  # partitioned operator (.matvec)
    flat_agg: torch.Tensor  # (P*n_local,) int64: p*n_pad_c + coarse id
    agg: torch.Tensor  # (P, n_local) int64 global coarse ids (0 on padding)
    tval: torch.Tensor  # (P, n_local) tentative weight (0 on padding)
    scale: torch.Tensor  # (P, n_local) omega/lmax/diag (0 on padding)
    inv_diag: torch.Tensor  # (P, n_local)
    lmax: torch.Tensor  # 0-d float32 CPU tensor
    tail: AMGPreconditioner
    mask: torch.Tensor  # (n_pad_c,) bool: real coarse rows
    n_pad_c: int
    smooth_steps: int

    def _r_apply(self, w: torch.Tensor) -> torch.Tensor:
        """``R w`` -> the ``(n_pad_c,)`` coarse vector: every part's
        segment sum into the global numbering, then :func:`psum`."""
        s = w - self.A.matvec(self.scale * w)
        ts = self.tval * s
        parts = ts.new_zeros(ts.shape[0] * self.n_pad_c)
        parts.index_add_(0, self.flat_agg, ts.reshape(-1))
        return psum(parts.view(ts.shape[0], self.n_pad_c), self.A.mesh)

    def _p_apply(self, x_c: torch.Tensor) -> torch.Tensor:
        """``P x_c`` for the coarse vector -> ``(P, n_local)``."""
        t = self.tval * x_c[self.agg]
        return t - self.scale * self.A.matvec(t)

    def _smooth(self, x, b, x_zero: bool = False):
        # The single-device V-cycle's Chebyshev smoother, so iteration
        # counts do not depend on P.
        return chebyshev_smooth(self.A.matvec, self.inv_diag, self.lmax,
                                self.smooth_steps, x, b, x_zero=x_zero)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        x = self._smooth(torch.zeros_like(r), r, x_zero=True)
        r_c = self._r_apply(r - self.A.matvec(x))
        r_c = torch.where(self.mask, r_c, torch.zeros_like(r_c))
        x = x + self._p_apply(self.tail(r_c))
        return self._smooth(x, r)


def build_halo_amg(
    A: CSRMatrix,
    plan: HaloPlan,
    *,
    dtype=torch.float32,
    device=None,
    **amg_kwargs,
) -> Optional[HaloAMG]:
    """Build the global hierarchy over an existing halo plan; the coarse
    tail lives on ``device`` (default: the card).  ``None`` when the
    hierarchy has no level."""
    info: list = []
    M = smoothed_aggregation_setup(A, dtype=dtype, level_info_out=info,
                                   device=device, **amg_kwargs)
    if not M.levels or not info:
        return None
    lv = info[0]
    agg, counts, d = lv["agg"], lv["counts"], lv["d"]
    lmax, omega = lv["lmax"], lv["omega"]
    n_c = int(agg.max()) + 1 if agg.size else 0
    n_pad_c = (int(M.levels[1].A.n_pad) if len(M.levels) > 1
               else int(M.coarse_inv.shape[-1]))
    tail = AMGPreconditioner(levels=list(M.levels[1:]),
                             coarse_inv=M.coarse_inv,
                             smooth_steps=M.smooth_steps)
    agg_p = np.zeros((plan.nparts, plan.n_local), dtype=np.int32)
    agg_p[plan.part_of_row, plan.local_of_row] = agg
    # float32 even in an f64 solve, as JAX scatters them.
    return HaloAMG(
        plan=plan,
        agg=agg_p,
        tval=plan.scatter_vector((1.0 / np.sqrt(counts))[agg],
                                 dtype=np.float32),
        scale=plan.scatter_vector((omega / lmax) / d, dtype=np.float32),
        inv_diag=plan.scatter_vector(1.0 / d, dtype=np.float32),
        lmax=float(lmax),
        smooth_steps=M.smooth_steps,
        tail=tail,
        n_c=n_c,
        n_pad_c=n_pad_c,
    )


def halo_amg_block(op, hamg: HaloAMG) -> _HaloAMGBlock:
    """The apply of ``hamg`` over ``op``'s parts, on ``op``'s device; over
    a mesh of several processes, its local parts' level-0 pieces, and every
    process runs the same coarse tail on the same gathered coarse
    residual."""
    dev = op.device
    P_ = op.mesh.local_parts

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(op.mesh.local(a))).to(
            dev)

    agg = put(hamg.agg.astype(np.int64))
    flat = agg + hamg.n_pad_c * torch.arange(P_, device=dev)[:, None]
    return _HaloAMGBlock(
        A=op, flat_agg=flat.reshape(-1), agg=agg, tval=put(hamg.tval),
        scale=put(hamg.scale), inv_diag=put(hamg.inv_diag),
        lmax=torch.tensor(hamg.lmax, dtype=torch.float32), tail=hamg.tail,
        mask=torch.arange(hamg.n_pad_c, device=dev) < hamg.n_c,
        n_pad_c=hamg.n_pad_c, smooth_steps=hamg.smooth_steps,
    )


def halo_amg_cg_solve(
    op,
    hamg: HaloAMG,
    b_host: np.ndarray,
    x0_host: np.ndarray,
    *,
    tol: float = 1e-12,
    maxiter: int = 300,
):
    """CG over the parts preconditioned by the global hierarchy.

    ``op``: a :class:`.sharded.ShardedOperator` (ELL or sliced-ELL local
    blocks) built from the SAME plan.  Returns ``(x_host, result)``."""
    b = op.put_vector(b_host)
    x0 = op.put_vector(x0_host)
    res = cg_solve(op, b, x0, precond=halo_amg_block(op, hamg), tol=tol,
                   maxiter=maxiter, dot=op.mesh.dot)
    return op.get_vector(res.x), res
