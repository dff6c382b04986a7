"""Two-level brick-Schwarz preconditioner for slab-partitioned structured
grids.

Counterpart of the JAX package's ``parallel/slabbrick.py``.  Contiguous
z-layer slabs of a lexicographic grid are grids themselves, so every part
runs a gather-free two-level cycle on its own slab block with no
communication in the preconditioner (CG's dots remain the only
reductions):

- smoother: Chebyshev on the local diagonal block (the slab DIA product
  with zero halo, which drops exactly the couplings that cross a slab
  boundary);
- T / T^T: brick aggregation as reshape + repeat / reshape + block sum;
- coarse solve: each slab's dense inverse, one batched ``torch.matmul``
  over the parts (a jnp matmul outside Pallas in JAX);
- optionally the additive slab-mean (Nicolaides) correction: each part's
  residual sum, JAX's scalar ``all_gather``, times a ``(P, P)`` inverse.

Over a mesh of several processes each holds its parts' blocks
(:meth:`SlabBrickPrecond.block`), and the slab-mean correction gathers
every part's sum.

The host set-up (the Galerkin blocks and ``np.linalg.inv``) is JAX's,
copied.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..solvers.precond.cheby import chebyshev_smooth
from .sharded import DeviceMesh, part_sums
from .slab import SlabDIAPlan, brick_expand, brick_sum

__all__ = ["SlabBrickBlock", "SlabBrickPrecond", "build_slab_brick_precond"]


@dataclasses.dataclass
class SlabBrickBlock:
    """The two-level cycle of every part, on one device: a CG
    preconditioner over ``(P, slab)`` vectors (over a ``mesh`` of several
    processes, its local parts' ``(k, slab)``)."""

    data: torch.Tensor  # (P, ndiags, slab) local DIA data
    coarse_inv: torch.Tensor  # (P, nc, nc) dense inverse of T^T A_loc T
    inv_diag: torch.Tensor  # (P, slab) 1/diag of the local block
    acc_inv: torch.Tensor  # (P, P) inverse of the slab-mean coarse operator
    offsets: Tuple[int, ...]
    slab: int
    local_dims: Tuple[int, int, int]  # (mx, my, mz_local)
    brick: int
    smooth_steps: int = 2
    use_global: bool = False
    mesh: Optional[DeviceMesh] = None

    def _matvec_local(self, x: torch.Tensor) -> torch.Tensor:
        """Block-diagonal product: the slab DIA form with a zero halo."""
        S = self.slab
        h = max(max(abs(o) for o in self.offsets), 1)
        x_ext = torch.nn.functional.pad(x, (h, h))
        y = torch.zeros_like(x)
        for d, off in enumerate(self.offsets):
            win = x_ext[:, h + off: h + off + S]
            y = y + self.data[:, d].to(x.dtype) * win
        return y

    def _smooth(self, x, r, x_zero: bool = False):
        """Chebyshev over D^-1 A_loc with the Gershgorin bound lmax = 2
        (exact for normalized graph Laplacians; local blocks only shrink
        it)."""
        return chebyshev_smooth(self._matvec_local, self.inv_diag, 2.0,
                                self.smooth_steps, x, r, x_zero=x_zero)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        """One symmetric two-level cycle on every slab block, plus
        (optionally) the additive global slab-mean correction."""
        x = self._smooth(torch.zeros_like(r), r, x_zero=True)
        rc = brick_sum(r - self._matvec_local(x), self.local_dims,
                       self.brick)
        xc = torch.matmul(self.coarse_inv.to(rc.dtype), rc.unsqueeze(-1))
        x = x + brick_expand(xc.squeeze(-1), self.local_dims, self.brick)
        x = self._smooth(x, r)
        if self.use_global:
            # JAX's all_gather of each part's sum.
            rg = part_sums(r, self.mesh)
            xg = torch.mv(self.acc_inv.to(rg.dtype), rg)
            if self.mesh is not None:
                xg = self.mesh.local(xg)
            x = x + xg[:, None]
        return x


@dataclasses.dataclass
class SlabBrickPrecond:
    """The stacked per-slab two-level cycles as host arrays (leading axis
    = parts); :meth:`block` puts them on a device as the callable
    :class:`SlabBrickBlock`."""

    data: np.ndarray  # (P, ndiags, slab)
    coarse_inv: np.ndarray  # (P, nc, nc)
    inv_diag: np.ndarray  # (P, slab)
    acc_inv: np.ndarray  # (P, P) global slab-mean coarse inverse
    offsets: Tuple[int, ...]
    slab: int
    local_dims: Tuple[int, int, int]
    brick: int
    smooth_steps: int = 2
    use_global: bool = False

    def block(self, device,
              mesh: Optional[DeviceMesh] = None) -> SlabBrickBlock:
        """The cycles on ``device``; over a ``mesh`` of several processes,
        its parts' only."""
        def put(a, per_part=True):
            if per_part and mesh is not None:
                a = mesh.local(a)
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return SlabBrickBlock(
            data=put(self.data), coarse_inv=put(self.coarse_inv),
            inv_diag=put(self.inv_diag),
            acc_inv=put(self.acc_inv, per_part=False),
            offsets=self.offsets, slab=self.slab, local_dims=self.local_dims,
            brick=self.brick, smooth_steps=self.smooth_steps,
            use_global=self.use_global, mesh=mesh,
        )


def build_slab_brick_precond(plan: SlabDIAPlan,
                             grid_dims: Tuple[int, int, int], brick: int = 6,
                             smooth_steps: int = 2, dtype=np.float32,
                             global_coarse: bool = False,
                             A=None) -> SlabBrickPrecond:
    """Host set-up of the stacked per-slab two-level cycles (JAX's).

    The plan's slab must be a whole number of z-layers (``plan.slab %
    (mx*my) == 0``: build it with ``build_slab_plan(..., row_align=mx*my)``);
    raises ``ValueError`` otherwise.  ``global_coarse`` adds the additive
    slab-mean correction (pass the host CSR as ``A``); on Dirichlet-walled
    heat problems it does not reduce iterations, so it is off by default,
    as in JAX."""
    mx, my, mz = (int(v) for v in grid_dims)
    P, nd, slab = plan.data.shape
    if slab % (mx * my) != 0:
        raise ValueError(
            f"slab size {slab} is not a whole number of z-layers "
            f"(mx*my = {mx * my}); build the slab plan with "
            f"row_align=mx*my"
        )
    mz_l = slab // (mx * my)
    b = brick
    ncx, ncy, ncz = -(-mx // b), -(-my // b), -(-mz_l // b)
    nc = ncx * ncy * ncz

    # Aggregate id per local row (the same for every slab).
    f = np.arange(slab)
    ix, rest = f % mx, f // mx
    iy, iz = rest % my, rest // my
    agg = (ix // b) + ncx * ((iy // b) + ncy * (iz // b))

    offsets = np.asarray(plan.offsets)
    data = np.asarray(plan.data, dtype=np.float64)
    # Coarse Galerkin blocks A_c[p] = T^T A_loc T with unit-weight T.
    Ac = np.zeros((P, nc, nc))
    diag = np.ones((P, slab))
    for d, off in enumerate(offsets):
        i = np.arange(slab)
        j = i + off
        ok = (j >= 0) & (j < slab)
        ii, jj = i[ok], j[ok]
        for p in range(P):
            np.add.at(Ac[p], (agg[ii], agg[jj]), data[p, d, ii])
        if off == 0:
            diag = np.where(data[:, d, :] != 0, data[:, d, :], 1.0)

    # Bricks covering only padding rows give zero coarse rows: identity.
    for p in range(P):
        zero = np.abs(np.diag(Ac[p])) < 1e-30
        Ac[p][zero, :] = 0.0
        Ac[p][:, zero] = 0.0
        Ac[p][zero, zero] = 1.0
    coarse_inv = np.linalg.inv(Ac)

    # Global slab-mean coarse: Acc[p, q] = ones_p^T A ones_q over the whole
    # matrix (cross-slab couplings included) — needs the host CSR.
    acc_inv = np.zeros((P, P))
    if global_coarse and A is not None:
        rows = np.repeat(np.arange(A.n_rows), A.row_lengths())
        pr = np.minimum(rows // slab, P - 1)
        pc = np.minimum(A.indices // slab, P - 1)
        Acc = np.zeros((P, P))
        np.add.at(Acc, (pr, pc), A.data)
        zero = np.abs(np.diag(Acc)) < 1e-30
        Acc[zero, zero] = 1.0
        acc_inv = np.linalg.inv(Acc)

    return SlabBrickPrecond(
        data=np.asarray(plan.data),
        coarse_inv=coarse_inv.astype(np.dtype(dtype)),
        inv_diag=(1.0 / diag).astype(np.dtype(dtype)),
        acc_inv=acc_inv.astype(np.dtype(dtype)),
        offsets=tuple(int(o) for o in plan.offsets),
        slab=slab,
        local_dims=(mx, my, mz_l),
        brick=b,
        smooth_steps=smooth_steps,
        use_global=bool(global_coarse and A is not None),
    )
