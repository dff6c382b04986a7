"""Global SA-AMG over z-slabs with kernel 3 as each part's fine product.

Counterpart of the JAX package's ``parallel/slabpadamg.py``: the global
brick hierarchy of :mod:`.slabamg` with the slab pad-stencil operator of
:mod:`.slabpad` as its fine level.

- **Fine level**: :class:`.slabpad.SlabPadStencilOperator` (the
  pad-stencil kernel on every part's window after the two-strip
  exchange).  Vectors live in each slab's owned padded space ``(L, myp,
  mxp)``; pad slots and dead layers hold 0 through the whole cycle (the
  kernel writes 0 there, and ``tval`` is 0 there).
- **Transfers local**: slabs are whole ``brick`` z-layers
  (``build_slab_pad_stencil(z_align=brick)``), so the brick tentative
  transfer extracts each slab's real ``(L, my, mx)`` box, block-sums or
  repeats it and embeds it back; the smoothing half of P/R is one
  fine-level product.  The restriction gathers the coarse residual (the
  reshape of ``(P, slab_c)``), padded or cut to the tail's length and
  masked past the true coarse rows.
- **Coarse tail**: the port's single-device levels, run once (over a mesh
  of several processes, once in each on the gathered coarse residual).

Set-up reuses ``smoothed_aggregation_setup(level_info_out=...)`` for the
global level-0 pieces, so iteration counts are the single-device
hierarchy's; they are embedded into the slab layout and uploaded once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.csr import CSRMatrix
from ..ops.dia import pack_dia_host
from ..ops.stencil import stencil_parts_from_packed
from ..ops.stencil_kernel import pad_stencil_from_parts
from ..solvers.cg import cg_solve
from ..solvers.precond.amg import AMGPreconditioner, smoothed_aggregation_setup
from .sharded import DeviceMesh
from .slabamg import SlabVCycle
from .slab import plan_mesh
from .slabpad import SlabPadPlan, build_slab_pad_stencil

__all__ = ["SlabPadAMG", "build_slab_pad_amg", "slab_pad_amg_cg_solve"]


@dataclasses.dataclass(kw_only=True)
class SlabPadAMG(SlabVCycle):
    """The slab hierarchy with the pad-stencil fine level: the V-cycle in
    the owned padded layout (``tval`` 0 on pad slots and dead layers), the
    slab-pad plan, and the global operator it was built on (the f64
    refinement's source, :mod:`.slabpadmixed`)."""

    plan: SlabPadPlan
    pad_op: object = None


def _pad_op_from_csr(A: CSRMatrix, grid_dims, device, bz=None):
    packed = pack_dia_host(A, dtype=torch.float32)
    if packed is None:
        return None
    parts = stencil_parts_from_packed(packed[0], packed[1], A.n_rows,
                                      grid_dims)
    if parts is None:
        return None
    if bz is None:
        return pad_stencil_from_parts(parts, device=device)
    return pad_stencil_from_parts(parts, bz=bz, device=device)


def build_slab_pad_amg(
    A: CSRMatrix,
    grid_dims: Tuple[int, int, int],
    nparts: int,
    *,
    pad_op=None,
    brick: int = 6,
    device=None,
    mesh: Optional[DeviceMesh] = None,
    **amg_kwargs,
) -> Optional[SlabPadAMG]:
    """Build the pad-engine partitioned hierarchy (float32, the kernel's
    compute type); None when the problem does not fit (no lattice
    stencil, or no slab size satisfies the brick and layer rules; the
    caller then takes :func:`.slabamg.build_slab_amg`).

    ``pad_op``: the global :class:`PadStencilOperator` already built
    (``choose_operator(..., pad_stencil=...)`` or
    ``pad_stencil_from_parts``); built from the CSR on ``device`` (default
    the card) when omitted.  The slab rules ``L ≡ -2 (mod bz)`` and ``L ≡ 0
    (mod brick)`` are solvable only when ``gcd(bz, brick)`` divides 2; if
    they are not, the operator is rebuilt with ``bz = 4``, as in JAX.
    ``mesh``: the level-0 layout (:func:`.slabpad.build_slab_pad_stencil`'s
    default: over several processes, this process's parts)."""
    mx, my, mz = (int(v) for v in grid_dims)
    if mx * my * mz != A.n_rows:
        return None
    if pad_op is None:
        pad_op = _pad_op_from_csr(A, grid_dims, device)
        if pad_op is None:
            return None
    plan = build_slab_pad_stencil(pad_op, nparts, z_align=brick, mesh=mesh)
    if plan is None and math.gcd(pad_op.bz, brick) > 2:
        pad_op = _pad_op_from_csr(A, grid_dims, pad_op.device, bz=4)
        if pad_op is not None:
            plan = build_slab_pad_stencil(pad_op, nparts, z_align=brick,
                                          mesh=mesh)
    if plan is None:
        return None

    info: list = []
    amg_kwargs.pop("fine_operator", None)  # supplied here: pad_op
    M = smoothed_aggregation_setup(
        A, dtype=torch.float32, grid_dims=grid_dims, brick=brick,
        level_info_out=info, fine_operator=pad_op, **amg_kwargs,
    )
    if not M.levels or not info:
        return None
    li = info[0]
    dev = plan.device
    # Level-0 pieces embedded into the owned stacked padded slab layout.
    tval_flat = (1.0 / np.sqrt(np.maximum(li["counts"], 1.0)))[li["agg"]]
    scale_flat = (li["omega"] / li["lmax"]) / li["d"]
    inv_diag = plan.mesh.local(plan.scatter_vector(1.0 / li["d"]))
    n_c = int(li["agg"].max()) + 1
    n_pad_c = (int(M.levels[1].A.n_pad) if len(M.levels) > 1
               else int(M.coarse_inv.shape[-1]))
    mx, my, _ = plan.dims
    return SlabPadAMG(
        plan=plan,
        pad_op=pad_op,
        A=plan.make_ops(),
        tval=plan.put_vector(tval_flat),
        scale=plan.put_vector(scale_flat),
        inv_diag=torch.from_numpy(
            np.where(inv_diag == 0.0, 1.0, inv_diag).astype(np.float32)
        ).to(dev),
        mask=torch.arange(n_pad_c, device=dev) < n_c,
        lmax=float(li["lmax"]),
        smooth_steps=M.smooth_steps,
        tail=AMGPreconditioner(levels=list(M.levels[1:]),
                               coarse_inv=M.coarse_inv,
                               smooth_steps=M.smooth_steps),
        n_c=n_c,
        n_pad_c=n_pad_c,
        dims_local=(mx, my, plan.L),
        brick=brick,
        pad=(plan.myp, plan.mxp),
        mesh=plan.mesh,
    )


def slab_pad_amg_cg_solve(samg: SlabPadAMG, b: np.ndarray, x0: np.ndarray,
                          *, mesh: Optional[DeviceMesh] = None,
                          tol: float = 1e-12, maxiter: int = 300):
    """CG over the slabs preconditioned by the global hierarchy, kernel 3
    on every part's fine product; float32, on the plan's device over its
    mesh.  Returns ``(x_host, CGResult)``."""
    plan = samg.plan
    mesh = plan_mesh(plan, mesh)
    res = cg_solve(samg.A, plan.put_vector(b), plan.put_vector(x0),
                   precond=samg, tol=tol, maxiter=maxiter, dot=mesh.dot)
    return plan.gather_vector(res.x), res
