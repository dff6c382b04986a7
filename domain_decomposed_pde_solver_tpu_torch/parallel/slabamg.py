"""Global SA-AMG over slab decompositions.

Counterpart of the JAX package's ``parallel/slabamg.py``: the
preconditioner applies the global brick hierarchy, so CG iteration counts
do not depend on the part count (they are the single-device hierarchy's,
up to the dots' summation order).

- **Fine level partitioned.**  The level-0 operator is split into slabs
  (:mod:`.slab`): the slab lattice stencil when the hierarchy's level 0
  is a :class:`..ops.stencil.StencilOperator` (float32), else the slab DIA
  form.  Its products exchange the two neighbour strips.
- **Transfers local.**  Slabs are whole ``brick`` z-layers
  (``row_align = mx*my*brick``), so the brick tentative transfer is a
  reshape and repeat inside each slab; the smoothing half of P/R is one
  fine-level product.  The restriction gathers the coarse residual:
  JAX's ``all_gather`` is the reshape of the ``(P, slab_c)`` tensor.
- **Coarse tail replicated.**  Levels 1 and below are the port's
  single-device levels (DIA and sliced-ELL kernels on the card).  JAX runs
  one copy per device; the port's one device runs it once, and over a
  mesh of several processes every process runs it on the same gathered
  coarse residual and keeps its parts' rows of the answer.

Set-up reuses :func:`..solvers.precond.amg.smoothed_aggregation_setup`
for the global hierarchy, then splits level 0.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.csr import CSRMatrix
from ..ops.dia import _torch_dtype
from ..ops.stencil import StencilOperator
from ..solvers.cg import cg_solve
from ..solvers.precond.amg import (
    AMGPreconditioner,
    BrickProlongator,
    smoothed_aggregation_setup,
)
from ..solvers.precond.cheby import chebyshev_smooth
from .sharded import DeviceMesh, all_parts, make_device_mesh
from .slab import (
    SlabDIAOperator,
    SlabDIAPlan,
    SlabStencilOperator,
    _upload,
    brick_expand,
    brick_sum,
    build_slab_plan,
    build_slab_stencil,
    plan_mesh,
)

__all__ = ["SlabAMG", "SlabVCycle", "build_slab_amg", "coarse_gather",
           "coarse_scatter", "slab_amg_cg_solve"]


def coarse_gather(r_c_loc: torch.Tensor, n_pad_c: int,
                  mask: torch.Tensor) -> torch.Tensor:
    """JAX's ``all_gather`` of the per-part coarse residuals ``(P,
    slab_c)`` into the tail's ``(n_pad_c,)`` vector: the parts in order
    (slab boundaries sit on brick rows, so this is the global brick
    numbering), cut or zero-extended to ``n_pad_c``, and 0 past the true
    coarse rows (``mask``)."""
    full = r_c_loc.reshape(-1)
    G = full.numel()
    r_c = full[:n_pad_c] if G >= n_pad_c else torch.nn.functional.pad(
        full, (0, n_pad_c - G))
    return torch.where(mask, r_c, torch.zeros_like(r_c))


def coarse_scatter(x_c: torch.Tensor, nparts: int,
                   slab_c: int) -> torch.Tensor:
    """The tail's answer back to ``(P, slab_c)``: part p takes its own
    rows (JAX's ``axis_index`` slice), 0 past ``n_pad_c``."""
    G = nparts * slab_c
    if G > x_c.numel():
        x_c = torch.nn.functional.pad(x_c, (0, G - x_c.numel()))
    return x_c[:G].reshape(nparts, slab_c)


@dataclasses.dataclass(kw_only=True)
class SlabVCycle:
    """The global V-cycle over ``(P, slab)`` vectors, a CG preconditioner;
    its level-0 pieces live on one device from the build on (over a
    ``mesh`` of several processes, the local parts' ``(k, slab)``).

    The fine level is ``A`` (any slab operator with ``matvec`` on ``(P,
    slab)``); the brick transfers are local to each part's ``dims_local``
    grid, in the compact layout (``pad`` None) or the padded one (``pad =
    (myp, mxp)``, :mod:`.slabpadamg`); the coarse tail is the port's
    single-device hierarchy, run once."""

    A: object  # the fine slab operator
    tval: torch.Tensor  # (P, slab) tentative weights (0 off the grid)
    scale: torch.Tensor  # (P, slab) omega/lmax/diag
    inv_diag: torch.Tensor  # (P, slab)
    mask: torch.Tensor  # (n_pad_c,) bool: real coarse rows
    lmax: float
    smooth_steps: int
    tail: AMGPreconditioner  # levels 1+ (small)
    n_c: int  # true coarse rows
    n_pad_c: int  # the tail's padded vector length
    dims_local: Tuple[int, int, int]  # (mx, my, layers) per-part grid
    brick: int
    pad: Optional[Tuple[int, int]] = None  # (myp, mxp) of a padded slab
    mesh: Optional[DeviceMesh] = None  # the mesh the build laid out

    @property
    def slab_c(self) -> int:
        mx, my, mz_p = self.dims_local
        b = self.brick
        return -(-mx // b) * -(-my // b) * -(-mz_p // b)

    @property
    def device(self) -> torch.device:
        return self.tval.device

    @property
    def nparts(self) -> int:
        return self.tval.shape[0] if self.mesh is None else self.mesh.nparts

    def _smooth(self, x, b, x_zero: bool = False):
        # lmax in the working dtype, so the Chebyshev bounds round as JAX's.
        lmax = torch.tensor(self.lmax, dtype=self.tval.dtype)
        return chebyshev_smooth(self.A.matvec, self.inv_diag, lmax,
                                self.smooth_steps, x, b, x_zero=x_zero)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        """One global V-cycle on the partitioned fine level."""
        matvec = self.A.matvec
        x = self._smooth(torch.zeros_like(r), r, x_zero=True)
        # R = T^T (I - A S): the smoothing half, then the brick sums.
        w = r - matvec(x)
        s = w - matvec(self.scale * w)
        r_c_parts = all_parts(brick_sum(self.tval * s, self.dims_local,
                                        self.brick, self.pad), self.mesh)
        r_c = coarse_gather(r_c_parts, self.n_pad_c, self.mask)
        x_c = coarse_scatter(self.tail(r_c), r_c_parts.shape[0], self.slab_c)
        if self.mesh is not None:
            x_c = self.mesh.local(x_c)
        # P = (I - S A) T.
        t = self.tval * brick_expand(x_c, self.dims_local, self.brick,
                                     self.pad)
        x = x + (t - self.scale * matvec(t))
        return self._smooth(x, r)


@dataclasses.dataclass(kw_only=True)
class SlabAMG(SlabVCycle):
    """The slab hierarchy with a slab DIA or lattice-stencil fine level:
    the V-cycle, and the host plan that scatters and gathers vectors."""

    plan: SlabDIAPlan


def build_slab_amg(
    A: CSRMatrix,
    grid_dims: Tuple[int, int, int],
    nparts: int,
    *,
    brick: int = 6,
    dtype=np.float32,
    device=None,
    mesh: Optional[DeviceMesh] = None,
    **amg_kwargs,
) -> Optional[SlabAMG]:
    """Build the partitioned hierarchy; the coarse tail lives on
    ``device`` (default: the card), the level-0 pieces over ``mesh``
    (default :func:`.sharded.make_device_mesh` on that device: over several
    processes, this process's parts).  None when the problem does not fit
    the slab-brick layout (unstructured fine level, slabs thinner than the
    bandwidth, or a z-extent not splittable into whole bricks)."""
    mx, my, mz = (int(v) for v in grid_dims)
    if mx * my * mz != A.n_rows:
        return None
    M = smoothed_aggregation_setup(
        A, dtype=_torch_dtype(dtype), grid_dims=grid_dims,
        brick=brick, device=device, **amg_kwargs)
    if not M.levels:
        return None
    lvl0 = M.levels[0]
    if not isinstance(lvl0.P, BrickProlongator):
        return None  # the hierarchy did not take the brick path
    plan = build_slab_plan(A, nparts, dtype=dtype, row_align=mx * my * brick)
    if plan is None:
        return None
    mz_p = plan.slab // (mx * my)
    if mz_p % brick != 0 or plan.slab % (mx * my) != 0:
        return None

    n = A.n_rows
    dev = M.coarse_inv.device
    if mesh is None:
        mesh = make_device_mesh(nparts, [dev])
    elif mesh.nparts != nparts or mesh.device != dev:
        raise ValueError(f"mesh of {mesh.nparts} parts on {mesh.device} for "
                         f"{nparts} slabs on {dev}")
    d = np.asarray(A.diagonal())
    d = np.where(d != 0, d, 1.0)

    def _split(v):
        out = np.zeros((plan.nparts, plan.slab), dtype=np.dtype(dtype))
        out.reshape(-1)[:n] = v[:n]
        return _upload(mesh.local(out), dev)

    n_pad_c = (int(M.levels[1].A.n_pad) if len(M.levels) > 1
               else int(M.coarse_inv.shape[-1]))
    ncx, ncy = -(-mx // brick), -(-my // brick)
    n_c = ncx * ncy * (-(-mz // brick))
    # The lattice-stencil fine level when level 0 decomposes into the same
    # z-layer slabs (its period divides them), else slab DIA.
    st = lvl0.A if isinstance(lvl0.A, StencilOperator) else None
    built = build_slab_stencil(st, nparts, brick) if st is not None else None
    if built is not None and built[0][2] == mz_p:
        _dims, corr, mask, meta = built
        op = SlabStencilOperator(
            pats=st.pats.to(device=dev, dtype=torch.float32),
            const_vals=st.const_vals.to(device=dev, dtype=torch.float32),
            corr=_upload(mesh.local(corr), dev),
            mask=_upload(mesh.local(mask), dev), mesh=mesh, **meta)
    else:
        op = SlabDIAOperator(data=_upload(mesh.local(plan.data), dev),
                             offsets=plan.offsets, halo=plan.halo,
                             slab=plan.slab, mesh=mesh)
    return SlabAMG(
        plan=plan,
        A=op,
        tval=_split(lvl0.P.tval.cpu().numpy()),
        scale=_split(lvl0.P.scale.cpu().numpy()),  # omega/lmax/diag
        inv_diag=_split(1.0 / d),
        mask=torch.arange(n_pad_c, device=dev) < n_c,
        lmax=float(lvl0.lmax),
        smooth_steps=M.smooth_steps,
        tail=AMGPreconditioner(levels=list(M.levels[1:]),
                               coarse_inv=M.coarse_inv,
                               smooth_steps=M.smooth_steps),
        n_c=n_c,
        n_pad_c=n_pad_c,
        dims_local=(mx, my, mz_p),
        brick=brick,
        mesh=mesh,
    )


def slab_amg_cg_solve(samg: SlabAMG, b: np.ndarray, x0: np.ndarray, *,
                      mesh: Optional[DeviceMesh] = None, tol: float = 1e-12,
                      maxiter: int = 300):
    """CG over the slabs preconditioned by the global hierarchy, in the
    dtype the hierarchy was built in, on its device, over the mesh it was
    built over (``mesh``, if given, must be that one).  Returns
    ``(x_host, CGResult)``; over several processes the result's ``x`` is
    this process's ``(k, slab)`` iterate and ``x_host`` the full answer."""
    plan = samg.plan
    dev = samg.device
    mesh = plan_mesh(samg, mesh)
    vdt = plan.data.dtype

    def put(v):
        return _upload(mesh.local(plan.scatter_vector(v, dtype=vdt)), dev)

    res = cg_solve(samg.A, put(b), put(x0), precond=samg, tol=tol,
                   maxiter=maxiter, dot=mesh.dot)
    return plan.gather_vector(all_parts(res.x, mesh)), res
