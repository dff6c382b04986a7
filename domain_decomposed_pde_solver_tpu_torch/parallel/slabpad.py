"""z-slab partition of the pad-stencil operator: kernel 3 per slab.

Counterpart of the JAX package's ``parallel/slabpad.py``.  Each part owns
a contiguous block of ``L`` whole z-layers of the padded ``(Z, myp, mxp)``
lattice; the halo is one z-layer per neighbour (the stencil's ``|dz| <=
1``), and a part's product is the pad-stencil kernel (``csrc/
pad_stencil.cu``) run unchanged on its window

    [lo_halo | L owned layers | hi_halo]     (Z_local = L + 2 layers)

with the window's z-validity bound ``mz = min(L, mz_global - p*L)``: the
kernel writes the layers ``1..mz`` and 0 everywhere else, so the last
slab's layers past the grid (dead layers) and every pad slot stay 0.

The slab rules are JAX's, kept exactly so that plans equal its arrays: L
is even (global layer ``p*L + l`` has the parity of local layer ``l``, so
the kernel's parity from the local layer is the global one), ``L + 2 ≡ 0
(mod bz)``, ``L ≡ 0 (mod z_align)``, ``L >= 2*bz - 2``; no plan when a
trailing slab would own no layer.  A window starts ``(L + 2) * myp * mxp``
slots after the previous one, and ``mxp`` is a multiple of 128, so every
window is 16-byte aligned for the kernel's vector copies.

One controller drives the P parts on one device (``parallel/sharded.py``):
a slab vector is the owned-only ``(P, L*myp*mxp)`` tensor (pad slots 0,
so dots need no mask), the exchange builds every part's window with one
strided copy of the owned layers and two strip copies
(:meth:`SlabPadStencilOperator.extended`), then one launch per part.  On
a CPU tensor each window takes the kernel's plain version
(:func:`..ops.stencil_kernel.pad_window_reference`).  Over a mesh of
several processes a plan holds its process's parts, and the first and
last local windows take their outer layers from the neighbouring
processes (:func:`.collectives.ring_strips`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.dia import _torch_dtype
from ..ops.ell import fetch_vector, stage_vector
from ..ops.stencil_kernel import (
    PadStencilOperator,
    kernel_tables,
    pad_window_spmv,
)
from ..solvers.cg import cg_solve
from ..solvers.precond.jacobi import DiagonalPreconditioner
from ..utils.timers import spanned
from .collectives import ring_strips
from .sharded import DeviceMesh, across_processes, all_parts, make_device_mesh
from .slab import plan_mesh

__all__ = [
    "SlabPadPlan",
    "SlabPadStencilOperator",
    "build_slab_pad_stencil",
    "slab_pad_cg_solve",
]


@dataclasses.dataclass
class SlabPadStencilOperator:
    """The slab pad-stencil product over all parts, on one device.

    ``corr_ext`` is each slab's diagonal correction in its window layout
    (zero guard layers where the halos sit), ``(P, (L+2)*myp*mxp)`` in the
    operator's storage (bfloat16 when exact); ``zlim[p]`` the last layer
    of window p the kernel writes.  The other fields have
    :class:`..ops.stencil_kernel.PadStencilOperator` semantics on the
    local dims ``(mx, my, L)``.  ``matvec`` takes and returns ``(P,
    L*myp*mxp)`` in float32 or float64 (the f64 residual of
    :mod:`.slabpadmixed` runs the kernel's double instance).  Over a
    ``mesh`` of several processes every ``(P, ...)`` is this process's
    ``(k, ...)``."""

    pats: torch.Tensor  # (ndiags, p, p, p) f32: the plain version's
    const_vals: torch.Tensor  # (n_groups,) f32
    quads: np.ndarray  # (n_groups, 8) f32: the kernel's pattern scalars
    corr_ext: torch.Tensor  # (P, (L+2)*myp*mxp)
    zlim: Tuple[int, ...]  # (P,) valid layers of each window
    taps: Tuple[Tuple[int, int, int], ...]
    groups: Tuple[Tuple[int, ...], ...]
    group_const: Tuple[bool, ...]
    dims_local: Tuple[int, int, int]  # (mx, my, L)
    period: int
    myp: int
    mxp: int
    bz: int
    mesh: Optional[DeviceMesh] = None
    _tables: Optional[tuple] = dataclasses.field(default=None, repr=False)

    @property
    def dims(self) -> Tuple[int, int, int]:
        return self.dims_local

    @property
    def L(self) -> int:
        return self.dims_local[2]

    @property
    def nparts(self) -> int:
        return self.corr_ext.shape[0]

    @property
    def n_pad(self) -> int:
        """Owned (per-part) vector length."""
        return self.L * self.myp * self.mxp

    @property
    def n_rows(self) -> int:
        return self.n_pad

    @property
    def dtype(self) -> torch.dtype:
        return torch.float32

    @property
    def device(self) -> torch.device:
        return self.corr_ext.device

    def kernel_tables(self):
        if self._tables is None:
            self._tables = kernel_tables(self.taps, self.groups, self.quads)
        return self._tables

    def extended(self, x: torch.Tensor) -> torch.Tensor:
        """The halo exchange: ``(P, L*layer)`` -> every part's window
        ``(P, (L+2)*layer)``, its owned layers between part p - 1's last
        layer and part p + 1's first (zeros at the ring ends; across
        processes the outer ones from the neighbouring processes)."""
        P_, L = x.shape[0], self.L
        layer = self.myp * self.mxp
        x3 = x.reshape(P_, L, layer)
        xe = x.new_empty((P_, L + 2, layer))
        xe[:, 1: L + 1] = x3
        xe[0, 0] = 0
        xe[P_ - 1, L + 1] = 0
        if P_ > 1:
            xe[1:, 0] = x3[:-1, L - 1]
            xe[:-1, L + 1] = x3[1:, 0]
        if across_processes(x, self.mesh):
            xe[0, 0], xe[P_ - 1, L + 1] = ring_strips(x3[0, 0],
                                                      x3[P_ - 1, L - 1])
        return xe.reshape(P_, -1)

    def window_products(self, xe: torch.Tensor) -> torch.Tensor:
        """Every part's window product (one kernel launch per part on the
        card): ``(P, (L+2)*layer)`` -> the same shape."""
        ye = torch.empty_like(xe)
        for p in range(xe.shape[0]):
            pad_window_spmv(self, xe[p], self.corr_ext[p], self.zlim[p],
                            out=ye[p])
        return ye

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        layer = self.myp * self.mxp
        ye = self.window_products(self.extended(x))
        return ye[:, layer: (self.L + 1) * layer]


@dataclasses.dataclass
class SlabPadPlan:
    """The P-way z-slab split of a pad-stencil operator: JAX's fields, the
    device arrays as tensors on the operator's device, plus the patterns
    the plain version reads.  ``mesh``: the mesh the device arrays are laid
    out over (over several processes ``corr_ext`` and ``inv_diag`` hold
    this process's parts; None: all parts, one process)."""

    nparts: int
    L: int  # owned layers per part
    dims: Tuple[int, int, int]  # global (mx, my, mz)
    myp: int
    mxp: int
    bz: int
    quads: np.ndarray  # (n_groups, 8) f32
    zlims: np.ndarray  # (nparts, 1, 2) int32
    corr_ext: torch.Tensor  # (nparts, (L+2)*myp, mxp) f32 or bf16
    inv_diag: torch.Tensor  # (nparts, L*myp*mxp) f32 (pad slots 1.0)
    meta: dict  # taps/groups/group_const/period
    pats: torch.Tensor  # (ndiags, p, p, p) f32
    const_vals: torch.Tensor  # (n_groups,) f32
    mesh: Optional[DeviceMesh] = None

    @property
    def slab(self) -> int:
        return self.L * self.myp * self.mxp

    @property
    def device(self) -> torch.device:
        return self.corr_ext.device

    def scatter_vector(self, x: np.ndarray, dtype=np.float32) -> np.ndarray:
        """Logical lexicographic ``(n_rows,)`` -> owned stacked ``(P,
        slab)`` (host)."""
        mx, my, mz = self.dims
        out = np.zeros((self.nparts * self.L, self.myp, self.mxp),
                       dtype=dtype)
        out[:mz, 1: my + 1, :mx] = np.asarray(x, dtype=dtype).reshape(
            mz, my, mx)
        return out.reshape(self.nparts, self.slab)

    def _owned_layers(self, k: int) -> Tuple[int, int]:
        """The global z-layers ``[z0, z1)`` of the real rows that this
        process's ``k`` parts own (the mesh's ``parts_lo`` on): z-major
        order makes them one contiguous range of the logical vector."""
        lo = 0 if self.mesh is None else self.mesh.parts_lo
        mz = self.dims[2]
        return min(lo * self.L, mz), min((lo + k) * self.L, mz)

    @spanned("request.put")
    def put_vector(self, x: np.ndarray, dtype=np.float32) -> torch.Tensor:
        """:meth:`scatter_vector` of this process's parts (all of them with
        one process) on the plan's device.  Only the real rows those parts
        own go up, cast to ``dtype`` on the host copy into a page-locked
        buffer (:func:`..ops.ell.stage_vector`), and are laid out on the
        device into a zeroed ``(k, slab)`` tensor: pad slots and the last
        slab's dead layers stay 0."""
        mx, my, mz = self.dims
        k = self.nparts if self.mesh is None else self.mesh.local_parts
        z0, z1 = self._owned_layers(k)
        xs = np.asarray(x).reshape(-1)
        if xs.size != mx * my * mz:
            raise ValueError(f"a vector of {xs.size} rows on a plan of "
                             f"{mx * my * mz}")
        layer = mx * my
        xd = stage_vector(xs[z0 * layer: z1 * layer], self.device,
                          _torch_dtype(dtype))
        out = torch.zeros((k * self.L, self.myp, self.mxp), dtype=xd.dtype,
                          device=xd.device)
        out[: z1 - z0, 1: my + 1, :mx] = xd.view(z1 - z0, my, mx)
        return out.reshape(k, self.slab)

    @spanned("request.get")
    def gather_vector(self, x_parts) -> np.ndarray:
        """The logical ``(n_rows,)`` host vector of a ``(P, slab)`` one, or
        over a mesh of several processes of this process's ``(k, slab)``
        (every process's parts gathered: every process calls it).

        Of a tensor, each process takes its parts' real rows into a compact
        tensor on its device, the processes all-gather those pieces
        (:func:`.sharded.all_parts`), and the joined vector comes
        down through a page-locked buffer into a new array that the caller
        owns (:func:`..ops.ell.fetch_vector`)."""
        if isinstance(x_parts, torch.Tensor):
            return fetch_vector(self._logical(x_parts))
        mx, my, mz = self.dims
        x3 = np.asarray(x_parts).reshape(self.nparts * self.L, self.myp,
                                         self.mxp)
        return np.ascontiguousarray(x3[:mz, 1: my + 1, :mx]).reshape(-1)

    def _logical(self, x_parts: torch.Tensor) -> torch.Tensor:
        """The logical ``(n_rows,)`` vector of slab parts, on their device.
        Each process's piece is padded to a whole process's ``k*L`` layers
        for the gather; only the last process owns fewer
        (:func:`slab_layers` leaves every other slab whole), so the pieces
        in rank order start with the logical vector."""
        mx, my, mz = self.dims
        k = x_parts.shape[0]
        z0, z1 = self._owned_layers(k)
        own = x_parts.detach().reshape(k * self.L, self.myp, self.mxp)[
            : z1 - z0, 1: my + 1, :mx]
        if not across_processes(x_parts, self.mesh):
            return own.reshape(-1)
        piece = own.new_zeros((k * self.L, my, mx))
        piece[: z1 - z0] = own
        return all_parts(piece.reshape(k, -1), self.mesh).reshape(-1)[
            : mx * my * mz]

    def make_ops(self) -> SlabPadStencilOperator:
        """The operator over the plan's parts, on its device."""
        mx, my, _ = self.dims
        zlims = self.zlims if self.mesh is None else self.mesh.local(
            self.zlims)
        return SlabPadStencilOperator(
            pats=self.pats,
            const_vals=self.const_vals,
            quads=self.quads,
            corr_ext=self.corr_ext.reshape(self.corr_ext.shape[0], -1),
            zlim=tuple(int(z) for z in zlims[:, 0, 1]),
            dims_local=(mx, my, self.L),
            myp=self.myp,
            mxp=self.mxp,
            bz=self.bz,
            mesh=self.mesh,
            **self.meta,
        )


def slab_layers(mz: int, nparts: int, bz: int, z_align: int = 1):
    """JAX's slab rule: the smallest L covering ``mz / nparts`` with L
    even, ``L + 2 ≡ 0 (mod bz)``, ``L ≡ 0 (mod z_align)`` and ``L >= 2*bz
    - 2``; None when no such L exists or a trailing slab would own no
    layer."""
    L_min = max(2 * bz - 2, -(-mz // nparts))
    k0 = -(-(L_min + 2) // bz)
    z_align = max(int(z_align), 1)
    L = None
    # k*bz - 2 cycles through residues mod z_align with period at most
    # z_align; scan one cycle and a little more.
    for k in range(k0, k0 + z_align + 2):
        cand = k * bz - 2
        if cand % 2 == 0 and cand % z_align == 0:
            L = cand
            break
    if L is None or L < 2:
        return None
    if nparts > 1 and (nparts - 1) * L >= mz:
        return None
    return L


def build_slab_pad_stencil(A: PadStencilOperator, nparts: int,
                           z_align: int = 1,
                           mesh: Optional[DeviceMesh] = None
                           ) -> Optional[SlabPadPlan]:
    """Split a :class:`PadStencilOperator` into P z-layer slabs on its
    device, laid out over ``mesh`` (default
    :func:`.sharded.make_device_mesh` on that device: over several
    processes, this process's parts); None when the grid has too few
    layers for P slabs or no L satisfies the rules
    (:func:`slab_layers`)."""
    mx, my, mz = A.dims
    bz = A.bz
    L = slab_layers(mz, nparts, bz, z_align)
    if L is None:
        return None
    myp, mxp = A.myp, A.mxp
    layer = myp * mxp

    # The correction keeps the operator's storage (bfloat16 when exact).
    corr3 = A.corr.reshape(A.Z, myp, mxp)
    corr_full = corr3.new_zeros((nparts * L, myp, mxp))
    corr_full[:mz] = corr3[1: mz + 1]
    corr_ext = corr3.new_zeros((nparts, L + 2, myp, mxp))
    corr_ext[:, 1: L + 1] = corr_full.reshape(nparts, L, myp, mxp)

    zlims = np.zeros((nparts, 1, 2), np.int32)
    for p_i in range(nparts):
        zlims[p_i, 0] = (1, int(np.clip(mz - p_i * L, 0, L)))

    d = A.diagonal_padded(fill=1.0).to(torch.float32).reshape(
        A.Z, myp, mxp)[1: mz + 1]
    d_full = torch.ones((nparts * L, myp, mxp), dtype=torch.float32,
                        device=d.device)
    d_full[:mz] = torch.where(d != 0, d, torch.ones_like(d))
    inv_diag = (1.0 / d_full).reshape(nparts, L * layer)

    meta = dict(taps=A.taps, groups=A.groups, group_const=A.group_const,
                period=A.period)
    if mesh is None:
        mesh = make_device_mesh(nparts, [A.corr.device])
    return SlabPadPlan(
        nparts=nparts, L=L, dims=A.dims, myp=myp, mxp=mxp, bz=bz,
        quads=A.quads.cpu().numpy().astype(np.float32), zlims=zlims,
        corr_ext=mesh.local(corr_ext.reshape(nparts, (L + 2) * myp, mxp)),
        inv_diag=mesh.local(inv_diag), meta=meta, mesh=mesh,
        pats=A.pats.to(torch.float32), const_vals=A.const_vals.to(
            torch.float32),
    )


def slab_pad_cg_solve(plan: SlabPadPlan, b: np.ndarray, x0: np.ndarray, *,
                      mesh: Optional[DeviceMesh] = None, tol: float = 1e-12,
                      maxiter: int = 1000, jacobi: bool = True):
    """CG over the slabs with kernel 3 as each part's product, float32, on
    the plan's device over its mesh (``mesh``, if given, must be that
    one).  Returns ``(x_host, CGResult)``."""
    mesh = plan_mesh(plan, mesh)
    op = plan.make_ops()
    M = DiagonalPreconditioner(plan.inv_diag) if jacobi else None
    res = cg_solve(op, plan.put_vector(b), plan.put_vector(x0), precond=M,
                   tol=tol, maxiter=maxiter, dot=mesh.dot)
    return plan.gather_vector(res.x), res
