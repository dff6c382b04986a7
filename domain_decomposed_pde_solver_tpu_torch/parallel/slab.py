"""Slab-partitioned banded operators: contiguous row slabs over the parts.

Counterpart of the JAX package's ``parallel/slab.py``.  For a banded
matrix (the DIA form of a structured mesh) the natural decomposition is
contiguous row slabs: every coupling stays within the bandwidth, so a part
only reads from its two neighbours.  JAX exchanges an H-wide strip with
two ``lax.ppermute`` shifts inside ``shard_map``; the port drives all P
parts from one controller on one device (``parallel/sharded.py``), so

- a slab vector is a ``(P, slab)`` tensor, JAX's owned-only stacked space
  (``scatter_vector`` / ``gather_vector``);
- the exchange is an explicit function on it: part p receives p - 1's
  last strip and p + 1's first strip, the ring ends zeros
  (:func:`neighbour_strips`; over a mesh of several processes a local
  ``(k, slab)`` tensor, with the outer strips from the neighbouring
  processes, :func:`.collectives.ring_strips`);
- dots are :func:`.sharded.psum_dot`, added in part order.

Every slab engine runs across processes: over a mesh of several, each
process uploads only its slabs and gets the full answer back.  The slab
plans here are host arrays, laid out at solve time over the mesh given;
the hierarchies (:mod:`.slabamg`, :mod:`.slabpad` and the others) upload
at build time and keep the mesh they were built over (:func:`plan_mesh`).

Two slab operators, both plain PyTorch as in JAX (XLA static slices there,
no Pallas kernel): :class:`SlabDIAOperator`, the DIA product over the
extended slab ``[left | own | right]``, and :class:`SlabStencilOperator`,
the pattern-broadcast lattice stencil over whole z-layers with one-layer
halos.  The pad-stencil kernel's slab form is :mod:`.slabpad`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.dia import DIAMatrix, _torch_dtype, pack_dia_host
from ..ops.stencil import stencil_core
from ..solvers.cg import cg_solve
from ..solvers.precond.jacobi import DiagonalPreconditioner
from .collectives import ring_strips
from .sharded import DeviceMesh, across_processes, all_parts, make_device_mesh

__all__ = [
    "SlabDIAOperator",
    "SlabDIAPlan",
    "SlabStencilOperator",
    "build_slab_plan",
    "build_slab_stencil",
    "neighbour_strips",
    "slab_cg_solve",
    "slab_stencil_cg_solve",
]


def neighbour_strips(x: torch.Tensor, width: int,
                     mesh: Optional[DeviceMesh] = None):
    """The ring exchange of a ``(P, slab)`` vector (JAX's two
    ``ppermute`` shifts): ``(left, right)``, each ``(P, width)``, with
    ``left[p]`` part p - 1's last ``width`` entries and ``right[p]`` part
    p + 1's first, zeros at the ring ends.  Over a ``mesh`` of several
    processes ``x`` holds the local parts ``(k, slab)``, and the first and
    last local parts get their outer strips from the neighbouring
    processes."""
    P_ = x.shape[0]
    left = x.new_zeros((P_, width))
    right = x.new_zeros((P_, width))
    if P_ > 1:
        left[1:] = x[:-1, x.shape[1] - width:]
        right[:-1] = x[1:, :width]
    if across_processes(x, mesh):
        left[0], right[-1] = ring_strips(x[0, :width],
                                         x[-1, x.shape[1] - width:])
    return left, right


def _brick_counts(dims, brick: int):
    mx, my, mz = dims
    return -(-mx // brick), -(-my // brick), -(-mz // brick)


def brick_expand(xc: torch.Tensor, dims: Tuple[int, int, int], brick: int,
                 pad: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The brick tentative transfer of every part (unit weights): ``(P,
    nc)`` brick values -> ``(P, slab)``, each brick's value on its nodes of
    the part's ``dims = (mx, my, mz)`` grid.  ``pad = (myp, mxp)``: the
    padded slab layout (row 0 and the slots past ``my``, ``mx`` hold 0);
    None: the compact lexicographic layout."""
    mx, my, mz = dims
    ncx, ncy, ncz = _brick_counts(dims, brick)
    P_ = xc.shape[0]
    z = xc.reshape(P_, ncz, ncy, ncx)
    z = z.repeat_interleave(brick, dim=1)[:, :mz]
    z = z.repeat_interleave(brick, dim=2)[:, :, :my]
    z = z.repeat_interleave(brick, dim=3)[:, :, :, :mx]
    if pad is not None:
        myp, mxp = pad
        z = torch.nn.functional.pad(z, (0, mxp - mx, 1, myp - my - 1))
    return z.reshape(P_, -1)


def brick_sum(w: torch.Tensor, dims: Tuple[int, int, int], brick: int,
              pad: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The transpose of :func:`brick_expand`: ``(P, slab)`` -> ``(P,
    nc)``, each brick's sum over its nodes (pad slots ignored)."""
    mx, my, mz = dims
    ncx, ncy, ncz = _brick_counts(dims, brick)
    P_ = w.shape[0]
    if pad is None:
        t = w.reshape(P_, mz, my, mx)
    else:
        myp, mxp = pad
        t = w.reshape(P_, mz, myp, mxp)[:, :, 1: my + 1, :mx]
    b = brick
    t = torch.nn.functional.pad(
        t, (0, ncx * b - mx, 0, ncy * b - my, 0, ncz * b - mz))
    return t.reshape(P_, ncz, b, ncy, b, ncx, b).sum(
        dim=(2, 4, 6)).reshape(P_, -1)


def _upload(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype)


@dataclasses.dataclass
class SlabDIAPlan:
    """Host-side description of a P-way contiguous slab split of a DIA
    matrix (JAX's fields, numpy arrays)."""

    nparts: int
    n: int  # logical rows
    slab: int  # rows per part (padded)
    halo: int  # H >= max |offset|
    offsets: Tuple[int, ...]
    data: np.ndarray  # (P, ndiags, slab)

    def scatter_vector(self, x: np.ndarray, dtype=None) -> np.ndarray:
        out = np.zeros((self.nparts, self.slab),
                       dtype=np.asarray(x).dtype if dtype is None else dtype)
        out.reshape(-1)[: self.n] = x
        return out

    def gather_vector(self, x_parts) -> np.ndarray:
        if isinstance(x_parts, torch.Tensor):
            x_parts = x_parts.detach().cpu().numpy()
        return np.asarray(x_parts).reshape(-1)[: self.n]


def _dia_host(A: DIAMatrix, dtype) -> np.ndarray:
    """A port ``DIAMatrix``'s diagonals as a host array in ``dtype`` (its
    storage may be bfloat16, which numpy lacks)."""
    return A.data.to(_torch_dtype(dtype)).cpu().numpy()


def build_slab_plan(A, nparts: int, dtype=np.float32,
                    row_align: int = 8) -> Optional[SlabDIAPlan]:
    """The slab plan of ``A`` (a CSR matrix or a port ``DIAMatrix``); None
    if the matrix has no DIA form (more than 64 diagonals) or its slabs
    would be thinner than the bandwidth.

    ``row_align``: slabs are padded to a multiple of this (``mx*my`` of a
    lexicographic grid makes every slab whole z-layers, as the brick
    preconditioner of :mod:`.slabbrick` needs)."""
    if isinstance(A, DIAMatrix):
        n = A.n_rows
        offsets = tuple(int(o) for o in A.offsets)
        data_full = _dia_host(A, dtype)[:, :n]
    else:
        packed = pack_dia_host(A, dtype=_torch_dtype(dtype))
        if packed is None:
            return None
        n = A.n_rows
        offsets = tuple(int(o) for o in packed[0])
        data_full = np.asarray(packed[1])[:, :n]
    H = max(max(abs(o) for o in offsets), 1)
    H = ((H + 7) // 8) * 8
    slab = -(-n // nparts)
    slab = -(-slab // row_align) * row_align
    if slab < H:
        # Slabs thinner than the bandwidth would need more than the two
        # neighbours; refuse (the caller takes the general route).
        return None
    data = np.zeros((nparts, len(offsets), slab), dtype=np.dtype(dtype))
    for p in range(nparts):
        lo = p * slab
        hi = min(lo + slab, n)
        if lo < n:
            data[p, :, : hi - lo] = data_full[:, lo:hi]
    return SlabDIAPlan(nparts=nparts, n=n, slab=slab, halo=H, offsets=offsets,
                       data=data)


@dataclasses.dataclass
class SlabDIAOperator:
    """The slab DIA product over all parts: ``data`` is ``(P, ndiags,
    slab)`` on the device; ``matvec`` takes and returns ``(P, slab)``.
    ``mesh``: over several processes, ``data`` and the vectors hold the
    mesh's local parts."""

    data: torch.Tensor
    offsets: Tuple[int, ...]
    halo: int
    slab: int
    mesh: Optional[DeviceMesh] = None

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        H, S = self.halo, self.slab
        left, right = neighbour_strips(x, H, self.mesh)
        x_ext = torch.cat([left, x, right], dim=1)  # (P, S + 2H)
        y = torch.zeros_like(x)
        for d, off in enumerate(self.offsets):
            win = x_ext[:, H + off: H + off + S]
            y = y + self.data[:, d].to(x.dtype) * win
        return y


@dataclasses.dataclass
class SlabStencilOperator:
    """The slab lattice-stencil product over all parts, whole z-layers per
    part (``dims_local = (mx, my, mz_p)``).

    The counterpart of :class:`..ops.stencil.StencilOperator` over slabs:
    the halo is one z-layer per neighbour (the stencil's ``|dz| <= 1``),
    each part's product is :func:`..ops.stencil.stencil_core` on its layers
    with those two strips, plus ``corr * x``; ``mask`` zeroes the rows past
    the global grid so dots stay exact.  ``corr`` and ``mask`` are ``(P,
    slab)``; over a ``mesh`` of several processes, the local parts'."""

    pats: torch.Tensor  # (ndiags, p, p, p)
    const_vals: torch.Tensor  # (n_groups,)
    corr: torch.Tensor  # (P, slab)
    mask: torch.Tensor  # (P, slab) 1 on real rows, 0 on padding
    taps: tuple
    groups: tuple
    group_const: tuple
    dims_local: Tuple[int, int, int]
    period: int
    mesh: Optional[DeviceMesh] = None

    @property
    def slab(self) -> int:
        mx, my, mz_p = self.dims_local
        return mx * my * mz_p

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        mx, my, mz_p = self.dims_local
        lo, hi = neighbour_strips(x, mx * my, self.mesh)
        y = torch.stack([
            stencil_core(
                x[p].reshape(mz_p, my, mx), lo[p].reshape(my, mx),
                hi[p].reshape(my, mx), self.period, self.taps, self.groups,
                self.group_const, self.const_vals, self.pats, x.dtype,
            ).reshape(-1)
            for p in range(x.shape[0])
        ])
        return self.mask * (y + self.corr * x)


def build_slab_stencil(S, nparts: int, row_align_layers: int = 1):
    """Split a :class:`..ops.stencil.StencilOperator` into P z-layer
    slabs: ``(dims_local, corr (P, slab), mask (P, slab), stencil_meta)``
    as float32 host arrays, or None when the z-extent cannot be split into
    slabs of at least two layers.  Each slab's layer count is a multiple
    of ``row_align_layers`` and of the stencil's period."""
    mx, my, mz = S.dims
    p = S.period
    align = int(np.lcm(row_align_layers, p))
    mz_p = -(-mz // nparts)
    mz_p = -(-mz_p // align) * align
    if mz_p < 2:  # a slab must cover more than the halo depth
        return None
    slab = mx * my * mz_p
    n = S.n_rows
    corr_full = np.zeros(nparts * slab, dtype=np.float32)
    corr_full[:n] = S.corr.cpu().numpy()[:n]
    mask_full = np.zeros(nparts * slab, dtype=np.float32)
    mask_full[:n] = 1.0
    meta = dict(taps=S.taps, groups=S.groups, group_const=S.group_const,
                dims_local=(mx, my, mz_p), period=p)
    return ((mx, my, mz_p), corr_full.reshape(nparts, slab),
            mask_full.reshape(nparts, slab), meta)


def _mesh(mesh: Optional[DeviceMesh], nparts: int) -> DeviceMesh:
    if mesh is None:
        return make_device_mesh(nparts)
    if mesh.nparts != nparts:
        raise ValueError(f"mesh of {mesh.nparts} parts for {nparts} slabs")
    return mesh


def plan_mesh(plan, mesh: Optional[DeviceMesh]) -> DeviceMesh:
    """The mesh ``plan`` (a slab plan or hierarchy on a device: ``mesh``,
    ``nparts``, ``device``) holds its parts over: its ``mesh``, or one
    process over all its parts on its device for a plan made without one;
    a ``mesh`` given must be that one (another size, device or process
    layout raises)."""
    own = plan.mesh or DeviceMesh(plan.nparts, plan.device)
    if mesh is not None and mesh != own:
        raise ValueError(
            f"mesh of {mesh.nparts} parts on {mesh.device} (process "
            f"{mesh.rank} of {mesh.world}) for a plan of {own.nparts} parts "
            f"on {own.device} (process {own.rank} of {own.world})")
    return own


def slab_stencil_cg_solve(S, nparts: int, b: np.ndarray, x0: np.ndarray, *,
                          mesh: Optional[DeviceMesh] = None,
                          tol: float = 1e-12, maxiter: int = 1000,
                          jacobi: bool = True):
    """CG over z-layer slabs of a lattice-stencil operator, in float32 as
    JAX's (its vectors, correction and patterns are float32 whatever the
    operator's dtype).  Returns ``(x_host, CGResult)`` or None if the
    operator cannot be split into layer slabs.  Over a ``mesh`` of several
    processes each uploads only its slabs, the result's ``x`` is its
    ``(k, slab)`` iterate and ``x_host`` the full answer."""
    built = build_slab_stencil(S, nparts)
    if built is None:
        return None
    dims_local, corr_p, mask_p, meta = built
    slab = corr_p.shape[1]
    n = S.n_rows
    mesh = _mesh(mesh, nparts)
    dev = mesh.device

    def scatter(v):
        out = np.zeros((nparts, slab), dtype=np.float32)
        out.reshape(-1)[:n] = v
        return _upload(mesh.local(out), dev)

    d = S.diagonal_padded(fill=1.0).cpu().numpy()[:n]
    inv_d = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 1.0)
    op = SlabStencilOperator(
        pats=S.pats.to(device=dev, dtype=torch.float32),
        const_vals=S.const_vals.to(device=dev, dtype=torch.float32),
        corr=_upload(mesh.local(corr_p), dev),
        mask=_upload(mesh.local(mask_p), dev), mesh=mesh, **meta)
    M = (DiagonalPreconditioner(scatter(inv_d.astype(np.float32)))
         if jacobi else None)
    res = cg_solve(op, scatter(np.asarray(b, np.float32)),
                   scatter(np.asarray(x0, np.float32)), precond=M, tol=tol,
                   maxiter=maxiter, dot=mesh.dot)
    return all_parts(res.x, mesh).cpu().numpy().reshape(-1)[:n], res


def slab_cg_solve(plan: SlabDIAPlan, b: np.ndarray, x0: np.ndarray, *,
                  mesh: Optional[DeviceMesh] = None, tol: float = 1e-12,
                  maxiter: int = 1000, jacobi: bool = True,
                  brick_precond=None):
    """CG over the slab DIA decomposition, in the plan's dtype.

    ``brick_precond``: a :class:`.slabbrick.SlabBrickPrecond`; every part
    then preconditions with its communication-free two-level brick cycle
    instead of Jacobi.  Over a ``mesh`` of several processes
    each uploads only its slabs (JAX's ``multihost_slab_cg_solve``), the
    result's ``x`` is its ``(k, slab)`` iterate and ``x_host`` the full
    answer.  Returns ``(x_host, CGResult)``."""
    mesh = _mesh(mesh, plan.nparts)
    dev = mesh.device
    data = _upload(mesh.local(plan.data), dev)
    op = SlabDIAOperator(data=data, offsets=plan.offsets, halo=plan.halo,
                         slab=plan.slab, mesh=mesh)
    dt = plan.data.dtype
    b_s = _upload(mesh.local(plan.scatter_vector(b, dtype=dt)), dev)
    x0_s = _upload(mesh.local(plan.scatter_vector(x0, dtype=dt)), dev)
    if brick_precond is not None:
        M = brick_precond.block(dev, mesh)
    elif jacobi:
        if 0 in plan.offsets:
            d = data[:, plan.offsets.index(0)]
        else:
            d = torch.ones_like(b_s)
        inv = torch.where(d != 0, 1.0 / torch.where(d == 0, 1.0, d), 1.0)
        M = DiagonalPreconditioner(inv)
    else:
        M = None
    res = cg_solve(op, b_s, x0_s, precond=M, tol=tol, maxiter=maxiter,
                   dot=mesh.dot)
    return plan.gather_vector(all_parts(res.x, mesh)), res
