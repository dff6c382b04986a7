"""The lattice stencil over a padded 3-D vector space: kernel 3 of the port.

Counterpart of the JAX package's ``ops/pallas/stencil_kernel.py``.  The
operator owns a padded 3-D vector space, as the sliced-ELL operator owns a
permuted one:

    slot(iz, iy, ix) = ((iz + 1) * myp + 1 + iy) * mxp + ix
    myp = round8(my + 2)   mxp = round128(mx + 1)   Z = round_bz(mz + 2)

with JAX's ``bz`` rule, so both packages have the same vector space.  Every
neighbour of a real node lies inside the space, and every pad slot holds 0
(the pad-slot invariant: ``put_vector`` writes zeros there and every
product writes zeros there), so a neighbour across the grid's edge reads 0
and the product needs no range masks.  A ``dx = -1`` neighbour of
``ix = 0`` is the previous row's last lane, a pad slot since
``mxp >= mx + 1``.

On a CUDA tensor :meth:`PadStencilOperator.matvec` launches the
hand-written kernel (``csrc/pad_stencil.cu`` through :mod:`._kernels`), in
float for f32 vectors and in double for f64 vectors (the f64 residual of
``solvers/mixed.py``), or raises; on a CPU tensor it evaluates
:meth:`PadStencilOperator.matvec_reference`, JAX's reference: the
identity-layout stencil on the extracted interior, embedded back, plus
``corr * x``.  The TPU kernel's roll factoring and DMA ring exist because
of VMEM and lane rolls and are not carried over.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.timers import spanned, to_device
from .ell import fetch_vector, stage_vector
from .stencil import StencilOperator, _pattern_field, stencil_core

__all__ = [
    "PadStencilOperator",
    "kernel_tables",
    "pad_stencil_from_parts",
    "pad_stencil_from_stencil",
    "pad_stencil_spmv",
    "pad_window_reference",
    "pad_window_spmv",
]


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


@dataclasses.dataclass
class PadStencilOperator:
    """Lattice-stencil operator over the padded 3-D vector space.

    ``pats``/``taps``/``groups``/``group_const``/``period`` have
    :class:`.stencil.StencilOperator` semantics (the reference evaluation).
    ``quads`` holds the per-group pattern scalars ``[g, zp*4 + yp*2 + xp]``
    the kernel reads (period-1 patterns replicated across the parity axes).
    ``corr`` is the diagonal correction embedded in the padded space,
    bfloat16 when bit-exact, else float32.
    """

    pats: torch.Tensor  # (ndiags, p, p, p) f32
    const_vals: torch.Tensor  # (n_groups,) f32
    quads: torch.Tensor  # (n_groups, 8) f32: [g, zp*4 + yp*2 + xp]
    corr: torch.Tensor  # (n_pad,) f32 or bf16
    taps: Tuple[Tuple[int, int, int], ...]
    groups: Tuple[Tuple[int, ...], ...]
    group_const: Tuple[bool, ...]
    dims: Tuple[int, int, int]
    period: int
    myp: int
    mxp: int
    bz: int
    n_rows: int  # logical DOF count mx*my*mz
    _tables: Optional[tuple] = dataclasses.field(default=None, repr=False)

    # -- padded-space geometry -------------------------------------------
    @property
    def Z(self) -> int:
        return _round_up(self.dims[2] + 2, self.bz)

    @property
    def n_pad(self) -> int:
        """Internal vector length (the operator's padded space)."""
        return self.Z * self.myp * self.mxp

    @property
    def n_cols(self) -> int:
        return self.n_rows

    @property
    def dtype(self) -> torch.dtype:
        return torch.float32

    @property
    def device(self) -> torch.device:
        return self.corr.device

    # -- host <-> device vector interface ----------------------------------
    @spanned("request.put")
    def put_vector(self, x, dtype=torch.float32) -> torch.Tensor:
        """Host (mz*my*mx,) vector -> padded space: the real entries go up
        (:func:`.ell.stage_vector`) and are padded on the device."""
        xd = stage_vector(x, self.device, dtype)
        return self.embed_device(xd.view(self.n_rows))

    @spanned("request.put")
    def put_vector_sparse(self, x, dtype=torch.float32) -> torch.Tensor:
        """Like :meth:`put_vector`, but ships only the nonzeros when the
        vector is sparse enough (a boundary-driven right-hand side)."""
        x = np.asarray(x)
        nz = np.flatnonzero(x)
        if nz.size >= 0.25 * x.size:
            return self.put_vector(x, dtype)
        out = torch.zeros(self.n_pad, dtype=dtype, device=self.device)
        slots = to_device(torch.from_numpy(self._slots(nz)), self.device)
        out[slots] = to_device(torch.as_tensor(x[nz]).to(dtype), self.device)
        return out

    @spanned("request.get")
    def get_vector(self, xp: torch.Tensor) -> np.ndarray:
        return fetch_vector(self.extract_device(xp))

    def embed_device(self, x3_flat: torch.Tensor) -> torch.Tensor:
        """(mz*my*mx,) interior (lexicographic) -> padded space, on device."""
        mx, my, mz = self.dims
        x3 = x3_flat[: mx * my * mz].reshape(mz, my, mx)
        return torch.nn.functional.pad(
            x3,
            (0, self.mxp - mx, 1, self.myp - my - 1, 1, self.Z - mz - 1),
        ).reshape(-1)

    def extract_device(self, xp: torch.Tensor) -> torch.Tensor:
        """Padded space -> (mz*my*mx,) interior, on device."""
        mx, my, mz = self.dims
        x3 = xp.reshape(self.Z, self.myp, self.mxp)
        return x3[1 : mz + 1, 1 : my + 1, :mx].reshape(-1)

    def pad_mask(self) -> torch.Tensor:
        """1.0 on real DOF slots, 0.0 on padding (device)."""
        mx, my, mz = self.dims
        return self.embed_device(
            torch.ones(mx * my * mz, dtype=torch.float32, device=self.device)
        )

    def _slots(self, idx: np.ndarray) -> np.ndarray:
        mx, my, _mz = self.dims
        iz, r = np.divmod(idx, mx * my)
        iy, ix = np.divmod(r, mx)
        return ((iz + 1) * self.myp + iy + 1) * self.mxp + ix

    def space_map(self) -> np.ndarray:
        """Internal slot of every logical (lexicographic) DOF: consumers
        that build per-row arrays (AMG transfers, Jacobi diagonals) scatter
        them with ``arr_pad[space_map()] = arr``."""
        return self._slots(np.arange(self.n_rows, dtype=np.int64))

    def diagonal_padded(self, fill: float = 1.0) -> torch.Tensor:
        d = self.corr.to(torch.float32)
        mask = self.pad_mask()
        if (0, 0, 0) in self.taps:
            didx = self.taps.index((0, 0, 0))
            c = _pattern_field(self.pats[didx].to(torch.float32), self.dims,
                               self.period)
            d = d + self.embed_device(c.reshape(-1))
        d = torch.where((mask > 0) & (d == 0), torch.full_like(d, fill), d)
        return torch.where(mask > 0, d, torch.full_like(d, fill))

    # -- products ------------------------------------------------------------
    def matvec(self, x_padded: torch.Tensor) -> torch.Tensor:
        return pad_stencil_spmv(self, x_padded)

    def matvec_reference(self, x_padded: torch.Tensor) -> torch.Tensor:
        """Plain PyTorch evaluation in the same padded space, in the dtype
        of ``x`` (the kernel's plain version; needs the pad-slot
        invariant)."""
        y3 = stencil_core(
            self.extract_device(x_padded).reshape(
                self.dims[2], self.dims[1], self.dims[0]),
            None, None, self.period, self.taps, self.groups,
            self.group_const, self.const_vals, self.pats, x_padded.dtype,
        )
        y = self.embed_device(y3.reshape(-1))
        return y + self.corr.to(x_padded.dtype) * x_padded

    def kernel_tables(self):
        """Host tables the kernel launch packs into its parameters
        (:func:`kernel_tables`), built once."""
        if self._tables is None:
            self._tables = kernel_tables(self.taps, self.groups, self.quads)
        return self._tables


def kernel_tables(taps, groups, quads):
    """The pad-stencil kernel's host tables: taps ``(dx, dy, dz)`` in group
    order (int32), each group's first tap (int32, length n_groups + 1) and
    the per-group pattern scalars ``quads`` (float32)."""
    order = [d for g in groups for d in g]
    tap_arr = np.array([taps[d] for d in order], dtype=np.int32).reshape(-1, 3)
    start = np.zeros(len(groups) + 1, dtype=np.int32)
    np.cumsum([len(g) for g in groups], out=start[1:])
    if isinstance(quads, torch.Tensor):
        quads = quads.cpu().numpy()
    quads = np.ascontiguousarray(quads, dtype=np.float32)
    return np.ascontiguousarray(tap_arr), start, quads


def pad_stencil_spmv(A: PadStencilOperator,
                     x_padded: torch.Tensor) -> torch.Tensor:
    """y = A @ x in the padded 3-D space, in the dtype of ``x`` (float32 or
    float64).  A CUDA tensor goes to the hand-written kernel (which raises
    on failure); a CPU tensor to :meth:`PadStencilOperator.matvec_reference`."""
    if x_padded.dim() != 1 or x_padded.numel() != A.n_pad:
        raise ValueError(
            f"pad-stencil matvec takes a ({A.n_pad},) vector, got "
            f"{tuple(x_padded.shape)}"
        )
    if x_padded.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported vector dtype {x_padded.dtype}")
    if x_padded.device != A.device:
        raise ValueError(f"x is on {x_padded.device}, the operator on {A.device}")
    if x_padded.device.type == "cpu":
        return A.matvec_reference(x_padded)
    if x_padded.device.type != "cuda":
        raise ValueError(f"no pad-stencil product for device {x_padded.device}")
    from ._kernels import pad_stencil_launch

    return pad_stencil_launch(A, x_padded.contiguous())


def pad_window_reference(A, x_win: torch.Tensor, corr_win: torch.Tensor,
                         mz: int) -> torch.Tensor:
    """Plain PyTorch product on one window of a z-slab (the plain version
    of :func:`.._kernels.pad_stencil_window_launch`), in the dtype of
    ``x_win``: the window's layers ``1..mz`` are the rows, its layers 0 and
    ``mz + 1`` their z-neighbours, and every other slot of the result is
    0.  ``A`` supplies the stencil (``pats``, ``const_vals``, ``taps``,
    ``groups``, ``group_const``, ``period``), ``dims`` (mx, my) and the
    padded extents."""
    mx, my = A.dims[0], A.dims[1]
    x3 = x_win.reshape(-1, A.myp, A.mxp)
    y3 = torch.zeros_like(x3)
    if mz > 0:
        inner = x3[:, 1 : my + 1, :mx]
        y = stencil_core(
            inner[1 : mz + 1], inner[0], inner[mz + 1], A.period, A.taps,
            A.groups, A.group_const, A.const_vals, A.pats, x_win.dtype,
        )
        c = corr_win.reshape(x3.shape)[1 : mz + 1, 1 : my + 1, :mx]
        y3[1 : mz + 1, 1 : my + 1, :mx] = y + c.to(x_win.dtype) * inner[
            1 : mz + 1]
    return y3.reshape(-1)


def pad_window_spmv(A, x_win: torch.Tensor, corr_win: torch.Tensor, mz: int,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The product on one window of a z-slab (see
    :func:`pad_window_reference`): the pad-stencil kernel on a CUDA tensor,
    the plain version on a CPU tensor (written to ``out`` when given)."""
    if x_win.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported vector dtype {x_win.dtype}")
    if x_win.device.type == "cpu":
        y = pad_window_reference(A, x_win, corr_win, mz)
        if out is None:
            return y
        out.copy_(y)
        return out
    if x_win.device.type != "cuda":
        raise ValueError(f"no pad-stencil product for device {x_win.device}")
    from ._kernels import pad_stencil_window_launch

    return pad_stencil_window_launch(A, x_win, corr_win, mz, out=out)


def _build_group_quads(period: int, pats_in, groups) -> np.ndarray:
    """Per-group pattern scalars ``[g, zp*4 + yp*2 + xp]``, a period-1
    pattern replicated across the parity axes."""
    p = period
    if p not in (1, 2):
        raise ValueError(f"lattice period must be 1 or 2, got {p}")
    pats = np.asarray(pats_in, dtype=np.float32)
    nq = np.zeros((len(groups), 8), dtype=np.float32)
    for g, tap_idx in enumerate(groups):
        pat = pats[tap_idx[0]]  # (p, p, p) [iz%p, iy%p, ix%p]
        for zp in range(2):
            for yp in range(2):
                for xp in range(2):
                    nq[g, zp * 4 + yp * 2 + xp] = pat[zp % p, yp % p, xp % p]
    return nq


def pad_stencil_from_stencil(st: StencilOperator, bz: int = 8,
                             corr_storage: str = "auto",
                             device=None) -> PadStencilOperator:
    """Repack an (already verified) identity-layout stencil operator into
    the padded 3-D layout (on ``st``'s device unless ``device`` is given)."""
    parts = dict(
        pats=st.pats.cpu().numpy().astype(np.float32),
        const_vals=st.const_vals.cpu().numpy().astype(np.float32),
        corr_pad=st.corr.cpu().numpy().astype(np.float32),
        taps=st.taps,
        groups=st.groups,
        group_const=st.group_const,
        dims=st.dims,
        period=st.period,
        n_rows=st.n_rows,
        n_pad=st.n_pad,
    )
    return pad_stencil_from_parts(
        parts, bz=bz, corr_storage=corr_storage,
        device=st.device if device is None else device,
    )


def pad_stencil_from_parts(parts: dict, bz: int = 8,
                           corr_storage: str = "auto",
                           device=None) -> PadStencilOperator:
    """Host stencil decomposition (``stencil_parts_from_packed``, the port's
    or the JAX package's dict, or the ``parts`` of
    :func:`..models.structured.structured_box_parts`, whose ``corr_pad``
    may be a tensor: it is downloaded, as JAX downloads it) -> padded-3-D
    operator on ``device`` (by default the card).  ``bz`` (even) follows
    JAX's rule: shrunk until JAX's VMEM estimate fits, so both packages
    build the same space."""
    dev = resolve_device(device)
    mx, my, mz = (int(v) for v in parts["dims"])
    myp = _round_up(my + 2, 8)
    mxp = _round_up(mx + 1, 128)
    n = mx * my * mz

    corr_src = parts["corr_pad"][:n]
    if isinstance(corr_src, torch.Tensor):  # structured_box_parts(device=...)
        corr_src = corr_src.cpu().numpy()
    corr_host = np.asarray(corr_src, dtype=np.float32)
    if corr_storage == "auto":
        from .dia import _bf16_exact

        corr_storage = "bfloat16" if _bf16_exact(corr_host) else "float32"
    corr_b = 2 if corr_storage == "bfloat16" else 4

    def vmem_bytes(b):  # JAX's estimate, kept so Z (the space) matches
        scratch = 2 * (b + 6) * myp * mxp * 4
        blocks = 2 * b * myp * mxp * (4 + corr_b)
        return scratch + blocks

    while bz > 2 and vmem_bytes(bz) > 10 * 2**20:
        bz -= 2
    if bz % 2:
        raise ValueError("bz must be even (z-parity is static per layer)")
    Z = _round_up(mz + 2, bz)

    # The correction is nonzero only on grid-boundary rows; when sparse
    # enough it ships as (slot, value) pairs and scatters on the device.
    nz = np.flatnonzero(corr_host)
    n_slots = Z * myp * mxp
    if nz.size < 0.25 * n:
        iz, r = np.divmod(nz, mx * my)
        iy, ix = np.divmod(r, mx)
        slots = ((iz + 1) * myp + iy + 1) * mxp + ix
        corr = torch.zeros(n_slots, dtype=torch.float32, device=dev)
        corr[torch.from_numpy(slots).to(dev)] = torch.from_numpy(
            corr_host[nz]).to(dev)
    else:
        corr3 = np.zeros((Z, myp, mxp), dtype=np.float32)
        corr3[1 : mz + 1, 1 : my + 1, :mx] = corr_host.reshape(mz, my, mx)
        corr = torch.from_numpy(corr3.reshape(-1)).to(dev)
    if corr_storage == "bfloat16":
        corr = corr.to(torch.bfloat16)

    quads = _build_group_quads(int(parts["period"]), parts["pats"],
                               parts["groups"])
    return PadStencilOperator(
        pats=torch.as_tensor(np.asarray(parts["pats"], np.float32)).to(dev),
        const_vals=torch.as_tensor(
            np.asarray(parts["const_vals"], np.float32)).to(dev),
        quads=torch.from_numpy(quads).to(dev),
        corr=corr,
        taps=tuple(tuple(int(v) for v in t) for t in parts["taps"]),
        groups=tuple(tuple(int(v) for v in g) for g in parts["groups"]),
        group_const=tuple(bool(c) for c in parts["group_const"]),
        dims=(mx, my, mz),
        period=int(parts["period"]),
        myp=myp,
        mxp=mxp,
        bz=bz,
        n_rows=n,
    )
