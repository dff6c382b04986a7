"""Lattice-stencil operator with pattern-broadcast coefficients.

Counterpart of the JAX package's ``ops/stencil.py``.  On a regular grid
every interior row of the heat operator repeats one of a few coefficient
patterns, chosen by the node's parity class ``(ix%p, iy%p, iz%p)`` (p = 1
or 2), and boundary rows deviate only on the main diagonal.  Hence exactly

    y  =  sum_d  pattern_d(parity) * shift(x, d)  +  corr * x

with the patterns broadcast (never stored per row) and ``corr`` the
elementwise diagonal correction.  :func:`stencil_parts_from_packed` verifies
the decomposition entry by entry against the DIA data and returns None
when the matrix is not such a stencil.

JAX evaluates :class:`StencilOperator` in XLA, outside any Pallas kernel,
so the port evaluates it in plain PyTorch on whatever device its arrays
live on.  The padded-3-D form with its own kernel is
:mod:`.stencil_kernel`.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .csr import CSRMatrix
from .ell import PaddedLayout, pad_to

__all__ = [
    "StencilOperator",
    "stencil_core",
    "stencil_from_csr",
    "stencil_from_dia",
    "stencil_from_packed",
    "stencil_from_parts",
    "stencil_parts_from_packed",
]


def _tree_sum(terms):
    while len(terms) > 1:
        nxt = [a + b for a, b in zip(terms[::2], terms[1::2])]
        if len(terms) % 2:
            nxt.append(terms[-1])
        terms = nxt
    return terms[0]


@dataclasses.dataclass
class StencilOperator(PaddedLayout):
    """Lattice-stencil operator: pattern-broadcast shifts + diagonal
    correction, in the identity (lexicographic, zero-padded) space.

    ``pats``: (ndiags, p, p, p) periodic coefficient patterns (class order
    ``[iz%p, iy%p, ix%p]``).  ``taps``: ((dx, dy, dz), ...) per diagonal.
    ``corr``: (n_pad,) diagonal correction (0 on interior rows and
    padding).  ``dims`` = (mx, my, mz), node id ``ix + mx*(iy + my*iz)``.
    ``groups``/``group_const``/``const_vals``: taps grouped by identical
    pattern; a group's shifted windows are summed before its coefficient
    multiply, and constant patterns multiply by a scalar.
    """

    pats: torch.Tensor
    const_vals: torch.Tensor  # (n_groups,) scalar per group (0 if non-const)
    corr: torch.Tensor
    taps: Tuple[Tuple[int, int, int], ...]
    groups: Tuple[Tuple[int, ...], ...]
    group_const: Tuple[bool, ...]
    dims: Tuple[int, int, int]
    period: int
    n_rows: int
    n_pad: int

    @property
    def n_cols(self) -> int:
        return self.n_rows

    @property
    def dtype(self) -> torch.dtype:
        return self.corr.dtype

    @property
    def device(self) -> torch.device:
        return self.corr.device

    def matvec(self, x_padded: torch.Tensor) -> torch.Tensor:
        mx, my, mz = self.dims
        x3 = x_padded[: self.n_rows].reshape(mz, my, mx)
        y = stencil_core(
            x3, None, None, self.period, self.taps, self.groups,
            self.group_const, self.const_vals, self.pats, x_padded.dtype,
        ).reshape(-1)
        y = torch.nn.functional.pad(y, (0, self.n_pad - self.n_rows))
        return y + self.corr.to(x_padded.dtype) * x_padded

    def diagonal_padded(self, fill: float = 1.0) -> torch.Tensor:
        d = self.corr
        if (0, 0, 0) in self.taps:
            didx = self.taps.index((0, 0, 0))
            base = _pattern_field(self.pats[didx].to(d.dtype), self.dims,
                                  self.period).reshape(-1)
            d = d + torch.nn.functional.pad(base, (0, self.n_pad - self.n_rows))
        pad = torch.arange(self.n_pad, device=d.device) >= self.n_rows
        return d.masked_fill((d == 0) | pad, fill)


def _pattern_field(pat: torch.Tensor, dims, p: int) -> torch.Tensor:
    """The (mz, my, mx) field of a (p, p, p) periodic pattern."""
    mx, my, mz = dims
    dev = pat.device
    c = pat[torch.arange(mz, device=dev) % p]
    c = c[:, torch.arange(my, device=dev) % p]
    return c[:, :, torch.arange(mx, device=dev) % p]


def stencil_core(x3, z_lo, z_hi, period, taps, groups, group_const,
                 const_vals, pats, dtype) -> torch.Tensor:
    """Pattern-grouped stencil application on a (mz, my, mx) grid block.

    ``z_lo``/``z_hi``: optional (my, mx) neighbour z-layers; None means the
    grid ends there (zero boundary, like the assembled operator).  Returns
    the (mz, my, mx) product without the diagonal correction.  Taps with
    identical patterns sum their windows first; constant patterns multiply
    by scalars."""
    mz, my, mx = x3.shape
    p = period
    ex, ey, ez = (-mx) % p, (-my) % p, (-mz) % p
    Mx, My, Mz = mx + ex, my + ey, mz + ez
    zeros = x3.new_zeros
    lo = zeros((1, my, mx)) if z_lo is None else z_lo[None]
    hi = zeros((1, my, mx)) if z_hi is None else z_hi[None]
    xz = torch.cat([lo, x3, hi, zeros((ez, my, mx))], dim=0)
    xe = torch.nn.functional.pad(xz, (1, 1 + ex, 1, 1 + ey))
    shp5 = (Mz // p, p, My // p, p, Mx)
    terms = []
    for g, tap_idx in enumerate(groups):
        ws = []
        for d in tap_idx:
            dx, dy, dz = taps[d]
            ws.append(xe[1 + dz : 1 + dz + Mz, 1 + dy : 1 + dy + My,
                         1 + dx : 1 + dx + Mx])
        W = _tree_sum(ws)  # sum the group's windows before multiplying
        if group_const[g]:
            terms.append(const_vals[g].to(dtype) * W)
        else:
            pat = pats[tap_idx[0]].to(dtype)  # (p, p, p)
            strip = pat.repeat(1, 1, Mx // p)  # (p, p, Mx)
            terms.append(
                (W.reshape(shp5) * strip[None, :, None, :, :]).reshape(
                    Mz, My, Mx
                )
            )
    return _tree_sum(terms)[:mz, :my, :mx]


def stencil_parts_from_packed(
    offsets,
    data: np.ndarray,
    n: int,
    dims: Tuple[int, int, int],
) -> Optional[dict]:
    """Exact lattice-stencil decomposition of host-packed diagonals into
    host arrays, or None.

    Verifies per entry that every off-diagonal equals
    ``pattern[class(i), tap] * in_range(i, tap)`` and that the diagonal
    deviation is captured by the elementwise correction.  Tries period 1
    (constant stencil, e.g. HEX8 boxes), then period 2 (parity-alternating,
    e.g. 5-tet boxes).  The returned dict (the JAX function's, key for key)
    feeds :func:`stencil_from_parts` or
    :func:`.stencil_kernel.pad_stencil_from_parts`."""
    mx, my, mz = (int(v) for v in dims)
    if mx * my * mz != n or min(mx, my, mz) < 7:
        return None
    taps = []
    for o in offsets:
        found = None
        for dz, dy, dx in itertools.product((-1, 0, 1), repeat=3):
            if dz * mx * my + dy * mx + dx == o:
                found = (dx, dy, dz)
                break
        if found is None:
            return None
        taps.append(found)
    if (0, 0, 0) not in taps:
        return None
    diag_idx = taps.index((0, 0, 0))

    data_full = np.ascontiguousarray(data, dtype=np.float32)
    data = data_full[:, :n]
    _lazy = {}

    def _idx():  # n-sized index arrays, only for the NumPy fallback
        if not _lazy:
            i = np.arange(n)
            _lazy["ix"] = i % mx
            r = i // mx
            _lazy["iy"] = r % my
            _lazy["iz"] = r // my
        return _lazy["ix"], _lazy["iy"], _lazy["iz"]

    from ..utils.native import stencil_verify_corr_native

    for period in (1, 2):
        p = period
        C = p * p * p
        # Class table from the first interior sample of each class (the
        # min(m) >= 7 guard makes one always exist).
        stencil = np.empty((C, len(offsets)), dtype=np.float32)
        for c in range(C):
            pz, py_, px = c // (p * p), (c // p) % p, c % p
            sz = 2 + ((pz - 2) % p)
            sy = 2 + ((py_ - 2) % p)
            sx = 2 + ((px - 2) % p)
            stencil[c] = data[:, sx + mx * (sy + my * sz)]
        res = stencil_verify_corr_native(
            data_full, (mx, my, mz), p, taps, diag_idx, stencil
        )
        if res is not None:
            ok, corr = res
            if not ok:
                continue
        else:
            ix, iy, iz = _idx()
            cls = (iz % p) * p * p + (iy % p) * p + (ix % p)
            ok = True
            for d in range(len(taps)):
                if d == diag_idx:
                    continue
                dx, dy, dz = taps[d]
                in_range = (
                    (ix + dx >= 0) & (ix + dx < mx)
                    & (iy + dy >= 0) & (iy + dy < my)
                    & (iz + dz >= 0) & (iz + dz < mz)
                )
                if not np.array_equal(data[d], stencil[cls, d] * in_range):
                    ok = False
                    break
            if not ok:
                continue
            corr = data[diag_idx] - stencil[cls, diag_idx]
        pats = np.zeros((len(taps), p, p, p), dtype=np.float32)
        for c in range(C):
            pz, py_, px = c // (p * p), (c // p) % p, c % p
            pats[:, pz, py_, px] = stencil[c]
        n_pad = pad_to(max(n, 1))
        corr_pad = np.zeros(n_pad, dtype=np.float32)
        corr_pad[:n] = corr
        # Group taps by identical pattern; record constant-pattern scalars.
        by_pat = {}
        for d in range(len(taps)):
            by_pat.setdefault(pats[d].tobytes(), []).append(d)
        groups = tuple(tuple(v) for v in by_pat.values())
        group_const = tuple(
            bool(np.all(pats[g[0]] == pats[g[0]].ravel()[0])) for g in groups
        )
        const_vals = np.array(
            [
                pats[g[0]].ravel()[0] if c else 0.0
                for g, c in zip(groups, group_const)
            ],
            dtype=np.float32,
        )
        return dict(
            pats=pats,
            const_vals=const_vals,
            corr_pad=corr_pad,
            taps=tuple(taps),
            groups=groups,
            group_const=group_const,
            dims=(mx, my, mz),
            period=p,
            n_rows=n,
            n_pad=n_pad,
        )
    return None


def stencil_from_parts(parts: dict, dtype=torch.float32,
                       device=None) -> StencilOperator:
    """Host decomposition -> :class:`StencilOperator` on ``device`` (by
    default the card).  Accepts the JAX package's ``parts`` dict as is."""
    from .dia import _torch_dtype

    dev = resolve_device(device)
    dtype = _torch_dtype(dtype)

    def up(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32)).to(
            dtype).to(dev)

    return StencilOperator(
        pats=up(parts["pats"]),
        const_vals=up(parts["const_vals"]),
        corr=up(parts["corr_pad"]),
        taps=tuple(tuple(int(v) for v in t) for t in parts["taps"]),
        groups=tuple(tuple(int(v) for v in g) for g in parts["groups"]),
        group_const=tuple(bool(c) for c in parts["group_const"]),
        dims=tuple(int(v) for v in parts["dims"]),
        period=int(parts["period"]),
        n_rows=int(parts["n_rows"]),
        n_pad=int(parts["n_pad"]),
    )


def stencil_from_dia(dia, dims: Tuple[int, int, int], dtype=torch.float32,
                     device=None) -> Optional[StencilOperator]:
    """Exact lattice-stencil decomposition of a :class:`.dia.DIAMatrix`,
    or None.  Downloads the diagonals as float32 (JAX's
    ``stencil_from_dia``); prefer :func:`stencil_from_packed` on the
    host-packed form where there is one.  The operator lands on
    ``device``, by default the DIA operator's."""
    n = dia.n_rows
    data = dia.data.to(torch.float32).cpu().numpy()[:, :n]
    return stencil_from_packed(dia.offsets, data, n, dims, dtype=dtype,
                               device=dia.device if device is None
                               else device)


def stencil_from_packed(offsets, data, n, dims, dtype=torch.float32,
                        device=None) -> Optional[StencilOperator]:
    """Exact lattice-stencil decomposition of host-packed diagonals to a
    device operator, or None."""
    parts = stencil_parts_from_packed(offsets, data, n, dims)
    if parts is None:
        return None
    return stencil_from_parts(parts, dtype=dtype, device=device)


def stencil_from_csr(csr: CSRMatrix, dims: Tuple[int, int, int],
                     dtype=torch.float32,
                     device=None) -> Optional[StencilOperator]:
    from .dia import pack_dia_host

    packed = pack_dia_host(csr, dtype=torch.float32)
    if packed is None:
        return None
    return stencil_from_packed(packed[0], packed[1], csr.n_rows, dims,
                               dtype=dtype, device=device)
