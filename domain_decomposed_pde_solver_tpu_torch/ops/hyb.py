"""The hybrid DIA + ELL format.

Counterpart of the JAX package's ``ops/hyb.py``.  After an RCM
reordering (:func:`.reorder.rcm_permute`, re-exported here as JAX's
module exports it) a good share of an unstructured matrix's nonzeros lies
on a few popular diagonals.  The hybrid keeps every diagonal whose
occupancy reaches ``min_occupancy`` as DIA and the rest as padded ELL:

    A = A_dia (popular diagonals) + A_ell (the remainder)

Both parts live in the same identity padded space.  On the card the DIA
part runs kernel 4 (``csrc/dia_spmv.cu``, the run-time diagonal loop for
the counts it meets here) and the ELL part its plain PyTorch gather and
row sum, as JAX computes ELL in XLA outside any Pallas kernel.  The
port's :func:`.dia.choose_operator` never picks this format (see
:mod:`.dia`); a caller builds it on request.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import resolve_device
from .csr import CSRMatrix, coo_to_csr
from .dia import _NP, DIAMatrix, _torch_dtype
from .ell import ELLMatrix, PaddedLayout, ell_from_csr, pad_to
from .reorder import rcm_permute

__all__ = ["HYBMatrix", "hyb_from_csr", "rcm_permute"]


@dataclasses.dataclass
class HYBMatrix(PaddedLayout):
    """``A = dia + ell``, both over the same padded row space."""

    dia: DIAMatrix
    ell: ELLMatrix
    n_rows: int

    @property
    def n_pad(self) -> int:
        return self.dia.n_pad

    @property
    def n_cols(self) -> int:
        return self.n_rows

    @property
    def dtype(self) -> torch.dtype:
        return self.dia.dtype

    @property
    def device(self) -> torch.device:
        return self.dia.device

    def matvec(self, x_padded: torch.Tensor) -> torch.Tensor:
        """y = A @ x: kernel 4 on the DIA part (its plain version on the
        CPU) plus the ELL part's product."""
        return self.dia.matvec(x_padded) + self.ell.matvec(x_padded)

    def diagonal_padded(self, fill: float = 1.0) -> torch.Tensor:
        d = self.dia.diagonal_padded(fill=0.0) + self.ell.diagonal_padded(
            fill=0.0)
        pad = torch.arange(self.n_pad, device=self.device) >= self.n_rows
        return d.masked_fill((d == 0) | pad, fill)

    def astype(self, dtype) -> "HYBMatrix":
        return HYBMatrix(self.dia.astype(dtype), self.ell.astype(dtype),
                         self.n_rows)


def _dia_part_from_entries(rows, offs, vals, offsets, n, n_pad, dtype,
                           device) -> DIAMatrix:
    """The DIA part in ``dtype`` storage (JAX applies no bfloat16 rule
    here, so neither does the port)."""
    np_dt = np.dtype(_NP[dtype])
    data = np.zeros((len(offsets), n_pad), dtype=np_dt)
    data[np.searchsorted(offsets, offs), rows] = vals.astype(np_dt)
    return DIAMatrix(data=torch.from_numpy(data).to(device),
                     offsets=tuple(int(o) for o in offsets), n_rows=n)


def hyb_from_csr(
    csr: CSRMatrix,
    dtype=torch.float32,
    min_occupancy: float = 0.02,
    max_diags: int = 256,
    row_multiple: int = 8,
    device=None,
) -> HYBMatrix:
    """Split ``csr`` (square) into its popular diagonals, those holding at
    least ``min_occupancy * n`` entries, at most the ``max_diags`` most
    popular, kept in ascending offset order, and an ELL remainder padded
    to the DIA part's rows: JAX's split.  ``device`` defaults to the
    card."""
    n = csr.n_rows
    if csr.n_cols != n:
        raise ValueError(f"HYB needs a square matrix, got {csr.shape}")
    dtype = _torch_dtype(dtype)
    dev = resolve_device(device)
    n_pad = pad_to(max(n, 1), row_multiple)
    rows = np.repeat(np.arange(n), csr.row_lengths())
    offs = csr.indices - rows
    uniq, inverse, counts = np.unique(offs, return_inverse=True,
                                      return_counts=True)
    popular = counts >= max(min_occupancy * n, 1)
    if popular.sum() > max_diags:
        keep = np.zeros_like(popular)
        keep[np.argsort(-counts)[:max_diags]] = True
        popular &= keep
    on_dia = popular[inverse]
    dia = _dia_part_from_entries(
        rows[on_dia], offs[on_dia], csr.data[on_dia], np.sort(uniq[popular]),
        n, n_pad, dtype, dev)
    rest = ~on_dia
    ell_csr = coo_to_csr(rows[rest], csr.indices[rest], csr.data[rest],
                         (n, n), sum_dups=False)
    ell = ell_from_csr(ell_csr, dtype=dtype, row_multiple=row_multiple,
                       device=dev).repad(n_pad)
    return HYBMatrix(dia=dia, ell=ell, n_rows=n)
