"""Padded ELL sparse format (the explicit AMG transfer operators).

Counterpart of the JAX package's ``ops/ell.py``.  Every row is padded to
the same width K; padding columns point at column 0 with value 0, so the
gather stays in bounds and padded slots contribute exact zeros.  The JAX
package computes the ELL product in XLA, outside any Pallas kernel, and so
does the port: a plain PyTorch gather, multiply and row sum on whatever
device the arrays live on.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import resolve_device
from .csr import CSRMatrix

__all__ = [
    "ELLMatrix",
    "PaddedLayout",
    "ell_from_csr",
    "pad_to",
    "pad_vector",
    "unpad_vector",
]


def pad_to(n: int, multiple: int = 8) -> int:
    return ((n + multiple - 1) // multiple) * multiple


class PaddedLayout:
    """Identity (non-permuting) padded vector layout.

    The host <-> device vector interface of every operator whose internal
    vector space is "original order, zero-padded to ``n_pad``" (ELL, DIA,
    the identity-layout stencil), as JAX's ``PaddedLayout`` (``ops/ell.py:35``
    there).  Operators with a permuted or embedded space (the sliced-ELL
    :class:`.bsg.BSGMatrix`, the padded 3-D
    :class:`.stencil_kernel.PadStencilOperator`) implement the same two
    methods themselves, so solvers and drivers stay format-agnostic.
    Subclasses provide ``n_pad``, ``n_rows`` and ``device``."""

    def put_vector(self, x, dtype=None) -> torch.Tensor:
        """Host (n,) vector -> device padded vector (input dtype kept
        unless ``dtype`` is given)."""
        return pad_vector(np.asarray(x), self.n_pad, dtype=dtype,
                          device=self.device)

    def get_vector(self, xp: torch.Tensor) -> np.ndarray:
        """Device padded vector -> host (n,) vector."""
        return unpad_vector(xp, self.n_rows)


@dataclasses.dataclass
class ELLMatrix(PaddedLayout):
    """Row-padded sparse matrix.

    ``cols``: (n_pad, K) int64 column per slot (0 for padding).
    ``vals``: (n_pad, K) float value per slot (0 for padding).
    ``n_rows``/``n_cols``: logical shape.
    """

    cols: torch.Tensor
    vals: torch.Tensor
    n_rows: int
    n_cols: int

    @property
    def n_pad(self) -> int:
        return int(self.cols.shape[0])

    @property
    def row_width(self) -> int:
        return int(self.cols.shape[1])

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def astype(self, dtype) -> "ELLMatrix":
        """The same slots with the values cast to ``dtype`` (columns
        kept)."""
        from .dia import _torch_dtype

        return ELLMatrix(self.cols, self.vals.to(_torch_dtype(dtype)),
                         self.n_rows, self.n_cols)

    def matvec(self, x_padded: torch.Tensor) -> torch.Tensor:
        """y = A @ x on padded vectors (:func:`.spmv.ell_spmv`)."""
        from .spmv import ell_spmv

        return ell_spmv(self, x_padded)

    def diagonal_padded(self, fill: float = 1.0) -> torch.Tensor:
        """Diagonal as a padded vector; padding rows get ``fill``."""
        row_ids = torch.arange(self.n_pad, device=self.device)[:, None]
        on_diag = (self.cols == row_ids) & (self.vals != 0)
        d = torch.where(on_diag, self.vals, torch.zeros_like(self.vals)).sum(1)
        return d.masked_fill(
            torch.arange(self.n_pad, device=self.device) >= self.n_rows, fill
        )

    def repad(self, n_pad: int) -> "ELLMatrix":
        """Grow the row padding to exactly ``n_pad`` rows."""
        cur = self.n_pad
        if cur == n_pad:
            return self
        if n_pad < cur:
            raise ValueError(f"cannot shrink ELL padding {cur} -> {n_pad}")
        pad = n_pad - cur
        return ELLMatrix(
            cols=torch.cat([self.cols, self.cols.new_zeros(pad, self.row_width)]),
            vals=torch.cat([self.vals, self.vals.new_zeros(pad, self.row_width)]),
            n_rows=self.n_rows,
            n_cols=self.n_cols,
        )


def ell_from_csr(
    csr: CSRMatrix,
    dtype=torch.float32,
    row_multiple: int = 8,
    width_multiple: int = 1,
    device=None,
) -> ELLMatrix:
    """Convert host CSR to device ELL (host packing, one upload to
    ``device``, by default the card)."""
    n_rows, n_cols = csr.shape
    lens = csr.row_lengths()
    k = int(lens.max()) if n_rows else 0
    k = max(pad_to(max(k, 1), width_multiple), 1)
    n_pad = pad_to(max(n_rows, 1), row_multiple)
    cols = np.zeros((n_pad, k), dtype=np.int64)
    vals64 = np.zeros((n_pad, k), dtype=np.float64)
    rows = np.repeat(np.arange(n_rows), lens)
    slot = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], lens)
    cols[rows, slot] = csr.indices
    vals64[rows, slot] = csr.data
    dev = resolve_device(device)
    return ELLMatrix(
        cols=torch.from_numpy(cols).to(dev),
        vals=torch.from_numpy(vals64).to(dtype).to(dev),
        n_rows=n_rows,
        n_cols=n_cols,
    )


def pad_vector(x: np.ndarray, n_pad: int, dtype=None,
               device=None) -> torch.Tensor:
    x = torch.as_tensor(np.asarray(x))
    out = torch.zeros(n_pad, dtype=x.dtype if dtype is None else dtype)
    out[: x.numel()] = x
    dev = resolve_device(device)
    return out.to(dev)


def unpad_vector(x: torch.Tensor, n: int) -> np.ndarray:
    return x[:n].cpu().numpy()
