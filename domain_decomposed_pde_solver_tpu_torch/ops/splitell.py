"""Split-ELL: a width-capped ELL plus a compact overflow tail.

Counterpart of the JAX package's ``ops/splitell.py``.  ELL pads every row
to the widest; Split-ELL caps the dense part at the ``K*`` that minimises

    cost(K) = n_pad * K  +  2 * sum_r max(len_r - K, 0)

and keeps the overflow as flat ``(row, col, val)`` triples, in CSR order
(so sorted by row), padded to a multiple of 8 with zeros.  Same arrays and
cap as JAX's.

JAX adds the tail with ``.at[tail_rows].add``.  On the card PyTorch's
``index_add_`` adds with atomics, whose order, and so whose bits, change
from run to run; the port adds it in a fixed order instead: the tail is
regrouped once per operator into a padded ``(rows with a tail, longest
tail)`` gather, each such row's tail summed along its slots and added to
its row once.  The product is plain PyTorch, as JAX's is XLA outside any
Pallas kernel; :func:`splitell_matvec_plain` is JAX's scatter-add form,
the yardstick of the fixed-order one.  The port's
:func:`.dia.choose_operator` never picks this format (see :mod:`.dia`).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..utils.device import resolve_device
from .csr import CSRMatrix
from .dia import _NP, _torch_dtype
from .ell import PaddedLayout, pad_to

__all__ = ["SplitELLMatrix", "splitell_from_csr", "splitell_matvec_plain"]


@dataclasses.dataclass
class SplitELLMatrix(PaddedLayout):
    """``cols``/``vals`` (n_pad, K*) as in ELL (int64 columns for
    PyTorch's gather), and the tail ``tail_rows``/``tail_cols``/
    ``tail_vals`` (t_pad,), padding entries row 0, column 0, value 0."""

    cols: torch.Tensor
    vals: torch.Tensor
    tail_rows: torch.Tensor
    tail_cols: torch.Tensor
    tail_vals: torch.Tensor
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

    @functools.cached_property
    def _tail(self):
        """``(rows, cols, vals)``: the rows with a tail entry (ascending,
        each once) and their entries as a padded ``(rows, longest tail)``
        gather in tail order (padding slots column 0, value 0); built once
        on the host from the tail's rows."""
        rows = self.tail_rows.cpu().numpy()
        t = rows.size
        order = np.argsort(rows, kind="stable")
        urows, start, counts = np.unique(rows[order], return_index=True,
                                         return_counts=True)
        width = int(counts.max()) if t else 0
        slot = np.arange(t) - np.repeat(start, counts)
        idx = np.full((urows.size, width), t, dtype=np.int64)
        idx[np.repeat(np.arange(urows.size), counts), slot] = order
        idx = torch.from_numpy(idx).to(self.device)
        cols = torch.cat([self.tail_cols, self.tail_cols.new_zeros(1)])[idx]
        vals = torch.cat([self.tail_vals, self.tail_vals.new_zeros(1)])[idx]
        return torch.from_numpy(urows).to(self.device), cols, vals

    def matvec(self, x_padded: torch.Tensor) -> torch.Tensor:
        """y = A @ x on padded vectors: the capped rows' gather and row
        sum, then each row's tail in a fixed order (the same bits on
        every run)."""
        y = (self.vals * x_padded[self.cols]).sum(dim=1)
        rows, cols, vals = self._tail
        if rows.numel():
            y.index_copy_(0, rows, y[rows] + (vals * x_padded[cols]).sum(1))
        return y

    def diagonal_padded(self, fill: float = 1.0) -> torch.Tensor:
        row_ids = torch.arange(self.n_pad, device=self.device)[:, None]
        on_diag = (self.cols == row_ids) & (self.vals != 0)
        d = torch.where(on_diag, self.vals, torch.zeros_like(self.vals)).sum(1)
        rows, cols, vals = self._tail
        if rows.numel():
            tail = (cols == rows[:, None]) & (vals != 0)
            d.index_copy_(0, rows, d[rows] + torch.where(
                tail, vals, torch.zeros_like(vals)).sum(1))
        return d.masked_fill(
            torch.arange(self.n_pad, device=self.device) >= self.n_rows, fill)

    def astype(self, dtype) -> "SplitELLMatrix":
        dtype = _torch_dtype(dtype)
        return SplitELLMatrix(
            self.cols, self.vals.to(dtype), self.tail_rows, self.tail_cols,
            self.tail_vals.to(dtype), self.n_rows, self.n_cols,
        )


def splitell_matvec_plain(A: SplitELLMatrix,
                          x_padded: torch.Tensor) -> torch.Tensor:
    """JAX's algebra as it stands: the capped rows' product, then the tail
    scatter-added with ``index_add_`` (atomics on the card: the bits may
    change from run to run there)."""
    y = (A.vals * x_padded[A.cols]).sum(dim=1)
    return y.index_add_(0, A.tail_rows, A.tail_vals * x_padded[A.tail_cols])


def splitell_from_csr(csr: CSRMatrix, dtype=torch.float32,
                      row_multiple: int = 8, device=None) -> SplitELLMatrix:
    """Split-ELL of ``csr`` with JAX's cap ``K*`` and arrays; ``device``
    defaults to the card."""
    n_rows, n_cols = csr.shape
    np_dt = np.dtype(_NP[_torch_dtype(dtype)])
    lens = csr.row_lengths()
    kmax = int(lens.max()) if n_rows else 1
    n_pad = pad_to(max(n_rows, 1), row_multiple)

    # The cost-minimising cap: overflow(K) = sum_r max(len_r - K, 0) from
    # suffix sums of the row-length histogram.
    ks = np.arange(1, kmax + 1)
    hist = np.bincount(lens, minlength=kmax + 2)
    rows_longer = np.cumsum(hist[::-1])[::-1]  # rows with len >= index
    tail_counts = np.array([int(rows_longer[k + 1:].sum()) for k in ks])
    cost = n_pad * ks + 2 * tail_counts
    K = int(ks[np.argmin(cost)])

    rows = np.repeat(np.arange(n_rows), lens)
    slot = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], lens)
    main = slot < K
    cols = np.zeros((n_pad, K), dtype=np.int64)
    vals = np.zeros((n_pad, K), dtype=np_dt)
    cols[rows[main], slot[main]] = csr.indices[main]
    vals[rows[main], slot[main]] = csr.data[main]

    t = int((~main).sum())
    t_pad = pad_to(max(t, 1), 8)
    tr = np.zeros(t_pad, dtype=np.int64)
    tc = np.zeros(t_pad, dtype=np.int64)
    tv = np.zeros(t_pad, dtype=np_dt)
    tr[:t] = rows[~main]
    tc[:t] = csr.indices[~main]
    tv[:t] = csr.data[~main]
    dev = resolve_device(device)

    def put(a):
        return torch.from_numpy(a).to(dev)

    return SplitELLMatrix(cols=put(cols), vals=put(vals), tail_rows=put(tr),
                          tail_cols=put(tc), tail_vals=put(tv),
                          n_rows=n_rows, n_cols=n_cols)
