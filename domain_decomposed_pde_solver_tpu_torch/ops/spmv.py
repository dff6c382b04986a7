"""The padded-ELL product and its byte count.

Counterpart of the JAX package's ``ops/spmv.py``.  JAX computes
:func:`ell_spmv` in XLA (a gather, a multiply and a row sum), outside any
Pallas kernel, and so does the port, in plain PyTorch on whatever device
the operator lives on; :meth:`.ell.ELLMatrix.matvec` calls it.  JAX's
``ell_spmv_pallas`` is not exported there and has no counterpart here.
Padding slots (column 0, value 0) contribute exact zeros, so padded and
logical results agree.
"""

from __future__ import annotations

from typing import Optional

import torch

from .ell import ELLMatrix

__all__ = ["ell_spmv", "spmv_bytes"]


def ell_spmv(A: ELLMatrix, x_padded: torch.Tensor) -> torch.Tensor:
    """y = A @ x with padded shapes: x_padded (n_pad,) -> y (n_pad,)."""
    return (A.vals * x_padded[A.cols]).sum(dim=1)


def spmv_bytes(A: ELLMatrix, dtype_bytes: Optional[int] = None) -> int:
    """Least device-memory traffic of one product, for roofline
    accounting: values and columns read once, x read once and y written
    once (``dtype_bytes`` overrides the value and vector width).  Columns
    count at JAX's 4 bytes (int32), the width a kernel would read; the
    port's ELL holds them as int64 for PyTorch's gather."""
    vb = A.vals.element_size() if dtype_bytes is None else dtype_bytes
    n_pad, k = A.cols.shape
    return n_pad * k * (vb + 4) + 2 * n_pad * vb
