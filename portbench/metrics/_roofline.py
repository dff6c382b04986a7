"""Least bytes of the fine operator's products, counted from the operator
as the configuration defines it (never from the program's layout), and a
kernel's share of its roofline from the trace.

- Sliced-ELL product (kernel 1) on the graph Laplacian: each nonzero's
  value once, 1 byte (the values are small integers, which int8 holds
  exactly), and its 4-byte column index once; ``x`` read once and ``y``
  written once over the rows, at the vectors' precision.
- Lattice stencil product (kernel 3): ``x`` read once and ``y`` written
  once over the free rows; the coefficients follow from the lattice and
  move no bytes.
"""

from __future__ import annotations

from typing import Callable, Optional


def sell_bytes(nnz: int, n: int, vector_bytes: int, value_bytes: int = 1,
               index_bytes: int = 4) -> int:
    return nnz * (value_bytes + index_bytes) + 2 * n * vector_bytes


def stencil_bytes(n: int, vector_bytes: int) -> int:
    return 2 * n * vector_bytes


def share(run, kind: str, bytes_of: Callable[[int], int]) -> Optional[float]:
    """Percent of the least time (bytes over the card's peak bandwidth) in
    the device time of the kernel's launches made inside the fine
    operator's products (spans ``fine.<kind>.<vector bytes>``)."""
    kernel = run.fine.get(kind)
    if kernel is None or run.trace is None or not run.peak_bytes_per_s:
        return None
    spent = least = 0.0
    for k, span in run.trace.launched_in(f"fine.{kind}.", kernel):
        spent += k.seconds
        least += bytes_of(int(span.rsplit(".", 1)[1])) / run.peak_bytes_per_s
    return 100.0 * least / spent if spent > 0 else None
