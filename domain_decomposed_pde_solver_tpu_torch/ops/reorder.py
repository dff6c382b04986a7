"""Reverse Cuthill-McKee orderings of host CSR matrices: the port's one
place for RCM.

The JAX package orders with two different RCM codes, which break ties
between equal-degree neighbours differently and so can give different
orders (they do on a refined 5^3 tet box):

- ``rcm_permute`` (``ops/hyb.py:126`` there, exported from its ``ops``)
  runs the native ``rcm_order`` of ``native/ddps_native.cpp``;
- its BSG packer (``ops/bsg.py::_rcm_perm``) runs scipy's
  ``reverse_cuthill_mckee(symmetric_mode=True)``.

The port keeps each where JAX uses it, so both packages number alike:
:func:`rcm_order` gives either order, :func:`rcm_permute` is JAX's, and
the sliced-ELL packer (:mod:`.bsg`) takes ``rcm_order(csr, native=False)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .csr import CSRMatrix, coo_to_csr

__all__ = ["rcm_order", "rcm_permute"]


def rcm_order(csr: CSRMatrix, *, native: bool = True) -> Optional[np.ndarray]:
    """The RCM order of ``csr``'s graph, ``order[new] = old`` (int64):
    the native library's (None when it is missing) or, with
    ``native=False``, scipy's ``reverse_cuthill_mckee`` in symmetric
    mode."""
    if native:
        from ..utils.native import rcm_order_native

        return rcm_order_native(csr.indptr, csr.indices, csr.n_rows)
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    S = sp.csr_matrix(
        (np.asarray(csr.data), np.asarray(csr.indices), np.asarray(csr.indptr)),
        shape=csr.shape,
    )
    return np.asarray(reverse_cuthill_mckee(S, symmetric_mode=True),
                      dtype=np.int64)


def rcm_permute(csr: CSRMatrix) -> Tuple[CSRMatrix, Optional[np.ndarray]]:
    """Symmetric RCM reordering: ``(P A P^T, perm)`` with ``perm[new] =
    old``, or ``(csr, None)`` when the native library is missing (JAX's
    ``rcm_permute``).  Permute vectors with ``b_new = b[perm]`` and back
    with ``x_old[perm] = x_new``."""
    perm = rcm_order(csr)
    if perm is None:
        return csr, None
    inv = np.zeros_like(perm)
    inv[perm] = np.arange(perm.size)
    rows = np.repeat(np.arange(csr.n_rows), csr.row_lengths())
    permuted = coo_to_csr(
        inv[rows], inv[csr.indices], csr.data, csr.shape, sum_dups=False
    )
    return permuted, perm
