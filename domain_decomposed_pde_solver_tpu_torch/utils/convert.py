"""Adopt objects of the JAX package, handed over as numpy arrays.

With these a caller assembles once and feeds both packages the very same
system and vector space: CSR fields, the right-hand side and the free-node
map go in as arrays; :func:`operator_from_csr` can adopt the JAX BSG
operator's permutation (``np.asarray(A_jax.perm)``); :func:`dia_from_numpy`
takes a JAX ``DIAMatrix``'s offsets and diagonals; and
:func:`pad_stencil_from_parts` takes the JAX package's host stencil
decomposition (``stencil_parts_from_packed``) as it is; and
:func:`ilu_from_numpy` takes a JAX ``ILU0Preconditioner``'s solve-ordered
factor arrays, so both packages apply identical factors.  Nothing here
imports the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

import torch

from ..models.heat import HeatSystem
from ..ops.bsg import BSGMatrix, bsg_from_csr
from ..ops.csr import CSRMatrix
from ..ops.dia import DIAMatrix
from ..ops.stencil_kernel import pad_stencil_from_parts
from ..solvers.precond.ilu import ilu_from_arrays as ilu_from_numpy
from .device import resolve_device

__all__ = [
    "csr_from_numpy",
    "dia_from_numpy",
    "heat_system_from_numpy",
    "ilu_from_numpy",
    "operator_from_csr",
    "pad_stencil_from_parts",
]


def csr_from_numpy(indptr, indices, data, shape: Tuple[int, int]) -> CSRMatrix:
    """A port CSR matrix from CSR arrays (copied, canonical dtypes)."""
    return CSRMatrix(
        indptr=np.array(indptr, dtype=np.int64),
        indices=np.array(indices, dtype=np.int64),
        data=np.array(data, dtype=np.float64),
        shape=(int(shape[0]), int(shape[1])),
    )


def heat_system_from_numpy(
    indptr,
    indices,
    data,
    shape: Tuple[int, int],
    b,
    free_to_node,
    num_nodes: Optional[int] = None,
    bdry_rows=None,
    bdry_cols=None,
) -> HeatSystem:
    """A port :class:`HeatSystem` from the JAX system's arrays."""
    A = csr_from_numpy(indptr, indices, data, shape)
    free_to_node = np.array(free_to_node, dtype=np.int64)
    n_nodes = (
        int(num_nodes) if num_nodes is not None
        else int(free_to_node.max()) + 1 if free_to_node.size else 0
    )
    node_to_free = np.full(n_nodes, -1, dtype=np.int64)
    node_to_free[free_to_node] = np.arange(free_to_node.size)
    return HeatSystem(
        A=A,
        b=np.array(b, dtype=np.float64),
        free_to_node=free_to_node,
        node_to_free=node_to_free,
        degree=A.diagonal(),
        bdry_rows=None if bdry_rows is None else np.array(bdry_rows),
        bdry_cols=None if bdry_cols is None else np.array(bdry_cols),
    )


def operator_from_csr(csr: CSRMatrix, perm=None, device=None) -> BSGMatrix:
    """The port's unstructured operator for ``csr``; ``perm`` (original row
    -> internal row) adopts a given numbering, e.g. the JAX operator's."""
    return bsg_from_csr(csr, perm=perm, device=device)


def dia_from_numpy(offsets, data, n_rows: int, compute_dtype: str = "",
                   device=None) -> DIAMatrix:
    """A port :class:`DIAMatrix` from DIA arrays: ``offsets`` (ndiags,),
    ``data`` (ndiags, n_pad) in float32/float64 — or the raw uint16 bits of
    bfloat16 storage, which numpy has no type for (``compute_dtype`` then
    names the compute type).  ``device`` defaults to the card."""
    arr = np.ascontiguousarray(data)
    if arr.dtype == np.uint16:
        t = torch.from_numpy(arr.astype(np.int32) << 16).view(torch.float32)
        t = t.to(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return DIAMatrix(
        data=t.to(resolve_device(device)),
        offsets=tuple(int(o) for o in np.asarray(offsets).reshape(-1)),
        n_rows=int(n_rows),
        compute_dtype=compute_dtype,
    )
