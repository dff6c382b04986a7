"""Full-mesh graph Laplacian (no Dirichlet elimination); a copy of the JAX
package's ``models/laplacian.py``.

The analogue of ``IO::getMatrix`` (``ExodusIO.hpp:733-1489``): the Laplacian
of the *entire* node graph — singular, so unfit for a direct solve, but the
operator the reference's power-method driver exercises
(``ExodusMatrixTest.cpp:131-171``) and the starting point for sideset-based
PDEs.  All of the reference's machinery there (block element distribution,
ParMETIS dual-graph partition, element redistribution, ghost-node
frequency-ownership protocol, duplicate-insert fix-up) exists to build this
same matrix across MPI ranks; here the matrix is assembled
once from vectorized edge arrays and *then* sharded by an explicit
partitioning step (:mod:`..parallel.partition`), so none of that runtime
protocol is needed.
"""

from __future__ import annotations

import numpy as np

from ..io.mesh import MeshModel
from ..ops.csr import CSRMatrix, coo_to_csr
from .heat import unique_element_edges

__all__ = ["assemble_full_laplacian"]


def assemble_full_laplacian(mesh: MeshModel, dtype=np.float64) -> CSRMatrix:
    """Graph Laplacian over all mesh nodes.

    ``A[i,j] = -1`` iff i and j share an element; ``A[i,i] = deg(i)``.
    Matches the fixed-up matrix of ``ExodusIO.hpp:1399-1433`` (duplicate
    inserts across ranks are summed then forced back to -1 there; edge
    de-duplication here gives the same result directly).
    """
    n = mesh.num_nodes
    u, v = unique_element_edges(mesh)
    degree = np.bincount(u, minlength=n).astype(dtype)
    coo_rows = np.concatenate([u, np.arange(n, dtype=np.int64)])
    coo_cols = np.concatenate([v, np.arange(n, dtype=np.int64)])
    coo_vals = np.concatenate([np.full(u.size, -1.0, dtype=dtype), degree])
    return coo_to_csr(coo_rows, coo_cols, coo_vals, (n, n), sum_dups=False)
