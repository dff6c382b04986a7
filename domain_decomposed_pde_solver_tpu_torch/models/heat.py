"""Steady-state heat equation model: graph-Laplacian assembly.

Reproduces, bit-for-bit, the system built by ``IO::assemble``
(``ExodusIO.hpp:128-723``), re-expressed as vectorized array ops instead of
per-node ``std::map<idx_t, std::set<idx_t>>`` loops:

- Nodes in any nodeset are Dirichlet boundary ("known") nodes; the remaining
  free nodes are the DOFs (``ExodusIO.hpp:216-235``).
- Two nodes are adjacent iff they co-occur in some element, over all element
  blocks (``ExodusIO.hpp:342-378``); adjacency is de-duplicated (set
  semantics).
- ``A[i,j] = -1`` for free neighbors i≠j; ``A[i,i] = total degree`` counting
  both free *and* boundary neighbors (``ExodusIO.hpp:123-125, :591-608``).
- ``B[i] = Σ`` over distinct boundary neighbors c of the **smallest** nodeset
  id containing c (ascending ``std::map`` scan with break,
  ``ExodusIO.hpp:671-687``).
- ``X`` is randomized (``ExodusIO.hpp:664-666``).

Free DOFs are numbered by ascending mesh-node index — identical to the
reference's relabeling scan (``ExodusIO.hpp:219-235``) on one rank.  Unlike
the reference there is no "repartition + chase the permutation" phase: device
placement is a separate, explicit step (:mod:`..parallel`), and
``free_to_node`` plays the role of the rank-0-gathered ``globalIDMap``
(``ExodusIO.hpp:692-720``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..io.mesh import MeshModel
from ..ops.csr import CSRMatrix, coo_to_csr

__all__ = [
    "HeatSystem",
    "assemble_heat_system",
    "unique_element_edges",
    "edges_from_blocks",
]


@dataclasses.dataclass
class HeatSystem:
    """The assembled reduced system ``A x = b`` plus index maps."""

    A: CSRMatrix  # (n_free, n_free) graph Laplacian over DOFs
    b: np.ndarray  # (n_free,) RHS from Dirichlet data
    free_to_node: np.ndarray  # (n_free,) reduced idx -> 0-based mesh node
    node_to_free: np.ndarray  # (num_nodes,) mesh node -> reduced idx, -1 if boundary
    degree: np.ndarray  # (n_free,) total degree (diag of A)
    mesh: Optional[MeshModel] = None
    # Boundary-edge structure (free row, boundary mesh node) — lets callers
    # rebuild the RHS for new Dirichlet values in O(nnz) without re-running
    # edge extraction (see api.SteadyHeatSolver.rhs_for).
    bdry_rows: Optional[np.ndarray] = None
    bdry_cols: Optional[np.ndarray] = None

    @property
    def n_free(self) -> int:
        return int(self.free_to_node.size)

    def random_x(self, seed: int = 0) -> np.ndarray:
        """Random initial iterate, as in ``(*X)->randomize()``
        (``ExodusIO.hpp:664-666``) — but seeded for reproducibility."""
        rng = np.random.default_rng(seed)
        return rng.uniform(-1.0, 1.0, size=self.n_free)


def unique_element_edges(mesh: MeshModel):
    """All unique directed node pairs (u, v), u != v, co-occurring in an element.

    This is the array-programming replacement for the reference's
    per-element double loop inserting into ``adjacency[u].insert(v)``
    (``ExodusIO.hpp:360-376``).  Returns ``(u, v)`` — two C-contiguous
    int64 arrays (contiguity matters: downstream bincount/fancy-indexing on
    strided column views is ~50x slower at 10M+ edges).  Uses the native C++
    kernel (``native/ddps_native.cpp::node_adjacency``) when available.
    """
    return edges_from_blocks(mesh.blocks, mesh.num_nodes)


def edges_from_blocks(mesh_blocks, n: int):
    """:func:`unique_element_edges` over an explicit block list.

    Factored out so the distributed-assembly path
    (:mod:`..parallel.distassembly`) can run the same edge extraction on a
    per-host element *slice* (``io.exodus.MeshSlice.blocks``) — the
    adjacency scan of the reference's element path run on each rank's
    block distribution (``ExodusIO.hpp:1111-1119``)."""
    from ..utils.native import node_adjacency_native

    if mesh_blocks:
        # Native path: group blocks by nodes-per-elem (the C++ kernel takes a
        # uniform-width conn array), dedup across groups with one np.unique.
        by_npe = {}
        for b in mesh_blocks:
            by_npe.setdefault(b.nodes_per_elem, []).append(b.conn)
        results = []
        ok = True
        for npe, conns in by_npe.items():
            conn = np.concatenate(conns, axis=0) if len(conns) > 1 else conns[0]
            res = node_adjacency_native(conn, n)
            if res is None:
                ok = False
                break
            results.append(res)
        if ok and len(results) == 1:
            indptr, indices = results[0]
            u = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
            return u, indices  # already sorted unique, contiguous
        if ok and results:
            keys = np.unique(
                np.concatenate(
                    [
                        np.repeat(np.arange(n, dtype=np.int64), np.diff(ip)) * n
                        + ix
                        for ip, ix in results
                    ]
                )
            )
            return (
                np.ascontiguousarray(keys // n),
                np.ascontiguousarray(keys % n),
            )
    chunks = []
    for blk in mesh_blocks:
        conn = blk.conn.astype(np.int64)
        npe = conn.shape[1]
        if npe < 2 or conn.shape[0] == 0:
            continue
        # Ordered index pairs (k, l), k != l, within an element.
        k_idx, l_idx = np.nonzero(~np.eye(npe, dtype=bool))
        u = conn[:, k_idx].reshape(-1)
        v = conn[:, l_idx].reshape(-1)
        chunks.append(u * np.int64(n) + v)
    if not chunks:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    uniq = np.unique(np.concatenate(chunks))
    # Drop u == v pairs arising from degenerate elements that repeat a node:
    # the native path filters elem[k] != v, and a surviving self-edge would
    # collide with the diagonal slot in the sort-free CSR insert downstream.
    uniq = uniq[(uniq // n) != (uniq % n)]
    return np.ascontiguousarray(uniq // n), np.ascontiguousarray(uniq % n)


def _uniform_conn(mesh_blocks):
    """Concatenated connectivity when every block shares nodes-per-elem;
    None otherwise (heterogeneous meshes take the per-block paths).  The
    single eligibility gate for both the fused and the two-kernel native
    assembly, so the two paths always accept the same meshes."""
    if not mesh_blocks:
        return None
    if len({b.nodes_per_elem for b in mesh_blocks}) != 1:
        return None
    conns = [b.conn for b in mesh_blocks]
    return np.concatenate(conns, axis=0) if len(conns) > 1 else conns[0]


def _adjacency_csr_native(mesh_blocks, n: int):
    """(indptr, indices) node adjacency via the native kernel, or None
    (unavailable, or heterogeneous nodes-per-elem blocks)."""
    from ..utils.native import node_adjacency_native

    conn = _uniform_conn(mesh_blocks)
    if conn is None:
        return None
    return node_adjacency_native(conn, n)


def assemble_heat_system(mesh: MeshModel, dtype=np.float64) -> HeatSystem:
    """Assemble the reduced Laplacian system with reference semantics."""
    n = mesh.num_nodes
    is_boundary, bval = mesh.boundary_value_per_node()
    if not is_boundary.any():
        import warnings

        warnings.warn(
            "mesh has no nodeset (Dirichlet) nodes: the reduced Laplacian "
            "is singular and the RHS is zero; use models.laplacian for the "
            "full-mesh operator, or add nodesets "
            "(io.sides.nodesets_from_sidesets can derive them)",
            stacklevel=2,
        )
    free_mask = ~is_boundary
    free_to_node = np.nonzero(free_mask)[0].astype(np.int64)
    node_to_free = np.full(n, -1, dtype=np.int64)
    node_to_free[free_to_node] = np.arange(free_to_node.size)
    n_free = int(free_to_node.size)

    if np.dtype(dtype) == np.float64:
        # Native single-scan assembly — the NumPy path below walks ~15
        # nnz-sized passes (~90 s of the 10M assembly on this 1-core
        # host; same values bit-for-bit, golden-tested).  Preferred form:
        # fused straight from the connectivity (assemble_from_conn skips
        # materializing the ~1.15 GB node-adjacency CSR and never builds
        # boundary-node rows); falls back to the two-kernel
        # adjacency-then-assemble form, byte-identical either way.
        res = None
        conn = _uniform_conn(mesh.blocks)
        if conn is not None:
            from ..utils.native import assemble_from_conn_native

            res = assemble_from_conn_native(
                conn, n, free_mask.astype(np.uint8), node_to_free,
                bval.astype(np.float64), n_free,
            )
        if res is None:
            adj = _adjacency_csr_native(mesh.blocks, n)
            if adj is not None:
                from ..utils.native import assemble_reduced_native

                res = assemble_reduced_native(
                    adj[0], adj[1], n, free_mask.astype(np.uint8),
                    node_to_free, bval.astype(np.float64), n_free,
                )
        if res is not None:
            indptr, indices, data, b, brows, bcols = res
            A = CSRMatrix(
                indptr=indptr, indices=indices, data=data,
                shape=(n_free, n_free),
            )
            # Diagonals are the only entries > -1 (off-diags are
            # exactly -1.0), one per row in row order.
            return HeatSystem(
                A=A,
                b=b,
                free_to_node=free_to_node,
                node_to_free=node_to_free,
                degree=data[data > -1.0].astype(dtype),
                mesh=mesh,
                bdry_rows=brows,
                bdry_cols=bcols,
            )

    u, v = unique_element_edges(mesh)  # unique ordered pairs, contiguous

    # Keep only edges whose source is a DOF: the reference only builds
    # adjacency rows for free nodes (``ExodusIO.hpp:366-372``).
    src_free = free_mask[u]
    u, v = u[src_free], v[src_free]
    ru = node_to_free[u]

    # Total degree per free node (free + boundary neighbors): the diagonal
    # (``ExodusIO.hpp:604-606`` uses adjacency[id].size()).
    degree = np.bincount(ru, minlength=n_free).astype(dtype)

    # Off-diagonal entries: -1 per free neighbor (``ExodusIO.hpp:597-601``).
    both_free = free_mask[v]
    rows = ru[both_free]
    cols = node_to_free[v[both_free]]
    # Direct canonical-CSR construction — no sort.  ``unique_element_edges``
    # returns pairs sorted by (u, v) and masking preserves order, so the
    # off-diagonals are already grouped per row with ascending columns.
    # The one diagonal entry per row is inserted at its sorted position
    # (after that row's columns < r): entry k lands at
    # ``k + rows[k] + (cols[k] > rows[k])`` — the rows[k] prior diagonal
    # insertions plus one if its own row's diagonal precedes it.  A
    # 19M-element argsort (the bulk of assembly time on this host) becomes
    # two O(nnz) scatters, and the result stays fully sorted (scipy ops
    # downstream require canonical index order).
    nnz_off = rows.size
    counts_off = np.bincount(rows, minlength=n_free)
    indptr_off = np.concatenate([[0], np.cumsum(counts_off)])
    nnz = nnz_off + n_free
    indices = np.empty(nnz, dtype=np.int64)
    data = np.empty(nnz, dtype=dtype)
    pos_off = (
        np.arange(nnz_off, dtype=np.int64) + rows + (cols > rows)
    )
    indices[pos_off] = cols
    data[pos_off] = -1.0
    n_before = np.bincount(rows[cols < rows], minlength=n_free)
    pos_diag = (
        indptr_off[:-1] + np.arange(n_free, dtype=np.int64) + n_before
    )
    indices[pos_diag] = np.arange(n_free, dtype=np.int64)
    data[pos_diag] = degree
    indptr = (
        indptr_off + np.arange(n_free + 1, dtype=np.int64)
    ).astype(np.int64)
    A = CSRMatrix(
        indptr=indptr, indices=indices, data=data, shape=(n_free, n_free)
    )

    # RHS: sum of boundary-neighbor nodeset ids (``ExodusIO.hpp:671-687``).
    bdry = ~both_free
    b = np.zeros(n_free, dtype=dtype)
    np.add.at(b, ru[bdry], bval[v[bdry]].astype(dtype))

    return HeatSystem(
        A=A,
        b=b,
        free_to_node=free_to_node,
        node_to_free=node_to_free,
        degree=degree,
        mesh=mesh,
        bdry_rows=np.ascontiguousarray(ru[bdry]),
        bdry_cols=np.ascontiguousarray(v[bdry]),
    )
