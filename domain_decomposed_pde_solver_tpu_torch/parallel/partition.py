"""Mesh/graph partitioners — the ParMETIS/METIS/Zoltan2 replacement.

The reference partitions three ways: node-Laplacian k-way via Zoltan2 →
ParMETIS (``ExodusIO.hpp:644-656``), element dual graph via raw
``ParMETIS_V3_PartMeshKway`` (``ExodusIO.hpp:919``), and sequential
``METIS_PartMeshDual`` for the decompose visualizer (``ExodusIO.hpp:1615``).
Here one deterministic toolkit covers all three:

- :func:`partition_rcb` — recursive coordinate bisection on node/element
  coordinates; handles any part count via weighted splits.  Deterministic,
  O(n log n), embarrassingly vectorizable.
- :func:`refine_partition` — greedy boundary Kernighan-Lin/Fiduccia-
  Mattheyses-style passes that cut the RCB edgecut down toward METIS
  quality while preserving balance.
- :func:`partition_graph` — RCB + refinement for a node graph with
  coordinates; pure-graph greedy BFS growth when no coordinates exist.
- :func:`build_dual_graph` — element dual graph (elements adjacent iff they
  share >= ncommon nodes, the reference's TETRA->3 / TRI->2 / HEX->4 rule,
  ``ExodusIO.hpp:909-918``).
- :func:`edgecut` / :func:`partition_stats` — the quality metrics the
  reference prints (edgecut ``ExodusIO.hpp:904,920``, remote-row percentages
  ``:1334-1351``).

Everything is host-side NumPy: partitioning happens once at setup, producing
static index sets that the device program consumes.  A numpy copy of the
JAX package's ``parallel/partition.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from ..io.mesh import MeshModel, elem_type_ncommon
from ..ops.csr import CSRMatrix, coo_to_csr

__all__ = [
    "partition_rcb",
    "partition_graph",
    "refine_partition",
    "build_dual_graph",
    "partition_mesh_elements",
    "edgecut",
    "partition_stats",
    "PartitionStats",
]


# ----------------------------------------------------------------------------
# Recursive coordinate bisection
# ----------------------------------------------------------------------------


def partition_rcb(coords: np.ndarray, nparts: int) -> np.ndarray:
    """Recursive coordinate bisection into ``nparts`` balanced parts.

    Splits along the widest axis at the weighted quantile so arbitrary part
    counts stay balanced (|part| differs by at most 1).  Deterministic:
    ties broken by stable argsort on (axis value, index).
    """
    n = coords.shape[0]
    parts = np.zeros(n, dtype=np.int32)
    if nparts <= 1 or n == 0:
        return parts

    def split(idx: np.ndarray, k: int, offset: int):
        if k == 1 or idx.size <= 1:
            parts[idx] = offset
            return
        k_lo = k // 2
        k_hi = k - k_lo
        sub = coords[idx]
        axis = int(np.argmax(sub.max(axis=0) - sub.min(axis=0)))
        order = np.argsort(sub[:, axis], kind="stable")
        n_lo = int(round(idx.size * k_lo / k))
        n_lo = min(max(n_lo, 1), idx.size - 1)
        split(idx[order[:n_lo]], k_lo, offset)
        split(idx[order[n_lo:]], k_hi, offset + k_lo)

    split(np.arange(n, dtype=np.int64), nparts, 0)
    return parts


# ----------------------------------------------------------------------------
# Graph-based refinement / growth
# ----------------------------------------------------------------------------


def edgecut(adj: CSRMatrix, parts: np.ndarray) -> int:
    """Number of graph edges crossing parts (each undirected edge once)."""
    rows = np.repeat(np.arange(adj.n_rows), adj.row_lengths())
    cross = parts[rows] != parts[adj.indices]
    return int(cross.sum()) // 2


def refine_partition(
    adj: CSRMatrix,
    parts: np.ndarray,
    nparts: int,
    passes: int = 8,
    imbalance: float = 1.03,
) -> np.ndarray:
    """Greedy boundary refinement (FM-flavored, vectorized).

    Each pass: for every boundary vertex compute, per neighbor part, the gain
    of moving there (external-degree − internal-degree); apply the positive-
    gain moves in gain order while respecting the balance cap.  Moves are
    applied in one shot per pass (Jacobi-style), which keeps the pass O(nnz)
    vectorized; a vertex oscillation is damped by the gain>0 requirement.
    """
    parts = parts.astype(np.int32).copy()
    n = adj.n_rows
    rows = np.repeat(np.arange(n), adj.row_lengths())
    cols = adj.indices
    max_size = int(np.ceil(n / nparts * imbalance))

    for _ in range(passes):
        pc = parts[cols]
        pr = parts[rows]
        # connectivity[v, p] = number of neighbors of v in part p
        conn = np.zeros((n, nparts), dtype=np.int32)
        np.add.at(conn, (rows, pc), 1)
        internal = conn[np.arange(n), parts]
        # Best alternative part per vertex.
        conn_masked = conn.copy()
        conn_masked[np.arange(n), parts] = -1
        best_part = np.argmax(conn_masked, axis=1).astype(np.int32)
        best_conn = conn_masked[np.arange(n), best_part]
        gain = best_conn - internal
        cand = np.nonzero(gain > 0)[0]
        if cand.size == 0:
            break
        # Apply in descending gain order with running balance bookkeeping.
        order = cand[np.argsort(-gain[cand], kind="stable")]
        sizes = np.bincount(parts, minlength=nparts)
        moved = 0
        for v in order:
            src, dst = parts[v], best_part[v]
            if sizes[dst] + 1 > max_size or sizes[src] <= 1:
                continue
            parts[v] = dst
            sizes[src] -= 1
            sizes[dst] += 1
            moved += 1
        if moved == 0:
            break
    return parts


def _greedy_graph_grow(adj: CSRMatrix, nparts: int) -> np.ndarray:
    """Greedy BFS graph-growing partition (no coordinates needed)."""
    n = adj.n_rows
    target = -(-n // nparts)
    parts = np.full(n, -1, dtype=np.int32)
    indptr, indices = adj.indptr, adj.indices
    unassigned_ptr = 0
    for p in range(nparts):
        # Seed: lowest-index unassigned vertex.
        while unassigned_ptr < n and parts[unassigned_ptr] != -1:
            unassigned_ptr += 1
        if unassigned_ptr >= n:
            break
        frontier = [unassigned_ptr]
        parts[unassigned_ptr] = p
        size = 1
        while frontier and size < target:
            nxt = []
            for v in frontier:
                for u in indices[indptr[v] : indptr[v + 1]]:
                    if parts[u] == -1 and size < target:
                        parts[u] = p
                        size += 1
                        nxt.append(int(u))
            frontier = nxt
    parts[parts == -1] = nparts - 1
    return parts


def partition_graph(
    adj: CSRMatrix,
    nparts: int,
    coords: Optional[np.ndarray] = None,
    refine_passes: int = 8,
) -> np.ndarray:
    """Partition a symmetric graph: RCB seed (if coords) + FM refinement."""
    if nparts <= 1:
        return np.zeros(adj.n_rows, dtype=np.int32)
    if coords is not None:
        parts = partition_rcb(coords, nparts)
    else:
        parts = _greedy_graph_grow(adj, nparts)
    return refine_partition(adj, parts, nparts, passes=refine_passes)


# ----------------------------------------------------------------------------
# Element dual graph
# ----------------------------------------------------------------------------


def build_dual_graph(mesh: MeshModel) -> CSRMatrix:
    """Elements adjacent iff they share >= ncommon(elem_type) nodes.

    Counting formulation: enumerate (element, element) co-incidences through
    shared nodes and keep pairs with multiplicity >= ncommon — equivalent to
    the METIS dual graph the reference builds (``ExodusIO.hpp:909-918``).
    ncommon is taken per element-pair as the min of the two blocks' rules
    (blocks are homogeneous in the bundled meshes).
    """
    ne = mesh.num_elem
    if ne == 0:
        return CSRMatrix(np.zeros(1, np.int64), np.zeros(0, np.int64), np.zeros(0), (0, 0))
    if len(mesh.blocks) == 1:
        from ..utils.native import dual_graph_native

        blk = mesh.blocks[0]
        res = dual_graph_native(
            blk.conn, mesh.num_nodes, elem_type_ncommon(blk.elem_type)
        )
        if res is not None:
            indptr, indices = res
            return CSRMatrix(
                indptr=indptr,
                indices=indices,
                data=np.ones(indices.size),
                shape=(ne, ne),
            )
    # (elem, node) incidence over all blocks in global element order.
    elems = []
    nodes = []
    ncommon_per_elem = np.zeros(ne, dtype=np.int32)
    offsets = mesh.global_elem_offsets()
    for b, off in zip(mesh.blocks, offsets):
        npe = b.nodes_per_elem
        eids = np.arange(b.num_elem, dtype=np.int64) + off
        elems.append(np.repeat(eids, npe))
        nodes.append(b.conn.reshape(-1).astype(np.int64))
        ncommon_per_elem[eids] = elem_type_ncommon(b.elem_type)
    elems = np.concatenate(elems)
    nodes = np.concatenate(nodes)

    # Group by node: for each node, all incident elements.
    order = np.argsort(nodes, kind="stable")
    nodes_s, elems_s = nodes[order], elems[order]
    uniq_nodes, starts = np.unique(nodes_s, return_index=True)
    counts = np.diff(np.append(starts, nodes_s.size))

    # Enumerate ordered pairs within each node group (u != v).
    pair_u = []
    pair_v = []
    for c in np.unique(counts):
        sel = counts == c
        if c < 2:
            continue
        grp_starts = starts[sel]
        # (G, c) matrix of element ids incident to each selected node.
        idx = grp_starts[:, None] + np.arange(c)[None, :]
        ems = elems_s[idx]  # (G, c)
        iu, iv = np.nonzero(~np.eye(int(c), dtype=bool))
        pair_u.append(ems[:, iu].reshape(-1))
        pair_v.append(ems[:, iv].reshape(-1))
    if not pair_u:
        return CSRMatrix(
            np.zeros(ne + 1, np.int64), np.zeros(0, np.int64), np.zeros(0), (ne, ne)
        )
    u = np.concatenate(pair_u)
    v = np.concatenate(pair_v)
    # Count shared nodes per (u, v).
    key = u * np.int64(ne) + v
    uniq_key, mult = np.unique(key, return_counts=True)
    uu, vv = uniq_key // ne, uniq_key % ne
    thresh = np.minimum(ncommon_per_elem[uu], ncommon_per_elem[vv])
    keep = mult >= thresh
    uu, vv = uu[keep], vv[keep]
    return coo_to_csr(uu, vv, np.ones(uu.size), (ne, ne), sum_dups=False)


def partition_mesh_elements(
    mesh: MeshModel, nparts: int, refine_passes: int = 8
) -> np.ndarray:
    """Partition elements via centroid RCB + dual-graph refinement.

    The ``METIS_PartMeshDual``/``ParMETIS_V3_PartMeshKway`` replacement
    (``ExodusIO.hpp:919, :1615``).
    """
    if nparts <= 1:
        return np.zeros(mesh.num_elem, dtype=np.int32)
    centroids = np.concatenate(
        [mesh.coords[b.conn].mean(axis=1) for b in mesh.blocks], axis=0
    )
    dual = build_dual_graph(mesh)
    parts = partition_rcb(centroids, nparts)
    return refine_partition(dual, parts, nparts, passes=refine_passes)


# ----------------------------------------------------------------------------
# Quality metrics
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class PartitionStats:
    nparts: int
    sizes: np.ndarray
    edgecut: int
    total_edges: int
    halo_sizes: np.ndarray  # per part: number of off-part neighbor vertices

    @property
    def imbalance(self) -> float:
        return float(self.sizes.max() / max(self.sizes.mean(), 1e-30))

    @property
    def cut_fraction(self) -> float:
        return self.edgecut / max(self.total_edges, 1)

    def __str__(self) -> str:
        return (
            f"parts={self.nparts} sizes=[{self.sizes.min()}..{self.sizes.max()}] "
            f"imbalance={self.imbalance:.3f} edgecut={self.edgecut} "
            f"({100 * self.cut_fraction:.2f}%) halo=[{self.halo_sizes.min()}.."
            f"{self.halo_sizes.max()}]"
        )


def partition_stats(adj: CSRMatrix, parts: np.ndarray, nparts: int) -> PartitionStats:
    """The reference's partition-quality dump (edgecut + remote percentages,
    ``ExodusIO.hpp:904,920, :1334-1351``) as a struct."""
    rows = np.repeat(np.arange(adj.n_rows), adj.row_lengths())
    cross = parts[rows] != parts[adj.indices]
    halo_sizes = np.zeros(nparts, dtype=np.int64)
    if cross.any():
        # Unique (owner part, remote vertex) pairs.
        key = parts[rows][cross].astype(np.int64) * adj.n_cols + adj.indices[cross]
        uniq = np.unique(key)
        np.add.at(halo_sizes, (uniq // adj.n_cols).astype(np.int64), 1)
    return PartitionStats(
        nparts=nparts,
        sizes=np.bincount(parts, minlength=nparts),
        edgecut=int(cross.sum()) // 2,
        total_edges=adj.nnz // 2,
        halo_sizes=halo_sizes,
    )
