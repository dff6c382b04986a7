"""Node ownership from an element partition — the ghost-node protocol.

The reference's element-partitioned path must decide, for every node shared
by elements on multiple ranks, exactly one owner.  Its protocol
(``ExodusIO.hpp:1121-1384``) exchanges per-pair sorted node lists over MPI
windows, then (node, usage-frequency) lists point-to-point, and picks
**the rank where the node has the highest adjacency frequency, ties broken
by lowest rank** ("if a node is more 'important' on one process, keep it
there", heuristic comment at ``ExodusIO.hpp:1191-1192``), asserting the
result forms a one-to-one map (``:1384``).

Because partitions are computed globally on the host, the same rule is
three vectorized lines — no communication protocol at all.  A numpy copy of
the JAX package's ``parallel/ownership.py``.
"""

from __future__ import annotations

import numpy as np

from ..io.mesh import MeshModel

__all__ = ["node_ownership_from_element_partition"]


def node_ownership_from_element_partition(
    mesh: MeshModel, elem_parts: np.ndarray, nparts: int
) -> np.ndarray:
    """Return ``owner[node] = part`` using the reference's frequency rule.

    frequency(node, part) = number of part-owned elements incident to the
    node; owner = argmax over parts, ties -> lowest part id.  Nodes touched
    by no element (possible in degenerate meshes) get part 0.
    """
    elem_parts = np.asarray(elem_parts, dtype=np.int64)
    n = mesh.num_nodes
    freq = np.zeros((n, nparts), dtype=np.int64)
    offsets = mesh.global_elem_offsets()
    for blk, off in zip(mesh.blocks, offsets):
        eids = np.arange(blk.num_elem, dtype=np.int64) + off
        p = elem_parts[eids]
        nodes = blk.conn.astype(np.int64)
        np.add.at(freq, (nodes.reshape(-1), np.repeat(p, blk.nodes_per_elem)), 1)
    # argmax returns the first (lowest part) maximum — the tie-break rule.
    owner = np.argmax(freq, axis=1).astype(np.int32)
    owner[freq.sum(axis=1) == 0] = 0
    return owner
