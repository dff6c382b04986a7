"""Partition visualization writer — the ``IO::decompose`` equivalent (a
copy of the JAX package's ``parallel/decompose.py``).

The reference's sequential path (``ExodusIO.hpp:1496-1969``): partition the
element dual graph, then write a complete copy of the mesh where **each
partition becomes an element block**, so ParaView colors partitions by block.
It copies coordinates (``:1709-1728``), coordinate names (``:1730-1739``),
element map (``:1741-1745``), nodesets + properties (``:1789-1851``),
sidesets + properties (``:1853-1917``), QA (``:1919-1941``) and info records
(``:1943-1960``), and the node number map (``:1962-1966``).

Here the result is produced as a new :class:`MeshModel` (then written by the
ordinary writer), with two deliberate deviations from the reference:
- partition block ids are 1-based (the reference passes block id 0 to
  ``ex_put_block``, ``ExodusIO.hpp:1772``, which is outside the Exodus id
  convention);
- empty partitions are dropped from the block list (the reference computes
  ``numparts`` the same way, ``ExodusIO.hpp:1680-1689``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..io.mesh import ElemBlock, MeshModel
from .partition import partition_mesh_elements

__all__ = ["decompose_mesh", "write_decomposition"]


def decompose_mesh(
    mesh: MeshModel,
    nparts: int,
    elem_parts: Optional[np.ndarray] = None,
) -> MeshModel:
    """Return a copy of ``mesh`` with one element block per partition."""
    if elem_parts is None:
        elem_parts = partition_mesh_elements(mesh, nparts)
    elem_parts = np.asarray(elem_parts, dtype=np.int64)
    if elem_parts.size != mesh.num_elem:
        raise ValueError("elem_parts must have one entry per element")

    # Global element order = concatenation of blocks (``ExodusIO.hpp:1639-1665``).
    conns = [b.conn for b in mesh.blocks]
    types = np.concatenate(
        [[b.elem_type] * b.num_elem for b in mesh.blocks]
    ) if mesh.blocks else np.zeros(0, dtype=object)
    npe_per_elem = np.concatenate(
        [np.full(b.num_elem, b.nodes_per_elem) for b in mesh.blocks]
    ) if mesh.blocks else np.zeros(0, np.int64)

    new_blocks = []
    elem_order = []  # original element index per new global position
    for p in range(int(nparts)):
        sel = np.nonzero(elem_parts == p)[0]
        if sel.size == 0:
            continue
        # Elements of a partition must share nodes-per-elem (the reference
        # deduces one width per partition block, ``ExodusIO.hpp:1753-1760``);
        # mixed widths are split into one block per element type.
        for et in np.unique(types[sel]):
            sub = sel[types[sel] == et]
            npe = int(npe_per_elem[sub[0]])
            conn = np.zeros((sub.size, npe), dtype=np.int64)
            offsets = mesh.global_elem_offsets()
            # Map global element index -> (block, local row).
            blk_of = np.searchsorted(offsets, sub, side="right") - 1
            for bi in np.unique(blk_of):
                rows = sub[blk_of == bi] - offsets[bi]
                conn[blk_of == bi] = conns[bi][rows]
            # Block ids are allocated sequentially so they stay unique even
            # when a partition mixes element types and is split into several
            # blocks (Exodus requires unique eb_prop1 ids); the partition is
            # preserved in the block name.  For single-type partitions this
            # reduces to the reference's id = partition + 1.
            new_blocks.append(
                ElemBlock(
                    id=len(new_blocks) + 1,
                    elem_type=str(et),
                    conn=conn,
                    name=f"partition_{p}",
                )
            )
            elem_order.append(sub)

    elem_order = (
        np.concatenate(elem_order) if elem_order else np.zeros(0, np.int64)
    )
    old_id_map = (
        mesh.elem_id_map
        if mesh.elem_id_map is not None
        else np.arange(1, mesh.num_elem + 1)
    )
    # Sidesets are copied with element indices remapped to the new element
    # order.  (The reference copies them with the *original* indices,
    # ``ExodusIO.hpp:1853-1917``, which point at the wrong elements after the
    # reorder — remapping is the behavior it intends.)
    new_pos = np.zeros(mesh.num_elem, dtype=np.int64)
    new_pos[elem_order] = np.arange(elem_order.size)
    import dataclasses as _dc

    new_side_sets = [
        _dc.replace(ss, elems=new_pos[ss.elems], sides=ss.sides.copy())
        for ss in mesh.side_sets
    ]
    return MeshModel(
        coords=mesh.coords.copy(),
        blocks=new_blocks,
        node_sets=[ns for ns in mesh.node_sets],
        side_sets=new_side_sets,
        title=mesh.title,
        num_dim=mesh.num_dim,
        node_id_map=(
            mesh.node_id_map.copy() if mesh.node_id_map is not None else None
        ),
        elem_id_map=old_id_map[elem_order],
        coord_names=mesh.coord_names,
        qa_records=list(mesh.qa_records),
        info_records=list(mesh.info_records),
    )


def write_decomposition(
    path: str,
    mesh: MeshModel,
    nparts: int,
    elem_parts: Optional[np.ndarray] = None,
) -> MeshModel:
    """Partition ``mesh`` and write the block-per-partition Exodus file."""
    from ..io.exodus import write_exodus

    out = decompose_mesh(mesh, nparts, elem_parts)
    write_exodus(path, out)
    return out
