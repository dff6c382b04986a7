"""Exodus side (face/edge) topology: sideset -> node resolution (a copy of
the JAX package's ``io/sides.py``).

The reference leaves sidesets unused in ``assemble`` ("if you want to make
use of sidesets, i.e. marking elements rather than nodes as unknown, see
'getMatrix'", ``ExodusIO.hpp:126-127``) and only copies them through in
``decompose``.  This package closes that gap: sidesets can be resolved
to their boundary nodes (standard Exodus-II local side numbering) and used
as Dirichlet sets — BASELINE config 2 ("Dirichlet sideset BCs").
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .mesh import MeshModel, NodeSet, SideSet

__all__ = ["side_local_nodes", "sideset_nodes", "sideset_faces", "nodesets_from_sidesets"]

# Exodus-II local side -> local node indices (0-based here; the standard
# tables are 1-based).  Keyed by element family prefix.
_SIDE_TABLES: Dict[str, List[Tuple[int, ...]]] = {
    "TETRA": [(0, 1, 3), (1, 2, 3), (0, 3, 2), (0, 2, 1)],
    "TET": [(0, 1, 3), (1, 2, 3), (0, 3, 2), (0, 2, 1)],
    "HEX": [
        (0, 1, 5, 4),
        (1, 2, 6, 5),
        (2, 3, 7, 6),
        (0, 4, 7, 3),
        (0, 3, 2, 1),
        (4, 5, 6, 7),
    ],
    "TRI": [(0, 1), (1, 2), (2, 0)],  # planar 2D: sides are edges
    "QUAD": [(0, 1), (1, 2), (2, 3), (3, 0)],
}

# 3D shell variants (Cubit writes "TRI"/"QUAD" for shells in 3D meshes):
# sides 1-2 are the faces, the remaining sides are the edges.
_SHELL_TABLES: Dict[str, List[Tuple[int, ...]]] = {
    "TRI": [(0, 1, 2), (0, 2, 1), (0, 1), (1, 2), (2, 0)],
    "QUAD": [(0, 1, 2, 3), (0, 3, 2, 1), (0, 1), (1, 2), (2, 3), (3, 0)],
}


def side_local_nodes(
    elem_type: str, side: int, shell: bool = False
) -> Tuple[int, ...]:
    """Local node indices (0-based) of 1-based Exodus side ``side``.

    ``shell=True`` selects the 3D shell numbering for TRI/QUAD (faces then
    edges), which Cubit uses when a surface mesh lives in a 3-D file (the
    bundled ``rectangle-tris-boundary.exo`` sideset references TRI sides 3-4:
    shell edges).
    """
    key = elem_type.strip().upper()
    tables = _SHELL_TABLES if shell else _SIDE_TABLES
    for prefix, table in tables.items():
        if key.startswith(prefix):
            if not 1 <= side <= len(table):
                if not shell and any(key.startswith(p) for p in _SHELL_TABLES):
                    return side_local_nodes(elem_type, side, shell=True)
                raise ValueError(f"{elem_type} has no side {side}")
            return table[side - 1]
    if shell:
        return side_local_nodes(elem_type, side, shell=False)
    raise ValueError(f"no side table for element type {elem_type!r}")


def sideset_nodes(mesh: MeshModel, ss: SideSet) -> np.ndarray:
    """Resolve a sideset to the sorted unique mesh nodes on its faces."""
    faces = sideset_faces(mesh, ss)
    if not faces:
        return np.zeros(0, dtype=np.int64)
    return np.unique(np.concatenate([f.reshape(-1) for f in faces]))


def sideset_faces(mesh: MeshModel, ss: SideSet) -> List[np.ndarray]:
    """Resolve a sideset to per-face connectivity arrays.

    Returns a list of ``(n_faces, k)`` int64 arrays, one per face arity
    (k=2 edges, k=3 triangle faces, k=4 quad faces) — the geometric input
    for surface integrals (Neumann/Robin terms, flux evaluation).  Same
    block/side resolution rules as :func:`sideset_nodes`.
    """
    offsets = mesh.global_elem_offsets()
    by_k: Dict[int, List[np.ndarray]] = {}
    blk_of = (
        np.searchsorted(offsets, ss.elems, side="right") - 1
        if ss.elems.size
        else np.zeros(0, np.int64)
    )
    for bi in np.unique(blk_of):
        blk = mesh.blocks[int(bi)]
        sel = blk_of == bi
        local_elems = ss.elems[sel] - offsets[int(bi)]
        sides = ss.sides[sel]
        et = blk.elem_type.strip().upper()
        is_shell = mesh.dim == 3 and (et.startswith("TRI") or et.startswith("QUAD"))
        for sd in np.unique(sides):
            idx = side_local_nodes(blk.elem_type, int(sd), shell=is_shell)
            rows = local_elems[sides == sd]
            faces = blk.conn[rows][:, list(idx)].astype(np.int64)
            by_k.setdefault(len(idx), []).append(faces)
    return [np.concatenate(v) for k, v in sorted(by_k.items())]


def nodesets_from_sidesets(
    mesh: MeshModel, values: Optional[Dict[int, int]] = None
) -> MeshModel:
    """Return a mesh copy whose sidesets are *also* expressed as nodesets.

    ``values`` maps sideset id -> nodeset id to assign (default: the sideset
    id itself, matching the reference's id-as-temperature convention for
    nodesets, ``ExodusIO.hpp:671-687``).  Existing nodesets are preserved;
    the synthesized ones are appended, so nodeset-based assembly then treats
    the sideset faces as Dirichlet boundary.
    """
    values = values or {}
    new_sets = list(mesh.node_sets)
    for ss in mesh.side_sets:
        ns_id = int(values.get(ss.id, ss.id))
        new_sets.append(
            NodeSet(
                id=ns_id,
                nodes=sideset_nodes(mesh, ss),
                name=f"from_sideset_{ss.id}",
            )
        )
    import dataclasses

    return dataclasses.replace(mesh, node_sets=new_sets)
