"""Uniform mesh refinement (TETRA 1->8, HEX 1->8, TRI 1->4).

The bundled meshes top out at ~112k elements; BASELINE config 5 wants
``lbracket.exo`` refined to ~10M DOF.  Refinement is fully vectorized:
edge midpoints are created by hashing sorted node pairs with ``np.unique``
(one new node per unique edge — conformal across elements), and child
connectivity is pure indexing.  Nodesets propagate to midpoints whose both
endpoints lie in the set (preserves Dirichlet faces); sidesets are dropped
(faces quadruple — regenerate from nodesets if needed).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .mesh import ElemBlock, MeshModel, NodeSet

__all__ = ["refine_uniform"]

# Local edge lists (pairs of local node ids).
_EDGES = {
    "TETRA": [(0, 1), (1, 2), (2, 0), (0, 3), (1, 3), (2, 3)],
    "TRI": [(0, 1), (1, 2), (2, 0)],
    "HEX": [
        (0, 1), (1, 2), (2, 3), (3, 0),  # bottom
        (4, 5), (5, 6), (6, 7), (7, 4),  # top
        (0, 4), (1, 5), (2, 6), (3, 7),  # verticals
    ],
}


def _family(elem_type: str) -> str:
    et = elem_type.strip().upper()
    for fam in ("TETRA", "TET", "TRI", "HEX"):
        if et.startswith(fam):
            return "TETRA" if fam == "TET" else fam
    raise ValueError(f"cannot refine element type {elem_type!r}")


def refine_uniform(mesh: MeshModel, levels: int = 1) -> MeshModel:
    """Refine every element ``levels`` times (8^levels tets per tet).

    ``node_id_map``/``elem_id_map`` of the input are NOT propagated (new
    nodes/elements have no original-mesh ids); the refined mesh uses the
    default identity maps.
    """
    out = mesh
    for _ in range(levels):
        out = _refine_once(out)
    return out


def _refine_once(mesh: MeshModel) -> MeshModel:
    n = mesh.num_nodes
    # 1. Collect all unique edges over all blocks.
    edge_list = []
    for blk in mesh.blocks:
        fam = _family(blk.elem_type)
        for a, b in _EDGES[fam]:
            u = blk.conn[:, a]
            v = blk.conn[:, b]
            lo, hi = np.minimum(u, v), np.maximum(u, v)
            edge_list.append(np.stack([lo, hi], axis=1))
    edges = np.concatenate(edge_list, axis=0).astype(np.int64)
    keys = edges[:, 0] * np.int64(n) + edges[:, 1]
    uniq_keys, inverse = np.unique(keys, return_inverse=True)
    mid_of_key = np.arange(uniq_keys.size) + n  # new node id per unique edge
    eu, ev = uniq_keys // n, uniq_keys % n
    mid_coords = 0.5 * (mesh.coords[eu] + mesh.coords[ev])
    coords = np.concatenate([mesh.coords, mid_coords], axis=0)

    # Per-block lookup: edge (a,b) of element e -> midpoint node id.
    def mids_for(blk_idx: int, blk: ElemBlock) -> np.ndarray:
        fam = _family(blk.elem_type)
        ne = blk.num_elem
        nedges = len(_EDGES[fam])
        # Slice of `inverse` belonging to this block, in edge-major order.
        start = sum(
            b.num_elem * len(_EDGES[_family(b.elem_type)])
            for b in mesh.blocks[:blk_idx]
        )
        inv = inverse[start : start + ne * nedges].reshape(nedges, ne).T
        return mid_of_key[inv]  # (ne, nedges)

    # Hex face centers are uniquified ACROSS blocks (edge midpoints already
    # are, via the global `keys` table above): a face shared between two hex
    # blocks must get ONE center node or the refined mesh is non-conformal.
    hex_face_keys = []
    for blk in mesh.blocks:
        if _family(blk.elem_type) == "HEX":
            hex_face_keys.append(_hex_face_keys(blk.conn.astype(np.int64)))
    face_table = None
    if hex_face_keys:
        all_keys = np.concatenate(hex_face_keys, axis=0)
        uniq_faces, face_inv = np.unique(all_keys, axis=0, return_inverse=True)
        face_base = coords.shape[0]
        coords = np.concatenate(
            [coords, coords[uniq_faces].mean(axis=1)], axis=0
        )
        face_table = (uniq_faces, face_inv, face_base)

    new_blocks: List[ElemBlock] = []
    extra_groups: List[Tuple[np.ndarray, np.ndarray]] = []  # (parents, new ids)
    if face_table is not None:
        uf, _, fb = face_table
        extra_groups.append((uf, fb + np.arange(uf.shape[0])))
    hex_seen = 0  # rows of face_inv consumed by earlier hex blocks
    for bi, blk in enumerate(mesh.blocks):
        fam = _family(blk.elem_type)
        c = blk.conn.astype(np.int64)
        m = mids_for(bi, blk)
        if fam == "TRI":
            # Corner tris + center tri.
            m01, m12, m20 = m[:, 0], m[:, 1], m[:, 2]
            kids = [
                np.stack([c[:, 0], m01, m20], 1),
                np.stack([m01, c[:, 1], m12], 1),
                np.stack([m20, m12, c[:, 2]], 1),
                np.stack([m01, m12, m20], 1),
            ]
        elif fam == "TETRA":
            # 4 corner tets + 4 tets around the inner octahedron, split by
            # the m01-m23 diagonal (any fixed diagonal gives a conformal
            # refinement for uniform splitting).
            m01, m12, m20, m03, m13, m23 = (m[:, i] for i in range(6))
            c0, c1, c2, c3 = (c[:, i] for i in range(4))
            kids = [
                np.stack([c0, m01, m20, m03], 1),
                np.stack([m01, c1, m12, m13], 1),
                np.stack([m20, m12, c2, m23], 1),
                np.stack([m03, m13, m23, c3], 1),
                # Octahedron (m01, m12, m20, m03, m13, m23) split around
                # the m01-m23 axis:
                np.stack([m01, m12, m20, m23], 1),
                np.stack([m01, m12, m23, m13], 1),
                np.stack([m01, m13, m23, m03], 1),
                np.stack([m01, m23, m20, m03], 1),
            ]
        elif fam == "HEX":
            uniq_faces, face_inv, face_base = face_table
            ne = c.shape[0]
            fc = (face_base + face_inv[hex_seen : hex_seen + ne * 6]).reshape(
                ne, 6
            )
            hex_seen += ne * 6
            kids, coords = _refine_hex(c, m, fc, coords)
        else:  # pragma: no cover
            raise AssertionError(fam)
        conn = np.stack(kids, axis=1).reshape(-1, c.shape[1])
        new_blocks.append(
            ElemBlock(id=blk.id, elem_type=blk.elem_type, conn=conn, name=blk.name)
        )

    # Nodesets: keep originals; add new nodes all of whose parent nodes lie
    # in the set (edge midpoints; hex face centers).
    new_sets: List[NodeSet] = []
    for ns in mesh.node_sets:
        inset = np.zeros(n, dtype=bool)
        inset[ns.nodes] = True
        parts = [ns.nodes, mid_of_key[inset[eu] & inset[ev]]]
        for parents, new_ids in extra_groups:
            parts.append(new_ids[inset[parents].all(axis=1)])
        new_sets.append(
            NodeSet(id=ns.id, nodes=np.concatenate(parts), name=ns.name)
        )

    out = MeshModel(
        coords=coords,
        blocks=new_blocks,
        node_sets=new_sets,
        side_sets=[],
        title=mesh.title + " (refined)",
        num_dim=mesh.num_dim,
    )
    out.validate()
    return out


_HEX_FACES = [
    (0, 1, 2, 3), (4, 5, 6, 7),
    (0, 1, 5, 4), (1, 2, 6, 5), (2, 3, 7, 6), (3, 0, 4, 7),
]


def _hex_face_keys(c: np.ndarray) -> np.ndarray:
    """(ne*6, 4) sorted node quadruples keying each hex face, element-major."""
    fnodes = np.stack([c[:, list(f)] for f in _HEX_FACES], axis=1)
    return np.sort(fnodes.reshape(-1, 4), axis=1)


def _refine_hex(c: np.ndarray, m: np.ndarray, fc: np.ndarray,
                coords: np.ndarray):
    """1->8 hex split: edge mids (given), face centers (given — deduplicated
    globally across all hex blocks by the caller so shared faces stay
    conformal), and a fresh body center per hex."""
    ne = c.shape[0]
    n0 = coords.shape[0]
    bc = n0 + np.arange(ne)
    bcoords = coords[c].mean(axis=1)
    coords = np.concatenate([coords, bcoords], axis=0)

    e = {  # edge midpoint shorthand by local pair
        (0, 1): m[:, 0], (1, 2): m[:, 1], (2, 3): m[:, 2], (3, 0): m[:, 3],
        (4, 5): m[:, 4], (5, 6): m[:, 5], (6, 7): m[:, 6], (7, 4): m[:, 7],
        (0, 4): m[:, 8], (1, 5): m[:, 9], (2, 6): m[:, 10], (3, 7): m[:, 11],
    }
    f_bot, f_top = fc[:, 0], fc[:, 1]
    f01, f12, f23, f30 = fc[:, 2], fc[:, 3], fc[:, 4], fc[:, 5]
    cc = bc

    def hexa(*nodes):
        return np.stack(nodes, 1)

    kids = [
        hexa(c[:, 0], e[(0, 1)], f_bot, e[(3, 0)], e[(0, 4)], f01, cc, f30),
        hexa(e[(0, 1)], c[:, 1], e[(1, 2)], f_bot, f01, e[(1, 5)], f12, cc),
        hexa(f_bot, e[(1, 2)], c[:, 2], e[(2, 3)], cc, f12, e[(2, 6)], f23),
        hexa(e[(3, 0)], f_bot, e[(2, 3)], c[:, 3], f30, cc, f23, e[(3, 7)]),
        hexa(e[(0, 4)], f01, cc, f30, c[:, 4], e[(4, 5)], f_top, e[(7, 4)]),
        hexa(f01, e[(1, 5)], f12, cc, e[(4, 5)], c[:, 5], e[(5, 6)], f_top),
        hexa(cc, f12, e[(2, 6)], f23, f_top, e[(5, 6)], c[:, 6], e[(6, 7)]),
        hexa(f30, cc, f23, e[(3, 7)], e[(7, 4)], f_top, e[(6, 7)], c[:, 7]),
    ]
    return kids, coords
