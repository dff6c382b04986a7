"""The benchmark's own copy of the box-mesh generator and its uniform
refinement, TETRA4 only, in NumPy.

A frozen copy: the harness makes its meshes with it and hands them to the
program as arrays, and the reference judges the program's answers on the
same arrays, so neither side's mesh moves when the program's own ``io``
changes.  It imports nothing of the program.

``box_tet4(nx, ny, nz)`` is a structured box of ``nx*ny*nz`` cells on
[0,1]^3, five tetrahedra per cell with the split alternating by cell parity
(so that faces match between neighbours), nodes numbered x fastest, and two
nodesets: id 100 on the x = 0 face, id 1000 on the x = 1 face.
``refine_tet4(mesh)`` splits every tetrahedron into eight (one new node per
unique edge; a nodeset keeps the midpoints of its own edges).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

__all__ = ["TetMesh", "box_tet4", "refine_tet4", "make_mesh"]

# Corner offsets of the 5-tet split of a unit cell, by cell parity; corners
# 0-3 are the bottom face counter-clockwise, 4-7 the top face.
TET5_EVEN = ((0, 1, 2, 5), (0, 2, 3, 7), (0, 5, 7, 4), (2, 7, 5, 6),
             (0, 2, 7, 5))
TET5_ODD = ((1, 3, 0, 4), (1, 2, 3, 6), (1, 6, 4, 5), (3, 4, 6, 7),
            (1, 3, 6, 4))
# Local edges of a tetrahedron.
TET_EDGES = ((0, 1), (1, 2), (2, 0), (0, 3), (1, 3), (2, 3))


@dataclasses.dataclass
class TetMesh:
    coords: np.ndarray  # (num_nodes, 3) float64
    conn: np.ndarray  # (num_elem, 4) int32, 0-based
    node_sets: Dict[int, np.ndarray]  # nodeset id -> 0-based node indices

    @property
    def num_nodes(self) -> int:
        return int(self.coords.shape[0])


def cell_corner_offsets(mx: int, my: int) -> np.ndarray:
    """Node-index offsets of a cell's 8 corners on an x-fastest node grid
    whose rows hold ``mx`` nodes and planes ``mx * my``."""
    offs = np.array([0, 1, 1 + mx, mx, 0, 1, 1 + mx, mx], dtype=np.int64)
    offs[4:] += mx * my
    return offs


def box_tet4(nx: int, ny: int, nz: int, bc_ids=(100, 1000)) -> TetMesh:
    mx, my, mz = nx + 1, ny + 1, nz + 1
    xs = np.linspace(0.0, 1.0, mx)
    ys = np.linspace(0.0, 1.0, my)
    zs = np.linspace(0.0, 1.0, mz)
    coords = np.empty((mx * my * mz, 3))
    coords[:, 0] = np.tile(xs, my * mz)
    coords[:, 1] = np.tile(np.repeat(ys, mx), mz)
    coords[:, 2] = np.repeat(zs, mx * my)
    idt = np.int32
    # Cells in (ci, cj, ck) order with ck fastest.
    ci = np.repeat(np.arange(nx, dtype=idt), ny * nz)
    cj = np.tile(np.repeat(np.arange(ny, dtype=idt), nz), nx)
    ck = np.tile(np.arange(nz, dtype=idt), nx * ny)
    base = ci + cj * idt(mx) + ck * idt(mx * my)
    offs = cell_corner_offsets(mx, my).astype(idt)
    tbl = np.stack([offs[np.asarray(TET5_EVEN)], offs[np.asarray(TET5_ODD)]])
    par = ((ci + cj + ck) & 1).astype(np.int8)
    conn = tbl.take(par, axis=0)  # (ncells, 5, 4)
    conn += base[:, None, None]
    conn = conn.reshape(-1, 4)
    x_of = np.arange(mx * my * mz) % mx
    node_sets = {int(bc_ids[0]): np.flatnonzero(x_of == 0),
                 int(bc_ids[1]): np.flatnonzero(x_of == nx)}
    return TetMesh(coords=coords, conn=conn, node_sets=node_sets)


def unique_edges(conn: np.ndarray, n: int):
    """Sorted unique edge keys ``lo * n + hi`` of a tetrahedral mesh and the
    index of every element edge (element-major within each local edge)
    among them."""
    c = conn.astype(np.int64)
    lo = np.concatenate([np.minimum(c[:, a], c[:, b]) for a, b in TET_EDGES])
    hi = np.concatenate([np.maximum(c[:, a], c[:, b]) for a, b in TET_EDGES])
    return np.unique(lo * np.int64(n) + hi, return_inverse=True)


def refine_tet4(mesh: TetMesh) -> TetMesh:
    n = mesh.num_nodes
    keys, inverse = unique_edges(mesh.conn, n)
    eu, ev = keys // n, keys % n
    coords = np.concatenate(
        [mesh.coords, 0.5 * (mesh.coords[eu] + mesh.coords[ev])], axis=0)
    ne = mesh.conn.shape[0]
    m = (inverse.reshape(len(TET_EDGES), ne).T + n).astype(np.int64)
    c = mesh.conn.astype(np.int64)
    m01, m12, m20, m03, m13, m23 = (m[:, i] for i in range(6))
    c0, c1, c2, c3 = (c[:, i] for i in range(4))
    # Four corner tetrahedra, then the inner octahedron split around the
    # m01-m23 diagonal.
    kids = [
        (c0, m01, m20, m03), (m01, c1, m12, m13), (m20, m12, c2, m23),
        (m03, m13, m23, c3), (m01, m12, m20, m23), (m01, m12, m23, m13),
        (m01, m13, m23, m03), (m01, m23, m20, m03),
    ]
    conn = np.stack([np.stack(k, 1) for k in kids], axis=1).reshape(-1, 4)
    node_sets = {}
    for sid, nodes in mesh.node_sets.items():
        inset = np.zeros(n, dtype=bool)
        inset[nodes] = True
        mids = np.flatnonzero(inset[eu] & inset[ev]) + n
        node_sets[sid] = np.concatenate([nodes, mids])
    return TetMesh(coords=coords, conn=conn.astype(np.int32),
                   node_sets=node_sets)


def make_mesh(cells, refine: int) -> TetMesh:
    """``box_tet4(*cells)`` refined ``refine`` times."""
    mesh = box_tet4(*cells)
    for _ in range(refine):
        mesh = refine_tet4(mesh)
    return mesh
