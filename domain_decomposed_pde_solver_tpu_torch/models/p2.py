"""P2 (quadratic) tetrahedral finite elements (a copy of the JAX package's
``models/p2.py``).

The reference is P1-graph-Laplacian only; this module completes the
element-order direction (``ExodusIO.hpp:725-732`` leaves real PDEs open):
TETRA4 meshes are elevated in place — every unique element edge gains a
midpoint DOF — and the standard 10-node quadratic basis is assembled with
a degree-2-exact 4-point Gauss rule.  Quadratic exact solutions are
reproduced to rounding, which the tests exploit (u = x^2 with f = -2).

Assembly is host-side NumPy (vectorized over elements, one einsum per
quadrature point); the assembled system is the same :class:`HeatSystem`
as every other model, so the whole solver /
preconditioner / partitioner stack applies unchanged.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from ..io.mesh import MeshModel
from ..ops.csr import coo_to_csr
from .heat import HeatSystem

__all__ = ["elevate_to_p2", "assemble_poisson_p2", "vertex_solution"]

# 4-point Gauss rule on the reference tet (degree-2 exact): barycentric
# coordinates (a,b,b,b) permutations with a = (5+3*sqrt(5))/20.
_QA = (5.0 + 3.0 * np.sqrt(5.0)) / 20.0
_QB = (5.0 - np.sqrt(5.0)) / 20.0
_QPOINTS = np.array(
    [
        [_QA, _QB, _QB, _QB],
        [_QB, _QA, _QB, _QB],
        [_QB, _QB, _QA, _QB],
        [_QB, _QB, _QB, _QA],
    ]
)  # (4 qpoints, 4 barycentric coords)

_EDGES = np.array([(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)])


def _tet_connectivity(mesh: MeshModel) -> np.ndarray:
    conns = []
    for blk in mesh.blocks:
        et = blk.elem_type.strip().upper()
        if not (et.startswith(("TETRA", "TET")) and blk.conn.shape[1] == 4):
            raise ValueError(f"P2 elevation supports TETRA4 only, got {et}")
        conns.append(blk.conn.astype(np.int64))
    return np.concatenate(conns)


def elevate_to_p2(
    mesh: MeshModel,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Add midpoint DOFs on every unique tet edge.

    Returns ``(coords_p2, conn_p2, boundary_mask)``:

    - ``coords_p2``: (n_p1 + n_edges, 3) — original nodes then midpoints;
    - ``conn_p2``: (ne, 10) — vertices 0-3 then edges in the order
      (01, 02, 03, 12, 13, 23);
    - ``boundary_mask``: True for DOFs on the geometric boundary (faces
      incident to exactly one element — the correct P2 notion: an edge
      DOF is boundary iff its edge lies IN a boundary face, not merely
      when both endpoints touch the boundary, which would mis-flag
      diagonals crossing the interior).
    """
    conn = _tet_connectivity(mesh)
    n = mesh.num_nodes

    # Unique edges (sorted pairs) + inverse -> midpoint ids.
    pairs = conn[:, _EDGES]  # (ne, 6, 2)
    pairs = np.sort(pairs.reshape(-1, 2), axis=1)
    uniq, inv = np.unique(pairs, axis=0, return_inverse=True)
    mid_ids = (n + inv).reshape(-1, 6)
    conn_p2 = np.concatenate([conn, mid_ids], axis=1)
    coords_p2 = np.concatenate(
        [mesh.coords, 0.5 * (mesh.coords[uniq[:, 0]] + mesh.coords[uniq[:, 1]])]
    )

    # Boundary faces: tet faces incident to exactly one element.
    faces = conn[:, [(1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)]]
    faces = np.sort(faces.reshape(-1, 3), axis=1)
    fu, fcount = np.unique(faces, axis=0, return_counts=True)
    bfaces = fu[fcount == 1]
    boundary = np.zeros(coords_p2.shape[0], dtype=bool)
    boundary[np.unique(bfaces)] = True
    # Edge DOFs on boundary faces: each boundary face contributes 3 edges.
    bedges = np.sort(
        bfaces[:, [(0, 1), (0, 2), (1, 2)]].reshape(-1, 2), axis=1
    )
    # Locate them among the unique edge list (both are sorted-unique rows).
    key = uniq[:, 0] * (coords_p2.shape[0] + 1) + uniq[:, 1]
    bkey = np.unique(bedges[:, 0] * (coords_p2.shape[0] + 1) + bedges[:, 1])
    hit = np.searchsorted(key, bkey)
    boundary[n + hit[key[hit] == bkey]] = True
    return coords_p2, conn_p2, boundary


def _p2_basis_at(lam: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Values and barycentric gradients of the 10 P2 basis functions at one
    barycentric point ``lam`` (4,).  Returns (phi (10,), dphi_dlam (10, 4))."""
    phi = np.empty(10)
    dphi = np.zeros((10, 4))
    for i in range(4):
        phi[i] = lam[i] * (2.0 * lam[i] - 1.0)
        dphi[i, i] = 4.0 * lam[i] - 1.0
    for k, (i, j) in enumerate(_EDGES):
        phi[4 + k] = 4.0 * lam[i] * lam[j]
        dphi[4 + k, i] = 4.0 * lam[j]
        dphi[4 + k, j] = 4.0 * lam[i]
    return phi, dphi


def assemble_poisson_p2(
    mesh: MeshModel,
    dirichlet: Callable[[np.ndarray], np.ndarray],
    f: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    dtype=np.float64,
) -> HeatSystem:
    """Assemble the P2 Poisson system ``-laplace(u) = f`` on a TETRA4 mesh.

    ``dirichlet(coords) -> values`` supplies the boundary trace at every
    boundary DOF (vertices and edge midpoints); ``f(coords) -> values`` the
    source density (default 0).  Returns the usual reduced
    :class:`HeatSystem` (free DOFs = interior vertices + interior edge
    midpoints), so CG/AMG/etc. apply unchanged.
    """
    coords, conn, boundary = elevate_to_p2(mesh)
    n_tot = coords.shape[0]
    free_mask = ~boundary
    free_to_node = np.nonzero(free_mask)[0].astype(np.int64)
    node_to_free = np.full(n_tot, -1, dtype=np.int64)
    node_to_free[free_to_node] = np.arange(free_to_node.size)
    n_free = int(free_to_node.size)

    # Constant barycentric gradients per element (same as P1): grad(lam) =
    # rows of [ones; J]^-T scaled — use the standard formula via Jinv.
    p = mesh.coords[conn[:, :4]]  # (ne, 4, 3) vertex coordinates
    J = np.stack(
        [p[:, 1] - p[:, 0], p[:, 2] - p[:, 0], p[:, 3] - p[:, 0]], axis=2
    )
    detJ = np.linalg.det(J)
    vol = np.abs(detJ) / 6.0
    Jinv = np.linalg.inv(J)  # (ne, 3, 3)
    gref = np.array(
        [[-1.0, -1.0, -1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
    )  # dlam/dxhat^T rows
    glam = np.einsum("aj,nji->nai", gref, Jinv)  # (ne, 4, 3) grad(lam_a)

    ne = conn.shape[0]
    K = np.zeros((ne, 10, 10))
    load = np.zeros((ne, 10))
    w = 0.25  # qweight (x vol)
    for q in range(4):
        lam = _QPOINTS[q]
        phi, dphi = _p2_basis_at(lam)
        # Physical gradients: g[n, a, i] = sum_c dphi[a, c] glam[n, c, i]
        g = np.einsum("ac,nci->nai", dphi, glam)
        K += w * vol[:, None, None] * np.einsum("nai,nbi->nab", g, g)
        if f is not None:
            xq = np.einsum("c,nci->ni", lam, p)  # quadrature point coords
            load += w * vol[:, None] * np.asarray(f(xq))[:, None] * phi[None]

    a_idx, b_idx = np.meshgrid(np.arange(10), np.arange(10), indexing="ij")
    rows = conn[:, a_idx].reshape(-1)
    cols = conn[:, b_idx].reshape(-1)
    vals = K.reshape(-1).astype(dtype)

    ff = free_mask[rows] & free_mask[cols]
    K_ff = coo_to_csr(
        node_to_free[rows[ff]], node_to_free[cols[ff]], vals[ff],
        (n_free, n_free), sum_dups=True,
    )
    gvals = np.zeros(n_tot)
    if boundary.any():
        gvals[boundary] = np.asarray(dirichlet(coords[boundary]))
    fb = free_mask[rows] & ~free_mask[cols]
    b = np.zeros(n_free, dtype=dtype)
    np.add.at(b, node_to_free[rows[fb]], -vals[fb] * gvals[cols[fb]])
    if f is not None:
        np.add.at(
            b,
            node_to_free[conn.reshape(-1)[free_mask[conn.reshape(-1)]]],
            load.reshape(-1)[free_mask[conn.reshape(-1)]],
        )

    return HeatSystem(
        A=K_ff,
        b=b,
        free_to_node=free_to_node,
        node_to_free=node_to_free,
        degree=K_ff.diagonal(),
        mesh=None,  # P2 DOFs outnumber mesh nodes; carry coords separately
    )


def vertex_solution(
    mesh: MeshModel,
    system: HeatSystem,
    u_free: np.ndarray,
    dirichlet: Callable[[np.ndarray], np.ndarray],
    coords_elevated: np.ndarray,
) -> np.ndarray:
    """Project an elevated solution back to the mesh VERTICES.

    Returns a ``(mesh.num_nodes,)`` nodal field combining free-DOF values
    and the Dirichlet trace — the field the Exodus solution writer accepts
    against the ORIGINAL mesh, so quadratic solves plug into the same
    visualization pipeline as P1 (the reference's animation workload,
    ``BelosMueLuSolver.cpp:112-133``).  Vertex DOFs occupy ids
    ``[0, mesh.num_nodes)`` of the elevated numbering, so this is a pure
    selection plus boundary fill."""
    n = mesh.num_nodes
    full = np.zeros(coords_elevated.shape[0])
    full[system.free_to_node] = np.asarray(u_free)
    bmask = np.ones(coords_elevated.shape[0], dtype=bool)
    bmask[system.free_to_node] = False
    if bmask.any():
        full[bmask] = np.asarray(dirichlet(coords_elevated[bmask]))
    return full[:n]
