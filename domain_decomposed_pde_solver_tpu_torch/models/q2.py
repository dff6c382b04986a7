"""Q2 (triquadratic) hexahedral finite elements — HEX8 meshes elevated to 27
nodes per element (a copy of the JAX package's ``models/q2.py``).

Completes the quadratic element family next to :mod:`.p2` (quadratic tets):
every unique element edge gains a midpoint DOF, every unique face a center
DOF, and every element a body-center DOF (8 + 12 + 6 + 1 = 27).  The
standard triquadratic tensor-product Lagrange basis is assembled with a
3x3x3 Gauss rule (degree-5 exact per axis); geometry stays trilinear
(subparametric — exact for the affine/trilinear hexes these meshes use, and
consistent with the elevated node placement, which is the trilinear image
of the reference positions).  Quadratic exact solutions are reproduced to
rounding on affine meshes, which the tests exploit.

The assembled system is the same :class:`HeatSystem` as every other
model, so the whole solver / preconditioner / partitioner stack applies
unchanged.  (The reference is P1-graph-Laplacian only,
``ExodusIO.hpp:725-732``.)
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from ..io.mesh import MeshModel
from ..ops.csr import coo_to_csr
from .heat import HeatSystem

__all__ = ["elevate_to_q2", "assemble_poisson_q2", "vertex_solution"]

# HEX8 vertex reference signs (Exodus order: bottom quad CCW, then top).
_V = np.array(
    [
        [-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
        [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1],
    ],
    dtype=np.int64,
)
# 12 edges: bottom ring, top ring, verticals (local vertex pairs).
_EDGES = np.array(
    [
        (0, 1), (1, 2), (2, 3), (3, 0),
        (4, 5), (5, 6), (6, 7), (7, 4),
        (0, 4), (1, 5), (2, 6), (3, 7),
    ]
)
# 6 faces (local vertex quadruples, circular order).
_FACES = np.array(
    [
        (0, 1, 2, 3), (4, 5, 6, 7),
        (0, 1, 5, 4), (3, 2, 6, 7),
        (0, 3, 7, 4), (1, 2, 6, 5),
    ]
)

# Reference signs of all 27 local nodes: vertices, edge mids, face centers,
# body center — each coordinate in {-1, 0, 1}.
_S27 = np.concatenate(
    [
        _V,
        (_V[_EDGES[:, 0]] + _V[_EDGES[:, 1]]) // 2,
        _V[_FACES].sum(axis=1) // 4,
        np.zeros((1, 3), dtype=np.int64),
    ]
)  # (27, 3)

# 3-point Gauss rule per axis (degree-5 exact).
_GP = np.array([-np.sqrt(3.0 / 5.0), 0.0, np.sqrt(3.0 / 5.0)])
_GW = np.array([5.0, 8.0, 5.0]) / 9.0


def _lag(s: int, x: float) -> Tuple[float, float]:
    """1-D quadratic Lagrange value and derivative for node sign s."""
    if s == -1:
        return 0.5 * x * (x - 1.0), x - 0.5
    if s == 0:
        return 1.0 - x * x, -2.0 * x
    return 0.5 * x * (x + 1.0), x + 0.5


def _q2_basis_at(gx: float, ge: float, gz: float) -> Tuple[np.ndarray, np.ndarray]:
    """Values and reference gradients of the 27 basis functions."""
    phi = np.empty(27)
    dphi = np.empty((27, 3))
    for a in range(27):
        sx, sy, sz = _S27[a]
        fx, dfx = _lag(int(sx), gx)
        fy, dfy = _lag(int(sy), ge)
        fz, dfz = _lag(int(sz), gz)
        phi[a] = fx * fy * fz
        dphi[a] = (dfx * fy * fz, fx * dfy * fz, fx * fy * dfz)
    return phi, dphi


def _hex_connectivity(mesh: MeshModel) -> np.ndarray:
    conns = []
    for blk in mesh.blocks:
        et = blk.elem_type.strip().upper()
        if not (et.startswith("HEX") and blk.conn.shape[1] == 8):
            raise ValueError(f"Q2 elevation supports HEX8 only, got {et}")
        conns.append(blk.conn.astype(np.int64))
    return np.concatenate(conns, axis=0)


def elevate_to_q2(mesh: MeshModel) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Add edge-midpoint, face-center, and body-center DOFs to a HEX8 mesh.

    Returns ``(coords_q2, conn_q2 (ne, 27), boundary_mask)`` with the local
    node order of ``_S27`` (vertices, 12 edges, 6 faces, center).  A DOF is
    boundary iff it lies in a face incident to exactly one element (the
    correct Q2 notion — covers the face's vertices, its 4 edge DOFs, and
    its center DOF; body centers are never boundary).
    """
    conn = _hex_connectivity(mesh)
    n = mesh.num_nodes
    ne = conn.shape[0]

    pairs = np.sort(conn[:, _EDGES].reshape(-1, 2), axis=1)
    ue, einv = np.unique(pairs, axis=0, return_inverse=True)
    edge_ids = (n + einv).reshape(ne, 12)

    quads = np.sort(conn[:, _FACES].reshape(-1, 4), axis=1)
    uf, finv = np.unique(quads, axis=0, return_inverse=True)
    n_e = ue.shape[0]
    face_ids = (n + n_e + finv).reshape(ne, 6)

    n_f = uf.shape[0]
    center_ids = (n + n_e + n_f + np.arange(ne))[:, None]

    conn_q2 = np.concatenate([conn, edge_ids, face_ids, center_ids], axis=1)
    # Node placement = trilinear image of the reference positions: edge
    # mids average 2 vertices, face centers 4, body centers 8.
    coords_q2 = np.concatenate(
        [
            mesh.coords,
            0.5 * (mesh.coords[ue[:, 0]] + mesh.coords[ue[:, 1]]),
            mesh.coords[uf].mean(axis=1),
            mesh.coords[conn].mean(axis=1),
        ]
    )

    # Boundary faces: incident to exactly one element.
    ufc, fcount = np.unique(quads, axis=0, return_counts=True)
    bquads = ufc[fcount == 1]
    boundary = np.zeros(coords_q2.shape[0], dtype=bool)
    boundary[np.unique(bquads)] = True
    # Face-center DOFs of boundary faces (sorted-quad record lookup).
    uf_view = np.ascontiguousarray(uf).view([("", uf.dtype)] * 4).ravel()
    bq_view = np.ascontiguousarray(bquads).view([("", bquads.dtype)] * 4).ravel()
    pos = np.searchsorted(uf_view, bq_view)
    boundary[n + n_e + pos] = True
    # Edge DOFs lying in boundary faces: each boundary quad was stored
    # SORTED, which loses the circular order — recover boundary edges from
    # the original (unsorted) faces of boundary elements instead: a face's
    # edge is boundary iff both its endpoints and the face are boundary...
    # Simpler and exact: mark the edges of every face that is itself
    # boundary, using the original circular faces matched via sorted keys.
    faces_circ = conn[:, _FACES].reshape(-1, 4)  # original order
    quads_sorted_view = (
        np.ascontiguousarray(np.sort(faces_circ, axis=1))
        .view([("", quads.dtype)] * 4)
        .ravel()
    )
    is_bface = np.isin(quads_sorted_view, bq_view)
    bcirc = faces_circ[is_bface]
    bedges = np.sort(
        np.stack(
            [bcirc[:, [0, 1]], bcirc[:, [1, 2]], bcirc[:, [2, 3]], bcirc[:, [3, 0]]],
            axis=1,
        ).reshape(-1, 2),
        axis=1,
    )
    ue_view = np.ascontiguousarray(ue).view([("", ue.dtype)] * 2).ravel()
    be_view = (
        np.ascontiguousarray(np.unique(bedges, axis=0))
        .view([("", bedges.dtype)] * 2)
        .ravel()
    )
    epos = np.searchsorted(ue_view, be_view)
    hit = ue_view[np.minimum(epos, ue_view.size - 1)] == be_view
    boundary[n + epos[hit]] = True
    return coords_q2, conn_q2, boundary


def assemble_poisson_q2(
    mesh: MeshModel,
    dirichlet: Callable[[np.ndarray], np.ndarray],
    f: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    dtype=np.float64,
) -> HeatSystem:
    """Assemble the Q2 Poisson system ``-laplace(u) = f`` on a HEX8 mesh.

    Same contract as :func:`..models.p2.assemble_poisson_p2`.
    """
    coords, conn, boundary = elevate_to_q2(mesh)
    n_tot = coords.shape[0]
    free_mask = ~boundary
    free_to_node = np.nonzero(free_mask)[0].astype(np.int64)
    node_to_free = np.full(n_tot, -1, dtype=np.int64)
    node_to_free[free_to_node] = np.arange(free_to_node.size)
    n_free = int(free_to_node.size)

    p = mesh.coords[conn[:, :8]]  # (ne, 8, 3) trilinear geometry
    ne = conn.shape[0]
    K = np.zeros((ne, 27, 27))
    load = np.zeros((ne, 27))
    sg = _V.astype(np.float64)
    for qx, (gx, wx) in enumerate(zip(_GP, _GW)):
        for qy, (ge, wy) in enumerate(zip(_GP, _GW)):
            for qz, (gz, wz) in enumerate(zip(_GP, _GW)):
                w = wx * wy * wz
                # Trilinear geometry Jacobian (same convention as
                # poisson_fem._hex_local_stiffness).
                fx = 1 + sg[:, 0] * gx
                fe = 1 + sg[:, 1] * ge
                fz = 1 + sg[:, 2] * gz
                dN8 = 0.125 * np.stack(
                    [sg[:, 0] * fe * fz, sg[:, 1] * fx * fz, sg[:, 2] * fx * fe],
                    axis=1,
                )  # (8, 3)
                J = np.einsum("nar,ac->nrc", p, dN8)
                detJ = np.abs(np.linalg.det(J))
                Jinv = np.linalg.inv(J)
                phi, dphi = _q2_basis_at(gx, ge, gz)
                g = np.einsum("ac,ncr->nar", dphi, Jinv)  # (ne, 27, 3)
                K += w * detJ[:, None, None] * np.einsum("nai,nbi->nab", g, g)
                if f is not None:
                    N8 = 0.125 * fx * fe * fz  # (8,)
                    xq = np.einsum("a,nai->ni", N8, p)
                    load += (
                        w * detJ[:, None] * np.asarray(f(xq))[:, None] * phi[None]
                    )

    a_idx, b_idx = np.meshgrid(np.arange(27), np.arange(27), indexing="ij")
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
        flat = conn.reshape(-1)
        sel = free_mask[flat]
        np.add.at(b, node_to_free[flat[sel]], load.reshape(-1)[sel])

    return HeatSystem(
        A=K_ff,
        b=b,
        free_to_node=free_to_node,
        node_to_free=node_to_free,
        degree=K_ff.diagonal(),
        mesh=None,  # Q2 DOFs outnumber mesh nodes; carry coords separately
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
