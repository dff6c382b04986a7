"""P1 finite-element Poisson model (true stiffness matrix); a copy of the
JAX package's ``models/poisson_fem.py``.

The reference stops at the *graph* Laplacian and leaves real PDEs as future
work ("if a particular PDE was meant to be [solved] ... see 'getMatrix'",
``ExodusIO.hpp:725-732``).  This model family completes that direction: the
standard P1 (linear simplex) stiffness matrix

    K[i,j] = ∫ grad(phi_i) . grad(phi_j) dx

assembled fully vectorized over elements (per-element 3x3/4x4 local
matrices from edge geometry), with the same nodeset-based Dirichlet
elimination and RHS-lifting machinery as the heat model: for boundary value
g, solve ``K_ff x = f - K_fb g``.

Supports TRI3 (2D, embedded in 3D via in-plane coordinates), TETRA4, and
HEX8 (trilinear hexes, 2x2x2 Gauss), with quad-face surface integrals for
hex boundaries.
The resulting :class:`..models.heat.HeatSystem`-shaped output plugs into
every solver/preconditioner/partitioner unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from ..io.mesh import MeshModel
from ..ops.csr import CSRMatrix, coo_to_csr
from .heat import HeatSystem

__all__ = ["assemble_poisson_fem", "surface_load", "surface_mass_coo"]


_G1 = 1.0 / np.sqrt(3.0)  # 2-point Gauss abscissa on [-1, 1]
# Bilinear quad reference signs in circular (Exodus side) node order.
_QUAD_SIGNS = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], dtype=np.float64)


def _surface_terms_of(coords: np.ndarray, faces: np.ndarray):
    """Exact P1/Q1 surface integrals for one face family.

    Returns ``(loadw (nf, k), mass (nf, k, k))`` with
    ``loadw[f, i] = integral_f(phi_i)`` and
    ``mass[f, i, j] = integral_f(phi_i phi_j)``.

    - k=2 straight edges and k=3 triangles: closed forms (measure/k and the
      consistent-mass templates).
    - k=4 bilinear quads (HEX8 boundary faces): 2x2 Gauss over the
      reference square with the position-dependent surface Jacobian
      ``|dr/dxi x dr/deta|`` — exact for planar quads and the standard
      quadrature for warped ones (no planarity assumption).
    """
    p = coords[faces]
    k = faces.shape[1]
    if k == 2:
        L = np.linalg.norm(p[:, 1] - p[:, 0], axis=1)
        loadw = np.repeat((L / 2.0)[:, None], 2, axis=1)
        local = np.array([[2.0, 1.0], [1.0, 2.0]]) / 6.0
        return loadw, L[:, None, None] * local[None]
    if k == 3:
        A = 0.5 * np.linalg.norm(
            np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]), axis=1
        )
        loadw = np.repeat((A / 3.0)[:, None], 3, axis=1)
        local = (np.ones((3, 3)) + np.eye(3)) / 12.0
        return loadw, A[:, None, None] * local[None]
    if k == 4:
        nf = faces.shape[0]
        loadw = np.zeros((nf, 4))
        mass = np.zeros((nf, 4, 4))
        sx, se = _QUAD_SIGNS[:, 0], _QUAD_SIGNS[:, 1]
        for gx in (-_G1, _G1):
            for ge in (-_G1, _G1):
                N = 0.25 * (1 + sx * gx) * (1 + se * ge)  # (4,)
                dNdx = 0.25 * sx * (1 + se * ge)  # (4,)
                dNde = 0.25 * se * (1 + sx * gx)  # (4,)
                rx = np.einsum("a,nai->ni", dNdx, p)  # (nf, 3)
                re = np.einsum("a,nai->ni", dNde, p)
                detJ = np.linalg.norm(np.cross(rx, re), axis=1)  # (nf,)
                loadw += detJ[:, None] * N[None, :]
                mass += detJ[:, None, None] * (N[:, None] * N[None, :])[None]
        return loadw, mass
    raise NotImplementedError(
        f"surface integrals for {k}-node faces are not implemented"
    )


def _faces_and_measures(mesh: MeshModel, sideset_id: int):
    """Resolve a sideset once to [(faces, loadw, mass), ...] per arity."""
    from ..io.sides import sideset_faces

    ss = _find_sideset(mesh, sideset_id)
    return [
        (faces,) + _surface_terms_of(mesh.coords, faces)
        for faces in sideset_faces(mesh, ss)
    ]


def _load_from(fm, g: float, num_nodes: int) -> np.ndarray:
    load = np.zeros(num_nodes)
    for faces, loadw, _mass in fm:
        np.add.at(load, faces.reshape(-1), g * loadw.reshape(-1))
    return load


def _mass_from(fm) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    rows, cols, vals = [], [], []
    for faces, _loadw, mass in fm:
        k = faces.shape[1]
        a, b = np.meshgrid(np.arange(k), np.arange(k), indexing="ij")
        rows.append(faces[:, a].reshape(-1))
        cols.append(faces[:, b].reshape(-1))
        vals.append(mass.reshape(-1))
    return (
        np.concatenate(rows),
        np.concatenate(cols),
        np.concatenate(vals),
    )


def surface_load(mesh: MeshModel, sideset_id: int, g: float) -> np.ndarray:
    """P1 surface load ``b_i = g * integral_dS(phi_i)`` over one sideset.

    The weak Neumann term for ``du/dn = g`` on the sideset: constant flux
    times exactly-integrated P1 basis (measure/k per face node).  Returns a
    full ``(num_nodes,)`` vector.
    """
    return _load_from(_faces_and_measures(mesh, sideset_id), g, mesh.num_nodes)


def surface_mass_coo(
    mesh: MeshModel, sideset_id: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """COO triplets of the P1 surface mass matrix ``integral_dS(phi_i phi_j)``
    over one sideset (the Robin/impedance boundary operator).

    Exact consistent mass: edges ``L/6 * [[2,1],[1,2]]``, triangle faces
    ``A/12 * (ones + eye)``.
    """
    return _mass_from(_faces_and_measures(mesh, sideset_id))


def _find_sideset(mesh: MeshModel, sideset_id: int):
    for ss in mesh.side_sets:
        if ss.id == sideset_id:
            return ss
    raise ValueError(
        f"mesh has no sideset {sideset_id} "
        f"(available: {sorted(s.id for s in mesh.side_sets)})"
    )


def _tet_local_stiffness(coords: np.ndarray, conn: np.ndarray) -> np.ndarray:
    """(ne, 4, 4) local stiffness for TETRA4: K_loc = V * B^T B with B the
    constant gradients of the barycentric basis."""
    p = coords[conn]  # (ne, 4, 3)
    # Jacobian columns: edges from node 0.
    J = np.stack([p[:, 1] - p[:, 0], p[:, 2] - p[:, 0], p[:, 3] - p[:, 0]], axis=2)
    detJ = np.linalg.det(J)
    vol = np.abs(detJ) / 6.0
    Jinv = np.linalg.inv(J)  # (ne, 3, 3)
    # Gradients of reference basis: lambda_0 = 1-x-y-z, lambda_i = x_i.
    gref = np.array(
        [[-1.0, -1.0, -1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
    )  # (4, 3)
    # Physical gradients: g_phys = gref @ Jinv  -> (ne, 4, 3)
    g = np.einsum("aj,nji->nai", gref, Jinv)
    K = np.einsum("nai,nbi,n->nab", g, g, vol)
    return K


_HEX_SIGNS = np.array(
    [
        [-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
        [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1],
    ],
    dtype=np.float64,
)  # Exodus HEX8 node order: bottom quad CCW then top quad


def _hex_local_stiffness(coords: np.ndarray, conn: np.ndarray) -> np.ndarray:
    """(ne, 8, 8) local stiffness for HEX8 (trilinear), 2x2x2 Gauss.

    Standard isoparametric form: at each Gauss point,
    ``K += w |J| (dN J^-1)(dN J^-1)^T`` with
    ``N_a = 1/8 (1 + xi xi_a)(1 + eta eta_a)(1 + zeta zeta_a)``.
    Exact for parallelepiped elements; the standard full-integration rule
    for general (non-affine) hexes."""
    p = coords[conn]  # (ne, 8, 3)
    K = np.zeros((conn.shape[0], 8, 8))
    sg = _HEX_SIGNS
    for gx in (-_G1, _G1):
        for ge in (-_G1, _G1):
            for gz in (-_G1, _G1):
                fx = 1 + sg[:, 0] * gx
                fe = 1 + sg[:, 1] * ge
                fz = 1 + sg[:, 2] * gz
                dN = 0.125 * np.stack(
                    [sg[:, 0] * fe * fz, sg[:, 1] * fx * fz, sg[:, 2] * fx * fe],
                    axis=1,
                )  # (8, 3) reference gradients
                # J[r, c] = dx_r/dxi_c (same convention as the tet path).
                J = np.einsum("nar,ac->nrc", p, dN)  # (ne, 3, 3)
                detJ = np.abs(np.linalg.det(J))
                Jinv = np.linalg.inv(J)  # Jinv[c, r] = dxi_c/dx_r
                g = np.einsum("ac,ncr->nar", dN, Jinv)  # (ne, 8, 3)
                K += np.einsum("nai,nbi,n->nab", g, g, detJ)
    return K


def _tri_local_stiffness(coords: np.ndarray, conn: np.ndarray) -> np.ndarray:
    """(ne, 3, 3) local stiffness for TRI3 via the cotangent formula,
    using 3D coordinates directly (works for planar meshes embedded in 3D)."""
    p = coords[conn]  # (ne, 3, 3)
    e0 = p[:, 2] - p[:, 1]  # opposite node 0
    e1 = p[:, 0] - p[:, 2]
    e2 = p[:, 1] - p[:, 0]
    n = np.cross(e1, e2)
    area2 = np.linalg.norm(n, axis=1)  # 2*area
    area2 = np.where(area2 == 0, 1e-300, area2)
    # K[a,b] = (e_a . e_b) / (2 * 2A) for a != b has sign conventions; the
    # standard form: K = (1/(4A)) * G with G[a,b] = e_a . e_b, where e_a is
    # the edge vector opposite node a, and K rows sum to zero.
    E = np.stack([e0, e1, e2], axis=1)  # (ne, 3, 3)
    G = np.einsum("nai,nbi->nab", E, E)
    return G / (2.0 * area2)[:, None, None]


def assemble_poisson_fem(
    mesh: MeshModel,
    f: Optional[np.ndarray] = None,
    dtype=np.float64,
    neumann: Optional[Dict[int, float]] = None,
    robin: Optional[Dict[int, Tuple[float, float]]] = None,
) -> HeatSystem:
    """Assemble the P1 Poisson system with nodeset Dirichlet BCs.

    Boundary values follow the reference convention (value = smallest
    nodeset id containing the node, ``ExodusIO.hpp:675-682``); ``f`` is an
    optional per-node source density (defaults to zero — pure boundary-value
    problem like the reference's heat equation).

    Sideset-driven natural BCs (the PDE direction the reference left open,
    ``ExodusIO.hpp:725-732``):

    - ``neumann``: {sideset_id: g} adds the flux load ``g integral(phi_i)``
      (``du/dn = g`` on that surface);
    - ``robin``: {sideset_id: (alpha, u_env)} adds the impedance term
      ``du/dn = -alpha (u - u_env)``: surface mass ``alpha M_s`` into the
      stiffness and load ``alpha u_env integral(phi_i)``.

    Untouched boundaries remain natural (zero flux).  Dirichlet nodesets
    win where they overlap a sideset (the surface rows are eliminated).
    """
    n = mesh.num_nodes
    is_boundary, bval = mesh.boundary_value_per_node()
    free_mask = ~is_boundary
    free_to_node = np.nonzero(free_mask)[0].astype(np.int64)
    node_to_free = np.full(n, -1, dtype=np.int64)
    node_to_free[free_to_node] = np.arange(free_to_node.size)
    n_free = int(free_to_node.size)

    rows_all = []
    cols_all = []
    vals_all = []
    for blk in mesh.blocks:
        et = blk.elem_type.strip().upper()
        conn = blk.conn.astype(np.int64)
        if et.startswith(("TETRA", "TET")) and conn.shape[1] == 4:
            K = _tet_local_stiffness(mesh.coords, conn)
        elif et.startswith("TRI") and conn.shape[1] == 3:
            K = _tri_local_stiffness(mesh.coords, conn)
        elif et.startswith("HEX") and conn.shape[1] == 8:
            K = _hex_local_stiffness(mesh.coords, conn)
        else:
            raise ValueError(f"P1 FEM assembly unsupported for {blk.elem_type}")
        npe = conn.shape[1]
        a_idx, b_idx = np.meshgrid(np.arange(npe), np.arange(npe), indexing="ij")
        rows_all.append(conn[:, a_idx].reshape(-1))
        cols_all.append(conn[:, b_idx].reshape(-1))
        vals_all.append(K.reshape(-1))
    # Robin surface mass joins the volume stiffness before the free/
    # boundary split, so Dirichlet elimination applies to it uniformly.
    surface_rhs = np.zeros(n)
    for ss_id, g in (neumann or {}).items():
        surface_rhs += surface_load(mesh, ss_id, float(g))
    for ss_id, (alpha, u_env) in (robin or {}).items():
        fm = _faces_and_measures(mesh, ss_id)  # resolve faces once
        sr, sc, sv = _mass_from(fm)
        rows_all.append(sr)
        cols_all.append(sc)
        vals_all.append(float(alpha) * sv)
        surface_rhs += float(alpha) * float(u_env) * _load_from(
            fm, 1.0, n
        )

    rows = np.concatenate(rows_all)
    cols = np.concatenate(cols_all)
    vals = np.concatenate(vals_all).astype(dtype)

    # Partition into K_ff (free x free) and lift: b = f_free - K_fb g.
    ff = free_mask[rows] & free_mask[cols]
    K_ff = coo_to_csr(
        node_to_free[rows[ff]],
        node_to_free[cols[ff]],
        vals[ff],
        (n_free, n_free),
        sum_dups=True,
    )
    fb = free_mask[rows] & ~free_mask[cols]
    b = np.zeros(n_free, dtype=dtype)
    np.add.at(
        b, node_to_free[rows[fb]], -vals[fb] * bval[cols[fb]].astype(dtype)
    )
    if f is not None:
        b = b + np.asarray(f, dtype=dtype)[free_to_node]
    if neumann or robin:
        b = b + surface_rhs.astype(dtype)[free_to_node]

    return HeatSystem(
        A=K_ff,
        b=b,
        free_to_node=free_to_node,
        node_to_free=node_to_free,
        degree=K_ff.diagonal(),
        mesh=mesh,
    )
