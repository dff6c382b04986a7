"""Synthetic structured box meshes (HEX8 / TETRA4) as MeshModel.

The bundled reference meshes top out at ~112k elements; the performance
targets (BASELINE configs 3/5) need 1M-10M-DOF problems.  This generator
produces Cubit-style box meshes of any size with Dirichlet nodesets on the
x-min / x-max faces — the same shape of problem as ``tet-cube-heat.exo``
(two opposing-face nodesets), at arbitrary scale, with no file I/O.
"""

from __future__ import annotations

import numpy as np

from .mesh import ElemBlock, MeshModel, NodeSet

__all__ = ["box_mesh"]

# Corner offsets of the 5-tet decomposition of a unit hex (parity-alternated
# to make faces conformal between neighboring hexes).
_TET5_EVEN = [
    (0, 1, 2, 5),
    (0, 2, 3, 7),
    (0, 5, 7, 4),
    (2, 7, 5, 6),
    (0, 2, 7, 5),
]
_TET5_ODD = [
    (1, 3, 0, 4),
    (1, 2, 3, 6),
    (1, 6, 4, 5),
    (3, 4, 6, 7),
    (1, 3, 6, 4),
]


def box_mesh(
    nx: int,
    ny: int,
    nz: int,
    elem_type: str = "HEX8",
    bc_ids=(100, 1000),
    title: str = "generated box mesh",
) -> MeshModel:
    """Structured box of ``nx*ny*nz`` cells on [0,1]^3.

    ``elem_type``: ``"HEX8"`` (one hex per cell) or ``"TETRA4"`` (5 tets per
    cell, parity-alternated).  Nodesets: ``bc_ids[0]`` on the x=0 face,
    ``bc_ids[1]`` on the x=1 face (cf. tet-cube-heat's two 645-node sets).
    """
    mx, my, mz = nx + 1, ny + 1, nz + 1
    # Node numbering: x fastest (node id = i + j*mx + k*mx*my).  Coords
    # fill sequentially in node order (the earlier meshgrid + permuted
    # scatter cost tens of seconds of page faults at 10M nodes).
    xs = np.linspace(0.0, 1.0, mx)
    ys = np.linspace(0.0, 1.0, my)
    zs = np.linspace(0.0, 1.0, mz)
    coords = np.empty((mx * my * mz, 3))
    coords[:, 0] = np.tile(xs, my * mz)
    coords[:, 1] = np.tile(np.repeat(ys, mx), mz)
    coords[:, 2] = np.repeat(zs, mx * my)

    # int32 node ids whenever they fit (meshes past 2^31 nodes are out of
    # scope): connectivity is the largest array this function writes, and
    # the native adjacency/assembly kernels have int32 fast paths — at 10M
    # DOF the dtype alone halves ~4 GB of freshly-faulted pages.
    idt = np.int32 if mx * my * mz < 2**31 else np.int64
    # Cell order: meshgrid('ij').ravel() order, i.e. ck fastest, ci slowest.
    ci = np.repeat(np.arange(nx, dtype=idt), ny * nz)
    cj = np.tile(np.repeat(np.arange(ny, dtype=idt), nz), nx)
    ck = np.tile(np.arange(nz, dtype=idt), nx * ny)

    # Cell corner nodes, standard HEX8 ordering (bottom CCW, then top CCW).
    base = ci + cj * idt(mx) + ck * idt(mx * my)
    offs = np.array(
        [0, 1, 1 + mx, mx, 0, 1, 1 + mx, mx], dtype=idt
    )
    offs[4:] += mx * my

    if elem_type.upper().startswith("HEX"):
        conn = base[:, None] + offs[None, :]  # (ncells, 8)
        et = "HEX8"
    else:
        # Tet corner offsets as a 2-row parity table; one contiguous-row
        # take + an in-place broadcast add.  (The earlier per-parity
        # boolean gathers copied `corners` twice — ~2.5 GB of strided
        # fancy-indexing at 10M DOF.)
        tbl = np.stack(
            [
                offs[np.asarray(_TET5_EVEN, dtype=np.int64)],
                offs[np.asarray(_TET5_ODD, dtype=np.int64)],
            ]
        )  # (2, 5, 4)
        par = ((ci + cj + ck) & 1).astype(np.int8)
        conn = tbl.take(par, axis=0)  # (ncells, 5, 4)
        conn += base[:, None, None]
        conn = conn.reshape(-1, 4)
        et = "TETRA4"

    i_all = np.arange(mx * my * mz)
    x_of = i_all % mx
    ns_lo = i_all[x_of == 0]
    ns_hi = i_all[x_of == nx]
    mesh = MeshModel(
        coords=coords,
        blocks=[ElemBlock(id=1, elem_type=et, conn=conn, name="box")],
        node_sets=[
            NodeSet(id=int(bc_ids[0]), nodes=ns_lo, name="xmin"),
            NodeSet(id=int(bc_ids[1]), nodes=ns_hi, name="xmax"),
        ],
        title=title,
        num_dim=3,
    )
    mesh.validate()
    return mesh
