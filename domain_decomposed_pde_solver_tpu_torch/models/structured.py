"""Closed-form (element-scan-free) assembly for generated box meshes.

Counterpart of the JAX package's ``models/structured.py``, with the port's
own imports.  ``assemble_heat_system(box_mesh(...))`` scans every element
to build node adjacency and the reduced Laplacian, and at 10M DOF also
builds a mesh it does not need.  But the box meshes are *lattices*: the
reduced system is exactly

- off-diagonal of tap d at free node i  =  ``pats[d][parity(i)]`` whenever
  ``i + d`` is inside the free grid;
- diagonal = the node's DEGREE = the number of its node-grid adjacency
  offsets that stay inside the node grid (``ExodusIO.hpp:123-125``);
- ``b[i]`` = nodeset id x the number of adjacent boundary (x-face) nodes
  (``ExodusIO.hpp:671-687``).

Both tables -- the reduced-grid stencil template and the node-adjacency
offset sets per parity class -- are derived from ONE probe box assembled
by the port's element path (:func:`box_lattice_tables`), never written as
constants, so this module cannot drift from the element-scan semantics;
the tests hold its output bit-identical (CSR, b, degree, maps) to the
element path and to the JAX package's, across sizes and parities.

Two products:

- :func:`structured_box_system` -- the full :class:`.heat.HeatSystem` via
  one native row-writer pass (``native/ddps_native.cpp::
  assemble_structured``): no mesh, no element scan, no dedup.  The 10M
  box's AMG set-up takes its CSR.
- :func:`structured_box_parts` -- the lattice-stencil operator parts with
  ``corr``, ``b`` and ``degree`` computed in numpy (``device=False``) or
  with torch on a device (``device=True``: the card; or a device name),
  so the solver operator never builds a host CSR.

These names are not exported by :mod:`..models`, as in JAX.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np

from ..ops.csr import CSRMatrix
from .heat import HeatSystem

__all__ = [
    "structured_box_system",
    "structured_box_parts",
    "box_lattice_tables",
]

_PROBE_CELLS = 8


@functools.lru_cache(maxsize=None)
def box_lattice_tables(elem_type: str = "TETRA4") -> Optional[Dict]:
    """Size-independent lattice tables of ``box_mesh`` systems, derived from
    a probe box assembled through the element path.

    Returns dict with: ``period``, ``taps`` (ascending by (dz,dy,dx)),
    ``diag_idx``, ``pats`` (nd, C) f64 in free-grid parity classes,
    ``opar_ptr``/``opar`` (node-adjacency offsets per free-parity class),
    and the stencil template's ``groups``, ``group_const`` and
    ``const_vals``; or None when the probe is not an exact lattice
    stencil.
    """
    from ..io.boxmesh import box_mesh
    from ..ops.dia import pack_dia_host
    from ..ops.stencil import stencil_parts_from_packed
    from ..solvers.precond.amg import infer_free_grid
    from .heat import assemble_heat_system
    from .laplacian import assemble_full_laplacian

    n_c = _PROBE_CELLS
    mesh = box_mesh(n_c, n_c, n_c, elem_type=elem_type)
    sy = assemble_heat_system(mesh)
    dims = infer_free_grid(mesh, sy.free_to_node)
    if dims is None:
        return None
    packed = pack_dia_host(sy.A, dtype=np.float32)
    if packed is None:
        return None
    uniq, data = packed
    parts = stencil_parts_from_packed(uniq, data, sy.n_free, dims)
    if parts is None:
        return None
    p = int(parts["period"])
    taps = parts["taps"]
    diag_idx = taps.index((0, 0, 0))
    C = p * p * p
    # pats in f64 (the stencil stores f32; graph-Laplacian entries are
    # small integers, so the cast is exact -- checked).
    pats32 = parts["pats"].reshape(len(taps), C)  # class order [iz,iy,ix]
    pats = pats32.astype(np.float64)
    if not np.array_equal(pats.astype(np.float32), pats32):
        return None

    # Node-adjacency offsets per node-parity class, from the full-mesh
    # Laplacian of the probe (ExodusIO.hpp:123-125 semantics), re-indexed
    # to FREE-grid parity classes (free ix = node x - 1).
    L = assemble_full_laplacian(mesh)
    m = n_c + 1  # node grid (m, m, m)
    opar_lists = []
    for c in range(C):
        pz, py_, px_free = c // (p * p), (c // p) % p, c % p
        px_node = (px_free + 1) % p if p > 1 else 0
        # A central node with the right parities (neighbours interior).
        x = 4 if (4 % p) == px_node or p == 1 else 5
        y = 4 if (4 % p) == py_ or p == 1 else 5
        z = 4 if (4 % p) == pz or p == 1 else 5
        u = x + m * (y + m * z)
        cols = L.indices[L.indptr[u]: L.indptr[u + 1]]
        offs = []
        for v in np.asarray(cols):
            if int(v) == u:
                continue
            dz_, r = divmod(int(v) - u + (m * m + m + 1), m * m)
            dy_, dx_ = divmod(r, m)
            offs.append((dx_ - 1, dy_ - 1, dz_ - 1))
        offs = sorted(offs)
        if any(max(abs(a), abs(b_), abs(cc)) > 1 for a, b_, cc in offs):
            return None
        opar_lists.append(offs)
    opar_ptr = np.zeros(C + 1, dtype=np.int64)
    for c in range(C):
        opar_ptr[c + 1] = opar_ptr[c] + len(opar_lists[c])
    opar = np.array(
        [o for lst in opar_lists for o in lst], dtype=np.int64
    ).reshape(-1, 3)
    return dict(
        period=p,
        taps=taps,
        diag_idx=diag_idx,
        pats=np.ascontiguousarray(pats),
        opar_ptr=opar_ptr,
        opar=np.ascontiguousarray(opar),
        # The stencil template's size-independent fields, reused as they
        # are by structured_box_parts.
        groups=parts["groups"],
        group_const=parts["group_const"],
        const_vals=parts["const_vals"],
    )


def _free_dims(nx: int, ny: int, nz: int) -> Tuple[int, int, int]:
    return nx - 1, ny + 1, nz + 1


def structured_box_system(
    nx: int,
    ny: int,
    nz: int,
    elem_type: str = "TETRA4",
    bc_ids=(100, 1000),
    dtype=np.float64,
) -> HeatSystem:
    """Reduced heat system of ``box_mesh(nx, ny, nz, elem_type, bc_ids)``,
    bit-identical to ``assemble_heat_system(box_mesh(...))``, built by one
    native lattice pass (no mesh object, no element scan; ``mesh`` is
    None).

    Falls back to the mesh path when the native library is missing or the
    grid is too small for the verified stencil territory (a free dimension
    under 7, the stencil detector's own guard), as JAX does.
    """
    from ..utils.native import load_native

    mx, my, mz = _free_dims(nx, ny, nz)
    tab = box_lattice_tables(elem_type) if min(mx, my, mz) >= 7 else None
    lib = load_native()
    if tab is None or lib is None:
        from ..io.boxmesh import box_mesh
        from .heat import assemble_heat_system

        return assemble_heat_system(
            box_mesh(nx, ny, nz, elem_type=elem_type, bc_ids=bc_ids),
            dtype=dtype,
        )

    n = mx * my * mz
    taps = np.array(tab["taps"], dtype=np.int64)
    # nnz: per (tap, class) -- classes whose pattern value is 0 carry no
    # adjacency on that tap (the native pass skips them); counts are
    # separable per axis over the class's parity-restricted in-range
    # indices.
    p = tab["period"]
    C = p * p * p
    pats = tab["pats"]
    diag_idx = int(tab["diag_idx"])
    ax = [np.arange(mx), np.arange(my), np.arange(mz)]
    dims_ = (mx, my, mz)

    def _cnt(axis, d, par):
        i = ax[axis]
        return int(np.count_nonzero(
            (i % p == par) & (i + d >= 0) & (i + d < dims_[axis])))

    nnz = 0
    for d in range(taps.shape[0]):
        dx, dy, dz = (int(v) for v in taps[d])
        for c in range(C):
            if d != diag_idx and pats[d, c] == 0.0:
                continue
            pz, py_, px_ = c // (p * p), (c // p) % p, c % p
            nnz += _cnt(0, dx, px_) * _cnt(1, dy, py_) * _cnt(2, dz, pz)
    indptr = np.zeros(n + 1, dtype=np.int64)
    indices = np.zeros(nnz, dtype=np.int32)
    data = np.zeros(nnz, dtype=np.float64)
    b = np.zeros(n, dtype=np.float64)
    degree = np.zeros(n, dtype=np.float64)
    lib.assemble_structured(
        mx, my, mz, tab["period"],
        np.ascontiguousarray(taps), taps.shape[0], tab["diag_idx"],
        tab["pats"], tab["opar_ptr"],
        np.ascontiguousarray(tab["opar"].reshape(-1)),
        float(bc_ids[0]), float(bc_ids[1]),
        indptr, indices, data, b, degree,
    )

    # Index maps: free nodes are mesh nodes with 0 < x < nx (the box's
    # nodesets are the two x faces), lexicographic -- closed form.
    mxn, myn, mzn = nx + 1, ny + 1, nz + 1
    num_nodes = mxn * myn * mzn
    node3 = np.arange(mxn, dtype=np.int64)[1:-1]
    free_to_node = (
        node3[None, :]
        + (np.arange(myn * mzn, dtype=np.int64) * mxn)[:, None]
    ).reshape(-1)
    node_to_free = np.full(num_nodes, -1, dtype=np.int64)
    node_to_free[free_to_node] = np.arange(n)

    # Boundary-edge pairs (for rhs_for): rows on the two x planes, one pair
    # per adjacent boundary node -- plane-sized, vectorized.
    rows_lo, cols_lo = _bdry_pairs(tab, mx, my, mz, mxn, lo=True)
    rows_hi, cols_hi = _bdry_pairs(tab, mx, my, mz, mxn, lo=False)
    bdry_rows = np.concatenate([rows_lo, rows_hi])
    bdry_cols = np.concatenate([cols_lo, cols_hi])

    if np.dtype(dtype) != np.float64:
        data = data.astype(np.dtype(dtype))
    A = CSRMatrix(indptr=indptr, indices=indices, data=data, shape=(n, n))
    return HeatSystem(
        A=A,
        b=b,
        free_to_node=free_to_node,
        node_to_free=node_to_free,
        degree=degree,
        mesh=None,
        bdry_rows=bdry_rows,
        bdry_cols=bdry_cols,
    )


def _bdry_pairs(tab, mx, my, mz, mxn, lo: bool):
    """(free row, boundary mesh node) pairs of one x face, vectorized."""
    p = tab["period"]
    opar_ptr, opar = tab["opar_ptr"], tab["opar"]
    want_dx = -1 if lo else 1
    ix = 0 if lo else mx - 1
    xc = ix % p
    iy = np.arange(my)
    iz = np.arange(mz)
    rows_out, cols_out = [], []
    x_node = 0 if lo else mxn - 1
    for c_y in range(p):
        for c_z in range(p):
            c = (c_z * p + c_y) * p + xc
            offs = opar[opar_ptr[c]: opar_ptr[c + 1]]
            offs = offs[offs[:, 0] == want_dx]
            sel_y = iy[iy % p == c_y]
            sel_z = iz[iz % p == c_z]
            if sel_y.size == 0 or sel_z.size == 0:
                continue
            YY = sel_y[None, :, None]  # (1, ny_sel, 1)
            ZZ = sel_z[:, None, None]  # (nz_sel, 1, 1)
            DY = offs[None, None, :, 1]
            DZ = offs[None, None, :, 2]
            ny_, nz_ = YY + DY, ZZ + DZ
            ok = (ny_ >= 0) & (ny_ < my) & (nz_ >= 0) & (nz_ < mz)
            r = ix + mx * (YY + my * ZZ) + 0 * DY
            node = x_node + mxn * (ny_ + my * nz_)
            rows_out.append(np.broadcast_to(r, ok.shape)[ok])
            cols_out.append(node[ok])
    if not rows_out:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(rows_out), np.concatenate(cols_out)


class _NumpyOps:
    """The array operations of :func:`structured_box_parts`, in numpy."""

    @staticmethod
    def zeros(shape):
        return np.zeros(shape, np.float32)

    @staticmethod
    def arange(n):
        return np.arange(n)

    @staticmethod
    def as_f32(a):
        return np.asarray(a, dtype=np.float32)

    @staticmethod
    def place(dst, idx, v):
        dst[idx] = v
        return dst


class _TorchOps:
    """The same operations with torch on ``device``."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.device = device

    def zeros(self, shape):
        return self.torch.zeros(shape, dtype=self.torch.float32,
                                device=self.device)

    def arange(self, n):
        return self.torch.arange(n, device=self.device)

    def as_f32(self, a):
        return self.torch.as_tensor(a, device=self.device).to(
            self.torch.float32)

    @staticmethod
    def place(dst, idx, v):
        dst[idx] = v
        return dst


def structured_box_parts(
    nx: int, ny: int, nz: int,
    elem_type: str = "TETRA4",
    bc_ids=(100, 1000),
    device=False,
) -> Optional[dict]:
    """Scan-free lattice-stencil operator parts of ``box_mesh(nx,ny,nz)``
    plus ``b`` and ``degree`` -- no mesh, no element scan, no CSR.

    ``device=False`` computes ``corr``/``b``/``degree`` in numpy;
    ``device=True`` with torch on the card, and a device name (``"cpu"``,
    ``"cuda:0"``) with torch there: nothing n-sized is built on the host
    or uploaded (JAX's ``device=True`` computes them with jnp on its
    default device).  The closed form is exact in float32 (small integer
    sums), so every route gives the same bits.

    Returns ``dict(parts=..., b=(n_pad,), degree=(n_pad,))`` or None (fall
    back to the host path).  ``parts`` feeds
    :func:`..ops.stencil.stencil_from_parts` and
    :func:`..ops.stencil_kernel.pad_stencil_from_parts`.
    """
    from ..ops.ell import pad_to

    if device is False:
        xp = _NumpyOps()
    else:
        from ..utils.device import resolve_device

        xp = _TorchOps(resolve_device(None if device is True else device))

    mx, my, mz = _free_dims(nx, ny, nz)
    if min(mx, my, mz) < 7:
        return None
    tab = box_lattice_tables(elem_type)
    if tab is None:
        return None
    p = tab["period"]
    C = p * p * p
    taps = tab["taps"]
    diag_idx = tab["diag_idx"]
    n = mx * my * mz
    n_pad = pad_to(n)

    pats = np.asarray(tab["pats"], dtype=np.float32)  # (nd, C)
    opar_ptr, opar = tab["opar_ptr"], tab["opar"]

    # degree(iz, iy, class) = # node-adjacency offsets with valid y/z (x is
    # always valid inside the node grid); per-class (mz, my) maps from
    # shifted index-validity vectors, then broadcast over x by parity.
    iy = xp.arange(my)
    iz = xp.arange(mz)
    ypar = (iy % p)[None, :]
    zpar = (iz % p)[:, None]
    deg_yz = xp.zeros((C, mz, my))
    blo_yz = xp.zeros((C, mz, my))
    bhi_yz = xp.zeros((C, mz, my))
    for c in range(C):
        cz, cy = c // (p * p), (c // p) % p
        cls_mask = (ypar == cy) & (zpar == cz)  # (mz, my)
        offs = opar[opar_ptr[c]: opar_ptr[c + 1]]
        dsum = xp.zeros((mz, my))
        losum = xp.zeros((mz, my))
        hisum = xp.zeros((mz, my))
        for dx, dy, dz in offs:
            oky = (iy + int(dy) >= 0) & (iy + int(dy) < my)
            okz = (iz + int(dz) >= 0) & (iz + int(dz) < mz)
            v = xp.as_f32(okz[:, None] & oky[None, :] & cls_mask)
            dsum = dsum + v
            if dx == -1:
                losum = losum + v
            elif dx == 1:
                hisum = hisum + v
        deg_yz = xp.place(deg_yz, c, dsum)
        blo_yz = xp.place(blo_yz, c, losum)
        bhi_yz = xp.place(bhi_yz, c, hisum)

    xpar = (xp.arange(mx) % p)[None, None, :]
    deg3 = xp.zeros((mz, my, mx))
    b3 = xp.zeros((mz, my, mx))
    for xc in range(p):
        # classes with this x parity, summed over their disjoint (y,z)
        # masks (the sum IS the per-cell value).
        sel = [c for c in range(C) if c % p == xc]
        dmap = sum(deg_yz[c] for c in sel)  # (mz, my)
        xmask = xp.as_f32(xpar == xc)
        deg3 = deg3 + dmap[:, :, None] * xmask
        lomap = sum(blo_yz[c] for c in sel)
        himap = sum(bhi_yz[c] for c in sel)
        xlo = xp.place(xp.zeros(mx), 0, 1.0)[None, None, :] * xmask
        xhi = xp.place(xp.zeros(mx), mx - 1, 1.0)[None, None, :] * xmask
        b3 = b3 + float(bc_ids[0]) * lomap[:, :, None] * xlo
        b3 = b3 + float(bc_ids[1]) * himap[:, :, None] * xhi

    # corr = degree - interior diagonal pattern (per class).
    pat_diag = xp.as_f32(pats[diag_idx].reshape(p, p, p))
    pdiag_grid = pat_diag[
        (xp.arange(mz) % p)[:, None, None],
        (xp.arange(my) % p)[None, :, None],
        (xp.arange(mx) % p)[None, None, :],
    ]
    corr3 = deg3 - pdiag_grid
    corr_pad = xp.place(xp.zeros(n_pad), slice(0, n), corr3.reshape(-1))
    b_pad = xp.place(xp.zeros(n_pad), slice(0, n), b3.reshape(-1))
    deg_pad = xp.place(xp.zeros(n_pad), slice(0, n), deg3.reshape(-1))

    parts = dict(
        pats=np.asarray(tab["pats"], dtype=np.float32).reshape(
            len(taps), p, p, p
        ),
        const_vals=np.asarray(tab["const_vals"], dtype=np.float32),
        corr_pad=corr_pad,
        taps=tuple(taps),
        groups=tab["groups"],
        group_const=tab["group_const"],
        dims=(mx, my, mz),
        period=p,
        n_rows=n,
        n_pad=n_pad,
    )
    return dict(parts=parts, b=b_pad, degree=deg_pad)
