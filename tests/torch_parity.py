"""Shared inputs for the parity tests of the PyTorch port against the JAX
package (``tests/test_torch_*.py``).

Meshes are generated (``box_mesh`` + ``refine_uniform``: unstructured tet
boxes of a few thousand DOF), assembled once with the JAX package, and
handed to both packages as the same numpy arrays.  Random inputs come from
numpy generators with fixed seeds.
"""

from __future__ import annotations

import functools

import numpy as np
import scipy.sparse as sp

from domain_decomposed_pde_solver_tpu.io import box_mesh, refine_uniform
from domain_decomposed_pde_solver_tpu.models import assemble_heat_system
from domain_decomposed_pde_solver_tpu_torch.utils.convert import csr_from_numpy

# Refined TETRA4 boxes: 8^3 -> 3,823 free DOF, 7x6x5 -> 1,573, 6^3 -> 1,643.
MESH_DIMS = [(8, 8, 8), (7, 6, 5)]


def mesh_id(dims) -> str:
    return "tet{}x{}x{}r".format(*dims)


@functools.lru_cache(maxsize=None)
def jax_problem(dims):
    """(mesh, HeatSystem) of the refined tet box, from the JAX package."""
    mesh = refine_uniform(box_mesh(*dims, elem_type="TETRA4"), 1)
    return mesh, assemble_heat_system(mesh)


def port_csr(system):
    """The JAX system's matrix as a port CSR (same arrays)."""
    A = system.A
    return csr_from_numpy(A.indptr, A.indices, A.data, A.shape)


def rand(n: int, seed: int, dtype=np.float64) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=n).astype(dtype)


def relerr(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def random_laplacian(n: int, deg: int, seed: int, shift: float = 0.0):
    """Random graph Laplacian (off-diagonal -1, diagonal the degree) plus
    ``shift`` on the diagonal, as scipy CSR with sorted indices: the graphs
    of the JAX package's BSG and fused-CG tests."""
    rng = np.random.default_rng(seed)
    m = n * deg // 2
    u, v = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = u != v
    u, v = u[keep], v[keep]
    M = sp.coo_matrix((np.ones(2 * u.size), (np.r_[u, v], np.r_[v, u])),
                      shape=(n, n)).tocsr()
    M.data[:] = -1.0
    M.setdiag(0)
    M.eliminate_zeros()
    M.setdiag(-np.asarray(M.sum(axis=1)).ravel() + shift)
    M = M.tocsr()
    M.sort_indices()
    return M


def plane_sides(mesh, axis: int, value: float, side_local_nodes):
    """``(elems, sides)`` of every element side lying on the plane
    ``coords[:, axis] == value``, as an Exodus sideset lists them (global
    element index, 1-based side), as ``examples/05_fem_flux_bcs.py`` builds
    them; ``side_local_nodes`` is either package's."""
    on = np.isclose(mesh.coords[:, axis], value)
    elems, sides = [], []
    off = 0
    for blk in mesh.blocks:
        n_sides = 6 if blk.elem_type.upper().startswith("HEX") else 4
        for s in range(1, n_sides + 1):
            idx = list(side_local_nodes(blk.elem_type, s))
            e = np.nonzero(on[blk.conn[:, idx]].all(axis=1))[0]
            elems.append(e + off)
            sides.append(np.full(e.size, s))
        off += blk.conn.shape[0]
    return (np.concatenate(elems).astype(np.int64),
            np.concatenate(sides).astype(np.int64))


def jax_box10m_route(N: int):
    """``bench10m.py:95-230``'s route in the JAX package at ``N``:
    ``structured_box_system``, ``pad_stencil_from_parts`` of
    ``structured_box_parts``, brick AMG over it, CG+AMG to 1e-6 (f32) and
    refinement to 1e-8 with the staged f64 right-hand side and the
    residual on the device.  Returns ``(system, AMG, CG result, refinement
    result)``."""
    import jax.numpy as jnp

    from domain_decomposed_pde_solver_tpu.models import structured as j_st
    from domain_decomposed_pde_solver_tpu.ops.pallas.stencil_kernel import (
        pad_stencil_from_parts,
    )
    from domain_decomposed_pde_solver_tpu.solvers.cg import cg_solve
    from domain_decomposed_pde_solver_tpu.solvers.mixed import (
        iterative_refinement_solve,
    )
    from domain_decomposed_pde_solver_tpu.solvers.precond.amg import (
        smoothed_aggregation_setup,
    )

    sy = j_st.structured_box_system(N, N, N)
    A = pad_stencil_from_parts(j_st.structured_box_parts(N, N, N)["parts"])
    M = smoothed_aggregation_setup(sy.A, dtype=jnp.float32,
                                   grid_dims=(N - 1, N + 1, N + 1),
                                   fine_operator=A)
    bh = (sy.b / np.abs(sy.b).max()).astype(np.float32)
    b = A.put_vector_sparse(bh)
    r = cg_solve(A, b, jnp.zeros_like(b), precond=M, tol=1e-6, maxiter=100)
    b64 = sy.b.astype(np.float64)
    mr = iterative_refinement_solve(
        sy.A, b64, tol=1e-8, inner_tol=1e-6, inner_maxiter=100, precond=M,
        operator=A, b_device=A.put_vector_sparse(b64, dtype=np.float64),
        device_residual=True)
    return sy, M, r, mr

