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
