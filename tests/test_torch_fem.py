"""The finite-element models (P1 with flux boundaries, P2, Q2): the port's
host copies against the JAX package's, and CG+AMG on the port's operators.

The assembly is numpy in both packages, so the CSR arrays, right-hand
sides and index maps must be equal exactly.  The solves (f64 CG+AMG to
1e-12 on the CPU) must take JAX's iteration counts and reproduce the exact
solution each case is built around: a linear one for the P1 flux problems
(``examples/05_fem_flux_bcs.py``), the quadratics of JAX's
``tests/test_p2.py:42`` and ``tests/test_q2.py:51`` for P2 and Q2, to 1e-9
absolute (values of order 10, CG to 1e-12 relative).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from domain_decomposed_pde_solver_tpu.io import box_mesh as j_box_mesh
from domain_decomposed_pde_solver_tpu.io import mesh as j_mesh
from domain_decomposed_pde_solver_tpu.models import (
    assemble_poisson_fem as j_assemble_fem,
    assemble_poisson_p2 as j_assemble_p2,
    assemble_poisson_q2 as j_assemble_q2,
)
from domain_decomposed_pde_solver_tpu.ops import (
    choose_operator as j_choose_operator,
    pad_vector as j_pad_vector,
    unpad_vector as j_unpad_vector,
)
from domain_decomposed_pde_solver_tpu.solvers import (
    cg_solve as j_cg_solve,
    smoothed_aggregation_setup as j_amg_setup,
)
from domain_decomposed_pde_solver_tpu_torch.io import box_mesh
from domain_decomposed_pde_solver_tpu_torch.io import mesh as p_mesh
from domain_decomposed_pde_solver_tpu_torch.io.sides import side_local_nodes
from domain_decomposed_pde_solver_tpu_torch.models import (
    assemble_poisson_fem,
    assemble_poisson_p2,
    assemble_poisson_q2,
    elevate_to_p2,
    elevate_to_q2,
)
from domain_decomposed_pde_solver_tpu_torch.ops.dia import choose_operator
from domain_decomposed_pde_solver_tpu_torch.solvers import (
    cg_solve,
    smoothed_aggregation_setup,
)
from torch_parity import plane_sides, port_csr

torch.set_num_threads(1)

G = 3.25  # Neumann flux on x = 1
ALPHA, U_ENV = 2.0, 11.0  # Robin (alpha, u_env) on x = 1


def _flux_mesh(make_box, mesh_mod, elem_type):
    """A 6x5x5 box with Dirichlet u = 5 on x = 0 and sideset 77 on x = 1."""
    m = make_box(6, 5, 5, elem_type=elem_type)
    x0 = np.nonzero(np.isclose(m.coords[:, 0], 0.0))[0].astype(np.int64)
    m.node_sets = [mesh_mod.NodeSet(id=5, nodes=x0)]
    e, s = plane_sides(m, 0, 1.0, side_local_nodes)
    m.side_sets = [mesh_mod.SideSet(id=77, elems=e, sides=s)]
    return m


def _u_quad_p2(c):
    return c[:, 0] ** 2 + 2 * c[:, 1] ** 2 - 3 * c[:, 2] ** 2


def _u_quad_q2(c):
    return c[:, 0] ** 2 + 2 * c[:, 1] ** 2 + 3 * c[:, 2] ** 2 - c[:, 0] * c[:, 1]


def _f_q2(c):
    return np.full(c.shape[0], -12.0)


CASES = {
    "p1-tet-neumann": ("fem", "TETRA4", dict(neumann={77: G})),
    "p1-tet-robin": ("fem", "TETRA4", dict(robin={77: (ALPHA, U_ENV)})),
    "p1-hex-neumann": ("fem", "HEX8", dict(neumann={77: G})),
    "p1-hex-robin": ("fem", "HEX8", dict(robin={77: (ALPHA, U_ENV)})),
    "p2": ("p2", "TETRA4", dict(dirichlet=_u_quad_p2)),
    "q2": ("q2", "HEX8", dict(dirichlet=_u_quad_q2, f=_f_q2)),
}


@functools.lru_cache(maxsize=None)
def _systems(case):
    """(port system, JAX system, DOF coordinates) of one case."""
    kind, elem, kw = CASES[case]
    if kind == "fem":
        pm = _flux_mesh(box_mesh, p_mesh, elem)
        jm = _flux_mesh(j_box_mesh, j_mesh, elem)
        return (assemble_poisson_fem(pm, **kw), j_assemble_fem(jm, **kw),
                pm.coords)
    pm, jm = box_mesh(6, 5, 5, elem), j_box_mesh(6, 5, 5, elem)
    if kind == "p2":
        return (assemble_poisson_p2(pm, **kw), j_assemble_p2(jm, **kw),
                elevate_to_p2(pm)[0])
    return (assemble_poisson_q2(pm, **kw), j_assemble_q2(jm, **kw),
            elevate_to_q2(pm)[0])


def _exact(case, coords):
    kind, _elem, kw = CASES[case]
    if kind != "fem":
        return kw["dirichlet"](coords)
    if "neumann" in kw:
        return 5.0 + G * coords[:, 0]
    return 5.0 + ALPHA * (U_ENV - 5.0) / (1.0 + ALPHA) * coords[:, 0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_assembly_matches_jax(case):
    p, j, _coords = _systems(case)
    assert p.A.shape == j.A.shape
    for name in ("indptr", "indices", "data"):
        a, b = getattr(p.A, name), getattr(j.A, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for name in ("b", "free_to_node", "node_to_free", "degree"):
        np.testing.assert_array_equal(getattr(p, name), getattr(j, name))


@pytest.mark.parametrize("case", sorted(CASES))
def test_cg_amg_takes_jax_iterations(case):
    p, j, coords = _systems(case)
    A = choose_operator(port_csr(p), dtype=torch.float64, device="cpu")
    M = smoothed_aggregation_setup(port_csr(p), dtype=torch.float64,
                                   device="cpu")
    b = A.put_vector(p.b, dtype=torch.float64)
    res = cg_solve(A, b, torch.zeros_like(b), precond=M, tol=1e-12,
                   maxiter=600)
    JA = j_choose_operator(j.A, dtype=jnp.float64)
    jb = j_pad_vector(j.b, JA.n_pad)
    jres = j_cg_solve(JA, jb, jnp.zeros_like(jb),
                      precond=j_amg_setup(j.A, dtype=jnp.float64), tol=1e-12,
                      maxiter=600)
    # DIA where JAX takes DIA; the sliced-ELL operator where JAX takes
    # Split-ELL or ELL (the port's choose_operator).
    assert (type(A).__name__ == "DIAMatrix") == (
        type(JA).__name__ == "DIAMatrix")
    assert res.converged and bool(jres.converged)
    assert res.iterations == int(jres.iterations)
    u = A.get_vector(res.x)
    exact = _exact(case, coords[p.free_to_node])
    assert np.abs(u - exact).max() <= 1e-9
    assert np.abs(u - j_unpad_vector(jres.x, j.n_free)).max() <= 1e-9
