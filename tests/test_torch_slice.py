"""The port's serving entry point, end to end, against the JAX pipeline.

``SteadyHeatSolver`` of the port (mesh -> assembly -> RCM sliced-ELL
operator -> SA-AMG with ``fine_operator`` -> CG, then a warm solve with new
boundary values -> Exodus output) is held to the JAX package's unstructured
pipeline built explicitly as it runs on a TPU: ``bsg_from_csr``,
``smoothed_aggregation_setup(fine_operator=...)``, ``cg_solve`` with the
same warm start.  Tolerances as in ``test_torch_solvers.py``: iteration
counts equal in f64 (within one in f32), solutions to 1e-10 relative in
f64 (summation order, amplified by the condition number).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from domain_decomposed_pde_solver_tpu.api import SteadyHeatSolver as JSolver
from domain_decomposed_pde_solver_tpu.io import read_nodal_vars as j_read_nodal_vars
from domain_decomposed_pde_solver_tpu.ops.bsg import bsg_from_csr as j_bsg_from_csr
from domain_decomposed_pde_solver_tpu.solvers.cg import cg_solve as j_cg_solve
from domain_decomposed_pde_solver_tpu.solvers.precond.amg import (
    smoothed_aggregation_setup as j_sa_setup,
)
from domain_decomposed_pde_solver_tpu.solvers.precond.jacobi import (
    jacobi_preconditioner as j_jacobi,
)
from domain_decomposed_pde_solver_tpu_torch import SteadyHeatSolver
from domain_decomposed_pde_solver_tpu_torch.io import box_mesh, refine_uniform
from domain_decomposed_pde_solver_tpu_torch.ops.bsg import BSGMatrix
from torch_parity import MESH_DIMS, jax_problem, relerr

torch.set_num_threads(1)

BC = {100: 80.0, 1000: 25.0}


def _port_solver(dims, dtype, precond="amg", device="cpu"):
    mesh = refine_uniform(box_mesh(*dims, elem_type="TETRA4"), 1)
    return SteadyHeatSolver(mesh, dtype=dtype, precond=precond, device=device)


def _jax_pipeline(dims, jdt, precond, tol, bc_b):
    """The JAX unstructured route, explicitly: cold solve, then a warm one
    on ``bc_b`` from the first answer; returns both results and A."""
    _mesh, sy = jax_problem(dims)
    A = j_bsg_from_csr(sy.A)
    if precond == "amg":
        M = j_sa_setup(sy.A, dtype=jdt, fine_operator=A)
    else:
        M = j_jacobi(A)
    npdt = np.dtype(jdt)
    b1 = A.put_vector(sy.b.astype(npdt), dtype=jdt)
    r1 = j_cg_solve(A, b1, jnp.zeros_like(b1), precond=M, tol=tol,
                    maxiter=1000)
    u1 = A.get_vector(r1.x)
    b2 = A.put_vector(bc_b.astype(npdt), dtype=jdt)
    x0 = A.put_vector(np.array(u1).astype(npdt), dtype=jdt)
    r2 = j_cg_solve(A, b2, x0, precond=M, tol=tol, maxiter=1000)
    return (r1, u1), (r2, A.get_vector(r2.x))


@pytest.mark.parametrize(
    "dims,dtype_name,precond,slack",
    [
        (MESH_DIMS[0], "float64", "amg", 0),
        (MESH_DIMS[1], "float64", "amg", 0),
        (MESH_DIMS[0], "float32", "amg", 1),
        (MESH_DIMS[1], "float64", "jacobi", 0),
    ],
    ids=["tet8r-f64-amg", "tet7x6x5r-f64-amg", "tet8r-f32-amg",
         "tet7x6x5r-f64-jacobi"],
)
def test_steady_heat_solver_matches_jax_pipeline(dims, dtype_name, precond,
                                                  slack):
    tdt, jdt = getattr(torch, dtype_name), getattr(jnp, dtype_name)
    tol = 1e-10 if dtype_name == "float64" else 1e-6
    s = _port_solver(dims, tdt, precond)
    assert isinstance(s.operator, BSGMatrix) and s.operator.perm is not None
    u1, res1 = s.solve(tol=tol)
    u2, res2 = s.solve(bc=BC, tol=tol)
    (j1, ju1), (j2, ju2) = _jax_pipeline(dims, jdt, precond, tol,
                                          s.rhs_for(BC))
    for res, jres, u, ju in ((res1, j1, u1, ju1), (res2, j2, u2, ju2)):
        assert res.converged and bool(jres.converged)
        assert abs(res.iterations - int(jres.iterations)) <= slack
        assert u.dtype == np.dtype(dtype_name)
        if dtype_name == "float64":
            assert relerr(u, ju) <= 1e-10
    # Maximum principle: the answers lie within the boundary values.
    assert 100.0 <= u1.min() and u1.max() <= 1000.0
    assert 25.0 <= u2.min() and u2.max() <= 80.0
    # Without the warm start the second problem converges to the same answer.
    u3, res3 = s.solve(bc=BC, tol=tol, warm_start=False)
    assert res3.converged
    if dtype_name == "float64":
        assert relerr(u3, u2) <= 1e-8


def test_rhs_and_boundary_values_match_jax():
    dims = MESH_DIMS[1]
    mesh_j, _sy = jax_problem(dims)
    js = JSolver(mesh_j, precond="none")
    s = _port_solver(dims, torch.float64, precond="none")
    for bc in (None, BC, {100: -3.5}):
        np.testing.assert_array_equal(s.rhs_for(bc), js.rhs_for(bc))
        np.testing.assert_array_equal(s.boundary_values_for(bc),
                                      js.boundary_values_for(bc))
    with pytest.raises(ValueError, match="not present"):
        s.rhs_for({7: 1.0})


def test_write_solution_reads_back_through_jax(tmp_path):
    s = _port_solver(MESH_DIMS[1], torch.float64)
    u, res = s.solve(bc=BC, tol=1e-10)
    path = str(tmp_path / "sol.exo")
    s.write_solution(path, u, bc=BC, timestep=3)
    names, times, vals = j_read_nodal_vars(path)
    assert names == ["Steady-State Heat Solution"]
    np.testing.assert_array_equal(times, [0.0, 3.0])
    np.testing.assert_array_equal(vals[0, 0], s.boundary_values_for(BC))
    np.testing.assert_array_equal(vals[1, 0, s.system.free_to_node], u)
    fixed = np.ones(s.mesh.num_nodes, bool)
    fixed[s.system.free_to_node] = False
    np.testing.assert_array_equal(vals[1, 0, fixed],
                                  s.boundary_values_for(BC)[fixed])


def test_solver_residual_on_the_host():
    """The answer solves the assembled system (host f64 residual)."""
    s = _port_solver(MESH_DIMS[0], torch.float64)
    u, res = s.solve(tol=1e-10)
    b = s.system.b
    rr = np.linalg.norm(b - s.system.A.matvec(u)) / np.linalg.norm(b)
    assert rr <= 1e-9
    assert res.relres <= 1e-10


@pytest.mark.parametrize("elem", ["TETRA4", "HEX8"])
def test_structured_box_solves_like_jax(elem):
    """A lexicographic box takes the structured route in both packages:
    DIA (f64) fine operator, brick aggregates at level 0, the same CG+AMG
    iterations and the same answer (f64: 1e-10, summation order)."""
    mesh = box_mesh(10, 9, 8, elem_type=elem)
    s = SteadyHeatSolver(mesh, dtype=torch.float64, precond="amg",
                         device="cpu")
    js = JSolver(box_mesh(10, 9, 8, elem_type=elem), precond="amg")
    assert type(s.operator).__name__ == type(js.operator).__name__ == "DIAMatrix"
    assert [type(l.P).__name__ for l in s._precond.levels][0] == \
        "BrickProlongator"
    u, res = s.solve(tol=1e-10)
    ju, jres = js.solve(tol=1e-10)
    assert res.converged and res.iterations == int(jres.iterations)
    assert relerr(u, ju) <= 1e-10
    assert 100.0 <= u.min() and u.max() <= 1000.0


def test_cuda_request_without_a_card_raises():
    """The card is asked for explicitly, or by default."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for device in ("cuda", None):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _port_solver(MESH_DIMS[1], torch.float32, device=device)
