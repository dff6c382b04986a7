"""The structured route of the port against the JAX package: brick AMG over
a stencil, pad-stencil or DIA fine level, CG+AMG, and mixed-precision
iterative refinement (``solvers/precond/amg.py``, ``api.py``,
``solvers/mixed.py``).

The box ``box_mesh(26, 26, 26, "TETRA4")`` (free grid 25 x 27 x 27, 18,225
DOF) gives the hierarchy [18225, 125] with a DIA level 1, the shape of the
1M-DOF box's [1009899, 4913].  Both packages get the same assembled
arrays; random vectors come from numpy with fixed seeds.

Tolerances: host setup pieces equal; device arrays equal up to f32/f64
rounding of the same operations (1e-6 relative in f32, 1e-12 in f64); CG
iterations equal in f64, within one in f32 (summation order moves the
stopping iteration); refinement sweeps equal, inner iterations within one
per sweep (f32 inner solves); answers within the f64 solve tolerance
amplified by the condition number (1e-10 relative for f64 CG to 1e-10;
1e-6 for the refined answers, whose inner solves are f32).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from domain_decomposed_pde_solver_tpu.api import SteadyHeatSolver as JSolver
from domain_decomposed_pde_solver_tpu.io import box_mesh as j_box_mesh
from domain_decomposed_pde_solver_tpu.models import assemble_heat_system
from domain_decomposed_pde_solver_tpu.ops import dia as j_dia
from domain_decomposed_pde_solver_tpu.solvers.cg import cg_solve as j_cg_solve
from domain_decomposed_pde_solver_tpu.solvers.mixed import (
    iterative_refinement_solve as j_refine,
)
from domain_decomposed_pde_solver_tpu.solvers.precond import amg as j_amg
from domain_decomposed_pde_solver_tpu_torch import SteadyHeatSolver
from domain_decomposed_pde_solver_tpu_torch.io import box_mesh
from domain_decomposed_pde_solver_tpu_torch.ops import dia as p_dia
from domain_decomposed_pde_solver_tpu_torch.solvers.cg import cg_solve
from domain_decomposed_pde_solver_tpu_torch.solvers.mixed import (
    _adaptive_inner_tol,
    iterative_refinement_solve,
)
from domain_decomposed_pde_solver_tpu_torch.solvers.precond import amg as p_amg
from torch_parity import port_csr, rand, relerr

torch.set_num_threads(1)

BOX = (26, 26, 26)


@functools.lru_cache(maxsize=None)
def _box(shape=BOX, elem="TETRA4"):
    mesh = j_box_mesh(*shape, elem_type=elem)
    sy = assemble_heat_system(mesh)
    dims = j_amg.infer_free_grid(mesh, sy.free_to_node)
    return sy, port_csr(sy), dims


def _ops(route):
    """(JAX operator, port operator, dtype name) for a route:
    "pad" f32 pad-stencil, "stencil" f32 identity stencil, "dia" f64 DIA."""
    sy, csr, dims = _box()
    name = "float64" if route == "dia" else "float32"
    pad = "always" if route == "pad" else "never"
    Aj = j_dia.choose_operator(sy.A, dtype=getattr(jnp, name),
                               grid_dims=dims, pad_stencil=pad)
    Ap = p_dia.choose_operator(csr, dtype=getattr(torch, name),
                               grid_dims=dims, pad_stencil=pad, device="cpu")
    return Aj, Ap, name


def _hierarchies(route):
    sy, csr, dims = _box()
    Aj, Ap, name = _ops(route)
    fine = route == "pad"
    Mj = j_amg.smoothed_aggregation_setup(
        sy.A, dtype=getattr(jnp, name), grid_dims=dims,
        fine_operator=Aj if fine else None)
    Mp = p_amg.smoothed_aggregation_setup(
        csr, dtype=getattr(torch, name), grid_dims=dims,
        fine_operator=Ap if fine else None, device="cpu")
    return Aj, Ap, Mj, Mp, name


@pytest.mark.parametrize("route", ["pad", "stencil", "dia"])
def test_hierarchy_matches_jax(route):
    Aj, Ap, Mj, Mp, name = _hierarchies(route)
    tol = 1e-6 if name == "float32" else 1e-12
    assert [l.n_rows for l in Mp.levels] == [l.n_rows for l in Mj.levels] \
        == [18225, 125]
    kinds_j = [(type(l.A).__name__, type(l.P).__name__) for l in Mj.levels]
    kinds_p = [(type(l.A).__name__, type(l.P).__name__) for l in Mp.levels]
    assert kinds_p == kinds_j
    brick = "PadBrickProlongator" if route == "pad" else "BrickProlongator"
    assert kinds_p[0][1] == brick
    assert kinds_p[1] == ("DIAMatrix", "FactoredProlongator")
    for lj, lp in zip(Mj.levels, Mp.levels):
        assert float(lp.lmax) == float(lj.lmax)
        assert lp.A.n_pad == lj.A.n_pad
        np.testing.assert_allclose(lp.inv_diag.numpy(),
                                   np.asarray(lj.inv_diag), rtol=tol)
    for attr in ("tval", "scale"):
        np.testing.assert_allclose(getattr(Mp.levels[0].P, attr).numpy(),
                                   np.asarray(getattr(Mj.levels[0].P, attr)),
                                   rtol=tol)
    # Level 1: the brick-coarse Galerkin operator, DIA in both packages.
    dj, dp = Mj.levels[1].A, Mp.levels[1].A
    assert dp.offsets == dj.offsets and dp.compute_dtype == dj.compute_dtype
    np.testing.assert_array_equal(dp.data.numpy(), np.asarray(dj.data))
    np.testing.assert_array_equal(Mp.levels[1].P.agg.numpy(),
                                  np.asarray(Mj.levels[1].P.agg))
    np.testing.assert_allclose(Mp.coarse_inv.numpy(),
                               np.asarray(Mj.coarse_inv), rtol=tol,
                               atol=tol * float(np.abs(Mj.coarse_inv).max()))
    # One V-cycle on the same residual.
    sy = _box()[0]
    r = rand(sy.A.n_rows, seed=11).astype(name)
    zj = Aj.get_vector(Mj(Aj.put_vector(r, dtype=getattr(jnp, name))))
    zp = Ap.get_vector(Mp(Ap.put_vector(r, dtype=getattr(torch, name))))
    assert relerr(zp, zj) <= (1e-5 if name == "float32" else 1e-12)


@pytest.mark.parametrize("name,slack", [("float64", 0), ("float32", 1)])
def test_cg_amg_iterations_match_jax_through_the_api(name, slack):
    tol = 1e-10 if name == "float64" else 1e-6
    s = SteadyHeatSolver(box_mesh(*BOX, elem_type="TETRA4"),
                         dtype=getattr(torch, name), device="cpu")
    js = JSolver(j_box_mesh(*BOX, elem_type="TETRA4"),
                 dtype=getattr(jnp, name))
    assert type(s.operator).__name__ == type(js.operator).__name__
    assert type(s.operator).__name__ == (
        "DIAMatrix" if name == "float64" else "StencilOperator")
    u, res = s.solve(tol=tol)
    ju, jres = js.solve(tol=tol)
    assert res.converged and bool(jres.converged)
    assert abs(res.iterations - int(jres.iterations)) <= slack
    if name == "float64":
        assert relerr(u, ju) <= 1e-10
    b = s.system.b
    host = np.linalg.norm(b - s.system.A.matvec(u.astype(np.float64)))
    assert host / np.linalg.norm(b) <= (1e-9 if name == "float64" else 2e-6)


def test_cg_amg_with_the_pad_stencil_fine_level_matches_jax():
    sy = _box()[0]
    Aj, Ap, Mj, Mp, _name = _hierarchies("pad")
    b = (sy.b / np.abs(sy.b).max()).astype(np.float32)
    rj = j_cg_solve(Aj, Aj.put_vector(b), jnp.zeros(Aj.n_pad, jnp.float32),
                    precond=Mj, tol=1e-6, maxiter=100)
    rp = cg_solve(Ap, Ap.put_vector(b), torch.zeros(Ap.n_pad), precond=Mp,
                  tol=1e-6, maxiter=100)
    assert rp.converged and bool(rj.converged)
    assert abs(rp.iterations - int(rj.iterations)) <= 1
    # The pad-slot invariant survives the preconditioned solve.
    assert not torch.any(rp.x[Ap.pad_mask() == 0])
    x = Ap.get_vector(rp.x).astype(np.float64)
    assert np.linalg.norm(sy.A.matvec(x) - b) / np.linalg.norm(b) <= 2e-6


@pytest.mark.parametrize("route", ["pad", "stencil"])
def test_iterative_refinement_matches_jax(route):
    """The CLI's f64 route: f32 CG+AMG sweeps, f64 residual on the device
    (the stencil's dtype-generic product), random initial guess."""
    sy = _box()[0]
    Aj, Ap, Mj, Mp, _name = _hierarchies(route)
    x0 = np.random.default_rng(0).uniform(-1.0, 1.0, size=sy.A.n_rows)
    mj = j_refine(sy.A, sy.b, x0=x0, tol=1e-8, precond=Mj, operator=Aj)
    mp = iterative_refinement_solve(_box()[1], sy.b, x0=x0, tol=1e-8,
                                    precond=Mp, operator=Ap)
    assert mp.converged and mj.converged
    assert mp.refinements == mj.refinements
    assert abs(mp.inner_iterations - mj.inner_iterations) <= mj.refinements
    host = np.linalg.norm(sy.b - sy.A.matvec(mp.x)) / np.linalg.norm(sy.b)
    assert host <= 1e-8 and abs(host - mp.relres) <= 1e-3 * mp.relres
    assert relerr(mp.x, mj.x) <= 1e-6
    assert set(mp.timings) == {"stage_ms", "sweeps_ms", "fetch_ms"}


def test_iterative_refinement_host_residual_matches_jax():
    """The host-residual path (any operator; here forced on the stencil),
    with CG+AMG inner solves (long f32 Jacobi-CG runs drift apart by
    several iterations through rounding alone)."""
    sy, csr, _dims = _box()
    Aj, Ap, Mj, Mp, _name = _hierarchies("stencil")
    mj = j_refine(sy.A, sy.b, tol=1e-9, operator=Aj, precond=Mj,
                  device_residual=False)
    mp = iterative_refinement_solve(csr, sy.b, tol=1e-9, operator=Ap,
                                    precond=Mp, device_residual=False)
    assert mp.converged and mj.converged and mp.timings is None
    assert mp.refinements == mj.refinements
    assert abs(mp.inner_iterations - mj.inner_iterations) <= mj.refinements
    assert relerr(mp.x, mj.x) <= 1e-6


def test_adaptive_inner_tol_and_f32_exact_gate_match_jax():
    from domain_decomposed_pde_solver_tpu.solvers import mixed as j_mixed
    from domain_decomposed_pde_solver_tpu_torch.solvers import mixed as p_mixed

    for args in ((1e-6, 1e-8, 1.0), (1e-6, 1e-8, 3e-5), (1e-6, 1e-8, 1e-12)):
        assert _adaptive_inner_tol(*args) == j_mixed._adaptive_inner_tol(*args)
    sy, csr, _dims = _box()
    assert p_mixed._f32_exact(csr) and j_mixed._f32_exact(sy.A)


def test_brick_aggregate_matches_jax():
    for dims, brick in (((25, 27, 27), 6), ((7, 9, 11), 4), ((13, 5, 8), 3)):
        np.testing.assert_array_equal(p_amg.brick_aggregate(dims, brick),
                                      j_amg.brick_aggregate(dims, brick))


def test_pad_brick_level0_device_matches_jax_and_host():
    """The level-0 vectors in the pad-stencil space, built on the device
    (by the port at every size, by JAX above 4M rows): equal to JAX's on
    the real slots, and to the host scatter JAX uses below 4M rows on all
    slots (tval and scale 0 on pads)."""
    sy, _csr, dims = _box()
    Aj, Ap, _name = _ops("pad")
    lmax, omega, brick = 1.7, 4.0 / 3.0, 6
    tj = j_amg._pad_brick_level0_device(Aj, brick, omega, lmax,
                                         jnp.dtype(jnp.float32))
    tp = p_amg._pad_brick_level0_device(Ap, brick, omega, lmax,
                                         torch.float32)
    mask = Ap.pad_mask().numpy() > 0
    for a, b in zip(tp, tj):
        np.testing.assert_allclose(a.numpy()[mask], np.asarray(b)[mask],
                                   rtol=1e-6)
    assert not np.any(tp[0].numpy()[~mask])
    assert not np.any(tp[1].numpy()[~mask])
    agg = p_amg.brick_aggregate(dims, brick)
    counts = np.bincount(agg).astype(np.float64)
    tval_h = np.zeros(Ap.n_pad)
    tval_h[Ap.space_map()] = 1.0 / np.sqrt(counts[agg])
    np.testing.assert_allclose(tp[0].numpy(), tval_h, rtol=1e-6)
    d = sy.A.diagonal()
    scale_h = np.zeros(Ap.n_pad)
    scale_h[Ap.space_map()] = (omega / lmax) / np.where(d != 0, d, 1.0)
    np.testing.assert_allclose(tp[1].numpy(), scale_h, rtol=1e-6)


def test_mismatched_grid_dims_fall_back_to_greedy_aggregation():
    sy, csr, dims = _box((9, 9, 9))
    with pytest.warns(UserWarning, match="does not match"):
        Mp = p_amg.smoothed_aggregation_setup(
            csr, grid_dims=(dims[0] + 1, dims[1], dims[2]), device="cpu")
    assert type(Mp.levels[0].P).__name__ == "FactoredProlongator"
