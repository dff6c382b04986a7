"""CG, Jacobi, the Chebyshev smoother and SA-AMG of the port against the
JAX package, on the unstructured route as JAX runs it on a TPU.

The JAX side is built explicitly the way its TPU path builds it: the BSG
operator from ``bsg_from_csr`` and ``smoothed_aggregation_setup(...,
fine_operator=...)`` (JAX's ``SteadyHeatSolver`` on a CPU takes Split-ELL
or ELL and no fine operator, a different hierarchy).  Both packages get
the same assembled arrays.

Tolerances, each from summation order: the two packages add the same
products in different orders (XLA's reductions against PyTorch's), so f64
results differ by rounding that CG and the V-cycle amplify at most by the
condition number of these small systems (~1e3): 1e-10 on solutions and
V-cycle outputs, 1e-12 on single operators.  Iteration counts are equal in
f64; in f32 rounding can move the stopping iteration by one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from domain_decomposed_pde_solver_tpu.ops.bsg import bsg_from_csr as j_bsg_from_csr
from domain_decomposed_pde_solver_tpu.solvers.cg import cg_solve as j_cg_solve
from domain_decomposed_pde_solver_tpu.solvers.precond import amg as j_amg
from domain_decomposed_pde_solver_tpu.solvers.precond.cheby import (
    chebyshev_smooth as j_cheby,
)
from domain_decomposed_pde_solver_tpu.solvers.precond.jacobi import (
    jacobi_preconditioner as j_jacobi,
)
from domain_decomposed_pde_solver_tpu_torch.ops.bsg import BSGMatrix, bsg_from_csr
from domain_decomposed_pde_solver_tpu_torch.solvers.cg import (
    IdentityPrecond,
    cg_solve,
    cg_solve_with_state,
)
from domain_decomposed_pde_solver_tpu_torch.solvers.precond import amg as p_amg
from domain_decomposed_pde_solver_tpu_torch.solvers.precond.cheby import (
    chebyshev_smooth,
)
from domain_decomposed_pde_solver_tpu_torch.solvers.precond.jacobi import (
    jacobi_preconditioner,
)
from torch_parity import MESH_DIMS, jax_problem, mesh_id, port_csr, rand, relerr

torch.set_num_threads(1)

# (JAX and port keyword arguments): default thresholds (explicit ELL P/R
# on level 1), then G/GT and sliced-ELL mid levels forced on, then a
# deeper hierarchy of them.
AMG_CASES = {
    "default": {},
    "chain": dict(bsg_transfer_min_rows=0, bsg_level_min_rows=50),
    "deep": dict(bsg_transfer_min_rows=0, bsg_level_min_rows=20,
                 coarse_size=12),
}


def _systems(dims):
    _mesh, sy = jax_problem(dims)
    return sy, port_csr(sy)


def _dense_of(matvec, n, n_in, dtype_np, backend):
    """Materialize the leading (n x n) block of a level operator."""
    cols = []
    for j in range(n):
        e = np.zeros(n_in, dtype=dtype_np)
        e[j] = 1.0
        if backend == "jax":
            y = np.asarray(matvec(jnp.asarray(e)))
        else:
            y = matvec(torch.from_numpy(e)).numpy()
        cols.append(y[:n])
    return np.stack(cols, axis=1)


@pytest.mark.parametrize("precond", ["jacobi", "none"])
@pytest.mark.parametrize("dims", MESH_DIMS, ids=mesh_id)
def test_cg_jacobi_f64_matches_jax(dims, precond):
    sy, csr = _systems(dims)
    Aj = j_bsg_from_csr(sy.A)
    Ap = bsg_from_csr(csr, device="cpu")
    bj = Aj.put_vector(sy.b, dtype=jnp.float64)
    bp = Ap.put_vector(sy.b, dtype=torch.float64)
    Mj = j_jacobi(Aj) if precond == "jacobi" else None
    Mp = jacobi_preconditioner(Ap) if precond == "jacobi" else IdentityPrecond()
    rj = j_cg_solve(Aj, bj, jnp.zeros_like(bj), precond=Mj, tol=1e-10,
                    maxiter=2000)
    rp = cg_solve(Ap, bp, torch.zeros_like(bp), precond=Mp, tol=1e-10,
                  maxiter=2000)
    assert rp.converged and bool(rj.converged)
    assert rp.iterations == int(rj.iterations)
    assert abs(rp.relres - float(rj.relres)) <= 1e-3 * float(rj.relres)
    assert relerr(Ap.get_vector(rp.x), Aj.get_vector(rj.x)) <= 1e-10


def test_cg_resumes_exactly_from_state():
    sy, csr = _systems(MESH_DIMS[1])
    A = bsg_from_csr(csr, device="cpu")
    b = A.put_vector(sy.b, dtype=torch.float64)
    M = jacobi_preconditioner(A)
    full, _ = cg_solve_with_state(A, b, torch.zeros_like(b), precond=M,
                                  tol=1e-10, maxiter=500)
    part, state = cg_solve_with_state(A, b, torch.zeros_like(b), precond=M,
                                      tol=1e-10, maxiter=7)
    rest, _ = cg_solve_with_state(A, b, part.x, state=state, precond=M,
                                  tol=1e-10, maxiter=500)
    assert part.iterations == 7 and not part.converged
    assert part.iterations + rest.iterations == full.iterations
    assert torch.equal(rest.x, full.x)


def test_cg_zero_rhs_returns_immediately():
    sy, csr = _systems(MESH_DIMS[1])
    A = bsg_from_csr(csr, device="cpu")
    b = torch.zeros(A.n_pad, dtype=torch.float64)
    res = cg_solve(A, b, torch.zeros_like(b), tol=1e-10)
    assert res.iterations == 0 and res.converged and res.relres == 0.0


@pytest.mark.parametrize("x_zero", [True, False])
def test_chebyshev_smooth_matches_jax(x_zero):
    sy, csr = _systems(MESH_DIMS[0])
    Aj = j_bsg_from_csr(sy.A)
    Ap = bsg_from_csr(csr, device="cpu")
    n = sy.A.n_rows
    b, x = rand(n, seed=21), rand(n, seed=22)
    lmax = 1.7
    inv_j = 1.0 / Aj.diagonal_padded(1.0).astype(jnp.float64)
    inv_p = 1.0 / Ap.diagonal_padded(1.0).double()
    yj = j_cheby(Aj.matvec, inv_j, jnp.asarray(lmax, jnp.float64), 3,
                 Aj.put_vector(x, dtype=jnp.float64),
                 Aj.put_vector(b, dtype=jnp.float64), x_zero=x_zero)
    yp = chebyshev_smooth(Ap.matvec, inv_p, torch.tensor(lmax,
                          dtype=torch.float64), 3,
                          Ap.put_vector(x, dtype=torch.float64),
                          Ap.put_vector(b, dtype=torch.float64), x_zero=x_zero)
    assert relerr(Ap.get_vector(yp), Aj.get_vector(yj)) <= 1e-12


@pytest.mark.parametrize("dims", MESH_DIMS, ids=mesh_id)
def test_host_setup_pieces_match_jax(dims):
    sy, csr = _systems(dims)
    np.testing.assert_array_equal(
        p_amg.aggregate_greedy(csr), j_amg.aggregate_greedy(sy.A)
    )
    S_p, S_j = p_amg._to_scipy(csr), j_amg._to_scipy(sy.A)
    assert p_amg._lmax_dinv_a_host(S_p) == j_amg._lmax_dinv_a_host(S_j)
    F_p = p_amg._filter_weak_entries(S_p, 0.2)
    F_j = j_amg._filter_weak_entries(S_j, 0.2)
    assert (F_p != F_j).nnz == 0


def _hierarchies(dims, dtype_name, case):
    sy, csr = _systems(dims)
    kw = AMG_CASES[case]
    jdt, tdt = getattr(jnp, dtype_name), getattr(torch, dtype_name)
    Aj = j_bsg_from_csr(sy.A)
    Ap = bsg_from_csr(csr, device="cpu")
    Mj = j_amg.smoothed_aggregation_setup(sy.A, dtype=jdt, fine_operator=Aj,
                                          **kw)
    Mp = p_amg.smoothed_aggregation_setup(csr, dtype=tdt, fine_operator=Ap,
                                          **kw)
    return sy, Aj, Ap, Mj, Mp


@pytest.mark.parametrize("case", sorted(AMG_CASES))
def test_amg_hierarchy_matches_jax_f64(case):
    sy, Aj, Ap, Mj, Mp = _hierarchies(MESH_DIMS[0], "float64", case)
    assert [l.n_rows for l in Mp.levels] == [l.n_rows for l in Mj.levels]
    assert len(Mp.levels) >= 2
    kinds = [(type(lj.P).__name__, type(lp.P).__name__)
             for lj, lp in zip(Mj.levels, Mp.levels)]
    if case != "default":
        assert all(k == ("BSGTransferProlongator",) * 2 for k in kinds), kinds
        assert all(isinstance(l.A, BSGMatrix) for l in Mp.levels)
        assert all(l.A.perm is None for l in Mp.levels[1:])
    for lj, lp in zip(Mj.levels, Mp.levels):
        assert float(lj.lmax) == float(lp.lmax)
        m = min(lj.inv_diag.shape[0], lp.inv_diag.shape[0])
        np.testing.assert_array_equal(np.asarray(lj.inv_diag)[:m],
                                      lp.inv_diag.numpy()[:m])
    # Coarse operators (levels >= 1, identity internal space in both):
    # materialized and equal to f64 rounding.
    for lj, lp in zip(Mj.levels[1:], Mp.levels[1:]):
        n = lj.n_rows
        Dj = _dense_of(lj.A.matvec, n, lj.A.n_pad, np.float64, "jax")
        Dp = _dense_of(lp.A.matvec, n, lp.A.n_pad, np.float64, "torch")
        assert relerr(Dp, Dj) <= 1e-12
    # The coarse solve: the inverse of the coarsest Galerkin operator (the
    # padded blocks are identity in both).
    Cj, Cp = np.asarray(Mj.coarse_inv), Mp.coarse_inv.numpy()
    m = min(Cj.shape[0], Cp.shape[0])
    assert relerr(Cp[:m, :m], Cj[:m, :m]) <= 1e-12
    # Restriction and prolongation of every level on the same vectors (the
    # padded lengths differ: JAX pads non-chain levels to 8, the port to
    # 1024; padding slots carry zeros or are never read).
    rng = np.random.default_rng(31)
    for k, (lj, lp) in enumerate(zip(Mj.levels, Mp.levels)):
        n = lj.n_rows
        v = rng.normal(size=n)
        if k == 0:
            r_j = Aj.put_vector(v, dtype=jnp.float64)
            r_p = Ap.put_vector(v, dtype=torch.float64)
        else:
            r_j = jnp.asarray(np.pad(v, (0, lj.A.n_pad - n)))
            r_p = torch.from_numpy(np.pad(v, (0, lp.A.n_pad - n)))
        rc_j = np.asarray(lj.R.matvec(r_j))
        rc_p = lp.R.matvec(r_p).numpy()
        m = min(rc_j.size, rc_p.size)
        assert relerr(rc_p[:m], rc_j[:m]) <= 1e-12
        w = rng.normal(size=max(rc_j.size, rc_p.size))
        y_j = lj.P.matvec(jnp.asarray(w[: rc_j.size]))
        y_p = lp.P.matvec(torch.from_numpy(w[: rc_p.size]))
        if k == 0:
            y_j, y_p = Aj.get_vector(y_j), Ap.get_vector(y_p)
        else:
            y_j, y_p = np.asarray(y_j)[:n], y_p.numpy()[:n]
        assert relerr(y_p, y_j) <= 1e-12
    r = rand(sy.A.n_rows, seed=32)
    zj = Aj.get_vector(Mj(Aj.put_vector(r, dtype=jnp.float64)))
    zp = Ap.get_vector(Mp(Ap.put_vector(r, dtype=torch.float64)))
    assert relerr(zp, zj) <= 1e-10


@pytest.mark.parametrize("dtype_name,slack",
                         [("float64", 0), ("float32", 1)],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("case", sorted(AMG_CASES))
@pytest.mark.parametrize("dims", MESH_DIMS, ids=mesh_id)
def test_cg_amg_iterations_match_jax(dims, case, dtype_name, slack):
    sy, Aj, Ap, Mj, Mp = _hierarchies(dims, dtype_name, case)
    jdt, tdt = getattr(jnp, dtype_name), getattr(torch, dtype_name)
    b = sy.b / np.abs(sy.b).max()
    tol = 1e-10 if dtype_name == "float64" else 1e-5
    bj = Aj.put_vector(b.astype(dtype_name), dtype=jdt)
    bp = Ap.put_vector(b.astype(dtype_name), dtype=tdt)
    rj = j_cg_solve(Aj, bj, jnp.zeros_like(bj), precond=Mj, tol=tol,
                    maxiter=200)
    rp = cg_solve(Ap, bp, torch.zeros_like(bp), precond=Mp, tol=tol,
                  maxiter=200)
    assert rp.converged and bool(rj.converged)
    assert abs(rp.iterations - int(rj.iterations)) <= slack
    x = Ap.get_vector(rp.x).astype(np.float64)
    host = np.linalg.norm(b - sy.A.matvec(x)) / np.linalg.norm(b)
    assert host <= (1e-9 if dtype_name == "float64" else 1e-4)
    if dtype_name == "float64":
        assert relerr(x, Aj.get_vector(rj.x)) <= 1e-10


def test_unported_branches_raise():
    """The distributed hierarchy builders' hook, which raised here before,
    is ported (held to JAX in ``test_torch_parallel_precond.py``): it fills
    one record per level.  An operator format the port does not have
    raises."""
    sy, csr = _systems(MESH_DIMS[1])
    info = []
    M = p_amg.smoothed_aggregation_setup(csr, level_info_out=info,
                                         device="cpu")
    assert len(info) == len(M.levels) >= 1
    assert info[0]["n"] == csr.n_rows
    with pytest.raises(ValueError, match="operator_format"):
        p_amg.smoothed_aggregation_setup(csr, operator_format="dia",
                                         device="cpu")
