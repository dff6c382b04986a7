"""The reference-parity Krylov solvers and preconditioners of the port
against the JAX package: GMRES, BiCGStab, the Chebyshev preconditioner and
its lmax estimate, ILU(0) and ILUT.

Both packages get the same assembled systems (``tests/torch_parity.py``:
refined tet boxes, and a structured tet box) and the same ELL operator
layout (row-padded to 8, plain gather-sum in both).

Tolerances, each from summation order: the packages add the same products
in different orders (XLA's reductions against PyTorch's), so f64 results
differ by rounding that a Krylov solve amplifies at most by the condition
number of these small systems (~1e3): 1e-10 on solutions and on the ILU
apply of identical factors, 1e-12 on single operators, factors and lmax
from the same start vector.  Iteration counts are equal in f64; in f32
rounding can move the stopping iteration by one.  f32 solves run to 1e-4,
a decade above the f32 rounding floor of these systems' true residual
(about 1e-5), where GMRES's implicit residual stops tracking it; BiCGStab
in f32 runs to 1e-5, because its residual is not monotone and at 1e-4 the
refined box's curve lies flat across two iterations, so rounding moves the
crossing by two.  The power method's start
vector is drawn by each package's own generator unless handed over, so
their lmax estimates differ: within 2 %, and then CG+Chebyshev iterations
within one.  JAX rounds its packed ILU factors through float32
(``ilu.py:115`` there) and the port does not: applies of each package's
own factors agree to 1e-6, and the port's own apply is held to the exact
triangular solves to 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from domain_decomposed_pde_solver_tpu.io import box_mesh as j_box_mesh
from domain_decomposed_pde_solver_tpu.models import assemble_heat_system
from domain_decomposed_pde_solver_tpu.ops.ell import ell_from_csr as j_ell
from domain_decomposed_pde_solver_tpu.solvers.bicgstab import (
    bicgstab_solve as j_bicgstab,
)
from domain_decomposed_pde_solver_tpu.solvers.cg import cg_solve as j_cg_solve
from domain_decomposed_pde_solver_tpu.solvers.gmres import gmres_solve as j_gmres
from domain_decomposed_pde_solver_tpu.solvers.precond import ilu as j_ilu
from domain_decomposed_pde_solver_tpu.solvers.precond.chebyshev import (
    chebyshev_preconditioner as j_cheb,
    estimate_lmax_dinv_a as j_lmax,
)
from domain_decomposed_pde_solver_tpu.solvers.precond.jacobi import (
    jacobi_preconditioner as j_jacobi,
)
from domain_decomposed_pde_solver_tpu_torch.ops.ell import ell_from_csr
from domain_decomposed_pde_solver_tpu_torch.solvers import (
    bicgstab_solve,
    cg_solve,
    chebyshev_preconditioner,
    estimate_lmax_dinv_a,
    gmres_solve,
    jacobi_preconditioner,
)
from domain_decomposed_pde_solver_tpu_torch.solvers.precond import ilu as p_ilu
from domain_decomposed_pde_solver_tpu_torch.utils import native as p_native
from domain_decomposed_pde_solver_tpu_torch.utils.convert import ilu_from_numpy
from torch_parity import MESH_DIMS, jax_problem, port_csr, relerr

torch.set_num_threads(1)

SYSTEMS = ["box", "refined"]
TOL = {"float64": 1e-10, "float32": 1e-4}


def _system(kind):
    if kind == "box":
        return assemble_heat_system(j_box_mesh(7, 6, 5, elem_type="TETRA4"))
    return jax_problem(MESH_DIMS[1])[1]


def _ops(kind, name):
    sy = _system(kind)
    csr = port_csr(sy)
    Aj = j_ell(sy.A, dtype=getattr(jnp, name))
    Ap = ell_from_csr(csr, dtype=getattr(torch, name), device="cpu")
    # A scaled right-hand side plus a random start: both packages get the
    # same host arrays.
    b = sy.b / np.abs(sy.b).max()
    x0 = np.random.default_rng(5).uniform(-1.0, 1.0, size=sy.A.n_rows)
    vec = {}
    for who, A, dt in (("jax", Aj, getattr(jnp, name)),
                       ("port", Ap, getattr(torch, name))):
        vec[who] = (A.put_vector(b.astype(name), dtype=dt),
                    A.put_vector(x0.astype(name), dtype=dt))
    return sy, csr, Aj, Ap, vec


def _same_answer(sy, Ap, xp, xj, name, rp, rj, slack):
    assert rp.converged and bool(rj.converged)
    assert abs(rp.iterations - int(rj.iterations)) <= slack
    if name == "float64":
        assert relerr(Ap.get_vector(xp), np.asarray(xj)[: sy.A.n_rows]) <= 1e-10
        assert abs(rp.relres - float(rj.relres)) <= 1e-2 * float(rj.relres)


DTYPES = pytest.mark.parametrize("name,slack", [("float64", 0), ("float32", 1)],
                                 ids=["float64", "float32"])


@DTYPES
@pytest.mark.parametrize("precond", ["none", "jacobi"])
@pytest.mark.parametrize("kind", SYSTEMS)
def test_gmres_matches_jax(kind, precond, name, slack):
    sy, _csr, Aj, Ap, vec = _ops(kind, name)
    tol = TOL[name]
    Mj = j_jacobi(Aj) if precond == "jacobi" else None
    Mp = jacobi_preconditioner(Ap) if precond == "jacobi" else None
    rj = j_gmres(Aj, *vec["jax"], precond=Mj, restart=12, tol=tol,
                 maxiter=1000)
    rp = gmres_solve(Ap, *vec["port"], precond=Mp, restart=12, tol=tol,
                     maxiter=1000)
    assert rp.iterations > 12  # the restarts ran
    _same_answer(sy, Ap, rp.x, rj.x, name, rp, rj, slack)


@pytest.mark.parametrize("restart,maxiter", [(30, 5), (1, 1), (4, 9)])
def test_gmres_restart_and_maxiter_semantics_match_jax(restart, maxiter):
    """maxiter is checked between cycles (a cycle may run past it); the
    count is inner steps; restart=1 is the reference's one-step solve."""
    sy, _csr, Aj, Ap, vec = _ops("refined", "float64")
    rj = j_gmres(Aj, *vec["jax"], restart=restart, tol=1e-14, maxiter=maxiter)
    rp = gmres_solve(Ap, *vec["port"], restart=restart, tol=1e-14,
                     maxiter=maxiter)
    assert not rp.converged and not bool(rj.converged)
    assert rp.iterations == int(rj.iterations)
    assert relerr(Ap.get_vector(rp.x), np.asarray(rj.x)[: sy.A.n_rows]) <= 1e-10


def test_gmres_zero_rhs_and_converged_start_return_at_once():
    _sy, _csr, _Aj, Ap, vec = _ops("refined", "float64")
    b, _x0 = vec["port"]
    zero = gmres_solve(Ap, torch.zeros_like(b), torch.zeros_like(b), tol=1e-10)
    assert zero.iterations == 0 and zero.converged and zero.relres == 0.0
    first = gmres_solve(Ap, b, torch.zeros_like(b), tol=1e-10, maxiter=2000)
    again = gmres_solve(Ap, b, first.x, tol=1e-10)
    assert first.converged and again.iterations == 0 and again.converged


@DTYPES
@pytest.mark.parametrize("kind", SYSTEMS)
def test_bicgstab_matches_jax(kind, name, slack):
    sy, _csr, Aj, Ap, vec = _ops(kind, name)
    tol = min(TOL[name], 1e-5)
    rj = j_bicgstab(Aj, *vec["jax"], precond=j_jacobi(Aj), tol=tol,
                    maxiter=1000)
    rp = bicgstab_solve(Ap, *vec["port"], precond=jacobi_preconditioner(Ap),
                        tol=tol, maxiter=1000)
    _same_answer(sy, Ap, rp.x, rj.x, name, rp, rj, slack)


def test_bicgstab_respects_maxiter():
    _sy, _csr, Aj, Ap, vec = _ops("refined", "float64")
    rj = j_bicgstab(Aj, *vec["jax"], tol=1e-14, maxiter=6)
    rp = bicgstab_solve(Ap, *vec["port"], tol=1e-14, maxiter=6)
    assert rp.iterations == int(rj.iterations) == 6 and not rp.converged


def _jax_start_vector(Aj, seed=0):
    """JAX's power-method start vector (``chebyshev.py:40-41`` there)."""
    import jax

    q = jax.random.uniform(jax.random.PRNGKey(seed), (Aj.n_pad,), Aj.dtype)
    return torch.from_numpy(np.array(q))


@pytest.mark.parametrize("kind", SYSTEMS)
def test_lmax_estimate_matches_jax(kind):
    _sy, _csr, Aj, Ap, _vec = _ops(kind, "float64")
    lj = float(j_lmax(Aj))
    same = estimate_lmax_dinv_a(Ap, q0=_jax_start_vector(Aj))
    own = estimate_lmax_dinv_a(Ap, seed=0)
    assert same.dtype == torch.float64 and same.dim() == 0
    assert abs(float(same) - lj) <= 1e-12 * lj
    assert abs(float(own) - lj) <= 0.02 * lj


@DTYPES
@pytest.mark.parametrize("kind", SYSTEMS)
def test_cg_chebyshev_matches_jax(kind, name, slack):
    sy, _csr, Aj, Ap, vec = _ops(kind, name)
    tol = TOL[name]
    Mj = j_cheb(Aj, j_lmax(Aj))
    lj = float(j_lmax(Aj))
    # The same lmax: the apply and the solve are held to JAX.
    Mp = chebyshev_preconditioner(Ap, lj)
    r = vec["port"][1]
    np.testing.assert_allclose(
        Mp(r).numpy(), np.asarray(Mj(vec["jax"][1])),
        rtol=1e-12 if name == "float64" else 1e-5,
        atol=1e-12 if name == "float64" else 1e-5)
    rj = j_cg_solve(Aj, *vec["jax"], precond=Mj, tol=tol, maxiter=500)
    rp = cg_solve(Ap, *vec["port"], precond=Mp, tol=tol, maxiter=500)
    _same_answer(sy, Ap, rp.x, rj.x, name, rp, rj, slack)
    # The port's own estimate (its own start vector): one iteration apart
    # at most.
    own = cg_solve(Ap, *vec["port"],
                   precond=chebyshev_preconditioner(
                       Ap, estimate_lmax_dinv_a(Ap)),
                   tol=tol, maxiter=500)
    assert own.converged and abs(own.iterations - int(rj.iterations)) <= 1


# ---------------------------------------------------------------------------
# ILU(0) and ILUT
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("kind", SYSTEMS)
def test_ilu_factors_match_jax(kind, native, monkeypatch):
    """Native against native, NumPy fallback against NumPy fallback (at
    capped fill the two ILUT implementations may break |value| ties
    differently, in JAX too)."""
    sy = _system(kind)
    csr = port_csr(sy)
    if not native:
        from domain_decomposed_pde_solver_tpu.utils import native as j_native

        monkeypatch.setenv("DDPS_NO_NATIVE", "1")
        for mod in (p_native, j_native):
            monkeypatch.setattr(mod, "_tried", False)
            monkeypatch.setattr(mod, "_lib", None)
    lu_j, dp_j = j_ilu.ilu0_factor(sy.A)
    ilut_j = j_ilu._ilut_factor(sy.A, 1.0, 0.0)
    lu_p, dp_p = p_ilu.ilu0_factor(csr)
    ilut_p = p_ilu._ilut_factor(csr, 1.0, 0.0)
    assert (p_native.load_native() is not None) == native
    np.testing.assert_array_equal(dp_p, dp_j)
    np.testing.assert_allclose(lu_p, lu_j, rtol=1e-12, atol=1e-12)
    for a, b in zip(ilut_p, ilut_j):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


def _ilu_pair(kind, which, name, n_pad):
    sy = _system(kind)
    csr = port_csr(sy)
    jbuild = (j_ilu.ilu0_preconditioner if which == "ilu0"
              else j_ilu.ilut_preconditioner)
    pbuild = (p_ilu.ilu0_preconditioner if which == "ilu0"
              else p_ilu.ilut_preconditioner)
    Mj = jbuild(sy.A, n_pad=n_pad, dtype=getattr(jnp, name))
    Mp = pbuild(csr, n_pad=n_pad, dtype=getattr(torch, name), device="cpu")
    return sy, csr, Mj, Mp


def _adopt(Mj, name):
    f = {k: np.asarray(getattr(Mj, k)) for k in (
        "l_cols", "l_vals", "l_rows", "l_starts", "l_counts",
        "u_cols", "u_vals", "u_rows", "u_starts", "u_counts", "inv_diag")}
    return ilu_from_numpy(**f, n_pad=Mj.n_pad, dtype=getattr(torch, name),
                          device="cpu")


@pytest.mark.parametrize("which", ["ilu0", "ilut"])
@pytest.mark.parametrize("kind", SYSTEMS)
def test_ilu_apply_matches_jax(kind, which):
    sy, csr, Mj, Mp = _ilu_pair(kind, which, "float64", None)
    n = sy.A.n_rows
    assert (Mp.l_nlev, Mp.u_nlev) == (Mj.l_nlev, Mj.u_nlev)
    assert Mp.n_pad == Mj.n_pad
    r = np.random.default_rng(41).normal(size=Mj.n_pad)
    r[n:] = 0.0
    zj = np.asarray(Mj(jnp.asarray(r)))
    # JAX's own factor arrays in the port's sweep: the same apply.
    assert relerr(_adopt(Mj, "float64")(torch.from_numpy(r)).numpy(), zj) <= 1e-10
    # The port's own factors (kept in f64): within JAX's f32 rounding of
    # its factors, and the exact triangular solves of the f64 factors.
    zp = Mp(torch.from_numpy(r)).numpy()
    assert relerr(zp, zj) <= 1e-6
    fac = (p_ilu.ilu0_factor(csr) if which == "ilu0" else None)
    if fac is not None:
        lu, _dp = fac
        S = sp.csr_matrix((lu, csr.indices, csr.indptr), shape=csr.shape)
        L = sp.tril(S, -1) + sp.eye(n)
        U = sp.triu(S)
    else:
        Lp, Li, Lx, Up, Ui, Ux, d = p_ilu._ilut_factor(csr, 1.0, 0.0)
        L = sp.csr_matrix((Lx, Li, Lp), shape=(n, n)) + sp.eye(n)
        U = sp.csr_matrix((Ux, Ui, Up), shape=(n, n)) + sp.diags(d)
    want = spla.spsolve_triangular(
        sp.csr_matrix(U), spla.spsolve_triangular(sp.csr_matrix(L), r[:n]),
        lower=False)
    assert relerr(zp[:n], want) <= 1e-12
    np.testing.assert_array_equal(zp[n:], r[n:])  # padding keeps r


@DTYPES
@pytest.mark.parametrize("which", ["ilu0", "ilut"])
@pytest.mark.parametrize("kind", SYSTEMS)
def test_gmres_ilu_matches_jax(kind, which, name, slack):
    """The reference's configuration (GMRES right-preconditioned by ILUT)
    and ILU(0): iteration counts equal to JAX's on each package's own
    factors, and with JAX's factors adopted the same answer."""
    sy, _csr, Aj, Ap, vec = _ops(kind, name)
    _s, _c, Mj, Mp = _ilu_pair(kind, which, name, Ap.n_pad)
    tol = TOL[name]
    rj = j_gmres(Aj, *vec["jax"], precond=Mj, restart=30, tol=tol,
                 maxiter=300)
    rp = gmres_solve(Ap, *vec["port"], precond=Mp, restart=30, tol=tol,
                     maxiter=300)
    assert rp.converged and bool(rj.converged)
    assert abs(rp.iterations - int(rj.iterations)) <= slack
    ra = gmres_solve(Ap, *vec["port"], precond=_adopt(Mj, name), restart=30,
                     tol=tol, maxiter=300)
    _same_answer(sy, Ap, ra.x, rj.x, name, ra, rj, slack)


def test_ilu_zero_pivot_raises():
    from domain_decomposed_pde_solver_tpu_torch.utils.convert import (
        csr_from_numpy,
    )

    csr = csr_from_numpy([0, 2, 4], [0, 1, 0, 1], [0.0, 1.0, 1.0, 1.0], (2, 2))
    with pytest.raises(ZeroDivisionError):
        p_ilu.ilu0_factor(csr)
